"""h2o-danube-3-4b [dense] — 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000 — llama+mistral mix, SWA [arXiv:2401.16818; unverified].

Sliding-window attention (mistral-style, 4096 window) makes the KV cache
O(window), so this arch RUNS the long_500k cell (DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    rope="rope",
    rope_theta=10_000.0,
    sliding_window=4096,
    act="swiglu",
)
SMOKE = CONFIG.smoke()
