"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attn+mamba heads [arXiv:2411.13676; hf].

Each block runs attention and a Mamba SSM branch in PARALLEL on the same
normed input, combined with a learned per-layer mix (the Hymba signature).
Sliding-window attention (1024) + O(1) SSM state -> RUNS long_500k.
Meta-tokens are omitted (backbone-only; noted in DESIGN.md §3).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_expand=2,
    sliding_window=1024,
    rope="rope",
    rope_theta=10_000.0,
    act="swiglu",
)
SMOKE = CONFIG.smoke()
