"""qwen2-vl-7b [vlm] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

Backbone only (per brief): the vision frontend is a STUB — ``input_specs``
provides precomputed patch embeddings (B, S, D) plus the (3, B, S) M-RoPE
position streams (temporal / height / width).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    rope="mrope",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),  # hd=128 -> half-dim 64 split
    frontend="vision",
    act="swiglu",
)
SMOKE = CONFIG.smoke()
