"""rwkv6-1.6b [ssm] — 24L d_model=2048 (attn-free) d_ff=7168 vocab=65536
— Finch, data-dependent decay [arXiv:2404.05892; unverified].

head_dim=64 (RWKV standard) -> 32 wkv heads.  O(1) decode state, so this
arch RUNS long_500k.  chunk_size=16 bounds the pairwise intra-chunk decay
tensor (see models/rwkv.py).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    rope="none",
    wkv_lora_rank=64,
    chunk_size=16,
    act="swiglu",  # unused by rwkv blocks
)
SMOKE = CONFIG.smoke()
