"""moonshot-v1-16b-a3b [moe] — 48L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=163840, MoE 64e top-6 — kimi/moonlight [hf:moonshotai/Moonlight-16B-A3B; hf].

Every layer is MoE (interleave=1); d_ff=1408 is the per-expert hidden dim.
Router frozen at 8 bits for ReLeQ (sensitivity — paper's first/last rule).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    num_experts=64,
    experts_per_token=6,
    moe_interleave=1,
    rope="rope",
    rope_theta=50_000.0,
    act="swiglu",
)
SMOKE = CONFIG.smoke()
