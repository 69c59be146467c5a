"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192, MoE 128e top-1 — MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

Maverick-style interleaved MoE: every other layer routes over 128 experts
(top-1) with a shared expert in parallel; the alternate layers are dense.
Param accounting at these numbers: attn ≈3.0B + routed 24·128·3·D·F ≈387B +
shared ≈3.0B + dense FFN ≈3.0B + embeddings ≈2.1B ≈ 398B total, ≈15-17B
active per token — matching the 400b-a17b name.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    num_experts=128,
    experts_per_token=1,
    moe_interleave=2,
    shared_expert=True,
    rope="rope",
    rope_theta=500_000.0,
    act="swiglu",
)
SMOKE = CONFIG.smoke()
