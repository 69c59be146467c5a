"""musicgen-large [audio] — 48L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

Backbone only: the EnCodec frontend is a STUB — ``input_specs`` provides
precomputed frame embeddings (the 4 codebooks' embeddings already summed,
as MusicGen does before its decoder).  Positions: sinusoidal absolute
(MusicGen uses no rotary).  GELU MLP (no gate), per the original
transformer-decoder recipe.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    rope="abs_sin",
    frontend="audio",
    act="gelu",
)
SMOKE = CONFIG.smoke()
