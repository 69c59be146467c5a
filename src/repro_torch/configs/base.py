"""Config schema: architectures and input shapes.

One ``ModelConfig`` per assigned architecture (exact numbers from the brief)
plus reduced smoke variants.  ``ShapeConfig`` covers the 4 assigned input
shapes.  Everything is a frozen dataclass — hashable, usable as a jit static
argument.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads
    # positions / attention flavor
    rope: str = "rope"          # rope | mrope | abs_sin | none
    rope_theta: float = 1e4
    mrope_sections: tuple[int, int, int] = (16, 24, 24)  # half-dim split
    sliding_window: int | None = None
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_interleave: int = 1     # 1 = every layer MoE; 2 = alternate dense/MoE
    shared_expert: bool = False
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    wkv_lora_rank: int = 64
    chunk_size: int = 64        # linear-attention chunk length
    # frontend stub (vlm/audio): inputs arrive as precomputed embeddings
    frontend: str | None = None
    act: str = "swiglu"         # swiglu | gelu
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # quantization: groups matching these prefixes are frozen at 8 bits
    # (paper keeps first/last layers at high precision; we freeze routers too)
    frozen_at_8: tuple[str, ...] = ("embed", "lm_head", "router")
    # attention flash chunk sizes
    q_chunk: int = 512
    kv_chunk: int = 1024

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        return replace(
            self,
            name=self.name + "-smoke",
            num_layers=2 if self.moe_interleave == 1 else 2 * self.moe_interleave,
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=16,
            d_ff=96,
            vocab_size=251,
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            wkv_lora_rank=8,
            chunk_size=8,
            sliding_window=8 if self.sliding_window else None,
            q_chunk=16,
            kv_chunk=16,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}

# Sub-quadratic archs for which long_500k is runnable (DESIGN.md §5):
# SSM (O(1) state), hybrid (SSM + windowed KV), SWA-dense (windowed KV).
LONG_CONTEXT_OK = ("rwkv6-1.6b", "hymba-1.5b", "h2o-danube-3-4b")


def cell_is_runnable(arch: str, shape: str) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch × shape) cell."""
    if shape == "long_500k" and arch not in LONG_CONTEXT_OK:
        return False, "full-attention arch: 500k dense KV decode is the quadratic regime (skip per brief)"
    return True, ""
