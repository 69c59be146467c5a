"""QuantPolicy: the per-layer bitwidth assignment ReLeQ searches over.

A *quantizable group* is one named weight tensor family of a model (e.g.
``"blocks.attn.wq"`` or CNN ``"conv1"``).  The RL agent's episode walks these
groups in order and assigns each a bitwidth from ``BITWIDTH_CHOICES``.

The policy has two faces:

- a host-side, human-readable mapping (dict, JSON round-trippable, printed in
  Table-2-style benchmark output), and
- a device-side dense ``int32[num_groups]`` vector (``as_array``) that enters
  the pjit'd train/serve step as *data* — crucial so that a vectorized batch
  of policies (num_envs × num_groups) shares one compiled executable.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

from repro_torch.quant.wrpn import FP_BITS

# The paper's action set (§2.5 uses {1..8}; experiments use {2..8} for deep
# quantization with 8 as the safe ceiling).  Keep 1..8 available; configs can
# restrict.
BITWIDTH_CHOICES: tuple[int, ...] = (1, 2, 3, 4, 5, 6, 7, 8)


@dataclass
class QuantPolicy:
    """Mapping group-name -> bitwidth, with fixed (non-searchable) groups."""

    group_names: tuple[str, ...]
    bits: dict[str, int] = field(default_factory=dict)
    default_bits: int = 8
    frozen: dict[str, int] = field(default_factory=dict)  # e.g. router: 8, first/last: 8

    def __post_init__(self):
        self.group_names = tuple(self.group_names)
        unknown = set(self.bits) - set(self.group_names)
        if unknown:
            raise KeyError(f"bits for unknown groups: {sorted(unknown)}")
        for k, v in self.frozen.items():
            if k not in self.group_names:
                raise KeyError(f"frozen group {k!r} not in group_names")
            self.bits[k] = v

    # -- search interface ---------------------------------------------------
    @property
    def searchable(self) -> tuple[str, ...]:
        return tuple(g for g in self.group_names if g not in self.frozen)

    def with_bits(self, name: str, bits: int) -> "QuantPolicy":
        if name in self.frozen:
            raise ValueError(f"group {name!r} is frozen at {self.frozen[name]}")
        new = dict(self.bits)
        new[name] = int(bits)
        return QuantPolicy(self.group_names, new, self.default_bits, dict(self.frozen))

    def with_all(self, bits: int) -> "QuantPolicy":
        new = {g: int(bits) for g in self.searchable}
        new.update(self.frozen)
        return QuantPolicy(self.group_names, new, self.default_bits, dict(self.frozen))

    def get(self, name: str) -> int:
        return int(self.bits.get(name, self.default_bits))

    # -- device-side --------------------------------------------------------
    def as_array(self) -> np.ndarray:
        """Dense int32 vector aligned with ``group_names`` order."""
        return np.asarray([self.get(g) for g in self.group_names], dtype=np.int32)

    @classmethod
    def from_array(cls, group_names, arr, frozen=None) -> "QuantPolicy":
        arr = np.asarray(arr).reshape(-1)
        if len(arr) != len(group_names):
            raise ValueError(f"policy length {len(arr)} != groups {len(group_names)}")
        bits = {g: int(b) for g, b in zip(group_names, arr)}
        return cls(tuple(group_names), bits, frozen=dict(frozen or {}))

    # -- metrics ------------------------------------------------------------
    def average_bits(self) -> float:
        return float(np.mean(self.as_array()))

    def describe(self) -> str:
        return "{" + ", ".join(str(self.get(g)) for g in self.group_names) + "}"

    # -- serialization ------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(
            {
                "group_names": list(self.group_names),
                "bits": {g: self.get(g) for g in self.group_names},
                "default_bits": self.default_bits,
                "frozen": self.frozen,
            },
            indent=2,
        )

    @classmethod
    def from_json(cls, s: str) -> "QuantPolicy":
        d = json.loads(s)
        return cls(
            tuple(d["group_names"]),
            {k: int(v) for k, v in d["bits"].items()},
            int(d.get("default_bits", 8)),
            {k: int(v) for k, v in d.get("frozen", {}).items()},
        )

    @classmethod
    def from_file(cls, path) -> "QuantPolicy":
        """Load a policy JSON written by ``to_json`` (search artifacts)."""
        with open(path) as f:
            return cls.from_json(f.read())

    @classmethod
    def full_precision(cls, group_names, frozen=None) -> "QuantPolicy":
        return cls(
            tuple(group_names),
            {g: FP_BITS for g in group_names if g not in (frozen or {})},
            frozen=dict(frozen or {}),
        )
