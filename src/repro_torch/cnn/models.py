"""The paper's CNN benchmark family (torch port of ``repro.cnn.models``).

Same protocol as the reference: ``init``, ``apply(params, x) -> logits``,
``quant_groups()``, ``frozen_bits()``; the layer list is the quantizable
weight groups in forward order (the paper's episode walk), and MACs per
sample come from the conv/fc geometry.

Params are a dict ``{layer: {"w", "b"}}``.  Conv weights are in torch's
OIHW layout, ``(c_out, c_in, k, k)``, depthwise ones ``(c, 1, k, k)``
(``convert.cnn_params_from_numpy`` permutes the reference's HWIO); fc
weights stay ``(n_in, n_out)`` and apply as ``x @ w + b``.  ``apply``
takes the reference's NHWC images and runs NCHW inside.  Convolutions
are library calls (cuDNN on the card), as the reference leaves them to
XLA.  Padding is the reference's ``"SAME"``: with stride 2 it is
asymmetric (the extra row and column go low-side last), so each layer's
padding is computed from its input size, never ``padding=k//2``.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models.model import QuantGroup


@dataclass(frozen=True)
class ConvSpec:
    name: str
    kind: str          # conv | dwconv | fc
    c_in: int
    c_out: int
    k: int = 3
    stride: int = 1
    residual_from: str | None = None   # resnet shortcuts


def same_padding(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride, groups=1):
    """NCHW conv with the reference's SAME padding."""
    k = w.shape[-1]
    lo, hi = same_padding(x.shape[-1], k, stride)
    if lo == hi:
        return F.conv2d(x, w, stride=stride, padding=lo, groups=groups)
    return F.conv2d(F.pad(x, (lo, hi, lo, hi)), w, stride=stride, groups=groups)


class CNNModel:
    """Sequential(+residual) CNN from a list of ConvSpecs."""

    def __init__(self, name: str, specs: list[ConvSpec], input_hw: int,
                 c_in: int, num_classes: int, frozen_first_last: bool = True):
        self.name = name
        self.specs = specs
        self.input_hw = input_hw
        self.c_in = c_in
        self.num_classes = num_classes
        self.frozen_first_last = frozen_first_last
        self._plan_shapes()

    def _plan_shapes(self):
        hw = self.input_hw
        self._hw_at = {}
        for s in self.specs:
            if s.kind == "fc":
                hw = 1
            self._hw_at[s.name] = hw
            if s.kind in ("conv", "dwconv") and s.stride > 1:
                hw = -(-hw // s.stride)

    def init(self, seed: int = 0, device=None):
        """He-normal weights, zero biases.  Each layer draws from its own
        CPU ``torch.Generator`` (seeded from ``seed`` and the crc32 of its
        name), so a seed gives the same params on the CPU and the card;
        they cannot be ``jax.random``'s (parity goes through ``convert``)."""
        device = resolve_device(device)
        params = {}
        flat_in = None
        for s in self.specs:
            gen = torch.Generator().manual_seed(
                seed * 1_000_003 + zlib.crc32(s.name.encode()))
            if s.kind == "conv":
                w = torch.randn((s.c_out, s.c_in, s.k, s.k), generator=gen)
                w *= (2.0 / (s.k * s.k * s.c_in)) ** 0.5
            elif s.kind == "dwconv":
                w = torch.randn((s.c_in, 1, s.k, s.k), generator=gen)
                w *= (2.0 / (s.k * s.k)) ** 0.5
            else:  # fc
                n_in = s.c_in if flat_in is None else flat_in
                w = torch.randn((n_in, s.c_out), generator=gen)
                w *= (2.0 / n_in) ** 0.5
            n_out = s.c_out if s.kind == "fc" else w.shape[0]
            params[s.name] = {"w": w.to(device), "b": torch.zeros(n_out, device=device)}
            if s.kind == "fc":
                flat_in = s.c_out
        return params

    def apply(self, params, x):
        """x: (B, H, W, C) -> logits (B, classes)."""
        x = x.permute(0, 3, 1, 2).contiguous()    # NHWC -> NCHW
        taps = {}
        flat = False
        for i, s in enumerate(self.specs):
            p = params[s.name]
            if s.kind == "fc":
                if not flat:
                    x = x.mean(dim=(2, 3))  # global average pool
                    flat = True
                x = x @ p["w"] + p["b"]
            elif s.kind == "dwconv":
                x = _conv(x, p["w"], s.stride, groups=s.c_in) + p["b"][:, None, None]
            else:
                x = _conv(x, p["w"], s.stride) + p["b"][:, None, None]
            if s.residual_from is not None and s.residual_from in taps:
                r = taps[s.residual_from]
                if r.shape == x.shape:
                    x = x + r
            taps[s.name] = x
            if i < len(self.specs) - 1:
                x = F.relu(x)
        return x

    # ---- quantization interface ----------------------------------------
    def quant_groups(self) -> list[QuantGroup]:
        out = []
        for s in self.specs:
            hw = self._hw_at[s.name]
            if s.kind == "conv":
                nw = s.k * s.k * s.c_in * s.c_out
                macs = nw * (hw // s.stride) * (hw // s.stride)
            elif s.kind == "dwconv":
                nw = s.k * s.k * s.c_in
                macs = nw * (hw // s.stride) * (hw // s.stride)
            else:
                nw = s.c_in * s.c_out
                macs = nw
            out.append(QuantGroup(s.name, (s.name, "w"), None, (0,), nw, macs))
        return out

    def frozen_bits(self) -> dict[str, int]:
        """Paper keeps boundary layers high-precision (Table 2: first/last 8)."""
        if not self.frozen_first_last:
            return {}
        return {self.specs[0].name: 8, self.specs[-1].name: 8}


def lenet() -> CNNModel:
    # paper LeNet on MNIST: conv1, conv2, fc1, fc2 (Table 2: {2,2,3,2})
    specs = [
        ConvSpec("conv1", "conv", 1, 6, k=5, stride=2),
        ConvSpec("conv2", "conv", 6, 16, k=5, stride=2),
        ConvSpec("fc1", "fc", 16, 120),
        ConvSpec("fc2", "fc", 120, 10),
    ]
    return CNNModel("lenet", specs, 28, 1, 10, frozen_first_last=False)


def simplenet5() -> CNNModel:
    # paper "CIFAR-10 (SimpleNet, 5 layers)": {5,5,5,5,5}
    specs = [
        ConvSpec("conv1", "conv", 3, 32, stride=1),
        ConvSpec("conv2", "conv", 32, 32, stride=2),
        ConvSpec("conv3", "conv", 32, 64, stride=2),
        ConvSpec("conv4", "conv", 64, 64, stride=2),
        ConvSpec("fc", "fc", 64, 10),
    ]
    return CNNModel("simplenet", specs, 32, 3, 10, frozen_first_last=False)


def svhn10() -> CNNModel:
    # paper "SVHN-10 (10 layers)": {8,4,4,4,4,4,4,4,4,8}
    chans = [32, 32, 48, 48, 64, 64, 80, 80]
    specs, c = [], 3
    for i, co in enumerate(chans):
        specs.append(ConvSpec(f"conv{i+1}", "conv", c, co,
                              stride=2 if i % 2 == 1 else 1))
        c = co
    specs += [ConvSpec("fc1", "fc", c, 128), ConvSpec("fc2", "fc", 128, 10)]
    return CNNModel("svhn10", specs, 32, 3, 10)


def vgg11() -> CNNModel:
    # VGG-11 structure (8 conv + 3 fc), the reference's reduced widths
    cfg = [(16, 1), (32, 2), (64, 1), (64, 2), (128, 1), (128, 2), (128, 1), (128, 2)]
    specs, c = [], 3
    for i, (co, st) in enumerate(cfg):
        specs.append(ConvSpec(f"conv{i+1}", "conv", c, co, stride=st))
        c = co
    specs += [ConvSpec("fc1", "fc", c, 128), ConvSpec("fc2", "fc", 128, 128),
              ConvSpec("fc3", "fc", 128, 10)]
    return CNNModel("vgg11", specs, 32, 3, 10)


def resnet20() -> CNNModel:
    # full ResNet-20 structure: stem + 3 stages × 3 blocks × 2 convs + fc
    specs = [ConvSpec("stem", "conv", 3, 16)]
    c = 16
    for stage, co in enumerate([16, 32, 64]):
        for blk in range(3):
            st = 2 if (stage > 0 and blk == 0) else 1
            prev = specs[-1].name
            specs.append(ConvSpec(f"s{stage}b{blk}a", "conv", c, co, stride=st))
            specs.append(ConvSpec(f"s{stage}b{blk}b", "conv", co, co, residual_from=prev))
            c = co
    specs.append(ConvSpec("fc", "fc", c, 10))
    return CNNModel("resnet20", specs, 32, 3, 10)


def alexnet() -> CNNModel:
    # AlexNet structure (5 conv + 3 fc), the reference's reduced widths
    specs = [
        ConvSpec("conv1", "conv", 3, 12, k=5, stride=2),
        ConvSpec("conv2", "conv", 12, 32, k=5, stride=2),
        ConvSpec("conv3", "conv", 32, 48),
        ConvSpec("conv4", "conv", 48, 48),
        ConvSpec("conv5", "conv", 48, 32, stride=2),
        ConvSpec("fc1", "fc", 32, 256),
        ConvSpec("fc2", "fc", 256, 256),
        ConvSpec("fc3", "fc", 256, 20),
    ]
    return CNNModel("alexnet", specs, 32, 3, 20)


def mobilenet_v1() -> CNNModel:
    # MobileNet-V1 structure: stem + 13 (dw, pw) pairs + fc, reduced widths
    plan = [(16, 1), (32, 2), (32, 1), (64, 2), (64, 1), (128, 2), (128, 1),
            (128, 1), (128, 1), (128, 1), (128, 1), (256, 2), (256, 1)]
    specs = [ConvSpec("stem", "conv", 3, 8, stride=2)]
    c = 8
    for i, (co, st) in enumerate(plan):
        specs.append(ConvSpec(f"dw{i+1}", "dwconv", c, c, stride=st))
        specs.append(ConvSpec(f"pw{i+1}", "conv", c, co, k=1))
        c = co
    specs.append(ConvSpec("fc", "fc", c, 20))
    return CNNModel("mobilenet", specs, 32, 3, 20)


CNN_ZOO = {
    "lenet": lenet,
    "simplenet": simplenet5,
    "svhn10": svhn10,
    "vgg11": vgg11,
    "resnet20": resnet20,
    "alexnet": alexnet,
    "mobilenet": mobilenet_v1,
}


def build_cnn(name: str) -> CNNModel:
    return CNN_ZOO[name]()
