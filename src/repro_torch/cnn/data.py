"""Synthetic-but-learnable image classification datasets (offline stand-ins);
a numpy-only copy of ``repro.cnn.data``, so batches are bitwise the
reference's.

Generator: class anchors in a latent space, pushed through a fixed random
two-layer nonlinear decoder into image space, plus per-sample latent jitter
and pixel noise.  Deterministic in (dataset name, split, index).  Networks
fit these to 90%+ accuracy in a few hundred CPU steps, and — validated in
tests — accuracy degrades monotonically as weights are quantized below
4 bits and recovers with fine-tuning: the signal ReLeQ consumes.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np

_SPECS = {
    # name: (hw, channels, classes, latent_dim, jitter)
    "mnist-like": (28, 1, 10, 16, 0.55),
    "cifar-like": (32, 3, 10, 24, 0.6),
    "svhn-like": (32, 3, 10, 24, 0.6),
    "imagenet-like": (32, 3, 20, 32, 0.5),
}


@dataclass
class SyntheticImages:
    name: str
    seed: int = 0

    def __post_init__(self):
        hw, c, k, latent, jitter = _SPECS[self.name]
        self.hw, self.channels, self.classes = hw, c, k
        self.latent, self.jitter = latent, jitter
        # zlib.crc32, NOT hash(): str hashing is randomized per process
        # (PYTHONHASHSEED), which made the dataset — and every accuracy
        # threshold downstream — nondeterministic across runs
        rng = np.random.default_rng(
            (zlib.crc32(self.name.encode()) * 31 + self.seed) % (2 ** 31))
        self.anchors = rng.normal(size=(k, latent)).astype(np.float32) * 1.6
        hidden = 64
        self.w1 = rng.normal(size=(latent, hidden)).astype(np.float32) / latent ** 0.5
        self.w2 = rng.normal(size=(hidden, hw * hw * c)).astype(np.float32) / hidden ** 0.5

    def batch(self, batch: int, index: int, split: str = "train"):
        salt = {"train": 0, "val": 7_000_003, "test": 13_000_017}[split]
        rng = np.random.default_rng((self.seed * 97 + salt + index) % (2 ** 63))
        y = rng.integers(0, self.classes, size=batch)
        z = self.anchors[y] + self.jitter * rng.normal(size=(batch, self.latent))
        h = np.tanh(z @ self.w1)
        x = (h @ self.w2).reshape(batch, self.hw, self.hw, self.channels)
        x += 0.25 * rng.normal(size=x.shape)
        return x.astype(np.float32), y.astype(np.int32)


def make_dataset(name: str, seed: int = 0) -> SyntheticImages:
    return SyntheticImages(name, seed)


# paper's network -> dataset mapping (Table 2)
DATASET_FOR = {
    "lenet": "mnist-like",
    "simplenet": "cifar-like",
    "svhn10": "svhn-like",
    "vgg11": "cifar-like",
    "resnet20": "cifar-like",
    "alexnet": "imagenet-like",
    "mobilenet": "imagenet-like",
}
