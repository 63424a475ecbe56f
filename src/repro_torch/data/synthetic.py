"""Synthetic-but-learnable CIFAR-like images (port of
`repro.data.synthetic.SyntheticImages`).

``batch(step)`` is a pure function of (seed, split, step): images are a
class template plus brightness jitter and pixel noise, labels the class. The
shapes, splits and construction follow the JAX package; the values come from
`torch.Generator` and differ from `jax.random`'s, so parity tests hand both
packages the same numpy batch instead.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

_SPLIT_SALT = {"train": 0, "val": 1, "test": 2}


def _generator(*seeds: int) -> torch.Generator:
    s = 0
    for v in seeds:
        s = (s * 1_000_003 + int(v)) % (1 << 63)
    return torch.Generator().manual_seed(s)


@dataclasses.dataclass(frozen=True)
class SyntheticImages:
    """CIFAR-like image classification stream."""

    num_classes: int = 10
    image_hw: Tuple[int, int] = (32, 32)
    channels: int = 3
    noise: float = 0.45
    seed: int = 0

    def _templates(self) -> torch.Tensor:
        h, w = self.image_hw
        # smooth class templates: low-frequency random fields, upsampled
        base = torch.randn((self.num_classes, self.channels, h // 4, w // 4),
                           generator=_generator(self.seed))
        up = F.interpolate(base, size=(h, w), mode="bilinear",
                           align_corners=False).permute(0, 2, 3, 1)
        return up / torch.clamp(up.std(unbiased=False), min=1e-6)

    def batch(self, step: int, batch_size: int, split: str = "train", *,
              device):
        """Returns (images (B,H,W,C) float32, labels (B,) int64) on
        ``device``; drawn on the CPU so every device sees the same batch."""
        gen = _generator(self.seed + 1000 * _SPLIT_SALT[split], step)
        y = torch.randint(0, self.num_classes, (batch_size,), generator=gen)
        x = self._templates()[y]
        # per-sample brightness/contrast jitter + pixel noise
        scale = 1.0 + 0.2 * torch.randn((batch_size, 1, 1, 1), generator=gen)
        x = x * scale + self.noise * torch.randn(x.shape, generator=gen)
        return x.to(device=device, dtype=torch.float32), y.to(device)
