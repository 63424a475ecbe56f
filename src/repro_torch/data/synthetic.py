"""Synthetic-but-learnable datasets (port of `repro.data.synthetic`).

``batch(step)`` is a pure function of (seed, split, step).
`SyntheticImages`: CIFAR-like images, a class template plus brightness
jitter and pixel noise, labels the class. `SyntheticTokens`: an LM token
stream, the noisy affine bigram process ``next = (a * cur + b) % vocab``
with probability 1 - eps, else a uniform token. The shapes, splits and
construction follow the JAX package (the bigram map's ``a`` and ``b``,
int32 arithmetic included, are its own); the values come from
`torch.Generator` and differ from `jax.random`'s, so parity tests hand both
packages the same numpy batch instead.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

_SPLIT_SALT = {"train": 0, "val": 1, "test": 2}


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32 two's complement (still int64)."""
    return torch.remainder(x + (1 << 31), 1 << 32) - (1 << 31)


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


@dataclasses.dataclass(frozen=True)
class SyntheticTokens:
    """LM token stream: noisy affine bigram process over the vocab.

    next = (a * cur + b) % vocab  with prob 1-eps, else uniform noise.
    """

    vocab: int = 32000
    eps: float = 0.15
    seed: int = 0

    @property
    def _a(self) -> int:
        return 31337 % self.vocab or 7

    @property
    def _b(self) -> int:
        return (self.seed * 2654435761 + 12345) % self.vocab

    def next_tokens(self, cur: torch.Tensor) -> torch.Tensor:
        """The bigram map of int tokens, in the JAX package's int32
        arithmetic (``a * cur + b`` wraps at 2^31, then a floor modulo)."""
        x = _wrap_int32(_wrap_int32(cur.long() * self._a) + self._b)
        return torch.remainder(x, self.vocab).to(torch.int32)

    def batch(self, step: int, batch_size: int, seq_len: int,
              split: str = "train", *, device):
        """Returns (tokens (B, S) int32, labels (B, S) int32) on ``device``;
        the labels are the tokens shifted by one. Drawn on the CPU so every
        device sees the same batch."""
        gen = _generator(self.seed + 7000 * _SPLIT_SALT[split], step)
        cur = torch.randint(0, self.vocab, (batch_size,), generator=gen,
                            dtype=torch.int32)
        noise = torch.rand((seq_len, batch_size), generator=gen) < self.eps
        rand_tok = torch.randint(0, self.vocab, (seq_len, batch_size),
                                 generator=gen, dtype=torch.int32)
        seq = [cur]
        for t in range(seq_len):
            cur = torch.where(noise[t], rand_tok[t], self.next_tokens(cur))
            seq.append(cur)
        seq = torch.stack(seq, dim=1).to(device)          # (B, S + 1)
        return seq[:, :-1], seq[:, 1:]
