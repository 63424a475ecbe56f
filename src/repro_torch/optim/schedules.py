"""Learning-rate schedules (port of `repro.optim.schedules`): callables of
the int step, a tensor or an int, returning a float32 tensor on the step's
device."""

from __future__ import annotations

import math

import torch


def _stepf(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    def fn(step):
        return torch.full((), lr, dtype=torch.float32,
                          device=torch.as_tensor(step).device)

    return fn


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(step):
        stepf = _stepf(step)
        warm = peak_lr * stepf / max(warmup_steps, 1)
        progress = torch.clamp(
            (stepf - warmup_steps) / max(total_steps - warmup_steps, 1),
            0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * progress))
        return torch.where(stepf < warmup_steps, warm, peak_lr * cos)

    return fn


def linear_decay(peak_lr: float, total_steps: int, final_frac: float = 0.0):
    def fn(step):
        stepf = _stepf(step)
        frac = torch.clamp(stepf / max(total_steps, 1), 0.0, 1.0)
        return peak_lr * (1.0 - (1.0 - final_frac) * frac)

    return fn
