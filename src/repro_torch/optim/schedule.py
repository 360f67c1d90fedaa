"""Learning-rate schedules: pure functions of a 0-d int32 step tensor.

The torch counterpart of ``repro.optim.schedule``. Each returns a 0-d fp32
tensor on the step's device, made by device operations only, so a schedule
runs inside a CUDA graph; divisions go through device tensors (CUDA's
``tensor / python_scalar`` multiplies by the reciprocal).
"""
from __future__ import annotations

import math

import torch

__all__ = ["constant_lr", "cosine_lr", "warmup_cosine"]


def _full(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=like.device)


def constant_lr(lr: float):
    return lambda step: _full(lr, step)


def cosine_lr(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        t = torch.clamp(step.to(torch.float32) / _full(total_steps, step),
                        0.0, 1.0)
        # the fp32 argument's cosine correctly rounded (taken in float64):
        # torch's fp32 cos is an ulp off XLA's at some steps
        cos = 0.5 * (1 + torch.cos((math.pi * t).double()).float())
        return lr * (final_frac + (1 - final_frac) * cos)
    return f


def warmup_cosine(lr: float, warmup: int, total_steps: int,
                  final_frac: float = 0.1):
    cos = cosine_lr(lr, max(total_steps - warmup, 1), final_frac)

    def f(step):
        w = torch.clamp(step.to(torch.float32) / _full(max(warmup, 1), step),
                        max=1.0)
        return w * cos(torch.clamp(step - warmup, min=0))
    return f
