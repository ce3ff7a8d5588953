"""LR schedules.  WSD (Warmup-Stable-Decay) is MiniCPM's schedule
(arXiv:2404.06395): the minicpm-2b config trains with it.  Each schedule
returns ``lr(step)``, a float32 0-d tensor (on the CPU) computed with the
reference's float32 formulas."""

from __future__ import annotations

import math
from typing import Callable

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def wsd_schedule(peak_lr: float, warmup_steps: int, stable_steps: int,
                 decay_steps: int, final_frac: float = 0.1) -> Callable:
    """Warmup -> Stable plateau -> exponential Decay (MiniCPM WSD)."""

    def lr(step):
        step = _f32(step)
        warm = peak_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
        in_decay = torch.clamp(step - warmup_steps - stable_steps, min=0.0)
        decay_ratio = torch.clamp(in_decay / max(decay_steps, 1), max=1.0)
        decay_mult = _f32(final_frac) ** decay_ratio
        return torch.where(step < warmup_steps + stable_steps, warm,
                           peak_lr * decay_mult)

    return lr


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1) -> Callable:
    def lr(step):
        step = _f32(step)
        warm = peak_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)

    return lr
