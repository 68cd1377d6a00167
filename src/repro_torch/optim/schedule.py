"""Learning-rate schedules, pure functions of the step (the port of
``repro.optim.schedule``): fp32 arithmetic in the JAX package's order."""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    kind: str = "warmup_cosine"    # warmup_cosine | warmup_linear | constant
    base_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_ratio: float = 0.1


def lr_at(step, cfg: ScheduleConfig) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor, on whose device
    the 0-d fp32 result lands)."""
    dev = step.device if isinstance(step, torch.Tensor) else None
    s = torch.as_tensor(step, dtype=torch.float32, device=dev)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.kind == "constant":
        decay = 1.0
    else:
        frac = torch.clamp((s - cfg.warmup_steps) /
                           max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
        if cfg.kind == "warmup_linear":
            decay = 1.0 - (1.0 - cfg.min_ratio) * frac
        else:
            decay = cfg.min_ratio + (1.0 - cfg.min_ratio) * 0.5 * \
                (1.0 + torch.cos(math.pi * frac))
    return cfg.base_lr * warm * decay
