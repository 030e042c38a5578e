"""Learning-rate schedules.

Port of semantic_gaussians_tpu.utils.schedules: the log-linear
interpolation with optional delay used for the xyz learning rate. The
returned callable takes an int or a tensor step and returns a float32
scalar tensor (on the step's device), evaluated in float32 as the JAX
package does. `cosine_annealing_schedule` is the JAX package's
CosineAnnealingLR equivalent; `cosine_decay_schedule` is the learning rate
the distill trainer sets each step (optax's cosine_decay_schedule, which the
JAX package's AdamW follows), as a float.
"""
from __future__ import annotations

import math

import torch


def expon_lr_schedule(
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 1_000_000,
):
    def schedule(step) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
                0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0)
            )
        else:
            delay_rate = 1.0
        t = torch.clamp(step / max_steps, 0.0, 1.0)
        # lr_final == 0 would give log(0) * t = -inf * 0 = NaN at t == 0;
        # decay toward a tiny positive floor instead.
        lr_final_safe = max(lr_final, 1e-30)
        # fills on the step's device, not copies from the host, so that a
        # CUDA graph can capture the schedule
        log_init = torch.log(torch.full((), lr_init, dtype=torch.float32, device=step.device))
        log_final = torch.log(
            torch.full((), lr_final_safe, dtype=torch.float32, device=step.device)
        )
        lr = delay_rate * torch.exp(log_init * (1 - t) + log_final * t)
        # 0 when step < 0 or lr_init == 0 (disabled groups).
        disabled = (step < 0) | (lr_init == 0.0)
        return torch.where(disabled, torch.zeros_like(lr), lr)

    return schedule


def cosine_annealing_schedule(lr_init: float, total_steps: int, lr_min: float = 0.0):
    """torch.optim.lr_scheduler.CosineAnnealingLR in closed form (the
    recursive form drifts), as the JAX package writes it."""

    def schedule(step) -> torch.Tensor:
        t = torch.clamp(torch.as_tensor(step).to(torch.float32) / total_steps, 0.0, 1.0)
        return lr_min + 0.5 * (lr_init - lr_min) * (1 + torch.cos(math.pi * t))

    return schedule


def cosine_decay_schedule(lr_init: float, decay_steps: int):
    """lr_t = lr_init * 0.5 * (1 + cos(pi * min(t, T) / T)), T = decay_steps,
    in float32 as optax evaluates it; t is the number of updates made
    before this one. Returns a float (an optimizer's param-group lr)."""

    def schedule(step: int) -> float:
        t = torch.tensor(min(step, decay_steps), dtype=torch.float32)
        decay = 0.5 * (1 + torch.cos(torch.tensor(math.pi, dtype=torch.float32) * t / decay_steps))
        return float(lr_init * decay)

    return schedule
