"""The optax pieces the JAX trainers use, on ``torch.optim.AdamW``.

- ``linear_schedule``, ``cosine_decay_schedule`` and
  ``warmup_cosine_decay_schedule``: optax's learning-rate schedules as
  functions of the update count (0 for the first update), in float64 on
  the host (optax evaluates them in float32).
- ``AdamW``: ``optax.chain(clip_by_global_norm(clip_norm), adamw(schedule,
  weight_decay=...))`` or, with ``clip_norm=None``, ``optax.adamw`` alone.
  ``init`` builds the ``torch.optim.AdamW`` (betas 0.9 and 0.999, eps
  1e-8, optax's decoupled weight decay: torch's default of 1e-2 is never
  used); ``update`` clips as optax does (each gradient becomes (g / |g|) *
  clip_norm when the global norm |g| >= clip_norm, without the 1e-6 of
  ``torch.nn.utils.clip_grad_norm_``), sets the learning rate of the
  update count and steps. A parameter without a gradient takes a zero
  gradient, as optax gives every leaf one.
- ``adam_moments`` / ``set_adam_moments``: the optimizer's step count and
  its ``exp_avg`` / ``exp_avg_sq`` by parameter name, optax's ``mu`` and
  ``nu`` (bias-corrected at the same count).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

Schedule = Callable[[int], float]


def constant_schedule(value: float) -> Schedule:
    return lambda count: float(value)


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax.linear_schedule: from init_value to end_value over
    transition_steps updates; constant init_value when that is <= 0."""
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(count: int) -> float:
        c = min(max(count, 0), transition_steps)
        return (init_value - end_value) * (1 - c / transition_steps) + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule: init_value * ((1 - alpha) * (1 + cos(pi
    min(count, decay_steps) / decay_steps)) / 2 + alpha)."""
    if not decay_steps > 0:
        raise ValueError(f"the cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        return init_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps)) + alpha)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule: linear from init_value to
    peak_value over warmup_steps, then the cosine decay to end_value at
    decay_steps (counted from the start)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)
    return lambda count: warmup(count) if count < warmup_steps else decay(count - warmup_steps)


def _grads(params) -> list:
    out = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        out.append(p.grad)
    return out


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on a list of gradients, in place, with no
    host read: each becomes (g / norm) * max_norm where the global norm is
    >= max_norm. Returns the norm (a 0-dim tensor)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


@dataclasses.dataclass(frozen=True)
class AdamW:
    """The optimizer of a JAX trainer (see the module docstring)."""

    schedule: Schedule
    weight_decay: float = 1e-4
    clip_norm: Optional[float] = 10.0

    def init(self, params) -> torch.optim.AdamW:
        return torch.optim.AdamW(list(params), lr=self.schedule(0), betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=self.weight_decay)

    def update(self, optimizer: torch.optim.AdamW, count: int) -> None:
        """One update from the gradients in ``.grad``; `count` is the number
        of updates before this one (the schedule's argument)."""
        params = [p for group in optimizer.param_groups for p in group["params"]]
        grads = _grads(params)
        if self.clip_norm is not None:
            clip_by_global_norm_(grads, self.clip_norm)
        for group in optimizer.param_groups:
            group["lr"] = self.schedule(count)
        optimizer.step()


def adam_moments(optimizer: torch.optim.Optimizer, named: Mapping[str, torch.Tensor]
                 ) -> Tuple[int, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(step count, {name: exp_avg}, {name: exp_avg_sq}) for the parameters
    `named`; zeros and count 0 before the first step."""
    count = 0
    mu, nu = {}, {}
    for name, p in named.items():
        st = optimizer.state.get(p, {})
        if "step" in st:
            count = int(st["step"])
        mu[name] = st["exp_avg"] if "exp_avg" in st else torch.zeros_like(p)
        nu[name] = st["exp_avg_sq"] if "exp_avg_sq" in st else torch.zeros_like(p)
    return count, mu, nu


def set_adam_moments(optimizer: torch.optim.Optimizer, named: Mapping[str, torch.Tensor],
                     count: int, mu: Mapping[str, torch.Tensor],
                     nu: Mapping[str, torch.Tensor]) -> None:
    """Sets every parameter's AdamW state: the step count (a CPU float32
    scalar, as torch keeps it) and its moments, copied to the parameter's
    device and dtype."""
    for name, p in named.items():
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu[name].to(device=p.device, dtype=p.dtype).clone(),
            "exp_avg_sq": nu[name].to(device=p.device, dtype=p.dtype).clone(),
        }
