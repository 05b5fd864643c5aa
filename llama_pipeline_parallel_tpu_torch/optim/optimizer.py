"""Optimizer + LR schedule: global-norm clipping, then AdamW, following optax.

The counterpart of llama_pipeline_parallel_tpu/optim/optimizer.py, which
chains `optax.clip_by_global_norm` and `optax.adamw`. This class reproduces
that chain rather than torch.optim's defaults:

- clip scale = max_norm / max(norm, max_norm) over the global gradient norm;
- Adam moments in fp32, bias-corrected with the incremented count, eps
  outside the square root (eps_root = 0);
- decoupled weight decay `+ weight_decay * param` on EVERY leaf (norms and
  embeddings included), then scaled by -lr;
- the schedule is read at the count BEFORE this update's increment.

Parameters are updated in place (the JAX version returns new arrays).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

Schedule = Callable[[int], float]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 1e-6
    weight_decay: float = 0.001
    beta1: float = 0.9
    beta2: float = 0.99
    eps: float = 1e-8
    max_grad_norm: float = 5.0
    total_steps: int = 1000
    warmup_steps: int = 50


def _linear(init: float, end: float, transition_steps: int, count: int) -> float:
    """optax.linear_schedule at `count`, in its float32 arithmetic (so the
    learning rate is the reference's to the bit)."""
    count = min(max(count, 0), transition_steps)
    frac = np.float32(1) - np.float32(count) / np.float32(transition_steps)
    return float(np.float32(init - end) * frac + np.float32(end))


def warmup_decay_schedule(peak_lr: float, total_steps: int, warmup_steps: int
                          ) -> Schedule:
    """Linear warmup to peak, then linear decay to 0 at total_steps
    (DeepSpeed's WarmupDecayLR; optax.join_schedules of two linear ramps)."""
    if warmup_steps >= total_steps:
        raise ValueError(f"warmup_steps ({warmup_steps}) must be < total_steps ({total_steps})")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return _linear(0.0, peak_lr, max(warmup_steps, 1), count)
        return _linear(peak_lr, 0.0, total_steps - warmup_steps, count - warmup_steps)

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    return torch.stack([t.float().square().sum() for t in tensors]).sum().sqrt()


class AdamW:
    """Clip + AdamW + schedule over a dict of fp32 parameters."""

    def __init__(self, params: dict[str, torch.Tensor], cfg: OptimizerConfig):
        self.cfg = cfg
        self.schedule = warmup_decay_schedule(cfg.learning_rate, cfg.total_steps,
                                              cfg.warmup_steps)
        self.count = 0
        self.mu = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}

    def state_dict(self) -> dict:
        """{"mu": {name: moment}, "nu": {name: moment}, "count": updates so
        far}: the live tensors (optax's ScaleByAdamState leaves by name)."""
        return {"mu": self.mu, "nu": self.nu, "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy `state` (as `state_dict` gives it, tensors on any device)
        into this optimizer's moments on their device; refuses a missing,
        extra or reshaped moment. The count sets the schedule's position, so
        the next update's learning rate is the uninterrupted run's."""
        for moment in ("mu", "nu"):
            mine, theirs = getattr(self, moment), state[moment]
            if set(theirs.keys()) != set(mine):
                raise ValueError(f"optimizer {moment}: names {sorted(set(theirs.keys()) ^ set(mine))} "
                                 f"are not in both the state and this optimizer")
            for name, t in mine.items():
                if tuple(theirs[name].shape) != tuple(t.shape):
                    raise ValueError(f"optimizer {moment}.{name}: {tuple(theirs[name].shape)} in "
                                     f"the state, {tuple(t.shape)} here")
                t.copy_(theirs[name])
        self.count = int(state["count"])

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
             norm: torch.Tensor | None = None) -> float:
        """Apply one update in place; returns the learning rate it used.
        `norm` is the global gradient norm when the caller has it (the train
        step reports it; under several pipeline processes it spans every
        stage's gradients, not just `grads`); otherwise it is computed here."""
        cfg = self.cfg
        if norm is None:
            norm = global_norm(grads.values())
        clip = cfg.max_grad_norm / torch.clamp(norm, min=cfg.max_grad_norm)
        lr = self.schedule(self.count)
        count_inc = self.count + 1
        mu_corr = 1.0 - cfg.beta1 ** count_inc
        nu_corr = 1.0 - cfg.beta2 ** count_inc
        for name, p in params.items():
            g = grads[name].float() * clip
            mu, nu = self.mu[name], self.nu[name]
            mu.mul_(cfg.beta1).add_(g, alpha=1.0 - cfg.beta1)
            nu.mul_(cfg.beta2).addcmul_(g, g, value=1.0 - cfg.beta2)
            update = (mu / mu_corr) / ((nu / nu_corr).sqrt_() + cfg.eps)
            update.add_(p, alpha=cfg.weight_decay)
            p.add_(update, alpha=-lr)
        self.count = count_inc
        return lr

