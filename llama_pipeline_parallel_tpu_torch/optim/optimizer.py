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
`Zero1AdamW` splits the moments over data-parallel replicas (ZeRO-1, the
reference's `_zero1_leaf_spec` placement): the same arithmetic on each
replica's slice, then an all-gather of the masters. The split is over dp
only: the sp peers of a replica hold identical parameters and moments, as
the reference's ZeRO-1 specs replicate them over sp.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from llama_pipeline_parallel_tpu_torch.parallel import distributed
from llama_pipeline_parallel_tpu_torch.parallel.tp import tp_dim

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
        self.shapes = {k: tuple(p.shape) for k, p in params.items()}
        self.mu = {k: torch.zeros_like(self._part(k, p), dtype=torch.float32)
                   for k, p in params.items()}
        self.nu = {k: torch.zeros_like(self._part(k, p), dtype=torch.float32)
                   for k, p in params.items()}

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
                if tuple(theirs[name].shape) != self.shapes[name]:
                    raise ValueError(f"optimizer {moment}.{name}: {tuple(theirs[name].shape)} in "
                                     f"the state, {self.shapes[name]} here")
                t.copy_(self._part(name, theirs[name]))
        self.count = int(state["count"])

    def _part(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The part of leaf `name` (a parameter, its gradient or a full
        moment) that this optimizer updates: all of it."""
        return t

    def _after_step(self, params: dict[str, torch.Tensor]) -> None:
        """What follows the elementwise update: nothing here."""

    def _owns_update(self, name: str) -> bool:
        """Whether this optimizer's update of leaf `name` counts in a
        global update norm (every leaf here: it updates them whole)."""
        return True

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
             norm: torch.Tensor | None = None, *, apply: bool = True,
             update_sq: dict[str, torch.Tensor] | None = None) -> float:
        """Apply one update in place; returns the learning rate it used.
        `norm` is the global gradient norm when the caller has it (the train
        step reports it; under several pipeline processes it spans every
        stage's gradients, not just `grads`); otherwise it is computed here.
        `update_sq` (a dict) receives, for each leaf whose update this
        optimizer owns, the fp32 sum of squares of the update it applies
        (-lr times the Adam direction plus decay: optax's `updates`).
        `apply=False` computes those updates from copies of the moments and
        changes nothing: the numerics guard's skipped step, whose update
        norms the reference still reports."""
        cfg = self.cfg
        if norm is None:
            norm = global_norm(grads.values())
        clip = cfg.max_grad_norm / torch.clamp(norm, min=cfg.max_grad_norm)
        lr = self.schedule(self.count)
        count_inc = self.count + 1
        mu_corr = 1.0 - cfg.beta1 ** count_inc
        nu_corr = 1.0 - cfg.beta2 ** count_inc
        for name, leaf in params.items():
            p = self._part(name, leaf)
            g = self._part(name, grads[name]).float() * clip
            mu, nu = self.mu[name], self.nu[name]
            if not apply:
                mu, nu = mu.clone(), nu.clone()
            mu.mul_(cfg.beta1).add_(g, alpha=1.0 - cfg.beta1)
            nu.mul_(cfg.beta2).addcmul_(g, g, value=1.0 - cfg.beta2)
            update = (mu / mu_corr) / ((nu / nu_corr).sqrt_() + cfg.eps)
            update.add_(p, alpha=cfg.weight_decay)
            if update_sq is not None and self._owns_update(name):
                update_sq[name] = torch.linalg.vector_norm(update).square() * (lr * lr)
            if apply:
                p.add_(update, alpha=-lr)
        if apply:
            self._after_step(params)
            self.count = count_inc
        return lr


def zero1_dim(shape: tuple[int, ...], dp: int, skip: int | None = None) -> int | None:
    """The dim a leaf's Adam moments are split over dp on (ZeRO-1): the
    rightmost one that dp divides, other than `skip` (the dim tp already
    splits), else None (the moments stay replicated). The reference's
    `_zero1_leaf_spec` (parallel/train_step.py) on a leaf of this package's
    layout: a chunk's layer leaves are [k, ...], the reference's
    stage-stacked [S, k, ...] without the stage dim it never splits, and the
    embedding, norm and lm_head are the same there; a tp rank's slice has
    the global sizes on every dim but `skip`, which the reference never
    picks."""
    if dp == 1:
        return None
    for dim in range(len(shape) - 1, -1, -1):
        if dim != skip and shape[dim] % dp == 0:
            return dim
    return None


def zero1_dims(shapes: dict[str, tuple[int, ...]], dp: int, tp: int = 1
               ) -> dict[str, int | None]:
    """zero1_dim of each leaf (named canonically or as a chunk's), skipping
    the dim tp splits when tp > 1 (parallel/tp.tp_dim)."""
    return {name: zero1_dim(shape, dp, tp_dim(name, len(shape)) if tp > 1 else None)
            for name, shape in shapes.items()}


def dp_part(t: torch.Tensor, dim: int | None, dp: int, index: int) -> torch.Tensor:
    """Replica `index`'s slice of `t` on `dim` among `dp` (a view; `t`
    itself when `dim` is None)."""
    if dim is None:
        return t
    n = t.shape[dim] // dp
    return t.narrow(dim, index * n, n)


class Zero1AdamW(AdamW):
    """AdamW with ZeRO-1 moments: replica `index` of `dp` holds, of each
    leaf, the slice of mu and nu on zero1_dim (1/dp of the leaf's moment
    bytes), updates that slice of the fp32 masters, then all-gathers the
    masters over `group` (the stage's dp group). Under tp (`tp` > 1) the
    leaves are a tp rank's slices and the split never takes the tp dim. The gradients it reads are
    already summed over dp, so every replica computes the same update of its
    slice as the replicated AdamW, element for element: the masters are
    bit-equal to that AdamW's. A leaf with no dim dp divides is updated
    whole on every replica. A checkpoint reads this replica's slices where
    they lie (ckpt/gather.py: process 0 joins them one leaf at a time), and
    `load_state_dict` takes full moments and keeps this replica's slices
    (AdamW.load_state_dict through _part)."""

    def __init__(self, params: dict[str, torch.Tensor], cfg: OptimizerConfig, dp: int,
                 index: int, group, tp: int = 1):
        self.dp, self.index, self.group = dp, index, group
        self.dims = zero1_dims({k: tuple(p.shape) for k, p in params.items()}, dp, tp)
        super().__init__(params, cfg)

    def _part(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return dp_part(t, self.dims[name], self.dp, self.index)

    def _owns_update(self, name: str) -> bool:
        # a split leaf's slice is this replica's alone; a whole leaf counts
        # on replica 0
        return self.dims[name] is not None or self.index == 0

    def _gather(self, name: str, part: torch.Tensor, out: torch.Tensor) -> None:
        """The full leaf into `out` from every replica's `part`."""
        dim = self.dims[name]
        n = out.shape[dim] // self.dp
        for j, got in enumerate(distributed.all_gather(part, self.group)):
            out.narrow(dim, j * n, n).copy_(got)

    def _after_step(self, params: dict[str, torch.Tensor]) -> None:
        for name, p in params.items():
            if self.dims[name] is not None:
                self._gather(name, self._part(name, p), p)

    def state_dict(self) -> dict:
        raise NotImplementedError(
            "Zero1AdamW holds 1/dp of each split moment; a checkpoint takes its slices "
            "through ckpt/gather.ShardedState")
