"""The reference's first training steps, and the numbers the comparison reads.

A step is the loss's token mean over the whole batch (summed over every row's
kept targets, divided once by their count), its gradient, the clip by the
global norm and AdamW as optax chains them (moments in fp32, bias correction
at the incremented count, eps outside the square root, decoupled weight decay
on every leaf, the learning rate read at the count before the update). The
learning rate warms up linearly from 0 over `max(int(total * proportion), 1)`
steps, then decays linearly to 0 at `total_steps`.

Returned numbers: each step's loss, the norm of each leaf's first gradient
after clipping (what the optimizer is given), and the norm of each leaf's
change over the steps run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bench_port import weights
from bench_port.reference.model import IGNORE_INDEX, loss_sum
from bench_port.reference.packing import shift_targets

ACTIVATION_BUDGET = 20 << 30  # fp32 activations a row block may keep without remat


@dataclasses.dataclass
class Numbers:
    losses: list[float]
    grad1: dict[str, float]
    change: dict[str, float]


def learning_rate(trainer: dict, count: int) -> float:
    peak, total = trainer["learning_rate"], trainer["total_steps"]
    warmup = max(int(total * trainer["warmup_proportion"]), 1)
    if count < warmup:
        return peak * count / warmup
    return peak * max(1.0 - (count - warmup) / (total - warmup), 0.0)


def _remat(model: dict, tokens: int) -> bool:
    d, f = model["hidden_size"], model["intermediate_size"]
    return tokens * model["num_hidden_layers"] * (10 * d + 4 * f) * 4 > ACTIVATION_BUDGET


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t, dtype=torch.float64))


def run(model: dict, trainer: dict, seed: int, steps: list[dict], device,
        quant: str | None = None) -> Numbers:
    """Train the seeded weights on `steps` (each the rows packing.py builds)."""
    names = list(weights.leaf_shapes(model))
    params = {n: weights.make_leaf(model, n, seed, device).requires_grad_() for n in names}
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    b1, b2 = trainer["adam_beta1"], trainer["adam_beta2"]
    losses, grad1 = [], {}
    for t, rows in enumerate(steps):
        targets = shift_targets(rows["labels"])
        count = max(int((targets != IGNORE_INDEX).sum()), 1)
        remat = _remat(model, rows["input_ids"].shape[1])
        total = torch.zeros((), dtype=torch.float64, device=device)
        for r in range(rows["input_ids"].shape[0]):
            part = {k: torch.from_numpy(np.ascontiguousarray(v[r:r + 1])).to(device)
                    for k, v in rows.items()}
            loss = loss_sum(params, part["input_ids"], part["segments"], part["positions"],
                            torch.from_numpy(targets[r:r + 1]).to(device), model, quant,
                            remat) / count
            loss.backward()
            total += loss.detach().double()
        losses.append(float(total))
        with torch.no_grad():
            norm = torch.sqrt(sum(p.grad.double().square().sum() for p in params.values()))
            clip = float(trainer["max_grad_norm"] / max(float(norm), trainer["max_grad_norm"]))
            lr = learning_rate(trainer, t)
            for n, p in params.items():
                g = p.grad * clip
                if t == 0:
                    grad1[n] = _norm(g)
                mu[n].mul_(b1).add_(g, alpha=1 - b1)
                nu[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                update = (mu[n] / (1 - b1 ** (t + 1))) / (
                    (nu[n] / (1 - b2 ** (t + 1))).sqrt() + trainer["adam_eps"])
                p.sub_(lr * (update + trainer["weight_decay"] * p))
                p.grad = None
    del mu, nu
    with torch.no_grad():
        change = {n: _norm(p - weights.make_leaf(model, n, seed, device))
                  for n, p in params.items()}
    return Numbers(losses, grad1, change)
