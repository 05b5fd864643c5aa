"""Carry parameters and optimizer state between the JAX package and this port.

The JAX package keeps its parameters as a nested dict of arrays
(llama_pipeline_parallel_tpu/models/llama/model.py `init_params`); this port
keeps the same leaves, in the same `[in, out]` layout, under dotted names
(models/llama/model.py). Both directions are therefore copies: no transpose,
no reshape. The JAX optimizer state is optax's chain of clip and adamw, whose
`ScaleByAdamState` (count, mu, nu) is the port's `AdamW.state_dict()`
(optim/optimizer.py). Leaves cross as numpy arrays, so neither package
imports the other.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _flatten(tree: dict, prefix: str = "") -> dict[str, Any]:
    flat = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(_flatten(value, name + "."))
        else:
            flat[name] = value
    return flat


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """Nested dict of numpy(-convertible) leaves -> {dotted name: CPU tensor},
    values kept exactly (bf16 leaves widen to fp32: torch has no view of
    numpy's bf16)."""
    out = {}
    for name, leaf in _flatten(tree).items():
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
        out[name] = torch.from_numpy(np.array(arr, copy=True))
    return out


def params_to_jax(params: dict[str, torch.Tensor]) -> dict:
    """{dotted name: tensor} -> nested dict of numpy arrays (bf16 widened to
    fp32, exactly; numpy has no bf16 of its own)."""
    tree: dict = {}
    for name, tensor in params.items():
        t = tensor.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        node = tree
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t.numpy().copy()
    return tree


def _is_state(node: Any, fields: tuple[str, ...]) -> bool:
    """Whether `node` is an optax state namedtuple with exactly `fields`."""
    return isinstance(node, tuple) and getattr(node, "_fields", None) == fields


_ADAM_FIELDS = ("count", "mu", "nu")  # optax ScaleByAdamState
_SCHEDULE_FIELDS = ("count",)         # optax ScaleByScheduleState


def _find_adam(opt_state: Any) -> Any:
    found = []

    def walk(node):
        if _is_state(node, _ADAM_FIELDS):
            found.append(node)
        elif isinstance(node, (tuple, list)):
            for child in node:
                walk(child)

    walk(opt_state)
    if len(found) != 1:
        raise ValueError(f"expected one optax ScaleByAdamState in the state, found {len(found)}")
    return found[0]


def optimizer_state_from_jax(opt_state: Any) -> dict:
    """The JAX trainer's optax state (numpy-convertible leaves) -> the
    port's `AdamW.state_dict()` form: {"mu": {name: CPU tensor}, "nu": ...,
    "count": int}, values kept exactly; load it with
    `AdamW.load_state_dict`."""
    adam = _find_adam(opt_state)
    return {"mu": params_from_jax(adam.mu), "nu": params_from_jax(adam.nu),
            "count": int(np.asarray(adam.count))}


def optimizer_state_to_jax(state: dict, template: Any) -> Any:
    """The port's `AdamW.state_dict()` -> an optax state shaped like
    `template` (e.g. `tx.init(params)` of the JAX trainer's optimizer), its
    ScaleByAdamState taking mu, nu and count, and the schedule's count
    following, as both count the updates so far. Leaves are numpy arrays."""
    adam = _find_adam(template)
    count = np.asarray(int(state["count"]), dtype=np.asarray(adam.count).dtype)

    def walk(node):
        if _is_state(node, _ADAM_FIELDS):
            return node._replace(count=count, mu=params_to_jax(state["mu"]),
                                 nu=params_to_jax(state["nu"]))
        if _is_state(node, _SCHEDULE_FIELDS):
            return node._replace(count=count)
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(child) for child in node))
        if isinstance(node, (tuple, list)):
            return type(node)(walk(child) for child in node)
        return node

    return walk(template)
