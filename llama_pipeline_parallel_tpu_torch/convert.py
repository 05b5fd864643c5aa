"""Carry parameters and optimizer state between the JAX package and this port.

The JAX package keeps its parameters as a nested dict of arrays
(llama_pipeline_parallel_tpu/models/llama/model.py `init_params`); this port
keeps the same leaves, in the same `[in, out]` layout, under dotted names
(models/llama/model.py). Both directions are therefore copies: no transpose,
no reshape. The JAX optimizer state is optax's chain of clip and adamw, whose
`ScaleByAdamState` (count, mu, nu) is the port's `AdamW.state_dict()`
(optim/optimizer.py). Leaves cross as numpy arrays, so neither package
imports the other.

The JAX pipeline keeps its layer leaves stage-stacked (its parallel/pipeline.py
`stack_stages`): `[S, k, ...]` for an even flat partition, `[S, v, k, ...]`
interleaved (global chunk c at `[c % S, c // S]`), `[S, k_max, ...]` with
zero padding slots for uneven `layer_counts`. `unstack_stages` /
`stack_stages` are the same maps in numpy, and `stage_params_from_jax` /
`stage_params_to_jax` carry such a tree to this port's per-chunk trees
(parallel/pipeline.py `split_params`) and back.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from llama_pipeline_parallel_tpu_torch.models.llama.manifest import StageManifest
from llama_pipeline_parallel_tpu_torch.parallel.pipeline import merge_params, split_params


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


def _stage_slots(manifest: StageManifest) -> np.ndarray:
    """[num_layers] index of each layer's slot in the flattened [S * k_max]
    stacked layer axis of a flat (v = 1) partition."""
    k = manifest.max_layers_per_stage
    slot = np.zeros(manifest.num_layers, np.int64)
    for st in range(manifest.num_stages):
        for j, layer in enumerate(manifest.layers_of_stage(st)):
            slot[layer] = st * k + j
    return slot


def unstack_stages(tree: dict, manifest: StageManifest) -> dict:
    """The JAX pipeline's stage-stacked tree (numpy leaves) -> the canonical
    tree, layer leaves [num_layers, ...] (the padding slots of an uneven
    partition dropped)."""
    s, v = manifest.num_stages, manifest.virtual_stages

    def leaf(x):
        x = np.asarray(x)
        if v > 1:  # [S, v, k, ...] -> [v, S, k, ...] -> [n, ...]
            return np.moveaxis(x, 1, 0).reshape((manifest.num_layers,) + x.shape[3:])
        flat = x.reshape((s * x.shape[1],) + x.shape[2:])
        return flat[_stage_slots(manifest)]

    out = dict(tree)
    out["layers"] = _map_leaves(leaf, tree["layers"])
    return out


def stack_stages(tree: dict, manifest: StageManifest) -> dict:
    """The canonical tree -> the JAX pipeline's stage-stacked layout (numpy
    leaves; an uneven partition's padding slots zero)."""
    s, v, k = manifest.num_stages, manifest.virtual_stages, manifest.max_layers_per_stage

    def leaf(x):
        x = np.asarray(x)
        if v > 1:
            kc = manifest.layers_per_chunk
            return np.moveaxis(x.reshape((v, s, kc) + x.shape[1:]), 0, 1)
        out = np.zeros((s * k,) + x.shape[1:], x.dtype)
        out[_stage_slots(manifest)] = x
        return out.reshape((s, k) + x.shape[1:])

    out = dict(tree)
    out["layers"] = _map_leaves(leaf, tree["layers"])
    return out


def _map_leaves(fn, node):
    if isinstance(node, dict):
        return {key: _map_leaves(fn, value) for key, value in node.items()}
    return fn(node)


def stage_params_from_jax(stacked: dict, manifest: StageManifest,
                          stages: tuple[int, ...] | None = None) -> dict[int, list]:
    """The JAX pipeline's stage-stacked params (numpy-convertible leaves) ->
    this port's {stage: [chunk trees]} of `stages` (default all), values kept
    exactly."""
    return split_params(params_from_jax(unstack_stages(stacked, manifest)), manifest, stages)


def stage_params_to_jax(chunks: dict[int, list], manifest: StageManifest) -> dict:
    """Every stage's chunk trees -> the JAX pipeline's stage-stacked tree of
    numpy arrays."""
    return stack_stages(params_to_jax(merge_params(chunks, manifest)), manifest)
