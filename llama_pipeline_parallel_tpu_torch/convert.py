"""Carry parameters between the JAX package and this port.

The JAX package keeps its parameters as a nested dict of arrays
(llama_pipeline_parallel_tpu/models/llama/model.py `init_params`); this port
keeps the same leaves, in the same `[in, out]` layout, under dotted names
(models/llama/model.py). Both directions are therefore copies: no transpose,
no reshape. Leaves cross as numpy arrays, so neither package imports the
other.
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
