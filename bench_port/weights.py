"""Seeded weights, made on the device, shared by the program and the reference.

Every leaf of the LLaMA parameter tree (the names are the published model's,
flattened: `embed.embedding`, `layers.attn.wq`, ..., `norm`, `lm_head`; layer
leaves carry a leading layer axis and keep the `[in, out]` layout) is drawn in
one call from a generator of its own, seeded by (seed, leaf). So a leaf can be
drawn again alone, after training has moved it, to measure the change. The
matrices are normal(0, 0.02) (the published `initializer_range`), the norms 1,
all fp32: the masters the configuration trains.
"""

from __future__ import annotations

import numpy as np
import torch

INIT_STD = 0.02


def leaf_shapes(model: dict) -> dict[str, tuple[int, ...]]:
    """The parameter tree of a model block of a configuration file."""
    n, d = model["num_hidden_layers"], model["hidden_size"]
    f, v = model["intermediate_size"], model["vocab_size"]
    heads, kv = model["num_attention_heads"], model["num_key_value_heads"]
    hd = d // heads
    return {
        "embed.embedding": (v, d),
        "layers.attn.wq": (n, d, heads * hd),
        "layers.attn.wk": (n, d, kv * hd),
        "layers.attn.wv": (n, d, kv * hd),
        "layers.attn.wo": (n, heads * hd, d),
        "layers.mlp.gate": (n, d, f),
        "layers.mlp.up": (n, d, f),
        "layers.mlp.down": (n, f, d),
        "layers.input_norm": (n, d),
        "layers.post_norm": (n, d),
        "norm": (d,),
        "lm_head": (d, v),
    }


def leaf_seed(seed: int, name: str) -> int:
    """A 63-bit generator seed for (seed, leaf); `seed` may be any size."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32] + [ord(c) for c in name]
    return int(np.random.SeedSequence(words).generate_state(2, np.uint64)[0] >> np.uint64(1))


def make_leaf(model: dict, name: str, seed: int, device: str | torch.device) -> torch.Tensor:
    """Leaf `name` of the seeded weights, fp32 on `device`."""
    shape = leaf_shapes(model)[name]
    if name.endswith("norm"):
        return torch.ones(shape, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, name))
    out = torch.empty(shape, dtype=torch.float32, device=device)
    return out.normal_(0.0, INIT_STD, generator=gen)
