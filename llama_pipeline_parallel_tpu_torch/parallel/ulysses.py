"""Ulysses sequence parallelism: all-to-all head scatter.

The counterpart of llama_pipeline_parallel_tpu/parallel/ulysses.py. Instead
of rotating k / v around a ring, two all-to-alls re-shard the activations
from sequence-sharded to head-sharded and back (`distributed.all_to_all`
over the sp group): each process then runs the ordinary attention (flash or
exact) over the FULL sequence for its share of the heads, which needs the
head count to divide by sp.

`_AllToAll` is an autograd Function whose backward is the reverse
all-to-all, as the transpose of jax's `all_to_all` is there. The segment
ids are all-gathered over the group (no gradient).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from llama_pipeline_parallel_tpu_torch.ops.attention import attention, repeat_kv
from llama_pipeline_parallel_tpu_torch.parallel import distributed


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return distributed.all_to_all(x.contiguous(), group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        g = distributed.all_to_all(g.contiguous(), group, concat_dim, split_dim)
        return g, None, None, None


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      padding_mask: Any = None, *, causal: bool = True, group: Any = None,
                      inner_attn: Callable = attention) -> torch.Tensor:
    """q: [b, s_local, h, hd]; k / v: [b, s_local, h_kv, hd], the sequence
    split over `group` (the sp group). GQA groups whose kv-head count does
    not divide the sp size are expanded first, by the smallest repeat that
    makes it divide. `inner_attn` is any AttnFn (exact or flash): it sees
    the full sequence, so no offsets are needed."""
    n = distributed.group_place(group)[1]
    h, h_kv = q.shape[2], k.shape[2]
    if h % n:
        raise ValueError(f"num heads {h} must be divisible by sp={n}")
    if h_kv % n:
        # minimal GQA expansion (full expansion would double the all-to-all
        # traffic for nothing: the inner attention re-expands groups itself)
        g = h // h_kv
        r = next(r for r in range(1, g + 1) if g % r == 0 and (h_kv * r) % n == 0)
        k, v = repeat_kv(k, r), repeat_kv(v, r)

    def scatter_heads(x):
        # [b, s_local, h', hd] -> [b, s_full, h' / n, hd]
        return _AllToAll.apply(x, group, 2, 1)

    qg, kg, vg = scatter_heads(q), scatter_heads(k), scatter_heads(v)
    if padding_mask is not None:
        padding_mask = distributed.all_gather_dim(
            torch.as_tensor(padding_mask, device=q.device).contiguous(), group, 1)
    out = inner_attn(qg, kg, vg, padding_mask, causal=causal)
    # [b, s_full, h / n, hd] -> [b, s_local, h, hd]
    return _AllToAll.apply(out, group, 1, 2)
