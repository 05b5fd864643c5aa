"""Sequence-parallel attention for the training step.

The counterpart of llama_pipeline_parallel_tpu/parallel/sp.py: under sp > 1
every activation holds this process's slab of the sequence
(parallel/mesh.sp_slab), and `make_sp_attention` wraps the run's AttnFn so
that attention is exact over the whole sequence anyway: k / v slabs rotate
around the sp group (ring, parallel/ring_attention.py) or the activations
re-shard head-wise by all-to-all (Ulysses, parallel/ulysses.py).
`check_sp` is what the reference's pipeline build refuses under sp.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from llama_pipeline_parallel_tpu_torch.ops.attention import repeat_kv
from llama_pipeline_parallel_tpu_torch.ops.flash_attention import flash_attention
from llama_pipeline_parallel_tpu_torch.parallel.ring_attention import ring_attention
from llama_pipeline_parallel_tpu_torch.parallel.ulysses import ulysses_attention

SP_STRATEGIES = ("ring", "ulysses")


def check_sp(cfg, tp: int, sp: int, kind: str) -> None:
    """The reference's refusals under sp: a strategy it does not know, and
    Ulysses with heads of a tp rank that do not divide by sp."""
    if kind not in SP_STRATEGIES:
        raise ValueError(f"unknown sequence_parallel {kind!r}; choose one of {SP_STRATEGIES}")
    if sp > 1 and kind == "ulysses":
        local_heads = cfg.num_attention_heads // max(tp, 1)
        if local_heads % sp:
            raise ValueError(
                f"sequence_parallel=ulysses needs heads/tp divisible by sp: "
                f"{cfg.num_attention_heads}/{tp} = {local_heads} vs sp={sp} "
                f"(use sequence_parallel=ring, which has no head constraint)")


def make_sp_attention(kind: str, inner_attn: Callable, group: Any,
                      packed: bool = False) -> Callable:
    """Wrap an AttnFn so it computes full-sequence attention over the slabs
    of `group` (the sp group).

    `inner_attn` is the attention the run would use without sp (exact or
    flash): Ulysses calls it on the re-sharded full-sequence view; the ring
    takes its per-slab backend from it (the flash kernels when it is
    `flash_attention`, the exact twins otherwise). `packed`: the run's
    batches carry PACKING segment ids in the mask, which the ring then
    rotates with its k / v; a plain right-padded mask is redundant under
    causal masking and is dropped, so the ring carries no segment stream.
    `kind` is one of SP_STRATEGIES (`check_sp`)."""
    if kind == "ring":
        backend = "flash" if inner_attn is flash_attention else "exact"

        def ring_fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    padding_mask: Any = None, *, causal: bool = True) -> torch.Tensor:
            # slabs rotate at one shape: expand GQA groups up front (the
            # gradient of the expansion is the group sum)
            n_rep = q.shape[2] // k.shape[2]
            k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
            return ring_attention(q, k, v, padding_mask if packed else None, causal=causal,
                                  group=group, backend=backend)

        return ring_fn

    def ulysses_fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   padding_mask: Any = None, *, causal: bool = True) -> torch.Tensor:
        return ulysses_attention(q, k, v, padding_mask, causal=causal, group=group,
                                 inner_attn=inner_attn)

    return ulysses_fn
