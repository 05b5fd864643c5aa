"""Tensor parallelism: the Megatron operator pair, the vocab-parallel max, and
which dim of each leaf is split over the tp ranks.

The counterpart of llama_pipeline_parallel_tpu/parallel/tp.py over a
`torch.distributed` process group (the tp group: the processes of one stage of
one replica, parallel/mesh.py). Column-parallel q/k/v/gate/up and row-parallel
wo/down need:

- `tp_copy` ("f"): identity forward, all-reduce backward: placed where a
  replicated activation fans out into column-sharded products, so the
  gradient of the replicated input (and through it the norms' and the
  embedding's) is summed over the tp ranks;
- `tp_reduce` ("g"): all-reduce forward, identity backward: on the partial
  outputs of row-sharded products;
- `tp_max`: all-reduce max forward, zero gradient: the vocab-parallel CE's
  stability shift, which cancels mathematically.

Each sums in the tensor's own dtype (the compute dtype), as the reference's
psum does. With no group (tp = 1) each is the identity.

`TP_DIMS` is `stage_param_specs(tp=True)`'s placement, counted from the
trailing dims so that canonical `[num_layers, ...]` and chunk `[k, ...]`
leaves split alike: q/k/v/gate/up on their output dim, wo/down on their input
dim, lm_head on its vocab dim; the norms and the embedding are replicated.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from llama_pipeline_parallel_tpu_torch.parallel import distributed

TP_DIMS = {"layers.attn.wq": -1, "layers.attn.wk": -1, "layers.attn.wv": -1,
           "layers.attn.wo": -2, "layers.mlp.gate": -1, "layers.mlp.up": -1,
           "layers.mlp.down": -2, "lm_head": -1}


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return distributed.all_reduce(g.contiguous().clone(), ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return distributed.all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Max(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return distributed.all_reduce(x.contiguous().clone(), group, op=dist.ReduceOp.MAX)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g), None


def tp_copy(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _Copy.apply(x, group)


def tp_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _Reduce.apply(x, group)


def tp_max(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _Max.apply(x, group)


def leaf_name(name: str) -> str:
    """The canonical name of a leaf named canonically or as a chunk's
    (`s{stage}c{chunk}/{name}`)."""
    return name.rsplit("/", 1)[-1]


def tp_dim(name: str, ndim: int) -> int | None:
    """The dim of a leaf of `ndim` dims that tp splits (TP_DIMS), or None for
    a replicated leaf."""
    dim = TP_DIMS.get(leaf_name(name))
    return None if dim is None else dim % ndim


def tp_shard(name: str, t: torch.Tensor, rank: int, tp: int) -> torch.Tensor:
    """Rank `rank`'s slice of leaf `name` among `tp` (a view; the leaf itself
    when replicated or tp = 1)."""
    dim = tp_dim(name, t.dim())
    if tp == 1 or dim is None:
        return t
    n = t.shape[dim] // tp
    return t.narrow(dim, rank * n, n)


def check_tp(cfg, tp: int, loss_chunks: int = 1, kernel_ce: bool = False) -> None:
    """What the reference's pipeline build refuses under tp > 1, in its
    words: a chunked or kernel CE head (the vocab-parallel CE never builds
    full logits), and a tp that does not divide the heads, the kv heads,
    the FFN width or the vocabulary."""
    if tp == 1:
        return
    if loss_chunks > 1:
        raise ValueError("loss_chunks > 1 is redundant under tp > 1: the "
                         "vocab-parallel CE already never materializes full logits")
    if kernel_ce:
        raise ValueError("kernels.ce=pallas is redundant under tp > 1: the "
                         "vocab-parallel CE already never materializes full logits "
                         "(shard the head wider instead)")
    if cfg.kv_heads % tp or cfg.num_attention_heads % tp:
        raise ValueError(f"tp={tp} must divide both num_attention_heads="
                         f"{cfg.num_attention_heads} and kv_heads={cfg.kv_heads}")
    if cfg.intermediate_size % tp:
        raise ValueError(f"tp={tp} must divide intermediate_size={cfg.intermediate_size}")
    if cfg.vocab_size % tp:
        raise ValueError(f"tp={tp} must divide vocab_size={cfg.vocab_size} "
                         f"(vocab-parallel lm_head)")


def grad_sq_sum(grads: dict[str, torch.Tensor], group) -> torch.Tensor:
    """The fp32 sum of squares of the gradients of the whole (unsplit)
    leaves that `grads` holds this tp rank's slices of: the split leaves'
    partial sums added over the tp group, each replicated leaf (whose
    gradient is whole and the same on every tp rank) counted once. Without
    a group, the plain sum in leaf order."""
    if group is None:
        return torch.stack([g.float().square().sum() for g in grads.values()]).sum()
    zero = torch.zeros((), device=next(iter(grads.values())).device)
    split, whole = zero.clone(), zero.clone()
    for name, g in grads.items():
        part = g.float().square().sum()
        if tp_dim(name, g.dim()) is None:
            whole += part
        else:
            split += part
    return distributed.all_reduce(split, group) + whole


def vocab_parallel_loss_sum_count(hn: torch.Tensor, w_local: torch.Tensor,
                                  targets: torch.Tensor, group, ignore_index: int
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's `_vocab_parallel_token_loss` on next-token `targets`
    (preshifted): each tp rank's logits of its [d, V/tp] slice of lm_head
    (a plain product, as the reference computes it outside any kernel), the
    row max over the ranks (tp_max), and the ranks' sums of exponentials and
    the target logit of the rank that owns it (tp_reduce); `hn` enters
    through tp_copy, so its gradient is summed over the ranks. Returns (the
    fp32 loss sum, the valid-target count), the same on every rank."""
    rank = dist.get_rank(group)
    hc = tp_copy(hn, group)
    logits = (hc @ w_local).float()
    v_local = w_local.shape[1]
    valid = targets != ignore_index
    m = tp_max(logits.detach().amax(dim=-1), group)
    z = tp_reduce(torch.exp(logits - m[..., None]).sum(dim=-1), group)
    local_idx = torch.where(valid, targets, 0).long() - rank * v_local
    owned = (local_idx >= 0) & (local_idx < v_local) & valid
    picked = logits.gather(-1, local_idx.clamp(0, v_local - 1)[..., None])[..., 0]
    target = tp_reduce(torch.where(owned, picked, torch.zeros_like(picked)), group)
    token_loss = (m + torch.log(z)) - target
    return torch.where(valid, token_loss, torch.zeros_like(token_loss)).sum(), valid.sum()
