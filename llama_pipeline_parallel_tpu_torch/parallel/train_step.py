"""The train step on one device: microbatched forward/backward, clip, AdamW.

The counterpart of llama_pipeline_parallel_tpu/parallel/train_step.py at
pp = dp = tp = sp = 1, where the pipeline's `_loss_and_grad_local`
(parallel/pipeline.py) degenerates to:

- count the valid next-token targets over the WHOLE step once;
- for each microbatch, take its loss sum over that global count and
  backpropagate it, accumulating the gradients in fp32 (`.grad` of the fp32
  masters) — so the sum is exactly the full-batch gradient;
- then clip and update.

The loss head is the reference's (`pipeline.py`'s `head`): the dense
lm_head + cross-entropy, or, with `loss_vocab_chunks > 1` or `kernels.ce:
pallas`, a fused head on the final-normed hidden states that never builds the
[tokens, V] logits — the vocab-chunked PyTorch op or the CUDA kernels.

Metrics are `loss`, `grad_norm` (before clipping, computed once and handed
to the optimizer), `lr` (the schedule at the step count before its increment)
and `step`, as in the reference. At pp > 1 the step's forward and backward
are a parallel/pipeline.Pipeline's. Under the host optimizer
(optim/offload.HostOffloadAdamW) the params are the working copy and the
gradients accumulate in fp32 buffers beside it (`grads`), microbatch by
microbatch in the same order (optim/offload.bind_fp32_grads).

`eval_step` is the loss-only pass (the reference's `make_pipeline_eval_fn`,
parallel/pipeline.py): the same microbatches, head and prologue under
`torch.no_grad()`, returning the (loss sum, valid count) pair so that the
evaluator weights batches exactly.

Data parallelism (`dp_group`: the process group of the replicas, None
alone): each replica runs its own rows; the valid-target count is summed
over the group before it divides, and the gradients, the loss and the eval
sums after, so every replica holds the whole batch's gradient (the
reference's psums over dp).

Tensor parallelism (`tp_group`: the process group of this replica's tp
ranks, None at tp = 1): each process holds its tp rank's slice of the split
leaves (parallel/tp.py), the layers run column- and row-parallel, the loss
head is the reference's vocab-parallel CE, and the gradient norm counts
each split leaf's slices over the group and each replicated leaf once.
`init_params_sharded` draws only the leaves (and rows, and tp slices) that a
process holds, with the same canonical values in every layout.

Sequence parallelism (`sp_group`: the processes of this replica's sequence
slabs, None at sp = 1): each process holds a column slab of every row
(parallel/mesh.sp_slab) and the attention is the sp-wrapped one
(parallel/sp.py). The next-token shift crosses the slab boundary (one ring
shift of each row's first label: `shift_labels`), rows without position ids
take positions from the slab's global start, and the valid-target count,
the loss, the gradients and the eval sums are summed over the slabs too (the
reference's psums over (dp, sp)); sp peers then hold the same gradients.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from llama_pipeline_parallel_tpu_torch.models.llama import model as llama
from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig
from llama_pipeline_parallel_tpu_torch.ops.attention import attention
from llama_pipeline_parallel_tpu_torch.ops.cross_entropy import fused_ce_sum_count
from llama_pipeline_parallel_tpu_torch.ops.fused_ce import kernel_ce_sum_count
from llama_pipeline_parallel_tpu_torch.optim.offload import HostOffloadAdamW, bind_fp32_grads
from llama_pipeline_parallel_tpu_torch.models.llama.manifest import StageManifest
from llama_pipeline_parallel_tpu_torch.optim.optimizer import AdamW
from llama_pipeline_parallel_tpu_torch.parallel import distributed
from llama_pipeline_parallel_tpu_torch.parallel.tp import (
    grad_sq_sum,
    tp_shard,
    vocab_parallel_loss_sum_count,
)
from llama_pipeline_parallel_tpu_torch.utils import numerics, timeline


@dataclasses.dataclass
class TrainState:
    step: int
    params: llama.Params  # fp32 masters, requires_grad; or the host optimizer's working copy
    optimizer: AdamW | HostOffloadAdamW


@dataclasses.dataclass(frozen=True)
class LossHead:
    """Which loss head a step runs: `loss_chunks` vocab chunks
    (`loss_vocab_chunks`), `kernel_ce` the CUDA kernels (`kernels.ce: pallas`)."""

    loss_chunks: int = 1
    kernel_ce: bool = False


def head_loss_sum_count(params: llama.Params, hn: torch.Tensor, targets: torch.Tensor,
                        cfg: LlamaConfig, head: LossHead, tp_group: Any = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss sum, valid count) of the final-normed hidden states `hn` against
    next-token `targets`, through `head` (reference: pipeline.py's `head`),
    or, under `tp_group`, the vocab-parallel CE of this rank's lm_head
    columns."""
    if tp_group is not None:
        return vocab_parallel_loss_sum_count(hn, params["lm_head"].to(cfg.dtype), targets,
                                             tp_group, llama.IGNORE_INDEX)
    if head.loss_chunks > 1 or head.kernel_ce:
        op = kernel_ce_sum_count if head.kernel_ce else fused_ce_sum_count
        return op(hn, params["lm_head"].to(cfg.dtype), targets, head.loss_chunks)
    return llama.token_loss_sum_and_count_preshifted(llama.lm_head(params, hn, cfg), targets)


def init_params_sharded(cfg: LlamaConfig, seed: int, manifest: StageManifest,
                        stages: tuple[int, ...], *, tp_rank: int = 0, tp: int = 1,
                        device: str | torch.device = "cuda") -> dict[int, list[llama.Params]]:
    """The trainer's init of what one process holds (the reference's
    `init_params_sharded`): {stage: [chunk trees]} of `stages`, each chunk's
    layer leaves only its layers' rows, its embedding / final norm / lm_head
    where the chunk owns them (parallel/pipeline.chunk_names), and of each
    split leaf only tp rank `tp_rank`'s slice. Each row is drawn whole from
    its own seed (model.init_leaf), so the pieces of every layout join into
    one process's init."""
    from llama_pipeline_parallel_tpu_torch.parallel.pipeline import chunk_names

    out = {}
    for s in stages:
        out[s] = []
        for c in range(manifest.virtual_stages):
            rows = manifest.layers_of_chunk(s, c)
            names = [n for n in llama.param_shapes(cfg) if n.startswith("layers.")]
            out[s].append({n: llama.init_leaf(
                cfg, n, seed, range(rows.start, rows.stop) if n.startswith("layers.") else None,
                device=device, cut=lambda t, n=n: tp_shard(n, t, tp_rank, tp))
                for n in names + list(chunk_names(manifest, s, c))})
    return out


def shift_labels(labels: torch.Tensor, sp_group: Any = None) -> torch.Tensor:
    """Next-token targets aligned with each position; the last position has
    none (IGNORE_INDEX). Under `sp_group` (the reference's
    `_sp_shift_labels`) `labels` is this process's slab: the target of its
    last position is the next slab's first label, fetched with one ring
    shift over the group, and only the last slab's last position has none."""
    rank, n = distributed.group_place(sp_group)
    ignore = torch.full_like(labels[:, :1], llama.IGNORE_INDEX)
    if n == 1:
        tail = ignore
    else:
        tail, = distributed.ring_shift([labels[:, :1].contiguous()], sp_group, shift=-1)
        if rank == n - 1:
            tail = ignore
    return torch.cat([labels[:, 1:], tail], dim=1)


def microbatches(batch: dict[str, torch.Tensor], num_microbatches: int, sp_group: Any = None):
    """(next-token targets [bsz, s], [(ids, mask, positions, targets) for each
    microbatch of `batch`]); mask and positions None where the batch has none,
    except that under `sp_group` a slab's rows without positions take them
    from the slab's global start (sp rank x slab length)."""
    ids = batch["input_ids"]
    bsz, seqlen = ids.shape
    if bsz % num_microbatches:
        raise ValueError(f"batch {bsz} not divisible by microbatches {num_microbatches}")
    mb = bsz // num_microbatches
    targets = shift_labels(batch["labels"], sp_group)
    mask, positions = batch.get("attention_mask"), batch.get("position_ids")
    sp_rank, sp = distributed.group_place(sp_group)
    if positions is None and sp > 1:
        positions = (sp_rank * seqlen + torch.arange(seqlen, device=ids.device)).expand(
            bsz, seqlen)
    rows = [slice(i * mb, (i + 1) * mb) for i in range(num_microbatches)]
    return targets, [(ids[r], None if mask is None else mask[r],
                      None if positions is None else positions[r], targets[r]) for r in rows]


def train_step(state: TrainState, batch: dict[str, torch.Tensor], cfg: LlamaConfig, *,
               num_microbatches: int = 1, attn_fn: Callable = attention,
               remat: bool = False, head: LossHead = LossHead(),
               kernel_prologue: bool = False, remat_policy: str = "nothing_saveable",
               pipeline: Any = None, grads: llama.Params | None = None,
               dp_group: Any = None, tp_group: Any = None, sp_group: Any = None,
               collect_stats: bool = False, poison_stage: int = -1, mesh: Any = None,
               manifest: StageManifest | None = None) -> dict:
    """One optimizer step over `batch` ([num_microbatches * mb, s] tensors on
    the params' device), updating `state` in place. `kernel_prologue` runs
    each layer's norm -> QKV -> RoPE on the fused prologue kernels
    (`kernels.prologue: pallas`); `remat` recomputes each layer in the
    backward under `remat_policy` (model.remat_layer). With `pipeline` (a
    parallel/pipeline.Pipeline whose StageParams.flat() are
    `state.params`) the forward and backward are its schedule's, and the
    other step knobs its config's; the gradient norm then spans every
    stage. `grads`: the fp32 gradient buffers of a working copy (the host
    optimizer's; the pipeline's StageParams hold the same tensors), zeroed
    here; None: the params' own `.grad`. `dp_group`: the replicas' process
    group at pp = 1 (a pipeline has its mesh's), `tp_group` its tp ranks',
    `sp_group` its sequence slabs' (`attn_fn` is then the sp-wrapped one).
    Returns the metrics.

    `collect_stats` (the numerics observatory, utils/numerics.py) adds
    `metrics["numerics"]`: the step's stats over `manifest`'s stages (the
    pipeline's, else one stage of the model's layers), global over `mesh`'s
    processes (default: the pipeline's), with the activation stats of each chunk's output and, on the
    on-card optimizer, each stage's update norm. It also arms the nonfinite
    guard there: when any gradient element is nonfinite, the params and the
    AdamW moments keep their values and count (optax's state, which the
    reference's where-select keeps) while the step counter still advances,
    as in the reference. The verdict is read on the host: one scalar read
    before the optimizer, the step's one synchronisation besides the loop's.
    The host optimizer (optim/offload.py, `skip_nonfinite`) skips from its
    global norm instead. `poison_stage` >= 0 scales that pipeline stage's
    layer gradients by +inf before the norm (the `grad_nonfinite` fault
    op). With the timeline installed (utils/timeline.py) the on-card
    optimizer's end is marked (`OPTIMIZER_BOUNDARY`). The reported `lr` is
    the schedule at the step counter (the reference's `schedule(state.step)`)
    on the on-card optimizer, the host optimizer's own otherwise."""
    params = state.params
    if grads is None:
        for p in params.values():
            p.grad = None
    else:
        for g in grads.values():
            g.zero_()
    act = {} if collect_stats else None
    if pipeline is not None:
        loss = pipeline.loss_and_grad(batch, act=act)
        manifest, mesh = pipeline.stage_params.manifest, mesh or pipeline.mesh
    else:
        targets, mbs = microbatches(batch, num_microbatches, sp_group)
        count = (targets != llama.IGNORE_INDEX).sum().float()
        global_count = sum_over(count, sp_group, dp_group).clamp(min=1)
        loss = torch.zeros((), device=targets.device)
        tap = None if act is None else functools.partial(numerics.act_fold, act, (0, 0))
        for ids, mask, positions, mb_targets in mbs:
            mb_params = params if grads is None else bind_fp32_grads(params, grads)
            hn = llama.hidden_states(mb_params, ids, mask, positions, cfg=cfg, attn_fn=attn_fn,
                                     remat=remat, kernel_prologue=kernel_prologue,
                                     remat_policy=remat_policy, tp_group=tp_group,
                                     act_tap=tap)
            mb_loss = head_loss_sum_count(mb_params, hn, mb_targets, cfg, head, tp_group)[0]
            mb_loss = mb_loss / global_count
            mb_loss.backward()
            loss += mb_loss.detach()
        sum_over(loss, sp_group, dp_group)
        for name, p in params.items():
            sum_over(p.grad if grads is None else grads[name], sp_group, dp_group)
        if manifest is None:
            manifest = StageManifest(num_layers=cfg.num_hidden_layers, num_stages=1)
    if grads is None:
        grads = {name: p.grad for name, p in params.items()}
    numerics.poison_grads(grads, poison_stage)
    grad_norm = (pipeline.global_norm() if pipeline is not None
                 else grad_sq_sum(grads, tp_group).sqrt())
    metrics = {"loss": loss, "grad_norm": grad_norm}
    optimizer = state.optimizer
    if collect_stats:
        stats = numerics.step_stats(params, grads, manifest, act=act, mesh=mesh,
                                    act_chunked=pipeline is not None
                                    and pipeline.pcfg.schedule in numerics.CHUNKED_SCHEDULES)
        metrics["numerics"] = stats
    if isinstance(optimizer, AdamW):  # the on-card optimizer (ZeRO-1 too)
        skip = collect_stats and bool(stats["nonfinite"])
        update_sq = {} if collect_stats else None
        metrics["lr"] = optimizer.schedule(state.step)
        optimizer.step(params, grads, grad_norm, apply=not skip, update_sq=update_sq)
        timeline.mark(timeline.OPTIMIZER_BOUNDARY,
                      0 if pipeline is None else pipeline.mesh.stages[0])
        if collect_stats:
            stats["update_norm_per_stage"] = numerics.update_norms(
                update_sq, manifest, loss.device, mesh)
    else:  # the host optimizer (its own guard), or any object with step()
        metrics["lr"] = optimizer.step(params, grads, grad_norm)
    state.step += 1
    metrics["step"] = state.step
    return metrics


@torch.no_grad()
def eval_step(params: llama.Params, batch: dict[str, torch.Tensor], cfg: LlamaConfig, *,
              num_microbatches: int = 1, attn_fn: Callable = attention,
              head: LossHead = LossHead(), kernel_prologue: bool = False,
              pipeline: Any = None, dp_group: Any = None, tp_group: Any = None,
              sp_group: Any = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The loss-only pass over `batch` in `num_microbatches` microbatches, on
    the training step's attention, head and prologue, with no autograd graph:
    (token-loss sum fp32, valid-target count) over the whole batch. With
    `pipeline`, its forward-only pass through every stage."""
    if pipeline is not None:
        return pipeline.loss_sum_count(batch)
    targets, mbs = microbatches(batch, num_microbatches, sp_group)
    loss_sum = torch.zeros((), device=targets.device)
    for ids, mask, positions, mb_targets in mbs:
        hn = llama.hidden_states(params, ids, mask, positions, cfg=cfg, attn_fn=attn_fn,
                                 kernel_prologue=kernel_prologue, tp_group=tp_group)
        loss_sum += head_loss_sum_count(params, hn, mb_targets, cfg, head, tp_group)[0].float()
    count = (targets != llama.IGNORE_INDEX).sum()
    return sum_over(loss_sum, sp_group, dp_group), sum_over(count, sp_group, dp_group)


def sum_over(t: torch.Tensor, *groups: Any) -> torch.Tensor:
    """`t` summed in place over each of `groups` in turn (None: nothing to
    sum), and returned."""
    for group in groups:
        distributed.all_reduce(t, group)
    return t
