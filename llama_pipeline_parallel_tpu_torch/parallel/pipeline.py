"""Pipeline parallelism: one interpreter of unit sequences over a stage transport.

The counterpart of llama_pipeline_parallel_tpu/parallel/pipeline.py. The
schedule is the reference's data: a per-flush `UnitSchedule` grid
(parallel/schedule.py) of F, B and W units per (tick, stage), the canonical
sequence of `1f1b`, `interleaved_1f1b` or `zb1`, or a `solver` sequence
loaded from `schedule_file`. `Pipeline` executes it tick by tick in plain
PyTorch:

- F (forward of a unit = one microbatch through one chunk of a stage's
  layers): the chunk forward without an autograd graph on the received
  input, which is buffered for the unit's backward (1F1B checkpoints at
  stage granularity); the output goes to the next stage. An F unit whose
  output nothing consumes (the last stage's last chunk) buffers its input
  and computes nothing: its B recomputes it.
- B: the chunk recomputed from the buffered input with autograd, then
  backpropagated from the received cotangent, or on the unit that owns the
  loss from the head's loss over the step's global valid-target count. The
  input's gradient goes to the previous stage. Fused schedules accumulate
  the parameters' gradients here too. Split-backward sequences (zb1, solver)
  recompute with the parameters DETACHED, so only input gradients are built
  (and the CE and prologue dW kernels never launch), and stash the (chunk
  input, cotangent) pair for the unit's W. B on (stage 0, chunk 0) then has
  nothing to compute: its input is the embedding lookup.
- W: the chunk recomputed from the stashed input, DETACHED, and
  backpropagated from the stashed cotangent into the parameters' fp32
  gradients, in the sequence's order.

Host offload (utils/host_stash.py): `offload_wgrad` (zb1) and a solver
sequence's `offload_units` push a B unit's (input, cotangent) pair to a
pinned host ring instead of keeping it on the card, and the W drain brings
each pair back one W unit ahead of its replay; `offload_activations` does the
same for the stage-input buffer between a unit's F and its B. The copies move
bytes: gradients and losses are the same bits with the tiers on or off.

Idle (-1) cells compute nothing. The tick's handoffs go through a
transport: a stage sends only what a valid unit produced for a valid unit
of the next tick, and posts a receive only for what a valid unit of the next
tick consumes; both ends read this from the same grid
(schedule.validate guarantees each consumed value was produced by the ring
neighbour on the tick before). `LocalTransport` runs every stage in one
process on one device and checks that the sends and receives match;
`DistTransport` runs one stage per process over torch.distributed,
posting each tick's sends and receives together (`batch_isend_irecv`).

Parameters: each chunk holds its own leaves (`StageParams`): the layer
leaves' slice of its layers (flat stages `[k_s, ...]`, one per stage, of
any length under uneven `layer_counts`; interleaved stages v chunks of
`[k, ...]`), the embedding on (stage 0, chunk 0), the final norm and
lm_head on the last stage's last chunk, one copy each. This replaces the
reference's stage-stacked, zero-padded layout and its pp-replicated
embed/head, whose gradients it psums over pp: the same mathematics.
`gradient_accumulation_chunks` runs sequential flushes, each normalised by
the one global token count, so the sum is the full-batch gradient. Under the
host optimizer (optim/offload.py) the leaves are the working copy in the
compute dtype and each gradient accumulates in an fp32 buffer beside it
(`StageParams(..., grads=...)`), in the same order as into the masters'
`.grad`.

Sequence parallelism (the mesh's sp group): every process of a stage's sp
group runs the same grid on its column slab of the rows, with the attention
wrapped by parallel/sp.make_sp_attention (`sequence_parallel`: ring or
ulysses) and the reference's sp terms: the label shift across slabs and
the slab's position base (train_step.microbatches), the valid-target count
summed over (dp, sp) before it divides, the loss over (pp, dp, sp) and every
gradient over (dp, sp) after. A decoder layer holds collectives under tp or
sp, so every sp peer must call the same ones in the same order: the grid
is the same on each, and the cells that compute nothing (the last stage's
F, zb1's B on the embedding chunk) compute nothing on every peer alike. The
reference's `_slot_valid` cond-skip has no counterpart here: the chunks
hold only their real layers.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from llama_pipeline_parallel_tpu_torch.models.llama import model as llama
from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig
from llama_pipeline_parallel_tpu_torch.models.llama.manifest import StageManifest
from llama_pipeline_parallel_tpu_torch.ops.attention import attention
from llama_pipeline_parallel_tpu_torch.optim.offload import bind_fp32_grads
from llama_pipeline_parallel_tpu_torch.parallel import distributed
from llama_pipeline_parallel_tpu_torch.parallel import schedule as usched
from llama_pipeline_parallel_tpu_torch.parallel.mesh import Mesh
from llama_pipeline_parallel_tpu_torch.parallel.sp import (
    SP_STRATEGIES,
    check_sp,
    make_sp_attention,
)
from llama_pipeline_parallel_tpu_torch.parallel.tp import check_tp, grad_sq_sum, tp_shard
from llama_pipeline_parallel_tpu_torch.parallel.train_step import (
    LossHead,
    head_loss_sum_count,
    microbatches,
    sum_over,
)
from llama_pipeline_parallel_tpu_torch.utils import host_stash, numerics, timeline
from llama_pipeline_parallel_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

Params = dict[str, torch.Tensor]

SCHEDULES = ("1f1b", "interleaved_1f1b", "zb1", "solver", "gpipe")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Schedule knobs, as the reference's PipelineConfig names and checks
    them.

    `remat` recomputes each layer inside a B or W unit's backward under
    `remat_policy`, on top of the stage-granularity recompute every unit
    schedule pays. `layer_counts`: per-stage layer counts of an uneven
    partition (None: even). `loss_chunks` / `kernel_ce` pick the loss head,
    `kernel_prologue` the decoder layers' prologue, as in the one-device
    step. `unit_schedule`: the per-flush sequence of `schedule: solver`.
    `offload_wgrad` (`offload.wgrad_stash`, zb1 only) keeps the W queue in
    host memory; a solver sequence carries its own per-unit vector instead.
    `offload_activations` (`offload.activations`) keeps the stage-input
    buffer there. `sequence_parallel` (ring or ulysses) is the attention
    strategy at sp > 1, `packed` whether the batches carry packing segment
    ids (the ring then rotates them with k / v); neither acts at sp = 1."""

    num_stages: int
    num_microbatches: int
    remat: bool = True
    remat_policy: str = "nothing_saveable"
    schedule: str = "1f1b"
    virtual_stages: int = 1
    accum_chunks: int = 1
    layer_counts: tuple | None = None
    loss_chunks: int = 1
    kernel_ce: bool = False
    kernel_prologue: bool = False
    unit_schedule: Any = dataclasses.field(default=None, compare=False, repr=False)
    offload_wgrad: bool = False
    offload_activations: bool = False
    sequence_parallel: str = "ring"
    packed: bool = False

    def __post_init__(self) -> None:
        if self.sequence_parallel not in SP_STRATEGIES:
            raise ValueError(f"unknown sequence_parallel {self.sequence_parallel!r}; "
                             f"choose one of {SP_STRATEGIES}")
        if self.num_microbatches < 1:
            raise ValueError("num_microbatches must be >= 1")
        if self.num_stages < 1:
            raise ValueError("num_stages must be >= 1")
        if self.schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {self.schedule!r}; choose one of {SCHEDULES}")
        check_offload_tiers(self.schedule, self.offload_wgrad, self.offload_activations)
        if self.loss_chunks < 1:
            raise ValueError("loss_chunks must be >= 1")
        if self.accum_chunks < 1 or self.num_microbatches % self.accum_chunks:
            raise ValueError(
                f"accum_chunks={self.accum_chunks} must divide "
                f"num_microbatches={self.num_microbatches}")
        if self.virtual_stages < 1:
            raise ValueError(f"virtual_stages must be >= 1, got {self.virtual_stages}")
        if self.virtual_stages > 1 and self.schedule not in ("interleaved_1f1b", "zb1", "solver"):
            raise ValueError(
                f"virtual_stages={self.virtual_stages} requires "
                f"schedule=interleaved_1f1b, zb1, or solver (got {self.schedule!r})")
        if self.layer_counts is not None:
            object.__setattr__(self, "layer_counts",
                               tuple(int(c) for c in self.layer_counts))
            if len(self.layer_counts) != self.num_stages:
                raise ValueError(
                    f"layer_counts has {len(self.layer_counts)} entries for "
                    f"num_stages={self.num_stages}")
        if self.schedule in ("interleaved_1f1b", "zb1", "solver"):
            uneven = self.layer_counts is not None and len(set(self.layer_counts)) != 1
            if uneven and (self.schedule == "interleaved_1f1b" or self.virtual_stages > 1):
                raise ValueError(
                    f"{self.schedule} with virtual_stages={self.virtual_stages} requires an "
                    f"even stage partition (the round-robin chunk layout has no uneven "
                    f"form); got layer_counts={self.layer_counts} — unequal stages run "
                    f"under zb1/solver at virtual_stages: 1, or the flat schedules")
            m_flush = self.num_microbatches // self.accum_chunks
            if (self.schedule != "solver" and self.virtual_stages > 1
                    and m_flush % self.num_stages):
                raise ValueError(
                    f"{self.schedule} with virtual_stages={self.virtual_stages} needs "
                    f"microbatches-per-flush ({self.num_microbatches}/{self.accum_chunks}="
                    f"{m_flush}) divisible by num_stages={self.num_stages} (the round-robin "
                    f"unit groups hold one microbatch per stage)")
        if self.schedule == "solver":
            self._check_solver_sequence()
        elif self.unit_schedule is not None:
            raise ValueError(f"unit_schedule is only meaningful under schedule: solver "
                             f"(got schedule={self.schedule!r})")
        if self.remat_policy not in llama.REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}; choose one of "
                             f"{llama.REMAT_POLICIES}")

    def _check_solver_sequence(self) -> None:
        us = self.unit_schedule
        if us is None:
            raise ValueError("schedule: solver needs a unit sequence — load one with the "
                             "trainer's schedule_file key")
        m_flush = self.num_microbatches // self.accum_chunks
        mismatches = [f"{name}: sequence {got} vs config {want}"
                      for name, got, want in (
                          ("num_stages", us.num_stages, self.num_stages),
                          ("virtual_stages", us.virtual_stages, self.virtual_stages),
                          ("microbatches-per-flush", us.num_microbatches, m_flush))
                      if got != want]
        if mismatches:
            raise ValueError(f"unit sequence does not fit this run: {'; '.join(mismatches)}")
        if us.stage_costs is not None:
            mine = tuple(self.layer_counts) if self.layer_counts is not None else None
            theirs = tuple(us.stage_costs)
            if len(set(theirs)) != 1 and theirs != mine:
                raise ValueError(
                    f"unit sequence was generated for stage layer counts {theirs} but this "
                    f"run partitions as {mine or 'even'} — re-emit the sequence for this "
                    f"partition")
        if self.offload_wgrad:
            raise ValueError("schedule: solver carries its own per-unit offload decision vector "
                             "— drop offload.wgrad_stash (the boolean is the all-or-nothing "
                             "special case)")
        usched.validate(us)


def check_offload_tiers(schedule: str, wgrad: bool, activations: bool) -> None:
    """The reference's rules for the host tiers: `offload.wgrad_stash`
    needs zb1 (only the split backward stashes a W queue), and
    `offload.activations` a schedule with a stage-input buffer (not gpipe)."""
    if wgrad and schedule not in ("zb1", "solver"):
        raise ValueError(f"offload.wgrad_stash requires schedule: zb1 (only the split backward "
                         f"stashes a W queue; got {schedule!r})")
    if activations and schedule == "gpipe":
        raise ValueError("offload.activations requires a hand-written-backward schedule (1f1b / "
                         "interleaved_1f1b / zb1): gpipe's stored activations are AD-internal, "
                         "there is no explicit ring buffer to tier")


def bubble_fraction(pcfg: PipelineConfig) -> float:
    """The counted bubble of the per-flush sequence (schedule.bubble_stats:
    idle units over wall units in the lockstep F = B = W cost model), as the
    reference reports it. On one card the stages run one after another, so
    the bubble costs no wall time there; it is what a pipeline across cards
    would idle."""
    s = pcfg.num_stages
    if s <= 1:
        return 0.0
    m, c = pcfg.num_microbatches, pcfg.accum_chunks
    idle, wall = usched.bubble_stats(_unit_schedule_for(
        dataclasses.replace(pcfg, num_microbatches=m // c, accum_chunks=1)))
    return (idle * c) / (wall * c) if wall else 0.0


def _unit_schedule_for(pcfg: PipelineConfig) -> usched.UnitSchedule:
    """The PER-FLUSH unit sequence the interpreter executes: the loaded
    solver sequence, or the canonical sequence of the named schedule.
    Callers pass a pcfg whose num_microbatches is already the per-flush
    count (accum_chunks=1)."""
    if pcfg.schedule == "gpipe":
        return gpipe_schedule(pcfg.num_microbatches // pcfg.accum_chunks, pcfg.num_stages)
    if pcfg.schedule == "solver":
        us = pcfg.unit_schedule
        if ((us.stage_costs is None or len(set(us.stage_costs)) == 1)
                and pcfg.layer_counts is not None and len(set(pcfg.layer_counts)) != 1):
            # a costless sequence on an unequal partition: attach the run's
            # layer counts so the bubble accounting stays honest
            us = dataclasses.replace(us, stage_costs=tuple(pcfg.layer_counts))
        return us
    counts = (tuple(pcfg.layer_counts) if pcfg.layer_counts is not None
              and len(set(pcfg.layer_counts)) != 1 else None)
    return _canonical_cached(pcfg.schedule, pcfg.num_microbatches // pcfg.accum_chunks,
                             pcfg.num_stages, pcfg.virtual_stages, pcfg.offload_wgrad, counts)


def flush_unit_schedule(pcfg: PipelineConfig) -> usched.UnitSchedule:
    """The per-flush unit sequence this config's interpreter executes."""
    return _unit_schedule_for(dataclasses.replace(
        pcfg, num_microbatches=pcfg.num_microbatches // pcfg.accum_chunks, accum_chunks=1))


def gpipe_schedule(m: int, s: int) -> usched.UnitSchedule:
    """gpipe's per-flush grid, as the reference runs it (the forward scan of
    `_pipeline_loss_local`, differentiated whole): a forward wave of every
    microbatch through every stage, m + S - 1 ticks (stage s runs
    microbatch t - s), then a backward wave of m + S - 1 ticks in ASCENDING
    microbatch order (stage s runs microbatch t - (S - 1 - s)), so each
    parameter folds its microbatches' gradients in the order flat 1F1B
    does. Flat layout only. The interpreter runs it as it runs 1F1B: F
    buffers its stage input and B recomputes the chunk from it (GPipe's
    rematerialisation at the stage boundary), so a stage holds O(m) stage
    inputs (ring_slots = m: no ring). No stage costs: its bubble is the
    reference's closed form c(S-1) / (M + c(S-1)) on any partition."""
    ticks = m + s - 1
    t_idx, st = np.arange(ticks)[:, None], np.arange(s)[None, :]
    fu, bu = t_idx - st, t_idx - (s - 1 - st)
    idle = np.full((ticks, s), -1, np.int32)
    f = np.concatenate([np.where((fu >= 0) & (fu < m), fu, -1).astype(np.int32), idle])
    b = np.concatenate([idle, np.where((bu >= 0) & (bu < m), bu, -1).astype(np.int32)])
    fwd = np.concatenate([np.ones(ticks, bool), np.zeros(ticks, bool)])
    return usched.UnitSchedule(
        num_stages=s, virtual_stages=1, num_microbatches=m, split_backward=False,
        f_unit=f, b_unit=b, w_unit=np.full_like(f, -1), has_f=fwd, has_b=~fwd,
        has_w=np.zeros(2 * ticks, bool), ring_fwd=fwd.copy(), ring_bwd=~fwd, ring_slots=m,
        offload_units=np.zeros(0, bool), wq_slot=np.zeros(0, np.int32), wq_hbm_slots=0,
        wq_host_slots=0, label="gpipe")


@functools.lru_cache(maxsize=64)
def _canonical_cached(schedule: str, m: int, s: int, v: int, offload_wgrad: bool = False,
                      stage_costs: tuple | None = None) -> usched.UnitSchedule:
    return usched.canonical_schedule(schedule, m, s, v, offload_wgrad=offload_wgrad,
                                     stage_costs=stage_costs)


# ---------------------------------------------------------------------------
# Byte models of the host tiers (the reference's, per stage)
# ---------------------------------------------------------------------------

def wgrad_partition(pcfg: PipelineConfig) -> tuple[int, int]:
    """(hbm_slots, host_slots) of the W queue's residual-pair slots: zb1's
    offload.wgrad_stash puts the whole queue on one side, a solver sequence's
    per-unit vector splits it."""
    if pcfg.schedule == "zb1":
        peak = (pcfg.num_microbatches // pcfg.accum_chunks) * pcfg.virtual_stages
        return (0, peak) if pcfg.offload_wgrad else (peak, 0)
    if pcfg.schedule == "solver" and pcfg.unit_schedule is not None \
            and pcfg.unit_schedule.split_backward:
        return pcfg.unit_schedule.wq_hbm_slots, pcfg.unit_schedule.wq_host_slots
    return 0, 0


def wgrad_queue_peak(pcfg: PipelineConfig) -> int:
    """Peak W-queue occupancy (HBM and host slots together); 0 for fused
    backward schedules."""
    return sum(wgrad_partition(pcfg))


def wgrad_offloaded_units(pcfg: PipelineConfig) -> int:
    """Per-flush count of W residual pairs that cross the link (down at B,
    up at W)."""
    if pcfg.schedule == "zb1" and pcfg.offload_wgrad:
        return (pcfg.num_microbatches // pcfg.accum_chunks) * pcfg.virtual_stages
    if pcfg.schedule == "solver" and pcfg.unit_schedule is not None:
        return pcfg.unit_schedule.offloaded_units
    return 0


def wgrad_stash_bytes(pcfg: PipelineConfig, mb_rows: int, local_seqlen: int,
                      hidden_size: int, dtype_bytes: int = 2) -> int:
    """Bytes of a stage's W queue: two hidden-sized buffers per queued unit."""
    return 2 * wgrad_queue_peak(pcfg) * mb_rows * local_seqlen * hidden_size * dtype_bytes


def activation_ring_slots(pcfg: PipelineConfig) -> int:
    """Stage-input buffer slots per flush: min(2S - 1, m) flat, min(2vS - 1,
    mv) chunked (the canonical sequences' ring_slots); 0 where there is none
    (gpipe, one flat stage)."""
    s, v = pcfg.num_stages, pcfg.virtual_stages
    m_flush = pcfg.num_microbatches // pcfg.accum_chunks
    if pcfg.schedule == "gpipe":
        return 0
    if pcfg.schedule == "solver" and pcfg.unit_schedule is not None:
        us = pcfg.unit_schedule
        return us.ring_slots if bool(us.has_f.any()) else 0
    if pcfg.schedule == "1f1b":
        return min(2 * s - 1, m_flush) if s > 1 else 0
    return min(2 * v * s - 1, m_flush * v)


def activation_ring_bytes(pcfg: PipelineConfig, mb_rows: int, local_seqlen: int,
                          hidden_size: int, dtype_bytes: int = 2) -> int:
    """Bytes of a stage's input buffer: what `offload.activations` moves to
    host memory."""
    return activation_ring_slots(pcfg) * mb_rows * local_seqlen * hidden_size * dtype_bytes


def stash_dims(mb_rows: int, seqlen: int, sp: int, hidden_size: int,
               dtype: torch.dtype) -> tuple[int, int, int, int]:
    """The (mb_rows, local_seqlen, hidden_size, dtype_bytes) every byte model
    here takes; `seqlen` is the row length, split over `sp`."""
    return (int(mb_rows), int(seqlen) // max(int(sp), 1), int(hidden_size),
            torch.empty((), dtype=dtype).element_size())


def host_stash_bytes(pcfg: PipelineConfig, mb_rows: int, local_seqlen: int,
                     hidden_size: int, dtype_bytes: int = 2) -> int:
    """Bytes a stage keeps in host memory under the enabled tiers, each
    ring's garbage slot included (utils/host_stash.py); 0 with both off."""
    slot = mb_rows * local_seqlen * hidden_size * dtype_bytes
    total = 0
    host_slots = wgrad_partition(pcfg)[1]
    if host_slots:
        total += 2 * host_slots * slot + 2 * slot
    if pcfg.offload_activations and activation_ring_slots(pcfg):
        total += activation_ring_bytes(pcfg, mb_rows, local_seqlen, hidden_size,
                                       dtype_bytes) + slot
    return total


def loss_head_bytes(pcfg: PipelineConfig, mb_rows: int, local_seqlen: int,
                    hidden_size: int, vocab_size: int) -> int:
    """Live bytes of the last stage's loss head (the reference's term,
    which tools/preflight.py's byte model adds and its selection scores as
    the ce axis): the dense and chunked heads hold one fp32 [tokens,
    V / loss_chunks] logits block, plus, when chunked, the backward's fp32
    [tokens, hidden] dh accumulator; the CE kernels (`kernels.ce: pallas`)
    keep only [tokens]-sized statistics, ~0."""
    tokens = mb_rows * local_seqlen
    if pcfg.kernel_ce:
        return 0
    logits_block = tokens * (vocab_size // max(pcfg.loss_chunks, 1)) * 4
    dh_acc = tokens * hidden_size * 4 if pcfg.loss_chunks > 1 else 0
    return logits_block + dh_acc


# ---------------------------------------------------------------------------
# Parameters: the canonical [num_layers, ...] tree <-> per-chunk trees
# ---------------------------------------------------------------------------

EMBED = "embed.embedding"
HEAD = ("norm", "lm_head")


def chunk_names(manifest: StageManifest, stage: int, chunk: int) -> tuple[str, ...]:
    """The non-layer leaves a chunk holds: the embedding on (stage 0, chunk
    0), the final norm and lm_head on the last stage's last chunk."""
    names: tuple[str, ...] = ()
    if stage == 0 and chunk == 0:
        names += (EMBED,)
    if stage == manifest.num_stages - 1 and chunk == manifest.virtual_stages - 1:
        names += HEAD
    return names


def chunk_views(params: Params, manifest: StageManifest,
                stages: tuple[int, ...] | None = None, tp_rank: int = 0,
                tp: int = 1) -> dict[int, list[Params]]:
    """{stage: [chunk trees]} of `stages` (default: all), as views of the
    canonical tree: each chunk's layer leaves are the rows of its layers
    (manifest.layers_of_chunk: a contiguous range); the embedding, norm and
    lm_head go to the chunk that owns them (chunk_names); of each leaf that
    tp splits, tp rank `tp_rank`'s slice (parallel/tp.tp_shard)."""
    out = {}
    for s in range(manifest.num_stages) if stages is None else stages:
        chunks = []
        for c in range(manifest.virtual_stages):
            rows = manifest.layers_of_chunk(s, c)
            tree = {name: leaf.detach()[rows.start:rows.stop]
                    for name, leaf in params.items() if name.startswith("layers.")}
            tree.update({name: params[name].detach() for name in chunk_names(manifest, s, c)})
            chunks.append({name: tp_shard(name, leaf, tp_rank, tp)
                           for name, leaf in tree.items()})
        out[s] = chunks
    return out


def flatten_chunks(chunks: dict[int, list[Params]]) -> Params:
    """{`s{stage}c{chunk}/{name}`: leaf} of a chunk structure (the optimizer's
    naming, StageParams.flat())."""
    return {f"s{s}c{c}/{name}": leaf for s in sorted(chunks)
            for c, tree in enumerate(chunks[s]) for name, leaf in tree.items()}


def chunks_like(chunks: dict[int, list[Params]], flat: Params) -> dict[int, list[Params]]:
    """Tensors named as flatten_chunks(chunks) in `chunks`' structure."""
    return {s: [{name: flat[f"s{s}c{c}/{name}"] for name in tree}
                for c, tree in enumerate(chunks[s])] for s in sorted(chunks)}


def split_params(params: Params, manifest: StageManifest,
                 stages: tuple[int, ...] | None = None, tp_rank: int = 0,
                 tp: int = 1) -> dict[int, list[Params]]:
    """The chunk trees of `stages` (default: all), copied out of the
    canonical tree (chunk_views)."""
    return {s: [{name: leaf.clone() for name, leaf in tree.items()} for tree in chunks]
            for s, chunks in chunk_views(params, manifest, stages, tp_rank, tp).items()}


def canonical_leaf(chunks: dict[int, list[Params]], manifest: StageManifest,
                   name: str) -> torch.Tensor:
    """One leaf of the canonical tree from every stage's chunks (a copy):
    a layer leaf concatenated in layer order, another the chunk's own."""
    cells = sorted(((manifest.layers_of_chunk(s, c).start, tree[name])
                    for s in chunks for c, tree in enumerate(chunks[s]) if name in tree),
                   key=lambda cell: cell[0])
    if not cells:
        raise KeyError(f"no chunk holds {name}")
    if name.startswith("layers."):
        return torch.cat([leaf.detach() for _, leaf in cells])
    return cells[0][1].detach().clone()


def merge_params(chunks: dict[int, list[Params]], manifest: StageManifest) -> Params:
    """The canonical tree from every stage's chunks (split_params'
    inverse): layer leaves concatenated in layer order."""
    if sorted(chunks) != list(range(manifest.num_stages)):
        raise ValueError(f"the canonical tree needs every stage; these chunks hold stages "
                         f"{sorted(chunks)} of {manifest.num_stages}")
    cells = sorted(((manifest.layers_of_chunk(s, c).start, chunks[s][c])
                    for s in chunks for c in range(manifest.virtual_stages)),
                   key=lambda cell: cell[0])
    out = {}
    for _, tree in cells:
        for name, leaf in tree.items():
            if name.startswith("layers."):
                out.setdefault(name, []).append(leaf.detach())
            else:
                out[name] = leaf.detach()
    return {name: torch.cat(v) if isinstance(v, list) else v.clone() for name, v in out.items()}


class StageParams:
    """The chunks of the stages this process runs (split_params' trees)
    under two namings: `chunks[s][c][name]` for the interpreter, and
    `flat()`, `s{stage}c{chunk}/{name}`, for the optimizer. Without `grads`
    the leaves are fp32 masters that take their gradients in `.grad`; with
    `grads` (fp32 tensors in the same chunk structure) they are a working
    copy whose gradients accumulate there (optim/offload.bind_fp32_grads).
    `to_canonical` / `copy_canonical` carry the params or any tensors named
    like `flat()` (the optimizer's moments) to and from the canonical
    [num_layers, ...] tree that checkpoints hold. Under tensor parallelism
    the leaves are tp rank `tp_rank`'s slices among `tp` (parallel/tp.py),
    which `copy_canonical` cuts (a process of one stage holds no canonical
    tree: ckpt/gather.py joins the pieces)."""

    def __init__(self, manifest: StageManifest, chunks: dict[int, list[Params]],
                 grads: dict[int, list[Params]] | None = None, tp_rank: int = 0,
                 tp: int = 1):
        self.manifest = manifest
        self.chunks = chunks
        self.grad_sinks = grads
        self.tp_rank, self.tp = tp_rank, tp
        if grads is None:
            for tree in self._trees():
                for leaf in tree.values():
                    leaf.requires_grad_(True)

    def train_tree(self, stage: int, chunk: int) -> Params:
        """Chunk (stage, chunk) as a unit that takes gradients reads it."""
        tree = self.chunks[stage][chunk]
        if self.grad_sinks is None:
            return tree
        return bind_fp32_grads(tree, self.grad_sinks[stage][chunk])

    def grads(self) -> Params:
        """The fp32 gradients, named as flat()."""
        if self.grad_sinks is None:
            return {name: leaf.grad for name, leaf in self.flat().items()}
        return flatten_chunks(self.grad_sinks)

    def stage_grads(self, stage: int) -> Params:
        """The fp32 gradients of one stage's chunks, named as flat()."""
        trees = self.chunks[stage] if self.grad_sinks is None else self.grad_sinks[stage]
        return {f"s{stage}c{c}/{name}": leaf.grad if self.grad_sinks is None else leaf
                for c, tree in enumerate(trees) for name, leaf in tree.items()}

    @classmethod
    def from_canonical(cls, params: Params, manifest: StageManifest,
                       stages: tuple[int, ...] | None = None, tp_rank: int = 0,
                       tp: int = 1) -> "StageParams":
        return cls(manifest, split_params(params, manifest, stages, tp_rank, tp),
                   tp_rank=tp_rank, tp=tp)

    @property
    def stages(self) -> tuple[int, ...]:
        return tuple(sorted(self.chunks))

    def _trees(self):
        for s in self.stages:
            yield from self.chunks[s]

    def flat(self) -> Params:
        return flatten_chunks(self.chunks)

    def _as_chunks(self, flat: Params) -> dict[int, list[Params]]:
        return chunks_like(self.chunks, flat)

    def canonical_names(self) -> set[str]:
        return {name for tree in self._trees() for name in tree}

    def to_canonical(self, flat: Params | None = None) -> Params:
        """The canonical tree of the params, or of `flat` (tensors named as
        flat()); every stage must be in this process."""
        return merge_params(self.chunks if flat is None else self._as_chunks(flat),
                            self.manifest)

    @torch.no_grad()
    def copy_canonical(self, canonical: Params, flat: Params | None = None,
                       what: str = "params", part: Callable | None = None) -> None:
        """Copy a canonical tree into the params (or into `flat`, tensors
        named as flat()) in place: each chunk's rows and this tp rank's
        slice, and of that `part(flat name, tensor)` where given (an
        optimizer's dp slice); refusing a missing or reshaped leaf."""
        targets = self.chunks if flat is None else self._as_chunks(flat)
        source = chunk_views(canonical, self.manifest, self.stages, self.tp_rank, self.tp)
        for s in self.stages:
            for c, tree in enumerate(targets[s]):
                for name, t in tree.items():
                    src = source[s][c].get(name)
                    if src is not None and part is not None:
                        src = part(f"s{s}c{c}/{name}", src)
                    if src is None or tuple(src.shape) != tuple(t.shape):
                        raise ValueError(
                            f"{what}: {name} of stage {s} chunk {c} is "
                            f"{None if src is None else tuple(src.shape)} in the source, "
                            f"{tuple(t.shape)} here")
                    t.copy_(src)


class CanonicalOptimizer:
    """An optimizer over StageParams.flat() loaded from canonical moments
    (what a checkpoint holds): `load_state_dict` hands the rows of this
    process's stages (views of the canonical moments) to the optimizer,
    which keeps what it holds of them (the whole leaves, or a ZeRO-1
    slice)."""

    def __init__(self, optimizer: Any, stage_params: StageParams):
        self.optimizer, self.stage_params = optimizer, stage_params

    def load_state_dict(self, state: dict) -> None:
        sp = self.stage_params
        flat = {"count": state["count"]}
        # the canonical tree's names: every stage holds every layer leaf's rows
        want = ({n for n in sp.canonical_names() if n.startswith("layers.")}
                | {EMBED, *HEAD})
        for moment in ("mu", "nu"):
            names = set(state[moment])
            if names != want:
                raise ValueError(f"optimizer {moment}: names {sorted(names ^ want)} are not "
                                 f"in both the state and this optimizer")
            flat[moment] = flatten_chunks(chunk_views(state[moment], sp.manifest, sp.stages,
                                                      sp.tp_rank, sp.tp))
        self.optimizer.load_state_dict(flat)


# ---------------------------------------------------------------------------
# Transports: the tick's stage-to-stage handoffs
# ---------------------------------------------------------------------------

FWD, BWD = "fwd", "bwd"  # activations to the next stage, cotangents to the previous
_TAGS = {FWD: 0, BWD: 1}


def _peer(kind: str, stage: int, num_stages: int, sending: bool) -> int:
    """The stage a `kind` message goes to (`sending`) or comes from."""
    step = 1 if (kind == FWD) == sending else -1
    return (stage + step) % num_stages


class LocalTransport:
    """Every stage in this process: what a stage sends at one tick is handed
    to its consumer at the next, in memory, with no copy. Messages carry the
    unit their consumer runs, and `exchange` checks that the tick's sends
    are exactly the next tick's receives."""

    def __init__(self, num_stages: int):
        self.num_stages = num_stages
        self._sent: dict[tuple[str, int, int], torch.Tensor] = {}
        self._inbox: dict[tuple[str, int], torch.Tensor] = {}

    def send(self, kind: str, stage: int, unit: int, tensor: torch.Tensor) -> None:
        self._sent[(kind, _peer(kind, stage, self.num_stages, sending=True), unit)] = tensor

    def exchange(self, expect: list[tuple[str, int, int]], like: torch.Tensor) -> None:
        if set(expect) != set(self._sent) or self._inbox:
            raise RuntimeError(f"transport out of step with the grid: sent (kind, stage, unit) "
                               f"{sorted(self._sent)}, the next tick receives {sorted(expect)}"
                               + (f", {sorted(self._inbox)} never received" if self._inbox
                                  else ""))
        self._inbox = {(kind, stage): t for (kind, stage, _), t in self._sent.items()}
        self._sent = {}

    def recv(self, kind: str, stage: int) -> torch.Tensor:
        return self._inbox.pop((kind, stage))

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def from_last_stage(self, t: torch.Tensor) -> torch.Tensor:
        return t


class DistTransport:
    """One stage per process over torch.distributed: stage s of this
    replica is global rank `ranks[s]`, and `group` is the replica's pp
    group. `exchange` posts the tick's sends and the next tick's receives
    together (`dist.batch_isend_irecv`; staged through host memory under
    gloo on cards) and waits for them; activations and cotangents carry
    different tags. `all_reduce_sum` sums over the stages (the pp group),
    `from_last_stage` broadcasts from this replica's last stage."""

    def __init__(self, num_stages: int, ranks: tuple[int, ...], group):
        self.num_stages, self.ranks, self.group = num_stages, ranks, group
        self._sent: list[tuple[str, int, torch.Tensor]] = []
        self._inbox: dict[tuple[str, int], torch.Tensor] = {}
        # a collective first: batch_isend_irecv's first call needs all ranks
        dist.barrier(group=group)

    def send(self, kind: str, stage: int, unit: int, tensor: torch.Tensor) -> None:
        self._sent.append((kind, _peer(kind, stage, self.num_stages, sending=True),
                           tensor.contiguous()))

    def exchange(self, expect: list[tuple[str, int, int]], like: torch.Tensor) -> None:
        sends, recvs, inbox = [], [], {}
        for kind in (FWD, BWD):
            sends += [(t, self.ranks[dst], _TAGS[kind]) for k, dst, t in self._sent if k == kind]
            for k, stage, _ in expect:
                if k == kind:
                    buf = torch.empty_like(like)
                    recvs.append((buf, self.ranks[_peer(kind, stage, self.num_stages,
                                                        sending=False)], _TAGS[kind]))
                    inbox[(kind, stage)] = buf
        distributed.batch_p2p(sends, recvs, self.group)
        self._sent, self._inbox = [], inbox

    def recv(self, kind: str, stage: int) -> torch.Tensor:
        return self._inbox.pop((kind, stage))

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        return distributed.all_reduce(t, self.group)

    def from_last_stage(self, t: torch.Tensor) -> torch.Tensor:
        return distributed.broadcast(t, self.ranks[-1], self.group)


def make_transport(mesh: Mesh) -> LocalTransport | DistTransport:
    """LocalTransport when this process runs every stage, DistTransport when
    it runs one stage (parallel/mesh.make_mesh refuses every other layout).
    The choice is logged."""
    if mesh.in_process:
        logger.info("pipeline: %d stages in this process, handed over in memory (local "
                    "transport)%s", mesh.pp,
                    f", replica {mesh.replica} of {mesh.dp}" if mesh.dp > 1 else "")
        return LocalTransport(mesh.pp)
    logger.info("pipeline: stage %d of %d, replica %d of %d, over torch.distributed (%s)",
                mesh.stages[0], mesh.pp, mesh.replica, mesh.dp, dist.get_backend())
    return DistTransport(mesh.pp, mesh.pp_ranks, mesh.pp_group)


# ---------------------------------------------------------------------------
# The interpreter
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Microbatch:
    ids: torch.Tensor
    mask: torch.Tensor | None
    cos: torch.Tensor
    sin: torch.Tensor
    targets: torch.Tensor


UNIT_KINDS = ("F", "B", "W")
_IN_RING = object()  # a stage input buffered in the host ring


class Pipeline:
    """A pipeline on this process: the model and schedule config, the
    layout (`mesh`), this process's StageParams and the transport.
    `loss_and_grad` runs one step's flushes, accumulating the fp32
    gradients of `stage_params`; `loss_sum_count` is the forward-only pass
    of evaluation. `units[stage]` counts the F, B and W cells each stage
    has executed, and `computed[stage]` those that ran a chunk (see the module docstring for the two kinds of cell
    that run none). With a host tier on, `stash_trace` lists the last
    step's W-queue moves in order, ("push" | "pop" | "replay", stage,
    unit), and `host_stash_bytes()` the pinned rings it holds."""

    def __init__(self, cfg: LlamaConfig, pcfg: PipelineConfig, mesh: Mesh,
                 stage_params: StageParams, attn_fn: Callable = attention,
                 transport: LocalTransport | DistTransport | None = None):
        if mesh.pp != pcfg.num_stages:
            raise ValueError(f"PipelineConfig.num_stages={pcfg.num_stages} does not match "
                             f"the mesh's pp={mesh.pp}")
        _check_layout(stage_params.manifest, pcfg, cfg)
        check_sp(cfg, mesh.tp, mesh.sp, pcfg.sequence_parallel)
        check_tp(cfg, mesh.tp, pcfg.loss_chunks, pcfg.kernel_ce)
        if tuple(stage_params.stages) != tuple(mesh.stages):
            raise ValueError(f"this process runs stages {mesh.stages}; the params hold "
                             f"{stage_params.stages}")
        self.cfg, self.pcfg, self.mesh = cfg, pcfg, mesh
        self.stage_params = stage_params
        if mesh.sp > 1:
            attn_fn = make_sp_attention(pcfg.sequence_parallel, attn_fn, mesh.sp_group,
                                        packed=pcfg.packed)
        self.attn_fn = attn_fn
        self.head = LossHead(loss_chunks=pcfg.loss_chunks, kernel_ce=pcfg.kernel_ce)
        self.us = flush_unit_schedule(pcfg)
        usched.validate(self.us)
        self.transport = transport if transport is not None else make_transport(mesh)
        self._act: dict | None = None
        # the schedule observatory's segment boundary marks (utils/timeline.py)
        self.timeline_marks = False
        self._seg_ends = {seg.t1 - 1: seg.index + 1 for seg in usched.segments(self.us)}
        self.units = {s: dict.fromkeys(UNIT_KINDS, 0) for s in mesh.stages}
        self.computed = {s: dict.fromkeys(UNIT_KINDS, 0) for s in mesh.stages}
        self._act_slots = activation_ring_slots(pcfg) if pcfg.offload_activations else 0
        self._rings: dict[tuple[int, str], torch.Tensor] = {}
        self.stash_trace: list[tuple[str, int, int]] = []
        # each stage's W units in the sequence's order: the drain prefetches
        # the next one's pair while the current one replays
        self._w_next = {}
        for s in mesh.stages:
            order = [int(w) for w in self.us.w_unit[:, s] if w >= 0]
            self._w_next[s] = dict(zip(order, order[1:]))

    # -- one chunk ------------------------------------------------------------

    def _owns(self, stage: int, chunk: int) -> tuple[bool, bool]:
        """(first, last): whether (stage, chunk) embeds / owns the loss."""
        return (stage == 0 and chunk == 0,
                stage == self.pcfg.num_stages - 1 and chunk == self.pcfg.virtual_stages - 1)

    def _chunk(self, params: Params, x: torch.Tensor | None, mb: _Microbatch, stage: int,
               chunk: int, remat: bool, fold: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """(chunk output, the head's loss sum on the loss-owning chunk else
        None). `fold`: this unit's output (before the final norm) joins the
        step's activation stats when they are collected."""
        first, last = self._owns(stage, chunk)
        pcfg = self.pcfg
        tp_group = self.mesh.tp_group
        act = self._act
        tap = (None if act is None or not fold
               else functools.partial(numerics.act_fold, act, (stage, chunk)))
        h = llama.chunk_hidden(params, x, mb.ids, mb.mask, mb.cos, mb.sin, cfg=self.cfg,
                               first=first, last=last, attn_fn=self.attn_fn,
                               remat=remat and pcfg.remat,
                               kernel_prologue=pcfg.kernel_prologue,
                               remat_policy=pcfg.remat_policy, tp_group=tp_group,
                               act_tap=tap)
        if not last:
            return h, None
        return h, head_loss_sum_count(params, h, mb.targets, self.cfg, self.head, tp_group)[0]

    def _microbatches(self, batch: dict[str, torch.Tensor]) -> tuple[torch.Tensor, list]:
        targets, mbs = microbatches(batch, self.pcfg.num_microbatches, self.mesh.sp_group)
        out = []
        for ids, mask, positions, mb_targets in mbs:
            cos, sin = llama.rope_tables(ids, positions, self.cfg)
            out.append(_Microbatch(ids, mask, cos, sin, mb_targets))
        return targets, out

    # -- the host tiers ------------------------------------------------------------

    def _ring(self, stage: int, kind: str, n_slots: int, like: torch.Tensor) -> torch.Tensor:
        """This stage's `kind` ring ("act", "wq_x", "wq_dy"), kept across
        flushes and steps while the shape holds."""
        ring = self._rings.get((stage, kind))
        shape = (n_slots + 1,) + tuple(like.shape)
        if ring is None or tuple(ring.shape) != shape or ring.dtype != like.dtype:
            ring = self._rings[(stage, kind)] = host_stash.stash_init(
                n_slots, like.shape, like.dtype, like.device)
        return ring

    def host_stash_bytes(self) -> int:
        """Bytes of the host rings this pipeline holds (every stage of this
        process)."""
        return sum(r.numel() * r.element_size() for r in self._rings.values())

    def _hosted(self, g: int) -> bool:
        """Whether unit g's W residual pair goes to host memory."""
        return self.us.split_backward and bool(self.us.offload_units[g])

    def _push_w(self, s: int, g: int, x, dy) -> None:
        """Queue unit g's (input, cotangent) for its W: pushed to the host
        rings at the unit's slot when hosted, else kept."""
        if not self._hosted(g):
            self._wq[s][g] = (x, dy)
            return
        slot = int(self.us.wq_slot[g])
        for kind, t in (("wq_x", x), ("wq_dy", dy)):
            if t is not None:
                host_stash.stash_push(self._ring(s, kind, self.us.wq_host_slots, t), t, slot)
        self._wq[s][g] = (x is not None, dy is not None)
        self.stash_trace.append(("push", s, g))

    def _pop_w(self, s: int, g: int) -> tuple:
        """Start unit g's pair on its way back to the card (a pair of
        host_stash.stash_pop results, None where the half is absent)."""
        has_x, has_dy = self._wq[s].pop(g)
        slot, device = int(self.us.wq_slot[g]), self._device
        self.stash_trace.append(("pop", s, g))
        return tuple(host_stash.stash_pop(self._rings[(s, kind)], slot, device) if has else None
                     for kind, has in (("wq_x", has_x), ("wq_dy", has_dy)))

    def _take_w(self, s: int, g: int) -> tuple:
        """Unit g's (input, cotangent) for its W: kept, prefetched or fetched
        now; then the next W unit's hosted pair is started on its way, so its
        copy runs behind this replay."""
        if not self._hosted(g):
            pair = self._wq[s].pop(g)
        else:
            pending = self._prefetched[s].pop(g, None) or self._pop_w(s, g)
            pair = tuple(None if p is None else host_stash.ready(p) for p in pending)
        nxt = self._w_next[s].get(g)
        if nxt is not None and self._hosted(nxt) and nxt in self._wq[s]:
            self._prefetched[s][nxt] = self._pop_w(s, nxt)
        if self._hosted(g):
            self.stash_trace.append(("replay", s, g))
        return pair

    def _keep_input(self, s: int, u: int, x) -> None:
        """Buffer F unit u's received input for its B: in the host ring at
        slot u % slots under offload_activations."""
        if self._act_slots and x is not None:
            host_stash.stash_push(self._ring(s, "act", self._act_slots, x), x,
                                  u % self._act_slots)
            x = _IN_RING
        self._xbuf[s][u] = x

    def _buffered_input(self, s: int, u: int):
        x = self._xbuf[s].pop(u, None)
        if x is _IN_RING:
            x = host_stash.ready(host_stash.stash_pop(self._rings[(s, "act")],
                                                      u % self._act_slots, self._device))
        return x

    # -- the grid's handoffs -----------------------------------------------------

    def _consumer_unit(self, kind: str, stage: int, unit: int) -> int:
        """The unit that consumes what `stage`'s `unit` sends: the same unit
        on the neighbour, or, across the ring's wrap (interleaved chunks),
        the same microbatch's unit one lap on (F) or back (B)."""
        s_total = self.pcfg.num_stages
        wraps = stage == s_total - 1 if kind == FWD else stage == 0
        return unit + s_total if wraps else unit

    def _expected(self, t: int, f_grid: np.ndarray, b_grid: np.ndarray | None
                  ) -> list[tuple[str, int, int]]:
        """The receives (kind, stage, unit) this process's stages post for
        tick `t`: an F cell whose input is not the embedding, a B cell whose
        unit does not own the loss."""
        us = self.us
        s_total, v = us.num_stages, us.virtual_stages
        out = []
        if t >= f_grid.shape[0]:
            return out
        for s in self.mesh.stages:
            f = int(f_grid[t, s])
            if f >= 0 and not self._owns(s, usched.unit_mb_chunk(f, s_total, v)[1])[0]:
                out.append((FWD, s, f))
            g = -1 if b_grid is None else int(b_grid[t, s])
            if g >= 0 and not self._owns(s, usched.bwd_unit_mb_chunk(g, s_total, v)[1])[1]:
                out.append((BWD, s, g))
        return out

    # -- training ------------------------------------------------------------------

    def loss_and_grad(self, batch: dict[str, torch.Tensor], act: dict | None = None
                      ) -> torch.Tensor:
        """One step's forward and backward over `batch` ([num_microbatches *
        mb, s] on the params' device; this replica's rows under dp):
        accumulates the gradients of the mean token loss into stage_params'
        `.grad` (which the caller zeroes) and returns that loss (fp32
        scalar, the same on every process). Under dp the valid-target count
        is summed over the replicas before it divides, and the gradients and
        the loss are summed over them after (the reference's psums over dp:
        the embedding, norm and lm_head live on one stage each here, so the
        dp group is all their sum needs); under sp the same over the slabs
        (`batch` is then this process's column slab).

        `act` (a dict; the numerics observatory's): each (stage, chunk)'s
        activation stats of this step are folded into it
        (utils/numerics.act_fold; the reference's `_act_stat_update`), once
        per unit that computes the chunk with its parameters' gradients: the
        B unit, or the W unit of a split-backward sequence (whose B on the
        embedding chunk computes nothing). With `timeline_marks` set, each
        flush records a boundary mark per stage of this process at its start
        and at the end of every segment of `schedule.segments`
        (utils/timeline.mark); off, nothing is recorded."""
        self._act = act
        targets, mbs = self._microbatches(batch)
        dp_group, sp_group = self.mesh.dp_group, self.mesh.sp_group
        count = (targets != llama.IGNORE_INDEX).sum().float()
        global_count = sum_over(count, sp_group, dp_group).clamp(min=1)
        c = self.pcfg.accum_chunks
        per = len(mbs) // c
        loss = torch.zeros((), device=targets.device)
        self._device = targets.device
        self.stash_trace = []
        for i in range(c):
            loss += self._flush(mbs[i * per:(i + 1) * per], global_count)
        for g in self.stage_params.grads().values():
            sum_over(g, sp_group, dp_group)
        return sum_over(self.transport.from_last_stage(loss), sp_group, dp_group)

    def _flush(self, mbs: list[_Microbatch], global_count: torch.Tensor) -> torch.Tensor:
        """One flush of the per-flush sequence over `mbs`; returns the sum of
        the owned microbatches' losses over `global_count` (0 off the last
        stage)."""
        us, tr = self.us, self.transport
        split = us.split_backward
        # per stage: F inputs by unit (or _IN_RING), the W queue by unit (a
        # pair, or which halves are in the host rings), prefetched pairs
        self._xbuf = {s: {} for s in self.mesh.stages}
        self._wq = {s: {} for s in self.mesh.stages}
        self._prefetched = {s: {} for s in self.mesh.stages}
        loss = torch.zeros((), device=mbs[0].ids.device)
        like = torch.empty(mbs[0].ids.shape + (self.cfg.hidden_size,), dtype=self.cfg.dtype,
                           device=mbs[0].ids.device)
        self._mark(0)
        for t in range(us.num_ticks):
            for s in self.mesh.stages:
                f, g, w = (int(grid[t, s]) for grid in (us.f_unit, us.b_unit, us.w_unit))
                if f >= 0:
                    self._forward_unit(s, f, mbs)
                if g >= 0:
                    loss += self._backward_unit(s, g, mbs, global_count, split)
                if w >= 0:
                    loss += self._weight_unit(s, w, mbs, global_count)
            tr.exchange(self._expected(t + 1, us.f_unit, us.b_unit), like)
            if t in self._seg_ends:
                self._mark(self._seg_ends[t])
        return loss

    def _mark(self, boundary: int) -> None:
        """A timeline boundary mark for each stage of this process. With
        every stage in one process they share the card's one stream, so a
        stage's segment wall is the card's wall between its marks, and only
        a pipeline across processes can show a straggler."""
        if self.timeline_marks:
            timeline.mark(boundary, *self.mesh.stages)

    def _forward_unit(self, s: int, u: int, mbs: list[_Microbatch]) -> None:
        """F: buffer the received input; run the chunk for the next stage,
        unless the unit owns the loss (its output goes nowhere)."""
        us = self.us
        mb, ch = usched.unit_mb_chunk(u, us.num_stages, us.virtual_stages)
        first, last = self._owns(s, ch)
        x = None if first else self.transport.recv(FWD, s)
        self._keep_input(s, u, x)
        self.units[s]["F"] += 1
        if last:
            return
        with torch.no_grad():
            y, _ = self._chunk(self.stage_params.chunks[s][ch], x, mbs[mb], s, ch, remat=False)
        self.computed[s]["F"] += 1
        self.transport.send(FWD, s, self._consumer_unit(FWD, s, u), y)

    def _backward_unit(self, s: int, g: int, mbs: list[_Microbatch],
                       global_count: torch.Tensor, split: bool) -> torch.Tensor:
        """B: recompute from the buffered input and backpropagate; returns
        the unit's loss over `global_count` (0 unless it owns the loss)."""
        us = self.us
        s_total, v = us.num_stages, us.virtual_stages
        mb, ch = usched.bwd_unit_mb_chunk(g, s_total, v)
        first, last = self._owns(s, ch)
        x = self._buffered_input(s, usched.bwd_fwd_unit(g, s_total, v))
        dy = None if last else self.transport.recv(BWD, s)
        self.units[s]["B"] += 1
        if split:
            self._push_w(s, g, x, dy)
            if first:  # input grads only, and the input is the embedding lookup
                return torch.zeros((), device=mbs[mb].ids.device)
        if split:
            params = {name: leaf.detach() for name, leaf in self.stage_params.chunks[s][ch].items()}
        else:
            params = self.stage_params.train_tree(s, ch)
        x_in = None if first else x.detach().requires_grad_()
        with torch.enable_grad():
            y, mb_sum = self._chunk(params, x_in, mbs[mb], s, ch, remat=True, fold=not split)
            if last:
                mb_loss = mb_sum / global_count
                torch.autograd.backward(mb_loss)
            else:
                torch.autograd.backward(y, dy)
        self.computed[s]["B"] += 1
        if not first:
            self.transport.send(BWD, s, self._consumer_unit(BWD, s, g), x_in.grad)
        return mb_loss.detach() if last else torch.zeros((), device=y.device)

    def _weight_unit(self, s: int, g: int, mbs: list[_Microbatch],
                     global_count: torch.Tensor) -> torch.Tensor:
        """W: recompute from the stashed input (detached) and backpropagate
        the stashed cotangent into the parameters' gradients. Returns the
        unit's loss over `global_count` where its B computed none (the one
        chunk of a one-stage pipeline), else 0."""
        us = self.us
        mb, ch = usched.bwd_unit_mb_chunk(g, us.num_stages, us.virtual_stages)
        first, last = self._owns(s, ch)
        x, dy = self._take_w(s, g)
        self.units[s]["W"] += 1
        with torch.enable_grad():
            y, mb_sum = self._chunk(self.stage_params.train_tree(s, ch), x, mbs[mb], s, ch,
                                    remat=True, fold=True)
            if last:
                mb_loss = mb_sum / global_count
                torch.autograd.backward(mb_loss)
            else:
                torch.autograd.backward(y, dy)
        self.computed[s]["W"] += 1
        return mb_loss.detach() if first and last else torch.zeros((), device=y.device)

    def global_norm(self) -> torch.Tensor:
        """The global gradient norm over every stage's gradients: each
        stage's sum of squares (under tp, its split leaves' slices summed
        over the tp group and its replicated leaves counted once:
        parallel/tp.grad_sq_sum), then the stages' sums added (in stage
        order in one process, by all_reduce over the pp group across
        processes; not over dp: the gradients are already summed over it,
        so the world would count each stage's sum dp times)."""
        sp = self.stage_params
        partial = [grad_sq_sum(sp.stage_grads(s), self.mesh.tp_group) for s in sp.stages]
        return self.transport.all_reduce_sum(torch.stack(partial).sum()).sqrt()

    # -- evaluation -------------------------------------------------------------------

    @torch.no_grad()
    def loss_sum_count(self, batch: dict[str, torch.Tensor]
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        """The forward-only pass (the reference's `_pipeline_loss_local`):
        every microbatch through every chunk, in the forward order of the
        unit grid (stage s runs unit t - s at tick t), with no autograd
        graph: (token-loss sum fp32, valid-target count) over the whole
        batch (every replica's under dp, every slab's under sp), the same on
        every process."""
        targets, mbs = self._microbatches(batch)
        s_total, v = self.pcfg.num_stages, self.pcfg.virtual_stages
        n_units = len(mbs) * v
        ticks = n_units + s_total - 1
        t_idx, st = np.arange(ticks)[:, None], np.arange(s_total)[None, :]
        f_grid = np.where((t_idx - st >= 0) & (t_idx - st < n_units), t_idx - st, -1)
        like = torch.empty(mbs[0].ids.shape + (self.cfg.hidden_size,), dtype=self.cfg.dtype,
                           device=targets.device)
        total = torch.zeros((), device=targets.device)
        for t in range(ticks):
            for s in self.mesh.stages:
                u = int(f_grid[t, s])
                if u < 0:
                    continue
                mb, ch = usched.unit_mb_chunk(u, s_total, v)
                first, last = self._owns(s, ch)
                x = None if first else self.transport.recv(FWD, s)
                y, mb_sum = self._chunk(self.stage_params.chunks[s][ch], x, mbs[mb], s, ch,
                                        remat=False)
                if last:
                    total += mb_sum.float()
                else:
                    self.transport.send(FWD, s, self._consumer_unit(FWD, s, u), y)
            self.transport.exchange(self._expected(t + 1, f_grid, None), like)
        count = (targets != llama.IGNORE_INDEX).sum()
        groups = (self.mesh.sp_group, self.mesh.dp_group)
        return (sum_over(self.transport.from_last_stage(total), *groups),
                sum_over(count, *groups))


def _check_layout(manifest: StageManifest, pcfg: PipelineConfig, cfg: LlamaConfig) -> None:
    """The params' partition must be the schedule's: the same stage count,
    virtual stages and layer counts (a mismatch means the manifest and the
    PipelineConfig came from different places)."""
    if manifest.num_layers != cfg.num_hidden_layers:
        raise ValueError(f"the manifest partitions {manifest.num_layers} layers; the model "
                         f"has {cfg.num_hidden_layers}")
    if (manifest.num_stages, manifest.virtual_stages) != (pcfg.num_stages,
                                                          pcfg.virtual_stages):
        raise ValueError(
            f"schedule={pcfg.schedule} (num_stages={pcfg.num_stages}, virtual_stages="
            f"{pcfg.virtual_stages}) but the params are split for {manifest.num_stages} "
            f"stages of {manifest.virtual_stages} chunks")
    counts = None if manifest.is_even else tuple(manifest.stage_layer_counts)
    mine = (None if pcfg.layer_counts is None or len(set(pcfg.layer_counts)) == 1
            else tuple(pcfg.layer_counts))
    if counts != mine:
        raise ValueError(f"layer_counts {pcfg.layer_counts} do not match the params' "
                         f"partition {manifest.stage_layer_counts}")

