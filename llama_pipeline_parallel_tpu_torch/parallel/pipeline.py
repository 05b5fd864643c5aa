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
the one global token count, so the sum is the full-batch gradient.
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
from llama_pipeline_parallel_tpu_torch.parallel import schedule as usched
from llama_pipeline_parallel_tpu_torch.parallel.mesh import Mesh
from llama_pipeline_parallel_tpu_torch.parallel.train_step import (
    LossHead,
    head_loss_sum_count,
    microbatches,
)
from llama_pipeline_parallel_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

Params = dict[str, torch.Tensor]

SCHEDULES = ("1f1b", "interleaved_1f1b", "zb1", "solver", "gpipe")
# the schedules this interpreter executes; gpipe (the reference's
# autodiff-of-the-forward-scan schedule) is not ported
UNIT_SCHEDULES = ("1f1b", "interleaved_1f1b", "zb1", "solver")
NOT_PORTED_SCHEDULES = {"gpipe": "a later slice (the forward-only schedule differentiated "
                                 "whole; this package runs the unit-sequence schedules)"}


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Schedule knobs, as the reference's PipelineConfig names and checks
    them (its sequence-parallel and offload knobs are not ported).

    `remat` recomputes each layer inside a B or W unit's backward under
    `remat_policy`, on top of the stage-granularity recompute every unit
    schedule pays. `layer_counts`: per-stage layer counts of an uneven
    partition (None: even). `loss_chunks` / `kernel_ce` pick the loss head,
    `kernel_prologue` the decoder layers' prologue, as in the one-device
    step. `unit_schedule`: the per-flush sequence of `schedule: solver`."""

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

    def __post_init__(self) -> None:
        if self.num_microbatches < 1:
            raise ValueError("num_microbatches must be >= 1")
        if self.num_stages < 1:
            raise ValueError("num_stages must be >= 1")
        if self.schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {self.schedule!r}; choose one of {SCHEDULES}")
        if self.schedule in NOT_PORTED_SCHEDULES:
            raise NotImplementedError(
                f"not ported yet: pipeline_schedule={self.schedule!r} comes with "
                f"{NOT_PORTED_SCHEDULES[self.schedule]}; choose one of {UNIT_SCHEDULES}")
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
        if us.offloaded_units:
            raise NotImplementedError(
                f"not ported yet: the solver sequence offloads {us.offloaded_units} W "
                f"residuals to host memory; host offload comes with a later slice (emit the "
                f"sequence with no offloaded units)")
        usched.validate(us)


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
                             pcfg.num_stages, pcfg.virtual_stages, counts)


def flush_unit_schedule(pcfg: PipelineConfig) -> usched.UnitSchedule:
    """The per-flush unit sequence this config's interpreter executes."""
    return _unit_schedule_for(dataclasses.replace(
        pcfg, num_microbatches=pcfg.num_microbatches // pcfg.accum_chunks, accum_chunks=1))


@functools.lru_cache(maxsize=64)
def _canonical_cached(schedule: str, m: int, s: int, v: int,
                      stage_costs: tuple | None = None) -> usched.UnitSchedule:
    return usched.canonical_schedule(schedule, m, s, v, stage_costs=stage_costs)


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


def _chunk_views(params: Params, manifest: StageManifest,
                 stages: tuple[int, ...] | None = None) -> dict[int, list[Params]]:
    """{stage: [chunk trees]} of `stages` (default: all), as views of the
    canonical tree: each chunk's layer leaves are the rows of its layers
    (manifest.layers_of_chunk: a contiguous range); the embedding, norm and
    lm_head go to the chunk that owns them (chunk_names)."""
    out = {}
    for s in range(manifest.num_stages) if stages is None else stages:
        chunks = []
        for c in range(manifest.virtual_stages):
            rows = manifest.layers_of_chunk(s, c)
            tree = {name: leaf.detach()[rows.start:rows.stop]
                    for name, leaf in params.items() if name.startswith("layers.")}
            tree.update({name: params[name].detach() for name in chunk_names(manifest, s, c)})
            chunks.append(tree)
        out[s] = chunks
    return out


def split_params(params: Params, manifest: StageManifest,
                 stages: tuple[int, ...] | None = None) -> dict[int, list[Params]]:
    """The chunk trees of `stages` (default: all), copied out of the
    canonical tree (_chunk_views)."""
    return {s: [{name: leaf.clone() for name, leaf in tree.items()} for tree in chunks]
            for s, chunks in _chunk_views(params, manifest, stages).items()}


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
    """The chunks of the stages this process runs (split_params' trees) as
    fp32 masters that take gradients, under two namings: `chunks[s][c][name]`
    for the interpreter, and `flat()`, `s{stage}c{chunk}/{name}`, for the
    optimizer. `to_canonical` / `copy_canonical` carry the params or any
    tensors named like `flat()` (the optimizer's moments) to and from the
    canonical [num_layers, ...] tree that checkpoints hold."""

    def __init__(self, manifest: StageManifest, chunks: dict[int, list[Params]]):
        self.manifest = manifest
        self.chunks = chunks
        for tree in self._trees():
            for leaf in tree.values():
                leaf.requires_grad_(True)

    @classmethod
    def from_canonical(cls, params: Params, manifest: StageManifest,
                       stages: tuple[int, ...] | None = None) -> "StageParams":
        return cls(manifest, split_params(params, manifest, stages))

    @property
    def stages(self) -> tuple[int, ...]:
        return tuple(sorted(self.chunks))

    def _trees(self):
        for s in self.stages:
            yield from self.chunks[s]

    def flat(self) -> Params:
        return {f"s{s}c{c}/{name}": leaf for s in self.stages
                for c, tree in enumerate(self.chunks[s]) for name, leaf in tree.items()}

    def _as_chunks(self, flat: Params) -> dict[int, list[Params]]:
        out: dict[int, list[Params]] = {}
        for s in self.stages:
            out[s] = [{name: flat[f"s{s}c{c}/{name}"] for name in tree}
                      for c, tree in enumerate(self.chunks[s])]
        return out

    def canonical_names(self) -> set[str]:
        return {name for tree in self._trees() for name in tree}

    def to_canonical(self, flat: Params | None = None) -> Params:
        """The canonical tree of the params, or of `flat` (tensors named as
        flat()); every stage must be in this process."""
        return merge_params(self.chunks if flat is None else self._as_chunks(flat),
                            self.manifest)

    @torch.no_grad()
    def copy_canonical(self, canonical: Params, flat: Params | None = None,
                       what: str = "params") -> None:
        """Copy a canonical tree into the params (or into `flat`, tensors
        named as flat()) in place, refusing a missing or reshaped leaf."""
        targets = self.chunks if flat is None else self._as_chunks(flat)
        source = _chunk_views(canonical, self.manifest, self.stages)
        for s in self.stages:
            for c, tree in enumerate(targets[s]):
                for name, t in tree.items():
                    src = source[s][c].get(name)
                    if src is None or tuple(src.shape) != tuple(t.shape):
                        raise ValueError(
                            f"{what}: {name} of stage {s} chunk {c} is "
                            f"{None if src is None else tuple(src.shape)} in the source, "
                            f"{tuple(t.shape)} here")
                    t.copy_(src)


class CanonicalOptimizer:
    """An optimizer over StageParams.flat() seen in the canonical naming:
    `state_dict()` gives the moments as canonical trees (what a checkpoint
    of the one-stage layout holds), `load_state_dict` copies canonical
    moments into the chunks'. Every stage must be in this process."""

    def __init__(self, optimizer: Any, stage_params: StageParams):
        self.optimizer, self.stage_params = optimizer, stage_params

    def state_dict(self) -> dict:
        sd = self.optimizer.state_dict()
        return {"mu": self.stage_params.to_canonical(sd["mu"]),
                "nu": self.stage_params.to_canonical(sd["nu"]), "count": sd["count"]}

    def load_state_dict(self, state: dict) -> None:
        for moment in ("mu", "nu"):
            names = set(state[moment])
            want = self.stage_params.canonical_names()
            if names != want:
                raise ValueError(f"optimizer {moment}: names {sorted(names ^ want)} are not "
                                 f"in both the state and this optimizer")
            self.stage_params.copy_canonical(state[moment], getattr(self.optimizer, moment),
                                             what=f"optimizer {moment}")
        self.optimizer.count = int(state["count"])


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
    """One stage per process over torch.distributed (rank r runs stage r):
    `exchange` posts the tick's sends and the next tick's receives together
    (`dist.batch_isend_irecv`) and waits for them; activations and
    cotangents carry different tags."""

    def __init__(self, num_stages: int, rank: int):
        self.num_stages, self.rank = num_stages, rank
        self._sent: list[tuple[str, int, torch.Tensor]] = []
        self._inbox: dict[tuple[str, int], torch.Tensor] = {}
        dist.barrier()  # a collective first: batch_isend_irecv's first call needs all ranks

    def send(self, kind: str, stage: int, unit: int, tensor: torch.Tensor) -> None:
        self._sent.append((kind, _peer(kind, stage, self.num_stages, sending=True),
                           tensor.contiguous()))

    def exchange(self, expect: list[tuple[str, int, int]], like: torch.Tensor) -> None:
        ops, inbox = [], {}
        for kind in (FWD, BWD):
            ops += [dist.P2POp(dist.isend, t, dst, tag=_TAGS[kind])
                    for k, dst, t in self._sent if k == kind]
            for k, stage, _ in expect:
                if k == kind:
                    buf = torch.empty_like(like)
                    ops.append(dist.P2POp(dist.irecv, buf,
                                          _peer(kind, stage, self.num_stages, sending=False),
                                          tag=_TAGS[kind]))
                    inbox[(kind, stage)] = buf
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        self._sent, self._inbox = [], inbox

    def recv(self, kind: str, stage: int) -> torch.Tensor:
        return self._inbox.pop((kind, stage))

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t)
        return t

    def from_last_stage(self, t: torch.Tensor) -> torch.Tensor:
        dist.broadcast(t, src=self.num_stages - 1)
        return t


def make_transport(mesh: Mesh) -> LocalTransport | DistTransport:
    """LocalTransport when this process runs every stage, DistTransport when
    it runs one stage of `pp` processes (parallel/mesh.make_mesh refuses
    every other layout). The choice is logged."""
    if mesh.in_process:
        logger.info("pipeline: %d stages in this process, handed over in memory (local "
                    "transport)", mesh.pp)
        return LocalTransport(mesh.pp)
    logger.info("pipeline: stage %d of %d over torch.distributed (%s)", mesh.stages[0],
                mesh.pp, dist.get_backend())
    return DistTransport(mesh.pp, mesh.rank)


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


class Pipeline:
    """A pipeline on this process: the model and schedule config, the
    layout (`mesh`), this process's StageParams and the transport.
    `loss_and_grad` runs one step's flushes, accumulating the fp32
    gradients of `stage_params`; `loss_sum_count` is the forward-only pass
    of evaluation. `units[stage]` counts the F, B and W cells each stage
    has executed, and `computed[stage]` those that ran a chunk (see the module docstring for the two kinds of cell
    that run none)."""

    def __init__(self, cfg: LlamaConfig, pcfg: PipelineConfig, mesh: Mesh,
                 stage_params: StageParams, attn_fn: Callable = attention,
                 transport: LocalTransport | DistTransport | None = None):
        if mesh.pp != pcfg.num_stages:
            raise ValueError(f"PipelineConfig.num_stages={pcfg.num_stages} does not match "
                             f"the mesh's pp={mesh.pp}")
        _check_layout(stage_params.manifest, pcfg, cfg)
        if tuple(stage_params.stages) != tuple(mesh.stages):
            raise ValueError(f"this process runs stages {mesh.stages}; the params hold "
                             f"{stage_params.stages}")
        self.cfg, self.pcfg, self.mesh = cfg, pcfg, mesh
        self.stage_params = stage_params
        self.attn_fn = attn_fn
        self.head = LossHead(loss_chunks=pcfg.loss_chunks, kernel_ce=pcfg.kernel_ce)
        self.us = flush_unit_schedule(pcfg)
        usched.validate(self.us)
        self.transport = transport if transport is not None else make_transport(mesh)
        self.units = {s: dict.fromkeys(UNIT_KINDS, 0) for s in mesh.stages}
        self.computed = {s: dict.fromkeys(UNIT_KINDS, 0) for s in mesh.stages}

    # -- one chunk ------------------------------------------------------------

    def _owns(self, stage: int, chunk: int) -> tuple[bool, bool]:
        """(first, last): whether (stage, chunk) embeds / owns the loss."""
        return (stage == 0 and chunk == 0,
                stage == self.pcfg.num_stages - 1 and chunk == self.pcfg.virtual_stages - 1)

    def _chunk(self, params: Params, x: torch.Tensor | None, mb: _Microbatch, stage: int,
               chunk: int, remat: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
        """(chunk output, the head's loss sum on the loss-owning chunk else
        None)."""
        first, last = self._owns(stage, chunk)
        pcfg = self.pcfg
        h = llama.chunk_hidden(params, x, mb.ids, mb.mask, mb.cos, mb.sin, cfg=self.cfg,
                               first=first, last=last, attn_fn=self.attn_fn,
                               remat=remat and pcfg.remat,
                               kernel_prologue=pcfg.kernel_prologue,
                               remat_policy=pcfg.remat_policy)
        if not last:
            return h, None
        return h, head_loss_sum_count(params, h, mb.targets, self.cfg, self.head)[0]

    def _microbatches(self, batch: dict[str, torch.Tensor]) -> tuple[torch.Tensor, list]:
        targets, mbs = microbatches(batch, self.pcfg.num_microbatches)
        out = []
        for ids, mask, positions, mb_targets in mbs:
            cos, sin = llama.rope_tables(ids, positions, self.cfg)
            out.append(_Microbatch(ids, mask, cos, sin, mb_targets))
        return targets, out

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

    def loss_and_grad(self, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        """One step's forward and backward over `batch` ([num_microbatches *
        mb, s] on the params' device): accumulates the gradients of the
        mean token loss into stage_params' `.grad` (which the caller zeroes)
        and returns that loss (fp32 scalar, the same on every process)."""
        targets, mbs = self._microbatches(batch)
        global_count = (targets != llama.IGNORE_INDEX).sum().clamp(min=1).float()
        c = self.pcfg.accum_chunks
        per = len(mbs) // c
        loss = torch.zeros((), device=targets.device)
        for i in range(c):
            loss += self._flush(mbs[i * per:(i + 1) * per], global_count)
        return self.transport.from_last_stage(loss)

    def _flush(self, mbs: list[_Microbatch], global_count: torch.Tensor) -> torch.Tensor:
        """One flush of the per-flush sequence over `mbs`; returns the sum of
        the owned microbatches' losses over `global_count` (0 off the last
        stage)."""
        us, tr = self.us, self.transport
        split = us.split_backward
        xbuf = {s: {} for s in self.mesh.stages}
        wq = {s: {} for s in self.mesh.stages}
        loss = torch.zeros((), device=mbs[0].ids.device)
        like = torch.empty(mbs[0].ids.shape + (self.cfg.hidden_size,), dtype=self.cfg.dtype,
                           device=mbs[0].ids.device)
        for t in range(us.num_ticks):
            for s in self.mesh.stages:
                f, g, w = (int(grid[t, s]) for grid in (us.f_unit, us.b_unit, us.w_unit))
                if f >= 0:
                    self._forward_unit(s, f, mbs, xbuf[s])
                if g >= 0:
                    loss += self._backward_unit(s, g, mbs, xbuf[s], wq[s], global_count, split)
                if w >= 0:
                    loss += self._weight_unit(s, w, mbs, wq[s], global_count)
            tr.exchange(self._expected(t + 1, us.f_unit, us.b_unit), like)
        return loss

    def _forward_unit(self, s: int, u: int, mbs: list[_Microbatch], xbuf: dict) -> None:
        """F: buffer the received input; run the chunk for the next stage,
        unless the unit owns the loss (its output goes nowhere)."""
        us = self.us
        mb, ch = usched.unit_mb_chunk(u, us.num_stages, us.virtual_stages)
        first, last = self._owns(s, ch)
        x = None if first else self.transport.recv(FWD, s)
        xbuf[u] = x
        self.units[s]["F"] += 1
        if last:
            return
        with torch.no_grad():
            y, _ = self._chunk(self.stage_params.chunks[s][ch], x, mbs[mb], s, ch, remat=False)
        self.computed[s]["F"] += 1
        self.transport.send(FWD, s, self._consumer_unit(FWD, s, u), y)

    def _backward_unit(self, s: int, g: int, mbs: list[_Microbatch], xbuf: dict, wq: dict,
                       global_count: torch.Tensor, split: bool) -> torch.Tensor:
        """B: recompute from the buffered input and backpropagate; returns
        the unit's loss over `global_count` (0 unless it owns the loss)."""
        us = self.us
        s_total, v = us.num_stages, us.virtual_stages
        mb, ch = usched.bwd_unit_mb_chunk(g, s_total, v)
        first, last = self._owns(s, ch)
        x = xbuf.pop(usched.bwd_fwd_unit(g, s_total, v), None)
        dy = None if last else self.transport.recv(BWD, s)
        self.units[s]["B"] += 1
        if split:
            wq[g] = (x, dy)
            if first:  # input grads only, and the input is the embedding lookup
                return torch.zeros((), device=mbs[mb].ids.device)
        params = self.stage_params.chunks[s][ch]
        if split:
            params = {name: leaf.detach() for name, leaf in params.items()}
        x_in = None if first else x.detach().requires_grad_()
        with torch.enable_grad():
            y, mb_sum = self._chunk(params, x_in, mbs[mb], s, ch, remat=True)
            if last:
                mb_loss = mb_sum / global_count
                torch.autograd.backward(mb_loss)
            else:
                torch.autograd.backward(y, dy)
        self.computed[s]["B"] += 1
        if not first:
            self.transport.send(BWD, s, self._consumer_unit(BWD, s, g), x_in.grad)
        return mb_loss.detach() if last else torch.zeros((), device=y.device)

    def _weight_unit(self, s: int, g: int, mbs: list[_Microbatch], wq: dict,
                     global_count: torch.Tensor) -> torch.Tensor:
        """W: recompute from the stashed input (detached) and backpropagate
        the stashed cotangent into the parameters' gradients. Returns the
        unit's loss over `global_count` where its B computed none (the one
        chunk of a one-stage pipeline), else 0."""
        us = self.us
        mb, ch = usched.bwd_unit_mb_chunk(g, us.num_stages, us.virtual_stages)
        first, last = self._owns(s, ch)
        x, dy = wq.pop(g)
        self.units[s]["W"] += 1
        with torch.enable_grad():
            y, mb_sum = self._chunk(self.stage_params.chunks[s][ch], x, mbs[mb], s, ch,
                                    remat=True)
            if last:
                mb_loss = mb_sum / global_count
                torch.autograd.backward(mb_loss)
            else:
                torch.autograd.backward(y, dy)
        self.computed[s]["W"] += 1
        return mb_loss.detach() if first and last else torch.zeros((), device=y.device)

    def global_norm(self) -> torch.Tensor:
        """The global gradient norm over every stage's gradients: each
        stage's sum of squares, then the stages' sums added (in stage order
        in one process, by all_reduce across processes)."""
        sp = self.stage_params
        partial = [torch.stack([leaf.grad.float().square().sum() for tree in sp.chunks[s]
                                for leaf in tree.values()]).sum() for s in sp.stages]
        return self.transport.all_reduce_sum(torch.stack(partial).sum()).sqrt()

    # -- evaluation -------------------------------------------------------------------

    @torch.no_grad()
    def loss_sum_count(self, batch: dict[str, torch.Tensor]
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        """The forward-only pass (the reference's `_pipeline_loss_local`):
        every microbatch through every chunk, in the forward order of the
        unit grid (stage s runs unit t - s at tick t), with no autograd
        graph: (token-loss sum fp32, valid-target count) over the whole
        batch, the same on every process."""
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
        return (self.transport.from_last_stage(total),
                (targets != llama.IGNORE_INDEX).sum())


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

