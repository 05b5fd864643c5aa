"""Pipeline schedules as DATA: typed per-stage unit sequences.

A copy of llama_pipeline_parallel_tpu/parallel/schedule.py (numpy and the
standard library only), kept so that this package never imports the JAX one;
tests/test_torch_schedule.py pins its outputs to the reference's. A schedule
is a grid of typed units that `parallel/pipeline.py`'s one interpreter
executes; the three named schedules (flat 1f1b, interleaved 1f1b, zb1) are
emitted by `canonical_schedule`, and a `solver` sequence is loaded from a file
(`load`) written by either package's `to_json`.

Vocabulary (one scheduling unit = one (microbatch, virtual-chunk) pair
passing through one stage):

  F  — forward of a unit (embed on (stage 0, chunk 0))
  B  — backward of a unit. Fused schedules compute input-grad AND
       weight-grad here (cost 2); split-backward schedules compute the
       input-grad only (cost 1) and stash a (chunk input, ring cotangent)
       residual pair into the W queue
  W  — weight-grad replay of a stashed residual (split backward only)
  send/recv — the per-tick stage-to-stage handoffs, encoded as the
       `ring_fwd` / `ring_bwd` tick flags (one value per direction per
       stage per tick)
  offload-push/offload-pop — per-UNIT host-memory tiering of the W residual
       (`offload_units`: the interpreter pushes the unit's pair to a pinned
       host ring at B and brings it back for W, utils/host_stash.py)

The grid representation: `f_unit`/`b_unit`/`w_unit` are [num_ticks,
num_stages] int arrays (-1 = no unit: the stage idles that half-tick), and
`has_f`/`has_b`/`has_w` are per-tick STRUCTURAL flags. `bubble_stats` counts
the lockstep model the reference compiles (every stage is charged each
structurally present half); the port's interpreter computes only the valid
cells, so on one card, where the stages run one after another, the bubble
costs no wall time.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np


class ScheduleError(ValueError):
    """A unit sequence that no interpreter run could execute correctly
    (broken transport, ring overflow, W before its B, ...)."""


SCHEDULE_FORMAT = "lpt-unit-schedule"
SCHEDULE_VERSION = 1

# Unit costs in the lockstep-scan model (bubble_stats): dL/dx and dL/dW are
# each the same matmul flops as the forward, so F = B = W = 1 and a fused
# backward (input-grad + weight-grad in one tick) costs 2 — the same
# accounting the deleted bubble_fraction formulas used.
COST_F = 1
COST_W = 1


def _cost_b(split_backward: bool) -> int:
    return 1 if split_backward else 2


@dataclasses.dataclass(frozen=True, eq=False)
class UnitSchedule:
    """One pipeline flush as data. All grids are [num_ticks, num_stages]
    int32 with -1 = idle; flags are [num_ticks] bool; `offload_units` /
    `wq_slot` are [n_units] (empty when not split_backward).

    `wq_slot[g]` is unit g's slot WITHIN its destination buffer
    (`offload_units[g]` picks host vs HBM); `wq_hbm_slots`/`wq_host_slots`
    size the two buffers after liveness reuse — the schedule-determined
    peak the byte models read (pipeline.wgrad_partition)."""

    num_stages: int
    virtual_stages: int
    num_microbatches: int  # per flush
    split_backward: bool
    f_unit: np.ndarray
    b_unit: np.ndarray
    w_unit: np.ndarray
    has_f: np.ndarray
    has_b: np.ndarray
    has_w: np.ndarray
    ring_fwd: np.ndarray
    ring_bwd: np.ndarray
    ring_slots: int
    offload_units: np.ndarray
    wq_slot: np.ndarray
    wq_hbm_slots: int
    wq_host_slots: int
    label: str = ""
    # Per-stage LAYER counts for UNEQUAL partitions (None = even): a unit's
    # cost on stage s is stage_costs[s] layer-units instead of 1, so the
    # lockstep wall charges every tick at the SLOWEST stage's cost while a
    # lighter stage's unit does proportionally less useful work —
    # bubble_stats counts both the fill/drain idle AND the per-tick
    # imbalance (SkipPipe/MPMD-PP's unequal-stage cost model, PAPERS.md).
    # Ring transport and liveness rules are layer-count-independent (a
    # stage's chunk is opaque to the ring), so the validator only checks
    # shape. v=1 only: the round-robin chunk layout has no uneven form.
    stage_costs: tuple | None = None

    @property
    def n_units(self) -> int:
        return self.num_microbatches * self.virtual_stages

    @property
    def num_ticks(self) -> int:
        return int(self.f_unit.shape[0])

    @property
    def offloaded_units(self) -> int:
        return int(self.offload_units.sum()) if self.split_backward else 0


def unit_mb_chunk(u: int, s: int, v: int) -> tuple[int, int]:
    """Forward unit index -> (microbatch, virtual chunk): group g covers
    microbatches [g*S, (g+1)*S) through all v chunks chunk-major, so unit
    u and u+S are the same microbatch one chunk (= one ring lap) later —
    the ordering that lets the plain ring ppermute carry chunk transitions
    (the numpy twin of pipeline._unit_mb_chunk)."""
    grp = u // (v * s)
    return grp * s + u % s, (u // s) % v


def bwd_unit_mb_chunk(g: int, s: int, v: int) -> tuple[int, int]:
    """Backward unit index -> (microbatch, chunk), chunk order reversed."""
    grp = g // (v * s)
    return grp * s + g % s, v - 1 - (g // s) % v


def bwd_fwd_unit(g: int, s: int, v: int) -> int:
    """The FORWARD unit whose buffered input backward unit g recomputes
    from (the xbuf slot key)."""
    _, ch = bwd_unit_mb_chunk(g, s, v)
    return (g // (v * s)) * (v * s) + ch * s + g % s


# ---------------------------------------------------------------------------
# Canonical generators — the three deleted schedules as sequences
# ---------------------------------------------------------------------------

def _grids(num_ticks: int, num_stages: int):
    shape = (num_ticks, num_stages)
    return (np.full(shape, -1, np.int32), np.full(shape, -1, np.int32),
            np.full(shape, -1, np.int32))


def _norm_costs(stage_costs, s: int):
    """Validate/normalize a per-stage layer-count vector at generation time
    (None passes through: even partitions carry no cost vector)."""
    if stage_costs is None:
        return None
    costs = tuple(int(c) for c in stage_costs)
    if len(costs) != s:
        raise ScheduleError(f"stage_costs has {len(costs)} entries for "
                            f"{s} stages")
    if any(c < 1 for c in costs):
        raise ScheduleError(f"every stage needs cost >= 1 layer, got {costs}")
    return costs


def generate_1f1b(m: int, s: int, stage_costs=None) -> UnitSchedule:
    """The flat 1F1B grid the deleted `_pipeline_1f1b_local` scanned: one
    segment of m + 2(S-1) ticks, EVERY tick structurally F+B with both
    ring directions (warmup/drain slots are -1 = masked, exactly as the
    old single scan masked them), forward unit t-s / backward unit
    t-(2S-2-s). At S=1 the forward half never existed (the fused backward
    re-embeds under its stage-0 cond), so the grid is B-only."""
    costs = _norm_costs(stage_costs, s)
    if s == 1:
        f, b, w = _grids(m, 1)
        b[:, 0] = np.arange(m)
        t = np.zeros(m, bool)
        return UnitSchedule(
            num_stages=1, virtual_stages=1, num_microbatches=m,
            split_backward=False, f_unit=f, b_unit=b, w_unit=w,
            has_f=t.copy(), has_b=~t, has_w=t.copy(),
            ring_fwd=t.copy(), ring_bwd=t.copy(), ring_slots=1,
            offload_units=np.zeros(0, bool), wq_slot=np.zeros(0, np.int32),
            wq_hbm_slots=0, wq_host_slots=0, label="1f1b",
            stage_costs=costs)
    num_ticks = m + 2 * (s - 1)
    f, b, w = _grids(num_ticks, s)
    t_idx = np.arange(num_ticks)[:, None]
    st = np.arange(s)[None, :]
    fu = t_idx - st
    bu = t_idx - (2 * (s - 1) - st)
    f[:] = np.where((fu >= 0) & (fu < m), fu, -1)
    b[:] = np.where((bu >= 0) & (bu < m), bu, -1)
    on = np.ones(num_ticks, bool)
    return UnitSchedule(
        num_stages=s, virtual_stages=1, num_microbatches=m,
        split_backward=False, f_unit=f, b_unit=b, w_unit=w,
        has_f=on.copy(), has_b=on.copy(), has_w=np.zeros(num_ticks, bool),
        ring_fwd=on.copy(), ring_bwd=on.copy(),
        ring_slots=min(2 * s - 1, m),
        offload_units=np.zeros(0, bool), wq_slot=np.zeros(0, np.int32),
        wq_hbm_slots=0, wq_host_slots=0, label="1f1b", stage_costs=costs)


def generate_interleaved(m: int, s: int, v: int = 1,
                         split_backward: bool = False,
                         offload_units=None,
                         w_placement: str = "trailing",
                         label: str | None = None,
                         stage_costs=None) -> UnitSchedule:
    """The phased interleaved grid the deleted
    `_pipeline_interleaved_1f1b_local` ran: vS-1 forward-only warmup
    ticks, steady F+B ticks, vS-1 backward-only drain ticks — forward
    unit t-s, backward unit t-((v+1)S-2-s). With `split_backward` (zb1)
    the B ticks stash residuals and `w_placement` places the W units:

      "trailing" — the canonical zb1 fourth phase: n_units W-only ticks
        after the ring goes quiet, ascending unit order on every stage
        (the fold order that keeps zb1 bit-exact vs the fused backward).
      "drain" — the solver's variant: each backward-drain tick also
        replays one W unit (the drain tick's cost grows 1 -> 2, the
        trailing phase shrinks by the same count: SAME wall clock and
        bubble), so the earliest-pushed residuals retire vS-1 ticks
        sooner and liveness slot-reuse shrinks the resident W queue.

    `offload_units`: per-unit host-tier decision vector (None = all-HBM;
    pass np.ones for the legacy offload.wgrad_stash behavior)."""
    costs = _norm_costs(stage_costs, s)
    if v > 1 and costs is not None and len(set(costs)) != 1:
        raise ScheduleError(
            f"unequal stage_costs={costs} require v=1: the round-robin "
            f"chunk layout has no uneven form (got v={v})")
    if v > 1 and m % s:
        raise ScheduleError(
            f"interleaved sequences need m divisible by num_stages at "
            f"v > 1 (the round-robin unit groups hold one microbatch per "
            f"stage); got m={m}, s={s}, v={v}")
    n_units = m * v
    warm = v * s - 1
    d_off = (v + 1) * s - 2
    t_main = n_units + d_off
    fwd_end = n_units + s - 1
    n_steady = max(fwd_end - warm, 0)
    n_drain = t_main - warm - n_steady

    drain_w = 0
    if split_backward and w_placement == "drain":
        # only ticks whose W unit's B has already run on EVERY stage
        # qualify; at m >= s (guaranteed for v > 1) that is all of them
        drain_w = min(n_drain, n_units) if n_units > v * s - 1 else 0
    elif w_placement != "trailing":
        raise ScheduleError(f"unknown w_placement {w_placement!r}")
    t_w = (n_units - drain_w) if split_backward else 0
    num_ticks = t_main + t_w

    f, b, w = _grids(num_ticks, s)
    t_idx = np.arange(t_main)[:, None]
    st = np.arange(s)[None, :]
    fu = t_idx - st
    bu = t_idx - (d_off - st)
    f[:t_main] = np.where((fu >= 0) & (fu < n_units) & (t_idx < fwd_end),
                          fu, -1)
    b[:t_main] = np.where((bu >= 0) & (bu < n_units) & (t_idx >= warm),
                          bu, -1)

    has_f = np.zeros(num_ticks, bool)
    has_b = np.zeros(num_ticks, bool)
    has_w = np.zeros(num_ticks, bool)
    has_f[:warm + n_steady] = True
    has_b[warm:t_main] = True
    if split_backward:
        if drain_w:
            drain0 = warm + n_steady
            has_w[drain0:drain0 + drain_w] = True
            w[drain0:drain0 + drain_w, :] = np.arange(drain_w)[:, None]
        has_w[t_main:] = True
        w[t_main:, :] = np.arange(drain_w, n_units)[:, None]
    ring_fwd = has_f.copy()
    ring_bwd = has_b.copy()

    if split_backward:
        off = (np.zeros(n_units, bool) if offload_units is None
               else np.asarray(offload_units, bool).copy())
        if off.shape != (n_units,):
            raise ScheduleError(
                f"offload_units has shape {off.shape}, expected ({n_units},)")
        wq_slot, hbm_n, host_n = _assign_wq_slots(
            s, v, n_units, b, w, off)
    else:
        off = np.zeros(0, bool)
        wq_slot, hbm_n, host_n = np.zeros(0, np.int32), 0, 0

    if label is None:
        label = "zb1" if split_backward else "interleaved_1f1b"
        if split_backward and w_placement == "drain":
            label = "zb1/drain-w"
    return UnitSchedule(
        num_stages=s, virtual_stages=v, num_microbatches=m,
        split_backward=split_backward, f_unit=f, b_unit=b, w_unit=w,
        has_f=has_f, has_b=has_b, has_w=has_w,
        ring_fwd=ring_fwd, ring_bwd=ring_bwd,
        ring_slots=min(2 * v * s - 1, n_units),
        offload_units=off, wq_slot=wq_slot,
        wq_hbm_slots=hbm_n, wq_host_slots=host_n, label=label,
        stage_costs=costs)


def _assign_wq_slots(s: int, v: int, n_units: int, b_grid, w_grid, off):
    """Greedy liveness slot reuse, computed per destination buffer over the
    CONSERVATIVE union window (earliest B push across stages -> latest W
    pop across stages), so one slot map is valid on every stage. Canonical
    trailing-W schedules get the identity map (nothing retires before the
    drain); drain-interleaved W frees the earliest units while late B
    units are still pushing, compressing the resident queue."""
    push = np.full(n_units, np.iinfo(np.int64).max, np.int64)
    pop = np.full(n_units, -1, np.int64)
    t_pos, s_pos = np.nonzero(b_grid >= 0)
    np.minimum.at(push, b_grid[t_pos, s_pos], t_pos)
    t_pos, s_pos = np.nonzero(w_grid >= 0)
    np.maximum.at(pop, w_grid[t_pos, s_pos], t_pos)
    push[push == np.iinfo(np.int64).max] = -1
    slots = np.zeros(n_units, np.int32)
    counts = {}
    for dest in (False, True):
        units = [g for g in range(n_units) if bool(off[g]) == dest]
        free: list[int] = []
        import heapq

        busy: list[tuple[int, int]] = []  # (pop_tick, slot)
        n_slots = 0
        for g in sorted(units, key=lambda g: (push[g], g)):
            while busy and busy[0][0] < push[g]:
                _, sl = heapq.heappop(busy)
                heapq.heappush(free, sl)
            if free:
                sl = heapq.heappop(free)
            else:
                sl = n_slots
                n_slots += 1
            slots[g] = sl
            heapq.heappush(busy, (pop[g], sl))
        counts[dest] = n_slots
    return slots, counts[False], counts[True]


def canonical_schedule(schedule: str, m: int, s: int, v: int = 1,
                       offload_wgrad: bool = False,
                       stage_costs=None) -> UnitSchedule:
    """The named schedule's canonical per-flush sequence — the generator
    that re-emits the three deleted hand-written scans as data.
    `stage_costs`: per-stage layer counts for an UNEQUAL partition (the
    unit placement is identical — only the cost accounting changes)."""
    if schedule == "1f1b":
        return generate_1f1b(m, s, stage_costs=stage_costs)
    if schedule == "interleaved_1f1b":
        return generate_interleaved(m, s, v, stage_costs=stage_costs)
    if schedule == "zb1":
        off = np.ones(m * v, bool) if offload_wgrad else None
        return generate_interleaved(m, s, v, split_backward=True,
                                    offload_units=off,
                                    stage_costs=stage_costs)
    raise ScheduleError(f"no canonical sequence for schedule {schedule!r}")


# ---------------------------------------------------------------------------
# Cost model: idle-unit accounting on the lockstep grid
# ---------------------------------------------------------------------------

def bubble_stats(us: UnitSchedule) -> tuple[int, int]:
    """(idle_units, wall_units) summed over all stages for one flush, in
    F=B=W unit costs. The wall charges every stage each structurally
    present half (the lockstep scan runs masked slots and discards them);
    useful work counts only the real (non -1) units. bubble =
    idle / wall — the generic form of the three deleted closed formulas,
    now derived by COUNTING the emitted sequence's idle ticks.

    With UNEQUAL `stage_costs` the accounting goes to LAYER units: a tick's
    wall cost is max(stage_costs) per structurally present half (the
    lockstep ppermute syncs every stage to the slowest one), while stage
    s's live unit contributes only stage_costs[s] useful layer-units — so
    the bubble counts fill/drain idle AND per-tick imbalance in one number.
    Even partitions (stage_costs None or uniform k) scale idle and wall by
    the same k, reducing to the identical rational: the floats stay
    bit-identical to the uncosted accounting."""
    bc = _cost_b(us.split_backward)
    costs = us.stage_costs
    if costs is None or len(set(costs)) == 1:
        wall = int(us.has_f.sum() * COST_F + us.has_b.sum() * bc
                   + us.has_w.sum() * COST_W)
        useful = int((us.f_unit >= 0).sum() * COST_F
                     + (us.b_unit >= 0).sum() * bc
                     + (us.w_unit >= 0).sum() * COST_W)
        total = us.num_stages * wall
        return total - useful, total
    c = np.asarray(costs, np.int64)
    cmax = int(c.max())
    wall = int(us.has_f.sum() * COST_F + us.has_b.sum() * bc
               + us.has_w.sum() * COST_W) * cmax
    useful = int(((us.f_unit >= 0) * c[None, :]).sum() * COST_F
                 + ((us.b_unit >= 0) * c[None, :]).sum() * bc
                 + ((us.w_unit >= 0) * c[None, :]).sum() * COST_W)
    total = us.num_stages * wall
    return total - useful, total


def analytic_bubble(us: UnitSchedule) -> float:
    idle, wall = bubble_stats(us)
    return idle / wall if wall else 0.0


# ---------------------------------------------------------------------------
# Segment decomposition: the interpreter's compile units as data
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Segment:
    """One maximal run of ticks with identical structural flags — exactly
    the runs the reference's interpreter compiles into one `lax.scan`
    each (the canonical sequences' warmup / steady / drain / W-drain
    phases). Shared between the interpreter and the schedule observatory
    (utils/timeline.py) so the timed boundaries and the executed scans can
    never disagree about where a segment starts."""

    index: int
    t0: int
    t1: int
    has_f: bool
    has_b: bool
    has_w: bool
    ring_fwd: bool
    ring_bwd: bool
    label: str

    @property
    def num_ticks(self) -> int:
        return self.t1 - self.t0


def segments(us: UnitSchedule) -> list[Segment]:
    """The sequence's maximal equal-flag tick runs, in execution order.
    Labels name the active halves ("F", "F+B", "B", "B+W", "W"); a repeated
    label (possible for solver sequences with several same-shaped phases)
    gets a "#k" suffix so every segment's label is unique within the
    flush — timeline records key on it."""
    flags = list(zip(us.has_f.tolist(), us.has_b.tolist(),
                     us.has_w.tolist(), us.ring_fwd.tolist(),
                     us.ring_bwd.tolist()))
    out: list[Segment] = []
    seen: dict[str, int] = {}
    t0 = 0
    while t0 < len(flags):
        t1 = t0
        while t1 < len(flags) and flags[t1] == flags[t0]:
            t1 += 1
        has_f, has_b, has_w, r_f, r_b = flags[t0]
        parts = [p for p, on in (("F", has_f), ("B", has_b), ("W", has_w))
                 if on]
        label = "+".join(parts) if parts else "idle"
        n = seen.get(label, 0)
        seen[label] = n + 1
        if n:
            label = f"{label}#{n + 1}"
        out.append(Segment(index=len(out), t0=t0, t1=t1, has_f=has_f,
                           has_b=has_b, has_w=has_w, ring_fwd=r_f,
                           ring_bwd=r_b, label=label))
        t0 = t1
    return out


def segment_stats(us: UnitSchedule) -> list[dict]:
    """Per-segment idle accounting in the same unit costs as bubble_stats:
    for each segment, the lockstep wall units every stage is charged and
    each stage's USEFUL units within it — so a measured per-segment
    duration can be split into busy and idle time (the timeline layer's
    measured bubble: weight each segment's scheduled idle fraction by its
    measured wall instead of its scheduled one). Summing
    (wall - useful) / wall over segments reproduces bubble_stats exactly;
    the dicts also carry the per-stage busy fractions the straggler
    report uses and the count of host-offloaded W units (transfer-stall
    attribution)."""
    bc = _cost_b(us.split_backward)
    costs = us.stage_costs
    s = us.num_stages
    c = (np.ones(s, np.int64) if costs is None
         else np.asarray(costs, np.int64))
    cmax = int(c.max())
    off = us.offload_units
    out = []
    for seg in segments(us):
        sl = slice(seg.t0, seg.t1)
        wall = (int(seg.has_f) * COST_F + int(seg.has_b) * bc
                + int(seg.has_w) * COST_W) * seg.num_ticks * cmax
        useful = (((us.f_unit[sl] >= 0) * c[None, :]).sum(0) * COST_F
                  + ((us.b_unit[sl] >= 0) * c[None, :]).sum(0) * bc
                  + ((us.w_unit[sl] >= 0) * c[None, :]).sum(0) * COST_W)
        w_units = us.w_unit[sl]
        host_w = 0
        if us.split_backward and off.size:
            live_w = np.unique(w_units[w_units >= 0])
            host_w = int(off[live_w].sum()) if live_w.size else 0
        out.append({
            "label": seg.label,
            "num_ticks": seg.num_ticks,
            "wall_units": wall,
            "useful_units": [int(u) for u in useful],
            "busy_frac": [float(u) / wall if wall else 0.0 for u in useful],
            "offloaded_w_units": host_w,
        })
    return out


# ---------------------------------------------------------------------------
# Validation: dependency / liveness / ring-capacity checks
# ---------------------------------------------------------------------------

def validate(us: UnitSchedule) -> None:
    """Reject any sequence the interpreter could not execute correctly.

    Checks, in order: grid/flag shape consistency; complete unit streams
    (each stage runs every F/B/W unit exactly once); intra-stage
    dependencies (B after its unit's F; W strictly after its B — a W
    scheduled before its B is the classic cycle); ring transport lockstep
    (a consumed value must have been produced by the ring predecessor on
    the immediately preceding tick, with that tick's ring flag set);
    stage-input ring-buffer capacity (no live slot overwritten before its
    backward reads it); W-queue slot liveness. Raises ScheduleError with
    the first violation named."""
    s, v, n = us.num_stages, us.virtual_stages, us.n_units
    t_total = us.num_ticks
    if v > 1 and n % (v * s):
        # partial round-robin unit groups would make the bwd->fwd unit map
        # (fwd_of_b below) index past n — name the violation instead
        raise ScheduleError(
            f"n_units={n} is not a whole number of round-robin unit groups "
            f"(v*s={v * s}) — v > 1 sequences need m divisible by "
            f"num_stages")
    for name, grid in (("f", us.f_unit), ("b", us.b_unit), ("w", us.w_unit)):
        if grid.shape != (t_total, s):
            raise ScheduleError(f"{name}_unit grid shape {grid.shape} != "
                               f"({t_total}, {s})")
        if grid.max(initial=-1) >= n or grid.min(initial=-1) < -1:
            raise ScheduleError(f"{name}_unit entries outside [-1, {n})")
    for name, flag, grid in (("f", us.has_f, us.f_unit),
                             ("b", us.has_b, us.b_unit),
                             ("w", us.has_w, us.w_unit)):
        if flag.shape != (t_total,):
            raise ScheduleError(f"has_{name} length {flag.shape} != {t_total}")
        bad = (~flag) & (grid >= 0).any(axis=1)
        if bad.any():
            raise ScheduleError(
                f"{name.upper()} unit scheduled in a tick whose has_{name} "
                f"flag is off (tick {int(np.argmax(bad))})")
    if (us.ring_fwd & ~us.has_f).any():
        raise ScheduleError("ring_fwd set on a tick with no forward half")
    if (us.ring_bwd & ~us.has_b).any():
        raise ScheduleError("ring_bwd set on a tick with no backward half")
    if us.has_f.any() and us.ring_slots < 1:
        raise ScheduleError(
            f"ring_slots={us.ring_slots} cannot buffer any stage input "
            f"(the interpreter's `unit % ring_slots` would be undefined)")
    if us.split_backward and us.wq_slot.size and int(us.wq_slot.min()) < 0:
        raise ScheduleError("negative wq_slot entries (the interpreter's "
                           "clip would silently alias residual slots)")
    if us.stage_costs is not None:
        _norm_costs(us.stage_costs, s)  # shape/positivity
        if v > 1 and len(set(us.stage_costs)) != 1:
            raise ScheduleError(
                f"unequal stage_costs={tuple(us.stage_costs)} require v=1: "
                f"the round-robin chunk layout has no uneven form")

    # per-stage unit streams + tick-of-unit maps (vectorized: the validator
    # runs inside every solver-candidate construction, so it must stay
    # cheap at n_units in the hundreds)
    def stream_ticks(grid, name, required):
        ticks = np.full((s, n), -1, np.int64)
        mask = grid >= 0
        if not required:
            if mask.any():
                raise ScheduleError(f"{name} units scheduled where none "
                                   f"belong")
            return ticks
        for st in range(s):
            col = grid[:, st]
            units = col[col >= 0]
            counts = np.bincount(units, minlength=n) if units.size else \
                np.zeros(n, np.int64)
            if units.size != n or (counts != 1).any():
                raise ScheduleError(
                    f"stage {st} {name} stream is not each unit exactly "
                    f"once (got {units.size} entries over "
                    f"{int((counts > 0).sum())} distinct units of {n})")
        # for each (t, st) holding a unit, ticks[st, unit] = t
        t_pos, s_pos = np.nonzero(mask)
        ticks[s_pos, grid[t_pos, s_pos]] = t_pos
        return ticks

    has_fwd = bool(us.has_f.any())
    if not has_fwd and (s > 1 or v > 1):
        raise ScheduleError("no forward ticks: only the S=1 v=1 fused "
                            "re-embed form may omit the forward half")
    f_ticks = stream_ticks(us.f_unit, "F", required=has_fwd)
    b_ticks = stream_ticks(us.b_unit, "B", required=True)
    w_ticks = stream_ticks(us.w_unit, "W", required=us.split_backward)

    # unit-index maps as vectors
    units = np.arange(n)
    grp = units // (v * s)
    ch_of_b = v - 1 - (units // s) % v
    fwd_of_b = grp * (v * s) + ch_of_b * s + units % s  # bwd_fwd_unit
    ch_of_f = (units // s) % v

    # intra-stage dependencies (same-tick is legal: the interpreter's tick
    # body runs F, then B, then W — the flat last stage backprops a
    # microbatch the same tick it finishes it)
    if has_fwd:
        bad = b_ticks < f_ticks[:, fwd_of_b]
        if bad.any():
            st, g = map(int, np.argwhere(bad)[0])
            raise ScheduleError(
                f"cyclic dependency: stage {st} backward of unit {g} at "
                f"tick {b_ticks[st, g]} precedes its forward "
                f"(unit {fwd_of_b[g]} at tick {f_ticks[st, fwd_of_b[g]]})")
    if us.split_backward:
        bad = w_ticks < b_ticks
        if bad.any():
            st, g = map(int, np.argwhere(bad)[0])
            raise ScheduleError(
                f"W before B: stage {st} replays unit {g}'s weight grad "
                f"at tick {w_ticks[st, g]} but its B unit (which stashes "
                f"the residual) runs at tick {b_ticks[st, g]}")

    # ring transport lockstep: a consumed value must have been produced by
    # the ring predecessor on the immediately preceding ring-flagged tick
    t_pos, s_pos = np.nonzero(us.f_unit >= 0)
    u_pos = us.f_unit[t_pos, s_pos]
    consume = ~((s_pos == 0) & (ch_of_f[u_pos] == 0))  # embed-source exempt
    pred = (s_pos - 1) % s
    u_pred = np.where(s_pos > 0, u_pos, u_pos - s)
    ok = (t_pos > 0)
    ok &= np.where(t_pos > 0, us.ring_fwd[np.maximum(t_pos - 1, 0)], False)
    ok &= us.f_unit[np.maximum(t_pos - 1, 0), pred] == u_pred
    bad = consume & ~ok
    if bad.any():
        i = int(np.argmax(bad))
        raise ScheduleError(
            f"forward transport broken: stage {int(s_pos[i])} consumes unit "
            f"{int(u_pos[i])} at tick {int(t_pos[i])} but stage "
            f"{int(pred[i])} did not produce unit {int(u_pred[i])} on ring "
            f"tick {int(t_pos[i]) - 1}")
    t_pos, s_pos = np.nonzero(us.b_unit >= 0)
    g_pos = us.b_unit[t_pos, s_pos]
    owns_loss = (s_pos == s - 1) & (ch_of_b[g_pos] == v - 1)
    pred = (s_pos + 1) % s
    g_pred = np.where(s_pos < s - 1, g_pos, g_pos - s)
    ok = (t_pos > 0) & (g_pred >= 0)
    ok &= np.where(t_pos > 0, us.ring_bwd[np.maximum(t_pos - 1, 0)], False)
    ok &= us.b_unit[np.maximum(t_pos - 1, 0), pred] == g_pred
    bad = ~owns_loss & ~ok
    if bad.any():
        i = int(np.argmax(bad))
        raise ScheduleError(
            f"backward transport broken: stage {int(s_pos[i])} consumes "
            f"the cotangent of unit {int(g_pos[i])} at tick "
            f"{int(t_pos[i])} but stage {int(pred[i])} did not produce "
            f"unit {int(g_pred[i])} on ring tick {int(t_pos[i]) - 1}")

    # stage-input ring capacity: F(u) writes slot u % ring_slots; the
    # matching backward reads it later; no other write may land in between
    if has_fwd:
        read_of_fwd = np.empty((s, n), np.int64)
        read_of_fwd[:, fwd_of_b] = b_ticks[:, units]
        slots = units % us.ring_slots
        for st in range(s):
            order = np.lexsort((units, f_ticks[st]))
            for slot in range(us.ring_slots):
                grp_u = order[slots[order] == slot]  # write-tick order
                if grp_u.size < 2:
                    continue
                wr_next = f_ticks[st, grp_u[1:]]
                rd_cur = read_of_fwd[st, grp_u[:-1]]
                bad_i = np.nonzero((wr_next > f_ticks[st, grp_u[:-1]])
                                   & (wr_next <= rd_cur))[0]
                if bad_i.size:
                    i = int(bad_i[0])
                    u1, u2 = int(grp_u[i]), int(grp_u[i + 1])
                    raise ScheduleError(
                        f"ring overflow: stage {st} slot {slot} (unit {u1}, "
                        f"written tick {f_ticks[st, u1]}, read tick "
                        f"{read_of_fwd[st, u1]}) is overwritten by unit "
                        f"{u2} at tick {f_ticks[st, u2]} — ring_slots="
                        f"{us.ring_slots} is too small")

    # W-queue slot liveness per destination buffer (conservative union
    # windows across stages must not overlap within one slot)
    if us.split_backward:
        if us.offload_units.shape != (n,) or us.wq_slot.shape != (n,):
            raise ScheduleError("offload_units / wq_slot must have one entry "
                               "per unit")
        push_u = b_ticks.min(axis=0)
        pop_u = w_ticks.max(axis=0)
        for dest, n_slots in ((False, us.wq_hbm_slots),
                              (True, us.wq_host_slots)):
            sel = np.nonzero(us.offload_units == dest)[0]
            if sel.size and int(us.wq_slot[sel].max()) >= n_slots:
                raise ScheduleError(
                    f"wq slot out of range for the "
                    f"{'host' if dest else 'HBM'} buffer ({n_slots} slots)")
            order = sel[np.lexsort((sel, push_u[sel]))]
            for slot in range(n_slots):
                grp_u = order[us.wq_slot[order] == slot]
                if grp_u.size < 2:
                    continue
                bad_i = np.nonzero(push_u[grp_u[1:]]
                                   <= pop_u[grp_u[:-1]])[0]
                if bad_i.size:
                    i = int(bad_i[0])
                    g1, g2 = int(grp_u[i]), int(grp_u[i + 1])
                    raise ScheduleError(
                        f"W-queue slot {slot} collision: units {g1} "
                        f"(live ticks {push_u[g1]}-{pop_u[g1]}) and {g2} "
                        f"(live {push_u[g2]}-{pop_u[g2]}) overlap")



# ---------------------------------------------------------------------------
# Serialization: per-stage typed unit sequences + ASCII timeline
# ---------------------------------------------------------------------------

def to_json(us: UnitSchedule) -> str:
    """Serialize as per-stage sequences of typed units — `stages[s][t]` is
    "F3", "F4+B1", "B2+W0", or "-" — plus the per-tick structural/ring
    flags and the W-queue metadata. The grid form round-trips exactly."""
    stages = []
    for st in range(us.num_stages):
        seq = []
        for t in range(us.num_ticks):
            parts = []
            for tag, grid in (("F", us.f_unit), ("B", us.b_unit),
                              ("W", us.w_unit)):
                if grid[t, st] >= 0:
                    parts.append(f"{tag}{int(grid[t, st])}")
            seq.append("+".join(parts) or "-")
        stages.append(seq)
    ticks = [{"run": "".join(tag for tag, flag in
                             (("F", us.has_f[t]), ("B", us.has_b[t]),
                              ("W", us.has_w[t])) if flag),
              "ring": "".join(tag for tag, flag in
                              (("f", us.ring_fwd[t]), ("b", us.ring_bwd[t]))
                              if flag)}
             for t in range(us.num_ticks)]
    doc = {
        "format": SCHEDULE_FORMAT, "version": SCHEDULE_VERSION,
        "label": us.label, "num_stages": us.num_stages,
        "virtual_stages": us.virtual_stages,
        "num_microbatches": us.num_microbatches,
        "split_backward": us.split_backward,
        "ring_slots": us.ring_slots,
        "wq_hbm_slots": us.wq_hbm_slots,
        "wq_host_slots": us.wq_host_slots,
        "offload_units": [bool(x) for x in us.offload_units],
        "wq_slot": [int(x) for x in us.wq_slot],
        "ticks": ticks, "stages": stages,
    }
    if us.stage_costs is not None:
        doc["stage_costs"] = [int(c) for c in us.stage_costs]
    return json.dumps(doc, indent=1)


def from_json(text: str) -> UnitSchedule:
    doc = json.loads(text)
    if doc.get("format") != SCHEDULE_FORMAT:
        raise ScheduleError(f"not a {SCHEDULE_FORMAT} document "
                           f"(format={doc.get('format')!r})")
    if doc.get("version") != SCHEDULE_VERSION:
        raise ScheduleError(f"unsupported schedule version "
                           f"{doc.get('version')!r}")
    s = int(doc["num_stages"])
    stages = doc["stages"]
    ticks = doc["ticks"]
    t_total = len(ticks)
    if len(stages) != s or any(len(seq) != t_total for seq in stages):
        raise ScheduleError("stages/ticks lengths disagree")
    f, b, w = _grids(t_total, s)
    grids = {"F": f, "B": b, "W": w}
    for st, seq in enumerate(stages):
        for t, cell in enumerate(seq):
            if cell == "-":
                continue
            for token in cell.split("+"):
                tag, idx = token[:1], token[1:]
                if tag not in grids or not idx.isdigit():
                    raise ScheduleError(f"bad unit token {token!r} at stage "
                                       f"{st} tick {t}")
                grids[tag][t, st] = int(idx)
    us = UnitSchedule(
        num_stages=s, virtual_stages=int(doc["virtual_stages"]),
        num_microbatches=int(doc["num_microbatches"]),
        split_backward=bool(doc["split_backward"]),
        f_unit=f, b_unit=b, w_unit=w,
        has_f=np.array(["F" in tk["run"] for tk in ticks], bool),
        has_b=np.array(["B" in tk["run"] for tk in ticks], bool),
        has_w=np.array(["W" in tk["run"] for tk in ticks], bool),
        ring_fwd=np.array(["f" in tk["ring"] for tk in ticks], bool),
        ring_bwd=np.array(["b" in tk["ring"] for tk in ticks], bool),
        ring_slots=int(doc["ring_slots"]),
        offload_units=np.array(doc["offload_units"], bool),
        wq_slot=np.array(doc["wq_slot"], np.int32),
        wq_hbm_slots=int(doc["wq_hbm_slots"]),
        wq_host_slots=int(doc["wq_host_slots"]),
        label=str(doc.get("label", "")),
        stage_costs=(tuple(int(c) for c in doc["stage_costs"])
                     if doc.get("stage_costs") is not None else None))
    validate(us)
    return us


def load(path: str) -> UnitSchedule:
    with open(path) as fh:
        return from_json(fh.read())


def ascii_timeline(us: UnitSchedule, max_ticks: int = 64) -> str:
    """Compact per-stage timeline for humans debugging a refused or
    surprising schedule without a TPU (the --emit-schedule companion):
    one column per tick, one row per stage, `.` = idle slot, lowercase
    `w` = a host-tiered residual pop."""
    t_show = min(us.num_ticks, max_ticks)
    cells = [[[] for _ in range(t_show)] for _ in range(us.num_stages)]
    for tag, grid in (("F", us.f_unit), ("B", us.b_unit), ("W", us.w_unit)):
        for t in range(t_show):
            for st in range(us.num_stages):
                if grid[t, st] >= 0:
                    mark = tag
                    if tag == "W" and us.offload_units.size and \
                            us.offload_units[grid[t, st]]:
                        mark = "w"
                    cells[st][t].append(f"{mark}{int(grid[t, st])}")
    width = max((len("+".join(c)) for row in cells for c in row), default=1)
    lines = [f"schedule {us.label or '?'}: S={us.num_stages} "
             f"v={us.virtual_stages} m={us.num_microbatches} "
             f"split_backward={us.split_backward} "
             f"ring_slots={us.ring_slots} "
             f"wq=[hbm {us.wq_hbm_slots} | host {us.wq_host_slots}] "
             + (f"layers/stage={list(us.stage_costs)} "
                if us.stage_costs is not None
                and len(set(us.stage_costs)) != 1 else "")
             + f"bubble={analytic_bubble(us):.4f}"]
    ring = " ".join(
        (("f" if us.ring_fwd[t] else " ") + ("b" if us.ring_bwd[t] else " "))
        .ljust(width) for t in range(t_show))
    lines.append(f"{'ring':>8} | {ring}")
    for st in range(us.num_stages):
        row = " ".join(("+".join(c) or ".").ljust(width)
                       for c in cells[st])
        lines.append(f"stage {st:>2} | {row}")
    if t_show < us.num_ticks:
        lines.append(f"... ({us.num_ticks - t_show} more ticks elided)")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# List-scheduling search space (the solver half preflight scores)
# ---------------------------------------------------------------------------

def with_offload(us: UnitSchedule, offload_units) -> UnitSchedule:
    """The same unit placement with a different per-unit offload vector
    (slots reassigned per destination buffer)."""
    if not us.split_backward:
        raise ScheduleError("offload vectors only apply to split-backward "
                            "schedules (there is no W queue otherwise)")
    off = np.asarray(offload_units, bool).copy()
    if off.shape != (us.n_units,):
        raise ScheduleError(f"offload_units has shape {off.shape}, expected "
                           f"({us.n_units},)")
    wq_slot, hbm_n, host_n = _assign_wq_slots(
        us.num_stages, us.virtual_stages, us.n_units, us.b_unit, us.w_unit,
        off)
    return dataclasses.replace(us, offload_units=off, wq_slot=wq_slot,
                               wq_hbm_slots=hbm_n, wq_host_slots=host_n)


def list_schedule(m: int, s: int, v: int = 1, split_backward: bool = True,
                  w_placement: str = "drain",
                  offload_units=None, stage_costs=None) -> UnitSchedule:
    """The list-scheduling heuristic's entry point: greedily place units
    on the lockstep tick grid in dependency order — which, under the
    lockstep cost model (every stage pays each structurally present
    half), lands on the phased F/B placement of the canonical sequences
    (no schedule can beat it: the fill/drain ticks are forced by the ring
    and every stage's unit work is identical) — then place the W units by
    `w_placement` and apply the per-unit `offload_units` decision vector.
    The searchable freedom this exposes beyond the hand-written three:
    WHERE the W replays go (trailing vs drain-interleaved, compressing
    W-queue residency at the same wall clock) and WHICH residuals tier to
    host (the PipeOffload axis preflight's solver candidates optimize
    against the HBM budget + hide-ratio constraints)."""
    us = generate_interleaved(m, s, v, split_backward=split_backward,
                              w_placement=w_placement if split_backward
                              else "trailing",
                              offload_units=offload_units if split_backward
                              else None,
                              label=f"solver/{w_placement}-w"
                              if split_backward else "solver/fused",
                              stage_costs=stage_costs)
    validate(us)
    return us
