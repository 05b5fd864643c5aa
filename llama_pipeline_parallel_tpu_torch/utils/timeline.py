"""Measured per-phase timelines — the schedule observatory's measurement half.

The counterpart of llama_pipeline_parallel_tpu/utils/timeline.py, with its
`timeline.*` block, its `timeline.jsonl` record and its metrics-line fields.
The pipeline interpreter (parallel/pipeline.py) runs each flush's unit
sequence tick by tick; with `timeline.enabled: true` it records a
**boundary mark** per stage of its process at the flush's start and at the
end of every segment of `schedule.segments` (the maximal equal-flag tick
runs: warmup / steady / drain / W-drain), and the train step records one
more after the optimizer update (`OPTIMIZER_BOUNDARY`). A mark is a
`torch.cuda.Event` recorded on the card's stream (on the CPU, the host
clock at that point); after the step's barrier the collector turns each
into seconds on the host clock. From those durations this module derives:

- a per-step `timeline.jsonl` record: per-segment measured durations,
  **bubble_fraction_measured** (each segment's scheduled idle fraction —
  `schedule.segment_stats` — weighted by its MEASURED wall instead of its
  scheduled one) next to the analytic number, per-stage straggler
  z-scores, and host-offload transfer-stall attribution;
- the metrics-line / health.json summary fields
  (`bubble_fraction_measured`, rolling `step_time_p50`/`step_time_p95`).

With every stage in one process the stages share the card's one stream:
a stage's segment wall is the card's wall between its marks, the stages'
totals are equal, and the straggler z-scores read 0 — they mean something
only for a pipeline across processes (DistTransport), where process 0
gathers every process's marks over the host group once a step
(`gather_marks`). At pp = 1 no pipeline runs and no segment is marked:
the records carry the step wall and the one-stage plan's analytic bubble
(0) only; gpipe's carry the step wall only, as in the reference, which has
no unit sequence for it. OFF records nothing.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import time
from typing import Any

import numpy as np

from llama_pipeline_parallel_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

TIMELINE_KEYS = {"enabled", "window"}

# Boundary index of the train step's post-optimizer-update mark
# (parallel/train_step.py) — far above any segment count.
OPTIMIZER_BOUNDARY = 1 << 16


@dataclasses.dataclass(frozen=True)
class TimelineConfig:
    """The `timeline.*` config block, parsed in one place (unknown keys
    rejected like `offload.*`)."""

    enabled: bool = False
    window: int = 64  # rolling window for step_time_p50/p95

    @classmethod
    def from_cfg(cls, node: Any) -> "TimelineConfig":
        node = node or {}
        if not isinstance(node, dict):
            raise ValueError(
                f"timeline must be a mapping, e.g. timeline: {{enabled: "
                f"true}} — got {node!r}")
        unknown = set(node) - TIMELINE_KEYS
        if unknown:
            raise ValueError(f"unknown timeline.* key(s) {sorted(unknown)}; "
                             f"known: {sorted(TIMELINE_KEYS)}")
        raw = node.get("window", 64)
        window = 64 if raw is None else int(raw)  # `window:` empty = default
        if window < 2:
            # an explicit 0/1 is a config mistake, not a default request —
            # rejected like the unknown keys above
            raise ValueError(f"timeline.window must be >= 2, got {window}")
        return cls(enabled=bool(node.get("enabled", False)), window=window)


# -- the mark sink ------------------------------------------------------------

_COLLECTOR: "TimelineCollector | None" = None


def mark(boundary: int, *stages: int) -> None:
    """Record one boundary mark for each of `stages` into the installed
    collector: one event on the current stream of the card (on the CPU, one
    reading of the host clock) that the stages share; nothing when no
    collector is installed."""
    c = _COLLECTOR
    if c is None:
        return
    import torch

    if c.device is not None and c.device.type == "cuda":
        at = torch.cuda.Event(enable_timing=True)
        at.record()
    else:
        at = time.perf_counter()
    c._marks.extend((int(boundary), int(stage), at) for stage in stages)


def install(collector: "TimelineCollector | None") -> None:
    """Point the process-global mark sink at this run's collector (None
    detaches)."""
    global _COLLECTOR
    _COLLECTOR = collector


class SegmentPlan:
    """Host-side description of what the boundary marks delimit: the
    per-flush segment decomposition (labels, scheduled idle accounting,
    offloaded-W counts) of the sequence the interpreter runs — built from
    the SAME `schedule.segments` grouping, so mark indices and the
    interpreter's segments can never disagree."""

    def __init__(self, pcfg) -> None:
        from llama_pipeline_parallel_tpu_torch.parallel import pipeline as pl
        from llama_pipeline_parallel_tpu_torch.parallel import schedule as usched

        if pcfg.schedule == "gpipe":
            raise ValueError(
                f"no segment plan for schedule {pcfg.schedule!r} (gpipe has "
                f"no unit sequence in the reference)")
        us = pl.flush_unit_schedule(pcfg)
        self.num_stages = int(us.num_stages)
        self.stats = usched.segment_stats(us)
        self.analytic_bubble = usched.analytic_bubble(us)
        self.total_wall_units = sum(s["wall_units"] for s in self.stats)
        self.offload_labels = {s["label"] for s in self.stats
                               if s["offloaded_w_units"]}

    def label_of(self, boundary: int) -> str:
        if boundary == 0:
            return "flush_start"
        if boundary >= OPTIMIZER_BOUNDARY:
            return "optimizer"
        if 1 <= boundary <= len(self.stats):
            return self.stats[boundary - 1]["label"]
        return f"boundary_{boundary}"


class TimelineCollector:
    """Per-step mark aggregation -> one timeline record.

    `begin_step` clears the mark list and records the step's base (an event
    on the card with the host clock beside it); the interpreter and the
    train step append marks; `end_step` (called after the step's barrier)
    resolves each mark to seconds on the host clock, gathers every
    process's marks to process 0 under several processes (`group`: the
    host group), groups them per stage, attributes each inter-mark interval
    to the label of the mark that ENDS it, and derives the measured bubble /
    straggler / transfer-stall fields. `plan=None` (gpipe) degrades to
    step-wall-only records."""

    def __init__(self, plan: SegmentPlan | None, device: Any = None, group: Any = None):
        self.plan = plan
        self.device = device
        self.group = group
        self._marks: list = []
        self._host_segments: dict[str, float] = {}
        self._t0 = 0.0
        self._base = None

    def begin_step(self, step: int) -> None:
        import torch

        self._marks = []
        self._host_segments = {}
        self._t0 = time.perf_counter()
        if self.device is not None and self.device.type == "cuda":
            self._base = torch.cuda.Event(enable_timing=True)
            self._base.record()

    def add_host_segment(self, label: str, dur_s: float) -> None:
        """Host-measured phase (e.g. the host optimizer's update) folded
        into the record next to the device segments."""
        self._host_segments[label] = self._host_segments.get(label, 0.0) + dur_s

    def _resolved(self) -> list:
        """The marks as (boundary, stage, host seconds): an event's time is
        the base's host time plus its device time since the base (the loop
        synchronises before each step, so the base runs when recorded)."""
        out = []
        for boundary, stage, t in self._marks:
            if not isinstance(t, float):
                t = self._t0 + self._base.elapsed_time(t) / 1e3
            out.append((boundary, stage, t))
        return out

    def gather_marks(self, marks: list) -> list | None:
        """Every process's marks on process 0 (None elsewhere), over the
        host group; this process's own when it is alone. Host clocks are
        `time.perf_counter` (CLOCK_MONOTONIC), one clock on one machine."""
        if self.group is None:
            return marks
        import torch.distributed as dist

        got = [None] * dist.get_world_size(self.group) if dist.get_rank() == 0 else None
        dist.gather_object(marks, got, dst=0, group=self.group)
        return None if got is None else [m for part in got for m in part]

    def end_step(self, step: int) -> dict | None:
        wall = time.perf_counter() - self._t0
        marks = self.gather_marks(self._resolved())
        self._marks = []
        if marks is None:
            return None
        rec: dict[str, Any] = {"step": int(step),
                               "wall_s": round(wall, 6)}
        if self.plan is not None:
            rec["bubble_fraction_analytic"] = round(
                self.plan.analytic_bubble, 6)
        for label, dur in self._host_segments.items():
            rec.setdefault("host_segments", {})[label] = round(dur, 6)
        if not marks or self.plan is None:
            return rec

        plan = self.plan
        # group per stage in arrival-time order; dp/tp/sp peers of a stage
        # interleave, and per (interval, label) the stage's time accumulates.
        # The optimizer mark is kept OUT of the per-stage streams: its phase
        # starts when the SLOWEST stage finished the pipeline, so measuring
        # it from any one stage's last mark would double-count the
        # straggler's tail into both numbers.
        by_stage: dict[int, list] = collections.defaultdict(list)
        opt_marks: list[float] = []
        last_pipeline_mark = None
        for boundary, stage, t in marks:
            if boundary >= OPTIMIZER_BOUNDARY:
                opt_marks.append(t)
                continue
            by_stage[stage].append((t, boundary))
            if last_pipeline_mark is None or t > last_pipeline_mark:
                last_pipeline_mark = t
        opt_dur = (max(0.0, max(opt_marks) - last_pipeline_mark)
                   if opt_marks and last_pipeline_mark is not None else 0.0)
        label_dur: dict[str, float] = {}
        stage_total: dict[int, float] = {}
        stage_label_dur: dict[str, dict[int, float]] = \
            collections.defaultdict(dict)
        for stage, ms in by_stage.items():
            ms.sort()
            for (t_prev, _), (t, boundary) in zip(ms, ms[1:]):
                label = plan.label_of(boundary)
                d = t - t_prev
                if label == "flush_start":
                    # a later accum flush's opening mark: the gap back to
                    # the previous flush's last boundary is host turnaround,
                    # not schedule time
                    continue
                cur = stage_label_dur[label].get(stage, 0.0)
                stage_label_dur[label][stage] = cur + d
        for label, per_stage in stage_label_dur.items():
            # the segment's lockstep wall is its slowest stage's time
            label_dur[label] = max(per_stage.values())
            for stage, d in per_stage.items():
                stage_total[stage] = stage_total.get(stage, 0.0) + d

        pipeline_s = sum(label_dur.values())
        segs: dict[str, dict] = {}
        bubble_time = 0.0
        transfer_stall = 0.0
        for sstat in plan.stats:
            label = sstat["label"]
            dur = label_dur.get(label)
            if dur is None:
                continue
            busy = sstat["busy_frac"]
            idle_frac = 1.0 - (sum(busy) / len(busy) if busy else 1.0)
            bubble_time += dur * idle_frac
            entry = {"dur_s": round(dur, 6),
                     "share": round(dur / pipeline_s, 4) if pipeline_s else 0.0,
                     "scheduled_share": round(
                         sstat["wall_units"] / plan.total_wall_units, 4)
                     if plan.total_wall_units else 0.0}
            if label in plan.offload_labels and plan.total_wall_units:
                # transfer-stall attribution: wall beyond the segment's
                # scheduled share of the pipeline time, on segments whose W
                # units cross the host link (a heuristic split, not a
                # measurement of the copies themselves)
                expected = (sstat["wall_units"] / plan.total_wall_units
                            * pipeline_s)
                stall = max(dur - expected, 0.0)
                entry["transfer_stall_s"] = round(stall, 6)
                transfer_stall += stall
            segs[label] = entry
        rec["segments"] = segs
        rec["pipeline_s"] = round(pipeline_s, 6)
        if opt_dur:
            rec["optimizer_s"] = round(opt_dur, 6)
        if pipeline_s:
            rec["bubble_fraction_measured"] = round(
                bubble_time / pipeline_s, 6)
        if transfer_stall:
            rec["transfer_stall_s"] = round(transfer_stall, 6)
        if stage_total:
            totals = [stage_total.get(s, 0.0)
                      for s in range(plan.num_stages)]
            mean = float(np.mean(totals))
            std = float(np.std(totals))
            z = [round((t - mean) / std, 3) if std > 1e-12 else 0.0
                 for t in totals]
            rec["stage_time_s"] = [round(t, 6) for t in totals]
            rec["stage_z"] = z
            rec["straggler_stage"] = int(np.argmax(totals))
        return rec


class TimelineWriter:
    """Append-only `timeline.jsonl` sink (process 0). Line-buffered so a
    crashed run's tail is still readable (utils/perf.read_jsonl tolerates a
    torn final line either way)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._f = open(path, "a", buffering=1)

    def write(self, record: dict) -> None:
        try:
            self._f.write(json.dumps(record) + "\n")
        except (OSError, ValueError, TypeError):
            logger.exception("timeline write failed (record dropped)")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class StepTimeline:
    """The trainer's side: installs the collector around every step,
    synchronises the card after the step (the attribute-marks-to-steps
    barrier), writes timeline.jsonl (process 0), and keeps the rolling
    metrics/health summary (`bubble_fraction_measured`,
    `step_time_p50/p95`). `group`: the host group under several
    processes."""

    def __init__(self, pcfg, output_dir: str, write: bool = True,
                 window: int = 64, device: Any = None, group: Any = None):
        plan = None
        try:
            plan = SegmentPlan(pcfg)
        except ValueError as e:
            logger.warning("timeline: %s — recording step walls only", e)
        self.collector = TimelineCollector(plan, device=device, group=group)
        self.device = device
        self.writer = (TimelineWriter(os.path.join(output_dir,
                                                   "timeline.jsonl"))
                       if write else None)
        self._walls: collections.deque = collections.deque(maxlen=window)
        self._bubbles: list[float] = []
        self.last_record: dict | None = None
        self.health_fields: dict = {}

    @property
    def segmented(self) -> bool:
        return self.collector.plan is not None

    def pre_step(self, step: int) -> None:
        install(self.collector)
        self.collector.begin_step(step)

    def post_step(self, step: int, loss) -> dict | None:
        import torch

        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        rec = self.collector.end_step(step)
        if rec is None:  # another process writes the record
            return None
        self._walls.append(rec["wall_s"])
        if rec.get("bubble_fraction_measured") is not None:
            self._bubbles.append(rec["bubble_fraction_measured"])
        self.last_record = rec
        if self.writer is not None:
            self.writer.write(rec)
        self.health_fields.update(self.scalars())
        return rec

    def add_host_segment(self, label: str, dur_s: float) -> None:
        self.collector.add_host_segment(label, dur_s)

    def scalars(self) -> dict:
        """The metrics-line summary — present only once a window exists,
        so downstream joins never see fabricated zeros."""
        out: dict = {}
        if self._walls:
            walls = list(self._walls)
            out["step_time_p50"] = round(float(np.percentile(walls, 50)), 4)
            out["step_time_p95"] = round(float(np.percentile(walls, 95)), 4)
        if self.last_record and "bubble_fraction_measured" in self.last_record:
            out["bubble_fraction_measured"] = \
                self.last_record["bubble_fraction_measured"]
        return out

    def measured_bubble_median(self) -> float | None:
        """Median of the run's measured bubbles (the perf-ledger pairing
        for the analytic bubble_fraction)."""
        return float(np.median(self._bubbles)) if self._bubbles else None

    def close(self) -> None:
        install(None)
        if self.writer is not None:
            self.writer.close()
