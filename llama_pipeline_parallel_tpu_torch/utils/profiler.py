"""Triggered, bounded torch.profiler capture windows.

The counterpart of llama_pipeline_parallel_tpu/utils/profiler.py (its
`profiler.*` block, triggers, retention cap and capture layout), over
`torch.profiler`: a capture records the host's operators and, on the card,
its CUDA kernels, and is written as a Chrome trace
(`<worker>.<ts>.pt.trace.json`, torch.profiler.tensorboard_trace_handler)
that tools/trace_summary.py reads. The `profile_steps` window profiles a
step range picked BEFORE the run; this layer captures the step you could
not have picked — fired by:

- config (`profiler.at_step: [N, ...]` — capture when the loop reaches N);
- step-time z-score outliers (a rolling window of per-step wall times; a
  step `profiler.zscore` standard deviations above the mean starts a
  capture);
- numerics anomalies (the observatory emits zero-duration
  `numerics_anomaly` spans; `TriggeredProfiler.on_span` subscribes to the
  span stream and converts them into captures);
- an allocation failure (the trainer's OOM handler calls `trigger("oom")`);
- a `capture.trigger` file dropped into this process's output dir (the
  reference's fleet alert surface): `observe_step` polls for it
  (rate-limited by `profiler.trigger_poll_s`), consumes it, and starts a
  capture.

Every capture is a bounded window: `profiler.window_steps` observe() calls
after which the trace stops, written under
`<output_dir>/captures/<time>-step<N>-<reason>/`. `profiler.max_captures`
is the retention cap. A capture never raises into the training loop (a
second profiler session, e.g. the `profile_steps` window, makes a start
fail with a warning), and a window open at loop exit is closed by
`close()`.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import re
import time
from typing import Any

import numpy as np

from llama_pipeline_parallel_tpu_torch.utils.fleet import CAPTURE_TRIGGER_NAME
from llama_pipeline_parallel_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

PROFILER_KEYS = {"at_step", "window_steps", "max_captures", "zscore",
                 "zscore_window", "zscore_min_history", "trigger_poll_s",
                 "on_anomaly"}


@dataclasses.dataclass(frozen=True)
class CaptureConfig:
    """The `profiler.*` config block (unknown keys rejected, the
    `offload.*` house style). `enabled` is implied by the node's presence:
    an empty node arms only the z-score default."""

    at_step: tuple = ()
    window_steps: int = 2       # observe() calls per capture window
    max_captures: int = 3       # retention cap: captures kept on disk
    zscore: float = 4.0         # 0 disables the outlier trigger
    zscore_window: int = 32     # rolling step-time window
    zscore_min_history: int = 8  # steps before the trigger can arm
    trigger_poll_s: float = 1.0  # capture.trigger poll cadence (fleet)
    on_anomaly: bool = True     # numerics_anomaly spans start captures

    @classmethod
    def from_cfg(cls, node: Any) -> "CaptureConfig | None":
        if node is None:
            return None
        if not isinstance(node, dict):
            raise ValueError(
                f"profiler must be a mapping, e.g. profiler: {{at_step: "
                f"[12]}} — got {node!r}")
        unknown = set(node) - PROFILER_KEYS
        if unknown:
            raise ValueError(f"unknown profiler.* key(s) {sorted(unknown)}; "
                             f"known: {sorted(PROFILER_KEYS)}")
        at = node.get("at_step") or ()
        if isinstance(at, (int, float)):
            at = (at,)
        cfg = cls(at_step=tuple(int(s) for s in at),
                  window_steps=int(node.get("window_steps", 2)),
                  max_captures=int(node.get("max_captures", 3)),
                  zscore=float(node.get("zscore", 4.0)),
                  zscore_window=int(node.get("zscore_window", 32)),
                  zscore_min_history=int(node.get("zscore_min_history", 8)),
                  trigger_poll_s=float(node.get("trigger_poll_s", 1.0)),
                  on_anomaly=bool(node.get("on_anomaly", True)))
        if cfg.window_steps < 1:
            raise ValueError("profiler.window_steps must be >= 1")
        if cfg.max_captures < 1:
            raise ValueError("profiler.max_captures must be >= 1")
        if cfg.zscore_min_history < 2:
            raise ValueError("profiler.zscore_min_history must be >= 2")
        return cfg


def _safe_reason(reason: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", reason)[:64] or "capture"


class TriggeredProfiler:
    """Bounded trace-capture state machine (trigger/observe from the loop
    thread, on_span from whatever thread emits spans) — all transitions
    funnel through `_start`/`_stop`, guarded against double starts."""

    def __init__(self, cfg: CaptureConfig, output_dir: str):
        self.cfg = cfg
        self.dir = os.path.join(output_dir, "captures")
        self._walls: collections.deque = collections.deque(
            maxlen=cfg.zscore_window)
        self._active_dir: str | None = None
        self._remaining = 0
        self._pending_at = set(cfg.at_step)
        self.captures_taken = 0
        # fleet cross-process trigger (utils/fleet.py drops the file); the
        # first poll is due immediately — a trigger left while this process
        # was dead must fire on the first post-relaunch step
        self._trigger_path = os.path.join(output_dir, CAPTURE_TRIGGER_NAME)
        self._next_trigger_poll = 0.0
        self._prof = None

    # -- the three trigger surfaces ---------------------------------------

    def observe_step(self, step: int, wall_s: float | None = None) -> None:
        """Advance the capture window by one step; evaluate the at_step and
        step-time z-score triggers. `wall_s=None` (the first step, whose
        kernels build) advances the window without feeding the z-score
        history."""
        was_capturing = self._active_dir is not None
        if was_capturing:
            self._remaining -= 1
            if self._remaining <= 0:
                self._stop()
        self.poll_fleet_trigger(step)
        # at_step semantics are "at or as soon after as possible": a
        # configured step that lands inside an active window (or was
        # skipped while one ran) fires at the first free boundary instead
        # of being silently dropped by an exact-match check
        due = min((s for s in self._pending_at if s <= step), default=None)
        if due is not None and self._active_dir is None:
            self._pending_at.discard(due)
            self.trigger("at_step", step=step)
            return
        if was_capturing or wall_s is None:
            # an in-capture step's wall (the outlier itself) must not
            # poison the rolling baseline
            return
        if (self.cfg.zscore > 0
                and len(self._walls) >= self.cfg.zscore_min_history):
            walls = np.asarray(self._walls, np.float64)
            std = float(walls.std())
            if std > 1e-12:
                z = (wall_s - float(walls.mean())) / std
                if z >= self.cfg.zscore:
                    self.trigger(f"zscore{z:.1f}", step=step)
                    return  # the outlier stays out of the baseline
        self._walls.append(wall_s)

    def poll_fleet_trigger(self, step: int | None = None) -> bool:
        """Consume a fleet-dropped `capture.trigger` in the output dir and
        start a capture for it. Rate-limited (`trigger_poll_s`): steps/
        ticks can run at token rate and a stat per tick would be pure
        overhead. While a capture is already active the file is left in
        place — it fires at the next free boundary instead of vanishing
        into the busy window. Returns True when a capture started."""
        now = time.monotonic()
        if now < self._next_trigger_poll:
            return False
        self._next_trigger_poll = now + max(self.cfg.trigger_poll_s, 0.0)
        if self._active_dir is not None \
                or not os.path.exists(self._trigger_path):
            return False
        try:
            with open(self._trigger_path) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            payload = {}
        reason = str((payload or {}).get("alert") or "fleet")
        # consume BEFORE triggering: a retention-capped drop must not
        # leave the file re-firing every poll forever
        try:
            os.unlink(self._trigger_path)
        except OSError:
            pass
        return self.trigger(f"fleet_{reason}", step=step)

    def on_span(self, rec: dict) -> None:
        """Span-stream listener (utils/trace.SpanRecorder.add_listener):
        the numerics observatory's anomaly spans become captures with no
        coupling between the two modules."""
        if self.cfg.on_anomaly and rec.get("name") == "numerics_anomaly":
            self.trigger("numerics_anomaly", step=rec.get("step"))

    def trigger(self, reason: str, step: int | None = None) -> bool:
        """Start a bounded capture now (any trigger surface). Returns True
        when a capture actually started — False while one is active or the
        retention cap is reached. The reason and step are written as
        `capture_meta.json` inside the capture dir."""
        if self._active_dir is not None:
            return False
        if self.captures_taken >= self.cfg.max_captures:
            logger.info("profiler capture (%s) skipped: retention cap of "
                        "%d captures reached", reason, self.cfg.max_captures)
            return False
        tag = f"step{step}-{_safe_reason(reason)}" if step is not None \
            else _safe_reason(reason)
        path = os.path.join(self.dir, f"{int(time.time())}-{tag}")
        return self._start(path, reason, step=step)

    # -- capture mechanics --------------------------------------------------

    def _start(self, path: str, reason: str, step: int | None = None) -> bool:
        try:
            os.makedirs(path, exist_ok=True)
            self._prof = start_profile(path)
        except Exception as e:
            # an already-running profiler (profile_steps window) must never
            # kill the loop
            logger.warning("profiler capture (%s) could not start: %r",
                           reason, e)
            return False
        self._active_dir = path
        self._remaining = self.cfg.window_steps
        self.captures_taken += 1
        try:
            record = {"reason": reason, "time": time.time()}
            if step is not None:
                record["step"] = step
            with open(os.path.join(path, "capture_meta.json"), "w") as f:
                json.dump(record, f, indent=2)
        except OSError:  # the trace is the payload; meta is best-effort
            logger.exception("capture_meta.json write failed (%s)", path)
        logger.warning("profiler capture started (%s): %s — %d step(s)",
                       reason, path, self.cfg.window_steps)
        return True

    def _stop(self) -> None:
        path, self._active_dir = self._active_dir, None
        prof, self._prof = self._prof, None
        if path is None:
            return
        try:
            prof.stop()
            logger.info("profiler capture written: %s (summarize with "
                        "python -m llama_pipeline_parallel_tpu_torch.tools.trace_summary)",
                        path)
        except Exception:
            logger.exception("profiler capture stop failed (%s)", path)

    @property
    def capturing(self) -> bool:
        return self._active_dir is not None

    def close(self) -> None:
        """Finalize an open window (loop exit on any path)."""
        self._stop()


def start_profile(path: str):
    """A started torch.profiler session over the host and, when the card
    is in use, its CUDA kernels, whose `stop()` writes a Chrome trace under
    `path` (tensorboard_trace_handler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(path))
    prof.start()
    return prof
