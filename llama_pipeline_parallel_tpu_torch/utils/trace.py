"""Structured span tracing, goodput accounting, and run-health telemetry.

The counterpart of llama_pipeline_parallel_tpu/utils/trace.py (its record
formats, bucket rules and health.json contract, unchanged). Three
cooperating pieces:

- **Spans** (`span`, `SpanRecorder`): context-managed host-time intervals
  written to `<output_dir>/spans.jsonl` by process 0 and mirrored into
  `torch.profiler.record_function`, so the same phase names line up against
  the card's kernels in a torch.profiler capture (`profile_steps` window +
  tools/trace_summary.py). Spans nest (thread-local stack -> `depth`/`parent`
  fields) and are thread-safe: the prefetch producer and the async-checkpoint
  commit thread record alongside the main loop.
- **RunClock**: classifies elapsed wall-clock into buckets
  (init/compile/train/data_stall/ckpt/eval/untracked) by listening to
  top-level main-thread spans, and emits a **goodput** fraction
  (train seconds / total elapsed, cumulative across restarts via the
  `prior=` snapshot).
- **Heartbeat**: a daemon thread that atomically rewrites
  `<output_dir>/health.json` (last step, last-step duration, goodput so far)
  on a fixed cadence, so an external watchdog can tell a hung run from a
  slow one without attaching a debugger.

The module-level recorder is a process-global configured once per run
(`configure(output_dir)`); instrumentation sites (train.train_run,
data.loader.PrefetchIterator, ckpt.checkpoint.CheckpointManager) call
`span(...)` unconditionally: before `configure`, spans still time and
annotate, they just aren't persisted. Plain stdlib apart from the
annotation, so the offline tools import it without a card.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Iterator

from llama_pipeline_parallel_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# span name -> RunClock bucket; spans not listed here (and nested or
# non-main-thread spans) never feed the clock, so bucket seconds are a
# partition of main-thread wall time, not a sum of overlapping intervals.
SPAN_BUCKETS = {
    "init": "init",
    "compile_block": "compile",
    "data_wait": "data_stall",
    "step_dispatch": "train",
    "device_step": "train",
    "eval": "eval",
    "ckpt_save": "ckpt",
    "ckpt_restore": "ckpt",
    # the serving workload's useful-work spans (serve/engine.py): goodput
    # for a serve process is serve seconds / elapsed, same contract as train
    "serve_prefill": "serve",
    "serve_decode_step": "serve",
}

BUCKETS = ("init", "compile", "train", "serve", "data_stall", "ckpt", "eval",
           "untracked")

# buckets that count as goodput: useful work of EITHER workload (a process
# runs one of them, so the sum never double-counts)
GOODPUT_BUCKETS = ("train", "serve")


class SpanRecorder:
    """Span sink: jsonl writer (process 0) + listener fan-out.

    `path=None` (processes other than 0, or pre-configure) records nothing to
    disk but still maintains nesting state and notifies listeners, so the
    RunClock on every process sees identical accounting.
    """

    def __init__(self, path: str | None = None):
        self._path = path
        self._f = open(path, "a", buffering=1) if path else None
        self._lock = threading.Lock()
        self._local = threading.local()
        self._listeners: list[Callable[[dict], None]] = []
        self._main = threading.main_thread()
        self.configured_at = time.time()

    # -- nesting ----------------------------------------------------------

    def _stack(self) -> list:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    def add_listener(self, fn: Callable[[dict], None]) -> None:
        self._listeners.append(fn)

    def remove_listener(self, fn: Callable[[dict], None]) -> None:
        if fn in self._listeners:
            self._listeners.remove(fn)

    # -- recording --------------------------------------------------------

    @contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[dict]:
        """Time a phase; yields the record dict (fields `dur`/`end` are
        filled on exit, so callers may read them after the with-block).
        Mirrored into torch.profiler.record_function so host phases are
        visible on a capture's host track next to the card's kernels."""
        stack = self._stack()
        rec: dict[str, Any] = {
            "name": name,
            "ts": time.time(),
            "depth": len(stack),
            "parent": stack[-1]["name"] if stack else None,
            **attrs,
        }
        stack.append(rec)
        t0 = time.perf_counter()
        annotation = _trace_annotation(name)
        try:
            if annotation is not None:
                with annotation:
                    yield rec
            else:
                yield rec
        finally:
            rec["dur"] = time.perf_counter() - t0
            rec["end"] = rec["ts"] + rec["dur"]
            stack.pop()
            self._emit(rec)

    def emit(self, name: str, ts: float, dur: float, **attrs: Any) -> dict:
        """Retroactive span (e.g. `init`, measured configure->loop-start
        without a with-block around model construction)."""
        rec = {"name": name, "ts": ts, "depth": 0, "parent": None,
               "dur": dur, "end": ts + dur, **attrs}
        self._emit(rec)
        return rec

    def _emit(self, rec: dict) -> None:
        rec["main_thread"] = threading.current_thread() is self._main
        for fn in list(self._listeners):
            try:
                fn(rec)
            except Exception:  # a meter bug must never kill training
                logger.exception("span listener failed on %r", rec.get("name"))
        if self._f is not None:
            line = json.dumps(rec)
            with self._lock:
                self._f.write(line + "\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def _trace_annotation(name: str):
    """torch.profiler.record_function(name), or None when torch is
    unavailable (offline tools importing this module must not require it)."""
    try:
        from torch.profiler import record_function

        return record_function(name)
    except Exception:
        return None


# -- process-global recorder -------------------------------------------------

_RECORDER = SpanRecorder()  # null sink until configure()


def configure(output_dir: str | None, write: bool = True) -> SpanRecorder:
    """Install the run's recorder. `write=False` (processes other than 0)
    keeps accounting live without a second writer of the shared jsonl."""
    global _RECORDER
    _RECORDER.close()
    path = None
    if output_dir is not None and write:
        os.makedirs(output_dir, exist_ok=True)
        path = os.path.join(output_dir, "spans.jsonl")
    _RECORDER = SpanRecorder(path)
    return _RECORDER


def recorder() -> SpanRecorder:
    return _RECORDER


def span(name: str, **attrs: Any):
    """`with trace.span("data_wait"): ...` against the process recorder."""
    return _RECORDER.span(name, **attrs)


# -- goodput accounting ------------------------------------------------------

class RunClock:
    """Wall-clock bucket accounting + goodput.

    Subscribes to a SpanRecorder and adds each **top-level, main-thread**
    span's duration to its SPAN_BUCKETS bucket — nested spans (a prefetch
    stall inside `data_wait`) and background threads (async checkpoint
    commit) are excluded so bucket seconds partition the main thread's wall
    time. `untracked` is the remainder (python overhead between spans).

    `prior=` seeds cumulative buckets/elapsed from a previous incarnation's
    snapshot (health.json carries one), so goodput after a preemption+resume
    reflects the whole run including the lost tail — that lost time shows up
    as a depressed goodput, which is exactly the badput signal.
    """

    def __init__(self, prior: dict | None = None,
                 already_elapsed: float = 0.0):
        """`already_elapsed`: seconds of THIS incarnation that passed before
        the clock existed (the init window) — counted into `elapsed()` so a
        bucket covering that window (`add("init", ...)`) doesn't make
        tracked seconds exceed the denominator."""
        self._t0 = time.perf_counter()
        self._pre = already_elapsed
        self.buckets: dict[str, float] = {b: 0.0 for b in BUCKETS if b != "untracked"}
        self._prior_elapsed = 0.0
        # a half-written prior snapshot (crashed incarnation) degrades to a
        # fresh clock — resilience must not depend on the dead run's tidiness
        if prior and isinstance(prior, dict):
            buckets = prior.get("buckets")
            for k, v in (buckets.items() if isinstance(buckets, dict) else ()):
                if k != "untracked":
                    try:
                        self.buckets[k] = self.buckets.get(k, 0.0) + float(v)
                    except (TypeError, ValueError):
                        pass
            try:
                self._prior_elapsed = float(prior.get("elapsed", 0.0))
            except (TypeError, ValueError):
                pass

    def add(self, bucket: str, seconds: float) -> None:
        self.buckets[bucket] = self.buckets.get(bucket, 0.0) + seconds

    def on_span(self, rec: dict) -> None:
        """SpanRecorder listener: route finished spans into buckets."""
        if rec.get("depth") != 0 or not rec.get("main_thread", True):
            return
        bucket = SPAN_BUCKETS.get(rec["name"])
        if bucket is not None:
            self.add(bucket, rec["dur"])

    def elapsed(self) -> float:
        """Cumulative run seconds, prior incarnations included."""
        return self._prior_elapsed + self._pre + (time.perf_counter() - self._t0)

    def _good_seconds(self) -> float:
        return sum(self.buckets.get(b, 0.0) for b in GOODPUT_BUCKETS)

    def goodput(self) -> float:
        return self._good_seconds() / max(self.elapsed(), 1e-9)

    def snapshot(self) -> dict:
        e = self.elapsed()
        tracked = sum(self.buckets.values())
        out = dict(self.buckets)
        out["untracked"] = max(e - tracked, 0.0)
        # goodput against the SAME elapsed sample as the buckets — a second
        # clock read would make the snapshot internally inconsistent
        return {"elapsed": e,
                "goodput": self._good_seconds() / max(e, 1e-9),
                "buckets": out}


# -- W3C trace context -------------------------------------------------------
#
# The serving tier's per-request identity (serve/reqtrace.py): a request
# either arrives with a `traceparent` header (the caller's distributed
# trace adopts our span tree) or is minted one at submit. Plain python on
# purpose — the frontend parses headers and offline reports join on trace
# ids without torch. Format (https://www.w3.org/TR/trace-context/):
#   00-<32 hex trace-id>-<16 hex parent-span-id>-<2 hex flags>

def mint_trace_id() -> str:
    """32 lowercase hex chars, never all-zero (the spec's invalid value)."""
    while True:
        tid = os.urandom(16).hex()
        if tid != "0" * 32:
            return tid


def mint_span_id() -> str:
    """16 lowercase hex chars, never all-zero."""
    while True:
        sid = os.urandom(8).hex()
        if sid != "0" * 16:
            return sid


def parse_traceparent(header: str | None) -> tuple[str, str] | None:
    """(trace_id, parent_span_id) from a `traceparent` header, or None on
    anything malformed — a bad header degrades to a freshly minted trace,
    never a 400 (tracing must not be able to reject work)."""
    if not isinstance(header, str):
        return None
    parts = header.strip().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id = parts[0], parts[1], parts[2]
    if version == "ff" or len(version) != 2:
        return None
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    # the spec mandates LOWERCASE hex; uppercase is malformed, not lenient
    if any(c not in "0123456789abcdef"
           for c in version + trace_id + span_id):
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


def format_traceparent(trace_id: str, span_id: str,
                       sampled: bool = True) -> str:
    return f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"


# -- device memory telemetry -------------------------------------------------

def device_peak_bytes() -> tuple[int | None, str]:
    """(peak bytes of the card, source) — delegated to utils/memwatch.py,
    the memory observatory's one spelling of the poll (the metrics-line key
    `device_peak_bytes`)."""
    from llama_pipeline_parallel_tpu_torch.utils import memwatch

    return memwatch.device_peak_bytes()


# -- run health --------------------------------------------------------------

class Heartbeat:
    """Atomic `<output_dir>/health.json` rewriter.

    `beat(step, step_dur)` updates in-memory state and (rate-limited) writes;
    a daemon thread also rewrites every `interval` seconds so the file's
    `time` keeps advancing while the main thread is stuck inside a step or
    a collective — the watchdog contract is: `time` stale => process
    dead; `time` fresh but `last_step` stuck long past `last_step_dur` =>
    run hung.

    Writes are tmp-file + os.replace so a watchdog polling the file can
    never read a torn JSON.
    """

    def __init__(self, output_dir: str, clock: RunClock | None = None,
                 interval: float = 10.0, min_write_interval: float = 1.0,
                 extra: dict | None = None, static: dict | None = None,
                 filename: str = "health.json"):
        # `filename`: the supervisor heartbeats the SAME output dir as the
        # child it watches (supervisor_health.json), so watchdog staleness
        # is itself observable without the two writers sharing one file
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, filename)
        self._clock = clock
        self._interval = interval
        self._min_write = min_write_interval
        # identity, not truthiness: the owner may hand over a still-empty
        # LIVE mapping (e.g. the timeline's rolling fields) it fills later
        self._extra = {} if extra is None else extra
        # run constants (e.g. the mesh topology) repeated on every write so
        # an external watchdog can read the incarnation's layout from
        # health.json alone; distinct from `extra`, which is a LIVE dict
        # whose owner mutates it between writes
        self._static = static or {}
        self._lock = threading.Lock()        # guards _state
        self._write_lock = threading.Lock()  # serializes whole-file writes
        self._state: dict[str, Any] = {"pid": os.getpid(), "last_step": None,
                                       "last_step_dur": None}
        self._last_write = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="health-heartbeat")
        self.write()  # the file exists from t0: "no file" means "never started"
        self._thread.start()

    def beat(self, step: int, step_dur: float | None = None) -> None:
        with self._lock:
            self._state["last_step"] = step
            if step_dur is not None:
                self._state["last_step_dur"] = step_dur
        if time.perf_counter() - self._last_write >= self._min_write:
            self.write()

    def write(self) -> None:
        self._last_write = time.perf_counter()
        with self._lock:
            state = dict(self._state)
        state["time"] = time.time()
        state.update(self._static)
        state.update(self._extra)
        if self._clock is not None:
            snap = self._clock.snapshot()
            state["goodput"] = snap["goodput"]
            state["clock"] = snap
        # the daemon's interval write and a main-thread beat() can race; they
        # share one tmp path, so serialize the dump+replace or the published
        # file could interleave two writers' bytes — torn JSON, exactly what
        # the atomic-rewrite contract promises a watchdog can never see
        with self._write_lock:
            tmp = f"{self.path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(state, f, indent=2)
            os.replace(tmp, self.path)

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.write()
            except Exception:  # disk hiccup must not kill the daemon
                logger.exception("heartbeat write failed")

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        self.write()  # final state, incl. the last step's clock snapshot


def load_health(output_dir: str) -> dict | None:
    """Previous incarnation's health.json (RunClock `prior=` seed), or None
    when absent, torn, or not a JSON object — a restart after a crash must
    never die on the dead incarnation's last write."""
    try:
        with open(os.path.join(output_dir, "health.json")) as f:
            health = json.load(f)
    except (OSError, ValueError):
        return None
    return health if isinstance(health, dict) else None
