"""Memory accounting: the memory observatory.

The counterpart of llama_pipeline_parallel_tpu/utils/memwatch.py, with its
record kinds, file names and forensics contract. Two sources here:

1. **compiled** — the reference records XLA's `memory_analysis()` of each
   jitted program. The port compiles no program, so its counterpart is a
   MEASURED record of the first step under the same record kind: the
   caching allocator's peak is reset before that step
   (`torch.cuda.reset_peak_memory_stats`) and read after it
   (`note_compiled(label, argument_bytes, peak_bytes)`): `argument_bytes` is
   what was allocated when the step began (params, gradients, moments),
   `peak_bytes` the step's peak, `temp_bytes` their difference. The fields
   only XLA has are left out: `output_bytes`, `alias_bytes`,
   `generated_bytes` and the HLO buffer attribution `top_buffers` (the
   `memory.top_buffers` key is accepted and has nothing to rank). On the
   CPU there are no allocator statistics and no such record.
2. **live** — a per-step host-side poll of the card's allocator
   (`torch.cuda.memory_stats`), host RSS, and the host-stash resident
   estimate into an opt-in `memory.jsonl`. The reference's fields read these
   torch keys: `bytes_in_use` <- `allocated_bytes.all.current`,
   `peak_bytes_in_use` <- `allocated_bytes.all.peak`, and
   `largest_alloc_size` <- the largest `active_allocated` block of
   `torch.cuda.memory_snapshot()` (the allocator keeps no running maximum
   of one allocation). OFF is zero overhead: nothing is polled.

Both feed the perf ledger (`mem_peak_gib` model-vs-measured rows) and the
OOM forensics path: `dump_oom_snapshot` writes a bounded snapshot (last
memory rows, the first-step record) to `<output_dir>/oom/` when an
allocation failure surfaces (`torch.cuda.OutOfMemoryError`, or the injected
`oom` fault's RESOURCE_EXHAUSTED error).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any

from llama_pipeline_parallel_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

MEMORY_KEYS = {"enabled", "every", "top_buffers"}

GIB = 1024 ** 3

# Bounded forensics: keep the newest N snapshots, the last M live rows.
OOM_KEEP_SNAPSHOTS = 8
OOM_KEEP_ROWS = 32


@dataclasses.dataclass(frozen=True)
class MemoryConfig:
    """The `memory.*` config block, parsed in one place (unknown keys
    rejected like `timeline.*`)."""

    enabled: bool = False
    every: int = 1  # sample every N steps
    top_buffers: int = 8  # XLA buffer attribution depth: nothing to rank here

    @classmethod
    def from_cfg(cls, node: Any) -> "MemoryConfig":
        node = node or {}
        if not isinstance(node, dict):
            raise ValueError(
                f"memory must be a mapping, e.g. memory: {{enabled: "
                f"true}} — got {node!r}")
        unknown = set(node) - MEMORY_KEYS
        if unknown:
            raise ValueError(f"unknown memory.* key(s) {sorted(unknown)}; "
                             f"known: {sorted(MEMORY_KEYS)}")
        raw = node.get("every", 1)
        every = 1 if raw is None else int(raw)  # `every:` empty = default
        if every < 1:
            raise ValueError(f"memory.every must be >= 1, got {every}")
        raw = node.get("top_buffers", 8)
        top = 8 if raw is None else int(raw)
        if top < 0:
            raise ValueError(f"memory.top_buffers must be >= 0, got {top}")
        return cls(enabled=bool(node.get("enabled", False)), every=every,
                   top_buffers=top)


# -- live telemetry (the one spelling; trace.py delegates here) --------------

def _cuda_device():
    """The card this process allocates on, or None off the card (no CUDA,
    or CUDA never initialised by this process: nothing was allocated)."""
    try:
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            return torch.cuda.current_device()
    except Exception as e:
        logger.debug("cuda device unavailable: %r", e)
    return None


def _host_rss_bytes() -> int:
    import resource

    # linux reports ru_maxrss in KiB
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def device_peak_bytes() -> tuple[int | None, str]:
    """(peak bytes of the card's allocator, source).

    The card reports `allocated_bytes.all.peak`; off the card the process
    peak RSS (ru_maxrss) stands in so the metrics field exists on every
    platform — the source tag keeps the two from being compared against
    each other."""
    device = _cuda_device()
    if device is not None:
        try:
            import torch

            return int(torch.cuda.memory_stats(device)["allocated_bytes.all.peak"]), "device"
        except Exception as e:
            logger.debug("memory_stats unavailable: %r", e)
    try:
        return _host_rss_bytes(), "host_rss"
    except Exception:
        return None, "unavailable"


def _largest_alloc(device) -> int | None:
    import torch

    sizes = [block["size"] for seg in torch.cuda.memory_snapshot()
             if seg.get("device", device) == device for block in seg.get("blocks", ())
             if block.get("state") == "active_allocated"]
    return max(sizes) if sizes else None


def live_sample() -> dict:
    """One host-side poll of every live source: the card's bytes in use,
    peak and largest live allocation, host RSS. Purely observational."""
    out: dict[str, Any] = {}
    device = _cuda_device()
    if device is not None:
        try:
            import torch

            stats = torch.cuda.memory_stats(device)
            out["device_bytes_in_use"] = int(stats["allocated_bytes.all.current"])
            out["device_peak_bytes"] = int(stats["allocated_bytes.all.peak"])
            largest = _largest_alloc(device)
            if largest is not None:
                out["device_largest_alloc"] = int(largest)
        except Exception as e:
            logger.debug("live memory_stats unavailable: %r", e)
    try:
        out["host_rss_bytes"] = _host_rss_bytes()
    except Exception:
        pass
    return out


# -- the run-side watch ------------------------------------------------------

class MemoryWatch:
    """The trainer's side: records the first step's measured peak (one
    shot per label), samples the live sources on a step cadence into
    `memory.jsonl`, keeps a bounded ring of recent rows for OOM snapshots,
    and pairs first-step-vs-live into perf-ledger rows. Host-side
    bookkeeping only: it never changes what the step computes."""

    def __init__(self, output_dir: str, every: int = 1,
                 top_buffers: int = 8, write: bool = True,
                 stash_bytes: int | None = None):
        self.every = max(int(every), 1)
        self.top_buffers = int(top_buffers)
        self.stash_bytes = stash_bytes  # host-stash resident estimate
        self.compiled: dict[str, dict] = {}
        self.path = os.path.join(output_dir, "memory.jsonl")
        self._f = None
        if write:
            try:
                os.makedirs(output_dir or ".", exist_ok=True)
                self._f = open(self.path, "a", buffering=1)
            except OSError:
                logger.exception("memory.jsonl open failed (sampling "
                                 "continues unwritten)")
        self._recent: list[dict] = []  # ring for the OOM snapshot
        self.last_sample: dict | None = None

    def note_compiled(self, label: str, argument_bytes: int, peak_bytes: int) -> dict:
        """Record one step's measured memory (first call per label wins):
        what was allocated at its start, its peak, and the difference as the
        step's temporaries."""
        if label in self.compiled:
            return self.compiled[label]
        rec = self.compiled[label] = {
            "label": label, "argument_bytes": int(argument_bytes),
            "temp_bytes": max(int(peak_bytes) - int(argument_bytes), 0),
            "peak_bytes": int(peak_bytes), "source": "measured"}
        self._write({"kind": "compiled", "time": time.time(), **rec})
        logger.info("first-step memory (%s): peak %.2f GiB (allocated at start %.2f + "
                    "temporaries %.2f)", label, rec["peak_bytes"] / GIB,
                    rec["argument_bytes"] / GIB, rec["temp_bytes"] / GIB)
        return rec

    def sample(self, step: int) -> dict | None:
        """One live poll (respecting the `every` cadence) -> one
        memory.jsonl row. Returns the row (or None when skipped)."""
        if step % self.every != 0:
            return None
        row = {"kind": "sample", "step": int(step), "time": time.time(),
               **live_sample()}
        if self.stash_bytes is not None:
            row["host_stash_bytes"] = int(self.stash_bytes)
        self.last_sample = row
        self._recent.append(row)
        if len(self._recent) > OOM_KEEP_ROWS:
            self._recent = self._recent[-OOM_KEEP_ROWS:]
        self._write(row)
        return row

    def _write(self, rec: dict) -> None:
        if self._f is None:
            return
        try:
            self._f.write(json.dumps(rec) + "\n")
        except (OSError, ValueError, TypeError):
            logger.exception("memory.jsonl write failed (record dropped)")

    def health_gauges(self) -> dict:
        """Live gauges for the metrics line / health.json — present only
        once a sample exists, so downstream joins never see fabricated
        zeros."""
        if not self.last_sample:
            return {}
        out = {}
        for k in ("device_bytes_in_use", "device_peak_bytes",
                  "host_rss_bytes"):
            if self.last_sample.get(k) is not None:
                out[k] = self.last_sample[k]
        return out

    def perf_rows(self, run: str | None = None) -> list[dict]:
        """Perf-ledger pairing: per recorded step a `compiled_peak_gib:<label>`
        row, plus one `mem_peak_gib` row with model = the train step's
        first-step peak, measured = the live device peak."""
        from llama_pipeline_parallel_tpu_torch.utils import perf

        rows: list[dict] = []
        for label, rec in self.compiled.items():
            rows.append(perf.make_row(
                f"compiled_peak_gib:{label}",
                model=round(rec["peak_bytes"] / GIB, 3), measured=None,
                unit="GiB", source="memwatch", run=run,
                temp_gib=round(rec["temp_bytes"] / GIB, 3),
                argument_gib=round(rec["argument_bytes"] / GIB, 3)))
        step_rec = (self.compiled.get("train_step")
                    or next(iter(self.compiled.values()), None))
        live_peak = None
        live_src = None
        if self.last_sample and self.last_sample.get("device_peak_bytes"):
            live_peak = self.last_sample["device_peak_bytes"]
            live_src = "device"
        else:
            b, src = device_peak_bytes()
            if b is not None and src == "device":
                live_peak, live_src = b, src
        if step_rec is not None or live_peak is not None:
            rows.append(perf.make_row(
                "mem_peak_gib",
                model=(round(step_rec["peak_bytes"] / GIB, 3)
                       if step_rec is not None else None),
                measured=(round(live_peak / GIB, 3)
                          if live_peak is not None else None),
                unit="GiB", source="memwatch", run=run,
                measured_source=live_src))
        return rows

    def snapshot(self) -> dict:
        """The bounded forensics payload: recent live rows + every
        first-step record."""
        return {"recent": list(self._recent[-OOM_KEEP_ROWS:]),
                "compiled": dict(self.compiled)}

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


# -- OOM forensics -----------------------------------------------------------

def oom_error(step: int) -> RuntimeError:
    """The injected `oom` fault's error: the allocation-failure marker the
    forensics path recognises, as the reference's chaos op raises it."""
    return RuntimeError(f"RESOURCE_EXHAUSTED: Out of memory while running step {step} "
                        f"(injected oom fault)")


def is_resource_exhausted(exc: BaseException) -> bool:
    """True for an allocation failure: `torch.cuda.OutOfMemoryError`, or an
    error whose type name or message carries RESOURCE_EXHAUSTED / "out of
    memory" (the injected `oom` fault raises a RuntimeError with that
    marker)."""
    try:
        import torch

        if isinstance(exc, torch.cuda.OutOfMemoryError):
            return True
    except Exception:
        pass
    text = f"{type(exc).__name__}: {exc}"
    return ("RESOURCE_EXHAUSTED" in text
            or "out of memory" in text.lower()
            or "ResourceExhausted" in type(exc).__name__)


def oom_dir(output_dir: str) -> str:
    return os.path.join(output_dir, "oom")


def dump_oom_snapshot(output_dir: str, step: int | None,
                      error: BaseException | str,
                      memwatch: "MemoryWatch | None" = None,
                      page_table: dict | None = None,
                      extra: dict | None = None) -> str | None:
    """Write one bounded OOM snapshot to `<output_dir>/oom/` — the last
    live rows, every first-step record, and the page table if a server was
    involved — atomically (tmp + rename) so a watcher never reads a torn
    file; the newest OOM_KEEP_SNAPSHOTS are retained. Swallows its own
    failures: forensics must never turn an OOM abort into a second crash."""
    try:
        d = oom_dir(output_dir)
        os.makedirs(d, exist_ok=True)
        snap: dict[str, Any] = {
            "time": time.time(),
            "step": None if step is None else int(step),
            "error": str(error)[:2000],
            "error_type": (type(error).__name__
                           if isinstance(error, BaseException) else "str"),
            "live": live_sample(),
        }
        if memwatch is not None:
            snap["memwatch"] = memwatch.snapshot()
        if page_table is not None:
            snap["page_table"] = page_table
        if extra:
            snap.update(extra)
        stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime(snap["time"]))
        path = os.path.join(d, f"oom-{stamp}-{os.getpid()}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(snap, f, indent=2, default=str)
        os.replace(tmp, path)
        # retention: newest first, drop the tail
        snaps = sorted((p for p in os.listdir(d)
                        if p.startswith("oom-") and p.endswith(".json")),
                       reverse=True)
        for old in snaps[OOM_KEEP_SNAPSHOTS:]:
            try:
                os.remove(os.path.join(d, old))
            except OSError:
                pass
        logger.error("OOM snapshot written: %s", path)
        return path
    except Exception:
        logger.exception("OOM snapshot failed (forensics dropped)")
        return None


def latest_oom_mtime(output_dir: str) -> float | None:
    """mtime of the newest OOM snapshot, or None — the one spelling the
    supervisor ("crash + fresh snapshot => oom outcome") and the fleet
    alert (`oom_recent`: snapshot newer than the member's registration)
    both compare timestamps against."""
    d = oom_dir(output_dir)
    try:
        times = [os.path.getmtime(os.path.join(d, p))
                 for p in os.listdir(d)
                 if p.startswith("oom-") and p.endswith(".json")]
    except OSError:
        return None
    return max(times) if times else None


def read_oom_snapshots(output_dir: str) -> list[dict]:
    """Every parseable snapshot under `<output_dir>/oom/`, newest first —
    missing dir, torn or garbage files degrade to whatever parses."""
    d = oom_dir(output_dir)
    out: list[dict] = []
    try:
        names = sorted((p for p in os.listdir(d)
                        if p.startswith("oom-") and p.endswith(".json")),
                       reverse=True)
    except OSError:
        return out
    for name in names:
        try:
            with open(os.path.join(d, name)) as f:
                rec = json.load(f)
            if isinstance(rec, dict):
                rec["_file"] = name
                out.append(rec)
        except (OSError, ValueError):
            continue
    return out
