"""Per-request distributed tracing: the serving tier's flight recorder
(docs/SERVING.md "Request tracing").

The counterpart of llama_pipeline_parallel_tpu/serve/reqtrace.py, copied
line for line over the port's utils/trace.py (tests/test_torch_serving.py
pins the copy's records to the reference's).

`serve/telemetry.py` answers "how is the fleet doing" with windowed
percentiles; this module answers "which request paid the p99 and WHERE" —
every request carries a W3C trace context (`TraceContext`: accepted from an
incoming `traceparent` header by the frontend or minted at submit) and the
engine, when a `RequestTraceRecorder` is attached, assembles one span tree
per request: queue-wait -> admission (with the page-reservation verdict) ->
each prefill chunk -> decode-tick aggregation (first/last tick + a
ticks-shared-with histogram) -> completion/shed/failure, with page-pool
allocation events from `serve/pages.py` attributed to their owning slot.

House rules:

- **Opt-in**: tracing OFF (no recorder) writes no stream and adds no
  per-token cost — the engine's hot paths guard on `reqtrace is None` and
  never build a record (tests pin this structurally). Trace IDS are always
  minted — they cost one `os.urandom` per REQUEST and every HTTP response
  carries one — only the span-tree recording is conditional.
- **ON changes no tokens**: recording is host-side bookkeeping around the
  same device calls; the parity test pins bit-identical tokens against an
  OFF twin.
- **Completion-rate writes**: one `request_trace.jsonl` line per request,
  written when the request ends (completed/shed/failed), never per token.
- **Tail exemplars**: a bounded ring keeps the slowest-K full records by
  TTFT and by TPOT, atomically rewritten to
  `request_trace_exemplars.json` so an operator grabs the current worst
  offenders without scanning the stream; an SLO-breach profiler capture
  records the same trace id in its `capture_meta.json`, so the capture
  and the waterfall name the same request.

`tools/request_report.py` renders waterfalls and the tail-attribution
table offline from these artifacts, degrading on torn/missing files like
every report in the repo.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any

from llama_pipeline_parallel_tpu_torch.utils.logging import get_logger
from llama_pipeline_parallel_tpu_torch.utils.trace import (
    format_traceparent,
    mint_span_id,
    mint_trace_id,
    parse_traceparent,
)

logger = get_logger(__name__)

REQUEST_TRACE_NAME = "request_trace.jsonl"
EXEMPLARS_NAME = "request_trace_exemplars.json"
SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One request's identity in a distributed trace: `trace_id` spans the
    whole caller journey, `span_id` is OUR span within it, `parent_span`
    is the caller's span when a `traceparent` header carried one."""

    trace_id: str
    span_id: str
    parent_span: str | None = None

    @classmethod
    def mint(cls) -> "TraceContext":
        return cls(trace_id=mint_trace_id(), span_id=mint_span_id())

    @classmethod
    def from_traceparent(cls, header: str | None) -> "TraceContext":
        """Adopt the caller's trace when the header parses; mint a fresh
        one otherwise — a malformed header degrades, never rejects."""
        parsed = parse_traceparent(header)
        if parsed is None:
            return cls.mint()
        trace_id, parent_span = parsed
        return cls(trace_id=trace_id, span_id=mint_span_id(),
                   parent_span=parent_span)

    def traceparent(self) -> str:
        """The header value a downstream hop (or the client) would use to
        continue THIS span's trace."""
        return format_traceparent(self.trace_id, self.span_id)


class RequestTraceBuilder:
    """Span-tree accumulator for ONE admitted request. Mutated by the
    engine loop thread; `mark_abandoned` may arrive from a frontend
    thread (a bool flag + timestamp — benign under the GIL, and the
    record is serialized under the recorder's lock)."""

    __slots__ = ("request_id", "trace_id", "span_id", "parent_span",
                 "tenant", "seed", "arrival", "spans", "slot", "bucket",
                 "pages_reserved", "pages_allocated", "first_tick",
                 "last_tick", "ticks", "shared_with", "t_admit", "t_first",
                 "abandoned_at", "prefix_tokens", "prefix_pages",
                 "prefix_cow", "gateway")

    def __init__(self, request) -> None:
        ctx = request.trace
        self.request_id = request.request_id
        self.trace_id = ctx.trace_id if ctx else None
        self.span_id = ctx.span_id if ctx else None
        self.parent_span = ctx.parent_span if ctx else None
        self.tenant = request.tenant
        self.seed = request.seed
        self.arrival = request.arrival
        self.spans: list[dict] = []
        self.slot: int | None = None
        self.bucket: int | None = None
        self.pages_reserved = 0
        self.pages_allocated = 0
        self.first_tick: int | None = None
        self.last_tick: int | None = None
        self.ticks = 0
        self.shared_with: dict[int, int] = {}
        self.t_admit: float | None = None
        self.t_first: float | None = None
        self.abandoned_at: float | None = None
        self.prefix_tokens = 0     # padded-row positions served from cache
        self.prefix_pages = 0      # shared pages mapped at admission
        self.prefix_cow = False    # divergence mid-page: a CoW fork ran
        # gateway dispatch attribution ({"attempt", "replay", "hedge"},
        # serve/gateway.py): present only on routed requests, absent on
        # the direct-to-replica path so those records stay byte-identical
        self.gateway = getattr(request, "gateway", None)

    # -- lifecycle events (engine loop thread) -----------------------------

    def admitted(self, t_admit: float, slot: int, bucket: int,
                 pages_reserved: int) -> None:
        self.t_admit = t_admit
        self.slot = slot
        self.bucket = bucket
        self.pages_reserved = pages_reserved
        self.spans.append({"name": "queue_wait", "ts": self.arrival,
                           "dur": round(t_admit - self.arrival, 6)})
        self.spans.append({"name": "admission", "ts": t_admit, "slot": slot,
                           "bucket": bucket,
                           "pages_reserved": pages_reserved,
                           "verdict": ("reserved" if pages_reserved
                                       else "dense")})

    def prefix_hit(self, tokens: int, pages: int, cow: bool) -> None:
        """Prefix-cache hit at admission: `tokens` padded-row positions
        came from `pages` shared pages (plus a copy-on-write fork when the
        divergence landed mid-page) with ZERO prefill work — the span the
        TTFT decomposition credits to `prefix_cache_hit`."""
        self.prefix_tokens = tokens
        self.prefix_pages = pages
        self.prefix_cow = cow
        self.spans.append({"name": "prefix_cache_hit", "ts": self.t_admit,
                           "tokens": tokens, "pages": pages,
                           "cow": bool(cow)})

    def prefill_chunk(self, ts: float, dur: float, offset: int,
                      tokens: int, tick: int) -> None:
        self.spans.append({"name": "prefill_chunk", "ts": ts,
                           "dur": round(dur, 6), "offset": offset,
                           "tokens": tokens, "tick": tick})

    def first_token(self, t_first: float) -> None:
        self.t_first = t_first
        self.spans.append({"name": "first_token", "ts": t_first})

    def decode_tick(self, tick: int, active: int) -> None:
        """Fold one decode tick: first/last tick indices plus a histogram
        of how many co-active requests shared each tick — the
        co-scheduling signal (a request whose ticks were mostly shared
        with a chunking neighbor decodes slower than one alone)."""
        if self.first_tick is None:
            self.first_tick = tick
        self.last_tick = tick
        self.ticks += 1
        self.shared_with[active] = self.shared_with.get(active, 0) + 1

    def page_alloc(self, tick: int, pages: int) -> None:
        self.pages_allocated += pages
        self.spans.append({"name": "page_alloc", "tick": tick,
                           "pages": pages})

    def mark_abandoned(self, ts: float) -> None:
        """Client hung up mid-stream (frontend OSError path). The engine
        cancels the request at the next step boundary, whose `build`
        carries the `abandoned` outcome and `tokens_discarded`; this stamps
        WHEN the disconnect was observed."""
        self.abandoned_at = ts

    # -- the record --------------------------------------------------------

    def build(self, outcome: str, t_done: float, tokens: int,
              ttft: float | None = None, tpot: float | None = None,
              queue_wait: float | None = None,
              slo_breach: list | None = None,
              capture: str | None = None,
              tokens_discarded: int | None = None) -> dict:
        if self.abandoned_at is not None:
            self.spans.append({"name": "abandoned", "ts": self.abandoned_at})
        prefill_s = round(sum(s["dur"] for s in self.spans
                              if s["name"] == "prefill_chunk"), 6)
        rec: dict[str, Any] = {
            "schema": SCHEMA_VERSION,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span": self.parent_span,
            "request_id": self.request_id,
            "tenant": self.tenant,
            "seed": self.seed,
            "outcome": outcome,
            "arrival": self.arrival,
            "end": t_done,
            "wall_s": round(t_done - self.arrival, 6),
            "tokens": tokens,
            "slot": self.slot,
            "bucket": self.bucket,
            "prefill_s": prefill_s,
            "spans": self.spans,
        }
        if ttft is not None:
            rec["ttft_s"] = round(ttft, 6)
        if tpot is not None:
            rec["tpot_s"] = round(tpot, 6)
        if queue_wait is not None:
            rec["queue_wait_s"] = round(queue_wait, 6)
        if self.pages_reserved:
            rec["pages_reserved"] = self.pages_reserved
        if self.pages_allocated:
            rec["pages_allocated"] = self.pages_allocated
        if self.ticks:
            rec["decode"] = {"first_tick": self.first_tick,
                             "last_tick": self.last_tick,
                             "ticks": self.ticks,
                             "shared_with": {str(k): v for k, v in
                                             sorted(self.shared_with.items())}}
        if self.gateway:
            rec["gateway"] = self.gateway
        if self.prefix_tokens:
            rec["prefix_cached_tokens"] = self.prefix_tokens
            rec["prefix_shared_pages"] = self.prefix_pages
            if self.prefix_cow:
                rec["prefix_cow_fork"] = True
        if self.abandoned_at is not None:
            rec["abandoned"] = True
        if tokens_discarded is not None:
            # cancellation satellite: tokens generated that no client read
            rec["tokens_discarded"] = tokens_discarded
        if slo_breach:
            rec["slo_breach"] = list(slo_breach)
        if capture:
            rec["capture"] = capture
        return rec


class ExemplarRing:
    """Slowest-K ring over one metric: `offer(value, record)` keeps the
    record iff it beats (exceeds) the fastest record currently held once
    the ring is full — the evicted record is always the LEAST slow, so
    the ring converges on the true tail regardless of arrival order."""

    def __init__(self, k: int):
        if k < 1:
            raise ValueError(f"exemplar ring size must be >= 1, got {k}")
        self.k = k
        self._items: list[tuple[float, dict]] = []  # sorted slowest-first

    def offer(self, value: float, record: dict) -> bool:
        if len(self._items) >= self.k and value <= self._items[-1][0]:
            return False
        self._items.append((value, record))
        self._items.sort(key=lambda it: -it[0])
        del self._items[self.k:]
        return True

    def records(self) -> list[dict]:
        """Held records, slowest first."""
        return [rec for _, rec in self._items]


class RequestTraceRecorder:
    """The request-observatory sink: one `request_trace.jsonl` line per
    finished request plus the atomic exemplars snapshot. Thread-safe —
    the engine loop writes completions while frontend threads write shed
    records straight from `submit()` rejections."""

    def __init__(self, output_dir: str, exemplar_k: int = 8,
                 filename: str = REQUEST_TRACE_NAME):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, filename)
        self.exemplars_path = os.path.join(output_dir, EXEMPLARS_NAME)
        self._f = open(self.path, "a", buffering=1)
        self._lock = threading.Lock()
        self._rings = {"ttft": ExemplarRing(exemplar_k),
                       "tpot": ExemplarRing(exemplar_k)}
        self.records_written = 0

    def begin(self, request) -> RequestTraceBuilder:
        return RequestTraceBuilder(request)

    def write(self, rec: dict) -> None:
        line = json.dumps(rec)
        with self._lock:
            if self._f is None:
                return
            self._f.write(line + "\n")
            self.records_written += 1
            updated = False
            for metric, ring in self._rings.items():
                value = rec.get(f"{metric}_s")
                if isinstance(value, (int, float)):
                    updated |= ring.offer(float(value), rec)
            if updated:
                self._write_exemplars()

    def record_shed(self, request, reason: str,
                    retry_after_s: float | None = None) -> None:
        """A rejection IS a trace — the shed request never reaches the
        engine loop, so its whole record is this terminal event."""
        ctx = request.trace
        rec = {"schema": SCHEMA_VERSION,
               "trace_id": ctx.trace_id if ctx else None,
               "span_id": ctx.span_id if ctx else None,
               "request_id": request.request_id,
               "tenant": request.tenant,
               "outcome": "shed",
               "reason": reason,
               "arrival": request.arrival}
        if retry_after_s is not None:
            rec["retry_after_s"] = retry_after_s
        self.write(rec)

    def record_abandoned_late(self, request) -> None:
        """Disconnect observed AFTER the request already completed (its
        full record is on disk): append a terminal `abandoned` marker
        joined by trace id instead of rewriting history."""
        ctx = request.trace
        self.write({"schema": SCHEMA_VERSION,
                    "trace_id": ctx.trace_id if ctx else None,
                    "request_id": request.request_id,
                    "tenant": request.tenant,
                    "outcome": "abandoned",
                    "event": "late_disconnect"})

    def exemplars(self) -> dict:
        with self._lock:
            return {metric: ring.records()
                    for metric, ring in self._rings.items()}

    def _write_exemplars(self) -> None:
        # caller holds the lock; tmp + replace so a reader never sees a
        # torn snapshot (the house atomic-rewrite contract)
        snap = {"schema": SCHEMA_VERSION,
                **{metric: ring.records()
                   for metric, ring in self._rings.items()}}
        tmp = f"{self.exemplars_path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(snap, f)
            os.replace(tmp, self.exemplars_path)
        except OSError:  # a disk hiccup must not kill the serve loop
            logger.exception("exemplar snapshot write failed")

    def close(self) -> None:
        with self._lock:
            if self._f is None:
                return
            self._write_exemplars()
            self._f.close()
            self._f = None
