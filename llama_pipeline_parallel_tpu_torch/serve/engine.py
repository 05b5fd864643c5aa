"""Continuous-batching inference engine (docs/SERVING.md).

The counterpart of llama_pipeline_parallel_tpu/serve/engine.py: the
scheduler is the reference's line for line; the device calls are the
port's decode entry points, on the device the engine owns (`device`,
"cuda" unless the caller asks for the CPU; a missing card is refused).

The admission/batch scheduler over the KV cache — the dense slot manager
(`slots.SlotKVCache`) or the paged pool (`pages.PagedKVCache`, selected by
`ServeConfig.kv_cache`): requests enter a bounded FIFO wait queue
(`submit`, thread-safe — overload raises `ServeOverloaded`; on the paged
cache, a worst-case page demand the pool cannot cover raises
`ServePagesExhausted`, both mapped to HTTP 429 + Retry-After by the
frontend), and at every `step()` boundary the engine

1. **admits** queued requests into free slots — each admission left-pads
   the prompt to the smallest configured bucket, runs `prefill_prompt`
   (its own padded shape per bucket), samples the request's FIRST token
   with its own generator, and splices the row into the long-lived cache —
   prefill-then-join. On the paged cache with `prefill_chunk_tokens` set, a bucket
   larger than the budget instead prefills INCREMENTALLY: at most that
   many prompt tokens per tick (`paged_prefill_chunk`), so in-flight
   decodes keep producing a token every tick — chunked batched prefill,
   no full-prefill stall;
2. runs ONE `decode_step`/`paged_decode_step` over every slot (static
   shape) — per-row write positions, rope positions, generators, and
   sampling knobs, so requests at different depths and with different
   `GenerationConfig`s share the tick;
3. distributes the sampled tokens to their streaming handles and frees the
   slots of finished rows (eos or budget) immediately — pages and
   reservations included — so the next boundary can admit again.

Token parity contract: a request served here emits EXACTLY the tokens of an
independent `generate(params, padded_prompt, cfg, gen,
generator=torch.Generator(device).manual_seed(request.seed))` call (prompt
left-padded to the same bucket): the decode entry points reproduce
generate()'s arithmetic per row at fixed shapes (models/llama/decode.py,
"Row invariance"), and tests/test_torch_serving.py pins it.

Per-request determinism: each request samples from a generator of its own,
seeded from `request.seed` only: admission order, co-tenants, and slot
index cannot perturb a request's tokens.

This module is deliberately host-side and single-stepper: `step()` is
driven either by `ServeLoop` (a background thread for in-process use), by
tools/serve.py's main loop (so serve spans land in the RunClock's `serve`
bucket), or manually by tests.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue as queue_mod
import threading
import time
from collections import deque

import numpy as np
import torch

from llama_pipeline_parallel_tpu_torch.models.llama import decode
from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig
from llama_pipeline_parallel_tpu_torch.models.llama.decode import GenerationConfig
from llama_pipeline_parallel_tpu_torch.serve.pages import PagedKVCache
from llama_pipeline_parallel_tpu_torch.serve.reqtrace import TraceContext
from llama_pipeline_parallel_tpu_torch.serve.slots import SlotKVCache
from llama_pipeline_parallel_tpu_torch.serve.telemetry import SLOStats, retry_after_s
from llama_pipeline_parallel_tpu_torch.utils import trace
from llama_pipeline_parallel_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_REQUEST_IDS = itertools.count()


class ServeOverloaded(RuntimeError):
    """Wait queue full: the backpressure signal (HTTP 429 upstream).
    `retry_after_s` is a coarse retry hint the frontend forwards as the
    Retry-After header."""

    retry_after_s: float = 1.0


class ServePagesExhausted(ServeOverloaded):
    """The free-page pool cannot cover this request's worst-case page
    demand on top of everything already promised: refuse NOW (HTTP 429 +
    Retry-After) instead of admitting and failing mid-decode."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class EngineShutdown(RuntimeError):
    """The engine is shut down: nothing will ever serve this request
    (HTTP 503 upstream — the client must go to another replica)."""


class RequestRejected(ValueError):
    """Request can never be served by this engine's shape budget."""


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine shape/scheduling budget, fixed at construction (the cache is
    allocated once from it)."""

    max_slots: int = 8
    max_len: int = 2048                # per-slot KV capacity (prompt + new)
    prompt_buckets: tuple = (64, 128, 256, 512, 1024)
    max_queue: int = 64                # bounded wait queue (backpressure)
    metrics_every: int = 16            # completions per serving metrics line
    # decode ticks per aggregated serve_decode_step span line: ticks run at
    # token rate (orders of magnitude denser than train steps), so per-tick
    # jsonl lines would grow spans.jsonl without bound on a long-lived
    # replica; durations still accumulate exactly (the RunClock listener
    # sees the aggregate), only the file granularity coarsens
    decode_span_every: int = 32
    # -- paged KV cache (docs/SERVING.md "Paged KV cache") -----------------
    kv_cache: str = "dense"            # "dense" | "paged"
    page_size: int = 64                # tokens per KV page (paged only)
    num_pages: int | None = None       # pool size; None = dense-equivalent
    kv_quant: str = "fp"               # "fp" | "int8" pages (paged only)
    # per-tick prefill token budget AND chunk granularity (paged only):
    # 0 = whole-prompt admissions; > 0 = a bucket larger than this prefills
    # in pieces of exactly this many tokens, interleaved with decode ticks
    prefill_chunk_tokens: int = 0
    # prefix caching (paged only; docs/SERVING.md "Prefix caching"):
    # share physical pages between requests with identical padded prompt
    # prefixes — cache-hit admissions skip the shared span's prefill and
    # reserve only their new pages. Off (the default) keeps the engine
    # byte-identical to the plain paged scheduler.
    prefix_cache: bool = False

    def __post_init__(self) -> None:
        if self.decode_span_every < 1:
            raise ValueError("decode_span_every must be >= 1")
        if not self.prompt_buckets:
            raise ValueError("prompt_buckets must be non-empty")
        if tuple(sorted(self.prompt_buckets)) != tuple(self.prompt_buckets):
            raise ValueError(f"prompt_buckets must be ascending, got "
                             f"{self.prompt_buckets}")
        if min(self.prompt_buckets) < 1:
            raise ValueError("prompt buckets must be >= 1")
        if min(self.prompt_buckets) + 1 > self.max_len:
            raise ValueError(
                f"max_len {self.max_len} cannot hold even the smallest "
                f"bucket {min(self.prompt_buckets)} plus one generated token")
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if self.kv_cache not in ("dense", "paged"):
            raise ValueError(f"kv_cache must be 'dense' or 'paged', got "
                             f"{self.kv_cache!r}")
        if self.kv_cache == "dense":
            if self.kv_quant != "fp":
                raise ValueError("kv_quant requires kv_cache: paged")
            if self.prefill_chunk_tokens:
                raise ValueError("prefill_chunk_tokens requires "
                                 "kv_cache: paged")
            if self.prefix_cache:
                raise ValueError("prefix_cache requires kv_cache: paged")
            return
        if self.kv_quant not in ("fp", "int8"):
            raise ValueError(f"kv_quant must be 'fp' or 'int8', got "
                             f"{self.kv_quant!r}")
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")
        if self.max_len % self.page_size:
            raise ValueError(f"max_len {self.max_len} must be a multiple of "
                             f"page_size {self.page_size}")
        for b in self.prompt_buckets:
            if b % self.page_size:
                raise ValueError(f"prompt bucket {b} must be a multiple of "
                                 f"page_size {self.page_size} (page-aligned "
                                 f"prefill writes)")
        if self.prefill_chunk_tokens:
            if self.prefill_chunk_tokens % self.page_size:
                raise ValueError(
                    f"prefill_chunk_tokens {self.prefill_chunk_tokens} must "
                    f"be a multiple of page_size {self.page_size}")
            for b in self.prompt_buckets:
                if b > self.prefill_chunk_tokens and \
                        b % self.prefill_chunk_tokens:
                    raise ValueError(
                        f"bucket {b} must be a multiple of "
                        f"prefill_chunk_tokens {self.prefill_chunk_tokens} "
                        f"(static chunk shapes)")
        if self.num_pages is not None and \
                self.num_pages < self.max_len // self.page_size:
            raise ValueError(
                f"num_pages {self.num_pages} cannot hold even one "
                f"full-length request "
                f"({self.max_len // self.page_size} pages)")

    @property
    def resolved_num_pages(self) -> int:
        """The pool size: as configured, or the dense-equivalent capacity
        (same logical tokens as the `[max_slots, max_len]` reservation)."""
        if self.num_pages is not None:
            return self.num_pages
        return self.max_slots * self.max_len // self.page_size


@dataclasses.dataclass
class ServeRequest:
    input_ids: list
    gen: GenerationConfig = dataclasses.field(default_factory=GenerationConfig)
    seed: int = 0
    request_id: str = dataclasses.field(
        default_factory=lambda: f"req-{next(_REQUEST_IDS)}")
    arrival: float = dataclasses.field(default_factory=time.time)
    # SLO class for per-tenant attribution (telemetry.SLOStats `tenants`
    # map, fleet rollup, request traces); None = unattributed
    tenant: str | None = None
    # W3C trace context (serve/reqtrace.TraceContext): the frontend parses
    # an incoming `traceparent` header into one; `submit()` mints one when
    # absent, so every submitted request has a trace id whether or not a
    # RequestTraceRecorder is attached
    trace: TraceContext | None = None
    # gateway-tier dispatch attribution (serve/gateway.py): when the
    # request arrived through the routing tier this carries
    # {"attempt": n, "replay": bool, "hedge": bool} — copied verbatim onto
    # the request-trace record so one trace_id joins the gateway journal
    # row to the replica-side attempt that actually served it
    gateway: dict | None = None


class RequestHandle:
    """The caller's end of a submitted request: a streaming token iterator
    plus a blocking result. Thread-safe — the engine loop pushes, frontend
    threads consume."""

    _DONE = object()

    def __init__(self, request: ServeRequest):
        self.request = request
        self.tokens_out: list[int] = []
        self.error: Exception | None = None
        # padded-row positions served from the prefix cache (0 = cold /
        # cache off) — set at submit, read by traffic tooling hit-rate math
        self.prefix_cached_tokens = 0
        self._q: queue_mod.Queue = queue_mod.Queue()
        self._done = threading.Event()

    # -- engine side -------------------------------------------------------

    def _push(self, token: int) -> None:
        self.tokens_out.append(token)
        self._q.put(token)

    def _finish(self, error: Exception | None = None) -> None:
        self.error = error
        self._done.set()
        self._q.put(self._DONE)

    # -- caller side -------------------------------------------------------

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def tokens(self, timeout: float | None = None):
        """Yield tokens as they are generated; raises the request's error
        (if any) after the stream ends. `timeout` bounds the wait for EACH
        token, not the whole stream."""
        while True:
            item = self._q.get(timeout=timeout)
            if item is self._DONE:
                break
            yield item
        if self.error is not None:
            raise self.error

    def result(self, timeout: float | None = None) -> list[int]:
        """All tokens, blocking until the request completes."""
        if not self._done.wait(timeout=timeout):
            raise TimeoutError(
                f"request {self.request.request_id} not done in {timeout}s")
        if self.error is not None:
            raise self.error
        return list(self.tokens_out)


@dataclasses.dataclass
class _Running:
    """Host-side state of one occupied slot."""

    request: ServeRequest
    handle: RequestHandle
    token: int               # last emitted token (the next step's input)
    pos: int                 # its rope position
    write_pos: int           # its cache row
    generator: torch.Generator | None   # the request's own (None: greedy)
    emitted: int
    t_admit: float
    t_first: float


@dataclasses.dataclass
class _Prefilling:
    """Host-side state of a slot whose prompt is still prefilling (paged
    chunked admissions; at most one request is mid-prefill at a time —
    FIFO order makes a second partial pointless)."""

    request: ServeRequest
    handle: RequestHandle
    slot: int
    bucket: int
    ids: np.ndarray          # [1, bucket] left-padded prompt
    mask: np.ndarray         # [1, bucket]
    positions: np.ndarray    # [1, bucket] rope positions
    done: int                # prompt tokens prefilled so far
    t_admit: float
    # prefix cache: the submit-time verdict (None = cache off), and
    # whether positions [0, done) at start came from shared pages — a warm
    # prefill recomputes only its tail via decode.paged_prefill_span
    match: object = None
    warm: bool = False


class ServeEngine:
    def __init__(self, params: dict, cfg: LlamaConfig, serve_cfg: ServeConfig,
                 metrics_writer=None, timeline=None, profiler=None,
                 slo=None, reqtrace=None, *, device: str | torch.device = "cuda"):
        """`params` in the CANONICAL layout, on any device and in any float
        dtype — `ckpt.load_module_checkpoint` hands them out straight from
        any training checkpoint (the train->serve handoff). The engine
        keeps one compute-dtype copy on `device` (decode.compute_params),
        made leaf by leaf, and allocates its cache there; a CUDA device
        without a card is refused.

        Observatory hooks (docs/OBSERVABILITY.md): `timeline` (a
        utils/timeline.TimelineWriter) gets one record per engine tick —
        the prefill-chunk vs decode-step wall split, with the mid-prefill
        request named — the serving counterpart of the trainer's
        per-segment timeline. `slo` (telemetry.SLOThresholds) checks every
        completed request; a breach bumps `slo_breaches` and fires
        `profiler` (utils/profiler.TriggeredProfiler), whose bounded
        capture window advances one tick per `step()`. `reqtrace` (a
        reqtrace.RequestTraceRecorder) turns on the request observatory:
        one span tree per request written to request_trace.jsonl at
        completion (docs/SERVING.md "Request tracing"); None (the
        default) keeps every per-token path free of tracing work."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServeEngine(device='cuda') needs a CUDA device; pass "
                               "device='cpu' to serve on the CPU")
        self.params = decode.compute_params(params, cfg, device=self.device)
        self.cfg = cfg
        self.serve_cfg = serve_cfg
        self._paged = serve_cfg.kv_cache == "paged"
        self._prefix = self._paged and serve_cfg.prefix_cache
        if self._paged:
            self.slots = PagedKVCache(
                cfg, serve_cfg.max_slots, serve_cfg.max_len,
                serve_cfg.page_size, serve_cfg.resolved_num_pages,
                serve_cfg.kv_quant, prefix_cache=serve_cfg.prefix_cache,
                device=self.device)
        else:
            self.slots = SlotKVCache(cfg, serve_cfg.max_slots,
                                     serve_cfg.max_len, device=self.device)
        self.stats = SLOStats()
        self._metrics_writer = metrics_writer
        self._timeline = timeline
        self._profiler = profiler
        self._slo = slo
        self._reqtrace = reqtrace
        # request_id -> in-flight RequestTraceBuilder (loop thread only;
        # empty forever when tracing is OFF — the structural free-ness pin)
        self._rt: dict = {}
        if reqtrace is not None and self._paged:
            # attribute page-pool hand-outs to the owning slot's request
            self.slots.alloc_listener = self._on_page_alloc
        self._last_decode_dur = 0.0
        self._occupants: dict[int, _Running] = {}
        self._prefilling: deque = deque()   # paged chunked admissions
        self._queue: deque = deque()
        # request ids the frontend saw disconnect: cancelled at the next
        # step boundary (queued, prefilling, or decoding alike)
        self._abandoned: set = set()
        self._closed = False
        # degraded-mode admission (docs/RESILIENCE.md "Actuation"): while
        # set (draining for a deploy restart, a mid-resize tier), submits
        # shed coherently — 429 + honest Retry-After — instead of queueing
        # work this process will not live to finish
        self._degraded: str | None = None
        self._lock = threading.Lock()
        self._work = threading.Event()   # ServeLoop parks on this when idle
        self.steps = 0
        self.prefill_chunks_last_tick = 0
        self.prefill_chunks_total = 0
        self.prefill_tokens_total = 0
        # pending aggregated serve_decode_step span (decode_span_every)
        self._tick_ts = 0.0
        self._tick_accum = 0.0
        self._tick_count = 0
        self._tick_active = 0

    # -- submission (any thread) ------------------------------------------

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def _retry_after(self, request: "ServeRequest") -> float:
        """Honest Retry-After (telemetry.retry_after_s): backlog ahead of
        this request / measured drain rate + deterministic per-request
        jitter. Called with the engine lock held — the SLOStats lock is
        leaf-only, so the nesting can never invert."""
        pending = (len(self._queue) + len(self._occupants)
                   + len(self._prefilling))
        return retry_after_s(pending, self.stats.drain_rate(),
                             key=request.request_id)

    def set_degraded(self, reason: str) -> None:
        """Enter degraded-mode admission: every submit sheds with 429 +
        honest Retry-After until cleared. In-flight and already-queued
        requests keep decoding — degraded is about NEW work only."""
        with self._lock:
            self._degraded = reason

    def clear_degraded(self) -> None:
        with self._lock:
            self._degraded = None

    def pick_bucket(self, prompt_len: int, max_new_tokens: int) -> int:
        """Smallest configured bucket holding the prompt whose budget still
        fits the slot capacity; RequestRejected when none can ever."""
        for bucket in self.serve_cfg.prompt_buckets:
            if (bucket >= prompt_len
                    and bucket + max_new_tokens <= self.serve_cfg.max_len):
                return bucket
        raise RequestRejected(
            f"prompt of {prompt_len} tokens + {max_new_tokens} new does not "
            f"fit any bucket {self.serve_cfg.prompt_buckets} within "
            f"max_len {self.serve_cfg.max_len}")

    def submit(self, request: ServeRequest) -> RequestHandle:
        """Enqueue a request; returns its streaming handle. Raises
        `RequestRejected` (unservable shape) or `ServeOverloaded` (wait
        queue full — shed load upstream). Both count as rejections in the
        SLO stats — an operator watching `requests_rejected` must see a
        storm of unservable shapes as clearly as queue overload."""
        if request.trace is None:
            request.trace = TraceContext.mint()
        demand = 0
        try:
            if len(request.input_ids) == 0:
                raise RequestRejected("empty prompt")
            bucket = self.pick_bucket(len(request.input_ids),
                                      request.gen.max_new_tokens)
            if self._paged:
                demand = self.slots.demand_pages(
                    bucket, request.gen.max_new_tokens)
                if demand > self.slots.num_pages:
                    raise RequestRejected(
                        f"worst-case demand of {demand} pages exceeds the "
                        f"pool ({self.slots.num_pages} pages of "
                        f"{self.slots.page_size} tokens)")
        except RequestRejected:
            self.stats.record_rejected(request.tenant)
            self._record_shed(request, "rejected")
            raise
        handle = RequestHandle(request)
        ids_row = mask_row = None
        if self._prefix:
            # padded-row layout is fixed at submit (bucket is), so the
            # block-hash chain can be computed here — identical to what
            # _start_prefill will rebuild
            pad = bucket - len(request.input_ids)
            ids_row = np.zeros(bucket, np.int32)
            ids_row[pad:] = np.asarray(request.input_ids, np.int32)
            mask_row = np.zeros(bucket, np.int32)
            mask_row[pad:] = 1
        with self._lock:
            if self._closed:  # a late submit must fail loudly, never hang
                # drain-time-derived Retry-After, the degraded-429 rule
                # applied to shutdown: a relaunched replica (or a sibling
                # behind the gateway) is up well within the hint, so the
                # 503 tells clients WHEN to come back instead of inviting
                # a hot retry against a dying process
                exc = EngineShutdown("serve engine shut down")
                exc.retry_after_s = self._retry_after(request)
                raise exc
            if self._degraded is not None:
                # shed, don't queue: this process is draining/mid-resize;
                # the honest hint covers the time to finish what it WILL
                # serve (a relaunched replica is up well within it)
                self.stats.record_rejected(request.tenant)
                exc = ServeOverloaded(
                    f"degraded ({self._degraded}) — retry on this or "
                    f"another replica")
                exc.retry_after_s = self._retry_after(request)
                self._record_shed(request, f"degraded:{self._degraded}",
                                  exc.retry_after_s)
                raise exc
            if len(self._queue) >= self.serve_cfg.max_queue:
                self.stats.record_rejected(request.tenant)
                exc = ServeOverloaded(
                    f"wait queue full ({self.serve_cfg.max_queue})")
                # honest backpressure: the measured time for the backlog
                # ahead to drain, not a static hint
                exc.retry_after_s = self._retry_after(request)
                self._record_shed(request, "queue_full", exc.retry_after_s)
                raise exc
            match = None
            if self._prefix:
                # cache-aware admission: shared prefix pages cost 0 new
                # pages, so the worst-case reservation shrinks by the
                # matched chain — a fully cached prompt admits into a pool
                # the cache-off math would have refused
                match = self.slots.match_and_reserve(
                    request.request_id, ids_row, mask_row, demand)
                if match is None:
                    self.stats.record_rejected(request.tenant)
                    self.stats.record_page_refused()
                    retry = self._retry_after(request)
                    self._record_shed(request, "pages_exhausted", retry)
                    raise ServePagesExhausted(
                        f"free-page pool cannot cover this request's "
                        f"worst-case demand even with prefix sharing "
                        f"({self.slots.pages_free} free, "
                        f"{self.slots.pages_reserved}/"
                        f"{self.slots.num_pages} reserved) — retry after a "
                        f"request completes", retry_after_s=retry)
                self.stats.record_prefix(match.tokens, len(match.pages),
                                         match.fork_src is not None)
                handle.prefix_cached_tokens = match.tokens
            elif demand and not self.slots.reserve(demand):
                # refuse NOW: admitting would strand the request mid-decode
                # when the pool runs dry under it
                self.stats.record_rejected(request.tenant)
                self.stats.record_page_refused()
                retry = self._retry_after(request)
                self._record_shed(request, "pages_exhausted", retry)
                raise ServePagesExhausted(
                    f"free-page pool cannot cover the worst-case demand of "
                    f"{demand} pages ({self.slots.pages_free} free, "
                    f"{self.slots.pages_reserved}/{self.slots.num_pages} "
                    f"reserved) — retry after a request completes",
                    retry_after_s=retry)
            self._queue.append((request, handle, demand, match))
        self._work.set()
        return handle

    def _record_shed(self, request: ServeRequest, reason: str,
                     retry_after_s: float | None = None) -> None:
        """A rejection's terminal trace record (request-rate, any thread;
        no-op with tracing OFF)."""
        if self._reqtrace is not None:
            self._reqtrace.record_shed(request, reason, retry_after_s)

    def note_abandoned(self, request: ServeRequest) -> None:
        """The frontend observed a client disconnect mid-stream: bump
        `requests_abandoned`, stamp the trace, and CANCEL the request at
        the next step boundary — queued entries drop their reservation,
        an in-flight slot is freed with its unshared pages released
        (shared prefix pages just drop a refcount) and `tokens_discarded`
        recorded on the abandoned trace event. Best-effort by nature: a
        disconnect racing the final completion write may land as a
        separate late record, and up to one more token can be decoded
        before the boundary."""
        self.stats.record_abandoned(request.tenant)
        with self._lock:
            if not self._closed:
                self._abandoned.add(request.request_id)
        self._work.set()
        if self._reqtrace is None:
            return
        b = self._rt.get(request.request_id)
        if b is not None:
            b.mark_abandoned(time.time())
        else:
            self._reqtrace.record_abandoned_late(request)

    # -- scheduling (the loop thread) -------------------------------------

    def step(self) -> bool:
        """One step boundary: admit (dense, and paged without a chunk
        budget: whole prompts) or advance bounded prefill chunks (paged
        with one), then one decode tick over all slots. Returns False when
        there was nothing to do (caller may sleep)."""
        t0 = time.perf_counter() if self._timeline is not None else 0.0
        self._cancel_abandoned()
        pf_req = (self._prefilling[0].request.request_id
                  if self._prefilling else None)
        self._advance_prefill()
        prefill_s = (time.perf_counter() - t0
                     if self._timeline is not None else 0.0)
        if not self._occupants:
            if self._prefilling:      # prefill-only tick is still work
                self.steps += 1
                self._note_tick(prefill_s, 0.0, pf_req)
                return True
            self._flush_decode_span()  # idle boundary: publish the tail
            self._work.clear()
            # submit() may have raced the clear — don't sleep on a full queue
            if self.queue_depth():
                self._work.set()
            return False
        self._last_decode_dur = 0.0
        self._decode_tick()
        self.steps += 1
        self._note_tick(prefill_s, self._last_decode_dur, pf_req)
        return True

    def _note_tick(self, prefill_s: float, decode_s: float,
                   pf_req: str | None) -> None:
        """One serving timeline record per tick (opt-in): the prefill vs
        decode wall split the SLO percentiles cannot show — a decode tick
        stretched by interleaved prefill chunks is visible here per tick,
        per mid-prefill request. Also advances an attached profiler's
        bounded capture window."""
        if self._profiler is not None:
            self._profiler.observe_step(self.steps)
        if self._timeline is None:
            return
        rec = {"tick": self.steps, "prefill_s": round(prefill_s, 6),
               "decode_s": round(decode_s, 6),
               "active": len(self._occupants),
               "queue_depth": len(self._queue)}
        if self._paged:
            # page-pool occupancy PER TICK: the fragmentation timeline —
            # how the reserved-vs-allocated gap moves as requests admit,
            # decode, and release (the snapshot gauges only show now)
            rec["pages_used"] = self.slots.pages_used
            rec["pages_reserved"] = self.slots.pages_reserved
            rec["fragmentation"] = round(self.slots.fragmentation, 4)
        if self.prefill_chunks_last_tick:
            rec["prefill_chunks"] = self.prefill_chunks_last_tick
        if pf_req is not None:
            rec["prefilling_request"] = pf_req
        self._timeline.write(rec)

    # -- cancellation (loop thread) -----------------------------------------

    def _cancel_abandoned(self) -> None:
        """Cancel every request the frontend flagged abandoned since the
        last boundary: queued entries return their page reservation (and
        release their prefix-match pins), a mid-prefill or decoding slot is
        freed — unshared pages back to the pool, shared prefix pages drop
        one refcount — and the trace ends as `abandoned` with the token
        count the client never consumed. No SLO record: the request has no
        honest completion latency."""
        if not self._abandoned:
            return
        with self._lock:
            doomed = self._abandoned
            self._abandoned = set()
            kept: deque = deque()
            queued = []
            while self._queue:
                entry = self._queue.popleft()
                (queued if entry[0].request_id in doomed
                 else kept).append(entry)
            self._queue = kept
        for request, handle, demand, match in queued:
            if match is not None:
                self.slots.cancel_match(match)
            elif demand:
                self.slots.unreserve(demand)
            self._finish_abandoned(request, handle, discarded=0)
        for pf in [p for p in self._prefilling
                   if p.request.request_id in doomed]:
            self._prefilling.remove(pf)
            if (pf.match is not None and pf.match.fork_src is not None
                    and not pf.match.forked):
                self.slots.unpin_page(pf.match.fork_src)
            self.slots.release(pf.slot)
            self._finish_abandoned(pf.request, pf.handle,
                                   discarded=len(pf.handle.tokens_out))
        for slot, r in [(s, r) for s, r in self._occupants.items()
                        if r.request.request_id in doomed]:
            self._occupants.pop(slot)
            self.slots.release(slot)
            self._finish_abandoned(r.request, r.handle, discarded=r.emitted)

    def _finish_abandoned(self, request: ServeRequest, handle: RequestHandle,
                          discarded: int) -> None:
        if self._reqtrace is not None:
            b = self._rt.pop(request.request_id, None)
            if b is not None:
                self._reqtrace.write(b.build(
                    "abandoned", time.time(), tokens=len(handle.tokens_out),
                    tokens_discarded=discarded))
        handle._finish(None)

    # -- admission: the ONE prefill path for both caches -------------------

    def _advance_prefill(self) -> None:
        """Spend at most `prefill_chunk_tokens` prompt tokens on prefill
        work this tick (unbounded when 0 — the dense cache and chunkless
        paged configs admit whole prompts): continue the in-progress
        chunked prefill first, then admit queued requests into free slots.
        A bucket no larger than the chunk budget prefills in ONE shot (the
        `prefill_prompt` + splice path — identical arithmetic on either
        cache); a larger bucket (paged only) runs in chunk-sized pieces
        across ticks, so in-flight decodes keep producing a token every
        tick — no full-prefill stall."""
        chunk = self.serve_cfg.prefill_chunk_tokens
        spent = 0
        chunks_run = 0
        while True:
            pf = self._prefilling[0] if self._prefilling else None
            if pf is None:
                entry = self._pop_admittable()
                if entry is None:
                    break
                pf = self._start_prefill(*entry)
                if pf is None:     # start failed; its handle already failed
                    continue
                self._prefilling.append(pf)
            if pf.warm:
                # only the tail past the cached prefix costs prefill work;
                # its length is not chunk-aligned, so the last (often only)
                # span is whatever remains
                remaining = pf.bucket - pf.done
                cost = remaining if not chunk else min(chunk, remaining)
            else:
                cost = pf.bucket if not chunk or pf.bucket <= chunk else chunk
            if chunk and spent + cost > chunk:
                break              # budget for this tick is spent
            try:
                finished = self._run_prefill_chunk(pf, cost)
            except Exception as e:
                logger.exception("prefill of %s failed",
                                 pf.request.request_id)
                self.stats.record_failed(pf.request.tenant)
                self._prefilling.remove(pf)
                self.slots.release(pf.slot)
                if self._reqtrace is not None:
                    b = self._rt.pop(pf.request.request_id, None)
                    if b is not None:
                        self._reqtrace.write(b.build(
                            "failed", time.time(),
                            tokens=len(pf.handle.tokens_out)))
                pf.handle._finish(e)
                continue
            spent += cost
            chunks_run += 1
            if finished:
                self._prefilling.remove(pf)
        self.prefill_chunks_last_tick = chunks_run
        if chunks_run:
            self.prefill_chunks_total += chunks_run
            self.prefill_tokens_total += spent

    def _pop_admittable(self):
        with self._lock:
            if not self._queue:
                return None
            request, handle, demand, match = self._queue[0]
            if match is None:   # dense, or paged with the cache off
                slot = self.slots.acquire(request.request_id, demand)
            else:
                slot = self.slots.acquire(request.request_id,
                                          match.new_demand, match=match)
            if slot is None:
                return None
            self._queue.popleft()
        return request, handle, slot, demand, match

    def _start_prefill(self, request: ServeRequest, handle: RequestHandle,
                       slot: int, demand: int,
                       match=None) -> "_Prefilling | None":
        try:
            gen = request.gen
            t_admit = time.time()
            trace.recorder().emit("serve_queue_wait", ts=request.arrival,
                                  dur=t_admit - request.arrival,
                                  request=request.request_id)
            bucket = self.pick_bucket(len(request.input_ids),
                                      gen.max_new_tokens)
            pad = bucket - len(request.input_ids)
            ids = np.zeros((1, bucket), np.int32)
            ids[0, pad:] = np.asarray(request.input_ids, np.int32)
            mask = np.zeros((1, bucket), np.int32)
            mask[0, pad:] = 1
            positions = np.clip(np.cumsum(mask, axis=1) - 1, 0,
                                None).astype(np.int32)
            chunk = self.serve_cfg.prefill_chunk_tokens
            warm = match is not None and match.tokens > 0
            if warm:
                # prefix-cache hit: positions [0, match.tokens) are served
                # by shared pages already mapped into the slot's table row
                # by acquire() — mark them valid (and everything past them
                # dead) in one row rewrite, fork the divergence page
                # copy-on-write when the split lands mid-page, and start
                # the prefill clock at the divergence point
                self.slots.set_mask_row_prefix(slot, mask[0], match.tokens)
                if match.fork_src is not None:
                    self.slots.fork_page(slot, match.fork_src)
                    match.forked = True
                    self.slots.unpin_page(match.fork_src)
            elif self._paged and chunk and bucket > chunk:
                # incremental writes: the previous occupant's mask must die
                self.slots.reset_mask_row(slot)
            if self._reqtrace is not None:
                b = self._reqtrace.begin(request)
                b.admitted(t_admit, slot, bucket,
                           demand if match is None else match.new_demand)
                if warm:
                    b.prefix_hit(match.tokens, len(match.pages),
                                 match.fork_src is not None)
                self._rt[request.request_id] = b
            return _Prefilling(request=request, handle=handle, slot=slot,
                               bucket=bucket, ids=ids, mask=mask,
                               positions=positions,
                               done=match.tokens if warm else 0,
                               t_admit=t_admit, match=match, warm=warm)
        except Exception as e:
            logger.exception("admission of %s failed", request.request_id)
            self.stats.record_failed(request.tenant)
            if (match is not None and match.fork_src is not None
                    and not match.forked):
                self.slots.unpin_page(match.fork_src)
            self.slots.release(slot)
            self._rt.pop(request.request_id, None)
            self._record_shed(request, "admission_failed")
            handle._finish(e)
            return None

    def _run_prefill_chunk(self, pf: _Prefilling, cost: int) -> bool:
        """Run one prefill unit of `cost` tokens for `pf`; on the final
        chunk, sample the request's first token (the same `sample_rowwise`
        program and rng discipline as the dense admission) and join the
        decode batch. Returns True when the request finished prefilling."""
        slot = pf.slot
        offset0 = pf.done
        with trace.span("serve_prefill", request=pf.request.request_id,
                        bucket=pf.bucket, slot=slot, chunk=cost,
                        offset=pf.done) as sp:
            if pf.warm:
                # prefix-cache tail: recompute only [done, done + cost) —
                # start and length are divergence-determined, not
                # page-aligned, so the span kernel scatters per-token into
                # the slot's (possibly just-forked) pages
                c0, c1 = pf.done, pf.done + cost
                self.slots.ensure_capacity(slot, c1)
                out = decode.paged_prefill_span(
                    self.params, pf.ids[:, c0:c1], pf.mask[:, c0:c1],
                    pf.positions[:, c0:c1], self.slots.pool,
                    self.slots.page_table[slot], slot, self.slots.kv_mask,
                    c0, self.cfg)
                self.slots.pool = out["pool"]
                self.slots.kv_mask = out["kv_mask"]
                logits = out["logits"]
                next_pos = int(pf.positions[0, -1]) + 1
                pf.done = c1
            elif cost == pf.bucket:
                # single shot; the prefill logits depend only on the prompt
                # block, so the row capacity (dense: the whole max_len row
                # write_slot splices; paged: the bucket write_pages pages)
                # changes residency, never arithmetic
                row_len = pf.bucket if self._paged else self.serve_cfg.max_len
                out = decode.prefill_prompt(
                    self.params, pf.ids, pf.mask, self.cfg, row_len)
                self.slots.admit(slot, out)
                logits = out["logits"]
                next_pos = int(out["next_pos"][0])
                pf.done = pf.bucket
            else:
                c0, c1 = pf.done, pf.done + cost
                self.slots.ensure_capacity(slot, c1)
                out = decode.paged_prefill_chunk(
                    self.params, pf.ids[:, c0:c1], pf.mask[:, c0:c1],
                    pf.positions[:, c0:c1], self.slots.pool,
                    self.slots.page_table[slot], slot, self.slots.kv_mask,
                    c0, self.cfg)
                self.slots.pool = out["pool"]
                self.slots.kv_mask = out["kv_mask"]
                logits = out["logits"]
                next_pos = int(pf.positions[0, -1]) + 1
                pf.done = c1
            if pf.done >= pf.bucket:
                if self._prefix and pf.match is not None:
                    # index the freshly written prompt pages so later
                    # requests can map them; registered pages survive this
                    # slot's release as cached pages
                    self.slots.register_prefix(slot, pf.match.hashes,
                                               pf.ids[0], pf.mask[0])
                gen = pf.request.gen
                # the request's own generator: the first token's draw,
                # then one a decode tick (greedy requests never draw)
                generator = (torch.Generator(device=self.device).manual_seed(
                    pf.request.seed) if gen.temperature > 0.0 else None)
                first = decode.sample_rowwise(
                    logits, [gen.temperature], [gen.top_k], [gen.top_p],
                    [generator])
                token = int(first[0])

        rt_b = (self._rt.get(pf.request.request_id)
                if self._reqtrace is not None else None)
        if rt_b is not None:
            # the span's own clock readings — chunk timing without a
            # second timer around the device call
            rt_b.prefill_chunk(sp["ts"], sp["dur"], offset0, cost,
                               tick=self.steps)
        if pf.done < pf.bucket:
            return False

        t_first = time.time()
        trace.recorder().emit("serve_ttft", ts=pf.request.arrival,
                              dur=t_first - pf.request.arrival,
                              request=pf.request.request_id)
        if rt_b is not None:
            rt_b.first_token(t_first)
        running = _Running(request=pf.request, handle=pf.handle, token=token,
                           pos=next_pos, write_pos=pf.bucket,
                           generator=generator, emitted=1,
                           t_admit=pf.t_admit, t_first=t_first)
        self._occupants[slot] = running
        pf.handle._push(token)
        if (gen.eos_token_id is not None and token == gen.eos_token_id) \
                or gen.max_new_tokens == 1:
            self._finish(slot, running)  # freed before any decode tick
        return True

    def _decode_tick(self) -> None:
        scfg = self.serve_cfg
        S = scfg.max_slots
        token = np.zeros(S, np.int32)
        pos = np.zeros(S, np.int32)
        write_pos = np.zeros(S, np.int32)
        generators: list = [None] * S
        temps = np.zeros(S, np.float32)
        top_ks = np.zeros(S, np.int32)
        top_ps = np.ones(S, np.float32)
        for slot, r in self._occupants.items():
            token[slot] = r.token
            pos[slot] = r.pos
            write_pos[slot] = r.write_pos
            generators[slot] = r.generator
            temps[slot] = r.request.gen.temperature
            top_ks[slot] = r.request.gen.top_k
            top_ps[slot] = r.request.gen.top_p

        n_active = len(self._occupants)
        t_wall = time.time()
        t0 = time.perf_counter()
        if self._paged:
            # back the next write of every active row BEFORE the tick: the
            # submit-time reservation guarantees these allocations succeed
            for slot, r in self._occupants.items():
                self.slots.ensure_capacity(slot, r.write_pos + 1)
            # only occupant rows may write/mark kv: a mid-prefill slot
            # already owns live pages and mask spans this tick must not touch
            active = np.zeros(scfg.max_slots, np.int32)
            for slot in self._occupants:
                active[slot] = 1
            out = decode.paged_decode_step(
                self.params, token, self.slots.pool, self.slots.page_table,
                pos, write_pos, self.slots.kv_mask, active, generators,
                temps, top_ks, top_ps, self.cfg)
        else:
            out = decode.decode_step(
                self.params, token, self.slots.cache, pos, write_pos,
                self.slots.kv_mask, generators, temps, top_ks, top_ps,
                self.cfg)
        self.slots.update_from_step(out)
        next_token = out["token"].cpu().numpy()    # blocks: real tick time
        self._last_decode_dur = time.perf_counter() - t0
        self._note_decode_tick(t_wall, self._last_decode_dur, n_active)
        if self._reqtrace is not None:
            # tick-rate but bounded by max_slots dict lookups; tracing OFF
            # skips even the branch body (the structural free-ness pin)
            for r in self._occupants.values():
                b = self._rt.get(r.request.request_id)
                if b is not None:
                    b.decode_tick(self.steps, n_active)

        for slot in list(self._occupants):
            r = self._occupants[slot]
            tok = int(next_token[slot])
            r.token = tok
            r.pos += 1
            r.write_pos += 1
            r.emitted += 1
            r.handle._push(tok)
            gen = r.request.gen
            if (gen.eos_token_id is not None and tok == gen.eos_token_id) \
                    or r.emitted >= gen.max_new_tokens:
                self._finish(slot, r)

    def _note_decode_tick(self, ts: float, dur: float, active: int) -> None:
        """Fold one decode tick into the pending aggregated
        `serve_decode_step` span; flush every `decode_span_every` ticks
        (and at idle boundaries / shutdown). The emitted span's `dur` is
        the exact sum of its `ticks` tick durations, so RunClock's `serve`
        bucket and the goodput fraction lose nothing to the aggregation —
        only the spans.jsonl line rate drops from token rate."""
        if self._tick_count == 0:
            self._tick_ts = ts
        self._tick_accum += dur
        self._tick_count += 1
        self._tick_active = active
        if self._tick_count >= self.serve_cfg.decode_span_every:
            self._flush_decode_span()

    def _flush_decode_span(self) -> None:
        if self._tick_count == 0:
            return
        trace.recorder().emit("serve_decode_step", ts=self._tick_ts,
                              dur=self._tick_accum, ticks=self._tick_count,
                              active=self._tick_active)
        self._tick_ts, self._tick_accum = 0.0, 0.0
        self._tick_count, self._tick_active = 0, 0

    def _on_page_alloc(self, slot: int, pages: int) -> None:
        """pages.PagedKVCache alloc_listener (installed only when tracing
        is ON): attribute a page hand-out to the slot's owning request —
        an occupant, or the mid-prefill request still filling the row."""
        r = self._occupants.get(slot)
        request_id = r.request.request_id if r is not None else None
        if request_id is None:
            for pf in self._prefilling:
                if pf.slot == slot:
                    request_id = pf.request.request_id
                    break
        b = self._rt.get(request_id) if request_id is not None else None
        if b is not None:
            b.page_alloc(self.steps, pages)

    def _finish(self, slot: int, r: _Running,
                error: Exception | None = None) -> None:
        t_done = time.time()
        ttft = r.t_first - r.request.arrival
        tpot = ((t_done - r.t_first) / (r.emitted - 1)
                if r.emitted > 1 else None)
        queue_wait = r.t_admit - r.request.arrival
        trace.recorder().emit(
            "serve_request", ts=r.request.arrival,
            dur=t_done - r.request.arrival, request=r.request.request_id,
            tokens=r.emitted, ttft=ttft, tpot=tpot, queue_wait=queue_wait,
            slot=slot)
        self.stats.record(ttft=ttft, tpot=tpot, queue_wait=queue_wait,
                          tokens=r.emitted, tenant=r.request.tenant)
        breaches: list = []
        capture_dir = None
        if self._slo is not None and error is None:
            breaches = self._slo.breaches(ttft, tpot, queue_wait)
            if breaches:
                self.stats.record_slo_breach(r.request.tenant)
                if self._profiler is not None:
                    # bounded capture of the ticks around the breach —
                    # retention-capped, never raises into the loop. The
                    # capture_meta carries the breaching request's trace
                    # id, so the capture and the request-trace waterfall
                    # name the same request.
                    meta = {"request_id": r.request.request_id}
                    if r.request.trace is not None:
                        meta["trace_id"] = r.request.trace.trace_id
                    if r.request.tenant:
                        meta["tenant"] = r.request.tenant
                    if self._profiler.trigger(f"serve_slo_{breaches[0]}",
                                              step=self.steps, meta=meta):
                        capture_dir = self._profiler.last_capture_dir
        if self._reqtrace is not None:
            b = self._rt.pop(r.request.request_id, None)
            if b is not None:
                self._reqtrace.write(b.build(
                    "failed" if error is not None else "completed", t_done,
                    tokens=r.emitted, ttft=ttft, tpot=tpot,
                    queue_wait=queue_wait, slo_breach=breaches or None,
                    capture=capture_dir))
        self._occupants.pop(slot, None)
        self.slots.release(slot)
        r.handle._finish(error)
        if (self._metrics_writer is not None
                and self.stats.completed % self.serve_cfg.metrics_every == 0):
            self._metrics_writer.log(self.stats.completed,
                                     self.metrics_snapshot())

    # -- introspection / teardown -----------------------------------------

    def metrics_snapshot(self) -> dict:
        """The serving metrics line: SLO percentiles + live occupancy."""
        snap = {"serving": 1, **self.stats.snapshot()}
        snap["active_slots"] = self.slots.active_count
        snap["queue_depth"] = self.queue_depth()
        snap["slot_allocations"] = self.slots.allocations
        snap["decode_steps"] = self.steps
        if self._degraded is not None:
            snap["degraded"] = self._degraded
        if self._paged:
            scfg = self.serve_cfg
            snap["kv_cache"] = "paged"
            snap["kv_quant"] = scfg.kv_quant
            snap["page_size"] = scfg.page_size
            snap["pages_total"] = self.slots.num_pages
            snap["pages_used"] = self.slots.pages_used
            snap["pages_free"] = self.slots.pages_free
            snap["pages_reserved"] = self.slots.pages_reserved
            # the reservation-vs-allocation gap: memory promised to worst-case
            # demand that has not materialized as written tokens (pages.py
            # fragmentation docstring) — /healthz serves this verbatim and
            # the fleet aggregates it across pods
            snap["reserved_unbacked"] = self.slots.reserved_unbacked
            snap["page_fragmentation"] = round(self.slots.fragmentation, 4)
            snap["reserved_gap_bytes"] = (self.slots.reserved_unbacked
                                          * self.slots.page_bytes())
            snap["page_allocations"] = self.slots.page_allocations
            snap["prefilling"] = len(self._prefilling)
            snap["prefill_chunks_last_tick"] = self.prefill_chunks_last_tick
            snap["prefill_chunks_total"] = self.prefill_chunks_total
            snap["prefill_tokens_total"] = self.prefill_tokens_total
            if self._prefix:
                # cache-off snapshots stay byte-identical to the plain
                # paged engine — these keys only exist
                # when prefix caching is on
                snap["prefix_cache"] = 1
                snap["pages_cached"] = self.slots.pages_cached
                snap["prefix_cow_forks"] = self.slots.cow_forks
                snap["prefix_evictions"] = self.slots.prefix_evictions
        return snap

    def drain(self, timeout_s: float = 60.0) -> None:
        """Step until queue and slots are empty (tests / synchronous use)."""
        deadline = time.monotonic() + timeout_s
        while self._occupants or self._prefilling or self.queue_depth():
            if time.monotonic() > deadline:
                raise TimeoutError("engine did not drain in time")
            self.step()

    def shutdown(self) -> None:
        """Fail every queued and in-flight request (process exit path);
        later submits raise EngineShutdown instead of queueing into a dead
        engine."""
        self._flush_decode_span()
        if self._profiler is not None:
            self._profiler.close()  # finalize an open capture window
        err = EngineShutdown("serve engine shut down")
        with self._lock:
            self._closed = True
            pending = list(self._queue)
            self._queue.clear()
        for request, handle, demand, match in pending:
            if match is not None:
                self.slots.cancel_match(match)
            elif demand:
                self.slots.unreserve(demand)
            self._record_shed(request, "shutdown")
            handle._finish(err)
        while self._prefilling:
            pf = self._prefilling.popleft()
            if (pf.match is not None and pf.match.fork_src is not None
                    and not pf.match.forked):
                self.slots.unpin_page(pf.match.fork_src)
            self.slots.release(pf.slot)
            self._write_failed_trace(pf.request, len(pf.handle.tokens_out))
            pf.handle._finish(err)
        for slot in list(self._occupants):
            r = self._occupants.pop(slot)
            self.slots.release(slot)
            self._write_failed_trace(r.request, r.emitted)
            r.handle._finish(err)

    def _write_failed_trace(self, request: ServeRequest, tokens: int) -> None:
        """Shutdown path: an in-flight request's trace ends as `failed`."""
        if self._reqtrace is None:
            return
        b = self._rt.pop(request.request_id, None)
        if b is not None:
            self._reqtrace.write(b.build("failed", time.time(),
                                         tokens=tokens))


class ServeLoop:
    """Background driver for in-process use (tests, notebooks): a thread
    calling `engine.step()`, parking on the engine's work event when idle.
    tools/serve.py does NOT use this — its loop runs on the main thread so
    serve spans feed the RunClock buckets."""

    def __init__(self, engine: ServeEngine, idle_wait_s: float = 0.05):
        self.engine = engine
        self._idle_wait = idle_wait_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serve-loop")

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                if not self.engine.step():
                    self.engine._work.wait(self._idle_wait)
            except Exception:
                # decode_step/write_slot update the long-lived cache in
                # place, so a failed step leaves the slot state poisoned — retrying
                # would raise forever while blocked clients hang. Fail every
                # handle (and future submits) instead, like the process
                # loop's exit path does.
                logger.exception("serve loop step failed; shutting the "
                                 "engine down")
                self.engine.shutdown()
                return

    def start(self) -> "ServeLoop":
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 10.0) -> None:
        self._stop.set()
        self.engine._work.set()
        self._thread.join(timeout=timeout_s)
        if self._thread.is_alive():
            # a step (e.g. a long prefill) is still running: shutting
            # the engine down now would free slots and finish handles
            # CONCURRENTLY with that step's own bookkeeping — leave the
            # state alone and let the daemon thread die with the process
            logger.warning("serve loop still inside a step after %.0fs; "
                           "skipping engine shutdown", timeout_s)
            return
        self.engine.shutdown()

    def __enter__(self) -> "ServeLoop":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
