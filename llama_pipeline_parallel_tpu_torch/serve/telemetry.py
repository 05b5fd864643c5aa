"""Serving SLO accounting: TTFT / TPOT / queue-wait percentiles.

The counterpart of llama_pipeline_parallel_tpu/serve/telemetry.py, copied
line for line (plain stdlib; tests/test_torch_serving.py pins the copy's
outputs to the reference's).

The serving counterpart of utils/trace's goodput layer. Per-request records
land in TWO streams the repo already owns:

- **spans.jsonl** (utils/trace): the engine emits retroactive spans
  `serve_queue_wait` (arrival -> admission), `serve_ttft` (arrival -> first
  token), and `serve_request` (arrival -> completion, with `ttft`/`tpot`/
  `queue_wait`/`tokens` attrs) per request, plus live `serve_prefill` /
  `serve_decode_step` spans that feed the RunClock's `serve` bucket.
- **metrics.jsonl** (utils/metrics.MetricsWriter): every `metrics_every`
  completions the engine logs one serving line with the rolling percentiles
  this module computes.

Definitions (docs/SERVING.md "SLO metrics"):
- `queue_wait` — request arrival to slot admission (scheduler latency).
- `TTFT` — time to first token: arrival to the prefill-sampled token.
  Includes queue_wait: it is the user-visible first-byte latency.
- `TPOT` — time per output token over the DECODE tail: (completion -
  first token) / (tokens - 1). Undefined for single-token requests.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
import zlib

# the cumulative serving counters every offline report surfaces next to
# the SLO percentiles (requests_* / slo_breaches / tokens_generated) —
# ONE spelling shared by tools/serving_report.py and
# tools/goodput_report.py so the two reports cannot drift
SERVE_COUNTER_KEYS = ("requests_completed", "requests_rejected",
                      "requests_failed", "requests_page_refused",
                      "requests_abandoned", "slo_breaches",
                      "tokens_generated")

# per-tenant percentile window: smaller than the global one — a tenant is
# a slice of the traffic, and the point is CURRENT per-class tail latency
TENANT_WINDOW = 256


@dataclasses.dataclass(frozen=True)
class SLOThresholds:
    """Per-request SLO limits the engine checks at completion time (None =
    unchecked). A breach bumps the `slo_breaches` counter and — when a
    TriggeredProfiler is attached (utils/profiler.py) — fires a bounded
    trace capture of the ticks around the slow request
    (docs/OBSERVABILITY.md "Triggered capture")."""

    ttft_s: float | None = None
    tpot_s: float | None = None
    queue_wait_s: float | None = None

    def breaches(self, ttft: float, tpot: float | None,
                 queue_wait: float) -> list[str]:
        out = []
        if self.ttft_s is not None and ttft > self.ttft_s:
            out.append("ttft")
        if self.tpot_s is not None and tpot is not None and tpot > self.tpot_s:
            out.append("tpot")
        if self.queue_wait_s is not None and queue_wait > self.queue_wait_s:
            out.append("queue_wait")
        return out


# trailing window the admission drain rate is measured over: long enough
# to smooth per-tick burstiness, short enough that Retry-After tracks the
# CURRENT drain, not an idle hour ago
DRAIN_WINDOW_S = 30.0


def retry_after_s(pending: int, drain_rate: float | None, key: str,
                  fallback: float = 1.0, max_s: float = 60.0) -> float:
    """An HONEST Retry-After for a shed request: the measured time for
    the `pending` requests ahead of it to drain at the current completion
    rate, plus deterministic jitter (crc32 of the request key, up to 25%)
    so synchronized clients do not retry in lockstep — same key, same
    hint, across replicas and retries (salted hash() would differ per
    process). Falls back to `fallback` before any completion has been
    measured; clamped to [0.1, max_s]."""
    if drain_rate is not None and drain_rate > 0:
        base = (pending + 1) / drain_rate
    else:
        base = fallback
    base = min(max(base, 0.1), max_s)
    jitter = (zlib.crc32(key.encode()) % 1000) / 1000.0 * 0.25 * base
    return round(min(base + jitter, max_s), 3)


def percentile(values, q: float) -> float | None:
    """Nearest-rank percentile of an unsorted sequence (None when empty).
    Plain python on purpose: offline tools import this without torch/numpy."""
    if not values:
        return None
    ordered = sorted(values)
    rank = max(0, min(len(ordered) - 1,
                      int(round(q / 100.0 * (len(ordered) - 1)))))
    return ordered[rank]


def percentiles_ms(values, prefix: str, qs=(50, 95, 99)) -> dict:
    """{prefix_p50_ms: ..., ...} for the given quantiles; empty input ->
    empty dict (a metrics line must not carry fabricated zeros)."""
    out = {}
    for q in qs:
        p = percentile(values, q)
        if p is not None:
            out[f"{prefix}_p{q}_ms"] = round(1000.0 * p, 3)
    return out


class _TenantStats:
    """One tenant's slice of the accounting: cumulative counters plus a
    bounded percentile window. Mutated only under the owning SLOStats
    lock — no lock of its own."""

    __slots__ = ("completed", "rejected", "failed", "abandoned",
                 "slo_breaches", "tokens_generated", "ttft", "tpot",
                 "queue_wait")

    def __init__(self, window: int = TENANT_WINDOW):
        self.completed = 0
        self.rejected = 0
        self.failed = 0
        self.abandoned = 0
        self.slo_breaches = 0
        self.tokens_generated = 0
        self.ttft = collections.deque(maxlen=window)
        self.tpot = collections.deque(maxlen=window)
        self.queue_wait = collections.deque(maxlen=window)

    def snapshot(self) -> dict:
        out = {"requests_completed": self.completed,
               "requests_rejected": self.rejected,
               "requests_failed": self.failed,
               "requests_abandoned": self.abandoned,
               "slo_breaches": self.slo_breaches,
               "tokens_generated": self.tokens_generated}
        out.update(percentiles_ms(list(self.ttft), "ttft", qs=(50, 95)))
        out.update(percentiles_ms(list(self.tpot), "tpot", qs=(50, 95)))
        out.update(percentiles_ms(list(self.queue_wait), "queue_wait",
                                  qs=(50, 95)))
        return out


class SLOStats:
    """Rolling serving-SLO accumulator (thread-safe: the engine loop records
    while frontend threads snapshot for /healthz).

    Percentiles are over a bounded window of the most recent `window`
    requests — a long-lived serve process must report CURRENT tail latency,
    not its lifetime average — while the counters are cumulative.

    Every record method takes an optional `tenant`: a named tenant gets
    its own `_TenantStats` slice (per-class counters + percentiles under
    the same SERVE_COUNTER_KEYS spellings), surfaced as the `tenants` map
    in `snapshot()` — the scaffolding ROADMAP item 2's per-tenant quotas
    will actuate on. `tenant=None` (the default) changes nothing.
    """

    def __init__(self, window: int = 1024):
        self._lock = threading.Lock()
        self.ttft = collections.deque(maxlen=window)
        self.tpot = collections.deque(maxlen=window)
        self.queue_wait = collections.deque(maxlen=window)
        # completion timestamps (monotonic): the admission drain-rate
        # window behind every honest Retry-After (`retry_after_s`)
        self.finished_at = collections.deque(maxlen=window)
        self.completed = 0
        self.rejected = 0
        self.failed = 0
        self.page_refused = 0
        self.abandoned = 0
        self.slo_breaches = 0
        self.tokens_generated = 0
        # prefix-cache accounting (serve/pages.py "Prefix caching"): all
        # zero — and absent from snapshots — unless the engine records a
        # cache verdict, so cache-off metrics lines stay byte-identical
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_cached_tokens = 0
        self.prefix_shared_pages = 0
        self.prefix_cow_forks = 0
        self._tenants: dict[str, _TenantStats] = {}

    def _tenant(self, tenant: str | None) -> "_TenantStats | None":
        # caller holds the lock
        if not tenant:
            return None
        ts = self._tenants.get(tenant)
        if ts is None:
            ts = self._tenants[tenant] = _TenantStats()
        return ts

    def record(self, ttft: float, tpot: float | None, queue_wait: float,
               tokens: int, tenant: str | None = None) -> None:
        with self._lock:
            self.completed += 1
            self.tokens_generated += tokens
            self.ttft.append(ttft)
            self.queue_wait.append(queue_wait)
            self.finished_at.append(time.monotonic())
            if tpot is not None:
                self.tpot.append(tpot)
            ts = self._tenant(tenant)
            if ts is not None:
                ts.completed += 1
                ts.tokens_generated += tokens
                ts.ttft.append(ttft)
                ts.queue_wait.append(queue_wait)
                if tpot is not None:
                    ts.tpot.append(tpot)

    def record_rejected(self, tenant: str | None = None) -> None:
        with self._lock:
            self.rejected += 1
            ts = self._tenant(tenant)
            if ts is not None:
                ts.rejected += 1

    def drain_rate(self, window_s: float = DRAIN_WINDOW_S,
                   now: float | None = None) -> float | None:
        """Completions/sec over the trailing window (None before any
        completion lands in it — absence of data must not fabricate a
        rate; callers fall back to a static hint)."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            recent = sum(1 for t in self.finished_at if now - t <= window_s)
        return recent / window_s if recent else None

    def record_failed(self, tenant: str | None = None) -> None:
        """Accepted but errored (admission/engine failure, not a client
        mistake): these must move a counter too, or an error storm looks
        like a healthy idle replica."""
        with self._lock:
            self.failed += 1
            ts = self._tenant(tenant)
            if ts is not None:
                ts.failed += 1

    def record_abandoned(self, tenant: str | None = None) -> None:
        """The client hung up mid-stream (frontend OSError path). The
        engine cancels the request at the next step boundary — slot and
        unshared pages freed, `tokens_discarded` on its trace — so this
        counter is the rate of work the fleet started for nobody."""
        with self._lock:
            self.abandoned += 1
            ts = self._tenant(tenant)
            if ts is not None:
                ts.abandoned += 1

    def record_slo_breach(self, tenant: str | None = None) -> None:
        """A completed request blew a configured SLOThresholds limit —
        counted next to the percentiles so an operator sees breach RATE,
        not just the rolling tail."""
        with self._lock:
            self.slo_breaches += 1
            ts = self._tenant(tenant)
            if ts is not None:
                ts.slo_breaches += 1

    def record_prefix(self, cached_tokens: int, shared_pages: int,
                      cow_fork: bool) -> None:
        """One prefix-cache admission verdict (paged cache with
        `prefix_cache` on): a hit served `cached_tokens` padded-row
        positions from `shared_pages` shared pages (plus a copy-on-write
        fork when the divergence landed mid-page); zero cached tokens is
        a miss. Hit RATE — hits/(hits+misses) — is the gauge the fleet
        alerts on."""
        with self._lock:
            if cached_tokens > 0:
                self.prefix_hits += 1
            else:
                self.prefix_misses += 1
            self.prefix_cached_tokens += cached_tokens
            self.prefix_shared_pages += shared_pages
            self.prefix_cow_forks += int(cow_fork)

    def record_page_refused(self) -> None:
        """Rejected because the free-page pool could not cover the
        request's worst-case demand (paged cache only; counted within
        `requests_rejected` too — this breaks out the capacity signal
        an operator scales replicas on)."""
        with self._lock:
            self.page_refused += 1

    def snapshot(self) -> dict:
        """One flat dict: cumulative counters + windowed percentiles, ms."""
        with self._lock:
            out = {
                "requests_completed": self.completed,
                "requests_rejected": self.rejected,
                "requests_failed": self.failed,
                "requests_page_refused": self.page_refused,
                "requests_abandoned": self.abandoned,
                "slo_breaches": self.slo_breaches,
                "tokens_generated": self.tokens_generated,
            }
            out.update(percentiles_ms(list(self.ttft), "ttft"))
            out.update(percentiles_ms(list(self.tpot), "tpot"))
            out.update(percentiles_ms(list(self.queue_wait), "queue_wait"))
            if self.prefix_hits or self.prefix_misses:
                out["prefix_hits"] = self.prefix_hits
                out["prefix_misses"] = self.prefix_misses
                out["prefix_hit_rate"] = round(
                    self.prefix_hits
                    / (self.prefix_hits + self.prefix_misses), 4)
                out["prefix_cached_tokens"] = self.prefix_cached_tokens
                out["prefix_shared_pages"] = self.prefix_shared_pages
                out["prefix_cow_forks"] = self.prefix_cow_forks
            if self._tenants:
                out["tenants"] = {name: ts.snapshot() for name, ts in
                                  sorted(self._tenants.items())}
            return out


# ---------------------------------------------------------------------------
# gateway-tier accounting (serve/gateway.py)
# ---------------------------------------------------------------------------

# cumulative gateway counters, ONE spelling shared by the gateway /healthz
# snapshot, its metrics.jsonl lines, the fleet rollup
# (utils/fleet._GATEWAY_FIELDS) and tools/fleet_report.py — the serving
# SERVE_COUNTER_KEYS rule applied to the routing tier
GATEWAY_COUNTER_KEYS = (
    "requests_routed",       # dispatch attempts sent to replicas (incl.
    #                          replays and hedges)
    "requests_retried",      # attempts re-routed after a 429/503 backoff
    "requests_replayed",     # requests re-submitted after a replica died
    #                          with tokens already delivered (splice path)
    "requests_hedged",       # hedge attempts launched (tail-latency race)
    "hedge_wins",            # requests whose hedge delivered first
    "wasted_hedge_tokens",   # tokens streamed by a losing attempt after
    #                          the winner was chosen (pure overhead gauge)
    "replay_skipped_tokens", # replayed-stream tokens suppressed below the
    #                          delivered watermark (splice verification)
    "requests_completed",
    "requests_failed",       # terminal failure after the retry budget
    "requests_shed",         # no healthy replica / upstream backoff budget
    "requests_rejected",     # replica said 400: deterministic, not retried
    "requests_abandoned",    # client hung up mid-stream
)

# gateway percentile window: the hedge delay is derived from CURRENT tail
# latency, so the window must roll like the per-tenant ones do
GATEWAY_WINDOW = 512


class GatewayStats:
    """Thread-safe gateway-tier accounting: cumulative GATEWAY_COUNTER_KEYS
    counters, a per-replica inflight gauge (the routing tier's own load
    signal — requests IT has outstanding on each replica, distinct from the
    replica's queue depth), and a rolling TTFT window the p95-derived hedge
    delay reads. Mirrors SLOStats' shape so /healthz, metrics.jsonl and the
    fleet rollup consume one snapshot dict."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters = {key: 0 for key in GATEWAY_COUNTER_KEYS}
        self._inflight: dict[str, int] = {}
        self._ttft = collections.deque(maxlen=GATEWAY_WINDOW)

    def bump(self, key: str, n: int = 1) -> None:
        if key not in self._counters:
            raise KeyError(f"unknown gateway counter {key!r} "
                           f"(use one of {GATEWAY_COUNTER_KEYS})")
        with self._lock:
            self._counters[key] += n

    def inflight(self, replica: str, delta: int) -> None:
        with self._lock:
            self._inflight[replica] = self._inflight.get(replica, 0) + delta

    def record_ttft(self, ttft_s: float) -> None:
        with self._lock:
            self._ttft.append(ttft_s)

    def ttft_p95_s(self, min_samples: int = 20) -> float | None:
        """The hedge-delay input: rolling client-visible TTFT p95, None
        until `min_samples` requests have completed — hedging must not
        actuate on a cold, unrepresentative window."""
        with self._lock:
            if len(self._ttft) < min_samples:
                return None
            return percentile(list(self._ttft), 95)

    def snapshot(self) -> dict:
        """One flat dict, `"gateway": 1` marking the stream the way
        serving lines carry `"serving": 1` — the fleet tailer keys its
        rollup branch on it."""
        with self._lock:
            out: dict = {"gateway": 1}
            out.update(self._counters)
            out.update(percentiles_ms(list(self._ttft), "ttft"))
            inflight = {k: v for k, v in sorted(self._inflight.items()) if v}
            out["inflight_total"] = sum(inflight.values())
            if inflight:
                out["inflight"] = inflight
            return out
