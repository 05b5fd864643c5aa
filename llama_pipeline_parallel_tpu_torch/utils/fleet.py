"""Fleet observatory: cross-process aggregation of a supervised pod (the
JAX package's utils/fleet.py, copied; its docs/OBSERVABILITY.md "Fleet").

A run's observability (utils/trace.py spans and goodput, the numerics
observatory, the timeline, perf ledger and triggered capture) lives in
ONE run directory. A pod is many of those at once: a supervised trainer
plus N serve replicas, each with its own supervisor, health.json, and
metrics stream. MPMD pipeline training at scale (PAPERS.md, arxiv
2412.14374) fails in exactly the cross-process seams no single directory
shows: a replica whose heartbeat went stale, a serve tier lagging the
trainer's checkpoints, goodput bleeding away across restarts. This module
is the rollup:

- **Registry contract**: every supervisor launch appends one row to
  `<fleet-root>/registry.jsonl` (`register_member`) — role, replica id,
  output_dir, pid, incarnation, layout. The registry is append-only and
  tolerant-read; the newest row per (output_dir, health_file) wins.
- **Incremental tailing**: `JsonlTailer` (offset-tracking, torn-tail
  carry, `perf.read_jsonl` parse semantics per line) and `FileWatcher`
  (stat-gated whole-file JSON) — a refresh reads only bytes written since
  the previous one, never the whole history. `bytes_read` is the proof a
  test pins.
- **`FleetAggregator`**: discovers members from the registry, tails each
  member's health.json / metrics.jsonl / incarnations.jsonl, scans the
  trainer's checkpoint dir for the latest VERIFIED (complete) step, and
  composes one atomic `<fleet-root>/fleet_status.json` — per-member
  heartbeat staleness, trainer step/goodput/step-time percentiles/bubble
  measured-vs-analytic, per-replica TTFT/TPOT/queue-wait/page-pool/
  `slo_breaches`, checkpoint lag, numerics anomaly counts, and pod-level
  goodput across incarnations.
- **Alert rules** (`AlertRules`, the `alerts.*` block): evaluated per
  refresh; state TRANSITIONS (firing/resolved edges, never level spam)
  append to `<fleet-root>/alerts.jsonl`, and a firing edge drops a
  `capture.trigger` file into the member's output dir — the member's
  TriggeredProfiler (utils/profiler.py) polls for it, so a fleet-level
  symptom produces a bounded process-level trace.

Plain stdlib on purpose: tools.fleetd and tools.fleet_report import it
without torch.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time
from typing import Any

from llama_pipeline_parallel_tpu_torch.utils import memwatch
from llama_pipeline_parallel_tpu_torch.utils.logging import get_logger
from llama_pipeline_parallel_tpu_torch.utils.perf import read_jsonl

logger = get_logger(__name__)

REGISTRY_NAME = "registry.jsonl"
STATUS_NAME = "fleet_status.json"
ALERTS_NAME = "alerts.jsonl"
# dropped into a MEMBER's output dir by a firing alert; consumed by the
# member's TriggeredProfiler (utils/profiler.py imports this spelling)
CAPTURE_TRIGGER_NAME = "capture.trigger"
HEALTH_NAME = "health.json"
SUPERVISOR_HEALTH_NAME = "supervisor_health.json"

_CKPT_RE = re.compile(r"^checkpoint-(\d+)$")


def _num(x) -> float | None:
    try:
        v = float(x)
    except (TypeError, ValueError):
        return None
    return v if v == v else None


def write_json_atomic(path: str, payload: dict) -> None:
    """tmp + os.replace: a polling reader (GET /fleet, a shell `cat`) can
    never see a torn fleet_status.json — the same contract health.json and
    serve.json already keep."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=False)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# registry contract
# ---------------------------------------------------------------------------

def register_member(fleet_root: str, *, output_dir: str,
                    role: str | None = None, replica: str | None = None,
                    pid: int | None = None, incarnation: int | None = None,
                    health_file: str = HEALTH_NAME,
                    **extra: Any) -> dict:
    """Append one member row to `<fleet-root>/registry.jsonl`. One line per
    LAUNCH (a restarted child re-registers with its new pid/incarnation);
    single-line O_APPEND writes keep concurrent supervisors from tearing
    each other's rows. Returns the row written."""
    os.makedirs(fleet_root, exist_ok=True)
    row = {"ts": time.time(),
           "role": role,
           "replica": replica or os.path.basename(os.path.normpath(output_dir)),
           "output_dir": os.path.abspath(output_dir),
           "pid": pid,
           "incarnation": incarnation,
           "health_file": health_file}
    row.update(extra)
    with open(os.path.join(fleet_root, REGISTRY_NAME), "a") as f:
        f.write(json.dumps(row) + "\n")
    return row


def load_registry(fleet_root: str) -> list[dict]:
    """Every parseable registry row (torn tail skipped — the tolerant
    reader's semantics, `perf.read_jsonl`)."""
    return read_jsonl(os.path.join(fleet_root, REGISTRY_NAME),
                      keep=lambda r: "output_dir" in r)


# ---------------------------------------------------------------------------
# incremental readers
# ---------------------------------------------------------------------------

class JsonlTailer:
    """Offset-tracking jsonl tailer: each `poll()` reads only the bytes
    appended since the previous poll, carrying a torn (newline-less) tail
    until its writer finishes the line — the incremental form of
    `perf.read_jsonl`'s skip-what-doesn't-parse rule. A file that SHRANK
    (rotation, a fresh incarnation truncating) resets to offset 0.
    `bytes_read` counts every byte ever read — the no-full-re-read proof
    tests pin."""

    def __init__(self, path: str, max_poll_bytes: int = 8 << 20):
        self.path = path
        self.offset = 0
        self.bytes_read = 0
        self._carry = b""
        self._max_poll = max_poll_bytes

    def poll(self) -> list[dict]:
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return []
        if size < self.offset:
            # truncated/rotated under us: start over, drop the stale carry
            self.offset, self._carry = 0, b""
        if size == self.offset:
            return []
        try:
            with open(self.path, "rb") as f:
                f.seek(self.offset)
                chunk = f.read(min(size - self.offset, self._max_poll))
        except OSError:
            return []
        self.offset += len(chunk)
        self.bytes_read += len(chunk)
        data = self._carry + chunk
        lines = data.split(b"\n")
        self._carry = lines.pop()  # b"" after a complete line; else the tear
        rows = []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except ValueError:
                continue
            if isinstance(row, dict):
                rows.append(row)
        return rows


class FileWatcher:
    """Stat-gated whole-file JSON reader for atomically-rewritten files
    (health.json): re-reads only when (mtime_ns, size) changed, so a
    refresh against an idle member costs one stat, zero reads. `.data` is
    the last successfully parsed dict (a torn/garbage rewrite keeps the
    previous good value, status `corrupt`)."""

    def __init__(self, path: str):
        self.path = path
        self.data: dict | None = None
        self.status = "missing"
        self.bytes_read = 0
        self._sig: tuple | None = None

    def poll(self) -> dict | None:
        try:
            st = os.stat(self.path)
        except OSError:
            self.status = "missing" if self.data is None else "gone"
            return self.data
        sig = (st.st_mtime_ns, st.st_size)
        if sig == self._sig:
            return self.data
        self._sig = sig
        try:
            with open(self.path) as f:
                raw = f.read()
            self.bytes_read += len(raw)
            parsed = json.loads(raw)
        except (OSError, ValueError):
            self.status = "corrupt"
            return self.data
        if isinstance(parsed, dict):
            self.data, self.status = parsed, "ok"
        else:
            self.status = "corrupt"
        return self.data


def latest_verified_step(checkpoint_root: str) -> int | None:
    """The newest COMPLETE checkpoint step under a trainer's output dir —
    complete means meta.json landed (the commit barrier: digests are
    recorded there, and restore verifies them), the same rule
    CheckpointManager.latest_step applies, re-spelled here without torch so
    the aggregator can poll it. Returns None for no-checkpoints-yet."""
    try:
        names = os.listdir(checkpoint_root)
    except OSError:
        return None
    steps = []
    for name in names:
        m = _CKPT_RE.match(name)
        if m and os.path.exists(os.path.join(checkpoint_root, name,
                                             "meta.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


# ---------------------------------------------------------------------------
# alert rules (the `alerts.*` block)
# ---------------------------------------------------------------------------

ALERT_KEYS = {"heartbeat_stale_s", "goodput_floor", "step_time_p95_s",
              "ttft_p95_ms", "queue_wait_p95_ms", "tenant_ttft_p95_ms",
              "prefix_hit_rate_floor", "checkpoint_lag_steps",
              "nonfinite_steps", "oom_recent"}
# config key -> the rule name edges/status use (the `_s`/`_ms` unit
# suffixes are config spelling, not alert identity)
_RULE_NAMES = {"heartbeat_stale_s": "heartbeat_stale",
               "goodput_floor": "goodput_floor",
               "step_time_p95_s": "step_time_p95",
               "ttft_p95_ms": "ttft_p95",
               "queue_wait_p95_ms": "queue_wait_p95",
               "tenant_ttft_p95_ms": "tenant_ttft_p95",
               "prefix_hit_rate_floor": "prefix_hit_rate",
               "checkpoint_lag_steps": "checkpoint_lag",
               "nonfinite_steps": "nonfinite_steps",
               "oom_recent": "oom_recent"}
_INT_ALERT_KEYS = ("checkpoint_lag_steps", "nonfinite_steps", "oom_recent")
# the dict spelling of one rule: {"threshold": 500, "for_s": 10,
# "cooldown_s": 30} — flap damping without a second config surface
_ALERT_VALUE_KEYS = {"threshold", "for_s", "cooldown_s"}


@dataclasses.dataclass(frozen=True)
class AlertRules:
    """Declarative fleet alert thresholds (unknown keys rejected, the
    `offload.*` house style). None disables a rule. Each value is either
    a bare threshold or `{"threshold": x, "for_s": y, "cooldown_s": z}` —
    `for_s` requires the raw condition to hold continuously that long
    before the alert FIRES (flap damping), and `cooldown_s` suppresses
    re-firing for that long after a resolve (thrash damping). Both
    default to 0, which is bit-identical to the undamped behavior.
    Semantics:

    - heartbeat_stale_s: member heartbeat age (vouched by its latest
      registry row, the supervisor's own staleness rule) above this
      fires. A member whose latest registry row is TERMINAL (the
      supervisor wrote `outcome=aborted` on giving up) fires immediately
      — a dead pod must not look healthy for the staleness window.
    - goodput_floor: a trainer/serve member's cumulative goodput BELOW
      this fires.
    - step_time_p95_s: the trainer's rolling step-time p95 above this.
    - ttft_p95_ms: a serve replica's rolling TTFT p95 above this.
    - queue_wait_p95_ms: a serve replica's rolling queue-wait p95 above
      this (admission latency — the autoscaler's primary borrow signal).
    - tenant_ttft_p95_ms: ONE threshold evaluated per tenant in a serve
      replica's `tenants` map (serve/telemetry.py per-tenant slices);
      each tenant gets its own rule instance named
      `tenant_ttft_p95:<tenant>` — independent fire/resolve edges and
      damping state per tenant, the scaffolding per-tenant SLO classes
      will actuate on.
    - prefix_hit_rate_floor: a prefix-caching serve replica's cumulative
      hit rate (prefix_hits / (prefix_hits + prefix_misses), the
      `prefix_hit_rate` metrics field) BELOW this fires — a cache that
      stopped hitting on a shared-prefix workload means the eviction
      churn or the traffic mix changed under the replica. Only evaluated
      when the replica reports the field (prefix cache on, some traffic
      admitted or refused).
    - checkpoint_lag_steps: serve replica's loaded checkpoint step more
      than this many steps behind the trainer's latest verified one.
    - nonfinite_steps: more than this many nonfinite training steps
      (0 = any nonfinite step alerts).
    - oom_recent: fires while a member's newest `oom/` snapshot
      (utils/memwatch.py forensics) postdates its latest registration —
      memory pressure killed THIS incarnation. Threshold 0 = any recent
      OOM alerts; the rule resolves deterministically when the
      supervisor's relaunch re-registers the member (newer `ts` than
      the snapshot).
    """

    heartbeat_stale_s: float | None = None
    goodput_floor: float | None = None
    step_time_p95_s: float | None = None
    ttft_p95_ms: float | None = None
    queue_wait_p95_ms: float | None = None
    tenant_ttft_p95_ms: float | None = None
    prefix_hit_rate_floor: float | None = None
    checkpoint_lag_steps: int | None = None
    nonfinite_steps: int | None = None
    oom_recent: int | None = None
    # rule name -> (for_s, cooldown_s); absent = (0, 0)
    damping: Any = None

    @classmethod
    def from_cfg(cls, node: Any) -> "AlertRules":
        node = node or {}
        if not isinstance(node, dict):
            raise ValueError(f"alerts must be a mapping, e.g. alerts: "
                             f"{{heartbeat_stale_s: 30}} — got {node!r}")
        unknown = set(node) - ALERT_KEYS
        if unknown:
            raise ValueError(f"unknown alerts.* key(s) {sorted(unknown)}; "
                             f"known: {sorted(ALERT_KEYS)}")
        kw: dict[str, Any] = {}
        damping: dict[str, tuple] = {}
        for key in ALERT_KEYS:
            raw = node.get(key)
            if raw is None:
                continue
            if isinstance(raw, dict):
                bad = set(raw) - _ALERT_VALUE_KEYS
                if bad:
                    raise ValueError(
                        f"unknown alerts.{key} key(s) {sorted(bad)}; "
                        f"known: {sorted(_ALERT_VALUE_KEYS)}")
                if raw.get("threshold") is None:
                    raise ValueError(f"alerts.{key} needs a 'threshold' "
                                     f"when spelled as a mapping")
                threshold = raw["threshold"]
                for_s = float(raw.get("for_s", 0.0) or 0.0)
                cooldown_s = float(raw.get("cooldown_s", 0.0) or 0.0)
                if for_s < 0 or cooldown_s < 0:
                    raise ValueError(f"alerts.{key}: for_s/cooldown_s "
                                     f"must be >= 0")
                if for_s or cooldown_s:
                    damping[_RULE_NAMES[key]] = (for_s, cooldown_s)
            else:
                threshold = raw
            kw[key] = (int(threshold) if key in _INT_ALERT_KEYS
                       else float(threshold))
        if damping:
            kw["damping"] = damping
        return cls(**kw)

    def damping_for(self, rule: str) -> tuple:
        """(for_s, cooldown_s) for one rule name; (0, 0) when undamped.
        Per-tenant rule instances (`tenant_ttft_p95:<tenant>`) inherit
        the base rule's damping — the `:` suffix is instance identity,
        not a second config surface."""
        base = rule.split(":", 1)[0]
        return (self.damping or {}).get(base, (0.0, 0.0))

    def evaluate(self, member: dict) -> list[tuple[str, float, float, bool]]:
        """(rule, value, threshold, firing) for every rule whose input
        exists on this member's status — a rule with no observable value
        is NOT evaluated (its prior state persists; absence of data must
        not fabricate a resolution)."""
        out = []
        role = member.get("role")

        def rule(name, value, threshold, firing):
            if value is not None and threshold is not None:
                out.append((name, value, threshold, bool(firing)))

        age = _num(member.get("heartbeat_age_s"))
        # a terminal registration row (supervisor gave up: crash loop,
        # exhausted budget, no rung) is an explicit death notice — stale
        # NOW, not after the staleness window elapses past the abort
        terminal = member.get("terminal_outcome") is not None
        rule("heartbeat_stale", age, self.heartbeat_stale_s,
             age is not None and self.heartbeat_stale_s is not None
             and (terminal or age > self.heartbeat_stale_s))
        if role != "supervisor":
            gp = _num(member.get("goodput"))
            rule("goodput_floor", gp, self.goodput_floor,
                 gp is not None and self.goodput_floor is not None
                 and gp < self.goodput_floor)
        p95 = _num(member.get("step_time_p95"))
        rule("step_time_p95", p95, self.step_time_p95_s,
             p95 is not None and self.step_time_p95_s is not None
             and p95 > self.step_time_p95_s)
        ttft = _num(member.get("ttft_p95_ms"))
        rule("ttft_p95", ttft, self.ttft_p95_ms,
             ttft is not None and self.ttft_p95_ms is not None
             and ttft > self.ttft_p95_ms)
        qw = _num(member.get("queue_wait_p95_ms"))
        rule("queue_wait_p95", qw, self.queue_wait_p95_ms,
             qw is not None and self.queue_wait_p95_ms is not None
             and qw > self.queue_wait_p95_ms)
        # ONE configured threshold, one rule INSTANCE per tenant: each
        # tenant's edge/damping state is independent (a paid-tier breach
        # must not be masked by a healthy free tier resolving)
        tenants = member.get("tenants")
        if isinstance(tenants, dict) and self.tenant_ttft_p95_ms is not None:
            for name in sorted(tenants):
                snap = tenants[name]
                if not isinstance(snap, dict):
                    continue
                tt = _num(snap.get("ttft_p95_ms"))
                rule(f"tenant_ttft_p95:{name}", tt, self.tenant_ttft_p95_ms,
                     tt is not None and tt > self.tenant_ttft_p95_ms)
        # floor rule, like goodput_floor: fires when the value drops BELOW
        # the threshold; absent field (cache off / no traffic yet) is not
        # evaluated — absence of data must not fabricate a firing
        phr = _num(member.get("prefix_hit_rate"))
        rule("prefix_hit_rate", phr, self.prefix_hit_rate_floor,
             phr is not None and self.prefix_hit_rate_floor is not None
             and phr < self.prefix_hit_rate_floor)
        lag = _num(member.get("checkpoint_lag"))
        rule("checkpoint_lag", lag, self.checkpoint_lag_steps,
             lag is not None and self.checkpoint_lag_steps is not None
             and lag > self.checkpoint_lag_steps)
        nf = _num(member.get("nonfinite_steps"))
        rule("nonfinite_steps", nf, self.nonfinite_steps,
             nf is not None and self.nonfinite_steps is not None
             and nf > self.nonfinite_steps)
        oom = _num(member.get("oom_recent"))
        rule("oom_recent", oom, self.oom_recent,
             oom is not None and self.oom_recent is not None
             and oom > self.oom_recent)
        return out


# ---------------------------------------------------------------------------
# per-member tail state
# ---------------------------------------------------------------------------

# trainer metrics-line fields the rollup keeps (last value wins)
_TRAIN_FIELDS = ("loss", "goodput", "bubble_fraction",
                 "bubble_fraction_measured", "step_time", "step_time_p50",
                 "step_time_p95", "nonfinite_steps", "anomaly_count", "mfu",
                 "tokens_per_sec")
# serving metrics-line fields the rollup keeps
_SERVE_FIELDS = ("requests_completed", "requests_rejected", "requests_failed",
                 "requests_page_refused", "slo_breaches", "tokens_generated",
                 "ttft_p50_ms", "ttft_p95_ms", "ttft_p99_ms", "tpot_p50_ms",
                 "tpot_p95_ms", "queue_wait_p50_ms", "queue_wait_p95_ms",
                 "active_slots", "queue_depth", "pages_used", "pages_free",
                 "pages_reserved", "pages_total", "reserved_unbacked",
                 "page_fragmentation", "reserved_gap_bytes",
                 "page_allocations", "prefilling", "prefill_chunks_total",
                 "prefill_tokens_total", "requests_abandoned", "tenants",
                 "prefix_cache", "prefix_hits", "prefix_misses",
                 "prefix_hit_rate", "prefix_cached_tokens",
                 "prefix_shared_pages", "prefix_cow_forks", "pages_cached",
                 "prefix_evictions")
# gateway metrics-line fields the rollup keeps (serve/gateway.py marks its
# lines `"gateway": 1` the way replicas mark theirs `"serving": 1`)
_GATEWAY_FIELDS = ("requests_routed", "requests_retried", "requests_replayed",
                   "requests_hedged", "hedge_wins", "wasted_hedge_tokens",
                   "replay_skipped_tokens", "requests_completed",
                   "requests_failed", "requests_shed", "requests_rejected",
                   "requests_abandoned", "ttft_p50_ms", "ttft_p95_ms",
                   "inflight_total", "replicas_known", "replicas_healthy",
                   "draining")
_STEP_TIME_WINDOW = 64


class _MemberTail:
    """One member's incremental readers + rolled-up scalars."""

    def __init__(self, row: dict):
        self.registered = row          # latest registry row
        self.role: str | None = row.get("role")  # sticky once resolved
        out = row["output_dir"]
        self.output_dir = out
        self.health = FileWatcher(
            os.path.join(out, row.get("health_file") or HEALTH_NAME))
        # a supervisor member shares its CHILD's output dir: tailing the
        # child's metrics/incarnations here would double-read every byte
        # and re-attribute the child's alert inputs to the supervisor —
        # the watchdog's own surface is its heartbeat file alone
        tail_streams = row.get("role") != "supervisor"
        self.metrics = (JsonlTailer(os.path.join(out, "metrics.jsonl"))
                        if tail_streams else None)
        self.incarnations = (
            JsonlTailer(os.path.join(out, "incarnations.jsonl"))
            if tail_streams else None)
        self.train_last: dict = {}
        self.serve_last: dict = {}
        self.gateway_last: dict = {}
        self.step_times: list[float] = []
        self.inc_count = 0
        self.inc_failed = 0
        self.inc_last: dict = {}
        self.resizes = 0

    @property
    def bytes_read(self) -> int:
        return (self.health.bytes_read
                + (self.metrics.bytes_read if self.metrics else 0)
                + (self.incarnations.bytes_read if self.incarnations else 0))

    def poll(self) -> None:
        health = self.health.poll() or {}
        if self.role is None and isinstance(health.get("role"), str):
            self.role = health["role"]
        for m in (self.metrics.poll() if self.metrics else ()):
            if m.get("serving"):
                for k in _SERVE_FIELDS:
                    if k in m:
                        self.serve_last[k] = m[k]
            elif m.get("gateway"):
                for k in _GATEWAY_FIELDS:
                    if k in m:
                        self.gateway_last[k] = m[k]
            else:
                for k in _TRAIN_FIELDS:
                    if k in m:
                        self.train_last[k] = m[k]
                st = _num(m.get("step_time"))
                if st is not None:
                    self.step_times.append(st)
        if len(self.step_times) > _STEP_TIME_WINDOW:
            del self.step_times[:-_STEP_TIME_WINDOW]
        for row in (self.incarnations.poll() if self.incarnations else ()):
            self.inc_count += 1
            self.inc_last = row
            if row.get("outcome") not in ("clean", "supervisor_stopped", None):
                self.inc_failed += 1
            if row.get("resized"):
                self.resizes += 1

    def resolved_role(self) -> str:
        # registry row > live health role > trainer (the only role that
        # never labels itself)
        return self.role or "trainer"


def _percentile(values: list[float], q: float) -> float | None:
    if not values:
        return None
    ordered = sorted(values)
    rank = max(0, min(len(ordered) - 1,
                      int(round(q / 100.0 * (len(ordered) - 1)))))
    return ordered[rank]


# ---------------------------------------------------------------------------
# the aggregator
# ---------------------------------------------------------------------------

class FleetAggregator:
    """Registry-driven fleet rollup. `refresh()` polls every member's
    streams incrementally, evaluates alert rules, appends firing/resolved
    EDGES to alerts.jsonl, drops capture triggers, and atomically rewrites
    fleet_status.json. Single-threaded by design — tools.fleetd calls
    it from one loop and hands snapshots to HTTP threads under a lock."""

    def __init__(self, fleet_root: str, rules: AlertRules | None = None,
                 capture_on_alert: bool = True):
        self.fleet_root = fleet_root
        self.rules = rules or AlertRules()
        self.capture_on_alert = capture_on_alert
        self._registry = JsonlTailer(os.path.join(fleet_root, REGISTRY_NAME))
        self._members: dict[tuple, _MemberTail] = {}
        self._alert_state: dict[tuple, dict] = {}
        self.refresh_count = 0
        self.last_status: dict | None = None

    # -- plumbing ----------------------------------------------------------

    @property
    def bytes_read(self) -> int:
        return (self._registry.bytes_read
                + sum(m.bytes_read for m in self._members.values()))

    def _member_key(self, row: dict) -> tuple:
        return (row["output_dir"], row.get("health_file") or HEALTH_NAME)

    def _ingest_registry(self) -> None:
        for row in self._registry.poll():
            # the tailer yields ANY parseable dict line; a row without an
            # output_dir (garbage, a future header) is skipped like a torn
            # line, never a KeyError out of the daemon's refresh loop
            if not isinstance(row.get("output_dir"), str):
                continue
            key = self._member_key(row)
            tail = self._members.get(key)
            if tail is None:
                self._members[key] = _MemberTail(row)
            else:
                tail.registered = row
                if tail.role is None and row.get("role"):
                    tail.role = row["role"]

    # -- one member's status ----------------------------------------------

    def _member_status(self, tail: _MemberTail, now: float) -> dict:
        tail.poll()
        health = tail.health.data or {}
        reg = tail.registered
        # liveness: the newest of (health time, latest registration) — a
        # freshly relaunched child that has not written health yet is
        # vouched for by its registration, the supervisor's own rule
        h_time = _num(health.get("time")) or 0.0
        reg_ts = _num(reg.get("ts")) or 0.0
        age = now - max(h_time, reg_ts) if (h_time or reg_ts) else None
        status: dict[str, Any] = {
            "role": tail.resolved_role(),
            "replica": reg.get("replica"),
            "output_dir": tail.output_dir,
            "pid": reg.get("pid"),
            "incarnation": reg.get("incarnation"),
            "health_status": tail.health.status,
            "heartbeat_age_s": round(age, 3) if age is not None else None,
            "last_step": health.get("last_step"),
            "goodput": _num(health.get("goodput")),
        }
        if reg.get("layout") is not None:
            status["layout"] = reg.get("layout")
        # a terminal registration row (register_member(..., outcome=...)
        # when the supervisor gives up) stops this member counting as
        # fresh: the heartbeat_stale rule fires immediately on it instead
        # of waiting out the staleness window — a dead pod must not look
        # healthy until its heartbeat ages out
        if isinstance(reg.get("outcome"), str):
            status["terminal_outcome"] = reg["outcome"]
        clock = health.get("clock")
        if isinstance(clock, dict):
            status["elapsed_s"] = _num(clock.get("elapsed"))
        # step-time percentiles: the member's own rolling fields when the
        # timeline mode publishes them, else derived from the tailed
        # metrics step_time stream
        p50 = _num(health.get("step_time_p50")) or _percentile(
            tail.step_times, 50)
        p95 = _num(health.get("step_time_p95")) or _percentile(
            tail.step_times, 95)
        if p50 is not None:
            status["step_time_p50"] = round(p50, 4)
        if p95 is not None:
            status["step_time_p95"] = round(p95, 4)
        for key in ("bubble_fraction", "bubble_fraction_measured",
                    "nonfinite_steps", "anomaly_count", "mfu", "loss"):
            val = tail.train_last.get(key, health.get(key))
            if val is not None:
                out_key = ("bubble_fraction_analytic"
                           if key == "bubble_fraction" else key)
                status[out_key] = val
        if tail.serve_last:
            status.update(tail.serve_last)
        if tail.gateway_last:
            status.update(tail.gateway_last)
        if health.get("checkpoint_step") is not None:
            status["checkpoint_step"] = health.get("checkpoint_step")
        elif isinstance(reg.get("checkpoint_step"), int):
            status["checkpoint_step"] = reg["checkpoint_step"]
        if tail.inc_count:
            status["incarnations"] = tail.inc_count
            status["restarts"] = max(tail.inc_count - 1, 0)
            status["failed_incarnations"] = tail.inc_failed
            status["resizes"] = tail.resizes
            status["last_outcome"] = tail.inc_last.get("outcome")
        if tail.resolved_role() != "supervisor":
            # OOM forensics surface (utils/memwatch.py): snapshot count and
            # the recency bit the oom_recent alert rule keys on. A snapshot
            # newer than the latest registration means memory pressure
            # killed THIS incarnation; a relaunch re-registers with a newer
            # ts, flipping the bit back to 0 — the alert resolves on
            # recovery, not by data going missing. Supervisor members share
            # the child's output dir, so only the child publishes these.
            try:
                snaps = [f for f in os.listdir(memwatch.oom_dir(
                    tail.output_dir)) if f.endswith(".json")]
            except OSError:
                snaps = []
            if snaps:
                status["oom_snapshots"] = len(snaps)
            mtime = memwatch.latest_oom_mtime(tail.output_dir)
            if mtime is not None or reg_ts:
                status["oom_recent"] = int(mtime is not None and reg_ts > 0
                                           and mtime > reg_ts)
        if tail.resolved_role() == "supervisor":
            for key in ("restarts", "consecutive_failures", "last_outcome",
                        "child_pid", "watched_dir"):
                if health.get(key) is not None:
                    status[key] = health[key]
        return status

    # -- alerts ------------------------------------------------------------

    def _evaluate_alerts(self, members: dict[tuple, dict],
                         ids: dict[tuple, str], now: float,
                         write: bool = True) -> tuple[dict, list[dict]]:
        alerts: dict[str, dict] = {}
        edges: list[dict] = []
        for key, member in members.items():
            member_id = ids[key]
            for rule, value, threshold, raw in self.rules.evaluate(member):
                state_key = (rule,) + key
                prev = self._alert_state.get(state_key)
                if prev is None:
                    prev = self._alert_state[state_key] = {
                        "firing": False, "since": now,
                        "raw_since": None, "resolved_at": None}
                # flap damping (for_s / cooldown_s, AlertRules docstring):
                # the raw condition must hold continuously for for_s before
                # the alert FIRES, and a resolve suppresses re-firing for
                # cooldown_s. Both default 0 — damped == raw, bit-identical
                # to the undamped evaluator.
                for_s, cooldown_s = self.rules.damping_for(rule)
                if raw:
                    if prev.get("raw_since") is None:
                        prev["raw_since"] = now
                else:
                    prev["raw_since"] = None
                firing = raw and now - prev["raw_since"] >= for_s
                if firing and not prev["firing"] \
                        and prev.get("resolved_at") is not None \
                        and now - prev["resolved_at"] < cooldown_s:
                    firing = False
                transitioned = firing != prev["firing"]
                if transitioned:
                    if not firing:
                        prev["resolved_at"] = now
                    prev["firing"] = firing
                    prev["since"] = now
                    edge = {"ts": now, "alert": rule, "member": member_id,
                            "output_dir": member["output_dir"],
                            "state": "firing" if firing else "resolved",
                            "value": value, "threshold": threshold}
                    edges.append(edge)
                    if write and firing and self.capture_on_alert \
                            and member["role"] != "supervisor":
                        self._drop_capture_trigger(member, edge)
                if prev["firing"] or transitioned:
                    alerts[f"{rule}:{member_id}"] = {
                        "state": "firing" if prev["firing"] else "resolved",
                        "since": prev["since"], "value": value,
                        "threshold": threshold}
        if edges and write:
            with open(os.path.join(self.fleet_root, ALERTS_NAME), "a") as f:
                for edge in edges:
                    f.write(json.dumps(edge) + "\n")
        return alerts, edges

    def _drop_capture_trigger(self, member: dict, edge: dict) -> None:
        """Cross-process triggered capture: leave one trigger file in the
        member's output dir; its TriggeredProfiler consumes it and runs a
        bounded, retention-capped capture. An UNCONSUMED trigger is left
        alone — alerts must not stack captures faster than the member can
        take them (and a dead member picks the file up on relaunch)."""
        path = os.path.join(member["output_dir"], CAPTURE_TRIGGER_NAME)
        if os.path.exists(path):
            return
        try:
            write_json_atomic(path, {"ts": edge["ts"], "alert": edge["alert"],
                                     "member": edge["member"],
                                     "value": edge["value"],
                                     "threshold": edge["threshold"]})
        except OSError as e:
            logger.warning("could not drop capture trigger in %s: %r",
                           member["output_dir"], e)

    # -- the refresh -------------------------------------------------------

    def refresh(self, write: bool = True) -> dict:
        now = time.time()
        self.refresh_count += 1
        bytes_before = self.bytes_read
        self._ingest_registry()
        members: dict[tuple, dict] = {}
        for key, tail in self._members.items():
            members[key] = self._member_status(tail, now)

        # trainer's latest VERIFIED checkpoint -> per-replica lag
        trainer_step = None
        for member in members.values():
            if member["role"] == "trainer":
                step = latest_verified_step(member["output_dir"])
                if step is not None:
                    member["latest_verified_step"] = step
                    trainer_step = (step if trainer_step is None
                                    else max(trainer_step, step))
        if trainer_step is not None:
            for member in members.values():
                loaded = member.get("checkpoint_step")
                if member["role"] == "serve" and isinstance(loaded, int):
                    member["checkpoint_lag"] = max(trainer_step - loaded, 0)

        # one display id per member, shared by the status map, the alert
        # rollup, and the edge rows — replica-name collisions (two dirs
        # with the same basename, no --replica) disambiguate ONCE here,
        # deterministically (registry ingestion order), so an edge and
        # its member entry can never name two different things
        ids: dict[tuple, str] = {}
        for key, member in members.items():
            member_id = f"{member['role']}:{member['replica']}"
            while member_id in ids.values():
                member_id += "+"
            ids[key] = member_id

        alerts, edges = self._evaluate_alerts(members, ids, now, write=write)

        # pod-level goodput across incarnations: each member's health
        # goodput is already cumulative across restarts (RunClock prior=
        # seeding); the pod number weights members by their elapsed wall
        good = elapsed = 0.0
        pod: dict[str, Any] = {
            "members": len(members),
            "trainer_step": trainer_step,
            "alerts_firing": sorted(k for k, v in alerts.items()
                                    if v["state"] == "firing"),
        }
        for member in members.values():
            gp, el = member.get("goodput"), member.get("elapsed_s")
            if member["role"] != "supervisor" and gp is not None and el:
                good += gp * el
                elapsed += el
        if elapsed:
            pod["goodput"] = round(good / elapsed, 4)

        by_id = {ids[key]: member for key, member in members.items()}
        status = {
            "time": now,
            "fleet_root": self.fleet_root,
            "refresh_count": self.refresh_count,
            "bytes_read_total": self.bytes_read,
            "bytes_read_last_refresh": self.bytes_read - bytes_before,
            "members": by_id,
            "pod": pod,
            "alerts": alerts,
            "alert_edges_last_refresh": edges,
        }
        self.last_status = status
        if write:
            try:
                write_json_atomic(
                    os.path.join(self.fleet_root, STATUS_NAME), status)
            except OSError as e:
                logger.warning("fleet_status.json write failed: %r", e)
        return status


def read_alerts(fleet_root: str) -> list[dict]:
    """Every parseable alert edge (tools.fleet_report's timeline)."""
    return read_jsonl(os.path.join(fleet_root, ALERTS_NAME),
                      keep=lambda r: "alert" in r)
