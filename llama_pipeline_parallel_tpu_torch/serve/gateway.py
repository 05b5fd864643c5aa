"""Request-durable gateway tier (the JAX package's serve/gateway.py,
ported; its docs/SERVING.md "Gateway & failover").

A stdlib-HTTP routing tier in front of N supervised serve replicas. The
module itself touches no torch and runs no model code — it moves bytes,
files and sockets. The import dependency is one-way by design:
serve/__init__ and tools.serve do NOT import this module, so the
direct-to-replica single-replica path pays zero gateway import cost and
stays byte-identical with the gateway absent.

The durability contract: the engine is deterministic per (prompt, seed,
gen config) — a served request emits exactly the tokens an independent
`generate()` would (the token-parity pin). So a request on a
crashed replica is REPLAYABLE, not lost: the gateway journals every
accepted request to a WAL before dispatch, and when a replica dies
mid-stream it re-submits the journalled body to a surviving replica,
verifies the replayed stream against the already-delivered prefix, skips
up to the delivered-token watermark, and splices — the client receives
the complete, bit-identical token sequence of an uninterrupted run.

WAL (`gateway_journal.jsonl`, utils/actions.py's actions.jsonl intent→outcome
discipline applied to requests):

  {"kind": "intent",    "gid", "trace_id", "ts", "body": {...}}
  {"kind": "routed",    "gid", "replica", "attempt", "hedge", "ts"}
  {"kind": "watermark", "gid", "delivered", "ts"}
  {"kind": "terminal",  "gid", "outcome", "tokens", "ts", ...}

Exactly one terminal row per gid — the writer REJECTS a duplicate. An
intent without a terminal is an orphan the next gateway start reconciles:
re-poll the replicas' request_trace.jsonl by trace_id (the request may
have finished while the gateway was down), else replay it headless so the
outcome is durable even across a gateway crash.

Routing is health-aware: fleet registry rows (utils/fleet.py) name the replicas,
`serve.json` carries each one's endpoint, `health.json` heartbeat age
gates liveness, and a rate-limited /healthz probe supplies queue-depth /
queue-wait / degraded gauges. Backpressure (429/503 + Retry-After) cools
a replica for exactly the hinted window; retries follow the shared
bounded exponential-backoff policy (utils/retry.py) with the hint as a
floor. Hedged dispatch races a second replica after a p95-derived delay;
first token wins, the loser is cancelled by closing its connection — the
replica's client-disconnect path (serve/frontend.py) frees its slot and pages at the
next tick.
"""

from __future__ import annotations

import dataclasses
import http.client
import itertools
import json
import os
import queue as queue_mod
import random
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from llama_pipeline_parallel_tpu_torch.serve.reqtrace import (
    REQUEST_TRACE_NAME,
    TraceContext,
)
from llama_pipeline_parallel_tpu_torch.serve.telemetry import (
    GatewayStats,
    retry_after_s,
)
from llama_pipeline_parallel_tpu_torch.utils import faults
from llama_pipeline_parallel_tpu_torch.utils import fleet as fleet_mod
from llama_pipeline_parallel_tpu_torch.utils.logging import get_logger
from llama_pipeline_parallel_tpu_torch.utils.perf import read_jsonl
from llama_pipeline_parallel_tpu_torch.utils.retry import (
    RetryPolicy,
    backoff_delay_s,
)

logger = get_logger(__name__)

JOURNAL_NAME = "gateway_journal.jsonl"
GATEWAY_JSON_NAME = "gateway.json"


class GatewayError(RuntimeError):
    """Base for gateway-terminal request failures."""


class GatewayOverloaded(GatewayError):
    """No healthy replica, or the upstream backoff budget is spent — the
    client should retry later (429/503 + Retry-After)."""

    def __init__(self, message: str, retry_after_s: float = 1.0,
                 code: int = 503):
        super().__init__(message)
        self.retry_after_s = retry_after_s
        self.code = code


class GatewayRejected(GatewayError):
    """A replica answered 400: the request is deterministically
    unservable — retrying elsewhere would just fail again."""


class SpliceDiverged(GatewayError):
    """A replayed stream disagreed with the already-delivered prefix —
    the determinism contract is broken (mixed checkpoints, an unseeded
    sampling path); failing loudly beats silently serving a franken-
    stream."""


# ---------------------------------------------------------------------------
# WAL
# ---------------------------------------------------------------------------

class GatewayJournal:
    """Append-only request WAL with the actions.jsonl idempotency rules:
    every row self-describing, torn tails tolerated on load, and exactly
    ONE terminal row per gid — `terminal()` raises on a duplicate, at
    restart the FIRST parsed terminal wins and later duplicates in the
    file are ignored (a torn duplicate can only exist if a previous
    incarnation crashed between write and flush)."""

    def __init__(self, output_dir: str):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, JOURNAL_NAME)
        self._lock = threading.Lock()
        # restart: rebuild the per-gid state from whatever parses
        self.state = self._load(self.path)
        self._terminal = {gid for gid, st in self.state.items()
                          if st["terminal"] is not None}
        self._f = open(self.path, "a")

    @staticmethod
    def _load(path: str) -> dict:
        state: dict[str, dict] = {}
        for row in read_jsonl(path, keep=lambda r: isinstance(r.get("gid"),
                                                              str)):
            st = state.setdefault(row["gid"], {
                "intent": None, "routed": [], "watermark": 0,
                "terminal": None})
            kind = row.get("kind")
            if kind == "intent" and st["intent"] is None:
                st["intent"] = row
            elif kind == "routed":
                st["routed"].append(row)
            elif kind == "watermark":
                st["watermark"] = max(st["watermark"],
                                      int(row.get("delivered") or 0))
            elif kind == "terminal" and st["terminal"] is None:
                st["terminal"] = row
        return state

    def _append(self, row: dict) -> None:
        line = json.dumps(row) + "\n"
        with self._lock:
            if self._f.closed:
                return
            self._f.write(line)
            self._f.flush()

    def intent(self, gid: str, trace_id: str | None, body: dict) -> None:
        """Journalled BEFORE first dispatch — an accepted request the
        gateway dies holding is an orphan reconciliation finds, never a
        silent loss. `body` is the replayable request (prompt, seed, gen
        config), stream/transport flags stripped."""
        row = {"kind": "intent", "gid": gid, "trace_id": trace_id,
               "ts": time.time(), "body": body}
        self.state[gid] = {"intent": row, "routed": [], "watermark": 0,
                           "terminal": None}
        self._append(row)

    def routed(self, gid: str, replica: str, attempt: int,
               hedge: bool = False) -> None:
        row = {"kind": "routed", "gid": gid, "replica": replica,
               "attempt": attempt, "hedge": bool(hedge), "ts": time.time()}
        st = self.state.get(gid)
        if st is not None:
            st["routed"].append(row)
        self._append(row)

    def watermark(self, gid: str, delivered: int) -> None:
        st = self.state.get(gid)
        if st is not None:
            st["watermark"] = max(st["watermark"], delivered)
        self._append({"kind": "watermark", "gid": gid,
                      "delivered": delivered, "ts": time.time()})

    def terminal(self, gid: str, outcome: str, tokens: int = 0,
                 **extra) -> None:
        with self._lock:
            if gid in self._terminal:
                raise ValueError(f"duplicate terminal row for {gid!r} "
                                 f"(outcome {outcome!r}) — the WAL records "
                                 f"exactly one outcome per request")
            self._terminal.add(gid)
        row = {"kind": "terminal", "gid": gid, "outcome": outcome,
               "tokens": tokens, "ts": time.time(), **extra}
        st = self.state.get(gid)
        if st is not None:
            st["terminal"] = row
        self._append(row)

    def has_terminal(self, gid: str) -> bool:
        return gid in self._terminal

    def orphans(self) -> list[str]:
        """Gids with a journalled intent and no terminal outcome — the
        reconciliation worklist, in intent order."""
        out = [(st["intent"]["ts"], gid) for gid, st in self.state.items()
               if st["intent"] is not None and st["terminal"] is None]
        return [gid for _, gid in sorted(out)]

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


# ---------------------------------------------------------------------------
# replica discovery + health-aware candidate set
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Replica:
    """One serve replica's live view: endpoint + health files + the
    gateway's own load/backoff state for it."""

    name: str
    output_dir: str
    serve: fleet_mod.FileWatcher
    health: fleet_mod.FileWatcher
    inflight: int = 0
    cooldown_until: float = 0.0
    queue_depth: int = 0
    queue_wait_p95_ms: float = 0.0
    degraded: bool = False
    last_probe: float = 0.0

    def endpoint(self) -> tuple[str, int] | None:
        data = self.serve.data or {}
        host, port = data.get("host"), data.get("port")
        if isinstance(host, str) and isinstance(port, int) and port > 0:
            return host, port
        return None

    def heartbeat_age(self, now: float) -> float | None:
        t = (self.health.data or {}).get("time")
        return now - t if isinstance(t, (int, float)) else None


class ReplicaDirectory:
    """Live replica set: fleet-registry rows with role="serve"
    and/or explicitly named output dirs. `poll()` ingests registry
    appendices and refreshes the stat-gated serve.json/health.json
    watchers; a rate-limited GET /healthz probe pulls queue-depth /
    queue-wait / degraded gauges for routing. Thread-safe: handler
    threads read candidates while the poll loop refreshes."""

    def __init__(self, fleet_root: str | None = None,
                 replica_dirs: tuple = (), stale_s: float = 15.0,
                 probe_every_s: float = 2.0,
                 probe_timeout_s: float = 1.0):
        self.fleet_root = fleet_root
        self.stale_s = stale_s
        self.probe_every_s = probe_every_s
        self.probe_timeout_s = probe_timeout_s
        self._lock = threading.Lock()
        self._registry = (fleet_mod.JsonlTailer(
            os.path.join(fleet_root, fleet_mod.REGISTRY_NAME))
            if fleet_root else None)
        self._replicas: dict[str, _Replica] = {}
        for d in replica_dirs:
            self._add(str(d))

    def _add(self, output_dir: str, name: str | None = None) -> _Replica:
        rep = self._replicas.get(output_dir)
        if rep is None:
            rep = _Replica(
                name=name or os.path.basename(os.path.normpath(output_dir)),
                output_dir=output_dir,
                serve=fleet_mod.FileWatcher(
                    os.path.join(output_dir, "serve.json")),
                health=fleet_mod.FileWatcher(
                    os.path.join(output_dir, fleet_mod.HEALTH_NAME)))
            self._replicas[output_dir] = rep
        elif name:
            rep.name = name
        return rep

    def poll(self, probe: bool = True) -> None:
        if self._registry is not None:
            for row in self._registry.poll():
                if (row.get("role") == "serve"
                        and isinstance(row.get("output_dir"), str)):
                    with self._lock:
                        self._add(row["output_dir"], row.get("replica"))
        with self._lock:
            replicas = list(self._replicas.values())
        now = time.time()
        for rep in replicas:
            rep.serve.poll()
            rep.health.poll()
            if probe and now - rep.last_probe >= self.probe_every_s:
                self._probe(rep, now)

    def _probe(self, rep: _Replica, now: float) -> None:
        """Rate-limited /healthz pull: queue gauges + the degraded bit.
        A probe failure is NOT a death sentence (heartbeat age owns
        liveness) — it just leaves the last-known gauges in place."""
        rep.last_probe = now
        endpoint = rep.endpoint()
        if endpoint is None:
            return
        try:
            conn = http.client.HTTPConnection(
                *endpoint, timeout=self.probe_timeout_s)
            try:
                conn.request("GET", "/healthz")
                snap = json.loads(conn.getresponse().read())
            finally:
                conn.close()
        except (OSError, ValueError, http.client.HTTPException):
            return
        if isinstance(snap, dict):
            rep.queue_depth = int(snap.get("queue_depth") or 0)
            rep.queue_wait_p95_ms = float(snap.get("queue_wait_p95_ms")
                                          or 0.0)
            rep.degraded = snap.get("degraded") is not None

    def all(self) -> list[_Replica]:
        with self._lock:
            return list(self._replicas.values())

    def candidates(self, exclude: tuple = (),
                   now: float | None = None) -> list[_Replica]:
        """Healthy replicas, best first: fresh heartbeat, a known
        endpoint, not cooling from a 429/503 Retry-After, not degraded;
        ordered by (gateway inflight + replica queue depth, queue-wait
        p95, name) — the gateway's own outstanding count is the primary
        signal because it is exact, the probed gauges refine it."""
        now = time.time() if now is None else now
        out = []
        for rep in self.all():
            if rep.name in exclude or rep.endpoint() is None:
                continue
            if now < rep.cooldown_until or rep.degraded:
                continue
            age = rep.heartbeat_age(now)
            if self.stale_s > 0 and (age is None or age > self.stale_s):
                continue
            out.append(rep)
        return sorted(out, key=lambda r: (r.inflight + r.queue_depth,
                                          r.queue_wait_p95_ms, r.name))

    def acquire(self, rep: _Replica) -> None:
        with self._lock:
            rep.inflight += 1

    def release(self, rep: _Replica) -> None:
        with self._lock:
            rep.inflight = max(rep.inflight - 1, 0)

    def note_backoff(self, rep: _Replica, retry_after: float) -> None:
        """A 429/503 with Retry-After cools the replica for exactly the
        hinted window — the honest hint (telemetry.retry_after_s) covers
        its drain, so routing around it until then is free goodput."""
        with self._lock:
            rep.cooldown_until = max(rep.cooldown_until,
                                     time.time() + retry_after)

    def snapshot(self) -> dict:
        now = time.time()
        healthy = {r.name for r in self.candidates()}
        out = {}
        for rep in self.all():
            age = rep.heartbeat_age(now)
            out[rep.name] = {
                "output_dir": rep.output_dir,
                "endpoint": (":".join(map(str, rep.endpoint()))
                             if rep.endpoint() else None),
                "heartbeat_age_s": round(age, 3) if age is not None else None,
                "inflight": rep.inflight,
                "queue_depth": rep.queue_depth,
                "healthy": rep.name in healthy,
                "cooling_s": round(max(rep.cooldown_until - now, 0.0), 3),
            }
        return out


# ---------------------------------------------------------------------------
# one dispatch attempt (reader thread over http.client)
# ---------------------------------------------------------------------------

class _Attempt:
    """One streaming POST to one replica. Pushes events into the
    coordinator's queue: ("token", idx, tok), ("done", idx, tokens),
    ("backoff", idx, code, retry_after_s), ("reject", idx, code, msg),
    ("died", idx, why). `cancel()` closes the socket — on the replica
    that is a client disconnect, which cancels the request at the next
    step boundary and frees its slot/pages (serve/frontend.py's disconnect path)."""

    def __init__(self, idx: int, replica: _Replica, body: dict,
                 headers: dict, outq: queue_mod.Queue, timeout_s: float):
        self.idx = idx
        self.replica = replica
        self.body = body
        self.headers = headers
        self.outq = outq
        self.timeout_s = timeout_s
        self.cancelled = False
        # token lines READ off the socket (not just ones the coordinator
        # consumed) — a cancelled loser's count is the wasted-hedge gauge
        self.tokens_seen = 0
        self._conn: http.client.HTTPConnection | None = None
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"gw-attempt-{body.get('request_id', idx)}")

    def start(self) -> None:
        self._thread.start()

    def cancel(self) -> None:
        self.cancelled = True
        conn = self._conn
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def _put(self, *event) -> None:
        if not self.cancelled:
            self.outq.put(event)

    def _run(self) -> None:
        endpoint = self.replica.endpoint()
        if endpoint is None:
            return self._put("died", self.idx, "endpoint vanished")
        try:
            faults.fire("gateway_dispatch", tag=self.replica.name)
            conn = http.client.HTTPConnection(*endpoint,
                                              timeout=self.timeout_s)
            self._conn = conn
            conn.request("POST", "/v1/generate",
                         json.dumps(self.body).encode(), self.headers)
            resp = conn.getresponse()
        except (OSError, http.client.HTTPException) as e:
            return self._put("died", self.idx, repr(e))
        if resp.status in (429, 503):
            try:
                retry = float(resp.getheader("Retry-After") or 1.0)
            except ValueError:
                retry = 1.0
            resp.read()
            conn.close()
            return self._put("backoff", self.idx, resp.status, retry)
        if resp.status != 200:
            try:
                msg = json.loads(resp.read() or b"{}").get("error", "")
            except ValueError:
                msg = ""
            conn.close()
            return self._put("reject", self.idx, resp.status, msg)
        try:
            for raw in resp:
                line = raw.strip()
                if not line:
                    continue
                row = json.loads(line)
                if row.get("done"):
                    conn.close()
                    if row.get("error"):
                        # the replica's engine failed the request (its
                        # own shutdown path included): replayable, the
                        # stream did NOT complete
                        return self._put("died", self.idx, row["error"])
                    return self._put("done", self.idx,
                                     row.get("tokens") or [])
                self.tokens_seen += 1
                self._put("token", self.idx, row.get("token"))
            # EOF without the done line: the replica died mid-stream
            self._put("died", self.idx, "stream ended without done line")
        except (OSError, ValueError, http.client.HTTPException) as e:
            self._put("died", self.idx, repr(e))
        finally:
            try:
                conn.close()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# the gateway
# ---------------------------------------------------------------------------

class GatewayHandle:
    """The caller's end of one routed request (the RequestHandle shape):
    `tokens()` streams spliced tokens; `info` carries the per-request
    attempt/replay/hedge accounting the response tail and serve_traffic
    summaries surface."""

    def __init__(self, gid: str, trace: TraceContext, gen):
        self.gid = gid
        self.trace = trace
        self.tokens_out: list[int] = []
        self.info = {"attempts": 0, "replays": 0, "hedges": 0}
        self._gen = gen

    def tokens(self):
        for tok in self._gen:
            self.tokens_out.append(tok)
            yield tok

    def result(self) -> list[int]:
        for _ in self.tokens():
            pass
        return self.tokens_out

    def close(self) -> None:
        self._gen.close()


class Gateway:
    """Routing + durability coordinator. One instance per gateway
    process; handler threads call `submit()` concurrently."""

    def __init__(self, output_dir: str, directory: ReplicaDirectory, *,
                 policy: RetryPolicy | None = None,
                 hedge: str | float = "off",
                 hedge_floor_s: float = 0.05,
                 watermark_every: int = 8,
                 request_timeout_s: float = 120.0,
                 route_wait_s: float = 20.0,
                 stats: GatewayStats | None = None):
        self.output_dir = output_dir
        self.directory = directory
        # serving retries are short-fused next to the storage default:
        # a request is latency-sensitive, and Retry-After floors the
        # delay whenever the replica supplied an honest hint
        self.policy = policy or RetryPolicy.from_env(base_delay_s=0.05,
                                                     max_delay_s=5.0)
        self.hedge = hedge
        self.hedge_floor_s = hedge_floor_s
        self.watermark_every = max(int(watermark_every), 1)
        self.request_timeout_s = request_timeout_s
        self.route_wait_s = route_wait_s
        self.stats = stats or GatewayStats()
        self.journal = GatewayJournal(output_dir)
        self.draining = False
        self._ids = itertools.count()
        self._pid = os.getpid()

    # -- public API --------------------------------------------------------

    def submit(self, body: dict,
               traceparent: str | None = None) -> GatewayHandle:
        """Validate + journal one request, return its streaming handle.
        Raises ValueError on a malformed body, GatewayOverloaded when
        draining. Dispatch is lazy — the WAL intent row is written here,
        attempts start on first `tokens()` pull."""
        body = self._normalize(body)
        if self.draining:
            raise GatewayOverloaded("gateway draining", retry_after_s=2.0,
                                    code=503)
        ctx = TraceContext.from_traceparent(traceparent)
        gid = f"gw-{self._pid}-{next(self._ids)}"
        self.journal.intent(gid, ctx.trace_id, body)
        handle = GatewayHandle(gid, ctx, None)
        handle._gen = self._stream(gid, ctx, body, handle.info)
        return handle

    @staticmethod
    def _normalize(body: dict) -> dict:
        """The replayable request: prompt + seed + gen config, transport
        flags stripped. Light validation only — the replica's
        request_from_json is authoritative and its 400 propagates."""
        if not isinstance(body, dict):
            raise ValueError("request body must be a JSON object")
        ids = body.get("input_ids")
        if (not isinstance(ids, list) or not ids
                or not all(isinstance(i, int) for i in ids)):
            raise ValueError("input_ids must be a non-empty list of ints")
        out = {k: v for k, v in body.items()
               if k not in ("stream", "request_id", "gateway")
               and v is not None}
        out["seed"] = int(body.get("seed", 0))
        return out

    def healthz(self) -> dict:
        snap = self.stats.snapshot()
        replicas = self.directory.snapshot()
        snap["replicas_known"] = len(replicas)
        snap["replicas_healthy"] = sum(1 for r in replicas.values()
                                       if r["healthy"])
        snap["replicas"] = replicas
        if self.draining:
            snap["draining"] = 1
        return snap

    def close(self) -> None:
        self.journal.close()

    # -- reconciliation (gateway restart) ----------------------------------

    def reconcile(self, replay: bool = True) -> list[dict]:
        """Resolve every orphaned intent left by a previous incarnation:
        (1) re-poll the replicas — a request that FINISHED while the
        gateway was down has a completed request_trace.jsonl record under
        this trace_id; adopt its outcome. (2) else replay the journalled
        body headless (the client is gone, but the outcome becomes
        durable: exactly one terminal row per intent, crash or no crash).
        Returns one {"gid", "outcome", ...} row per orphan."""
        results = []
        for gid in self.journal.orphans():
            st = self.journal.state[gid]
            trace_id = st["intent"].get("trace_id")
            body = st["intent"].get("body")
            found = self._find_completed_trace(trace_id) if trace_id else None
            if found is not None:
                self.journal.terminal(
                    gid, "reconciled", tokens=int(found.get("tokens") or 0),
                    via="replica_trace", replica_outcome=found.get("outcome"))
                results.append({"gid": gid, "outcome": "reconciled"})
            elif replay and isinstance(body, dict):
                outcome = self._replay_headless(gid, body)
                results.append({"gid": gid, "outcome": outcome})
            else:
                self.journal.terminal(gid, "lost", via="no_replay")
                results.append({"gid": gid, "outcome": "lost"})
        return results

    def _find_completed_trace(self, trace_id: str) -> dict | None:
        """A replica-side terminal record for this trace: the request ran
        to completion even though the gateway never journalled it."""
        for rep in self.directory.all():
            rows = read_jsonl(
                os.path.join(rep.output_dir, REQUEST_TRACE_NAME),
                keep=lambda r: (r.get("trace_id") == trace_id
                                and r.get("outcome") == "completed"))
            if rows:
                return rows[-1]
        return None

    def _replay_headless(self, gid: str, body: dict) -> str:
        handle = GatewayHandle(gid, TraceContext.mint(), None)
        handle._gen = self._stream(gid, handle.trace, dict(body),
                                   handle.info)
        try:
            tokens = handle.result()
            logger.info("reconciled orphan %s by replay (%d tokens)",
                        gid, len(tokens))
            return "replayed"
        except GatewayError as e:
            logger.warning("orphan %s replay failed: %r", gid, e)
            return "failed"

    # -- routing -----------------------------------------------------------

    def _route(self, exclude: tuple = ()) -> _Replica | None:
        self.directory.poll()
        cands = self.directory.candidates(exclude=exclude)
        if not cands and exclude:
            # a dead/cooling exclusion with nobody else up: any healthy
            # replica (its relaunch included) beats failing the request
            cands = self.directory.candidates()
        return cands[0] if cands else None

    def _route_wait(self, exclude: tuple, deadline: float) -> _Replica | None:
        """Wait for SOME healthy replica up to `deadline` — the watchdog
        relaunch racing the replay is a feature, not a flake: whichever
        of (relaunched A, surviving B) turns healthy first wins."""
        while True:
            rep = self._route(exclude=exclude)
            if rep is not None or time.monotonic() >= deadline:
                return rep
            time.sleep(0.05)

    def _hedge_delay(self) -> float | None:
        if self.hedge == "off" or self.hedge is None:
            return None
        if self.hedge == "auto":
            p95 = self.stats.ttft_p95_s()
            if p95 is None:
                return None
            return max(p95, self.hedge_floor_s)
        return max(float(self.hedge), self.hedge_floor_s)

    # -- the coordinator ---------------------------------------------------

    def _stream(self, gid: str, ctx: TraceContext, body: dict, info: dict):
        """Generator of spliced tokens for one request. All WAL writes,
        retry/replay/hedge state and stats accounting live here, so a
        request has exactly one coordinator whatever the transport."""
        delivered: list[int] = []
        outq: queue_mod.Queue = queue_mod.Queue()
        live: dict[int, _Attempt] = {}
        positions: dict[int, int] = {}
        winner: int | None = None
        hedged = False  # one hedge per request: "a SECOND attempt"
        failures = 0
        t_start = time.monotonic()
        deadline = t_start + self.request_timeout_s
        rng = random.Random(zlib.crc32(gid.encode()))
        next_watermark = self.watermark_every
        headers = {"Content-Type": "application/json",
                   "traceparent": ctx.traceparent()}

        def launch(hedge: bool = False, exclude: tuple = ()):
            rep = (self._route(exclude=exclude) if hedge
                   else self._route_wait(exclude,
                                         min(deadline, time.monotonic()
                                             + self.route_wait_s)))
            if rep is None:
                return None
            info["attempts"] += 1
            idx = info["attempts"]
            out_body = dict(body)
            out_body["stream"] = True
            out_body["request_id"] = f"{gid}.a{idx}"
            out_body["gateway"] = {"attempt": idx,
                                   "replay": bool(delivered),
                                   "hedge": hedge}
            att = _Attempt(idx, rep, out_body, headers, outq,
                           self.request_timeout_s)
            live[idx] = att
            positions[idx] = 0
            self.directory.acquire(rep)
            self.stats.inflight(rep.name, +1)
            self.stats.bump("requests_routed")
            if hedge:
                info["hedges"] += 1
                self.stats.bump("requests_hedged")
            self.journal.routed(gid, rep.name, idx, hedge=hedge)
            att.start()
            return att

        def retire(idx: int) -> None:
            att = live.pop(idx, None)
            if att is not None:
                att.cancel()
                self.directory.release(att.replica)
                self.stats.inflight(att.replica.name, -1)

        def retire_all() -> None:
            for idx in list(live):
                retire(idx)

        def fail(outcome: str, exc: GatewayError, **extra):
            retire_all()
            self.stats.bump(f"requests_{outcome}")
            self.journal.terminal(gid, outcome, tokens=len(delivered),
                                  **extra)
            raise exc

        try:
            if launch() is None:
                fail("shed", GatewayOverloaded(
                    "no healthy replica",
                    retry_after_s=retry_after_s(0, None, gid,
                                                fallback=2.0)),
                     reason="no_replica")
            while True:
                now = time.monotonic()
                if now >= deadline:
                    fail("failed", GatewayError(
                        f"request deadline ({self.request_timeout_s}s) "
                        f"exceeded"), reason="deadline")
                # hedge timer: armed only while one primary attempt runs,
                # nothing delivered, and the delay is derivable
                timeout = deadline - now
                hedge_delay = (self._hedge_delay()
                               if not hedged and winner is None
                               and len(live) == 1 and not delivered
                               else None)
                if hedge_delay is not None:
                    timeout = min(timeout, max(
                        t_start + hedge_delay - now, 0.0))
                try:
                    event = outq.get(timeout=timeout)
                except queue_mod.Empty:
                    if hedge_delay is not None and winner is None:
                        hedged = True  # fired (or skipped): once only
                        only = next(iter(live.values()))
                        launch(hedge=True, exclude=(only.replica.name,))
                    continue
                kind, idx = event[0], event[1]
                att = live.get(idx)
                if att is None:
                    continue  # a cancelled attempt's last words

                if kind == "token":
                    if winner is None:
                        winner = idx
                        if att.body["gateway"]["hedge"]:
                            self.stats.bump("hedge_wins")
                        for other in [i for i in live if i != idx]:
                            wasted = live[other].tokens_seen
                            if wasted:
                                self.stats.bump("wasted_hedge_tokens",
                                                wasted)
                            retire(other)
                    pos = positions[idx]
                    positions[idx] = pos + 1
                    if idx != winner:
                        # a losing attempt streamed past the decision:
                        # pure overhead, measured not hidden
                        self.stats.bump("wasted_hedge_tokens")
                        continue
                    tok = event[2]
                    if pos < len(delivered):
                        # splice: below the delivered watermark the
                        # replayed stream must REPRODUCE the prefix —
                        # verify and suppress until caught up
                        if delivered[pos] != tok:
                            fail("failed", SpliceDiverged(
                                f"replay diverged at token {pos}: "
                                f"delivered {delivered[pos]}, replica "
                                f"streamed {tok}"), reason="splice")
                        self.stats.bump("replay_skipped_tokens")
                        continue
                    if not delivered:
                        self.stats.record_ttft(now - t_start)
                    delivered.append(tok)
                    if len(delivered) >= next_watermark:
                        self.journal.watermark(gid, len(delivered))
                        next_watermark = (len(delivered)
                                          + self.watermark_every)
                    yield tok

                elif kind == "done":
                    tokens_list = event[2]
                    if winner is None:
                        winner = idx  # zero-token stream: done decides
                    if idx != winner:
                        retire(idx)
                        continue
                    pos = positions[idx]
                    for tok in tokens_list[pos:]:
                        # tail tokens that raced the done line (the
                        # replica's final line carries the full list)
                        if len(delivered) < len(tokens_list):
                            delivered.append(tok)
                            yield tok
                    if delivered != tokens_list:
                        fail("failed", SpliceDiverged(
                            f"spliced stream ({len(delivered)} tokens) != "
                            f"replica terminal list "
                            f"({len(tokens_list)})"), reason="splice_tail")
                    retire_all()
                    self.stats.bump("requests_completed")
                    self.journal.terminal(gid, "completed",
                                          tokens=len(delivered),
                                          replays=info["replays"],
                                          hedges=info["hedges"])
                    return

                elif kind == "backoff":
                    code, retry_after = event[2], event[3]
                    self.directory.note_backoff(att.replica, retry_after)
                    retire(idx)
                    if live and winner is None:
                        continue  # the hedge partner is still racing
                    failures += 1
                    self.stats.bump("requests_retried")
                    if failures >= self.policy.max_attempts:
                        fail("shed", GatewayOverloaded(
                            f"retry budget spent ({failures} backoffs, "
                            f"last {code})", retry_after_s=retry_after,
                            code=429 if code == 429 else 503),
                             reason=f"backoff_{code}")
                    # Retry-After floors the delay only when the refuser
                    # is the sole option: with another healthy replica up,
                    # honoring the hint means cooling the REFUSER
                    # (note_backoff above) while the retry goes elsewhere
                    # immediately
                    self.directory.poll()
                    has_alt = bool(self.directory.candidates(
                        exclude=(att.replica.name,)))
                    time.sleep(backoff_delay_s(
                        self.policy, failures, rng,
                        floor_s=0.0 if has_alt else retry_after))
                    winner = None
                    if launch(exclude=(att.replica.name,)) is None:
                        fail("shed", GatewayOverloaded(
                            "no healthy replica after backoff",
                            retry_after_s=retry_after),
                             reason="no_replica")

                elif kind == "reject":
                    code, msg = event[2], event[3]
                    fail("rejected", GatewayRejected(
                        f"replica rejected request ({code}): {msg}"),
                         reason=f"http_{code}")

                elif kind == "died":
                    why = event[2]
                    was_winner = idx == winner
                    retire(idx)
                    if not was_winner and (winner is not None or live):
                        continue  # a loser died; the race goes on
                    failures += 1
                    if failures >= self.policy.max_attempts:
                        fail("failed", GatewayError(
                            f"replica stream died {failures} times, "
                            f"retry budget spent (last: {why})"),
                             reason="died")
                    winner = None
                    if delivered:
                        info["replays"] += 1
                        self.stats.bump("requests_replayed")
                        logger.info(
                            "replica %s died mid-stream of %s at token "
                            "%d (%s); replaying", att.replica.name, gid,
                            len(delivered), why)
                    else:
                        self.stats.bump("requests_retried")
                    time.sleep(backoff_delay_s(self.policy, failures, rng))
                    if launch(exclude=(att.replica.name,)) is None:
                        fail("failed", GatewayError(
                            f"no healthy replica for replay of {gid} "
                            f"(last death: {why})"), reason="no_replica")
        except GeneratorExit:
            # client hung up: cancel every live attempt (the replicas
            # free their slots at the next tick) and record the outcome
            retire_all()
            self.stats.bump("requests_abandoned")
            if not self.journal.has_terminal(gid):
                self.journal.terminal(gid, "abandoned",
                                      tokens=len(delivered))
            raise
        finally:
            retire_all()


# ---------------------------------------------------------------------------
# HTTP front-end (mirrors serve/frontend.py)
# ---------------------------------------------------------------------------

class _GatewayHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.0"
    server_version = "lpt-gateway/1"

    @property
    def gateway(self) -> Gateway:
        return self.server.gateway  # type: ignore[attr-defined]

    def log_message(self, fmt, *args):
        logger.debug("http %s", fmt % args)

    def _send_json(self, code: int, payload: dict,
                   headers: dict | None = None) -> None:
        body = (json.dumps(payload) + "\n").encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            return self._send_json(200, self.gateway.healthz())
        if self.path == "/replicas":
            return self._send_json(200, self.gateway.directory.snapshot())
        return self._send_json(404, {"error": f"no route {self.path}"})

    @staticmethod
    def _ids(handle: GatewayHandle) -> dict:
        return {"request_id": handle.gid,
                "trace_id": handle.trace.trace_id}

    def _headers(self, handle: GatewayHandle,
                 extra: dict | None = None) -> dict:
        headers = {"X-Request-Id": handle.gid,
                   "X-Trace-Id": handle.trace.trace_id,
                   "traceparent": handle.trace.traceparent()}
        if extra:
            headers.update(extra)
        return headers

    def do_POST(self):
        if self.path != "/v1/generate":
            return self._send_json(404, {"error": f"no route {self.path}"})
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            handle = self.gateway.submit(body,
                                         self.headers.get("traceparent"))
        except (ValueError, TypeError) as e:
            return self._send_json(400, {"error": str(e)})
        except GatewayOverloaded as e:
            retry = max(1, int(-(-e.retry_after_s // 1)))
            return self._send_json(
                e.code, {"error": str(e)},
                headers={"Retry-After": str(retry)})

        stream = bool(body.get("stream"))
        it = handle.tokens()
        # pull the first token BEFORE committing a 200: pre-stream
        # failures (shed, reject, upstream budget) keep their honest
        # status code; a zero-token completion is a 200 with no tokens
        try:
            first = next(it, None)
        except GatewayOverloaded as e:
            retry = max(1, int(-(-e.retry_after_s // 1)))
            return self._send_json(
                e.code, {"error": str(e), **self._ids(handle)},
                headers=self._headers(handle,
                                      {"Retry-After": str(retry)}))
        except GatewayRejected as e:
            return self._send_json(400, {"error": str(e),
                                         **self._ids(handle)},
                                   headers=self._headers(handle))
        except GatewayError as e:
            return self._send_json(500, {"error": repr(e),
                                         **self._ids(handle)},
                                   headers=self._headers(handle))

        def tail(error: str | None = None) -> dict:
            out = {"done": True, **self._ids(handle),
                   "tokens": handle.tokens_out, **handle.info}
            if error is not None:
                out["error"] = error
            return out

        if not stream:
            try:
                for _ in it:
                    pass
            except GatewayError as e:
                return self._send_json(500, {"error": repr(e),
                                             **self._ids(handle)},
                                       headers=self._headers(handle))
            return self._send_json(
                200, {**self._ids(handle), "tokens": handle.tokens_out,
                      **handle.info},
                headers=self._headers(handle))

        self.send_response(200)
        self.send_header("Content-Type", "application/jsonlines")
        for name, value in self._headers(handle).items():
            self.send_header(name, value)
        self.end_headers()
        try:
            if first is not None:
                line = {"token": first, **self._ids(handle)}
                self.wfile.write((json.dumps(line) + "\n").encode())
                self.wfile.flush()
                for token in it:
                    self.wfile.write(
                        (json.dumps({"token": token}) + "\n").encode())
                    self.wfile.flush()
            out = tail()
        except OSError:
            # client hung up mid-stream: closing the iterator cancels
            # the live attempts and journals the abandonment
            logger.debug("client disconnected during stream of %s",
                         handle.gid)
            handle.close()
            return
        except GatewayError as e:
            out = tail(error=repr(e))
        try:
            self.wfile.write((json.dumps(out) + "\n").encode())
        except OSError:
            logger.debug("client disconnected during stream tail of %s",
                         handle.gid)
            handle.close()


def make_gateway_server(gateway: Gateway, host: str = "127.0.0.1",
                        port: int = 0) -> ThreadingHTTPServer:
    """Bound (not yet serving) HTTP server; port 0 picks an ephemeral
    port — read the bound one off `server.server_address`."""
    server = ThreadingHTTPServer((host, port), _GatewayHandler)
    server.gateway = gateway  # type: ignore[attr-defined]
    server.daemon_threads = True
    return server
