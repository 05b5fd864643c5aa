"""Run the request-durable gateway tier in front of N serve replicas.

The supervised-process wrapper over serve/gateway.py (the counterpart of
the JAX package's tools/gateway.py; it touches no device): discovers
replicas live from the fleet
registry (role="serve" rows) and/or explicitly named output dirs,
journals every accepted request to `<output_dir>/gateway_journal.jsonl`
before dispatch, reconciles orphaned intents left by a previous
incarnation at startup, and serves:

  POST /v1/generate   the serve front-end's API, routed + durable:
                      health-aware replica choice, bounded retry with
                      Retry-After honored, bit-exact replay + stream
                      splice when a replica dies mid-request, optional
                      hedged dispatch (--hedge).
  GET  /healthz       gateway gauges (telemetry.GATEWAY_COUNTER_KEYS) +
                      per-replica routing state.
  GET  /replicas      the routing table alone.

Telemetry follows the serve replica's shape: `gateway.json` (atomic;
pid/host/port/started), a health.json heartbeat (role="gateway"), and
periodic metrics.jsonl lines marked `"gateway": 1` the fleet aggregator
rolls up (utils/fleet._GATEWAY_FIELDS). SIGTERM drains: new submits shed
with 503 + Retry-After while in-flight requests finish.

Example:

  python -m llama_pipeline_parallel_tpu_torch.tools.gateway --output_dir /tmp/gw \\
      --fleet_root /tmp/fleet --port 8100 --hedge auto
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
import time


from llama_pipeline_parallel_tpu_torch.serve.gateway import (
    GATEWAY_JSON_NAME,
    Gateway,
    ReplicaDirectory,
    make_gateway_server,
)
from llama_pipeline_parallel_tpu_torch.utils import fleet, trace
from llama_pipeline_parallel_tpu_torch.utils.metrics import MetricsWriter
from llama_pipeline_parallel_tpu_torch.utils.retry import RetryPolicy


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--output_dir", required=True,
                   help="gateway home: journal/metrics/health/gateway.json")
    p.add_argument("--fleet_root", default=None,
                   help="fleet registry root; serve members are discovered "
                        "live from its registry.jsonl")
    p.add_argument("--replica_dirs", default=None,
                   help="comma-separated serve output dirs (instead of, or "
                        "in addition to, --fleet_root discovery)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="0 picks an ephemeral port (recorded in "
                        "gateway.json)")
    p.add_argument("--replica", default=None,
                   help="fleet member name (default: output dir basename)")
    p.add_argument("--stale_s", type=float, default=15.0,
                   help="replica heartbeat age beyond which it is not "
                        "routed to (<=0 disables the check)")
    p.add_argument("--hedge", default="off",
                   help="'off', 'auto' (p95-derived delay), or a fixed "
                        "delay in seconds for the second attempt")
    p.add_argument("--retry_attempts", type=int, default=4,
                   help="total dispatch tries per request (backoffs and "
                        "mid-stream deaths both draw on this budget)")
    p.add_argument("--retry_base_delay_s", type=float, default=0.05)
    p.add_argument("--request_timeout_s", type=float, default=120.0)
    p.add_argument("--watermark_every", type=int, default=8,
                   help="journal a tokens-delivered watermark row every N "
                        "streamed tokens")
    p.add_argument("--no_reconcile", action="store_true",
                   help="skip startup reconciliation of orphaned WAL "
                        "intents (they stay orphaned)")
    p.add_argument("--drain_s", type=float, default=10.0)
    p.add_argument("--health_interval", type=float, default=5.0)
    p.add_argument("--metrics_every_s", type=float, default=2.0)
    args = p.parse_args(argv)

    replica_dirs = tuple(d for d in (args.replica_dirs or "").split(",")
                         if d.strip())
    if not args.fleet_root and not replica_dirs:
        p.error("need --fleet_root and/or --replica_dirs")

    t_start = time.time()
    os.makedirs(args.output_dir, exist_ok=True)
    directory = ReplicaDirectory(fleet_root=args.fleet_root,
                                 replica_dirs=replica_dirs,
                                 stale_s=args.stale_s)
    hedge: str | float = args.hedge
    if hedge not in ("off", "auto"):
        hedge = float(hedge)
    gw = Gateway(
        args.output_dir, directory,
        policy=RetryPolicy.from_env(max_attempts=args.retry_attempts,
                                    base_delay_s=args.retry_base_delay_s,
                                    max_delay_s=5.0),
        hedge=hedge, watermark_every=args.watermark_every,
        request_timeout_s=args.request_timeout_s)

    directory.poll()
    if not args.no_reconcile:
        # a previous incarnation's orphaned intents get their terminal
        # outcome BEFORE new traffic: re-polled from replica traces when
        # the request finished without us, replayed headless otherwise
        reconciled = gw.reconcile()
        if reconciled:
            print(f"[gateway] reconciled {len(reconciled)} orphaned "
                  f"intent(s): "
                  + ", ".join(f"{r['gid']}={r['outcome']}"
                              for r in reconciled), flush=True)

    server = make_gateway_server(gw, args.host, args.port)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="gateway-http").start()

    name = args.replica or os.path.basename(
        os.path.normpath(args.output_dir))
    fleet.write_json_atomic(
        os.path.join(args.output_dir, GATEWAY_JSON_NAME),
        {"pid": os.getpid(), "host": args.host, "port": port,
         "fleet_root": args.fleet_root, "replica_dirs": list(replica_dirs),
         "started": t_start})
    if args.fleet_root:
        fleet.register_member(args.fleet_root, output_dir=args.output_dir,
                              role="gateway", replica=name,
                              pid=os.getpid())
    hb = trace.Heartbeat(args.output_dir, interval=args.health_interval,
                         static={"role": "gateway", "port": port})
    writer = MetricsWriter(args.output_dir)

    stop = threading.Event()

    def _stop(signum, _frame):
        print(f"[gateway] signal {signum}: draining to clean exit",
              flush=True)
        stop.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _stop)

    known = len(directory.all())
    print(f"[gateway] ready on {args.host}:{port} — {known} replica(s) "
          f"known, hedge={args.hedge}, "
          f"retry_attempts={args.retry_attempts}", flush=True)

    def metrics_line() -> dict:
        snap = gw.healthz()
        snap.pop("replicas", None)  # nested routing table: /healthz only
        snap.pop("inflight", None)
        return snap

    tick = 0
    try:
        while not stop.is_set():
            directory.poll()
            tick += 1
            hb.beat(tick)
            writer.log(tick, metrics_line())
            stop.wait(max(args.metrics_every_s, 0.1))
        # drain: shed new submits with an honest 503 while in-flight
        # streams (and their replays) finish
        gw.draining = True
        deadline = time.monotonic() + args.drain_s
        while (gw.stats.snapshot().get("inflight_total", 0)
               and time.monotonic() < deadline):
            time.sleep(0.05)
        left = gw.stats.snapshot().get("inflight_total", 0)
        if left:
            print(f"[gateway] drain window ({args.drain_s:.0f}s) expired "
                  f"with {left} dispatch(es) in flight", flush=True)
    finally:
        server.shutdown()
        writer.log(tick + 1, metrics_line())
        writer.close()
        gw.close()
        hb.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
