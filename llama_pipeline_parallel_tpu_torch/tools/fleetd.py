"""Fleet observatory daemon: the live rollup of a supervised pod (the
counterpart of the JAX package's tools/fleetd.py; it touches no device).

Points a `utils/fleet.FleetAggregator` at a `--fleet-root` (where every
supervisor launched with the same flag registers its members), refreshes
it on a fixed cadence — each refresh tails the members' health/metrics/
incarnation streams INCREMENTALLY, rewrites `fleet_status.json`
atomically, evaluates the `alerts.*` rules, appends firing/resolved edges
to `alerts.jsonl`, and drops `capture.trigger` files into alerting
members' output dirs — and serves the rollup live over stdlib HTTP (the
serve/frontend.py style: dependency-free):

  GET /fleet     the full fleet_status.json payload (latest refresh)
  GET /healthz   {"time", "refresh_count", "members", "alerts_firing"}

Usage:
  python -m llama_pipeline_parallel_tpu_torch.tools.fleetd --fleet-root /runs/fleet1 --port 8900 \
      --refresh-s 2 --alerts '{"heartbeat_stale_s": 30, "ttft_p95_ms": 500}'

`--alerts` takes inline JSON or `@/path/to/alerts.json` (unknown keys
rejected — the config-block house rule). A `tenant_ttft_p95_ms`
threshold fans out per tenant: one `tenant_ttft_p95:<tenant>` rule
instance per tenant found in a member's serving snapshot, all sharing
the one configured threshold. `--once` performs a single
refresh, prints the status JSON, and exits (cron / CI probes).
SIGTERM/SIGINT exit cleanly after the current refresh. Alert edges are
echoed to stdout as they happen, so a supervisor-of-supervisors log shows
the pod's incident timeline without opening a file.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


from llama_pipeline_parallel_tpu_torch.utils.actions import (
    ACTIONS_NAME,
)
from llama_pipeline_parallel_tpu_torch.utils.fleet import (
    AlertRules,
    FleetAggregator,
    JsonlTailer,
)


class _FleetHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.0"
    server_version = "lpt-fleetd/1"

    def log_message(self, fmt, *args):  # stdlib default spams stderr
        pass

    def _send_json(self, code: int, payload: dict) -> None:
        body = (json.dumps(payload, indent=2) + "\n").encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        status = self.server.fleet_status()  # type: ignore[attr-defined]
        if self.path == "/fleet":
            if status is None:
                return self._send_json(503, {"error": "no refresh yet"})
            return self._send_json(200, status)
        if self.path == "/healthz":
            if status is None:
                return self._send_json(200, {"time": time.time(),
                                             "refresh_count": 0,
                                             "members": 0,
                                             "alerts_firing": []})
            return self._send_json(200, {
                "time": status["time"],
                "refresh_count": status["refresh_count"],
                "members": len(status["members"]),
                "alerts_firing": status["pod"]["alerts_firing"]})
        return self._send_json(404, {"error": f"no route {self.path}"})


def make_server(agg: FleetAggregator, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Bound (not yet serving) HTTP server over the aggregator's LATEST
    snapshot — handler threads never touch the aggregator itself (it is
    single-threaded); they read the last refresh under a lock."""
    server = ThreadingHTTPServer((host, port), _FleetHandler)
    server.daemon_threads = True
    lock = threading.Lock()

    def fleet_status():
        with lock:
            return agg.last_status

    server.fleet_status = fleet_status  # type: ignore[attr-defined]
    server.status_lock = lock           # type: ignore[attr-defined]
    return server


def _parse_alerts(spec: str | None) -> AlertRules:
    if not spec:
        return AlertRules()
    raw = spec.strip()
    if raw.startswith("@"):
        with open(raw[1:]) as f:
            node = json.load(f)
    else:
        node = json.loads(raw)
    return AlertRules.from_cfg(node)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--fleet-root", required=True,
                   help="the registry/status/alerts home every supervisor "
                        "was pointed at with its own --fleet-root")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="0 picks an ephemeral port (printed at startup)")
    p.add_argument("--refresh-s", type=float, default=2.0,
                   help="aggregation cadence (each refresh is incremental)")
    p.add_argument("--alerts", default=None,
                   help="alert thresholds: inline JSON or @/path/to/"
                        "alerts.json with alerts.* keys")
    p.add_argument("--no-capture", action="store_true",
                   help="evaluate alerts but never drop capture.trigger "
                        "files into member dirs")
    p.add_argument("--once", action="store_true",
                   help="one refresh, print the status JSON, exit")
    args = p.parse_args(argv)

    try:
        rules = _parse_alerts(args.alerts)
    except (OSError, ValueError) as e:
        raise SystemExit(f"fleetd: bad --alerts: {e}")
    agg = FleetAggregator(args.fleet_root, rules,
                          capture_on_alert=not args.no_capture)

    if args.once:
        status = agg.refresh()
        print(json.dumps(status, indent=2))
        return 0

    server = make_server(agg, args.host, args.port)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="fleetd-http").start()
    print(f"[fleetd] watching {args.fleet_root} — GET http://{args.host}:"
          f"{port}/fleet every {args.refresh_s:.1f}s", flush=True)

    stop = threading.Event()

    def _stop(signum, _frame):
        print(f"[fleetd] signal {signum}: exiting after this refresh",
              flush=True)
        stop.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _stop)
        except ValueError:  # not the main thread (in-process tests)
            pass

    # tools.fleetctl's action journal, echoed next to the alert edges
    # that caused the actions — the pod's incident AND response timeline in
    # one log. No actuator running -> no file -> poll() is a no-op.
    actions_tail = JsonlTailer(os.path.join(args.fleet_root, ACTIONS_NAME))
    try:
        while not stop.is_set():
            with server.status_lock:  # type: ignore[attr-defined]
                status = agg.refresh()
            for edge in status["alert_edges_last_refresh"]:
                print(f"[fleetd] alert {edge['state'].upper()}: "
                      f"{edge['alert']} on {edge['member']} "
                      f"(value={edge['value']} threshold={edge['threshold']})",
                      flush=True)
            for row in actions_tail.poll():
                if row.get("phase") == "intent":
                    print(f"[fleetd] action INTENT: {row.get('kind')} "
                          f"{row.get('id')} params={row.get('params')}"
                          + (f" alert={row['alert']}"
                             if row.get("alert") else ""), flush=True)
                elif row.get("phase") == "outcome":
                    print(f"[fleetd] action "
                          f"{str(row.get('outcome', '?')).upper()}: "
                          f"{row.get('kind')} {row.get('id')}", flush=True)
            stop.wait(args.refresh_s)
    finally:
        server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
