"""The port's request-durable gateway (llama_pipeline_parallel_tpu_torch/serve/gateway.py,
tools/gateway.py) held to the JAX package's serve/gateway.py.

- Scripted stand-in replicas (the reference tests' FakeReplica: the serve
  front-end's wire protocol without an engine), one set per package: the
  same client streams, attempt counts, WAL rows (timestamps and trace ids
  aside) and counters for a kill mid-stream spliced onto a survivor, a
  divergent replay refused, a hedge won by the second replica, a 429 whose
  Retry-After cools the replica, a spent backoff budget, a 400, a zero-token
  stream, and a planted `gateway_dispatch` fault; the same HTTP lines from
  both packages' handlers.
- The one-way import rule: the port's serve/__init__ and tools/serve.py do
  not import the gateway; tools/request_report.py takes the WAL's name from
  it.
- The SIGKILL-and-replay acceptance on the CPU: two supervised
  `tools.serve` replicas of a tiny checkpoint, `tools.gateway` over the fleet
  registry, four streamed requests, replica a SIGKILLed mid-stream: every
  client gets exactly the tokens of an in-process `generate` on the same
  checkpoint, the WAL has one terminal row a request and the replay's
  `routed` row, a's supervisor relaunches it, the fleet aggregator records a's
  stale heartbeat firing then resolving, and a's relaunch consumes exactly one
  capture trigger.
"""

import ast
import glob
import importlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

import torch_resilience as tr
from llama_pipeline_parallel_tpu_torch.serve import gateway as t_gw
from llama_pipeline_parallel_tpu_torch.serve.telemetry import GATEWAY_COUNTER_KEYS
from llama_pipeline_parallel_tpu_torch.utils import faults as t_faults
from llama_pipeline_parallel_tpu_torch.utils import fleet as t_fleet
from llama_pipeline_parallel_tpu_torch.utils import retry as t_retry

REPO = tr.REPO


@pytest.fixture(scope="session")
def ref():
    """The JAX package's gateway, faults, fleet and retry modules, after
    installing the stand-in for `jax._src.sharding_impls.TransferToMemoryKind`
    where this jax lacks it."""
    import jax._src.sharding_impls as impls

    if not hasattr(impls, "TransferToMemoryKind"):
        class TransferToMemoryKind:
            def __init__(self, memory_kind):
                self.memory_kind = memory_kind

        impls.TransferToMemoryKind = TransferToMemoryKind
    mods = {"gw": "serve.gateway", "faults": "utils.faults", "fleet": "utils.fleet",
            "retry": "utils.retry"}
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"llama_pipeline_parallel_tpu.{v}") for k, v in mods.items()})


def _port():
    return types.SimpleNamespace(gw=t_gw, faults=t_faults, fleet=t_fleet, retry=t_retry)


# -- scripted replicas (the reference tests' FakeReplica) ---------------------


class _FakeHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.0"

    def log_message(self, fmt, *args):
        pass

    def do_GET(self):
        body = json.dumps({"serving": 1, "queue_depth": 0,
                           "queue_wait_p95_ms": 0.0}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(length) or b"{}")
        server = self.server
        with server.lock:
            server.requests.append(body)
            n = len(server.requests)
        plan = server.script(body, n)
        code = plan.get("code", 200)
        if code != 200:
            payload = json.dumps({"error": plan.get("error", "no")}).encode()
            self.send_response(code)
            if plan.get("retry_after") is not None:
                self.send_header("Retry-After", str(plan["retry_after"]))
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/jsonlines")
        self.end_headers()
        tokens, die_after = plan.get("tokens", []), plan.get("die_after")
        try:
            for i, tok in enumerate(tokens):
                if die_after is not None and i >= die_after:
                    return  # the crash: the stream ends without its done line
                if plan.get("token_delay"):
                    time.sleep(plan["token_delay"])
                line = ({"token": tok, "request_id": body.get("request_id"), "trace_id": "t"}
                        if i == 0 else {"token": tok})
                self.wfile.write((json.dumps(line) + "\n").encode())
                self.wfile.flush()
            if die_after is not None and die_after >= len(tokens):
                return
            self.wfile.write((json.dumps({"done": True, "request_id": body.get("request_id"),
                                          "tokens": tokens}) + "\n").encode())
        except OSError:
            with server.lock:
                server.disconnects += 1


class FakeReplica:
    """A scripted replica: `script(body, n)` -> {"tokens", "die_after",
    "token_delay"} or {"code", "retry_after", "error"}, and the discovery
    files (serve.json, health.json) a live replica keeps."""

    def __init__(self, outdir, script):
        self.output_dir = outdir
        self.server = ThreadingHTTPServer(("127.0.0.1", 0), _FakeHandler)
        self.server.script, self.server.requests = script, []
        self.server.disconnects, self.server.lock = 0, threading.Lock()
        self.server.daemon_threads = True
        self.port = self.server.server_address[1]
        threading.Thread(target=self.server.serve_forever, daemon=True).start()
        os.makedirs(outdir, exist_ok=True)
        t_fleet.write_json_atomic(os.path.join(outdir, "serve.json"),
                                  {"pid": os.getpid(), "host": "127.0.0.1", "port": self.port})
        t_fleet.write_json_atomic(os.path.join(outdir, "health.json"),
                                  {"time": time.time(), "role": "serve"})

    def close(self):
        self.server.shutdown()


SCENARIOS = {
    "midstream_kill": (lambda b, n: {"tokens": [1, 2, 3, 4, 5, 6], "die_after": 3},
                       lambda b, n: {"tokens": [1, 2, 3, 4, 5, 6]}, {"watermark_every": 1}),
    "divergent_splice": (lambda b, n: {"tokens": [1, 2, 3, 4], "die_after": 2},
                         lambda b, n: {"tokens": [1, 9, 3, 4]}, {}),
    "hedge": (lambda b, n: {"tokens": [1, 2, 3], "token_delay": 1.0},
              lambda b, n: {"tokens": [1, 2, 3]}, {"hedge": 0.1}),
    "retry_after": (lambda b, n: {"code": 429, "retry_after": 5.0, "error": "full"},
                    lambda b, n: {"tokens": [7, 8, 9]}, {}),
    "budget_spent": (lambda b, n: {"code": 429, "retry_after": 0.01, "error": "full"},
                     lambda b, n: {"code": 503, "retry_after": 0.01, "error": "drain"},
                     {"policy": (2, 0.01, 0.02)}),
    "rejected_400": (lambda b, n: {"code": 400, "error": "bad shape"},
                     lambda b, n: {"tokens": [1]}, {}),
    "zero_tokens": (lambda b, n: {"tokens": []}, lambda b, n: {"tokens": [1]}, {}),
    "dispatch_fault": (lambda b, n: {"tokens": [4, 5, 6]},
                       lambda b, n: {"tokens": [4, 5, 6]}, {"fault": True}),
}
COUNTERS = [k for k in GATEWAY_COUNTER_KEYS if k not in ("inflight_total",)]


def _gateway(mods, root, replicas, **kw):
    attempts, base, cap = kw.pop("policy", (4, 0.01, 0.05))
    directory = mods.gw.ReplicaDirectory(replica_dirs=tuple(r.output_dir for r in replicas),
                                         stale_s=60.0, probe_every_s=0.05, probe_timeout_s=1.0)
    return mods.gw.Gateway(os.path.join(root, "gw"), directory,
                           policy=mods.retry.RetryPolicy(max_attempts=attempts,
                                                         base_delay_s=base, max_delay_s=cap),
                           route_wait_s=5.0, **kw)


def _wal(root):
    rows = tr.jsonl(os.path.join(root, "gw", t_gw.JOURNAL_NAME))
    return [{k: v for k, v in r.items() if k not in ("ts", "trace_id")} for r in rows]


def _drive(mods, root, scenario):
    script_a, script_b, kw = SCENARIOS[scenario]
    kw = dict(kw)
    fault = kw.pop("fault", False)
    a = FakeReplica(os.path.join(root, "a"), script_a)
    b = FakeReplica(os.path.join(root, "b"), script_b)
    if fault:
        mods.faults.configure({"faults": [{"site": "gateway_dispatch", "op": "error",
                                           "times": 1}]})
    try:
        gw = _gateway(mods, root, [a, b], **kw)
        handle = gw.submit({"input_ids": [5, 6], "max_new_tokens": 6, "seed": 3})
        stream = []
        try:
            for tok in handle.tokens():
                stream.append(tok)
            outcome = "ok"
        except mods.gw.GatewayError as e:
            outcome = (type(e).__name__, getattr(e, "code", None))
        snap = gw.healthz()
        gw.close()
        return {"stream": stream, "outcome": outcome, "info": handle.info, "wal": _wal(root),
                "counters": {k: snap.get(k) for k in COUNTERS},
                "cooling": {n: r["cooling_s"] > 1 for n, r in snap["replicas"].items()},
                "posted": (len(a.server.requests), len(b.server.requests))}
    finally:
        mods.faults.configure(None)
        a.close()
        b.close()


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_gateway_matches_reference(ref, tmp_path, scenario):
    want = _drive(ref, str(tmp_path / "ref"), scenario)
    got = _drive(_port(), str(tmp_path / "port"), scenario)
    assert got == want
    expect = {"midstream_kill": ([1, 2, 3, 4, 5, 6], "ok"),
              "divergent_splice": ([1, 2], ("SpliceDiverged", None)),
              "hedge": ([1, 2, 3], "ok"), "retry_after": ([7, 8, 9], "ok"),
              "budget_spent": ([], ("GatewayOverloaded", 503)),
              "rejected_400": ([], ("GatewayRejected", None)),
              "zero_tokens": ([], "ok"), "dispatch_fault": ([4, 5, 6], "ok")}[scenario]
    assert (got["stream"], got["outcome"]) == expect
    kinds = [r["kind"] for r in got["wal"]]
    assert kinds.count("intent") == kinds.count("terminal") == 1
    if scenario == "midstream_kill":
        assert got["info"] == {"attempts": 2, "replays": 1, "hedges": 0}
        assert [r["replica"] for r in got["wal"] if r["kind"] == "routed"] == ["a", "b"]
    if scenario == "hedge":
        assert [r["hedge"] for r in got["wal"] if r["kind"] == "routed"] == [False, True]


def _http_lines(mods, root):
    a = FakeReplica(os.path.join(root, "a"),
                    lambda b, n: {"tokens": [1, 2, 3, 4], "die_after": 2})
    b = FakeReplica(os.path.join(root, "b"), lambda b, n: {"tokens": [1, 2, 3, 4]})
    gw = _gateway(mods, root, [a, b])
    server = mods.gw.make_gateway_server(gw)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        resp = urllib.request.urlopen(urllib.request.Request(
            f"{url}/v1/generate", data=json.dumps({"input_ids": [5, 6], "seed": 3,
                                                   "stream": True}).encode()), timeout=60)
        lines = [json.loads(x) for x in resp.read().splitlines()]
        assert lines[0]["request_id"] == resp.headers["X-Request-Id"]
        body = json.load(urllib.request.urlopen(urllib.request.Request(
            f"{url}/v1/generate", data=json.dumps({"input_ids": [7], "seed": 1}).encode()),
            timeout=60))
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(urllib.request.Request(
                f"{url}/v1/generate", data=json.dumps({"input_ids": "no"}).encode()),
                timeout=10)
        health = json.load(urllib.request.urlopen(f"{url}/healthz", timeout=10))
        drop = ("request_id", "trace_id")
        return ([{k: v for k, v in x.items() if k not in drop} for x in lines],
                {k: v for k, v in body.items() if k not in drop}, err.value.code,
                sorted(health), {k: health[k] for k in COUNTERS if k in health})
    finally:
        server.shutdown()
        gw.close()
        a.close()
        b.close()


def test_http_handler_matches_reference(ref, tmp_path):
    """The gateway's own HTTP surface: the streamed lines of a request
    spliced across a kill, a non-streamed body, a 400 and /healthz."""
    got = _http_lines(_port(), str(tmp_path / "port"))
    assert got == _http_lines(ref, str(tmp_path / "ref"))
    assert [x.get("token") for x in got[0][:-1]] == [1, 2, 3, 4] and got[2] == 400


def test_direct_path_never_imports_the_gateway():
    """serve/__init__ and tools/serve.py of the port stay gateway-free (the
    one-way rule the reference pins), and request_report reads the WAL by
    the gateway's own name."""
    from llama_pipeline_parallel_tpu_torch.tools import request_report

    pkg = os.path.join(REPO, "llama_pipeline_parallel_tpu_torch")
    for rel in (os.path.join("serve", "__init__.py"), os.path.join("tools", "serve.py")):
        tree = ast.parse(open(os.path.join(pkg, rel)).read())
        names = [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        names += [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        assert not any("gateway" in name for name in names), rel
    assert request_report.JOURNAL_NAME is t_gw.JOURNAL_NAME


# -- the SIGKILL-and-replay acceptance -----------------------------------------

N_NEW = 24


def _serve_cmd(ckpt, out):
    return [sys.executable, "-m", "llama_pipeline_parallel_tpu_torch.tools.serve",
            "--device", "cpu", "--checkpoint_dir", ckpt, "--output_dir", out,
            "--port", "0", "--max_slots", "2", "--max_len", "64", "--buckets", "8",
            "--metrics_every", "1", "--health_interval", "0.25", "--drain_s", "5"]


def _wait_json(path, timeout_s=120.0, changed_from=None, key="pid"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            with open(path) as f:
                info = json.load(f)
            if changed_from is None or info.get(key) != changed_from:
                return info
        except (OSError, ValueError):
            pass
        time.sleep(0.05)
    raise AssertionError(f"{path} never appeared")


def _kill_mid_stream(journal, replica_dir, replica, stop, killed):
    """SIGKILL `replica` (its serve.json pid) once a stream routed to it has
    a delivered-token watermark in the gateway's WAL, so the kill lands
    mid-stream whatever the machine's load; the pid goes to `killed`."""
    from llama_pipeline_parallel_tpu_torch.tools import serve_traffic

    on = {}
    while not stop.is_set():
        try:
            rows = tr.jsonl(journal)
        except (OSError, ValueError):  # not there yet, or a row half written
            rows = []
        for r in rows:
            if r["kind"] == "routed":
                on[r["gid"]] = r["replica"]
            elif r["kind"] == "watermark" and on.get(r["gid"]) == replica:
                killed.append(serve_traffic.kill_replica(replica_dir))
                return
        time.sleep(0.01)


def _refresh_until(agg, pred, what, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        status = agg.refresh()
        if pred(status):
            return status
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def test_sigkill_mid_stream_replays_exact_tokens(tmp_path):
    from llama_pipeline_parallel_tpu_torch.ckpt.checkpoint import (
        CheckpointManager,
        load_module_checkpoint,
    )
    from llama_pipeline_parallel_tpu_torch.models.llama import decode as td
    from llama_pipeline_parallel_tpu_torch.models.llama import model as t_llama
    from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig
    from llama_pipeline_parallel_tpu_torch.models.llama.manifest import StageManifest
    from llama_pipeline_parallel_tpu_torch.tools import serve_traffic

    cfg = LlamaConfig.tiny()
    ckpt, fleet_root = str(tmp_path / "ckpt"), str(tmp_path / "fleet")
    CheckpointManager(ckpt).save(0, t_llama.init_params(cfg, seed=0, device="cpu"),
                                 StageManifest(num_layers=cfg.num_hidden_layers, num_stages=1),
                                 cfg)
    procs, replicas = {}, {n: str(tmp_path / n) for n in ("a", "b")}
    try:
        for name, out in replicas.items():
            # a's relaunch probes the devices for 2 s (a slow probe): the
            # window in which its stale heartbeat shows
            plan = {"faults": [{"site": "device_probe", "op": "stall", "seconds": 2.0,
                                "after": 1}]}
            env = tr.env(LPT_DEVICE_COUNT="1", LPT_FAULT_PLAN=json.dumps(plan),
                         LPT_SERVE_STEP_DELAY_S="0.1" if name == "a" else "0")
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "llama_pipeline_parallel_tpu_torch.tools.supervisor",
                 "--output-dir", out, "--fleet-root", fleet_root, "--role", "serve",
                 "--replica", name, "--poll-s", "0.1", "--hang-timeout-s", "120",
                 "--layout-ladder", json.dumps([{"name": "one", "devices": 1}]), "--",
                 *_serve_cmd(ckpt, out)], cwd=REPO, env=env, stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL)
        gw_out = str(tmp_path / "gw")
        procs["gw"] = subprocess.Popen(
            [sys.executable, "-m", "llama_pipeline_parallel_tpu_torch.tools.gateway",
             "--output_dir", gw_out, "--fleet_root", fleet_root, "--stale_s", "60",
             "--retry_attempts", "6", "--retry_base_delay_s", "0.05",
             "--metrics_every_s", "0.5"], cwd=REPO, env=tr.env(),
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        info = {n: _wait_json(os.path.join(out, "serve.json")) for n, out in replicas.items()}
        for out in replicas.values():  # both answer before traffic starts
            _wait_json(os.path.join(out, "health.json"), key="port")
        gw_port = _wait_json(os.path.join(gw_out, t_gw.GATEWAY_JSON_NAME))["port"]
        agg = t_fleet.FleetAggregator(fleet_root, t_fleet.AlertRules(heartbeat_stale_s=1.0))
        assert "heartbeat_stale:serve:a" not in agg.refresh()["pod"]["alerts_firing"]

        reqs = serve_traffic.poisson_trace(7, 8.0, 4, serve_traffic.parse_mix("5"),
                                           serve_traffic.parse_mix(str(N_NEW)))
        # a is killed after 8 of a stream's 24 tokens reached its client (the
        # gateway's first watermark), 1.6 s of a's delayed ticks before its end
        stop, killed = threading.Event(), []
        killer = threading.Thread(target=_kill_mid_stream, daemon=True, args=(
            os.path.join(gw_out, t_gw.JOURNAL_NAME), replicas["a"], "a", stop, killed))
        killer.start()
        try:
            summary = serve_traffic.run_trace_gateway(
                f"http://127.0.0.1:{gw_port}", reqs, vocab=cfg.vocab_size,
                collect_tokens=True, result_timeout_s=120.0)
        finally:
            stop.set()
            killer.join()
        assert killed and killed[0] == info["a"]["pid"], (killed, summary)
        stale = _refresh_until(agg, lambda s: "heartbeat_stale:serve:a"
                               in s["pod"]["alerts_firing"], "a's stale heartbeat")
        assert stale["members"]["serve:b"]["heartbeat_age_s"] < 1.0

        # the requests' prompts as serve_traffic drew them, left-padded to the
        # bucket, in one generate call (a row's tokens do not depend on its batch)
        params, cfg, _, _ = load_module_checkpoint(ckpt, device="cpu")
        prompts = [np.random.RandomState(r.seed).randint(3, cfg.vocab_size,
                                                         size=r.prompt_len).tolist()
                   for r in reqs]
        out = td.generate(td.compute_params(params, cfg),
                          np.asarray([[0] * (8 - len(p)) + p for p in prompts]),
                          np.asarray([[0] * (8 - len(p)) + [1] * len(p) for p in prompts]),
                          cfg, td.GenerationConfig(max_new_tokens=N_NEW),
                          generator=[torch.Generator().manual_seed(r.seed) for r in reqs])
        assert summary["tokens"] == out["tokens"].tolist()
        assert summary["completed"] == 4 and summary["replayed"] >= 1, summary

        rows = tr.jsonl(os.path.join(gw_out, t_gw.JOURNAL_NAME))
        terminals = [r for r in rows if r["kind"] == "terminal"]
        assert sorted(r["gid"] for r in terminals) == sorted(
            r["gid"] for r in rows if r["kind"] == "intent")
        assert all(r["outcome"] == "completed" for r in terminals)
        replayed = {r["gid"] for r in rows if r["kind"] == "watermark"} & {
            r["gid"] for r in rows if r["kind"] == "routed" and r["attempt"] > 1}
        assert replayed, "no replay routed row after a delivered watermark"

        # a's supervisor relaunches it; the alert resolves, and the relaunch
        # consumes the one capture trigger the firing edge dropped
        _wait_json(os.path.join(replicas["a"], "serve.json"), changed_from=info["a"]["pid"])
        _refresh_until(agg, lambda s: "heartbeat_stale:serve:a"
                       not in s["pod"]["alerts_firing"], "the alert to resolve")
        captures = os.path.join(replicas["a"], "captures", "*")
        deadline = time.monotonic() + 30
        while not glob.glob(captures) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert len(glob.glob(captures)) == 1
        assert not os.path.exists(os.path.join(replicas["a"], t_fleet.CAPTURE_TRIGGER_NAME))
        edges = [e["state"] for e in t_fleet.read_alerts(fleet_root)
                 if e["alert"] == "heartbeat_stale" and e["member"] == "serve:a"]
        assert edges == ["firing", "resolved"]
        ledger = tr.jsonl(os.path.join(replicas["a"], "incarnations.jsonl"))
        assert ledger[0]["outcome"] == "crash"
    finally:
        from llama_pipeline_parallel_tpu_torch.tools import supervisor as t_sup

        below = {name: t_sup._descendants(proc.pid) for name, proc in procs.items()}
        for proc in procs.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for name, proc in procs.items():
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            for pid, start in below[name]:  # nothing the test started outlives it
                if t_sup._alive(pid, start):
                    os.kill(pid, signal.SIGKILL)
