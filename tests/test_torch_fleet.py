"""The port's fleet observatory (llama_pipeline_parallel_tpu_torch/utils/fleet.py,
tools/fleetd.py, tools/fleet_report.py) held to the JAX package's.

The same scripted pod is written into two roots: a trainer, its supervisor,
two serve replicas (one with tenants and a prefix cache, one with an OOM
snapshot and a crash / resize in its ledger), a gateway and a dead member.
Each package's FleetAggregator refreshes its own root three times while the
members' streams grow, one is truncated and a member relaunches: the same
fleet_status.json (timestamps and the root's path aside), the same alert
edges, the same capture triggers and the same `bytes_read`. fleetd --once
and fleet_report give the same output over the final trees.
"""

import importlib
import json
import os
import re
import sys
import time
import types

import pytest

from llama_pipeline_parallel_tpu_torch.utils import fleet as t_fleet
from llama_pipeline_parallel_tpu_torch.utils import memwatch as t_memwatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every key whose value is a clock reading or a duration measured at refresh
TIME_KEYS = {"time", "ts", "since", "heartbeat_age_s", "start", "end", "t0", "t1",
             "elapsed_s", "started"}
RULES = {"heartbeat_stale_s": 30, "goodput_floor": 0.5, "step_time_p95_s": 2.0,
         "ttft_p95_ms": {"threshold": 400, "for_s": 0, "cooldown_s": 0},
         "queue_wait_p95_ms": 100, "tenant_ttft_p95_ms": 300,
         "prefix_hit_rate_floor": 0.5, "checkpoint_lag_steps": 1,
         "nonfinite_steps": 0, "oom_recent": 0}


@pytest.fixture(scope="session")
def ref():
    """The JAX package's fleet and actions modules and its root fleet tools,
    after installing the stand-in for `jax._src.sharding_impls
    .TransferToMemoryKind` where this jax lacks it."""
    import jax._src.sharding_impls as impls

    if not hasattr(impls, "TransferToMemoryKind"):
        class TransferToMemoryKind:
            def __init__(self, memory_kind):
                self.memory_kind = memory_kind

        impls.TransferToMemoryKind = TransferToMemoryKind
    sys.path.insert(0, os.path.join(REPO, "tools"))
    return types.SimpleNamespace(
        fleet=importlib.import_module("llama_pipeline_parallel_tpu.utils.fleet"),
        fleetd=importlib.import_module("fleetd"),
        fleet_report=importlib.import_module("fleet_report"))


def _lines(path, rows, mode="a"):
    with open(path, mode) as f:
        for row in rows:
            f.write((row if isinstance(row, str) else json.dumps(row)) + "\n")


def _json(path, payload):
    with open(path, "w") as f:
        json.dump(payload, f)


class Pod:
    """One scripted pod under `root`: `stage(n)` writes the members' files as
    they stand before refresh n (0, 1, 2), the same bytes in every root."""

    def __init__(self, root: str, now: float):
        self.root, self.now = root, now
        self.fleet_root = os.path.join(root, "fleet")
        os.makedirs(self.fleet_root, exist_ok=True)

    def out(self, name):
        d = os.path.join(self.root, name)
        os.makedirs(d, exist_ok=True)
        return d

    def register(self, name, **row):
        _lines(os.path.join(self.fleet_root, "registry.jsonl"), [{
            "ts": self.now - 5, "role": None, "replica": name,
            "output_dir": self.out(name), "pid": 1000, "incarnation": 0,
            "health_file": "health.json", **row}])

    def stage(self, n):
        now, out = self.now, self.out
        if n == 0:
            self.register("trainer", role="trainer", layout="dp2")
            self.register("trainer", role="supervisor", replica="trainer",
                          health_file="supervisor_health.json")
            _json(os.path.join(out("trainer"), "supervisor_health.json"),
                  {"time": now - 1, "role": "supervisor", "restarts": 1,
                   "consecutive_failures": 0, "last_outcome": "clean",
                   "child_pid": 1001, "watched_dir": out("trainer")})
            _json(os.path.join(out("trainer"), "health.json"),
                  {"time": now - 1, "last_step": 4, "goodput": 0.8,
                   "clock": {"elapsed": 100.0}, "topology": {"dp": 2}})
            _lines(os.path.join(out("trainer"), "metrics.jsonl"),
                   [{"step": s, "loss": 5.0 - 0.1 * s, "step_time": 0.5 + 0.1 * s,
                     "goodput": 0.8, "nonfinite_steps": 0, "anomaly_count": 0,
                     "bubble_fraction": 0.25, "mfu": 0.3} for s in range(1, 5)])
            for step, complete in ((2, True), (4, True), (6, False)):
                d = os.path.join(out("trainer"), f"checkpoint-{step}")
                os.makedirs(d, exist_ok=True)
                if complete:
                    _json(os.path.join(d, "meta.json"), {"step": step})
            for name, ttft in (("a", 120.0), ("b", 90.0)):
                self.register(name, role="serve")
                _json(os.path.join(out(name), "health.json"),
                      {"time": now - 1, "role": "serve", "last_step": 10,
                       "goodput": 0.9, "clock": {"elapsed": 50.0},
                       "checkpoint_step": 2})
                _lines(os.path.join(out(name), "metrics.jsonl"), [{
                    "step": 1, "serving": 1, "requests_completed": 3,
                    "ttft_p95_ms": ttft, "queue_wait_p95_ms": 20.0,
                    "tokens_generated": 40, "slo_breaches": 0,
                    **({"tenants": {"free": {"ttft_p95_ms": 80.0},
                                    "paid": {"ttft_p95_ms": 100.0}},
                        "prefix_hit_rate": 0.75, "prefix_hits": 3,
                        "prefix_misses": 1} if name == "a" else {})}])
            self.register("gw", role="gateway")
            _json(os.path.join(out("gw"), "health.json"),
                  {"time": now - 1, "role": "gateway"})
            _lines(os.path.join(out("gw"), "metrics.jsonl"), [{
                "step": 1, "gateway": 1, "requests_routed": 4, "requests_replayed": 1,
                "requests_completed": 4, "ttft_p95_ms": 150.0, "replicas_known": 2,
                "replicas_healthy": 2}])
            self.register("dead", role="serve", ts=now - 1000)
        elif n == 1:
            # the trainer slows, a tenant breaches, b crashes with an OOM and
            # is resized, a torn line lands on a's stream, the dead member's
            # supervisor gives up
            _lines(os.path.join(out("trainer"), "metrics.jsonl"),
                   [{"step": 5, "loss": 4.4, "step_time": 3.5, "goodput": 0.4,
                     "nonfinite_steps": 1}])
            _json(os.path.join(out("trainer"), "health.json"),
                  {"time": now - 1, "last_step": 5, "goodput": 0.4,
                   "clock": {"elapsed": 110.0}, "topology": {"dp": 2}})
            _lines(os.path.join(out("a"), "metrics.jsonl"), [{
                "step": 2, "serving": 1, "requests_completed": 6, "ttft_p95_ms": 500.0,
                "queue_wait_p95_ms": 150.0,
                "tenants": {"free": {"ttft_p95_ms": 90.0},
                            "paid": {"ttft_p95_ms": 350.0}},
                "prefix_hit_rate": 0.25}, '{"step": 3, "serving": 1, "tor'])
            _lines(os.path.join(out("b"), "incarnations.jsonl"), [
                {"incarnation": 0, "outcome": "crash", "duration_s": 10.0,
                 "layout": "dp2", "resized": False},
                {"incarnation": 1, "outcome": "oom", "duration_s": 4.0,
                 "layout": "dp1", "resized": True}])
            d = t_memwatch.oom_dir(out("b"))
            os.makedirs(d, exist_ok=True)
            _json(os.path.join(d, "oom-20260101-000000-1.json"), {"step": 3})
            os.utime(os.path.join(d, "oom-20260101-000000-1.json"), (now, now))
            self.register("dead", role="serve", ts=now - 900, outcome="aborted",
                          reason="crash_loop")
        else:
            # a's stream is rotated under the tailer, b relaunches (a newer
            # registration resolves its OOM), the torn tail is completed
            _lines(os.path.join(out("a"), "metrics.jsonl"), [{
                "step": 4, "serving": 1, "requests_completed": 9, "ttft_p95_ms": 100.0,
                "queue_wait_p95_ms": 10.0, "prefix_hit_rate": 0.8}], mode="w")
            self.register("b", role="serve", ts=now + 5, incarnation=2, pid=1002)
            _lines(os.path.join(out("trainer"), "metrics.jsonl"),
                   [{"step": 6, "loss": 4.3, "step_time": 0.6}])


def _normal(value, root, key=""):
    """`value` with the root's path replaced and every clock reading dropped:
    the time keys, and the value of a heartbeat_stale alert (an age, read
    when each package's refresh ran)."""
    if isinstance(value, dict):
        age = key.startswith("heartbeat_stale") or value.get("alert") == "heartbeat_stale"
        return {k: _normal(v, root, k) for k, v in value.items()
                if k not in TIME_KEYS and not (age and k == "value")}
    if isinstance(value, list):
        return [_normal(v, root) for v in value]
    if isinstance(value, str):
        return value.replace(root, "<root>")
    return value


def _trigger(root, name):
    path = os.path.join(root, name, t_fleet.CAPTURE_TRIGGER_NAME)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return _normal(json.load(f), root)


def test_aggregator_matches_reference_across_refreshes(ref, tmp_path):
    now = time.time()
    # roots of one length: the registry rows, and so bytes_read, hold the paths
    pods = {"ref": Pod(str(tmp_path / "refr"), now), "port": Pod(str(tmp_path / "port"), now)}
    aggs = {"ref": ref.fleet.FleetAggregator(pods["ref"].fleet_root,
                                             ref.fleet.AlertRules.from_cfg(RULES)),
            "port": t_fleet.FleetAggregator(pods["port"].fleet_root,
                                            t_fleet.AlertRules.from_cfg(RULES))}
    assert aggs["port"].rules == t_fleet.AlertRules.from_cfg(dict(RULES))
    firing_seen = set()
    for n in range(3):
        status = {}
        for side, pod in pods.items():
            pod.stage(n)
            status[side] = aggs[side].refresh()
        got, want = (_normal(status[s], pods[s].root) for s in ("port", "ref"))
        assert got == want, f"refresh {n}"
        assert status["port"]["bytes_read_total"] == status["ref"]["bytes_read_total"] > 0
        firing_seen |= set(status["port"]["pod"]["alerts_firing"])
        for name in ("trainer", "a", "b", "gw", "dead"):
            assert _trigger(pods["port"].root, name) == _trigger(pods["ref"].root, name), name
    # the script reaches every rule, and the triggers and edges landed
    assert {k.split(":")[0] for k in firing_seen} >= {
        "heartbeat_stale", "goodput_floor", "step_time_p95", "ttft_p95", "queue_wait_p95",
        "tenant_ttft_p95", "prefix_hit_rate", "checkpoint_lag", "nonfinite_steps",
        "oom_recent"}
    edges = {s: _normal(ref.fleet.read_alerts(p.fleet_root) if s == "ref"
                        else t_fleet.read_alerts(p.fleet_root), p.root)
             for s, p in pods.items()}
    assert edges["port"] == edges["ref"] and any(e["state"] == "resolved"
                                                 for e in edges["port"])
    with open(os.path.join(pods["port"].fleet_root, t_fleet.STATUS_NAME)) as f:
        on_disk = json.load(f)
    assert _normal(on_disk, pods["port"].root) == _normal(status["port"], pods["port"].root)

    # the tools over the final trees: fleetd --once and fleet_report
    for tool in ("fleetd", "fleet_report"):
        outs = {}
        for side, pod in pods.items():
            mod = (getattr(ref, tool) if side == "ref"
                   else importlib.import_module(f"llama_pipeline_parallel_tpu_torch.tools.{tool}"))
            if tool == "fleetd":
                outs[side] = _normal(mod.FleetAggregator(pod.fleet_root).refresh(write=False),
                                     pod.root)
            else:
                outs[side] = _normal(mod.build_report(pod.fleet_root), pod.root)
        assert outs["port"] == outs["ref"], tool


def test_fleet_tools_cli_match_reference(ref, tmp_path, capsys):
    """fleetd --once prints the status JSON and fleet_report renders the same
    text from both packages (paths and clock readings aside)."""
    now = time.time()
    out = {}
    for side in ("ref", "port"):
        pod = Pod(str(tmp_path / ("refr" if side == "ref" else side)), now)
        for n in range(3):
            pod.stage(n)
        mod = (ref if side == "ref" else types.SimpleNamespace(**{
            t: importlib.import_module(f"llama_pipeline_parallel_tpu_torch.tools.{t}")
            for t in ("fleetd", "fleet_report")}))
        assert mod.fleetd.main(["--fleet-root", pod.fleet_root, "--once",
                                "--alerts", json.dumps(RULES)]) == 0
        status = json.loads(capsys.readouterr().out)
        assert mod.fleet_report.main([pod.fleet_root]) == 0
        text = capsys.readouterr().out.replace(pod.root, "<root>")
        # clock readings in the rendered text: seconds with a decimal point
        out[side] = (_normal(status, pod.root), re.sub(r"\d+\.\d+", "<n>", text))
    assert out["port"] == out["ref"]
    assert "heartbeat_stale" in out["port"][1]


def test_latest_verified_step_reads_the_ports_checkpoints(ref, tmp_path):
    """The aggregator's trainer step comes from the port's checkpoint dirs:
    a committed save counts, a directory without meta.json does not; both
    packages read the same step, and Deployer's verified_steps agree."""
    from llama_pipeline_parallel_tpu_torch.ckpt import checkpoint as t_ckpt
    from llama_pipeline_parallel_tpu_torch.models.llama import model as t_llama
    from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig
    from llama_pipeline_parallel_tpu_torch.models.llama.manifest import StageManifest
    from llama_pipeline_parallel_tpu_torch.utils import actions as t_actions

    cfg = LlamaConfig.tiny()
    params = t_llama.init_params(cfg, seed=0, device="cpu")
    mgr = t_ckpt.CheckpointManager(str(tmp_path))
    manifest = StageManifest(num_layers=cfg.num_hidden_layers, num_stages=1)
    for step in (2, 4):
        mgr.save(step, params, manifest, cfg)
    os.makedirs(tmp_path / "checkpoint-6")  # arrays landing, no commit yet
    assert t_fleet.latest_verified_step(str(tmp_path)) == 4
    assert ref.fleet.latest_verified_step(str(tmp_path)) == 4
    assert t_actions.verified_steps(str(tmp_path)) == [2, 4]


def test_profiler_takes_the_trigger_name_from_fleet():
    """utils/profiler.py polls for the file fleet drops: one spelling."""
    from llama_pipeline_parallel_tpu_torch.utils import profiler

    assert profiler.CAPTURE_TRIGGER_NAME is t_fleet.CAPTURE_TRIGGER_NAME == "capture.trigger"


def test_tailer_and_watcher_match_reference(ref, tmp_path):
    """JsonlTailer across a torn tail, a garbage line and a truncation, and
    FileWatcher across a torn rewrite: the same rows, status and bytes."""
    seqs = {}
    for side, mod in (("ref", ref.fleet), ("port", t_fleet)):
        path, hpath = str(tmp_path / f"{side}.jsonl"), str(tmp_path / f"{side}.json")
        tailer, watcher = mod.JsonlTailer(path), mod.FileWatcher(hpath)
        seq = [tailer.poll(), watcher.poll(), watcher.status]
        with open(path, "w") as f:
            f.write('{"a": 1}\nnot json\n{"b": 2')
        _json(hpath, {"time": 1.0})
        seq += [tailer.poll(), watcher.poll(), watcher.status]
        with open(path, "a") as f:
            f.write('2}\n')
        with open(hpath, "w") as f:
            f.write('{"time": 2')
        seq += [tailer.poll(), watcher.poll(), watcher.status]
        _lines(path, [{"c": 3}], mode="w")
        seq += [tailer.poll(), tailer.bytes_read, watcher.bytes_read]
        seqs[side] = seq
    assert seqs["port"] == seqs["ref"]
