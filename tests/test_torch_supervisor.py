"""The port's supervisor (llama_pipeline_parallel_tpu_torch/tools/supervisor.py)
held to the JAX package's tools/supervisor.py, its launcher rule, and the
supervised chaos resize.

- The same dummy children under both supervisors give the same
  incarnations.jsonl outcomes, exit codes and layouts, and the same exit
  code: a crash then a clean run, the restart budget, a crash loop, a hang,
  the ladder walked on an injected `device_probe` device loss, and the
  actuated resize and deploy. A stop while no child runs launches none.
- `--nproc_per_node` follows the rung's `devices`; the hung ranks of a
  torch.distributed.run launch are stopped through their own SIGTERM (the
  launcher then exits 0) or killed with the launcher, and none outlives the
  incarnation.
- The `barrier` fault site: parallel/distributed.barrier against the
  reference's host_barrier, and the trainers' saves retried past it.
- The chaos resize of the JAX package's tests/test_elastic.py on the port: a
  `die` at step 3 in one of 2 ranks and a device loss at the relaunch's
  probe; the supervisor relaunches 1 rank at dp 1, which resumes the step-2
  checkpoint and finishes with the sample ledger of a straight dp 1 run.
"""

import importlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest

import torch_resilience as tr
from llama_pipeline_parallel_tpu_torch.parallel import distributed as t_dist
from llama_pipeline_parallel_tpu_torch.tools import supervisor as t_sup
from llama_pipeline_parallel_tpu_torch.utils import faults as t_faults

REPO = tr.REPO


@pytest.fixture(scope="session")
def ref():
    """The JAX package's supervisor (a root tool) and faults module, after
    installing the stand-in for `jax._src.sharding_impls.TransferToMemoryKind`
    where this jax lacks it."""
    import jax._src.sharding_impls as impls

    if not hasattr(impls, "TransferToMemoryKind"):
        class TransferToMemoryKind:
            def __init__(self, memory_kind):
                self.memory_kind = memory_kind

        impls.TransferToMemoryKind = TransferToMemoryKind
    sys.path.insert(0, os.path.join(REPO, "tools"))
    return types.SimpleNamespace(
        supervisor=importlib.import_module("supervisor"),
        faults=importlib.import_module("llama_pipeline_parallel_tpu.utils.faults"),
        dist=importlib.import_module("llama_pipeline_parallel_tpu.parallel.distributed"),
        actions=importlib.import_module("llama_pipeline_parallel_tpu.utils.actions"))


def _py(script, *args):
    return [sys.executable, "-c", script, *args]


# the dummy children: each logs its argv, then does what its case asks
_CRASH_ONCE = """
import json, os, sys
log, marker = sys.argv[1], sys.argv[2]
open(log, "a").write(json.dumps(sys.argv[3:]) + "\\n")
if not os.path.exists(marker):
    open(marker, "w").close()
    sys.exit(17)
"""
_ALWAYS_FAILS = "import sys; sys.exit(1)"
_HANGS = """
import json, sys, time
json.dump({"time": time.time(), "last_step": 3}, open(sys.argv[1], "w"))
time.sleep(60)
"""
# writes a deploy request while it runs, then exits 0 on SIGTERM
_DEPLOYS = """
import json, os, signal, sys
log, marker, req = sys.argv[1], sys.argv[2], sys.argv[3]
open(log, "a").write(json.dumps(sys.argv[4:]) + "\\n")
if os.path.exists(marker):
    sys.exit(0)
open(marker, "w").close()
signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))
json.dump({"action": "deploy", "step": 7, "id": "action-000002"}, open(req + ".tmp", "w"))
os.replace(req + ".tmp", req)
signal.pause()
"""
LADDER = [{"name": "dp2", "devices": 8, "overrides": ["mesh.dp=2"]},
          {"name": "dp1", "devices": 4, "overrides": ["mesh.dp=1",
                                                     "gradient_accumulation_steps=4"]}]


def _case(name, out):
    """(argv, config keywords, fault plan, env) of one case in `out`."""
    log, marker = os.path.join(out, "argv.jsonl"), os.path.join(out, "marker")
    # no child but the hanging one writes a heartbeat: the timeout must
    # cover a loaded machine's interpreter start
    cfg = dict(max_restarts=2, hang_timeout_s=20.0, grace_s=1.0, crash_loop_threshold=3,
               crash_loop_window_s=0.0, poll_s=0.05)
    plan, env = None, None
    if name == "crash_then_clean":
        argv = _py(_CRASH_ONCE, log, marker, "--x")
    elif name == "budget":
        argv, cfg["max_restarts"], cfg["crash_loop_threshold"] = _py(_ALWAYS_FAILS), 1, 99
    elif name == "crash_loop":
        argv = _py(_ALWAYS_FAILS)
        cfg.update(max_restarts=50, crash_loop_threshold=2, crash_loop_window_s=100.0)
    elif name == "hang":
        argv = _py(_HANGS, os.path.join(out, "health.json"))
        cfg.update(max_restarts=1, hang_timeout_s=1.0, crash_loop_threshold=99)
    elif name == "ladder_device_loss":
        argv = _py(_CRASH_ONCE, log, marker)
        env = {**os.environ, "LPT_DEVICE_COUNT": "8"}
        plan = {"faults": [{"site": "device_probe", "op": "device_loss", "devices": 4,
                            "after": 1}]}
        cfg["ladder"] = json.dumps(LADDER)
    elif name == "actuate_resize":
        argv = _py(_CRASH_ONCE, log, marker)
        env = {**os.environ, "LPT_DEVICE_COUNT": "8"}
        cfg.update(ladder=json.dumps(LADDER), actuate=True)
        with open(os.path.join(out, "action.request"), "w") as f:
            json.dump({"action": "resize", "rung": "dp1", "id": "action-000004"}, f)
        open(marker, "w").close()  # no crash: the pinned rung's one clean run
    else:  # actuate_deploy
        argv = _py(_DEPLOYS, log, marker, os.path.join(out, "action.request"), "--step", "1")
        cfg.update(actuate=True, max_restarts=3)
    return argv, cfg, plan, env


def _ledger_view(out):
    return [(r["incarnation"], r["outcome"], r["exit_code"], r.get("layout"),
             r.get("devices"), r.get("resized"), r.get("last_step"), r.get("action"))
            for r in tr.jsonl(os.path.join(out, "incarnations.jsonl"))]


def _files(out):
    """What the case leaves in its directory besides the ledger: the child
    argv log, the pinned state and the actuation files (timestamps aside)."""
    view = {}
    for name in ("argv.jsonl", "action_state.json", "action.ack", "resize.request",
                 "action.request"):
        path = os.path.join(out, name)
        if os.path.exists(path):
            text = open(path).read()
            view[name] = ([json.loads(x) for x in text.splitlines()] if name.endswith("l")
                          else {k: v for k, v in json.loads(text).items() if k != "ts"})
    return view


@pytest.mark.parametrize("case", ["crash_then_clean", "budget", "crash_loop", "hang",
                                  "ladder_device_loss", "actuate_resize", "actuate_deploy"])
def test_supervisor_matches_reference(ref, tmp_path, case):
    got = {}
    for side, sup, faults in (("ref", ref.supervisor, ref.faults), ("port", t_sup, t_faults)):
        out = str(tmp_path / side)
        os.makedirs(out)
        argv, cfg, plan, env = _case(case, out)
        if "ladder" in cfg:
            cfg["ladder"] = sup.parse_ladder(cfg["ladder"])
        faults.configure(plan)
        try:
            rc = sup.Supervisor(argv, sup.SupervisorConfig(output_dir=out, **cfg), env=env).run()
        finally:
            faults.configure(None)
        got[side] = (rc, _ledger_view(out), _files(out))
    assert got["port"] == got["ref"]
    rc, rows, _ = got["port"]
    assert {"crash_then_clean": 0, "budget": 2, "crash_loop": 3, "hang": 2,
            "ladder_device_loss": 0, "actuate_resize": 0, "actuate_deploy": 0}[case] == rc
    if case == "ladder_device_loss":
        assert [(r[3], r[4], r[5]) for r in rows] == [("dp2", 8, False), ("dp1", 4, True)]


def test_a_stop_between_launches_launches_nothing(tmp_path):
    """A SIGTERM to the supervisor while no child runs (here in the
    relaunch's device probe, held 1 s by a stall rule) launches no further
    child and ends supervision with 0; the crashed first incarnation is the
    ledger's only row."""
    out = str(tmp_path)
    log, marker = os.path.join(out, "argv.jsonl"), os.path.join(out, "marker")
    sup = t_sup.Supervisor(_py(_CRASH_ONCE, log, marker), t_sup.SupervisorConfig(
        output_dir=out, max_restarts=3, poll_s=0.05, ladder=t_sup.parse_ladder(
            '[{"devices": 1}]')), env={**os.environ, "LPT_DEVICE_COUNT": "1"})

    def stop_in_the_probe():
        while not os.path.exists(marker):
            time.sleep(0.01)
        time.sleep(0.3)
        sup._forward_signal(signal.SIGTERM, None)

    t_faults.configure({"faults": [{"site": "device_probe", "op": "stall", "seconds": 1.0,
                                    "after": 1}]})
    stopper = threading.Thread(target=stop_in_the_probe, daemon=True)
    stopper.start()
    try:
        assert sup.run() == 0
    finally:
        t_faults.configure(None)
        stopper.join(timeout=10)
    assert [r["outcome"] for r in tr.jsonl(os.path.join(out, "incarnations.jsonl"))] == ["crash"]
    assert len(tr.jsonl(log)) == 1


def test_nproc_per_node_follows_the_rung():
    """One process per device: a torch.distributed.run (or torchrun) child
    gets the rung's `devices` as --nproc_per_node, replacing the command's
    value among the launcher's own options or added after the launcher;
    the training program's arguments and any other command are untouched."""
    cli = ["-m", "x.cli", "--nproc_per_node", "9"]
    py = sys.executable
    assert t_sup._set_nproc([py, "-m", "torch.distributed.run", "--nproc_per_node", "2",
                             *cli], 1) == [py, "-m", "torch.distributed.run",
                                           "--nproc_per_node", "1", *cli]
    assert t_sup._set_nproc([py, "-m", "torch.distributed.run", "--master_port", "5",
                             "--nproc-per-node=4", "t.py"], 2)[5:7] == ["--nproc-per-node=2",
                                                                         "t.py"]
    assert t_sup._set_nproc(["torchrun", "--standalone", *cli], 3) == [
        "torchrun", "--nproc_per_node", "3", "--standalone", *cli]
    assert t_sup._set_nproc([py, "t.py", "--nproc_per_node", "2"], 1) == [
        py, "t.py", "--nproc_per_node", "2"]
    assert t_sup._launcher_index([py, "t.py"]) is None


# a rank of a hung launch: on SIGTERM it either exits 0 (the graceful stop)
# or ignores the signal; it records its pid, and once both ranks have, rank 0
# writes one heartbeat, the last
_RANK = """
import json, os, signal, sys, time
pids, out = sys.argv[1], sys.argv[3]
signal.signal(signal.SIGTERM, (lambda *a: sys.exit(0)) if sys.argv[2] == "graceful"
              else signal.SIG_IGN)
open(os.path.join(pids, f"rank{os.environ['RANK']}.pid"), "w").write(str(os.getpid()))
while not all(os.path.exists(os.path.join(pids, f"rank{r}.pid")) for r in (0, 1)):
    time.sleep(0.05)
if os.environ["RANK"] == "0":
    json.dump({"time": time.time()}, open(os.path.join(out, "health.json"), "w"))
time.sleep(120)
"""


@pytest.mark.parametrize("mode", ["graceful", "hard", "graceful-slow-launcher"])
def test_no_rank_outlives_a_hung_incarnation(tmp_path, mode):
    """A torch.distributed.run launch of 2 ranks whose heartbeat stops is
    hung: the graceful stop goes to the ranks (not the launcher), so ranks
    that honour SIGTERM exit 0 and the launcher exits 0; ranks that ignore it
    are SIGKILLed with the launcher after the grace. Either way no rank is
    alive when the supervisor returns. The grace is the ranks': a launcher
    that sees its ranks' exit only after the grace (a monitor interval of 5 s
    here, a loaded host in practice) still exits 0."""
    script = tmp_path / "rank.py"
    script.write_text(_RANK)
    out = str(tmp_path / "run")
    slow = ["--monitor_interval", "5"] if mode.endswith("slow-launcher") else []
    mode = mode.split("-")[0]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           *slow, "--master_port", str(tr.free_port()), str(script), str(tmp_path),
           mode, out]
    # a heartbeat stamped ahead covers the launch however long it takes on a
    # loaded machine; rank 0's last heartbeat replaces it once both ranks run
    os.makedirs(out)
    with open(os.path.join(out, "health.json"), "w") as f:
        json.dump({"time": time.time() + 600}, f)
    sup = t_sup.Supervisor(cmd, t_sup.SupervisorConfig(
        output_dir=out, max_restarts=0, hang_timeout_s=2.0,
        grace_s=10.0 if mode == "graceful" and not slow else 1.0,
        crash_loop_threshold=99, poll_s=0.1), env=tr.env())
    t0 = time.monotonic()
    assert sup.run() == 2  # the one incarnation hung: the budget is spent
    rows = tr.jsonl(os.path.join(out, "incarnations.jsonl"))
    assert [r["outcome"] for r in rows] == ["hang"]
    assert rows[0]["exit_code"] == (0 if mode == "graceful" else -signal.SIGKILL)
    pids = [int((tmp_path / f"rank{r}.pid").read_text()) for r in (0, 1)]
    for pid in pids:
        st = t_sup._stat(pid)
        assert st is None or st[2] == "Z", f"rank {pid} outlived its incarnation: {st}"
    assert time.monotonic() - t0 < 60


def test_barrier_fault_site_matches_reference(ref, monkeypatch):
    """parallel/distributed.barrier fires `barrier` inside each attempt, as the
    reference's host_barrier: a stall delays it, an injected error is
    retried (LPT_BARRIER_RETRIES, default 1) and, past the budget, raised as
    the transient-barrier error in both packages."""
    monkeypatch.setenv("LPT_RETRY_BASE_DELAY_S", "0")
    for mod, faults in ((t_dist, t_faults), (ref.dist, ref.faults)):
        wait = mod.barrier if mod is t_dist else mod.host_barrier
        faults.configure({"faults": [{"site": "barrier", "op": "stall", "seconds": 0.05,
                                      "match": "ckpt"}]})
        t0 = time.perf_counter()
        wait("ckpt-arrays-1")
        assert time.perf_counter() - t0 >= 0.05
        faults.configure({"faults": [{"site": "barrier", "op": "error", "times": 1}]})
        wait("sync-z")
        assert faults.active().stats()[0]["fired"] == 1
        monkeypatch.setenv("LPT_BARRIER_RETRIES", "0")
        faults.configure({"faults": [{"site": "barrier", "op": "error"}]})
        with pytest.raises(mod.TransientBarrierError, match="sync-y"):
            wait("sync-y")
        monkeypatch.delenv("LPT_BARRIER_RETRIES")
        faults.configure(None)


def test_chaos_resize_supervised_two_ranks_to_one(tmp_path):
    """The supervised chaos resize on the port: rank 0 or 1 dies at step 3
    (a `die` rule with a marker: one rank, once), the launcher fails, the
    relaunch's probe reports one device (`device_loss`), the supervisor
    walks the ladder to dp1 and relaunches torch.distributed.run with one
    process, which resumes checkpoint-2 and finishes step 6. The sample
    ledger equals a straight dp1 run's, no id twice, and the last loss is
    the straight run's within 1e-5. The plan's `barrier` rule fails each
    process's first commit barrier once: the trainer takes it and the save
    retries into the barrier its peer waits in."""
    out, straight = str(tmp_path / "chaos"), str(tmp_path / "straight")
    plan = {"faults": [
        {"site": "step", "op": "die", "at_step": 3, "marker": os.path.join(out, "fault.fired")},
        {"site": "device_probe", "op": "device_loss", "devices": 1, "after": 1},
        {"site": "barrier", "op": "error", "times": 1, "match": "ckpt-arrays"}]}
    os.makedirs(out)
    sup = subprocess.run(
        [sys.executable, "-m", "llama_pipeline_parallel_tpu_torch.tools.supervisor",
         "--output-dir", out, "--max-restarts", "2", "--hang-timeout-s", "120",
         "--poll-s", "0.1", "--layout-ladder", json.dumps(tr.LADDER), "--", *tr.launcher(out)],
        cwd=REPO, env=tr.env(LPT_DEVICE_COUNT="2", LPT_FAULT_PLAN=json.dumps(plan)),
        capture_output=True, text=True, timeout=300)
    assert sup.returncode == 0, f"{sup.stdout[-3000:]}\n{sup.stderr[-3000:]}"
    assert (sup.stdout + sup.stderr).count(
        "error@barrier (tag='ckpt-arrays-2', step=None, fire 1): raising") == 2
    ledger = tr.jsonl(os.path.join(out, "incarnations.jsonl"))
    assert [r["outcome"] for r in ledger] == ["crash", "clean"]
    assert [r["layout"] for r in ledger] == ["dp2", "dp1"]
    assert [r["devices"] for r in ledger] == [2, 1] and ledger[1]["resized"] is True
    # one process per device: the relaunch ran one rank at dp 1
    topo = ledger[1]["trainer_topology"]
    assert topo["dp"] == 1 and topo["process_count"] == 1
    with open(os.path.join(out, "checkpoint-6", "meta.json")) as f:
        meta = json.load(f)
    assert meta["topology"]["dp"] == 1
    assert meta["data_state"]["consumed_samples"] == tr.STEPS * tr.GLOBAL_BATCH

    tr.straight_run(straight)
    assert tr.dedup_ledger(out) == tr.dedup_ledger(straight)
    ids = [i for v in tr.dedup_ledger(out).values() for i in v]
    assert len(ids) == len(set(ids)) == tr.STEPS * tr.GLOBAL_BATCH
    np.testing.assert_allclose(tr.losses(out)[tr.STEPS], tr.losses(straight)[tr.STEPS],
                               rtol=1e-5)
    from llama_pipeline_parallel_tpu_torch.tools.goodput_report import incarnation_summary

    summary = incarnation_summary(out)
    assert summary["resize_events"] == 1 and summary["resize_lost_seconds"] > 0
