"""The port's alert-driven actions (llama_pipeline_parallel_tpu_torch/utils/actions.py,
tools/fleetctl.py, the trainer's resize vote) held to the JAX package's.

- The Autoscaler and the Deployer of both packages over the same scripted
  fleet_status sequence and the same checkpoint / replica directories: the
  same journal rows and ids, the same action.request files dropped.
- A fault at `action_execute` leaves an open intent in both; reconcile voids
  the borrow and completes the deploy in both. A `die` there kills the
  port's fleetctl between the rows, and the next fleetctl reconciles.
- The `actions` block parses and refuses alike; fleetctl --once takes the
  same actions.
- run_training of both packages with `actions.resize_on_request`, the
  request dropped at step 3: both save at step 3, ack after the save and
  stop; the losses and the saved params agree within 1e-5.
- End to end on the CPU: the supervisor (--actuate, a dp2 / dp1 ladder)
  over torch.distributed.run at 2 ranks; after the step-2 checkpoint fleetd
  sees the trainer's step-time alert and fleetctl's autoscaler borrows; the
  supervisor drops resize.request, both ranks vote and stop at one step,
  save, ack and exit 0, and one rank resumes at dp1 and finishes with the
  sample ledger of a straight dp1 run.
"""

import importlib
import json
import os
import subprocess
import sys
import threading
import time
import types

import jax
import numpy as np
import pytest

import torch_resilience as tr
from llama_pipeline_parallel_tpu_torch import convert
from llama_pipeline_parallel_tpu_torch import train as t_train
from llama_pipeline_parallel_tpu_torch.ckpt import checkpoint as t_ckpt
from llama_pipeline_parallel_tpu_torch.ckpt import tensor_io
from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig as TConfig
from llama_pipeline_parallel_tpu_torch.models.llama.manifest import StageManifest as TManifest
from llama_pipeline_parallel_tpu_torch.tools import fleetctl as t_fleetctl
from llama_pipeline_parallel_tpu_torch.utils import actions as t_actions
from llama_pipeline_parallel_tpu_torch.utils import config as t_config
from llama_pipeline_parallel_tpu_torch.utils import faults as t_faults

REPO = tr.REPO


@pytest.fixture(scope="session")
def ref():
    """The JAX package's actions, faults and trainer modules and its root
    fleetctl, after installing the stand-in for `jax._src.sharding_impls
    .TransferToMemoryKind` where this jax lacks it."""
    import jax._src.sharding_impls as impls

    if not hasattr(impls, "TransferToMemoryKind"):
        class TransferToMemoryKind:
            def __init__(self, memory_kind):
                self.memory_kind = memory_kind

        impls.TransferToMemoryKind = TransferToMemoryKind
    sys.path.insert(0, os.path.join(REPO, "tools"))
    mods = {"actions": "utils.actions", "faults": "utils.faults", "train": "train",
            "ckpt": "ckpt.checkpoint", "llama": "models.llama.model",
            "config": "models.llama.config", "manifest": "models.llama.manifest",
            "pl": "parallel.pipeline"}
    ns = {k: importlib.import_module(f"llama_pipeline_parallel_tpu.{v}")
          for k, v in mods.items()}
    return types.SimpleNamespace(fleetctl=importlib.import_module("fleetctl"), **ns)


def _json(path, payload):
    with open(path, "w") as f:
        json.dump(payload, f)


def _firing(rule, member, since):
    return {"alerts": {f"{rule}:{member}": {"state": "firing", "since": since,
                                            "value": 1.0, "threshold": 0.5}}}


class World:
    """A trainer's checkpoint dir and two serve replicas' dirs under `root`,
    and the supervisor's side of the action RPC (consume a request: ack it,
    apply a deploy's step to serve.json)."""

    def __init__(self, root):
        self.root = root
        self.fleet = os.path.join(root, "fleet")
        self.trainer = os.path.join(root, "trainer")
        self.replicas = [os.path.join(root, f"r{i}") for i in range(2)]
        for d in (self.fleet, self.trainer, *self.replicas):
            os.makedirs(d, exist_ok=True)
        _json(os.path.join(self.replicas[0], "serve.json"), {"checkpoint_step": 2})

    def checkpoint(self, step, eval_loss):
        d = os.path.join(self.trainer, f"checkpoint-{step}")
        os.makedirs(d, exist_ok=True)
        _json(os.path.join(d, "meta.json"), {"step": step, "eval_loss": eval_loss})

    def consume(self):
        for d in (self.trainer, *self.replicas):
            path = os.path.join(d, "action.request")
            if os.path.exists(path):
                req = json.load(open(path))
                _json(os.path.join(d, "action.ack"), {"id": req["id"]})
                if req["action"] == "deploy":
                    _json(os.path.join(d, "serve.json"), {"checkpoint_step": req["step"]})
                os.remove(path)

    def requests(self):
        out = {}
        for d in (self.trainer, *self.replicas):
            path = os.path.join(d, "action.request")
            if os.path.exists(path):
                out[os.path.basename(d)] = {k: v for k, v in json.load(open(path)).items()
                                            if k != "ts"}
        return out


def _journal(mod, world):
    rows = mod.ActionJournal(world.fleet).rows()
    return json.loads(json.dumps([{k: v for k, v in r.items() if k not in ("ts", "cmd_pid")}
                                  for r in rows]).replace(world.root, "<root>"))


def _actuators(mod, world):
    cfg = mod.ActionsConfig.from_cfg({
        "autoscale": {"trainer_dir": world.trainer, "borrow_rung": "dp1",
                      "restore_rung": "dp2", "for_s": 5, "idle_for_s": 10, "cooldown_s": 20},
        "deploy": {"trainer_dir": world.trainer, "replica_dirs": world.replicas,
                   "eval_regression": 0.05}})
    journal = mod.ActionJournal(world.fleet)
    return (journal, mod.Autoscaler(cfg.autoscale, journal, world.fleet),
            mod.Deployer(cfg.deploy, journal))


def _script(world, autoscaler, deployer, t0):
    """The scripted sequence: (what happened, ids taken, requests dropped)
    after each tick; the supervisors consume between ticks."""
    log = []

    def tick(label, status, now, who=("a", "d")):
        taken = []
        if "a" in who:
            taken += autoscaler.tick(status, now)
        if "d" in who:
            taken += deployer.tick(status, now)
        log.append((label, taken, world.requests()))
        world.consume()

    world.checkpoint(2, 2.0)
    world.checkpoint(4, 1.8)
    breach = _firing("ttft_p95", "serve:r0", t0)
    tick("breach, not yet sustained; deploy 4 to both", breach, t0 + 1)
    tick("sustained: borrow", breach, t0 + 6)
    tick("borrowed, still breaching", breach, t0 + 7)
    tick("quiet starts", {}, t0 + 8)
    tick("quiet long enough, cooling down", {}, t0 + 19)
    tick("handback", {}, t0 + 31)
    world.checkpoint(6, 2.5)  # regressed: held once
    tick("candidate 6 held", {}, t0 + 32, "d")
    tick("still held, not journaled twice", {}, t0 + 33, "d")
    tick("lag alert forces 6", _firing("checkpoint_lag", "serve:r0", t0), t0 + 34, "d")
    tick("deployed 6 regressed vs 4: rollback", {}, t0 + 35, "d")
    return log


def test_actuators_match_reference(ref, tmp_path):
    t0 = time.time()
    got = {}
    for side, mod in (("ref", ref.actions), ("port", t_actions)):
        world = World(str(tmp_path / ("refr" if side == "ref" else side)))
        journal, autoscaler, deployer = _actuators(mod, world)
        log = _script(world, autoscaler, deployer, t0)
        got[side] = (json.loads(json.dumps(log).replace(world.root, "<root>")),
                     _journal(mod, world), autoscaler.mode())
    assert got["port"] == got["ref"]
    kinds = [r["kind"] for r in got["port"][1] if r["phase"] == "intent"]
    assert kinds == ["deploy", "deploy", "borrow", "handback", "hold", "hold", "deploy",
                     "deploy", "rollback", "rollback"]


def test_action_execute_fault_and_reconcile_match_reference(ref, tmp_path):
    """An error at `action_execute` lands between the intent and outcome
    rows: reconcile voids the autoscaler's undelivered borrow and completes
    the deployer's deploy by delivering it, in both packages."""
    t0 = time.time()
    got = {}
    for side, mod, faults in (("ref", ref.actions, ref.faults),
                              ("port", t_actions, t_faults)):
        world = World(str(tmp_path / ("refr" if side == "ref" else side)))
        world.checkpoint(2, 2.0)
        world.checkpoint(4, 1.8)
        journal, autoscaler, deployer = _actuators(mod, world)
        faults.configure({"faults": [{"site": "action_execute", "op": "error", "times": 2}]})
        try:
            with pytest.raises(faults.InjectedFault, match="action_execute"):
                autoscaler.tick(_firing("queue_wait_p95", "serve:r1", t0), t0 + 6)
            with pytest.raises(faults.InjectedFault, match="action_execute"):
                deployer.tick({}, t0 + 6)
        finally:
            faults.configure(None)
        opened = [r["id"] for r in journal.open_intents()]
        resolved = mod.reconcile_open_intents(journal, autoscaler, deployer)
        taken = autoscaler.tick(_firing("queue_wait_p95", "serve:r1", t0), t0 + 7)
        got[side] = (opened, resolved, taken, world.requests(), _journal(mod, world))
    assert got["port"] == got["ref"]
    assert [outcome for _, _, outcome in got["port"][1]] == ["voided", "done"]


def test_fleetctl_die_at_action_execute_is_reconciled(tmp_path):
    """A `die` at action_execute SIGKILLs the port's fleetctl between the
    intent and outcome rows; the next fleetctl --once reconciles the open
    intent (voided: the request was never written) and borrows afresh."""
    world = World(str(tmp_path))
    t0 = time.time()
    _json(os.path.join(world.fleet, "fleet_status.json"),
          _firing("ttft_p95", "serve:r0", t0 - 10))
    actions = json.dumps({"autoscale": {"trainer_dir": world.trainer, "borrow_rung": "dp1",
                                        "restore_rung": "dp2", "for_s": 1}})
    cmd = [sys.executable, "-m", "llama_pipeline_parallel_tpu_torch.tools.fleetctl",
           "--fleet-root", world.fleet, "--once", "--actions", actions]
    died = subprocess.run(cmd, cwd=REPO, env=tr.env(LPT_FAULT_PLAN=json.dumps(
        {"faults": [{"site": "action_execute", "op": "die"}]})), capture_output=True,
        text=True, timeout=120)
    assert died.returncode == -9, died.stderr[-2000:]
    assert [r["phase"] for r in t_actions.read_actions(world.fleet)] == ["intent"]
    again = subprocess.run(cmd, cwd=REPO, env=tr.env(), capture_output=True, text=True,
                           timeout=120)
    assert again.returncode == 0, again.stderr[-2000:]
    assert "reconciled action-000000 (borrow): voided" in again.stdout
    assert json.loads(again.stdout.strip().splitlines()[-1]) == {"actions": ["action-000001"]}
    assert world.requests()["trainer"]["id"] == "action-000001"


def test_fleetctl_once_matches_reference(ref, tmp_path, capsys):
    t0 = time.time()
    out = {}
    for side, tool in (("ref", ref.fleetctl), ("port", t_fleetctl)):
        world = World(str(tmp_path / ("refr" if side == "ref" else side)))
        world.checkpoint(2, 2.0)
        _json(os.path.join(world.fleet, "fleet_status.json"),
              _firing("queue_wait_p95", "serve:r0", t0 - 30))
        actions = {"autoscale": {"trainer_dir": world.trainer, "borrow_rung": "dp1",
                                 "restore_rung": "dp2", "for_s": 5},
                   "deploy": {"trainer_dir": world.trainer, "replica_dirs": world.replicas}}
        assert tool.main(["--fleet-root", world.fleet, "--once",
                          "--actions", json.dumps(actions)]) == 0
        out[side] = (capsys.readouterr().out, world.requests())
    assert out["port"] == out["ref"]
    with pytest.raises(SystemExit, match="bad --actions"):
        t_fleetctl.main(["--fleet-root", str(tmp_path), "--actions", '{"autoscale": 1}'])


@pytest.mark.parametrize("node", [
    None, {}, {"resize_on_request": True}, {"resize_on_request": 0}, "yes",
    {"resize_on_request": True, "autoscale": {}}])
def test_train_actions_block_matches_reference(ref, node):
    """TrainActions.from_cfg of both packages: the same value, or the same
    refusal."""
    outs = []
    for mod in (ref.actions, t_actions):
        try:
            outs.append(("ok", mod.TrainActions.from_cfg(node).resize_on_request))
        except ValueError as e:
            outs.append(("refused", str(e)))
    assert outs[0] == outs[1]


def _tiny(tmp_path, name, *overrides):
    return t_config.load_config(os.path.join(REPO, "conf", "tiny_smoke.yaml"), [
        "mesh.pp=1", "mesh.dp=1", "max_steps=6", "total_steps=8", "warmup_steps=1",
        "logging_steps=1", "save_steps=0", "save_final=false", "resume=false",
        "actions={resize_on_request: true}", "dataset.pseudo_dataset_len=64",
        f"output_dir={tmp_path}/{name}", *overrides])


def _request_at(module, monkeypatch, check):
    """Make `module._resize_requested` drop the real resize.request before
    its `check`-th call (0-based): with one process the vote is taken every
    step, so the request arrives at step `check`."""
    original, calls = module._resize_requested, []

    def watched(output_dir):
        if len(calls) == check:
            _json(os.path.join(output_dir, "resize.request"), {"id": "action-000007"})
        calls.append(output_dir)
        return original(output_dir)

    monkeypatch.setattr(module, "_resize_requested", watched)


def test_trainer_resize_vote_matches_reference_run_training(ref, tmp_path, monkeypatch):
    """run_training of both packages, warm-started from the same weights
    (the reference's init, carried by convert.py), with the request
    dropped at step 3: both stop at step 3 with a checkpoint there, the
    request renamed to its ack, the losses of steps 1-3 and the saved
    params within 1e-5."""
    cfg_j = ref.config.LlamaConfig.tiny()
    tree = ref.llama.init_params(jax.random.PRNGKey(7), cfg_j)
    one = ref.manifest.StageManifest.for_config(cfg_j, 1)
    ref.ckpt.CheckpointManager(str(tmp_path / "warm_ref")).save(
        0, ref.pl.stack_stages(tree, one), one, cfg_j)
    t_ckpt.CheckpointManager(str(tmp_path / "warm_port")).save(
        0, convert.params_from_jax(jax.device_get(tree)),
        TManifest(num_layers=cfg_j.num_hidden_layers, num_stages=1), TConfig.tiny())
    _request_at(ref.train, monkeypatch, 3)
    _request_at(t_train, monkeypatch, 3)
    want = ref.train.run_training(_tiny(tmp_path, "ref", f"model_name_or_path={tmp_path}/warm_ref"))
    got = t_train.run_training(_tiny(tmp_path, "port", f"model_name_or_path={tmp_path}/warm_port"),
                               device="cpu")
    assert got["preempted_at"] == want["preempted_at"] == 3
    for side in ("ref", "port"):
        d = tmp_path / side
        assert sorted(p for p in os.listdir(d) if p.startswith("checkpoint-")) == ["checkpoint-3"]
        assert not (d / "resize.request").exists()
        assert json.loads((d / "resize.request.ack").read_text())["id"] == "action-000007"
    losses = {s: [r["loss"] for r in tr.jsonl(str(tmp_path / s / "metrics.jsonl")) if "loss" in r]
              for s in ("ref", "port")}
    assert len(losses["port"]) == len(losses["ref"]) == 3
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=0, atol=1e-5)
    jtree, _, _, _ = ref.ckpt.load_module_checkpoint(str(tmp_path / "ref"))
    with tensor_io.TensorFile(str(tmp_path / "port" / "checkpoint-3" /
                                  "params.safetensors")) as f:
        for k, v in convert.params_from_jax(jax.device_get(jtree)).items():
            np.testing.assert_allclose(f.tensor(k).numpy(), v.numpy(), rtol=0, atol=1e-5,
                                       err_msg=k)


def test_a_vote_on_a_just_saved_step_writes_no_second_checkpoint(tmp_path, monkeypatch):
    """A request that arrives while a step's periodic save is written stops
    the run at the next boundary on that checkpoint: the vote joins its
    commit instead of writing the same state again, and acks."""
    import logging

    from llama_pipeline_parallel_tpu_torch.ckpt import checkpoint as ckpt_mod

    saves = []
    handler = logging.Handler(logging.INFO)
    handler.emit = lambda r: saves.append(r.getMessage()) if "saved checkpoint" in \
        r.getMessage() else None
    ckpt_mod.logger.addHandler(handler)
    _request_at(t_train, monkeypatch, 2)
    try:
        got = t_train.run_training(_tiny(tmp_path, "port", "save_steps=2"), device="cpu")
    finally:
        ckpt_mod.logger.removeHandler(handler)
    assert got["preempted_at"] == 2
    assert [m.split(" to ")[0] for m in saves] == ["saved checkpoint-2"]
    assert (tmp_path / "port" / "resize.request.ack").exists()
    assert sorted(p for p in os.listdir(tmp_path / "port")
                  if p.startswith("checkpoint-")) == ["checkpoint-2"]


def test_actuated_resize_end_to_end(tmp_path):
    """fleetd -> fleetctl -> supervisor -> the trainers' resize vote on the
    CPU (chip_smoke.py's phase_resilience trainer leg at the tiny preset)."""
    from llama_pipeline_parallel_tpu_torch.tools import fleetd, goodput_report

    out, straight = str(tmp_path / "train"), str(tmp_path / "straight")
    fleet_root = str(tmp_path / "fleet")
    # steps from 3 on take 0.5 s more, so the request lands mid-run
    plan = {"faults": [{"site": "step", "op": "slow", "seconds": 0.5, "after": 3}]}
    sup = subprocess.Popen(
        [sys.executable, "-m", "llama_pipeline_parallel_tpu_torch.tools.supervisor",
         "--output-dir", out, "--fleet-root", fleet_root, "--actuate", "--poll-s", "0.1",
         "--hang-timeout-s", "120", "--max-restarts", "2",
         "--layout-ladder", json.dumps(tr.LADDER), "--",
         *tr.launcher(out, "actions={resize_on_request: true}")],
        cwd=REPO, env=tr.env(LPT_DEVICE_COUNT="2", LPT_FAULT_PLAN=json.dumps(plan)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    log = []
    reader = threading.Thread(target=lambda: log.extend(sup.stdout), daemon=True)
    reader.start()
    try:
        deadline = time.monotonic() + 120
        while not os.path.exists(os.path.join(out, "checkpoint-2", "meta.json")):
            assert sup.poll() is None and time.monotonic() < deadline, "".join(log)[-3000:]
            time.sleep(0.05)
        assert fleetd.main(["--fleet-root", fleet_root, "--once", "--no-capture",
                            "--alerts", json.dumps({"step_time_p95_s": 1e-6})]) == 0
        assert t_fleetctl.main([
            "--fleet-root", fleet_root, "--once", "--actions", json.dumps({"autoscale": {
                "trainer_dir": out, "borrow_rung": "dp1", "restore_rung": "dp2",
                "breach_alerts": ["step_time_p95"]}})]) == 0
        assert sup.wait(timeout=240) == 0, "".join(log)[-3000:]
    finally:
        if sup.poll() is None:  # nothing the test started outlives it
            from llama_pipeline_parallel_tpu_torch.tools import supervisor as t_sup

            below = t_sup._descendants(sup.pid)
            sup.kill()
            for pid, start in below:
                if t_sup._alive(pid, start):
                    os.kill(pid, 9)
        reader.join(timeout=10)
    text = "".join(log)
    assert text.count("resize request; checkpointing at step") == 2  # both ranks, one step
    ledger = tr.jsonl(os.path.join(out, "incarnations.jsonl"))
    assert [r["layout"] for r in ledger] == ["dp2", "dp1"]
    assert [r["outcome"] for r in ledger] == ["clean", "clean"] and ledger[1]["resized"]
    assert ledger[0]["action"]["action"] == "resize"
    assert ledger[1]["trainer_topology"]["process_count"] == 1
    history = t_actions.ActionJournal(fleet_root).history()
    assert [(h["kind"], h["result"]["outcome"]) for h in history] == [("borrow", "done")]
    assert json.load(open(os.path.join(out, "resize.request.ack")))["id"] == history[0]["id"]
    with open(os.path.join(out, f"checkpoint-{tr.STEPS}", "meta.json")) as f:
        meta = json.load(f)
    assert meta["topology"]["dp"] == 1
    assert meta["data_state"]["consumed_samples"] == tr.STEPS * tr.GLOBAL_BATCH
    tr.straight_run(straight)
    assert tr.dedup_ledger(out) == tr.dedup_ledger(straight)
    np.testing.assert_allclose(tr.losses(out)[tr.STEPS], tr.losses(straight)[tr.STEPS],
                               rtol=1e-5)
    assert goodput_report.incarnation_summary(out)["resize_events"] == 1
