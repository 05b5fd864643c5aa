"""The port's step loop (train.train_run) against the JAX trainer's
`_train_loop` for one process: preemption (SIGTERM / SIGINT -> a checkpoint at
the next step, a resume equal to the uninterrupted run), the `step` fault
site, the remat policies, the metrics line's meter (`real_tokens_per_sec`,
the data wait) and the wandb / tensorboard sinks.

Tiny preset in fp32 on the CPU; tolerances stated per check.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
import weakref

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from llama_pipeline_parallel_tpu_torch import train as t_train
from llama_pipeline_parallel_tpu_torch.models.llama import model as t_llama
from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig as TConfig
from llama_pipeline_parallel_tpu_torch.ops import flash_attention as t_fa
from llama_pipeline_parallel_tpu_torch.ops import fused_prologue as t_fp
from llama_pipeline_parallel_tpu_torch.utils import config as t_config
from llama_pipeline_parallel_tpu_torch.utils import faults as t_faults
from llama_pipeline_parallel_tpu_torch.utils import metrics as t_metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "conf", "tiny_smoke.yaml")


def _args(out, *extra):
    return ["mesh.pp=1", "mesh.dp=1", f"output_dir={out}", "max_steps=6", "total_steps=8",
            "logging_steps=1", "async_save=false", *extra]


def _cli(out, *extra):
    return subprocess.Popen(
        [sys.executable, "-m", "llama_pipeline_parallel_tpu_torch.cli", "--config", TINY,
         "--device", "cpu", *_args(out, *extra)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _lines(out):
    path = os.path.join(out, "metrics.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip()]


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------

def test_sigterm_checkpoints_at_the_next_step_and_resumes_bit_equal(tmp_path):
    """The CLI on the CPU, slowed at the `step` site, gets SIGTERM after its
    second step: it saves a complete checkpoint-N (and `latest`) at the step
    it stops at, names N in its log and exits 0. Its losses up to N, and a
    resume from N to the end, equal the uninterrupted run's bit for bit,
    and so do the final parameters."""
    out = tmp_path / "stopped"
    proc = _cli(out, "fault_plan={faults: [{site: step, op: slow, seconds: 0.4}]}")
    try:
        deadline = time.monotonic() + 90
        while len(_lines(out)) < 2 and proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        stdout, err = proc.communicate(timeout=90)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-2000:]
    stopped = _lines(out)
    n = stopped[-1]["step"]
    assert 2 <= n < 6, err[-2000:]
    assert f"preemption signal; checkpointing at step {n} and exiting" in err
    assert f"'final_step': {n}, 'start_step': 0, 'preempted_at': {n}" in stdout
    assert (out / "latest").read_text().strip() == f"checkpoint-{n}"
    assert os.path.isfile(out / f"checkpoint-{n}" / "meta.json")

    whole = t_train.build_run(t_config.load_config(TINY, _args(tmp_path / "whole")), "cpu")
    want = t_train.train_run(whole)
    assert [r["loss"] for r in stopped] == want["losses"][:n]
    resumed = t_train.build_run(t_config.load_config(TINY, _args(out)), "cpu")
    assert resumed.start_step == n
    got = t_train.train_run(resumed)
    assert got["preempted_at"] is None and got["final_step"] == 6
    assert got["losses"] == want["losses"][n:]
    for k, v in whole.state.params.items():
        assert torch.equal(resumed.state.params[k], v), k


def test_signal_during_setup_stops_at_the_first_step(tmp_path, monkeypatch):
    """A SIGTERM that lands while the run is being built (the handlers are
    installed first) is honoured at the first step: a checkpoint at the start
    step, `preempted_at` and `final_step` name it, and the handlers from
    before the run are back afterwards. A run on another thread installs
    nothing."""
    build = t_train.build_run

    def build_then_signal(*a, **kw):
        run = build(*a, **kw)
        assert signal.getsignal(signal.SIGTERM) is t_train._on_preemption_signal
        signal.raise_signal(signal.SIGTERM)
        return run

    monkeypatch.setattr(t_train, "build_run", build_then_signal)
    before = signal.getsignal(signal.SIGTERM)
    summary = t_train.run_training(t_config.load_config(TINY, _args(tmp_path)), device="cpu")
    assert (summary["preempted_at"], summary["final_step"], summary["losses"]) == (0, 0, [])
    assert t_train.CheckpointManager(str(tmp_path)).latest_step() == 0
    assert signal.getsignal(signal.SIGTERM) is before
    assert signal.getsignal(signal.SIGINT) is not t_train._on_preemption_signal

    seen = []
    worker = threading.Thread(target=lambda: (t_train._install_preemption_handlers(),
                                              seen.append(signal.getsignal(signal.SIGTERM))))
    worker.start()
    worker.join(timeout=10)
    assert not worker.is_alive() and seen == [before]


# ---------------------------------------------------------------------------
# the `step` fault site
# ---------------------------------------------------------------------------

def test_step_site_die_kills_the_process_at_its_step(tmp_path):
    """`die` at the `step` site (SIGKILL, the default signal) ends the CLI at
    the top of loop step 2, as in the JAX trainer: two steps logged, no
    checkpoint."""
    proc = _cli(tmp_path, "fault_plan={faults: [{site: step, op: die, at_step: 2}]}")
    _, err = proc.communicate(timeout=120)
    assert proc.returncode == -signal.SIGKILL, err[-2000:]
    assert "die@step" in err
    assert [r["step"] for r in _lines(tmp_path)] == [1, 2]
    assert t_train.CheckpointManager(str(tmp_path)).latest_step() is None


def test_step_site_stall_and_slow_land_in_step_time(tmp_path):
    """`stall` and `slow` at the `step` site sleep at the top of their steps
    (fired once each) inside the window's wall, so the window's `step_time`
    holds them; the per-step `step_times` (the step alone) do not."""
    plan = ("fault_plan={faults: [{site: step, op: stall, seconds: 0.6, at_step: 1}, "
            "{site: step, op: slow, seconds: 0.6, at_step: 2}]}")
    run = t_train.build_run(t_config.load_config(TINY, _args(
        tmp_path, plan, "max_steps=4", "logging_steps=4")), "cpu")
    summary = t_train.train_run(run)
    assert [(r["op"], r["seen"], r["fired"]) for r in t_faults.active().stats()] == [
        ("stall", 1, 1), ("slow", 1, 1)]
    t_faults.configure(None)
    line = _lines(tmp_path)[0]
    # the window's wall less the first step, per step: at least the 1.2 s asleep
    assert line["step_time"] * 4 >= 1.2
    assert sum(summary["step_times"][1:]) < line["step_time"] * 4 - 1.2 + 1e-3


# ---------------------------------------------------------------------------
# the remat policies
# ---------------------------------------------------------------------------

class _LiveOutputs(TorchDispatchMode):
    """Every op's output, by weak reference: what the forward leaves alive."""

    def __init__(self):
        super().__init__()
        self.refs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.refs.append(weakref.ref(t))
        return out

    def live_bytes(self) -> int:
        storages = {}
        for ref in self.refs:
            t = ref()
            if t is not None:
                storages[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return sum(storages.values())


def _forward_backward(params, batch, cfg, remat, policy):
    """(loss, gradients) through the flash and prologue kernels' plain
    versions."""
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    logits = t_llama.forward(leaves, batch["input_ids"], batch["attention_mask"], cfg=cfg,
                             remat=remat, remat_policy=policy,
                             attn_fn=t_train.flash_attention, kernel_prologue=True)
    loss = t_llama.loss_fn(logits, batch["labels"])
    loss.backward()
    return loss.detach(), {k: v.grad for k, v in leaves.items()}


def _remat_inputs():
    cfg = TConfig.tiny()
    params = t_llama.init_params(cfg, device="cpu", seed=0)
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(3, cfg.vocab_size, (2, 32), generator=g)
    mask = torch.ones_like(ids)
    mask[1, 24:] = 0
    return cfg, params, {"input_ids": ids, "attention_mask": mask,
                         "labels": torch.where(mask == 1, ids, t_llama.IGNORE_INDEX)}


@pytest.mark.parametrize("policy", t_llama.REMAT_POLICIES)
def test_remat_policy_gives_the_gradients_of_no_remat(policy, monkeypatch):
    """Each remat policy, with the flash and prologue kernels' plain versions:
    loss and gradients within 1e-6 (relative to each gradient's largest
    element) of the run without remat, and the forward kernels run again in
    the backward (2 calls a layer) under every policy except
    everything_saveable: a kernel's output is not a product, so no policy
    keeps it."""
    cfg, params, batch = _remat_inputs()
    calls = {"flash": 0, "prologue": 0}
    fwd_plain, pro_plain = t_fa._fwd_plain, t_fp._fwd_plain

    def counted(key, fn):
        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(t_fa, "_fwd_plain", counted("flash", fwd_plain))
    monkeypatch.setattr(t_fp, "_fwd_plain", counted("prologue", pro_plain))
    want_loss, want = _forward_backward(params, batch, cfg, False, "nothing_saveable")
    base = dict(calls)
    loss, grads = _forward_backward(params, batch, cfg, True, policy)
    layers = cfg.num_hidden_layers
    per_layer = 1 if policy == "everything_saveable" else 2
    assert base == {"flash": layers, "prologue": layers}
    assert {k: v - base[k] for k, v in calls.items()} == {"flash": per_layer * layers,
                                                           "prologue": per_layer * layers}
    np.testing.assert_allclose(loss.item(), want_loss.item(), rtol=1e-6)
    for k, g in want.items():
        assert (grads[k] - g).abs().max().item() <= 1e-6 * g.abs().max().item(), k


def test_remat_policies_keep_more_as_they_save_more():
    """The bytes of op outputs that the forward leaves alive for the
    backward (exact attention, composed prologue): nothing_saveable <
    dots_with_no_batch_dims_saveable (+ the projections' mm outputs) <=
    dots_saveable (+ the attention's bmm outputs) <= everything_saveable (the
    whole graph, which is no remat)."""
    cfg, params, batch = _remat_inputs()

    def saved(policy, attn=t_llama.attention):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        census = _LiveOutputs()
        with census:
            loss = t_llama.loss_fn(t_llama.forward(
                leaves, batch["input_ids"], batch["attention_mask"], cfg=cfg, remat=True,
                remat_policy=policy, attn_fn=attn), batch["labels"])
        assert loss.grad_fn is not None  # the graph, and what it keeps, is alive here
        return census.live_bytes()

    got = {policy: saved(policy) for policy in ("nothing_saveable",
                                                "dots_with_no_batch_dims_saveable",
                                                "dots_saveable", "everything_saveable")}
    order = list(got.values())
    assert order[0] < order[1] <= order[2] <= order[3], got
    assert order[1] < order[2]  # the exact op's einsums are bmm: only dots_saveable keeps them
    assert saved("checkpoint_dots") == got["dots_saveable"]
    assert saved("checkpoint_dots_with_no_batch_dims") == got["dots_with_no_batch_dims_saveable"]


def test_trainer_takes_a_saving_policy(tmp_path):
    """The trainer runs `remat_policy: dots_with_no_batch_dims_saveable` (the
    70B config's) with checkpointing on: the same losses as the default
    policy, step for step."""
    def losses(out, *extra):
        return t_train.run_training(t_config.load_config(TINY, _args(
            out, "max_steps=2", *extra)), device="cpu")["losses"]

    saving = losses(tmp_path / "s", "remat_policy=dots_with_no_batch_dims_saveable")
    assert saving == losses(tmp_path / "n") and len(saving) == 2


# ---------------------------------------------------------------------------
# the meter and the sinks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pad_fraction,real", [(0.0, False), (0.25, True)])
def test_real_tokens_per_sec_only_where_pads_are(tmp_path, pad_fraction, real):
    """`real_tokens_per_sec` (non-pad positions over the window's wall) is on
    the metrics line of a padded run, in the ratio of its non-pad share, and
    not on an unpadded one."""
    t_train.run_training(t_config.load_config(TINY, _args(
        tmp_path, "max_steps=2", "logging_steps=2", f"dataset.pad_fraction={pad_fraction}")),
        device="cpu")
    line = _lines(tmp_path)[0]
    assert ("real_tokens_per_sec" in line) == real
    if real:
        np.testing.assert_allclose(line["real_tokens_per_sec"] / line["tokens_per_sec"],
                                   1 - pad_fraction, rtol=1e-9)
    assert line["tokens_per_sec_per_chip"] == line["tokens_per_sec"]


def test_data_wait_shows_in_tokens_per_sec_and_step_time(tmp_path):
    """A `data_read` slow fault (0.1 s a record, 4 records a batch) starves
    the loop: the window's wall holds every read, so tokens_per_sec is at
    most a batch's tokens per 0.4 s. step_time is that wall less the first
    step, over the 3 steps: the prefetch thread starts inside the window and
    reads the 3 batches one after another (1.2 s), so the wall is at least
    that and the last step, and at least the first batch's read and every
    step; a long first step may hide later reads, and the bound on step_time
    takes its length from the run's own `step_times`."""
    plan = "fault_plan={faults: [{site: data_read, op: slow, seconds: 0.1}]}"
    summary = t_train.run_training(t_config.load_config(TINY, _args(
        tmp_path, plan, "max_steps=3", "logging_steps=3", "prefetch_depth=1")), device="cpu")
    line = _lines(tmp_path)[0]
    times = summary["step_times"]
    assert line["tokens_per_sec"] <= summary["tokens_per_step"] / 0.4
    assert line["step_time"] * 3 >= 3 * 0.4 + times[-1] - times[0]
    assert line["step_time"] * 3 >= sum(times[1:]) + 0.4


def _flan_rows(n, seed):
    words = "the quick brown fox jumps over lazy dog what is a model".split()
    rng = np.random.RandomState(seed)
    return [{"inputs": " ".join(rng.choice(words, rng.randint(2, 7))),
             "targets": " ".join(rng.choice(words, rng.randint(1, 4)))} for _ in range(n)]


def test_packed_run_evaluates_and_meters_non_pad_tokens(tmp_path):
    """conf/llama_7b_flan_packed.yaml on the CPU (tiny preset) with a held-out
    JSONL from the same generator and another seed as `eval_dataset`: the
    eval loader packs as training does (segment ids through flash, no
    autograd graph), `eval_loss` is logged, and the training line carries
    `real_tokens_per_sec` below `tokens_per_sec`."""
    from tokenizers import SentencePieceUnigramTokenizer
    from transformers import PreTrainedTokenizerFast

    rows = _flan_rows(48, 0)
    spm = SentencePieceUnigramTokenizer()
    spm.train_from_iterator([f"{r['inputs']} {r['targets']}" for r in rows], vocab_size=60,
                            unk_token="<unk>", special_tokens=["<unk>", "<s>", "</s>"])
    PreTrainedTokenizerFast(tokenizer_object=spm._tokenizer, bos_token="<s>", eos_token="</s>",
                            unk_token="<unk>").save_pretrained(str(tmp_path / "tok"))
    for name, data in (("train", rows), ("eval", _flan_rows(16, 1))):
        (tmp_path / f"{name}.jsonl").write_text("\n".join(json.dumps(r) for r in data))
    cfg = t_config.load_config(os.path.join(REPO, "conf", "llama_7b_flan_packed.yaml"), [
        "mesh.pp=1", "mesh.dp=1", "model={preset: tiny, dtype: float32}",
        f"tokenizer_path={tmp_path / 'tok'}", f"dataset.path={tmp_path / 'train.jsonl'}",
        f"eval_dataset={{_target_: llama_pipeline_parallel_tpu.data.datasets.LazyJsonlDataset, "
        f"path: {tmp_path / 'eval.jsonl'}}}", "eval_steps=2", "max_seq_length=48",
        "packing_factor=2", "per_device_train_batch_size=2", "gradient_accumulation_steps=2",
        "attention=flash", "max_steps=2", "logging_steps=2", "save_final=false",
        f"output_dir={tmp_path / 'run'}"])
    run = t_train.build_run(cfg, "cpu")
    assert run.attn_fn is t_train.flash_attention  # segment ids on every call
    assert run.eval_loader.per_replica_batch == 2 * 2 * 2 and len(run.eval_loader) == 2
    t_fa.reset_launch_counts()
    t_train.train_run(run)
    train_line, eval_line = _lines(tmp_path / "run")
    assert 0 < train_line["real_tokens_per_sec"] < train_line["tokens_per_sec"]
    assert eval_line["step"] == 2 and np.isfinite(eval_line["eval_loss"])
    batch = next(iter(run.eval_loader))
    assert batch["attention_mask"].max() >= 2  # eval rows pack
    assert run.evaluate() == eval_line["eval_loss"]


class _Sink:
    """A stand-in for a sink's package: records every call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def record(*a, **kw):
            self.calls.append((name, a, kw))
            return self
        return record


def test_wandb_and_tensorboard_sinks_get_every_line(tmp_path, monkeypatch):
    """With stand-in `wandb` and `torch.utils.tensorboard` modules, the
    trainer's writer (use_wandb, use_tensorboard) inits a wandb run with the
    config, sets `loss` and `eval_loss` to their minimum in its summary, logs
    every line to both, and closes both; a sink whose package cannot import
    is logged and left out, the JSONL still written."""
    wandb, board = _Sink(), _Sink()
    monkeypatch.setitem(sys.modules, "wandb", types.SimpleNamespace(
        init=wandb.init, define_metric=wandb.define_metric))
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=board.writer))
    t_train.run_training(t_config.load_config(TINY, _args(
        tmp_path / "on", "max_steps=2", "use_wandb=true", "use_tensorboard=true",
        "eval_dataset={synthetic: true, seq_length: 32, pseudo_dataset_len: 4}",
        "eval_steps=2")), device="cpu")
    names = [c[0] for c in wandb.calls]
    assert names[:3] == ["init", "define_metric", "define_metric"] and names[-1] == "finish"
    assert wandb.calls[0][2]["config"]["use_wandb"] is True
    assert {c[1][0]: c[2] for c in wandb.calls[1:3]} == {"loss": {"summary": "min"},
                                                          "eval_loss": {"summary": "min"}}
    logged = [(c[2]["step"], c[1][0]) for c in wandb.calls if c[0] == "log"]
    lines = _lines(tmp_path / "on")
    assert [(s, set(d)) for s, d in logged] == [(r["step"], set(r) - {"step"}) for r in lines]
    scalars = [(c[1][0], c[2]["global_step"]) for c in board.calls if c[0] == "add_scalar"]
    assert ("eval_loss", 2) in scalars and ("loss", 1) in scalars
    assert board.calls[0][1][0].endswith("tensorboard") and board.calls[-1][0] == "close"

    monkeypatch.setitem(sys.modules, "wandb", None)  # import fails
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    records = []
    handler = __import__("logging").Handler()
    handler.emit = records.append
    t_metrics.logger.addHandler(handler)
    try:
        writer = t_metrics.MetricsWriter(str(tmp_path / "off"), use_wandb=True,
                                         use_tensorboard=True)
        writer.log(1, {"loss": 1.5})
        writer.close()
    finally:
        t_metrics.logger.removeHandler(handler)
    warned = [r.getMessage() for r in records if r.levelname == "WARNING"]
    assert any(w.startswith("wandb unavailable") for w in warned)
    assert any(w.startswith("tensorboard unavailable") for w in warned)
    assert _lines(tmp_path / "off") == [{"step": 1, "loss": 1.5}]
