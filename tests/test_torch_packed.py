"""The port's packed training path: tokenizer-backed data packed with segment
ids through the train step, the trainer and the CLI, on the CPU (the
kernels' plain versions), against the JAX package where it has the same
function; and the trainer's fault sites (data_read, storage_write,
ckpt_commit).

Tiny preset in fp32 at seq <= 64. The tokenizer is a SentencePiece-Unigram
model trained inside the test; the JSONL is written by the test.
"""

import importlib
import json
import logging
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_pipeline_parallel_tpu_torch import convert
from llama_pipeline_parallel_tpu_torch import train as t_train
from llama_pipeline_parallel_tpu_torch.ckpt import checkpoint as t_ckpt
from llama_pipeline_parallel_tpu_torch.data import collator as t_collator
from llama_pipeline_parallel_tpu_torch.data.tokenization import expand_special_tokenizer
from llama_pipeline_parallel_tpu_torch.models.llama import model as t_llama
from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig as TConfig
from llama_pipeline_parallel_tpu_torch.models.llama.manifest import StageManifest as TManifest
from llama_pipeline_parallel_tpu_torch.optim import optimizer as t_optim
from llama_pipeline_parallel_tpu_torch.parallel import train_step as t_ts
from llama_pipeline_parallel_tpu_torch.train import (
    build_run,
    run_training,
    select_attention,
    train_run,
)
from llama_pipeline_parallel_tpu_torch.utils import config as t_config
from llama_pipeline_parallel_tpu_torch.utils import faults as t_faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAN = os.path.join(REPO, "conf", "llama_7b_flan_packed.yaml")
WORDS = ("the quick brown fox jumps over lazy dog pipeline parallelism cuts a model "
         "into stages what is capital of france paris").split()


def _install_transfer_stand_in() -> None:
    """A stand-in for `jax._src.sharding_impls.TransferToMemoryKind` where this
    jax lacks it: the reference's host stash imports it, and on the CPU never
    constructs it."""
    import jax._src.sharding_impls as impls

    if not hasattr(impls, "TransferToMemoryKind"):
        class TransferToMemoryKind:
            def __init__(self, memory_kind):
                self.memory_kind = memory_kind

        impls.TransferToMemoryKind = TransferToMemoryKind


_install_transfer_stand_in()


@pytest.fixture(scope="session")
def ref():
    mods = {"llama": "models.llama.model", "config": "models.llama.config",
            "manifest": "models.llama.manifest", "optim": "optim",
            "pl": "parallel.pipeline", "ts": "parallel.train_step",
            "mesh": "parallel.mesh", "fa": "ops.flash_attention",
            "attn": "ops.attention"}
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"llama_pipeline_parallel_tpu.{v}") for k, v in mods.items()})


def flan_rows(n: int, seed: int, prompt_words=(2, 7), target_words=(1, 4)) -> list[dict]:
    rng = np.random.RandomState(seed)
    return [{"inputs": " ".join(rng.choice(WORDS, rng.randint(*prompt_words))),
             "targets": " ".join(rng.choice(WORDS, rng.randint(*target_words)))}
            for _ in range(n)]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """A trained tokenizer (no pad token) under tok/ and a 64-row JSONL."""
    from tokenizers import SentencePieceUnigramTokenizer
    from transformers import PreTrainedTokenizerFast

    d = tmp_path_factory.mktemp("packed")
    rows = flan_rows(64, 0)
    spm = SentencePieceUnigramTokenizer()
    spm.train_from_iterator([f"{r['inputs']} {r['targets']}" for r in rows], vocab_size=80,
                            unk_token="<unk>", special_tokens=["<unk>", "<s>", "</s>"])
    PreTrainedTokenizerFast(tokenizer_object=spm._tokenizer, bos_token="<s>", eos_token="</s>",
                            unk_token="<unk>").save_pretrained(str(d / "tok"))
    (d / "train.jsonl").write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return d


def _tokenizer(data_dir):
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(str(data_dir / "tok"))
    expand_special_tokenizer(tok)
    return tok


def _packed_batches(data_dir, n_batches, rows=4, seq=64, pack=2):
    """Packed batches of `rows` rows from the port's collator."""
    coll = t_collator.PackedCausalLMCollator(_tokenizer(data_dir), seq, pack_factor=pack)
    out = [coll(flan_rows(rows * pack, seed)) for seed in range(1, n_batches + 1)]
    assert all(b["attention_mask"].max() >= 2 for b in out)  # rows do pack
    return out


def _flan_overrides(data_dir, out, *extra):
    """conf/llama_7b_flan_packed.yaml cut to one CPU and the tiny preset,
    on the test's JSONL and tokenizer."""
    return ["mesh.pp=1", "mesh.dp=1", "model={preset: tiny, dtype: float32}",
            f"tokenizer_path={data_dir / 'tok'}", f"dataset.path={data_dir / 'train.jsonl'}",
            "max_seq_length=48", "packing_factor=2", "per_device_train_batch_size=2",
            "gradient_accumulation_steps=2", "attention=flash", "save_final=false",
            "async_save=false", f"output_dir={out}", *extra]


# ---------------------------------------------------------------------------
# the train step and the forward on packed rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl,prologue", [("exact", False), ("flash", False), ("flash", True)],
                         ids=["exact", "flash", "flash-kernel-prologue"])
def test_packed_train_step_matches_reference(ref, data_dir, impl, prologue):
    """3 steps of the reference's jitted train step (pp = dp = 1, 2
    microbatches) on packed batches against the port's train_step from the
    same params: attention with the segment stream (the trainer's choice for
    a packed run: flash_attention with the mask, or the exact op), and with
    the prologue kernels (positions restart in each segment)."""
    cfg_j, cfg_t = ref.config.LlamaConfig.tiny(), TConfig.tiny()
    tree = ref.llama.init_params(jax.random.PRNGKey(2), cfg_j)
    params = convert.params_from_jax(jax.device_get(tree))
    mesh = ref.mesh.make_mesh(ref.mesh.MeshConfig(pp=1, dp=1))
    manifest = ref.manifest.StageManifest.for_config(cfg_j, 1)
    stacked = ref.pl.stack_stages(tree, manifest)
    kw = dict(learning_rate=5e-3, total_steps=20, warmup_steps=1)
    tx, sched = ref.optim.make_optimizer(ref.optim.OptimizerConfig(**kw))
    state = ref.ts.init_train_state(stacked, tx, mesh)
    ref_attn = ref.attn.attention if impl == "exact" else ref.fa.flash_attention
    step_fn = ref.ts.make_train_step(
        mesh, cfg_j, ref.pl.PipelineConfig(num_stages=1, num_microbatches=2, packed=True,
                                           kernel_prologue=prologue),
        tx, sched, stacked, attn_fn=ref_attn)

    leaves = {k: v.requires_grad_() for k, v in params.items()}
    t_state = t_ts.TrainState(step=0, params=leaves,
                              optimizer=t_optim.AdamW(leaves, t_optim.OptimizerConfig(**kw)))
    t_attn = select_attention(impl, 64, torch.device("cpu"), packed=True)
    for batch in _packed_batches(data_dir, 3):
        state, want = step_fn(state, {k: jnp.asarray(v) for k, v in batch.items()})
        got = t_ts.train_step(t_state, {k: torch.from_numpy(v) for k, v in batch.items()},
                              cfg_t, num_microbatches=2, attn_fn=t_attn,
                              kernel_prologue=prologue)
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]), rtol=1e-4)
    final = convert.params_from_jax(jax.device_get(ref.pl.unstack_stages(state.params, manifest)))
    for k, v in final.items():
        np.testing.assert_allclose(leaves[k].detach().numpy(), v.numpy(), rtol=0, atol=2e-5,
                                   err_msg=k)


@pytest.mark.parametrize("impl,prologue", [("exact", False), ("flash", False), ("flash", True)],
                         ids=["exact", "flash", "flash-kernel-prologue"])
def test_packed_logits_match_the_examples_run_alone(data_dir, impl, prologue):
    """Each segment of a packed row gives the logits of its example run
    alone (positions from 0, no segment ids), within 2e-5: the segment mask
    and the per-token positions hold packed examples apart."""
    cfg = TConfig.tiny()
    params = t_llama.init_params(cfg, device="cpu", seed=4)
    batch = _packed_batches(data_dir, 1, rows=2)[0]
    attn = select_attention(impl, 64, torch.device("cpu"), packed=True)
    with torch.no_grad():
        packed = t_llama.forward(params, torch.from_numpy(batch["input_ids"]),
                                 torch.from_numpy(batch["attention_mask"]),
                                 torch.from_numpy(batch["position_ids"]), cfg=cfg,
                                 attn_fn=attn, kernel_prologue=prologue)
        seen = 0
        for r in range(batch["input_ids"].shape[0]):
            seg = batch["attention_mask"][r]
            for s in range(1, seg.max() + 1):
                at = np.flatnonzero(seg == s)
                ids = torch.from_numpy(batch["input_ids"][r, at][None])
                alone = t_llama.forward(params, ids, cfg=cfg, attn_fn=attn,
                                        kernel_prologue=prologue)
                np.testing.assert_allclose(packed[r, at].numpy(), alone[0].numpy(), rtol=2e-5,
                                           atol=2e-5, err_msg=f"row {r} segment {s}")
                seen += 1
    assert seen >= 3


def test_packed_flash_masks_what_the_exact_op_masks(data_dir):
    """On packed rows the flash path with segments gives the exact op's
    per-token outputs on real tokens and exactly 0 on pad rows; without the
    segment stream (the unpacked path) it does not."""
    batch = _packed_batches(data_dir, 1, rows=2)[0]
    mask = torch.from_numpy(batch["attention_mask"])
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 64, 4, 16, generator=g) for _ in range(3))
    exact = t_llama.attention(q, k, v, mask)
    flash = select_attention("flash", 64, torch.device("cpu"), packed=True)(q, k, v, mask)
    real = mask != 0
    np.testing.assert_allclose(flash[real].numpy(), exact[real].numpy(), rtol=1e-5, atol=1e-6)
    assert (flash[~real] == 0).all() and (~real).any()
    unpacked = select_attention("flash", 64, torch.device("cpu"))(q, k, v, mask)
    assert (unpacked[real] - exact[real]).abs().max() > 1e-2


# ---------------------------------------------------------------------------
# the trainer and the CLI
# ---------------------------------------------------------------------------

def test_cli_runs_the_packed_flan_config(data_dir, tmp_path):
    """conf/llama_7b_flan_packed.yaml through cli.py on the CPU with a
    tokenizer directory, packing_factor=2, the quarantine armed and a
    `data_read` corrupt rule from LPT_FAULT_PLAN: finite losses, and the
    packing and quarantine columns in metrics.jsonl."""
    plan = {"faults": [{"site": "data_read", "op": "corrupt", "match": "7"}]}
    env = dict(os.environ, LPT_FAULT_PLAN=json.dumps(plan), LPT_RETRY_MAX_ATTEMPTS="1")
    cmd = [sys.executable, "-m", "llama_pipeline_parallel_tpu_torch.cli", "--config", FLAN,
           "--device", "cpu", *_flan_overrides(data_dir, tmp_path, "max_steps=4",
                                                "logging_steps=2", "resume=false",
                                                "data={quarantine_bad_shards: true, "
                                                "log_sample_ids: true}")]
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(x) for x in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in lines] == [2, 4]
    for r in lines:
        assert np.isfinite(r["loss"])
        assert r["packing_dropped_total"] >= 0 and 0 <= r["packing_drop_rate"] <= 1
        assert r["data_quarantined_records"] > 0
    ledger = [json.loads(x) for x in open(tmp_path / "samples.jsonl")]
    assert len(ledger) >= 4 and all(len(x["indices"]) == 8 for x in ledger)


def test_packed_resume_mid_epoch_repeats_the_uninterrupted_run(data_dir, tmp_path):
    """Save at step 3 of 6 (8 examples a step, 8 steps an epoch), resume in a
    new run: the resumed run reads the uninterrupted run's batches (the
    sample ledger) and repeats its losses."""
    def run(out, *extra):
        cfg = t_config.load_config(FLAN, _flan_overrides(
            data_dir, out, "total_steps=6", "data={log_sample_ids: true}", *extra))
        return run_training(cfg, device="cpu")

    def ledger(out):
        return [json.loads(x) for x in open(out / "samples.jsonl")]

    whole = run(tmp_path / "a", "max_steps=6", "resume=false")
    first = run(tmp_path / "b", "max_steps=3", "save_steps=3", "resume=false")
    n_first = len(ledger(tmp_path / "b"))
    second = run(tmp_path / "b", "max_steps=6")
    assert (first["steps_per_epoch"], second["start_step"]) == (8, 3)
    np.testing.assert_allclose(first["losses"] + second["losses"], whole["losses"], rtol=1e-6)
    want = ledger(tmp_path / "a")[:6]
    got = ledger(tmp_path / "b")
    assert got[:3] + got[n_first:n_first + 3] == want
    meta = t_ckpt.CheckpointManager(str(tmp_path / "b")).load_meta(3)
    assert meta["data_state"]["consumed_samples"] == 24
    assert meta["data_state"]["global_batch_examples"] == 8


def test_tokenizer_seam_replaces_only_the_load(data_dir, tmp_path):
    """build_run(tokenizer=...) uses the object it is given (still through
    expand_special_tokenizer and the vocabulary check) and needs no
    tokenizer_path."""
    from transformers import AutoTokenizer

    cfg = t_config.load_config(FLAN, _flan_overrides(data_dir, tmp_path, "resume=false"))
    del cfg["tokenizer_path"]
    tok = AutoTokenizer.from_pretrained(str(data_dir / "tok"))
    assert tok.pad_token is None
    run = build_run(cfg, "cpu", tokenizer=tok)
    assert run.loader.collate_fn.tokenizer is tok and tok.pad_token == tok.eos_token
    assert run.loader.per_replica_batch == 8 and run.seq_length == 48
    small = t_config.load_config(FLAN, _flan_overrides(data_dir, tmp_path, "resume=false",
                                                       "model={preset: tiny, vocab_size: 32}"))
    with pytest.raises(ValueError, match="vocab_size is 32"):
        build_run(small, "cpu", tokenizer=AutoTokenizer.from_pretrained(str(data_dir / "tok")))


# ---------------------------------------------------------------------------
# fault sites
# ---------------------------------------------------------------------------

@pytest.fixture()
def no_backoff(monkeypatch):
    monkeypatch.setenv("LPT_RETRY_BASE_DELAY_S", "0")
    monkeypatch.delenv(t_faults.ENV_PLAN, raising=False)
    yield
    t_faults.configure(None)


def _tiny(tmp_path, *extra):
    return t_config.load_config(os.path.join(REPO, "conf", "tiny_smoke.yaml"), [
        "mesh.pp=1", "mesh.dp=1", f"output_dir={tmp_path}", "max_steps=1", "total_steps=4",
        "dataset.pseudo_dataset_len=8", *extra])


def test_storage_write_errors_are_retried_and_the_checkpoint_commits(tmp_path, no_backoff):
    """A `storage_write` error rule on meta.json with times: 2 fails the
    first two writes; the retry policy writes it on the third and the final
    checkpoint commits and verifies."""
    plan = "fault_plan={faults: [{site: storage_write, op: error, match: meta.json, times: 2}]}"
    run = build_run(_tiny(tmp_path, plan, "save_final=true"), "cpu")
    train_run(run)
    stats = t_faults.active().stats()
    assert stats[0]["fired"] == 2 and stats[0]["seen"] == 3
    mgr = t_ckpt.CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 1
    mgr.verify(1)


def test_ckpt_commit_fault_leaves_no_complete_checkpoint(tmp_path, no_backoff):
    """An `error` at `ckpt_commit` fires after the files are written and
    before meta.json: the save fails and the directory is not a checkpoint."""
    t_faults.configure({"faults": [{"site": "ckpt_commit", "op": "error", "at_step": 2}]})
    cfg = TConfig.tiny()
    params = t_llama.init_params(cfg, device="cpu")
    mgr = t_ckpt.CheckpointManager(str(tmp_path))
    manifest = TManifest(num_layers=cfg.num_hidden_layers, num_stages=1)
    mgr.save(1, params, manifest, cfg)
    with pytest.raises(t_faults.InjectedFault, match="ckpt_commit"):
        mgr.save(2, params, manifest, cfg)
    assert os.path.isfile(tmp_path / "checkpoint-2" / t_ckpt.PARAMS_FILE)
    assert not os.path.exists(tmp_path / "checkpoint-2" / "meta.json")
    assert mgr.latest_step() == 1


def test_storage_read_fault_is_retried_on_restore(tmp_path, no_backoff):
    """A `storage_write` error rule on the params file fails the restore's
    first read; the retry reads it again and the resume goes on."""
    train_run(build_run(_tiny(tmp_path, "save_final=true"), "cpu"))
    plan = ("fault_plan={faults: [{site: storage_write, op: error, "
            "match: params.safetensors, times: 1}]}")
    run = build_run(_tiny(tmp_path, plan, "max_steps=2"), "cpu")
    assert run.start_step == 1
    assert t_faults.active().stats()[0]["fired"] == 1


@pytest.mark.parametrize("site", ["action_execute", "barrier", "device_probe",
                                  "gateway_dispatch"])
def test_fault_plan_at_a_site_this_trainer_lacks_is_refused(tmp_path, no_backoff, monkeypatch,
                                                            site):
    """Every fault site has its firer in the port now: the trainer fires
    `barrier` (parallel/distributed.barrier), and a rule at a site it does
    not fire is the pod's (the supervisor's `device_probe`, the actuators'
    `action_execute`, the gateway's `gateway_dispatch`), so it is taken, from
    the config and from LPT_FAULT_PLAN (which wins over the config), and
    names itself in the log when it is not the trainer's. A site no
    component fires is refused by the plan's own check."""
    records = []
    handler = logging.Handler(logging.INFO)
    handler.emit = records.append
    t_train.logger.addHandler(handler)
    try:
        build_run(_tiny(tmp_path, f"fault_plan={{faults: [{{site: {site}, op: stall}}]}}"),
                  "cpu")
        assert [r["site"] for r in t_faults.active().stats()] == [site]
        monkeypatch.setenv(t_faults.ENV_PLAN, json.dumps(
            {"faults": [{"site": site, "op": "stall"}, {"site": "data_read", "op": "slow"}]}))
        build_run(_tiny(tmp_path, "fault_plan={faults: [{site: data_read, op: slow}]}"), "cpu")
        assert [r["site"] for r in t_faults.active().stats()] == [site, "data_read"]
    finally:
        t_train.logger.removeHandler(handler)
    named = [r.getMessage() for r in records if "does not fire" in r.getMessage()]
    assert len(named) == (0 if site == "barrier" else 2)
    assert all(f"'{site}'" in m for m in named)
    monkeypatch.setenv(t_faults.ENV_PLAN, json.dumps(
        {"faults": [{"site": "data_read", "op": "slow", "seconds": 0}]}))
    build_run(_tiny(tmp_path, f"fault_plan={{faults: [{{site: {site}, op: stall}}]}}"), "cpu")
    assert t_faults.active().stats()[0]["site"] == "data_read"
    monkeypatch.delenv(t_faults.ENV_PLAN)
    with pytest.raises(t_faults.FaultPlanError, match="unknown site 'nowhere'"):
        build_run(_tiny(tmp_path, "fault_plan={faults: [{site: nowhere, op: stall}]}"), "cpu")
