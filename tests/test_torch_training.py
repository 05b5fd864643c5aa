"""The port's config, data, conversion, model, optimizer and train step
against the JAX package's, and a CPU run of the port's CLI.

Same numpy inputs / seeds through both packages, fp32 (the `tiny` preset);
tolerances stated per check.
"""

import dataclasses
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
from llama_pipeline_parallel_tpu_torch.data import collator as t_collator
from llama_pipeline_parallel_tpu_torch.data import datasets as t_datasets
from llama_pipeline_parallel_tpu_torch.data import loader as t_loader
from llama_pipeline_parallel_tpu_torch.ckpt import checkpoint as t_ckpt
from llama_pipeline_parallel_tpu_torch.models.llama import manifest as t_manifest
from llama_pipeline_parallel_tpu_torch.models.llama import model as t_llama
from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig as TConfig
from llama_pipeline_parallel_tpu_torch.optim import optimizer as t_optim
from llama_pipeline_parallel_tpu_torch.parallel import train_step as t_ts
from llama_pipeline_parallel_tpu_torch.train import build_run, run_training, select_attention
from llama_pipeline_parallel_tpu_torch.utils import config as t_config
from tests.test_torch_pipeline import GRAD_RTOL, LOSS_RTOL, _assert_grads_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fp32 forward through 4 layers: matmul summation order differs between XLA
# and PyTorch's CPU kernels
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="session")
def ref():
    """The reference modules, after installing the stand-in for
    `jax._src.sharding_impls.TransferToMemoryKind` where this jax lacks it
    (imported by the reference's host stash, never constructed on the CPU)."""
    import jax._src.sharding_impls as impls

    if not hasattr(impls, "TransferToMemoryKind"):
        class TransferToMemoryKind:
            def __init__(self, memory_kind):
                self.memory_kind = memory_kind

        impls.TransferToMemoryKind = TransferToMemoryKind
    mods = {"llama": "models.llama.model", "config": "models.llama.config",
            "manifest": "models.llama.manifest", "optim": "optim",
            "pl": "parallel.pipeline", "ts": "parallel.train_step",
            "mesh": "parallel.mesh", "fa": "ops.flash_attention",
            "attn": "ops.attention", "cfgio": "utils.config",
            "collator": "data.collator", "datasets": "data.datasets",
            "loader": "data.loader", "ckpt": "ckpt.checkpoint"}
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"llama_pipeline_parallel_tpu.{v}") for k, v in mods.items()})


def _params(ref, seed=0):
    """Reference init -> (jax tree, port params carried over by convert.py)."""
    tree = ref.llama.init_params(jax.random.PRNGKey(seed), ref.config.LlamaConfig.tiny())
    return tree, convert.params_from_jax(jax.device_get(tree))


def _batch(vocab, b, s, seed, pad_tail=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, vocab, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    if pad_tail:
        mask[:, -pad_tail:] = 0
    return {"input_ids": ids, "attention_mask": mask,
            "position_ids": np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy(),
            "labels": np.where(mask == 1, ids, t_collator.IGNORE_INDEX).astype(np.int32)}


# ---------------------------------------------------------------------------
# config, data, conversion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", ["tiny", "llama_7b", "llama_13b", "llama_33b",
                                    "llama_65b", "llama2_7b", "llama2_13b",
                                    "llama2_70b", "codellama_34b_16k"])
def test_model_config_presets(ref, preset):
    want = getattr(ref.config.LlamaConfig, preset)()
    got = getattr(TConfig, preset)()
    for field in dataclasses.fields(TConfig):
        w, g = getattr(want, field.name), getattr(got, field.name)
        if field.name in ("dtype", "param_dtype"):
            assert jnp.dtype(w).name == str(g).removeprefix("torch."), field.name
        else:
            assert g == w, field.name
    assert (got.head_dim, got.kv_heads) == (want.head_dim, want.kv_heads)


@pytest.mark.parametrize("name", sorted(f for f in os.listdir(os.path.join(REPO, "conf"))
                                        if f.endswith(".yaml")))
def test_load_config_matches_reference(ref, name):
    overrides = ["mesh.pp=1", "--learning_rate=1e-4", "model.num_hidden_layers=2",
                 "dataset={synthetic: true, seq_length: 64}"]
    path = os.path.join(REPO, "conf", name)
    assert t_config.load_config(path, overrides) == ref.cfgio.load_config(path, overrides)


def test_synthetic_dataset_and_labels_match_reference(ref):
    kw = dict(vocab_size=300, seq_length=24, pseudo_dataset_len=16, seed=5, pad_fraction=0.25)
    want, got = ref.datasets.SyntheticDataset(**kw), t_datasets.SyntheticDataset(**kw)
    for idx in (0, 7, 15):
        for key, arr in want[idx].items():
            np.testing.assert_array_equal(got[idx][key], arr)
    ids = np.arange(20, dtype=np.int32).reshape(2, 10)
    mask = np.ones_like(ids)
    mask[1, 7:] = 0
    prompt = np.array([3, 1], np.int32)
    np.testing.assert_array_equal(t_collator.get_lm_labels(ids, mask, prompt),
                                  ref.collator.get_lm_labels(ids, mask, prompt))


@pytest.mark.parametrize("start_epoch,start_batch", [(0, 0), (1, 2)])
def test_loader_batches_match_reference(ref, start_epoch, start_batch):
    """Same batches for the same seed over an epoch boundary, from an O(1)
    resume position."""
    ds_kw = dict(vocab_size=64, seq_length=8, pseudo_dataset_len=22, seed=1)
    want_loader = ref.loader.DataLoader(ref.datasets.SyntheticDataset(**ds_kw),
                                        ref.collator.PretokenizedCollator(),
                                        per_replica_batch=4, seed=9)
    got_loader = t_loader.DataLoader(t_datasets.SyntheticDataset(**ds_kw),
                                     t_collator.PretokenizedCollator(),
                                     per_replica_batch=4, seed=9)
    assert len(got_loader) == len(want_loader) == 5
    want = iter(ref.loader.RepeatingLoader(want_loader, start_epoch, start_batch))
    got = iter(t_loader.RepeatingLoader(got_loader, start_epoch, start_batch))
    for _ in range(7):
        w, g = next(want), next(got)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key])


def test_convert_round_trip_is_exact(ref):
    tree, params = _params(ref)
    assert {k: tuple(v.shape) for k, v in params.items()} == t_llama.param_shapes(TConfig.tiny())
    back = convert.params_to_jax(params)
    flat_want = jax.tree_util.tree_leaves_with_path(jax.device_get(tree))
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_back) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_back[path], leaf)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pad_tail", [0, 5])
def test_forward_logits_and_loss_match_reference(ref, pad_tail):
    """Plain and right-padded batches, exact attention with the mask."""
    tree, params = _params(ref)
    cfg_j, cfg_t = ref.config.LlamaConfig.tiny(), TConfig.tiny()
    batch = _batch(cfg_t.vocab_size, 2, 24, seed=2, pad_tail=pad_tail)
    want = ref.llama.forward(tree, jnp.asarray(batch["input_ids"]),
                             jnp.asarray(batch["attention_mask"]),
                             jnp.asarray(batch["position_ids"]), cfg=cfg_j)
    model = t_llama.LlamaForCausalLM(cfg_t, params)
    got = model(torch.from_numpy(batch["input_ids"]), torch.from_numpy(batch["attention_mask"]),
                torch.from_numpy(batch["position_ids"]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **LOGIT_TOL)
    labels = batch["labels"]
    want_loss = ref.llama.loss_fn(want, jnp.asarray(labels))
    got_loss = t_llama.loss_fn(got, torch.from_numpy(labels))
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-6)
    got_sum, got_count = t_llama.token_loss_sum_and_count(got, torch.from_numpy(labels))
    want_sum, want_count = ref.llama.token_loss_sum_and_count(want, jnp.asarray(labels))
    assert int(got_count) == int(want_count)
    np.testing.assert_allclose(got_sum.item(), float(want_sum), rtol=1e-5)


def test_flash_forward_matches_exact_on_real_tokens(ref):
    """The model on the port's flash path (segment stream dropped, as the
    trainer runs it) against the reference's exact forward, on the positions
    that carry a target (right padding: pads are never keys of real rows)."""
    tree, params = _params(ref)
    batch = _batch(256, 2, 64, seed=3, pad_tail=9)
    want = ref.llama.forward(tree, jnp.asarray(batch["input_ids"]),
                             jnp.asarray(batch["attention_mask"]), cfg=ref.config.LlamaConfig.tiny())
    attn = select_attention("flash", 64, torch.device("cpu"))
    got = t_llama.forward(params, torch.from_numpy(batch["input_ids"]),
                          torch.from_numpy(batch["attention_mask"]), cfg=TConfig.tiny(),
                          attn_fn=attn)
    real = batch["attention_mask"] == 1
    np.testing.assert_allclose(got.detach().numpy()[real], np.asarray(want)[real], **LOGIT_TOL)


def test_remat_gives_the_same_gradients(ref):
    _, params = _params(ref)
    batch = _batch(256, 2, 16, seed=4)
    grads = []
    for remat in (False, True):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        logits = t_llama.forward(leaves, torch.from_numpy(batch["input_ids"]),
                                 cfg=TConfig.tiny(), remat=remat)
        t_llama.loss_fn(logits, torch.from_numpy(batch["labels"])).backward()
        grads.append({k: v.grad for k, v in leaves.items()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_schedule_matches_reference(ref):
    want = ref.optim.warmup_decay_schedule(2e-3, total_steps=40, warmup_steps=6)
    got = t_optim.warmup_decay_schedule(2e-3, total_steps=40, warmup_steps=6)
    for count in (0, 1, 5, 6, 7, 23, 39, 40, 45):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, atol=1e-12)
    with pytest.raises(ValueError):
        t_optim.warmup_decay_schedule(1.0, total_steps=10, warmup_steps=10)


def test_optimizer_matches_optax_over_several_updates(ref):
    """Identical gradient sequences (some large enough to clip) through the
    reference's optax chain and the port's AdamW; fp32 params after every
    update within a few ulps of the update size."""
    rng = np.random.RandomState(6)
    shapes = {"w": (6, 5), "norm": (5,), "emb": (3, 4)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(learning_rate=1e-2, weight_decay=0.01, max_grad_norm=2.0,
              total_steps=12, warmup_steps=2)
    tx, sched = ref.optim.make_optimizer(ref.optim.OptimizerConfig(**kw))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    opt = t_optim.AdamW(tp, t_optim.OptimizerConfig(**kw))
    for step in range(6):
        scale = 3.0 if step % 2 else 0.05  # alternate clipped / unclipped steps
        g = {k: (scale * rng.randn(*s)).astype(np.float32) for k, s in shapes.items()}
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = {k: jp[k] + updates[k] for k in jp}
        lr = opt.step(tp, {k: torch.from_numpy(v) for k, v in g.items()})
        np.testing.assert_allclose(lr, float(sched(step)), rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(lr, opt.schedule(step))
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def carried(ref):
    """The reference trains 2 steps at tiny, then its third; its params and
    optax moments after 2 steps are carried into the port
    (convert.optimizer_state_from_jax). Holds both sides' third step: the
    reference's gradients (make_pipeline_loss_and_grad on the same params
    and batch), metrics and params after it."""
    cfg_j = ref.config.LlamaConfig.tiny()
    tree, _ = _params(ref, seed=2)
    mesh = ref.mesh.make_mesh(ref.mesh.MeshConfig(pp=1, dp=1))
    manifest = ref.manifest.StageManifest.for_config(cfg_j, 1)
    tx, sched = ref.optim.make_optimizer(ref.optim.OptimizerConfig(**CARRY_OPT))
    stacked = ref.pl.stack_stages(tree, manifest)
    state = ref.ts.init_train_state(stacked, tx, mesh)
    pcfg = ref.pl.PipelineConfig(num_stages=1, num_microbatches=2)
    step_fn = ref.ts.make_train_step(mesh, cfg_j, pcfg, tx, sched, stacked,
                                     attn_fn=ref.attn.attention)
    batches = [_batch(cfg_j.vocab_size, 4, 32, seed=s, pad_tail=3) for s in (7, 8, 9)]
    for b in batches[:2]:
        state, _ = step_fn(state, {k: jnp.asarray(v) for k, v in b.items()})

    def canonical(stacked_tree):
        return convert.params_from_jax(jax.device_get(ref.pl.unstack_stages(stacked_tree,
                                                                            manifest)))

    third = {k: jnp.asarray(v) for k, v in batches[2].items()}
    grad_fn = jax.jit(ref.pl.make_pipeline_loss_and_grad(mesh, cfg_j, pcfg, stacked,
                                                         attn_fn=ref.attn.attention))
    grads = canonical(grad_fn(state.params, third)[1])
    moments = ref.ckpt._canonicalize_moments(jax.device_get(state.opt_state), manifest,
                                             to_canonical=True)
    params = canonical(state.params)
    state, metrics = step_fn(state, third)
    return types.SimpleNamespace(params=params, moments=moments, batch=batches[2],
                                 grads=grads, metrics=metrics, final=canonical(state.params))


# the reference's optimizer in the carried-state tests
CARRY_OPT = dict(learning_rate=5e-3, total_steps=20, warmup_steps=1)


def _carried_optimizer(carried, leaves):
    opt = t_optim.AdamW(leaves, t_optim.OptimizerConfig(**CARRY_OPT))
    opt.load_state_dict(convert.optimizer_state_from_jax(carried.moments))
    return opt


def test_optimizer_state_carries_from_the_reference_and_back(ref, carried):
    """The reference's optax moments after 2 steps, carried into the port's
    AdamW (count 2), convert back leaf for leaf; given the reference's own
    third-step gradients, the carried AdamW's update gives the reference's
    third-step params within the optimizer parity test's limits (rtol 1e-6,
    atol 1e-7): the moments, the count that the schedule and the bias
    correction read, and the clip all carried. (Fed the port's own
    gradients instead, the params would differ by the gradients' fp32
    summation order, which Adam magnifies where a gradient element is near
    zero and its moments are zero: test_carried_step_gradients_match_reference
    holds those gradients.)"""
    leaves = {k: v.clone() for k, v in carried.params.items()}
    opt = _carried_optimizer(carried, leaves)
    assert opt.count == 2
    back = convert.optimizer_state_to_jax(opt.state_dict(), carried.moments)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(carried.moments))
    for got, want in zip(jax.tree_util.tree_leaves(back),
                         jax.tree_util.tree_leaves(carried.moments)):
        np.testing.assert_array_equal(got, np.asarray(want))
    lr = opt.step(leaves, carried.grads)
    np.testing.assert_allclose(lr, float(carried.metrics["lr"]), rtol=1e-6)
    assert opt.count == int(carried.metrics["step"]) == 3
    for k, v in carried.final.items():
        np.testing.assert_allclose(leaves[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_carried_step_gradients_match_reference(ref, carried):
    """One port train_step from the carried params and moments on the
    reference's third batch: its loss, gradient norm, learning rate and step
    are the reference's third step's, and its gradients are the reference's
    within GRAD_RTOL of each leaf's largest element (the train step's
    limits)."""
    leaves = {k: v.clone().requires_grad_() for k, v in carried.params.items()}
    t_state = t_ts.TrainState(step=2, params=leaves,
                              optimizer=_carried_optimizer(carried, leaves))
    got = t_ts.train_step(t_state, {k: torch.from_numpy(v) for k, v in carried.batch.items()},
                          TConfig.tiny(), num_microbatches=2)
    want = carried.metrics
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]),
                               rtol=GRAD_RTOL)
    np.testing.assert_allclose(got["lr"], float(want["lr"]), rtol=1e-6)
    assert got["step"] == int(want["step"]) == 3
    _assert_grads_close({k: p.grad for k, p in leaves.items()}, carried.grads)


# ---------------------------------------------------------------------------
# the slice as a whole: the train step
# ---------------------------------------------------------------------------

# the loss heads: dense (lm_head + CE), the vocab-chunked op
# (loss_vocab_chunks=4), and the CE kernels (kernels.ce=pallas), which run
# their plain versions on the CPU against the reference's Pallas kernels in
# interpret mode; likewise the prologue kernels (kernels.prologue=pallas)
HEADS = {"dense": dict(), "chunked": dict(loss_chunks=4),
         "kernel": dict(loss_chunks=4, kernel_ce=True)}


@pytest.mark.parametrize("impl,head,prologue", [
    pytest.param("exact", "dense", False, id="exact"),
    pytest.param("flash", "dense", False, id="flash"),
    pytest.param("exact", "chunked", False, id="exact-chunked"),
    pytest.param("exact", "kernel", False, id="exact-kernel"),
    pytest.param("flash", "kernel", False, id="flash-kernel"),
    pytest.param("exact", "kernel", True, id="exact-kernel-prologue"),
    pytest.param("flash", "kernel", True, id="flash-kernel-prologue"),
])
def test_train_step_matches_reference(ref, impl, head, prologue):
    """3 steps of the reference's jitted train step on a 1-device mesh
    (pp = dp = 1, 2 microbatches) against the port's train_step, from the
    same params (convert.py) and the same loader batches (right-padded rows,
    so the valid-target count is not the row count), with each loss head and
    with the composed or the kernel prologue (`prologue`)."""
    cfg_j, cfg_t = ref.config.LlamaConfig.tiny(), TConfig.tiny()
    tree, params = _params(ref, seed=1)
    mesh = ref.mesh.make_mesh(ref.mesh.MeshConfig(pp=1, dp=1))
    manifest = ref.manifest.StageManifest.for_config(cfg_j, 1)
    stacked = ref.pl.stack_stages(tree, manifest)
    kw = dict(learning_rate=5e-3, total_steps=20, warmup_steps=1)
    tx, sched = ref.optim.make_optimizer(ref.optim.OptimizerConfig(**kw))
    state = ref.ts.init_train_state(stacked, tx, mesh)
    if impl == "exact":
        ref_attn = ref.attn.attention
    else:  # what the reference trainer selects for attention=flash, unpacked
        def ref_attn(q, k, v, padding_mask=None, *, causal=True):
            return ref.fa.flash_attention(q, k, v, None, causal=causal)
    step_fn = ref.ts.make_train_step(
        mesh, cfg_j, ref.pl.PipelineConfig(num_stages=1, num_microbatches=2,
                                           kernel_prologue=prologue, **HEADS[head]),
        tx, sched, stacked, attn_fn=ref_attn)

    leaves = {k: v.requires_grad_() for k, v in params.items()}
    t_state = t_ts.TrainState(step=0, params=leaves,
                              optimizer=t_optim.AdamW(leaves, t_optim.OptimizerConfig(**kw)))
    t_attn = select_attention(impl, 32, torch.device("cpu"))
    loader = t_loader.DataLoader(
        t_datasets.SyntheticDataset(vocab_size=256, seq_length=32, pseudo_dataset_len=16,
                                    seed=3, pad_fraction=0.25),
        t_collator.PretokenizedCollator(), per_replica_batch=4, seed=3)
    for batch in list(loader)[:3]:
        state, want = step_fn(state, {k: jnp.asarray(v) for k, v in batch.items()})
        got = t_ts.train_step(t_state, {k: torch.from_numpy(v) for k, v in batch.items()},
                              cfg_t, num_microbatches=2, attn_fn=t_attn, remat=True,
                              head=t_ts.LossHead(**HEADS[head]), kernel_prologue=prologue)
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(got["lr"], float(want["lr"]), rtol=1e-6)
        assert got["step"] == int(want["step"])
    final = convert.params_from_jax(jax.device_get(ref.pl.unstack_stages(state.params, manifest)))
    # Adam's step is ~lr per element whatever the gradient's size: after 3
    # steps of 5e-3 the params agree to well under one step
    for k, v in final.items():
        np.testing.assert_allclose(leaves[k].detach().numpy(), v.numpy(), rtol=0, atol=2e-5,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# trainer and CLI
# ---------------------------------------------------------------------------

def test_cli_cpu_run_loss_decreases(tmp_path):
    """`python -m llama_pipeline_parallel_tpu_torch.cli` on tiny_smoke, one
    device, on the CPU. A 4-row dataset repeats every step, so the model can
    memorise it and the loss must fall (fresh random rows could not go below
    ln(vocab))."""
    cmd = [sys.executable, "-m", "llama_pipeline_parallel_tpu_torch.cli", "--config",
           "conf/tiny_smoke.yaml", "--device", "cpu", "mesh.pp=1", "mesh.dp=1",
           f"output_dir={tmp_path}", "dataset.pseudo_dataset_len=4", "logging_steps=4"]
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = [json.loads(x) for x in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in lines] == [4, 8, 12]
    assert {"loss", "lr", "grad_norm", "tokens_per_sec", "step_time"} <= set(lines[0])
    assert lines[-1]["loss"] < lines[0]["loss"] - 0.5


def test_cli_cpu_run_with_kernel_ce_head(tmp_path):
    """The CLI with `kernels.ce=pallas loss_vocab_chunks=4` on the CPU (the
    kernels' plain versions) gives the dense head's losses step by step."""
    args = ["mesh.pp=1", "mesh.dp=1", "dataset.pseudo_dataset_len=4", "logging_steps=4",
            "max_steps=8"]
    cmd = [sys.executable, "-m", "llama_pipeline_parallel_tpu_torch.cli", "--config",
           "conf/tiny_smoke.yaml", "--device", "cpu", *args, f"output_dir={tmp_path}/ce",
           "kernels.ce=pallas", "loss_vocab_chunks=4"]
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    got = [json.loads(x) for x in open(tmp_path / "ce" / "metrics.jsonl")]
    dense = run_training(t_config.load_config(os.path.join(REPO, "conf", "tiny_smoke.yaml"),
                                              args + [f"output_dir={tmp_path}/dense"]),
                         device="cpu")
    assert [r["step"] for r in got] == [4, 8]
    want = [np.mean(dense["losses"][:4]), np.mean(dense["losses"][4:])]
    np.testing.assert_allclose([r["loss"] for r in got], want, rtol=1e-5)
    assert got[-1]["loss"] < got[0]["loss"]


def test_cli_cpu_run_with_kernel_prologue_and_ce_head(tmp_path):
    """The CLI with `kernels.prologue=pallas kernels.ce=pallas
    loss_vocab_chunks=4` on the CPU (both kernel families' plain versions)
    gives the composed prologue and dense head's losses step by step, to fp32
    summation order (rtol 1e-5, as the CE head alone)."""
    args = ["mesh.pp=1", "mesh.dp=1", "dataset.pseudo_dataset_len=4", "logging_steps=4",
            "max_steps=8"]
    cmd = [sys.executable, "-m", "llama_pipeline_parallel_tpu_torch.cli", "--config",
           "conf/tiny_smoke.yaml", "--device", "cpu", *args, f"output_dir={tmp_path}/k",
           "kernels.prologue=pallas", "kernels.ce=pallas", "loss_vocab_chunks=4"]
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "prologue=True" in res.stderr
    got = [json.loads(x) for x in open(tmp_path / "k" / "metrics.jsonl")]
    composed = run_training(t_config.load_config(
        os.path.join(REPO, "conf", "tiny_smoke.yaml"), args + [f"output_dir={tmp_path}/c"]),
        device="cpu")
    assert [r["step"] for r in got] == [4, 8]
    want = [np.mean(composed["losses"][:4]), np.mean(composed["losses"][4:])]
    np.testing.assert_allclose([r["loss"] for r in got], want, rtol=1e-5)
    assert got[-1]["loss"] < got[0]["loss"]


def test_trainer_refuses_what_it_does_not_run(tmp_path):
    cfg = t_config.load_config(os.path.join(REPO, "conf", "tiny_smoke.yaml"),
                               [f"output_dir={tmp_path}"])
    # tiny_smoke is pp=2 dp=2: a replica a process, so one process is refused
    with pytest.raises(ValueError, match="1 processes for mesh pp2xdp2"):
        run_training(cfg, device="cpu")
    # tp runs a process a (stage, replica, tp rank): one process is refused
    with pytest.raises(ValueError, match="1 processes for mesh pp2xdp2xtp2xsp1: run it in "
                                         "pp\\*dp\\*tp=8 processes"):
        run_training(t_config.load_config(os.path.join(REPO, "conf", "tiny_smoke.yaml"),
                                          [f"output_dir={tmp_path}", "mesh.tp=2"]),
                     device="cpu")
    # sp runs a process a (stage, replica, sp rank): one process is refused
    with pytest.raises(ValueError, match="1 processes for mesh pp2xdp2xtp1xsp2: run it in "
                                         "pp\\*dp\\*sp=8 processes"):
        run_training(t_config.load_config(os.path.join(REPO, "conf", "tiny_smoke.yaml"),
                                          [f"output_dir={tmp_path}", "mesh.sp=2"]),
                     device="cpu")
    one = ["mesh.pp=1", "mesh.dp=1", f"output_dir={tmp_path}"]

    def build(*overrides):
        return build_run(t_config.load_config(os.path.join(REPO, "conf", "tiny_smoke.yaml"),
                                              one + list(overrides)), device="cpu")

    assert build("kernels.prologue=pallas").kernel_prologue
    assert not build().kernel_prologue
    with pytest.raises(ValueError, match="unknown kernels"):
        build("kernels.attention=pallas")
    with pytest.raises(ValueError, match="'xla' or 'pallas'"):
        build("kernels.ce=cuda")
    with pytest.raises(ValueError, match="must divide vocab_size=256"):
        build("loss_vocab_chunks=3")
    run = build("kernels.ce=pallas", "loss_vocab_chunks=8")
    assert run.head == t_ts.LossHead(loss_chunks=8, kernel_ce=True)
    assert build().head == t_ts.LossHead()
    with pytest.raises(ValueError, match="unknown attention"):
        select_attention("fast", 32, torch.device("cpu"))
    with pytest.raises(ValueError, match="model_cfg"):
        select_attention("auto", 4096, torch.device("cuda"))
    assert select_attention("auto", 4096, torch.device("cpu")) is t_llama.attention


def _build_tiny(tmp_path, *overrides):
    """build_run of tiny_smoke on one CPU device, with `overrides`."""
    return build_run(t_config.load_config(
        os.path.join(REPO, "conf", "tiny_smoke.yaml"),
        ["mesh.pp=1", "mesh.dp=1", f"output_dir={tmp_path}", *overrides]), device="cpu")


_REFUSED_KEYS = [
    # the trainer's actions block takes resize_on_request alone; fleetctl's
    # actuator blocks are refused by name, as the JAX trainer refuses them
    pytest.param("actions={resize_on_request: true, autoscale: {for_s: 1}}", ValueError,
                 r"unknown actions\.\* key\(s\) \['autoscale'\]",
                 id="actions={resize_on_request: true}"),
    ("profiler={zscore_min_history: 1}", ValueError, "zscore_min_history must be >= 2"),
    ("remat_policy=nothing_savable", ValueError, "unknown remat_policy"),
    ("offload={wgrad_stash: true}", ValueError, "offload.wgrad_stash requires schedule: zb1"),
    ("gradient_accumulation_chunks=3", ValueError, "must divide"),
    ("pipeline_schedule=zb2", ValueError, "unknown pipeline_schedule"),
    ("fault_plan={faults: [{site: step, op: grad_nonfinite, at_step: 3, stage: 1}]}",
     ValueError, r"grad_nonfinite rule stage\(s\) \[1\] out of range for num_stages=1"),
    ("numerics={enabled: true, windows: 5}", ValueError, "unknown numerics config keys"),
    ("timeline={enabled: true, every: 2}", ValueError, r"unknown timeline\.\* key"),
    ("profiler={at_step: [3], window_steps: 0}", ValueError, "window_steps must be >= 1"),
    ("memory={enabled: true, every: 0}", ValueError, "memory.every must be >= 1"),
    ("eval_dataset={synthetic: true, seq_length: 32, pseudo_dataset_len: 1}", ValueError,
     "eval dataset too small for one batch"),
    ("timeline={enabled: true, window: 1}", ValueError, "timeline.window must be >= 2"),
]


@pytest.mark.parametrize("override,error,match", _REFUSED_KEYS,
                         ids=[case[0] if isinstance(case, tuple) else None
                              for case in _REFUSED_KEYS])
def test_trainer_refuses_keys_it_does_not_run(tmp_path, override, error, match):
    """An `actions` block with a key the trainer's block does not have (an
    actuator's) is refused by name; a name outside the JAX trainer's remat
    policies or schedules, an
    observatory block with an unknown key or a value out of its range, a
    grad_nonfinite rule at a stage the pipeline lacks, and an eval set too
    small for one batch are refused as the JAX trainer refuses them."""
    with pytest.raises(error, match=match):
        _build_tiny(tmp_path, override)


@pytest.mark.parametrize("overrides,logged", [
    (["remat_policy=nothing_saveable"], None),
    (["remat_policy=dots_saveable", "activation_checkpointing=false"], None),
    (["pipeline_schedule=zb1", "virtual_stages=2"], "virtual_stages"),
    (["pipeline_schedule=solver", "schedule_file=unit_schedule.json"], "schedule_file"),
    (["offload={wgrad_stash: false, activations: false}"], None),
    (["numerics={enabled: false}", "eval_steps=0", "async_save=false"], None),
])
def test_trainer_takes_keys_without_effect_on_one_device(tmp_path, overrides, logged):
    """The default of each refused key, a remat policy with checkpointing off,
    and the pipeline's schedule keys (one stage runs its microbatches in
    order) build; the schedule keys are named in one warning."""
    from llama_pipeline_parallel_tpu_torch import train as t_train

    records = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = records.append
    t_train.logger.addHandler(handler)
    try:
        run = _build_tiny(tmp_path, *overrides)
    finally:
        t_train.logger.removeHandler(handler)
    assert run.remat == ("activation_checkpointing=false" not in overrides)
    warned = [r.getMessage() for r in records]
    if logged:
        assert len(warned) == 1 and logged in warned[0] and "pipeline_schedule" in warned[0]
    else:
        assert warned == []


def test_remat_policy_nothing_saveable_trains(tmp_path):
    """remat_policy: nothing_saveable (what torch.utils.checkpoint does here)
    trains as the default does: the same losses, step by step."""
    args = ["mesh.pp=1", "mesh.dp=1", "max_steps=2", "total_steps=4", "warmup_steps=1",
            "dataset.pseudo_dataset_len=4"]
    path = os.path.join(REPO, "conf", "tiny_smoke.yaml")
    named = run_training(t_config.load_config(path, args + [
        f"output_dir={tmp_path}/named", "remat_policy=nothing_saveable"]), device="cpu")
    default = run_training(t_config.load_config(path, args + [f"output_dir={tmp_path}/d"]),
                           device="cpu")
    assert named["losses"] == default["losses"] and len(named["losses"]) == 2


@pytest.mark.parametrize("entries,resume,resumes", [
    (["checkpoint-4"], None, True),
    (["checkpoint-4", "checkpoint-8"], "true", True),
    (["checkpoint-4"], "false", False),
    ([], None, False),
    (["checkpoint-4.corrupt", "metrics.jsonl"], None, False),
])
def test_trainer_refuses_to_skip_a_checkpoint_it_would_resume(tmp_path, entries, resume,
                                                              resumes):
    """The trainer resumes from output_dir's newest complete checkpoint-N by
    default (`resume`, true), as the JAX trainer does, rather than start at
    step 0 over it; with resume=false, an empty dir, or only a quarantined
    checkpoint and other files, it starts at step 0."""
    cfg = TConfig.tiny()
    params = t_llama.init_params(cfg, device="cpu")
    mgr = t_ckpt.CheckpointManager(str(tmp_path))
    for entry in entries:
        if entry.startswith("checkpoint-") and entry[len("checkpoint-"):].isdigit():
            mgr.save(int(entry[len("checkpoint-"):]), params,
                     t_manifest.StageManifest(num_layers=cfg.num_hidden_layers, num_stages=1),
                     cfg, optimizer=t_optim.AdamW(params, t_optim.OptimizerConfig()))
        elif entry.endswith(".corrupt"):
            (tmp_path / entry).mkdir()
        else:
            (tmp_path / entry).write_text("")
    overrides = [] if resume is None else [f"resume={resume}"]
    run = _build_tiny(tmp_path, "max_steps=12", *overrides)
    newest = max((int(e.split("-")[1]) for e in entries if e.split("-")[-1].isdigit()),
                 default=0)
    assert run.start_step == (newest if resumes else 0)
    assert run.state.step == run.start_step


# what the trainer refuses in each shipped config with the mesh cut to one
# card (None: it builds)
_ONE_CARD_REFUSALS = {
    "codellama_34b_16k.yaml": None,
    "llama2_70b_pp4_tp4_dp2.yaml": None,
    "llama_13b_pp4_dp2.yaml": None,
    "llama_65b_pp8_tp2_dp2.yaml": None,
    "llama_65b_pp8_v2_tp2_dp2.yaml": None,
    "llama_65b_pp8_zb1_offload_tp2_dp2.yaml": None,
    "llama_65b_pp8_zb1_tp2_dp2.yaml": None,
    "llama_7b_flan_packed.yaml": None,
    "llama_7b_pp4.yaml": None,
    "tiny_smoke.yaml": None,
}


def _tokenizer_and_jsonl(root) -> tuple[str, str]:
    """A SentencePiece-Unigram tokenizer trained here (saved under tok/) and a
    JSONL of {"inputs", "targets"} rows."""
    from tokenizers import SentencePieceUnigramTokenizer
    from transformers import PreTrainedTokenizerFast

    rows = [{"inputs": f"what is item {i}", "targets": f"item {i} is thing {i}"}
            for i in range(32)]
    spm = SentencePieceUnigramTokenizer()
    spm.train_from_iterator([f"{r['inputs']} {r['targets']}" for r in rows], vocab_size=60,
                            unk_token="<unk>", special_tokens=["<unk>", "<s>", "</s>"])
    PreTrainedTokenizerFast(tokenizer_object=spm._tokenizer, bos_token="<s>", eos_token="</s>",
                            unk_token="<unk>").save_pretrained(str(root / "tok"))
    (root / "train.jsonl").write_text("\n".join(json.dumps(r) for r in rows))
    return str(root / "tok"), str(root / "train.jsonl")


@pytest.mark.parametrize("name", sorted(f for f in os.listdir(os.path.join(REPO, "conf"))
                                        if f.endswith(".yaml")))
def test_shipped_configs_build_on_one_card_or_name_the_refused_key(tmp_path, name):
    """Every shipped config, with the mesh cut to one device (and the model,
    data and batch cut to the tiny preset's size), builds or is refused with
    a message that names the key it cannot honour. A tokenizer-backed config
    keeps its dataset and packing, on a JSONL and a tokenizer the test writes."""
    path = os.path.join(REPO, "conf", name)
    if "_target_" in (t_config.load_config(path).get("dataset") or {}):
        tok, jsonl = _tokenizer_and_jsonl(tmp_path)
        data = [f"dataset.path={jsonl}", f"tokenizer_path={tok}", "max_seq_length=32"]
    else:
        data = ["dataset={synthetic: true, seq_length: 32, pseudo_dataset_len: 8}"]
    cfg = t_config.load_config(path, [
        "mesh.pp=1", "mesh.dp=1", "mesh.tp=1", "mesh.sp=1", "model={preset: tiny}", *data,
        "per_device_train_batch_size=1", "gradient_accumulation_steps=2",
        f"output_dir={tmp_path}"])
    key = _ONE_CARD_REFUSALS[name]
    if key is None:
        assert build_run(cfg, device="cpu").model_cfg.num_hidden_layers > 0
    else:
        with pytest.raises((NotImplementedError, ValueError), match=key):
            build_run(cfg, device="cpu")


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu():
    """Two fp32 train steps on the card (flash kernels, cuBLAS) against the
    same steps on the CPU (plain versions) from the same params and batches;
    head_dim 128 so the kernels take it. Losses, grad norms and each step's
    gradients agree to fp32 summation order. (Params are not compared:
    Adam divides by sqrt(v) + 1e-8, so a gradient that is rounding noise,
    ~1e-9, moves its parameter by a visible fraction of lr on either side.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cfg = TConfig.tiny(hidden_size=256, num_attention_heads=2, num_key_value_heads=1)
    init = t_llama.init_params(cfg, device="cpu", seed=0)
    batches = [_batch(cfg.vocab_size, 4, 64, seed=s, pad_tail=7) for s in (1, 2)]
    runs = []
    for device in ("cpu", "cuda"):
        leaves = {k: v.clone().to(device).requires_grad_() for k, v in init.items()}
        state = t_ts.TrainState(step=0, params=leaves, optimizer=t_optim.AdamW(
            leaves, t_optim.OptimizerConfig(learning_rate=1e-3, total_steps=10,
                                            warmup_steps=1)))
        attn = select_attention("flash", 64, torch.device(device))
        steps = []
        for b in batches:
            m = t_ts.train_step(state, {k: torch.from_numpy(v).to(device) for k, v in b.items()},
                                cfg, num_microbatches=2, attn_fn=attn)
            steps.append((m["loss"].item(), m["grad_norm"].item(),
                          {k: v.grad.detach().cpu() for k, v in leaves.items()}))
        runs.append(steps)
    for (loss, norm, grads), (card_loss, card_norm, card_grads) in zip(*runs):
        np.testing.assert_allclose(card_loss, loss, rtol=1e-6)
        np.testing.assert_allclose(card_norm, norm, rtol=1e-5)
        for k in grads:
            torch.testing.assert_close(card_grads[k], grads[k], rtol=1e-4, atol=1e-7, msg=k)
