"""The port's evaluation: the loss-only pass (parallel/train_step.eval_step)
against the JAX package's `make_pipeline_eval_fn` on a one-device mesh, and
the trainer's eval loop (`eval_dataset`, `eval_steps`): `eval_loss` in
metrics.jsonl and in every later checkpoint's meta.json, the exact token
mean over the eval set, and no trace left on the training run.

Tiny preset in fp32, the reference's parameters carried over by convert.py;
tolerances stated per check.
"""

import importlib
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_pipeline_parallel_tpu_torch import convert
from llama_pipeline_parallel_tpu_torch.data import collator as t_collator
from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig as TConfig
from llama_pipeline_parallel_tpu_torch.parallel import train_step as t_ts
from llama_pipeline_parallel_tpu_torch.train import build_run, select_attention, train_run
from llama_pipeline_parallel_tpu_torch.utils import config as t_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the eval sum against the reference's: fp32 through 4 layers, where XLA and
# PyTorch's CPU kernels sum in other orders
SUM_RTOL = 1e-5


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
            "manifest": "models.llama.manifest", "pl": "parallel.pipeline",
            "mesh": "parallel.mesh", "fa": "ops.flash_attention", "attn": "ops.attention"}
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"llama_pipeline_parallel_tpu.{v}") for k, v in mods.items()})


def _padded_batch(vocab, b, s, seed):
    """Right-padded rows of different lengths (segment id 1, pads 0)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, vocab, size=(b, s)).astype(np.int32)
    lengths = rng.randint(s // 2, s + 1, size=b)
    lengths[0] = s
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    return {"input_ids": ids, "attention_mask": mask,
            "position_ids": np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy(),
            "labels": np.where(mask == 1, ids, t_collator.IGNORE_INDEX).astype(np.int32)}


def _packed_batch(vocab, b, s, seed):
    """Rows packing 2-4 examples each (segment ids 1..k, positions that
    restart in each segment, each segment's first label ignored) and a pad
    tail."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, vocab, size=(b, s)).astype(np.int32)
    seg = np.zeros((b, s), np.int32)
    pos = np.zeros((b, s), np.int32)
    labels = np.full((b, s), t_collator.IGNORE_INDEX, np.int32)
    for r in range(b):
        cuts = np.sort(rng.choice(np.arange(4, s - 6), size=rng.randint(1, 4), replace=False))
        bounds = [0, *cuts.tolist(), s - rng.randint(1, 6)]
        for k, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
            seg[r, lo:hi] = k + 1
            pos[r, lo:hi] = np.arange(hi - lo)
            labels[r, lo + 1:hi] = ids[r, lo + 1:hi]
    return {"input_ids": ids, "attention_mask": seg, "position_ids": pos, "labels": labels}


def _ref_flash_without_mask(ref):
    def attn(q, k, v, padding_mask=None, *, causal=True):
        return ref.fa.flash_attention(q, k, v, None, causal=causal)

    return attn


# (attention, loss head, prologue kernels, batch): the reference trainer's
# choices for the same config (flash drops the 0/1 mask of an unpacked run
# and keeps the segment ids of a packed one)
CASES = {
    "exact-padded": ("exact", t_ts.LossHead(), False, _padded_batch),
    "flash": ("flash", t_ts.LossHead(), False, _padded_batch),
    "ce-kernel": ("exact", t_ts.LossHead(loss_chunks=4, kernel_ce=True), False, _padded_batch),
    "prologue-kernel": ("exact", t_ts.LossHead(), True, _padded_batch),
    "packed-flash": ("flash", t_ts.LossHead(), False, _packed_batch),
}


@pytest.mark.parametrize("case", list(CASES))
def test_eval_sum_and_count_match_reference(ref, case):
    """The port's loss-only pass (2 microbatches of 2 rows) against the
    reference's `make_pipeline_eval_fn` on a pp = dp = 1 mesh, from the same
    params and batch: the loss sum within SUM_RTOL, the valid count exactly,
    and no autograd graph on the port's side."""
    impl, head, prologue, make_batch = CASES[case]
    packed = make_batch is _packed_batch
    cfg_j, cfg_t = ref.config.LlamaConfig.tiny(), TConfig.tiny()
    tree = ref.llama.init_params(jax.random.PRNGKey(3), cfg_j)
    params = convert.params_from_jax(jax.device_get(tree))
    manifest = ref.manifest.StageManifest.for_config(cfg_j, 1)
    stacked = ref.pl.stack_stages(tree, manifest)
    mesh = ref.mesh.make_mesh(ref.mesh.MeshConfig(pp=1, dp=1))
    pcfg = ref.pl.PipelineConfig(num_stages=1, num_microbatches=2,
                                 loss_chunks=head.loss_chunks, kernel_ce=head.kernel_ce,
                                 kernel_prologue=prologue)
    if impl == "exact":
        ref_attn = ref.attn.attention
    else:
        ref_attn = ref.fa.flash_attention if packed else _ref_flash_without_mask(ref)
    eval_fn = jax.jit(ref.pl.make_pipeline_eval_fn(mesh, cfg_j, pcfg, stacked, attn_fn=ref_attn))
    batch = make_batch(cfg_t.vocab_size, 4, 32, seed=7)
    want_sum, want_count = eval_fn(stacked, {k: jnp.asarray(v) for k, v in batch.items()})

    leaves = {k: v.requires_grad_() for k, v in params.items()}
    got_sum, got_count = t_ts.eval_step(
        leaves, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg_t, num_microbatches=2,
        attn_fn=select_attention(impl, 32, torch.device("cpu"), packed=packed), head=head,
        kernel_prologue=prologue)
    assert not got_sum.requires_grad and got_sum.grad_fn is None
    assert int(got_count) == int(want_count)
    np.testing.assert_allclose(got_sum.item(), float(want_sum), rtol=SUM_RTOL)


def _tiny_cfg(out, *extra):
    """tiny_smoke on one CPU device: 4 steps, a right-padded training set and
    a padded held-out set of 12 rows (3 eval batches of 4)."""
    return t_config.load_config(os.path.join(REPO, "conf", "tiny_smoke.yaml"), [
        "mesh.pp=1", "mesh.dp=1", f"output_dir={out}", "max_steps=4", "logging_steps=2",
        "dataset.pad_fraction=0.25", "async_save=false", *extra])


EVAL = ["eval_dataset={synthetic: true, seq_length: 32, pseudo_dataset_len: 13, "
        "pad_fraction: 0.5}", "per_device_eval_batch_size=2", "eval_steps=2"]


def test_trainer_eval_loss_lands_in_metrics_and_meta(tmp_path):
    """Every eval_steps, `eval_loss` (the exact token mean over the unshuffled
    eval set, not a mean of the batches' means) goes to metrics.jsonl after
    the training line of the same step, and meta.json of every later
    checkpoint carries it with its step. The evaluation leaves the
    parameters and the optimizer's moments bit-equal, and the training
    losses are bit-equal to a run without eval."""
    run = build_run(_tiny_cfg(tmp_path / "eval", *EVAL, "save_steps=2"), "cpu")
    assert len(run.eval_loader) == 3  # 13 rows in batches of 2 x 2: the last row dropped
    assert run.eval_loader.per_replica_batch == 4
    summary = train_run(run)
    lines = [json.loads(x) for x in open(tmp_path / "eval" / "metrics.jsonl")]
    assert [(r["step"], "eval_loss" in r) for r in lines] == [(2, False), (2, True), (4, False),
                                                               (4, True)]
    evals = {r["step"]: r["eval_loss"] for r in lines if "eval_loss" in r}
    for step in (2, 4):
        meta = json.load(open(tmp_path / "eval" / f"checkpoint-{step}" / "meta.json"))
        assert (meta["eval_loss"], meta["eval_step"]) == (evals[step], step)

    # the last evaluation was of the final params: recompute it here, batch by
    # batch in dataset order, as one token mean
    before = {k: v.detach().clone() for k, v in run.state.params.items()}
    moments = {k: v.clone() for k, v in run.state.optimizer.state_dict().items()
               if isinstance(v, torch.Tensor)}
    sums, counts, rows = [], [], []
    for batch in run.eval_loader:
        loss_sum, count = run.eval_sum_count({k: torch.from_numpy(v) for k, v in batch.items()})
        sums.append(float(loss_sum))
        counts.append(int(count))
        rows.append(batch["input_ids"])
    np.testing.assert_array_equal(np.concatenate(rows),
                                  np.stack([run.eval_loader.dataset[i]["input_ids"]
                                            for i in range(12)]))
    assert evals[4] == sum(sums) / sum(counts) == run.evaluate()
    # batches of different weights (rows padded to other lengths): one token
    # mean over all of them, which their mean of means is not
    run.eval_loader = [_padded_batch(256, 4, 32, seed) for seed in (1, 2, 3)]
    sums, counts = zip(*[(float(a), int(b)) for a, b in (
        run.eval_sum_count({k: torch.from_numpy(v) for k, v in batch.items()})
        for batch in run.eval_loader)])
    assert len(set(counts)) == 3
    assert run.evaluate() == sum(sums) / sum(counts) != np.mean(np.array(sums) / counts)
    for k, v in run.state.params.items():
        assert torch.equal(v, before[k]), k
    for k, v in run.state.optimizer.state_dict().items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, moments[k]), k

    plain = train_run(build_run(_tiny_cfg(tmp_path / "plain", "save_steps=2"), "cpu"))
    assert summary["losses"] == plain["losses"] and len(plain["losses"]) == 4
    meta = json.load(open(tmp_path / "plain" / "checkpoint-4" / "meta.json"))
    assert "eval_loss" not in meta and "eval_step" not in meta
