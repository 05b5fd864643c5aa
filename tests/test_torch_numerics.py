"""The port's numerics observatory (utils/numerics.py, the nonfinite guard of
parallel/train_step.py and optim/offload.py, the pipeline's activation
stats) against the JAX package's, on the CPU at the `tiny` preset in fp32.

Limits:
- `step_stats` on the same numpy params, gradients and updates in both
  layouts (the reference's stage-stacked trees, the port's canonical or
  per-chunk leaves), at pp 1 and at pp 2 x interleaved v 2: every field
  within rtol 1e-5 (fp32, the sums in different orders), the nonfinite
  flag and a poisoned stage's infinities equal;
- the activation stats of a pp 2 step (flat 1F1B and interleaved v 2)
  against the reference's `make_pipeline_loss_and_grad(collect_stats=True)`
  on the 8-device CPU mesh: rtol 1e-4 (the forward's fp32 matmul order, the
  train step's gradient tolerance);
- `AnomalyDetector` on one series: the same z-scores;
- a step whose gradients overflow without the fault op (lm_head scaled so
  the loss is nonfinite): the port keeps its params, moments and count bit
  for bit and advances its step counter, as the reference's train step
  keeps its params.
"""

import importlib
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_pipeline_parallel_tpu_torch import convert
from llama_pipeline_parallel_tpu_torch.data.collator import IGNORE_INDEX
from llama_pipeline_parallel_tpu_torch.models.llama import model as t_llama
from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig as TConfig
from llama_pipeline_parallel_tpu_torch.models.llama.manifest import StageManifest as TManifest
from llama_pipeline_parallel_tpu_torch.ops.attention import attention as t_attention
from llama_pipeline_parallel_tpu_torch.optim import optimizer as t_optim
from llama_pipeline_parallel_tpu_torch.parallel import pipeline as t_pl
from llama_pipeline_parallel_tpu_torch.parallel import train_step as t_ts
from llama_pipeline_parallel_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from llama_pipeline_parallel_tpu_torch.utils import numerics as t_num

STATS_RTOL = 1e-5
ACT_RTOL = 1e-4


@pytest.fixture(scope="module")
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
            "manifest": "models.llama.manifest", "pl": "parallel.pipeline",
            "mesh": "parallel.mesh", "attn": "ops.attention", "num": "utils.numerics",
            "ts": "parallel.train_step", "optim": "optim.optimizer"}
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"llama_pipeline_parallel_tpu.{v}") for k, v in mods.items()})


def _tree(ref, seed=0):
    return jax.device_get(ref.llama.init_params(jax.random.PRNGKey(seed),
                                                ref.config.LlamaConfig.tiny()))


def _random_like(tree, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda x: (rng.randn(*x.shape) * scale).astype(np.float32), tree)


def _port_layout(canonical: dict, manifest: TManifest, pp: int) -> dict:
    """The port's leaves as its optimizer names them: canonical at pp 1, per
    chunk (`s{s}c{c}/...`) under a pipeline."""
    if pp == 1:
        return canonical
    return t_pl.flatten_chunks(t_pl.split_params(canonical, manifest))


def _close(got, want, rtol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite, err_msg=what)
    np.testing.assert_allclose(got[finite], want[finite], rtol=rtol, atol=0, err_msg=what)


STATS_CASES = {"pp1": dict(pp=1, v=1), "pp2-interleaved-v2": dict(pp=2, v=2)}


@pytest.mark.parametrize("poison", [-1, 0], ids=["finite", "poisoned"])
@pytest.mark.parametrize("case", list(STATS_CASES), ids=list(STATS_CASES))
def test_step_stats_match_reference(ref, case, poison):
    """`step_stats` and the update norms on the same numpy params, gradients
    and updates in both packages' layouts, field by field; with stage 0
    poisoned (the grad_nonfinite op) the same nonfinite verdict and the
    same infinities."""
    pp, v = STATS_CASES[case]["pp"], STATS_CASES[case]["v"]
    cfg_j = ref.config.LlamaConfig.tiny()
    manifest_j = ref.manifest.StageManifest.for_config(cfg_j, pp, virtual_stages=v)
    manifest_t = TManifest(num_layers=cfg_j.num_hidden_layers, num_stages=pp, virtual_stages=v)
    params = _tree(ref)
    grads = _random_like(params, 1, 0.1)
    updates = _random_like(params, 2, 1e-3)
    stack = lambda t: ref.pl.stack_stages(t, manifest_j)  # noqa: E731
    g_j = stack(grads)
    if poison >= 0:
        g_j = ref.num.poison_grads(g_j, poison)
    want = jax.device_get(ref.num.step_stats(stack(params), g_j, stack(updates),
                                             virtual_stages=v))
    port = lambda t: _port_layout(convert.params_from_jax(t), manifest_t, pp)  # noqa: E731
    g_t = t_num.poison_grads(port(grads), poison)
    got = t_num.step_stats(port(params), g_t, manifest_t)
    u_t = port(updates)
    got["update_norm_per_stage"] = t_num.update_norms(
        {n: u.square().sum() for n, u in u_t.items()}, manifest_t, torch.device("cpu"))
    for key in ("grad_norm_per_stage", "param_norm_per_stage", "update_norm_per_stage",
                "grad_absmax_per_layer"):
        _close(got[key], want[key], STATS_RTOL, key)
    assert set(got["grad_absmax_per_group"]) == set(want["grad_absmax_per_group"])
    for group, w in want["grad_absmax_per_group"].items():
        _close(got["grad_absmax_per_group"][group], w, STATS_RTOL, group)
    assert set(got["replicated_groups"]) == set(want["replicated_groups"])
    for group, w in want["replicated_groups"].items():
        _close(got["replicated_groups"][group], w, STATS_RTOL, group)
    assert bool(got["nonfinite"]) == bool(want["nonfinite"]) == (poison >= 0)


def _batch(b=8, s=16, seed=3, vocab=256):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, vocab, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[:, -3:] = 0
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    return {"input_ids": ids, "attention_mask": mask, "position_ids": pos,
            "labels": np.where(mask != 0, ids, IGNORE_INDEX).astype(np.int32)}


ACT_CASES = {"1f1b-pp2": dict(schedule="1f1b", v=1), "zb1-pp2": dict(schedule="zb1", v=1),
             "interleaved-pp2-v2": dict(schedule="interleaved_1f1b", v=2)}


@pytest.mark.parametrize("case", list(ACT_CASES), ids=list(ACT_CASES))
def test_activation_stats_of_a_pp2_step_match_reference(ref, case):
    """The per-stage (and, interleaved, per-chunk) activation rms and absmax
    of one pp 2 step, 4 microbatches, folded by the port's interpreter,
    against the reference's collect_stats pipeline on the same params and
    batch."""
    schedule, v = ACT_CASES[case]["schedule"], ACT_CASES[case]["v"]
    pp, m = 2, 4
    tree = _tree(ref)
    batch = _batch()
    cfg_j = ref.config.LlamaConfig.tiny()
    manifest_j = ref.manifest.StageManifest(num_layers=cfg_j.num_hidden_layers, num_stages=pp,
                                            virtual_stages=v)
    pcfg_j = ref.pl.PipelineConfig(num_stages=pp, num_microbatches=m, schedule=schedule,
                                   virtual_stages=v, remat=True)
    mesh_j = ref.mesh.make_mesh(ref.mesh.MeshConfig(pp=pp, dp=1))
    stacked = ref.pl.stack_stages(tree, manifest_j)
    fn = jax.jit(ref.pl.make_pipeline_loss_and_grad(mesh_j, cfg_j, pcfg_j, stacked,
                                                    attn_fn=ref.attn.attention,
                                                    collect_stats=True))
    _, _, want = jax.device_get(fn(stacked, {k: jnp.asarray(x) for k, x in batch.items()}))

    cfg = TConfig.tiny()
    manifest = TManifest(num_layers=cfg.num_hidden_layers, num_stages=pp, virtual_stages=v)
    pcfg = t_pl.PipelineConfig(num_stages=pp, num_microbatches=m, schedule=schedule,
                               virtual_stages=v, remat=True)
    sp = t_pl.StageParams.from_canonical(convert.params_from_jax(tree), manifest)
    pipe = t_pl.Pipeline(cfg, pcfg, make_mesh(MeshConfig(pp=pp)), sp, t_attention)
    act = {}
    pipe.loss_and_grad({k: torch.from_numpy(x) for k, x in batch.items()}, act=act)
    got = t_num.step_stats(sp.flat(), sp.grads(), manifest, act=act,
                           act_chunked=schedule in t_num.CHUNKED_SCHEDULES)
    keys = ["act_rms_per_stage", "act_absmax_per_stage"]
    if schedule in t_num.CHUNKED_SCHEDULES:
        keys += ["act_rms_per_chunk", "act_absmax_per_chunk"]
    assert {k for k in got if k.startswith("act_")} == set(keys) == set(want)
    for key in keys:
        _close(got[key], want[key], ACT_RTOL, key)


def test_anomaly_detector_matches_reference(ref):
    """One series with a flat start, a drift, a spike and a NaN: the same
    z-score (or None) at every sample."""
    rng = np.random.RandomState(0)
    series = [1.0] * 5 + list(1.0 + 0.01 * rng.randn(20)) + [5.0, float("nan"), 1.01, 1e3]
    a = ref.num.AnomalyDetector(window=8, min_history=4)
    b = t_num.AnomalyDetector(window=8, min_history=4)
    for x in series:
        za, zb = a.push(x), b.push(x)
        assert (za is None) == (zb is None)
        if za is not None:
            assert za == zb


def _overflowing_lm_head(params: dict) -> None:
    """Scale lm_head so the logits overflow: the loss and every gradient
    turn nonfinite without the fault op."""
    with torch.no_grad():
        params["lm_head"].mul_(3e38)


def test_overflow_step_is_skipped_as_in_reference(ref):
    """A step whose loss is nonfinite (lm_head scaled to overflow the
    logits): the reference's train step (numerics on) keeps its params; the
    port's train_step with the stats on keeps its params, moments and count
    bit for bit, reports the step nonfinite and advances its step counter;
    the following step then trains from the kept state."""
    cfg_j, cfg_t = ref.config.LlamaConfig.tiny(), TConfig.tiny()
    tree = _tree(ref, seed=1)
    tree["lm_head"] = tree["lm_head"] * np.float32(3e38)
    batch = _batch(b=4, s=16)
    kw = dict(learning_rate=5e-3, total_steps=20, warmup_steps=1)

    mesh = ref.mesh.make_mesh(ref.mesh.MeshConfig(pp=1, dp=1))
    manifest = ref.manifest.StageManifest.for_config(cfg_j, 1)
    stacked = ref.pl.stack_stages(tree, manifest)
    tx, sched = ref.optim.make_optimizer(ref.optim.OptimizerConfig(**kw))
    state = ref.ts.init_train_state(stacked, tx, mesh)
    step_fn = ref.ts.make_train_step(mesh, cfg_j, ref.pl.PipelineConfig(
        num_stages=1, num_microbatches=2), tx, sched, stacked, collect_stats=True)
    before_j = jax.device_get(state.params)
    state, want = step_fn(state, {k: jnp.asarray(x) for k, x in batch.items()})
    assert bool(want["numerics"]["nonfinite"])
    for a, b in zip(jax.tree.leaves(before_j), jax.tree.leaves(jax.device_get(state.params))):
        np.testing.assert_array_equal(a, b)

    params = {k: v.requires_grad_() for k, v in convert.params_from_jax(
        jax.device_get(_tree(ref, seed=1))).items()}
    _overflowing_lm_head(params)
    opt = t_optim.AdamW(params, t_optim.OptimizerConfig(**kw))
    t_state = t_ts.TrainState(step=0, params=params, optimizer=opt)
    before = {k: v.detach().clone() for k, v in params.items()}
    moments = {k: (opt.mu[k].clone(), opt.nu[k].clone()) for k in params}
    got = t_ts.train_step(t_state, {k: torch.from_numpy(x) for k, x in batch.items()}, cfg_t,
                          num_microbatches=2, collect_stats=True)
    assert not math.isfinite(float(got["loss"])) and bool(got["numerics"]["nonfinite"])
    for k, v in params.items():
        assert torch.equal(v.detach(), before[k]), k
        assert torch.isfinite(v).all(), k
        assert torch.equal(opt.mu[k], moments[k][0]) and torch.equal(opt.nu[k], moments[k][1])
    assert opt.count == 0 and t_state.step == got["step"] == 1 == int(want["step"])
    # the reference reports the schedule at its step counter, as the port does
    np.testing.assert_allclose(got["lr"], float(want["lr"]), rtol=1e-6)


def test_overflow_step_keeps_params_in_the_trainer(tmp_path):
    """The same overflow through the trainer (build_run, numerics on by
    default): both steps are skipped, params unchanged, both numerics.jsonl
    records nonfinite."""
    import json
    import os

    from llama_pipeline_parallel_tpu_torch import train as t_train
    from llama_pipeline_parallel_tpu_torch.utils import config as t_config

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = t_train.build_run(t_config.load_config(
        os.path.join(repo, "conf", "tiny_smoke.yaml"),
        ["mesh.pp=1", "mesh.dp=1", f"output_dir={tmp_path}", "max_steps=2", "total_steps=8",
         "logging_steps=2"]),
        device="cpu")
    _overflowing_lm_head(run.state.params)
    before = {k: v.detach().clone() for k, v in run.state.params.items()}
    t_train.train_run(run)
    for k, v in run.state.params.items():
        assert torch.equal(v.detach(), before[k]), k
    # the monitor reads a step one step late: the last line counts step 1
    line = [json.loads(x) for x in open(tmp_path / "metrics.jsonl")][-1]
    assert line["nonfinite_steps"] == 1 and line["anomaly_count"] == 1
    records = [json.loads(x) for x in open(tmp_path / "numerics.jsonl")]
    assert [r["nonfinite"] for r in records] == [True, True]
    assert run.state.optimizer.count == 0 and run.state.step == 2
