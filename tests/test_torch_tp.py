"""The port's tensor parallelism (pp x tp x dp across processes: the
Megatron layers, the prologue's tp all-reduce, the vocab-parallel CE, ZeRO-1
under tp, the init by shard, evaluation, the pipeline's host tiers) against
the JAX package's, on the CPU at the `tiny` preset in fp32 (4 heads, 2 kv
heads, FFN 128, vocab 256: tp = 2 divides them all; the one tp = 4 step runs
it with 4 kv heads, and two tp = 2 steps with 8 q / 4 kv heads, 2 kv heads a
rank).

The processes are gloo ranks started here (tests/torch_tp_worker.py, or the
CLI), each with RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT and a join
timeout; the reference runs the same layouts on tests/conftest.py's 8
virtual CPU devices. Parameters are the reference's init carried over by
convert.py; batches are numpy from a seed, a different pad tail on every row.

Tolerances (tests/test_torch_pipeline.py's): the loss within rtol 1e-5 of
the reference's, each gradient leaf (a rank's slice) within 1e-4 of the
largest element of the reference's slice; trainer losses 1e-5 and final
params 1e-4 against the reference's run_training. The tp sums run in fp32
here, where tp = 2 adds two numbers in either package's order alike; at
tp = 4 the order of four may differ, a rounding of fp32 well inside 1e-4
(in bf16 it would not be: these tolerances hold in fp32 only). Where
both sides are this package (ZeRO-1 against the replicated AdamW on the same
gradients, the joined init against one process's) the test says bit-equal.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_pipeline_parallel_tpu_torch import convert
from llama_pipeline_parallel_tpu_torch import train as t_train
from llama_pipeline_parallel_tpu_torch.ckpt import tensor_io
from llama_pipeline_parallel_tpu_torch.models.llama import model as t_llama
from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig as TConfig
from llama_pipeline_parallel_tpu_torch.models.llama.manifest import StageManifest as TManifest
from llama_pipeline_parallel_tpu_torch.optim import optimizer as t_optim
from llama_pipeline_parallel_tpu_torch.parallel import pipeline as t_pl
from llama_pipeline_parallel_tpu_torch.parallel import tp as t_tp
from llama_pipeline_parallel_tpu_torch.utils import config as t_config
from tests.test_torch_dp import (
    EVAL_SUM_RTOL,
    OPT,
    _dp_batch,
    _ref_eval,
    _warm_checkpoints,
    finish,
    launch,
)
from tests.test_torch_pipeline import (
    GRAD_RTOL,
    LOSS_RTOL,
    _assert_grads_close,
    _free_port,
    _tree,
    ref,  # noqa: F401  (the reference fixture)
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_tp_worker.py")
MICROBATCHES = 4
# (pp, dp, tp, schedule, virtual stages, kernel prologue) of each step job
STEPS = {
    "pp2xtp2": (2, 1, 2, "1f1b", 1, False),
    "pp1xtp2xdp2": (1, 2, 2, "1f1b", 1, False),
    "pp2xtp2xdp2": (2, 2, 2, "1f1b", 1, False),
    "pp2xtp2xdp2-prologue": (2, 2, 2, "1f1b", 1, True),
    "pp2xtp2xdp2-interleaved": (2, 2, 2, "interleaved_1f1b", 2, False),
    "pp2xtp2xdp2-zb1": (2, 2, 2, "zb1", 1, False),
    "pp1xtp4": (1, 1, 4, "1f1b", 1, False),
    "pp2xtp2-gqa": (2, 1, 2, "1f1b", 1, False),
    "pp2xtp2-gqa-prologue": (2, 1, 2, "1f1b", 1, True),
    "pp2xtp2xdp2-zb1-stash": (2, 2, 2, "zb1", 1, False),
}
# (q heads, kv heads) of the step jobs off the tiny preset's (4, 2), each from
# a tree of its own (inputs.pt's `_params_key`): tp 4 needs 4 kv heads, and 8
# q / 4 kv heads (head dim 8) give each tp 2 rank 4 q heads on 2 kv heads, two
# GQA groups inside a rank (llama2_70b_pp4_tp4_dp2 gives a rank 16 on 2)
HEADS = {"pp1xtp4": (4, 4), "pp2xtp2-gqa": (8, 4), "pp2xtp2-gqa-prologue": (8, 4)}
TINY_HEADS = (4, 2)
# the host tiers (PipelineConfig's offload knobs) of a step job, and the job
# of the same layout and schedule with them off
TIERS = {"pp2xtp2xdp2-zb1-stash": dict(offload_wgrad=True, offload_activations=True)}
TIERS_OFF = {"pp2xtp2xdp2-zb1-stash": "pp2xtp2xdp2-zb1"}
# the step jobs that first evaluate inputs.pt's eval batch (eval_step: the
# pipeline's loss_sum_count at pp 2)
EVALS = ("pp1xtp2xdp2", "pp2xtp2xdp2")
# the trainer's 3 steps at each layout, all on tiny_smoke's 8 rows a step
# (dp 1 takes them as 4 microbatches), warm-started from the same weights
TRAIN_LAYOUTS = {"pp2xtp2": ["mesh.dp=1", "gradient_accumulation_steps=4"],
                 "pp1xtp2xdp2": ["mesh.pp=1"], "pp2xtp2xdp2": []}
# the trainer's eval set at pp 2 x tp 2 x dp 2 (evaluated before its steps):
# rows padded at random, 2 batches of 2 microbatches of 2 rows a replica
TRAIN_EVAL = ["eval_dataset={synthetic: true, seq_length: 32, pseudo_dataset_len: 16, "
              "pad_fraction: 0.5}", "per_device_eval_batch_size=2"]
TRAIN_ARGS = ["mesh.tp=2", "max_steps=3", "logging_steps=1", "save_final=true",
              "resume=false", "dataset.pseudo_dataset_len=64"]
INIT_SEED = 11
# generation with tp-sharded params: the tiny preset (4 q heads, 2 kv heads)
# at tp 2 in fp32, on left-padded prompts; greedy and seeded sampling
GEN_TP = dict(kind="generate", name="generate", pp=1, dp=2, tp=2, seed=7,
              greedy=dict(max_new_tokens=8),
              sampled=dict(max_new_tokens=8, temperature=0.8, top_k=20, top_p=0.9))
GEN_LOGITS_ATOL = 1e-5


def _job_step(name):
    pp, dp, tp, schedule, v, prologue = STEPS[name]
    return dict(kind="step", name=name, pp=pp, dp=dp, tp=tp, schedule=schedule, v=v,
                prologue=prologue, microbatches=MICROBATCHES,
                heads=HEADS.get(name, TINY_HEADS), params=_params_key(name),
                tiers=TIERS.get(name, {}), eval=name in EVALS)


def _params_key(name):
    q, kv = HEADS.get(name, TINY_HEADS)
    return "params" if (q, kv) == TINY_HEADS else f"params_q{q}kv{kv}"


def _ranks(name):
    pp, dp, tp = STEPS[name][:3]
    return pp * dp * tp


def _write_jobs(out, jobs, inputs):
    torch.save(inputs, out / "inputs.pt")
    torch.save(jobs, out / "jobs.pt")


def _results(out, name, n):
    return [torch.load(out / f"{name}-rank{r}.pt") for r in range(n)]


def _ref_loss_and_grad(ref, tree, batch, pp, dp, tp, schedule, v, prologue, heads=TINY_HEADS,
                       tiers=None):
    """The reference's pipeline at the layout, with its offload knobs `tiers`
    (their stores kept in regular memory on the CPU, as
    tests/test_torch_host_stash.py runs them)."""
    cfg = ref.config.LlamaConfig.tiny(num_attention_heads=heads[0],
                                      num_key_value_heads=heads[1])
    manifest = ref.manifest.StageManifest(num_layers=cfg.num_hidden_layers, num_stages=pp,
                                          virtual_stages=v)
    pcfg = ref.pl.PipelineConfig(num_stages=pp, num_microbatches=MICROBATCHES,
                                 schedule=schedule, virtual_stages=v, remat=True,
                                 kernel_prologue=prologue, **(tiers or {}))
    mesh = ref.mesh.make_mesh(ref.mesh.MeshConfig(pp=pp, dp=dp, tp=tp))
    stacked = ref.pl.stack_stages(tree, manifest)
    fn = jax.jit(ref.pl.make_pipeline_loss_and_grad(mesh, cfg, pcfg, stacked,
                                                    attn_fn=ref.attn.attention))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LPT_HOST_STASH_FORCE", "0")
        loss, grads = fn(stacked, {k: jnp.asarray(x) for k, x in batch.items()})
    canonical = convert.unstack_stages(jax.device_get(grads), TManifest(
        num_layers=cfg.num_hidden_layers, num_stages=pp, virtual_stages=v))
    return float(loss), convert.params_from_jax(canonical)


def _slices(canonical, res, pp, v, tp):
    """A rank's tp slices of a canonical tree, named as its optimizer names
    its leaves (chunk names at pp > 1)."""
    if pp == 1:
        return {k: t_tp.tp_shard(k, x, res["tp_rank"], tp) for k, x in canonical.items()}
    manifest = TManifest(num_layers=4, num_stages=pp, virtual_stages=v)
    return t_pl.flatten_chunks(t_pl.chunk_views(canonical, manifest, tuple(res["stages"]),
                                                res["tp_rank"], tp))


@pytest.fixture(scope="module")
def tp_runs(ref, tmp_path_factory):
    """Every step job of STEPS, the init job, the operator job and the
    trainer's 3 steps at each layout (run_training, warm-started from the
    reference's init), in one launch of 4 processes (the 4-process layouts
    and the ops) and one of 8, started together, while the reference
    computes its side: its pipeline at each step job's layout and its
    run_training at pp 2 x tp 2 x dp 2."""
    tree = _tree(ref)
    trees = {TINY_HEADS: tree}
    for q, kv in set(HEADS.values()):
        trees[(q, kv)] = jax.device_get(ref.llama.init_params(
            jax.random.PRNGKey(1), ref.config.LlamaConfig.tiny(num_attention_heads=q,
                                                               num_key_value_heads=kv)))
    batch, eval_batch = _dp_batch(), _dp_batch(seed=4)
    rng = np.random.RandomState(5)
    inputs = {**{_params_key(name): convert.params_from_jax(trees[HEADS.get(name, TINY_HEADS)])
                 for name in STEPS},
              "batch": {k: torch.from_numpy(x) for k, x in batch.items()},
              "eval_batch": {k: torch.from_numpy(x) for k, x in eval_batch.items()},
              "optimizer": OPT,
              "x": torch.from_numpy(rng.randn(2, 3, 5).astype(np.float32)),
              "g": torch.from_numpy(rng.randn(2, 3, 5).astype(np.float32)),
              "h": torch.from_numpy(rng.randn(2, 6, 64).astype(np.float32)),
              "lm_head": torch.from_numpy(0.3 * rng.randn(64, 256).astype(np.float32)),
              "targets": torch.from_numpy(np.where(rng.rand(2, 6) < 0.2, -100,
                                                   rng.randint(0, 256, (2, 6)))
                                          .astype(np.int64)),
              "gen_ids": torch.from_numpy(rng.randint(3, 256, (3, 7)).astype(np.int64)),
              "gen_mask": torch.from_numpy((np.arange(7)[None] >= np.array([[0], [2], [4]]))
                                           .astype(np.int64))}
    four, eight = tmp_path_factory.mktemp("tp4"), tmp_path_factory.mktemp("tp8")
    train_dir = tmp_path_factory.mktemp("tp_train")
    warm = _warm_checkpoints(ref, train_dir)
    conf = os.path.join(REPO, "conf", "tiny_smoke.yaml")
    trains = {name: dict(kind="train", name=f"train-{name}", config=conf, overrides=TRAIN_ARGS + extra + [
        f"output_dir={train_dir}/{name}", f"model_name_or_path={train_dir}/warm_port"])
        for name, extra in TRAIN_LAYOUTS.items()}
    trains["pp2xtp2xdp2"].update(eval=True, overrides=trains["pp2xtp2xdp2"]["overrides"]
                                 + TRAIN_EVAL)
    _write_jobs(four, [_job_step(n) for n in STEPS if _ranks(n) == 4]
                + [dict(kind="ops", name="ops", pp=2, dp=1, tp=2), GEN_TP,
                       trains["pp2xtp2"], trains["pp1xtp2xdp2"]], inputs)
    _write_jobs(eight, [_job_step(n) for n in STEPS if _ranks(n) == 8]
                + [dict(kind="init", name="init", pp=2, dp=2, tp=2, seed=INIT_SEED),
                   trains["pp2xtp2xdp2"]], inputs)
    procs = {4: launch(4, [sys.executable, WORKER, str(four)]),
             8: launch(8, [sys.executable, WORKER, str(eight)])}
    want = {name: _ref_loss_and_grad(ref, trees[HEADS.get(name, TINY_HEADS)], batch,
                                     *STEPS[name], HEADS.get(name, TINY_HEADS),
                                     TIERS.get(name)) for name in STEPS}
    want_eval, = _ref_eval(ref, tree, [eval_batch], 2, 2, 2)
    ref.train.run_training(t_config.load_config(conf, TRAIN_ARGS + [
        f"output_dir={train_dir}/ref", f"model_name_or_path={train_dir}/warm_ref"]))
    for p in procs.values():
        for rc, _, stderr in finish(p):
            assert rc == 0, stderr[-3000:]
    results = {name: _results(four if _ranks(name) == 4 else eight, name, _ranks(name))
               for name in STEPS}
    return dict(tree=tree, inputs=inputs, want=want, results=results,
                ops=_results(four, "ops", 4), init=_results(eight, "init", 8),
                generate=_results(four, "generate", 4),
                train_dir=train_dir, want_eval=want_eval, eval_batch=eval_batch, warm=warm,
                train_eval=_results(eight, "train-pp2xtp2xdp2", 8),
                dirs={name: four if _ranks(name) == 4 else eight for name in STEPS})


def test_generate_with_tp_sharded_params(ref, tp_runs):
    """Generation with Megatron-sharded params at tp 2 (GQA: 2 q heads and 1
    kv head a rank): greedy tokens equal the port's unsharded `generate`
    and the JAX package's on the same weights, on every rank;
    forward_with_cache's logits (prefill and one decode step) within 1e-5 of
    the unsharded; a seeded sampling run gives the same tokens on both tp
    ranks of each replica and in the unsharded run."""
    import importlib

    from llama_pipeline_parallel_tpu_torch.models.llama import decode as td

    rdecode = importlib.import_module("llama_pipeline_parallel_tpu.models.llama.decode")
    cfg = TConfig.tiny(dtype=torch.float32)
    params = tp_runs["inputs"]["params"]
    ids, mask = tp_runs["inputs"]["gen_ids"], tp_runs["inputs"]["gen_mask"]
    greedy = td.generate(params, ids, mask, cfg, td.GenerationConfig(**GEN_TP["greedy"]))
    want = np.asarray(rdecode.generate(
        tp_runs["tree"], jnp.asarray(ids.numpy().astype(np.int32)),
        jnp.asarray(mask.numpy().astype(np.int32)), ref.config.LlamaConfig.tiny(
            dtype=jnp.float32), rdecode.GenerationConfig(**GEN_TP["greedy"]))["tokens"])
    np.testing.assert_array_equal(greedy["tokens"].numpy(), want)
    sampled = td.generate(params, ids, mask, cfg, td.GenerationConfig(**GEN_TP["sampled"]),
                          generator=torch.Generator().manual_seed(GEN_TP["seed"]))["tokens"]
    b, p = ids.shape
    cache = td.init_kv_cache(cfg, b, p + 1, device="cpu")
    kv_mask = torch.nn.functional.pad(mask.to(torch.int32), (0, 1))
    positions = (mask.cumsum(1) - 1).clamp_min(0)
    prefill, cache = td.forward_with_cache(params, ids, cache, positions, 0, kv_mask, cfg)
    kv_mask[:, p] = 1
    step, _ = td.forward_with_cache(params, greedy["tokens"][:, :1], cache,
                                    positions[:, -1:] + 1, p, kv_mask, cfg, causal=False)
    ranks = tp_runs["generate"]
    assert sorted(r["tp_rank"] for r in ranks) == [0, 0, 1, 1]
    for r in ranks:
        np.testing.assert_array_equal(r["greedy"].numpy(), want)
        np.testing.assert_array_equal(r["sampled"].numpy(), sampled.numpy())
        np.testing.assert_allclose(r["prefill"].numpy(), prefill.numpy(), rtol=0,
                                   atol=GEN_LOGITS_ATOL)
        np.testing.assert_allclose(r["step"].numpy(), step.numpy(), rtol=0,
                                   atol=GEN_LOGITS_ATOL)


@pytest.mark.parametrize("name", list(STEPS))
def test_step_matches_reference_pipeline(tp_runs, name):
    """One step at each layout (and, at pp 2 x tp 2 x dp 2, with the
    prologue kernels' plain twins against the reference's interpret-mode
    Pallas prologue, under interleaved v2 and zb1, and zb1 with both host
    tiers against the reference's with its offload knobs; at pp 2 x tp 2 with
    8 q / 4 kv heads, 2 kv heads a rank, composed and with the prologue
    twins) against the reference's make_pipeline_loss_and_grad on the same
    layout: the loss on every rank, and every rank's slice of every
    gradient."""
    pp, dp, tp, _, v, _ = STEPS[name]
    want_loss, want_grads = tp_runs["want"][name]
    for res in tp_runs["results"][name]:
        np.testing.assert_allclose(float(res["loss"]), want_loss, rtol=LOSS_RTOL)
        _assert_grads_close(res["grads"], _slices(want_grads, res, pp, v, tp))


@pytest.mark.parametrize("name", ["pp2xtp2", "pp1xtp2xdp2", "pp2xtp2xdp2", "pp1xtp4",
                                  "pp2xtp2-gqa"])
def test_norm_and_zero1_masters_under_tp(tp_runs, name):
    """The gradient norm each rank clips by is the reference gradient's
    whole norm (each split leaf's slices added over tp, each replicated leaf
    once), and each rank's masters after the step (ZeRO-1 at dp 2: its
    slice updated, then gathered over dp) are bit-equal to a replicated
    AdamW fed its gradients and norm; no moment is split on the tp dim."""
    pp, dp, tp, _, v, _ = STEPS[name]
    want_grads = tp_runs["want"][name][1]
    want_norm = float(torch.stack([g.double().square().sum()
                                   for g in want_grads.values()]).sum().sqrt())
    for res in tp_runs["results"][name]:
        np.testing.assert_allclose(float(res["norm"]), want_norm, rtol=1e-5)
        start = _slices(tp_runs["inputs"][_params_key(name)], res, pp, v, tp)
        plain = {k: x.clone() for k, x in start.items()}
        t_optim.AdamW(plain, t_optim.OptimizerConfig(**OPT)).step(plain, res["grads"],
                                                                    res["norm"])
        for k in plain:
            assert torch.equal(res["masters"][k], plain[k]), k
        for k, dim in (res["dims"] or {}).items():
            assert dim != t_tp.tp_dim(k, res["grads"][k].dim()) or dim is None, k
            full = res["grads"][k].numel()
            assert res["mu"][k].numel() == (full if dim is None else full // dp), k


@pytest.mark.parametrize("name", EVALS)
def test_eval_under_tp_matches_reference(tp_runs, name):
    """The loss-only pass (eval_step; at pp 2 the pipeline's loss_sum_count)
    at each layout of EVALS on an eval batch whose rows are padded unevenly
    across the dp replicas (row i by i tokens: replica 0 holds more valid
    targets than replica 1), against the reference's make_pipeline_eval_fn
    at pp 2 x tp 2 x dp 2 on the same params and batch: on every rank the
    valid count exactly (summed over dp, not over tp) and the loss sum within
    EVAL_SUM_RTOL (summed over pp and dp, not twice over tp)."""
    want_sum, want_count = tp_runs["want_eval"]
    labels = tp_runs["eval_batch"]["labels"]
    per_replica = [int((labels[r * 4:(r + 1) * 4, 1:] != -100).sum()) for r in range(2)]
    assert per_replica[0] > per_replica[1] and sum(per_replica) == want_count
    for res in tp_runs["results"][name]:
        loss_sum, count = res["eval"]
        assert int(count) == want_count
        np.testing.assert_allclose(float(loss_sum), want_sum, rtol=EVAL_SUM_RTOL)


def test_trainer_eval_under_tp_matches_reference(ref, tp_runs):
    """The trainer's evaluation of its `eval_dataset` (Run.eval_sum_count
    over each batch of its eval loader, this replica's rows) at pp 2 x tp 2
    x dp 2, at the warm-start weights: each batch's (loss sum, valid count)
    on every rank against the reference's make_pipeline_eval_fn at the same
    layout on the replicas' rows joined: the count exactly, the sum within
    EVAL_SUM_RTOL."""
    ranks = tp_runs["train_eval"]
    by_replica = {r["replica"]: r for r in ranks}
    assert sorted(by_replica) == [0, 1]
    batches = [{k: torch.cat([by_replica[r]["eval_batches"][i][k] for r in (0, 1)]).numpy()
                for k in local} for i, local in enumerate(ranks[0]["eval_batches"])]
    assert len(batches) == len(ranks[0]["eval"]) >= 1
    want = _ref_eval(ref, tp_runs["warm"], batches, 2, 2, 2,
                     microbatches=ranks[0]["microbatches"])
    for i, (want_sum, want_count) in enumerate(want):
        for res in ranks:
            loss_sum, count = res["eval"][i]
            assert int(count) == want_count
            np.testing.assert_allclose(float(loss_sum), want_sum, rtol=EVAL_SUM_RTOL)


@pytest.mark.parametrize("name", list(TIERS))
def test_stash_tiers_under_tp_bit_equal_to_off(tp_runs, name):
    """A step with the pipeline's host tiers on (offload.wgrad_stash and
    offload.activations under zb1 at pp 2 x tp 2 x dp 2) against the same
    job with them off: every rank's loss, norm, gradients (its tp slices)
    and masters bit-equal, as the tiers only move bytes. Every rank pushed
    to its rings, and on each replica and tp rank its two stages' rings
    hold the byte model's bytes of one stage (stage 0 the cotangents' W
    ring, stage 1 the inputs' W ring and the activation ring) at the full
    hidden width, which tp does not split. Its match with the reference's
    step is test_step_matches_reference_pipeline's."""
    on, off = tp_runs["results"][name], tp_runs["results"][TIERS_OFF[name]]
    pp, dp, tp, schedule, v, prologue = STEPS[name]
    for a, b in zip(on, off):
        assert (a["replica"], a["tp_rank"], a["stages"]) == (b["replica"], b["tp_rank"],
                                                               b["stages"])
        assert torch.equal(a["loss"], b["loss"]) and torch.equal(a["norm"], b["norm"])
        for key in ("grads", "masters"):
            assert set(a[key]) == set(b[key])
            for k in a[key]:
                assert torch.equal(a[key][k], b[key][k]), (key, k)
        assert a["pushes"] > 0 and b["pushes"] == b["host_stash_bytes"] == 0
    pcfg = t_pl.PipelineConfig(num_stages=pp, num_microbatches=MICROBATCHES,
                               schedule=schedule, virtual_stages=v, **TIERS[name])
    mb_rows = tp_runs["inputs"]["batch"]["input_ids"].shape[0] // dp // MICROBATCHES
    seqlen = tp_runs["inputs"]["batch"]["input_ids"].shape[1]
    per_stage = t_pl.host_stash_bytes(pcfg, *t_pl.stash_dims(mb_rows, seqlen, 1, 64,
                                                             torch.float32))
    held = {}
    for res in on:
        key = (res["replica"], res["tp_rank"])
        held[key] = held.get(key, 0) + res["host_stash_bytes"]
    assert len(held) == dp * tp and set(held.values()) == {per_stage} and per_stage > 0


@pytest.mark.parametrize("name", list(STEPS))
def test_numerics_record_under_tp_matches_one_process(tp_runs, name):
    """Process 0's numerics.jsonl record of each step job (the stats of
    every rank reduced to the global record: split leaves' squares added
    over tp, replicated ones once, dp replicas once) against the norms of
    the reference's gradients of the same step in one process: each
    stage's grad norm within the whole norm's rtol 1e-5; per-stage vectors
    of length pp; finite."""
    pp, _, _, _, v, _ = STEPS[name]
    want_grads = tp_runs["want"][name][1]
    rec = [json.loads(line) for line in
           open(os.path.join(tp_runs["dirs"][name], name, "numerics.jsonl"))]
    assert len(rec) == 1 and not rec[0]["nonfinite"]
    manifest = TManifest(num_layers=4, num_stages=pp, virtual_stages=v)
    want = []
    for s_ in range(pp):
        rows = [r for c in range(v) for r in manifest.layers_of_chunk(s_, c)]
        want.append(sum(float(g[rows].double().square().sum())
                        for k, g in want_grads.items() if k.startswith("layers.")) ** 0.5)
    for key in ("grad_norm_per_stage", "param_norm_per_stage", "update_norm_per_stage",
                "act_rms_per_stage", "act_absmax_per_stage"):
        assert len(rec[0][key]) == pp and all(np.isfinite(rec[0][key])), key
    np.testing.assert_allclose(rec[0]["grad_norm_per_stage"], want, rtol=1e-5)


def test_tp_operators_against_one_process(tp_runs):
    """tp_copy (identity; backward the sum over the ranks), tp_reduce (the
    sum; backward identity) and tp_max (the max; zero gradient) on each
    rank of a tp group of 2, against the one-process sums."""
    x, g = tp_runs["inputs"]["x"], tp_runs["inputs"]["g"]
    for res in tp_runs["ops"]:
        t = res["tp_rank"]
        torch.testing.assert_close(res["copy"], x[t], rtol=0, atol=0)
        torch.testing.assert_close(res["copy_grad"], g.sum(0), rtol=0, atol=0)
        torch.testing.assert_close(res["reduce"], x.sum(0), rtol=0, atol=0)
        torch.testing.assert_close(res["reduce_grad"], g[t], rtol=0, atol=0)
        torch.testing.assert_close(res["max"], x.max(0).values, rtol=0, atol=0)
        assert not res["max_grad"].any()


def test_vocab_parallel_ce_matches_reference(ref, tp_runs):
    """The vocab-parallel CE (parallel/tp.vocab_parallel_loss_sum_count) on
    each rank of a tp group of 2 against the reference's
    _vocab_parallel_token_loss in a shard_map over a tp = 2 mesh, on the
    same preshifted targets (a fifth of them ignored): the loss sum, the
    count, dh and each rank's columns of dW."""
    from jax.sharding import PartitionSpec as P

    inp = tp_runs["inputs"]
    cfg = ref.config.LlamaConfig.tiny()
    mesh = ref.mesh.make_mesh(ref.mesh.MeshConfig(tp=2))
    h, w, labels = (jnp.asarray(inp[k].numpy()) for k in ("h", "lm_head", "targets"))
    labels = labels.astype(jnp.int32)

    def local(h_, w_):
        """The loss and its gradients on each tp device, as the reference's
        pipeline takes them (inside the shard_map)."""
        def loss_of(a, b):
            return ref.pl._vocab_parallel_token_loss({"lm_head": b}, a, labels, cfg,
                                                     preshifted=True)

        (loss_, count_), (dh_, dw_) = jax.value_and_grad(loss_of, argnums=(0, 1),
                                                         has_aux=True)(h_, w_)
        return loss_, count_, dh_, dw_

    fn = jax.shard_map(local, mesh=mesh, in_specs=(P(), P(None, "tp")),
                       out_specs=(P(), P(), P(), P(None, "tp")), check_vma=False)
    loss, count, dh, dw = fn(h, w)
    dw = np.asarray(dw)
    for res in tp_runs["ops"]:
        t = res["tp_rank"]
        np.testing.assert_allclose(float(res["ce_loss"]), float(loss), rtol=1e-6)
        assert int(res["ce_count"]) == int(count)
        np.testing.assert_allclose(res["ce_dh"].numpy(), np.asarray(dh), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(res["ce_dw"].numpy(), dw[:, t * 128:(t + 1) * 128],
                                   rtol=1e-5, atol=1e-7)


def test_init_by_shard_joins_into_one_process_init(tp_runs):
    """The trainer's init at pp 2 x tp 2 x dp 2: every rank holds only its
    stage's chunk and its tp slices; the replicas hold the same; joined over
    tp and stages, bit-equal to one process's init (model.init_params)
    from the same seed."""
    cfg = TConfig.tiny()
    one = t_llama.init_params(cfg, INIT_SEED, device="cpu")
    manifest = TManifest(num_layers=4, num_stages=2)
    by_cell = {}
    for res in tp_runs["init"]:
        (stage, chunks), = res["chunks"].items()
        key = (stage, res["tp_rank"])
        if key in by_cell:  # the other replica: the same tensors
            for k, x in chunks[0].items():
                assert torch.equal(x, by_cell[key][0][k]), k
        by_cell[key] = chunks
    joined = {}
    for stage in range(2):
        for name in by_cell[(stage, 0)][0]:
            parts = [by_cell[(stage, t)][0][name] for t in range(2)]
            dim = t_tp.tp_dim(name, parts[0].dim())
            joined.setdefault(stage, [{}])[0][name] = (parts[0] if dim is None
                                                       else torch.cat(parts, dim))
    merged = t_pl.merge_params(joined, manifest)
    assert set(merged) == set(one)
    for k in one:
        assert torch.equal(merged[k], one[k]), k


def test_trainer_layouts_match_reference_run_training(ref, tp_runs):
    """tiny_smoke with mesh.tp=2 through run_training at pp 2 x tp 2 (4
    processes; 4 microbatches of 2 rows), pp 1 x tp 2 x dp 2 (4) and pp 2 x
    tp 2 x dp 2 (8), warm-started from the reference's init, 3 steps,
    against the reference's run_training at pp 2 x tp 2 x dp 2 over the
    virtual mesh: the metrics line's loss at each step (1e-5) and the final
    params (1e-4)."""
    d = tp_runs["train_dir"]
    want = [json.loads(x)["loss"] for x in open(d / "ref" / "metrics.jsonl")
            if "loss" in json.loads(x)]
    cfg_j = ref.config.LlamaConfig.tiny()
    manifest = ref.manifest.StageManifest.for_config(cfg_j, 2)
    tree = ref.llama.init_params(jax.random.PRNGKey(4), cfg_j)
    ref_final = ref.ckpt.CheckpointManager(str(d / "ref")).load_params(
        3, ref.pl.stack_stages(tree, manifest), manifest)
    want_params = convert.params_from_jax(convert.unstack_stages(
        jax.device_get(ref_final), TManifest(num_layers=4, num_stages=2)))
    for name in TRAIN_LAYOUTS:
        got = [json.loads(x)["loss"] for x in open(d / name / "metrics.jsonl")]
        assert len(got) == len(want) == 3, name
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, err_msg=name)
        got_params = tensor_io.load_file(str(d / name / "checkpoint-3" / "params.safetensors"))
        _assert_grads_close(got_params, want_params, rtol=1e-4)
        meta = json.load(open(d / name / "checkpoint-3" / "meta.json"))
        assert meta["topology"]["tp"] == 2, meta["topology"]


# ---------------------------------------------------------------------------
# placement, refusals, the run of record's config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", ["tiny", "llama_65b", "llama2_70b"])
@pytest.mark.parametrize("tp,dp", [(2, 2), (4, 2), (2, 4)])
def test_zero1_placement_under_tp_matches_reference(ref, preset, tp, dp):
    """zero1_dims on each leaf of a tp rank (a chunk's [k, ...] layer leaves
    and the embedding, norm and lm_head, at the local widths) puts the dp
    split where the reference's _zero1_leaf_spec puts it on the
    stage-stacked global leaf under stage_param_specs(tp=True), called
    directly, at pp 4: never on the tp dim; the column-parallel weights on
    their input dim, the vocab-parallel lm_head on dim 0."""
    from llama_pipeline_parallel_tpu.parallel.train_step import _zero1_leaf_spec

    cfg_j = getattr(ref.config.LlamaConfig, preset)()
    tree = jax.eval_shape(lambda: ref.pl.stack_stages(
        ref.llama.init_params(jax.random.PRNGKey(0), cfg_j),
        ref.manifest.StageManifest.for_config(cfg_j, 4)))
    specs = ref.pl.stage_param_specs(tree, tp=True)
    flat_specs = dict(jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0])
    checked = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(str(getattr(k, "key", k)) for k in path)
        stacked = name.startswith("layers.")
        spec = _zero1_leaf_spec(flat_specs[path], tuple(leaf.shape), dp)
        dims = [i for i, ax in enumerate(tuple(spec)) if ax == "dp"]
        want = (dims[0] - 1 if stacked else dims[0]) if dims else None
        mine = tuple(leaf.shape[1:]) if stacked else tuple(leaf.shape)
        local = tuple(t_tp.tp_shard(name, torch.empty(mine, device="meta"), 0, tp).shape)
        assert t_optim.zero1_dims({name: local}, dp, tp)[name] == want, (name, spec)
        checked += 1
    assert checked >= 10


@pytest.mark.parametrize("bad,overrides", [
    ("loss_chunks", ["loss_vocab_chunks=4"]),
    ("kernel_ce", ["kernels.ce=pallas"]),
    ("heads", ["model.num_attention_heads=2", "model.num_key_value_heads=1"]),
    ("ffn", ["model.intermediate_size=129"]),
    ("vocab", ["model.vocab_size=255"]),
])
def test_tp_refusals_match_reference(ref, tmp_path, bad, overrides):
    """Under tp = 2 the trainer refuses what the reference's pipeline build
    refuses (a chunked or kernel CE head, a tp that does not divide the
    heads, kv heads, FFN width or vocabulary), with the reference's words."""
    cfg_j = ref.config.LlamaConfig.tiny()
    node = {"loss_chunks": {}, "kernel_ce": {}, "heads": dict(num_attention_heads=2,
                                                               num_key_value_heads=1),
            "ffn": dict(intermediate_size=129), "vocab": dict(vocab_size=255)}[bad]
    import dataclasses

    cfg_j = dataclasses.replace(cfg_j, **node)
    manifest = ref.manifest.StageManifest(num_layers=4, num_stages=2)
    pcfg = ref.pl.PipelineConfig(num_stages=2, num_microbatches=2,
                                 loss_chunks=4 if bad == "loss_chunks" else 1,
                                 kernel_ce=bad == "kernel_ce")
    stacked = jax.eval_shape(lambda: ref.pl.stack_stages(
        ref.llama.init_params(jax.random.PRNGKey(0), cfg_j), manifest))
    mesh = ref.mesh.make_mesh(ref.mesh.MeshConfig(pp=2, tp=2))
    with pytest.raises(ValueError) as want:
        ref.pl.make_pipeline_loss_and_grad(mesh, cfg_j, pcfg, stacked)
    cfg = t_config.load_config(os.path.join(REPO, "conf", "tiny_smoke.yaml"),
                               ["mesh.tp=2", f"output_dir={tmp_path}", *overrides])
    with pytest.raises(ValueError) as got:
        t_train.build_run(cfg, device="cpu")
    assert str(got.value) == str(want.value)


def test_run_of_record_config_runs_through_the_cli(tmp_path):
    """conf/llama_65b_pp8_tp2_dp2.yaml through the CLI under
    torch.distributed.run in 8 processes on the CPU, with only the model cut
    to the tiny preset and pp to 2 (its tp 2 x dp 2, optimizer_offload,
    optimizer_offload_zero2, schedule and data keys as written) and a few
    steps: exit 0, finite losses."""
    import subprocess

    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "8",
           "--master_addr", "localhost", "--master_port", str(_free_port()),
           "-m", "llama_pipeline_parallel_tpu_torch.cli", "--config",
           "conf/llama_65b_pp8_tp2_dp2.yaml", "--device", "cpu", "model.preset=tiny",
           "mesh.pp=2", "max_steps=1", "total_steps=500", "save_final=false",
           "resume=false", f"output_dir={tmp_path}"]
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-3000:]
    losses = [json.loads(x)["loss"] for x in open(tmp_path / "metrics.jsonl")]
    assert len(losses) == 1 and all(np.isfinite(losses)), losses
    assert "pipeline pp2xdp2xtp2xsp1" in res.stderr
