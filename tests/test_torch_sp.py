"""The port's sequence parallelism (ring attention, Ulysses, the pipeline's sp
terms, the trainer at pp x tp x sp, checkpoints across sp) against the JAX
package's, on the CPU at the `tiny` preset in fp32 (4 heads of 16, 2 kv
heads).

The processes are gloo ranks started here (tests/torch_sp_worker.py), two
launches of 4 started together, each with RANK / WORLD_SIZE / MASTER_ADDR /
MASTER_PORT and a join timeout; the reference runs the same layouts on
tests/conftest.py's 8 virtual CPU devices (its ring and Ulysses inside
shard_map). Parameters are the reference's init carried over by convert.py;
inputs are numpy from a seed.

Tolerances: the ring and Ulysses outputs within 1e-5 (absolute) of the
reference's, their gradients within 1e-4 of the largest element of the
reference's; the pipeline's loss and gradients at tests/test_torch_pipeline.py's
LOSS_RTOL / GRAD_RTOL; trainer losses 1e-5 and final params 1e-4 against
the reference's run_training; a resume across sp layouts 1e-5. Where the
result is exactly zero by construction (a row that sees no key, a slab no
query sees) the test says exactly.
"""

import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_pipeline_parallel_tpu_torch import convert
from llama_pipeline_parallel_tpu_torch import train as t_train
from llama_pipeline_parallel_tpu_torch.ckpt import tensor_io
from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig as TConfig
from llama_pipeline_parallel_tpu_torch.models.llama.manifest import StageManifest as TManifest
from llama_pipeline_parallel_tpu_torch.parallel import pipeline as t_pl
from llama_pipeline_parallel_tpu_torch.parallel import ring_attention as t_ring
from llama_pipeline_parallel_tpu_torch.parallel import sp as t_sp
from llama_pipeline_parallel_tpu_torch.parallel import tp as t_tp
from llama_pipeline_parallel_tpu_torch.parallel.mesh import MeshConfig, layout_for
from llama_pipeline_parallel_tpu_torch.utils import config as t_config
from tests.test_torch_dp import OPT, _dp_batch, _warm_checkpoints, finish, launch
from tests.test_torch_pipeline import (
    GRAD_RTOL,
    LOSS_RTOL,
    _assert_grads_close,
    _tree,
    ref,  # noqa: F401  (the reference fixture)
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_sp_worker.py")
CONFIG = os.path.join(REPO, "conf", "codellama_34b_16k.yaml")
MICROBATCHES = 4
OUT_ATOL = 1e-5
RESUME_TOL = 1e-5
# the attention ops' inputs: b 2, 32 tokens, 4 heads of 16 (2 kv heads for
# Ulysses); packed segment ids: row 0's second segment crosses every slab
# boundary of sp 2 and sp 4, then a pad tail; row 1 three segments
ATTN_SHAPE = dict(b=2, s=32, h=4, hd=16)
SEGMENTS = [[1] * 5 + [2] * 19 + [0] * 8, [3] * 7 + [4] * 10 + [5] * 15]
# (kind, sp, backend or inner attention, packed) of each attention job
ATTN_JOBS = {
    "ring-sp2-exact": ("ring", 2, "exact", False),
    "ring-sp2-exact-packed": ("ring", 2, "exact", True),
    "ring-sp2-flash": ("ring", 2, "flash", False),
    "ring-sp2-flash-packed": ("ring", 2, "flash", True),
    "ring-sp4-exact": ("ring", 4, "exact", False),
    "ring-sp4-flash-packed": ("ring", 4, "flash", True),
    "ulysses-sp2-exact": ("ulysses", 2, "exact", True),
    "ulysses-sp2-flash": ("ulysses", 2, "flash", True),
    "ulysses-sp4-exact": ("ulysses", 4, "exact", True),
}
# (pp, dp, tp, sp, schedule, strategy, port attention, kernel CE, kernel
# prologue) of each pipeline step job, all at 4 processes; the reference
# runs the exact attention, its interpret-mode Pallas CE and prologue
STEPS = {
    "pp2xsp2": (2, 1, 1, 2, "1f1b", "ring", "exact", False, False),
    "pp1xdp2xsp2": (1, 2, 1, 2, "1f1b", "ulysses", "exact", False, False),
    "pp1xtp2xsp2": (1, 1, 2, 2, "1f1b", "ring", "flash", False, False),
    "pp2xsp2-zb1": (2, 1, 1, 2, "zb1", "ring", "exact", False, False),
    "pp2xsp2-kernels": (2, 1, 1, 2, "1f1b", "ring", "flash", True, True),
}
CE_CHUNKS = 4
EVAL_LAYOUT = "pp2xsp2"
# conf/codellama_34b_16k.yaml at the tiny cut: the model, 32-token rows, 2
# microbatches of 1 row, 3 steps, warm-started from the reference's init
TRAIN_ARGS = ["model.preset=tiny", "model.dtype=float32", "mesh.pp=1",
              "dataset.seq_length=32", "max_seq_length=32", "dataset.pseudo_dataset_len=64",
              "gradient_accumulation_steps=2", "per_device_train_batch_size=1",
              "attention=exact", "learning_rate=5e-3", "warmup_steps=1", "total_steps=20",
              "max_steps=3", "logging_steps=1", "save_steps=2", "save_final=true"]
SP_MESH = ["mesh.tp=2", "mesh.sp=2"]
ONE_MESH = ["mesh.tp=1", "mesh.sp=1"]


def _attn_inputs():
    rng = np.random.RandomState(21)
    b, s, h, hd = ATTN_SHAPE["b"], ATTN_SHAPE["s"], ATTN_SHAPE["h"], ATTN_SHAPE["hd"]

    def rand(heads):
        return rng.randn(b, s, heads, hd).astype(np.float32)

    seg = np.asarray(SEGMENTS, np.int32)
    return {"ring": dict(q=rand(h), k=rand(h), v=rand(h), dout=rand(h), seg=seg),
            "ulysses": dict(q=rand(h), k=rand(2), v=rand(2), dout=rand(h), seg=seg)}


def _ref_attention(kind, sp, impl, case, packed):
    """The reference's ring_attention (backend exact) or ulysses_attention
    (inner exact attention) in a shard_map over an sp mesh: (out, dq, dk,
    dv) of the whole sequence. Flash inside Ulysses keeps the kernels'
    segment rule (a pad row sees no key), which the reference's exact op
    does not (a pad row attends uniformly): its oracle is the reference's
    GQA ring (make_sp_attention, packed), whose exact slabs keep that rule."""
    from jax.sharding import PartitionSpec as P

    from llama_pipeline_parallel_tpu.ops.attention import attention
    from llama_pipeline_parallel_tpu.parallel import mesh as ref_mesh
    from llama_pipeline_parallel_tpu.parallel.ring_attention import ring_attention
    from llama_pipeline_parallel_tpu.parallel.sp import make_sp_attention
    from llama_pipeline_parallel_tpu.parallel.ulysses import ulysses_attention

    mesh = ref_mesh.make_mesh(ref_mesh.MeshConfig(sp=sp))
    seg = jnp.asarray(case["seg"]) if packed else None
    spec = P(None, "sp")
    gqa_ring = make_sp_attention("ring", attention, packed=True)

    def local(q, k, v, *seg_):
        mask = seg_[0] if seg_ else None
        if kind == "ring":
            return ring_attention(q, k, v, mask, causal=True, axis_name="sp", backend="exact")
        if impl == "flash":
            return gqa_ring(q, k, v, mask, causal=True)
        return ulysses_attention(q, k, v, mask, causal=True, axis_name="sp")

    extra = () if seg is None else (seg,)
    fn = jax.shard_map(local, mesh=mesh, in_specs=(spec,) * (3 + len(extra)),
                       out_specs=spec, check_vma=False)

    def fwd_bwd(q, k, v, dout):
        out, vjp = jax.vjp(lambda a, b_, c: fn(a, b_, c, *extra), q, k, v)
        return (out, *vjp(dout))

    return [np.asarray(x) for x in jax.jit(fwd_bwd)(
        *(jnp.asarray(case[n]) for n in ("q", "k", "v", "dout")))]


def _ref_pipeline(ref, tree, batch, pp, dp, tp, sp, schedule, strategy, ce, prologue,
                  with_eval=False):
    """The reference's make_pipeline_loss_and_grad at the layout (exact
    attention), and, `with_eval`, its make_pipeline_eval_fn's (sum, count)
    there."""
    cfg = ref.config.LlamaConfig.tiny()
    manifest = ref.manifest.StageManifest(num_layers=cfg.num_hidden_layers, num_stages=pp)
    pcfg = ref.pl.PipelineConfig(num_stages=pp, num_microbatches=MICROBATCHES,
                                 schedule=schedule, remat=True, kernel_ce=ce,
                                 loss_chunks=CE_CHUNKS if ce else 1, kernel_prologue=prologue,
                                 sequence_parallel=strategy)
    mesh = ref.mesh.make_mesh(ref.mesh.MeshConfig(pp=pp, dp=dp, tp=tp, sp=sp))
    stacked = ref.pl.stack_stages(tree, manifest)
    jbatch = {k: jnp.asarray(x) for k, x in batch.items()}
    fn = jax.jit(ref.pl.make_pipeline_loss_and_grad(mesh, cfg, pcfg, stacked,
                                                    attn_fn=ref.attn.attention))
    loss, grads = fn(stacked, jbatch)
    canonical = convert.unstack_stages(jax.device_get(grads), TManifest(
        num_layers=cfg.num_hidden_layers, num_stages=pp))
    ev = None
    if with_eval:
        ev = ref.pl.make_pipeline_eval_fn(mesh, cfg, pcfg, stacked, attn_fn=ref.attn.attention)
        ev = tuple(float(x) for x in jax.jit(ev)(stacked, jbatch))
    return float(loss), convert.params_from_jax(canonical), ev


def _slices(canonical, res, pp, tp):
    """A rank's pieces of a canonical tree (its stage's chunk at pp > 1, its
    tp slices), named as its optimizer names them."""
    if pp == 1:
        return {k: t_tp.tp_shard(k, x, res["tp_rank"], tp) for k, x in canonical.items()}
    manifest = TManifest(num_layers=4, num_stages=pp)
    return t_pl.flatten_chunks(t_pl.chunk_views(canonical, manifest, tuple(res["stages"]),
                                                res["tp_rank"], tp))


def _job_step(name):
    pp, dp, tp, sp, schedule, strategy, attn, ce, prologue = STEPS[name]
    return dict(kind="step", name=name, pp=pp, dp=dp, tp=tp, sp=sp, schedule=schedule,
                strategy=strategy, attention=attn, ce=ce, loss_chunks=CE_CHUNKS if ce else 1,
                prologue=prologue, microbatches=MICROBATCHES, eval=name == EVAL_LAYOUT)


def _results(out, name, n=4):
    return [torch.load(out / f"{name}-rank{r}.pt") for r in range(n)]


def _losses(path):
    return [json.loads(x)["loss"] for x in open(path / "metrics.jsonl") if "loss" in json.loads(x)]


def _train_cfg(d, name, *extra):
    return t_config.load_config(CONFIG, TRAIN_ARGS + list(extra) + [f"output_dir={d}/{name}"])


def _resume_dir(d, src, name, step=2):
    """A fresh output_dir holding only `src`'s checkpoint-`step`."""
    shutil.copytree(d / src / f"checkpoint-{step}", d / name / f"checkpoint-{step}")
    return name


@pytest.fixture(scope="module")
def sp_runs(ref, tmp_path_factory):
    """Every attention and step job in one launch of 4 processes, the
    trainer's jobs (conf/codellama_34b_16k.yaml at the tiny cut: 3 steps at
    pp 1 x tp 2 x sp 2, a resume there from a one-process checkpoint, the
    seq % sp refusal) in another, started together, while the reference
    computes its side. Before the launches, the one-process run whose
    checkpoint-2 the launch resumes; after them, a one-process resume of
    the launch's checkpoint-2."""
    tree = _tree(ref)
    batch = _dp_batch()
    attn = _attn_inputs()
    d = tmp_path_factory.mktemp("sp_train")
    _warm_checkpoints(ref, d)
    warm = [f"model_name_or_path={d}/warm_port"]
    # the one-process run (tp 1, sp 1) that the launch resumes at sp 2
    one = t_train.run_training(_train_cfg(d, "one", *ONE_MESH, *warm, "resume=false"),
                               device="cpu")
    resumed_at_sp = _resume_dir(d, "one", "sp_from_one")
    inputs = {"params": convert.params_from_jax(tree), "optimizer": OPT,
              "batch": {k: torch.from_numpy(x) for k, x in batch.items()},
              "attn": {kind: {k: torch.from_numpy(x) for k, x in case.items()}
                       for kind, case in attn.items()}}
    ops_dir, train_dir = tmp_path_factory.mktemp("sp_ops"), tmp_path_factory.mktemp("sp_jobs")
    attn_jobs = [dict(kind=kind, name=name, sp=sp, dp=4 // sp, case=kind, packed=packed,
                      backend=impl, inner=impl)
                 for name, (kind, sp, impl, packed) in ATTN_JOBS.items()]
    torch.save(inputs, ops_dir / "inputs.pt")
    torch.save(attn_jobs + [_job_step(n) for n in STEPS], ops_dir / "jobs.pt")
    train = lambda name, *extra: dict(  # noqa: E731
        kind="train", name=name, config=CONFIG,
        overrides=TRAIN_ARGS + SP_MESH + list(extra) + [f"output_dir={d}/{name}"])
    torch.save({}, train_dir / "inputs.pt")
    torch.save([train("sp", *warm, "resume=false"),
                train(resumed_at_sp, "resume=true"),
                dict(kind="refuse", name="refuse", config=CONFIG,
                     overrides=TRAIN_ARGS + SP_MESH + [
                         "dataset.seq_length=31", "max_seq_length=31",
                         f"output_dir={d}/refuse"])], train_dir / "jobs.pt")
    procs = [launch(4, [sys.executable, WORKER, str(ops_dir)]),
             launch(4, [sys.executable, WORKER, str(train_dir)])]
    want_attn = {name: _ref_attention(kind, sp, impl, attn[kind], packed)
                 for name, (kind, sp, impl, packed) in ATTN_JOBS.items()}
    want = {name: _ref_pipeline(ref, tree, batch, *STEPS[name][:6], *STEPS[name][7:],
                                with_eval=name == EVAL_LAYOUT)
            for name in STEPS}
    ref_args = [*SP_MESH, f"model_name_or_path={d}/warm_ref", "resume=false"]
    ref.train.run_training(_train_cfg(d, "ref", *ref_args))
    with pytest.raises(ValueError) as refused:
        ref.train.run_training(_train_cfg(d, "ref_refuse", "mesh.sp=2", "dataset.seq_length=31",
                                          "max_seq_length=31"))
    for p in procs:
        for rc, _, stderr in finish(p, timeout=300):
            assert rc == 0, stderr[-3000:]
    # the launch's checkpoint-2 resumed in one process
    back = t_train.run_training(_train_cfg(d, _resume_dir(d, "sp", "one_from_sp"), *ONE_MESH,
                                           "resume=true"), device="cpu")
    return dict(d=d, want_attn=want_attn, want=want, attn=attn,
                attn_results={n: _results(ops_dir, n) for n in ATTN_JOBS},
                results={n: _results(ops_dir, n) for n in STEPS},
                train={n: _results(train_dir, n) for n in ("sp", resumed_at_sp, "refuse")},
                one=one, back=back, resumed_at_sp=resumed_at_sp,
                ref_refused=str(refused.value))


def _slab(x, sp, i):
    n = x.shape[1] // sp
    return x[:, i * n:(i + 1) * n]


@pytest.mark.parametrize("name", list(ATTN_JOBS))
def test_attention_ops_match_reference(sp_runs, name):
    """ring_attention (exact and flash backends; with and without packed
    segment ids, a segment crossing the slab boundaries and a pad tail) and
    ulysses_attention (GQA 4:2, segment ids; exact and flash inside) at sp 2
    and 4 against the reference's in shard_map (flash inside Ulysses against
    the reference's GQA ring, which keeps the kernels' segment rule): each
    slab's output within
    1e-5 and dq, dk, dv within 1e-4 of the largest element. Under causal
    masking rank 0's q slab sees no key of every later slab. Exactly zero,
    where the segment test is the kernels' (the ring, flash inside
    Ulysses; the exact op lets a pad row attend uniformly, as the
    reference's does): the output and dq of pad rows (they see no key), dk
    and dv of pad keys (no query sees them)."""
    kind, sp, impl, packed = ATTN_JOBS[name]
    want = sp_runs["want_attn"][name]
    seg = sp_runs["attn"][kind]["seg"]
    for res in sp_runs["attn_results"][name]:
        i = res["sp_rank"]
        w_out, w_dq, w_dk, w_dv = (_slab(x, sp, i) for x in want)
        np.testing.assert_allclose(res["out"].numpy(), w_out, rtol=0, atol=OUT_ATOL)
        _assert_grads_close({"dq": res["dq"], "dk": res["dk"], "dv": res["dv"]},
                            {"dq": w_dq, "dk": w_dk, "dv": w_dv})
        if packed and (kind == "ring" or impl == "flash"):
            pad = _slab(seg, sp, i) == 0
            for key in ("out", "dq", "dk", "dv"):
                assert not res[key].numpy()[pad].any(), key


@pytest.mark.parametrize("backend", ["exact", "flash"])
def test_slab_edges_exact(backend):
    """The ring's per-slab step at the two slabs the sp ring adds: a slab
    whose every score is masked (rank 0's queries against rank 1's keys:
    out 0, lse NEG_INF, dq / dk / dv 0, exactly) and one where no score is
    (rank 1's queries against rank 0's keys: the non-causal attention of the
    slab, 1e-5), on both backends (flash: the kernels' plain tiles here)."""
    rng = np.random.RandomState(8)
    q, k, v, do = (torch.from_numpy(rng.randn(2, 4, 16, 16).astype(np.float32))
                   for _ in range(4))
    kw = dict(causal=True, scale=0.25)
    out, lse = t_ring._slab_fwd(backend, q, k, v, q_offset=0, kv_offset=16, **kw)
    assert not out.any() and bool((lse == t_ring.NEG_INF).all())
    delta = torch.randn(2, 4, 16, 1)
    grads = t_ring._slab_bwd(backend, q, k, v, do, lse, delta, q_offset=0, kv_offset=16, **kw)
    assert not any(g.any() for g in grads)
    full, lse_full = t_ring._slab_fwd(backend, q, k, v, q_offset=16, kv_offset=0, **kw)
    want, want_lse = t_ring._slab_fwd_exact(q, k, v, causal=False, scale=0.25, q_offset=0,
                                            kv_offset=0)
    torch.testing.assert_close(full.float(), want, rtol=0, atol=OUT_ATOL)
    torch.testing.assert_close(lse_full, want_lse, rtol=0, atol=OUT_ATOL)


@pytest.mark.parametrize("name", list(STEPS))
def test_step_matches_reference_pipeline(sp_runs, name):
    """One step at each layout (ring under 1f1b and zb1, with pp, tp or dp;
    Ulysses at dp 2; the ring's flash backend at tp 2 and with the CE and
    prologue kernels' plain twins against the reference's interpret-mode
    Pallas ones) against the reference's make_pipeline_loss_and_grad on the
    same layout: the loss on every rank, every rank's pieces of every
    gradient (sp peers hold the same sums), the gradient norm; at pp 2 x sp
    2 the eval pass's (sum, count) against make_pipeline_eval_fn's. Ranks
    sit in the reference's row-major (pp, dp, sp, tp) order."""
    pp, dp, tp, sp = STEPS[name][:4]
    want_loss, want_grads, want_eval = sp_runs["want"][name]
    want_norm = float(torch.stack([g.double().square().sum()
                                   for g in want_grads.values()]).sum().sqrt())
    order = np.arange(pp * dp * sp * tp).reshape(pp, dp, sp, tp)
    for rank, res in enumerate(sp_runs["results"][name]):
        stage = res["stages"][0] if pp > 1 else 0
        assert order[stage, res["replica"], res["sp_rank"], res["tp_rank"]] == rank
        np.testing.assert_allclose(float(res["loss"]), want_loss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(res["norm"]), want_norm, rtol=1e-5)
        _assert_grads_close(res["grads"], _slices(want_grads, res, pp, tp), rtol=GRAD_RTOL)
        if name == EVAL_LAYOUT:
            np.testing.assert_allclose(float(res["eval"][0]), want_eval[0], rtol=LOSS_RTOL)
            assert int(res["eval"][1]) == int(want_eval[1])


def test_trainer_matches_reference_run_training(ref, sp_runs):
    """conf/codellama_34b_16k.yaml at model.preset=tiny mesh.pp=1 mesh.tp=2
    mesh.sp=2 (its ring, offloaded optimizer and remat as written; 32-token
    rows) through run_training in 4 processes, warm-started from the
    reference's init, 3 steps, against the reference's run_training at the
    same cut on the virtual mesh: the metrics line's loss at each step
    (1e-5) and the final params (1e-4); the topology records sp."""
    d = sp_runs["d"]
    want = _losses(d / "ref")
    got = _losses(d / "sp")
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    jtree, _, _, _ = ref.ckpt.load_module_checkpoint(str(d / "ref"))
    want_params = convert.params_from_jax(jax.device_get(jtree))
    got_params = tensor_io.load_file(str(d / "sp" / "checkpoint-3" / "params.safetensors"))
    _assert_grads_close(got_params, want_params, rtol=1e-4)
    meta = json.load(open(d / "sp" / "checkpoint-3" / "meta.json"))
    assert (meta["topology"]["sp"], meta["topology"]["tp"]) == (2, 2), meta["topology"]


def test_checkpoints_resume_across_sp(sp_runs):
    """A save at pp 1 x tp 2 x sp 2 (step 2) resumed in one process (tp 1,
    sp 1), and a one-process save resumed at pp 1 x tp 2 x sp 2: step 3's
    loss within 1e-5 of the run that saved; the two uninterrupted runs
    agree too."""
    d = sp_runs["d"]
    sp_losses, one_losses = _losses(d / "sp"), sp_runs["one"]["losses"]
    np.testing.assert_allclose(sp_losses, one_losses, rtol=0, atol=RESUME_TOL)
    back = sp_runs["back"]
    assert back["start_step"] == 2 and len(back["losses"]) == 1
    np.testing.assert_allclose(back["losses"][0], sp_losses[2], rtol=0, atol=RESUME_TOL)
    for res in sp_runs["train"][sp_runs["resumed_at_sp"]]:
        assert len(res["losses"]) == 1
        np.testing.assert_allclose(res["losses"][0], one_losses[2], rtol=0, atol=RESUME_TOL)


def test_sp_refusals_match_reference(ref, sp_runs):
    """A sequence length sp does not divide, refused by the trainer in 4
    processes with the reference's words; Ulysses with heads a tp rank
    cannot split over sp, in the reference's words (make_pipeline_loss_and_grad
    at sp 8); every stage in one process at sp > 1, by name."""
    for res in sp_runs["train"]["refuse"]:
        assert res["error"] == sp_runs["ref_refused"]
    cfg_j = ref.config.LlamaConfig.tiny()
    manifest = ref.manifest.StageManifest.for_config(cfg_j, 1)
    stacked = jax.eval_shape(lambda: ref.pl.stack_stages(
        ref.llama.init_params(jax.random.PRNGKey(0), cfg_j), manifest))
    pcfg = ref.pl.PipelineConfig(num_stages=1, num_microbatches=1, sequence_parallel="ulysses")
    with pytest.raises(ValueError) as want:
        ref.pl.make_pipeline_loss_and_grad(ref.mesh.make_mesh(ref.mesh.MeshConfig(sp=8)),
                                           cfg_j, pcfg, stacked)
    with pytest.raises(ValueError) as got:
        t_sp.check_sp(TConfig.tiny(), 1, 8, "ulysses")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="every stage in one process is not run at sp=2"):
        layout_for(MeshConfig(pp=2, sp=2), 2)


def test_layout_of_the_16k_config():
    """conf/codellama_34b_16k.yaml's own mesh (pp 4 x tp 2 x sp 2) runs one
    stage a process in 16 processes; pp 1 x tp 2 x sp 2 one (sp, tp) cell a
    process in 4; one process is refused, naming the count."""
    mesh = t_config.load_config(CONFIG, [])["mesh"]
    config = MeshConfig(**{ax: int(mesh.get(ax, 1)) for ax in ("pp", "dp", "tp", "sp")})
    assert config == MeshConfig(pp=4, tp=2, sp=2)
    assert layout_for(config, 16) == "stage_per_process"
    assert layout_for(MeshConfig(tp=2, sp=2), 4) == "replica_per_process"
    with pytest.raises(ValueError, match="run it in pp\\*dp\\*sp\\*tp=16 processes"):
        layout_for(config, 1)
