"""The port's data parallelism (pp x dp across processes, ZeRO-1, evaluation,
the pipeline's host tiers over DistTransport, the stop vote) against the JAX
package's, on the CPU at the `tiny` preset in fp32.

The processes are gloo ranks started here (tests/torch_dist_worker.py, or
the CLI), each with RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT; the
reference runs the same layout on tests/conftest.py's 8 virtual CPU devices.
Parameters are the reference's init carried over by convert.py; batches are
numpy from a seed, with a different pad tail on every row so that the
replicas' valid-target counts differ (a count not summed over dp would show).

Tolerances: the loss within rtol 1e-5 of the reference's, each gradient leaf
within 1e-4 of its own largest element (tests/test_torch_pipeline.py's
rules); trainer losses 1e-5 and final params 1e-4 against the reference's
run_training; the eval sum 1e-5 (tests/test_torch_eval.py's) and its count
exactly. Where both sides are this package (ZeRO-1 against the replicated
AdamW on the same gradients, a pipeline with its host tiers against the same
without) the arithmetic is the same element for element, and the test says
bit-equal.
"""

import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_pipeline_parallel_tpu_torch import convert
from llama_pipeline_parallel_tpu_torch.ckpt import checkpoint as t_ckpt
from llama_pipeline_parallel_tpu_torch.ckpt import tensor_io
from llama_pipeline_parallel_tpu_torch.models.llama import model as t_llama
from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig as TConfig
from llama_pipeline_parallel_tpu_torch.models.llama.manifest import StageManifest as TManifest
from llama_pipeline_parallel_tpu_torch.optim import optimizer as t_optim
from llama_pipeline_parallel_tpu_torch.parallel import pipeline as t_pl
from llama_pipeline_parallel_tpu_torch.parallel import train_step as t_ts
from llama_pipeline_parallel_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from llama_pipeline_parallel_tpu_torch.utils import config as t_config
from tests.test_torch_pipeline import (
    GRAD_RTOL,
    LOSS_RTOL,
    PROCESS_TIMEOUT_S,
    _assert_grads_close,
    _batch,
    _free_port,
    _tree,
    ref,  # noqa: F401  (the reference fixture)
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
OPT = dict(learning_rate=5e-3, total_steps=20, warmup_steps=1)
# (pp, dp, processes) of the step parity: one stage a process, and one
# replica a process (every stage in each, over the local transport)
LAYOUTS = {"pp2xdp2": (2, 2, 4), "pp2xdp2-2proc": (2, 2, 2), "pp1xdp2": (1, 2, 2)}
MICROBATCHES = 4
# the pipeline runs after the step at pp 2 x dp 2 in 4 processes (one stage a
# process: DistTransport): zb1 with both host tiers, and without them
TIERS = dict(offload_wgrad=True, offload_activations=True)
VARIANTS = {"zb1": ("zb1", {}), "zb1-stash": ("zb1", TIERS)}
VARIANT_LAYOUT = "pp2xdp2"
# the eval sum against the reference's (tests/test_torch_eval.py's: fp32
# through 4 layers, summed in other orders)
EVAL_SUM_RTOL = 1e-5


def launch(n: int, argv: list[str], env: dict | None = None) -> list[subprocess.Popen]:
    """`n` processes of `argv` as the gloo ranks of one group (their output
    piped: `finish` returns it)."""
    port = str(_free_port())
    procs = []
    for rank in range(n):
        # one thread a process: several processes share the test's cores
        penv = {**os.environ, "PYTHONPATH": REPO, "RANK": str(rank), "LOCAL_RANK": str(rank),
                "WORLD_SIZE": str(n), "MASTER_ADDR": "localhost", "MASTER_PORT": port,
                "OMP_NUM_THREADS": "1", **(env or {})}
        procs.append(subprocess.Popen(argv, cwd=REPO, env=penv, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    return procs


def finish(procs: list[subprocess.Popen], timeout: float = PROCESS_TIMEOUT_S) -> list:
    """Wait for every process (killing all at the deadline); [(rc, stdout,
    stderr)] in rank order."""
    deadline = time.monotonic() + timeout
    out = []
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        out.append((p.returncode, stdout, stderr))
    return out


def cli(*overrides: str) -> list[str]:
    return [sys.executable, "-m", "llama_pipeline_parallel_tpu_torch.cli", "--config",
            "conf/tiny_smoke.yaml", "--device", "cpu", *overrides]


def _dp_batch(seed=3):
    """8 rows of 16 tokens, row i right-padded by i positions."""
    batch = _batch(b=8, s=16, seed=seed)
    for i in range(8):
        if i:
            batch["attention_mask"][i, -i:] = 0
    batch["labels"] = np.where(batch["attention_mask"] != 0, batch["input_ids"],
                               -100).astype(np.int32)
    return batch


def _eval_batch():
    """_dp_batch from another seed: row i right-padded by i positions, so
    replica 0 of 2 holds more valid targets than replica 1."""
    return _dp_batch(seed=4)


def _ref_loss_and_grad(ref, tree, batch, pp, dp, schedule="1f1b", tiers=None):
    """The reference's pipeline at MeshConfig(pp, dp), with its offload knobs
    `tiers` (their stores kept in regular memory on the CPU, as
    tests/test_torch_host_stash.py runs them)."""
    cfg = ref.config.LlamaConfig.tiny()
    manifest = ref.manifest.StageManifest(num_layers=cfg.num_hidden_layers, num_stages=pp)
    pcfg = ref.pl.PipelineConfig(num_stages=pp, num_microbatches=MICROBATCHES, remat=True,
                                 schedule=schedule, **(tiers or {}))
    mesh = ref.mesh.make_mesh(ref.mesh.MeshConfig(pp=pp, dp=dp))
    stacked = ref.pl.stack_stages(tree, manifest)
    fn = jax.jit(ref.pl.make_pipeline_loss_and_grad(mesh, cfg, pcfg, stacked,
                                                    attn_fn=ref.attn.attention))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LPT_HOST_STASH_FORCE", "0")
        loss, grads = fn(stacked, {k: jnp.asarray(v) for k, v in batch.items()})
    canonical = convert.unstack_stages(jax.device_get(grads), TManifest(
        num_layers=cfg.num_hidden_layers, num_stages=pp))
    return float(loss), convert.params_from_jax(canonical)


def _ref_eval(ref, tree, batches, pp, dp, tp=1, microbatches=MICROBATCHES):
    """The reference's make_pipeline_eval_fn at the layout on each global
    batch: [(loss sum, valid count)]."""
    cfg = ref.config.LlamaConfig.tiny()
    manifest = ref.manifest.StageManifest(num_layers=cfg.num_hidden_layers, num_stages=pp)
    pcfg = ref.pl.PipelineConfig(num_stages=pp, num_microbatches=microbatches)
    mesh = ref.mesh.make_mesh(ref.mesh.MeshConfig(pp=pp, dp=dp, tp=tp))
    stacked = ref.pl.stack_stages(tree, manifest)
    fn = jax.jit(ref.pl.make_pipeline_eval_fn(mesh, cfg, pcfg, stacked,
                                              attn_fn=ref.attn.attention))
    out = []
    for batch in batches:
        loss_sum, count = fn(stacked, {k: jnp.asarray(np.asarray(x)) for k, x in batch.items()})
        out.append((float(loss_sum), int(count)))
    return out


@pytest.fixture(scope="module")
def steps(ref, tmp_path_factory):
    """One train_step at each of LAYOUTS in its processes (started together),
    from the reference's init on _dp_batch, after the loss-only pass over an
    eval batch, and at VARIANT_LAYOUT followed by the VARIANTS pipelines:
    {layout: (dir, [rank results])}."""
    tree = _tree(ref)
    batch = _dp_batch()
    runs = {}
    for name, (pp, dp, n) in LAYOUTS.items():
        out = tmp_path_factory.mktemp(name)
        torch.save({"params": convert.params_from_jax(tree),
                    "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
                    "eval_batch": {k: torch.from_numpy(v) for k, v in _eval_batch().items()},
                    "variants": VARIANTS if name == VARIANT_LAYOUT else {},
                    "microbatches": MICROBATCHES, "optimizer": OPT}, out / "inputs.pt")
        runs[name] = (out, launch(n, [sys.executable, WORKER, "step", str(out), str(pp),
                                      str(dp), "1f1b"]))
    results = {}
    for name, (out, procs) in runs.items():
        for rc, _, stderr in finish(procs):
            assert rc == 0, stderr[-3000:]
        results[name] = [{**torch.load(out / f"rank{r}.pt"), "path": str(out / f"rank{r}.pt")}
                         for r in range(LAYOUTS[name][2])]
    return tree, batch, results


def _canonical(results, pp, key, variant=None):
    """The canonical tree of `key` ("grads", "masters"; with `variant`, that
    VARIANTS pipeline's gradients) from replica 0's processes (every stage),
    and each replica's the same."""
    manifest = TManifest(num_layers=TConfig.tiny().num_hidden_layers, num_stages=pp)
    trees = {}
    for res in results:
        trees.setdefault(res["replica"], {}).update(
            res[key] if variant is None else res["variants"][variant][1])
    if pp == 1:
        canon = {r: tree for r, tree in trees.items()}
    else:
        canon = {}
        for r, flat in trees.items():
            structure = t_pl.chunk_views(
                {k: torch.empty(s, device="meta") for k, s in
                 t_llama.param_shapes(TConfig.tiny()).items()}, manifest)
            canon[r] = t_pl.merge_params(t_pl.chunks_like(structure, flat), manifest)
    for r, tree in canon.items():
        for k in tree:
            assert torch.equal(tree[k], canon[0][k]), (r, k)
    return canon[0]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_step_across_processes_matches_reference(ref, steps, layout):
    """The step's loss (the same on every process) and its gradients summed
    over dp, against the reference's pipeline on MeshConfig(pp, dp) over the
    virtual CPU mesh; every replica holds the same gradients."""
    tree, batch, results = steps
    results = results[layout]
    pp, dp, _ = LAYOUTS[layout]
    want_loss, want_grads = _ref_loss_and_grad(ref, tree, batch, pp, dp)
    losses = {res["loss"].item() for res in results}
    assert len(losses) == 1, losses
    np.testing.assert_allclose(losses.pop(), want_loss, rtol=LOSS_RTOL)
    _assert_grads_close(_canonical(results, pp, "grads"), want_grads, rtol=GRAD_RTOL)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_zero1_masters_bit_equal_replicated_adamw(steps, layout):
    """The ZeRO-1 masters after the step (each replica's slice updated, then
    all-gathered) against the replicated AdamW fed the same reduced
    gradients and norm: bit-equal. Each process holds of each leaf's mu
    exactly its 1/dp slice on zero1_dim (the whole leaf where no dim
    divides)."""
    tree, _, results = steps
    results = results[layout]
    pp, dp, _ = LAYOUTS[layout]
    grads = _canonical(results, pp, "grads")
    masters = _canonical(results, pp, "masters")
    params = {k: v.clone() for k, v in convert.params_from_jax(tree).items()}
    plain = t_optim.AdamW(params, t_optim.OptimizerConfig(**OPT))
    plain.step(params, grads, results[0]["norm"])
    for k in params:
        assert torch.equal(masters[k], params[k]), k
    for res in results:
        for name, mu in res["mu"].items():
            dim = res["dims"][name]
            full = res["grads"][name].numel()
            assert mu.numel() == (full if dim is None else full // dp), name
            assert dim == t_optim.zero1_dim(tuple(res["grads"][name].shape), dp)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_numerics_across_processes_match_one_process(steps, layout):
    """Process 0's numerics.jsonl record of the step (every process's stats
    reduced to the global record) against the same step in one process on
    the whole batch: per-stage grad, param and update norms and activation
    rms / absmax within the gradients' rtol, the record's vectors of length
    pp, finite."""
    tree, batch, results = steps
    pp, dp, _ = LAYOUTS[layout]
    out = os.path.dirname(results[layout][0]["path"])
    got = [json.loads(line) for line in open(os.path.join(out, "numerics.jsonl"))]
    assert len(got) == 1 and not got[0]["nonfinite"]
    cfg = TConfig.tiny()
    manifest = TManifest(num_layers=cfg.num_hidden_layers, num_stages=pp)
    params = convert.params_from_jax(tree)
    pipe = None
    if pp > 1:
        sp = t_pl.StageParams.from_canonical(params, manifest)
        pipe = t_pl.Pipeline(cfg, t_pl.PipelineConfig(num_stages=pp,
                                                      num_microbatches=MICROBATCHES), make_mesh(
            MeshConfig(pp=pp)), sp)
        params = sp.flat()
    else:
        params = {k: v.clone().requires_grad_() for k, v in params.items()}
    state = t_ts.TrainState(step=0, params=params,
                            optimizer=t_optim.AdamW(params, t_optim.OptimizerConfig(**OPT)))
    want = t_ts.train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg,
                           num_microbatches=MICROBATCHES, remat=True, pipeline=pipe,
                           collect_stats=True, manifest=manifest)["numerics"]
    for key in ("grad_norm_per_stage", "param_norm_per_stage", "update_norm_per_stage",
                "act_rms_per_stage", "act_absmax_per_stage"):
        assert len(got[0][key]) == pp, key
        np.testing.assert_allclose(got[0][key], want[key].numpy(), rtol=GRAD_RTOL, err_msg=key)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_eval_across_processes_matches_reference(ref, steps, layout):
    """The loss-only pass (eval_step; at pp 2 the pipeline's loss_sum_count,
    over DistTransport in 4 processes and in memory in 2) on an eval batch
    padded unevenly across the replicas, against the reference's
    make_pipeline_eval_fn at pp 2 x dp 2 on the same params and batch: on
    every process the valid count exactly (summed over the replicas) and the
    loss sum within EVAL_SUM_RTOL (summed over the stages and the
    replicas)."""
    tree, _, results = steps
    batch = _eval_batch()
    per_replica = [int((batch["labels"][r * 4:(r + 1) * 4, 1:] != -100).sum()) for r in (0, 1)]
    assert per_replica[0] > per_replica[1]
    (want_sum, want_count), = _ref_eval(ref, tree, [batch], 2, 2)
    assert want_count == sum(per_replica)
    for res in results[layout]:
        loss_sum, count = res["eval"]
        assert int(count) == want_count
        np.testing.assert_allclose(float(loss_sum), want_sum, rtol=EVAL_SUM_RTOL)


def test_stash_tiers_across_processes_bit_equal_to_off(steps):
    """zb1 at pp 2 x dp 2 in 4 processes (one stage each, DistTransport) with
    both host tiers (offload.wgrad_stash, offload.activations) against the
    same pipeline without them: every process's loss and gradients
    bit-equal, as the tiers only move bytes; every process pushed to its
    rings, and each replica's two stages hold the byte model's bytes of one
    stage (stage 0 the cotangents' W ring, stage 1 the inputs' W ring and
    the activation ring)."""
    _, batch, results = steps
    pp, dp, _ = LAYOUTS[VARIANT_LAYOUT]
    held = {}
    for res in results[VARIANT_LAYOUT]:
        on, off = res["variants"]["zb1-stash"], res["variants"]["zb1"]
        assert torch.equal(on[0], off[0])
        assert set(on[1]) == set(off[1])
        for k in on[1]:
            assert torch.equal(on[1][k], off[1][k]), k
        assert on[3] > 0 and off[2] == off[3] == 0
        held[res["replica"]] = held.get(res["replica"], 0) + on[2]
    pcfg = t_pl.PipelineConfig(num_stages=pp, num_microbatches=MICROBATCHES,
                               schedule="zb1", **TIERS)
    rows, seqlen = batch["input_ids"].shape
    per_stage = t_pl.host_stash_bytes(pcfg, *t_pl.stash_dims(
        rows // dp // MICROBATCHES, seqlen, 1, TConfig.tiny().hidden_size, torch.float32))
    assert held == {0: per_stage, 1: per_stage} and per_stage > 0


def test_stash_tiers_across_processes_match_reference(ref, steps):
    """The tiered zb1 pipeline at pp 2 x dp 2 across processes against the
    reference's zb1 pipeline with its offload knobs on MeshConfig(pp 2, dp
    2): the loss on every process, and the gradients summed over dp."""
    tree, batch, results = steps
    results = results[VARIANT_LAYOUT]
    pp, dp, _ = LAYOUTS[VARIANT_LAYOUT]
    want_loss, want_grads = _ref_loss_and_grad(ref, tree, batch, pp, dp, "zb1", TIERS)
    losses = {res["variants"]["zb1-stash"][0].item() for res in results}
    assert len(losses) == 1, losses
    np.testing.assert_allclose(losses.pop(), want_loss, rtol=LOSS_RTOL)
    _assert_grads_close(_canonical(results, pp, "grads", "zb1-stash"), want_grads,
                        rtol=GRAD_RTOL)


def _stacked_leaves(ref, cfg_j, pp):
    """(name, reference stacked shape, port chunk-leaf shape) of every leaf
    at pp stages (flat layout)."""
    tree = jax.eval_shape(lambda: ref.pl.stack_stages(
        ref.llama.init_params(jax.random.PRNGKey(0), cfg_j),
        ref.manifest.StageManifest.for_config(cfg_j, pp)))
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(str(getattr(k, "key", k)) for k in path)
        stacked = name.startswith("layers.")
        out.append((name, tuple(leaf.shape), tuple(leaf.shape[1:]) if stacked else
                    tuple(leaf.shape), stacked))
    return out


@pytest.mark.parametrize("preset", ["tiny", "llama_7b"])
@pytest.mark.parametrize("dp", [2, 4])
def test_zero1_placement_matches_reference(ref, preset, dp):
    """zero1_dim on each leaf of this package's layout (a chunk's [k, ...]
    layer leaves, the embedding, norm and lm_head) puts the split where the
    reference's _zero1_leaf_spec does on its stage-stacked leaves (P('pp')
    layer leaves, replicated others), called directly, at pp 4."""
    from llama_pipeline_parallel_tpu.parallel.train_step import _zero1_leaf_spec
    from jax.sharding import PartitionSpec as P

    cfg_j = getattr(ref.config.LlamaConfig, preset)()
    checked = 0
    for name, stacked_shape, mine, stacked in _stacked_leaves(ref, cfg_j, 4):
        spec = _zero1_leaf_spec(P("pp") if stacked else P(), stacked_shape, dp)
        dims = [i for i, ax in enumerate(tuple(spec)) if ax == "dp"]
        want = (dims[0] - 1 if stacked else dims[0]) if dims else None
        assert t_optim.zero1_dim(mine, dp) == want, (name, stacked_shape, spec)
        checked += 1
    assert checked >= 10


def _warm_checkpoints(ref, tmp_path, seed=4):
    """The reference's init saved by each package's checkpointer (a
    module-only checkpoint-0 each): the common start of the two trainers."""
    cfg_j = ref.config.LlamaConfig.tiny()
    tree = ref.llama.init_params(jax.random.PRNGKey(seed), cfg_j)
    one = ref.manifest.StageManifest.for_config(cfg_j, 1)
    ref.ckpt.CheckpointManager(str(tmp_path / "warm_ref")).save(
        0, ref.pl.stack_stages(tree, one), one, cfg_j)
    t_ckpt.CheckpointManager(str(tmp_path / "warm_port")).save(
        0, convert.params_from_jax(jax.device_get(tree)), TManifest(num_layers=4, num_stages=1),
        TConfig.tiny())
    return tree


def test_trainer_across_processes_matches_reference_run_training(ref, tmp_path):
    """conf/tiny_smoke.yaml's pp 2 x dp 2 through the CLI in 4 processes
    against the reference's run_training on the same layout over the virtual
    mesh, both warm-started from the same weights, 3 steps: the metrics
    line's loss at each step (1e-5) and the final params (1e-4)."""
    tree = _warm_checkpoints(ref, tmp_path)
    args = ["max_steps=3", "logging_steps=1", "save_final=true", "resume=false",
            "dataset.pseudo_dataset_len=64"]
    procs = launch(4, cli(*args, f"output_dir={tmp_path}/port",
                          f"model_name_or_path={tmp_path}/warm_port"))
    ref_cfg = t_config.load_config(os.path.join(REPO, "conf", "tiny_smoke.yaml"), args + [
        f"output_dir={tmp_path}/ref", f"model_name_or_path={tmp_path}/warm_ref"])
    ref.train.run_training(ref_cfg)
    for rc, _, stderr in finish(procs):
        assert rc == 0, stderr[-3000:]
    want = [json.loads(x)["loss"] for x in open(tmp_path / "ref" / "metrics.jsonl")
            if "loss" in json.loads(x)]
    got = [json.loads(x)["loss"] for x in open(tmp_path / "port" / "metrics.jsonl")]
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    cfg_j = ref.config.LlamaConfig.tiny()
    manifest = ref.manifest.StageManifest.for_config(cfg_j, 2)
    ref_final = ref.ckpt.CheckpointManager(str(tmp_path / "ref")).load_params(
        3, ref.pl.stack_stages(tree, manifest), manifest)
    want_params = convert.params_from_jax(convert.unstack_stages(
        jax.device_get(ref_final), TManifest(num_layers=4, num_stages=2)))
    got_params = tensor_io.load_file(str(tmp_path / "port" / "checkpoint-3" /
                                         "params.safetensors"))
    _assert_grads_close(got_params, want_params, rtol=1e-4)


def test_tiny_smoke_runs_unchanged_under_torch_distributed_run(tmp_path):
    """`python -m torch.distributed.run --nproc_per_node 4 -m ...cli --config
    conf/tiny_smoke.yaml --device cpu` (pp 2 x dp 2 as the file says; only
    output_dir pointed here): exit 0, process 0 alone writes the metrics line
    at steps 4, 8 and 12, finite losses near ln(253) (uniform tokens of a
    253-token range: the loss cannot fall much below it), the topology of
    the four processes in its summary."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "4",
           "--master_addr", "localhost", "--master_port", str(_free_port()),
           "-m", "llama_pipeline_parallel_tpu_torch.cli", "--config", "conf/tiny_smoke.yaml",
           "--device", "cpu", f"output_dir={tmp_path}"]
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=PROCESS_TIMEOUT_S, env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.count("training done") == 1
    lines = [json.loads(x) for x in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in lines] == [4, 8, 12]
    losses = [r["loss"] for r in lines]
    assert all(np.isfinite(losses)) and all(abs(x - np.log(253)) < 0.2 for x in losses), losses
    assert "pipeline pp2xdp2xtp1xsp1" in res.stderr


def test_sigterm_to_one_rank_stops_every_rank_at_the_same_step(tmp_path):
    """Four processes (pp 2 x dp 2) slowed at the `step` site; SIGTERM to
    rank 2 alone after the first metrics line: every process exits 0, the
    run stops at the next multiple of preempt_check_every with one
    checkpoint there (and `latest`), whose tensors a one-process run reads."""
    plan = json.dumps({"faults": [{"site": "step", "op": "slow", "seconds": 0.3}]})
    procs = launch(4, cli("max_steps=200", "logging_steps=1", "save_steps=0",
                          "save_final=false", "resume=false", "preempt_check_every=3",
                          f"output_dir={tmp_path}"), env={"LPT_FAULT_PLAN": plan})
    metrics = tmp_path / "metrics.jsonl"
    deadline = time.monotonic() + PROCESS_TIMEOUT_S
    try:
        while not (metrics.exists() and metrics.read_text().strip()):
            assert time.monotonic() < deadline and all(p.poll() is None for p in procs)
            time.sleep(0.2)
    except AssertionError:
        for p in procs:
            p.kill()
        raise
    procs[2].send_signal(signal.SIGTERM)
    results = finish(procs)
    assert [rc for rc, _, _ in results] == [0, 0, 0, 0], [e[-2000:] for _, _, e in results]
    steps = sorted(int(d.split("-")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("checkpoint-"))
    assert len(steps) == 1 and steps[0] % 3 == 0 and 0 < steps[0] < 200, steps
    assert (tmp_path / "latest").read_text() == f"checkpoint-{steps[0]}"
    logged = [json.loads(x)["step"] for x in open(metrics)]
    assert logged[-1] == steps[0]
    assert "preempted_at': " + str(steps[0]) in results[0][1]
    meta = json.load(open(tmp_path / f"checkpoint-{steps[0]}" / "meta.json"))
    assert meta["step"] == steps[0] and meta["topology"]["dp"] == 2
    params = tensor_io.load_file(str(tmp_path / f"checkpoint-{steps[0]}" / "params.safetensors"))
    assert set(params) == set(t_llama.param_shapes(TConfig.tiny()))


def test_async_save_across_processes_equals_blocking(tmp_path):
    """pp 1 x dp 2 in 2 processes saving step 2 with async_save (each
    process copies its pieces to host memory, then the commit threads serve
    process 0's requests while the loop trains on) and without: both
    checkpoint-2s complete and byte-equal, file for file."""
    args = ["mesh.pp=1", "max_steps=3", "save_steps=2", "save_final=false", "resume=false",
            "dataset.pseudo_dataset_len=64", "total_steps=8"]
    runs = {mode: launch(2, cli(*args, f"async_save={mode == 'async'}",
                                f"output_dir={tmp_path}/{mode}"))
            for mode in ("async", "blocking")}
    for procs in runs.values():
        for rc, _, stderr in finish(procs):
            assert rc == 0, stderr[-3000:]
    for name in ("params.safetensors", "opt.safetensors"):
        a, b = (open(tmp_path / mode / "checkpoint-2" / name, "rb").read() for mode in runs)
        assert len(a) > 1024 and a == b, name
    for mode in runs:
        assert t_ckpt.CheckpointManager(str(tmp_path / mode)).latest_step() == 2
