"""The port's pipeline (parallel/pipeline.py and the trainer at pp > 1)
against the JAX package's, on the CPU at the `tiny` preset in fp32.

The reference runs here at pp > 1: tests/conftest.py gives jax 8 virtual CPU
devices. Parameters are the reference's init carried over by convert.py, so
both packages start from the same numbers; batches are numpy from a seed.

Tolerances: the loss within rtol 1e-5 of the reference's (fp32, XLA and
PyTorch sum in different orders); each gradient leaf within GRAD_RTOL of
its own largest element (the train step's grad-norm tolerance,
tests/test_torch_training.py). Where both sides are this package (the
pipeline against the unpipelined step, one process against two, a
checkpoint at pp 2 against pp 1) the same operations run on the same
numbers in the same order, so the results are bit-equal, and the tests say
so.
"""

import dataclasses
import importlib
import json
import os
import socket
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
from llama_pipeline_parallel_tpu_torch.ckpt import tensor_io
from llama_pipeline_parallel_tpu_torch.data.collator import IGNORE_INDEX
from llama_pipeline_parallel_tpu_torch.models.llama import model as t_llama
from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig as TConfig
from llama_pipeline_parallel_tpu_torch.models.llama.manifest import StageManifest as TManifest
from llama_pipeline_parallel_tpu_torch.ops.attention import attention as t_attention
from llama_pipeline_parallel_tpu_torch.optim import optimizer as t_optim
from llama_pipeline_parallel_tpu_torch.parallel import pipeline as t_pl
from llama_pipeline_parallel_tpu_torch.parallel import schedule as t_us
from llama_pipeline_parallel_tpu_torch.parallel import train_step as t_ts
from llama_pipeline_parallel_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from llama_pipeline_parallel_tpu_torch.utils import config as t_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
# every test that starts processes gives them this long before it fails, so
# a deadlock costs a bounded share of the suite's time
PROCESS_TIMEOUT_S = 120


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
            "mesh": "parallel.mesh", "attn": "ops.attention", "us": "parallel.schedule",
            "train": "train", "ckpt": "ckpt.checkpoint"}
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"llama_pipeline_parallel_tpu.{v}") for k, v in mods.items()})


def _tree(ref, seed=0):
    return jax.device_get(ref.llama.init_params(jax.random.PRNGKey(seed),
                                                ref.config.LlamaConfig.tiny()))


def _batch(b=8, s=16, seed=3, pad_tail=0, packed=False, vocab=256):
    """Rows of random tokens: right-padded by `pad_tail`, or `packed` with
    three segments and a pad tail (segment ids in attention_mask, positions
    restarting in each segment)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, vocab, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    if pad_tail:
        mask[:, -pad_tail:] = 0
    if packed:
        cuts = (0, 5, 11, s - 3)
        for i, (lo, hi) in enumerate(zip(cuts, cuts[1:])):
            mask[:, lo:hi] = i + 1
            pos[:, lo:hi] = np.arange(hi - lo)
        mask[:, cuts[-1]:] = 0
        pos[:, cuts[-1]:] = 0
    return {"input_ids": ids, "attention_mask": mask, "position_ids": pos,
            "labels": np.where(mask != 0, ids, IGNORE_INDEX).astype(np.int32)}


def _manifest(num_layers, pp, v=1, counts=None):
    return TManifest(num_layers=num_layers, num_stages=pp, virtual_stages=v,
                     layer_counts=counts)


def _port_pipeline(params, pp, m, *, schedule="1f1b", v=1, counts=None, accum=1,
                   unit_schedule=None, head=None, prologue=False, attn=t_attention):
    cfg = TConfig.tiny()
    manifest = _manifest(cfg.num_hidden_layers, pp, v, counts)
    pcfg = t_pl.PipelineConfig(num_stages=pp, num_microbatches=m, schedule=schedule,
                               virtual_stages=v, layer_counts=counts, accum_chunks=accum,
                               unit_schedule=unit_schedule, remat=True,
                               kernel_prologue=prologue, **(head or {}))
    sp = t_pl.StageParams.from_canonical(params, manifest)
    return t_pl.Pipeline(cfg, pcfg, make_mesh(MeshConfig(pp=pp)), sp, attn), sp


def _port_grads(sp):
    return sp.to_canonical({k: p.grad for k, p in sp.flat().items()})


def _assert_grads_close(got: dict, want: dict, rtol=GRAD_RTOL):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].detach().numpy()
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= rtol * scale, f"{k}: max |diff| {err:.3e} vs {rtol} x {scale:.3e}"


def _ref_loss_and_grad(ref, tree, batch, pp, m, *, schedule="1f1b", v=1, counts=None, accum=1,
                       unit_schedule=None, head=None, prologue=False):
    cfg = ref.config.LlamaConfig.tiny()
    manifest = ref.manifest.StageManifest(num_layers=cfg.num_hidden_layers, num_stages=pp,
                                          virtual_stages=v, layer_counts=counts)
    pcfg = ref.pl.PipelineConfig(num_stages=pp, num_microbatches=m, schedule=schedule,
                                 virtual_stages=v, layer_counts=counts, accum_chunks=accum,
                                 unit_schedule=unit_schedule, remat=True,
                                 kernel_prologue=prologue, **(head or {}))
    mesh = ref.mesh.make_mesh(ref.mesh.MeshConfig(pp=pp, dp=1))
    stacked = ref.pl.stack_stages(tree, manifest)
    fn = jax.jit(ref.pl.make_pipeline_loss_and_grad(mesh, cfg, pcfg, stacked,
                                                    attn_fn=ref.attn.attention))
    loss, grads = fn(stacked, {k: jnp.asarray(v_) for k, v_ in batch.items()})
    canonical = convert.unstack_stages(jax.device_get(grads), _manifest(
        cfg.num_hidden_layers, pp, v, counts))
    return float(loss), convert.params_from_jax(canonical)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the interpreter against the reference's make_pipeline_loss_and_grad
# ---------------------------------------------------------------------------

INTERPRETER_CASES = {
    "1f1b-pp2-m4": dict(pp=2, m=4),
    "1f1b-pp4-m2": dict(pp=4, m=2),  # M < S: no steady state
    "interleaved-pp2-v2": dict(pp=2, m=4, schedule="interleaved_1f1b", v=2),
    "zb1-pp2": dict(pp=2, m=4, schedule="zb1"),
    "zb1-pp2-v2": dict(pp=2, m=4, schedule="zb1", v=2),
    "uneven31-1f1b": dict(pp=2, m=4, counts=(3, 1)),
    "uneven31-zb1": dict(pp=2, m=4, schedule="zb1", counts=(3, 1)),
    "accum-chunks-2": dict(pp=2, m=4, accum=2),
    "pad-tail": dict(pp=2, m=4, batch=dict(pad_tail=5)),
    "packed-segments": dict(pp=2, m=4, batch=dict(packed=True)),
    "kernels-ce-prologue": dict(pp=2, m=4, head=dict(loss_chunks=4, kernel_ce=True),
                                prologue=True),
}


@pytest.mark.parametrize("name", list(INTERPRETER_CASES))
def test_interpreter_matches_reference(ref, name):
    """One step's loss and every gradient of the port's in-process pipeline
    against the reference's pipeline on a pp-device mesh, from the same
    params and batch. The kernel case runs the port's plain twins of the CE
    and prologue kernels on the CPU and the reference's Pallas kernels in
    interpret mode."""
    case = dict(INTERPRETER_CASES[name])
    batch = _batch(**case.pop("batch", {}))
    tree = _tree(ref)
    want_loss, want_grads = _ref_loss_and_grad(ref, tree, batch, **case)
    pipe, sp = _port_pipeline(convert.params_from_jax(tree), **case)
    loss = pipe.loss_and_grad(_torch_batch(batch))
    np.testing.assert_allclose(loss.item(), want_loss, rtol=LOSS_RTOL)
    _assert_grads_close(_port_grads(sp), want_grads)


@pytest.mark.parametrize("placement", ["trailing", "drain"])
def test_interpreter_runs_solver_sequence_like_reference(ref, tmp_path, placement):
    """A solver sequence (list schedule, W placed trailing or in the drain)
    written by the reference's to_json and loaded by the port, run by both
    interpreters: the same loss and gradients."""
    seq = ref.us.list_schedule(4, 2, 2, w_placement=placement)
    path = tmp_path / "unit_schedule.json"
    path.write_text(ref.us.to_json(seq))
    batch, tree = _batch(), _tree(ref)
    want_loss, want_grads = _ref_loss_and_grad(ref, tree, batch, 2, 4, schedule="solver", v=2,
                                               unit_schedule=seq)
    pipe, sp = _port_pipeline(convert.params_from_jax(tree), 2, 4, schedule="solver", v=2,
                              unit_schedule=t_us.load(str(path)))
    loss = pipe.loss_and_grad(_torch_batch(batch))
    np.testing.assert_allclose(loss.item(), want_loss, rtol=LOSS_RTOL)
    _assert_grads_close(_port_grads(sp), want_grads)


@pytest.mark.parametrize("schedule,v", [("1f1b", 1), ("interleaved_1f1b", 2)])
def test_eval_pass_matches_reference(ref, schedule, v):
    """The forward-only pass (loss sum, valid count) against the
    reference's make_pipeline_eval_fn, on a batch with a pad tail."""
    cfg = ref.config.LlamaConfig.tiny()
    batch, tree = _batch(pad_tail=4), _tree(ref)
    manifest = ref.manifest.StageManifest.for_config(cfg, 2, virtual_stages=v)
    pcfg = ref.pl.PipelineConfig(num_stages=2, num_microbatches=4, schedule=schedule,
                                 virtual_stages=v)
    mesh = ref.mesh.make_mesh(ref.mesh.MeshConfig(pp=2, dp=1))
    stacked = ref.pl.stack_stages(tree, manifest)
    fn = jax.jit(ref.pl.make_pipeline_eval_fn(mesh, cfg, pcfg, stacked,
                                              attn_fn=ref.attn.attention))
    want_sum, want_count = fn(stacked, {k: jnp.asarray(x) for k, x in batch.items()})
    pipe, sp = _port_pipeline(convert.params_from_jax(tree), 2, 4, schedule=schedule, v=v)
    got_sum, got_count = pipe.loss_sum_count(_torch_batch(batch))
    np.testing.assert_allclose(got_sum.item(), float(want_sum), rtol=LOSS_RTOL)
    assert int(got_count) == int(want_count)
    assert all(p.grad is None for p in sp.flat().values())


def test_stage_stacked_trees_carry_both_ways(ref):
    """convert.stage_params_from_jax / stage_params_to_jax against the
    reference's stack_stages: flat, interleaved and padded uneven layouts."""
    tree = _tree(ref)
    cfg = ref.config.LlamaConfig.tiny()
    for pp, v, counts in ((2, 1, None), (2, 2, None), (2, 1, (3, 1)), (4, 1, None)):
        manifest = ref.manifest.StageManifest(num_layers=cfg.num_hidden_layers, num_stages=pp,
                                              virtual_stages=v, layer_counts=counts)
        stacked = jax.device_get(ref.pl.stack_stages(tree, manifest))
        mine = _manifest(cfg.num_hidden_layers, pp, v, counts)
        chunks = convert.stage_params_from_jax(stacked, mine)
        assert sorted(chunks) == list(range(pp)) and all(len(c) == v for c in chunks.values())
        for s in range(pp):
            for c in range(v):
                rows = mine.layers_of_chunk(s, c)
                np.testing.assert_array_equal(chunks[s][c]["layers.attn.wq"].numpy(),
                                              tree["layers"]["attn"]["wq"][rows.start:rows.stop])
        assert ("embed.embedding" in chunks[0][0]) and ("lm_head" in chunks[pp - 1][v - 1])
        back = convert.stage_params_to_jax(chunks, mine)
        for got, want in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(stacked)):
            np.testing.assert_array_equal(got, np.asarray(want))


# ---------------------------------------------------------------------------
# the pipeline against this package's own unpipelined step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule,v", [("1f1b", 1), ("interleaved_1f1b", 2), ("zb1", 1)])
def test_pipelined_train_step_equals_unpipelined(ref, schedule, v):
    """Two optimizer steps through train_step with a pp 2 pipeline against
    the unpipelined train_step, from the same params and batches: losses and
    the updated params bit-equal (the same operations on the same numbers in
    the same order; no step clips, so the norm does not enter the update),
    grad norms within 1e-6 (the squares of a layer leaf are summed per
    stage's slice, then across stages)."""
    cfg = TConfig.tiny()
    params = convert.params_from_jax(_tree(ref))
    ocfg = t_optim.OptimizerConfig(learning_rate=5e-3, total_steps=20, warmup_steps=1)
    flat = {k: v_.clone().requires_grad_() for k, v_ in params.items()}
    one = t_ts.TrainState(0, flat, t_optim.AdamW(flat, ocfg))
    pipe, sp = _port_pipeline(params, 2, 4, schedule=schedule, v=v)
    two = t_ts.TrainState(0, sp.flat(), t_optim.AdamW(sp.flat(), ocfg))
    for seed in (5, 6):
        batch = _torch_batch(_batch(seed=seed, pad_tail=3))
        want = t_ts.train_step(one, batch, cfg, num_microbatches=4, remat=True)
        got = t_ts.train_step(two, batch, cfg, pipeline=pipe)
        assert got["loss"].item() == want["loss"].item()
        np.testing.assert_allclose(got["grad_norm"].item(), want["grad_norm"].item(),
                                   rtol=1e-6)
        assert got["grad_norm"].item() < ocfg.max_grad_norm
        assert (got["lr"], got["step"]) == (want["lr"], want["step"])
    merged = sp.to_canonical()
    for k, p in flat.items():
        assert torch.equal(merged[k], p.detach()), k


@pytest.mark.parametrize("schedule,v,counts,accum", [
    ("1f1b", 1, None, 1), ("interleaved_1f1b", 2, None, 1), ("zb1", 2, None, 2),
    ("zb1", 1, (3, 1), 1)])
def test_no_idle_computation(ref, schedule, v, counts, accum):
    """Each stage executes exactly the valid F, B and W cells of the grid,
    once per flush; the cells that run no chunk are exactly the F of the
    loss-owning chunk (its output goes nowhere) and, split, the B of (stage
    0, chunk 0) (its input is the embedding lookup)."""
    params = convert.params_from_jax(_tree(ref))
    pipe, _ = _port_pipeline(params, 2, 4, schedule=schedule, v=v, counts=counts, accum=accum)
    pipe.loss_and_grad(_torch_batch(_batch()))
    us = pipe.us
    m_flush = us.num_microbatches
    for s in range(2):
        valid = {kind: int((grid[:, s] >= 0).sum()) * accum
                 for kind, grid in zip(t_pl.UNIT_KINDS, (us.f_unit, us.b_unit, us.w_unit))}
        assert pipe.units[s] == valid
        idle_f = m_flush * accum if s == 1 else 0
        idle_b = m_flush * accum if us.split_backward and s == 0 else 0
        assert pipe.computed[s] == {"F": valid["F"] - idle_f, "B": valid["B"] - idle_b,
                                    "W": valid["W"]}


def test_local_transport_refuses_a_grid_out_of_step(ref):
    """A sequence whose handoffs do not line up (an F row moved a tick) is
    caught by the local transport, not run on the wrong input."""
    params = convert.params_from_jax(_tree(ref))
    pipe, _ = _port_pipeline(params, 2, 4)
    f = pipe.us.f_unit.copy()
    f[[1, 2], :] = f[[2, 1], :]
    pipe.us = dataclasses.replace(pipe.us, f_unit=f)
    with pytest.raises((RuntimeError, KeyError)):
        pipe.loss_and_grad(_torch_batch(_batch()))


# ---------------------------------------------------------------------------
# one stage per process: torch.distributed with gloo
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _barrier_worker(out_dir: str) -> None:
    """Under torch.distributed.run with 2 processes: rank 0 waits at a
    barrier with a 2 s deadline that rank 1 never enters; rank 0 records
    what the barrier raised."""
    import time

    from llama_pipeline_parallel_tpu_torch.parallel import distributed

    distributed.initialize_distributed("cpu")
    distributed.barrier("both", timeout_s=60)  # both arrive: passes
    if distributed.process_index() == 0:
        try:
            distributed.barrier("lonely", timeout_s=2)
            raised = "nothing"
        except distributed.BarrierTimeoutError as e:
            raised = f"BarrierTimeoutError: {e}"
        with open(os.path.join(out_dir, "rank0.txt"), "w") as f:
            f.write(raised)
    else:
        time.sleep(5)
    os._exit(0)  # the process group holds a barrier rank 1 never joined


def _worker(out_dir: str, schedule: str) -> None:
    """One stage of a pp 2 pipeline under torch.distributed.run: the tiny
    model from a seeded torch init, one step's loss and this stage's
    gradients (canonical names of its chunk) saved to `out_dir`."""
    from llama_pipeline_parallel_tpu_torch.parallel import distributed

    distributed.initialize_distributed("cpu")
    rank = distributed.process_index()
    cfg = TConfig.tiny()
    params = t_llama.init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    mesh = make_mesh(MeshConfig(pp=2))
    manifest = _manifest(cfg.num_hidden_layers, 2)
    sp = t_pl.StageParams.from_canonical(params, manifest, mesh.stages)
    pcfg = t_pl.PipelineConfig(num_stages=2, num_microbatches=4, schedule=schedule)
    pipe = t_pl.Pipeline(cfg, pcfg, mesh, sp)
    loss = pipe.loss_and_grad(_torch_batch(_batch()))
    norm = pipe.global_norm()
    torch.save({"loss": loss, "norm": norm,
                "grads": {k: p.grad for k, p in sp.flat().items()}, "units": pipe.units},
               os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.mark.parametrize("schedule", ["1f1b", "zb1"])
def test_two_gloo_processes_equal_in_process(tmp_path, schedule):
    """Two processes (torch.distributed.run, gloo), one stage each, against
    the in-process pipeline on the same params and batch: loss, gradient
    norm and every gradient bit-equal (both transports hand over the same
    bytes), the loss and norm the same on both processes."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_addr", "localhost", "--master_port", str(_free_port()),
           os.path.abspath(__file__), "--worker", str(tmp_path), schedule]
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=PROCESS_TIMEOUT_S, env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr[-3000:]
    cfg = TConfig.tiny()
    params = t_llama.init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    pipe, sp = _port_pipeline(params, 2, 4, schedule=schedule)
    loss = pipe.loss_and_grad(_torch_batch(_batch()))
    norm = pipe.global_norm()
    mine = {k: p.grad for k, p in sp.flat().items()}
    for rank in (0, 1):
        got = torch.load(tmp_path / f"rank{rank}.pt")
        assert got["loss"].item() == loss.item() and got["norm"].item() == norm.item()
        assert got["units"] == {rank: pipe.units[rank]}
        for k, g in got["grads"].items():
            assert k.startswith(f"s{rank}c") and torch.equal(g, mine[k]), k


def test_barrier_raises_when_a_peer_does_not_arrive(tmp_path):
    """parallel/distributed.barrier: two gloo processes pass a barrier both
    enter; one that a peer never enters raises BarrierTimeoutError, naming
    the barrier, after its deadline."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_addr", "localhost", "--master_port", str(_free_port()),
           os.path.abspath(__file__), "--barrier", str(tmp_path)]
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=PROCESS_TIMEOUT_S, env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr[-3000:]
    raised = (tmp_path / "rank0.txt").read_text()
    assert raised.startswith("BarrierTimeoutError") and "'lonely'" in raised, raised


def test_mesh_config_matches_reference(ref, monkeypatch):
    """MeshConfig's validation and describe() are the reference's; a lone
    process runs every stage, dp > 1 is refused by name, and so is a process
    group whose size is not pp."""
    for axes in (dict(pp=4), dict(pp=2, dp=2), dict(pp=8, dp=2, tp=2)):
        assert MeshConfig(**axes).describe() == ref.mesh.MeshConfig(**axes).describe()
    for bad in (dict(pp=0), dict(tp=-1)):
        with pytest.raises(ValueError, match="must be >= 1"):
            MeshConfig(**bad)
        with pytest.raises(ValueError, match="must be >= 1"):
            ref.mesh.MeshConfig(**bad)
    mesh = make_mesh(MeshConfig(pp=4))
    assert (mesh.stages, mesh.rank, mesh.process_count) == ((0, 1, 2, 3), 0, 1)
    assert make_mesh(MeshConfig()).stages == (0,)
    with pytest.raises(NotImplementedError, match="'dp': 2"):
        make_mesh(MeshConfig(pp=2, dp=2))
    from llama_pipeline_parallel_tpu_torch.parallel import mesh as t_mesh

    monkeypatch.setattr(t_mesh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(t_mesh.dist, "get_world_size", lambda: 2)
    with pytest.raises(ValueError, match="2 processes for mesh pp1"):
        make_mesh(MeshConfig(pp=1))


def test_cli_under_torch_distributed_run(tmp_path):
    """`python -m torch.distributed.run --nproc_per_node 2 -m
    llama_pipeline_parallel_tpu_torch.cli ... --device cpu mesh.pp=2` trains
    2 steps; only process 0 writes the metrics line, with the losses of the
    same run in one process."""
    args = ["mesh.pp=2", "mesh.dp=1", "max_steps=2", "total_steps=4", "logging_steps=1",
            "save_final=false", "resume=false"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_addr", "localhost", "--master_port", str(_free_port()),
           "-m", "llama_pipeline_parallel_tpu_torch.cli", "--config", "conf/tiny_smoke.yaml",
           "--device", "cpu", *args, f"output_dir={tmp_path}/two"]
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=PROCESS_TIMEOUT_S, env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(x) for x in open(tmp_path / "two" / "metrics.jsonl")]
    assert [r["step"] for r in lines] == [1, 2]
    assert res.stdout.count("training done") == 1
    one = t_train.run_training(t_config.load_config(
        os.path.join(REPO, "conf", "tiny_smoke.yaml"), args + [f"output_dir={tmp_path}/one"]),
        device="cpu")
    assert [r["loss"] for r in lines] == one["losses"]


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def _tiny_cfg(tmp_path, name, *overrides):
    return t_config.load_config(os.path.join(REPO, "conf", "tiny_smoke.yaml"), [
        "mesh.pp=2", "mesh.dp=1", "dataset.pseudo_dataset_len=64", "logging_steps=1",
        f"output_dir={tmp_path}/{name}", *overrides])


@pytest.mark.parametrize("schedule", ["1f1b", "zb1"])
def test_trainer_matches_reference_run_training(ref, tmp_path, schedule):
    """run_training at pp 2 in both packages, warm-started from the same
    weights (the reference's init, saved by each package's checkpointer),
    on the same synthetic data: the metrics line's loss at each of 3 steps."""
    cfg_j = ref.config.LlamaConfig.tiny()
    tree = ref.llama.init_params(jax.random.PRNGKey(4), cfg_j)
    one = ref.manifest.StageManifest.for_config(cfg_j, 1)
    ref.ckpt.CheckpointManager(str(tmp_path / "warm_ref")).save(
        0, ref.pl.stack_stages(tree, one), one, cfg_j)
    t_ckpt.CheckpointManager(str(tmp_path / "warm_port")).save(
        0, convert.params_from_jax(jax.device_get(tree)), _manifest(4, 1), TConfig.tiny())
    args = ["max_steps=3", f"pipeline_schedule={schedule}", "save_final=false",
            "resume=false"]
    ref_cfg = t_config.load_config(os.path.join(REPO, "conf", "tiny_smoke.yaml"), [
        "mesh.pp=2", "mesh.dp=1", "dataset.pseudo_dataset_len=64", "logging_steps=1",
        f"output_dir={tmp_path}/ref", f"model_name_or_path={tmp_path}/warm_ref", *args])
    ref.train.run_training(ref_cfg)
    t_train.run_training(_tiny_cfg(tmp_path, "port", f"model_name_or_path={tmp_path}/warm_port",
                                   *args), device="cpu")
    want = [json.loads(x)["loss"] for x in open(tmp_path / "ref" / "metrics.jsonl")
            if "loss" in json.loads(x)]
    got = [json.loads(x)["loss"] for x in open(tmp_path / "port" / "metrics.jsonl")]
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_trainer_evaluates_through_the_pipeline(tmp_path):
    """`eval_dataset` at pp 2 runs the forward-only pipeline: the metrics
    line's eval_loss equals the one-device run's, step for step, and both
    carry the same training losses."""
    args = ["max_steps=4", "total_steps=8", "save_final=false", "resume=false",
            "eval_dataset={synthetic: true, seq_length: 32, pseudo_dataset_len: 8}",
            "eval_steps=2"]
    runs = {}
    for pp in (1, 2):
        t_train.run_training(_tiny_cfg(tmp_path, f"e{pp}", f"mesh.pp={pp}", *args),
                             device="cpu")
        rows = [json.loads(x) for x in open(tmp_path / f"e{pp}" / "metrics.jsonl")]
        runs[pp] = ([(r["step"], r["eval_loss"]) for r in rows if "eval_loss" in r],
                    [r["loss"] for r in rows if "loss" in r])
    assert [step for step, _ in runs[2][0]] == [2, 4]
    assert runs[2] == runs[1]


def _ckpt_tensors(path):
    out = {}
    for name in ("params.safetensors", "opt.safetensors"):
        with tensor_io.TensorFile(os.path.join(path, name)) as f:
            out.update({f"{name}:{k}": f.tensor(k) for k in f.keys()})
    return out


def test_checkpoint_at_pp2_equals_pp1(tmp_path):
    """Two steps and a save at pp 2 (in one process) and at pp 1 from the
    same seed: every tensor of the two checkpoints (params, both moments,
    count) bit-equal; meta.json records each run's own partition."""
    paths = {}
    for pp in (1, 2):
        cfg = _tiny_cfg(tmp_path, f"pp{pp}", f"mesh.pp={pp}", "max_steps=2", "total_steps=4",
                        "save_final=true", "resume=false")
        paths[pp] = t_train.run_training(cfg, device="cpu")["output_dir"] + "/checkpoint-2"
    a, b = _ckpt_tensors(paths[1]), _ckpt_tensors(paths[2])
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    meta = json.load(open(os.path.join(paths[2], "meta.json")))
    assert meta["manifest"]["num_stages"] == 2 and meta["topology"]["pp"] == 2


def test_resume_across_pp_changes_equals_uninterrupted(tmp_path):
    """pp 2 for 2 steps -> resume at pp 1 for 2 -> resume at pp 2 on an
    uneven (3, 1) partition for 2: every loss that of the uninterrupted pp 2
    run, bit for bit, and each restore logs the topology it changed."""
    straight = t_train.run_training(_tiny_cfg(tmp_path, "a", "max_steps=6", "total_steps=6",
                                              "save_final=false", "resume=false"), device="cpu")
    losses = []
    legs = [("mesh.pp=2", "max_steps=2", "resume=false"), ("mesh.pp=1", "max_steps=4"),
            ("mesh.pp=2", "layer_counts=[3,1]", "max_steps=6")]
    for leg in legs:
        out = t_train.run_training(_tiny_cfg(tmp_path, "b", "total_steps=6", "save_final=true",
                                             *leg), device="cpu")
        losses += out["losses"]
    assert losses == straight["losses"]
    meta = json.load(open(tmp_path / "b" / "checkpoint-6" / "meta.json"))
    assert meta["topology"]["layer_counts"] == [3, 1]
    assert meta["manifest"]["layer_counts"] == [3, 1]


@pytest.mark.parametrize("overrides", [
    ["pipeline_schedule=1f1b"], ["pipeline_schedule=interleaved_1f1b", "virtual_stages=2"],
    ["pipeline_schedule=zb1", "layer_counts=[3,1]"], ["stage_balance=cost"]])
def test_topology_meta_equals_reference(ref, tmp_path, overrides):
    """The topology block a pp 2 run records equals the reference's
    `_topology_meta` for the same mesh, schedule and partition, and the
    partition is the reference's `build_manifest` (cost-balanced too)."""
    cfg = _tiny_cfg(tmp_path, "t", *overrides)
    run = t_train.build_run(cfg, device="cpu")
    mesh = ref.mesh.make_mesh(ref.mesh.MeshConfig(pp=2, dp=1))
    cfg_j = ref.config.LlamaConfig.tiny()
    manifest = ref.train.build_manifest(cfg, cfg_j, 2)
    pcfg = ref.train.build_pipeline_config(cfg, ref.mesh.MeshConfig(pp=2, dp=1), manifest)
    assert run.topology == ref.train._topology_meta(mesh, pcfg, manifest)
    assert run.manifest.to_json() == manifest.to_json()


@pytest.mark.parametrize("overrides,error,match", [
    (["pipeline_schedule=gpipe"], NotImplementedError, "gpipe"),
    (["mesh.dp=2"], NotImplementedError, "'dp': 2"),
    (["offload={wgrad_stash: true}"], NotImplementedError, "'offload'"),
    (["pipeline_schedule=solver", "virtual_stages=2"], NotImplementedError, "offload"),
    (["gradient_accumulation_chunks=3"], ValueError, "must divide"),
])
def test_trainer_refuses_at_pp2(tmp_path, overrides, error, match):
    """What the pipeline does not run is refused by name: gpipe, dp > 1,
    the offload block, a solver sequence that offloads W residuals (written
    by the reference's list schedule with half its units offloaded), an
    accumulation-chunk count that does not divide the microbatches."""
    if "pipeline_schedule=solver" in overrides:
        seq = t_us.list_schedule(2, 2, 2, offload_units=np.array([True, False] * 2))
        (tmp_path / "seq.json").write_text(t_us.to_json(seq))
        overrides = overrides + [f"schedule_file={tmp_path}/seq.json"]
    with pytest.raises(error, match=match):
        t_train.build_run(_tiny_cfg(tmp_path, "r", *overrides), device="cpu")


@pytest.mark.parametrize("key", ["save_steps=2", "save_final=true", "resume=true"])
def test_trainer_refuses_saves_across_processes(tmp_path, monkeypatch, key):
    """In a run of more than one process, saving and resuming are refused by
    name (cross-process checkpoints come with the next slice)."""
    from llama_pipeline_parallel_tpu_torch.parallel import distributed

    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    defaults = {"save_steps=2": "save_steps", "save_final=true": "save_final",
                "resume=true": "resume"}
    others = [o for o in ("save_steps=0", "save_final=false", "resume=false")
              if o.split("=")[0] != defaults[key]]
    cfg = _tiny_cfg(tmp_path, "m", key, *others)
    with pytest.raises(NotImplementedError, match=defaults[key]):
        t_train._check_supported(cfg)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2], sys.argv[3])
if __name__ == "__main__" and sys.argv[1:2] == ["--barrier"]:
    _barrier_worker(sys.argv[2])
