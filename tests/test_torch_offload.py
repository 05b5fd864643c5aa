"""The port's host optimizer (optim/offload.py, csrc/host_adamw.cpp), its
trainer path and its `offload_parts` checkpoints, on the CPU.

g++ is here as on the card, so the C++ runs in these tests. Limits:
- the port's HostOffloadAdamW against the JAX package's on the same tree and
  gradients (host-norm path, clipping active): masters and moments
  bit-equal (the same C++ source and flags, the same fp64 norm order);
- the C++ against its plain PyTorch twin and both against the on-device
  AdamW, and the device-norm path against the host-norm path: rtol 2e-5,
  atol 1e-6 (the reference's test_matches_optax limits: fp32 update order
  and an fp32 against an fp64 norm);
- `f32_to_bf16` bit-equal to torch's host cast, NaN, infinities, ties and
  subnormals included;
- the trainer (tiny_smoke, fp32, 4 steps) with and without
  optimizer_offload: losses within 1e-5, masters rtol 2e-5, atol 1e-6; and
  against the JAX trainer's offload run from the same warm-start weights:
  losses within 1e-5, masters within MASTERS_VS_JAX_ATOL;
- an offload_parts save and resume: the resumed run's losses and final
  masters bit-equal to the uninterrupted run's.
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
from llama_pipeline_parallel_tpu_torch.ckpt import tensor_io
from llama_pipeline_parallel_tpu_torch.models.llama import model as t_llama
from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig as TConfig
from llama_pipeline_parallel_tpu_torch.models.llama.manifest import StageManifest as TManifest
from llama_pipeline_parallel_tpu_torch.ops import kernel_build
from llama_pipeline_parallel_tpu_torch.optim import offload as t_off
from llama_pipeline_parallel_tpu_torch.optim import optimizer as t_optim
from llama_pipeline_parallel_tpu_torch.parallel import train_step as t_ts
from llama_pipeline_parallel_tpu_torch.utils import config as t_config
from tests.test_torch_pipeline import _free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# pytest-xdist's workers share the CPUs: each worker's torch takes its share
# of them for its intra-op threads (as the host AdamW's teams take theirs,
# t_off.default_threads), so that six workers on eight cores do not run
# forty-eight spinning OpenMP threads. Set as the module is imported: every
# worker imports every test module before its first test.
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0))
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

RTOL, ATOL = 2e-5, 1e-6
LOSS_TOL = 1e-5
# masters of two trainers whose gradients differ in fp32 summation order: Adam
# turns a gradient's relative error into an absolute step of up to lr times
# it, whatever the parameter's size, so (as tests/test_torch_training.py's
# train step against the reference) they are held to well under one step of
# tiny_smoke's lr 1e-2
MASTERS_VS_JAX_ATOL = 2e-5
SHAPES = {"a": (64, 32), "b.c": (128,), "d": (3, 5, 7)}


@pytest.fixture(scope="module")
def ref():
    """The reference modules, after installing the stand-in for
    `jax._src.sharding_impls.TransferToMemoryKind` where this jax lacks it
    (imported by the reference's host stash, never constructed here)."""
    import jax._src.sharding_impls as impls

    if not hasattr(impls, "TransferToMemoryKind"):
        class TransferToMemoryKind:
            def __init__(self, memory_kind):
                self.memory_kind = memory_kind

        impls.TransferToMemoryKind = TransferToMemoryKind
    mods = {"off": "optim.offload", "optim": "optim.optimizer", "train": "train",
            "ckpt": "ckpt.checkpoint", "llama": "models.llama.model",
            "config": "models.llama.config", "manifest": "models.llama.manifest",
            "pl": "parallel.pipeline"}
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"llama_pipeline_parallel_tpu.{v}") for k, v in mods.items()})


def _tree(seed=0):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*shape).astype(np.float32) for k, shape in SHAPES.items()}


def _grads(step):
    rng = np.random.RandomState(100 + step)
    return {k: (rng.randn(*shape) * 2).astype(np.float32) for k, shape in SHAPES.items()}


def _torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


CFG = dict(learning_rate=1e-2, weight_decay=0.1, beta1=0.9, beta2=0.95, max_grad_norm=1.0,
           total_steps=100, warmup_steps=10)
STEPS = 5


def _host(device_norm=False):
    host = t_off.HostOffloadAdamW(t_optim.OptimizerConfig(**CFG), device_norm=device_norm)
    host.init(_torch(_tree()))
    return host


def test_library_builds_into_the_build_dir():
    """g++ builds csrc/host_adamw.cpp into the port's build directory under a
    name hashed from source and flags; the three functions and the OpenMP
    thread count are reachable, and the count set is the count read."""
    lib = t_off.load_native()
    path = t_off.library_path()
    assert os.path.dirname(path) == kernel_build.build_dir()
    assert os.path.exists(path) and os.path.basename(path).startswith("host_adamw-")
    for fn in ("adamw_step", "l2_norm_sq", "f32_to_bf16"):
        assert hasattr(lib, fn)
    before = lib.omp_get_max_threads()
    lib.omp_set_num_threads(2)
    assert lib.omp_get_max_threads() == 2
    lib.omp_set_num_threads(before)


def test_build_failure_raises(monkeypatch, tmp_path):
    """A source g++ cannot build raises; nothing falls back."""
    bad = tmp_path / "host_adamw.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(t_off, "CSRC", str(bad))
    monkeypatch.setattr(t_off, "_lib", None)
    monkeypatch.setenv("LPT_TORCH_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        t_off.load_native()


def test_host_adamw_bit_equal_to_jax(ref):
    """The port's host AdamW and the JAX package's on the same tree and
    gradients, 5 steps on the host-norm path with clipping active: masters
    and moments bit-equal, the same learning rate each step, and the same
    fp64 norm up to the last bits (OpenMP adds its threads' partial sums in
    the order they finish; the clip factor goes to the C++ as fp32)."""
    jhost = ref.off.HostOffloadAdamW(ref.optim.OptimizerConfig(**CFG))
    jtree = {"a": jnp.asarray(_tree()["a"]), "b": {"c": jnp.asarray(_tree()["b.c"])},
             "d": jnp.asarray(_tree()["d"])}
    jhost.init(jtree)
    host = _host()
    for step in range(STEPS):
        g = _grads(step)
        jhost.update({"a": jnp.asarray(g["a"]), "b": {"c": jnp.asarray(g["b.c"])},
                      "d": jnp.asarray(g["d"])})
        host.update(_torch(g))
        assert host.last_grad_norm == pytest.approx(jhost.last_grad_norm, rel=1e-12)
        assert host.last_grad_norm > CFG["max_grad_norm"]
        assert host.last_lr == jhost.last_lr
    want = convert.params_from_jax(jax.device_get(jhost.masters_tree()))
    moments = {attr: convert.params_from_jax(jax.device_get(jhost.moments_tree(attr)))
               for attr in ("m", "v")}
    for name in SHAPES:
        assert torch.equal(host.masters[name], want[name]), name
        assert torch.equal(host.m[name], moments["m"][name]), name
        assert torch.equal(host.v[name], moments["v"][name]), name
    assert host.step_count == jhost.step_count == STEPS
    assert set(host.last_timings) == {"d2h_norm_ms", "update_ms"}


def _close(got, want):
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].detach().numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_device_norm_matches_host_norm():
    """update_and_refresh with the norm taken in fp32 (device_norm) against
    the host fp64 norm, 5 steps: masters within rtol 2e-5, atol 1e-6; the
    phases each path reports."""
    host_path, device_path = _host(), _host(device_norm=True)
    work = {k: torch.empty(s) for k, s in SHAPES.items()}
    for step in range(STEPS):
        g = _torch(_grads(step))
        host_path.update_and_refresh(g, work)
        device_path.update_and_refresh(g, work)
    _close(device_path.masters, host_path.masters)
    assert set(host_path.last_timings) == {"d2h_norm_ms", "update_h2d_ms"}
    assert set(device_path.last_timings) == {"norm_ms", "stream_d2h_update_h2d_ms"}


def _adamw_reference():
    params = {k: v.clone() for k, v in _torch(_tree()).items()}
    opt = t_optim.AdamW(params, t_optim.OptimizerConfig(**CFG))
    for step in range(STEPS):
        opt.step(params, _torch(_grads(step)))
    return params


def _plain_run():
    """adamw_plain under the same clip and schedule the host AdamW applies."""
    cfg = t_optim.OptimizerConfig(**CFG)
    schedule = t_optim.warmup_decay_schedule(cfg.learning_rate, cfg.total_steps,
                                             cfg.warmup_steps)
    p = _torch(_tree())
    m = {k: torch.zeros(s) for k, s in SHAPES.items()}
    v = {k: torch.zeros(s) for k, s in SHAPES.items()}
    for step in range(STEPS):
        g = _torch(_grads(step))
        norm = float(t_optim.global_norm(g.values()))
        scale = cfg.max_grad_norm / norm if norm > cfg.max_grad_norm else 1.0
        assert scale < 1.0  # clipping is active
        for k in SHAPES:
            t_off.adamw_plain(p[k], m[k], v[k], g[k], schedule(step), cfg.beta1, cfg.beta2,
                              cfg.eps, cfg.weight_decay, step + 1, scale)
    return p


@pytest.mark.parametrize("impl", ["cpp", "plain"])
def test_update_matches_the_on_device_adamw(impl):
    """The C++ step (update_and_refresh with the fp32 norm AdamW takes) and
    its plain twin, 5 clipped steps, against optim.optimizer.AdamW; and the
    C++ against the plain twin. rtol 2e-5, atol 1e-6."""
    want = _adamw_reference()
    plain = _plain_run()
    if impl == "plain":
        _close(plain, want)
        return
    host = _host(device_norm=True)
    work = {k: torch.empty(s) for k, s in SHAPES.items()}
    for step in range(STEPS):
        host.update_and_refresh(_torch(_grads(step)), work)
    _close(host.masters, want)
    _close(host.masters, plain)
    for k in SHAPES:
        assert torch.equal(work[k], host.masters[k])  # an fp32 working copy is the master


def _bits(u32: list[int]) -> torch.Tensor:
    return torch.tensor(u32, dtype=torch.int64).to(torch.int32).view(torch.float32)


def test_f32_to_bf16_bit_equal_to_torch_cast():
    """The host cast of the working copy against tensor.to(torch.bfloat16):
    random values of every scale, ties to even both ways, the largest
    finite values (rounding to infinity), infinities, subnormals, zeros of
    both signs, and NaNs of every payload (a NaN whose payload lies in the
    low 16 bits included)."""
    rng = np.random.RandomState(0)
    rand = (rng.randn(1 << 16) * np.exp(rng.uniform(-80, 80, 1 << 16))).astype(np.float32)
    special = _bits([0x3F808000, 0x3F818000, 0xBF808000, 0x3F80FFFF, 0x7F7FFFFF, 0xFF7FFFFF,
                     0x7F800000, 0xFF800000, 0x00000001, 0x00008000, 0x80018000, 0x0,
                     0x80000000, 0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001, 0x7FBFFFFF,
                     0x7F808000, 0x7FFFFFFF])
    src = torch.cat([torch.from_numpy(rand), special]).contiguous()
    out = torch.empty(src.shape, dtype=torch.bfloat16)
    lib = t_off.load_native()
    lib.f32_to_bf16(t_off._ptr(src), t_off._ptr(out), src.numel())
    want = src.to(torch.bfloat16)
    assert torch.equal(out.view(torch.int16), want.view(torch.int16))
    assert out[-7:].isnan().all()


def test_working_copy_is_the_rne_cast_of_the_masters():
    """device_params(bf16) is torch's cast of each master, bit for bit."""
    host = _host()
    work = host.device_params(torch.bfloat16, "cpu")
    for name, master in host.masters.items():
        assert torch.equal(work[name].view(torch.int16),
                           master.to(torch.bfloat16).view(torch.int16))


def test_host_step_leaves_torch_thread_count_unchanged():
    """The library shares torch's OpenMP runtime: each of its calls sets its
    own team size (one thread for these small leaves), and one host AdamW
    step (norm, update, bf16 refresh) leaves the process's count, which is
    torch's intra-op thread count, as it found it."""
    before = torch.get_num_threads()
    torch.set_num_threads(3)
    try:
        host = _host()
        work = {k: torch.empty(s, dtype=torch.bfloat16) for k, s in SHAPES.items()}
        host.update_and_refresh(_torch(_grads(0)), work)
        assert torch.get_num_threads() == 3
    finally:
        torch.set_num_threads(before)


def test_update_and_refresh_equals_update_then_device_params():
    """The streamed step (update + cast + copy per leaf) against the separate
    phases: the same masters and working copy, bit for bit."""
    fused, separate = _host(), _host()
    work = {k: torch.empty(s, dtype=torch.bfloat16) for k, s in SHAPES.items()}
    for step in range(3):
        g = _torch(_grads(step))
        fused.update_and_refresh(g, work)
        separate.update(g)
        want = separate.device_params(torch.bfloat16, "cpu")
        for name in SHAPES:
            assert torch.equal(work[name].view(torch.int16), want[name].view(torch.int16))
    for name in SHAPES:
        assert torch.equal(fused.masters[name], separate.masters[name])
    assert fused.last_grad_norm == separate.last_grad_norm


def test_pieces_stream_the_same_bits(monkeypatch):
    """Leaves larger than a piece (PIECE cut to 100 elements: "a" streams in
    21 pieces, one of them short) step and refresh to the same masters and
    working copy as leaves taken whole; the host norm agrees to fp64
    rounding (its per-piece sums are added in another grouping)."""
    whole = _host()
    monkeypatch.setattr(t_off, "PIECE", 100)
    cut = _host()
    assert len(cut._pieces()) == 21 + 2 + 2
    works = [{k: torch.empty(s, dtype=torch.bfloat16) for k, s in SHAPES.items()}
             for _ in range(2)]
    for step in range(3):
        g = _torch(_grads(step))
        whole.update_and_refresh(g, works[0])
        cut.update_and_refresh(g, works[1])
        assert cut.last_grad_norm == pytest.approx(whole.last_grad_norm, rel=1e-12)
    for name in SHAPES:
        assert torch.equal(cut.masters[name], whole.masters[name])
        assert torch.equal(works[1][name].view(torch.int16), works[0][name].view(torch.int16))


def test_state_dict_round_trip():
    """Masters and state_dict into a fresh optimizer: the next step is
    bit-equal to the original's."""
    one = _host()
    one.update(_torch(_grads(0)))
    two = _host()
    two.load_state_dict(one.state_dict())
    two.load_masters(one.masters_tree())
    assert two.step_count == one.step_count == 1
    one.update(_torch(_grads(1)))
    two.update(_torch(_grads(1)))
    for name in SHAPES:
        assert torch.equal(one.masters[name], two.masters[name])
        assert torch.equal(one.v[name], two.v[name])


@pytest.mark.parametrize("mutate", ["missing", "extra", "reshaped"])
def test_mismatched_tree_refused(mutate):
    host = _host()
    g = _torch(_grads(0))
    if mutate == "missing":
        del g["a"]
    elif mutate == "extra":
        g["e"] = torch.zeros(2)
    else:
        g["a"] = torch.zeros(32, 64)
    with pytest.raises(ValueError, match="does not match the initialized param tree"):
        host.update(g)
    with pytest.raises(ValueError, match="does not match"):
        host.load_masters(g)


def _batch(cfg, b=4, s=16, seed=1):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, cfg.vocab_size, size=(b, s)).astype(np.int64)
    mask = np.ones((b, s), np.int64)
    mask[:, -3:] = 0
    labels = np.where(mask != 0, ids, t_llama.IGNORE_INDEX)
    pos = np.broadcast_to(np.arange(s), (b, s)).copy()
    return {k: torch.from_numpy(v) for k, v in (("input_ids", ids), ("attention_mask", mask),
                                                  ("position_ids", pos), ("labels", labels))}


def test_bf16_working_copy_takes_the_masters_fp32_gradients():
    """One step in bf16 compute over 2 microbatches: on a bf16 working copy
    with fp32 gradient buffers (bind_fp32_grads), the loss and every
    gradient are bit-equal to those of the fp32 masters cast where used
    (norms and the embedding read in fp32, as on the masters). The norms
    are moved off 1.0 to values bf16 holds exactly, so that both paths read
    the same weights while a bf16 rounding of their gradients would show."""
    cfg = TConfig.tiny(dtype=torch.bfloat16)
    masters = t_llama.init_params(cfg, device="cpu", seed=0)
    for k in ("layers.input_norm", "layers.post_norm", "norm"):
        moved = masters[k] + 0.05 * torch.randn(masters[k].shape)
        masters[k] = moved.to(torch.bfloat16).float()
    batch = _batch(cfg)
    leaves = {k: v.clone().requires_grad_() for k, v in masters.items()}
    ocfg = t_optim.OptimizerConfig(total_steps=10, warmup_steps=1)
    on_device = t_ts.train_step(t_ts.TrainState(0, leaves, t_optim.AdamW(leaves, ocfg)),
                                dict(batch), cfg, num_microbatches=2)
    working = {k: v.to(torch.bfloat16) for k, v in masters.items()}
    grads = {k: torch.full(v.shape, 7.0) for k, v in masters.items()}  # zeroed by the step

    class Keep:  # an optimizer that keeps the gradients it is handed
        def step(self, params, g, norm):
            self.grads = {k: t.clone() for k, t in g.items()}
            return 0.0

    keep = Keep()
    offload = t_ts.train_step(t_ts.TrainState(0, working, keep), dict(batch), cfg,
                              num_microbatches=2, grads=grads)
    assert offload["loss"].item() == on_device["loss"].item()
    for k, leaf in leaves.items():
        assert keep.grads[k].dtype == torch.float32
        assert torch.equal(keep.grads[k], leaf.grad), k


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def _tiny(tmp_path, name, *overrides):
    return t_config.load_config(os.path.join(REPO, "conf", "tiny_smoke.yaml"), [
        "mesh.dp=1", "max_steps=4", "total_steps=8", "warmup_steps=1", "logging_steps=1",
        "dataset.pseudo_dataset_len=64", f"output_dir={tmp_path}/{name}", *overrides])


def _masters(run):
    """The run's fp32 masters in the canonical tree."""
    tree = run.canonical_of(run.host.masters_tree() if run.host is not None
                            else run.state.params)
    return {k: v.make() if isinstance(v, tensor_io.Lazy) else v.detach() for k, v in tree.items()}


@pytest.mark.parametrize("pp", [1, 2])
def test_trainer_with_and_without_offload(tmp_path, pp):
    """tiny_smoke (fp32) for 4 steps at pp 1 and at its own pp 2, with and
    without optimizer_offload: losses within 1e-5 step by step, final
    masters within rtol 2e-5, atol 1e-6; the metrics line carries the host
    phases."""
    runs = {}
    for offload in (False, True):
        run = t_train.build_run(_tiny(tmp_path, f"o{offload}", f"mesh.pp={pp}",
                                      f"optimizer_offload={str(offload).lower()}",
                                      "save_final=false", "resume=false"), device="cpu")
        runs[offload] = (t_train.train_run(run)["losses"], _masters(run))
    np.testing.assert_allclose(runs[True][0], runs[False][0], rtol=0, atol=LOSS_TOL)
    _close(runs[True][1], runs[False][1])
    rows = [json.loads(x) for x in open(tmp_path / "oTrue" / "metrics.jsonl")]
    assert all("stream_d2h_update_h2d_ms" in r and "norm_ms" in r for r in rows)


def test_trainer_offload_matches_jax_trainer_offload(ref, tmp_path):
    """run_training with optimizer_offload in both packages (pp 1, fp32),
    warm-started from the same weights (the reference's init, carried by
    convert.py and saved by each package's checkpointer): the metrics
    line's loss at each of 4 steps within 1e-5, and the final masters
    within MASTERS_VS_JAX_ATOL."""
    cfg_j = ref.config.LlamaConfig.tiny()
    tree = ref.llama.init_params(jax.random.PRNGKey(4), cfg_j)
    one = ref.manifest.StageManifest.for_config(cfg_j, 1)
    ref.ckpt.CheckpointManager(str(tmp_path / "warm_ref")).save(
        0, ref.pl.stack_stages(tree, one), one, cfg_j)
    t_ckpt.CheckpointManager(str(tmp_path / "warm_port")).save(
        0, convert.params_from_jax(jax.device_get(tree)),
        TManifest(num_layers=cfg_j.num_hidden_layers, num_stages=1), TConfig.tiny())
    args = ["mesh.pp=1", "optimizer_offload=true", "save_final=true", "resume=false"]
    ref.train.run_training(_tiny(tmp_path, "ref", f"model_name_or_path={tmp_path}/warm_ref",
                                 *args))
    run = t_train.build_run(_tiny(tmp_path, "port", f"model_name_or_path={tmp_path}/warm_port",
                                  *args), device="cpu")
    t_train.train_run(run)
    want = [json.loads(x)["loss"] for x in open(tmp_path / "ref" / "metrics.jsonl")
            if "loss" in json.loads(x)]
    got = [json.loads(x)["loss"] for x in open(tmp_path / "port" / "metrics.jsonl")]
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_TOL)
    jtree, _, _, _ = ref.ckpt.load_module_checkpoint(str(tmp_path / "ref"))
    for k, v in convert.params_from_jax(jax.device_get(jtree)).items():
        np.testing.assert_allclose(run.host.masters[k].numpy(), v.numpy(), rtol=0,
                                   atol=MASTERS_VS_JAX_ATOL, err_msg=k)


def _final_state(run):
    return {**{f"p.{k}": v for k, v in _masters(run).items()},
            **{f"m.{k}": v for k, v in run.canonical_of(run.host.m).items()}}


@pytest.mark.parametrize("pp", [1, 2])
def test_offload_checkpoint_resumes_bit_equal(tmp_path, pp):
    """An offload run saves the offload_parts layout at step 2 (params, opt_m,
    opt_v, meta.json's opt_layout and opt_step_count; inspect_ckpt --verify
    digests the three files); a second run resumes it and repeats steps 3-4:
    losses and final masters bit-equal to the uninterrupted run's."""
    from llama_pipeline_parallel_tpu_torch.tools import inspect_ckpt

    args = [f"mesh.pp={pp}", "optimizer_offload=true", "save_final=false"]
    full = t_train.build_run(_tiny(tmp_path, "full", *args, "resume=false"), device="cpu")
    losses = t_train.train_run(full)["losses"]
    part = _tiny(tmp_path, "part", *args, "resume=false", "max_steps=2", "save_steps=2")
    t_train.run_training(part, device="cpu")
    step_dir = tmp_path / "part" / "checkpoint-2"
    assert sorted(os.listdir(step_dir)) == ["meta.json", "opt_m.safetensors",
                                            "opt_v.safetensors", "params.safetensors"]
    meta = json.loads((step_dir / "meta.json").read_text())
    assert meta["opt_layout"] == "offload_parts" and meta["opt_step_count"] == 2
    verified = inspect_ckpt.verify_digests(str(tmp_path / "part"), 2)
    assert verified["status"] == "OK" and len(verified["files"]) == 3
    resumed = t_train.build_run(_tiny(tmp_path, "part", *args), device="cpu")
    assert resumed.start_step == 2 and resumed.host.step_count == 2
    assert t_train.train_run(resumed)["losses"] == losses[2:]
    want = {k: v for k, v in _masters(full).items()}
    for k, v in _masters(resumed).items():
        assert torch.equal(v, want[k]), k


def test_resume_refuses_the_other_layout(tmp_path):
    """An offload_parts checkpoint resumed without offload, and a fused
    checkpoint resumed with it, are refused by name with the remedy; a
    warm start (model_name_or_path) takes the weights of either layout."""
    for offload in (True, False):
        t_train.run_training(_tiny(tmp_path, f"src{offload}", "mesh.pp=1", "max_steps=2",
                                   f"optimizer_offload={str(offload).lower()}",
                                   "save_final=true", "resume=false"), device="cpu")
    with pytest.raises(ValueError, match="opt_layout=offload_parts.*optimizer_offload: true"):
        t_train.build_run(_tiny(tmp_path, "srcTrue", "mesh.pp=1"), device="cpu")
    with pytest.raises(ValueError, match="offload layout.*model_name_or_path"):
        t_train.build_run(_tiny(tmp_path, "srcFalse", "mesh.pp=1", "optimizer_offload=true"),
                          device="cpu")
    for src, offload in (("srcTrue", False), ("srcFalse", True), ("srcTrue", True)):
        run = t_train.build_run(_tiny(tmp_path, f"warm{src}{offload}", "mesh.pp=1",
                                      f"model_name_or_path={tmp_path}/{src}",
                                      f"optimizer_offload={str(offload).lower()}",
                                      "resume=false"), device="cpu")
        with tensor_io.TensorFile(str(tmp_path / src / "checkpoint-2" /
                                      "params.safetensors")) as f:
            for k, v in _masters(run).items():
                assert torch.equal(v, f.tensor(k)), k


def test_two_processes_equal_one_process(tmp_path):
    """tiny_smoke's pp 2 on the host optimizer under `torch.distributed.run`
    (a process a stage over gloo, each stepping its own stage's masters; the
    host-path norm's square summed over the processes by `reduce_norm_sq`):
    the metrics line's losses equal those of the same run in one process."""
    args = ["mesh.pp=2", "mesh.dp=1", "max_steps=3", "total_steps=6", "logging_steps=1",
            "save_final=false", "resume=false", "optimizer_offload=true",
            "offload_device_norm=false"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_addr", "localhost", "--master_port", str(_free_port()),
           "-m", "llama_pipeline_parallel_tpu_torch.cli", "--config", "conf/tiny_smoke.yaml",
           "--device", "cpu", *args, f"output_dir={tmp_path}/two"]
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr[-3000:]
    two = [json.loads(x)["loss"] for x in open(tmp_path / "two" / "metrics.jsonl")]
    one = t_train.run_training(t_config.load_config(
        os.path.join(REPO, "conf", "tiny_smoke.yaml"), args + [f"output_dir={tmp_path}/one"]),
        device="cpu")
    assert two == one["losses"] and len(two) == 3


def test_offload_keys_parsed_and_zero2_logged(tmp_path):
    """Unknown offload.* keys are refused; offload.wgrad_stash outside zb1
    is refused as the reference refuses it; optimizer_offload_zero2 at dp 1
    is logged as having no effect and runs the plain layout."""
    with pytest.raises(ValueError, match="unknown offload"):
        t_train.build_run(_tiny(tmp_path, "k", "offload={wgrad: true}"), device="cpu")
    with pytest.raises(ValueError, match="requires schedule: zb1"):
        t_train.build_run(_tiny(tmp_path, "k", "offload={wgrad_stash: true}"), device="cpu")
    records = []
    handler = logging.Handler(logging.INFO)
    handler.emit = records.append
    t_train.logger.addHandler(handler)
    try:
        run = t_train.build_run(_tiny(tmp_path, "z", "mesh.pp=1", "optimizer_offload=true",
                                      "optimizer_offload_zero2=true"), device="cpu")
    finally:
        t_train.logger.removeHandler(handler)
    assert any("optimizer_offload_zero2 has no effect at dp=1" in r.getMessage()
               for r in records)
    assert run.host is not None and run.state.optimizer is run.host
