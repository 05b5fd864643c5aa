"""The port's host optimizer at dp > 1 (optim/offload.py: the replicated
layout and the ZeRO-2 layout of `optimizer_offload_zero2`) against the JAX
package's, on the CPU at the `tiny` preset in fp32.

The processes are gloo ranks (tests/torch_tp_worker.py, each with a join
timeout) running the trainer at pp 1 x dp 2 (2 processes) and pp 2 x tp 2 x
dp 2 (8), warm-started from the reference's init carried over by
convert.py; the reference runs run_training with the same keys on
tests/conftest.py's 8 virtual CPU devices.

Tolerances (tests/test_torch_offload.py's): the metrics line's losses
within 1e-5 of the reference's, the final masters within 1e-4 of the largest
element of each leaf. Between the two layouts of this package (the same
gradients and norm, the same elementwise C++ AdamW on a slice or on the
whole leaf) the test says bit-equal.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from llama_pipeline_parallel_tpu_torch import convert
from llama_pipeline_parallel_tpu_torch.ckpt import tensor_io
from llama_pipeline_parallel_tpu_torch.models.llama.manifest import StageManifest as TManifest
from llama_pipeline_parallel_tpu_torch.utils import config as t_config
from tests.test_torch_dp import _warm_checkpoints, finish, launch
from tests.test_torch_pipeline import LOSS_RTOL, _assert_grads_close, ref  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_tp_worker.py")
TINY_SMOKE = os.path.join(REPO, "conf", "tiny_smoke.yaml")
ARGS = ["max_steps=3", "logging_steps=1", "save_final=true", "resume=false",
        "dataset.pseudo_dataset_len=64", "optimizer_offload=true"]
# (processes, layout overrides) of each cell
LAYOUTS = {"pp1xdp2": (2, ["mesh.pp=1"]), "pp2xtp2xdp2": (8, ["mesh.tp=2"])}
# the host optimizer's layouts, and the host-path norm (counted once over
# the processes) in the ZeRO-2 one
VARIANTS = {"replicated": [], "zero2": ["optimizer_offload_zero2=true"],
            "zero2-hostnorm": ["optimizer_offload_zero2=true", "offload_device_norm=false"]}
CELLS = [(layout, variant) for layout in LAYOUTS for variant in VARIANTS
         if variant != "zero2-hostnorm" or layout == "pp2xtp2xdp2"]


@pytest.fixture(scope="module")
def offload_runs(ref, tmp_path_factory):
    """Every cell's 3 trainer steps, one launch a layout (its variants one
    after another in the same processes), while the reference runs each
    cell's run_training."""
    root = tmp_path_factory.mktemp("offload_dp")
    _warm_checkpoints(ref, root)
    procs = {}
    for layout, (n, keys) in LAYOUTS.items():
        d = root / layout
        d.mkdir()
        torch.save({}, d / "inputs.pt")
        torch.save([dict(kind="train", name=variant, config=TINY_SMOKE, overrides=ARGS + keys + [
            *VARIANTS[variant], f"output_dir={d}/{variant}",
            f"model_name_or_path={root}/warm_port"]) for v_layout, variant in CELLS
            if v_layout == layout], d / "jobs.pt")
        procs[layout] = launch(n, [sys.executable, WORKER, str(d)])
    for layout, variant in CELLS:
        ref.train.run_training(t_config.load_config(TINY_SMOKE, ARGS + LAYOUTS[layout][1] + [
            *VARIANTS[variant], f"output_dir={root}/ref-{layout}-{variant}",
            f"model_name_or_path={root}/warm_ref"]))
    for ps in procs.values():
        for rc, _, stderr in finish(ps):
            assert rc == 0, stderr[-3000:]
    results = {(layout, variant): [torch.load(root / layout / f"{variant}-rank{r}.pt")
                                   for r in range(LAYOUTS[layout][0])]
               for layout, variant in CELLS}
    return root, results


def _ref_masters(ref, path, pp):
    cfg_j = ref.config.LlamaConfig.tiny()
    manifest = ref.manifest.StageManifest.for_config(cfg_j, pp)
    tree = ref.llama.init_params(jax.random.PRNGKey(4), cfg_j)
    final = ref.ckpt.CheckpointManager(str(path)).load_params(
        3, ref.pl.stack_stages(tree, manifest), manifest)
    return convert.params_from_jax(convert.unstack_stages(
        jax.device_get(final), TManifest(num_layers=4, num_stages=pp)))


@pytest.mark.parametrize("layout,variant", CELLS)
def test_host_optimizer_at_dp2_matches_reference_run_training(ref, offload_runs, layout,
                                                              variant):
    """The host optimizer at pp 1 x dp 2 and pp 2 x tp 2 x dp 2, replicated
    and ZeRO-2 (and ZeRO-2 with the host-path norm), against the reference's
    run_training with the same keys over the virtual mesh, 3 steps: the
    metrics line's loss at each step (1e-5), every rank's losses the same,
    and the final masters (1e-4)."""
    root, results = offload_runs
    want = [json.loads(x)["loss"] for x in open(root / f"ref-{layout}-{variant}" /
                                                "metrics.jsonl") if "loss" in json.loads(x)]
    got = [json.loads(x)["loss"] for x in open(root / layout / variant / "metrics.jsonl")]
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert all(r["losses"] == results[(layout, variant)][0]["losses"]
               for r in results[(layout, variant)])
    pp = 2 if layout.startswith("pp2") else 1
    got_params = tensor_io.load_file(str(root / layout / variant / "checkpoint-3" /
                                         "params.safetensors"))
    _assert_grads_close(got_params, _ref_masters(ref, root / f"ref-{layout}-{variant}", pp),
                        rtol=1e-4)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_zero2_masters_bit_equal_replicated(offload_runs, layout):
    """After 3 steps the ZeRO-2 run's masters and moments (each replica's
    slices, joined by process 0 into its checkpoint) are bit-equal to the
    replicated layout's, and so are the losses."""
    root, results = offload_runs
    assert results[(layout, "zero2")][0]["losses"] == results[(layout, "replicated")][0]["losses"]
    for name in ("params.safetensors", "opt_m.safetensors", "opt_v.safetensors"):
        a = tensor_io.load_file(str(root / layout / "zero2" / "checkpoint-3" / name))
        b = tensor_io.load_file(str(root / layout / "replicated" / "checkpoint-3" / name))
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), (name, k)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_zero2_rank_holds_its_share_of_host_bytes(offload_runs, layout):
    """Under ZeRO-2 each rank's host masters and both moments are 1/dp of
    every leaf (of its tp slice) that has a dim dp divides, on the dim
    zero1_dims picks, and the whole leaf otherwise; the replicated layout
    keeps every leaf whole."""
    _, results = offload_runs
    dp = 2
    split = 0
    for variant in ("zero2", "replicated"):
        for res in results[(layout, variant)]:
            for name, (master, m, v, whole, dim) in res["host"].items():
                assert master == m == v, name
                if variant == "replicated" or dim is None:
                    assert master == whole, name
                    assert variant == "replicated" or all(n % dp for n in whole), name
                    continue
                want = list(whole)
                want[dim] //= dp
                assert master == tuple(want), name
                split += 1
    assert split >= 10
