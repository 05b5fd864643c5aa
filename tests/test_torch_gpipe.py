"""The port's gpipe schedule (parallel/pipeline.gpipe_schedule, run by the
interpreter's F / B units) against the JAX package's gpipe, on the CPU at
the `tiny` preset in fp32.

gpipe is the reference's forward scan differentiated whole: here a forward
wave that buffers each stage input, then a backward wave in ascending
microbatch order that recomputes each chunk from its input. Tolerances as
tests/test_torch_pipeline.py's: loss 1e-5, gradients 1e-4 of each leaf's
largest element against the reference; against this package's flat 1F1B
the gradients are bit-equal (each parameter folds its microbatches in the
same order, through the same operations).
"""

import json
import os

import numpy as np
import pytest
import torch

from llama_pipeline_parallel_tpu_torch import convert
from llama_pipeline_parallel_tpu_torch import train as t_train
from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig as TConfig
from llama_pipeline_parallel_tpu_torch.parallel import pipeline as t_pl
from llama_pipeline_parallel_tpu_torch.parallel import schedule as t_us
from llama_pipeline_parallel_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from tests.test_torch_pipeline import (
    LOSS_RTOL,
    _assert_grads_close,
    _batch,
    _manifest,
    _port_grads,
    _ref_loss_and_grad,
    _tiny_cfg,
    _torch_batch,
    _tree,
    ref,  # noqa: F401  (the reference fixture)
)

CASES = {
    "pp2-m4": dict(pp=2, m=4),
    "pp4-m2": dict(pp=4, m=2),  # M < S
    "pp2-accum2": dict(pp=2, m=4, accum=2),
    "pp2-uneven31": dict(pp=2, m=4, counts=(3, 1)),
}


def _pipeline(params, pp, m, *, schedule="gpipe", accum=1, counts=None, remat=True):
    cfg = TConfig.tiny()
    pcfg = t_pl.PipelineConfig(num_stages=pp, num_microbatches=m, schedule=schedule,
                               accum_chunks=accum, layer_counts=counts, remat=remat)
    sp = t_pl.StageParams.from_canonical(params, _manifest(cfg.num_hidden_layers, pp,
                                                           counts=counts))
    return t_pl.Pipeline(cfg, pcfg, make_mesh(MeshConfig(pp=pp)), sp), sp


@pytest.mark.parametrize("name", list(CASES))
def test_gpipe_matches_reference(ref, name):
    """One step's loss and gradients of the port's gpipe against the
    reference's gpipe (make_pipeline_loss_and_grad, schedule="gpipe") on a
    pp-device mesh, from the same params and a batch with a pad tail."""
    case = CASES[name]
    batch, tree = _batch(pad_tail=3), _tree(ref)
    want_loss, want_grads = _ref_loss_and_grad(ref, tree, batch, case["pp"], case["m"],
                                               schedule="gpipe", accum=case.get("accum", 1),
                                               counts=case.get("counts"))
    pipe, sp = _pipeline(convert.params_from_jax(tree), **case)
    loss = pipe.loss_and_grad(_torch_batch(batch))
    np.testing.assert_allclose(loss.item(), want_loss, rtol=LOSS_RTOL)
    _assert_grads_close(_port_grads(sp), want_grads)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("name", ["pp2-m4", "pp4-m2", "pp2-accum2"])
def test_gpipe_bit_equal_flat_1f1b(ref, name, remat):
    """gpipe against flat 1F1B on the same params and batch, with and
    without activation checkpointing: loss and every gradient bit-equal."""
    case = CASES[name]
    params = convert.params_from_jax(_tree(ref))
    batch = _torch_batch(_batch(pad_tail=3))
    got = {}
    for schedule in ("gpipe", "1f1b"):
        pipe, sp = _pipeline(params, **case, schedule=schedule, remat=remat)
        got[schedule] = (pipe.loss_and_grad(batch).item(), _port_grads(sp))
    assert got["gpipe"][0] == got["1f1b"][0]
    for k, g in got["1f1b"][1].items():
        assert torch.equal(got["gpipe"][1][k], g), k


@pytest.mark.parametrize("pp,m,accum", [(2, 4, 1), (4, 8, 1), (4, 8, 2), (4, 2, 1), (8, 16, 4)])
def test_gpipe_bubble_equals_reference_and_the_grid(ref, pp, m, accum):
    """bubble_fraction under gpipe is the reference's c(S-1) / (M + c(S-1))
    to the bit, and the idle share the grid's own count gives
    (schedule.bubble_stats); the grid is a forward wave of m/c + S - 1 ticks
    and a backward wave as long, each unit once a stage, and it validates."""
    pcfg = t_pl.PipelineConfig(num_stages=pp, num_microbatches=m, schedule="gpipe",
                               accum_chunks=accum)
    want = ref.pl.bubble_fraction(ref.pl.PipelineConfig(num_stages=pp, num_microbatches=m,
                                                        schedule="gpipe", accum_chunks=accum))
    us = t_pl.flush_unit_schedule(pcfg)
    idle, wall = t_us.bubble_stats(us)
    assert t_pl.bubble_fraction(pcfg) == want == (idle * accum) / (wall * accum)
    ticks = m // accum + pp - 1
    assert us.num_ticks == 2 * ticks and not us.split_backward
    assert us.has_f[:ticks].all() and not us.has_f[ticks:].any() and us.has_b[ticks:].all()
    for s in range(pp):
        f, b = us.f_unit[:, s], us.b_unit[:, s]
        assert list(f[f >= 0]) == list(range(m // accum)) == list(b[b >= 0])
    t_us.validate(us)


def test_gpipe_runs_every_unit_once_and_keeps_no_graph(ref):
    """Each stage runs every F and B unit of the grid once per flush (the
    loss-owning stage's F only buffers: its B computes the chunk); the
    stage inputs of the whole flush are buffered at once between the waves
    (no ring), and no buffered input outlives the step."""
    pipe, _ = _pipeline(convert.params_from_jax(_tree(ref)), 2, 4, accum=2)
    peak = {0: 0, 1: 0}
    keep = pipe._keep_input

    def counting_keep(s, u, x):
        keep(s, u, x)
        peak[s] = max(peak[s], len(pipe._xbuf[s]))

    pipe._keep_input = counting_keep
    pipe.loss_and_grad(_torch_batch(_batch()))
    for s in range(2):
        assert pipe.units[s] == {"F": 4, "B": 4, "W": 0}
        assert pipe._xbuf[s] == {} and peak[s] == 2  # m per flush = 4 // 2
    assert pipe.computed[0] == {"F": 4, "B": 4, "W": 0}
    assert pipe.computed[1] == {"F": 0, "B": 4, "W": 0}


def test_trainer_runs_gpipe_as_flat(tmp_path):
    """run_training at pp 2 with pipeline_schedule=gpipe: the metrics line's
    losses those of flat 1f1b from the same seed, bit for bit, with the
    counted bubble of the reference's formula in the log's pipeline line."""
    losses = {}
    for schedule in ("gpipe", "1f1b"):
        t_train.run_training(_tiny_cfg(tmp_path, schedule, "max_steps=3", "save_final=false",
                                       "resume=false", f"pipeline_schedule={schedule}"),
                             device="cpu")
        losses[schedule] = [json.loads(x)["loss"]
                            for x in open(os.path.join(tmp_path, schedule, "metrics.jsonl"))]
    assert len(losses["gpipe"]) == 3 and losses["gpipe"] == losses["1f1b"]


def test_gpipe_refuses_host_tiers():
    """gpipe's stored activations are autograd's: offload.activations is
    refused as the reference refuses it, and the W-queue tier too."""
    with pytest.raises(ValueError, match="offload.activations requires"):
        t_pl.PipelineConfig(num_stages=2, num_microbatches=4, schedule="gpipe",
                            offload_activations=True)
    with pytest.raises(ValueError, match="offload.wgrad_stash requires"):
        t_pl.PipelineConfig(num_stages=2, num_microbatches=4, schedule="gpipe",
                            offload_wgrad=True)
