"""The port's preflight (llama_pipeline_parallel_tpu_torch/tools/preflight.py)
held to the JAX package's tools/preflight.py on the CPU.

- The byte-model terms the two share (the layout model, the ring / stash /
  loss-head terms, the host-link traffic and feasibility, the stash
  remedies) equal for every conf/*.yaml, both tools given the card's peak,
  budget and bandwidths explicitly.
- Schedule selection at the 65B pp 8 shape of tests/test_preflight_select.py:
  the candidate grid and every scored row equal, and the winner in its cases
  (enough memory, a blown stash, a starved host link, nothing fits, the ce
  axis, the solver lane).
- The 65B 32-device layout frontier: rows and scores equal (1e-9 relative),
  the winner the hand-written pp8 x tp2 x dp2 layout.
- The emitted solver JSON and ladder JSON equal byte for byte; the ladder
  parses in the port's supervisor and every rung passes the port's builders;
  an emitted schedule trains three steps in the port's trainer with the
  named schedule's gradient norms and losses, and its checkpoint gives the
  same resume_compat report in both packages.
- The CLI: `python -m` on tiny_smoke with a budget exits 0; without a card
  and without --hbm-gb it exits non-zero, and --calibrate / --memory-audit
  refuse to run.
"""

import glob
import importlib
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from llama_pipeline_parallel_tpu_torch.parallel import pipeline as t_pl
from llama_pipeline_parallel_tpu_torch.parallel import schedule as t_us
from llama_pipeline_parallel_tpu_torch.tools import preflight as t_pf
from llama_pipeline_parallel_tpu_torch.tools import supervisor as t_sup
from llama_pipeline_parallel_tpu_torch.utils.config import apply_overrides, load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "conf", "*.yaml")))
# the constants both tools take explicitly, so that neither's default counts
CHIP_FLOPS, HOST_BW, ICI_BW, HBM = 989e12, 40.0, 419.1, 79.19
# tests/test_preflight_select.py's 65B pp 8 shape
S, M, LAYERS = 8, 256, 80
COMPUTE = lambda pcfg: 60.0  # noqa: E731 — modeled step seconds, accum-invariant
CE_AXIS = ((1, False), (8, False), (250, True))
AW65 = (8, 2, 2, 1)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's preflight (a root tool) and the modules it builds
    on, after installing the stand-in for
    `jax._src.sharding_impls.TransferToMemoryKind` where this jax lacks it."""
    import jax._src.sharding_impls as impls

    if not hasattr(impls, "TransferToMemoryKind"):
        class TransferToMemoryKind:
            def __init__(self, memory_kind):
                self.memory_kind = memory_kind

        impls.TransferToMemoryKind = TransferToMemoryKind
    sys.path.insert(0, os.path.join(REPO, "tools"))
    mods = {"pl": "parallel.pipeline", "us": "parallel.schedule", "train": "train",
            "mesh": "parallel.mesh", "config": "models.llama.config",
            "cfgload": "utils.config"}
    return types.SimpleNamespace(
        pf=importlib.import_module("preflight"),
        **{k: importlib.import_module(f"llama_pipeline_parallel_tpu.{v}")
           for k, v in mods.items()})


def _built(pkg, cfg):
    """(mesh_cfg, model_cfg, pcfg, dims, seq) of `cfg` through a package's
    own builders."""
    train = pkg.train
    mesh_cfg = pkg.mesh.MeshConfig(**{ax: int((cfg.get("mesh") or {}).get(ax, 1))
                                      for ax in ("pp", "dp", "tp", "sp")})
    model_cfg = train.build_model_config(cfg["model"])
    manifest = train.build_manifest(cfg, model_cfg, mesh_cfg.pp)
    pcfg = train.build_pipeline_config(cfg, mesh_cfg, manifest)
    seq = t_pf._seq_length(cfg)
    dims = pkg.pl.stash_dims(int(cfg.get("per_device_train_batch_size", 1)), seq, mesh_cfg.sp,
                             model_cfg.hidden_size, model_cfg.dtype)
    return mesh_cfg, model_cfg, pcfg, dims, seq


def _port():
    from llama_pipeline_parallel_tpu_torch import train
    from llama_pipeline_parallel_tpu_torch.parallel import mesh

    return types.SimpleNamespace(train=train, mesh=mesh, pl=t_pl)


@pytest.mark.parametrize("config", CONFIGS, ids=os.path.basename)
def test_byte_model_terms_match_reference(ref, config):
    rcfg = ref.cfgload.load_config(config)
    tcfg = load_config(config)
    r_mesh, r_model, r_pcfg, r_dims, seq = _built(ref, rcfg)
    t_mesh, t_model, t_pcfg, t_dims, _ = _built(_port(), tcfg)
    assert r_dims == t_dims
    vocab = t_model.vocab_size
    for v in (None, vocab):
        assert (t_pf.candidate_device_terms_gib(t_pcfg, t_dims, v)
                == ref.pf.candidate_device_terms_gib(r_pcfg, r_dims, v))
    kw = dict(optimizer_offload=bool(tcfg.get("optimizer_offload")),
              zero2=bool(tcfg.get("optimizer_offload_zero2")))
    for pp, tp, dp in ((t_mesh.pp, t_mesh.tp, t_mesh.dp), (1, 1, 1), (2, 4, 8)):
        assert (t_pf.layout_device_gib(t_model, pp, tp, dp, layer_counts=t_pcfg.layer_counts,
                                       **kw)
                == ref.pf.layout_device_gib(r_model, pp, tp, dp,
                                            layer_counts=r_pcfg.layer_counts, **kw))
    assert (t_pl.loss_head_bytes(t_pcfg, *t_dims[:3], vocab // t_mesh.tp)
            == ref.pl.loss_head_bytes(r_pcfg, *r_dims[:3], vocab // t_mesh.tp))
    assert t_pf.offload_traffic_bytes(t_pcfg, t_dims) == ref.pf.offload_traffic_bytes(
        r_pcfg, r_dims)
    mb = int(tcfg.get("per_device_train_batch_size", 1))
    t_s = t_pf._step_compute_seconds(t_model, t_mesh, t_pcfg, mb, seq, 0.45, CHIP_FLOPS)
    r_s = ref.pf._step_compute_seconds(r_model, r_mesh, r_pcfg, mb, seq, 0.45, CHIP_FLOPS)
    assert t_s == pytest.approx(r_s, rel=1e-12)
    assert (t_pf.offload_feasibility(t_pcfg, t_dims, t_s, HOST_BW)
            == ref.pf.offload_feasibility(r_pcfg, r_dims, r_s, HOST_BW))
    if t_pl.wgrad_queue_peak(t_pcfg):
        assert t_pf.stash_remedies(t_pcfg) == ref.pf.stash_remedies(r_pcfg)
    # the port's report carries the reference's terms at the printed places
    report = t_pf.preflight(tcfg, HBM, host_bw_gibps=HOST_BW, chip_flops=CHIP_FLOPS)
    terms = ref.pf.candidate_device_terms_gib(r_pcfg, r_dims)
    assert report["ring_gib"] == round(terms["ring_gib"], 2)
    assert report["stash_gib"] == round(terms["stash_gib"], 2)
    assert report["params_grads_optimizer_gib"] == round(ref.pf.layout_device_gib(
        r_model, r_mesh.pp, r_mesh.tp, r_mesh.dp, layer_counts=r_pcfg.layer_counts, **kw), 2)


def _rows(rows):
    return [{k: v for k, v in r.items() if k != "_pcfg"} for r in rows]


def _grid(pcfgs):
    return [(c.schedule, c.virtual_stages, c.accum_chunks, c.offload_wgrad,
             c.offload_activations, c.loss_chunks, c.kernel_ce) for c in pcfgs]


SELECT_CASES = {  # (base GiB, budget GiB, host GiB/s, ce axis, solver lane)
    "enough_memory_zb1": (70.0, 1000.0, 30.0, None, False),
    "blown_stash_wgrad_offload": (70.0, HBM, 30.0, None, False),
    "starved_link_interleaved": (70.0, HBM, 0.5, None, False),
    "nothing_fits": (120.0, HBM, 30.0, None, False),
    "ce_axis": (70.0, 1000.0, 30.0, CE_AXIS, False),
    "solver_lane": (70.0, HBM, 30.0, None, True),
}


@pytest.fixture(scope="module")
def dims(ref):
    return ref.pl.stash_dims(8, 512, 1, 8192, "bfloat16")


@pytest.mark.parametrize("case", list(SELECT_CASES))
def test_selection_matches_reference(ref, dims, case):
    import torch

    base, hbm, bw, ce, solver = SELECT_CASES[case]
    assert t_pl.stash_dims(8, 512, 1, 8192, torch.bfloat16) == dims
    vocab = 32000 if ce else None
    out = []
    for pf in (t_pf, ref.pf):
        cands = pf.enumerate_candidates(S, M, LAYERS, ce_options=ce)
        if solver:
            cands += pf.solver_candidates(S, M, LAYERS, base, dims, hbm)
        out.append((_grid(cands), pf.select_schedule(cands, base, dims, hbm, bw, COMPUTE,
                                                     vocab=vocab)))
    (t_grid, (t_win, t_rows)), (r_grid, (r_win, r_rows)) = out
    assert t_grid == r_grid
    assert _rows(t_rows) == _rows(r_rows)
    assert (t_win is None) == (r_win is None)
    if t_win is not None:
        assert _rows([t_win]) == _rows([r_win])
        assert t_pf.select_overrides(t_win) == ref.pf.select_overrides(r_win)
    want = {"enough_memory_zb1": "zb1", "blown_stash_wgrad_offload": "zb1",
            "starved_link_interleaved": "interleaved_1f1b", "nothing_fits": None,
            "ce_axis": "zb1", "solver_lane": "solver"}[case]
    assert (t_win and t_win["schedule"]) == want
    assert t_pf.ce_axis_options(1, 32000, 1) == ref.pf.ce_axis_options(1, 32000, 1) == CE_AXIS


@pytest.fixture(scope="module")
def frontiers(ref):
    """The 65B 32-device frontier of both packages (the port's model config
    is its own LLaMA-65B preset)."""
    from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig

    kw = dict(mb_rows=8, seq=512, global_batch_examples=4096, base_gib_aw=70.0,
              aw_layout=AW65, hbm_gb=HBM, chip_flops=CHIP_FLOPS, host_bw_gibps=HOST_BW,
              ici_bw_gibps=ICI_BW, solver_lane=False)
    return (t_pf.layout_frontier(LlamaConfig.llama_65b(), 32, **kw),
            ref.pf.layout_frontier(ref.config.LlamaConfig.llama_65b(), 32, **kw))


def test_layout_frontier_matches_reference(ref, frontiers):
    (t_win, t_rows), (r_win, r_rows) = frontiers
    assert [r["layout"] for r in t_rows] == [r["layout"] for r in r_rows]
    for t, r in zip(t_rows, r_rows):
        assert (t["feasible"], t["microbatches"], t["layer_counts"], t["base_gib"]) == (
            r["feasible"], r["microbatches"], r["layer_counts"], r["base_gib"])
        if t["feasible"]:
            assert t["_score"] == pytest.approx(r["_score"], rel=1e-9)
            assert _rows([t["sched"]]) == _rows([r["sched"]])
    assert t_win["layout"] == r_win["layout"] == "pp8xtp2xdp2xsp1"
    assert t_win["sched"]["schedule"] == "zb1" and t_win["microbatches"] == 256
    assert t_pf.layout_overrides(t_win) == ref.pf.layout_overrides(r_win)


def _emit_both(ref, dims, tmp_path, name, winner_of):
    """Each package's _emit_schedule of its own winner; the two files."""
    paths = []
    for pkg, pf in (("port", t_pf), ("ref", ref.pf)):
        cands = pf.enumerate_candidates(S, M, LAYERS)
        cands += pf.solver_candidates(S, M, LAYERS, 70.0, dims, HBM)
        win, _ = pf.select_schedule(cands, 70.0, dims, *winner_of, COMPUTE)
        plm = t_pl if pf is t_pf else ref.pl
        aw = plm.PipelineConfig(num_stages=S, num_microbatches=M, schedule="zb1",
                                virtual_stages=2)
        path = str(tmp_path / f"{pkg}-{name}.json")
        pf._emit_schedule(path, win.get("_pcfg"), win, S, aw)
        paths.append(path)
    return [open(p, "rb").read() for p in paths]


def test_emitted_schedules_and_ladder_match_reference(ref, dims, tmp_path):
    # a solver winner (the 65B blown-stash budget) and a canonical one
    for name, winner_of in (("solver", (HBM, 30.0)), ("canonical", (1000.0, 30.0))):
        port, reference = _emit_both(ref, dims, tmp_path, name, winner_of)
        assert port == reference
        assert t_us.from_json(port.decode()).num_stages == S
    from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig

    ladders = []
    for pkg, pf, model in (("port", t_pf, LlamaConfig.tiny()),
                           ("ref", ref.pf, ref.config.LlamaConfig.tiny())):
        def sfile(rung, pcfg, pkg=pkg, pf=pf):
            us = t_us if pf is t_pf else ref.us
            path = str(tmp_path / f"{pkg}-{rung}.schedule.json")
            with open(path, "w") as fh:
                fh.write(us.to_json(pcfg.unit_schedule))
            return path

        rungs, _ = pf.build_ladder(model, 4, 1, 32, 8, 1.0, (2, 1, 2, 1), HBM, top_k=2,
                                   schedule_file_for=sfile, chip_flops=1e12,
                                   host_bw_gibps=HOST_BW, ici_bw_gibps=ICI_BW)
        ladders.append(rungs)
    t_rungs, r_rungs = ladders
    assert json.dumps(t_rungs, indent=1).replace("port-", "ref-") == json.dumps(r_rungs,
                                                                                indent=1)
    for rung in [r for r in t_rungs if "pipeline_schedule=solver" in r["overrides"]]:
        path = next(o.split("=", 1)[1] for o in rung["overrides"]
                    if o.startswith("schedule_file="))
        assert open(path, "rb").read() == open(path.replace("port-", "ref-"), "rb").read()
    # the port's supervisor takes the ladder, and every rung passes the
    # port's own builders at its device count
    ladder_file = tmp_path / "ladder.json"
    ladder_file.write_text(json.dumps(t_rungs))
    parsed = t_sup.parse_ladder(f"@{ladder_file}")
    assert [r.devices for r in parsed] == [r["devices"] for r in t_rungs]
    port = _port()
    for rung in t_rungs:
        cfg = apply_overrides({"model": {"preset": "tiny"}, "mesh": {},
                               "per_device_train_batch_size": 1}, rung["overrides"])
        mesh_cfg, _, pcfg, _, _ = _built(port, cfg)
        assert mesh_cfg.pp * mesh_cfg.tp * mesh_cfg.dp * mesh_cfg.sp == rung["devices"]
        assert pcfg.num_stages == mesh_cfg.pp


SOLVER_STEPS = 3  # tiny_smoke warms up over 2 steps: step 3's loss reads step 2's update


def _grad_norms(run_dir: str) -> list:
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [r["grad_norm"] for r in map(json.loads, f) if "grad_norm" in r]


@pytest.fixture(scope="module")
def solver_run(tmp_path_factory):
    """tiny_smoke's pp 2 in one process: --select --emit-schedule through the
    port's CLI, then SOLVER_STEPS steps of the emitted sequence through the
    trainer, saved at the last (and the same steps under the named schedule)."""
    from llama_pipeline_parallel_tpu_torch.train import run_training

    out = tmp_path_factory.mktemp("solver")
    sched = str(out / "schedule.json")
    config = os.path.join(REPO, "conf", "tiny_smoke.yaml")
    assert t_pf.main(["--config", config, "--hbm-gb", "80", "--chip-flops", "1e12",
                      "--select", "--emit-schedule", sched, "mesh.dp=1"]) == 0
    us = t_us.load(sched)
    base = ["mesh.dp=1", f"max_steps={SOLVER_STEPS}", "total_steps=12", "save_final=false",
            "resume=false", "logging_steps=1", f"virtual_stages={us.virtual_stages}"]
    name = ("zb1" if us.split_backward
            else "interleaved_1f1b" if us.virtual_stages > 1 else "1f1b")
    named = run_training(load_config(config, base + [f"pipeline_schedule={name}",
                                                     f"output_dir={out}/named"]), device="cpu")
    named["grad_norms"] = _grad_norms(str(out / "named"))
    run_dir = str(out / "run")
    solver = run_training(load_config(config, base + [
        "pipeline_schedule=solver", f"schedule_file={sched}", f"save_steps={SOLVER_STEPS}",
        f"output_dir={run_dir}"]), device="cpu")
    solver["grad_norms"] = _grad_norms(run_dir)
    return types.SimpleNamespace(config=config, run_dir=run_dir, named=named, solver=solver,
                                 us=us)


def test_emitted_schedule_runs_in_the_trainer(solver_run):
    """The emitted sequence trains as the named schedule does from the same
    init: each step's gradient norm (every B and W unit's gradient) and
    loss (step 3's reads step 2's update)."""
    assert solver_run.us.num_stages == 2
    named, solver = solver_run.named, solver_run.solver
    assert len(solver["losses"]) == SOLVER_STEPS and np.all(np.isfinite(solver["losses"]))
    assert len(solver["grad_norms"]) == SOLVER_STEPS
    assert solver["grad_norms"] == pytest.approx(named["grad_norms"], rel=1e-6)
    assert solver["losses"] == pytest.approx(named["losses"], rel=1e-6)


@pytest.mark.parametrize("change", [[], ["mesh.dp=2"], ["pipeline_schedule=zb1"],
                                    ["mesh.pp=1"], ["gradient_accumulation_steps=4"]],
                         ids=["same", "dp2", "schedule", "pp1", "global_batch"])
def test_resume_compat_matches_reference(ref, solver_run, change):
    us = solver_run.us
    overrides = ["mesh.dp=1", "pipeline_schedule=solver", f"virtual_stages={us.virtual_stages}",
                 f"output_dir={solver_run.run_dir}"] + change
    t_report = t_pf.resume_compat(load_config(solver_run.config, overrides))
    r_report = ref.pf.resume_compat(ref.cfgload.load_config(solver_run.config, overrides))
    assert t_report is not None and t_report["resume_step"] == SOLVER_STEPS
    assert t_report == r_report


def test_cli_runs_through_python_m():
    proc = subprocess.run([sys.executable, "-m", "llama_pipeline_parallel_tpu_torch.tools.preflight",
                           "--config", "conf/tiny_smoke.yaml", "--hbm-gb", "80"],
                          cwd=REPO, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "preflight OK" in proc.stdout and "byte model" in proc.stdout


def test_no_card_no_budget_and_no_measurement(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("holds the tool's refusals where there is no card")
    config = os.path.join(REPO, "conf", "tiny_smoke.yaml")
    with pytest.raises(SystemExit) as e:
        t_pf.main(["--config", config])
    assert e.value.code != 0
    assert "--hbm-gb" in capsys.readouterr().err
    for flag in ("--calibrate", "--memory-audit"):
        with pytest.raises(SystemExit, match="torch.cuda.is_available"):
            t_pf.main(["--config", config, "--hbm-gb", "80", flag])
    assert t_pf.main(["--all", os.path.join(REPO, "conf", "tiny*.yaml"), "--hbm-gb", "80"]) == 0
    assert t_pf.main(["--all", os.path.join(REPO, "conf", "tiny*.yaml"),
                      "--hbm-gb", "0.000001"]) == 1


def test_rank_step_measurement_runs_the_trainer_step_on_the_cpu():
    """measure_rank_step's path off the card (its memory readings are the
    card's): a tp rank's slices of the tiny model step and give a finite
    loss."""
    cfg = load_config(os.path.join(REPO, "conf", "tiny_smoke.yaml"), ["mesh.tp=2"])
    got = t_pf.measure_rank_step(cfg, 1, device="cpu")
    assert got["layers"] == 1 and np.isfinite(got["loss"]) and "peak_bytes" not in got
    rows = t_pf._rank_model_gib(cfg, 2)
    assert rows["params_grads_optimizer_gib"] > 0 and rows["port_activations_gib"] > 0
