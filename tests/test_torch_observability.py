"""The port's observability layer against the JAX package's, on the CPU at
the `tiny` preset in fp32: spans, goodput and health.json (utils/trace.py),
the perf ledger (utils/perf.py), the timeline's plan (utils/timeline.py),
the memory watch's forensics (utils/memwatch.py), the trainer's wiring of
them and of the numerics monitor, and the four report tools.

Limits:
- the stdlib copies (perf, the RunClock, the traceparent helpers) give the
  reference's outputs exactly;
- SegmentPlan labels, stats and analytic bubble equal for flat 1F1B,
  interleaved v 2 and zb1, and the collector's record equal on the same
  marks;
- a 3-step `run_training` of both trainers from the same weights (the
  reference's init, warm-started), with a `grad_nonfinite` rule at the
  second step and the timeline, memory watch and profile window on, on the
  on-card optimizer (pp 2) and on the host optimizer (pp 1): numerics.jsonl
  record by record (the same keys, nonfinite flags and counters, every
  finite stat within the train step's rtol 1e-4), the same span names and
  depths, the same health.json keys, the same file set and record keys,
  and final params within 2e-5 (the train step's, tests/test_torch_training.py);
- the four tools (`python -m llama_pipeline_parallel_tpu_torch.tools.*`)
  print the same sections and keys on the reference's run directory as on
  the port's.
The reference on this jax records no timeline marks on the CPU (its
records carry no segments), so the port's timeline-measured fields are
checked against the plan, not against the reference's run.
"""

import importlib
import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from llama_pipeline_parallel_tpu_torch import convert
from llama_pipeline_parallel_tpu_torch import train as t_train
from llama_pipeline_parallel_tpu_torch.ckpt import checkpoint as t_ckpt
from llama_pipeline_parallel_tpu_torch.ckpt import tensor_io
from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig as TConfig
from llama_pipeline_parallel_tpu_torch.models.llama.manifest import StageManifest as TManifest
from llama_pipeline_parallel_tpu_torch.parallel import pipeline as t_pl
from llama_pipeline_parallel_tpu_torch.utils import config as t_config
from llama_pipeline_parallel_tpu_torch.utils import memwatch as t_mem
from llama_pipeline_parallel_tpu_torch.utils import numerics as t_num
from llama_pipeline_parallel_tpu_torch.utils import perf as t_perf
from llama_pipeline_parallel_tpu_torch.utils import timeline as t_tl
from llama_pipeline_parallel_tpu_torch.utils import trace as t_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAT_RTOL = 1e-4
PARAMS_ATOL = 2e-5
LOSS_RTOL = 1e-5
# spans whose count depends on thread timing, not on the run
TIMING_SPANS = {"prefetch_stall"}


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
    mods = {"perf": "utils.perf", "trace": "utils.trace", "tl": "utils.timeline",
            "mem": "utils.memwatch", "pl": "parallel.pipeline", "train": "train",
            "ckpt": "ckpt.checkpoint", "llama": "models.llama.model",
            "config": "models.llama.config", "manifest": "models.llama.manifest"}
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"llama_pipeline_parallel_tpu.{v}") for k, v in mods.items()})


# ---------------------------------------------------------------------------
# the stdlib copies and the plan
# ---------------------------------------------------------------------------

ROWS = [
    {"metric": "mfu", "measured": 0.41, "unit": "fraction", "run": "a"},
    {"metric": "mfu", "measured": 0.005, "run": "b"},
    {"metric": "mfu", "measured": 0.43, "run": "c", "context": {"backend": "cpu"}},
    {"metric": "host_bw_gibps", "measured": 11.5, "run": "a"},
    {"metric": "host_bw_gibps", "measured": 0.0, "run": "b"},
    {"metric": "mem_peak_gib", "model": 10.0, "measured": 12.5, "unit": "GiB", "run": "a"},
    {"metric": "bubble_fraction", "model": 0.2, "measured": float("nan"), "run": "a"},
    {"metric": "bench_round", "reason": "unreachable", "run": "r01"},
]


def test_perf_summarize_and_calibration_match_reference(ref, tmp_path):
    """summarize, derive_calibration and the jsonl round trip of the copy
    give the reference's outputs on the same rows (timestamps aside)."""
    want, got = ref.perf.summarize(ROWS), t_perf.summarize(ROWS)
    assert got == want
    cw, cg = ref.perf.derive_calibration(ROWS), t_perf.derive_calibration(ROWS)
    cw.pop("generated_at"), cg.pop("generated_at")
    assert cg == cw and "mem_scale" in cg and "mfu" in cg
    rows = [t_perf.make_row("step_time_s", measured=1.5, unit="s", run="x", p95=2.0),
            t_perf.make_row("bench_round", reason="no chip")]
    assert t_perf.append_rows(str(tmp_path / "perf.jsonl"), rows) == 2
    with open(tmp_path / "perf.jsonl", "a") as f:
        f.write('{"torn": \n')
    got = t_perf.read_ledger(str(tmp_path / "perf.jsonl"))
    want = ref.perf.read_ledger(str(tmp_path / "perf.jsonl"))
    assert got == want and [r["metric"] for r in got] == ["step_time_s", "bench_round"]


def test_run_clock_buckets_and_traceparent_match_reference(ref):
    """The same span records (top-level main-thread ones counted, nested and
    background ones not) into both RunClocks with the same prior: the same
    buckets and goodput; the traceparent helpers agree."""
    prior = {"elapsed": 10.0, "buckets": {"train": 6.0, "init": 1.0, "untracked": 3.0}}
    spans = [{"name": "data_wait", "depth": 0, "main_thread": True, "dur": 0.5},
             {"name": "step_dispatch", "depth": 0, "main_thread": True, "dur": 2.0},
             {"name": "prefetch_stall", "depth": 1, "main_thread": True, "dur": 0.4},
             {"name": "ckpt_commit", "depth": 0, "main_thread": False, "dur": 3.0},
             {"name": "ckpt_save", "depth": 0, "main_thread": True, "dur": 1.0},
             {"name": "compile_block", "depth": 0, "main_thread": True, "dur": 4.0},
             {"name": "eval", "depth": 0, "main_thread": True, "dur": 0.25}]
    clocks = [mod.RunClock(prior=prior, already_elapsed=1.0) for mod in (ref.trace, t_trace)]
    for clock in clocks:
        clock.add("init", 0.5)
        for s in spans:
            clock.on_span(dict(s))
    assert clocks[0].buckets == clocks[1].buckets
    assert clocks[1].buckets["train"] == 8.0 and clocks[1].buckets["data_stall"] == 0.5
    header = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
    for h in (header, header.upper(), "garbage", None, "00-" + "0" * 32 + "-" + "cd" * 8 + "-01"):
        assert t_trace.parse_traceparent(h) == ref.trace.parse_traceparent(h)
    assert t_trace.format_traceparent("a" * 32, "b" * 16) == ref.trace.format_traceparent(
        "a" * 32, "b" * 16)


PLAN_CASES = {"1f1b": dict(schedule="1f1b"),
              "interleaved-v2": dict(schedule="interleaved_1f1b", virtual_stages=2),
              "zb1": dict(schedule="zb1")}


@pytest.mark.parametrize("case", list(PLAN_CASES), ids=list(PLAN_CASES))
def test_segment_plan_and_record_match_reference(ref, case):
    """SegmentPlan of pp 4, 8 microbatches: the same segment labels, stats
    and analytic bubble; both collectors fed the same marks (each segment a
    stage's time, stage 2 the straggler, an optimizer mark) give the same
    record, wall time aside."""
    kw = PLAN_CASES[case]
    want = ref.tl.SegmentPlan(ref.pl.PipelineConfig(num_stages=4, num_microbatches=8, **kw))
    got = t_tl.SegmentPlan(t_pl.PipelineConfig(num_stages=4, num_microbatches=8, **kw))
    assert got.stats == want.stats
    assert got.analytic_bubble == want.analytic_bubble
    n = len(got.stats)
    assert [got.label_of(b) for b in range(n + 2)] == [want.label_of(b) for b in range(n + 2)]
    marks = [(b, s, 0.1 * b + (0.03 * b if s == 2 else 0.01 * s)) for b in range(n + 1)
             for s in range(4)] + [(t_tl.OPTIMIZER_BOUNDARY, 0, 0.2 * n + 1.0)]
    records = []
    for mod, plan in ((ref.tl, want), (t_tl, got)):
        collector = mod.TimelineCollector(plan)
        collector.begin_step(5)
        collector._marks = list(marks)
        rec = collector.end_step(5)
        rec.pop("wall_s")
        records.append(rec)
    assert records[1] == records[0] and records[1]["straggler_stage"] == 2


def test_oom_snapshot_matches_reference(ref, tmp_path):
    """An allocation failure's snapshot: the same keys as the reference's,
    read back by both readers; the injected fault's error and the card's
    OutOfMemoryError are both recognised."""
    watch = t_mem.MemoryWatch(str(tmp_path / "p"), every=1)
    watch.sample(1)
    t_mem.dump_oom_snapshot(str(tmp_path / "p"), 1, t_mem.oom_error(1), memwatch=watch)
    ref.mem.dump_oom_snapshot(str(tmp_path / "r"), 1, RuntimeError("RESOURCE_EXHAUSTED: x"),
                              memwatch=ref.mem.MemoryWatch(str(tmp_path / "r")))
    got = t_mem.read_oom_snapshots(str(tmp_path / "p"))
    want = ref.mem.read_oom_snapshots(str(tmp_path / "r"))
    assert len(got) == len(want) == 1 and set(got[0]) == set(want[0])
    assert set(got[0]["memwatch"]) == set(want[0]["memwatch"])
    assert t_mem.is_resource_exhausted(t_mem.oom_error(3))
    assert t_mem.is_resource_exhausted(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert not t_mem.is_resource_exhausted(ValueError("shape"))


# ---------------------------------------------------------------------------
# both trainers, 3 steps, a nonfinite step
# ---------------------------------------------------------------------------

PATHS = {"device": dict(pp=2, overrides=["profile_steps=[1,2]"]),
         "host": dict(pp=1, overrides=["optimizer_offload=true"])}


def _cfg(root, name, pp, *overrides):
    return t_config.load_config(os.path.join(REPO, "conf", "tiny_smoke.yaml"), [
        "mesh.dp=1", f"mesh.pp={pp}", "max_steps=3", "total_steps=8", "warmup_steps=1",
        "logging_steps=1", "dataset.pseudo_dataset_len=64", f"output_dir={root}/{name}",
        "save_final=true", "resume=false", "health_interval=0.5",
        "timeline={enabled: true}", "memory={enabled: true}",
        "fault_plan={faults: [{site: step, op: grad_nonfinite, at_step: 1, "
        f"stage: {pp - 1}}}]}}", *overrides])


@pytest.fixture(scope="module", params=list(PATHS))
def runs(ref, request, tmp_path_factory):
    """(path, reference dir, port dir, port Run) after both trainers ran the
    same 3 steps from the reference's init."""
    path = request.param
    pp, extra = PATHS[path]["pp"], PATHS[path]["overrides"]
    root = tmp_path_factory.mktemp(path)
    cfg_j = ref.config.LlamaConfig.tiny()
    tree = ref.llama.init_params(jax.random.PRNGKey(4), cfg_j)
    one = ref.manifest.StageManifest.for_config(cfg_j, 1)
    ref.ckpt.CheckpointManager(str(root / "warm_ref")).save(
        0, ref.pl.stack_stages(tree, one), one, cfg_j)
    t_ckpt.CheckpointManager(str(root / "warm_port")).save(
        0, convert.params_from_jax(jax.device_get(tree)),
        TManifest(num_layers=cfg_j.num_hidden_layers, num_stages=1), TConfig.tiny())
    ref.train.run_training(_cfg(root, "ref", pp, f"model_name_or_path={root}/warm_ref", *extra))
    run = t_train.build_run(_cfg(root, "port", pp, f"model_name_or_path={root}/warm_port",
                                 *extra), device="cpu")
    t_train.train_run(run)
    t_trace.configure(None)
    return path, str(root / "ref"), str(root / "port"), run


def _jsonl(path):
    return [json.loads(line) for line in open(path)]


def _stat_close(got, want, what):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _stat_close(g, w, f"{what}[{i}]")
        return
    g, w = t_num.stat_to_float(got), t_num.stat_to_float(want)
    assert np.isfinite(g) == np.isfinite(w), f"{what}: {got} vs {want}"
    if np.isfinite(w):
        np.testing.assert_allclose(g, w, rtol=STAT_RTOL, atol=1e-7, err_msg=what)


def test_numerics_records_match_reference(runs):
    """numerics.jsonl: three records with the same keys, the same nonfinite
    flags and anomalies (step 2, poisoned), every stat within rtol 1e-4; the
    metrics lines carry the same counters and goodput."""
    _, ref_dir, port_dir, _ = runs
    want, got = _jsonl(f"{ref_dir}/numerics.jsonl"), _jsonl(f"{port_dir}/numerics.jsonl")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    for g, w in zip(got, want):
        assert set(g) == set(w), (g.keys(), w.keys())
        assert g["nonfinite"] == w["nonfinite"] and g.get("anomaly") == w.get("anomaly")
        for key in set(w) - {"ts", "step", "nonfinite", "anomaly"}:
            _stat_close(g[key], w[key], f"step {w['step']} {key}")
    assert [r["nonfinite"] for r in got] == [False, True, False]
    assert os.path.exists(f"{port_dir}/numerics-snapshot-2.json")
    lines = {m: [r for r in _jsonl(f"{d}/metrics.jsonl") if "loss" in r]
             for m, d in (("ref", ref_dir), ("port", port_dir))}
    for g, w in zip(lines["port"], lines["ref"]):
        assert g["nonfinite_steps"] == w["nonfinite_steps"]
        assert g["anomaly_count"] == w["anomaly_count"]
        assert set(w) - set(g) <= {"offload_stash"} and 0 <= g["goodput"] <= 1
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)


def test_spans_health_and_files_match_reference(runs):
    """spans.jsonl: the same (name, depth, parent) set; health.json: the
    same keys (the timeline's measured bubble aside, which the reference's
    CPU run cannot measure) and the same counters; the same output files;
    memory.jsonl samples and timeline.jsonl records with the reference's
    keys; a torch.profiler trace under profile/ where the window was set."""
    path, ref_dir, port_dir, _ = runs

    def shape(d):
        return {(s["name"], s["depth"], s["parent"]) for s in _jsonl(f"{d}/spans.jsonl")
                if s["name"] not in TIMING_SPANS}

    assert shape(port_dir) == shape(ref_dir)
    want = json.load(open(f"{ref_dir}/health.json"))
    got = json.load(open(f"{port_dir}/health.json"))
    assert set(want) <= set(got) and set(got) - set(want) <= {"bubble_fraction_measured"}
    assert set(got["topology"]) == set(want["topology"])
    assert set(got["clock"]["buckets"]) == set(want["clock"]["buckets"])
    for key in ("last_step", "nonfinite_steps", "anomaly_count"):
        assert got[key] == want[key], key
    files = {d: {f for f in os.listdir(d) if not f.startswith("checkpoint-")}
             for d in (ref_dir, port_dir)}
    assert files[port_dir] == files[ref_dir]
    samples = {d: [r for r in _jsonl(f"{d}/memory.jsonl") if r["kind"] == "sample"]
               for d in (ref_dir, port_dir)}
    assert [set(r) for r in samples[port_dir]] == [set(r) for r in samples[ref_dir]]
    tl_ref, tl_port = _jsonl(f"{ref_dir}/timeline.jsonl"), _jsonl(f"{port_dir}/timeline.jsonl")
    assert len(tl_port) == len(tl_ref) == 3
    for g, w in zip(tl_port, tl_ref):
        assert set(w) - {"segments", "pipeline_s", "optimizer_s"} <= set(g)
        assert g["bubble_fraction_analytic"] == w["bubble_fraction_analytic"]
        assert set(g["host_segments"] if "host_segments" in w else {}) == set(
            w.get("host_segments", {}))
    if path == "device":
        plan_labels = {"F", "F+B", "B"}
        for g in tl_port:
            assert set(g["segments"]) <= plan_labels and 0 <= g["bubble_fraction_measured"] < 1
        traces = [f for _, _, fs in os.walk(f"{port_dir}/profile") for f in fs
                  if f.endswith(".pt.trace.json")]
        assert traces


def test_final_params_match_reference(runs):
    """The final params (the nonfinite step skipped on both sides) within
    2e-5 of the reference's checkpoint, and finite."""
    _, ref_dir, _, run = runs
    from llama_pipeline_parallel_tpu.ckpt import checkpoint as ref_ckpt

    jtree, _, _, _ = ref_ckpt.load_module_checkpoint(ref_dir)
    tree = run.canonical_of(run.host.masters_tree() if run.host is not None
                            else run.state.params)
    for k, v in convert.params_from_jax(jax.device_get(jtree)).items():
        got = tree[k].make() if isinstance(tree[k], tensor_io.Lazy) else tree[k].detach()
        assert torch.isfinite(got).all(), k
        np.testing.assert_allclose(got.numpy(), v.numpy(), rtol=0, atol=PARAMS_ATOL, err_msg=k)


def _tool(name, *args):
    out = subprocess.run([sys.executable, "-m", f"llama_pipeline_parallel_tpu_torch.tools.{name}",
                          *args], capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def _sections(text):
    return [line.split(":")[0] for line in text.splitlines() if line.startswith("==")]


def test_report_tools_read_both_run_directories(runs, tmp_path):
    """goodput_report --json and numerics_report --json give the same keys
    (and the same numerics verdicts) on the reference's run directory as on
    the port's; their tables the same sections; perf_report the same table
    header and calibration keys; trace_summary reads the port's
    torch.profiler capture (and the reference's, where it wrote one)."""
    path, ref_dir, port_dir, _ = runs
    reps = {d: json.loads(_tool("goodput_report", d, "--json")) for d in (ref_dir, port_dir)}
    assert set(reps[port_dir]) == set(reps[ref_dir])
    assert set(reps[port_dir]["buckets"]) == set(reps[ref_dir]["buckets"])
    assert reps[port_dir]["numerics"] == reps[ref_dir]["numerics"]
    assert reps[port_dir]["numerics"]["first_nonfinite_step"] == 2
    assert _sections(_tool("goodput_report", port_dir)) == _sections(
        _tool("goodput_report", ref_dir))
    nums = {d: json.loads(_tool("numerics_report", d, "--json")) for d in (ref_dir, port_dir)}
    assert set(nums[port_dir]) == set(nums[ref_dir])
    assert nums[port_dir]["first_nonfinite"] == nums[ref_dir]["first_nonfinite"]
    assert _sections(_tool("numerics_report", port_dir)) == _sections(
        _tool("numerics_report", ref_dir))
    calib = {}
    for d in (ref_dir, port_dir):
        text = _tool("perf_report", d, "--emit-calibration", str(tmp_path / "c.json"))
        assert text.splitlines()[0].split() == ["metric", "model", "measured", "err%", "n",
                                                "drift", "unit"]
        calib[d] = set(json.load(open(tmp_path / "c.json")))
    assert calib[port_dir] == calib[ref_dir]
    if path == "device":
        text = _tool("trace_summary", f"{port_dir}/profile", "--top", "3")
        assert text.startswith("trace: ") and "\n== " in text
        text = _tool("trace_summary", f"{ref_dir}/profile", "--top", "3")
        assert text.startswith("trace: ") and "\n== " in text


# ---------------------------------------------------------------------------
# the halt, the OOM drill, the import hygiene
# ---------------------------------------------------------------------------

def _tiny(root, name, *overrides):
    return t_config.load_config(os.path.join(REPO, "conf", "tiny_smoke.yaml"), [
        "mesh.dp=1", "mesh.pp=1", "max_steps=3", "total_steps=8", "warmup_steps=1",
        "logging_steps=1", "dataset.pseudo_dataset_len=64", f"output_dir={root}/{name}",
        "resume=false", *overrides])


def test_halt_on_nonfinite_checkpoints_then_raises(tmp_path):
    """numerics.halt_on_nonfinite with a grad_nonfinite rule at the second
    step: run_training raises NonfiniteHaltError one step later, after a
    final checkpoint of the last completed step whose params are finite."""
    cfg = _tiny(tmp_path, "halt", "numerics={halt_on_nonfinite: true}",
                "fault_plan={faults: [{site: step, op: grad_nonfinite, at_step: 1}]}")
    with pytest.raises(t_num.NonfiniteHaltError, match="step 2"):
        t_train.run_training(cfg, device="cpu")
    mgr = t_ckpt.CheckpointManager(str(tmp_path / "halt"))
    assert mgr.latest_step() == 3
    params = {n: torch.empty(s) for n, s in
              __import__("llama_pipeline_parallel_tpu_torch.models.llama.model",
                         fromlist=["param_shapes"]).param_shapes(TConfig.tiny()).items()}
    mgr.load_params(3, params)
    assert all(torch.isfinite(t).all() for t in params.values())


def test_oom_fault_writes_snapshot_and_raises(tmp_path):
    """An `oom` rule at the second step: the run raises the allocation
    failure after writing one snapshot under oom/ (with the memory watch's
    recent rows), and goodput_report shows it."""
    cfg = _tiny(tmp_path, "oom", "memory={enabled: true}", "profiler={zscore: 0}",
                "fault_plan={faults: [{site: step, op: oom, at_step: 1}]}")
    with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
        t_train.run_training(cfg, device="cpu")
    snaps = t_mem.read_oom_snapshots(str(tmp_path / "oom"))
    assert len(snaps) == 1 and snaps[0]["step"] == 1
    assert [r["step"] for r in snaps[0]["memwatch"]["recent"]] == [1]
    rep = json.loads(_tool("goodput_report", str(tmp_path / "oom"), "--json"))
    assert rep["oom"]["snapshots"] == 1


def test_port_imports_nothing_of_jax():
    """No module of the port, and nothing in chip_smoke.py, imports jax or
    the JAX package (parsed with ast: every import statement)."""
    import ast

    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "llama_pipeline_parallel_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(open(path).read(), path)):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                    node.func, "id", None)) in ("import_module", "__import__")
                    and node.args and isinstance(node.args[0], ast.Constant)):
                mods = [str(node.args[0].value)]
            bad += [(os.path.relpath(path, REPO), m) for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib", "llama_pipeline_parallel_tpu")]
    assert len(files) > 50 and not bad, bad
