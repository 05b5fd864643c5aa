"""The command's refusals, and what its process loads."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from bench_port import cells, run

CMD = [sys.executable, os.path.join("bench_port", "run.py"), "--workload",
       "mistral7b-stage.full-4k", "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run(CMD, cwd=cwd, capture_output=True, text=True, timeout=300)


def test_without_a_card_it_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    done = _run(cells.ROOT)
    assert done.returncode != 0
    assert done.stdout.strip() == ""
    assert "CUDA card" in done.stderr


def test_in_a_bare_checkout_it_fails_and_prints_no_result(tmp_path):
    shutil.copy(os.path.join(cells.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(cells.ROOT, "bench_port"), tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    done = _run(tmp_path)
    assert done.returncode != 0
    assert done.stdout.strip() == ""


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("llama_pipeline_parallel_tpu_torch", "llama_pipeline_parallel_tpu_torch.train",
                 "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "llama_pipeline_parallel_tpu.train", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax.numpy", "llama_pipeline_parallel_tpu.train"]


PROBE = """
import json, sys, time
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
import torch
from bench_port import run
run.environment()
{body}
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def _modules(body):
    code = PROBE.format(root=cells.ROOT, tests=os.path.dirname(__file__), body=body)
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert done.returncode == 0, done.stderr[-2000:]
    return set(json.loads(done.stdout.strip().splitlines()[-1]))


def test_a_whole_run_loads_neither_jax_nor_the_jax_package():
    loaded = _modules("""
from bench_port import harness
from tiny import tiny_cell
out = harness.run_cell(tiny_cell("mistral7b-stage.sft-packed-4k"), 2**31 + 3, 0.2,
                       True, torch.device("cpu"), time.monotonic())
assert out["correct"], out["found"]
""")
    assert "llama_pipeline_parallel_tpu_torch" in loaded
    assert not loaded & set(run.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    loaded = _modules("""
from bench_port.reference import train, packing, model, attention
from bench_port import generator, weights, tokenizer, compare, counts
""")
    assert not loaded & {"llama_pipeline_parallel_tpu_torch", *run.FORBIDDEN}
