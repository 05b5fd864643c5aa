"""Helpers of the port's supervised end-to-end tests (tests/test_torch_supervisor.py,
tests/test_torch_actions.py): the tiny_smoke trainer through the CLI, under
`python -m torch.distributed.run` or alone, and what its run directory says."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 6
GLOBAL_BATCH = 8  # 2 rows x 2 microbatches x dp 2, or 2 x 4 x dp 1
# the ladder of the supervised runs: 2 ranks, then 1 with the global batch kept
LADDER = [{"name": "dp2", "devices": 2, "overrides": []},
          {"name": "dp1", "devices": 1,
           "overrides": ["mesh.dp=1", "gradient_accumulation_steps=4"]}]


def free_port() -> int:
    """tests/test_torch_pipeline._free_port: a port below the ephemeral range."""
    from tests.test_torch_pipeline import _free_port

    return _free_port()


def cli_args(out: str, *extra: str) -> list[str]:
    """The CLI's arguments: tiny_smoke at pp 1 x dp 2, 6 steps, a save every
    2, the sample ledger, the stop votes every step."""
    return ["-m", "llama_pipeline_parallel_tpu_torch.cli", "--config", "conf/tiny_smoke.yaml",
            "--device", "cpu", "mesh.pp=1", "mesh.dp=2", f"output_dir={out}",
            f"max_steps={STEPS}", f"total_steps={STEPS}", "save_steps=2", "logging_steps=1",
            "save_final=true", "preempt_check_every=1", "data.log_sample_ids=true", *extra]


def launcher(out: str, *extra: str) -> list[str]:
    """The training command under torch.distributed.run at 2 processes (the
    supervisor sets --nproc_per_node from the rung)."""
    return [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
            "--master_port", str(free_port()), *cli_args(out, *extra)]


def env(**extra: str) -> dict:
    return {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
            "LPT_RETRY_BASE_DELAY_S": "0.01", **extra}


def straight_run(out: str) -> None:
    """The same global batch in one process at dp 1, uninterrupted."""
    proc = subprocess.run([sys.executable, *cli_args(out, *LADDER[1]["overrides"])],
                          cwd=REPO, env=env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


def jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def dedup_ledger(out: str) -> dict:
    """{(epoch, batch): sorted ids} of the trained batches, the last row of a
    batch winning (a resumed incarnation re-trains the batches after its
    checkpoint; the prefetcher's rows past the last step were never trained)."""
    return {(r["epoch"], r["batch"]): sorted(r["indices"])
            for r in jsonl(os.path.join(out, "samples.jsonl"))
            if r["epoch"] == 0 and r["batch"] < STEPS}


def losses(out: str) -> dict:
    """step -> loss of the metrics lines, the last line of a step winning."""
    return {r["step"]: r["loss"] for r in jsonl(os.path.join(out, "metrics.jsonl"))
            if "loss" in r}
