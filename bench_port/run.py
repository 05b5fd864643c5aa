"""Run one cell of BENCHMARK.json once and print its result line.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks for.
The last line of standard output is the result (one JSON object); the last
lines of standard error are the compared numbers beside their limits. With
`--trace 0` the metrics are the cell's end-to-end metrics, with `--trace 1` its
per-layer metrics from a profiled window. Exits non-zero, printing no result,
without the cards, or when jax, jaxlib, flax or the JAX package was loaded.
Kernel builds and caches stay in `bench_port/build/` (fixed paths), so only a
checkout's first run compiles.
"""

from __future__ import annotations

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "llama_pipeline_parallel_tpu")


def environment() -> None:
    """Cache directories inside the checkout, no JAX through transformers, the
    checkout on the import path."""
    build = os.path.join(BENCH_DIR, "build")
    os.environ["LPT_TORCH_BUILD_DIR"] = os.path.join(build, "torch_kernels")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["USE_FLAX"] = os.environ["USE_JAX"] = "0"  # transformers, if anything loads it
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is one of FORBIDDEN."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    environment()

    import torch

    from bench_port import cells, compare, harness

    cell = cells.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench_port: {args.workload} needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T0)
    loaded = forbidden_modules()
    if loaded:
        print(f"bench_port: these modules were loaded: {loaded}", file=sys.stderr)
        return 3
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                         "count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"]}}
    reading = out["reading"]
    if args.trace:
        result["device"].update(busy_s=reading.trace.busy_s, window_s=reading.window_s)
        result["breakdown"] = harness.breakdown(reading.trace)
    result["checks"] = compare.checks(out["found"], cell.limits)
    sys.stdout.flush()
    for name, check in result["checks"].items():
        print(f"{name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
