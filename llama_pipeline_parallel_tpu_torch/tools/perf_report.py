"""Model-vs-measured calibration report over the perf ledger.

The counterpart of the JAX package's tools/perf_report.py, with its table
and its calibration file. Reads perf.jsonl rows (utils/perf.py schema —
written by the port's train.py with `timeline.enabled` or `memory.enabled`)
plus archived bench rounds (BENCH_r0*.json, error rounds included), and
prints:

- the **calibration table**: per metric, the analytic/model value next to
  its measured counterpart, the model error %, and the measured drift
  across runs;
- the **failure summary**: reason-tagged rows ("N rounds unreachable" —
  the standing TPU gap, summarized instead of silently dropped);
- with `--emit-calibration PATH`: the measured-constants JSON
  (`mfu`, `host_bw_gibps`, `ici_bw_gibps`, `mem_scale` — whichever the
  ledger holds) that `tools/preflight.py --select --calibration PATH`
  consumes to re-rank the layout/schedule frontier from measurements
  instead of CLI guesses — the analytic half of ROADMAP's "measured
  re-selection". `mem_scale` (live peak / byte-model peak, from the
  memory observatory's `mem_peak_gib` rows) scales the selector's
  est_peak_gib feasibility test.

Degrades, never tracebacks: missing/torn/garbage ledgers and archives
contribute whatever parses (the goodput_report house rule).

Usage:
  python -m llama_pipeline_parallel_tpu_torch.tools.perf_report
      <run_dir_or_perf.jsonl> ... [--bench BENCH_r01.json ...]
      [--bench-glob 'BENCH_r0*.json'] [--emit-calibration perf-calib.json]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import statistics
import sys

from llama_pipeline_parallel_tpu_torch.utils import perf


def collect_rows(paths: list[str], bench: list[str]) -> list[dict]:
    rows: list[dict] = []
    for p in paths:
        ledger = p if p.endswith(".jsonl") else os.path.join(p, "perf.jsonl")
        got = perf.read_ledger(ledger)
        if not got:
            print(f"note: no parseable rows under {ledger}", file=sys.stderr)
        rows.extend(got)
    for b in bench:
        rows.extend(perf.rows_from_bench_file(b))
    return rows


def _fmt(x: float | None, width: int = 10) -> str:
    if x is None:
        return "-".rjust(width)
    if x == 0 or 1e-3 <= abs(x) < 1e5:
        return f"{x:.4g}".rjust(width)
    return f"{x:.3e}".rjust(width)


def print_table(rows: list[dict]) -> None:
    summary = perf.summarize(rows)
    metrics = summary["metrics"]
    if metrics:
        print(f"{'metric':40s} {'model':>10s} {'measured':>10s} "
              f"{'err%':>8s} {'n':>4s} {'drift':>10s} {'unit':>6s}")
        for name in sorted(metrics):
            m = metrics[name]
            model = statistics.median(m["models"]) if m["models"] else None
            meas = statistics.median(m["measured"]) if m["measured"] else None
            err = ""
            if m["pairs"]:
                # median relative model error over rows carrying both halves
                errs = [(mo - me) / me * 100.0
                        for mo, me in m["pairs"] if me]
                if errs:
                    err = f"{statistics.median(errs):+.1f}"
            drift = None
            if len(m["measured"]) > 1:
                drift = statistics.pstdev(m["measured"])
            n = max(len(m["measured"]), len(m["models"]))
            print(f"{name[:40]:40s} {_fmt(model)} {_fmt(meas)} "
                  f"{err:>8s} {n:>4d} {_fmt(drift)} {m['unit']:>6s}")
    else:
        print("no model/measured rows")
    failures = summary["failures"]
    if failures:
        by_run: dict[str, str] = {}
        for row in failures:
            by_run.setdefault(row.get("run") or "?", str(row.get("reason")))
        print(f"\n{len(by_run)} round(s) produced no live number:")
        for run in sorted(by_run):
            print(f"  {run}: {by_run[run][:120]}")


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("runs", nargs="*",
                   help="run output dirs (or perf.jsonl paths)")
    p.add_argument("--bench", nargs="*", default=[],
                   help="bench summary JSON file(s) (bench.py output or "
                        "BENCH_r0*.json archives; error rounds summarize "
                        "as failures)")
    p.add_argument("--bench-glob", default=None,
                   help="glob of bench archives, e.g. 'BENCH_r0*.json'")
    p.add_argument("--emit-calibration", default=None, metavar="PATH",
                   help="write the measured-constants JSON for "
                        "`preflight --select --calibration PATH`")
    args = p.parse_args(argv)

    bench = list(args.bench)
    if args.bench_glob:
        bench += sorted(glob.glob(args.bench_glob))
    if not args.runs and not bench:
        p.error("nothing to read: pass run dirs and/or --bench/--bench-glob")
    rows = collect_rows(args.runs, bench)
    print_table(rows)

    if args.emit_calibration:
        calib = perf.derive_calibration(rows)
        usable = {k: v for k, v in calib.items()
                  if k in ("mfu", "host_bw_gibps", "ici_bw_gibps",
                           "mem_scale")}
        with open(args.emit_calibration, "w") as f:
            json.dump(calib, f, indent=2)
        if usable:
            print(f"\ncalibration written: {args.emit_calibration} "
                  f"({', '.join(f'{k}={v}' for k, v in usable.items())}) — "
                  f"feed it to `tools/preflight.py --select --calibration`")
        else:
            print(f"\ncalibration written: {args.emit_calibration} — no "
                  f"measured constants yet (no offload-bw/mfu rows in the "
                  f"ledger); preflight will keep its CLI assumptions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
