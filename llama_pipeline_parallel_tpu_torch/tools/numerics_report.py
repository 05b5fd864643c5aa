"""Offline view of a run's numerics stream (`<output_dir>/numerics.jsonl`).

The training-dynamics counterpart of tools/goodput_report.py: where that
tool answers "where did wall-clock go", this one answers "what did the
optimization do" — per-stage norm trajectories, the anomaly timeline, and
first-nonfinite localization to a pipeline stage / layer-group (from the
per-step records plus the `numerics-snapshot-<step>.json` the monitor
dumps on each anomaly — utils/numerics.py, docs/OBSERVABILITY.md).

Usage:
  python -m llama_pipeline_parallel_tpu_torch.tools.numerics_report <output_dir>
      [--json] [--top 5]

The counterpart of the JAX package's tools/numerics_report.py: the same
sections and keys over the port's numerics.jsonl and snapshots.

Follows the track-summary conventions of the sibling tools: one
`== section ==` per table; degrades (never tracebacks) on torn/missing
artifacts from a crashed run.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os


def _num(v) -> float:
    """jsonl stat value -> float, via the writer's own codec (the monitor
    spells nonfinite floats as 'inf'/'-inf'/'nan' strings); junk from a
    torn line degrades to NaN."""
    from llama_pipeline_parallel_tpu_torch.utils.numerics import stat_to_float

    try:
        return stat_to_float(v)
    except (TypeError, ValueError):
        return math.nan


def load_records(output_dir: str) -> list[dict]:
    from llama_pipeline_parallel_tpu_torch.utils.perf import read_jsonl as load_jsonl

    recs = [r for r in load_jsonl(os.path.join(output_dir, "numerics.jsonl"))
            if isinstance(r, dict) and "step" in r]
    # numerics.jsonl appends across incarnations: a resume re-runs the steps
    # after its checkpoint, so a step can have several records. The LAST one
    # is the surviving timeline (the run the checkpoints continue from) —
    # keep it, like the metrics/incarnation readers treat their streams.
    by_step: dict = {}
    for r in recs:
        by_step[r["step"]] = r
    return [by_step[s] for s in sorted(by_step)]


def stage_trajectories(records: list[dict],
                       field: str = "grad_norm_per_stage") -> list[dict]:
    """Per-stage summary of one per-stage field over the run: first/last/
    max finite value + nonfinite step count."""
    series: dict[int, list] = {}
    for r in records:
        vals = r.get(field)
        if not isinstance(vals, list):
            continue
        for s, v in enumerate(vals):
            series.setdefault(s, []).append((r["step"], _num(v)))
    out = []
    for s in sorted(series):
        pts = series[s]
        finite = [v for _, v in pts if math.isfinite(v)]
        out.append({
            "stage": s,
            "steps": len(pts),
            "first": finite[0] if finite else None,
            "last": finite[-1] if finite else None,
            "max": max(finite) if finite else None,
            "nonfinite_steps": sum(1 for _, v in pts if not math.isfinite(v)),
        })
    return out


def anomaly_timeline(records: list[dict]) -> list[dict]:
    return [{"step": r["step"], "kinds": r.get("anomaly"),
             "z_loss": r.get("z_loss"), "z_grad": r.get("z_grad"),
             "loss": r.get("loss"), "grad_norm": r.get("grad_norm")}
            for r in records if r.get("anomaly")]


def first_nonfinite(records: list[dict], output_dir: str) -> dict | None:
    """Localize the FIRST nonfinite step to a pipeline stage (from the
    per-stage vectors in the step record) and, when the anomaly snapshot
    exists, to the layer-groups whose gradients went nonfinite."""
    for r in records:
        if not r.get("nonfinite"):
            continue
        loc: dict = {"step": r["step"]}
        stages = set()
        for field in ("grad_norm_per_stage", "act_absmax_per_stage"):
            vals = r.get(field)
            if isinstance(vals, list):
                stages |= {s for s, v in enumerate(vals)
                           if not math.isfinite(_num(v))}
        loc["stages"] = sorted(stages)
        snap_path = os.path.join(output_dir, f"numerics-snapshot-{r['step']}.json")
        if os.path.exists(snap_path):
            try:
                with open(snap_path) as f:
                    snap = json.load(f)
            except (OSError, ValueError):
                snap = None
            if isinstance(snap, dict):
                groups = []
                for name, vals in (snap.get("grad_absmax_per_group") or {}).items():
                    if isinstance(vals, list) and any(
                            not math.isfinite(_num(v)) for v in vals):
                        groups.append(name)
                for name, v in (snap.get("replicated_groups") or {}).items():
                    if not math.isfinite(_num(v)):
                        groups.append(name)
                loc["groups"] = sorted(groups)
                loc["snapshot"] = os.path.basename(snap_path)
        return loc
    return None


def build_report(output_dir: str, top: int = 5) -> dict:
    records = load_records(output_dir)
    if not records:
        raise SystemExit(
            f"no numerics records under {output_dir} (numerics.jsonl missing "
            f"or empty — was the run started with numerics.enabled: false?)")
    anomalies = anomaly_timeline(records)
    return {
        "output_dir": output_dir,
        "records": len(records),
        "first_step": records[0]["step"],
        "last_step": records[-1]["step"],
        "nonfinite_steps": sum(1 for r in records if r.get("nonfinite")),
        "anomaly_count": len(anomalies),
        "anomalies": anomalies[:top],
        "first_nonfinite": first_nonfinite(records, output_dir),
        "grad_norm_per_stage": stage_trajectories(records, "grad_norm_per_stage"),
        "param_norm_per_stage": stage_trajectories(records, "param_norm_per_stage"),
        "act_rms_per_stage": stage_trajectories(records, "act_rms_per_stage"),
        "act_absmax_per_stage": stage_trajectories(records, "act_absmax_per_stage"),
        "snapshots": sorted(os.path.basename(p) for p in glob.glob(
            os.path.join(output_dir, "numerics-snapshot-*.json"))),
    }


def _fmt(v) -> str:
    return "-" if v is None else f"{v:.4g}"


def print_report(rep: dict) -> None:
    print(f"run: {rep['output_dir']}  ({rep['records']} numerics records, "
          f"steps {rep['first_step']}..{rep['last_step']})")
    print(f"  nonfinite steps: {rep['nonfinite_steps']}   anomalies: "
          f"{rep['anomaly_count']}")

    loc = rep.get("first_nonfinite")
    if loc:
        stages = ",".join(map(str, loc.get("stages", []))) or "?"
        groups = ",".join(loc.get("groups", [])) or "(no snapshot detail)"
        print(f"\n== first nonfinite ==\n  step {loc['step']}: pipeline "
              f"stage(s) {stages}; layer-group(s) {groups}")

    if rep["anomalies"]:
        print("\n== anomaly timeline ==")
        for a in rep["anomalies"]:
            zs = " ".join(f"{k}={a[k]}" for k in ("z_loss", "z_grad")
                          if a.get(k) is not None)
            print(f"  step {a['step']:<6} {','.join(a['kinds']):<24} "
                  f"loss={a['loss']} grad_norm={a['grad_norm']} {zs}")

    for field in ("grad_norm_per_stage", "param_norm_per_stage",
                  "act_rms_per_stage", "act_absmax_per_stage"):
        rows = rep.get(field)
        if not rows:
            continue
        print(f"\n== {field}: first -> last (max) ==")
        for row in rows:
            nf = (f"  NONFINITE x{row['nonfinite_steps']}"
                  if row["nonfinite_steps"] else "")
            print(f"  stage {row['stage']}:  {_fmt(row['first'])} -> "
                  f"{_fmt(row['last'])}  (max {_fmt(row['max'])}){nf}")

    if rep["snapshots"]:
        print(f"\n== anomaly snapshots ==\n  " + "\n  ".join(rep["snapshots"]))


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("output_dir", help="trainer output dir (holds numerics.jsonl)")
    p.add_argument("--top", type=int, default=5,
                   help="anomalies to list in the timeline")
    p.add_argument("--json", action="store_true",
                   help="emit the report as JSON instead of tables")
    args = p.parse_args(argv)
    rep = build_report(args.output_dir, top=args.top)
    if args.json:
        print(json.dumps(rep, indent=2))
    else:
        print_report(rep)


if __name__ == "__main__":
    main()
