"""Per-run goodput/badput report from a trainer output dir.

Joins the span stream (`spans.jsonl`, written by utils/trace.py) with the
scalar stream (`metrics.jsonl`) into the operational picture a run
lives or dies on: where wall-clock went (time-bucket table), which logging
windows were slowest, and how bad the input-pipeline stalls were — offline,
after the run, no profiler capture needed (the Perfetto window covers a few
steps; the span stream covers the whole run).

Usage:
  python -m llama_pipeline_parallel_tpu_torch.tools.goodput_report <output_dir>
      [--top 5] [--json]

The counterpart of the JAX package's tools/goodput_report.py: the same
sections and keys, over the port's run directories (spans.jsonl,
metrics.jsonl, health.json, numerics.jsonl, oom/). Follows trace_summary's
track-summary conventions: one `== section ==` per table, durations in ms/s
with percentages against the section total.
"""

from __future__ import annotations

import argparse
import json
import os

# the serving counters a serve process's metrics line carries (the
# reference's serve/telemetry.SERVE_COUNTER_KEYS, the one spelling)
SERVE_COUNTER_KEYS = ("requests_completed", "requests_rejected",
                      "requests_failed", "requests_page_refused",
                      "requests_abandoned", "slo_breaches",
                      "tokens_generated")


def load_jsonl(path: str) -> list[dict]:
    """THE tolerant jsonl reader — `perf.read_jsonl`, spelled once for the
    whole repo: a crashed writer (the whole reason this tool exists) can
    leave a truncated tail or garbage line in any run artifact, and every
    reader must degrade to whatever parses, never traceback."""
    from llama_pipeline_parallel_tpu_torch.utils.perf import read_jsonl

    return read_jsonl(path)


def wall_window(spans: list[dict]) -> tuple[float, float]:
    """(first span start, last span end) over MAIN-THREAD spans — the run's
    observed wall window. The trainer emits a retroactive `init` span from
    trace.configure(), so the window opens at run start; background spans
    (async checkpoint commits) are excluded, matching the bucket rules."""
    main = [s for s in spans if s.get("main_thread", True)]
    if not main:
        raise SystemExit("no spans to report on")
    return (min(s["ts"] for s in main),
            max(s.get("end", s["ts"] + s.get("dur", 0.0)) for s in main))


def bucket_table(spans: list[dict]) -> dict[str, float]:
    """Seconds per RunClock bucket, recomputed from the span stream with the
    SAME rules the live clock applies (top-level, main-thread spans only —
    utils/trace.SPAN_BUCKETS), plus `untracked` as the wall remainder, so
    the table's sum IS the run's wall-clock."""
    from llama_pipeline_parallel_tpu_torch.utils.trace import SPAN_BUCKETS

    t0, t1 = wall_window(spans)
    buckets: dict[str, float] = {}
    for s in spans:
        if s.get("depth") != 0 or not s.get("main_thread", True):
            continue
        bucket = SPAN_BUCKETS.get(s["name"])
        if bucket is not None:
            buckets[bucket] = buckets.get(bucket, 0.0) + s["dur"]
    buckets["untracked"] = max((t1 - t0) - sum(buckets.values()), 0.0)
    return buckets


def slowest_windows(spans: list[dict], metrics: list[dict], top: int
                    ) -> list[dict]:
    """Logging windows ranked by per-step wall time: `device_step` spans
    (one per boundary; `steps` counts the window's steps) joined with the
    metrics line logged at the same step for loss/goodput context."""
    # a step can carry several lines (the train scalars, then an eval_loss
    # line at the same boundary) — merge them so neither shadows the other
    by_step: dict = {}
    for m in metrics:
        by_step.setdefault(m.get("step"), {}).update(m)
    windows = []
    for s in spans:
        if s["name"] != "device_step":
            continue
        steps = max(int(s.get("steps", 1)), 1)
        m = by_step.get(s.get("step"), {})
        windows.append({
            "step": s.get("step"),
            "steps": steps,
            "block_s": s["dur"],
            "per_step_s": s["dur"] / steps,
            "step_time": m.get("step_time"),
            "loss": m.get("loss"),
        })
    windows.sort(key=lambda w: -(w["step_time"] or w["per_step_s"]))
    return windows[:top]


def stall_histogram(spans: list[dict], name: str = "data_wait"
                    ) -> list[tuple[str, int, float]]:
    """(label, count, total seconds) per duration decade for one span name.
    `data_wait` and the nested `prefetch_stall` are histogrammed SEPARATELY —
    a prefetch stall happens inside its data_wait, so summing both would
    double-count the stalled seconds."""
    edges = [(0.001, "<1ms"), (0.01, "1-10ms"), (0.1, "10-100ms"),
             (1.0, "0.1-1s"), (float("inf"), ">=1s")]
    hist = {label: [0, 0.0] for _, label in edges}
    for s in spans:
        if s["name"] != name:
            continue
        for hi, label in edges:
            if s["dur"] < hi:
                hist[label][0] += 1
                hist[label][1] += s["dur"]
                break
    return [(label, n, total) for label, (n, total) in hist.items()]


def _num(value) -> float | None:
    """A float, or None for anything a half-written file might hold."""
    try:
        return float(value)
    except (TypeError, ValueError):
        return None


def load_health(output_dir: str) -> tuple[dict, str]:
    """(health dict, status) where status is ok|missing|corrupt. The report
    must DEGRADE on a missing or partially-written/garbage health.json (a
    crashed run is exactly when this tool gets pointed at a dir), never
    traceback — non-dict JSON ("null", a list) counts as corrupt too."""
    path = os.path.join(output_dir, "health.json")
    if not os.path.exists(path):
        return {}, "missing"
    try:
        with open(path) as f:
            health = json.load(f)
    except (OSError, ValueError):
        return {}, "corrupt"
    if not isinstance(health, dict):
        return {}, "corrupt"
    return health, "ok"


def _incarnation_label(row: dict) -> str | None:
    """Topology label for one ledger row: the trainer's own health.json
    topology when it ran long enough to write one, else the supervisor's
    ladder-rung label, else None (an inelastic pre-elastic ledger)."""
    topo = row.get("trainer_topology")
    if isinstance(topo, dict) and topo.get("layout"):
        return topo["layout"]
    return row.get("layout")


def incarnation_summary(output_dir: str) -> dict | None:
    """Roll-up of the supervisor's goodput ledger (incarnations.jsonl, one
    row per launch — tools.supervisor), or None when the run was never
    supervised. Restart badput = wall seconds spent in incarnations that
    did not end cleanly; `resize_lost_seconds` is a SIBLING bucket — the
    failed-incarnation time that forced each topology resize plus the
    probe/relaunch gap before the resized launch (the gap is wall-clock
    lost_seconds never counts) — so elastic downgrades are visible next to
    plain restarts."""
    rows = load_jsonl(os.path.join(output_dir, "incarnations.jsonl"))
    rows = [r for r in rows if isinstance(r, dict)]
    if not rows:
        return None
    # supervisor_stopped = the supervisor itself was preempted and the child
    # checkpointed + exited cleanly — productive time, not restart badput
    failed = [r for r in rows
              if r.get("outcome") not in ("clean", "supervisor_stopped", None)]
    resize_lost = 0.0
    resizes = 0
    for prev, cur in zip(rows, rows[1:]):
        if not cur.get("resized"):
            continue
        resizes += 1
        # the failed incarnation that forced this resize, plus the
        # probe/relaunch gap before the resized one came up
        if prev in failed:
            resize_lost += _num(prev.get("duration_s")) or 0.0
        start, end = _num(cur.get("start")), _num(prev.get("end"))
        if start is not None and end is not None:
            resize_lost += max(start - end, 0.0)
    return {
        "incarnations": len(rows),
        "restarts": max(len(rows) - 1, 0),
        "crashes": sum(1 for r in failed if r.get("outcome") == "crash"),
        "hangs": sum(1 for r in failed if r.get("outcome") == "hang"),
        # the supervisor labels an allocation-failure death distinctly
        # (crash + fresh oom/ snapshot — tools.supervisor): a capacity
        # problem every relaunch will hit again, unlike a transient crash
        "ooms": sum(1 for r in failed if r.get("outcome") == "oom"),
        "lost_seconds": sum(_num(r.get("duration_s")) or 0.0 for r in failed),
        "resize_events": resizes,
        "resize_lost_seconds": round(resize_lost, 3),
        "last_outcome": rows[-1].get("outcome"),
        "layouts": [{"incarnation": r.get("incarnation"),
                     "outcome": r.get("outcome"),
                     "layout": _incarnation_label(r),
                     "devices": r.get("devices"),
                     "resized": bool(r.get("resized"))} for r in rows],
    }


def supervisor_summary(output_dir: str) -> dict | None:
    """Roll-up of the watchdog's OWN heartbeat (supervisor_health.json,
    tools.supervisor), or None when the run is unsupervised — so the
    report labels the directory's supervisor distinctly instead of
    treating every health file as the trainer's."""
    import time

    path = os.path.join(output_dir, "supervisor_health.json")
    try:
        with open(path) as f:
            health = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(health, dict):
        return None
    age = None
    t = _num(health.get("time"))
    if t is not None:
        age = round(time.time() - t, 1)
    return {"pid": health.get("pid"),
            "heartbeat_age_s": age,
            "restarts": health.get("restarts"),
            "consecutive_failures": health.get("consecutive_failures"),
            "last_outcome": health.get("last_outcome"),
            "child_pid": health.get("child_pid"),
            "layout": health.get("layout")}


# the p95-ish latency + capacity gauges this report shows NEXT to the
# shared counter set (SERVE_COUNTER_KEYS above)
_SERVE_GAUGE_KEYS = ("ttft_p95_ms", "tpot_p50_ms", "queue_wait_p95_ms",
                     "pages_used", "pages_free", "pages_reserved",
                     "reserved_unbacked", "page_fragmentation",
                     "reserved_gap_bytes", "prefilling",
                     "prefill_chunks_total", "prefill_tokens_total")


def serve_counter_summary(metrics: list[dict]) -> dict | None:
    """Last serving metrics line's counter/gauge picture, or None for a
    run that never served."""
    serving = [m for m in metrics if isinstance(m, dict) and m.get("serving")]
    if not serving:
        return None
    last = serving[-1]
    return {k: last[k] for k in SERVE_COUNTER_KEYS + _SERVE_GAUGE_KEYS
            if k in last}


def oom_summary(output_dir: str, top: int = 5) -> dict | None:
    """Roll-up of the OOM forensics snapshots (`<output_dir>/oom/`, written
    by the trainer's allocation-failure handler — utils/memwatch.py), or
    None when the run never OOMed. Tolerant like every other reader: a
    torn/garbage snapshot contributes nothing, the parseable rest still
    reports."""
    from llama_pipeline_parallel_tpu_torch.utils import memwatch

    snaps = memwatch.read_oom_snapshots(output_dir)
    if not snaps:
        return None
    out = {"snapshots": len(snaps), "events": []}
    for s in snaps[:top]:
        live = s.get("live") if isinstance(s.get("live"), dict) else {}
        peak = _num(live.get("device_peak_bytes"))
        out["events"].append({"step": s.get("step"),
                              "time": s.get("time"),
                              "error": str(s.get("error", ""))[:160],
                              "device_peak_gib": (round(peak / (1 << 30), 2)
                                                  if peak is not None
                                                  else None)})
    return out


def numerics_summary(output_dir: str, top: int = 5) -> dict | None:
    """Roll-up of the numerics observatory's stream (numerics.jsonl, one row
    per step — utils/numerics.py), or None when the run had numerics off.
    Folds the anomaly timeline into the run report so a goodput dip can be
    read next to the loss spike / nonfinite step that caused the restart."""
    rows = [r for r in load_jsonl(os.path.join(output_dir, "numerics.jsonl"))
            if isinstance(r, dict) and "step" in r]
    if not rows:
        return None
    # last record per step: resumes re-run steps past their checkpoint and
    # append a second record — only the surviving timeline counts
    by_step: dict = {}
    for r in rows:
        by_step[r["step"]] = r
    rows = [by_step[s] for s in sorted(by_step)]
    anomalies = [r for r in rows if r.get("anomaly")]
    nonfinite = [r for r in rows if r.get("nonfinite")]
    return {
        "records": len(rows),
        "nonfinite_steps": len(nonfinite),
        "anomaly_count": len(anomalies),
        "first_nonfinite_step": nonfinite[0]["step"] if nonfinite else None,
        "anomalies": [{"step": r["step"], "kinds": r["anomaly"]}
                      for r in anomalies[:top]],
    }


def build_report(output_dir: str, top: int = 5) -> dict:
    spans = load_jsonl(os.path.join(output_dir, "spans.jsonl"))
    metrics = load_jsonl(os.path.join(output_dir, "metrics.jsonl"))
    health, health_status = load_health(output_dir)
    t0, t1 = wall_window(spans)
    buckets = bucket_table(spans)
    wall = t1 - t0
    return {
        "output_dir": output_dir,
        "wall_seconds": wall,
        "buckets": buckets,
        # either workload's useful-work bucket (a process runs one of them)
        "goodput": (buckets.get("train", 0.0) + buckets.get("serve", 0.0))
        / max(wall, 1e-9),
        "health_status": health_status,
        "cumulative_goodput": _num(health.get("goodput")),
        "last_step": health.get("last_step"),
        # serve replicas heartbeat a role; a trainer's health has none
        "role": health.get("role") or "trainer",
        "serve_counters": serve_counter_summary(metrics),
        "supervisor": supervisor_summary(output_dir),
        "incarnations": incarnation_summary(output_dir),
        "numerics": numerics_summary(output_dir, top),
        "oom": oom_summary(output_dir, top),
        "slowest_windows": slowest_windows(spans, metrics, top),
        "stall_histogram": stall_histogram(spans, "data_wait"),
        "prefetch_stalls": {
            "count": sum(1 for s in spans if s["name"] == "prefetch_stall"),
            "seconds": sum(s["dur"] for s in spans
                           if s["name"] == "prefetch_stall"),
        },
        "spans": len(spans),
        "metrics_lines": len(metrics),
    }


def print_report(rep: dict) -> None:
    wall = rep["wall_seconds"]
    print(f"run: {rep['output_dir']}  (role {rep.get('role', 'trainer')}, "
          f"{rep['spans']} spans, {rep['metrics_lines']} metrics lines, "
          f"last step {rep['last_step']})")
    if rep.get("health_status") != "ok":
        print(f"  (health.json {rep['health_status']} — cumulative goodput / "
              f"last-step fields degraded)")

    sup = rep.get("supervisor")
    if sup:
        loop = (f", {sup['consecutive_failures']} consecutive failure(s)"
                if sup.get("consecutive_failures") else "")
        age = (f", heartbeat {sup['heartbeat_age_s']:.0f}s old"
               if sup.get("heartbeat_age_s") is not None else "")
        print(f"\n== supervisor (watchdog heartbeat) ==\n"
              f"  pid {sup.get('pid')}, {sup.get('restarts') or 0} "
              f"restart(s){loop}, last outcome "
              f"{sup.get('last_outcome')}{age}")

    inc = rep.get("incarnations")
    if inc:
        ooms = (f", {inc['ooms']} oom(s)" if inc.get("ooms") else "")
        print(f"\n== incarnations (supervisor ledger) ==\n"
              f"  {inc['incarnations']} launch(es), {inc['restarts']} "
              f"restart(s): {inc['crashes']} crash(es), {inc['hangs']} "
              f"hang(s){ooms}; {inc['lost_seconds']:.1f} s lost to failed "
              f"incarnations; last outcome: {inc['last_outcome']}")
        if inc.get("resize_events"):
            # crash duration + relaunch gap around each resize — the gap is
            # not part of lost_seconds (which counts only failed-incarnation
            # wall time), so this is a sibling bucket, not a subset
            print(f"  {inc['resize_events']} topology resize(s); "
                  f"{inc['resize_lost_seconds']:.1f} s of crash + relaunch "
                  f"downtime bought a smaller layout (resize badput)")
        if any(l.get("layout") for l in inc.get("layouts", [])):
            for l in inc["layouts"]:
                mark = " <- resized" if l.get("resized") else ""
                devices = (f", {l['devices']} device(s)"
                           if l.get("devices") is not None else "")
                print(f"    #{l['incarnation']}: {l['layout'] or '?'}"
                      f"{devices}  [{l['outcome']}]{mark}")

    oom = rep.get("oom")
    if oom:
        print(f"\n== oom forensics ({oom['snapshots']} snapshot(s), "
              f"newest first) ==")
        for e in oom["events"]:
            peak = (f"  device peak {e['device_peak_gib']} GiB"
                    if e.get("device_peak_gib") is not None else "")
            print(f"    step {e.get('step')}: {e.get('error')}{peak}")
        print("  (full snapshots: <output_dir>/oom/)")

    num = rep.get("numerics")
    if num:
        print(f"\n== numerics (anomaly timeline) ==\n"
              f"  {num['records']} records: {num['nonfinite_steps']} "
              f"nonfinite step(s), {num['anomaly_count']} anomaly(ies)"
              + (f"; first nonfinite at step {num['first_nonfinite_step']}"
                 if num["first_nonfinite_step"] is not None else ""))
        for a in num["anomalies"]:
            print(f"    step {a['step']:<6} {','.join(a['kinds'])}")
        if num["anomaly_count"]:
            print("  (details: python -m llama_pipeline_parallel_tpu_torch.tools."
                  f"numerics_report {rep['output_dir']})")

    serve = rep.get("serve_counters")
    if serve:
        print("\n== serving counters (last metrics line) ==")
        print("  " + " ".join(f"{k}={serve[k]}" for k in serve))

    print(f"\n== time buckets: {wall:.2f} s wall ==")
    for name, secs in sorted(rep["buckets"].items(), key=lambda kv: -kv[1]):
        pct = 100 * secs / wall if wall else 0.0
        print(f"  {secs:10.2f} s  {pct:5.1f}%  {name}")
    print(f"  {sum(rep['buckets'].values()):10.2f} s  total (goodput "
          f"{100 * rep['goodput']:.1f}%"
          + (f", cumulative incl. prior incarnations "
             f"{100 * rep['cumulative_goodput']:.1f}%"
             if rep["cumulative_goodput"] is not None else "") + ")")

    if rep["slowest_windows"]:
        print("\n== slowest logging windows (per-step wall time) ==")
        for w in rep["slowest_windows"]:
            step_time = w["step_time"]
            shown = step_time if step_time is not None else w["per_step_s"]
            loss = f"  loss {w['loss']:.4g}" if w["loss"] is not None else ""
            print(f"  {1e3 * shown:10.2f} ms/step  @step {w['step']:<6} "
                  f"({w['steps']} steps, value-fetch block "
                  f"{1e3 * w['block_s']:.2f} ms){loss}")

    total_stall = sum(t for _, _, t in rep["stall_histogram"])
    print(f"\n== input-wait histogram (data_wait): {total_stall:.3f} s total ==")
    for label, n, secs in rep["stall_histogram"]:
        print(f"  {label:>8}  x{n:<6d} {secs:10.3f} s")
    ps = rep["prefetch_stalls"]
    print(f"  of which prefetch buffer-empty stalls: x{ps['count']} "
          f"{ps['seconds']:.3f} s")


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("output_dir", help="trainer output dir (holds spans.jsonl)")
    p.add_argument("--top", type=int, default=5,
                   help="slowest logging windows to list")
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
