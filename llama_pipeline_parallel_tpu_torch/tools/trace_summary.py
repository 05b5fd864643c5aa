"""Summarize a torch.profiler trace: top ops by accumulated duration.

The counterpart of the JAX package's tools/trace_summary.py over the Chrome
trace torch.profiler exports (`<worker>.<ts>.pt.trace.json`, written by the
trainer's `profile_steps` window under `<output_dir>/profile` and by the
triggered profiler under `<output_dir>/captures/...`): it aggregates the
complete ("X") events of the newest capture under a directory.

Usage:
  python -m llama_pipeline_parallel_tpu_torch.tools.trace_summary <trace_dir>
      [--top 15] [--track SUBSTR]

A track is a process of the trace and, within it, a thread: torch.profiler
puts the host's operators on the process's threads and each CUDA stream's
kernels on a track of the card (e.g. "GPU 0 / stream 7"). `--track` keeps
the tracks whose name contains SUBSTR (e.g. "stream" for the card's
kernels only; default keeps every track and prints each track's total so
card vs host time is visible side by side).
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os


def load_latest_trace(trace_dir: str) -> tuple[str, dict]:
    """Newest capture under `trace_dir`, gzipped or plain. A missing
    capture raises FileNotFoundError; an unreadable or torn one (killed
    mid-capture) raises SystemExit with a readable message — the CLI prints
    it instead of a traceback."""
    paths = sorted(
        glob.glob(os.path.join(trace_dir, "**", "*.trace.json.gz"),
                  recursive=True)
        + glob.glob(os.path.join(trace_dir, "**", "*.trace.json"),
                    recursive=True),
        key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(
            f"no *.trace.json.gz (or *.trace.json) under {trace_dir} (is "
            f"this a torch.profiler output dir? expected "
            f"<worker>.<ts>.pt.trace.json)")
    path = paths[-1]
    opener = gzip.open if path.endswith(".gz") else open
    try:
        with opener(path, "rt") as f:
            trace = json.load(f)
    except (OSError, ValueError) as e:
        raise SystemExit(
            f"could not parse trace capture {path}: {e}\n(partial capture "
            f"from an interrupted profile window? delete it and re-capture)")
    if not isinstance(trace, dict):
        raise SystemExit(f"trace capture {path} is not a Chrome-trace JSON "
                         f"object (got {type(trace).__name__})")
    return path, trace


def track_names(trace: dict) -> dict:
    """{(pid, tid): "<process name> / <thread name>"} from the trace's
    metadata events (the pid or tid itself where a name is missing)."""
    procs, threads = {}, {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "M":
            continue
        name = (e.get("args") or {}).get("name")
        if e.get("name") == "process_name":
            procs[e.get("pid")] = name
        elif e.get("name") == "thread_name":
            threads[(e.get("pid"), e.get("tid"))] = name
    out = {}
    for e in trace.get("traceEvents", []):
        key = (e.get("pid"), e.get("tid"))
        if e.get("ph") == "X" and key not in out:
            proc = procs.get(key[0]) or str(key[0])
            thread = threads.get(key) or str(key[1])
            out[key] = f"{proc} / {thread}"
    return out


def summarize(trace: dict, track_filter: str | None = None):
    """-> (per-track total us, per-track op->us Counter, per-track op->count
    Counter)."""
    names = track_names(trace)
    track_total: collections.Counter = collections.Counter()
    op_dur: dict = collections.defaultdict(collections.Counter)
    op_count: dict = collections.defaultdict(collections.Counter)
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        track = names[(e.get("pid"), e.get("tid"))]
        if track_filter and track_filter.lower() not in track.lower():
            continue
        dur = float(e.get("dur", 0.0))
        name = e.get("name", "?")
        track_total[track] += dur
        op_dur[track][name] += dur
        op_count[track][name] += 1
    return track_total, op_dur, op_count


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("trace_dir")
    p.add_argument("--top", type=int, default=15)
    p.add_argument("--track", default=None,
                   help="only tracks whose name contains this (e.g. 'stream')")
    args = p.parse_args(argv)

    try:
        path, trace = load_latest_trace(args.trace_dir)
    except FileNotFoundError as e:
        # empty/wrong dir: a readable verdict, not a traceback
        raise SystemExit(str(e))
    print(f"trace: {path}")
    track_total, op_dur, op_count = summarize(trace, args.track)
    if not track_total:
        raise SystemExit("no complete events matched "
                         f"(--track {args.track!r}); try without --track")
    for track, total in sorted(track_total.items(), key=lambda kv: -kv[1]):
        print(f"\n== {track}: {total / 1e3:.2f} ms total ==")
        for name, dur in op_dur[track].most_common(args.top):
            pct = 100 * dur / total if total else 0.0
            print(f"  {dur / 1e3:10.2f} ms  {pct:5.1f}%  "
                  f"x{op_count[track][name]:<5d} {name}")


if __name__ == "__main__":
    main()
