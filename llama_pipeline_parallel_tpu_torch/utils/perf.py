"""The perf ledger: one jsonl schema pairing every analytic/model number
the run emits with its measured counterpart.

The counterpart of llama_pipeline_parallel_tpu/utils/perf.py, copied line
for line (it is plain stdlib; tests/test_torch_observability.py pins the
copy's outputs to the reference's). A **row** is one observation:

    {"ts": <epoch>, "source": "train"|"bench"|"serve",
     "run": <label>, "metric": <name>,
     "model": <float|null>, "measured": <float|null>, "unit": <str>,
     "reason": <str, failure rows only>, "context": {...}}

`model` is an analytic prediction (the sequence-counted bubble, the first
step's measured peak memory); `measured` is a wall-clock/bandwidth/memory
observation; either may be absent. Failure rows (`reason`) record rounds
that produced NO number, so `tools/perf_report.py` can summarize "N rounds
unreachable" instead of silently showing an empty table. The bench-archive
readers (`rows_from_bench_summary`, `rows_from_bench_file`) read the JSON
package's bench summaries, which the port's perf_report also accepts.

Writer: train.py (the timeline-measured bubble vs the analytic one, step
walls, the memory watch's rows) into `<output_dir>/perf.jsonl`. Reader:
tools/perf_report.py (calibration table + the constants file).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Iterable

SCHEMA_VERSION = 1


def make_row(metric: str, model: float | None = None,
             measured: float | None = None, unit: str = "",
             source: str = "", run: str = "", reason: str | None = None,
             **context: Any) -> dict:
    row: dict[str, Any] = {"ts": time.time(), "schema": SCHEMA_VERSION,
                           "source": source, "run": run, "metric": metric,
                           "model": _num(model), "measured": _num(measured),
                           "unit": unit}
    if reason:
        row["reason"] = str(reason)
    if context:
        row["context"] = context
    return row


def _num(x) -> float | None:
    try:
        v = float(x)
    except (TypeError, ValueError):
        return None
    return v if v == v else None  # NaN -> absent


def append_rows(path: str, rows: Iterable[dict]) -> int:
    """Append rows to a perf.jsonl (created with parents). Returns the
    count written; any single row failing to serialize is dropped, never
    fatal — ledger writes ride along real runs."""
    rows = list(rows)
    if not rows:
        return 0
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    n = 0
    with open(path, "a", buffering=1) as f:
        for row in rows:
            try:
                f.write(json.dumps(row) + "\n")
                n += 1
            except (TypeError, ValueError):
                continue
    return n


def read_jsonl(path: str, keep=None) -> list[dict]:
    """THE tolerant jsonl reader (the goodput_report house rule, spelled
    once): every parseable dict record of a line stream —
    missing/empty/torn/garbage lines degrade to whatever parses. `keep`
    (optional predicate over a parsed dict) filters records; shared by the
    perf ledger and the timeline reader so the degrade semantics cannot
    drift between them."""
    rows: list[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except ValueError:
                    continue
                if isinstance(row, dict) and (keep is None or keep(row)):
                    rows.append(row)
    except OSError:
        return []
    return rows


def read_ledger(path: str) -> list[dict]:
    """Every parseable perf row (rows without a `metric` are skipped)."""
    return read_jsonl(path, keep=lambda row: "metric" in row)


# ---------------------------------------------------------------------------
# bench.py output -> rows
# ---------------------------------------------------------------------------

def rows_from_bench_summary(summary: dict, run: str = "bench") -> list[dict]:
    """Convert one bench.py summary JSON (the single line it prints, or a
    BENCH_r0*.json archive) into ledger rows. Error rounds (the TPU-
    unreachable shape: an `error` key with value 0.0) become one
    reason-tagged failure row; healthy rounds contribute the headline MFU
    plus every `extra:*` row's model-vs-measured pairing:

    - `extra:sched-*` / `extra:layout-*`: measured step seconds, with the
      layout rows' `score_s_model` as the model half and every sched
      row's `bubble_fraction_analytic` carried in context (its measured
      counterpart is the trainer's timeline, not bench);
    - `extra:offload-bw`: measured host-link bandwidth (`host_bw_gibps`,
      the number `--calibration` feeds back into preflight);
    - `extra:offload-wgrad-stash`: `transfer_ms_model` vs the measured
      `transfer_stall_ms`;
    - `extra:kernel-*`: modeled bytes-moved with the measured saved-ms /
      achieved bandwidth;
    - `extra:serve-*`: measured decode/prefill latencies.
    """
    if not isinstance(summary, dict):
        return []
    if summary.get("error"):
        return [make_row("bench_round", source="bench", run=run,
                         reason=summary["error"])]
    rows: list[dict] = []
    if summary.get("mfu") is not None:
        rows.append(make_row("mfu", measured=summary.get("mfu"),
                             unit="fraction", source="bench", run=run,
                             best_config=summary.get("best_config")))
    configs = summary.get("all_configs") or {}
    if not isinstance(configs, dict):
        configs = {}
    for name, r in configs.items():
        if not isinstance(r, dict):
            continue
        # bench.py's summary FLATTENS each row's detail into the config
        # entry (next to ms/tok_s); an un-flattened {"detail": {...}}
        # (tests, older archives) is accepted too
        if isinstance(r.get("detail"), dict):
            detail = dict(r["detail"])
        else:
            detail = {k: v for k, v in r.items() if k not in ("ms", "tok_s")}
        # nothing model-vs-measured in the headline sweep rows
        if not name.startswith("extra:"):
            continue
        step_s = (r["ms"] / 1000.0) if isinstance(r.get("ms"), (int, float)) \
            else None
        model_s = detail.get("score_s_model")
        rows.append(make_row(
            f"step_s:{name}", model=model_s, measured=step_s, unit="s",
            source="bench", run=run, **detail))
        if "bubble_fraction_analytic" in detail:
            rows.append(make_row(
                f"bubble_fraction:{name}",
                model=detail["bubble_fraction_analytic"],
                source="bench", run=run))
        if name.startswith("extra:offload-bw"):
            bws = [detail.get("d2h_gibps"), detail.get("h2d_gibps")]
            bws = [b for b in (_num(b) for b in bws) if b]
            if bws:
                rows.append(make_row(
                    "host_bw_gibps", measured=min(bws), unit="GiB/s",
                    source="bench", run=run,
                    pinned_host=detail.get("pinned_host")))
        if "transfer_ms_model" in detail:
            rows.append(make_row(
                f"transfer_ms:{name}", model=detail["transfer_ms_model"],
                measured=detail.get("transfer_stall_ms"), unit="ms",
                source="bench", run=run))
        if "achieved_gibps" in detail:
            rows.append(make_row(
                f"kernel_bw_gibps:{name}",
                measured=detail["achieved_gibps"], unit="GiB/s",
                source="bench", run=run,
                bytes_model_gib=detail.get("bytes_model_gib")))
        if name.startswith("extra:mem-peak"):
            # the memory observatory's pairing: compiled memory_analysis
            # peak (model half) vs the live device peak (measured half) —
            # the row `derive_calibration` turns into `mem_scale`
            rows.append(make_row(
                "mem_peak_gib", model=detail.get("compiled_peak_gib"),
                measured=detail.get("live_peak_gib"), unit="GiB",
                source="bench", run=run, backend=detail.get("backend"),
                temp_gib=detail.get("temp_gib")))
        if name.startswith("extra:mem-pagepool"):
            rows.append(make_row(
                "page_fragmentation", measured=detail.get("fragmentation"),
                unit="fraction", source="bench", run=run,
                pages_reserved=detail.get("pages_reserved"),
                pages_used=detail.get("pages_used"),
                reserved_gap_gib=detail.get("reserved_gap_gib")))
    return rows


def rows_from_bench_file(path: str, run: str | None = None) -> list[dict]:
    """Rows from an archived bench round (BENCH_r0*.json). Two formats:
    bench.py's own summary line saved as JSON, or the harness wrapper
    `{"n", "cmd", "rc", "tail"}` whose `tail` embeds the emitted summary
    line — the shape the five TPU-unreachable rounds archived. Unreadable
    files yield one failure row naming the file — history must be
    summarizable even when a round wrote garbage."""
    label = run or os.path.basename(path)
    try:
        with open(path) as f:
            summary = json.load(f)
    except (OSError, ValueError) as e:
        return [make_row("bench_round", source="bench", run=label,
                         reason=f"unreadable bench archive: {e}")]
    if not isinstance(summary, dict):
        return [make_row("bench_round", source="bench", run=label,
                         reason="bench archive is not a JSON object")]
    if "metric" not in summary and "tail" in summary:
        embedded = _summary_from_tail(str(summary.get("tail", "")))
        if embedded is None:
            return [make_row(
                "bench_round", source="bench", run=label,
                reason=f"round rc={summary.get('rc')} emitted no summary "
                       f"line")]
        summary = embedded
    return rows_from_bench_summary(summary, run=label)


def _summary_from_tail(tail: str) -> dict | None:
    """The LAST parseable {"metric": ...} JSON line inside a captured
    stdout/stderr tail (the watchdog/probe error line included)."""
    found = None
    for line in tail.splitlines():
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict) and "metric" in obj:
            found = obj
    return found


# ---------------------------------------------------------------------------
# Aggregation (tools/perf_report.py)
# ---------------------------------------------------------------------------

def summarize(rows: list[dict]) -> dict:
    """Group rows by metric -> {models: [...], measured: [...], pairs:
    [(model, measured)], runs: {...}}; failure rows aggregate under
    "failures"."""
    metrics: dict[str, dict] = {}
    failures: list[dict] = []
    for row in rows:
        if row.get("reason"):
            failures.append(row)
            continue
        m = metrics.setdefault(row.get("metric", "?"),
                               {"models": [], "measured": [], "pairs": [],
                                "runs": set(), "unit": row.get("unit", "")})
        model, meas = _num(row.get("model")), _num(row.get("measured"))
        if model is not None:
            m["models"].append(model)
        if meas is not None:
            m["measured"].append(meas)
        if model is not None and meas is not None:
            m["pairs"].append((model, meas))
        if row.get("run"):
            m["runs"].add(row["run"])
    return {"metrics": metrics, "failures": failures}


def derive_calibration(rows: list[dict]) -> dict:
    """Measured constants for `preflight --select --calibration`: the
    knobs the CLI otherwise takes on faith (--mfu, --host-bw-gibps,
    --ici-bw-gibps, --mem-scale), each present only when the ledger holds
    a live measurement for it — preflight keeps its CLI value for absent
    keys.

    Rows stamped `context.backend: cpu` are EXCLUDED: a CPU smoke measures
    real numbers about the wrong hardware (an mfu of 1e-4, a device_put
    "host link"), and feeding them into preflight's TPU model would
    re-rank the frontier from noise; an mfu floor of 0.01 backstops
    unstamped rows from old archives."""
    import statistics

    by_metric: dict[str, list[float]] = {}
    mem_ratios: list[float] = []
    for row in rows:
        meas = _num(row.get("measured"))
        ctx = row.get("context") or {}
        if isinstance(ctx, dict) and ctx.get("backend") == "cpu":
            continue
        # only positive measurements can calibrate a rate/fraction model
        # constant (a failed probe's 0.0 must not zero preflight's model)
        if meas is not None and meas > 0:
            by_metric.setdefault(row.get("metric", ""), []).append(meas)
        # mem_scale is a RATIO constant (measured live peak / byte-model
        # peak), so it needs both halves of the same row — unlike the rate
        # constants above, a lone measurement calibrates nothing
        if row.get("metric") == "mem_peak_gib":
            model = _num(row.get("model"))
            if model and model > 0 and meas is not None and meas > 0:
                mem_ratios.append(meas / model)
    calib: dict[str, Any] = {}
    mfu = [v for v in by_metric.get("mfu", ()) if v >= 0.01]
    if mfu:
        calib["mfu"] = round(statistics.median(mfu), 4)
    if by_metric.get("host_bw_gibps"):
        calib["host_bw_gibps"] = round(
            statistics.median(by_metric["host_bw_gibps"]), 2)
    if by_metric.get("ici_bw_gibps"):
        calib["ici_bw_gibps"] = round(
            statistics.median(by_metric["ici_bw_gibps"]), 2)
    if mem_ratios:
        calib["mem_scale"] = round(statistics.median(mem_ratios), 4)
    calib["generated_at"] = time.time()
    calib["rows_used"] = len(mfu) + len(mem_ratios) + sum(
        len(v) for k, v in by_metric.items()
        if k in ("host_bw_gibps", "ici_bw_gibps"))
    return calib
