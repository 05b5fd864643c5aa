"""Offline serving-SLO summary from a serve run directory.

The counterpart of the JAX package's tools/serving_report.py, copied line
for line. Reads the telemetry a serve process
(`python -m llama_pipeline_parallel_tpu_torch.tools.serve`) left behind —
`serve_request` spans in spans.jsonl (per-request TTFT/TPOT/queue-wait),
serving metrics lines in metrics.jsonl, health.json — and prints the SLO
picture: request/token counts, p50/p95/p99 latency tables, throughput over
the busy window, and the slot/queue occupancy the last metrics line saw.

    python -m llama_pipeline_parallel_tpu_torch.tools.serving_report /runs/serve1

Degrades instead of tracebacking on missing/torn files (the
goodput_report contract): a crashed replica's directory must still
report whatever it managed to record.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from llama_pipeline_parallel_tpu_torch.serve.telemetry import (
    SERVE_COUNTER_KEYS,
    percentiles_ms,
)


def load_jsonl(path: str) -> list[dict]:
    """Parseable dict rows only — `perf.read_jsonl`, the one spelling of
    the tolerant reader (a torn tail or garbage line is skipped)."""
    from llama_pipeline_parallel_tpu_torch.utils.perf import read_jsonl

    return read_jsonl(path)


def build_report(output_dir: str) -> dict:
    spans = load_jsonl(os.path.join(output_dir, "spans.jsonl"))
    requests = [s for s in spans if s.get("name") == "serve_request"]
    metrics = [m for m in load_jsonl(os.path.join(output_dir, "metrics.jsonl"))
               if m.get("serving")]
    try:
        with open(os.path.join(output_dir, "health.json")) as f:
            health = json.load(f)
        health = health if isinstance(health, dict) else {}
    except (OSError, ValueError):
        health = {}

    ttft = [s["ttft"] for s in requests if isinstance(s.get("ttft"), (int, float))]
    tpot = [s["tpot"] for s in requests if isinstance(s.get("tpot"), (int, float))]
    qwait = [s["queue_wait"] for s in requests
             if isinstance(s.get("queue_wait"), (int, float))]
    tokens = sum(int(s.get("tokens", 0)) for s in requests)

    busy = None
    if requests:
        t0 = min(s["ts"] for s in requests)
        t1 = max(s.get("end", s["ts"]) for s in requests)
        busy = max(t1 - t0, 1e-9)
    return {
        "output_dir": output_dir,
        "requests": len(requests),
        "tokens": tokens,
        "busy_seconds": busy,
        "tokens_per_sec": (tokens / busy) if busy else None,
        "ttft": percentiles_ms(ttft, "ttft"),
        "tpot": percentiles_ms(tpot, "tpot"),
        "queue_wait": percentiles_ms(qwait, "queue_wait"),
        "max_ttft_ms": round(1000 * max(ttft), 3) if ttft else None,
        "mean_tokens_per_request": round(tokens / len(requests), 2)
        if requests else None,
        "last_metrics": metrics[-1] if metrics else None,
        "role": health.get("role"),
        "health_goodput": health.get("goodput"),
    }


def _latency_row(name: str, table: dict, values_key: str) -> str:
    cells = " ".join(f"p{q}={table.get(f'{values_key}_p{q}_ms', '—')}"
                     for q in (50, 95, 99))
    return f"  {name:<12} {cells} (ms)"


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("output_dir")
    args = p.parse_args(argv)
    rep = build_report(args.output_dir)

    print(f"== serving report: {rep['output_dir']} ==")
    if not rep["requests"] and rep["last_metrics"] is None:
        print("  no serve_request spans or serving metrics found — nothing "
              "served yet, or the directory is not a serve run")
        return 1
    print(f"  {rep['requests']} requests, {rep['tokens']} tokens"
          + (f", {rep['tokens_per_sec']:.1f} tok/s over "
             f"{rep['busy_seconds']:.2f} s busy window"
             if rep["tokens_per_sec"] is not None else ""))
    if rep["mean_tokens_per_request"] is not None:
        print(f"  {rep['mean_tokens_per_request']} tokens/request mean")
    print("\n== SLO percentiles (spans.jsonl serve_request) ==")
    print(_latency_row("ttft", rep["ttft"], "ttft"))
    print(_latency_row("tpot", rep["tpot"], "tpot"))
    print(_latency_row("queue_wait", rep["queue_wait"], "queue_wait"))
    last = rep["last_metrics"]
    if last:
        print("\n== last serving metrics line ==")
        # the shared counter set (telemetry.SERVE_COUNTER_KEYS — the one
        # spelling goodput_report renders too) plus this report's
        # occupancy extras
        occupancy = {k: last.get(k) for k in
                     SERVE_COUNTER_KEYS
                     + ("active_slots", "queue_depth", "slot_allocations",
                        "decode_steps") if k in last}
        print("  " + " ".join(f"{k}={v}" for k, v in occupancy.items()))
        if last.get("kv_cache") == "paged":
            # the paged-capacity picture next to the SLOs: pool occupancy,
            # worst-case reservations, the admission-refusal counter, and
            # the prefill-chunk cadence (docs/SERVING.md "Paged KV cache")
            # requests_page_refused moved up into the counter line above
            pages = {k: last.get(k) for k in
                     ("pages_used", "pages_reserved", "pages_total",
                      "page_size", "kv_quant", "page_allocations")
                     if k in last}
            print("  page pool: " + " ".join(f"{k}={v}"
                                             for k, v in pages.items()))
            chunks = {k: last.get(k) for k in
                      ("prefill_chunks_last_tick", "prefill_chunks_total",
                       "prefill_tokens_total", "prefilling") if k in last}
            if chunks:
                print("  prefill:   " + " ".join(f"{k}={v}"
                                                 for k, v in chunks.items()))
            if last.get("prefix_cache"):
                # the prefix-cache picture (docs/SERVING.md "Prefix
                # caching"): hit rate, tokens/pages served from shared
                # pages, CoW forks, and the cached-page / eviction churn
                prefix = {k: last.get(k) for k in
                          ("prefix_hit_rate", "prefix_hits",
                           "prefix_misses", "prefix_cached_tokens",
                           "prefix_shared_pages", "prefix_cow_forks",
                           "pages_cached", "prefix_evictions")
                          if k in last}
                print("  prefix:    " + " ".join(f"{k}={v}"
                                                 for k, v in prefix.items()))
        tenants = last.get("tenants")
        if isinstance(tenants, dict) and tenants:
            # per-tenant attribution (serve/telemetry.py _TenantStats);
            # the full per-request story lives in tools/request_report
            for name in sorted(tenants):
                snap = tenants[name]
                if isinstance(snap, dict):
                    cells = " ".join(
                        f"{k}={v}" for k, v in sorted(snap.items()))
                    print(f"  tenant {name}: {cells}")
    if os.path.exists(os.path.join(rep["output_dir"],
                                   "request_trace.jsonl")):
        print("\n  per-request span trees found: render waterfalls with "
              f"python -m llama_pipeline_parallel_tpu_torch.tools.request_report "
              f"{rep['output_dir']}")
    if rep["health_goodput"] is not None:
        print(f"\n  serve goodput (health.json): "
              f"{100 * rep['health_goodput']:.1f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
