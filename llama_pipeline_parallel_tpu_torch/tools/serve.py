"""Continuous-batching inference service over a native checkpoint.

The counterpart of the JAX package's tools/serve.py (docs/SERVING.md):
loads a checkpoint of the port's trainer (the train->serve handoff — any
training checkpoint's canonical layout loads straight into the decode
stack via `ckpt.checkpoint.load_module_checkpoint`), builds a
`serve.ServeEngine` on `--device` (default cuda; a missing card is
refused), exposes the JSON HTTP endpoint, and emits the SAME run telemetry
as a trainer — spans.jsonl (TTFT/TPOT/queue-wait per request),
metrics.jsonl (serving SLO percentile lines), and the health.json
heartbeat — so `tools.goodput_report` / `tools.serving_report` read its run
directory like any other.

    python -m llama_pipeline_parallel_tpu_torch.tools.serve \
        --checkpoint_dir /ckpts/run1 --output_dir /runs/serve1 --port 8000 \
        --max_slots 8 --max_len 2048

The checkpoint's fp32 masters are read on the host and the engine keeps
one compute-dtype copy on the device.

The engine loop runs on the MAIN thread (serve_prefill/serve_decode_step
spans feed the RunClock's `serve` bucket — goodput for a serve process is
the fraction of wall-clock spent producing tokens); HTTP handler threads
only block on request handles. SIGTERM/SIGINT stop ADMISSIONS, drain
in-flight and queued requests for up to --drain_s (size it inside the
supervisor's grace), then exit 0 — the preemption contract: a routine
stop must not 500 the requests already decoding.

`serve.json` in the output dir records the bound port + pid atomically, so
clients (and the multi-replica chaos test) can find a restarted replica.
LPT_SERVE_STEP_DELAY_S stretches every decode step (chaos hook: gives the
kill-mid-decode test a deterministic window; never set it in production).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time


def write_serve_json(output_dir: str, payload: dict) -> None:
    """Atomic `serve.json` rewrite: a polling client never reads a torn
    file. Reuses the checkpoint layer's crash-safe writer (tmp + fsync +
    os.replace under the storage retry policy) instead of a third
    hand-rolled copy."""
    from llama_pipeline_parallel_tpu_torch.ckpt.checkpoint import _write_file_atomic

    _write_file_atomic(os.path.join(output_dir, "serve.json"),
                       json.dumps(payload, indent=2))


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda",
                   help="where the engine runs (default cuda; 'cpu' serves "
                        "on the host)")
    p.add_argument("--checkpoint_dir", required=True)
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--output_dir", required=True,
                   help="telemetry home: spans/metrics/health/serve.json")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="0 picks an ephemeral port (recorded in serve.json)")
    p.add_argument("--max_slots", type=int, default=8)
    p.add_argument("--max_len", type=int, default=2048,
                   help="per-slot KV capacity (prompt bucket + new tokens)")
    p.add_argument("--buckets", default="64,128,256,512,1024",
                   help="ascending prompt bucket lengths")
    p.add_argument("--max_queue", type=int, default=64)
    p.add_argument("--kv_cache", default="dense", choices=("dense", "paged"),
                   help="paged: fixed-size KV pages + slot->page table — "
                        "device memory tracks tokens actually generated "
                        "(docs/SERVING.md)")
    p.add_argument("--page_size", type=int, default=64,
                   help="tokens per KV page (paged only)")
    p.add_argument("--num_pages", type=int, default=None,
                   help="page-pool size; default = dense-equivalent "
                        "(max_slots * max_len / page_size)")
    p.add_argument("--kv_quant", default="fp", choices=("fp", "int8"),
                   help="int8: quantized KV pages with per-page scales, "
                        "fp32 dequant on read (paged only)")
    p.add_argument("--prefill_chunk_tokens", type=int, default=0,
                   help="per-tick prefill token budget; buckets above it "
                        "prefill in chunks interleaved with decode ticks "
                        "(paged only; 0 = whole-prompt admissions)")
    p.add_argument("--prefix_cache", action="store_true",
                   help="share physical KV pages between requests with "
                        "identical prompt prefixes: cache hits skip the "
                        "shared span's prefill and reserve only their new "
                        "pages (paged only; docs/SERVING.md 'Prefix "
                        "caching')")
    p.add_argument("--metrics_every", type=int, default=16,
                   help="completed requests per serving metrics line")
    p.add_argument("--health_interval", type=float, default=10.0,
                   help="health.json heartbeat cadence in seconds (size "
                        "fleet heartbeat_stale_s alerts above this)")
    p.add_argument("--idle_poll_s", type=float, default=0.02)
    p.add_argument("--drain_s", type=float, default=15.0,
                   help="after SIGTERM/SIGINT: seconds to finish in-flight "
                        "and queued requests before failing the remainder "
                        "(keep below a supervisor's grace period)")
    p.add_argument("--timeline", action="store_true",
                   help="write a per-tick timeline.jsonl (prefill-chunk vs "
                        "decode-step wall split — the serving half of the "
                        "schedule observatory, docs/OBSERVABILITY.md "
                        "'Timelines')")
    p.add_argument("--slo_ttft_ms", type=float, default=None,
                   help="TTFT SLO in ms: breaches count on the metrics "
                        "line and fire a bounded profiler capture under "
                        "<output_dir>/captures (docs/OBSERVABILITY.md "
                        "'Triggered capture')")
    p.add_argument("--slo_queue_wait_ms", type=float, default=None,
                   help="queue-wait SLO in ms (same breach handling)")
    p.add_argument("--capture_max", type=int, default=3,
                   help="retention cap for SLO-breach profiler captures")
    p.add_argument("--request_trace", action="store_true",
                   help="per-request span trees to request_trace.jsonl "
                        "(one line per completed/shed request) + the "
                        "slowest-K exemplar snapshot — the request "
                        "observatory (docs/SERVING.md 'Request tracing'); "
                        "off by default: OFF adds no per-token cost")
    p.add_argument("--trace_exemplars", type=int, default=8,
                   help="slowest-K requests kept with full span trees in "
                        "request_trace_exemplars.json (--request_trace)")
    args = p.parse_args(argv)

    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda needs a CUDA device; pass --device cpu to serve on the host")

    from llama_pipeline_parallel_tpu_torch.ckpt.checkpoint import (
        load_module_checkpoint,
    )
    from llama_pipeline_parallel_tpu_torch.serve import (
        ServeConfig,
        ServeEngine,
    )
    from llama_pipeline_parallel_tpu_torch.serve.frontend import make_server
    from llama_pipeline_parallel_tpu_torch.utils import trace
    from llama_pipeline_parallel_tpu_torch.utils.metrics import MetricsWriter

    t_start = time.time()
    os.makedirs(args.output_dir, exist_ok=True)
    trace.configure(args.output_dir)
    clock = trace.RunClock(prior=trace.load_health(args.output_dir))
    trace.recorder().add_listener(clock.on_span)

    params, cfg, manifest, step = load_module_checkpoint(
        args.checkpoint_dir, args.step, device="cpu")
    serve_cfg = ServeConfig(
        max_slots=args.max_slots, max_len=args.max_len,
        prompt_buckets=tuple(int(b) for b in args.buckets.split(",")),
        max_queue=args.max_queue, metrics_every=args.metrics_every,
        kv_cache=args.kv_cache, page_size=args.page_size,
        num_pages=args.num_pages, kv_quant=args.kv_quant,
        prefill_chunk_tokens=args.prefill_chunk_tokens,
        prefix_cache=args.prefix_cache)
    writer = MetricsWriter(args.output_dir)
    tl_writer = None
    if args.timeline:
        from llama_pipeline_parallel_tpu_torch.utils.timeline import TimelineWriter

        tl_writer = TimelineWriter(
            os.path.join(args.output_dir, "timeline.jsonl"))
    from llama_pipeline_parallel_tpu_torch.utils.profiler import (
        CaptureConfig,
        TriggeredProfiler,
    )

    # the profiler is ALWAYS armed: without SLO thresholds it captures
    # nothing on its own, but its capture.trigger poll is what lets a
    # fleet-level alert (tools.fleetd) reach this replica for a
    # bounded trace (docs/OBSERVABILITY.md "Fleet")
    prof = TriggeredProfiler(
        CaptureConfig(zscore=0.0, max_captures=args.capture_max,
                      window_steps=8),
        args.output_dir)
    slo = None
    if args.slo_ttft_ms is not None or args.slo_queue_wait_ms is not None:
        from llama_pipeline_parallel_tpu_torch.serve.telemetry import SLOThresholds

        slo = SLOThresholds(
            ttft_s=(args.slo_ttft_ms / 1000.0
                    if args.slo_ttft_ms is not None else None),
            queue_wait_s=(args.slo_queue_wait_ms / 1000.0
                          if args.slo_queue_wait_ms is not None else None))
    reqtrace_rec = None
    if args.request_trace:
        from llama_pipeline_parallel_tpu_torch.serve.reqtrace import (
            RequestTraceRecorder,
        )

        reqtrace_rec = RequestTraceRecorder(
            args.output_dir, exemplar_k=args.trace_exemplars)
    engine = ServeEngine(params, cfg, serve_cfg, metrics_writer=writer,
                         timeline=tl_writer, profiler=prof, slo=slo,
                         reqtrace=reqtrace_rec, device=args.device)
    del params   # the engine holds its compute-dtype copy

    server = make_server(engine, args.host, args.port)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="serve-http").start()
    write_serve_json(args.output_dir, {
        "pid": os.getpid(), "host": args.host, "port": port,
        "checkpoint_dir": args.checkpoint_dir, "checkpoint_step": step,
        "kv_cache": serve_cfg.kv_cache, "started": t_start})

    # init window accounted like the trainer's: everything before the loop
    trace.recorder().emit("init", ts=t_start, dur=time.time() - t_start)
    hb_serve_cfg = {"max_slots": serve_cfg.max_slots,
                    "max_len": serve_cfg.max_len,
                    "prompt_buckets": list(serve_cfg.prompt_buckets),
                    "kv_cache": serve_cfg.kv_cache}
    if serve_cfg.kv_cache == "paged":
        hb_serve_cfg.update(
            page_size=serve_cfg.page_size,
            num_pages=serve_cfg.resolved_num_pages,
            kv_quant=serve_cfg.kv_quant,
            prefill_chunk_tokens=serve_cfg.prefill_chunk_tokens,
            prefix_cache=serve_cfg.prefix_cache)
    hb = trace.Heartbeat(
        args.output_dir, clock, interval=args.health_interval,
        static={"role": "serve", "port": port,
                "checkpoint_step": step,
                "serve_config": hb_serve_cfg})

    stop = threading.Event()

    def _stop(signum, _frame):
        print(f"[serve] signal {signum}: draining to clean exit", flush=True)
        stop.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _stop)

    step_delay = float(os.environ.get("LPT_SERVE_STEP_DELAY_S", "0") or 0)
    kv_desc = f"{serve_cfg.max_slots} slots x {serve_cfg.max_len} kv"
    if serve_cfg.kv_cache == "paged":
        kv_desc = (f"{serve_cfg.max_slots} slots over "
                   f"{serve_cfg.resolved_num_pages} x "
                   f"{serve_cfg.page_size}-token {serve_cfg.kv_quant} pages"
                   + (f", prefill chunk {serve_cfg.prefill_chunk_tokens}"
                      if serve_cfg.prefill_chunk_tokens else "")
                   + (", prefix cache" if serve_cfg.prefix_cache else ""))
    print(f"[serve] ready on {args.host}:{port} — checkpoint step {step}, "
          f"{kv_desc}, buckets {serve_cfg.prompt_buckets}", flush=True)
    try:
        while not stop.is_set():
            did_work = engine.step()
            if did_work:
                hb.beat(engine.steps)
                if step_delay:
                    time.sleep(step_delay)
            else:
                # an idle replica must still honor a fleet capture trigger
                # AND advance an open capture window (the engine only does
                # either inside work ticks — without this, an idle-started
                # capture would trace nothing, unbounded, until traffic)
                prof.observe_step(engine.steps)
                engine._work.wait(args.idle_poll_s)
        # graceful drain: HTTP stays UP but every new submit sheds with a
        # coherent 429 + honest Retry-After (degraded-mode admission,
        # docs/RESILIENCE.md "Actuation") while in-flight and queued
        # requests finish — the stop contract; whatever outlives the
        # window is failed by engine.shutdown() below
        engine.set_degraded("draining")
        deadline = time.monotonic() + args.drain_s
        while ((engine.slots.active_count or engine.queue_depth())
               and time.monotonic() < deadline):
            if engine.step():
                hb.beat(engine.steps)
            else:  # unreachable in practice; never busy-spin the drain
                time.sleep(0.01)
        if engine.slots.active_count or engine.queue_depth():
            print(f"[serve] drain window ({args.drain_s:.0f}s) expired with "
                  f"{engine.slots.active_count} active / "
                  f"{engine.queue_depth()} queued; failing them", flush=True)
    finally:
        server.shutdown()
        engine.shutdown()
        snap = engine.metrics_snapshot()
        if engine.stats.completed:
            writer.log(engine.stats.completed, snap)
            # the serve loop's perf-ledger contribution: measured SLO
            # latencies (no analytic halves yet — the pairing the serving
            # cost models of a future PR will fill in)
            from llama_pipeline_parallel_tpu_torch.utils import perf

            perf.append_rows(
                os.path.join(args.output_dir, "perf.jsonl"),
                [perf.make_row(f"serve:{k}", measured=snap[k], unit="ms",
                               source="serve", run=args.output_dir)
                 for k in ("ttft_p50_ms", "ttft_p95_ms", "tpot_p50_ms",
                           "queue_wait_p95_ms") if k in snap])
        writer.close()
        if tl_writer is not None:
            tl_writer.close()
        if reqtrace_rec is not None:
            reqtrace_rec.close()
        hb.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
