"""Synthetic serving traffic: Poisson arrivals, prompt/output length mixes.

The counterpart of the JAX package's tools/serve_traffic.py, over the
port's engine (`--device`, default cuda) and its HTTP frontend.

Turns the serving tier's SLO claims into measured curves: a seeded,
deterministic request trace (exponential inter-arrival gaps at `--rate`
requests/s; prompt and output lengths drawn from weighted mixes like
`"64:0.7,256:0.3"`) is replayed against a live `ServeEngine` in-process,
and the run summary reports what the engine actually did under load —
completions, page/queue refusals, TTFT/TPOT percentiles, prefill-chunk
cadence. The library functions (`poisson_trace` / `run_trace` /
`run_trace_gateway`) are what tests and chip_smoke.py drive.

    python -m llama_pipeline_parallel_tpu_torch.tools.serve_traffic \
        --checkpoint_dir /ckpts/run1 \
        --rate 8 --requests 64 --prompt_mix 64:0.6,256:0.4 \
        --output_mix 16:0.5,64:0.5 --kv_cache paged --page_size 64 \
        --prefill_chunk_tokens 256

Determinism: the trace depends only on (seed, rate, n, mixes) — two runs
against the same checkpoint see identical arrivals, prompts, and sampling
seeds. Wall-clock replay obviously isn't deterministic; the trace is.

`--gateway URL` replays the SAME trace over HTTP, streaming, instead of an
in-process engine — no checkpoint load in this process: against the
routing tier (`tools.gateway`) the summary
gains its per-request attempt/replay/hedge counts; against one serve
process (`tools.serve`'s own /v1/generate) it is a plain HTTP client.
`--chaos kill:<t_s>` pairs with it: SIGKILL the replica named by
`--chaos_target` (its serve.json pid) at trace offset t_s, turning the run
into the failover acceptance drill — the summary then shows how many
requests were replayed to a survivor.
Gateway mode adds NO RNG draws: arrivals, prompts, and seeds come from
the identical `poisson_trace` stream, so a gateway run and an in-process
run of the same (seed, rate, n, mixes) serve identical requests.
"""

from __future__ import annotations

import argparse
import dataclasses
import http.client
import json
import os
import re
import signal
import sys
import threading
import time
import zlib

import numpy as np


@dataclasses.dataclass(frozen=True)
class TrafficRequest:
    arrival_s: float        # offset from trace start
    prompt_len: int         # tail length when a prefix class is stamped
    max_new_tokens: int
    seed: int
    tenant: str | None = None   # SLO class (per-tenant attribution)
    # shared-prefix workload class (--prefix_mix): requests in the same
    # class share a seeded common prefix of `prefix_len` tokens ahead of
    # their per-seed tail — the prefix-cache hit population
    prefix: str | None = None
    prefix_len: int = 0


def parse_mix(spec: str) -> tuple[tuple[int, float], ...]:
    """`"64:0.7,256:0.3"` -> ((64, 0.7), (256, 0.3)), weights normalized.
    A bare `"64"` means a single length at weight 1."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        length, _, weight = part.partition(":")
        out.append((int(length), float(weight) if weight else 1.0))
    if not out:
        raise ValueError(f"empty length mix {spec!r}")
    total = sum(w for _, w in out)
    if total <= 0 or any(w < 0 for _, w in out) or any(n < 1 for n, _ in out):
        raise ValueError(f"mix {spec!r} needs positive lengths and "
                         f"non-negative weights summing > 0")
    return tuple((n, w / total) for n, w in out)


def mix_label(mix: tuple[tuple[int, float], ...]) -> str:
    """Canonical `len:weight` string — the form bench rows record."""
    return ",".join(f"{n}:{round(w, 4)}" for n, w in mix)


def parse_tenant_mix(spec: str) -> tuple[tuple[str, float], ...]:
    """`"free:0.8,paid:0.2"` -> (("free", 0.8), ("paid", 0.2)), weights
    normalized — the tenant counterpart of `parse_mix`. A bare `"paid"`
    means one tenant at weight 1."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, weight = part.partition(":")
        if not name:
            raise ValueError(f"tenant mix {spec!r} has an empty tenant name")
        out.append((name, float(weight) if weight else 1.0))
    if not out:
        raise ValueError(f"empty tenant mix {spec!r}")
    total = sum(w for _, w in out)
    if total <= 0 or any(w < 0 for _, w in out):
        raise ValueError(f"tenant mix {spec!r} needs non-negative weights "
                         f"summing > 0")
    return tuple((name, w / total) for name, w in out)


def tenant_mix_label(mix: tuple[tuple[str, float], ...]) -> str:
    return ",".join(f"{name}:{round(w, 4)}" for name, w in mix)


def parse_prefix_mix(spec: str) -> tuple[tuple[str, int, float], ...]:
    """`"sys512:0.9,cold:0.1"` -> (("sys512", 512, 0.9), ("cold", 0, 0.1)):
    trailing digits in an entry name are its shared-prefix token count
    (every request in that class gets the SAME seeded prefix of that many
    tokens ahead of its per-request tail); a digitless name like `cold`
    is a no-prefix class. Weights normalize like the other mixes."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, weight = part.partition(":")
        if not name:
            raise ValueError(f"prefix mix {spec!r} has an empty class name")
        m = re.search(r"(\d+)$", name)
        out.append((name, int(m.group(1)) if m else 0,
                    float(weight) if weight else 1.0))
    if not out:
        raise ValueError(f"empty prefix mix {spec!r}")
    total = sum(w for _, _, w in out)
    if total <= 0 or any(w < 0 for _, _, w in out):
        raise ValueError(f"prefix mix {spec!r} needs non-negative weights "
                         f"summing > 0")
    return tuple((name, n, w / total) for name, n, w in out)


def prefix_mix_label(mix: tuple[tuple[str, int, float], ...]) -> str:
    return ",".join(f"{name}:{round(w, 4)}" for name, _, w in mix)


def prefix_ids(name: str, length: int, vocab: int,
               low: int = 3) -> list[int]:
    """The shared prefix token ids of class `name`: seeded by the class
    name alone, so every request in the class — across traces and runs —
    shares the exact same tokens (a system prompt, in effect)."""
    rs = np.random.RandomState(zlib.crc32(name.encode()) & 0x7FFFFFFF)
    return rs.randint(low, vocab, size=length).tolist()


def poisson_trace(seed: int, rate_rps: float, n_requests: int,
                  prompt_mix, output_mix, tenant_mix=None,
                  prefix_mix=None) -> list[TrafficRequest]:
    """A deterministic Poisson arrival trace: exponential inter-arrival
    gaps at `rate_rps`, lengths drawn independently from the two mixes.
    Each request carries its own sampling seed (derived from the trace
    seed), so replaying a trace is reproducible end-to-end. `tenant_mix`
    (parse_tenant_mix) additionally stamps each request with a weighted
    tenant draw — all tenant draws happen AFTER the whole length/seed
    stream, so a tenantless trace is bit-identical to one generated
    before tenants existed and stamping tenants changes ONLY the tenant
    field. `prefix_mix` (parse_prefix_mix) stamps a shared-prefix class
    the same way — its draws come AFTER the tenant stream, so untenanted,
    unprefixed traces stay tuple-identical across all three vintages."""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1, got {n_requests}")
    rs = np.random.RandomState(seed)
    gaps = rs.exponential(1.0 / rate_rps, size=n_requests)
    arrivals = np.cumsum(gaps) - gaps[0]          # first request at t=0
    p_lens = [n for n, _ in prompt_mix]
    p_w = [w for _, w in prompt_mix]
    o_lens = [n for n, _ in output_mix]
    o_w = [w for _, w in output_mix]
    draws = []
    for i in range(n_requests):
        prompt_len = int(rs.choice(p_lens, p=p_w))
        max_new = int(rs.choice(o_lens, p=o_w))
        req_seed = int(rs.randint(0, 2**31 - 1))
        draws.append((prompt_len, max_new, req_seed))
    if tenant_mix:
        t_names = [name for name, _ in tenant_mix]
        t_w = [w for _, w in tenant_mix]
        tenants = [str(rs.choice(t_names, p=t_w))
                   for _ in range(n_requests)]
    else:
        tenants = [None] * n_requests
    if prefix_mix:
        p_names = list(range(len(prefix_mix)))
        p_pw = [w for _, _, w in prefix_mix]
        picks = [int(rs.choice(p_names, p=p_pw)) for _ in range(n_requests)]
        prefixes = [(prefix_mix[j][0], prefix_mix[j][1]) for j in picks]
    else:
        prefixes = [(None, 0)] * n_requests
    return [TrafficRequest(arrival_s=float(arrivals[i]), prompt_len=pl,
                           max_new_tokens=mn, seed=sd, tenant=tenants[i],
                           prefix=prefixes[i][0],
                           prefix_len=prefixes[i][1])
            for i, (pl, mn, sd) in enumerate(draws)]


def run_trace(engine, trace_requests, time_scale: float = 1.0,
              prompt_token_low: int = 3,
              result_timeout_s: float = 300.0,
              collect_tokens: bool = False) -> dict:
    """Replay a trace against a live engine (a ServeLoop is started for
    the duration): submit each request at its (scaled) arrival offset,
    count refusals by kind, wait for every accepted request, and return
    the run summary. Prompt token ids are drawn deterministically from
    the request's seed; a TrafficRequest's tenant is stamped onto the
    ServeRequest, so per-tenant SLO slices and request traces attribute
    it. `collect_tokens=True` adds `tokens` to the summary — one entry
    per trace request, index-aligned (None for refused requests) — the
    fixture the tracing-ON/OFF parity twin compares bit-for-bit."""
    from llama_pipeline_parallel_tpu_torch.models.llama.decode import (
        GenerationConfig,
    )
    from llama_pipeline_parallel_tpu_torch.serve import (
        RequestRejected,
        ServeLoop,
        ServeOverloaded,
        ServePagesExhausted,
        ServeRequest,
    )

    vocab = engine.cfg.vocab_size
    handles = []                 # (trace index, handle)
    refused_pages = refused_overload = rejected = 0
    submitted_by_tenant: dict[str, int] = {}
    t0 = time.monotonic()
    with ServeLoop(engine, idle_wait_s=0.002):
        for i, tr in enumerate(trace_requests):
            target = t0 + tr.arrival_s * time_scale
            delay = target - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            prompt = np.random.RandomState(tr.seed).randint(
                prompt_token_low, vocab, size=tr.prompt_len).tolist()
            if tr.prefix_len:
                # shared-prefix class: the class prefix ahead of the
                # per-seed tail — same tail-length class means same total
                # length, same bucket pad, real page sharing
                prompt = prefix_ids(tr.prefix, tr.prefix_len, vocab,
                                    prompt_token_low) + prompt
            req = ServeRequest(
                input_ids=prompt,
                gen=GenerationConfig(max_new_tokens=tr.max_new_tokens),
                seed=tr.seed, tenant=tr.tenant)
            try:
                handles.append((i, engine.submit(req)))
                if tr.tenant:
                    submitted_by_tenant[tr.tenant] = \
                        submitted_by_tenant.get(tr.tenant, 0) + 1
            except ServePagesExhausted:
                refused_pages += 1
            except ServeOverloaded:
                refused_overload += 1
            except RequestRejected:
                rejected += 1
        tokens_by_index: dict[int, list] = {}
        for i, h in handles:
            try:
                tokens_by_index[i] = h.result(timeout=result_timeout_s)
            except Exception:
                pass  # counted via the engine's failed/rejected counters
    wall = time.monotonic() - t0
    snap = engine.metrics_snapshot()
    summary = {
        "requests": len(trace_requests),
        "submitted": len(handles),
        "refused_pages": refused_pages,
        "refused_overload": refused_overload,
        "rejected_shape": rejected,
        "wall_s": round(wall, 3),
        **{k: snap[k] for k in snap
           if k.startswith(("ttft_", "tpot_", "queue_wait_", "prefix_"))
           or k in ("requests_completed", "requests_failed",
                    "tokens_generated", "prefill_chunks_total",
                    "prefill_tokens_total", "pages_total")},
    }
    if submitted_by_tenant:
        summary["submitted_by_tenant"] = dict(
            sorted(submitted_by_tenant.items()))
    if any(tr.prefix is not None for tr in trace_requests):
        # per-class hit rate: what fraction of each prefix class's
        # SUBMITTED requests were served a cached prefix (the engine-side
        # counters aggregate across classes; this is the mix breakdown)
        per: dict[str, dict] = {}
        for i, h in handles:
            name = trace_requests[i].prefix or "cold"
            d = per.setdefault(name, {"submitted": 0, "hits": 0,
                                      "cached_tokens": 0})
            d["submitted"] += 1
            if h.prefix_cached_tokens > 0:
                d["hits"] += 1
                d["cached_tokens"] += h.prefix_cached_tokens
        for d in per.values():
            d["hit_rate"] = round(d["hits"] / d["submitted"], 4)
        summary["prefix_classes"] = dict(sorted(per.items()))
    if "tenants" in snap:
        summary["tenants"] = snap["tenants"]
    if collect_tokens:
        summary["tokens"] = [tokens_by_index.get(i)
                             for i in range(len(trace_requests))]
    if wall > 0:
        summary["tokens_per_sec"] = round(
            snap.get("tokens_generated", 0) / wall, 2)
    return summary


def parse_chaos(spec: str) -> tuple[str, float]:
    """`"kill:2.5"` -> ("kill", 2.5): SIGKILL the --chaos_target replica
    at trace offset 2.5s (scaled by --time_scale like arrivals)."""
    kind, _, at = spec.partition(":")
    if kind != "kill" or not at:
        raise ValueError(f"chaos spec {spec!r}: expected 'kill:<t_s>'")
    t_s = float(at)
    if t_s < 0:
        raise ValueError(f"chaos offset must be >= 0, got {t_s}")
    return kind, t_s


def kill_replica(replica_dir: str) -> int | None:
    """SIGKILL the serve process whose serve.json lives in `replica_dir`;
    returns the pid killed, or None when there is nothing to kill (the
    chaos drill racing a supervisor relaunch is expected, not an error)."""
    try:
        with open(os.path.join(replica_dir, "serve.json")) as f:
            pid = int(json.load(f)["pid"])
        os.kill(pid, signal.SIGKILL)
        return pid
    except (OSError, ValueError, KeyError):
        return None


def _gateway_addr(url: str) -> tuple[str, int]:
    hostport = url.split("//", 1)[-1].rstrip("/")
    host, _, port = hostport.partition(":")
    return host or "127.0.0.1", int(port or 80)


def _gateway_one(host: str, port: int, body: dict, timeout_s: float,
                 results: list, i: int) -> None:
    """One streamed request through the gateway; results[i] gets
    {"status", "tokens", "attempts", "replays", "hedges"} or
    {"status", "error"} — connection death (the gateway itself dying,
    not a replica: replica deaths are absorbed by replay) is an error."""
    out: dict = {"status": 0}
    try:
        conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
        conn.request("POST", "/v1/generate", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        out["status"] = resp.status
        if resp.status != 200:
            try:
                out["error"] = json.loads(resp.read() or b"{}").get("error")
            except ValueError:
                out["error"] = f"http {resp.status}"
            return
        tokens, tail = [], None
        while True:
            raw = resp.readline()
            if not raw:
                break
            line = json.loads(raw)
            if line.get("done"):
                tail = line
                break
            tokens.append(line["token"])
        if tail is None:
            out.update(status=0, error="stream ended without done line")
            return
        if "error" in tail:
            out.update(status=500, error=tail["error"])
            return
        out.update(tokens=tail.get("tokens", tokens),
                   attempts=int(tail.get("attempts", 1)),
                   replays=int(tail.get("replays", 0)),
                   hedges=int(tail.get("hedges", 0)))
    except (OSError, ValueError) as e:
        out.setdefault("error", repr(e))
        out["status"] = out.get("status") or 0
    finally:
        results[i] = out


def gateway_healthz(gateway_url: str, timeout_s: float = 5.0) -> dict:
    host, port = _gateway_addr(gateway_url)
    conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
    conn.request("GET", "/healthz")
    return json.loads(conn.getresponse().read())


def run_trace_gateway(gateway_url: str, trace_requests, vocab: int,
                      time_scale: float = 1.0, prompt_token_low: int = 3,
                      result_timeout_s: float = 300.0,
                      collect_tokens: bool = False,
                      chaos: tuple[str, float] | None = None,
                      chaos_target: str | None = None) -> dict:
    """Replay a trace through the gateway tier over HTTP: one streaming
    POST per request at its (scaled) arrival offset, each read to its
    done line on a worker thread. Prompts are drawn exactly as
    `run_trace` draws them — same RandomState(seed) stream — so the two
    modes serve identical requests. `chaos=("kill", t_s)` SIGKILLs the
    `chaos_target` replica at trace offset t_s; requests in flight on it
    are the gateway's replay population, and the summary's `replayed` /
    `attempts_total` report what the failover actually did."""
    host, port = _gateway_addr(gateway_url)
    n = len(trace_requests)
    results: list = [None] * n
    threads: list[threading.Thread] = []
    t0 = time.monotonic()
    chaos_timer = None
    if chaos is not None:
        if not chaos_target:
            raise ValueError("chaos needs a chaos_target replica dir")
        kind, t_s = chaos
        chaos_timer = threading.Timer(t_s * time_scale, kill_replica,
                                      args=(chaos_target,))
        chaos_timer.daemon = True
        chaos_timer.start()
    for i, tr in enumerate(trace_requests):
        target = t0 + tr.arrival_s * time_scale
        delay = target - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        prompt = np.random.RandomState(tr.seed).randint(
            prompt_token_low, vocab, size=tr.prompt_len).tolist()
        if tr.prefix_len:
            prompt = prefix_ids(tr.prefix, tr.prefix_len, vocab,
                                prompt_token_low) + prompt
        body = {"input_ids": prompt, "seed": tr.seed, "stream": True,
                "max_new_tokens": tr.max_new_tokens}
        if tr.tenant:
            body["tenant"] = tr.tenant
        t = threading.Thread(target=_gateway_one,
                             args=(host, port, body, result_timeout_s,
                                   results, i), daemon=True)
        t.start()
        threads.append(t)
    deadline = time.monotonic() + result_timeout_s
    for t in threads:
        t.join(timeout=max(0.1, deadline - time.monotonic()))
    if chaos_timer is not None:
        chaos_timer.cancel()
    wall = time.monotonic() - t0
    done = [r or {"status": 0, "error": "no response"} for r in results]
    completed = [r for r in done if r["status"] == 200 and "error" not in r]
    summary = {
        "requests": n,
        "submitted": sum(1 for r in done if r["status"] == 200),
        "completed": len(completed),
        "failed": sum(1 for r in done
                      if r["status"] in (0, 500)
                      or (r["status"] == 200 and "error" in r)),
        "refused_overload": sum(1 for r in done
                                if r["status"] in (429, 503)),
        "rejected_shape": sum(1 for r in done if r["status"] == 400),
        "attempts_total": sum(r.get("attempts", 0) for r in completed),
        "replayed": sum(1 for r in completed if r.get("replays", 0) > 0),
        "hedged": sum(1 for r in completed if r.get("hedges", 0) > 0),
        "wall_s": round(wall, 3),
    }
    try:
        snap = gateway_healthz(gateway_url)
        summary["gateway"] = {k: snap[k] for k in (
            "requests_routed", "requests_retried", "requests_replayed",
            "requests_hedged", "hedge_wins", "wasted_hedge_tokens",
            "replay_skipped_tokens", "requests_completed",
            "requests_failed", "requests_shed", "ttft_p50_ms",
            "ttft_p95_ms", "replicas_known", "replicas_healthy")
            if k in snap}
    except (OSError, ValueError):
        pass  # gateway gone at drain time: the per-request view stands
    if collect_tokens:
        summary["tokens"] = [r.get("tokens") for r in done]
    return summary


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda",
                   help="where the in-process engine runs (default cuda)")
    p.add_argument("--checkpoint_dir", default=None,
                   help="required unless --gateway drives a remote tier")
    p.add_argument("--gateway", default=None, metavar="URL",
                   help="replay the trace over HTTP through a gateway or "
                        "a serve process's frontend instead of an "
                        "in-process engine — no checkpoint load here")
    p.add_argument("--vocab", type=int, default=32000,
                   help="vocab size for prompt draws in --gateway mode "
                        "(in-process mode reads it off the checkpoint)")
    p.add_argument("--chaos", default=None, metavar="SPEC",
                   help="failure drill in --gateway mode: 'kill:<t_s>' "
                        "SIGKILLs the --chaos_target replica at trace "
                        "offset t_s (scaled by --time_scale)")
    p.add_argument("--chaos_target", default=None,
                   help="replica output dir whose serve.json pid the "
                        "--chaos drill kills")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rate", type=float, default=4.0, help="requests/s")
    p.add_argument("--requests", type=int, default=32)
    p.add_argument("--prompt_mix", default="64:0.7,256:0.3")
    p.add_argument("--output_mix", default="16:0.5,64:0.5")
    p.add_argument("--tenant_mix", default=None,
                   help="weighted tenant mix like 'free:0.8,paid:0.2': "
                        "stamps each generated request's tenant for "
                        "per-tenant SLO slices and request traces")
    p.add_argument("--prefix_mix", default=None,
                   help="shared-prefix workload mix like "
                        "'sys512:0.9,cold:0.1': trailing digits are the "
                        "class's common seeded prefix length in tokens "
                        "ahead of each request's tail (digitless = no "
                        "prefix); pair with --prefix_cache to measure "
                        "hit-rate TTFT wins")
    p.add_argument("--prefix_cache", action="store_true",
                   help="enable the engine's prefix cache (paged only)")
    p.add_argument("--time_scale", type=float, default=1.0,
                   help="replay arrivals at 1/time_scale speed")
    p.add_argument("--output_dir", default=None,
                   help="where --request_trace artifacts land (optional "
                        "otherwise)")
    p.add_argument("--request_trace", action="store_true",
                   help="attach a RequestTraceRecorder to the engine: "
                        "request_trace.jsonl + exemplars in --output_dir "
                        "(requires --output_dir)")
    p.add_argument("--trace_exemplars", type=int, default=8)
    # engine shape (mirrors tools/serve)
    p.add_argument("--max_slots", type=int, default=8)
    p.add_argument("--max_len", type=int, default=2048)
    p.add_argument("--buckets", default="64,128,256,512,1024")
    p.add_argument("--max_queue", type=int, default=64)
    p.add_argument("--kv_cache", default="dense", choices=("dense", "paged"))
    p.add_argument("--page_size", type=int, default=64)
    p.add_argument("--num_pages", type=int, default=None)
    p.add_argument("--kv_quant", default="fp", choices=("fp", "int8"))
    p.add_argument("--prefill_chunk_tokens", type=int, default=0)
    args = p.parse_args(argv)

    prompt_mix = parse_mix(args.prompt_mix)
    output_mix = parse_mix(args.output_mix)
    tenant_mix = (parse_tenant_mix(args.tenant_mix)
                  if args.tenant_mix else None)
    prefix_mix = (parse_prefix_mix(args.prefix_mix)
                  if args.prefix_mix else None)
    if args.request_trace and not args.output_dir:
        p.error("--request_trace requires --output_dir")
    if args.chaos and not args.gateway:
        p.error("--chaos is a --gateway mode drill")
    if args.chaos and not args.chaos_target:
        p.error("--chaos requires --chaos_target")

    if args.gateway:
        # gateway mode: same trace, over HTTP — this process never
        # touches torch or the checkpoint
        trace_requests = poisson_trace(args.seed, args.rate, args.requests,
                                       prompt_mix, output_mix,
                                       tenant_mix=tenant_mix,
                                       prefix_mix=prefix_mix)
        summary = run_trace_gateway(
            args.gateway, trace_requests, vocab=args.vocab,
            time_scale=args.time_scale,
            chaos=parse_chaos(args.chaos) if args.chaos else None,
            chaos_target=args.chaos_target)
        summary["mix"] = {"prompt": mix_label(prompt_mix),
                          "output": mix_label(output_mix),
                          "rate_rps": args.rate, "seed": args.seed}
        print(json.dumps(summary, indent=2))
        return 0

    if not args.checkpoint_dir:
        p.error("--checkpoint_dir is required without --gateway")
    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda needs a CUDA device; pass --device cpu")

    from llama_pipeline_parallel_tpu_torch.ckpt.checkpoint import (
        load_module_checkpoint,
    )
    from llama_pipeline_parallel_tpu_torch.serve import ServeConfig, ServeEngine

    params, cfg, _, step = load_module_checkpoint(args.checkpoint_dir,
                                                  args.step, device="cpu")
    reqtrace_rec = None
    if args.request_trace:
        from llama_pipeline_parallel_tpu_torch.serve.reqtrace import (
            RequestTraceRecorder,
        )

        reqtrace_rec = RequestTraceRecorder(
            args.output_dir, exemplar_k=args.trace_exemplars)
    engine = ServeEngine(params, cfg, ServeConfig(
        max_slots=args.max_slots, max_len=args.max_len,
        prompt_buckets=tuple(int(b) for b in args.buckets.split(",")),
        max_queue=args.max_queue, kv_cache=args.kv_cache,
        page_size=args.page_size, num_pages=args.num_pages,
        kv_quant=args.kv_quant,
        prefill_chunk_tokens=args.prefill_chunk_tokens,
        prefix_cache=args.prefix_cache),
        reqtrace=reqtrace_rec, device=args.device)
    trace_requests = poisson_trace(args.seed, args.rate, args.requests,
                                   prompt_mix, output_mix,
                                   tenant_mix=tenant_mix,
                                   prefix_mix=prefix_mix)
    summary = run_trace(engine, trace_requests, time_scale=args.time_scale)
    summary["mix"] = {"prompt": mix_label(prompt_mix),
                      "output": mix_label(output_mix),
                      "rate_rps": args.rate, "seed": args.seed}
    if tenant_mix is not None:
        summary["mix"]["tenant"] = tenant_mix_label(tenant_mix)
    if prefix_mix is not None:
        summary["mix"]["prefix"] = prefix_mix_label(prefix_mix)
    summary["checkpoint_step"] = step
    engine.shutdown()
    if reqtrace_rec is not None:
        reqtrace_rec.close()
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
