"""Offline tail-latency forensics from a request-trace directory.

The counterpart of the JAX package's tools/request_report.py, copied line
for line (the gateway's journal name comes from the port's serve/gateway.py).

Reads the artifacts a tracing-enabled serve run left behind —
`request_trace.jsonl` (one span tree per finished request, written by
serve/reqtrace.py) and `request_trace_exemplars.json` (the slowest-K
snapshot) — and answers "which request paid the p99 and WHERE":

- the p99-TTFT exemplar's waterfall (queue wait, admission verdict, each
  prefill chunk, first token, decode-tick summary), rendered against the
  request's own arrival time;
- a tail-attribution table decomposing tail TTFT into its phases —
  queue wait, the request's OWN prefill chunks, and the gap between them
  (time spent waiting behind a chunking neighbor's prefill ticks);
- per-tenant tables (counts, tokens, TTFT/TPOT percentiles) when the
  trace carries tenants;
- with `--gateway DIR`, the gateway-tier join: the routing tier's WAL
  (`gateway_journal.jsonl`, serve/gateway.py) joined to the replica's
  trace records by trace_id — one request's full dispatch history
  (every routed attempt, the replay after a replica died, the hedge that
  lost) next to the replica-side spans it produced, plus replay/hedge
  spans in the exemplar waterfall.

    python -m llama_pipeline_parallel_tpu_torch.tools.request_report /runs/serve1
    python -m llama_pipeline_parallel_tpu_torch.tools.request_report /runs/serve1 --json
    python -m llama_pipeline_parallel_tpu_torch.tools.request_report /runs/serve1 \
        --gateway /runs/gw

Degrades instead of tracebacking on missing/torn files (the
goodput_report contract): a crashed replica's directory must still
report whatever it managed to record.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from llama_pipeline_parallel_tpu_torch.serve.gateway import JOURNAL_NAME
from llama_pipeline_parallel_tpu_torch.serve.reqtrace import (
    EXEMPLARS_NAME,
    REQUEST_TRACE_NAME,
)
from llama_pipeline_parallel_tpu_torch.serve.telemetry import (
    percentiles_ms,
)


def load_trace(output_dir: str) -> list[dict]:
    """Parseable dict rows only — `perf.read_jsonl`, the one spelling of
    the tolerant reader (a torn tail or garbage line is skipped)."""
    from llama_pipeline_parallel_tpu_torch.utils.perf import read_jsonl

    return read_jsonl(os.path.join(output_dir, REQUEST_TRACE_NAME))


def load_exemplars(output_dir: str) -> dict:
    try:
        with open(os.path.join(output_dir, EXEMPLARS_NAME)) as f:
            snap = json.load(f)
        return snap if isinstance(snap, dict) else {}
    except (OSError, ValueError):
        return {}


def _num(v) -> float | None:
    return float(v) if isinstance(v, (int, float)) else None


def load_gateway_journal(gateway_dir: str) -> dict[str, dict]:
    """gid -> collapsed WAL state from a gateway dir's
    gateway_journal.jsonl (serve/gateway.py schema): intent ts + trace_id,
    every routed attempt, the high-water delivered mark, and the FIRST
    terminal row (the journal writer enforces exactly one; a torn rewrite
    never un-decides an outcome). perf.read_jsonl keeps this tolerant of
    torn tails — a crashed gateway's journal still reports."""
    from llama_pipeline_parallel_tpu_torch.utils.perf import read_jsonl

    by_gid: dict[str, dict] = {}
    for r in read_jsonl(os.path.join(gateway_dir, JOURNAL_NAME)):
        gid, kind = r.get("gid"), r.get("kind")
        if not isinstance(gid, str) or not isinstance(kind, str):
            continue
        st = by_gid.setdefault(gid, {
            "gid": gid, "trace_id": None, "intent_ts": None,
            "routed": [], "watermark": 0, "terminal": None})
        if kind == "intent":
            st["trace_id"] = r.get("trace_id")
            st["intent_ts"] = _num(r.get("ts"))
        elif kind == "routed":
            st["routed"].append({k: r.get(k) for k in
                                 ("replica", "attempt", "hedge", "ts")})
        elif kind == "watermark":
            st["watermark"] = max(st["watermark"],
                                  int(r.get("delivered") or 0))
        elif kind == "terminal" and st["terminal"] is None:
            st["terminal"] = {k: r.get(k) for k in
                              ("outcome", "tokens", "ts", "replays",
                               "hedges", "via") if r.get(k) is not None}
    return by_gid


def gateway_tables(by_gid: dict[str, dict],
                   records: list[dict]) -> dict:
    """The gateway join: WAL state keyed by gid, replica trace records
    attached by trace_id (a replayed request has ONE gid and trace_id but
    several replica records — the dead attempt's partial trace and the
    survivor's full one both join)."""
    recs_by_trace: dict[str, list[dict]] = {}
    for rec in records:
        tid = rec.get("trace_id")
        if isinstance(tid, str):
            recs_by_trace.setdefault(tid, []).append(rec)
    outcomes: dict[str, int] = {}
    replayed = hedged = orphans = joined = 0
    exemplar = None
    rows = []
    for gid in sorted(by_gid):
        st = by_gid[gid]
        term = st["terminal"]
        if term is None:
            orphans += 1
        else:
            outcomes[term["outcome"]] = outcomes.get(term["outcome"], 0) + 1
            if term.get("replays"):
                replayed += 1
            if term.get("hedges"):
                hedged += 1
        replica_recs = recs_by_trace.get(st["trace_id"], [])
        joined += bool(replica_recs)
        row = {**st, "replica_records": len(replica_recs),
               "replicas": sorted({r.get("replica") for r in st["routed"]
                                   if r.get("replica")})}
        rows.append(row)
        # the exemplar: the request with the busiest dispatch history
        # (most attempts; replays beat hedges at a tie) — the one whose
        # waterfall shows the failover machinery actually working
        busy = (len(st["routed"]),
                int((term or {}).get("replays") or 0))
        if st["routed"] and (exemplar is None or busy > exemplar[0]):
            exemplar = (busy, row, replica_recs)
    return {"requests": len(by_gid), "outcomes": dict(sorted(
                outcomes.items())),
            "replayed": replayed, "hedged": hedged, "orphans": orphans,
            "joined": joined, "rows": rows,
            "exemplar": None if exemplar is None
            else {"wal": exemplar[1], "records": exemplar[2]}}


def gateway_waterfall(wal: dict, replica_recs: list[dict]) -> list[str]:
    """Render one gateway request's dispatch history: each routed attempt
    as a span at its offset from the WAL intent row, replay/hedge marked,
    with the replica-side record (outcome + TTFT) it joins to."""
    t0 = wal.get("intent_ts")
    term = wal.get("terminal") or {}
    lines = [f"  gateway {wal['gid']} trace {wal.get('trace_id')} "
             f"outcome={term.get('outcome', 'ORPHANED')} "
             f"tokens={term.get('tokens')} watermark={wal.get('watermark')}"]
    by_attempt = {}
    for rec in replica_recs:
        att = (rec.get("gateway") or {}).get("attempt")
        if att is not None:
            by_attempt.setdefault(att, rec)
    for r in wal["routed"]:
        ts = _num(r.get("ts"))
        off = (f"+{1000 * (ts - t0):8.1f} ms"
               if ts is not None and t0 is not None else "        ?")
        kind = "hedge " if r.get("hedge") else ("replay" if r["attempt"] > 1
                                                else "route ")
        rec = by_attempt.get(r.get("attempt"))
        side = ""
        if rec is not None:
            ttft = _num(rec.get("ttft_s"))
            side = (f"  -> replica outcome={rec.get('outcome')}"
                    + (f" ttft={1000 * ttft:.1f} ms" if ttft else ""))
        lines.append(f"    {off}  attempt {r.get('attempt')} "
                     f"{kind} -> {r.get('replica')}{side}")
    ts = _num(term.get("ts"))
    if ts is not None and t0 is not None:
        extras = " ".join(f"{k}={term[k]}" for k in
                          ("replays", "hedges", "via") if k in term)
        lines.append(f"    +{1000 * (ts - t0):8.1f} ms  terminal "
                     f"{term.get('outcome')} {extras}".rstrip())
    return lines


def ttft_breakdown(rec: dict) -> dict | None:
    """Decompose one record's TTFT into queue / own-prefill / interleave.

    queue is the recorded queue-wait, prefill is the sum of the request's
    own chunk durations (`prefill_s`), and interleave is whatever remains
    of TTFT — under chunked batched prefill that remainder is the time
    the request's chunks spent parked behind a neighbor's turn on the
    shared tick, the "prefill-behind-chunked-neighbor" phase.
    """
    ttft = _num(rec.get("ttft_s"))
    if ttft is None or ttft <= 0:
        return None
    queue = _num(rec.get("queue_wait_s")) or 0.0
    prefill = _num(rec.get("prefill_s")) or 0.0
    interleave = max(ttft - queue - prefill, 0.0)
    decode = max((_num(rec.get("wall_s")) or ttft) - ttft, 0.0)
    out = {"ttft_s": ttft,
           "queue_s": round(queue, 6),
           "prefill_s": round(prefill, 6),
           "interleave_s": round(interleave, 6),
           "decode_s": round(decode, 6),
           "queue_pct": round(100 * queue / ttft, 1),
           "prefill_pct": round(100 * prefill / ttft, 1),
           "interleave_pct": round(100 * interleave / ttft, 1)}
    cached = rec.get("prefix_cached_tokens")
    if isinstance(cached, int) and cached > 0:
        # prefix_cache_hit component: tokens the prefix cache served from
        # shared pages — prefill work this request never paid (the span of
        # the same name in the waterfall carries pages/cow detail)
        out["prefix_cached_tokens"] = cached
        out["prefix_shared_pages"] = int(rec.get("prefix_shared_pages") or 0)
        out["prefix_cow_fork"] = bool(rec.get("prefix_cow_fork"))
    return out


def tail_attribution(records: list[dict], quantile: float = 99.0) -> dict:
    """Aggregate breakdown over the TTFT tail (records at or above the
    given TTFT percentile): where does tail TTFT actually go?"""
    timed = [(r, _num(r.get("ttft_s"))) for r in records]
    timed = [(r, t) for r, t in timed if t is not None and t > 0]
    if not timed:
        return {}
    values = sorted(t for _, t in timed)
    idx = min(int(len(values) * quantile / 100.0), len(values) - 1)
    cut = values[idx]
    tail = [r for r, t in timed if t >= cut]
    queue = sum((_num(r.get("queue_wait_s")) or 0.0) for r in tail)
    prefill = sum((_num(r.get("prefill_s")) or 0.0) for r in tail)
    ttft = sum(t for _, t in timed if t >= cut)
    interleave = max(ttft - queue - prefill, 0.0)
    return {"quantile": quantile, "cut_ttft_s": round(cut, 6),
            "requests": len(tail),
            "queue_pct": round(100 * queue / ttft, 1),
            "prefill_pct": round(100 * prefill / ttft, 1),
            "interleave_pct": round(100 * interleave / ttft, 1)}


def tenant_tables(records: list[dict]) -> dict:
    """Per-tenant slices of the trace (completed outcomes drive the
    latency percentiles; shed/abandoned are counted separately)."""
    tenants: dict[str, dict] = {}
    for rec in records:
        tenant = rec.get("tenant")
        if not isinstance(tenant, str):
            continue
        t = tenants.setdefault(tenant, {"completed": 0, "shed": 0,
                                        "abandoned": 0, "failed": 0,
                                        "tokens": 0, "_ttft": [], "_tpot": []})
        outcome = rec.get("outcome")
        if outcome in t:
            t[outcome] += 1
        if outcome == "completed":
            t["tokens"] += int(rec.get("tokens") or 0)
            for metric in ("ttft", "tpot"):
                v = _num(rec.get(f"{metric}_s"))
                if v is not None:
                    t[f"_{metric}"].append(v)
    out = {}
    for name in sorted(tenants):
        t = tenants[name]
        row = {k: v for k, v in t.items() if not k.startswith("_")}
        row.update(percentiles_ms(t["_ttft"], "ttft", qs=(50, 95, 99)))
        row.update(percentiles_ms(t["_tpot"], "tpot", qs=(50, 95, 99)))
        out[name] = row
    return out


def exemplar_waterfall(rec: dict) -> list[str]:
    """Render one record's span tree as offset/duration lines relative to
    the request's arrival — the human-readable waterfall."""
    arrival = _num(rec.get("arrival"))
    lines = [f"  request {rec.get('request_id')} trace {rec.get('trace_id')}"
             f" tenant={rec.get('tenant')} outcome={rec.get('outcome')}"
             f" tokens={rec.get('tokens')}"]
    gw = rec.get("gateway")
    if isinstance(gw, dict):
        # gateway attribution (serve/gateway.py pass-through): which
        # dispatch attempt produced THIS replica-side record
        lines.append(
            f"  gateway attempt {gw.get('attempt')}"
            + (" (replay)" if gw.get("replay") else "")
            + (" (hedge)" if gw.get("hedge") else ""))
    bd = ttft_breakdown(rec)
    if bd:
        lines.append(
            f"  ttft {1000 * bd['ttft_s']:.1f} ms = "
            f"{bd['queue_pct']}% queue + {bd['prefill_pct']}% own prefill "
            f"+ {bd['interleave_pct']}% prefill-behind-chunked-neighbor; "
            f"decode {1000 * bd['decode_s']:.1f} ms")
        if bd.get("prefix_cached_tokens"):
            lines.append(
                f"  prefix cache hit: {bd['prefix_cached_tokens']} tokens "
                f"from {bd['prefix_shared_pages']} shared page(s)"
                + (", CoW fork" if bd.get("prefix_cow_fork") else ""))
    for span in rec.get("spans") or []:
        if not isinstance(span, dict):
            continue
        name = span.get("name", "?")
        ts = _num(span.get("ts"))
        off = (f"+{1000 * (ts - arrival):8.1f} ms" if ts is not None
               and arrival is not None else f"tick {span.get('tick', '?')}")
        dur = _num(span.get("dur"))
        dur_s = f" for {1000 * dur:7.1f} ms" if dur is not None else ""
        extras = " ".join(f"{k}={span[k]}" for k in
                          ("slot", "bucket", "verdict", "offset", "tokens",
                           "pages", "cow") if k in span)
        lines.append(f"    {off}{dur_s}  {name:<14} {extras}".rstrip())
    decode = rec.get("decode")
    if isinstance(decode, dict):
        lines.append(f"    decode: ticks {decode.get('first_tick')}.."
                     f"{decode.get('last_tick')} ({decode.get('ticks')} "
                     f"total), shared_with={decode.get('shared_with')}")
    if rec.get("slo_breach"):
        lines.append(f"    SLO breach: {rec['slo_breach']}"
                     + (f" -> capture {rec['capture']}"
                        if rec.get("capture") else ""))
    return lines


def build_report(output_dir: str, gateway_dir: str | None = None) -> dict:
    records = load_trace(output_dir)
    exemplars = load_exemplars(output_dir)
    gateway = (gateway_tables(load_gateway_journal(gateway_dir), records)
               if gateway_dir else None)
    completed = [r for r in records if r.get("outcome") == "completed"]
    shed = [r for r in records if r.get("outcome") == "shed"]
    ttft = [v for r in completed
            if (v := _num(r.get("ttft_s"))) is not None]
    tpot = [v for r in completed
            if (v := _num(r.get("tpot_s"))) is not None]
    timed = [(r, t) for r in completed
             if (t := _num(r.get("ttft_s"))) is not None]
    p99_exemplar = max(timed, key=lambda it: it[1])[0] if timed else None
    hits = [r for r in records
            if isinstance(r.get("prefix_cached_tokens"), int)
            and r["prefix_cached_tokens"] > 0]
    prefix = {
        "hits": len(hits),
        "cached_tokens": sum(r["prefix_cached_tokens"] for r in hits),
        "shared_pages": sum(int(r.get("prefix_shared_pages") or 0)
                            for r in hits),
        "cow_forks": sum(1 for r in hits if r.get("prefix_cow_fork")),
    } if hits else None
    return {"output_dir": output_dir,
            "gateway": gateway,
            "prefix": prefix,
            "records": len(records),
            "completed": len(completed),
            "shed": len(shed),
            "abandoned": sum(1 for r in records
                             if r.get("outcome") == "abandoned"
                             or r.get("abandoned")),
            "ttft": percentiles_ms(ttft, "ttft", qs=(50, 95, 99)),
            "tpot": percentiles_ms(tpot, "tpot", qs=(50, 95, 99)),
            "tail": tail_attribution(completed),
            "tenants": tenant_tables(records),
            "p99_exemplar": p99_exemplar,
            "exemplars": {m: [r.get("request_id") for r in recs
                              if isinstance(r, dict)]
                          for m, recs in exemplars.items()
                          if isinstance(recs, list)}}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("output_dir")
    p.add_argument("--gateway", default=None, metavar="DIR",
                   help="gateway output dir: join its "
                        "gateway_journal.jsonl to the replica trace by "
                        "trace_id (dispatch attempts, replays, hedges)")
    p.add_argument("--json", action="store_true",
                   help="emit the full report as one JSON object")
    args = p.parse_args(argv)
    rep = build_report(args.output_dir, gateway_dir=args.gateway)
    if args.json:
        print(json.dumps(rep, indent=2))
        return 0 if rep["records"] else 1

    print(f"== request trace report: {rep['output_dir']} ==")
    if not rep["records"]:
        print(f"  no {REQUEST_TRACE_NAME} records found — tracing was off, "
              "or the directory is not a traced serve run")
        return 1
    print(f"  {rep['records']} records: {rep['completed']} completed, "
          f"{rep['shed']} shed, {rep['abandoned']} abandoned")
    if rep["prefix"]:
        px = rep["prefix"]
        print(f"  prefix cache: {px['hits']} hit(s), "
              f"{px['cached_tokens']} cached tokens, "
              f"{px['shared_pages']} shared page(s), "
              f"{px['cow_forks']} CoW fork(s)")
    for metric in ("ttft", "tpot"):
        table = rep[metric]
        cells = " ".join(f"p{q}={table.get(f'{metric}_p{q}_ms', '—')}"
                         for q in (50, 95, 99))
        print(f"  {metric:<6} {cells} (ms)")
    tail = rep["tail"]
    if tail:
        print(f"\n== tail attribution (TTFT >= p{tail['quantile']:g} = "
              f"{1000 * tail['cut_ttft_s']:.1f} ms, "
              f"{tail['requests']} request(s)) ==")
        print(f"  tail TTFT = {tail['queue_pct']}% queue + "
              f"{tail['prefill_pct']}% own prefill + "
              f"{tail['interleave_pct']}% prefill-behind-chunked-neighbor")
    if rep["p99_exemplar"] is not None:
        print("\n== slowest-TTFT exemplar waterfall ==")
        for line in exemplar_waterfall(rep["p99_exemplar"]):
            print(line)
    gw = rep.get("gateway")
    if gw:
        print(f"\n== gateway join ({gw['requests']} journalled "
              f"request(s)) ==")
        cells = " ".join(f"{k}={v}" for k, v in gw["outcomes"].items())
        print(f"  outcomes: {cells or '(none terminal)'}; "
              f"{gw['replayed']} replayed, {gw['hedged']} hedged, "
              f"{gw['orphans']} orphaned")
        print(f"  {gw['joined']} of {gw['requests']} joined to replica "
              f"trace records by trace_id")
        if gw["exemplar"]:
            print("\n== busiest dispatch waterfall (most attempts) ==")
            for line in gateway_waterfall(gw["exemplar"]["wal"],
                                          gw["exemplar"]["records"]):
                print(line)
    if rep["tenants"]:
        print("\n== per-tenant ==")
        for name, row in rep["tenants"].items():
            counts = " ".join(f"{k}={row[k]}" for k in
                              ("completed", "shed", "abandoned", "failed",
                               "tokens") if row.get(k))
            lat = " ".join(f"{k.replace('_ms', '')}="
                           f"{row[k]}" for k in row if k.endswith("_ms")
                           and row[k] is not None)
            print(f"  {name:<12} {counts}")
            if lat:
                print(f"  {'':<12} {lat} (ms)")
    if rep["exemplars"]:
        print("\n== exemplar snapshot (request_trace_exemplars.json) ==")
        for metric, ids in rep["exemplars"].items():
            print(f"  slowest by {metric}: {ids}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
