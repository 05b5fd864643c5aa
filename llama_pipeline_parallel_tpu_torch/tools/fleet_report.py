"""Offline whole-pod report from a fleet root (the counterpart of the JAX
package's tools/fleet_report.py).

The post-mortem counterpart of tools.fleetd: where the daemon shows
the pod NOW, this tells the pod's story after the fact — which members
ran, every incarnation of every role on one wall-clock timeline with
restart/resize markers, the alert firing/resolved timeline next to it,
the serve tier's SLO picture, and the checkpoint-lag table (how far each
replica trailed the trainer's latest verified checkpoint).

    python -m llama_pipeline_parallel_tpu_torch.tools.fleet_report /runs/fleet1 [--json]

Reads `<fleet-root>/registry.jsonl` + `alerts.jsonl` and each registered
member's health.json / metrics.jsonl / incarnations.jsonl. Degrades on
missing/torn/garbage files like every other report in tools/ — a pod that
just burned down is exactly when this gets run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


from llama_pipeline_parallel_tpu_torch.utils.actions import (
    read_actions,
)
from llama_pipeline_parallel_tpu_torch.utils.fleet import (
    HEALTH_NAME,
    FleetAggregator,
    _num,
    load_registry,
    read_alerts,
)
from llama_pipeline_parallel_tpu_torch.utils.perf import read_jsonl


def build_report(fleet_root: str) -> dict:
    """One refresh of the aggregator (it already knows how to roll a
    member up; offline we just never write status/alerts/triggers) plus
    the cross-member timelines only hindsight can draw."""
    registry = load_registry(fleet_root)
    agg = FleetAggregator(fleet_root, capture_on_alert=False)
    status = agg.refresh(write=False) if registry else {
        "members": {}, "pod": {"members": 0, "alerts_firing": []}}

    # every incarnation of every member on one timeline
    seen_dirs = []
    for row in registry:
        if row["output_dir"] not in seen_dirs:
            seen_dirs.append(row["output_dir"])
    # one event stream per OUTPUT DIR: the supervisor member shares its
    # child's dir (and ledger), so iterating members would print every
    # incarnation twice — label each dir with its child (non-supervisor)
    # member when one exists
    dir_label: dict[str, str] = {}
    for member_id, member in status["members"].items():
        out = member["output_dir"]
        if out not in dir_label or member["role"] != "supervisor":
            dir_label[out] = member_id
    events = []
    for out, member_id in dir_label.items():
        rows = read_jsonl(os.path.join(out, "incarnations.jsonl"),
                          keep=lambda r: "incarnation" in r)
        for row in rows:
            events.append({
                "member": member_id,
                "incarnation": row.get("incarnation"),
                "start": _num(row.get("start")),
                "end": _num(row.get("end")),
                "duration_s": _num(row.get("duration_s")),
                "outcome": row.get("outcome"),
                "layout": row.get("layout"),
                "resized": bool(row.get("resized")),
                "last_step": row.get("last_step"),
            })
    events.sort(key=lambda e: e["start"] or 0.0)

    alerts = read_alerts(fleet_root)
    actions = read_actions(fleet_root)
    t0_candidates = ([e["start"] for e in events if e["start"]]
                     + [_num(a.get("ts")) for a in alerts
                        if _num(a.get("ts"))]
                     + [_num(r.get("ts")) for r in actions
                        if _num(r.get("ts"))]
                     + [_num(r.get("ts")) for r in registry
                        if _num(r.get("ts"))])
    t0 = min(t0_candidates) if t0_candidates else None

    # serve SLO + checkpoint-lag tables straight off the member rollups
    slo_rows, lag_rows, gateway_rows = [], [], []
    trainer_step = status.get("pod", {}).get("trainer_step")
    for member_id, member in status["members"].items():
        if member["role"] == "gateway":
            # the routing tier's own counters (serve/gateway.py): routing /
            # retry / replay / hedge volume plus gateway-observed TTFT
            gateway_rows.append({k: member.get(k) for k in (
                "replica", "requests_routed", "requests_completed",
                "requests_retried", "requests_replayed", "requests_hedged",
                "hedge_wins", "wasted_hedge_tokens", "replay_skipped_tokens",
                "requests_shed", "requests_failed", "ttft_p50_ms",
                "ttft_p95_ms", "replicas_healthy", "replicas_known")})
        if member["role"] != "serve":
            continue
        slo_rows.append({k: member.get(k) for k in (
            "replica", "requests_completed", "tokens_generated",
            "ttft_p50_ms", "ttft_p95_ms", "tpot_p50_ms",
            "queue_wait_p95_ms", "slo_breaches", "requests_page_refused",
            "requests_failed")})
        lag_rows.append({"replica": member.get("replica"),
                         "checkpoint_step": member.get("checkpoint_step"),
                         "checkpoint_lag": member.get("checkpoint_lag")})
    return {"fleet_root": fleet_root, "t0": t0,
            "registered_members": len(status["members"]),
            "registered_dirs": seen_dirs,
            "members": status["members"], "pod": status.get("pod", {}),
            "incarnation_timeline": events, "alert_timeline": alerts,
            "action_timeline": actions,
            "slo_table": slo_rows, "gateway_table": gateway_rows,
            "checkpoint_lag": {"trainer_step": trainer_step,
                               "replicas": lag_rows}}


def _rel(ts, t0) -> str:
    if ts is None or t0 is None:
        return "?"
    return f"t+{ts - t0:8.1f}s"


def print_report(rep: dict) -> None:
    print(f"fleet: {rep['fleet_root']}  ({rep['registered_members']} "
          f"member(s))")
    pod = rep.get("pod", {})
    if pod.get("goodput") is not None:
        print(f"  pod goodput (elapsed-weighted, incarnations included): "
              f"{100 * pod['goodput']:.1f}%")
    if pod.get("alerts_firing"):
        print(f"  STILL FIRING: {', '.join(pod['alerts_firing'])}")

    print("\n== members ==")
    for member_id, m in rep["members"].items():
        bits = [f"{m.get('incarnations', 1) or 1} incarnation(s)"]
        if m.get("last_step") is not None:
            bits.append(f"last step {m['last_step']}")
        if m.get("latest_verified_step") is not None:
            bits.append(f"latest verified ckpt {m['latest_verified_step']}")
        if m.get("checkpoint_step") is not None:
            bits.append(f"serving ckpt step {m['checkpoint_step']}")
        if m.get("goodput") is not None:
            bits.append(f"goodput {100 * m['goodput']:.1f}%")
        if m.get("health_status") not in ("ok", None):
            bits.append(f"health {m['health_status']}")
        print(f"  {member_id:<24} {', '.join(bits)}")

    t0 = rep["t0"]
    if rep["incarnation_timeline"]:
        print("\n== incarnation timeline (all roles) ==")
        for e in rep["incarnation_timeline"]:
            mark = ""
            if e["resized"]:
                mark = "  <- resized"
            elif e["outcome"] not in ("clean", None):
                mark = f"  <- {e['outcome']}"
            layout = f" [{e['layout']}]" if e.get("layout") else ""
            dur = (f"{e['duration_s']:7.1f}s"
                   if e["duration_s"] is not None else "      ?")
            print(f"  {_rel(e['start'], t0)}  {e['member']:<24} "
                  f"#{e['incarnation']} {dur}  {e['outcome'] or '?'}"
                  f"{layout}{mark}")

    if rep["alert_timeline"]:
        print("\n== alert timeline ==")
        for a in rep["alert_timeline"]:
            print(f"  {_rel(_num(a.get('ts')), t0)}  "
                  f"{str(a.get('state', '?')).upper():<9} {a.get('alert')} "
                  f"on {a.get('member')} (value={a.get('value')} "
                  f"threshold={a.get('threshold')})")

    if rep.get("action_timeline"):
        # the actuation story (tools.fleetctl): every action's intent
        # and outcome row, interleaved with the alert edges that caused
        # them — one merged clock, so cause sits right above effect
        print("\n== actions timeline (interleaved with alert edges) ==")
        merged = ([("alert", _num(a.get("ts")), a)
                   for a in rep["alert_timeline"]]
                  + [("action", _num(r.get("ts")), r)
                     for r in rep["action_timeline"]])
        merged.sort(key=lambda item: item[1] or 0.0)
        for tag, ts, row in merged:
            if tag == "alert":
                print(f"  {_rel(ts, t0)}  alert  "
                      f"{str(row.get('state', '?')).upper():<9} "
                      f"{row.get('alert')} on {row.get('member')}")
            elif row.get("phase") == "intent":
                cause = f"  <- {row['alert']}" if row.get("alert") else ""
                print(f"  {_rel(ts, t0)}  action INTENT    "
                      f"{row.get('kind')} {row.get('id')} "
                      f"params={row.get('params')}{cause}")
            else:
                print(f"  {_rel(ts, t0)}  action "
                      f"{str(row.get('outcome', '?')).upper():<9} "
                      f"{row.get('kind')} {row.get('id')}")

    if rep["slo_table"]:
        print("\n== serve tier SLOs (last metrics line per replica) ==")
        for r in rep["slo_table"]:
            cells = " ".join(f"{k}={r[k]}" for k in (
                "requests_completed", "ttft_p50_ms", "ttft_p95_ms",
                "tpot_p50_ms", "queue_wait_p95_ms", "slo_breaches",
                "requests_page_refused", "requests_failed")
                if r.get(k) is not None)
            cells = cells or "(no serving metrics recorded)"
            print(f"  {str(r.get('replica')):<16} {cells}")

    if rep.get("gateway_table"):
        print("\n== gateway tier (last metrics line per gateway) ==")
        for r in rep["gateway_table"]:
            cells = " ".join(f"{k}={r[k]}" for k in (
                "requests_routed", "requests_completed", "requests_retried",
                "requests_replayed", "requests_hedged", "hedge_wins",
                "wasted_hedge_tokens", "replay_skipped_tokens",
                "requests_shed", "requests_failed", "ttft_p50_ms",
                "ttft_p95_ms") if r.get(k) is not None)
            if r.get("replicas_known") is not None:
                cells += (f" replicas={r.get('replicas_healthy')}"
                          f"/{r.get('replicas_known')} healthy")
            cells = cells.strip() or "(no gateway metrics recorded)"
            print(f"  {str(r.get('replica')):<16} {cells}")

    lag = rep["checkpoint_lag"]
    if lag["replicas"]:
        print(f"\n== checkpoint lag (trainer latest verified: "
              f"{lag['trainer_step']}) ==")
        for r in lag["replicas"]:
            lag_s = (f"{r['checkpoint_lag']} step(s) behind"
                     if r.get("checkpoint_lag") is not None
                     else "lag unknown")
            print(f"  {str(r.get('replica')):<16} serving step "
                  f"{r.get('checkpoint_step')}  ({lag_s})")
    if not rep["members"]:
        print("\n  no members registered — is this a fleet root? "
              f"(expected {os.path.join(rep['fleet_root'], 'registry.jsonl')}"
              f"; members heartbeat {HEALTH_NAME} in their own dirs)")


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("fleet_root", help="the --fleet-root the supervisors "
                                      "and fleetd were pointed at")
    p.add_argument("--json", action="store_true",
                   help="emit the report as JSON instead of tables")
    args = p.parse_args(argv)
    rep = build_report(args.fleet_root)
    if args.json:
        print(json.dumps(rep, indent=2))
    else:
        print_report(rep)
    return 0


if __name__ == "__main__":
    sys.exit(main())
