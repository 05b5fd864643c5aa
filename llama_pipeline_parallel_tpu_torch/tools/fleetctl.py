"""Fleet actuator daemon: alert edges in, supervised actions out (the
counterpart of the JAX package's tools/fleetctl.py; it touches no device).

The read side of the loop is tools.fleetd — it aggregates the pod into
`fleet_status.json` and appends alert edges to `alerts.jsonl`. This tool
closes the loop: it watches that status file and drives the two journaled
actuators in `utils/actions.py` against it:

- **autoscale** — a sustained serve-side SLO breach (ttft_p95 /
  queue_wait_p95) borrows training devices: the trainer's supervisor
  (running with --actuate) is asked via an atomic `action.request` to pin
  a smaller ladder rung; `scale_up_cmd` launches the extra serve replica
  on the freed devices. Sustained quiet hands them back.
- **deploy** — serve replicas tail the trainer's latest VERIFIED
  checkpoint, gated by each checkpoint's recorded eval_loss; a deployed
  regression rolls back to the previous verified step.

Every action is journaled in `<fleet-root>/actions.jsonl` as an intent
row before any side effect and an outcome row after — SIGKILL this
process at any point and the next start reconciles the open intents from
on-disk evidence (complete or safely void; see ActionJournal). Run it
like fleetd:

  python -m llama_pipeline_parallel_tpu_torch.tools.fleetctl --fleet-root /runs/fleet1 --interval 2 \
      --actions '{"autoscale": {"trainer_dir": "/runs/train1",
                  "borrow_rung": "dp1", "restore_rung": "dp2"}}'

`--actions` takes inline JSON or `@/path/to/actions.json` (unknown keys
rejected — the config-block house rule). `--once` reconciles, runs one
tick, prints the ids taken, and exits (tests / cron). Without `--actions`
(or with an empty block) the tool actuates nothing — inert by default,
like every actuation path in this repo.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time


from llama_pipeline_parallel_tpu_torch.utils.actions import (
    ActionJournal,
    ActionsConfig,
    Autoscaler,
    Deployer,
    reconcile_open_intents,
)
from llama_pipeline_parallel_tpu_torch.utils.fleet import (
    STATUS_NAME,
    FileWatcher,
)


def parse_actions(spec: str | None) -> ActionsConfig:
    """Inline JSON or @file -> validated ActionsConfig (fleetd's --alerts
    convention)."""
    if not spec:
        return ActionsConfig()
    raw = spec.strip()
    if raw.startswith("@"):
        with open(raw[1:]) as f:
            node = json.load(f)
    else:
        node = json.loads(raw)
    return ActionsConfig.from_cfg(node)


class FleetActuator:
    """The tick harness the daemon loop and the tests share: builds the
    journal + configured actuators over a fleet root, reconciles the
    crash-recovery worklist once at startup, then evaluates every tick
    against the newest `fleet_status.json` snapshot."""

    def __init__(self, fleet_root: str, cfg: ActionsConfig):
        self.fleet_root = fleet_root
        self.journal = ActionJournal(fleet_root)
        self._status = FileWatcher(os.path.join(fleet_root, STATUS_NAME))
        self.autoscaler = (Autoscaler(cfg.autoscale, self.journal,
                                      fleet_root)
                           if cfg.autoscale is not None else None)
        self.deployer = (Deployer(cfg.deploy, self.journal)
                         if cfg.deploy is not None else None)

    def reconcile(self) -> list[tuple]:
        return reconcile_open_intents(self.journal, self.autoscaler,
                                      self.deployer)

    def tick(self, now: float | None = None) -> list[str]:
        if now is None:
            now = time.time()
        status = self._status.poll()
        taken: list[str] = []
        if self.autoscaler is not None:
            taken += self.autoscaler.tick(status, now)
        if self.deployer is not None:
            taken += self.deployer.tick(status, now)
        return taken


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--fleet-root", required=True,
                   help="the fleet home tools.fleetd aggregates into "
                        "(fleet_status.json in, actions.jsonl out)")
    p.add_argument("--actions", default=None,
                   help="actuation config: inline JSON or @/path/to/"
                        "actions.json with actions.* keys")
    p.add_argument("--interval", type=float, default=2.0,
                   help="tick cadence in seconds (match fleetd's "
                        "--refresh-s; each tick is one status read)")
    p.add_argument("--once", action="store_true",
                   help="reconcile + one tick, print action ids, exit")
    args = p.parse_args(argv)

    try:
        cfg = parse_actions(args.actions)
    except (OSError, ValueError) as e:
        raise SystemExit(f"fleetctl: bad --actions: {e}")
    act = FleetActuator(args.fleet_root, cfg)

    # crash recovery FIRST: an intent left open by a killed predecessor
    # must resolve before any fresh action can race its side effects
    for action_id, kind, outcome in act.reconcile():
        print(f"[fleetctl] reconciled {action_id} ({kind}): {outcome}",
              flush=True)

    if args.once:
        taken = act.tick()
        print(json.dumps({"actions": taken}))
        return 0

    configured = [name for name, a in (("autoscale", act.autoscaler),
                                       ("deploy", act.deployer))
                  if a is not None]
    print(f"[fleetctl] watching {args.fleet_root} every "
          f"{args.interval:.1f}s — actuators: "
          f"{', '.join(configured) or 'none (inert)'}", flush=True)

    stop = threading.Event()

    def _stop(signum, _frame):
        print(f"[fleetctl] signal {signum}: exiting after this tick",
              flush=True)
        stop.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _stop)
        except ValueError:  # not the main thread (in-process tests)
            pass

    while not stop.is_set():
        for action_id in act.tick():
            print(f"[fleetctl] action {action_id} journaled", flush=True)
        stop.wait(args.interval)
    return 0


if __name__ == "__main__":
    sys.exit(main())
