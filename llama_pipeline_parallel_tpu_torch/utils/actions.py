"""Alert-driven actuation: the journaled control plane closing the loop
from fleet alert edges to supervised actions (the JAX package's
utils/actions.py, copied; its docs/RESILIENCE.md "Actuation").

The observability substrate shows a pod's incidents (utils/fleet.py:
alerts.jsonl edges, fleet_status.json); this module makes them actuate.
Every action is a crash-safe, idempotent, journaled state machine:

  intent row -> execute -> outcome row        (both in actions.jsonl)

The journal (`ActionJournal`) is the actuator's ONLY durable state — an
actuator SIGKILLed between the two rows reconciles on restart by looking
at the world, not its memory: an intent whose side effects are evidenced
on disk (the supervisor's `action.request`/`action.ack` carrying the
action id) completes as `done` (reconciled); one with no delivery
evidence is safely voided — the still-firing alert re-triggers a fresh
action after cooldown, so voiding can never lose work, only delay it.

Two actuators compose machinery the repo already trusts:

- **Autoscaler** (`Autoscaler`): a sustained serve-side breach
  (ttft_p95 / queue_wait_p95 firing longer than `for_s`) BORROWS devices
  from training — an atomic `action.request` file asks the trainer's
  supervisor (tools.supervisor --actuate) to pin a lower ladder rung;
  the trainer saves at a step boundary, relaunches smaller (elastic
  resume preserves the data contract), and the freed devices host a new
  serve replica (`scale_up_cmd`). Sustained quiet (`idle_for_s`) hands
  them back. Every transition is rate-limited by `cooldown_s` so a
  flapping alert cannot thrash the pod.
- **Deployer** (`Deployer`): serve replicas tail the trainer's latest
  VERIFIED checkpoint (meta.json landed — the commit barrier),
  gated by the `eval_loss` each checkpoint's meta records: a candidate
  regressing vs the deployed step is held, and a DEPLOYED step
  regressing vs its predecessor triggers rollback to that previous
  verified step (`load_module_checkpoint` re-verifies every shard's
  sha256 on restore). A firing `checkpoint_lag` alert forces the
  handoff past the cooldown.

Plain stdlib on purpose: tools.fleetctl imports it without torch, the
same rule utils/fleet.py keeps.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import time
from typing import Any

from llama_pipeline_parallel_tpu_torch.utils import faults, fleet
from llama_pipeline_parallel_tpu_torch.utils.logging import get_logger
from llama_pipeline_parallel_tpu_torch.utils.perf import read_jsonl

logger = get_logger(__name__)

ACTIONS_NAME = "actions.jsonl"
# dropped into a SUPERVISOR's output dir by an actuator; consumed by
# tools.supervisor under --actuate (the capture.trigger pattern:
# atomic write, skip-if-present, the consumer deletes it)
ACTION_REQUEST_NAME = "action.request"
# the supervisor's receipt: atomically rewritten with the id of the last
# request it applied — the actuator's reconciliation evidence
ACTION_ACK_NAME = "action.ack"
# dropped into the TRAINER's output dir by its supervisor: train.py
# (actions.resize_on_request) saves at the next step boundary and exits
# cleanly for an elastic relaunch; the trainer renames it to the ack so
# a crashed supervisor can see the request was honored
RESIZE_REQUEST_NAME = "resize.request"
RESIZE_ACK_NAME = "resize.request.ack"

_ID_RE = re.compile(r"^action-(\d+)$")


def read_json_file(path: str) -> dict | None:
    """Tolerant whole-file JSON: None for missing/torn/not-a-dict — the
    actuator must survive any on-disk state (read_health's rule)."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    return data if isinstance(data, dict) else None


def write_action_request(output_dir: str, payload: dict) -> bool:
    """Atomically drop one action request into a supervisor's output dir.
    Skip-if-present (the capture-trigger rule): an unconsumed request
    means the supervisor has not caught up — stacking a second would race
    its consume/apply. Returns False when skipped."""
    path = os.path.join(output_dir, ACTION_REQUEST_NAME)
    if os.path.exists(path):
        return False
    os.makedirs(output_dir, exist_ok=True)
    fleet.write_json_atomic(path, payload)
    return True


# ---------------------------------------------------------------------------
# the journal
# ---------------------------------------------------------------------------

class ActionJournal:
    """Paired intent/outcome rows in `<fleet-root>/actions.jsonl`.

    Append-only, tolerant-read (perf.read_jsonl semantics: a torn tail or
    garbage line is skipped, never a crash) — tools.fleet_report reads
    it with the same reader. Ids are monotonic `action-NNNNNN`, recovered
    by scanning the journal, so an actuator restart can never reuse one.
    The journal is the actuator's only durable state: `open_intents()`
    is the crash-recovery worklist."""

    def __init__(self, fleet_root: str):
        os.makedirs(fleet_root, exist_ok=True)
        self.path = os.path.join(fleet_root, ACTIONS_NAME)

    def rows(self) -> list[dict]:
        return read_jsonl(self.path,
                          keep=lambda r: "id" in r and "phase" in r)

    def _append(self, row: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def next_id(self) -> str:
        n = 0
        for row in self.rows():
            m = _ID_RE.match(str(row.get("id", "")))
            if m:
                n = max(n, int(m.group(1)) + 1)
        return f"action-{n:06d}"

    def begin(self, kind: str, params: dict | None = None,
              alert: str | None = None) -> str:
        """Append the intent row; returns the action id. The intent lands
        BEFORE any side effect — a crash between the two leaves an open
        intent for reconcile, never an unjournaled action."""
        action_id = self.next_id()
        row = {"ts": time.time(), "id": action_id, "kind": kind,
               "phase": "intent", "params": params or {}}
        if alert is not None:
            row["alert"] = alert
        self._append(row)
        return action_id

    def finish(self, action_id: str, outcome: str, **detail: Any) -> None:
        """Append the outcome row (`done` / `failed` / `voided`). Carries
        the intent's kind so a timeline renders either row standalone."""
        kind = next((r.get("kind") for r in self.rows()
                     if r.get("id") == action_id
                     and r.get("phase") == "intent"), None)
        row = {"ts": time.time(), "id": action_id, "kind": kind,
               "phase": "outcome", "outcome": outcome}
        row.update(detail)
        self._append(row)

    def open_intents(self) -> list[dict]:
        """Intent rows with no outcome row yet — an actuator died between
        the pair; reconcile completes or safely voids each."""
        rows = self.rows()
        closed = {r["id"] for r in rows if r.get("phase") == "outcome"}
        return [r for r in rows
                if r.get("phase") == "intent" and r["id"] not in closed]

    def history(self) -> list[dict]:
        """Intent rows annotated with their outcome row under `result`
        (absent while open), in journal order."""
        rows = self.rows()
        out, by_id = [], {}
        for r in rows:
            if r.get("phase") == "intent":
                entry = dict(r)
                by_id[r["id"]] = entry
                out.append(entry)
            elif r.get("phase") == "outcome" and r.get("id") in by_id:
                by_id[r["id"]]["result"] = r
        return out

    def last_done_ts(self, kinds: tuple) -> float | None:
        """Newest `done` outcome among the given kinds — the cooldown
        anchor (voided actions do not consume cooldown: a void changed
        nothing, so it must not delay the retry that will)."""
        ts = None
        for h in self.history():
            res = h.get("result")
            if h.get("kind") in kinds and res \
                    and res.get("outcome") == "done":
                t = res.get("ts")
                if isinstance(t, (int, float)):
                    ts = t if ts is None else max(ts, t)
        return ts


def read_actions(fleet_root: str) -> list[dict]:
    """Every parseable action row (tools.fleet_report's timeline) —
    the same degrade-don't-crash contract as fleet.read_alerts."""
    return read_jsonl(os.path.join(fleet_root, ACTIONS_NAME),
                      keep=lambda r: "id" in r and "phase" in r)


# ---------------------------------------------------------------------------
# the actions.* config block
# ---------------------------------------------------------------------------

_AUTOSCALE_KEYS = {"breach_alerts", "for_s", "cooldown_s", "idle_for_s",
                   "trainer_dir", "borrow_rung", "restore_rung",
                   "scale_up_cmd", "scale_down_cmd"}
_DEPLOY_KEYS = {"trainer_dir", "replica_dirs", "eval_regression",
                "cooldown_s", "on_lag_alert"}
_ACTIONS_KEYS = {"autoscale", "deploy"}


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """The `actions.autoscale` block: when to borrow training devices for
    serving and when to hand them back (unknown keys rejected, the
    `offload.*` house style)."""

    trainer_dir: str
    borrow_rung: str
    restore_rung: str
    breach_alerts: tuple = ("ttft_p95", "queue_wait_p95")
    for_s: float = 0.0        # breach must fire continuously this long
    idle_for_s: float = 0.0   # quiet must hold this long before handback
    cooldown_s: float = 0.0   # minimum gap between scale transitions
    scale_up_cmd: str | None = None   # shell: launch the borrowed replica
    scale_down_cmd: str | None = None  # shell: stop it on handback

    @classmethod
    def from_cfg(cls, node: Any) -> "AutoscaleConfig":
        if not isinstance(node, dict):
            raise ValueError(f"actions.autoscale must be a mapping, got "
                             f"{node!r}")
        unknown = set(node) - _AUTOSCALE_KEYS
        if unknown:
            raise ValueError(f"unknown actions.autoscale key(s) "
                             f"{sorted(unknown)}; known: "
                             f"{sorted(_AUTOSCALE_KEYS)}")
        for key in ("trainer_dir", "borrow_rung", "restore_rung"):
            if not node.get(key):
                raise ValueError(f"actions.autoscale.{key} is required")
        kw: dict[str, Any] = {
            "trainer_dir": os.path.abspath(str(node["trainer_dir"])),
            "borrow_rung": str(node["borrow_rung"]),
            "restore_rung": str(node["restore_rung"])}
        if node.get("breach_alerts") is not None:
            alerts = node["breach_alerts"]
            if not isinstance(alerts, (list, tuple)) or not alerts:
                raise ValueError("actions.autoscale.breach_alerts must be "
                                 "a non-empty list of alert rule names")
            kw["breach_alerts"] = tuple(str(a) for a in alerts)
        for key in ("for_s", "idle_for_s", "cooldown_s"):
            if node.get(key) is not None:
                val = float(node[key])
                if val < 0:
                    raise ValueError(f"actions.autoscale.{key} must be "
                                     f">= 0, got {val}")
                kw[key] = val
        for key in ("scale_up_cmd", "scale_down_cmd"):
            if node.get(key) is not None:
                kw[key] = str(node[key])
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class DeployConfig:
    """The `actions.deploy` block: continuous checkpoint deployment with
    eval-loss gating and rollback."""

    trainer_dir: str
    replica_dirs: tuple
    eval_regression: float = 0.0  # candidate worse by more than this holds
    cooldown_s: float = 0.0
    on_lag_alert: bool = True     # checkpoint_lag firing forces the handoff

    @classmethod
    def from_cfg(cls, node: Any) -> "DeployConfig":
        if not isinstance(node, dict):
            raise ValueError(f"actions.deploy must be a mapping, got "
                             f"{node!r}")
        unknown = set(node) - _DEPLOY_KEYS
        if unknown:
            raise ValueError(f"unknown actions.deploy key(s) "
                             f"{sorted(unknown)}; known: "
                             f"{sorted(_DEPLOY_KEYS)}")
        if not node.get("trainer_dir"):
            raise ValueError("actions.deploy.trainer_dir is required")
        dirs = node.get("replica_dirs")
        if not isinstance(dirs, (list, tuple)) or not dirs:
            raise ValueError("actions.deploy.replica_dirs must be a "
                             "non-empty list of serve output dirs")
        kw: dict[str, Any] = {
            "trainer_dir": os.path.abspath(str(node["trainer_dir"])),
            "replica_dirs": tuple(os.path.abspath(str(d)) for d in dirs)}
        if node.get("eval_regression") is not None:
            tol = float(node["eval_regression"])
            if tol < 0:
                raise ValueError(f"actions.deploy.eval_regression must be "
                                 f">= 0, got {tol}")
            kw["eval_regression"] = tol
        if node.get("cooldown_s") is not None:
            cd = float(node["cooldown_s"])
            if cd < 0:
                raise ValueError(f"actions.deploy.cooldown_s must be >= 0, "
                                 f"got {cd}")
            kw["cooldown_s"] = cd
        if node.get("on_lag_alert") is not None:
            kw["on_lag_alert"] = bool(node["on_lag_alert"])
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class ActionsConfig:
    """The full `actions.*` block tools.fleetctl takes (inline JSON or
    @file). Both sub-blocks optional — an empty block actuates nothing."""

    autoscale: AutoscaleConfig | None = None
    deploy: DeployConfig | None = None

    @classmethod
    def from_cfg(cls, node: Any) -> "ActionsConfig":
        node = node or {}
        if not isinstance(node, dict):
            raise ValueError(f"actions must be a mapping, got {node!r}")
        unknown = set(node) - _ACTIONS_KEYS
        if unknown:
            raise ValueError(f"unknown actions.* key(s) {sorted(unknown)}; "
                             f"known: {sorted(_ACTIONS_KEYS)}")
        return cls(
            autoscale=(AutoscaleConfig.from_cfg(node["autoscale"])
                       if node.get("autoscale") is not None else None),
            deploy=(DeployConfig.from_cfg(node["deploy"])
                    if node.get("deploy") is not None else None))


# the trainer-side gate (train.py `actions.*` config block): everything
# is off by default — a config without the block behaves byte-identically
# to a pre-actuation trainer
_TRAIN_ACTION_KEYS = {"resize_on_request"}


@dataclasses.dataclass(frozen=True)
class TrainActions:
    """train.py's `actions.*` block: `resize_on_request: true` makes the
    train loop poll for `<output_dir>/resize.request` on the preemption
    cadence and treat it like a preemption notice (save at the step
    boundary, exit 0 for the supervisor's elastic relaunch)."""

    resize_on_request: bool = False

    @classmethod
    def from_cfg(cls, node: Any) -> "TrainActions":
        node = node or {}
        if not isinstance(node, dict):
            raise ValueError(f"actions must be a mapping, e.g. actions: "
                             f"{{resize_on_request: true}} — got {node!r}")
        unknown = set(node) - _TRAIN_ACTION_KEYS
        if unknown:
            raise ValueError(f"unknown actions.* key(s) {sorted(unknown)}; "
                             f"known: {sorted(_TRAIN_ACTION_KEYS)}")
        return cls(resize_on_request=bool(node.get("resize_on_request",
                                                   False)))


# ---------------------------------------------------------------------------
# shared actuator plumbing
# ---------------------------------------------------------------------------

def _delivery_evidence(output_dir: str, action_id: str) -> str | None:
    """Did an action request with this id reach its supervisor? Checks
    the pending request file AND the supervisor's ack (a consumed request
    leaves only the ack). Returns what was found, or None."""
    req = read_json_file(os.path.join(output_dir, ACTION_REQUEST_NAME))
    if req and req.get("id") == action_id:
        return "request_pending"
    ack = read_json_file(os.path.join(output_dir, ACTION_ACK_NAME))
    if ack and ack.get("id") == action_id:
        return "acked"
    return None


def _run_shell(cmd: str, log_path: str) -> int:
    """Fire-and-forget shell command (replica launch/stop): stdout+stderr
    to a log file in the fleet root; returns the pid. The actuator never
    waits — the spawned supervisor registers itself in the fleet registry,
    which is the evidence reconcile looks for."""
    log = open(log_path, "ab")
    try:
        proc = subprocess.Popen(cmd, shell=True, stdout=log, stderr=log,
                                start_new_session=True)
    finally:
        log.close()
    return proc.pid


def _firing_alerts(status: dict | None) -> dict[str, dict]:
    """rule-name -> {key, since, member} for every currently-firing alert
    in a fleet_status snapshot (first firing member wins per rule)."""
    out: dict[str, dict] = {}
    for key, val in ((status or {}).get("alerts") or {}).items():
        if not isinstance(val, dict) or val.get("state") != "firing":
            continue
        rule, _, member = str(key).partition(":")
        since = val.get("since")
        entry = {"key": key, "member": member,
                 "since": since if isinstance(since, (int, float)) else None}
        prev = out.get(rule)
        if prev is None or ((entry["since"] or 0) < (prev["since"] or 0)):
            out[rule] = entry
    return out


class Autoscaler:
    """The borrow/handback state machine. Mode is DERIVED from the
    journal (the last done borrow/handback), never from memory — an
    actuator restart resumes mid-cycle exactly where the journal says."""

    KINDS = ("borrow", "handback")

    def __init__(self, cfg: AutoscaleConfig, journal: ActionJournal,
                 fleet_root: str):
        self.cfg = cfg
        self.journal = journal
        self.fleet_root = fleet_root
        self._quiet_since: float | None = None

    def mode(self) -> str:
        last = None
        for h in self.journal.history():
            res = h.get("result")
            if h.get("kind") in self.KINDS and res \
                    and res.get("outcome") == "done":
                last = h["kind"]
        return "borrowed" if last == "borrow" else "normal"

    def _cooled(self, now: float) -> bool:
        last = self.journal.last_done_ts(self.KINDS)
        return last is None or now - last >= self.cfg.cooldown_s

    def _execute(self, action_id: str, kind: str, rung: str,
                 cmd: str | None) -> None:
        # the chaos seam: a `die` rule at action_execute SIGKILLs the
        # actuator between the intent and outcome rows — the exact window
        # reconcile exists for
        faults.fire("action_execute", tag=f"{kind}:{action_id}")
        delivered = write_action_request(
            self.cfg.trainer_dir,
            {"ts": time.time(), "action": "resize", "rung": rung,
             "id": action_id})
        detail: dict[str, Any] = {"rung": rung, "delivered": delivered}
        if cmd:
            detail["cmd_pid"] = _run_shell(
                cmd, os.path.join(self.fleet_root, f"{kind}.log"))
        self.journal.finish(action_id, "done", **detail)

    def tick(self, status: dict | None, now: float) -> list[str]:
        """One evaluation against the latest fleet_status snapshot;
        returns the ids of actions taken."""
        firing = _firing_alerts(status)
        breaches = {rule: info for rule, info in firing.items()
                    if rule in self.cfg.breach_alerts}
        taken: list[str] = []
        mode = self.mode()
        if mode == "normal":
            self._quiet_since = None
            sustained = [info for info in breaches.values()
                         if info["since"] is not None
                         and now - info["since"] >= self.cfg.for_s]
            if sustained and self._cooled(now):
                info = sustained[0]
                action_id = self.journal.begin(
                    "borrow",
                    params={"rung": self.cfg.borrow_rung,
                            "trainer_dir": self.cfg.trainer_dir},
                    alert=info["key"])
                logger.info("autoscaler: %s firing since %.1fs ago -> "
                            "borrow (%s)", info["key"],
                            now - (info["since"] or now), action_id)
                self._execute(action_id, "borrow", self.cfg.borrow_rung,
                              self.cfg.scale_up_cmd)
                taken.append(action_id)
        else:
            if breaches:
                self._quiet_since = None
            else:
                if self._quiet_since is None:
                    self._quiet_since = now
                if now - self._quiet_since >= self.cfg.idle_for_s \
                        and self._cooled(now):
                    action_id = self.journal.begin(
                        "handback",
                        params={"rung": self.cfg.restore_rung,
                                "trainer_dir": self.cfg.trainer_dir})
                    logger.info("autoscaler: quiet for %.1fs -> handback "
                                "(%s)", now - self._quiet_since, action_id)
                    self._execute(action_id, "handback",
                                  self.cfg.restore_rung,
                                  self.cfg.scale_down_cmd)
                    taken.append(action_id)
                    self._quiet_since = None
        return taken

    def reconcile(self, intent: dict) -> str:
        """Resolve one of OUR open intents after an actuator crash:
        delivery evidence -> complete as done; none -> safely void (the
        request write never happened, so the world is unchanged and the
        still-firing alert will re-trigger). Returns the outcome."""
        evidence = _delivery_evidence(self.cfg.trainer_dir, intent["id"])
        if evidence:
            self.journal.finish(intent["id"], "done", reconciled=True,
                                evidence=evidence)
            return "done"
        self.journal.finish(intent["id"], "voided", reconciled=True,
                            reason="no delivery evidence after actuator "
                                   "crash; alert will re-trigger")
        return "voided"


def verified_steps(checkpoint_root: str) -> list[int]:
    """Every COMPLETE checkpoint step (meta.json landed), ascending —
    the plural of fleet.latest_verified_step, for rollback targeting."""
    try:
        names = os.listdir(checkpoint_root)
    except OSError:
        return []
    steps = []
    for name in names:
        m = re.match(r"^checkpoint-(\d+)$", name)
        if m and os.path.exists(os.path.join(checkpoint_root, name,
                                             "meta.json")):
            steps.append(int(m.group(1)))
    return sorted(steps)


def checkpoint_eval_loss(checkpoint_root: str, step: int) -> float | None:
    """The eval_loss train.py records into a checkpoint's meta.json (the
    deployment gate's input); None when the meta is absent/torn or the
    run never evaluated."""
    meta = read_json_file(os.path.join(checkpoint_root,
                                       f"checkpoint-{step}", "meta.json"))
    if not meta:
        return None
    try:
        val = float(meta.get("eval_loss"))
    except (TypeError, ValueError):
        return None
    return val if val == val else None


class Deployer:
    """Continuous checkpoint deployment, ground-truth driven: the
    deployed step is read from each replica's serve.json (never from
    memory), the candidate set from the trainer's checkpoint dir, and the
    gate from each checkpoint's recorded eval_loss."""

    KINDS = ("deploy", "rollback")

    def __init__(self, cfg: DeployConfig, journal: ActionJournal):
        self.cfg = cfg
        self.journal = journal

    def _deployed_step(self, replica_dir: str) -> int | None:
        serve = read_json_file(os.path.join(replica_dir, "serve.json"))
        step = (serve or {}).get("checkpoint_step")
        return step if isinstance(step, int) else None

    def _cooled(self, replica_dir: str, now: float) -> bool:
        ts = None
        for h in self.journal.history():
            res = h.get("result")
            if h.get("kind") in self.KINDS and res \
                    and res.get("outcome") == "done" \
                    and h.get("params", {}).get("replica_dir") == replica_dir:
                t = res.get("ts")
                if isinstance(t, (int, float)):
                    ts = t if ts is None else max(ts, t)
        return ts is None or now - ts >= self.cfg.cooldown_s

    def _held(self, replica_dir: str, step: int) -> bool:
        """Was this candidate already journaled as held for this replica?
        (one `hold` row per vetoed candidate, not one per tick)"""
        for h in self.journal.history():
            if h.get("kind") == "hold" \
                    and h.get("params", {}).get("replica_dir") == replica_dir \
                    and h.get("params", {}).get("step") == step:
                return True
        return False

    def _decide(self, replica_dir: str, firing: dict[str, dict],
                steps: list[int]) -> tuple[str, int, str] | None:
        """(kind, target step, reason) or None. The gate:

        - nothing deployed yet (or the deployed step vanished) -> tail
          the latest verified step.
        - the DEPLOYED step's eval_loss regressed vs the previous
          verified step's -> rollback to that previous step.
        - a NEWER verified step exists: deploy it unless its eval_loss
          regressed vs the deployed one (held, journaled once); a firing
          checkpoint_lag alert forces the handoff regardless.
        """
        if not steps:
            return None
        latest = steps[-1]
        deployed = self._deployed_step(replica_dir)
        lag_forced = (self.cfg.on_lag_alert
                      and "checkpoint_lag" in firing)
        if deployed is None or deployed not in steps:
            return ("deploy", latest, "tail")
        tol = self.cfg.eval_regression
        prior = [s for s in steps if s < deployed]
        if prior:
            prev = prior[-1]
            cur_eval = checkpoint_eval_loss(self.cfg.trainer_dir, deployed)
            prev_eval = checkpoint_eval_loss(self.cfg.trainer_dir, prev)
            if cur_eval is not None and prev_eval is not None \
                    and cur_eval > prev_eval + tol:
                return ("rollback", prev, "eval_regression")
        if latest > deployed:
            cand_eval = checkpoint_eval_loss(self.cfg.trainer_dir, latest)
            dep_eval = checkpoint_eval_loss(self.cfg.trainer_dir, deployed)
            regressed = (cand_eval is not None and dep_eval is not None
                         and cand_eval > dep_eval + tol)
            if lag_forced:
                return ("deploy", latest, "lag_alert")
            if regressed:
                if not self._held(replica_dir, latest):
                    hold_id = self.journal.begin(
                        "hold", params={"replica_dir": replica_dir,
                                        "step": latest,
                                        "deployed": deployed,
                                        "candidate_eval": cand_eval,
                                        "deployed_eval": dep_eval})
                    self.journal.finish(hold_id, "done",
                                        reason="candidate eval_loss "
                                               "regressed vs deployed")
                return None
            return ("deploy", latest, "tail")
        return None

    def tick(self, status: dict | None, now: float) -> list[str]:
        firing = _firing_alerts(status)
        steps = verified_steps(self.cfg.trainer_dir)
        taken: list[str] = []
        for replica_dir in self.cfg.replica_dirs:
            # an unconsumed request means the replica's supervisor has not
            # caught up — writing another would race its consume/apply
            if os.path.exists(os.path.join(replica_dir,
                                           ACTION_REQUEST_NAME)):
                continue
            decision = self._decide(replica_dir, firing, steps)
            if decision is None:
                continue
            kind, target, reason = decision
            if reason != "lag_alert" and not self._cooled(replica_dir, now):
                continue
            deployed = self._deployed_step(replica_dir)
            if target == deployed:
                continue
            action_id = self.journal.begin(
                kind, params={"replica_dir": replica_dir, "step": target,
                              "from_step": deployed, "reason": reason},
                alert=(firing.get("checkpoint_lag", {}).get("key")
                       if reason == "lag_alert" else None))
            logger.info("deployer: %s %s -> step %s (%s, %s)", kind,
                        replica_dir, target, reason, action_id)
            faults.fire("action_execute", tag=f"{kind}:{action_id}")
            delivered = write_action_request(
                replica_dir, {"ts": now, "action": "deploy",
                              "step": target, "id": action_id})
            self.journal.finish(action_id, "done", step=target,
                                delivered=delivered)
            taken.append(action_id)
        return taken

    def reconcile(self, intent: dict) -> str:
        """Deploy/rollback re-execution is idempotent (the request names
        an absolute step; delivering it twice converges to the same
        state), so an open intent COMPLETES: evidence -> done; no
        evidence -> re-deliver, then done."""
        params = intent.get("params") or {}
        replica_dir = params.get("replica_dir")
        step = params.get("step")
        if not isinstance(replica_dir, str) or not isinstance(step, int):
            self.journal.finish(intent["id"], "voided", reconciled=True,
                                reason="malformed intent params")
            return "voided"
        evidence = _delivery_evidence(replica_dir, intent["id"])
        if evidence is None and self._deployed_step(replica_dir) == step:
            evidence = "already_serving"
        if evidence:
            self.journal.finish(intent["id"], "done", reconciled=True,
                                evidence=evidence)
            return "done"
        delivered = write_action_request(
            replica_dir, {"ts": time.time(), "action": "deploy",
                          "step": step, "id": intent["id"]})
        self.journal.finish(intent["id"], "done", reconciled=True,
                            redelivered=delivered)
        return "done"


def reconcile_open_intents(journal: ActionJournal,
                           autoscaler: Autoscaler | None,
                           deployer: Deployer | None) -> list[tuple]:
    """Startup crash recovery: resolve every open intent through its
    actuator (complete or safely void); unowned kinds are voided — an
    intent nobody can execute must not pin the journal open forever.
    Returns [(id, kind, outcome)]."""
    resolved = []
    for intent in journal.open_intents():
        kind = intent.get("kind")
        if autoscaler is not None and kind in Autoscaler.KINDS:
            outcome = autoscaler.reconcile(intent)
        elif deployer is not None and kind in Deployer.KINDS:
            outcome = deployer.reconcile(intent)
        else:
            journal.finish(intent["id"], "voided", reconciled=True,
                           reason=f"no actuator configured for kind "
                                  f"{kind!r}")
            outcome = "voided"
        logger.info("reconciled open intent %s (%s): %s",
                    intent.get("id"), kind, outcome)
        resolved.append((intent.get("id"), kind, outcome))
    return resolved
