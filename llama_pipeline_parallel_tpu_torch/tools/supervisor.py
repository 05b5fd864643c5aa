"""Supervised elastic restart for the trainer and the serve replicas.

The counterpart of the JAX package's tools/supervisor.py (its
docs/RESILIENCE.md): a watchdog that launches the training command, watches
the run's `health.json` heartbeat (utils/trace.Heartbeat: `time` stale =>
process dead or wedged), and restarts crashed or hung incarnations within a
bounded budget. Each incarnation is appended to the goodput ledger
`<output_dir>/incarnations.jsonl`, which tools.goodput_report folds into
its report, so restart badput is visible next to the buckets it depresses.

Usage:
  python -m llama_pipeline_parallel_tpu_torch.tools.supervisor \\
      --output-dir /runs/exp1 [options] -- \\
      python -m torch.distributed.run --nproc_per_node 2 \\
          -m llama_pipeline_parallel_tpu_torch.cli \\
          --config conf/llama_7b_pp4.yaml output_dir=/runs/exp1

The watchdog is workload-agnostic: a serving replica (tools.serve)
heartbeats the same health.json (with a `role: serve` label that lands in
the ledger), so multi-replica serving is N supervisors each watching one
serve process from a shared checkpoint.

Behavior:
- exit 0 from the child ends supervision (clean completion; the trainer's
  own preemption save counts — it exits 0).
- non-zero exit / signal death restarts the child, up to --max-restarts.
- a heartbeat stale for --hang-timeout-s (or never appearing for that
  long) marks the incarnation HUNG: the graceful stop (SIGTERM: the
  trainer's checkpoint-and-exit path), --grace-s to comply, then SIGKILL
  to every process the incarnation started.
- crash-loop detection: --crash-loop-threshold consecutive failures each
  younger than --crash-loop-window-s abort supervision (exit 3) — a
  deterministic crash must page a human, not burn the restart budget.
- SIGTERM/SIGINT to the supervisor forward to the child as the graceful
  stop and end the restart loop (the pod-preemption path: the trainer
  saves, everyone exits).

One process per device. The port's trainer runs one process per rank,
under `python -m torch.distributed.run` (or `torchrun`); that is its
counterpart of the JAX package's one process per host. So when the child
command is such a launch, the supervisor sets the launcher's
`--nproc_per_node` to the chosen ladder rung's `devices` (replacing the
value the command gives, or adding the option), and a rung that changes dp
changes the process count with it. The child starts in a session of its
own. The graceful stop goes to the launcher's workers, not to the launcher
(a SIGTERM to `torch.distributed.run` makes it exit nonzero even when its
workers saved and exited 0): the workers vote, save at one step and exit 0,
and the launcher then exits 0. The hard path kills the launcher and every
process below it, each worker's own session included, so no rank of a hung
incarnation outlives it (the process tree is read from /proc while the
child runs; the workers are reparented once the launcher dies). Any other
child is signalled itself, as in the reference.

Elastic fallback ladder: with --layout-ladder, each (re)launch first probes
the available device count and walks the ladder — an ordered list of
layouts, each with the minimum devices it needs and the config overrides
that select it:

  --layout-ladder '[{"name": "dp2", "devices": 2, "overrides": []},
                    {"name": "dp1", "devices": 1,
                     "overrides": ["mesh.dp=1",
                                   "gradient_accumulation_steps=4"]}]'

(inline JSON or @/path/to/ladder.json, the reference's format). The first
rung whose `devices` fits launches; its overrides are appended to the
training command, the trainer's elastic restore reshards the checkpoint onto
the new mesh, and the resize is recorded in the incarnation ledger
(`layout`, `devices`, `resized` fields). Keep every rung's GLOBAL batch
identical (compensate a dp shrink with more accumulation steps) for
sample-exact data continuity. The probe order is: an injected
`device_probe` fault verdict (chaos tests) > $LPT_DEVICE_COUNT >
--probe-cmd > `torch.cuda.device_count()` in a fresh process. When no rung
fits, the supervisor aborts with exit 4 — running a layout the hardware
cannot hold would just crash-loop.

Fleet observatory (utils/fleet.py): the supervisor writes its OWN heartbeat
to `<output_dir>/supervisor_health.json` (role=supervisor, restart count,
consecutive-failure crash-loop state, current child pid). With
--fleet-root, the supervisor and every child (re)launch are registered in
`<fleet-root>/registry.jsonl` (role/replica/output_dir/pid/incarnation/
layout), the discovery contract tools.fleetd aggregates a whole pod from.
With --actuate it consumes the `action.request` files an actuator
(tools.fleetctl, utils/actions.py) drops into the output dir: resize pins a
ladder rung (and drops `resize.request` for the trainer's resize vote),
deploy pins a serve checkpoint `--step`; both stop the child gracefully and
relaunch it without ending supervision.

Exit codes: 0 child completed; 2 restart budget exhausted; 3 crash loop;
4 no ladder rung fits the available devices; when the supervisor itself
is stopped, the child's own exit code (a signal death maps to the shell
convention 128+N), or 0 when no child was running (the supervisor then
launches none).

Resume correctness is the trainer's job (checkpoint integrity + fallback,
O(1) data repositioning); the supervisor only guarantees a fresh
incarnation gets launched with a command line whose layout the surviving
hardware can actually run. The supervisor touches no device itself.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
from typing import Any

from llama_pipeline_parallel_tpu_torch.utils import actions, faults, fleet, memwatch, trace

LEDGER_NAME = "incarnations.jsonl"
HEALTH_NAME = "health.json"
# actuation state persisted across SUPERVISOR restarts (pinned ladder
# rung / pinned serve checkpoint step): a restarted watchdog must keep
# honoring an applied action, not silently revert the pod
ACTION_STATE_NAME = "action_state.json"


def _now() -> float:
    return time.time()


def read_health(output_dir: str) -> dict | None:
    """The run's health.json, or None when absent/torn/not-a-dict (the
    writer is atomic, but the supervisor must survive any on-disk state)."""
    try:
        with open(os.path.join(output_dir, HEALTH_NAME)) as f:
            health = json.load(f)
    except (OSError, ValueError):
        return None
    return health if isinstance(health, dict) else None


# ---------------------------------------------------------------------------
# the launcher rule and the process tree
# ---------------------------------------------------------------------------

_LAUNCHERS = ("torch.distributed.run", "torchrun")
# the launcher's options that take no value (every other option takes one)
_LAUNCHER_FLAGS = {"-m", "--module", "--no-python", "--no_python", "--standalone",
                   "--run-path", "--run_path", "--virtual-local-rank",
                   "--virtual_local_rank"}
_NPROC = ("--nproc_per_node", "--nproc-per-node")
# seconds a launcher whose workers all left on the graceful stop is given to
# exit by itself before it is killed (its exit code is the incarnation's)
LAUNCHER_EXIT_S = 30.0


def _launcher_index(cmd: list[str]) -> int | None:
    """Index of the launcher in `cmd` (`-m torch.distributed.run`'s module
    name, or a `torchrun` executable), else None."""
    for i, arg in enumerate(cmd):
        if arg == "torch.distributed.run" and i and cmd[i - 1] == "-m":
            return i
        if os.path.basename(arg) == "torchrun":
            return i
    return None


def _set_nproc(cmd: list[str], devices: int) -> list[str]:
    """`cmd` with the launcher's --nproc_per_node set to `devices` (one
    process per device): the option's value is replaced where the launcher's
    own options give it, else the option is added after the launcher. A
    command that is no such launch is returned unchanged."""
    at = _launcher_index(cmd)
    if at is None:
        return list(cmd)
    out = list(cmd)
    i = at + 1
    while i < len(out) and out[i].startswith("-"):
        opt = out[i]
        if opt in _NPROC and i + 1 < len(out):
            out[i + 1] = str(devices)
            return out
        if opt.split("=", 1)[0] in _NPROC and "=" in opt:
            out[i] = f"{opt.split('=', 1)[0]}={devices}"
            return out
        if opt in ("-m", "--module"):  # the training module follows
            break
        i += 1 if opt in _LAUNCHER_FLAGS or "=" in opt else 2
    return out[:at + 1] + ["--nproc_per_node", str(devices)] + out[at + 1:]


def _stat(pid: int) -> tuple[int, int, str] | None:
    """(parent pid, start time, state) of a process from /proc, or None."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            raw = f.read()
    except OSError:
        return None
    fields = raw[raw.rindex(")") + 2:].split()
    return int(fields[1]), int(fields[19]), fields[0]


def _processes() -> dict[int, tuple[int, int, str]]:
    table = {}
    try:
        names = os.listdir("/proc")
    except OSError:
        return table
    for name in names:
        if name.isdigit():
            st = _stat(int(name))
            if st is not None:
                table[int(name)] = st
    return table


def _children(pid: int) -> list[int]:
    """The live processes whose parent is `pid`."""
    return sorted(p for p, (ppid, _, state) in _processes().items()
                  if ppid == pid and state != "Z")


def _descendants(pid: int) -> set[tuple[int, int]]:
    """(pid, start time) of every live process below `pid`."""
    table = _processes()
    below: dict[int, list[int]] = {}
    for p, (ppid, _, state) in table.items():
        if state != "Z":
            below.setdefault(ppid, []).append(p)
    out, todo = set(), list(below.get(pid, ()))
    while todo:
        p = todo.pop()
        out.add((p, table[p][1]))
        todo.extend(below.get(p, ()))
    return out


def _alive(pid: int, start: int) -> bool:
    """Whether the process `pid` that started at `start` still runs (a
    zombie has ended)."""
    st = _stat(pid)
    return st is not None and st[1] == start and st[2] != "Z"


@dataclasses.dataclass
class LayoutRung:
    """One rung of the elastic fallback ladder: the minimum device count
    this layout needs and the config overrides that select it."""

    devices: int
    overrides: tuple = ()
    name: str = ""

    def label(self) -> str:
        return self.name or (" ".join(self.overrides) or "base")


def parse_ladder(spec: str | None) -> list[LayoutRung] | None:
    """--layout-ladder value: inline JSON or `@/path/to/ladder.json`, a list
    of {"devices": int, "overrides": [str, ...], "name": str?} objects,
    ordered best-first."""
    if not spec:
        return None
    raw = spec.strip()
    if raw.startswith("@"):
        with open(raw[1:]) as f:
            data = json.load(f)
    else:
        data = json.loads(raw)
    if not isinstance(data, list) or not data:
        raise ValueError("--layout-ladder must be a non-empty JSON list")
    rungs = []
    for i, entry in enumerate(data):
        if not isinstance(entry, dict) or "devices" not in entry:
            raise ValueError(f"ladder rung #{i} must be an object with a "
                             f"'devices' key, got {entry!r}")
        unknown = set(entry) - {"devices", "overrides", "name"}
        if unknown:
            raise ValueError(f"ladder rung #{i}: unknown keys {sorted(unknown)}")
        rungs.append(LayoutRung(devices=int(entry["devices"]),
                                overrides=tuple(entry.get("overrides") or ()),
                                name=str(entry.get("name", ""))))
    return rungs


@dataclasses.dataclass
class SupervisorConfig:
    output_dir: str
    max_restarts: int = 5
    hang_timeout_s: float = 300.0
    grace_s: float = 30.0
    crash_loop_threshold: int = 3
    crash_loop_window_s: float = 120.0
    poll_s: float = 1.0
    ladder: list | None = None      # LayoutRungs, best-first (None = inelastic)
    probe_cmd: str | None = None    # shell command printing the device count
    # fleet observatory (utils/fleet.py): every launch is
    # registered in <fleet_root>/registry.jsonl so tools.fleetd can
    # discover and tail this member; role/replica label the registration
    # (role is otherwise learned from the child's own health.json)
    fleet_root: str | None = None
    role: str | None = None
    replica: str | None = None
    # alert-driven actuation (utils/actions.py): consume
    # atomic `action.request` files an actuator (tools.fleetctl) drops
    # into output_dir — resize pins a ladder rung, deploy pins a serve
    # checkpoint step; both gracefully restart the child WITHOUT ending
    # supervision. Off by default: without it the supervisor's behavior
    # is byte-identical to the pre-actuation watchdog.
    actuate: bool = False


class Supervisor:
    """Launch/watch/restart loop. Separated from main() so chaos tests can
    drive it in-process with fast timeouts."""

    def __init__(self, cmd: list[str], cfg: SupervisorConfig,
                 env: dict[str, str] | None = None):
        if not cmd:
            raise ValueError("supervisor needs a command to run")
        self.cmd = cmd
        self.cfg = cfg
        self.env = env
        self._child: subprocess.Popen | None = None
        self._stop_signal: int | None = None
        self._ledger_path = os.path.join(cfg.output_dir, LEDGER_NAME)
        os.makedirs(cfg.output_dir, exist_ok=True)
        # previous incarnation's rung label, seeded from the persisted
        # ledger so a resize across a SUPERVISOR restart (new process, same
        # output_dir) is still recorded as resized
        self._last_layout: str | None = self._last_ledger_layout()
        # the watchdog's OWN heartbeat (supervisor_health.json, started in
        # run()): watchdog staleness must be as observable as the child's —
        # a fleet whose supervisor died silently cannot restart anything
        self._hb = None
        self._hb_state: dict[str, Any] = {
            "incarnation": None, "child_pid": None, "restarts": 0,
            "consecutive_failures": 0, "last_outcome": None, "layout": None}
        # actuation (--actuate): pinned layout rung / serve checkpoint
        # step, persisted in action_state.json so a supervisor restart
        # keeps honoring an applied action; the action currently stopping
        # the child (its clean exit must NOT end supervision)
        self._pinned_rung: str | None = None
        self._pinned_step: int | None = None
        self._action_pending: dict | None = None
        self._action_state_path = os.path.join(cfg.output_dir,
                                               ACTION_STATE_NAME)
        # the incarnation's process tree: (pid, start time) of every process
        # seen below the child, and whether the child is a launcher
        self._tree: set[tuple[int, int]] = set()
        self._launcher_child = False
        # whether the stop signal reached the running child (one arriving
        # between launches, or before the child is known, is delivered by
        # the watch loop; twice would force-quit a trainer)
        self._stop_delivered = False
        if cfg.actuate:
            state = self._read_json(self._action_state_path)
            if state:
                if isinstance(state.get("rung"), str):
                    self._pinned_rung = state["rung"]
                if isinstance(state.get("step"), int):
                    self._pinned_step = state["step"]

    def _heartbeat_start(self) -> None:
        try:
            self._hb = trace.Heartbeat(
                self.cfg.output_dir,
                interval=min(10.0, max(self.cfg.poll_s, 0.5)),
                static={"role": "supervisor", "pid": os.getpid(),
                        "watched_dir": os.path.abspath(self.cfg.output_dir),
                        "max_restarts": self.cfg.max_restarts},
                extra=self._hb_state,
                filename=fleet.SUPERVISOR_HEALTH_NAME)
        except OSError as e:
            print(f"[supervisor] own heartbeat unavailable ({e!r})",
                  flush=True)
        try:
            if self.cfg.fleet_root:
                fleet.register_member(
                    self.cfg.fleet_root, output_dir=self.cfg.output_dir,
                    role="supervisor", pid=os.getpid(),
                    replica=self.cfg.replica,
                    health_file=fleet.SUPERVISOR_HEALTH_NAME)
        except Exception as e:
            # registration is telemetry; a full fleet disk must not stop
            # the watchdog from launching anything (_register_incarnation's
            # rule, applied to the supervisor's own row too)
            print(f"[supervisor] fleet registration failed: {e!r}",
                  flush=True)

    def _register_incarnation(self, incarnation: int, pid: int,
                              layout: dict | None) -> None:
        """Fleet registry contract: one row per LAUNCH, so the aggregator
        sees a fresh pid/incarnation the moment the child exists (and its
        registration vouches liveness until the first health.json write)."""
        if not self.cfg.fleet_root:
            return
        try:
            fleet.register_member(
                self.cfg.fleet_root, output_dir=self.cfg.output_dir,
                role=self.cfg.role, replica=self.cfg.replica,
                pid=pid, incarnation=incarnation,
                supervisor_pid=os.getpid(), **(layout or {}))
        except Exception as e:
            # registration is telemetry; a full fleet disk must not stop
            # the restart loop
            print(f"[supervisor] fleet registration failed: {e!r}",
                  flush=True)

    def _register_abort(self, reason: str) -> None:
        """Terminal registry rows for BOTH member keys (child + the
        supervisor's own) when supervision gives up (crash loop, budget,
        no rung): the aggregator stops counting them as fresh the moment
        it reads the row, instead of waiting out heartbeat_stale_s on a
        pod nothing will ever restart."""
        if not self.cfg.fleet_root:
            return
        try:
            fleet.register_member(
                self.cfg.fleet_root, output_dir=self.cfg.output_dir,
                role=self.cfg.role, replica=self.cfg.replica,
                pid=os.getpid(), outcome="aborted", reason=reason)
            fleet.register_member(
                self.cfg.fleet_root, output_dir=self.cfg.output_dir,
                role="supervisor", replica=self.cfg.replica,
                pid=os.getpid(), health_file=fleet.SUPERVISOR_HEALTH_NAME,
                outcome="aborted", reason=reason)
        except Exception as e:  # telemetry; the exit code must still land
            print(f"[supervisor] abort registration failed: {e!r}",
                  flush=True)

    # -- actuation (--actuate) -----------------------------------------------

    @staticmethod
    def _read_json(path: str) -> dict | None:
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return None
        return data if isinstance(data, dict) else None

    @staticmethod
    def _write_json_atomic(path: str, payload: dict) -> None:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2)
        os.replace(tmp, path)

    def _apply_step_override(self, cmd: list[str]) -> list[str]:
        """The pinned serve checkpoint step, spliced into the child
        command (any existing --step is replaced — the pin IS the
        deployment state)."""
        if self._pinned_step is None:
            return cmd
        out, i = [], 0
        while i < len(cmd):
            if cmd[i] == "--step" and i + 1 < len(cmd):
                i += 2
                continue
            if cmd[i].startswith("--step="):
                i += 1
                continue
            out.append(cmd[i])
            i += 1
        return out + ["--step", str(self._pinned_step)]

    def _consume_action_request(self, child: "subprocess.Popen | None"
                                ) -> dict | None:
        """One actuation RPC step: read + validate `action.request`,
        apply the pin, persist it, write the ack (the actuator's
        reconciliation evidence), remove the request, then gracefully
        stop the child (it saves/drains and exits 0 — the same contract
        as preemption). Crash-safe at every seam: the request file is
        removed LAST, so a supervisor killed mid-apply re-consumes an
        identical request on restart (pins are idempotent)."""
        req_path = os.path.join(self.cfg.output_dir,
                                actions.ACTION_REQUEST_NAME)
        req = self._read_json(req_path)
        if req is None:
            if os.path.exists(req_path):
                # torn/garbage request: drop it, or it wedges the
                # actuator's skip-if-present writer forever
                print(f"[supervisor] removing unreadable action request "
                      f"{req_path}", flush=True)
                try:
                    os.remove(req_path)
                except OSError:
                    pass
            return None
        action = req.get("action")
        if action == "resize":
            rung = req.get("rung")
            self._pinned_rung = rung if isinstance(rung, str) else None
            # the trainer's own boundary poll (actions.resize_on_request):
            # a labeled resize file it consumes at the next step boundary
            # — the SIGTERM below covers children that don't poll
            try:
                self._write_json_atomic(
                    os.path.join(self.cfg.output_dir,
                                 actions.RESIZE_REQUEST_NAME),
                    {"ts": _now(), "id": req.get("id"),
                     "rung": self._pinned_rung})
            except OSError:
                pass
        elif action == "deploy":
            try:
                self._pinned_step = int(req["step"])
            except (KeyError, TypeError, ValueError):
                print(f"[supervisor] deploy request without a valid step: "
                      f"{req!r}; ignoring", flush=True)
                try:
                    os.remove(req_path)
                except OSError:
                    pass
                return None
        else:
            print(f"[supervisor] unknown action {action!r}; ignoring",
                  flush=True)
            try:
                os.remove(req_path)
            except OSError:
                pass
            return None
        try:
            self._write_json_atomic(
                self._action_state_path,
                {"rung": self._pinned_rung, "step": self._pinned_step,
                 "last_id": req.get("id"), "ts": _now()})
            self._write_json_atomic(
                os.path.join(self.cfg.output_dir, actions.ACTION_ACK_NAME),
                {"ts": _now(), "id": req.get("id"), "action": action,
                 "rung": self._pinned_rung, "step": self._pinned_step})
        except OSError as e:
            print(f"[supervisor] could not persist action state: {e!r}",
                  flush=True)
        try:
            os.remove(req_path)
        except OSError:
            pass
        print(f"[supervisor] action {req.get('id')}: {action} "
              f"(rung={self._pinned_rung} step={self._pinned_step}); "
              f"restarting child gracefully", flush=True)
        if child is not None and child.poll() is None:
            # the trainer saves at a boundary, serve drains — both exit 0
            self._graceful_stop(child, signal.SIGTERM)
        return req

    def _last_ledger_layout(self) -> str | None:
        try:
            with open(self._ledger_path) as f:
                lines = [l for l in f if l.strip()]
            return json.loads(lines[-1]).get("layout") if lines else None
        except (OSError, ValueError, AttributeError):
            return None  # fresh run, torn tail, or a pre-elastic ledger

    # -- ledger ------------------------------------------------------------

    def _log_incarnation(self, rec: dict[str, Any]) -> None:
        """Append one incarnation row to the goodput ledger. Plain append:
        the supervisor is the file's only writer."""
        with open(self._ledger_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    # -- signal forwarding ---------------------------------------------------

    def _forward_signal(self, sig, _frame) -> None:
        self._stop_signal = sig
        child = self._child
        if child is not None and child.poll() is None:
            self._graceful_stop(child, sig)
            self._stop_delivered = True

    # -- the child's process tree --------------------------------------------

    def _graceful_stop(self, child: subprocess.Popen, sig: int
                       ) -> set[tuple[int, int]]:
        """Deliver the graceful stop: to a launcher's workers (each saves and
        exits 0, and the launcher then exits 0), else to the child itself. A
        launcher whose workers have not started yet gets the signal itself.
        Returns (pid, start time) of the workers signalled."""
        targets = (_children(child.pid) if self._launcher_child else [])
        workers = set()
        for pid in targets or [child.pid]:
            st = _stat(pid) if targets else None
            try:
                os.kill(pid, sig)
            except OSError:
                continue
            if st is not None:
                workers.add((pid, st[1]))
        return workers

    def _track_tree(self, child: subprocess.Popen) -> None:
        """Remember every process below the child, with its start time (a
        reused pid is never taken for it): once the launcher dies its workers
        are reparented and cannot be found from it any more."""
        self._tree.update(_descendants(child.pid))

    def _kill_tree(self, child: subprocess.Popen) -> None:
        """SIGKILL the child with its process group (while it is not reaped:
        a reaped pid may be another process's) and every live process seen
        below it, each with its own group where it leads one, then wait
        until none is left."""
        if child.poll() is None:
            self._track_tree(child)
            for kill in (os.killpg, os.kill):
                try:
                    kill(child.pid, signal.SIGKILL)
                except OSError:
                    pass
        for pid, start in sorted(self._tree):
            if not _alive(pid, start):
                continue
            try:
                if os.getpgid(pid) == pid:
                    os.killpg(pid, signal.SIGKILL)
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
        try:
            child.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass
        deadline = _now() + 30
        while _now() < deadline and any(_alive(p, s) for p, s in self._tree):
            time.sleep(0.05)

    # -- elastic layout selection --------------------------------------------

    def _probe_devices(self, incarnation: int) -> int | None:
        """Available device count for the next launch, or None when unknown
        (treated as "assume the full topology"). Probe order: an injected
        `device_probe` fault verdict (chaos plans simulate losing chips at
        restart) > $LPT_DEVICE_COUNT > --probe-cmd > this interpreter
        reading torch.cuda.device_count() in a fresh process (the dead
        child's devices are released by then)."""
        try:
            verdict = faults.fire("device_probe",
                                  tag=f"incarnation-{incarnation}")
        except Exception:
            verdict = None
        if verdict and verdict.startswith("device_loss:"):
            n = int(verdict.split(":", 1)[1])
            print(f"[supervisor] injected device loss: probe reports {n} "
                  f"device(s)", flush=True)
            return n
        env_count = (self.env or os.environ).get("LPT_DEVICE_COUNT")
        if env_count:
            try:
                return int(env_count)
            except ValueError:
                # the supervisor exists to survive faults — garbage in the
                # env falls through to the next probe, never a traceback
                print(f"[supervisor] ignoring malformed LPT_DEVICE_COUNT="
                      f"{env_count!r}", flush=True)
        probe_cmd = self.cfg.probe_cmd or (
            f"{sys.executable} -c 'import torch; print(torch.cuda.device_count())'")
        try:
            out = subprocess.run(probe_cmd, shell=True, env=self.env,
                                 capture_output=True, text=True, timeout=300)
            return int(out.stdout.strip().splitlines()[-1])
        except Exception as e:
            print(f"[supervisor] device probe failed ({e!r}); assuming the "
                  f"full topology", flush=True)
            return None

    def _select_rung(self, incarnation: int
                     ) -> tuple["LayoutRung | None", int | None]:
        """(rung, probed device count) for this launch; (None, n) when no
        rung fits. Without a ladder: (None, None) — inelastic, base command."""
        if not self.cfg.ladder:
            return None, None
        available = self._probe_devices(incarnation)
        if self._pinned_rung is not None:
            for rung in self.cfg.ladder:
                if rung.label() == self._pinned_rung:
                    # an applied resize action overrides best-fit: a
                    # BORROW deliberately runs a smaller rung than the
                    # probe would pick (the freed devices host a serve
                    # replica), so availability does not re-promote it
                    return rung, available
            print(f"[supervisor] pinned rung {self._pinned_rung!r} not in "
                  f"the ladder; falling back to best-fit", flush=True)
        for rung in self.cfg.ladder:
            if available is None or available >= rung.devices:
                return rung, available
        return None, available

    # -- one incarnation -----------------------------------------------------

    def _heartbeat_age(self, started_at: float) -> float:
        """Seconds since the run last proved liveness: health.json's `time`
        field when present, else the incarnation launch (covers the init
        window before the Heartbeat thread exists — size --hang-timeout-s
        for the model-build+restore+compile phase, not just step cadence)."""
        health = read_health(self.cfg.output_dir)
        last = started_at
        if health is not None:
            try:
                t = float(health.get("time", 0.0))
            except (TypeError, ValueError):
                t = 0.0
            # a stale file from a PREVIOUS incarnation must not vouch for
            # this one before it ever writes
            if t > started_at:
                last = t
        return _now() - last

    def _kill_hung(self, child: subprocess.Popen) -> None:
        """The graceful stop (the trainer checkpoints and exits cleanly),
        grace, then SIGKILL to the whole tree. A launcher whose workers all
        complied within the grace is given LAUNCHER_EXIT_S more to exit."""
        self._track_tree(child)
        workers = self._graceful_stop(child, signal.SIGTERM)
        try:
            child.wait(timeout=self.cfg.grace_s)
        except subprocess.TimeoutExpired:
            # the grace is the workers' to comply; once all have exited, the
            # launcher exits on its own at its next monitor poll and store
            # shutdown (~0.4 s on an idle host, more on a loaded one)
            if workers and not any(_alive(p, s) for p, s in workers):
                try:
                    child.wait(timeout=LAUNCHER_EXIT_S)
                except subprocess.TimeoutExpired:
                    pass
        self._kill_tree(child)

    def _run_once(self, incarnation: int, cmd: list[str] | None = None,
                  layout: dict | None = None) -> dict:
        cmd = cmd if cmd is not None else self.cmd
        started = _now()
        print(f"[supervisor] incarnation {incarnation}: {' '.join(cmd)}",
              flush=True)
        # a session of its own: the hard path kills the child's whole group
        child = subprocess.Popen(cmd, env=self.env, start_new_session=True)
        self._child = child
        self._launcher_child = _launcher_index(cmd) is not None
        self._tree = set()
        self._register_incarnation(incarnation, child.pid, layout)
        self._hb_state.update(incarnation=incarnation, child_pid=child.pid,
                              layout=(layout or {}).get("layout"))
        if self._hb is not None:
            try:
                self._hb.write()
            except OSError:  # full disk must not orphan the fresh child
                pass
        outcome = "clean"
        while True:
            self._track_tree(child)
            if self._stop_signal is not None and not self._stop_delivered:
                self._graceful_stop(child, self._stop_signal)
                self._stop_delivered = True
            rc = child.poll()
            if rc is not None:
                if self._stop_signal is not None:
                    outcome = "supervisor_stopped"
                elif rc != 0:
                    outcome = "crash"
                break
            if self.cfg.actuate and self._stop_signal is None \
                    and self._action_pending is None:
                self._action_pending = self._consume_action_request(child)
            if self._stop_signal is None \
                    and self._heartbeat_age(started) > self.cfg.hang_timeout_s:
                print(f"[supervisor] incarnation {incarnation} heartbeat "
                      f"stale > {self.cfg.hang_timeout_s:.0f}s; killing "
                      f"(SIGTERM, {self.cfg.grace_s:.0f}s grace, SIGKILL)",
                      flush=True)
                self._kill_hung(child)
                rc = child.returncode
                outcome = "hang"
                break
            time.sleep(self.cfg.poll_s)
        self._child = None
        # no process of this incarnation outlives it: a worker its launcher
        # left behind is killed before the next launch
        self._kill_tree(child)
        ended = _now()
        if outcome == "crash":
            # OOM forensics (utils/memwatch.py): the trainer's allocation-
            # failure handler dumps a snapshot into <output_dir>/oom/
            # before re-raising. A snapshot newer than THIS incarnation's
            # launch means memory pressure killed it — labeled distinctly
            # so goodput_report separates capacity problems (every restart
            # will OOM again) from transient crashes (a restart may help).
            oom_mtime = memwatch.latest_oom_mtime(self.cfg.output_dir)
            if oom_mtime is not None and oom_mtime > started:
                outcome = "oom"
        health = read_health(self.cfg.output_dir) or {}
        # a health.json the DEAD PREVIOUS incarnation wrote must not label
        # this one (same staleness rule as _heartbeat_age): an incarnation
        # that died before its first heartbeat gets None fields, not the
        # old topology/step
        try:
            fresh = float(health.get("time", 0.0)) > started
        except (TypeError, ValueError):
            fresh = False
        rec = {
            "incarnation": incarnation,
            "start": started,
            "end": ended,
            "duration_s": round(ended - started, 3),
            "exit_code": rc,
            "outcome": outcome,
            "last_step": health.get("last_step"),
            "goodput": health.get("goodput"),
            # the trainer's own view of its mesh (health.json `topology`,
            # written by the Heartbeat) — the ledger's authoritative label
            "trainer_topology": health.get("topology") if fresh else None,
        }
        # serve processes (tools.serve) heartbeat a `role` so the ledger
        # and goodput report can tell a serving incarnation from a training
        # one; absent for trainers, so their rows are unchanged
        if fresh and health.get("role"):
            rec["role"] = health.get("role")
        if layout is not None:
            rec.update(layout)
        if self._action_pending is not None:
            # the ledger shows WHY this incarnation ended: an applied
            # action, not a fault (outcome stays "clean" so goodput and
            # crash-loop accounting are untouched)
            rec["action"] = {"id": self._action_pending.get("id"),
                             "action": self._action_pending.get("action")}
        self._log_incarnation(rec)
        print(f"[supervisor] incarnation {incarnation} ended: "
              f"outcome={outcome} exit={rc} last_step={rec['last_step']}",
              flush=True)
        return rec

    # -- the loop ------------------------------------------------------------

    def run(self) -> int:
        prev_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev_handlers[sig] = signal.signal(sig, self._forward_signal)
            except ValueError:  # not the main thread (in-process tests)
                pass
        self._heartbeat_start()
        try:
            failures: list[dict] = []  # consecutive non-clean incarnations
            for incarnation in range(self.cfg.max_restarts + 1):
                if self.cfg.actuate and self._action_pending is None:
                    # a request that arrived while no child was running
                    # (or survived a supervisor crash mid-apply): apply
                    # the pin BEFORE launching, then clear — there is no
                    # child to stop, so it is not a pending restart
                    self._consume_action_request(None)
                rung, available = self._select_rung(incarnation)
                cmd, layout = self.cmd, None
                if self.cfg.ladder:
                    if rung is None:
                        print(f"[supervisor] no ladder rung fits "
                              f"{available} available device(s); aborting "
                              f"(a layout the hardware cannot hold would "
                              f"only crash-loop)", flush=True)
                        self._register_abort("no_rung_fits")
                        return 4
                    cmd = _set_nproc(self.cmd, rung.devices) + list(rung.overrides)
                    resized = (self._last_layout is not None
                               and rung.label() != self._last_layout)
                    if resized:
                        print(f"[supervisor] topology resize: "
                              f"{self._last_layout} -> {rung.label()} "
                              f"({available} device(s) available)",
                              flush=True)
                    layout = {"layout": rung.label(), "devices": available,
                              "overrides": list(rung.overrides),
                              "resized": resized}
                    self._last_layout = rung.label()
                cmd = self._apply_step_override(cmd)
                if self._stop_signal is not None:
                    # stopped while no child ran (the probe's window):
                    # nothing to save, so nothing is launched
                    print(f"[supervisor] signal {self._stop_signal} before "
                          f"incarnation {incarnation}; not launching", flush=True)
                    return 0
                rec = self._run_once(incarnation, cmd=cmd, layout=layout)
                self._hb_state.update(
                    last_outcome=rec["outcome"], restarts=incarnation,
                    consecutive_failures=(
                        0 if rec["outcome"] in ("clean", "supervisor_stopped")
                        else self._hb_state["consecutive_failures"] + 1))
                if rec["outcome"] == "clean":
                    if self._action_pending is not None:
                        # an applied action stopped the child (resize/
                        # deploy): its clean exit is a RESTART boundary,
                        # not the end of supervision — relaunch on the
                        # pinned state
                        self._action_pending = None
                        failures.clear()
                        continue
                    return 0
                if rec["outcome"] == "supervisor_stopped":
                    # pod preemption of the supervisor itself: the child was
                    # told, saved, and exited; propagate its code. A signal
                    # death maps to the shell convention 128+N — a raw
                    # negative returncode through sys.exit() would come out
                    # as an unrelated status (e.g. -15 -> 241)
                    rc = rec["exit_code"] or 0
                    return 128 - rc if rc < 0 else rc
                failures.append(rec)
                tail = failures[-self.cfg.crash_loop_threshold:]
                if (len(tail) >= self.cfg.crash_loop_threshold
                        and all(f["duration_s"] < self.cfg.crash_loop_window_s
                                for f in tail)):
                    print(f"[supervisor] crash loop: last {len(tail)} "
                          f"incarnations each died within "
                          f"{self.cfg.crash_loop_window_s:.0f}s; giving up",
                          flush=True)
                    self._register_abort("crash_loop")
                    return 3
            print(f"[supervisor] restart budget exhausted "
                  f"({self.cfg.max_restarts} restarts)", flush=True)
            self._register_abort("budget_exhausted")
            return 2
        finally:
            if self._hb is not None:
                try:  # final state: last outcome + restart count
                    self._hb.stop()
                except OSError:
                    pass  # heartbeat is telemetry; handlers must restore
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--output-dir", required=True,
                   help="the trainer's output_dir (health.json + the "
                        "incarnations.jsonl ledger live here)")
    p.add_argument("--max-restarts", type=int, default=5,
                   help="restarts after the first launch (default 5)")
    p.add_argument("--hang-timeout-s", type=float, default=300.0,
                   help="heartbeat staleness that declares a hang; must "
                        "cover the init+compile window (default 300)")
    p.add_argument("--grace-s", type=float, default=30.0,
                   help="SIGTERM->SIGKILL grace for a hung child (default 30)")
    p.add_argument("--crash-loop-threshold", type=int, default=3,
                   help="consecutive fast failures that abort (default 3)")
    p.add_argument("--crash-loop-window-s", type=float, default=120.0,
                   help="a failure younger than this counts toward the "
                        "crash loop (default 120)")
    p.add_argument("--poll-s", type=float, default=1.0,
                   help="watchdog poll interval (default 1)")
    p.add_argument("--layout-ladder", default=None,
                   help="elastic fallback ladder: JSON list of {devices, "
                        "overrides, name} rungs, best-first (inline or "
                        "@/path/to/ladder.json); each launch probes the "
                        "available devices and runs the first rung that "
                        "fits (exit 4 when none does)")
    p.add_argument("--probe-cmd", default=None,
                   help="shell command printing the available device count "
                        "(default: this interpreter reading "
                        "torch.cuda.device_count() in a fresh process); only "
                        "used with --layout-ladder")
    p.add_argument("--fleet-root", default=None,
                   help="fleet observatory home: register this member and "
                        "every (re)launch in <fleet-root>/registry.jsonl "
                        "for tools.fleetd")
    p.add_argument("--role", default=None,
                   help="registry role label (trainer/serve); default: "
                        "learned from the child's health.json")
    p.add_argument("--replica", default=None,
                   help="registry replica id; default: the output dir's "
                        "basename")
    p.add_argument("--actuate", action="store_true",
                   help="consume atomic action.request files an actuator "
                        "(tools.fleetctl) drops into the output dir: "
                        "resize pins a ladder rung, deploy pins a serve "
                        "checkpoint step; both restart the child "
                        "gracefully without ending supervision. Off by "
                        "default — without it behavior is identical to "
                        "the plain watchdog")
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="the training command, after `--`")
    args = p.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        p.error("no training command given (append `-- python -m torch.distributed.run "
                "... -m llama_pipeline_parallel_tpu_torch.cli ...`)")
    sup = Supervisor(cmd, SupervisorConfig(
        output_dir=args.output_dir, max_restarts=args.max_restarts,
        hang_timeout_s=args.hang_timeout_s, grace_s=args.grace_s,
        crash_loop_threshold=args.crash_loop_threshold,
        crash_loop_window_s=args.crash_loop_window_s, poll_s=args.poll_s,
        ladder=parse_ladder(args.layout_ladder), probe_cmd=args.probe_cmd,
        fleet_root=args.fleet_root, role=args.role, replica=args.replica,
        actuate=args.actuate))
    return sup.run()


if __name__ == "__main__":
    sys.exit(main())
