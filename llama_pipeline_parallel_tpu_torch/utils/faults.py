"""Deterministic fault injection for chaos-testing the recovery paths.

A copy of llama_pipeline_parallel_tpu/utils/faults.py (stdlib only), so a
plan parses and fires the same way in both packages. With no plan
configured, `fire()` is a single `is None` check.

A **fault plan** is a dict (config node `fault_plan`, or the
`LPT_FAULT_PLAN` env var holding inline JSON or `@/path/to/plan.json`):

    {"seed": 0,
     "faults": [
       {"site": "storage_write", "op": "error", "match": "meta.json",
        "times": 2},
       {"site": "barrier",  "op": "stall", "seconds": 2.0},
       {"site": "data_read", "op": "slow", "seconds": 0.05, "every": 10},
       {"site": "data_read", "op": "corrupt", "times": 1},
       {"site": "step", "op": "die", "at_step": 7},
       {"site": "ckpt_commit", "op": "die", "after": 1,
        "marker": "/tmp/run/fired.marker"}]}

Rule fields (all optional except `site` + `op`):
  match     substring the call site's `tag` must contain
  at_step   only fire when the call site's `step` equals this
  after     skip the first N matching invocations (per process)
  times     fire at most N times (per process; default unlimited)
  every     fire on every Nth matching invocation (1 = every one)
  p         fire with this probability (seeded RNG — deterministic for a
            fixed plan seed and invocation order)
  marker    path to a file: skip if it exists, create it when firing —
            the cross-restart "fire once EVER" latch (counters reset when
            the supervisor relaunches the process; the marker does not)
  seconds   stall/slow duration
  signal    for op=die: signal name (default SIGKILL — a crash, not a
            clean shutdown; SIGTERM would take the graceful-preemption
            path instead)

Ops:
  error     raise InjectedFault (an OSError subclass, so the shared retry
            policy treats it as a transient storage/read failure)
  stall/slow  sleep `seconds` (barrier stall, slow record)
  corrupt   `fire()` returns "corrupt" and the call site mangles its own
            payload (the loader turns the record into a read failure)
  die       kill this process with `signal` (simulates preemption/crash —
            mid-async-save when attached to the ckpt_commit site)
  grad_nonfinite  (`step` site) `fire()` returns "grad_nonfinite:<stage>"
            (extra field `stage`, default 0): the JAX trainer poisons that
            pipeline stage's gradients
  device_loss  (`device_probe` site) `fire()` returns
            "device_loss:<devices>" (extra field `devices`, default 0: the
            remaining device count)
  oom       (`step` site) `fire()` returns "oom": the JAX trainer raises a
            synthetic allocation failure

Sites: `storage_write` (checkpoint file I/O), `ckpt_commit` (between the
files' durability and the meta/tag write), `barrier` (inside each attempt of
parallel/distributed.barrier), `data_read` (per-record dataset reads), `step`
(top of every training step), `device_probe` (the supervisor's
available-device probe), `action_execute` (an actuator between its intent
and outcome rows, utils/actions.py) and `gateway_dispatch` (each dispatch
attempt of serve/gateway.py). The trainer fires the first five
(train.FAULT_SITES); tools.supervisor, the actuators and the gateway fire
the other three from the same plan.
"""

from __future__ import annotations

import json
import os
import random
import signal as _signal
import threading
import time

from llama_pipeline_parallel_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

ENV_PLAN = "LPT_FAULT_PLAN"

_OPS = ("error", "stall", "slow", "corrupt", "die", "grad_nonfinite",
        "device_loss", "oom")
_SITES = ("storage_write", "ckpt_commit", "barrier", "data_read", "step",
          "device_probe", "action_execute", "gateway_dispatch")


class InjectedFault(OSError):
    """A planned transient fault. Subclasses OSError so the shared retry
    policy (utils/retry.py) retries it exactly like a real storage blip."""


class FaultPlanError(ValueError):
    """The plan itself is malformed — always fatal, never injected."""


class _Rule:
    def __init__(self, spec: dict, index: int, rng_seed: int):
        unknown = set(spec) - {"site", "op", "match", "at_step", "after",
                               "times", "every", "p", "marker", "seconds",
                               "signal", "stage", "devices"}
        if unknown:
            raise FaultPlanError(f"fault rule #{index}: unknown keys {sorted(unknown)}")
        try:
            self.site = spec["site"]
            self.op = spec["op"]
        except KeyError as e:
            raise FaultPlanError(f"fault rule #{index}: missing {e}") from None
        if self.site not in _SITES:
            raise FaultPlanError(
                f"fault rule #{index}: unknown site {self.site!r} (use one of {_SITES})")
        if self.op not in _OPS:
            raise FaultPlanError(
                f"fault rule #{index}: unknown op {self.op!r} (use one of {_OPS})")
        self.match = spec.get("match")
        self.at_step = spec.get("at_step")
        self.after = int(spec.get("after", 0))
        self.times = spec.get("times")
        self.every = int(spec.get("every", 1))
        self.p = spec.get("p")
        self.marker = spec.get("marker")
        self.seconds = float(spec.get("seconds", 0.0))
        self.stage = int(spec.get("stage", 0))
        self.devices = int(spec.get("devices", 0))
        if self.devices < 0:
            raise FaultPlanError(
                f"fault rule #{index}: devices must be >= 0, got {self.devices}")
        self.signal = spec.get("signal", "SIGKILL")
        if not hasattr(_signal, self.signal):
            raise FaultPlanError(f"fault rule #{index}: unknown signal {self.signal!r}")
        self.index = index
        self.seen = 0   # matching invocations observed
        self.fired = 0  # times actually fired
        # per-rule RNG: deterministic for a fixed plan seed + invocation
        # order, independent of every other rule's draw sequence. crc32, not
        # hash(): string hashing is salted per process, and a plan must draw
        # identically across supervisor restarts
        import zlib

        self._rng = random.Random(
            rng_seed ^ zlib.crc32(f"{index}:{self.site}".encode()))

    def should_fire(self, tag: str, step: int | None) -> bool:
        if self.match is not None and self.match not in tag:
            return False
        if self.at_step is not None and step != self.at_step:
            return False
        self.seen += 1
        if self.seen <= self.after:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        if (self.seen - self.after - 1) % max(self.every, 1):
            return False
        if self.p is not None and self._rng.random() >= self.p:
            return False
        if self.marker:
            if os.path.exists(self.marker):
                return False
            # atomic create-or-skip: two threads (main loop + async commit)
            # must not both claim a single-shot rule
            try:
                fd = os.open(self.marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.close(fd)
            except FileExistsError:
                return False
        self.fired += 1
        return True


class FaultInjector:
    def __init__(self, plan: dict):
        if not isinstance(plan, dict):
            raise FaultPlanError(f"fault plan must be a dict, got {type(plan).__name__}")
        seed = int(plan.get("seed", 0))
        faults = plan.get("faults", [])
        if not isinstance(faults, list):
            raise FaultPlanError("fault plan 'faults' must be a list of rules")
        self._rules = [_Rule(spec, i, seed) for i, spec in enumerate(faults)]
        self._lock = threading.Lock()

    def fire(self, site: str, tag: str = "", step: int | None = None) -> str | None:
        """Run the plan's matching rules for one call-site invocation.
        Returns "corrupt" when a corrupt rule fired (the caller mangles its
        payload); raises InjectedFault for error rules; sleeps for
        stall/slow; kills the process for die."""
        verdict = None
        for rule in self._rules:
            if rule.site != site:
                continue
            with self._lock:  # counters must tick atomically across threads
                firing = rule.should_fire(tag, step)
            if not firing:
                continue
            desc = (f"injected fault #{rule.index} {rule.op}@{site}"
                    f" (tag={tag!r}, step={step}, fire {rule.fired})")
            if rule.op in ("stall", "slow"):
                logger.warning("%s: sleeping %.3fs", desc, rule.seconds)
                time.sleep(rule.seconds)
            elif rule.op == "error":
                logger.warning("%s: raising", desc)
                raise InjectedFault(desc)
            elif rule.op == "corrupt":
                logger.warning("%s: corrupting payload", desc)
                verdict = "corrupt"
            elif rule.op == "grad_nonfinite":
                logger.warning("%s: poisoning stage %d gradients nonfinite",
                               desc, rule.stage)
                verdict = f"grad_nonfinite:{rule.stage}"
            elif rule.op == "device_loss":
                logger.warning("%s: simulating device loss (%d remaining)",
                               desc, rule.devices)
                verdict = f"device_loss:{rule.devices}"
            elif rule.op == "oom":
                logger.warning("%s: simulating allocation failure", desc)
                verdict = "oom"
            elif rule.op == "die":
                # raw stderr write then a hard kill: the point is an unclean
                # death (no atexit, no finally) — exactly what a preempted
                # or OOM-killed pod process looks like
                os.write(2, f"[faults] {desc}: killing process\n".encode())
                os.kill(os.getpid(), getattr(_signal, rule.signal))
                time.sleep(30)  # SIGKILL delivery race; never proceed past a die
        return verdict

    def stats(self) -> list[dict]:
        return [{"index": r.index, "site": r.site, "op": r.op,
                 "seen": r.seen, "fired": r.fired} for r in self._rules]


# -- process-global injector -------------------------------------------------

_INJECTOR: FaultInjector | None = None
_ENV_LOADED = False


def configure(plan: dict | None) -> FaultInjector | None:
    """Install (or clear, with None) the process-global fault plan."""
    global _INJECTOR, _ENV_LOADED
    _ENV_LOADED = True  # explicit configure overrides lazy env pickup
    _INJECTOR = FaultInjector(plan) if plan else None
    if _INJECTOR is not None:
        logger.warning("fault injection ACTIVE: %d rule(s) — this is a chaos "
                       "run, not a production run", len(_INJECTOR._rules))
    return _INJECTOR


def configure_from_env() -> FaultInjector | None:
    """Install the plan from LPT_FAULT_PLAN (inline JSON, or `@<path>` /
    a bare path to a JSON file). No-op without the variable."""
    raw = os.environ.get(ENV_PLAN, "").strip()
    if not raw:
        return configure(None)
    if raw.startswith("@"):
        raw = raw[1:]
    if not raw.lstrip().startswith("{"):
        with open(raw) as f:
            return configure(json.load(f))
    try:
        plan = json.loads(raw)
    except json.JSONDecodeError as e:
        raise FaultPlanError(f"{ENV_PLAN} is neither valid JSON nor a "
                             f"readable path: {e}") from e
    return configure(plan)


def active() -> FaultInjector | None:
    """The current injector, lazily picking up LPT_FAULT_PLAN on first use
    (call sites deep in the loader/checkpoint never need explicit wiring)."""
    global _ENV_LOADED
    if not _ENV_LOADED:
        _ENV_LOADED = True
        configure_from_env()
    return _INJECTOR


def fire(site: str, tag: str = "", step: int | None = None) -> str | None:
    """The one call threaded through the codebase. Free when no plan is
    configured."""
    inj = active()
    if inj is None:
        return None
    return inj.fire(site, tag, step=step)


def has_rule(site: str, op: str) -> bool:
    """Does the active plan carry a rule for (site, op)? Build-time probe:
    the trainer only compiles the chaos-only poison input into the jitted
    step when a grad_nonfinite rule exists, so steady-state runs keep the
    unchanged two-argument step signature."""
    inj = active()
    return inj is not None and any(
        r.site == site and r.op == op for r in inj._rules)


def rule_field_values(site: str, op: str, field: str) -> list:
    """Every matching rule's value for one field (e.g. the grad_nonfinite
    `stage`s) — lets the trainer validate plan fields it alone can bound
    (a stage index only means something against the pipeline's mesh)."""
    inj = active()
    if inj is None:
        return []
    return [getattr(r, field) for r in inj._rules
            if r.site == site and r.op == op]
