"""Bounded exponential-backoff-with-jitter retry for transient faults.

A copy of llama_pipeline_parallel_tpu/utils/retry.py (stdlib only): the one
retry policy every storage call site shares. Checkpoint writes, reads,
digests and commits (ckpt/checkpoint.py) run under it, so a flaky network
mount costs a few delayed seconds instead of the run.

Env knobs (read at call time, so tests and launchers can override without
code changes):
  LPT_RETRY_MAX_ATTEMPTS  total tries incl. the first (default 4)
  LPT_RETRY_BASE_DELAY_S  first backoff delay (default 0.5)
  LPT_RETRY_MAX_DELAY_S   backoff ceiling (default 30)
  LPT_RETRY_SEED          jitter RNG seed (default: derived from pid --
                          set it for bit-reproducible chaos tests)
"""

from __future__ import annotations

import dataclasses
import os
import random
import time
from typing import Any, Callable, Iterable

from llama_pipeline_parallel_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """`max_attempts` TOTAL tries; attempt k (1-based) sleeps
    `min(base_delay_s * multiplier**(k-1), max_delay_s)` scaled by a
    uniform jitter in [1-jitter, 1+jitter] before the next try."""

    max_attempts: int = 4
    base_delay_s: float = 0.5
    max_delay_s: float = 30.0
    multiplier: float = 2.0
    jitter: float = 0.25

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")

    @classmethod
    def from_env(cls, **overrides: Any) -> "RetryPolicy":
        """The shared default policy, with env knobs applied (explicit
        `overrides` win over env; env wins over the dataclass defaults)."""
        env: dict[str, Any] = {}
        for field, var, cast in (("max_attempts", "LPT_RETRY_MAX_ATTEMPTS", int),
                                 ("base_delay_s", "LPT_RETRY_BASE_DELAY_S", float),
                                 ("max_delay_s", "LPT_RETRY_MAX_DELAY_S", float)):
            raw = os.environ.get(var)
            if raw:
                env[field] = cast(raw)
        env.update(overrides)
        return cls(**env)

    def delay_s(self, attempt: int, rng: random.Random) -> float:
        """Backoff before try `attempt + 1` (attempt is 0-based tries done)."""
        base = min(self.base_delay_s * self.multiplier ** max(attempt - 1, 0),
                   self.max_delay_s)
        return base * rng.uniform(1.0 - self.jitter, 1.0 + self.jitter)


def backoff_delay_s(policy: RetryPolicy, attempt: int, rng: random.Random,
                    floor_s: float = 0.0) -> float:
    """The backoff before try `attempt + 1` with a server-supplied floor:
    when the upstream answered 429/503 with a Retry-After hint, honoring
    it means never retrying EARLIER than the hint — the policy's
    exponential curve still applies on top, so repeated hints cannot pin
    a client into a hot loop at the server's minimum (the serve/gateway.py
    dispatch rule, spelled here next to the curve it composes with)."""
    return max(policy.delay_s(attempt, rng), floor_s)


def _rng(seed: int | None) -> random.Random:
    if seed is None:
        raw = os.environ.get("LPT_RETRY_SEED")
        seed = int(raw) if raw else os.getpid()
    return random.Random(seed)


def retry_call(fn: Callable[[], Any], *,
               policy: RetryPolicy | None = None,
               retryable: Iterable[type[BaseException]] = (OSError,),
               non_retryable: Iterable[type[BaseException]] = (),
               describe: str = "",
               seed: int | None = None,
               on_retry: Callable[[int, BaseException], None] | None = None) -> Any:
    """Call `fn()` under the policy; re-raise the last error once the attempt
    budget is spent. Only `retryable` exception types retry — anything else
    (a programming error, a corrupt-checkpoint verdict) propagates
    immediately: retrying a deterministic failure just delays the crash.
    `non_retryable` carves deterministic subclasses back out of a broad
    retryable base (FileNotFoundError out of OSError: an absent checkpoint
    is a fact, not a blip).

    `describe` labels the log lines (e.g. the path being written);
    `on_retry(attempt, err)` is a test/telemetry hook fired before each
    backoff sleep."""
    pol = policy or RetryPolicy.from_env()
    retryable = tuple(retryable)
    non_retryable = tuple(non_retryable)
    rng = None  # constructed only when a retry actually happens: the happy
    #            path (every hot-loop dataset read) pays zero RNG setup
    for attempt in range(1, pol.max_attempts + 1):
        try:
            return fn()
        except retryable as e:
            if non_retryable and isinstance(e, non_retryable):
                raise
            if attempt >= pol.max_attempts:
                logger.error("%s failed after %d attempts: %r",
                             describe or "retried call", attempt, e)
                raise
            if rng is None:
                rng = _rng(seed)
            delay = pol.delay_s(attempt, rng)
            logger.warning("%s failed (attempt %d/%d): %r; retrying in %.2fs",
                           describe or "retried call", attempt,
                           pol.max_attempts, e, delay)
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(delay)
    raise AssertionError("unreachable")  # pragma: no cover
