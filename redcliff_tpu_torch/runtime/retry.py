"""Reusable retry/backoff/deadline primitives (the port's copy of
``redcliff_tpu/runtime/retry.py``; the code is the JAX module's, bit for
bit).

One policy object for every probe or spread loop: exponential backoff with
bounded jitter, an optional wall-clock deadline, an attempt budget, and a
fixed-schema outcome log (:meth:`RetryOutcome.log`), so an artifact can
tell "device dead" from "policy too impatient".

stdlib only.
"""
from __future__ import annotations

import time
from dataclasses import asdict, dataclass, field
from typing import Any, Callable

__all__ = ["RetryPolicy", "RetryOutcome", "GiveUp", "retry",
           "PROBE_RETRY_POLICY"]


class GiveUp(Exception):
    """Raised by a retried callable to abort the retry loop immediately (the
    failure is known-terminal; further attempts would waste the budget)."""


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with bounded jitter and an optional deadline.

    Attempt 0 runs immediately; attempt ``k`` waits
    ``min(base_delay_s * multiplier**(k-1), max_delay_s)`` first, widened by a
    uniform jitter of ±``jitter_frac`` when an ``rng`` is supplied (spreads
    fleet-synchronized callers; deterministic without one). ``deadline_s``
    bounds the WHOLE loop: an attempt whose backoff would land past the
    deadline is not started, and the outcome records ``deadline_hit``.
    """

    max_attempts: int = 5
    base_delay_s: float = 1.0
    multiplier: float = 2.0
    max_delay_s: float = 60.0
    jitter_frac: float = 0.0
    deadline_s: float | None = None

    def backoff_s(self, attempt: int, rng=None) -> float:
        if attempt <= 0:
            return 0.0
        d = min(self.base_delay_s * self.multiplier ** (attempt - 1),
                self.max_delay_s)
        if rng is not None and self.jitter_frac > 0:
            d *= 1.0 + self.jitter_frac * (2.0 * rng.random() - 1.0)
        return d

    def schedule(self, rng=None):
        """The full per-attempt backoff list (len == max_attempts)."""
        return [self.backoff_s(i, rng=rng) for i in range(self.max_attempts)]

    def as_dict(self):
        return asdict(self)


@dataclass
class RetryOutcome:
    """Result of a :func:`retry` loop plus its fixed-schema attempt log."""

    ok: bool
    value: Any = None
    error: str | None = None
    deadline_hit: bool = False
    attempts: list = field(default_factory=list)
    policy: dict = field(default_factory=dict)

    def log(self):
        """The fixed schema recorded into BENCH/cache artifacts: policy knobs,
        one record per attempt (index, backoff actually waited, offset from
        loop start, outcome, info), whether the deadline cut the loop."""
        return {
            "policy": dict(self.policy),
            "attempts": [dict(a) for a in self.attempts],
            "num_attempts": len(self.attempts),
            "deadline_hit": bool(self.deadline_hit),
            "ok": bool(self.ok),
            "error": self.error,
        }


def retry(fn: Callable[[int], Any], policy: RetryPolicy, *,
          is_success: Callable[[Any], bool] | None = None,
          retryable: Callable[[BaseException], bool] | None = None,
          info_of: Callable[[Any], str] | None = None,
          sleep: Callable[[float], None] = time.sleep,
          monotonic: Callable[[], float] = time.monotonic,
          rng=None) -> RetryOutcome:
    """Run ``fn(attempt_index)`` under ``policy`` until it succeeds.

    Success = the call returns (no exception) and ``is_success(result)`` (all
    returns succeed when ``is_success`` is None). Failure handling:

    - a falsy ``is_success`` verdict consumes the attempt and backs off;
    - an exception for which ``retryable(exc)`` is false (or ``retryable`` is
      None) re-raises immediately — only declared-transient errors burn
      attempts; a retryable exception that exhausts the budget re-raises too,
      so exception-style callers never get a silent None;
    - :class:`GiveUp` aborts the loop immediately with ``ok=False`` (the
      callable learned the failure is terminal).

    ``sleep``/``monotonic``/``rng`` are injectable for the fault-injection
    tests (assert the backoff schedule without waiting it out).
    Returns a :class:`RetryOutcome`; ``outcome.log()`` is the fixed schema.
    """
    t0 = monotonic()
    out = RetryOutcome(ok=False, policy=policy.as_dict())
    last_exc = None
    for attempt in range(policy.max_attempts):
        backoff = policy.backoff_s(attempt, rng=rng)
        if (policy.deadline_s is not None
                and (monotonic() - t0) + backoff > policy.deadline_s):
            out.deadline_hit = True
            break
        if backoff:
            sleep(backoff)
        rec = {"attempt": attempt, "backoff_s": round(backoff, 3),
               "t_offset_s": round(monotonic() - t0, 3)}
        try:
            result = fn(attempt)
        except GiveUp as e:
            rec.update(ok=False, info=f"gave up: {e}")
            out.attempts.append(rec)
            out.error = f"gave up: {e}"
            return out
        except Exception as e:  # noqa: BLE001 - classified right below
            if retryable is None or not retryable(e):
                raise
            last_exc = e
            rec.update(ok=False, info=repr(e)[:300])
            out.attempts.append(rec)
            continue
        ok = bool(is_success(result)) if is_success is not None else True
        rec.update(ok=ok,
                   info=(info_of(result) if info_of is not None else None))
        out.attempts.append(rec)
        last_exc = None
        if ok:
            out.ok = True
            out.value = result
            return out
    if last_exc is not None:
        raise last_exc
    if out.error is None:
        out.error = ("deadline exceeded" if out.deadline_hit
                     else f"no success in {len(out.attempts)} attempt(s)")
    return out


# The shared accelerator-probe policy: attempts spread 15 s -> 2 min apart
# (backoffs 0/15/30/60/120) and the whole loop gives up after 15 minutes, so
# a wedged device cannot stretch pure probing without bound. Callers whose
# attempts embed long work must widen deadline_s to cover that work. Jitter
# only applies when the caller passes an rng to retry().
PROBE_RETRY_POLICY = RetryPolicy(
    max_attempts=5, base_delay_s=15.0, multiplier=2.0, max_delay_s=120.0,
    jitter_frac=0.1, deadline_s=900.0)
