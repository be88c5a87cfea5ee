"""The retry and deadline primitives of the serve path.

Copy of ``our_tree_tpu.resilience.policy``, trimmed to what the port
calls: ``Budget`` (wall-clock budget arithmetic, the per-request deadline,
with ``debit`` for a simulated fault's cost) and ``RetryPolicy`` with
bounded attempts, exponential backoff, a per-failure observer and a
fallback on exhaustion (the lanes' on-lane retry, ``isolate.run_child``,
the native build). The reference's jitter, per-attempt and total budgets,
stop predicate and per-exception delays have no caller here. Stdlib only.
"""

from __future__ import annotations

import time

from ..obs import trace


class PolicyExhausted(Exception):
    """Every attempt failed. ``last`` is the final attempt's exception (also
    ``__cause__``)."""

    def __init__(self, name: str, attempts: int, last: BaseException | None):
        self.name, self.attempts, self.last = name, attempts, last
        super().__init__(
            f"{name or 'retry policy'}: exhausted after {attempts} attempt(s); last failure: "
            f"{type(last).__name__ if last else 'none'}: {last}")


class Budget:
    """Wall-clock budget accounting; ``total_s <= 0`` is unbudgeted (never
    exhausted). ``debit(seconds)`` charges a simulated
    cost (an injected hang) without sleeping."""

    def __init__(self, total_s: float = 0.0, clock=time.monotonic):
        self.total_s = max(float(total_s), 0.0)
        self._clock = clock
        self._t0 = clock()
        self._debited = 0.0

    def spent(self) -> float:
        """Wall seconds consumed so far, debits included."""
        return self._clock() - self._t0 + self._debited

    def remaining(self) -> float:
        """Seconds left (``inf`` when unbudgeted, floored at 0)."""
        if not self.total_s:
            return float("inf")
        return max(self.total_s - self.spent(), 0.0)

    def exhausted(self) -> bool:
        return bool(self.total_s) and self.spent() >= self.total_s

    def debit(self, seconds: float) -> None:
        self._debited += max(float(seconds), 0.0)


class Attempt:
    """What one attempt knows: its 0-based ``index``."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index


class RetryPolicy:
    """Run ``op(attempt)`` until it returns or ``attempts`` are spent.
    Exceptions of ``retry_on`` mean "maybe retry", anything else propagates;
    between failures it sleeps ``base_delay_s * factor**index``. ``log(attempt,
    exc)`` observes each failure. Exhaustion returns ``on_exhausted(last)``
    when that is given, else raises ``PolicyExhausted``."""

    def __init__(self, *, attempts: int = 3, base_delay_s: float = 0.0, factor: float = 2.0,
                 retry_on: tuple = (Exception,), on_exhausted=None, log=None, name: str = "",
                 sleep=time.sleep):
        if attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {attempts}")
        self.attempts = attempts
        self.base_delay_s = base_delay_s
        self.factor = factor
        self.retry_on = retry_on
        self.on_exhausted = on_exhausted
        self.log = log
        self.name = name
        self.sleep = sleep

    def run(self, op):
        last: BaseException | None = None
        for index in range(self.attempts):
            if index and self.base_delay_s:
                self.sleep(self.base_delay_s * self.factor ** (index - 1))
            attempt = Attempt(index)
            try:
                return op(attempt)
            except self.retry_on as e:
                last = e
                trace.counter("retry_failures", policy=self.name or "retry", attempt=index,
                              error=type(e).__name__)
                if self.log is not None:
                    self.log(attempt, e)
        trace.point("retry-exhausted", policy=self.name or "retry", attempts=self.attempts,
                    error=type(last).__name__ if last else None)
        if self.on_exhausted is not None:
            return self.on_exhausted(last)
        raise PolicyExhausted(self.name, self.attempts, last) from last
