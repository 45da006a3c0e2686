"""Step watchdog: wall-clock budgets for engine steps and the drain.

A copy of ``deepspeed_tpu/resilience/watchdog.py`` for the port, which imports nothing
of the JAX package; the text below is the JAX module's.

``StepWatchdog`` is pure accounting — the scheduler times each engine call
(``perf_counter``, always wall time, even under a simulated scheduling
clock) and reports it here. A step over ``step_budget_s`` is a **breach**
(counted, per kind); ``escalate_after`` consecutive breaches is an
**escalation** — the scheduler feeds escalations to the circuit breaker as
failures, so a slow-but-not-crashing engine (the TPU tail-latency mode the
Gemma/TPU serving comparisons treat as first-class) eventually opens the
breaker just like a crashing one. A fast step resets the consecutive
counter.

``drain_budget_s`` bounds ``close()``: a drain that cannot finish inside
the budget stops stepping and cancels the stragglers instead of hanging
shutdown forever (breaches of this budget are the ``drain_aborts`` metric).

``hard_breach_after`` is the escalation *above* escalation: that many
consecutive escalations (with no healthy step in between) means the engine
is wedged, not merely slow — breaker-driven shedding would keep rejecting
traffic forever while the wedged dispatch never completes. The watchdog
then raises ``UnrecoverableEngineError``, which the scheduler answers with
engine-loss recovery (rebuild + journal replay, docs/RESILIENCE.md) instead
of shedding.

All three knobs default to ``None`` = disabled: the watchdog is zero-cost
until an operator opts in, and existing breach/escalation behaviour is
unchanged unless ``hard_breach_after`` is set."""

from typing import Dict, Optional, Tuple

from .errors import UnrecoverableEngineError


class StepWatchdog:
    def __init__(self, step_budget_s: Optional[float] = None,
                 escalate_after: int = 3,
                 drain_budget_s: Optional[float] = None,
                 hard_breach_after: Optional[int] = None):
        if escalate_after < 1:
            raise ValueError(
                f"escalate_after must be >= 1, got {escalate_after}")
        if hard_breach_after is not None and hard_breach_after < 1:
            raise ValueError(
                f"hard_breach_after must be >= 1, got {hard_breach_after}")
        self.step_budget_s = step_budget_s
        self.escalate_after = escalate_after
        self.drain_budget_s = drain_budget_s
        self.hard_breach_after = hard_breach_after
        self.breaches = 0
        self.escalations = 0
        self.hard_breaches = 0
        self.worst_s = 0.0
        self.breaches_by_kind: Dict[str, int] = {}
        self._consecutive = 0
        self._consecutive_escalations = 0

    def observe(self, kind: str, duration_s: float,
                scale: float = 1.0) -> Tuple[bool, bool]:
        """Record one step; returns ``(breached, escalated)``.

        ``scale`` multiplies the budget for this observation: a fused
        K-step decode dispatch (docs/SERVING.md) legitimately takes ~K× the
        wall clock of a single step, so the scheduler passes its horizon —
        per-token slowness still breaches, amortized bulk work does not."""
        self.worst_s = max(self.worst_s, duration_s)
        budget = (None if self.step_budget_s is None
                  else self.step_budget_s * scale)
        if budget is None or duration_s <= budget:
            self._consecutive = 0
            self._consecutive_escalations = 0
            return False, False
        self.breaches += 1
        self.breaches_by_kind[kind] = self.breaches_by_kind.get(kind, 0) + 1
        self._consecutive += 1
        if self._consecutive >= self.escalate_after:
            self.escalations += 1
            self._consecutive = 0  # escalation resets the streak
            self._consecutive_escalations += 1
            if (self.hard_breach_after is not None
                    and self._consecutive_escalations
                    >= self.hard_breach_after):
                # wedged, not slow: hand the scheduler an engine-loss
                # signal instead of another breaker failure — recovery
                # replaces the engine, shedding would just reject forever
                self.hard_breaches += 1
                self._consecutive_escalations = 0
                raise UnrecoverableEngineError(
                    f"watchdog hard breach: {self.hard_breach_after} "
                    f"consecutive escalation(s) on {kind!r} "
                    f"(worst {self.worst_s:.3f}s vs budget "
                    f"{self.step_budget_s}s) — dispatch is wedged")
            return True, True
        return True, False
