"""Circuit breaker with priority-floor load shedding (docs/RESILIENCE.md).

A copy of ``deepspeed_tpu/resilience/breaker.py`` for the port, which imports nothing
of the JAX package; the text below is the JAX module's.

State machine::

    CLOSED --(failure_threshold consecutive failures)--> OPEN
    OPEN   --(cooldown_s elapses; next poll)-----------> HALF_OPEN
    HALF_OPEN --(one successful engine call)-----------> CLOSED
    HALF_OPEN --(any failure)--------------------------> OPEN   (re-armed)

Failures are engine-call faults (transient occurrences, persistent
per-request faults, watchdog escalations) — NOT capacity pressure
(``PoolExhaustedError``), which preemption absorbs by design. While OPEN the
scheduler keeps driving live work (the serving loop is also the probe
transport), but ``submit`` sheds arrivals whose priority is below
``shed_priority_floor`` with a typed ``SheddingError``; traffic at or above
the floor still lands, so SLA-critical requests ride through the incident.
Successes during OPEN do not close the breaker — only the cooldown-gated
HALF_OPEN probe can, so one lucky step inside a failure storm cannot flap
the breaker shut.

All timestamps come from an injectable clock *passed by the caller* (the
scheduler forwards its own scheduling clock), so tests and simulated loads
drive transitions deterministically. Every transition is appended to
``transitions`` as ``(t, state_name)`` — the bench persists this trail."""

import enum
from typing import List, Tuple


class BreakerState(enum.Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


class CircuitBreaker:
    def __init__(self, failure_threshold: int = 5, cooldown_s: float = 1.0,
                 shed_priority_floor: int = 1):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}")
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.shed_priority_floor = shed_priority_floor
        self.state = BreakerState.CLOSED
        self.consecutive_failures = 0
        self.opened_at = 0.0
        self.opens = 0
        self.half_opens = 0
        self.closes = 0
        self.transitions: List[Tuple[float, str]] = []

    def _move(self, state: BreakerState, now: float) -> None:
        self.state = state
        self.transitions.append((now, state.value))

    def poll(self, now: float) -> BreakerState:
        """Advance time-driven transitions (OPEN -> HALF_OPEN); call once
        per scheduler step and before any shed decision."""
        if (self.state is BreakerState.OPEN
                and now - self.opened_at >= self.cooldown_s):
            self.half_opens += 1
            self._move(BreakerState.HALF_OPEN, now)
        return self.state

    def on_failure(self, now: float) -> None:
        self.consecutive_failures += 1
        if self.state is BreakerState.HALF_OPEN:
            # the probe failed: re-arm the cooldown
            self.opens += 1
            self.opened_at = now
            self._move(BreakerState.OPEN, now)
        elif (self.state is BreakerState.CLOSED
              and self.consecutive_failures >= self.failure_threshold):
            self.opens += 1
            self.opened_at = now
            self._move(BreakerState.OPEN, now)

    def rearm_half_open(self, now: float) -> None:
        """Engine-loss recovery (docs/RESILIENCE.md): after a hot rebuild
        the scheduler re-arms the breaker straight into HALF_OPEN from any
        state — the fresh incarnation is unproven, so the next engine call
        is the probe (success closes, failure re-opens with a full
        cooldown). Skipping the OPEN cooldown is deliberate: the cooldown
        exists to give a *sick* engine time to heal, and the sick engine
        was just thrown away."""
        self.consecutive_failures = 0
        if self.state is not BreakerState.HALF_OPEN:
            self.half_opens += 1
            self._move(BreakerState.HALF_OPEN, now)

    def on_success(self, now: float) -> None:
        self.consecutive_failures = 0
        if self.state is BreakerState.HALF_OPEN:
            self.closes += 1
            self._move(BreakerState.CLOSED, now)

    def should_shed(self, priority: int, now: float) -> bool:
        """True when this submission must be rejected with SheddingError."""
        return (self.poll(now) is BreakerState.OPEN
                and priority < self.shed_priority_floor)

    @property
    def state_gauge(self) -> float:
        """Numeric state for dashboards: 0 closed, 1 half-open, 2 open."""
        return {BreakerState.CLOSED: 0.0, BreakerState.HALF_OPEN: 1.0,
                BreakerState.OPEN: 2.0}[self.state]
