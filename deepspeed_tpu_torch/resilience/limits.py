"""Adaptive per-replica concurrency limits (docs/RESILIENCE.md
"Health & overload").

A copy of ``deepspeed_tpu/resilience/limits.py`` for the port, which imports nothing
of the JAX package; the text below is the JAX module's.

The concurrency-limits study (PAPERS.md: 2011.03641) frames the problem:
a static queue bound admits the same load against a fast replica and a
struggling one, so overload is only discovered after latency has already
collapsed. :class:`AdaptiveLimit` is the Vegas/gradient answer — a
per-replica ceiling on in-flight requests that *observes* dispatch
latency and moves:

- **shrink on latency rise** (multiplicative): when the Vegas queue
  estimate ``limit * (1 - min_rtt / rtt)`` exceeds ``beta``, the replica
  is queueing internally — the limit backs off by ``decrease`` (default
  0.9x), fast enough to drain a building convoy.
- **grow on headroom** (additive): when the estimate is under ``alpha``,
  the replica is under-utilized at the current ceiling — the limit
  probes up by ``+1/limit`` per sample (one whole slot per limit's worth
  of observations, the classic additive-increase shape).

``min_rtt`` is the observed no-load floor (monotone minimum of the
per-unit dispatch latency); ``rtt`` samples come from the same
``health_tap`` feed the :class:`~deepspeed_tpu.resilience.health.
HealthMonitor` rides, normalized per horizon unit.

The pool consults the limit in two places:

- :meth:`Router.place <deepspeed_tpu.serve.router.Router.place>` skips
  replicas with no :meth:`has_headroom` — an at-limit replica is simply
  not a placement candidate;
- accounting rides the ownership surface: ``admit`` at placement,
  ``release`` when the request finishes or migrates away, ``admit`` on
  the adopting side. The sanitizer's ``check_pool_health`` asserts the
  count is conserved against the pool's owner map every step.

Determinism (DSTPU005): pure arithmetic over fed samples; the uid ledger
is a dict (insertion-ordered) and no decision iterates a set.
"""

from typing import Dict, Optional


class AdaptiveLimit:
    """Vegas-style adaptive concurrency ceiling for one replica.

    ``alpha``/``beta`` are the Vegas thresholds on the estimated queue
    depth (requests sitting inside the replica beyond the no-load
    pipeline): below ``alpha`` the limit grows additively, above
    ``beta`` it shrinks multiplicatively, between them it holds."""

    def __init__(self, *, initial: int = 8, min_limit: int = 1,
                 max_limit: int = 64, alpha: float = 1.0,
                 beta: float = 3.0, decrease: float = 0.9):
        if not (1 <= min_limit <= initial <= max_limit):
            raise ValueError(
                f"need 1 <= min_limit({min_limit}) <= initial({initial}) "
                f"<= max_limit({max_limit})")
        if not (0.0 < decrease < 1.0):
            raise ValueError(f"decrease must be in (0, 1), got {decrease}")
        if beta < alpha:
            raise ValueError(f"beta({beta}) < alpha({alpha})")
        self.limit = float(initial)
        self.min_limit = min_limit
        self.max_limit = max_limit
        self.alpha = alpha
        self.beta = beta
        self.decrease = decrease
        #: observed no-load latency floor (seconds per dispatch unit)
        self.min_rtt: Optional[float] = None
        self.samples = 0
        self.grows = 0
        self.shrinks = 0
        #: in-flight ledger: uid -> True. A dict, not a set — idempotent
        #: admit/release and deterministic iteration for the sanitizer.
        self._inflight: Dict[int, bool] = {}

    # ------------------------------------------------------------------
    # admission accounting
    # ------------------------------------------------------------------
    @property
    def inflight(self) -> int:
        return len(self._inflight)

    def has_headroom(self) -> bool:
        return len(self._inflight) < int(self.limit)

    def headroom(self) -> int:
        """Free admission slots under the current ceiling (0 when
        saturated). Migration targeting — rebalance moves, disaggregated
        handoffs — ranks candidates by this, so a replica admission would
        reject never gets loaded through the side door either."""
        return max(0, int(self.limit) - len(self._inflight))

    def admit(self, uid: int) -> None:
        self._inflight[uid] = True

    def release(self, uid: int) -> None:
        self._inflight.pop(uid, None)

    def holds(self, uid: int) -> bool:
        return uid in self._inflight

    # ------------------------------------------------------------------
    # the gradient update
    # ------------------------------------------------------------------
    def observe(self, rtt_s: float) -> None:
        """One per-unit dispatch latency sample. The first sample seeds
        ``min_rtt``; every later one runs the Vegas update."""
        if rtt_s <= 0.0:
            return
        self.samples += 1
        if self.min_rtt is None:
            self.min_rtt = rtt_s
            return
        self.min_rtt = min(self.min_rtt, rtt_s)
        queue_est = self.limit * (1.0 - self.min_rtt / rtt_s)
        if queue_est > self.beta:
            new = max(float(self.min_limit), self.limit * self.decrease)
            if new < self.limit:
                self.shrinks += 1
            self.limit = new
        elif queue_est < self.alpha:
            new = min(float(self.max_limit), self.limit + 1.0 / self.limit)
            if new > self.limit:
                self.grows += 1
            self.limit = new

    # ------------------------------------------------------------------
    # views
    # ------------------------------------------------------------------
    def view(self) -> Dict[str, float]:
        return {"limit": self.limit, "inflight": float(self.inflight),
                "headroom": float(self.headroom()),
                "min_rtt_s": self.min_rtt or 0.0,
                "grows": self.grows, "shrinks": self.shrinks}

    def __repr__(self) -> str:
        return (f"AdaptiveLimit(limit={self.limit:.2f}, "
                f"inflight={self.inflight}, min_rtt={self.min_rtt})")
