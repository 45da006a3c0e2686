"""Elastic pool scaling: a control loop over ``EnginePool.scale_to``
(docs/SERVING.md "Elastic scaling").

A copy of ``deepspeed_tpu/serve/elastic.py`` for the port, which imports nothing
of the JAX package; the text below is the JAX module's.

The pool already knows how to grow and shrink losslessly — ``scale_to``
composes spawn/undrain and drain/migrate/retire. What it does not know
is *when*. :class:`ElasticController` closes that loop from the same
gauges the overload machinery already maintains:

- **utilization** — in-flight work against capacity. With adaptive
  limits armed (``pool.enable_limits``) capacity is each replica's live
  Vegas ceiling, so the controller chases the measured service capacity,
  not a static guess; without limits it falls back to a configured
  ``capacity_per_replica``.
- **backlog** — admitted-but-unprefilled tokens
  (``scheduler.prefill_backlog_tokens``) plus queued requests: committed
  work utilization cannot see yet. A pool that looks 60% utilized while
  sitting on a deep prompt backlog is under-provisioned, not idle.

Decisions are guarded three ways, because elasticity that flaps is worse
than no elasticity:

- **hysteresis** — a scale verdict must hold for ``hysteresis_ticks``
  consecutive ticks before it acts; one bursty tick moves nothing.
- **cooldown** — after any resize, ``cooldown_s`` of clock time must
  pass before the next (spawning a replica has a warmup cost; let the
  last action land before judging it insufficient).
- **shrink safety** — scale-down is DEFERRED (not queued) unless the
  survivors can absorb the victims' load below the scale-up threshold;
  a deferred shrink simply re-evaluates next tick. Scale-up failures
  are absorbed by ``scale_to`` itself (the pool continues at its
  current size) — the controller just sees the smaller pool and may
  retry after cooldown.

Determinism (DSTPU005): the controller never reads a wall clock — time
comes from the pool's injected clock, so a replayed trace makes the same
scaling decisions at the same virtual instants.
"""

from typing import Dict, Optional

from .pool import EnginePool, SERVING
from .router import Router

__all__ = ["ElasticController"]


class ElasticController:
    """Drive :meth:`EnginePool.scale_to` from pool load gauges.

    Call :meth:`tick` once per pool step (or on any cadence — decisions
    are rate-limited by hysteresis and cooldown, not by call frequency).
    Returns the signed replica delta it applied (0 almost always).
    """

    def __init__(self, pool: EnginePool, *,
                 min_replicas: int = 1,
                 max_replicas: int = 8,
                 scale_up_at: float = 0.85,
                 scale_down_at: float = 0.35,
                 backlog_high_tokens: int = 4096,
                 capacity_per_replica: int = 8,
                 hysteresis_ticks: int = 3,
                 cooldown_s: float = 5.0):
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas ({min_replicas}) <= "
                f"max_replicas ({max_replicas})")
        if not 0.0 <= scale_down_at < scale_up_at <= 1.0:
            raise ValueError(
                f"need 0 <= scale_down_at ({scale_down_at}) < "
                f"scale_up_at ({scale_up_at}) <= 1")
        self.pool = pool
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.scale_up_at = scale_up_at
        self.scale_down_at = scale_down_at
        self.backlog_high_tokens = backlog_high_tokens
        self.capacity_per_replica = capacity_per_replica
        self.hysteresis_ticks = hysteresis_ticks
        self.cooldown_s = cooldown_s
        self._high_ticks = 0
        self._low_ticks = 0
        self._last_resize_at: Optional[float] = None
        #: lifetime counters (bench / tests)
        self.counters: Dict[str, int] = {
            "ticks": 0, "ups": 0, "downs": 0, "deferred_downs": 0}

    # ------------------------------------------------------------------
    # gauges
    # ------------------------------------------------------------------
    def _capacity(self, rep) -> float:
        if rep.limit is not None:
            return max(1.0, float(rep.limit.limit))
        return float(self.capacity_per_replica)

    def utilization(self) -> float:
        """Pool utilization in [0, ~]: owned non-terminal work over live
        capacity. Backlogged prefill tokens count through
        :meth:`Router.load`'s request-equivalents, so a replica chewing
        a long admitted prompt reads busy, not idle."""
        serving = [r for r in self.pool.replicas if r.state == SERVING]
        if not serving:
            return 0.0
        load = float(sum(Router.load(r) for r in serving))
        cap = sum(self._capacity(r) for r in serving)
        return load / cap

    def backlog_tokens(self) -> int:
        return sum(r.scheduler.prefill_backlog_tokens()
                   for r in self.pool.replicas if r.state == SERVING)

    # ------------------------------------------------------------------
    # the control loop
    # ------------------------------------------------------------------
    def tick(self) -> int:
        """Evaluate the gauges once; resize by at most one replica."""
        self.counters["ticks"] += 1
        serving = [r for r in self.pool.replicas if r.state == SERVING]
        n = len(serving)
        if n == 0:
            return 0  # nothing serving: revival is supervision's job
        util = self.utilization()
        pressure = (util >= self.scale_up_at
                    or self.backlog_tokens() >= self.backlog_high_tokens)
        idle = (util <= self.scale_down_at
                and self.backlog_tokens() == 0)
        self._high_ticks = self._high_ticks + 1 if pressure else 0
        self._low_ticks = self._low_ticks + 1 if idle else 0
        now = self.pool._clock()
        if (self._last_resize_at is not None
                and now - self._last_resize_at < self.cooldown_s):
            return 0
        if self._high_ticks >= self.hysteresis_ticks and n < self.max_replicas:
            got = self.pool.scale_to(n + 1)
            self._high_ticks = self._low_ticks = 0
            self._last_resize_at = now
            if got > 0:
                self.counters["ups"] += 1
            return got
        if self._low_ticks >= self.hysteresis_ticks and n > self.min_replicas:
            # shrink safety: survivors must absorb the victim's load
            # without being pushed straight past the scale-up threshold
            load = float(sum(Router.load(r) for r in serving))
            cap_after = sum(sorted((self._capacity(r) for r in serving),
                                   reverse=True)[:n - 1])
            if cap_after > 0 and load / cap_after > self.scale_up_at:
                self.counters["deferred_downs"] += 1
                return 0
            got = self.pool.scale_to(n - 1)
            self._high_ticks = self._low_ticks = 0
            self._last_resize_at = now
            if got < 0:
                self.counters["downs"] += 1
            return got
        return 0
