"""Pool health supervision: gray-failure detection with hysteresis
(docs/RESILIENCE.md "Health & overload").

A copy of ``deepspeed_tpu/resilience/health.py`` for the port, which imports nothing
of the JAX package; the text below is the JAX module's.

The engine pool already survives a replica that dies *loudly* — a
``DeviceLostError`` escalates out of ``scheduler.step`` and the pool
replays the dead replica's journal across survivors. Production fleets
mostly fail *quietly*: a replica running 10x slow (thermal throttle, a
sick host, a noisy neighbour) stays ``SERVING`` while dragging pool-wide
p99 TTFT. :class:`HealthMonitor` closes that gap with two signals:

- **latency**: every successful dispatch feeds a per-replica
  per-token-unit latency EMA (``duration_s / scale`` — a K-step fused
  dispatch is K units of legitimate work). Samples accumulate into
  fixed-size windows; a window whose mean exceeds the SLO is a breach.
  ``k_windows`` CONSECUTIVE breaches quarantine the replica — the
  hysteresis that keeps one GC pause or compile stall from draining a
  healthy replica.
- **heartbeat lease**: every observed step renews a wall-lease. A
  replica whose lease expires without a single heartbeat is not slow,
  it is *gone* (wedged dispatch, dead control thread) — the monitor
  declares it lost and the pool absorbs it through the existing
  journal-replay path.

Detector state machine, per replica::

    SERVING --breached window--> SUSPECT --k consecutive--> QUARANTINED
       ^                            |                            |
       |<------clean window---------+                            |
       |                                                         |
       +<--- recovery_probes consecutive good probes (undrain) --+

While QUARANTINED the replica is health-drained (its live requests
migrate to survivors via the ``detach``/``adopt`` seam) and probed: the
pool times a no-op dispatch against the drained engine at exponentially
backed-off intervals (``probe_backoff_s`` doubling to
``probe_backoff_max_s``; a good probe holds the interval, a bad one
doubles it). ``recovery_probes`` consecutive sub-SLO probes restore the
replica to rotation.

The SLO is either explicit (``slo_s``) or adaptive: ``slo_factor`` x the
*fastest* healthy replica's EMA — the floor is robust when a minority of
the pool is degraded, which is the gray-failure shape.

Determinism (DSTPU005): the monitor never reads a wall clock — every
entry point takes ``now`` from the caller's injectable clock, and all
per-replica state lives in dicts iterated in sorted-id order. Fed the
same observation trace, the monitor emits the same verdicts.
"""

from typing import Callable, Dict, List, Optional, Tuple

from ..utils.logging import logger

#: detector states (plain strings — they cross log/health-view boundaries)
SERVING = "serving"
SUSPECT = "suspect"
QUARANTINED = "quarantined"
LOST = "lost"


class ReplicaHealth:
    """Per-replica detector record (one per pool member)."""

    def __init__(self, lease_deadline: Optional[float],
                 role: str = "mixed"):
        self.state = SERVING
        #: the replica's serving role (docs/SERVING.md "Disaggregated
        #: serving") — purely observational here, but per-role views make
        #: a dead prefill tier visible as such, not as generic churn
        self.role = role
        #: per-unit dispatch latency EMA (seconds per horizon unit)
        self.ema = 0.0
        self.samples = 0
        self._win_sum = 0.0
        self._win_n = 0
        #: consecutive breached windows (the hysteresis counter)
        self.breach_windows = 0
        self.lease_deadline = lease_deadline
        #: quarantine bookkeeping
        self.drained = False          # pool acked the drain
        self.probe_at: Optional[float] = None
        self.probe_backoff_s = 0.0
        self.good_probes = 0
        #: lifetime counters (health view / metrics)
        self.suspects = 0
        self.quarantines = 0
        self.probes = 0
        self.probe_failures = 0
        self.recoveries = 0
        self.lease_expiries = 0

    def view(self) -> Dict[str, object]:
        return {"state": self.state, "role": self.role, "ema_s": self.ema,
                "breach_windows": self.breach_windows,
                "lease_deadline": self.lease_deadline,
                "quarantines": self.quarantines, "probes": self.probes,
                "recoveries": self.recoveries,
                "lease_expiries": self.lease_expiries}


class HealthMonitor:
    """Gray-failure detector over an engine pool's replicas.

    The pool drives it: it calls :meth:`heartbeat` after every
    replica step, :meth:`observe` from every successful dispatch (the
    scheduler's ``health_tap``), and :meth:`poll` once per pool step to
    collect verdicts — ``("quarantine", rid)`` (drain the replica) and
    ``("lost", rid)`` (absorb it through journal replay). While a
    replica is quarantined the pool asks :meth:`probe_due` and reports
    probe outcomes through :meth:`observe_probe`, which returns True
    when the replica has recovered and should be undrained.

    ``clock`` is only used as a default ``now`` for callers that omit
    it; every method takes an explicit ``now`` so tests drive the
    detector on a virtual timeline."""

    def __init__(self, *, clock: Callable[[], float],
                 slo_s: Optional[float] = None, slo_factor: float = 4.0,
                 window: int = 8, k_windows: int = 3,
                 lease_s: float = 30.0, probe_backoff_s: float = 0.25,
                 probe_backoff_max_s: float = 8.0,
                 recovery_probes: int = 2):
        if window < 1 or k_windows < 1 or recovery_probes < 1:
            raise ValueError("window, k_windows and recovery_probes must "
                             "be >= 1")
        self._clock = clock
        self.slo_s = slo_s
        self.slo_factor = slo_factor
        self.window = window
        self.k_windows = k_windows
        self.lease_s = lease_s
        self.probe_backoff_s = probe_backoff_s
        self.probe_backoff_max_s = probe_backoff_max_s
        self.recovery_probes = recovery_probes
        self._replicas: Dict[int, ReplicaHealth] = {}
        #: verdicts produced by observe()/poll(), drained by poll() in
        #: replica-id order (deterministic emission)
        self._pending_quarantine: List[int] = []

    # ------------------------------------------------------------------
    # registration
    # ------------------------------------------------------------------
    def attach(self, replica_id: int, now: Optional[float] = None,
               role: str = "mixed") -> None:
        now = self._clock() if now is None else now
        self._replicas[replica_id] = ReplicaHealth(now + self.lease_s,
                                                   role=role)

    def _rec(self, replica_id: int) -> ReplicaHealth:
        rec = self._replicas.get(replica_id)
        if rec is None:
            raise ValueError(f"replica {replica_id} is not attached to "
                             "this HealthMonitor")
        return rec

    # ------------------------------------------------------------------
    # SLO
    # ------------------------------------------------------------------
    def slo(self) -> float:
        """The breach threshold (seconds per dispatch unit): explicit
        ``slo_s`` when configured, else ``slo_factor`` x the fastest
        non-quarantined replica's EMA. ``inf`` until a baseline exists —
        the detector never fires on a cold pool."""
        if self.slo_s is not None:
            return self.slo_s
        floor = None
        for rid in sorted(self._replicas):
            rec = self._replicas[rid]
            if rec.state in (SERVING, SUSPECT) and rec.samples >= self.window:
                if floor is None or rec.ema < floor:
                    floor = rec.ema
        return float("inf") if floor is None or floor <= 0.0 \
            else self.slo_factor * floor

    # ------------------------------------------------------------------
    # feeds
    # ------------------------------------------------------------------
    def heartbeat(self, replica_id: int,
                  now: Optional[float] = None) -> None:
        """The replica's control loop is alive: renew its lease."""
        now = self._clock() if now is None else now
        rec = self._rec(replica_id)
        if rec.state in (SERVING, SUSPECT):
            rec.lease_deadline = now + self.lease_s

    def observe(self, replica_id: int, duration_s: float,
                scale: float = 1.0, *,
                now: Optional[float] = None) -> None:
        """One successful dispatch on ``replica_id``: ``duration_s``
        wall seconds for ``scale`` horizon units of work. Renews the
        lease (a dispatch IS a heartbeat) and advances the window/EMA
        state machine."""
        now = self._clock() if now is None else now
        rec = self._rec(replica_id)
        if rec.state not in (SERVING, SUSPECT):
            return  # quarantined/lost replicas are fed via probes only
        rec.lease_deadline = now + self.lease_s
        unit = duration_s / max(scale, 1.0)
        rec.ema = unit if rec.samples == 0 else 0.7 * rec.ema + 0.3 * unit
        rec.samples += 1
        rec._win_sum += unit
        rec._win_n += 1
        if rec._win_n < self.window:
            return
        mean = rec._win_sum / rec._win_n
        rec._win_sum = 0.0
        rec._win_n = 0
        if mean > self.slo():
            rec.breach_windows += 1
            if rec.state == SERVING:
                rec.state = SUSPECT
                rec.suspects += 1
            if rec.breach_windows >= self.k_windows:
                rec.state = QUARANTINED
                rec.quarantines += 1
                rec.drained = False
                rec.good_probes = 0
                rec.probe_backoff_s = self.probe_backoff_s
                rec.probe_at = None
                self._pending_quarantine.append(replica_id)
                logger.warning(
                    "health: replica %d breached SLO %.4fs for %d "
                    "consecutive window(s) (mean %.4fs) — quarantining",
                    replica_id, self.slo(), rec.breach_windows, mean)
        else:
            rec.breach_windows = 0
            if rec.state == SUSPECT:
                rec.state = SERVING

    # ------------------------------------------------------------------
    # verdicts
    # ------------------------------------------------------------------
    def poll(self, now: Optional[float] = None
             ) -> List[Tuple[str, int]]:
        """Collect pending verdicts in replica-id order:
        ``("quarantine", rid)`` — drain the replica (gray failure);
        ``("lost", rid)`` — its heartbeat lease expired, absorb it."""
        now = self._clock() if now is None else now
        out: List[Tuple[str, int]] = []
        for rid in sorted(dict.fromkeys(self._pending_quarantine)):
            out.append(("quarantine", rid))
        self._pending_quarantine = []
        for rid in sorted(self._replicas):
            rec = self._replicas[rid]
            if (rec.state in (SERVING, SUSPECT)
                    and rec.lease_deadline is not None
                    and now > rec.lease_deadline):
                rec.state = LOST
                rec.lease_expiries += 1
                logger.error(
                    "health: replica %d heartbeat lease expired "
                    "(deadline %.3f < now %.3f) — declaring lost",
                    rid, rec.lease_deadline, now)
                out.append(("lost", rid))
        return out

    def note_drained(self, replica_id: int,
                     now: Optional[float] = None) -> None:
        """The pool completed the quarantine drain; probing starts after
        the initial backoff."""
        now = self._clock() if now is None else now
        rec = self._rec(replica_id)
        rec.drained = True
        rec.probe_backoff_s = self.probe_backoff_s
        rec.probe_at = now + rec.probe_backoff_s

    def note_deferred(self, replica_id: int) -> None:
        """The pool could not honour a quarantine verdict (no surviving
        replica to migrate onto). Downgrade to SUSPECT one breach short
        of the threshold: the very next breached window re-offers the
        verdict, but a clean window clears it."""
        rec = self._rec(replica_id)
        if rec.state == QUARANTINED:
            rec.state = SUSPECT
            rec.quarantines -= 1
            rec.breach_windows = max(0, self.k_windows - 1)

    # ------------------------------------------------------------------
    # quarantine probing
    # ------------------------------------------------------------------
    def quarantined_ids(self) -> List[int]:
        return [rid for rid in sorted(self._replicas)
                if self._replicas[rid].state == QUARANTINED]

    def probe_due(self, replica_id: int,
                  now: Optional[float] = None) -> bool:
        now = self._clock() if now is None else now
        rec = self._rec(replica_id)
        return (rec.state == QUARANTINED and rec.drained
                and rec.probe_at is not None and now >= rec.probe_at)

    def observe_probe(self, replica_id: int, duration_s: float,
                      scale: float = 1.0, *,
                      now: Optional[float] = None) -> bool:
        """One timed probe dispatch against a quarantined replica.
        Returns True when the replica has recovered
        (``recovery_probes`` consecutive sub-SLO probes) and should be
        undrained; a bad probe resets the streak and doubles the
        backoff (exponential — a persistently sick replica is probed
        ever more rarely)."""
        now = self._clock() if now is None else now
        rec = self._rec(replica_id)
        rec.probes += 1
        unit = duration_s / max(scale, 1.0)
        if unit <= self.slo():
            rec.good_probes += 1
            if rec.good_probes >= self.recovery_probes:
                rec.state = SERVING
                rec.recoveries += 1
                rec.breach_windows = 0
                rec._win_sum = 0.0
                rec._win_n = 0
                rec.ema = unit
                rec.samples = 1
                rec.drained = False
                rec.probe_at = None
                rec.lease_deadline = now + self.lease_s
                logger.info("health: replica %d recovered after %d "
                            "probe(s) — restoring to rotation",
                            replica_id, rec.probes)
                return True
            rec.probe_at = now + rec.probe_backoff_s
        else:
            rec.good_probes = 0
            rec.probe_failures += 1
            rec.probe_backoff_s = min(rec.probe_backoff_s * 2.0,
                                      self.probe_backoff_max_s)
            rec.probe_at = now + rec.probe_backoff_s
        return False

    def probe_failed(self, replica_id: int,
                     now: Optional[float] = None) -> None:
        """A probe dispatch raised (as opposed to merely running slow):
        same treatment as an over-SLO probe."""
        now = self._clock() if now is None else now
        rec = self._rec(replica_id)
        rec.probes += 1
        rec.good_probes = 0
        rec.probe_failures += 1
        rec.probe_backoff_s = min(rec.probe_backoff_s * 2.0,
                                  self.probe_backoff_max_s)
        rec.probe_at = now + rec.probe_backoff_s

    # ------------------------------------------------------------------
    # lifecycle notes from the pool
    # ------------------------------------------------------------------
    def note_lost(self, replica_id: int) -> None:
        """The pool absorbed this replica (death or probe-time loss)."""
        rec = self._replicas.get(replica_id)
        if rec is not None:
            rec.state = LOST

    def note_retired(self, replica_id: int) -> None:
        """The pool retired this replica on purpose (elastic scale-down):
        forget its record entirely — a deliberate retirement is not a
        loss and must not read as one in the summary."""
        self._replicas.pop(replica_id, None)

    def note_revived(self, replica_id: int,
                     now: Optional[float] = None) -> None:
        """An explicit ``pool.revive`` brought the replica back: fresh
        detector state, fresh lease."""
        now = self._clock() if now is None else now
        rec = self._rec(replica_id)
        rec.state = SERVING
        rec.ema = 0.0
        rec.samples = 0
        rec._win_sum = 0.0
        rec._win_n = 0
        rec.breach_windows = 0
        rec.drained = False
        rec.probe_at = None
        rec.good_probes = 0
        rec.lease_deadline = now + self.lease_s

    # ------------------------------------------------------------------
    # views (pool health / sanitizer)
    # ------------------------------------------------------------------
    def state_of(self, replica_id: int) -> Optional[str]:
        rec = self._replicas.get(replica_id)
        return None if rec is None else rec.state

    def lease_deadline_of(self, replica_id: int) -> Optional[float]:
        rec = self._replicas.get(replica_id)
        return None if rec is None else rec.lease_deadline

    def summary(self) -> Dict[str, Dict[str, object]]:
        return {str(rid): self._replicas[rid].view()
                for rid in sorted(self._replicas)}
