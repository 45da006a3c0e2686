"""Engine pool: data-parallel serving replicas behind one prefix-affinity
router (docs/SERVING.md "Engine pool").

A copy of ``deepspeed_tpu/serve/pool.py`` for the port, which imports nothing
of the JAX package; the text below is the JAX module's.

One :class:`EnginePool` owns N ``(scheduler, engine)`` replicas and a
:class:`~deepspeed_tpu.serve.router.Router`. The pool is the control
plane; each replica keeps its own queue, journal, breaker, and metrics
(labelled ``serve/replica<i>/...`` so N series never alias). Four verbs
define it:

- **place** — ``submit`` routes each request to the replica holding the
  longest full-block prefix of its prompt (exact content-index probe),
  falling back to least-loaded. Shared-prefix traffic concentrates where
  its KV already lives instead of recomputing it N ways.
- **migrate** — a request moves replicas by ``detach`` (preempt +
  journal handoff) and ``adopt`` (re-admission through normal ``put``).
  Under greedy decoding the continuation is bitwise identical to a
  never-migrated run — the same preemption round-trip guarantee
  engine-loss recovery rides. ``rebalance`` uses it to close load gaps.
- **drain** — rolling weight updates: one replica at a time stops taking
  traffic, its live requests migrate to survivors, ``load_params`` swaps
  weights (same shapes — zero recompilation), and the replica rejoins.
  v1 and v2 serve side by side; no admitted request is ever rejected.
- **absorb** — a replica death (``UnrecoverableEngineError`` escalated
  out of ``scheduler.step``) replays the dead replica's journal across
  survivors under the POOL's :class:`RecoveryPolicy` budget. Per-replica
  breakers keep recording incidents; :meth:`EnginePool.health` is the
  pool-level view. With no survivors the pool delegates to the replica's
  own in-place recovery (the single-engine path, unchanged).
- **supervise** — :meth:`EnginePool.enable_health` arms a gray-failure
  detector (``resilience.health``, docs/RESILIENCE.md "Health &
  overload"): every successful dispatch feeds a per-replica latency EMA
  and renews a heartbeat lease. A replica breaching its SLO for k
  consecutive windows is auto-drained (live requests migrate over the
  ``detach``/``adopt`` seam — bitwise), probed while quarantined with
  exponential backoff, and undrained on recovery; a replica whose lease
  expires is declared LOST and absorbed through the same journal-replay
  path a loud device loss takes. :meth:`enable_limits` adds a
  Vegas-style adaptive concurrency ceiling per replica, consulted by
  ``Router.place`` and conserved against the owner map by the
  sanitizer. :meth:`restore` cold-rebuilds a pool from per-replica
  durable journal files after a host crash, replaying every live
  request through normal admission — bitwise under greedy and sampled
  decoding.

Determinism (DSTPU005): every pool decision — placement, rebalance
victim, death-replay targeting — is a pure function of replica state in
replica-id order; no wall clock, RNG, or set iteration on a decision
path. A replayed trace routes identically.
"""

import os
import re
import time
from typing import Callable, Dict, List, Optional

from ..analysis import sanitizer as _sanitizer
from ..resilience.errors import (EngineUsageError, ReplicaLostError,
                                 RequestFailedError,
                                 UnrecoverableEngineError)
from ..resilience.health import HealthMonitor
from ..resilience.journal_store import DurableRequestJournal
from ..resilience.limits import AdaptiveLimit
from ..resilience.recovery import RecoveryPolicy
from ..utils.logging import logger
from .metrics import Event, PoolMetrics
from .request import Request, RequestState
from .router import Router
from .scheduler import (ContinuousBatchScheduler, QueueFullError,
                        SchedulerClosedError)

#: replica lifecycle states (plain strings — they cross process/log
#: boundaries in health views and events)
SERVING = "serving"
DRAINING = "draining"
DEAD = "dead"

#: per-replica durable journal naming under a pool journal directory
#: (``EnginePool.restore`` discovers membership from these)
_JOURNAL_RE = re.compile(r"^replica(\d+)\.journal$")


class Replica:
    """One pool member: a scheduler (which owns its engine) plus the
    pool-side lifecycle state. The router duck-types this handle:
    ``replica_id``, ``scheduler``, ``engine``."""

    def __init__(self, replica_id: int,
                 scheduler: ContinuousBatchScheduler):
        self.replica_id = replica_id
        self.scheduler = scheduler
        self.state = SERVING
        #: serving role (docs/SERVING.md "Disaggregated serving"):
        #: ``mixed`` (both phases — the compatible default), ``prefill``
        #: or ``decode``. The router's phase axis reads it; only
        #: :class:`~deepspeed_tpu.serve.disagg.DisaggPool` sets it.
        self.role = "mixed"
        #: adaptive concurrency ceiling (resilience.limits) — None until
        #: the pool arms ``enable_limits``. The router skips replicas
        #: with no headroom; the pool keeps the uid ledger conserved.
        self.limit: Optional[AdaptiveLimit] = None

    @property
    def engine(self):
        return self.scheduler.engine

    def __repr__(self) -> str:
        return (f"Replica(id={self.replica_id}, state={self.state}, "
                f"role={self.role}, "
                f"live={self.scheduler.live_count}, "
                f"queued={self.scheduler.queue_depth})")


class EnginePool:
    """N data-parallel scheduler+engine replicas behind one router.

    Construct from pre-built schedulers (each already holding its engine
    and journal), or via :meth:`build` from an engine factory. The pool
    forces ``escalate_losses=True`` on every member: an engine loss
    raises out of the replica's ``step`` and the pool decides — replay
    across survivors (cross-replica absorption) or, with none left,
    delegate to the replica's own in-place rebuild.

    ``recovery`` is the POOL's rebuild/absorption budget, separate from
    each replica's own policy (which only governs the no-survivor
    delegation path)."""

    def __init__(self, schedulers: List[ContinuousBatchScheduler], *,
                 router: Optional[Router] = None,
                 recovery: Optional[RecoveryPolicy] = None,
                 clock: Optional[Callable[[], float]] = None):
        if not schedulers:
            raise ValueError("EnginePool needs at least one scheduler")
        self.replicas: List[Replica] = []
        for i, sched in enumerate(schedulers):
            rid = sched.replica_id if sched.replica_id is not None else i
            sched.replica_id = rid
            sched.metrics.replica_id = rid
            sched.escalate_losses = True
            self.replicas.append(Replica(rid, sched))
        ids = [r.replica_id for r in self.replicas]
        if len(dict.fromkeys(ids)) != len(ids):
            raise ValueError(f"duplicate replica ids: {ids}")
        self.replicas.sort(key=lambda r: r.replica_id)
        self.router = router or Router()
        self.recovery = recovery or RecoveryPolicy()
        self._clock = clock or schedulers[0]._clock
        self.metrics = PoolMetrics()
        #: uid -> replica_id, maintained by every placement/migration;
        #: the sanitizer cross-checks it against the journals
        self._owner: Dict[int, int] = {}
        #: uid -> Request for every request the pool ever placed (the
        #: result surface — survives migration and replica death)
        self._requests: Dict[int, Request] = {}
        #: gray-failure detector (resilience.health) — None until
        #: :meth:`enable_health` arms it
        self.health_monitor: Optional[HealthMonitor] = None
        #: elastic-scaling recipe (docs/SERVING.md "Elastic scaling") —
        #: :meth:`build` records how it made its replicas so
        #: :meth:`scale_to` can stamp out more of the same; pools built
        #: from pre-made schedulers can only shrink
        self._engine_factory = None
        self._journal_factory = None
        self._scheduler_kw: Dict[str, object] = {}
        self._limit_factory: Optional[Callable[[int], AdaptiveLimit]] = None
        self._limits_enabled = False
        self._closed = False

    @classmethod
    def build(cls, engine_factory, n_replicas: int, *,
              router: Optional[Router] = None,
              recovery: Optional[RecoveryPolicy] = None,
              journal_factory=None,
              clock: Callable[[], float] = time.monotonic,
              **scheduler_kw) -> "EnginePool":
        """Construct ``n_replicas`` schedulers over fresh engines.
        ``engine_factory(i)`` returns replica *i*'s engine;
        ``journal_factory(i)`` (optional) its journal — e.g. a
        :class:`~deepspeed_tpu.resilience.DurableRequestJournal` per
        replica. ``scheduler_kw`` is forwarded to every scheduler."""
        scheds = []
        for i in range(n_replicas):
            kw = dict(scheduler_kw)
            if journal_factory is not None:
                kw["journal"] = journal_factory(i)
            scheds.append(ContinuousBatchScheduler(
                engine_factory(i), replica_id=i, escalate_losses=True,
                clock=clock, **kw))
        pool = cls(scheds, router=router, recovery=recovery, clock=clock)
        # retain the recipe: scale_to() grows the pool by replaying it
        pool._engine_factory = engine_factory
        pool._journal_factory = journal_factory
        pool._scheduler_kw = dict(scheduler_kw)
        return pool

    # ------------------------------------------------------------------
    # cold-start restore (docs/RESILIENCE.md "Health & overload")
    # ------------------------------------------------------------------
    @staticmethod
    def journal_path(directory: str, replica_id: int) -> str:
        """The canonical per-replica durable journal path —
        ``<directory>/replica<i>.journal``. Use as the ``build``
        ``journal_factory`` so :meth:`restore` can rediscover the pool."""
        return os.path.join(directory, f"replica{replica_id}.journal")

    @classmethod
    def restore(cls, directory: str, engine_factory, *,
                router: Optional[Router] = None,
                recovery: Optional[RecoveryPolicy] = None,
                clock: Callable[[], float] = time.monotonic,
                fsync: bool = False,
                **scheduler_kw) -> "EnginePool":
        """Cold-start a pool after a host crash from the per-replica
        durable journals under ``directory`` (``replica<i>.journal``,
        written by a pool built with
        ``journal_factory=lambda i: DurableRequestJournal(
        EnginePool.journal_path(dir, i))``).

        Membership is discovered from the files (``max id + 1``
        replicas — a replica whose journal is missing restarts empty),
        fresh engines come from ``engine_factory(i)``, and every
        journaled live request re-enters through the normal
        detach→adopt admission path on its original replica. Greedy
        continuations are bitwise identical to the uninterrupted run;
        sampled requests replay their committed prefix byte-for-byte
        and re-derive every remaining PRNG key from (seed, absolute
        position) — the same contract single-engine crash recovery
        proves."""
        ids = []
        for name in sorted(os.listdir(directory)):
            m = _JOURNAL_RE.match(name)
            if m is not None:
                ids.append(int(m.group(1)))
        if not ids:
            raise ValueError(
                f"no replica journals (replica<i>.journal) under "
                f"{directory!r} — nothing to restore")
        pool = cls.build(
            engine_factory, max(ids) + 1, router=router, recovery=recovery,
            journal_factory=lambda i: DurableRequestJournal(
                cls.journal_path(directory, i), fsync=fsync),
            clock=clock, **scheduler_kw)
        restored = 0
        for rep in pool.replicas:
            sched = rep.scheduler
            for uid in list(sched.journal.uids()):
                # detach+adopt on the SAME scheduler: the entry has no
                # live Request attached (host state died with the
                # crash), so adopt reconstructs it and replays
                # prompt + committed tokens through normal admission
                entry = sched.journal.detach(uid)
                req = sched.adopt(entry)
                pool._owner[uid] = rep.replica_id
                pool._requests[uid] = req
                restored += 1
        pool.metrics.observe_restore(restored)
        logger.info(
            "pool: cold-restored %d replica(s) from %r — %d live "
            "request(s) replaying", len(pool.replicas), directory,
            restored)
        return pool

    # ------------------------------------------------------------------
    # health supervision & overload control (docs/RESILIENCE.md)
    # ------------------------------------------------------------------
    def _tap_for(self, rep: Replica) -> Callable[[str, float, float], None]:
        """The per-replica dispatch feed: every successful engine call
        reports (kind, duration_s, scale) into the health detector and
        the replica's adaptive limit. One closure serves both — each
        consumer is consulted dynamically, so arming order is free."""
        def tap(kind: str, duration_s: float, scale: float) -> None:
            if self.health_monitor is not None:
                self.health_monitor.observe(rep.replica_id, duration_s, scale,
                                    now=self._clock())
            if rep.limit is not None:
                rep.limit.observe(duration_s / max(scale, 1.0))
        return tap

    def enable_health(self, monitor: Optional[HealthMonitor] = None,
                      ) -> HealthMonitor:
        """Arm gray-failure supervision: attach every non-dead replica
        to ``monitor`` (a default-configured :class:`HealthMonitor` on
        the pool's clock when omitted) and wire each scheduler's
        ``health_tap``. Call after warmup — compile-time first-dispatch
        latency would otherwise pollute the baseline EMA (the adaptive
        SLO ignores cold replicas, but an explicit ``slo_s`` does not)."""
        if monitor is None:
            monitor = HealthMonitor(clock=self._clock)
        self.health_monitor = monitor
        now = self._clock()
        for rep in self.replicas:
            if rep.state != DEAD:
                monitor.attach(rep.replica_id, now=now, role=rep.role)
            rep.scheduler.health_tap = self._tap_for(rep)
        return monitor

    def enable_limits(self, factory: Optional[Callable[[int],
                                                       AdaptiveLimit]] = None,
                      ) -> None:
        """Arm per-replica adaptive concurrency limits.
        ``factory(replica_id)`` builds each replica's
        :class:`AdaptiveLimit` (default-configured when omitted). The
        ledger is seeded with the requests each replica already owns, so
        arming mid-flight conserves the accounting invariant."""
        self._limit_factory = factory
        self._limits_enabled = True
        for rep in self.replicas:
            rep.limit = (AdaptiveLimit() if factory is None
                         else factory(rep.replica_id))
            for uid, rid in self._owner.items():
                if rid == rep.replica_id and not self._requests[uid].finished:
                    rep.limit.admit(uid)
            rep.scheduler.health_tap = self._tap_for(rep)

    # ------------------------------------------------------------------
    # membership views
    # ------------------------------------------------------------------
    def replica(self, replica_id: int) -> Replica:
        for rep in self.replicas:
            if rep.replica_id == replica_id:
                return rep
        raise ValueError(f"no replica {replica_id} in this pool")

    def _serving(self, exclude: Optional[Replica] = None) -> List[Replica]:
        return [r for r in self.replicas
                if r.state == SERVING and r is not exclude]

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------
    def submit(self, prompt, **kw) -> Request:
        """Route one request: prefix-affinity first, least-loaded
        fallback (:class:`Router`). A replica rejecting on backpressure
        (``QueueFullError``) is removed from the candidate set and the
        placement retries; the error propagates only when EVERY serving
        replica is full. ``SheddingError`` from an open breaker
        propagates as-is — shedding is the replica saying shed, not
        "try my neighbour"."""
        if self._closed:
            raise SchedulerClosedError("pool is closed to new admits")
        candidates = self._serving()
        while True:
            rep, hits = self.router.place(prompt, candidates)
            if rep is None:
                at_limit = [c.replica_id for c in candidates
                            if c.limit is not None
                            and not c.limit.has_headroom()]
                if at_limit:
                    self.metrics.observe_limit_reject()
                    raise QueueFullError(
                        f"every serving replica is at its adaptive "
                        f"concurrency limit (replicas {at_limit}); retry "
                        "after in-flight work drains")
                raise QueueFullError(
                    "every serving replica rejected this request")
            try:
                req = rep.scheduler.submit(prompt, **kw)
            except QueueFullError:
                candidates = [c for c in candidates if c is not rep]
                continue
            self._owner[req.uid] = rep.replica_id
            self._requests[req.uid] = req
            if rep.limit is not None:
                rep.limit.admit(req.uid)
            self.metrics.observe_placement(hits)
            return req

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One pool iteration, two-phase (docs/SERVING.md "Pipelined
        dispatch"): phase 1 dispatches every non-dead replica's next round
        (``step_dispatch``) so N devices execute concurrently, phase 2
        absorbs each replica's tokens (``step_absorb``) — on synchronous
        (non-pipelined) schedulers ``step_dispatch`` is a no-op and
        ``step_absorb`` runs the whole step, so the loop degrades to the
        old sequential order exactly. An escalated engine loss in either
        phase routes to :meth:`_absorb_replica_loss`; a replica lost in
        phase 1 is skipped in phase 2. The heartbeat lease is fed per
        replica at its OWN absorb — never once for the whole pool pass —
        so one straggler's host phase cannot expire its neighbours'
        leases. Returns True while any replica has work."""
        work = False
        lost: set = set()
        for rep in self.replicas:
            if rep.state == DEAD:
                continue
            try:
                rep.scheduler.step_dispatch()
            except UnrecoverableEngineError as e:
                lost.add(rep.replica_id)
                self._absorb_replica_loss(rep, e)
                work = True
        for rep in self.replicas:
            if rep.state == DEAD or rep.replica_id in lost:
                continue
            try:
                if rep.scheduler.step_absorb():
                    work = True
                if self.health_monitor is not None:
                    # a completed control-loop pass IS the liveness
                    # signal the lease rides — even an idle one
                    self.health_monitor.heartbeat(rep.replica_id,
                                          now=self._clock())
            except UnrecoverableEngineError as e:
                self._absorb_replica_loss(rep, e)
                work = True
        by_id = {r.replica_id: r for r in self.replicas}
        for uid in [u for u, req in list(self._requests.items())
                    if req.finished]:
            rid = self._owner.pop(uid, None)
            rep = by_id.get(rid) if rid is not None else None
            if rep is not None and rep.limit is not None:
                rep.limit.release(uid)
        if self._supervise():
            work = True
        self.metrics.observe_gauges(
            [Router.load(r) for r in self.replicas if r.state != DEAD],
            serving=sum(1 for r in self.replicas if r.state == SERVING),
            draining=sum(1 for r in self.replicas if r.state == DRAINING),
            dead=sum(1 for r in self.replicas if r.state == DEAD))
        if _sanitizer.sanitize_enabled():
            # checked mode: every live uid owned by exactly one replica,
            # no journal entry orphaned or double-adopted
            _sanitizer.check_pool_ownership(
                [(r.replica_id, r.scheduler.journal, r.scheduler._all)
                 for r in self.replicas if r.state != DEAD],
                self._owner)
            tenancy = next((r.scheduler.tenancy for r in self.replicas
                            if getattr(r.scheduler, "tenancy", None)
                            is not None), None)
            if tenancy is not None:
                # tenanted pools: per-tenant cache-quota + outstanding-slot
                # accounting must hold on every non-dead block manager
                _sanitizer.check_tenant_accounting(
                    [(r.replica_id, r.engine) for r in self.replicas
                     if r.state != DEAD], tenancy)
            if self.health_monitor is not None or any(
                    r.limit is not None for r in self.replicas):
                _sanitizer.check_pool_health(
                    [(r.replica_id, r.state,
                      (None if self.health_monitor is None else
                       self.health_monitor.lease_deadline_of(r.replica_id)),
                      (None if self.health_monitor is None else
                       self.health_monitor.state_of(r.replica_id)),
                      (None if r.limit is None else r.limit.inflight),
                      r.scheduler.journal)
                     for r in self.replicas],
                    self._owner, self._clock())
        return work

    def _supervise(self) -> bool:
        """Act on the health detector's verdicts (one pass per pool
        step): quarantine-drain gray failures, absorb lease-expired
        replicas through journal replay, probe quarantined replicas and
        undrain the recovered. Returns True when anything moved."""
        if self.health_monitor is None:
            return False
        now = self._clock()
        acted = False
        for verdict, rid in self.health_monitor.poll(now=now):
            rep = self.replica(rid)
            if verdict == "quarantine":
                if rep.state != SERVING or not self._serving(exclude=rep):
                    # already out of rotation, or nowhere to migrate —
                    # downgrade; the next breached window re-offers it
                    self.health_monitor.note_deferred(rid)
                    continue
                moved = self.drain(rid)
                self.health_monitor.note_drained(rid, now)
                self.metrics.observe_quarantine(moved)
                acted = True
                logger.warning(
                    "pool: replica %d quarantined by the health monitor "
                    "(%d request(s) migrated); probing for recovery",
                    rid, moved)
            elif verdict == "lost":
                self.metrics.observe_lease_expiry()
                if rep.state == DEAD:
                    continue  # already absorbed by a loud loss
                self._absorb_replica_loss(rep, ReplicaLostError(
                    f"replica {rid} heartbeat lease expired at "
                    f"{now:.3f} — declaring lost"))
                acted = True
        for rid in self.health_monitor.quarantined_ids():
            rep = self.replica(rid)
            if rep.state != DRAINING or not self.health_monitor.probe_due(rid, now):
                continue
            t0 = time.perf_counter()
            try:
                rep.engine.put([], [])  # no-op dispatch, timed
            except UnrecoverableEngineError as e:
                self._absorb_replica_loss(rep, e)
                acted = True
                continue
            except Exception:
                self.health_monitor.probe_failed(rid, now)
                continue
            if self.health_monitor.observe_probe(
                    rid, time.perf_counter() - t0, now=now):
                self.undrain(rid)
                self.metrics.observe_health_recovery()
                acted = True
        return acted

    def run_until_complete(self) -> None:
        """Drive the pool until every placed request is terminal. Raises
        :class:`UnrecoverableEngineError` instead of returning silently
        (or spinning) when no replica can make progress — every replica
        dead, or a request stranded with no serving owner."""
        while self.step():
            pass
        stranded = sorted(u for u, r in self._requests.items()
                          if not r.finished)
        if stranded:
            raise UnrecoverableEngineError(
                f"pool made no progress with {len(stranded)} unfinished "
                f"request(s) (uids {stranded[:8]}): no serving replica "
                "can run them")

    def stream(self, req: Request):
        """Yield ``req``'s tokens as generated, driving the POOL loop —
        the request may migrate replicas mid-stream; the iterator
        follows it (same ``Request`` object rides the journal entry).
        Raises :class:`UnrecoverableEngineError` instead of busy-spinning
        when the pool can no longer make progress for ``req``."""
        stalled = False
        while True:
            for tok in req.new_tokens():
                yield tok
            if req.finished:
                if req.error is not None:
                    raise req.error
                return
            if stalled:
                raise UnrecoverableEngineError(
                    f"pool made no progress while uid {req.uid} is "
                    f"unfinished (state {req.state.value}): the request "
                    "is stranded with no serving replica able to run it")
            # one more drain pass after the first idle step: the final
            # step may have produced tokens we have not yielded yet
            stalled = not self.step()

    # ------------------------------------------------------------------
    # migration / rebalance
    # ------------------------------------------------------------------
    def migrate(self, uid: int, to_replica_id: int, *,
                _rebalance: bool = False) -> Request:
        """Move one live request between replicas: ``detach`` from its
        owner (preempt + journal handoff) and ``adopt`` on the target,
        which must be SERVING. Bitwise-lossless under greedy decoding."""
        src_id = self._owner.get(uid)
        if src_id is None:
            raise ValueError(f"uid {uid} is not owned by this pool")
        if src_id == to_replica_id:
            return self._requests[uid]
        dst = self.replica(to_replica_id)
        if dst.state != SERVING:
            raise EngineUsageError(
                f"cannot migrate uid {uid} onto replica {to_replica_id} "
                f"in state {dst.state}")
        src = self.replica(src_id)
        entry = src.scheduler.detach(uid)
        try:
            req = dst.scheduler.adopt(entry)
        except Exception:
            # restore ownership — a failed adopt must not strand the
            # entry outside every journal
            src.scheduler.adopt(entry)
            raise
        self._owner[uid] = to_replica_id
        if src.limit is not None:
            src.limit.release(uid)
        if dst.limit is not None:
            dst.limit.admit(uid)
        self.metrics.observe_migration(rebalance=_rebalance)
        return req

    def _replay_target(self, entry, survivors: List[Replica]) -> Replica:
        """Where a detached entry replays when its owner leaves rotation
        (drain, quarantine, death). Placement rides the router; with every
        candidate at its concurrency limit the least-loaded survivor takes
        it anyway — migrated load is conserved, not new admission, so the
        limit filter must not strand it. The disaggregated pool overrides
        this with role-aware targeting (a mid-prefill request belongs on a
        prefill-capable survivor, a decoding one wherever capacity
        exists)."""
        target, _ = self.router.place(entry.replay_tokens(), survivors)
        if target is None:
            target = min(survivors,
                         key=lambda r: (Router.load(r), r.replica_id))
        return target

    def _pick_migratable(self, rep: Replica) -> Optional[int]:
        """The cheapest request to move off ``rep``: the youngest queued
        request (nothing resident to recompute), else the live request
        with the least committed history (smallest replay prefill).
        Deterministic: ties break on uid."""
        queued = list(rep.scheduler._queue)
        if queued:
            return max(queued, key=lambda r: (r.arrival_time, r.uid)).uid
        live = list(rep.scheduler._live.values())
        if live:
            return min(live, key=lambda r: (len(r.tokens), r.uid)).uid
        return None

    def rebalance(self, max_moves: int = 1) -> int:
        """Close load gaps: while the busiest serving replica holds at
        least 2 more requests than the idlest, migrate one off it.
        Returns the number of moves made."""
        moves = 0
        while moves < max_moves:
            serving = self._serving()
            if len(serving) < 2:
                break
            hi = max(serving, key=lambda r: (Router.load(r), -r.replica_id))
            # rebalance-aware limits (docs/RESILIENCE.md "Health &
            # overload"): a replica admission would reject is not a
            # replica rebalance may overload — saturated targets are
            # skipped, unlike drain/death replay where the load MUST land
            targets = [r for r in serving if r is not hi
                       and (r.limit is None or r.limit.has_headroom())]
            if not targets:
                break
            lo = min(targets, key=lambda r: (Router.load(r), r.replica_id))
            if Router.load(hi) - Router.load(lo) < 2:
                break
            uid = self._pick_migratable(hi)
            if uid is None:
                break
            self.migrate(uid, lo.replica_id, _rebalance=True)
            moves += 1
        return moves

    # ------------------------------------------------------------------
    # drain / rolling weight update
    # ------------------------------------------------------------------
    def drain(self, replica_id: int) -> int:
        """Take a replica out of rotation without rejecting anything:
        mark it DRAINING (the router stops offering it), migrate every
        request it owns onto survivors via the journal handoff, and
        return the number moved. Requires at least one other SERVING
        replica."""
        rep = self.replica(replica_id)
        if rep.state != SERVING:
            raise EngineUsageError(
                f"replica {replica_id} is {rep.state}, not serving")
        survivors = self._serving(exclude=rep)
        if not survivors:
            raise EngineUsageError(
                f"cannot drain replica {replica_id}: no other serving "
                "replica to migrate its requests to")
        t0 = time.perf_counter()
        rep.state = DRAINING
        moved = 0
        for uid in list(rep.scheduler.journal.uids()):
            entry = rep.scheduler.detach(uid)
            target = self._replay_target(entry, survivors)
            target.scheduler.adopt(entry)
            self._owner[uid] = target.replica_id
            if rep.limit is not None:
                rep.limit.release(uid)
            if target.limit is not None:
                target.limit.admit(uid)
            self.metrics.observe_migration()
            moved += 1
        self.metrics.observe_drain(time.perf_counter() - t0)
        if _sanitizer.sanitize_enabled():
            # drained engine must hold zero sequences / block refs
            _sanitizer.check_drained(rep.engine)
        logger.info("pool: replica %d drained (%d request(s) migrated)",
                    replica_id, moved)
        return moved

    def undrain(self, replica_id: int) -> None:
        """Return a DRAINING replica to rotation."""
        rep = self.replica(replica_id)
        if rep.state != DRAINING:
            raise EngineUsageError(
                f"replica {replica_id} is {rep.state}, not draining")
        rep.state = SERVING

    def load_weights(self, replica_id: int, params,
                     version=None) -> None:
        """Swap a DRAINED replica's weights (same pytree shapes — zero
        recompilation). ``engine.load_params`` flushes the prefix cache
        across BOTH tiers and drops the swap store: a device-only flush
        would let a later index hit promote stale old-weights KV back
        from host RAM, or a swap-in re-admit a victim's old-weights
        blocks — the silent-wrong-logits failure mode the v1→v2 rolling
        update regression test plants."""
        rep = self.replica(replica_id)
        if rep.state != DRAINING:
            raise EngineUsageError(
                f"load_weights needs replica {replica_id} draining "
                f"(is {rep.state}) — live KV predates the new weights")
        rep.engine.load_params(params, version=version)
        self.metrics.observe_weight_swap()

    def rolling_update(self, params, version=None,
                       steps_between: int = 0) -> None:
        """Rolling weight update: one serving replica at a time drains,
        swaps to ``params``, and rejoins — v_old and v_new serve side by
        side throughout and no admitted request is rejected.
        ``steps_between`` pool steps run between replicas to let
        migrated work make progress before the next drain."""
        for rid in [r.replica_id for r in self.replicas
                    if r.state == SERVING]:
            self.drain(rid)
            self.load_weights(rid, params, version=version)
            self.undrain(rid)
            for _ in range(steps_between):
                self.step()

    # ------------------------------------------------------------------
    # elastic scaling (docs/SERVING.md "Elastic scaling")
    # ------------------------------------------------------------------
    def scale_to(self, n: int) -> int:
        """Elastic resize to ``n`` SERVING replicas, composed entirely
        from verbs the pool already proves correct:

        * **grow** — stamp out fresh replicas from the :meth:`build`
          recipe (engine/journal factories + scheduler kwargs) and enter
          them into rotation exactly like an undrain: armed supervision
          (health monitor, adaptive limit, dispatch tap) and the shared
          tenancy registry's cache quotas attach before the router may
          offer them. A factory failure mid-grow is absorbed the way a
          replica death is — counted, logged, the pool continues at
          whatever size it reached; it never raises mid-resize.
        * **shrink** — the highest-id serving replicas drain (every owned
          request migrates to survivors over the journal handoff — the
          same bitwise-lossless path drain/death replay use) and then
          retire: removed from membership, scheduler closed, supervision
          record dropped. In-flight work is never cancelled by a resize.

        Returns the signed change in serving replicas actually achieved
        (grow failures make it smaller than requested). DRAINING and DEAD
        replicas are not counted and not touched — quarantine and revival
        stay the health monitor's business."""
        if self._closed:
            raise SchedulerClosedError("pool is closed")
        if n < 1:
            raise ValueError(f"cannot scale to {n} replicas (min 1)")
        current = len(self._serving())
        if n > current:
            return self._grow(n - current)
        if n < current:
            return -self._shrink(current - n)
        return 0

    def _grow(self, k: int) -> int:
        if self._engine_factory is None:
            raise EngineUsageError(
                "scale-up needs the build() recipe: this pool was "
                "constructed from pre-built schedulers — it can shrink "
                "but not grow")
        grew = failed = 0
        next_id = max(r.replica_id for r in self.replicas) + 1
        for rid in range(next_id, next_id + k):
            kw = dict(self._scheduler_kw)
            if self._journal_factory is not None:
                kw["journal"] = self._journal_factory(rid)
            try:
                engine = self._engine_factory(rid)
            except Exception as e:  # absorbed: death of a replica-to-be
                failed += 1
                logger.warning(
                    "pool: scale-up replica %d failed to build (%s: %s) — "
                    "absorbed, pool continues at current size",
                    rid, type(e).__name__, e)
                continue
            sched = ContinuousBatchScheduler(
                engine, replica_id=rid, escalate_losses=True,
                clock=self._clock, **kw)
            sched.metrics.replica_id = rid
            rep = Replica(rid, sched)
            if self._limits_enabled:
                rep.limit = (AdaptiveLimit() if self._limit_factory is None
                             else self._limit_factory(rid))
            sched.health_tap = self._tap_for(rep)
            if self.health_monitor is not None:
                self.health_monitor.attach(rid, now=self._clock(),
                                           role=rep.role)
            # a fresh engine starts with an empty quota ledger: push the
            # shared registry's per-tenant cache budgets before any
            # placement can land content on it
            sched._push_tenant_quotas()
            self.replicas.append(rep)
            grew += 1
            logger.info("pool: scaled up — replica %d entered rotation", rid)
        self.replicas.sort(key=lambda r: r.replica_id)
        self.metrics.observe_scale(grew, 0, failed)
        return grew

    def _shrink(self, k: int) -> int:
        serving = self._serving()
        if k >= len(serving):
            raise ValueError(
                f"cannot retire {k} of {len(serving)} serving replicas "
                "(min 1 must remain)")
        shrank = 0
        # highest id first: deterministic, and retires the newest
        # (coldest prefix caches) before the oldest
        for rep in sorted(serving, key=lambda r: -r.replica_id)[:k]:
            self.drain(rep.replica_id)   # migrates every owned request
            rep.scheduler.close()
            if self.health_monitor is not None:
                self.health_monitor.note_retired(rep.replica_id)
            self.replicas.remove(rep)
            shrank += 1
            logger.info("pool: scaled down — replica %d retired",
                        rep.replica_id)
        self.metrics.observe_scale(0, shrank, 0)
        return shrank

    # ------------------------------------------------------------------
    # replica-death absorption
    # ------------------------------------------------------------------
    def _absorb_replica_loss(self, rep: Replica,
                             exc: BaseException) -> None:
        """A replica's engine is lost. With survivors: mark it DEAD and
        replay its journal across them under the pool's
        :class:`RecoveryPolicy` budget (deadline-expired requests cancel
        TYPED, exactly like single-engine recovery). Without survivors:
        delegate to the replica's own in-place rebuild — the tested
        single-engine path, budgeted by ITS policy."""
        now = self._clock()
        sched = rep.scheduler
        survivors = self._serving(exclude=rep)
        if not survivors:
            sched._recover(exc, now)
            return
        sched.breaker.on_failure(now)
        sched.metrics.faults["engine_losses"] += 1
        if not self.recovery.admit(now, type(exc).__name__):
            logger.error(
                "pool: replica %d lost (%s) with the pool absorption "
                "budget (%d) spent — escalating", rep.replica_id, exc,
                self.recovery.max_consecutive_rebuilds)
            raise exc
        logger.warning(
            "pool: replica %d lost (%s); %d journaled request(s) replay "
            "across %d survivor(s)", rep.replica_id, exc,
            len(sched.journal), len(survivors))
        rep.state = DEAD
        if self.health_monitor is not None:
            self.health_monitor.note_lost(rep.replica_id)
        replayed = cancelled = 0
        for uid in list(sched.journal.uids()):
            # detach is loss-tolerant: preempt/flush on the dead engine
            # absorb the error (the blocks died with it)
            entry = sched.detach(uid)
            if rep.limit is not None:
                rep.limit.release(uid)
            req = entry.request
            if (req is not None and req.deadline is not None
                    and req.deadline <= now):
                req.error = RequestFailedError(
                    uid, f"deadline expired during replica "
                    f"{rep.replica_id} loss (deadline {req.deadline:.3f} "
                    f"<= now {now:.3f})")
                req.state = RequestState.CANCELLED
                req.cancel_reason = "deadline"
                req.finish_time = now
                self._owner.pop(uid, None)
                cancelled += 1
                continue
            target = self._replay_target(entry, survivors)
            target.scheduler.adopt(entry)
            self._owner[uid] = target.replica_id
            if target.limit is not None:
                target.limit.admit(uid)
            replayed += 1
        # the dead scheduler's residual host state is already empty
        # (detach swept _all/_queue/_live); clear the recorded loss so a
        # later explicit revive doesn't trip over it
        sched._engine_dead = None
        self.recovery.note_rebuilt(now, replayed, cancelled)
        self.metrics.observe_death(replayed, cancelled)
        logger.warning(
            "pool: replica %d absorbed (#%d pool-wide): %d replaying on "
            "survivors, %d cancelled past deadline", rep.replica_id,
            self.recovery.rebuilds, replayed, cancelled)

    def revive(self, replica_id: int) -> None:
        """Bring a DEAD replica back: rebuild its engine (fresh pools,
        same compiled programs) and rejoin rotation empty — its former
        requests stay where absorption placed them."""
        rep = self.replica(replica_id)
        if rep.state != DEAD:
            raise EngineUsageError(
                f"replica {replica_id} is {rep.state}, not dead")
        rep.engine.rebuild()
        rep.scheduler._engine_dead = None
        # the rebuilt block manager starts with an empty per-tenant quota
        # ledger — re-push the registry's cache budgets before rotation
        rep.scheduler._push_tenant_quotas()
        rep.scheduler.breaker.rearm_half_open(self._clock())
        rep.state = SERVING
        if self.health_monitor is not None:
            if self.health_monitor.state_of(rep.replica_id) is None:
                self.health_monitor.attach(rep.replica_id, now=self._clock(),
                                           role=rep.role)
            else:
                self.health_monitor.note_revived(rep.replica_id,
                                         now=self._clock())

    # ------------------------------------------------------------------
    # observability / shutdown
    # ------------------------------------------------------------------
    def owner_of(self, uid: int) -> Optional[int]:
        return self._owner.get(uid)

    def health(self) -> Dict[str, object]:
        """Pool-level health view: per-replica state, breaker gauge,
        load, weights version; the pool recovery trail and metrics."""
        return {
            "replicas": [{
                "replica_id": r.replica_id,
                "state": r.state,
                "breaker": r.scheduler.breaker.state_gauge,
                "live": r.scheduler.live_count,
                "queued": r.scheduler.queue_depth,
                "backlog_tokens": (0 if r.state == DEAD
                                   else r.scheduler.prefill_backlog_tokens()),
                "load": (0 if r.state == DEAD else Router.load(r)),
                "rebuilds": r.scheduler.recovery.rebuilds,
                "weights_version": getattr(r.engine, "weights_version",
                                           None),
                "health": (None if self.health_monitor is None
                           else self.health_monitor.state_of(r.replica_id)),
                "limit": (None if r.limit is None else r.limit.view()),
            } for r in self.replicas],
            "pool_recovery_trail": list(self.recovery.trail),
            "detector": (None if self.health_monitor is None
                         else self.health_monitor.summary()),
            "pool": self.metrics.summary(),
        }

    def monitor_events(self, step: int = 0) -> List[Event]:
        """Pool gauges (``serve/pool/*``) plus every non-dead replica's
        replica-labelled serve + engine events in one list."""
        out = self.metrics.events(step)
        for rep in self.replicas:
            if rep.state != DEAD:
                out.extend(rep.scheduler.monitor_events(step))
        return out

    def close(self) -> None:
        """Graceful pool drain: stop admissions, cancel never-admitted
        queued requests, drive every replica to completion through the
        POOL loop (so a replica death during shutdown still absorbs),
        then close each scheduler."""
        if self._closed:
            return
        self._closed = True
        for rep in self.replicas:
            if rep.state == DEAD:
                continue
            for req in list(rep.scheduler._queue):
                if req.admitted_time is None:
                    rep.scheduler.cancel(req.uid, reason="drain")
        while self.step():
            pass
        for rep in self.replicas:
            if rep.state != DEAD:
                rep.scheduler.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
