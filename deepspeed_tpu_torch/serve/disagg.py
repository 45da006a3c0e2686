"""Disaggregated prefill/decode serving (docs/SERVING.md "Disaggregated
serving").

A copy of ``deepspeed_tpu/serve/disagg.py`` for the port, which imports nothing
of the JAX package; the text below is the JAX module's.

Production traffic is bimodal: prefill is compute-bound and bursty,
decode is memory-bound and steady — mixed on one replica, each is the
other's noisy neighbor, and the chunked-prefill duty cycle (the
single-replica truce) only bounds the interference, it cannot remove it.
:class:`DisaggPool` removes it across replicas: members specialize into
**prefill workers** (role ``prefill`` — take new submissions, run
chunked prefill, own nothing steady) and **decode workers** (role
``decode`` — take post-prefill handoffs, run the fused decode loop),
with ``mixed`` as the backward-compatible default that serves both
phases.

The handoff is the subsystem's heart: when a request finishes prefill on
a prefill worker, the pool moves it by **KV transfer instead of token
replay** —

1. ``scheduler.detach_with_kv`` exports the at-rest KV through the
   engine's ``export_swap`` (async D2H gathers via the TransferEngine,
   ledger-accounted, materialized once — the handoff's designed sync)
   and detaches the journal entry; export pops the uid from every
   source-side store BEFORE detach's flush runs, so no uid is ever
   resident in two stores;
2. the uid-keyed payload (CRC-stamped, self-describing geometry) lands
   on the decode worker via ``import_swap`` — double imports, imports
   over a live uid, and geometry drift raise typed errors; a CRC
   mismatch raises ``TransferCorruptError``;
3. ``adopt`` re-admits the entry through normal admission, where the
   scheduler's swap-resident fast path (``_swap_in_readmit``) lands the
   imported blocks with one batched device_put and decode resumes
   exactly where prefill left it — bitwise under greedy, and bitwise
   under sampled because admission re-registers sampling BEFORE the
   swap path and every PRNG key derives from (seed, absolute position).

Every rung of that ladder may break — engine without the seam, KV not
at rest, transfer failure, CRC mismatch, import rejection, mid-handoff
engine loss — and every break degrades to the SAME fallback: journal
replay of ``prompt + committed tokens``, the bitwise-proven path that
engine-loss recovery, migration, and pool restore already ride. A
handoff is therefore never a correctness risk; the KV path is purely an
optimization (skip the re-prefill), exactly like the swap store it
reuses.

Placement gets a second axis (``Router.place(..., phase=...)``): new
submissions place by prefix affinity among prefill-capable replicas;
handoffs place least-loaded among decode-capable replicas, gated by each
worker's ``AdaptiveLimit`` headroom — a saturated decode worker is
skipped and the handoff deferred (the request keeps decoding where it
is; deferral is visible in ``serve/pool/handoff_deferrals`` and excused
to the sanitizer). Per-role health: a dead prefill worker's mid-prefill
requests replay on surviving prefill-capable replicas, a dead decode
worker's requests replay wherever capacity exists (role purity yields
to capacity — a stranded request is worse than a noisy neighbor).

Determinism (DSTPU005): handoff candidates are walked in replica-id
order and selected through the router's pure scoring; the injectable
pool clock times deadlines. A replayed trace hands off identically.
"""

import time
from typing import Dict, List, Optional, Set

from ..analysis import sanitizer as _sanitizer
from ..resilience.errors import EngineUsageError, RequestFailedError
from ..runtime.transfer_engine import TransferCorruptError
from ..utils.logging import logger
from .pool import DEAD, SERVING, EnginePool, Replica
from .request import RequestState
from .router import PHASE_ROLES, Router

#: the legal replica roles
ROLES = ("prefill", "decode", "mixed")


class DisaggPool(EnginePool):
    """An :class:`EnginePool` whose replicas carry phase roles and whose
    step moves every freshly-prefilled request from its prefill worker
    to a decode worker by KV-transfer handoff (journal replay on any
    degradation). With no roles configured — every replica ``mixed`` —
    behavior is identical to the base pool."""

    def __init__(self, schedulers, *, roles=None, **kw):
        super().__init__(schedulers, **kw)
        #: uid -> exported payload for the handoff currently in flight
        #: (sanitizer truth: a uid in here must be journaled nowhere)
        self._inflight_handoffs: Dict[int, Optional[dict]] = {}
        #: uids whose handoff this step deliberately deferred (no decode
        #: headroom / KV not yet at rest) — excused to the sanitizer
        self._deferred: Set[int] = set()
        if roles is not None:
            self.set_roles(roles)

    # ------------------------------------------------------------------
    # role configuration
    # ------------------------------------------------------------------
    def set_roles(self, roles) -> None:
        """Assign replica roles. ``roles`` is a ``replica_id -> role``
        mapping or a sequence in replica-id order. Validated atomically:
        every role legal, at least one prefill-capable AND one
        decode-capable member — a pool that can start requests but never
        finish them (or vice versa) is a configuration error, not a
        runtime surprise."""
        if not isinstance(roles, dict):
            ids = [r.replica_id for r in self.replicas]
            if len(roles) != len(ids):
                raise ValueError(
                    f"{len(roles)} roles for {len(ids)} replicas")
            roles = dict(zip(ids, list(roles)))
        for rid, role in roles.items():
            if role not in ROLES:
                raise ValueError(
                    f"replica {rid}: unknown role {role!r} "
                    f"(legal: {ROLES})")
            self.replica(rid)  # raises on unknown id
        assigned = {r.replica_id: roles.get(r.replica_id, r.role)
                    for r in self.replicas}
        caps = list(assigned.values())
        if not any(c in PHASE_ROLES["prefill"] for c in caps):
            raise ValueError("disaggregated pool needs at least one "
                             "prefill-capable (prefill/mixed) replica")
        if not any(c in PHASE_ROLES["decode"] for c in caps):
            raise ValueError("disaggregated pool needs at least one "
                             "decode-capable (decode/mixed) replica")
        for rep in self.replicas:
            rep.role = assigned[rep.replica_id]

    @classmethod
    def build(cls, engine_factory, n_replicas: int, *, roles=None,
              **kw) -> "DisaggPool":
        """:meth:`EnginePool.build` plus role assignment."""
        pool = super().build(engine_factory, n_replicas, **kw)
        if roles is not None:
            pool.set_roles(roles)
        return pool

    @classmethod
    def restore(cls, directory: str, engine_factory, *, roles=None,
                **kw) -> "DisaggPool":
        """:meth:`EnginePool.restore` plus role assignment. Restored
        entries replay on their original replicas first (the base
        contract — bitwise); any decode-phase request that lands on a
        prefill worker is handed off by the first post-restore step, so
        the role topology re-converges without a special path."""
        pool = super().restore(directory, engine_factory, **kw)
        if roles is not None:
            pool.set_roles(roles)
        return pool

    # ------------------------------------------------------------------
    # stepping: base pool + handoff dispatch
    # ------------------------------------------------------------------
    def step(self) -> bool:
        work = super().step()
        if self._dispatch_handoffs():
            work = True
        if _sanitizer.sanitize_enabled():
            _sanitizer.check_disagg_ownership(
                [(r.replica_id, r.role, r.scheduler.journal,
                  r.scheduler._all)
                 for r in self.replicas if r.state != DEAD],
                dict(self._inflight_handoffs), self._deferred)
            for rep in self.replicas:
                transfer = getattr(rep.engine, "transfer", None)
                if rep.state != DEAD and transfer is not None:
                    # handoff bytes must balance each engine's ledger:
                    # exports settle as completed D2H on the source, the
                    # import side moves host arrays only
                    _sanitizer.check_transfer_ledger(transfer)
        return work

    def _dispatch_handoffs(self) -> int:
        """Move every decode-phase request off its prefill worker. Walks
        prefill replicas in id order; per request, picks the target
        BEFORE detaching (a request is never detached without somewhere
        to go), deferring when no decode-capable replica has
        ``AdaptiveLimit`` headroom or the KV is not yet at rest."""
        self._deferred.clear()
        moved = 0
        for src in self.replicas:
            if src.state != SERVING or src.role != "prefill":
                continue
            sched = src.scheduler
            pending = [(uid, req) for uid, req in sched._live.items()
                       if req.state is RequestState.DECODE]
            for uid, req in pending:
                ready = getattr(src.engine, "export_ready", None)
                if ready is not None and not ready(uid):
                    # mid-speculation / in-flight tokens: next step
                    self._deferred.add(uid)
                    self.metrics.observe_handoff_deferral()
                    continue
                candidates = self._serving(exclude=src)
                target, _ = self.router.place(req.replay_tokens(),
                                              candidates, phase="decode")
                if target is None:
                    # every decode-capable replica is saturated (or gone)
                    # — the request keeps decoding where it is; admission
                    # pressure, not migration, is what the limit protects
                    self._deferred.add(uid)
                    self.metrics.observe_handoff_deferral()
                    continue
                moved += self._handoff(src, target, uid)
        return moved

    def _handoff(self, src: Replica, dst: Replica, uid: int) -> int:
        """One prefill→decode handoff over the detach/adopt seam with the
        KV riding alongside. Failure ladder: export failure → payload
        ``None`` → plain replay adopt; import rejection (CRC, typed
        usage, geometry) → replay adopt; adopt failure → imported KV
        flushed off the target (orphan-counted), ownership restored on
        the source, error re-raised — the entry is never stranded outside
        every journal."""
        t0 = time.perf_counter()
        now = self._clock()
        entry, payload = src.scheduler.detach_with_kv(uid)
        self._inflight_handoffs[uid] = payload
        kv, nbytes = False, 0
        try:
            if src.limit is not None:
                src.limit.release(uid)
            req = entry.request
            if (req is not None and req.deadline is not None
                    and req.deadline <= now):
                # mid-handoff expiry cancels TYPED, exactly like the
                # death-replay deadline branch — the payload is dropped
                # (host arrays, nothing to cancel in the ledger)
                req.error = RequestFailedError(
                    uid, f"deadline expired during prefill->decode "
                    f"handoff (deadline {req.deadline:.3f} <= now "
                    f"{now:.3f})")
                req.state = RequestState.CANCELLED
                req.cancel_reason = "deadline"
                req.finish_time = now
                self._owner.pop(uid, None)
                return 0
            if payload is not None:
                importer = getattr(dst.engine, "import_swap", None)
                if importer is not None:
                    try:
                        nbytes = importer(uid, payload)
                        kv = True
                    except (TransferCorruptError, EngineUsageError) as e:
                        logger.warning(
                            "pool: uid %d handoff KV import on replica "
                            "%d failed (%s); degrading to journal "
                            "replay", uid, dst.replica_id, e)
            try:
                dst.scheduler.adopt(entry)
            except Exception:
                if kv:
                    dst.engine.flush(uid)  # orphaned import, counted
                src.scheduler.adopt(entry)
                if src.limit is not None:
                    src.limit.admit(uid)
                raise
            self._owner[uid] = dst.replica_id
            if dst.limit is not None:
                dst.limit.admit(uid)
        finally:
            self._inflight_handoffs.pop(uid, None)
        self.metrics.observe_migration()
        self.metrics.observe_handoff(kv, nbytes,
                                     time.perf_counter() - t0)
        logger.debug(
            "pool: uid %d handed off replica %d -> %d (%s, %d B)",
            uid, src.replica_id, dst.replica_id,
            "kv" if kv else "replay", nbytes)
        return 1

    # ------------------------------------------------------------------
    # per-role loss absorption
    # ------------------------------------------------------------------
    def _replay_target(self, entry, survivors: List[Replica]) -> Replica:
        """Role-aware replay targeting: a mid-prefill entry (no committed
        tokens) belongs on a prefill-capable survivor, a decode-phase one
        on a decode-capable survivor — each through the router's
        phase-filtered, headroom-gated placement. When no phase-capable
        survivor has headroom the load must still land: least-loaded
        among the phase-capable, else least-loaded among ALL survivors
        (role purity yields to capacity — the handoff dispatcher will
        re-home the request once the topology recovers)."""
        phase = "decode" if entry.tokens else "prefill"
        target, _ = self.router.place(entry.replay_tokens(), survivors,
                                      phase=phase)
        if target is None:
            capable = [r for r in survivors
                       if getattr(r, "role", "mixed") in PHASE_ROLES[phase]]
            pool = capable or survivors
            target = min(pool,
                         key=lambda r: (Router.load(r), r.replica_id))
        return target
