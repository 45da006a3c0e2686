"""Continuous-batching scheduler over ``InferenceEngineV2``.

A copy of ``deepspeed_tpu/serve/scheduler.py`` for the port, which imports nothing
of the JAX package; the text below is the JAX module's. The port's engine
runs every schedule here: slot and paged engines, the fused decode horizon,
speculative verification, pipelined dispatch, and swap preemption over the
host KV tier. The drain in ``close()`` waits for the card with
``torch.cuda.synchronize`` where the JAX package blocks on the pool.

The engine exposes the mechanism (``put`` / ``decode_step`` / ``flush`` /
``can_schedule``); every consumer so far hand-rolled the policy around it.
:class:`ContinuousBatchScheduler` is that policy, production-shaped:

- **admission**: priority-plus-age scoring (``priority + age_weight * age``,
  plus a deadline-urgency boost), so high-priority requests go first but an
  aged low-priority request always overtakes a *later-arriving* one — a
  steady stream of VIP traffic cannot starve the tail. Backpressure is a
  bounded queue: ``submit`` raises :class:`QueueFullError` when full.
- **chunked interleaved prefill** (paged engines, default on): admission
  only *registers* a request's prompt with the engine (the prefix-cache
  lookup runs immediately); the prompt's tokens then ride the per-step
  dispatch in budget-bounded chunks MIXED with the live decode rows — one
  compiled ragged program per scheduler iteration, decode rows first
  (shortest-pending-first), prefill chunks filling the remaining budget.
  TTFT under a long-prompt convoy is O(chunk), not O(prompt): no decode
  round, and no queued admission, ever waits for a whole foreign prefill.
  Partially-prefilled requests are first-class: they persist in ``PREFILL``
  across steps, stay preemptible (re-admission replays the prompt through
  the prefix cache, which already indexed the partial prompt's full
  blocks — bitwise-lossless under greedy), and rows whose KV blocks cannot
  be allocated are deferred by the engine rather than stalling the batch.
  ``chunked_prefill=False`` restores the monolithic drain-at-admission
  path (the A/B baseline; slot engines always use it).
- **preemption under block-pool pressure**: when ``can_schedule`` fails for
  a higher-priority arrival (or the shared KV block pool runs dry mid-step),
  a victim is selected — lowest priority, then most blocks held, then least
  progress — ``engine.preempt``-ed to reclaim its blocks, and re-queued.
  Admission-time eviction additionally requires the arrival to beat the
  victim's admission score, so age shields long-waiting requests.
  Re-admission replays ``prompt + generated`` through ``put``; with the
  paged engine's prefix cache on, the victim's full blocks are still indexed
  (flush parks them in the LRU) so the replay maps them straight back into
  the block table at near-zero cost. Greedy decoding makes the round trip
  bitwise-lossless: the re-admitted request continues with exactly the
  tokens an unpreempted run would have produced. On an engine with a host
  KV tier (``host_tier_blocks > 0``, docs/PREFIX_CACHING.md "Two-tier
  cache") a swap-vs-recompute cost model picks the cheaper exit per
  victim: ``engine.swap_out`` parks the victim's KV in host RAM so
  re-admission is one batched host->device block copy (``swap_in``)
  instead of a prompt replay — swap wins when
  ``2 x blocks x block_bytes x s_per_byte_EMA <
  replay_tokens x token_EMA``. ``swap_preemption`` forces either path;
  the swap store is a cache, never a source of truth: a rebuild drops it
  and re-admission falls back to the journal replay unchanged.
- **failure containment** (docs/RESILIENCE.md): engine faults are typed
  (``deepspeed_tpu.resilience.errors``) and no longer unwind the whole
  serving loop. Transient faults are retried with bounded exponential
  backoff + deterministic jitter; persistent per-request faults quarantine
  ONLY the culpable request into the terminal ``FAILED`` state (blocks
  flushed, streaming consumers unblocked with the error) while uninvolved
  live requests are preempted and re-admitted through the prefix cache —
  bitwise-lossless under greedy decoding. A step watchdog counts wall-clock
  budget breaches and escalates sustained slowness to the circuit breaker;
  the breaker sheds low-priority admissions (``SheddingError``) while open
  and restores service through a half-open probe. Capacity signals
  (``PoolExhaustedError``) stay what they were: preemption pressure, never
  breaker failures.
- **fused multi-token decode** (docs/SERVING.md): when the engine was built
  with ``decode_horizon=K``, steady-state decode rounds run K tokens per
  compiled dispatch (``engine.decode_multi``) instead of one — the per-token
  host overhead (dispatch, transfer, scheduler iteration) is amortized K×.
  An **adaptive horizon** collapses to 1 whenever fusing could hurt TTFT or
  SLA behavior (pending admissions, stalled prefill, <K tokens remaining, a
  deadline inside the horizon's wall-clock budget), and the ≤K−1 overrun
  tokens a horizon generates past ``max_new_tokens``/EOS are **rolled
  back** (``engine.rollback``) so output, block accounting, and the prefix
  index are bitwise identical to single-step decode under greedy.
- **speculative decoding** (docs/SERVING.md): with a ``proposer``
  configured, full-horizon rounds draft up to K−1 tokens per request
  (prompt-lookup self-drafting by default, or a small draft model) and
  verify them in ONE position-parallel ``engine.verify_multi`` dispatch;
  the longest accepted prefix +1 bonus token is committed, the rest rolled
  back. A per-request acceptance EMA adapts the draft length and degrades
  collapsed requests to the plain fused path. Greedy verification emits
  exactly the tokens sequential greedy would — the bitwise story, the
  preempt→re-admit replay, and chaos parity all survive unchanged.
- **streaming**: per-token callbacks (``Request.on_token``) and a pull
  iterator (:meth:`stream`) that drives the loop.
- **graceful drain**: :meth:`close` rejects new admits, cancels
  never-admitted queued requests, finishes everything that was started
  (including preempted requests awaiting re-admission), and blocks on
  outstanding device work before returning — the r4 transfer-guard
  discipline (``deepspeed_tpu/utils/transfer.py``): never abandon queued
  transfers. With a watchdog ``drain_budget_s`` the drain is bounded:
  stragglers are cancelled rather than hanging shutdown forever.

Everything here is host-side bookkeeping; the fixed-shape contract of the
paged engine is untouched (``ragged_cache_size <= 4`` plus at most ONE
fused-horizon program, ``fused_cache_size <= 1``, under any schedule).
"""

import time
from collections import deque
from typing import Callable, Deque, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..analysis import sanitizer as _sanitizer
from ..resilience.breaker import CircuitBreaker
from ..resilience.errors import (ContextOverflowError, DeadlineShedError,
                                 PoolExhaustedError, QuotaExceededError,
                                 RequestFailedError, SheddingError,
                                 TenantThrottledError, TransientEngineError,
                                 UnrecoverableEngineError)
from ..resilience.recovery import RecoveryPolicy, RequestJournal
from ..resilience.retry import RetryPolicy
from ..resilience.watchdog import StepWatchdog
from ..utils.logging import logger
from .metrics import Event, ServeMetrics
from .request import Request, RequestState
from .sampling import SamplingParams, StopScanner, combined_bias
from .speculation import DraftProposer, SpecPolicy
from .tenancy import TenantRegistry


class QueueFullError(RuntimeError):
    """Bounded-queue backpressure: the caller must retry later or shed load."""


class SchedulerClosedError(RuntimeError):
    """``submit`` after ``close()`` — the scheduler is draining or drained."""


class ContinuousBatchScheduler:
    """SLA-aware admit/decode loop owning one :class:`InferenceEngineV2`.

    ``clock`` is the *scheduling* time source (arrivals, aging, deadlines,
    TTFT, breaker cooldowns) and is injectable for deterministic tests /
    simulated arrival processes; decode-step latency and watchdog budgets
    are always measured with ``time.perf_counter``. Token selection is
    greedy argmax by default; a request submitted with
    :class:`~deepspeed_tpu.serve.sampling.SamplingParams` samples under
    counter-based per-(seed, position) keys (docs/SAMPLING.md), which
    keeps the preemption round trip's bitwise guarantee — replay
    recomputes the same keys from the committed history, exactly as
    argmax recomputes the same tokens.

    ``retry`` / ``breaker`` / ``watchdog`` default to always-on instances
    whose thresholds only matter once faults actually occur (the watchdog
    defaults to no budget), so a healthy engine sees zero behavior change.
    ``sleep`` is the backoff sleeper — injectable so chaos tests don't wait
    out real backoff.

    ``journal`` / ``recovery`` are the engine-loss recovery pair
    (docs/RESILIENCE.md): the write-ahead request journal and the rebuild
    budget. On an :class:`UnrecoverableEngineError` the scheduler rebuilds
    the engine and replays every journaled live request through normal
    admission — bitwise lossless under greedy; streams see a pause, not an
    error. ``RecoveryPolicy(max_consecutive_rebuilds=0)`` disables recovery
    (losses propagate to the caller).
    """

    def __init__(self, engine, *, max_queue: int = 256, age_weight: float = 1.0,
                 deadline_weight: float = 1.0, preemption: bool = True,
                 clock: Callable[[], float] = time.monotonic,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 watchdog: Optional[StepWatchdog] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 decode_horizon: Optional[int] = None,
                 chunked_prefill: Optional[bool] = None,
                 proposer: Optional[DraftProposer] = None,
                 journal: Optional[RequestJournal] = None,
                 recovery: Optional[RecoveryPolicy] = None,
                 replica_id: Optional[int] = None,
                 escalate_losses: bool = False,
                 swap_preemption: Optional[bool] = None,
                 deadline_guard: bool = False,
                 pipelined: bool = False,
                 tenancy: Optional[TenantRegistry] = None):
        self.engine = engine
        #: multi-tenant QoS (docs/SERVING.md "Multi-tenant QoS"): when a
        #: :class:`TenantRegistry` is attached, every submit must name a
        #: registered tenant; admission order becomes weighted fair
        #: queueing over (tenant, SLO class) instead of the priority
        #: score, token buckets / outstanding quotas gate submission, and
        #: per-tenant prefix-cache quotas are pushed to the engine. Pool
        #: replicas share ONE registry so quotas and virtual time are
        #: tenant-global. ``None`` (the default) is byte-for-byte the
        #: pre-tenancy scheduler.
        self.tenancy = tenancy
        #: pool membership (docs/SERVING.md engine pool): ``replica_id``
        #: labels this scheduler's metrics/events so N replicas never alias
        #: in one monitor stream; ``escalate_losses`` re-raises engine
        #: losses out of :meth:`step` instead of recovering in place — the
        #: pool routes them to cross-replica replay when survivors exist
        self.replica_id = replica_id
        self.escalate_losses = escalate_losses
        # chunked interleaved prefill (docs/SERVING.md): the default for
        # paged engines — admission registers the prompt, its chunks ride
        # the per-step mixed dispatch. False = monolithic drain at _start
        # (the A/B baseline). Slot engines have no mixed ragged program to
        # interleave into, so they always run monolithic.
        if chunked_prefill is None:
            chunked_prefill = bool(getattr(engine, "paged", False))
        elif chunked_prefill and not getattr(engine, "paged", False):
            raise ValueError(
                "chunked_prefill=True needs a paged engine (prefill chunks "
                "interleave into the mixed ragged dispatch)")
        self.chunked_prefill = chunked_prefill
        #: fused dispatches run since prefill last progressed — the duty
        #: cycle _effective_horizon uses to trade K against backlog
        self._fused_since_prefill = 0
        #: priority of the highest-priority PREFILL request whose backlog
        #: is deferral-starved under pool pressure (None = no starvation).
        #: While set, _admit holds strictly-lower-priority candidates back:
        #: freed capacity must reach the starved prefill, not be stolen by
        #: a re-admitted victim's replay (the admit↔preempt ping-pong)
        self._starved_prio: Optional[int] = None
        # fused multi-token decode (docs/SERVING.md): the horizon K the
        # decode loop MAY run at — defaults to the engine's compiled horizon.
        # The adaptive policy (_effective_horizon) collapses to 1 whenever
        # fusing could hurt TTFT or SLA behavior.
        if decode_horizon is None:
            decode_horizon = getattr(engine, "decode_horizon", 1)
        elif decode_horizon != 1 and decode_horizon != getattr(
                engine, "decode_horizon", 1):
            raise ValueError(
                f"decode_horizon {decode_horizon} does not match the "
                f"engine's compiled horizon "
                f"{getattr(engine, 'decode_horizon', 1)} (horizons are "
                "restricted to {1, K} — the fixed-shape discipline)")
        self.decode_horizon = decode_horizon
        # speculative decoding (docs/SERVING.md): a DraftProposer (or a
        # pre-built SpecPolicy) turns every full-horizon round into a draft
        # + ONE verify_multi dispatch. The verify width is the engine's
        # compiled horizon K: up to K-1 draft tokens per request, and the
        # per-request acceptance EMA adapts each draft length down to the
        # expected accepted length (or to 0 — the plain fused path — when
        # acceptance collapses). Greedy verification keeps output bitwise
        # identical to non-speculative decode.
        self.spec: Optional[SpecPolicy] = None
        if proposer is not None:
            if not getattr(engine, "paged", False) or self.decode_horizon <= 1:
                raise ValueError(
                    "speculative decoding needs a paged engine compiled "
                    "with decode_horizon > 1 (the verify width K: drafts "
                    "are up to K-1 tokens, verified in one dispatch)")
            self.spec = (proposer if isinstance(proposer, SpecPolicy)
                         else SpecPolicy(proposer))
        self._token_est_s = 0.0  # EMA per-token dispatch wall (deadline guard)
        # deadline-aware early rejection (docs/RESILIENCE.md "Health &
        # overload"): shed at admission when predicted TTFT (pending prefill
        # backlog x the per-token dispatch EMA) already exceeds the deadline.
        # Opt-in: the EMA is wall-domain, so virtual-clock harnesses must not
        # arm it implicitly.
        self.deadline_guard = deadline_guard
        #: pool health feed (resilience.health): when set, every successful
        #: engine dispatch reports (kind, duration_s, scale) — the pool wires
        #: this to HealthMonitor.observe + AdaptiveLimit.observe per replica
        self.health_tap: Optional[Callable[[str, float, float], None]] = None
        # swap-based preemption (docs/PREFIX_CACHING.md "Two-tier cache"):
        # None = cost model (per victim, needs a host tier), True = always
        # swap when the engine can, False = always flush+replay. The
        # bandwidth EMA is seconds/byte measured around engine.swap_in (the
        # one designed host sync on this path); it starts empty and the
        # first swap in auto mode is the probe that fills it.
        self.swap_preemption = swap_preemption
        self._swap_s_per_byte = 0.0
        self.max_queue = max_queue
        self.age_weight = age_weight
        self.deadline_weight = deadline_weight
        self.preemption = preemption
        self._clock = clock
        self.retry = retry or RetryPolicy()
        self.breaker = breaker or CircuitBreaker()
        self.watchdog = watchdog or StepWatchdog()
        # explicit None check: an EMPTY journal is falsy (__len__ == 0), and
        # `journal or ...` would silently discard a caller's durable journal
        self.journal = RequestJournal() if journal is None else journal
        self.recovery = recovery or RecoveryPolicy()
        #: an engine loss observed on a teardown path (flush/preempt inside
        #: cancel/finish) — recorded, not raised: the dead engine's pool is
        #: garbage anyway, so the host-side terminal transition completes
        #: and the NEXT step() runs recovery before touching the engine
        self._engine_dead: Optional[BaseException] = None
        self._sleep = sleep
        self.metrics = ServeMetrics(replica_id=replica_id)
        self._queue: Deque[Request] = deque()
        self._live: Dict[int, Request] = {}
        self._all: Dict[int, Request] = {}
        #: host-side stop-sequence scan state, one per live sampled request
        #: with stop sequences. Built lazily from committed history, so
        #: preemption/migration/replay reconstruct it exactly (and pool
        #: migration never ships it — the adopting side rebuilds)
        self._stop_scanners: Dict[int, StopScanner] = {}
        #: an admitted request's prefill hit pool exhaustion; its pending
        #: tokens sit inside the engine and must drain before it decodes
        self._stalled = False
        # pipelined dispatch (docs/SERVING.md "Pipelined dispatch"): with
        # ``pipelined=True`` the decode loop keeps ONE step in flight —
        # plan/dispatch round N+1 while N executes on device, absorb N's
        # tokens one step late (speculative: late stop detections roll the
        # in-flight successor back). ``False`` is the bitwise synchronous
        # twin, the same discipline as ``overlap=False`` on the
        # TransferEngine.
        if pipelined and not getattr(engine, "paged", False):
            raise ValueError(
                "pipelined=True needs a paged engine (the deferred-sync "
                "decode_dispatch rides the compiled ragged decode round)")
        self.pipelined = pipelined
        #: the one in-flight decode round: a dict with the engine's
        #: DecodeDispatchHandle, the per-uid staleness record
        #: ``{uid: (req, desc, emitted_len)}``, and dispatch timing.
        #: None = the pipe is dry.
        self._inflight: Optional[Dict[str, object]] = None
        #: absorb work staged by step_dispatch for step_absorb (the pool's
        #: two-phase drive): (prev record, fetched tokens, timing)
        self._pending_absorb: Optional[Dict[str, object]] = None
        self._closed = False

    # ------------------------------------------------------------------
    # submission surface
    # ------------------------------------------------------------------
    def submit(self, prompt, *, max_new_tokens: int = 32, priority: int = 0,
               deadline: Optional[float] = None,
               arrival_time: Optional[float] = None,
               on_token=None, uid: Optional[int] = None,
               eos_token: Optional[int] = None,
               sampling: Optional[SamplingParams] = None,
               tenant: Optional[str] = None,
               slo: Optional[str] = None) -> Request:
        """Enqueue a request; raises :class:`QueueFullError` on backpressure,
        :class:`SheddingError` while the circuit breaker sheds load, and
        :class:`SchedulerClosedError` after :meth:`close`.

        ``sampling`` carries the per-request decoding policy
        (docs/SAMPLING.md). ``sampling.n > 1`` fans out into ``n`` sibling
        requests sharing the prompt (the paged prefix cache COW-shares its
        full blocks); the returned request is stream 0 (it keeps ``uid`` /
        ``on_token``) with the whole sibling list attached as ``.fanout``.
        Each sibling is journaled with its own concrete derived-seed params,
        so replay never re-fans-out."""
        if self._closed:
            raise SchedulerClosedError("scheduler is closed to new admits")
        slo_name = None
        if self.tenancy is not None:
            # tenancy resolution FIRST: the SLO class decides the priority
            # the breaker's shed floor and the preemption ordering see, and
            # its deadline budget feeds the deadline guard below
            if tenant is None:
                raise ValueError(
                    "this scheduler enforces multi-tenant QoS: submit() "
                    "requires tenant= (register tenants on its "
                    "TenantRegistry)")
            spec, cls = self.tenancy.resolve(tenant, slo)
            slo_name = cls.name
            priority = cls.priority
            if arrival_time is None:
                arrival_time = self._clock()
            if deadline is None and cls.deadline_s is not None:
                deadline = arrival_time + cls.deadline_s
        elif tenant is not None:
            raise ValueError(
                "tenant= given but this scheduler has no TenantRegistry "
                "(pass tenancy= at construction)")
        if self.breaker.should_shed(priority, self._clock()):
            self.metrics.faults["shed"] += 1
            raise SheddingError(
                f"circuit breaker open: shedding priority {priority} "
                f"(< floor {self.breaker.shed_priority_floor}); retry after "
                f"cooldown or resubmit at or above the floor")
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) + max_new_tokens > self.engine.max_seq_len:
            raise ValueError(
                f"prompt({len(prompt)}) + max_new_tokens({max_new_tokens}) "
                f"exceeds engine context {self.engine.max_seq_len}")
        if (self.deadline_guard and deadline is not None
                and self._token_est_s > 0.0):
            # deadline-aware early rejection: predicted TTFT is every prefill
            # token ahead of (and including) this prompt at the measured
            # per-token dispatch EMA. Shedding now is strictly cheaper than
            # burning prefill compute on a request that expires in queue.
            pending = (len(prompt) + self._prefill_backlog()
                       + sum(len(r.prompt) for r in self._queue))
            predicted = pending * self._token_est_s
            remaining = deadline - self._clock()
            if predicted > remaining:
                self.metrics.faults["deadline_shed"] += 1
                raise DeadlineShedError(
                    f"predicted TTFT {predicted:.4f}s exceeds remaining "
                    f"deadline budget {remaining:.4f}s ({pending} pending "
                    f"prefill token(s) at {self._token_est_s:.6f}s/token); "
                    "shed at admission", predicted_s=predicted,
                    remaining_s=remaining)
        if sampling is not None:
            if sampling.needs_engine and not getattr(self.engine, "paged",
                                                     False):
                raise ValueError(
                    "sampling with temperature / logit-bias / processors "
                    "requires a paged engine; slot-mode engines only "
                    "support greedy decoding (stop sequences alone are "
                    "host-side and allowed)")
            if sampling.logit_bias:
                vs = getattr(getattr(self.engine, "cfg", None),
                             "vocab_size", None)
                if vs is not None and sampling.logit_bias[-1][0] >= vs:
                    raise ValueError(
                        f"logit_bias token id {sampling.logit_bias[-1][0]} "
                        f">= engine vocab size {vs}")
            if sampling.n > 1:
                # atomic fanout admission: all n streams or none — a
                # partial fanout would leave best-of with missing arms
                if len(self._queue) + sampling.n > self.max_queue:
                    self.metrics.admission_rejects += 1
                    raise QueueFullError(
                        f"serve queue full ({self.max_queue}); fanout of "
                        f"{sampling.n} rejected")
                at = self._clock() if arrival_time is None else arrival_time
                if self.tenancy is not None:
                    # atomic fanout under QoS too: verify the bucket covers
                    # ALL n streams and the outstanding quota fits them
                    # before any sibling is admitted — no partial fanout on
                    # a mid-recursion throttle. Each sibling then charges
                    # its own share (the precheck guarantees success).
                    self.tenancy.precheck(
                        tenant, sampling.n,
                        sampling.n * float(len(prompt) + max_new_tokens),
                        self._clock())
                siblings = [
                    self.submit(prompt, max_new_tokens=max_new_tokens,
                                priority=priority, deadline=deadline,
                                arrival_time=at,
                                on_token=(on_token if i == 0 else None),
                                uid=(uid if i == 0 else None),
                                eos_token=eos_token,
                                sampling=sampling.child(i),
                                tenant=tenant, slo=slo)
                    for i in range(sampling.n)]
                first = siblings[0]
                first.fanout = siblings
                self.metrics.observe_fanout(sampling.n)
                return first
            sampling = sampling.child(0)  # normalize best_of off the record
        if len(self._queue) >= self.max_queue:
            self.metrics.admission_rejects += 1
            raise QueueFullError(
                f"serve queue full ({self.max_queue}); request rejected")
        if self.tenancy is not None:
            # the LAST admission gate: every cheaper rejection above ran
            # first, so a rejected request never drains the tenant's
            # bucket. charge() raises typed (QuotaExceededError before the
            # bucket is touched, TenantThrottledError with the refill time)
            cost = float(len(prompt) + max_new_tokens)
            try:
                self.tenancy.charge(tenant, cost, self._clock())
            except QuotaExceededError:
                self.metrics.observe_tenant(tenant, "quota_rejects")
                self.metrics.faults["shed"] += 1
                raise
            except TenantThrottledError:
                self.metrics.observe_tenant(tenant, "throttled")
                self.metrics.faults["shed"] += 1
                raise
        kw = {} if uid is None else {"uid": uid}
        req = Request(prompt=prompt, max_new_tokens=max_new_tokens,
                      priority=priority, deadline=deadline,
                      arrival_time=(self._clock() if arrival_time is None
                                    else arrival_time),
                      on_token=on_token, eos_token=eos_token,
                      sampling=sampling, tenant=tenant, slo=slo_name, **kw)
        if req.uid in self._all and not self._all[req.uid].finished:
            raise ValueError(f"uid {req.uid} is already in flight")
        if self.tenancy is not None:
            # WFQ tags (start-time fair queueing): assigned at submission,
            # consumed by _admit's min-finish-tag selection. The engine's
            # per-tenant cache quota rides along lazily so tenants
            # registered after scheduler construction still get enforced.
            req._wfq_start, req._wfq_finish = self.tenancy.wfq_tag(
                tenant, slo_name, cost)
            self.tenancy.note_outstanding(tenant, req.uid)
            self._push_tenant_quota(tenant)
            self.metrics.observe_tenant(tenant, "submitted")
        self._all[req.uid] = req
        self._queue.append(req)
        # write-ahead: journaled before the engine ever sees the request,
        # so an engine loss at ANY later point finds a replayable record
        self.journal.record(req)
        self.metrics.submitted += 1
        return req

    def cancel(self, uid: int, reason: str = "cancelled") -> bool:
        """Cancel a queued or live request. Safe to race with completion /
        preemption: the engine-side ``flush`` is idempotent."""
        req = self._all.get(uid)
        if req is None or req.finished:
            return False
        if req in self._queue:
            self._queue.remove(req)
        self._live.pop(uid, None)
        self._stop_scanners.pop(uid, None)
        self._engine_flush(uid)  # no-op when not resident (idempotent)
        req.state = RequestState.CANCELLED
        req.cancel_reason = reason
        req.finish_time = self._clock()
        self.journal.resolve(uid)
        self._release_tenant(req, "cancelled")
        self.metrics.cancelled += 1
        if self.spec is not None:
            self.spec.forget(uid)
        return True

    # ------------------------------------------------------------------
    # migration seam (docs/SERVING.md engine pool)
    # ------------------------------------------------------------------
    def detach(self, uid: int):
        """Hand a non-terminal request off this scheduler: preempt it out
        of the engine (blocks freed; a dead or rebuilt engine makes this a
        no-op — flush/preempt are idempotent), remove every host-side
        reference, and return its :class:`JournalEntry` with the live
        ``Request`` object attached. The entry is the migration token:
        :meth:`adopt` on another scheduler re-admits it through the normal
        ``put`` path, and greedy decoding makes the continuation bitwise
        identical to a never-migrated run (the same preemption round-trip
        guarantee engine-loss recovery rides). Raises ``ValueError`` for
        unknown/finished uids — detach is a control-plane call, never a
        race."""
        req = self._all.get(uid)
        if req is None or req.finished:
            raise ValueError(f"uid {uid} is not live on this scheduler")
        if self._inflight is not None and uid in self._inflight["rows"]:
            # pipelined dispatch: the uid has an unabsorbed token in flight.
            # Detach is a drain boundary (the TransferEngine discipline) —
            # absorb first so the migrating JournalEntry carries every token
            # the device already produced and the export sees at-rest KV.
            self._drain_inflight(self._clock())
        if req in self._queue:
            self._queue.remove(req)
        if uid in self._live:
            self._engine_preempt(uid)  # absorbs an engine loss (recorded)
            self._live.pop(uid, None)
        else:
            # a swap-preempted victim waiting in the queue still owns a
            # host-side swap entry on THIS engine; flush drops it (silent
            # no-op otherwise). Swap payloads never cross engines — the
            # adopting scheduler replays from the journal entry.
            self._engine_flush(uid)
        if req.state in (RequestState.PREFILL, RequestState.DECODE):
            # the legal eviction edge; the adopting side walks
            # PREEMPTED -> QUEUED (QUEUED/PREEMPTED requests ride as-is)
            req.state = RequestState.PREEMPTED
            req.preemptions += 1
        self._all.pop(uid, None)
        self._stop_scanners.pop(uid, None)  # adopting side rebuilds lazily
        if self.spec is not None:
            self.spec.forget(uid)
        entry = self.journal.detach(uid)
        entry.request = req
        self.metrics.detaches += 1
        return entry

    def detach_with_kv(self, uid: int):
        """Detach a request AND export its at-rest KV for a cross-engine
        handoff (docs/SERVING.md "Disaggregated serving"): returns
        ``(entry, payload)`` where ``payload`` is the engine's
        ``export_swap`` dict — or ``None`` whenever the KV path cannot
        deliver (engine without the seam, request not at rest, transfer
        failure, engine loss mid-export). ``None`` is the fallback-ladder
        signal, never an error: the entry always comes back valid and the
        adopting side replays ``prompt + committed tokens`` from the
        journal, so a degraded handoff costs recompute, not correctness.
        Export happens BEFORE detach — export pops the uid from this
        engine's stores, so by the time detach's flush runs the uid is
        resident nowhere on the source (no uid in two stores, ever)."""
        if self._inflight is not None and uid in self._inflight["rows"]:
            # absorb the in-flight round before export: export_swap demands
            # at-rest KV (no uncommitted positions), and the payload must
            # cover every token the journal entry will claim
            self._drain_inflight(self._clock())
        payload = None
        export = getattr(self.engine, "export_swap", None)
        if export is not None and self._engine_dead is None:
            try:
                payload = export(uid)
            except UnrecoverableEngineError as e:
                # next step() recovers; THIS handoff degrades to replay
                self._note_engine_lost(e)
                payload = None
            except TransientEngineError:
                # a handoff is never worth a retry loop — replay instead
                payload = None
        return self.detach(uid), payload

    def adopt(self, entry) -> Request:
        """Take ownership of a detached :class:`JournalEntry`: journal it
        here (committed-token record preserved byte for byte), walk the
        request onto the queue, and let normal admission replay
        ``prompt + committed tokens`` through ``put``. The SAME ``Request``
        object keeps serving when the entry carries one (streams survive
        the move); a bare entry — e.g. replayed from a durable journal
        after a host crash — reconstructs the request from the serialized
        fields."""
        if self._closed:
            raise SchedulerClosedError(
                "cannot adopt into a closed scheduler")
        req = getattr(entry, "request", None)
        if req is None:
            req = Request(prompt=list(entry.prompt),
                          max_new_tokens=entry.max_new_tokens,
                          priority=entry.priority, deadline=entry.deadline,
                          arrival_time=entry.arrival_time,
                          eos_token=entry.eos_token, uid=entry.uid,
                          sampling=getattr(entry, "sampling", None),
                          tenant=getattr(entry, "tenant", None),
                          slo=getattr(entry, "slo", None))
            req.tokens = list(entry.tokens)
            entry.request = req
        sp = getattr(req, "sampling", None)
        if (sp is not None and sp.needs_engine
                and not getattr(self.engine, "paged", False)):
            raise ValueError(
                f"uid {req.uid}: sampled request cannot be adopted by a "
                f"slot-mode (non-paged) engine")
        if req.uid in self._all and not self._all[req.uid].finished:
            raise ValueError(f"uid {req.uid} is already in flight here")
        if (len(req.prompt) + req.max_new_tokens
                > self.engine.max_seq_len):
            raise ValueError(
                f"uid {req.uid}: prompt({len(req.prompt)}) + "
                f"max_new_tokens({req.max_new_tokens}) exceeds this "
                f"engine's context {self.engine.max_seq_len}")
        if req.state is RequestState.PREEMPTED:
            req.state = RequestState.QUEUED
        self._all[req.uid] = req
        self._queue.append(req)
        self.journal.adopt(entry)
        self.metrics.adopts += 1
        if self.tenancy is not None and req.tenant is not None:
            # migration is not new offered load: the uid re-notes as
            # outstanding (idempotent — the registry is pool-global) and
            # the bucket is NEVER re-charged. The request does re-enter
            # the fair queue here, so it takes fresh WFQ tags on this
            # registry's virtual time (deterministic: adoption order is
            # replay order).
            req._wfq_start, req._wfq_finish = self.tenancy.wfq_tag(
                req.tenant, req.slo or "", float(len(req.prompt)
                                                 + req.max_new_tokens))
            self.tenancy.note_outstanding(req.tenant, req.uid)
            self._push_tenant_quota(req.tenant)
        return req

    # ------------------------------------------------------------------
    # multi-tenant QoS plumbing (docs/SERVING.md "Multi-tenant QoS")
    # ------------------------------------------------------------------
    def _push_tenant_quota(self, tenant: str) -> None:
        """Push one tenant's prefix-cache block quota to the engine (the
        ``set_kv_quota`` seam — silently absent on slot engines). Called
        at submit/adopt so tenants registered after construction are still
        enforced before their first block is ever cached."""
        if self.tenancy is None:
            return
        setq = getattr(self.engine, "set_kv_quota", None)
        if setq is None:
            return
        try:
            spec = self.tenancy.spec(tenant)
        except ValueError:
            return  # adopted legacy entry naming an unregistered tenant
        if spec.cache_blocks is not None:
            setq(tenant, spec.cache_blocks)

    def _push_tenant_quotas(self) -> None:
        """Re-push EVERY registered tenant's cache quota — a rebuilt
        engine starts with a fresh :class:`BlockedKVCache` that has
        forgotten them."""
        if self.tenancy is None:
            return
        setq = getattr(self.engine, "set_kv_quota", None)
        if setq is None:
            return
        for spec in self.tenancy.tenants():
            if spec.cache_blocks is not None:
                setq(spec.tenant_id, spec.cache_blocks)

    def _release_tenant(self, req: Request, outcome: str) -> None:
        """A tenant-tagged request reached a terminal state here: release
        its pool-global outstanding slot and account the outcome."""
        if self.tenancy is None or req.tenant is None:
            return
        self.tenancy.release(req.tenant, req.uid)
        self.metrics.observe_tenant(req.tenant, outcome)
        if req.tokens:
            self.metrics.observe_tenant(req.tenant, "tokens",
                                        float(len(req.tokens)))

    # ------------------------------------------------------------------
    # fault handling primitives (docs/RESILIENCE.md)
    # ------------------------------------------------------------------
    def _retry_transient(self, site: str, attempt: int,
                         err: TransientEngineError) -> bool:
        """Account one transient fault; True if the caller should back off
        and retry, False when the retry budget is spent (caller re-raises).
        Every occurrence is a breaker failure — a retried-away fault still
        happened."""
        now = self._clock()
        self.metrics.faults["transient_faults"] += 1
        self.breaker.on_failure(now)
        if attempt + 1 >= self.retry.max_attempts:
            self.metrics.faults["retry_giveups"] += 1
            logger.warning("serve: transient fault at %s, retries exhausted "
                           "(%d attempts): %s", site, attempt + 1, err)
            return False
        self.metrics.faults["transient_retries"] += 1
        self._sleep(self.retry.delay(attempt + 1, key=site))
        return True

    def _note_engine_lost(self, exc: BaseException) -> None:
        """Record an engine loss seen on a path that must not raise (the
        teardown half of cancel/finish): the next :meth:`step` recovers
        before touching the engine again."""
        if self._engine_dead is None:
            self._engine_dead = exc

    def _engine_flush(self, uid: int) -> None:
        """``engine.flush`` with transient-fault retry (flush must not fail
        a cancel/finish path on a runtime hiccup; it is idempotent, so the
        retry is always safe). An engine LOSS here is absorbed, not raised:
        the blocks this flush would reclaim died with the engine, so the
        host-side terminal transition completes and recovery (which rebuilds
        the whole pool) runs at the next step."""
        attempt = 0
        while True:
            try:
                return self.engine.flush(uid)
            except UnrecoverableEngineError as e:
                self._note_engine_lost(e)
                return
            except TransientEngineError as e:
                if not self._retry_transient("flush", attempt, e):
                    raise
                attempt += 1

    def _engine_preempt(self, uid: int) -> int:
        attempt = 0
        while True:
            try:
                return self.engine.preempt(uid)
            except UnrecoverableEngineError as e:
                # same contract as _engine_flush: the victim is re-queued
                # host-side (its replay needs no engine state) and the dead
                # pool reclaims nothing — recovery rebuilds it wholesale
                self._note_engine_lost(e)
                return 0
            except TransientEngineError as e:
                if not self._retry_transient("preempt", attempt, e):
                    raise
                attempt += 1

    def _engine_swap_out(self, uid: int) -> bool:
        """``engine.swap_out`` with the same fault contract as
        ``_engine_preempt``: an engine loss is absorbed (the victim replays
        from the journal after recovery — the swap entry would have died
        with the incarnation anyway), transients retry. False means the
        engine declined (pending prefill tokens, uncommitted speculation,
        no tier) and the caller takes the flush+replay path."""
        attempt = 0
        while True:
            try:
                return self.engine.swap_out(uid)
            except UnrecoverableEngineError as e:
                self._note_engine_lost(e)
                return False
            except TransientEngineError as e:
                if not self._retry_transient("swap_out", attempt, e):
                    raise
                attempt += 1

    def _observe_engine_ok(self, kind: str, duration_s: float,
                           scale: float = 1.0) -> None:
        """A successful engine call: feed the watchdog; a budget breach is
        NOT a success for the breaker (a slow-but-alive engine must be able
        to open it), and an escalation counts as a failure outright.
        ``scale`` is the decode horizon: a K-step fused dispatch gets K× the
        step budget (its wall clock is ~K single steps of legitimate work)."""
        now = self._clock()
        # a hard breach (wedged dispatch) raises UnrecoverableEngineError
        # out of observe — neither breaker hook runs; step()'s recovery
        # wrapper catches it and rebuilds the engine
        if self.health_tap is not None:
            self.health_tap(kind, duration_s, scale)
        breached, escalated = self.watchdog.observe(kind, duration_s, scale)
        if not breached:
            self.breaker.on_success(now)
            # a healthy dispatch proves the current incarnation works:
            # the consecutive-rebuild budget re-arms
            self.recovery.note_engine_ok()
        elif escalated:
            self.breaker.on_failure(now)

    def _fail(self, req: Request, exc: BaseException, now: float) -> None:
        """Quarantine ``req``: terminal FAILED, blocks flushed, streaming
        consumers unblocked with the error (``stream`` re-raises it)."""
        self._live.pop(req.uid, None)
        self._stop_scanners.pop(req.uid, None)
        if req in self._queue:
            self._queue.remove(req)
        self._engine_flush(req.uid)
        req.state = RequestState.FAILED
        req.error = exc
        req.finish_time = now
        self.journal.resolve(req.uid)
        self._release_tenant(req, "failed")
        self.metrics.failed += 1
        self.metrics.faults["failed_requests"] += 1
        if self.spec is not None:
            self.spec.forget(req.uid)
        logger.warning("serve: quarantined uid %d after persistent fault: %s",
                       req.uid, exc)

    def _contain(self, culpable_uid: int, exc: BaseException,
                 now: float) -> None:
        """Persistent per-request failure: fail the culpable request, then
        preempt every uninvolved live request so it re-admits through the
        prefix cache from known-good state — bitwise-lossless under greedy
        decoding. The fault layer raises before the engine mutates state, so
        the survivors' committed history is intact."""
        self.metrics.faults["persistent_faults"] += 1
        self.breaker.on_failure(now)
        req = self._all.get(culpable_uid)
        if req is not None and not req.finished:
            self._fail(req, exc, now)
        else:  # culprit unknown to us: flush engine-side residue anyway
            self._engine_flush(culpable_uid)
        for other in [r for r in list(self._live.values())
                      if r.state in (RequestState.PREFILL,
                                     RequestState.DECODE)]:
            self._preempt(other)
            self.metrics.faults["containment_preemptions"] += 1
        self._stalled = not self.chunked_prefill and any(
            d.in_flight for d in self.engine.state.seqs.values())

    def _recover(self, exc: BaseException, now: float) -> None:
        """Engine-loss recovery (docs/RESILIENCE.md): the engine is dead or
        wedged — quarantine nothing, replace it.

        1. The loss is a breaker failure (the trail records the incident).
        2. :class:`RecoveryPolicy` admits the rebuild or the loss re-raises
           (budget spent / recovery disabled — supervisor's problem).
        3. ``engine.rebuild()`` replaces pools and sequence state with
           fresh instances of identical geometry; the compiled programs
           survive, so the per-incarnation dispatch bounds are unchanged.
        4. Every live request walks the legal eviction edges
           (``PREFILL/DECODE -> PREEMPTED -> QUEUED``) back into the queue:
           re-admission feeds its committed history through the NORMAL
           ``put`` path — the rebuilt prefix cache is cold, so the replay
           is a real prefill, but greedy decoding makes the continuation
           bitwise identical (the preemption round-trip guarantee).
           In-flight dispatch results that were never absorbed are simply
           lost; replay regenerates those tokens identically.
        5. Requests whose deadline passed while the engine was down are
           cancelled TYPED: ``Request.error`` carries a
           :class:`RequestFailedError`, so ``stream()`` consumers re-raise
           instead of hanging or ending silently mid-output.
        6. The breaker re-arms HALF_OPEN — the next dispatch is the probe.

        Every lifecycle position lands in a defined outcome: mid-prefill
        and mid-speculation requests replay from committed history (a
        speculative dispatch commits only emitted tokens, so no draft ever
        enters the journal), PREEMPTED requests are already queued and
        simply meet a fresh engine, and a loss during ``close()``'s drain
        recovers here too — the drain loop keeps stepping until the
        replayed requests finish."""
        self._engine_dead = None
        self.metrics.faults["engine_losses"] += 1
        self.breaker.on_failure(now)
        if not self.recovery.admit(now, type(exc).__name__):
            logger.error(
                "serve: engine lost (%s) with the consecutive-rebuild "
                "budget (%d) spent — escalating to the supervisor", exc,
                self.recovery.max_consecutive_rebuilds)
            raise exc
        logger.warning(
            "serve: engine lost (%s); rebuilding — %d live request(s) "
            "replay from the journal", exc, len(self._live))
        self.engine.rebuild()
        # a rebuilt engine's fresh BlockedKVCache has forgotten every
        # per-tenant cache quota — re-arm them before any replay registers
        self._push_tenant_quotas()
        replayed = 0
        for req in list(self._live.values()):
            req.state = RequestState.PREEMPTED
            req.preemptions += 1
            # original arrival time rides along: a replayed request keeps
            # its age-based admission score (same anti-thrash rule as
            # ordinary preemption)
            req.state = RequestState.QUEUED
            self._queue.append(req)
            replayed += 1
        self._live.clear()
        # per-incarnation scheduler state: the fresh engine holds no
        # pending prefill, so none of these can carry over
        self._stalled = False
        self._starved_prio = None
        self._fused_since_prefill = 0
        # a round in flight died with the device — its tokens were never
        # absorbed, so the journal replay regenerates them bitwise
        self._inflight = None
        self._pending_absorb = None
        cancelled = 0
        rnow = self._clock()
        for req in [r for r in self._queue
                    if r.deadline is not None and r.deadline <= rnow]:
            req.error = RequestFailedError(
                req.uid, f"deadline expired during engine recovery "
                f"(deadline {req.deadline:.3f} <= now {rnow:.3f})")
            self.cancel(req.uid, reason="deadline")
            self.metrics.deadline_cancels += 1
            self.metrics.faults["recovery_cancelled"] += 1
            cancelled += 1
        self.metrics.faults["engine_rebuilds"] += 1
        self.metrics.faults["recovery_replays"] += replayed
        self.recovery.note_rebuilt(rnow, replayed, cancelled)
        self.breaker.rearm_half_open(rnow)
        logger.warning(
            "serve: engine rebuilt (#%d this scheduler): %d replaying, "
            "%d cancelled past deadline; breaker HALF_OPEN",
            self.recovery.rebuilds, replayed, cancelled)
        if _sanitizer.sanitize_enabled():
            # checked mode: the new incarnation starts empty, and every
            # journaled live uid must be re-queued or terminally resolved —
            # a silent drop would hang its stream consumer forever
            _sanitizer.check_drained(self.engine)
            _sanitizer.check_recovery(self.journal, self._queue, self._all)

    # ------------------------------------------------------------------
    # scheduling policy
    # ------------------------------------------------------------------
    def _score(self, req: Request, now: float) -> float:
        s = req.priority + self.age_weight * (now - req.arrival_time)
        if req.deadline is not None:
            s += self.deadline_weight / max(req.deadline - now, 1e-3)
        return s

    def _blocks_held(self, uid: int) -> int:
        desc = self.engine.state.seqs.get(uid)
        return len(desc.blocks) if desc is not None else 0

    def _pick_victim(self, below_priority: Optional[int] = None
                     ) -> Optional[Request]:
        """Eviction order: lowest priority, then most blocks held (reclaim
        the most KV per eviction), then least progress (waste the least
        decode work). A stalled mid-prefill request is evictable too — its
        replay is just its prompt."""
        cands = [r for r in self._live.values()
                 if r.state in (RequestState.DECODE, RequestState.PREFILL)
                 and (below_priority is None or r.priority < below_priority)]
        if not cands:
            return None
        return min(cands, key=lambda r: (r.priority,
                                         -self._blocks_held(r.uid),
                                         len(r.tokens)))

    def _swap_wins(self, req: Request, held: int) -> bool:
        """Swap-vs-recompute cost model (docs/PREFIX_CACHING.md "Two-tier
        cache"). Swapping moves the victim's KV across the interconnect
        twice (out now, back in at re-admission); recompute replays
        ``prompt + generated`` through prefill. Per victim:

            swap:      2 x held x block_bytes x s_per_byte_EMA
            recompute: len(replay_tokens) x token_EMA

        ``swap_preemption`` True/False forces the path. In auto mode an
        empty token EMA (nothing decoded yet) means no evidence recompute
        is expensive — replay; an empty bandwidth EMA with a live token EMA
        takes one swap as the probe that measures it."""
        if not getattr(self.engine, "host_tier_blocks", 0):
            return False
        if self.swap_preemption is False:
            return False
        # only a fully-prefilled, decoded-at-least-once victim has swappable
        # at-rest KV; mid-prefill victims (pending engine-side tokens) replay
        if held == 0 or req.state is not RequestState.DECODE:
            return False
        if self.swap_preemption:
            return True
        if self._token_est_s == 0.0:
            return False
        if self._swap_s_per_byte == 0.0:
            # before the first measured swap_in, seed from the engine's
            # TransferEngine H2D bandwidth EMA (docs/TRANSFER.md): ANY
            # promote/swap traffic already priced the tunnel, so the cost
            # model starts informed instead of blind-probing
            te = getattr(self.engine, "transfer", None)
            seed = te.s_per_byte("h2d") if te is not None else 0.0
            if seed <= 0.0:
                return True  # bandwidth probe: the swap_in measures the EMA
            self._swap_s_per_byte = seed
        swap_s = (2.0 * held * getattr(self.engine, "block_bytes", 0)
                  * self._swap_s_per_byte)
        recompute_s = len(req.replay_tokens()) * self._token_est_s
        return swap_s < recompute_s

    def _preempt(self, req: Request) -> None:
        held = self._blocks_held(req.uid)
        swapped = self._swap_wins(req, held) and self._engine_swap_out(
            req.uid)
        freed = held if swapped else self._engine_preempt(req.uid)
        if getattr(self.engine, "host_tier_blocks", 0):
            self.metrics.observe_swap_preemption(swapped)
        self._live.pop(req.uid, None)
        req.state = RequestState.PREEMPTED
        req.preemptions += 1
        self.metrics.preemptions += 1
        self.metrics.preempted_blocks_reclaimed += freed
        logger.debug("serve: preempted uid %d (%s, freed %d blocks, %d "
                     "generated)", req.uid,
                     "swapped" if swapped else "flushed", freed,
                     len(req.tokens))
        # PREEMPTED -> QUEUED: original arrival time is kept, so the victim
        # carries its full age into re-admission scoring (anti-thrash)
        req.state = RequestState.QUEUED
        self._queue.append(req)

    def _expire_deadlines(self, now: float) -> None:
        for req in [r for r in self._queue
                    if r.deadline is not None and r.deadline <= now]:
            self.cancel(req.uid, reason="deadline")
            self.metrics.deadline_cancels += 1
        # live PREFILL/DECODE requests past their deadline are cancelled too
        # (blocks flushed) — finishing a missed SLA spends pool capacity the
        # queued requests behind it could use
        for req in [r for r in self._live.values()
                    if r.deadline is not None and r.deadline <= now]:
            self.cancel(req.uid, reason="deadline")
            self.metrics.deadline_cancels += 1
            # a stale _stalled flag after cancelling a mid-prefill request
            # self-heals: the drain put([], []) recomputes it from engine
            # state before the next admission

    def _admit(self, now: float) -> None:
        while self._queue and not self._stalled:
            arrived = [r for r in self._queue if r.arrival_time <= now]
            if not arrived:
                return
            if self.tenancy is not None:
                # weighted fair queueing (docs/SERVING.md "Multi-tenant
                # QoS"): serve the smallest finish tag. A flooding tenant
                # only stretches its OWN flow's tags — admitted shares
                # converge to the configured weights under saturation.
                # Ties (and rare untagged legacy adoptions, tag 0.0) break
                # on arrival then uid: deterministic (DSTPU005).
                best = min(arrived,
                           key=lambda r: (getattr(r, "_wfq_finish", 0.0),
                                          r.arrival_time, r.uid))
            else:
                best = max(arrived, key=lambda r: self._score(r, now))
            if (self.chunked_prefill and self._starved_prio is not None
                    and best.priority <= self._starved_prio):
                # a prefill at this priority or above is starved for
                # blocks: freed capacity must reach it first — admitting
                # now would let the candidate's replay re-grab (via the
                # prefix-cache lookup) the very blocks a relief preemption
                # just reclaimed, and the starved row would defer forever
                # (the admit↔preempt ping-pong). Cleared the moment the
                # backlog consumes a chunk again, or empties.
                return
            if not self.engine.can_schedule(1):
                # block-pool / slot pressure: a higher-priority arrival may
                # evict a lower-priority live request — but only one whose
                # admission score it also beats. The age term shields an
                # old request that just won admission from being bounced
                # straight back by the next fresh VIP (starvation freedom).
                if not self.preemption:
                    return
                victim = self._pick_victim(below_priority=best.priority)
                if victim is None or (self._score(victim, now)
                                      >= self._score(best, now)):
                    return
                self._preempt(victim)
                continue  # re-check capacity; may need more than one victim
            if self._swap_resident(best.uid):
                # a swap-preempted victim re-admits by block copy, but only
                # once its full at-rest footprint PLUS one growth block fit
                # — restoring into an exactly-full pool re-creates the very
                # pressure that evicted it (readmit→exhaust→preempt, no row
                # ever advancing). While live decodes are draining the pool
                # organically, hold the restore; if nothing is decoding (or
                # the footprint can never fit), fall through and let
                # _swap_in_readmit's gate drop the entry onto the replay
                # path, which allocates lazily and defers under pressure.
                mgr = self.engine.block_mgr
                need = mgr.blocks_needed(
                    len(best.prompt) + len(best.tokens)) + 1
                if (mgr.free_blocks < need
                        and need <= mgr.num_blocks - 1
                        and any(r.state is RequestState.DECODE
                                for r in self._live.values())):
                    return
            self._queue.remove(best)
            if self.tenancy is not None:
                # virtual time advances to the served start tag — the SFQ
                # service event that keeps idle flows from banking credit
                self.tenancy.on_service(getattr(best, "_wfq_start", 0.0))
            self._start(best, now)

    def _swap_resident(self, uid: int) -> bool:
        """True when ``uid``'s KV is parked in the engine's host swap
        store. Duck-typed on ``engine.swap_resident`` — and deliberately
        NOT gated on ``host_tier_blocks``: swap-preemption only populates
        the store with the tier on, but a disaggregated handoff
        (``import_swap``) parks KV on tier-less decode workers too, and
        both re-admit through the same ``_swap_in_readmit`` fast path."""
        fn = getattr(self.engine, "swap_resident", None)
        return fn is not None and fn(uid)

    def _swap_in_readmit(self, req: Request) -> bool:
        """Re-admit a swap-preempted victim by block copy: ``engine.swap_in``
        restores the at-rest KV (one batched device_put) and the request
        resumes decoding exactly where it left off — no replay dispatch at
        all. The transfer wall clock feeds the bandwidth EMA the cost model
        runs on (``swap_in``'s materialization is the designed host sync on
        this path, so measuring around it is honest). False — the entry died
        with a rebuild, or the pool can't hold the blocks right now — falls
        back to the normal replay admission; transients retry, a loss is
        recorded and the replay path surfaces it.

        Headroom gate: the restore is refused unless the pool holds the
        victim's at-rest blocks PLUS one to grow into. A swap-in that
        exactly fills the pool guarantees the next block-boundary crossing
        re-preempts someone before any row advances — the
        readmit→exhaust→preempt livelock. Replay has no such failure mode
        (chunked prefill allocates lazily and defers under pressure), so
        under that much pressure the entry is dropped and recompute wins
        regardless of what the byte-cost model says."""
        mgr = getattr(self.engine, "block_mgr", None)
        if mgr is not None:
            need = mgr.blocks_needed(len(req.prompt) + len(req.tokens))
            if mgr.free_blocks < need + 1:
                self._engine_flush(req.uid)  # drop the cached swap entry
                return False
        attempt = 0
        while True:
            try:
                t0 = time.perf_counter()
                ok = self.engine.swap_in(req.uid)
                break
            except UnrecoverableEngineError as e:
                self._note_engine_lost(e)
                return False
            except TransientEngineError as e:
                if not self._retry_transient("swap_in", attempt, e):
                    raise
                attempt += 1
        if not ok:
            return False
        dt = time.perf_counter() - t0
        nbytes = self._blocks_held(req.uid) * getattr(
            self.engine, "block_bytes", 0)
        if nbytes and dt > 0:
            spb = dt / nbytes
            self._swap_s_per_byte = (
                spb if self._swap_s_per_byte == 0.0
                else 0.5 * self._swap_s_per_byte + 0.5 * spb)
            self.metrics.observe_swap_readmit(dt, 1.0 / self._swap_s_per_byte)
        req.state = RequestState.DECODE
        logger.debug("serve: swap-in re-admitted uid %d (%d blocks, %.3fms)",
                     req.uid, self._blocks_held(req.uid), dt * 1e3)
        return True

    def _start(self, req: Request, now: float) -> None:
        req.state = RequestState.PREFILL
        if req.admitted_time is None:
            req.admitted_time = now
        self._live[req.uid] = req
        self.metrics.admitted += 1
        if req.tenant is not None:
            # attribute this sequence's KV blocks BEFORE the engine sees
            # the prompt: the prefix cache charges block ownership at
            # registration time (docs/SERVING.md "Multi-tenant QoS"), and
            # every (re-)admission path — fresh, replay, swap-in — funnels
            # through here first
            set_owner = getattr(self.engine, "set_kv_owner", None)
            if set_owner is not None:
                set_owner(req.uid, req.tenant)
            self.metrics.observe_tenant(req.tenant, "admitted")
        sp = req.sampling
        if sp is not None and sp.needs_engine:
            # (re-)register with the engine BEFORE any admission path:
            # flush/preempt/swap_out all dropped the engine's per-residency
            # sampling state, so every (re-)admission pushes it fresh —
            # including the swap-in fast path below, whose restored rows
            # must sample under this request's keys on the very next step
            self.engine.set_sampling(
                req.uid, sp,
                bias_row=combined_bias(sp, self.engine.cfg.vocab_size,
                                       req.replay_tokens()))
            self.metrics.observe_sampling_admit(sp)
        if self._swap_resident(req.uid) and self._swap_in_readmit(req):
            return  # resumed in place: next decode round feeds tokens[-1]
        if self.chunked_prefill:
            # register + prefix-cache lookup only (max_steps=0): the
            # prompt's chunks ride this step's mixed dispatch and onward —
            # admission never runs a foreign prompt's prefill to completion
            self._engine_put([req.uid], [req.replay_tokens()], max_steps=0)
            return
        out = self._engine_put([req.uid], [req.replay_tokens()])
        self._absorb(out, now)

    def _engine_put(self, uids: List[int], token_lists: List[List[int]],
                    max_steps: Optional[int] = None
                    ) -> Dict[int, np.ndarray]:
        """``engine.put`` with full fault handling.

        - pool pressure: on exhaustion, evict a strictly-lower-priority
          victim and retry (pending tokens already sit inside the engine, so
          the retry passes no new work). With no eligible victim the prefill
          stalls until live decodes complete and free blocks; if nothing is
          decoding either, the pool cannot hold this request at all and the
          error propagates.
        - transient faults: bounded backoff retry with the SAME arguments
          (the fault layer raises before the engine mutates state).
        - persistent per-request faults: quarantine the culpable uid and
          containment-preempt the rest (see :meth:`_contain`)."""
        # the priority the eviction check compares against: the request(s)
        # being prefilled — on a pure drain retry, the stalled PREFILL ones
        prios = [self._all[u].priority for u in uids] + [
            r.priority for r in self._live.values()
            if r.state is RequestState.PREFILL]
        prio = max(prios) if prios else None
        attempt = 0
        while True:
            try:
                t0 = time.perf_counter()
                kw = {"max_steps": max_steps} if self.engine.paged else {}
                out = self.engine.put(uids, token_lists,
                                      greedy=self.engine.paged, **kw)
                if max_steps != 0:
                    self._observe_engine_ok("prefill",
                                            time.perf_counter() - t0)
                # chunked mode: pending tokens inside the engine are the
                # normal mid-prefill case, never an admission-gating stall
                self._stalled = not self.chunked_prefill and any(
                    d.in_flight for d in self.engine.state.seqs.values())
                return out
            except TransientEngineError as e:
                if not self._retry_transient("put", attempt, e):
                    raise
                attempt += 1
            except RequestFailedError as e:
                self._contain(e.uid, e, self._clock())
                keep = [(u, t) for u, t in zip(uids, token_lists)
                        if u != e.uid]
                uids = [u for u, _ in keep]
                token_lists = [t for _, t in keep]
                if not uids:
                    return {}
            except PoolExhaustedError:
                if not self.preemption:
                    raise
                victim = self._pick_victim(below_priority=prio)
                if victim is None:
                    if any(r.state is RequestState.DECODE
                           for r in self._live.values()):
                        self._stalled = True  # wait for organic frees
                        return {}
                    if len(self._live) > 1:
                        # nothing decoding, nothing lower-priority: break the
                        # equal-priority deadlock by evicting unconditionally
                        victim = self._pick_victim()
                if victim is None:
                    raise  # the pool cannot hold even this one request
                self._preempt(victim)
                uids, token_lists = [], []  # drain engine-held pending

    def _emit_token(self, req: Request, tok: int, now: float) -> bool:
        """Deliver one kept token; True when it finishes the request
        (max_new_tokens reached, EOS, or a stop sequence completed — the
        matching tokens ARE emitted, like ``eos_token``)."""
        if req.first_token_time is None:
            req.first_token_time = now
            self.metrics.ttft_s.append(now - req.arrival_time)
        req.state = RequestState.DECODE
        sp = req.sampling
        scan = None
        if sp is not None and sp.stop:
            scan = self._stop_scanners.get(req.uid)
            if scan is None:
                # built lazily from the PRE-emit committed history, so a
                # re-admitted / migrated / replayed request reconstructs
                # the exact tail state its tokens imply — a stop match
                # spanning a preemption boundary still fires
                scan = StopScanner(sp.stop, history=req.tokens)
                self._stop_scanners[req.uid] = scan
        req._emit(tok)
        # commit point: the journal's committed-token record extends by this
        # token, so a later engine loss replays exactly the emitted history
        self.journal.commit(req)
        self.metrics.tokens_generated += 1
        stop_hit = scan is not None and scan.push(tok) > 0
        if stop_hit:
            self.metrics.observe_stop_hit()
        finished = (req.remaining == 0 or stop_hit
                    or (req.eos_token is not None and tok == req.eos_token))
        if sp is not None:
            if not sp.is_greedy:
                self.metrics.observe_sampled_token()
            if sp.dynamic and not finished:
                # dynamic logit processors re-mask per committed token; the
                # horizon is collapsed to 1 for them, so the refreshed row
                # lands before the next dispatch samples this request
                self.engine.refresh_bias(
                    req.uid, combined_bias(sp, self.engine.cfg.vocab_size,
                                           req.replay_tokens()))
                self.metrics.observe_bias_refresh()
        return finished

    def _absorb(self, out: Dict[int, np.ndarray], now: float) -> None:
        for uid, val in out.items():
            req = self._live.get(uid)
            if req is None:  # cancelled between dispatch and absorb
                self._engine_flush(uid)
                continue
            tok = int(val) if self.engine.paged else int(np.argmax(val))
            if self._emit_token(req, tok, now):
                self._finish(req, now)

    def _absorb_multi(self, out: Dict[int, List[int]],
                      now: float,
                      spans: Optional[Dict[int, int]] = None) -> int:
        """Absorb a fused dispatch: emit each row's tokens in order until a
        stop condition (max_new_tokens / EOS) fires, then ROLL BACK the
        overrun tokens — ``engine.rollback`` truncates ``seen_tokens`` and
        history, frees the over-allocated blocks, and registers only the
        kept tokens' full blocks in the prefix index. The rollback runs
        BEFORE the finishing flush so the content index never covers
        discarded tokens; for surviving requests ``rollback(uid, 0)`` is the
        registration commit the single-step path does inline.

        ``spans`` generalizes the fused case to speculative verification:
        per uid, how many cache positions the dispatch actually advanced.
        A fused row advanced ``len(toks)``; a verified row advanced the
        full horizon K while emitting only the accepted prefix + bonus
        token, so its rollback covers rejected drafts AND pad positions.
        Returns the total rolled-back token count."""
        total_overrun = 0
        for uid, toks in out.items():
            req = self._live.get(uid)
            if req is None:  # cancelled between dispatch and absorb
                self._engine_flush(uid)
                continue
            kept = 0
            finished = False
            for tok in toks:
                kept += 1
                if self._emit_token(req, tok, now):
                    finished = True
                    break
            span = len(toks) if spans is None else spans[uid]
            overrun = span - kept
            if overrun:
                self.metrics.observe_rollback(overrun)
                total_overrun += overrun
            self.engine.rollback(uid, overrun)
            if finished:
                self._finish(req, now)
        return total_overrun

    def _finish(self, req: Request, now: float) -> None:
        self._engine_flush(req.uid)
        self._live.pop(req.uid, None)
        self._stop_scanners.pop(req.uid, None)
        req.state = RequestState.DONE
        req.finish_time = now
        self.journal.resolve(req.uid)
        self._release_tenant(req, "completed")
        self.metrics.completed += 1
        if self.spec is not None:
            self.spec.forget(req.uid)

    def _prefill_backlog(self) -> int:
        """Pending prompt tokens registered with the engine but not yet
        dispatched (the chunked-prefill backlog)."""
        if not getattr(self.engine, "paged", False):
            return 0
        return self.engine.prefill_backlog()

    def prefill_backlog_tokens(self) -> int:
        """Public gauge for the router and pool health: tokens admitted into
        the engine but not yet prefilled. Load-bearing for placement — an
        admitted long prompt is committed work ``live_count`` cannot see
        until its first token lands."""
        if self._engine_dead is not None:
            return 0
        return self._prefill_backlog()

    def _effective_horizon(self, now: float, feed: Dict[int, int]) -> int:
        """The horizon this decode round actually runs at. Collapses to 1 —
        single-step decode, unchanged TTFT/SLA behavior — whenever:

        - a stalled monolithic prefill is draining,
        - (monolithic mode) admissions are queued — a K-step dispatch would
          delay the arrival's whole-prompt prefill by K token times,
        - a live request has fewer than K tokens remaining (don't generate
          guaranteed overrun) or fewer than K context positions left,
        - a live deadline falls inside the horizon's wall-clock budget
          (K × the EMA per-token dispatch time) — the fused step must not
          blow through an SLA the single-step loop would have honored.

        Under chunked interleaved prefill a pending backlog no longer
        hard-collapses the horizon: fused decode and prefill-serving mixed
        dispatches ALTERNATE (at most one fused dispatch per dispatch that
        consumed prompt tokens), so steady decode traffic keeps ~K/2 of the
        fused amortization while the prefilling request's TTFT stays
        O(chunk) at merely twice the all-prefill pace — the trade the
        monolithic path couldn't make. Queued arrivals stop costing a
        collapse too: admission is registration-only and its chunks enter
        the same duty cycle next step.
        """
        K = self.decode_horizon
        if K <= 1 or not getattr(self.engine, "paged", False):
            return 1
        if self._stalled:
            return 1
        if self.chunked_prefill:
            if self._prefill_backlog() and self._fused_since_prefill >= 1:
                return 1
        elif any(r.arrival_time <= now for r in self._queue):
            return 1
        for uid in feed:
            req = self._live[uid]
            if req.remaining < K:
                return 1
            if req.sampling is not None and req.sampling.dynamic:
                # a dynamic logit processor re-masks after every committed
                # token, and a K-step on-device scan cannot re-enter the
                # host mid-loop — single-step is the correctness price
                return 1
            d = self.engine.state.seqs.get(uid)
            if d is not None and d.seen_tokens + K > self.engine.max_seq_len:
                return 1
        budget = K * self._token_est_s
        for r in self._live.values():
            if r.deadline is not None and r.deadline - now < budget:
                return 1
        return K  # speculation (when configured) rides exactly this branch:
        # a verify dispatch advances the same K cache positions a fused
        # dispatch does, so every collapse condition above applies to both

    def _collect_drafts(self, feed: Dict[int, int]) -> Dict[int, List[int]]:
        """Drafts for one full-horizon round: each fed request's committed
        context (prompt + emitted tokens, ending in the token about to be
        fed) goes to the proposer with its EMA-adapted budget (≤ K−1).
        Empty dict = nothing draftable this round — run the plain fused
        path and count a degraded step."""
        return self.spec.collect(
            list(feed),
            lambda uid: self._live[uid].prompt + self._live[uid].tokens,
            self.decode_horizon - 1)

    def _decode_once(self, now: float) -> None:
        """One decode iteration. ``pipelined=False``: the synchronous loop —
        plan, dispatch, wait, absorb, all in this call
        (:meth:`_decode_sync`). ``pipelined=True``: the plan/dispatch/absorb
        stages run with ONE step in flight — this call fetches the previous
        round, plans and dispatches the next from its tokens, and only then
        absorbs the fetched round (:meth:`_pipeline_dispatch_stage` +
        :meth:`_pipeline_absorb_stage`), so the device executes round N+1
        through the whole host phase of round N."""
        if self.pipelined:
            staged = self._pipeline_dispatch_stage(now)
            if staged is not None:
                self._pipeline_absorb_stage(staged, now)
            return
        self._decode_sync(now)

    def _decode_sync(self, now: float) -> None:
        """One engine dispatch: the live decode feed plus — under chunked
        interleaved prefill — as many pending prefill-chunk rows as the
        token budget holds, in ONE compiled ragged program. Pure decode
        rounds (no backlog) keep the dedicated ``decode_step``/fused paths
        bitwise-unchanged. With a :class:`DraftProposer` configured,
        full-horizon rounds become speculative: drafts are verified in ONE
        ``verify_multi`` dispatch and the accepted prefix (+1 bonus token)
        is committed, the rest rolled back — the same all-or-nothing
        K-position shape as the fused path, so retries, containment, and
        the duty cycle treat both identically."""
        backlog = self._prefill_backlog() if self.chunked_prefill else 0
        if not backlog:
            # no pending prompt tokens: nothing is starved, and the fused
            # duty cycle re-arms (must happen even when this round has no
            # feed either — a stale starvation flag would gate admission
            # of an empty system forever)
            self._starved_prio = None
            self._fused_since_prefill = 0
        if self.chunked_prefill:
            # a fed token deferred by a trimmed dispatch (pool pressure, or
            # a fault raised after enqueue) still sits in the engine's
            # pending queue — refeeding it would double-advance the request
            feed = {}
            for uid, r in self._live.items():
                if r.state is not RequestState.DECODE:
                    continue
                d = self.engine.state.seqs.get(uid)
                if d is not None and d.in_flight == 0:
                    feed[uid] = r.tokens[-1]
        else:
            feed = {uid: r.tokens[-1] for uid, r in self._live.items()
                    if r.state is RequestState.DECODE}
        if not feed and not backlog:
            return
        horizon = self._effective_horizon(now, feed) if feed else 1
        # drafts are collected ONCE, outside the retry loop: an injected
        # fault retries the verify dispatch with the SAME drafts, so the
        # retried step is verbatim (chaos parity)
        drafts: Optional[Dict[int, List[int]]] = None
        if horizon > 1 and self.spec is not None:
            drafts = self._collect_drafts(feed)
            if not drafts:
                self.metrics.observe_spec_degraded()
        attempt = 0
        while True:
            t0 = time.perf_counter()
            try:
                if drafts:
                    out = self.engine.verify_multi(feed, drafts)
                elif horizon > 1:
                    out = self.engine.decode_multi(feed, horizon=horizon)
                elif backlog:
                    # the mixed chunked-prefill dispatch: decode rows first
                    # (the engine's shortest-pending-first order), prompt
                    # chunks filling the rest of the token budget
                    uids = list(feed)
                    out = self.engine.put(uids, [[feed[u]] for u in uids],
                                          greedy=True, max_steps=1)
                else:
                    out = self.engine.decode_step(feed, greedy=True)
                break
            except TransientEngineError as e:
                site = "verify_multi" if drafts else "decode_step"
                if not self._retry_transient(site, attempt, e):
                    raise
                attempt += 1
            except (RequestFailedError, ContextOverflowError) as e:
                # persistent and attributable: quarantine the culpable
                # request, containment-preempt the rest, retry next step
                if e.uid is None or e.uid not in self._all:
                    raise
                self._contain(e.uid, e, now)
                return
            except PoolExhaustedError:
                if not self.preemption:
                    raise
                if self.chunked_prefill:
                    # nothing was dispatchable: any pending prefill is
                    # starved — route reclaimed capacity to it (see
                    # _relieve_prefill_pressure / _admit)
                    self._starved_prio = max(
                        (r.priority for r in self._live.values()
                         if r.state is RequestState.PREFILL), default=None)
                # decode-time pool pressure: SOMEONE must yield or no
                # sequence can progress (and nothing would ever free) —
                # eviction here is unconditional on priority, lowest first.
                # Exception: a sole mid-prefill resident would just replay
                # into the same wall (its replay needs at least the same
                # blocks) — propagate, the pool cannot hold the request
                victim = self._pick_victim()
                if victim is None or (
                        len(self._live) == 1
                        and victim.state is RequestState.PREFILL):
                    raise
                self._preempt(victim)
                return  # retry next step with the shrunken batch
        dt = time.perf_counter() - t0
        kind = "decode" if not backlog else ("mixed" if feed else "prefill")
        self._observe_engine_ok(kind, dt, scale=horizon)
        if feed:
            self.metrics.observe_step(dt, len(feed), horizon=horizon)
            self.metrics.observe_decode(horizon, fused=horizon > 1)
            per_tok = dt / horizon
            self._token_est_s = (per_tok if self._token_est_s == 0.0
                                 else 0.5 * self._token_est_s + 0.5 * per_tok)
        if backlog:
            # chunked-prefill accounting + the fused/prefill duty cycle:
            # a dispatch that consumed prompt tokens re-arms one fused
            # dispatch; one that couldn't (rows trimmed under pool
            # pressure) applies admission-style preemption pressure so a
            # lower-priority resident can't starve a prefilling request
            consumed = max(0, backlog - self._prefill_backlog())
            if consumed:
                self.metrics.observe_prefill_chunk(consumed,
                                                   interleaved=bool(feed))
                self._fused_since_prefill = 0
                self._starved_prio = None
            elif horizon > 1:
                self._fused_since_prefill += 1
            else:
                self.metrics.observe_prefill_deferred()
                self._relieve_prefill_pressure(now)
        if drafts:
            self._absorb_speculation(out, drafts, now)
        elif horizon > 1:
            self._absorb_multi(out, now)
        else:
            self._absorb(out, now)

    # ------------------------------------------------------------------
    # pipelined dispatch (docs/SERVING.md "Pipelined dispatch")
    # ------------------------------------------------------------------
    def _pipeline_barrier(self, now: float, feed: Dict[int, int],
                          backlog: int) -> bool:
        """True when THIS round cannot run with a step in flight and must
        take the synchronous path (after draining the pipe):

        - a chunked-prefill backlog: prompt chunks ride the mixed ragged
          dispatch, whose host sync is inherent;
        - a stalled monolithic prefill draining;
        - speculation configured, or the adaptive horizon choosing a fused
          round: both commit/rollback against their absorb the SAME step;
        - a fed request with a dynamic logit processor: its bias row must
          be refreshed from the absorbed token BEFORE the next dispatch
          samples it — a one-late absorb would sample under a stale mask.
        """
        if backlog or self._stalled or self.spec is not None:
            return True
        if feed and self._effective_horizon(now, feed) > 1:
            return True
        for uid in feed:
            sp = self._live[uid].sampling
            if sp is not None and sp.dynamic:
                return True
        return False

    def _pipeline_dispatch_stage(self, now: float
                                 ) -> Optional[Dict[str, object]]:
        """PLAN + DISPATCH with one step in flight. Fetches the previous
        round's tokens (the deferred host sync — by now the device had the
        whole intervening host phase to run), plans the next feed from
        them, dispatches it, and returns the fetched round staged for
        :meth:`_pipeline_absorb_stage` — which runs while the new dispatch
        executes. Returns None when the round took the synchronous path
        (pipeline barrier) or there was nothing to fetch."""
        t_plan0 = time.perf_counter()
        backlog = self._prefill_backlog() if self.chunked_prefill else 0
        if not backlog:
            # same re-arm rule as the synchronous loop (see _decode_sync)
            self._starved_prio = None
            self._fused_since_prefill = 0
        # candidate decode rows, the sync twin's feed-build rule: a token
        # deferred inside the engine (in_flight) is never double-fed
        cands: Dict[int, int] = {}
        for uid, r in self._live.items():
            if r.state is not RequestState.DECODE:
                continue
            d = self.engine.state.seqs.get(uid)
            if d is not None and d.in_flight == 0:
                cands[uid] = r.tokens[-1]
        if self._pipeline_barrier(now, cands, backlog):
            if self._inflight is not None:
                self.metrics.observe_pipeline_stall()
                self._drain_inflight(now)
            self._decode_sync(now)
            return None
        prev = self._inflight
        raw: Optional[Dict[int, int]] = None
        wait_dt = 0.0
        if prev is not None:
            t_wait0 = time.perf_counter()
            try:
                raw = prev["handle"].fetch()
            except UnrecoverableEngineError:
                # the round died with the device: nothing of it was
                # absorbed, so journal replay regenerates its tokens
                # bitwise from the last committed state
                self._inflight = None
                raise
            wait_dt = time.perf_counter() - t_wait0
        if not cands and prev is None:
            return None
        # plan the next feed. Rows riding the fetched round are fed their
        # brand-new token; predicted finishes (EOS / max_new_tokens —
        # decidable from the raw token alone) are NOT fed. Stop-sequence
        # finishes are NOT predicted (the scan is stateful): those rows
        # are fed speculatively and the successor token rolled back at
        # absorb — the speculative-absorb rule.
        next_feed: Dict[int, int] = {}
        for uid, last_tok in cands.items():
            r = self._live[uid]
            if prev is not None and raw is not None and uid in prev["rows"]:
                rec_req, rec_desc, rec_emitted = prev["rows"][uid]
                if (r is rec_req and len(r.tokens) == rec_emitted
                        and self.engine.state.seqs.get(uid) is rec_desc):
                    tok = raw[uid]
                    if (len(r.tokens) + 1 >= r.max_new_tokens
                            or (r.eos_token is not None
                                and tok == r.eos_token)):
                        continue  # finishes at absorb: never fed
                    next_feed[uid] = tok
                    continue
                # stale row (preempted/re-admitted since dispatch): its
                # in-flight token is discarded at absorb; feeding the
                # committed last token regenerates it bitwise
            next_feed[uid] = last_tok
        plan_dt = time.perf_counter() - t_plan0 - wait_dt
        handle = None
        enqueue_dt = 0.0
        if next_feed:
            attempt = 0
            while True:
                t0 = time.perf_counter()
                try:
                    handle = self.engine.decode_dispatch(next_feed)
                    enqueue_dt = time.perf_counter() - t0
                    break
                except TransientEngineError as e:
                    if not self._retry_transient("decode_step", attempt, e):
                        raise
                    attempt += 1
                except (RequestFailedError, ContextOverflowError) as e:
                    if e.uid is None or e.uid not in self._all:
                        raise
                    self._contain(e.uid, e, now)
                    break  # absorb the fetched round below (stale rows skip)
                except PoolExhaustedError:
                    if not self.preemption:
                        raise
                    if prev is not None:
                        # fed rows still carry the fetched round's
                        # provisional position, so swap_out would decline
                        # every victim: let the pipe run dry, absorb (and
                        # commit) below, and re-plan next step against
                        # at-rest rows — preempting there keeps the
                        # swap-vs-recompute economics of the sync twin
                        break
                    victim = self._pick_victim()
                    if victim is None or (
                            len(self._live) == 1
                            and victim.state is RequestState.PREFILL):
                        raise
                    self._preempt(victim)
                    break  # the pipe restarts next step, smaller batch
        if handle is not None:
            self._inflight = {
                "handle": handle,
                "rows": {uid: (self._live[uid],
                               self.engine.state.seqs.get(uid),
                               len(self._live[uid].tokens))
                         for uid in handle.uids},
                "enqueue_dt": enqueue_dt,
            }
            self.metrics.observe_pipeline_dispatch(len(handle.uids))
        else:
            self._inflight = None
            if next_feed:
                self.metrics.observe_pipeline_stall()  # pipe ran dry
        if prev is None or raw is None:
            return None
        return {"prev": prev, "raw": raw, "wait_dt": wait_dt,
                "plan_dt": plan_dt}

    def _pipeline_absorb_stage(self, staged: Dict[str, object],
                               now: float) -> None:
        """ABSORB one fetched round — one step late. Runs while the
        successor dispatch executes on device. Per row: emit the token
        (the journal's one commit point — in-flight tokens are never
        journaled), then settle the engine's provisional positions via
        ``commit_step``: a surviving row retains its successor's in-flight
        position; a finishing row detected HERE (a stop sequence — the
        speculative miss) drops the successor position it was speculatively
        fed, counted as a speculative rollback; stale rows (preempted /
        re-admitted / cancelled since dispatch) are skipped — their tokens
        regenerate bitwise from committed state on replay."""
        prev, raw = staged["prev"], staged["raw"]
        cur = self._inflight
        t0 = time.perf_counter()
        absorbed = 0
        for uid, (req, desc, emitted) in prev["rows"].items():
            r = self._live.get(uid)
            if r is None:  # cancelled between dispatch and absorb
                self._engine_flush(uid)
                continue
            if (r is not req or r.state is not RequestState.DECODE
                    or len(r.tokens) != emitted
                    or self.engine.state.seqs.get(uid) is not desc):
                continue  # stale: the in-flight token is discarded
            finished = self._emit_token(r, raw[uid], now)
            absorbed += 1
            drop = 0
            retain = 0
            if cur is not None and uid in cur["rows"]:
                if finished:
                    drop = 1
                    del cur["rows"][uid]
                    self.metrics.observe_pipeline_rollback(1)
                else:
                    retain = 1
                    # the successor round snapshotted this row BEFORE the
                    # emit above; refresh its expected-emitted count so the
                    # next absorb's staleness check sees the new length
                    c_req, c_desc, _ = cur["rows"][uid]
                    cur["rows"][uid] = (c_req, c_desc, len(r.tokens))
            self._engine_commit(uid, drop, retain)
            if finished:
                self._finish(r, now)
        absorb_dt = time.perf_counter() - t0
        dt = prev["enqueue_dt"] + staged["wait_dt"]
        self._observe_engine_ok("decode", dt, scale=1.0)
        if absorbed:
            self.metrics.observe_step(
                dt, absorbed, horizon=1, plan_s=staged["plan_dt"],
                wait_s=staged["wait_dt"], absorb_s=absorb_dt)
            self.metrics.observe_decode(1, fused=False)
            self._token_est_s = (dt if self._token_est_s == 0.0
                                 else 0.5 * self._token_est_s + 0.5 * dt)
        self.metrics.observe_pipeline_in_flight(
            len(cur["rows"]) if cur is not None else 0)

    def _drain_inflight(self, now: float) -> None:
        """Drain boundary: fetch and absorb the in-flight round NOW. Every
        synchronous-path interaction (mixed prefill dispatch, fused or
        speculative rounds, migration detach, close) runs against an
        at-rest engine — the TransferEngine drain-at-boundary discipline."""
        prev = self._inflight
        if prev is None:
            return
        t0 = time.perf_counter()
        try:
            raw = prev["handle"].fetch()
        except UnrecoverableEngineError:
            self._inflight = None
            raise
        wait_dt = time.perf_counter() - t0
        self._inflight = None
        self._pipeline_absorb_stage(
            {"prev": prev, "raw": raw, "wait_dt": wait_dt, "plan_dt": 0.0},
            now)

    def _engine_commit(self, uid: int, drop: int, retain: int) -> None:
        """``engine.commit_step`` with the flush/preempt fault contract: an
        engine loss is absorbed (the positions died with the pool; the
        next step recovers), transients retry with the same arguments."""
        attempt = 0
        while True:
            try:
                self.engine.commit_step(uid, drop, retain)
                return
            except UnrecoverableEngineError as e:
                self._note_engine_lost(e)
                return
            except TransientEngineError as e:
                if not self._retry_transient("flush", attempt, e):
                    raise
                attempt += 1

    def _inflight_ledger(self) -> Dict[int, int]:
        """The declared in-flight provisional spans, ``{uid: tokens}`` —
        what the sanitizers are told to expect in ``uncommitted``."""
        if self._inflight is None:
            return {}
        return {uid: self._inflight["handle"].span
                for uid in self._inflight["rows"]}

    def _absorb_speculation(self, out: Dict[int, List[int]],
                            drafts: Dict[int, List[int]],
                            now: float) -> None:
        """Acceptance math for one verified dispatch (docs/SERVING.md):
        per row, ``m`` = longest prefix of the draft matching the target's
        per-position argmax; emit the first ``m`` (accepted) verifier
        tokens plus the one FREE token the verifier produced at the first
        mismatch — identical to what sequential greedy decode would have
        emitted, which is the whole bitwise story. The cache advanced the
        full horizon K for every row, so the rollback span is K regardless
        of draft length (rejected tail + pad positions)."""
        K = self.decode_horizon
        accepted_out: Dict[int, List[int]] = {}
        spans: Dict[int, int] = {}
        proposed = accepted = 0
        for uid, g in out.items():
            ds = drafts.get(uid, [])
            m = 0
            while m < len(ds) and int(ds[m]) == int(g[m]):
                m += 1
            accepted_out[uid] = g[:m + 1]
            spans[uid] = K
            proposed += len(ds)
            accepted += m
            if ds:
                self.spec.observe(uid, len(ds), m)
        rollback = self._absorb_multi(accepted_out, now, spans=spans)
        self.metrics.observe_speculation(
            proposed, accepted, bonus=len(out), rollback=rollback,
            mean_draft=(sum(len(d) for d in drafts.values())
                        / max(1, len(drafts))))

    def _relieve_prefill_pressure(self, now: float) -> None:
        """A mixed dispatch under pool pressure served its decode rows but
        deferred every prefill chunk. Decodes free blocks as they finish,
        so the backlog is not wedged — but a strictly-lower-priority
        resident should not make a prefilling request wait for organic
        frees: evict one (the same priority test admission-time eviction
        applies), and record the starved priority so _admit routes the
        reclaimed capacity to the starved prefill instead of a re-admitted
        victim."""
        prio = max((r.priority for r in self._live.values()
                    if r.state is RequestState.PREFILL), default=None)
        self._starved_prio = prio
        if prio is None or not self.preemption:
            return
        victim = self._pick_victim(below_priority=prio)
        if victim is not None:
            self._preempt(victim)

    # ------------------------------------------------------------------
    # driving surface
    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One scheduler iteration: poll the breaker, expire deadlines,
        admit (registration-only under chunked prefill), drain stalled
        monolithic prefills, then run ONE engine dispatch — mixed
        decode+prefill-chunk rows when a backlog is pending. Returns True
        while work remains.

        Internally ``step()`` is the two-phase drive run back to back:
        :meth:`step_dispatch` then :meth:`step_absorb`. A pool calls the
        phases separately across its replicas (dispatch-all, then
        absorb-all) so N devices execute concurrently instead of
        serializing behind each other's host phases.

        Engine-loss wrapper (docs/RESILIENCE.md): an
        :class:`UnrecoverableEngineError` from any engine-touching phase —
        or one recorded earlier on a teardown path — routes to
        :meth:`_recover` instead of propagating; the step ends after the
        rebuild and the replay proceeds from the next step's normal
        admission."""
        self.step_dispatch()
        return self.step_absorb()

    def step_dispatch(self) -> None:
        """Pool phase 1 (docs/SERVING.md "Pipelined dispatch"): admission +
        plan + dispatch WITHOUT waiting on the device, so a pool can start
        every replica's round before absorbing any. A synchronous scheduler
        waits on the device inside its one dispatch call, so for it phase 1
        is a no-op and the whole classic step runs in :meth:`step_absorb` —
        the two-phase drive degrades to the sequential loop, byte for
        byte."""
        if not self.pipelined:
            return
        now = self._clock()
        if self._engine_dead is not None:
            exc, self._engine_dead = self._engine_dead, None
            if self.escalate_losses:
                raise exc
            self._recover(exc, now)
            now = self._clock()
        self.breaker.poll(now)
        self._expire_deadlines(now)
        try:
            self._admit(now)
            if self._stalled:
                self._absorb(self._engine_put([], []), now)
            self._pending_absorb = self._pipeline_dispatch_stage(now)
        except UnrecoverableEngineError as e:
            self._inflight = None
            self._pending_absorb = None
            if self.escalate_losses:
                raise
            self._recover(e, now)

    def step_absorb(self) -> bool:
        """Pool phase 2: absorb what :meth:`step_dispatch` staged — while
        the successor round executes on device — or, for a synchronous
        scheduler, run the whole classic step; then close the step with
        gauges, sanitizers, and the work-remaining verdict."""
        now = self._clock()
        if self.pipelined:
            staged, self._pending_absorb = self._pending_absorb, None
            try:
                if staged is not None:
                    self._pipeline_absorb_stage(staged, now)
            except UnrecoverableEngineError as e:
                self._inflight = None
                if self.escalate_losses:
                    raise
                self._recover(e, now)
            self._step_postamble()
            return bool(self._queue or self._live
                        or self._inflight is not None)
        if self._engine_dead is not None:
            exc, self._engine_dead = self._engine_dead, None
            if self.escalate_losses:
                raise exc
            self._recover(exc, now)
            now = self._clock()
        self.breaker.poll(now)
        self._expire_deadlines(now)
        try:
            self._admit(now)
            if self._stalled:
                self._absorb(self._engine_put([], []), now)
            self._decode_once(now)
        except UnrecoverableEngineError as e:
            if self.escalate_losses:
                # pool mode (docs/SERVING.md): the loss is the POOL's to
                # absorb — survivors adopt this replica's journal instead
                # of an in-place rebuild. Host state is left intact for
                # the pool's detach sweep.
                raise
            self._recover(e, now)
        self._step_postamble()
        return bool(self._queue or self._live)

    def _step_postamble(self) -> None:
        """End-of-step bookkeeping shared by both drive modes: gauges and
        (under ``DSTPU_SANITIZE``) the between-steps invariant sweep."""
        self.metrics.observe_gauges(len(self._queue), len(self._live))
        self.metrics.observe_prefill_backlog(self._prefill_backlog())
        self.metrics.observe_resilience(self.breaker, self.watchdog)
        self.metrics.faults["journal_live"] = float(len(self.journal))
        if getattr(self.engine, "host_tier_blocks", 0):
            self.metrics.observe_kvtier(self.engine.prefix_cache_stats())
        if _sanitizer.sanitize_enabled():
            # checked mode (docs/ANALYSIS.md): between steps, every pending
            # backlog row must belong to a live request and every live
            # PREFILL request must still have work in the engine
            _sanitizer.check_prefill_ownership(self.engine, self._live)
            # and every speculative dispatch must have been committed or
            # rolled back — uncommitted draft positions crossing a step
            # boundary would let the prefix index cover unverified tokens.
            # Pipelined mode declares its ONE in-flight round's spans; any
            # uncommitted position beyond the declaration still trips.
            ledger = self._inflight_ledger()
            _sanitizer.check_speculation_commit(self.engine,
                                                inflight=ledger or None)
            # with a host tier: every block in exactly one tier state, and
            # demoted index entries must resolve through the host tier
            _sanitizer.check_tier_conservation(self.engine)
            if self.pipelined:
                _sanitizer.check_pipeline_coherence(
                    self.engine, self.journal, self._live, ledger,
                    dispatch_uids=(self._inflight["handle"].uids
                                   if self._inflight is not None else None))

    def run_until_complete(self) -> None:
        while self.step():
            pass

    def stream(self, req: Request) -> Iterator[int]:
        """Yield ``req``'s tokens as they are generated, driving the loop.
        A quarantined request unblocks its consumer by re-raising the fault
        that failed it (after yielding every token generated before it) —
        and so does a request cancelled *during engine-loss recovery*
        (deadline expired mid-rebuild): its typed ``RequestFailedError``
        re-raises the same way, so the consumer sees a reason, never a
        silently truncated stream and never a hang. A request that merely
        rides through a recovery sees a pause, not an error."""
        while True:
            for tok in req.new_tokens():
                yield tok
            if req.finished:
                if req.error is not None:
                    raise req.error
                return
            self.step()

    def close(self) -> None:
        """Graceful drain: reject new admits, cancel never-admitted queued
        requests, finish everything that was started — including preempted
        requests waiting in the queue for re-admission — then block on
        outstanding device work (transfer discipline: exiting with transfers
        queued is the r4 wedge). With ``watchdog.drain_budget_s`` set the
        drain is bounded: past the budget, stragglers are cancelled
        (``reason="drain_timeout"``, counted in ``drain_aborts``) so a sick
        engine cannot hang shutdown forever."""
        if self._closed:
            return
        self._closed = True
        for req in list(self._queue):
            if req.admitted_time is None:
                self.cancel(req.uid, reason="drain")
        budget = self.watchdog.drain_budget_s
        deadline = None if budget is None else time.perf_counter() + budget
        while self._live or self._queue or self._inflight is not None:
            self.step()
            if deadline is not None and time.perf_counter() > deadline and (
                    self._live or self._queue):
                self.metrics.faults["drain_aborts"] += 1
                logger.warning(
                    "serve: drain budget %.3fs exceeded; cancelling %d live "
                    "+ %d queued stragglers", budget, len(self._live),
                    len(self._queue))
                for uid in list(self._live):
                    self.cancel(uid, reason="drain_timeout")
                for req in list(self._queue):
                    self.cancel(req.uid, reason="drain_timeout")
                break
        # a bounded-drain abort may leave a round in flight with every row
        # cancelled — discard it; the synchronize settles the device
        self._inflight = None
        self._pending_absorb = None
        device = getattr(self.engine, "device", None)
        if isinstance(device, torch.device) and device.type == "cuda":
            torch.cuda.synchronize(device)
        if _sanitizer.sanitize_enabled():
            # checked mode: a drained engine must hold zero sequences and
            # zero block references — a leak here is a scheduler bug that
            # would otherwise surface as slow pool starvation in prod
            _sanitizer.check_drained(self.engine)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def live_count(self) -> int:
        return len(self._live)

    def next_arrival(self) -> Optional[float]:
        """Earliest arrival time among queued requests (load generators use
        this to fast-forward a simulated clock through idle gaps)."""
        return min((r.arrival_time for r in self._queue), default=None)

    def monitor_events(self, step: int = 0) -> List[Event]:
        """Serving counters (``serve/*`` and ``serve/faults/*``) plus the
        engine's prefix-cache counters as one event list for
        ``MonitorMaster.write_events``. With a ``replica_id`` the engine's
        events are replica-prefixed too (``replica<id>/inference/...``):
        the engine doesn't know its pool membership, and N unlabeled
        prefix-cache series would alias exactly like the serve counters
        the ``ServeMetrics`` label fixes."""
        eng = self.engine.monitor_events(step)
        if self.replica_id is not None:
            eng = [(f"replica{self.replica_id}/{label}", v, s)
                   for label, v, s in eng]
        return self.metrics.events(step) + eng
