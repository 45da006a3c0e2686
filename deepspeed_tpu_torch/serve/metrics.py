"""Serving metrics surface.

A copy of ``deepspeed_tpu/serve/metrics.py`` for the port, which imports nothing
of the JAX package; the text below is the JAX module's.

Counters and latency distributions the scheduler maintains per step, exported
as ``(label, value, step)`` events under the ``serve/`` prefix so they fan
into ``deepspeed_tpu.monitor.MonitorMaster.write_events`` alongside the
engine's ``inference/prefix_cache/*`` counters — one dashboard for the whole
serving path.

Decode-step latencies are wall-clock (``time.perf_counter``) even when the
scheduler runs on a virtual clock; TTFT is ``first_token - arrival`` in the
scheduler's clock domain, so simulated arrival processes report meaningful
queueing delay.
"""

from typing import Dict, List, Optional, Tuple

import numpy as np

Event = Tuple[str, float, int]


class ServeMetrics:
    """Aggregated serving counters + latency samples.

    ``replica_id`` is the pool-membership label (docs/SERVING.md engine
    pool): when set, every event label is emitted under
    ``serve/replica<id>/...`` instead of ``serve/...`` so N replicas'
    counters never alias in one ``MonitorMaster.write_events`` stream —
    replica 0's ``tokens_generated`` and replica 1's stay separate series.
    ``None`` (the single-engine default) keeps the historical labels
    byte-identical."""

    def __init__(self, replica_id: Optional[int] = None):
        self.replica_id = replica_id
        self.submitted = 0
        self.admitted = 0
        self.completed = 0
        self.cancelled = 0
        self.failed = 0              # terminal FAILED (quarantined requests)
        self.preemptions = 0
        self.preempted_blocks_reclaimed = 0
        self.admission_rejects = 0   # bounded-queue backpressure
        self.deadline_cancels = 0    # expired while QUEUED
        #: migration seam traffic (docs/SERVING.md engine pool): requests
        #: handed off to another scheduler / received from one
        self.detaches = 0
        self.adopts = 0
        self.tokens_generated = 0
        self.queue_depth = 0         # gauge, refreshed each step
        self.live = 0                # gauge, refreshed each step
        self.queue_peak = 0
        self.ttft_s: List[float] = []        # admission-arrival -> first token
        self.step_lat_s: List[float] = []    # decode-dispatch wall time
        self.step_batch: List[int] = []      # decode-dispatch batch × horizon
        #: fused multi-token decode counters (docs/SERVING.md), exported
        #: under ``serve/decode/*``: the horizon of the latest dispatch
        #: (gauge — 1 whenever the adaptive horizon collapses), how many
        #: dispatches ran fused, and how many overrun tokens (past EOS /
        #: max_new_tokens) were rolled back. ``tokens_generated`` counts only
        #: KEPT tokens — rolled-back tokens are never emitted.
        self.decode: Dict[str, float] = {
            "horizon": 1.0, "fused_steps": 0, "rollback_tokens": 0}
        #: chunked interleaved prefill counters (docs/SERVING.md), exported
        #: under ``serve/prefill/*``: how many dispatches consumed prompt
        #: tokens (``chunks``) and how many tokens they consumed
        #: (``chunk_tokens``); ``interleaved_steps`` are dispatches that
        #: carried BOTH live decode rows and prefill-chunk rows — the
        #: convoy-killing shape — vs ``prefill_only_steps``;
        #: ``deferred_steps`` made no prefill progress under pool pressure
        #: (rows trimmed, decodes served); ``backlog_tokens`` is the
        #: end-of-step pending-prompt gauge, ``backlog_peak`` its high water.
        self.prefill: Dict[str, float] = {
            "chunks": 0, "chunk_tokens": 0, "interleaved_steps": 0,
            "prefill_only_steps": 0, "deferred_steps": 0,
            "backlog_tokens": 0.0, "backlog_peak": 0}
        #: speculative-decoding counters (docs/SERVING.md), exported under
        #: ``serve/spec/*``: ``steps`` verified dispatches ran,
        #: ``proposed_tokens``/``accepted_tokens`` feed the acceptance story
        #: (``acceptance_rate`` is their running ratio), ``bonus_tokens``
        #: are the free verifier tokens emitted at mismatch/positions past
        #: the draft, ``rollback_tokens`` the speculative share of rollback
        #: traffic (also counted in ``serve/decode/rollback_tokens``),
        #: ``degraded_steps`` fused dispatches taken by requests whose
        #: acceptance EMA collapsed, and ``draft_horizon`` the mean draft
        #: length of the latest speculative dispatch (gauge).
        self.spec: Dict[str, float] = {
            "steps": 0, "proposed_tokens": 0, "accepted_tokens": 0,
            "bonus_tokens": 0, "rollback_tokens": 0, "degraded_steps": 0,
            "acceptance_rate": 0.0, "draft_horizon": 0.0}
        #: pipelined-dispatch counters (docs/SERVING.md "Pipelined
        #: dispatch"), exported under ``serve/pipeline/*``: ``dispatches``
        #: deferred-sync decode rounds put in flight, ``in_flight`` the
        #: end-of-step in-flight row count (gauge — 0 whenever the pipe is
        #: drained), ``speculative_rollbacks`` in-flight successor positions
        #: dropped at absorb because the late token finished the request
        #: (stop-sequence overrun), ``pipeline_stalls`` rounds that had to
        #: drain and fall back to the synchronous twin (fused/spec horizon,
        #: prefill backlog, dynamic sampling, admission stall), and the
        #: stage-timing split gauges ``host_plan_ms`` / ``device_wait_ms``
        #: / ``absorb_ms`` of the latest absorbed round — the one number
        #: ``observe_step`` used to conflate.
        self.pipeline: Dict[str, float] = {
            "dispatches": 0, "in_flight": 0.0,
            "speculative_rollbacks": 0, "pipeline_stalls": 0,
            "host_plan_ms": 0.0, "device_wait_ms": 0.0, "absorb_ms": 0.0}
        #: multi-tenant QoS counters (docs/SERVING.md "Multi-tenant QoS"),
        #: exported under ``serve/tenant/<tenant>/<k>``: per-tenant
        #: admission outcomes (submitted/admitted/throttled/quota_rejects)
        #: and token production. Empty — zero event-stream cost — on
        #: untenanted schedulers.
        self.tenant: Dict[str, Dict[str, float]] = {}
        #: KV-tier counters (docs/PREFIX_CACHING.md "Two-tier cache"),
        #: exported under ``serve/kvtier/*``: engine-side tier traffic
        #: (demotions/promotions/host evictions, swap round trips and their
        #: byte volumes, host-tier occupancy gauges) synced from
        #: ``prefix_cache_stats()`` each step, plus the scheduler's own
        #: preemption-path split (``swap_preemptions`` vs
        #: ``recompute_preemptions``) and the transfer-bandwidth EMA gauge
        #: the swap-vs-recompute cost model runs on. All zeros when the
        #: engine has no host tier.
        self.kvtier: Dict[str, float] = {
            "demotions": 0,             # device blocks demoted to host RAM
            "promotions": 0,            # host blocks promoted on index hits
            "host_evictions": 0,        # blocks destroyed out of the host LRU
            "host_blocks": 0.0,         # gauge: host-tier resident blocks
            "host_bytes": 0.0,          # gauge: host-tier resident bytes
            "swap_out": 0, "swap_in": 0,
            "swap_out_bytes": 0.0, "swap_in_bytes": 0.0,
            "swap_preemptions": 0,      # victims preempted by KV swap-out
            "recompute_preemptions": 0,  # victims preempted onto replay
            "bw_bytes_per_s": 0.0,      # gauge: host->device bandwidth EMA
        }
        #: swap re-admission wall-clock samples (swap_in transfer + restore);
        #: the bench's re-admission p95 and the ``serve/kvtier`` percentile
        #: events come from here
        self.swap_readmit_s: List[float] = []
        #: sampling counters (docs/SAMPLING.md), exported under
        #: ``serve/sampling/*``: ``sampled_requests`` admissions that
        #: registered engine-side sampling state (every re-admission counts
        #: — replay paths re-register), ``sampled_tokens`` tokens selected
        #: by categorical sampling rather than argmax, ``fanout_streams``
        #: sibling streams created by ``n > 1`` fanout, ``stop_hits``
        #: requests finished by a stop sequence (overrun tokens past the
        #: match land in ``serve/decode/rollback_tokens``), and
        #: ``bias_refreshes`` dynamic logit-processor row re-scatters.
        self.sampling: Dict[str, float] = {
            "sampled_requests": 0, "sampled_tokens": 0,
            "fanout_streams": 0, "stop_hits": 0, "bias_refreshes": 0}
        #: resilience counters, exported under ``serve/faults/*``
        #: (docs/RESILIENCE.md); breaker_* are synced from the breaker each
        #: step, the rest are incremented by the scheduler as faults land
        self.faults: Dict[str, float] = {
            "transient_faults": 0,        # TransientEngineError occurrences
            "transient_retries": 0,       # backoff retries performed
            "retry_giveups": 0,           # retry budget exhausted
            "persistent_faults": 0,       # RequestFailedError occurrences
            "failed_requests": 0,         # requests quarantined to FAILED
            "containment_preemptions": 0,  # uninvolved live reqs re-admitted
            "watchdog_breaches": 0,
            "watchdog_escalations": 0,
            "shed": 0,                    # SheddingError admissions rejected
            "deadline_shed": 0,           # DeadlineShedError early rejections
            "drain_aborts": 0,            # close() hit its drain budget
            "breaker_opens": 0,
            "breaker_half_opens": 0,
            "breaker_closes": 0,
            "breaker_state": 0.0,         # gauge: 0 closed, 1 half, 2 open
            # engine-loss recovery (docs/RESILIENCE.md)
            "engine_losses": 0,           # UnrecoverableEngineError raised
            "engine_rebuilds": 0,         # hot rebuilds completed
            "recovery_replays": 0,        # journaled live reqs re-queued
            "recovery_cancelled": 0,      # deadline expired during rebuild
            "watchdog_hard_breaches": 0,
            "journal_live": 0.0,          # gauge: unresolved journal entries
        }

    def observe_step(self, latency_s: float, batch: int,
                     horizon: int = 1,
                     plan_s: Optional[float] = None,
                     wait_s: Optional[float] = None,
                     absorb_s: Optional[float] = None) -> None:
        """One decode dispatch: ``batch`` sequences advanced ``horizon``
        tokens each — ``step_batch`` records tokens per dispatch. Pipelined
        rounds also pass the stage split (host planning, device wait at
        ``fetch()``, host absorb), routed into the ``serve/pipeline/*``
        timing gauges; the synchronous twin leaves them ``None`` and the
        gauges untouched."""
        self.step_lat_s.append(latency_s)
        self.step_batch.append(batch * horizon)
        if plan_s is not None:
            self.pipeline["host_plan_ms"] = round(plan_s * 1000, 3)
        if wait_s is not None:
            self.pipeline["device_wait_ms"] = round(wait_s * 1000, 3)
        if absorb_s is not None:
            self.pipeline["absorb_ms"] = round(absorb_s * 1000, 3)

    def observe_pipeline_dispatch(self, batch: int) -> None:
        """One deferred-sync decode round put in flight (``batch`` rows)."""
        self.pipeline["dispatches"] += 1
        self.pipeline["in_flight"] = float(batch)

    def observe_pipeline_in_flight(self, batch: int) -> None:
        """End-of-step in-flight gauge (0 when the pipe is drained)."""
        self.pipeline["in_flight"] = float(batch)

    def observe_pipeline_rollback(self, n_tokens: int) -> None:
        """In-flight successor positions dropped at absorb because the late
        token finished the request (also counted in
        ``serve/decode/rollback_tokens`` by the engine commit)."""
        self.pipeline["speculative_rollbacks"] += n_tokens

    def observe_pipeline_stall(self) -> None:
        """A round drained the pipe and fell back to the synchronous twin."""
        self.pipeline["pipeline_stalls"] += 1

    def observe_decode(self, horizon: int, fused: bool) -> None:
        self.decode["horizon"] = float(horizon)
        if fused:
            self.decode["fused_steps"] += 1

    def observe_rollback(self, n_tokens: int) -> None:
        self.decode["rollback_tokens"] += n_tokens

    def observe_speculation(self, proposed: int, accepted: int,
                            bonus: int, rollback: int,
                            mean_draft: float) -> None:
        """One speculative (verify_multi) dispatch: ``proposed`` draft
        tokens went in, ``accepted`` matched the target argmax, ``bonus``
        free verifier tokens were emitted on top, ``rollback`` speculative
        positions were reclaimed."""
        self.spec["steps"] += 1
        self.spec["proposed_tokens"] += proposed
        self.spec["accepted_tokens"] += accepted
        self.spec["bonus_tokens"] += bonus
        self.spec["rollback_tokens"] += rollback
        if self.spec["proposed_tokens"]:
            self.spec["acceptance_rate"] = (
                self.spec["accepted_tokens"] / self.spec["proposed_tokens"])
        self.spec["draft_horizon"] = float(mean_draft)

    def observe_spec_degraded(self) -> None:
        """A fused dispatch ran because speculation was collapsed/empty."""
        self.spec["degraded_steps"] += 1

    def observe_sampling_admit(self, params) -> None:
        """One admission that pushed sampling state to the engine (initial
        or replay re-registration)."""
        self.sampling["sampled_requests"] += 1

    def observe_sampled_token(self) -> None:
        self.sampling["sampled_tokens"] += 1

    def observe_fanout(self, n: int) -> None:
        self.sampling["fanout_streams"] += n

    def observe_stop_hit(self) -> None:
        self.sampling["stop_hits"] += 1

    def observe_tenant(self, tenant: str, key: str, n: float = 1.0) -> None:
        """Bump one per-tenant counter (lazily created — tenants appear in
        the event stream the first time they act on this replica)."""
        d = self.tenant.setdefault(tenant, {})
        d[key] = d.get(key, 0.0) + n

    def observe_bias_refresh(self) -> None:
        self.sampling["bias_refreshes"] += 1

    def observe_kvtier(self, stats: Dict[str, float]) -> None:
        """Sync engine-side tier counters from ``prefix_cache_stats()`` —
        called once per step, gauge-style (the engine owns the running
        totals; this mirrors them into the event stream)."""
        for src, dst in (("demoted_blocks", "demotions"),
                         ("promoted_blocks", "promotions"),
                         ("host_evicted_blocks", "host_evictions"),
                         ("host_blocks", "host_blocks"),
                         ("host_bytes", "host_bytes"),
                         ("swap_out", "swap_out"), ("swap_in", "swap_in"),
                         ("swap_out_bytes", "swap_out_bytes"),
                         ("swap_in_bytes", "swap_in_bytes")):
            if src in stats:
                self.kvtier[dst] = float(stats[src])

    def observe_swap_preemption(self, swapped: bool) -> None:
        """One preemption on a tiered engine: which path the cost model
        (or the forced ``swap_preemption`` setting) took."""
        self.kvtier["swap_preemptions" if swapped
                    else "recompute_preemptions"] += 1

    def observe_swap_readmit(self, latency_s: float,
                             bw_bytes_per_s: float) -> None:
        """One swap-based re-admission: the host->device transfer+restore
        wall clock, and the bandwidth EMA it updated."""
        self.swap_readmit_s.append(latency_s)
        self.kvtier["bw_bytes_per_s"] = float(bw_bytes_per_s)

    def observe_prefill_chunk(self, n_tokens: int, interleaved: bool) -> None:
        """One dispatch that consumed ``n_tokens`` prompt tokens;
        ``interleaved`` when live decode rows shared the same program."""
        self.prefill["chunks"] += 1
        self.prefill["chunk_tokens"] += n_tokens
        if interleaved:
            self.prefill["interleaved_steps"] += 1
        else:
            self.prefill["prefill_only_steps"] += 1

    def observe_prefill_deferred(self) -> None:
        """A dispatch ran under a pending backlog but consumed no prompt
        tokens (its prefill rows were trimmed under pool pressure)."""
        self.prefill["deferred_steps"] += 1

    def observe_prefill_backlog(self, backlog_tokens: int) -> None:
        self.prefill["backlog_tokens"] = float(backlog_tokens)
        self.prefill["backlog_peak"] = max(self.prefill["backlog_peak"],
                                           backlog_tokens)

    def observe_gauges(self, queue_depth: int, live: int) -> None:
        self.queue_depth = queue_depth
        self.live = live
        self.queue_peak = max(self.queue_peak, queue_depth)

    def observe_resilience(self, breaker, watchdog) -> None:
        """Sync breaker/watchdog state into the fault counters (per step)."""
        self.faults["breaker_opens"] = breaker.opens
        self.faults["breaker_half_opens"] = breaker.half_opens
        self.faults["breaker_closes"] = breaker.closes
        self.faults["breaker_state"] = breaker.state_gauge
        self.faults["watchdog_breaches"] = watchdog.breaches
        self.faults["watchdog_escalations"] = watchdog.escalations
        self.faults["watchdog_hard_breaches"] = getattr(
            watchdog, "hard_breaches", 0)

    @staticmethod
    def _pct(samples: List[float], q: float) -> float:
        return float(np.percentile(np.asarray(samples), q)) if samples else 0.0

    def summary(self) -> Dict[str, float]:
        """Flat counter/percentile dict (the bench row + event payload)."""
        s = {
            "submitted": self.submitted, "admitted": self.admitted,
            "completed": self.completed, "cancelled": self.cancelled,
            "failed": self.failed,
            "preemptions": self.preemptions,
            "preempted_blocks_reclaimed": self.preempted_blocks_reclaimed,
            "admission_rejects": self.admission_rejects,
            "deadline_cancels": self.deadline_cancels,
            "detaches": self.detaches, "adopts": self.adopts,
            "tokens_generated": self.tokens_generated,
            "queue_depth": self.queue_depth, "live": self.live,
            "queue_peak": self.queue_peak,
            "ttft_p50_ms": round(self._pct(self.ttft_s, 50) * 1000, 2),
            "ttft_p95_ms": round(self._pct(self.ttft_s, 95) * 1000, 2),
            "ttft_p99_ms": round(self._pct(self.ttft_s, 99) * 1000, 2),
            "token_lat_p50_ms": round(self._pct(self.step_lat_s, 50) * 1000, 2),
            "token_lat_p95_ms": round(self._pct(self.step_lat_s, 95) * 1000, 2),
        }
        if self.step_batch:
            s["mean_batch"] = round(float(np.mean(self.step_batch)), 1)
        return s

    def events(self, step: int = 0) -> List[Event]:
        """``(label, value, step)`` tuples for ``MonitorMaster.write_events``
        — serving counters under ``serve/``, resilience counters under
        ``serve/faults/``. With a ``replica_id`` the whole tree moves under
        ``serve/replica<id>/`` (no aliasing across pool members)."""
        p = ("serve/" if self.replica_id is None
             else f"serve/replica{self.replica_id}/")
        return ([(f"{p}{k}", float(v), step)
                 for k, v in sorted(self.summary().items())]
                + [(f"{p}decode/{k}", float(v), step)
                   for k, v in sorted(self.decode.items())]
                + [(f"{p}prefill/{k}", float(v), step)
                   for k, v in sorted(self.prefill.items())]
                + [(f"{p}spec/{k}", float(v), step)
                   for k, v in sorted(self.spec.items())]
                + [(f"{p}pipeline/{k}", float(v), step)
                   for k, v in sorted(self.pipeline.items())]
                + [(f"{p}sampling/{k}", float(v), step)
                   for k, v in sorted(self.sampling.items())]
                + [(f"{p}kvtier/{k}", float(v), step)
                   for k, v in sorted({
                       **self.kvtier,
                       "swap_readmit_p50_ms": round(
                           self._pct(self.swap_readmit_s, 50) * 1000, 3),
                       "swap_readmit_p95_ms": round(
                           self._pct(self.swap_readmit_s, 95) * 1000, 3),
                   }.items())]
                + [(f"{p}tenant/{t}/{k}", float(v), step)
                   for t in sorted(self.tenant)
                   for k, v in sorted(self.tenant[t].items())]
                + [(f"{p}faults/{k}", float(v), step)
                   for k, v in sorted(self.faults.items())])


class PoolMetrics:
    """Pool-level control-plane counters (docs/SERVING.md engine pool),
    exported under ``serve/pool/*``. Per-replica serving counters live in
    each replica's own :class:`ServeMetrics` (replica-labeled); this class
    holds only what no single replica can know: placement quality,
    migration traffic, drain/rolling-update progress, death absorption,
    and the load-imbalance gauge."""

    def __init__(self):
        self.pool: Dict[str, float] = {
            "placements": 0,          # routed submissions
            "placement_hits": 0,      # placements with a prefix-affinity hit
            "affinity_blocks": 0,     # full prompt blocks matched at placement
            "migrations": 0,          # detach->adopt moves (any reason)
            "rebalances": 0,          # migrations made by rebalance()
            "drains": 0,              # replica drains completed
            "drain_duration_s": 0.0,  # latest drain wall-clock (gauge)
            "weight_swaps": 0,        # load_weights() on a drained replica
            "replica_deaths": 0,      # losses absorbed cross-replica
            "death_replays": 0,       # journal entries replayed on survivors
            "death_cancelled": 0,     # deadline-expired during death replay
            "imbalance": 0.0,         # gauge: max - min serving-replica load
            "replicas_serving": 0.0,  # gauges: pool health view
            "replicas_draining": 0.0,
            "replicas_dead": 0.0,
            # health supervision & overload control (docs/RESILIENCE.md
            # "Health & overload")
            "health_quarantines": 0,   # gray failures auto-drained
            "health_migrations": 0,    # requests moved by quarantine drains
            "health_recoveries": 0,    # quarantined replicas undrained
            "lease_expiries": 0,       # replicas declared lost by lease
            "limit_rejects": 0,        # submissions refused: pool at limit
            "restores": 0,             # cold-start restores completed
            "restored_requests": 0,    # live requests replayed at restore
            # disaggregated prefill/decode serving (docs/SERVING.md
            # "Disaggregated serving")
            # elastic scaling (docs/SERVING.md "Elastic scaling")
            "scale_ups": 0,            # replicas added by scale_to()
            "scale_downs": 0,          # replicas retired by scale_to()
            "scale_up_failures": 0,    # factory failures absorbed mid-grow
            "handoffs": 0,             # prefill->decode moves completed
            "handoffs_kv": 0,          # ... that moved KV (vs replay)
            "handoff_bytes": 0,        # KV bytes moved by handoffs
            "handoff_deferrals": 0,    # handoffs deferred: no target headroom
            "handoff_p95_s": 0.0,      # gauge: p95 handoff latency
        }
        self._handoff_s: List[float] = []

    def observe_placement(self, hit_blocks: int) -> None:
        self.pool["placements"] += 1
        if hit_blocks > 0:
            self.pool["placement_hits"] += 1
            self.pool["affinity_blocks"] += hit_blocks

    def observe_migration(self, rebalance: bool = False) -> None:
        self.pool["migrations"] += 1
        if rebalance:
            self.pool["rebalances"] += 1

    def observe_drain(self, duration_s: float) -> None:
        self.pool["drains"] += 1
        self.pool["drain_duration_s"] = float(duration_s)

    def observe_weight_swap(self) -> None:
        self.pool["weight_swaps"] += 1

    def observe_death(self, replayed: int, cancelled: int) -> None:
        self.pool["replica_deaths"] += 1
        self.pool["death_replays"] += replayed
        self.pool["death_cancelled"] += cancelled

    def observe_quarantine(self, migrated: int) -> None:
        self.pool["health_quarantines"] += 1
        self.pool["health_migrations"] += migrated

    def observe_health_recovery(self) -> None:
        self.pool["health_recoveries"] += 1

    def observe_lease_expiry(self) -> None:
        self.pool["lease_expiries"] += 1

    def observe_limit_reject(self) -> None:
        self.pool["limit_rejects"] += 1

    def observe_scale(self, grew: int, shrank: int, failed: int) -> None:
        self.pool["scale_ups"] += grew
        self.pool["scale_downs"] += shrank
        self.pool["scale_up_failures"] += failed

    def observe_restore(self, restored: int) -> None:
        self.pool["restores"] += 1
        self.pool["restored_requests"] += restored

    def observe_handoff(self, kv: bool, nbytes: int,
                        duration_s: float) -> None:
        """One completed prefill→decode handoff. ``kv=False`` is the
        journal-replay fallback (the ladder's safe rung — still a
        handoff, just a recomputed one)."""
        self.pool["handoffs"] += 1
        if kv:
            self.pool["handoffs_kv"] += 1
            self.pool["handoff_bytes"] += nbytes
        self._handoff_s.append(float(duration_s))
        s = sorted(self._handoff_s)
        self.pool["handoff_p95_s"] = s[max(0, int(0.95 * len(s)) - 1)] \
            if len(s) > 1 else s[0]

    def observe_handoff_deferral(self) -> None:
        self.pool["handoff_deferrals"] += 1

    def observe_gauges(self, loads: List[int], serving: int, draining: int,
                       dead: int) -> None:
        self.pool["imbalance"] = float(
            (max(loads) - min(loads)) if loads else 0)
        self.pool["replicas_serving"] = float(serving)
        self.pool["replicas_draining"] = float(draining)
        self.pool["replicas_dead"] = float(dead)

    def summary(self) -> Dict[str, float]:
        return dict(self.pool)

    def events(self, step: int = 0) -> List[Event]:
        return [(f"serve/pool/{k}", float(v), step)
                for k, v in sorted(self.pool.items())]
