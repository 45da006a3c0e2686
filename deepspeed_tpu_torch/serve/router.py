"""Prefix-affinity request router for the engine pool (docs/SERVING.md).

A copy of ``deepspeed_tpu/serve/router.py`` for the port, which imports nothing
of the JAX package; the text below is the JAX module's.

One placement decision per submission: which replica should own this
request? Shared-prompt traffic (system prompts, few-shot headers — the
dominant production shape, docs/PREFIX_CACHING.md) is only cheap when it
lands where its KV blocks already live, so the router scores every
serving replica by **exact prefix affinity**: the replica's engine walks
its chained content index over the prompt's leading full blocks
(``InferenceEngineV2.prefix_probe`` — read-only, no refcount or LRU
perturbation) and reports how many it holds. With a host KV tier the
probe counts demoted blocks too (docs/PREFIX_CACHING.md "Two-tier
cache"): a prefix parked in host RAM is one batched promotion away, so
it scores the same as device-resident content. Highest hit count wins;
zero-hit placements (and ``affinity=False``, the A/B baseline) fall back
to **least-loaded** (live + queued requests); remaining ties break on the
lowest replica id.

Disaggregated serving (docs/SERVING.md "Disaggregated serving") adds a
second placement axis next to affinity: the request's **phase**. New
submissions are prefill work — they place by prefix affinity among
prefill-capable replicas (role ``prefill`` or ``mixed``); post-prefill
handoffs are decode work — they place least-loaded among decode-capable
replicas (role ``decode`` or ``mixed``), skipping the affinity probe
entirely (the KV arrives WITH the request, so there is no locality to
exploit and no reason to pay a probe per handoff). A handle without a
``role`` attribute is ``mixed``, so single-role-free pools behave exactly
as before the axis existed.

Determinism (DSTPU005): the decision is a pure function of the replicas'
current state and the candidate prompt — no wall clock, no RNG, no set
iteration. The caller passes replicas in id order and the tie-break is
total, so the same pool state always places the same request on the same
replica; a replayed trace routes identically.
"""

from typing import List, Optional, Sequence, Tuple

#: replica roles a phase may place on (docs/SERVING.md "Disaggregated
#: serving"); ``mixed`` replicas serve both phases — the compatible
#: default for pools that never configured roles
PHASE_ROLES = {
    "prefill": ("prefill", "mixed"),
    "decode": ("decode", "mixed"),
}


class Router:
    """Placement policy over a list of replica handles.

    A *replica handle* is duck-typed: ``replica_id`` (int, unique),
    ``scheduler`` (exposes ``live_count`` / ``queue_depth``) and
    ``engine`` (exposes ``prefix_probe``); an optional ``role``
    (``"prefill"`` / ``"decode"`` / ``"mixed"``, default ``"mixed"``)
    gates which phases it may receive. ``affinity=False`` disables
    the prefix score entirely — pure least-loaded, the bench's A/B
    baseline."""

    def __init__(self, *, affinity: bool = True):
        self.affinity = affinity

    #: prompt tokens that weigh like one queued request in the load score.
    #: Matches the order of a typical chunked-prefill round (token_budget),
    #: so a replica sitting on thousands of admitted-but-unprefilled tokens
    #: scores as several requests' worth of committed work instead of
    #: rounding to zero — without letting one long prompt swamp the
    #: rebalancer's integer gap>=2 logic.
    BACKLOG_TOKENS_PER_REQUEST = 256

    @staticmethod
    def load(replica) -> int:
        """A replica's placement load: requests it owns that are not yet
        terminal — live members plus its queue — plus its chunked-prefill
        backlog in request-equivalents. live_count counts an admitted
        sequence the moment it is admitted, but two replicas with equal
        member counts can hide wildly different committed work: one may
        still owe thousands of prompt tokens of prefill. Folding the
        backlog in stops the router steering new prompts at the replica
        that looks idle but is still chewing through admissions."""
        n = replica.scheduler.live_count + replica.scheduler.queue_depth
        backlog = getattr(replica.scheduler, "prefill_backlog_tokens", None)
        if backlog is not None:
            n += backlog() // Router.BACKLOG_TOKENS_PER_REQUEST
        return n

    def place(self, prompt: Sequence[int], replicas: List[object],
              *, phase: str = "prefill") -> Tuple[Optional[object], int]:
        """Pick the owner for ``prompt`` among ``replicas`` (id order).
        ``phase`` selects the role axis: ``"prefill"`` (new submissions —
        affinity-scored) or ``"decode"`` (handoffs — least-loaded only).
        Returns ``(replica, hit_blocks)`` — ``hit_blocks`` is the winning
        affinity score (0 on a least-loaded fallback) — or ``(None, 0)``
        when no replica is offered."""
        roles = PHASE_ROLES[phase]
        probe = self.affinity and phase == "prefill"
        best = None
        best_key: Optional[Tuple[int, int, int]] = None
        best_hits = 0
        for rep in replicas:
            if getattr(rep, "role", "mixed") not in roles:
                continue
            # adaptive concurrency limit (docs/RESILIENCE.md "Health &
            # overload"): a replica at its Vegas ceiling is not a candidate
            # — affinity never overrides overload protection
            limit = getattr(rep, "limit", None)
            if limit is not None and not limit.has_headroom():
                continue
            hits = rep.engine.prefix_probe(prompt) if probe else 0
            key = (-hits, self.load(rep), rep.replica_id)
            if best_key is None or key < best_key:
                best, best_key, best_hits = rep, key, hits
        return best, best_hits
