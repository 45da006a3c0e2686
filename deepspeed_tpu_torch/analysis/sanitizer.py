"""Runtime sanitizer, "checked mode" for the serving stack (counterpart of
``deepspeed_tpu/analysis/sanitizer.py``).

``DSTPU_SANITIZE=1`` (the same variable as the JAX package) arms checked
mode:

- :func:`checked_cache_cls` — a ``BlockedKVCache`` subclass that re-verifies
  refcount conservation, COW exclusivity, use-after-free / double-free,
  rollback exactness, registration during speculation, the full-prompt
  lookup cap and prefix-index/pool consistency after **every** allocator
  operation. The engine builds it instead of the plain cache when checked
  mode is armed, at construction and at ``rebuild()``.
- :func:`check_transition` validates every ``Request.state`` assignment
  against the legal lifecycle graph.
- the scheduler's between-steps and drain checks below, the TransferEngine
  ledger check (``check_transfer_ledger``), the engine pool's checks
  (``check_pool_ownership``, ``check_pool_health``,
  ``check_tenant_accounting``, ``check_disagg_ownership``) and the training
  checks (``check_gather_conservation``, which ``save_checkpoint`` runs on
  every gather; ``check_shard_conservation``, which consolidation runs;
  ``check_offload_split``).

Violations raise :class:`SanitizerError`, an ``AssertionError`` subclass,
so the serving loop's typed ``RuntimeError`` handling can never swallow
one; the messages are the JAX package's. With the variable unset
everything here is dormant. The module imports nothing heavy at import
time: the cache subclass is built on first request.
"""

import os
from typing import Callable, Dict, FrozenSet, Iterable, List, Optional

_ENV = "DSTPU_SANITIZE"


_OFF = ("", "0", "false", "off", "no")


def sanitize_enabled() -> bool:
    """True when checked mode is armed (``DSTPU_SANITIZE=1``). Read from
    the environment on every call so tests can flip it per-case; the
    lookup is a few hundred nanoseconds — invisible next to a dispatch."""
    return os.environ.get(_ENV, "").strip().lower() not in _OFF


class SanitizerError(AssertionError):
    """A mechanized invariant was violated. Subclasses ``AssertionError``
    (not ``RuntimeError``): the resilience layer's containment paths catch
    typed ``RuntimeError``s, and a sanitizer finding must never be retried,
    quarantined, or shed — it must stop the test."""


class IllegalTransitionError(SanitizerError):
    """A ``Request.state`` assignment off the legal lifecycle graph."""


#: legal edges, keyed on ``RequestState.value`` strings so this module
#: never imports the serve layer (which imports *us*). Self-transitions
#: are always legal (the decode loop re-asserts DECODE per token).
LEGAL_TRANSITIONS: Dict[str, FrozenSet[str]] = {
    "queued": frozenset({"prefill", "cancelled", "failed"}),
    "prefill": frozenset({"decode", "preempted", "cancelled", "failed"}),
    "decode": frozenset({"done", "preempted", "cancelled", "failed"}),
    "preempted": frozenset({"queued", "cancelled", "failed"}),
    "done": frozenset(),
    "cancelled": frozenset(),
    "failed": frozenset(),
}


def check_transition(uid: object, old, new) -> None:
    """Validate one ``Request.state`` assignment. ``old is None`` is the
    dataclass's initial assignment and always legal; terminal states have
    no out-edges."""
    if old is None or old is new:
        return
    legal = LEGAL_TRANSITIONS.get(getattr(old, "value", str(old)))
    if legal is None:  # unknown state object: nothing to validate against
        return
    if getattr(new, "value", str(new)) not in legal:
        raise IllegalTransitionError(
            f"[sanitizer] illegal request state transition uid={uid}: "
            f"{old} -> {new} (legal from {old}: "
            f"{sorted(legal) or 'none — terminal state'})")


# ---------------------------------------------------------------------------
# checked KV cache
# ---------------------------------------------------------------------------

_checked_cls = None


def checked_cache_cls():
    """The :class:`CheckedBlockedKVCache` class, built on first use (lazy
    so importing this module never pulls in the inference stack)."""
    global _checked_cls
    if _checked_cls is not None:
        return _checked_cls

    from ..inference.v2.ragged_manager import BlockedKVCache

    class CheckedBlockedKVCache(BlockedKVCache):
        """Drop-in ``BlockedKVCache`` that re-verifies the allocator's
        invariants after every operation.

        ``descs`` is a zero-arg callable yielding every live
        :class:`SequenceDescriptor` (the engine passes its state table);
        without it the wrapper falls back to the descriptors it has seen,
        which is enough for standalone allocator tests. Checks are
        O(live blocks) pure-host work per op — negligible next to the
        compiled dispatch each op brackets, but still debug-mode-only."""

        def __init__(self, *args,
                     descs: Optional[Callable[[], Iterable]] = None, **kw):
            super().__init__(*args, **kw)
            self._descs_provider = descs
            self._seen: Dict[int, object] = {}

        # -- plumbing ----------------------------------------------------
        def _descs(self) -> List:
            if self._descs_provider is not None:
                return list(self._descs_provider())
            return list(self._seen.values())

        def _track(self, desc) -> None:
            self._seen[desc.uid] = desc

        def verify(self, op: str = "verify") -> None:
            """All invariants, loudly: base ``check_invariants`` (pool
            partitioning, index/meta/children consistency, refcount
            conservation against live descriptors) plus explicit
            use-after-free scans for better diagnostics."""
            descs = self._descs()
            free = set(self._free)
            for d in descs:
                for b in d.blocks:
                    if b in free:
                        raise SanitizerError(
                            f"[sanitizer] use-after-free after {op}: uid "
                            f"{d.uid} still maps block {b}, which is on "
                            "the free list")
                    if self.refcount(b) < 1:
                        raise SanitizerError(
                            f"[sanitizer] use-after-free after {op}: uid "
                            f"{d.uid} maps block {b} with refcount 0")
            try:
                self.check_invariants(descs)
            except AssertionError as e:
                if isinstance(e, SanitizerError):
                    raise
                raise SanitizerError(
                    f"[sanitizer] KV-cache invariant broken after {op}: "
                    f"{e}") from e

        # -- checked operations ------------------------------------------
        def ensure(self, desc, n_tokens):
            self._track(desc)
            super().ensure(desc, n_tokens)
            self.verify(f"ensure(uid={desc.uid}, n={n_tokens})")

        def lookup(self, desc, tokens):
            self._track(desc)
            skipped = super().lookup(desc, tokens)
            if skipped > len(tokens) - 1:
                raise SanitizerError(
                    f"[sanitizer] prefix lookup for uid {desc.uid} skipped "
                    f"{skipped} of {len(tokens)} tokens — at least the "
                    "final prompt token must run to produce logits")
            self.verify(f"lookup(uid={desc.uid})")
            return skipped

        def copy_on_write(self, desc, j):
            self._track(desc)
            src_before = desc.blocks[j]
            refs_before = self.refcount(src_before)
            src, dst = super().copy_on_write(desc, j)
            # COW exclusivity: the writer must own the replacement block
            # alone, and exactly one reference must come off the source
            if self.refcount(dst) != 1:
                raise SanitizerError(
                    f"[sanitizer] COW exclusivity: dst block {dst} has "
                    f"refcount {self.refcount(dst)} != 1 after "
                    f"copy_on_write(uid={desc.uid}, j={j})")
            if desc.blocks[j] != dst or src != src_before:
                raise SanitizerError(
                    f"[sanitizer] COW repoint: uid {desc.uid} slot {j} "
                    f"maps {desc.blocks[j]}, expected dst {dst} "
                    f"(src {src} vs {src_before})")
            if self.refcount(src) != refs_before - 1:
                raise SanitizerError(
                    f"[sanitizer] COW released {refs_before - self.refcount(src)} "
                    f"references on src block {src}, expected exactly 1")
            self.verify(f"copy_on_write(uid={desc.uid}, j={j})")
            return src, dst

        def register(self, desc, limit=None):
            self._track(desc)
            # speculation-aware rollback accounting (docs/SERVING.md): a
            # fused/verify dispatch marks its K advanced positions as
            # uncommitted; registering them in the content index before
            # rollback commits the step would let the prefix cache serve
            # unverified draft tokens to other requests. A bounded
            # registration (pipelined dispatch: ``limit`` at the committed
            # boundary) is allowed while a provisional tail is in flight —
            # but only when the bound truly excludes every such position.
            if getattr(desc, "uncommitted", 0):
                if limit is None or limit > desc.seen_tokens - desc.uncommitted:
                    raise SanitizerError(
                        f"[sanitizer] register during speculation: uid "
                        f"{desc.uid} has {desc.uncommitted} uncommitted "
                        "token(s) from the last fused/verify/pipelined "
                        "dispatch — the prefix index may only cover "
                        "positions below the committed boundary")
            super().register(desc, limit=limit)
            self.verify(f"register(uid={desc.uid})")

        def rollback(self, desc, n_tokens):
            self._track(desc)
            before = len(desc.blocks)
            keep = min(before, self.blocks_needed(n_tokens))
            freed = super().rollback(desc, n_tokens)
            # rollback exactness: exactly the over-allocated tail comes
            # back, one reference per block, never more, never fewer
            if freed != before - keep or len(desc.blocks) != keep:
                raise SanitizerError(
                    f"[sanitizer] rollback exactness: uid {desc.uid} freed "
                    f"{freed} blocks to keep {len(desc.blocks)}, expected "
                    f"to free {before - keep} and keep {keep}")
            self.verify(f"rollback(uid={desc.uid}, n={n_tokens})")
            return freed

        def free(self, desc):
            # double-free scan BEFORE mutating: a stale descriptor (a
            # scheduler race re-freeing flushed blocks) must be caught
            # here, not corrupt refcounts of whoever owns the block now
            for b in desc.blocks:
                if self.refcount(b) < 1:
                    raise SanitizerError(
                        f"[sanitizer] double free: uid {desc.uid} frees "
                        f"block {b} which has no outstanding reference")
            super().free(desc)
            self._seen.pop(desc.uid, None)
            self.verify(f"free(uid={desc.uid})")

        def flush_cache(self):
            super().flush_cache()
            self.verify("flush_cache")

    _checked_cls = CheckedBlockedKVCache
    return _checked_cls


def check_prefill_ownership(engine, live: Dict[int, object]) -> None:
    """Chunked interleaved prefill (docs/SERVING.md) makes ``PREFILL`` a
    long-lived state: partially-prefilled sequences stay resident in the
    engine across scheduler steps. Two invariants tie the scheduler's view
    to the engine's between steps:

    - every engine descriptor still holding pending (undispatched) tokens
      belongs to a live request — an orphaned backlog row would keep
      dispatching a dead request's prompt and leak its blocks;
    - every live ``PREFILL``-state request is still resident with work
      outstanding — a PREFILL request with no pending tokens lost its
      backlog (it can never produce a first token).
    """
    state = getattr(engine, "state", None)
    if state is None:
        return
    for uid, d in state.seqs.items():
        if d.in_flight and uid not in live:
            raise SanitizerError(
                f"[sanitizer] orphaned prefill backlog: uid {uid} holds "
                f"{d.in_flight} pending token(s) but no live request owns "
                "it — cancel/preempt must flush pending work")
    for uid, req in live.items():
        if getattr(getattr(req, "state", None), "value", None) != "prefill":
            continue
        d = state.seqs.get(uid)
        if d is None or d.in_flight == 0:
            raise SanitizerError(
                f"[sanitizer] live PREFILL request uid {uid} has no "
                "pending work in the engine — its backlog was lost, the "
                "request can never produce a first token")


def check_speculation_commit(engine,
                             inflight: Optional[Dict[int, int]] = None
                             ) -> None:
    """Speculative decoding (docs/SERVING.md) advances every verified
    row's cache by the full horizon K and relies on the scheduler to
    commit/rollback the step — ``engine.rollback(uid, n)`` — before the
    next scheduler iteration. Between steps, then:

    - no descriptor may carry ``uncommitted`` positions (a dispatch whose
      accept/rollback bookkeeping was skipped would feed the next round
      from unverified cache state);
    - no descriptor's prefix-index registration may cover more tokens than
      it has committed (``seen_tokens``) — the draft-tokens-never-indexed
      guarantee (docs/PREFIX_CACHING.md).

    ``inflight`` (pipelined dispatch, docs/SERVING.md) is the scheduler's
    declared in-flight ledger, ``{uid: provisional token span}``: exactly
    that many uncommitted tokens are EXPECTED on those uids at the step
    boundary — the one legitimately un-absorbed round. Anything beyond the
    declaration is still a violation.
    """
    state = getattr(engine, "state", None)
    if state is None:
        return
    mgr = getattr(engine, "block_mgr", None)
    bs = getattr(mgr, "block_size", None)
    for uid, d in state.seqs.items():
        allowed = (inflight or {}).get(uid, 0)
        if getattr(d, "uncommitted", 0) > allowed:
            raise SanitizerError(
                f"[sanitizer] uncommitted speculation across a step "
                f"boundary: uid {uid} still has {d.uncommitted} "
                f"uncommitted token(s) (declared in-flight: {allowed}) — "
                "the scheduler must rollback/commit every fused/verify/"
                "pipelined dispatch it absorbs")
        if bs and getattr(d, "n_indexed", 0) * bs > d.seen_tokens:
            raise SanitizerError(
                f"[sanitizer] prefix index past committed history: uid "
                f"{uid} registered {d.n_indexed} full block(s) "
                f"({d.n_indexed * bs} tokens) but committed only "
                f"{d.seen_tokens}")


def check_pipeline_coherence(engine, journal, live: Dict[int, object],
                             inflight: Dict[int, int],
                             dispatch_uids: Optional[List[int]] = None
                             ) -> None:
    """Pipelined dispatch (docs/SERVING.md): with one step in flight the
    scheduler's absorb runs one step LATE, so four invariants tie the
    in-flight ledger to the engine and the journal at every step boundary:

    - the ledger is exact: each declared uid carries exactly its declared
      provisional span in ``uncommitted`` (a drifted ledger means commit
      bookkeeping was skipped or double-counted);
    - no uid rides two in-flight dispatches: the dispatched row list holds
      each uid at most once (a double-fed uid would double-advance);
    - the journal never contains a token from an un-absorbed step: per
      in-flight uid, ``prompt + journaled tokens`` may exceed the engine's
      committed positions (``seen_tokens - uncommitted``) by at most the
      one emitted-but-not-yet-cached token of the ``decode_step`` contract;
    - rollback-on-absorb leaves refcounts exact: every at-rest live decode
      row's block list covers its committed positions with at most the
      standing-retry one-token over-allocation.
    """
    if dispatch_uids is not None:
        if len(dispatch_uids) != len(set(dispatch_uids)):
            raise SanitizerError(
                "[sanitizer] pipeline double-feed: uid(s) "
                f"{sorted(u for u in set(dispatch_uids) if dispatch_uids.count(u) > 1)} "
                "appear more than once in the in-flight dispatch")
    state = getattr(engine, "state", None)
    if state is None:
        return
    for uid, span in inflight.items():
        if uid not in live:
            raise SanitizerError(
                f"[sanitizer] pipeline ledger names uid {uid} which has no "
                "live request — finished/contained uids must leave the "
                "in-flight ledger at their absorb")
        d = state.seqs.get(uid)
        if d is None or getattr(d, "uncommitted", 0) != span:
            got = "no descriptor" if d is None else d.uncommitted
            raise SanitizerError(
                f"[sanitizer] pipeline ledger drift: uid {uid} declared "
                f"{span} in-flight token(s) but the engine carries {got}")
        e = journal.get(uid) if journal is not None else None
        if e is not None:
            committed = d.seen_tokens - d.uncommitted
            if len(e.prompt) + len(e.tokens) > committed + 1:
                raise SanitizerError(
                    f"[sanitizer] journal ahead of absorb: uid {uid} "
                    f"journals {len(e.tokens)} token(s) on a {len(e.prompt)}"
                    f"-token prompt but the engine has committed only "
                    f"{committed} position(s) — a token from an un-absorbed "
                    "step was committed")
    mgr = getattr(engine, "block_mgr", None)
    if mgr is None:
        return
    for uid, req in live.items():
        if getattr(getattr(req, "state", None), "value", None) != "decode":
            continue
        d = state.seqs.get(uid)
        if d is None or d.in_flight or uid in inflight:
            continue
        lo = mgr.blocks_needed(d.seen_tokens)
        hi = mgr.blocks_needed(d.seen_tokens + 1)
        if not (lo <= len(d.blocks) <= hi):
            raise SanitizerError(
                f"[sanitizer] pipeline rollback refcount drift: uid {uid} "
                f"holds {len(d.blocks)} block(s) for {d.seen_tokens} "
                f"committed token(s), expected within [{lo}, {hi}]")


def check_drained(engine) -> None:
    """After a scheduler ``close()`` drain the engine must be empty: no
    resident sequences, no outstanding block references, and the block
    pool fully allocatable (free + cached-evictable == usable). Cached
    LRU blocks are fine — they are reclaimable prefix state, not leaks."""
    problems: List[str] = []
    state = getattr(engine, "state", None)
    if state is not None and getattr(state, "n_active", 0):
        problems.append(f"{state.n_active} sequence(s) still resident "
                        f"(uids {sorted(state.seqs)})")
    mgr = getattr(engine, "block_mgr", None)
    if mgr is not None:
        refs = getattr(mgr, "_ref", None)
        if refs:
            problems.append(f"outstanding block references {dict(refs)}")
        usable = mgr.num_blocks - 1  # block 0 is the reserved trash block
        if mgr.free_blocks != usable:
            problems.append(f"pool accounting: free+cached "
                            f"{mgr.free_blocks} != usable {usable}")
    if problems:
        raise SanitizerError("[sanitizer] pool leak at close() drain: "
                             + "; ".join(problems))


def check_tier_conservation(engine) -> None:
    """Two-tier cache conservation (docs/PREFIX_CACHING.md "Two-tier
    cache"): between scheduler steps, every block the tiered allocator
    knows about must live in EXACTLY one of four states —

    - **free**: on the device free list,
    - **device-LRU**: device-resident indexed prefix content, unreferenced,
    - **host-tier**: demoted to host RAM (negative-id namespace),
    - **NVMe-tier**: spilled to disk (same negative-id namespace — a spill
      moves residency, never the id),
    - **referenced**: mapped by at least one live sequence.

    On top of the partition: every content-index entry must resolve — a
    device-id entry through the referenced/LRU sets, a demoted (negative)
    entry through the host OR NVMe tier (a dangling demoted entry would let
    ``lookup`` promote freed garbage into a live sequence); queued
    promotions must target referenced blocks (the lookup that queued them
    pinned the destination); and every swap entry must describe a
    NON-resident sequence with exactly the at-rest block count its
    committed history needs — swap payloads are a cache keyed by uid, and
    a resident uid with a swap entry means a flush was skipped. No-op on
    engines without a prefix cache."""
    mgr = getattr(engine, "block_mgr", None)
    if mgr is None or not getattr(mgr, "prefix_cache", False):
        return
    from ..inference.v2.ragged_manager import _ROOT

    problems: List[str] = []
    free, lru, ref = set(mgr._free), set(mgr._lru), set(mgr._ref)
    host = set(mgr._host)
    nvme = set(getattr(mgr, "_nvme", ()))
    for overlap, name in ((free & ref, "free AND referenced"),
                          (free & lru, "free AND device-LRU"),
                          (ref & lru, "referenced AND device-LRU"),
                          (host & nvme, "host-tier AND NVMe-tier")):
        if overlap:
            problems.append(f"block(s) {sorted(overlap)} are {name}")
    bad_ns = [b for b in host | nvme if b >= _ROOT]
    if bad_ns:
        problems.append(f"tiered id(s) {sorted(bad_ns)} outside the "
                        f"negative namespace (must be < {_ROOT})")
    devices = free | ref | lru
    expected = set(range(1, mgr.num_blocks))  # block 0 is the trash block
    if devices != expected:
        missing = sorted(expected - devices)
        extra = sorted(devices - expected)
        problems.append(f"device pool not conserved: missing {missing}, "
                        f"unexpected {extra}")
    cap = max(getattr(mgr, "host_tier_blocks", 0), 0)
    if len(host) > cap:
        problems.append(f"host tier over capacity: {len(host)} resident "
                        f"> {cap}")
    nvme_cap = max(getattr(mgr, "nvme_blocks", 0), 0)
    if len(nvme) > nvme_cap:
        problems.append(f"NVMe tier over capacity: {len(nvme)} resident "
                        f"> {nvme_cap}")
    for key, b in mgr._index.items():
        if b < _ROOT:
            if b not in host and b not in nvme:
                problems.append(f"index entry {key} points at demoted "
                                f"block {b} with no tier residence")
        elif b not in ref and b not in lru:
            problems.append(f"index entry {key} points at device block "
                            f"{b} that is neither referenced nor cached")
    for _, dst in getattr(mgr, "_pending_promotions", ()):
        if dst not in ref:
            problems.append(f"pending promotion targets block {dst} with "
                            "no live reference pinning it")
    seqs = getattr(getattr(engine, "state", None), "seqs", {})
    for uid, entry in getattr(engine, "_swaps", {}).items():
        if uid in seqs:
            problems.append(f"uid {uid} is engine-resident AND holds a "
                            "swap entry — swap_out must flush first")
            continue
        payloads, _, seen = entry
        need = mgr.blocks_needed(seen)
        if len(payloads) != need:
            problems.append(f"swap entry uid {uid}: {len(payloads)} "
                            f"payload block(s) for {seen} committed "
                            f"tokens (needs {need})")
    if problems:
        raise SanitizerError("[sanitizer] tier conservation violated: "
                             + "; ".join(problems))


def check_transfer_ledger(transfer) -> None:
    """TransferEngine byte-ledger conservation, checked at every drain
    boundary under ``DSTPU_SANITIZE`` (``sanitizer.py:528``):

    - per direction, bytes **submitted == completed + cancelled + in
      flight**;
    - the in-flight byte count equals the sum over open tickets (and a
      ticket in the open table is open);
    - the engine's recorded violations (a staging buffer re-requested while
      its ticket is open, a ``.value`` read without ``drain_before``) are
      reported once and cleared.

    Duck-typed on the engine's ledger surface; a no-op for engines without
    one."""
    ledger = getattr(transfer, "ledger", None)
    if ledger is None:
        return
    problems: List[str] = []
    led = ledger()
    open_bytes = {"d2h": 0, "h2d": 0}
    for t in getattr(transfer, "_open", {}).values():
        open_bytes[t.direction] = open_bytes.get(t.direction, 0) + t.nbytes
        if not t.open:
            problems.append(f"ticket {t.tid} ({t.direction}) is closed but "
                            "still tracked as open")
    for d in ("d2h", "h2d"):
        sub = led["submitted"][d]
        acct = (led["completed"][d] + led.get("cancelled", {}).get(d, 0)
                + led["inflight"][d])
        if sub != acct:
            problems.append(
                f"{d} bytes not conserved: submitted {sub} != completed "
                f"{led['completed'][d]} + cancelled "
                f"{led.get('cancelled', {}).get(d, 0)} + inflight "
                f"{led['inflight'][d]}")
        if led["inflight"][d] < 0:
            problems.append(f"{d} in-flight byte count went negative "
                            f"({led['inflight'][d]})")
        if led["inflight"][d] != open_bytes.get(d, 0):
            problems.append(
                f"{d} in-flight ledger {led['inflight'][d]} B disagrees "
                f"with the open-ticket table ({open_bytes.get(d, 0)} B)")
    recorded = list(getattr(transfer, "violations", ()))
    if recorded:
        transfer.violations = []
        problems.extend(recorded)
    if problems:
        raise SanitizerError("[sanitizer] transfer ledger violated: "
                             + "; ".join(problems))


def check_recovery(journal, queued, all_requests: Dict[int, object]) -> None:
    """Post-recovery re-admission check (docs/RESILIENCE.md): immediately
    after an engine rebuild, every journaled live uid must be accounted
    for — re-queued for replay, or terminally resolved (the
    deadline-expired-during-rebuild cancels). A uid the journal still holds
    that is neither queued nor terminal was silently dropped by recovery:
    its stream consumer would hang forever, the failure mode the journal
    exists to make impossible. Duck-typed on ``journal.uids()`` /
    ``Request.state`` so this module keeps importing neither the serve nor
    the resilience layer."""
    problems: List[str] = []
    queued_uids = {getattr(r, "uid", None) for r in queued}
    for uid in journal.uids():
        req = all_requests.get(uid)
        if req is None:
            problems.append(f"uid {uid} journaled but unknown to the "
                            "scheduler")
            continue
        state = getattr(getattr(req, "state", None), "value", None)
        if state in ("done", "cancelled", "failed"):
            problems.append(f"uid {uid} is terminal ({state}) but still "
                            "journaled — a resolve() is missing")
        elif uid not in queued_uids:
            problems.append(f"uid {uid} ({state}) journaled live but "
                            "neither re-queued nor terminally resolved")
    if problems:
        raise SanitizerError("[sanitizer] recovery dropped request(s): "
                             + "; ".join(problems))


def check_pool_ownership(replica_views, owner: Dict[int, int]) -> None:
    """Engine-pool ownership invariant (docs/SERVING.md): every live
    request is owned by EXACTLY one replica. ``replica_views`` is a list
    of ``(replica_id, journal, all_requests)`` triples (non-dead replicas
    only); ``owner`` is the pool's uid -> replica_id map. Violations this
    catches:

    - a uid journaled on two replicas at once (a double adopt — the
      request would decode twice and its journals diverge);
    - a journal entry whose uid the SAME replica's scheduler does not
      know live (an orphaned entry: detach removed the request but the
      journal handoff was lost — its stream consumer hangs);
    - a live request no journal covers (an orphaned request: an engine
      loss now would silently drop it — the write-ahead contract);
    - the pool's owner map disagreeing with where the journal actually
      lives (migration updated one side but not the other).

    Duck-typed on ``journal.uids()`` / ``Request.state`` like
    :func:`check_recovery` — no serve/resilience import."""
    problems: List[str] = []
    seen: Dict[int, int] = {}
    for rid, journal, all_requests in replica_views:
        for uid in journal.uids():
            if uid in seen:
                problems.append(f"uid {uid} journaled on replicas "
                                f"{seen[uid]} AND {rid} — double adopt")
                continue
            seen[uid] = rid
            req = all_requests.get(uid)
            state = getattr(getattr(req, "state", None), "value", None)
            if req is None or state in ("done", "cancelled", "failed"):
                problems.append(f"uid {uid} journaled on replica {rid} "
                                f"but not live there ({state}) — "
                                "orphaned entry")
            own = owner.get(uid)
            if own is not None and own != rid:
                problems.append(f"uid {uid}: pool owner map says replica "
                                f"{own}, journal lives on {rid}")
        for uid, req in all_requests.items():
            state = getattr(getattr(req, "state", None), "value", None)
            if (state not in ("done", "cancelled", "failed")
                    and uid not in journal.uids()):
                problems.append(f"uid {uid} live on replica {rid} with "
                                "no journal entry — unreplayable")
    if problems:
        raise SanitizerError("[sanitizer] pool ownership violation: "
                             + "; ".join(problems))


def check_pool_health(replica_views, owner: Dict[int, int],
                      now: float) -> None:
    """Health-supervision invariants (docs/RESILIENCE.md "Health &
    overload"). ``replica_views`` is a list of ``(replica_id, state,
    lease_deadline, health_state, limit_inflight, journal)`` tuples for
    EVERY replica (dead included); ``owner`` is the pool's uid ->
    replica_id map and ``now`` the pool clock. Violations this catches:

    - a SERVING replica whose heartbeat lease has already expired — the
      supervisor must have declared it lost before the step ended, so a
      stale lease in rotation means poll() was skipped or its verdict
      dropped;
    - a health-quarantined replica that still owns requests (non-empty
      journal or owner-map entries) — the quarantine drain is supposed
      to migrate everything before probing starts;
    - a replica's adaptive-limit in-flight count disagreeing with the
      owner map — an admit/release was lost and the ceiling is now
      enforced against phantom (or invisible) load.

    Duck-typed (``journal.uids()``, plain strings/ints) — no
    serve/resilience import."""
    problems: List[str] = []
    owned: Dict[int, int] = {}
    for uid, rid in owner.items():
        owned[rid] = owned.get(rid, 0) + 1
    for rid, state, lease, health_state, inflight, journal in replica_views:
        if (state == "serving" and health_state in ("serving", "suspect")
                and lease is not None and now > lease):
            problems.append(
                f"replica {rid} is serving with an expired heartbeat "
                f"lease (deadline {lease:.3f} < now {now:.3f}) — lost "
                "verdict missed")
        if health_state == "quarantined" and getattr(journal, "uids",
                                                     None) is not None:
            held = list(journal.uids())
            if held:
                problems.append(
                    f"health-quarantined replica {rid} still owns "
                    f"{len(held)} journaled request(s) ({held[:4]}) — "
                    "quarantine drain incomplete")
            stuck = owned.get(rid, 0)
            if stuck:
                problems.append(
                    f"health-quarantined replica {rid} still owns "
                    f"{stuck} request(s) in the pool owner map")
        if inflight is not None and state != "dead":
            expect = owned.get(rid, 0)
            if int(inflight) != expect:
                problems.append(
                    f"replica {rid} limit accounting broken: "
                    f"{int(inflight)} in flight vs {expect} owned — "
                    "admit/release leak")
    if problems:
        raise SanitizerError("[sanitizer] pool health violation: "
                             + "; ".join(problems))


def check_tenant_accounting(replica_engines, registry) -> None:
    """Multi-tenant QoS invariants (docs/SERVING.md "Multi-tenant QoS"),
    armed per ``pool.step`` when a tenancy registry is wired.
    ``replica_engines`` is a list of ``(replica_id, engine)`` for every
    non-dead replica; ``registry`` duck-types ``TenantRegistry``
    (``tenants()`` → specs with ``tenant_id`` / ``cache_blocks``,
    ``outstanding(tid)``). Violations this catches:

    - a tenant's AT-REST cached blocks exceeding its quota while an
      evictable leaf of its own still exists — ``_enforce_quota`` was
      skipped or its eviction miscounted (pure interior/pinned overage
      is legal: evicting it would dangle other tenants' chains);
    - a block manager's per-tenant at-rest ledger disagreeing with a
      recount of its block-owner map — an incremental charge/uncharge
      hook was missed (the drift that quota decisions silently feed on);
    - a negative outstanding-request count can never appear (sets), but a
      tenant with NO registered spec holding outstanding slots means a
      release outlived its registration.

    Duck-typed: engines without a paged block manager contribute nothing.
    """
    problems: List[str] = []
    known = {s.tenant_id for s in registry.tenants()}
    for rid, engine in replica_engines:
        mgr = getattr(engine, "block_mgr", None)
        if mgr is None or not hasattr(mgr, "_block_owner"):
            continue
        ref = mgr._ref
        rest: Dict[str, int] = {}
        for b, o in mgr._block_owner.items():
            if b not in ref:
                rest[o] = rest.get(o, 0) + 1
        if rest != mgr._owner_rest:
            problems.append(
                f"replica {rid}: per-tenant at-rest ledger "
                f"{mgr._owner_rest} != recount {rest} — a charge/uncharge "
                "hook was missed")
        for owner, quota in mgr._owner_quota.items():
            over = rest.get(owner, 0) - quota
            if over <= 0:
                continue
            evictable = any(
                mgr._block_owner.get(b) == owner
                and not mgr._children.get(b)
                for tier in (mgr._lru, mgr._host, mgr._nvme)
                for b in tier)
            if evictable:
                problems.append(
                    f"replica {rid}: tenant {owner!r} is {over} block(s) "
                    f"over its cache quota ({quota}) with an evictable "
                    "leaf of its own still resident — quota enforcement "
                    "skipped")
    for tid in list(getattr(registry, "_outstanding", {})):
        if tid not in known and registry.outstanding(tid):
            problems.append(
                f"unregistered tenant {tid!r} holds "
                f"{registry.outstanding(tid)} outstanding slot(s)")
    if problems:
        raise SanitizerError("[sanitizer] tenant accounting violation: "
                             + "; ".join(problems))


def check_disagg_ownership(replica_views, handoffs,
                           deferred) -> None:
    """Disaggregated-serving invariants (docs/SERVING.md "Disaggregated
    serving"), armed per ``DisaggPool.step`` on top of
    :func:`check_pool_ownership`. ``replica_views`` is a list of
    ``(replica_id, role, journal, all_requests)`` tuples (non-dead
    replicas only); ``handoffs`` maps uid -> the in-flight handoff's
    exported payload dict (``None`` for a replay-degraded handoff);
    ``deferred`` is the set of uids whose handoff the pool deliberately
    postponed this step (no decode headroom / KV not yet at rest).
    Violations this catches:

    - a uid both journaled on a replica AND carried by an in-flight
      handoff — two owners; whichever finishes second double-decodes;
    - a handoff payload whose declared byte count disagrees with the
      bytes its blocks actually hold — KV was dropped or duplicated in
      transit (the in-memory companion of the CRC: the checksum proves
      the bytes are intact, this proves they are conserved — the
      TransferEngine ledger accounted exactly this many out of the
      source);
    - a decode-phase request resident on a prefill-only replica that the
      pool did NOT defer — the handoff dispatcher missed it, and a
      prefill worker is now paying the steady decode cost the role split
      exists to remove.

    Duck-typed (``journal.uids()``, ``Request.state``, payload dicts) —
    no serve/resilience import."""
    problems: List[str] = []
    for rid, role, journal, all_requests in replica_views:
        for uid in journal.uids():
            if uid in handoffs:
                problems.append(
                    f"uid {uid} journaled on replica {rid} AND in an "
                    "in-flight handoff — two owners")
        if role == "prefill":
            for uid, req in all_requests.items():
                state = getattr(getattr(req, "state", None), "value", None)
                if state == "decode" and uid not in deferred:
                    problems.append(
                        f"decode-phase uid {uid} resident on prefill-only "
                        f"replica {rid} without a recorded deferral — "
                        "handoff missed")
    for uid, payload in handoffs.items():
        if payload is None:
            continue  # replay-degraded handoff carries no KV
        declared = int(payload.get("nbytes", -1))
        actual = sum(int(getattr(b, "nbytes", 0))
                     for b in payload.get("blocks", ()))
        if declared != actual:
            problems.append(
                f"uid {uid} handoff payload declares {declared} B but "
                f"its blocks hold {actual} B — KV not conserved in "
                "transit")
    if problems:
        raise SanitizerError("[sanitizer] disagg ownership violation: "
                             + "; ".join(problems))


# ---------------------------------------------------------------------------
# training: partition/gather conservation (ZeRO state)
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# training: partition/gather conservation (checkpoint state)
# ---------------------------------------------------------------------------

def _tree_items(tree, path=""):
    """(path, leaf) pairs of a tree of dicts, lists and tuples, dict keys in
    sorted order (a structure compares equal whatever its insertion order,
    as a jax treedef does)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_items(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_items(v, f"{path}[{i}]")
    else:
        yield path, tree


def _shares_memory(host, src) -> bool:
    """Whether the host leaf's bytes lie inside the source tensor's storage."""
    import numpy as np
    import torch

    if src.device.type != "cpu" or src.untyped_storage().nbytes() == 0:
        return False
    lo = src.untyped_storage().data_ptr()
    hi = lo + src.untyped_storage().nbytes()
    ptr = (host.data_ptr() if isinstance(host, torch.Tensor)
           else host.__array_interface__["data"][0] if isinstance(host, np.ndarray)
           else None)
    return ptr is not None and lo <= ptr < hi


def check_gather_conservation(src_tree, host_tree) -> None:
    """Checkpoint-gather round trip: ``_gather_to_host`` must return a tree
    of the same structure whose every tensor leaf is a host copy of its
    source — a CPU tensor or numpy array of the same shape, element count
    and dtype width, holding its own memory. A leaf still on the card, a
    reshaped or lossy-cast one, or one that still shares the source's
    storage (the next step's in-place update would then change the bytes
    an async save has yet to write) raises. A copy of the JAX package's
    check, with the snapshot condition in place of its sharded gather."""
    import numpy as np
    import torch

    src_items = list(_tree_items(src_tree))
    host_items = list(_tree_items(host_tree))
    if [p for p, _ in src_items] != [p for p, _ in host_items]:
        raise SanitizerError(
            f"[sanitizer] gather changed tree structure: "
            f"{[p for p, _ in src_items]} -> {[p for p, _ in host_items]}")
    for (path, s), (_, h) in zip(src_items, host_items):
        if not isinstance(s, torch.Tensor):
            continue  # scalar/str passthrough leaves gather as themselves
        if isinstance(h, torch.Tensor):
            if h.device.type != "cpu":
                raise SanitizerError(
                    f"[sanitizer] gather leaf {path}: device tensor came back on "
                    f"{h.device}, not as a host copy")
            h_shape, h_size, h_width = tuple(h.shape), h.numel(), h.element_size()
        elif isinstance(h, np.ndarray):
            h_shape, h_size, h_width = tuple(h.shape), int(h.size), h.dtype.itemsize
        else:
            raise SanitizerError(
                f"[sanitizer] gather leaf {path}: tensor came back as "
                f"{type(h).__name__}, not a host array")
        if h_shape != tuple(s.shape):
            raise SanitizerError(
                f"[sanitizer] gather leaf {path} shape not conserved: "
                f"{tuple(s.shape)} -> host {h_shape} (a gather dropped or "
                "duplicated a part)")
        if h_size != s.numel():
            raise SanitizerError(
                f"[sanitizer] gather leaf {path} element count not conserved: "
                f"{s.numel()} -> {h_size}")
        if h_width != s.element_size():
            raise SanitizerError(
                f"[sanitizer] gather leaf {path} dtype width changed: {s.dtype} "
                f"({s.element_size()} B) -> {h_width} B — a lossy cast snuck into "
                "the checkpoint path")
        if h_size and _shares_memory(h, s):
            raise SanitizerError(
                f"[sanitizer] gather leaf {path} shares memory with its source: "
                "not a snapshot, the next in-place update would change it")


def check_offload_split(host_idx, dev_idx, n_leaves: int) -> None:
    """Offload twin-flow partition (zero/offload.py ``split_by_ratio``):
    the host and device index lists must be an exact two-coloring of the
    parameter leaves — disjoint (no leaf optimizer-stepped twice) and
    covering (no leaf never stepped). Checked, as the JAX package checks it,
    at the engine's ``_setup_offload`` and on the index lists a checkpoint
    carries."""
    host_set, dev_set = set(host_idx), set(dev_idx)
    if len(host_set) != len(host_idx) or len(dev_set) != len(dev_idx):
        raise SanitizerError(
            f"[sanitizer] offload split has duplicate indices: host "
            f"{sorted(host_idx)}, dev {sorted(dev_idx)}")
    overlap = host_set & dev_set
    if overlap:
        raise SanitizerError(
            f"[sanitizer] offload split not disjoint: leaves "
            f"{sorted(overlap)} appear in BOTH host and device partitions — "
            "each would be optimizer-stepped twice per step")
    missing = set(range(n_leaves)) - host_set - dev_set
    extra = (host_set | dev_set) - set(range(n_leaves))
    if missing or extra:
        raise SanitizerError(
            f"[sanitizer] offload split does not cover the parameter tree: "
            f"missing leaves {sorted(missing)}, out-of-range "
            f"{sorted(extra)} (n_leaves={n_leaves})")


def check_shard_conservation(leaf_sizes, bounds, shard_slices=None,
                             dtype=None) -> None:
    """ZeRO shard partition (zero/partition.py ``PartitionPlan``): the
    per-rank shards must PARTITION every leaf's flat element range —
    contiguous bounds that start at 0, end at the leaf size, and never run
    backwards (disjoint + covering), with every rank present for every leaf.
    Optionally, ``shard_slices[r][j]`` (the concrete per-rank flat arrays —
    e.g. the slices a sharded checkpoint carries, or the views a gather is
    about to concatenate) are checked against the bounds: element counts and
    dtype must be conserved, so a shard file that was truncated, duplicated,
    or down-cast is caught before its bytes reach optimizer state. Checked at
    partition build, checkpoint save, and consolidation (docs/ZERO.md)."""
    import numpy as np

    n_leaves = len(leaf_sizes)
    if len(bounds) != n_leaves:
        raise SanitizerError(
            f"[sanitizer] shard plan covers {len(bounds)} leaves but the "
            f"parameter tree has {n_leaves}")
    num_shards = None
    for j, (size, bs) in enumerate(zip(leaf_sizes, bounds)):
        bs = list(bs)
        if num_shards is None:
            num_shards = len(bs) - 1
        elif len(bs) - 1 != num_shards:
            raise SanitizerError(
                f"[sanitizer] shard bounds for leaf {j} describe "
                f"{len(bs) - 1} shards, leaf 0 describes {num_shards} — "
                "ranks would disagree on the partition")
        if not bs or bs[0] != 0 or bs[-1] != int(size):
            raise SanitizerError(
                f"[sanitizer] shard bounds for leaf {j} do not cover it: "
                f"bounds {bs} over {int(size)} elements (a dropped head or "
                "tail shard would silently never be optimizer-stepped)")
        for r in range(len(bs) - 1):
            if bs[r] > bs[r + 1]:
                raise SanitizerError(
                    f"[sanitizer] shard bounds for leaf {j} run backwards at "
                    f"rank {r}: {bs} — overlapping shards would double-step "
                    "the shared elements")
    if shard_slices is None:
        return
    if num_shards is None:
        num_shards = 0
    if len(shard_slices) != num_shards:
        raise SanitizerError(
            f"[sanitizer] {len(shard_slices)} shard slice sets for a "
            f"{num_shards}-shard plan — a rank's state is missing or "
            "duplicated")
    for r, slices in enumerate(shard_slices):
        if len(slices) != n_leaves:
            raise SanitizerError(
                f"[sanitizer] shard {r} carries {len(slices)} leaf slices, "
                f"expected {n_leaves}")
        for j, sl in enumerate(slices):
            want = bounds[j][r + 1] - bounds[j][r]
            got = int(np.size(sl))
            if got != want:
                raise SanitizerError(
                    f"[sanitizer] shard {r} leaf {j} size not conserved: "
                    f"{got} elements vs bounds [{bounds[j][r]}, "
                    f"{bounds[j][r + 1]}) = {want}")
            if dtype is not None and np.dtype(getattr(sl, "dtype", dtype)) \
                    != np.dtype(dtype):
                raise SanitizerError(
                    f"[sanitizer] shard {r} leaf {j} dtype changed: "
                    f"{np.dtype(sl.dtype)} vs required {np.dtype(dtype)} — "
                    "a lossy cast snuck into the shard path")
