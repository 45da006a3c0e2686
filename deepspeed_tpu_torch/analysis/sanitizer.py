"""Runtime sanitizer, the checks the serving scheduler and requests call
(counterpart of ``deepspeed_tpu/analysis/sanitizer.py``).

``DSTPU_SANITIZE=1`` (the same variable as the JAX package) arms checked
mode: every ``Request.state`` assignment is validated against the legal
lifecycle graph (:func:`check_transition`), and the scheduler runs the
between-steps and drain checks below. Violations raise
:class:`SanitizerError`, an ``AssertionError`` subclass, so the serving
loop's typed ``RuntimeError`` handling can never swallow one. With the
variable unset everything here is dormant.

The functions are copies of the JAX module's, with its TransferEngine
ledger check (``check_transfer_ledger``). Its checked ``BlockedKVCache``
(``checked_cache_cls``) and the pool, tenancy and training checks come with
ROADMAP.md Queue 1 item 10.
"""

import os
from typing import Dict, FrozenSet, List, Optional

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
