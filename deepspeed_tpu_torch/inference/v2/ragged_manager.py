"""Sequence/state management for continuous batching.

Host-only numpy bookkeeping, kept as a copy of
``deepspeed_tpu/inference/v2/ragged_manager.py`` so that this package never
imports the JAX package; ``tests/test_torch_ragged_manager.py`` replays the
same operations against both copies. The text below is the JAX module's.

Reference: ``deepspeed/inference/v2/ragged/`` — ``DSStateManager``
(``ragged_manager.py:19``), ``DSSequenceDescriptor`` (``sequence_descriptor.py``),
``BlockedKVCache`` (``kv_cache.py:40``).

TPU re-design: the reference allocates paged KV blocks and builds ragged batch
descriptors consumed by CUDA kernels with dynamic shapes. Under XLA everything
must be static-shaped, so the cache is a fixed pool of **sequence slots**
(max_seqs × max_seq_len) and the host-side scheduler packs work into bucketed
shapes; "ragged" bookkeeping (who occupies which slot, how far each sequence
has decoded) lives here on the host where shapes don't matter.

Prefix caching (vLLM-style automatic prefix caching, docs/PREFIX_CACHING.md):
``BlockedKVCache`` additionally keeps per-block reference counts and an exact
content index over FULL blocks, chained so a block's key embeds its whole
prefix — ``(parent_block_id, tokens_in_block)``. A new prompt walks the chain
from the root and maps every hit block straight into its block table, skipping
those tokens' prefill entirely. Unreferenced cached blocks park in an LRU and
are reclaimed (leaf-first, so a chain never dangles) when the free list runs
dry. All of this is host-side bookkeeping: device programs see only block
tables, so the fixed-shape discipline of the ragged engine is untouched.

Two-tier cache (docs/PREFIX_CACHING.md "Two-tier cache"): with
``host_tier_blocks > 0`` the allocator grows a host-RAM spill tier under the
device pool — the ZeRO-Infinity memory-wall move applied to inference KV.
LRU reclaim then *demotes* a full prefix block to a pinned host buffer
(``demote_fn``, an engine-supplied async gather) instead of destroying it,
and a content-index hit on a demoted block *promotes* it back: the block is
rekeyed onto a fresh device id immediately (bookkeeping is synchronous) while
the data movement is queued in ``_pending_promotions`` for the engine to
drain — batched, one ``device_put`` per dispatch — before the next program
runs. Demoted blocks live in a disjoint negative-id namespace (< ``_ROOT``)
so a recycled device id can never collide with a host-resident index entry;
``_rekey`` rewrites the index/meta/children edges — including the children's
own keys, which embed the parent id — whenever a block crosses the tier
boundary. The host tier is a cache, never a source of truth: flushes drop it
wholesale and recovery never consults it.

NVMe third tier (docs/TRANSFER.md): with ``nvme_blocks > 0`` host-LRU
eviction *spills* the oldest host block to disk (``spill_fn``) instead of
destroying it. A spill keeps the block's id — host and NVMe ids share the
``< _ROOT`` namespace, so only residency moves (``_host`` → ``_nvme``) and no
rekey is needed; the index chain stays intact and ``probe`` sees all three
tiers. A content hit on an NVMe block loads it back (``load_fn``) straight
onto a device block; a load that fails verification (``load_fn`` returns
None — the TransferEngine's CRC/ring protocol exhausted every slot) drops
the block's whole NVMe subtree and truncates the hit chain there, so the
tokens recompute via normal prefill — corruption degrades to a cache miss,
never to wrong KV. Because children demote before parents and the spill
takes the oldest host entry first, an NVMe block's children are always
NVMe-resident and subtree drops never dangle an edge.
"""

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ...resilience.errors import ContextOverflowError, PoolExhaustedError

#: chain root sentinel for the content index (block ids are >= 0)
_ROOT = -1


@dataclass
class SequenceDescriptor:
    """reference ``DSSequenceDescriptor``: tracked state of one live sequence."""

    uid: int
    slot: int
    seen_tokens: int = 0  # tokens already in the KV cache
    pending: List[int] = field(default_factory=list)  # tokens not yet prefilled
    blocks: List[int] = field(default_factory=list)  # paged mode: pool block ids
    history: List[int] = field(default_factory=list)  # paged: tokens in cache order
    n_indexed: int = 0  # leading blocks registered in the prefix index
    #: cache positions advanced by the LAST fused/verify dispatch that have
    #: not been committed yet — ``rollback`` may truncate at most this many
    #: tokens (committed tokens are immutable: the prefix index may already
    #: cover them) and resets it to 0 (docs/SERVING.md speculative decoding)
    uncommitted: int = 0
    done: bool = False

    @property
    def in_flight(self) -> int:
        return len(self.pending)

    @property
    def at_rest(self) -> bool:
        """True when the sequence sits between dispatches with every cached
        token committed — no pending prefill, no uncommitted speculation,
        holding blocks. The only posture swap-out and cross-engine export
        may capture: anything in flight would be silently dropped by the
        gather (docs/SERVING.md "Disaggregated serving")."""
        return (not self.done and not self.pending and not self.uncommitted
                and bool(self.blocks))


class BlockedKVCache:
    """Paged-block allocator (reference ``ragged/kv_cache.py:40
    BlockedKVCache``): a fixed pool of fixed-size blocks handed to sequences
    on demand. Block 0 is reserved as the trash block masked writes target.

    With ``prefix_cache=True`` the allocator also runs the block-level prefix
    cache: refcounts, the chained content index, and LRU reclaim of cached
    blocks. The engine drives it through four calls — ``lookup`` at admission,
    ``copy_on_write`` before writing into a shared block, ``register`` after a
    step fills blocks, and ``free`` at flush."""

    def __init__(self, num_blocks: int, block_size: int, max_blocks_per_seq: int,
                 prefix_cache: bool = False, host_tier_blocks: int = 0,
                 nvme_blocks: int = 0):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq
        self.prefix_cache = prefix_cache
        #: host-RAM spill tier capacity in blocks; 0 disables the tier and
        #: keeps reclaim byte-identical to the single-tier allocator
        self.host_tier_blocks = host_tier_blocks if prefix_cache else 0
        #: NVMe third-tier capacity in blocks; requires the host tier (spills
        #: only ever come OUT of ``_host``) and engine-supplied spill/load fns
        self.nvme_blocks = nvme_blocks if self.host_tier_blocks else 0
        self._free: List[int] = list(range(1, num_blocks))[::-1]  # 0 reserved
        self._ref: Dict[int, int] = {}  # block -> refcount (present iff > 0)
        # content index: (parent block id | _ROOT, token tuple) -> block id.
        # Exact keys (no hashing) — a collision would silently serve another
        # prompt's KV, so the tokens themselves are the key.
        self._index: Dict[Tuple[int, Tuple[int, ...]], int] = {}
        self._meta: Dict[int, Tuple[Tuple[int, Tuple[int, ...]], int]] = {}
        self._children: Dict[int, set] = {}  # parent block -> indexed children
        #: cached-but-unreferenced blocks, insertion order = eviction order
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        #: host tier: host id (< _ROOT) -> opaque payload handle from
        #: ``demote_fn``; insertion order = host-eviction order
        self._host: "OrderedDict[int, object]" = OrderedDict()
        #: NVMe tier residency: block id (same ``< _ROOT`` namespace as the
        #: host tier — a spill moves residency, never the id), insertion
        #: order = NVMe-eviction order; payloads live on disk, not here
        self._nvme: "OrderedDict[int, None]" = OrderedDict()
        self._next_host_id = _ROOT - 1
        #: (payload, device_block) pairs the engine must scatter onto the
        #: device before its next dispatch (see ``take_promotions``)
        self._pending_promotions: List[Tuple[object, int]] = []
        #: engine-supplied ``block_id -> payload`` async gather; when None the
        #: tier tracks bookkeeping only (host-side unit tests)
        self.demote_fn = None
        #: engine-supplied NVMe hooks: ``spill_fn(hid, payload) -> bool``
        #: persists a host payload to disk, ``load_fn(hid) -> payload|None``
        #: reads it back (None = failed verification), ``drop_fn(hid)``
        #: deletes the on-disk copy; all None = bookkeeping-only tier
        self.spill_fn = None
        self.load_fn = None
        self.drop_fn = None
        self.stats = {"lookups": 0, "hits": 0, "hit_blocks": 0,
                      "skipped_prefill_tokens": 0, "evicted_blocks": 0,
                      "cow_copies": 0, "dedup_blocks": 0,
                      "demoted_blocks": 0, "promoted_blocks": 0,
                      "host_evicted_blocks": 0, "nvme_spilled_blocks": 0,
                      "nvme_loaded_blocks": 0, "nvme_evicted_blocks": 0,
                      "nvme_corrupt_blocks": 0, "quota_evicted_blocks": 0}
        # -- multi-tenant cache quotas (docs/SERVING.md "Multi-tenant QoS").
        # Ownership is charged when a block is first INDEXED (the first
        # registering tenant keeps the charge on dedup — shared content is
        # billed once) and follows the block across tier moves (_rekey).
        # The quota bounds a tenant's AT-REST footprint: indexed blocks no
        # live sequence references (_lru / host / NVMe residents). Blocks
        # pinned by live refs are working set, not cache, and are never
        # quota-evicted. All four maps stay empty on untenanted engines —
        # every hook below is then a dict miss, zero behavior change.
        self._seq_owner: Dict[int, str] = {}     # uid -> tenant
        self._block_owner: Dict[int, str] = {}   # block (any tier) -> tenant
        self._owner_quota: Dict[str, int] = {}   # tenant -> max at-rest blocks
        self._owner_rest: Dict[str, int] = {}    # tenant -> at-rest blocks now

    @property
    def free_blocks(self) -> int:
        """Allocatable blocks: truly free plus cached-evictable."""
        return len(self._free) + len(self._lru)

    @property
    def cached_blocks(self) -> int:
        """Blocks currently holding indexed prefix content (both tiers)."""
        return len(self._meta)

    @property
    def host_blocks(self) -> int:
        """Blocks currently resident in the host-RAM spill tier."""
        return len(self._host)

    @property
    def nvme_resident_blocks(self) -> int:
        """Blocks currently resident in the NVMe third tier."""
        return len(self._nvme)

    def blocks_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    # ------------------------------------------------------------------
    # refcounting + LRU reclaim
    # ------------------------------------------------------------------
    def _incref(self, block: int):
        if block in self._lru:  # cached block comes back into use
            del self._lru[block]
            self._rest_uncharge(block)
        self._ref[block] = self._ref.get(block, 0) + 1

    def _decref(self, block: int):
        r = self._ref[block] - 1
        if r < 0:
            raise AssertionError(f"block {block}: refcount went negative")
        if r:
            self._ref[block] = r
            return
        del self._ref[block]
        if block in self._meta:
            # still carries indexed prefix content: park in the LRU (MRU end)
            # rather than the free list so future prompts can hit it
            self._lru[block] = None
            owner = self._block_owner.get(block)
            if owner is not None:
                self._owner_rest[owner] = self._owner_rest.get(owner, 0) + 1
                self._enforce_quota(owner)
        else:
            self._free.append(block)

    # ------------------------------------------------------------------
    # per-tenant at-rest accounting (see __init__ for the model)
    # ------------------------------------------------------------------
    def _rest_uncharge(self, block: int) -> None:
        owner = self._block_owner.get(block)
        if owner is not None:
            n = self._owner_rest.get(owner, 0) - 1
            if n > 0:
                self._owner_rest[owner] = n
            else:
                self._owner_rest.pop(owner, None)

    def _enforce_quota(self, owner: str) -> None:
        """Shrink ``owner``'s at-rest footprint back under its quota by
        destructively evicting its own oldest cached leaves — never another
        tenant's. A tenant may sit OVER quota when every overage block is
        interior (anchors children, possibly another tenant's extensions) —
        eviction would dangle the chain, so the overage is tolerated until
        the subtree unwinds; the sanitizer only flags over-quota tenants
        that still hold an evictable leaf."""
        quota = self._owner_quota.get(owner)
        if quota is None:
            return
        while (self._owner_rest.get(owner, 0) > quota
               and self._evict_owner_one(owner)):
            pass

    def _evict_owner_one(self, owner: str, device_only: bool = False) -> bool:
        """Destroy one of ``owner``'s at-rest leaf blocks, oldest first,
        coldest tier last only for ``device_only`` (allocation needs a
        *device* block): LRU, then host, then NVMe. Destructive on every
        tier — a quota is a bound on retained content, demoting would just
        move the overage down a tier."""
        for b in self._lru:  # oldest → newest
            if self._block_owner.get(b) == owner and not self._children.get(b):
                del self._lru[b]
                self._unindex(b)
                self.stats["evicted_blocks"] += 1
                self.stats["quota_evicted_blocks"] += 1
                self._free.append(b)
                return True
        if device_only:
            return False
        for b in self._host:
            if self._block_owner.get(b) == owner and not self._children.get(b):
                self._drop_payload(self._host[b])
                self._unindex(b)
                del self._host[b]
                self.stats["host_evicted_blocks"] += 1
                self.stats["quota_evicted_blocks"] += 1
                return True
        for b in self._nvme:
            if self._block_owner.get(b) == owner and not self._children.get(b):
                self._unindex(b)
                del self._nvme[b]
                if self.drop_fn is not None:
                    self.drop_fn(b)
                self.stats["nvme_evicted_blocks"] += 1
                self.stats["quota_evicted_blocks"] += 1
                return True
        return False

    def set_seq_owner(self, uid: int, owner: str) -> None:
        """Tag sequence ``uid``'s future index registrations with ``owner``
        (the tenant id). Called by the scheduler at admission, before the
        first prefill step registers blocks."""
        self._seq_owner[uid] = owner

    def set_owner_quota(self, owner: str, max_blocks: Optional[int]) -> None:
        """Cap ``owner``'s at-rest cached blocks; ``None`` lifts the cap.
        Takes effect immediately: a lowered quota evicts down on the spot."""
        if max_blocks is None:
            self._owner_quota.pop(owner, None)
            return
        self._owner_quota[owner] = int(max_blocks)
        self._enforce_quota(owner)

    def owner_view(self) -> Dict[str, Dict[str, int]]:
        """Per-tenant accounting snapshot for metrics / the sanitizer."""
        out: Dict[str, Dict[str, int]] = {}
        for o in set(self._owner_rest) | set(self._owner_quota):
            out[o] = {"at_rest": self._owner_rest.get(o, 0)}
            if o in self._owner_quota:
                out[o]["quota"] = self._owner_quota[o]
        return out

    def _unindex(self, block: int):
        if block not in self._ref:  # at rest in some tier: leave the ledger
            self._rest_uncharge(block)
        self._block_owner.pop(block, None)
        key, parent = self._meta.pop(block)
        del self._index[key]
        if parent != _ROOT:
            kids = self._children.get(parent)
            if kids is not None:
                kids.discard(block)
                if not kids:
                    del self._children[parent]
        self._children.pop(block, None)

    def _rekey(self, old: int, new: int):
        """Move one indexed block to a new id across the tier boundary,
        rewriting every edge that names it: its own index entry and meta, its
        parent's children set, and — because a child's key embeds the parent
        id — every child's index key and meta. Content-chain identity is
        untouched: the key tokens never change, only the id they resolve to."""
        key, parent = self._meta.pop(old)
        self._index[key] = new
        self._meta[new] = (key, parent)
        owner = self._block_owner.pop(old, None)
        if owner is not None:  # the charge follows the content across tiers
            self._block_owner[new] = owner
        if parent != _ROOT:
            kids = self._children.get(parent)
            if kids is not None:
                kids.discard(old)
                kids.add(new)
        kids = self._children.pop(old, None)
        if kids:
            self._children[new] = kids
            for c in kids:
                ckey, _ = self._meta[c]
                del self._index[ckey]
                nkey = (new, ckey[1])
                self._index[nkey] = c
                self._meta[c] = (nkey, new)

    @staticmethod
    def _drop_payload(payload) -> None:
        """A destroyed tier entry's payload may be an in-flight
        TransferTicket — cancel it so the engine's byte ledger settles the
        bytes as cancelled instead of leaking them as forever-in-flight."""
        cancel = getattr(payload, "cancel", None)
        if cancel is not None:
            cancel()

    def _evict_host_one(self, spill: bool = None) -> bool:
        """Make room in the host tier by one block: *spill* the oldest host
        block to the NVMe tier when one is configured (residency moves, the
        id — and therefore every index/children edge — stays), destroy a
        leaf block otherwise. ``spill=False`` forces the destructive path
        (flushes: dropped content must not resurface by NVMe load).

        The spill takes strictly the OLDEST entry: children demote before
        parents, so FIFO order guarantees an NVMe block's children are
        already NVMe-resident — the invariant subtree drops rely on. The
        destructive path stays leaf-first (no children in any tier), since
        it is the only place tiered content actually dies."""
        if spill is None:
            spill = self.nvme_blocks > 0 and self.spill_fn is not None
        if spill and self._host:
            while len(self._nvme) >= self.nvme_blocks:
                if not self._evict_nvme_one():
                    spill = False  # NVMe wedged: fall back to destruction
                    break
            if spill:
                b = next(iter(self._host))  # oldest
                if self.spill_fn(b, self._host[b]):
                    del self._host[b]
                    self._nvme[b] = None
                    self.stats["nvme_spilled_blocks"] += 1
                    return True
                # spill failed (disk error): fall through and destroy a leaf
        for b in self._host:  # oldest → newest
            if not self._children.get(b):
                self._drop_payload(self._host[b])
                self._unindex(b)
                del self._host[b]
                self.stats["host_evicted_blocks"] += 1
                return True
        # every resident block has children (a promotion holds one leaf out
        # of the scan): tell the caller to fall back to a hard evict
        return False

    def _evict_nvme_one(self) -> bool:
        """Destroy one leaf block of the NVMe tier (oldest first) — the
        bottom of the hierarchy, where eviction finally deletes content."""
        for b in self._nvme:  # oldest → newest
            if not self._children.get(b):
                self._unindex(b)
                del self._nvme[b]
                if self.drop_fn is not None:
                    self.drop_fn(b)
                self.stats["nvme_evicted_blocks"] += 1
                return True
        return False

    def _drop_nvme_subtree(self, root: int) -> None:
        """Drop ``root`` and every descendant from the index and the NVMe
        tier (descendants of an NVMe block are all NVMe-resident). Used when
        a load fails verification: the chain is truncated at the corrupt
        block and everything below it is unreachable content."""
        stack, order = [root], []
        while stack:
            b = stack.pop()
            order.append(b)
            stack.extend(self._children.get(b, ()))
        for b in reversed(order):  # children unindex before their parent
            self._unindex(b)
            self._nvme.pop(b, None)
            if self.drop_fn is not None:
                self.drop_fn(b)

    def _demote(self, b: int) -> bool:
        """Spill device block ``b``'s content to the host tier: gather its KV
        asynchronously (``demote_fn`` must never block the decode dispatch)
        and rekey its index entries onto a fresh host id. Returns False when
        the host tier cannot make room, in which case the caller destroys the
        block the single-tier way."""
        while len(self._host) >= self.host_tier_blocks:
            if not self._evict_host_one():
                return False
        payload = self.demote_fn(b) if self.demote_fn is not None else None
        hid = self._next_host_id
        self._next_host_id -= 1
        self._rekey(b, hid)
        self._host[hid] = payload
        self.stats["demoted_blocks"] += 1
        return True

    def _promote(self, hid: int, uid: int):
        """Bring demoted block ``hid`` back onto the device: allocate a device
        block (refcount 1, for the caller's chain), rekey the index entries
        onto it, and queue the data movement for the engine to drain before
        its next dispatch. Returns the device id, or None when the device
        pool cannot host it (the hit chain is truncated there — the tokens
        recompute, correctness is unaffected).

        NVMe-resident blocks load straight to the device: the disk copy is
        read back (``load_fn``), verified by the TransferEngine's CRC/ring
        protocol, and deleted once promoted. A failed verification drops the
        block's whole NVMe subtree and truncates the hit — corruption
        degrades to recompute, never to wrong KV."""
        if hid in self._nvme:
            del self._nvme[hid]  # hold it out of any eviction scan below
            try:
                dst = self._allocate(uid)
            except PoolExhaustedError:
                self._nvme[hid] = None  # re-shelve and give up
                return None
            payload = self.load_fn(hid) if self.load_fn is not None else None
            if payload is None and self.load_fn is not None:
                self._decref(dst)  # unindexed → straight back to free list
                self._drop_nvme_subtree(hid)
                self.stats["nvme_corrupt_blocks"] += 1
                return None
            if self.drop_fn is not None:
                self.drop_fn(hid)  # promoted: the disk copy is now stale
            self._rekey(hid, dst)
            self._rest_uncharge(dst)  # promoted into a live chain: in use
            self._pending_promotions.append((payload, dst))
            self.stats["nvme_loaded_blocks"] += 1
            self.stats["promoted_blocks"] += 1
            return dst
        payload = self._host.pop(hid)
        try:
            dst = self._allocate(uid)
        except PoolExhaustedError:
            self._host[hid] = payload  # re-shelve (MRU end) and give up
            return None
        self._rekey(hid, dst)
        self._rest_uncharge(dst)  # promoted into a live chain: in use
        self._pending_promotions.append((payload, dst))
        self.stats["promoted_blocks"] += 1
        return dst

    def take_promotions(self) -> List[Tuple[object, int]]:
        """Hand the engine the queued ``(payload, device_block)`` promotion
        orders and clear the queue. The engine batches them into one
        ``device_put`` and scatters per block with a single compiled
        traced-index program — before any dispatch that reads the pool."""
        orders, self._pending_promotions = self._pending_promotions, []
        return orders

    def _evict_one(self, demote: bool = None) -> bool:
        """Reclaim one unreferenced cached block into the free list — by
        demotion to the host tier when one is configured, destructively
        otherwise (``demote=False`` forces the destructive path; flushes use
        it so dropped content cannot resurface by promotion).

        Leaf-first among the LRU: evicting an interior block would leave its
        indexed children keyed on a dead parent id. An unreferenced block's
        descendants are all unreferenced too (a sequence holding a child holds
        the whole chain), so every LRU subtree has its leaves in the LRU and
        the scan below always finds one. With the tier on, "leaf" means no
        *device-resident* children — host-resident children were demoted
        first and ``_rekey`` keeps their keys valid across the move."""
        if demote is None:
            demote = self.host_tier_blocks > 0
        for b in self._lru:  # oldest → newest
            kids = self._children.get(b)
            if kids and (not demote or any(c >= 0 for c in kids)):
                continue
            if demote and self._demote(b):
                del self._lru[b]
                self._free.append(b)
                return True
            if kids:
                # demotion failed (host tier wedged) and b still anchors
                # host-resident children: destroying it would dangle them
                continue
            del self._lru[b]
            self._unindex(b)
            self.stats["evicted_blocks"] += 1
            self._free.append(b)
            return True
        if self._lru:
            if demote:  # wedged host tier: surface as capacity, not corruption
                return False
            # unreachable unless an invariant broke; stay safe
            raise AssertionError("prefix-cache LRU holds only interior blocks")
        return False

    def flush_cache(self):
        """Force-evict every cached (unreferenced) block back to the free
        pool — drops all prefix reuse state held beyond live sequences,
        *including the entire host and NVMe tiers*: a flush marks the
        content stale (e.g. a weight swap), so nothing may survive to
        promote or load back in. NVMe drains first (its blocks may pin host
        parents), then the host tier destructively (never spilling — spilled
        content would resurface)."""
        while self._nvme:
            if not self._evict_nvme_one():  # pragma: no cover - defensive
                raise AssertionError("NVMe tier wedged during flush")
        while self._host:
            if not self._evict_host_one(spill=False):  # pragma: no cover
                raise AssertionError("host tier wedged during flush")
        while self._lru:
            self._evict_one(demote=False)

    def _allocate(self, uid: int) -> int:
        owner = self._seq_owner.get(uid)
        while not self._free:
            # A tenant allocating AT its cache budget reclaims its own
            # at-rest device blocks first — its hot prompt churns its own
            # budget, never another tenant's cached prefixes.
            if (owner is not None
                    and owner in self._owner_quota
                    and self._owner_rest.get(owner, 0)
                    >= self._owner_quota[owner]
                    and self._evict_owner_one(owner, device_only=True)):
                continue
            if not self._evict_one():
                # typed capacity signal (message kept for compat): the
                # scheduler dispatches on the type, not the string
                raise PoolExhaustedError(
                    f"KV block pool exhausted (uid {uid}; "
                    f"{self.num_blocks - 1} usable blocks)", uid=uid)
        b = self._free.pop()
        self._ref[b] = 1
        return b

    # ------------------------------------------------------------------
    # allocation surface (pre-existing)
    # ------------------------------------------------------------------
    def ensure(self, desc: SequenceDescriptor, n_tokens: int):
        """Grow ``desc.blocks`` to cover ``n_tokens`` logical positions."""
        need = self.blocks_needed(n_tokens)
        if need > self.max_blocks_per_seq:
            # per-sequence context wall, same family as the engine's
            # max_seq_len check: permanent and attributable to this uid
            raise ContextOverflowError(
                f"uid {desc.uid}: {n_tokens} tokens need {need} blocks > "
                f"max {self.max_blocks_per_seq} per sequence", uid=desc.uid)
        while len(desc.blocks) < need:
            desc.blocks.append(self._allocate(desc.uid))

    def table_row(self, desc: SequenceDescriptor) -> np.ndarray:
        row = np.zeros((self.max_blocks_per_seq,), np.int32)
        self.fill_table_row(desc, row)
        return row

    def fill_table_row(self, desc: SequenceDescriptor,
                       out: np.ndarray) -> None:
        """Write ``desc``'s block table into ``out`` in place (trailing
        entries zeroed → trash block 0) — the hot-path variant of
        :meth:`table_row`: the engine's step loops fill rows of reused
        scratch instead of allocating a fresh row per sequence per step."""
        n = len(desc.blocks)
        out[:n] = desc.blocks
        out[n:] = 0

    def rollback(self, desc: SequenceDescriptor, n_tokens: int) -> int:
        """Release ``desc``'s trailing blocks past what ``n_tokens`` logical
        positions need (the fused-decode overrun path: a K-step dispatch
        pre-allocates K tokens of blocks; tokens past EOS/max_new_tokens are
        then truncated). Refcount-exact for shared tails — a block mapped in
        by a prefix-cache hit simply drops one reference (parking in the LRU
        if it was the last), it is never force-freed. Returns the number of
        references released."""
        keep = self.blocks_needed(n_tokens)
        freed = 0
        while len(desc.blocks) > keep:
            self._decref(desc.blocks.pop())
            freed += 1
        desc.n_indexed = min(desc.n_indexed, len(desc.blocks))
        return freed

    def free(self, desc: SequenceDescriptor):
        for b in desc.blocks:
            self._decref(b)
        desc.blocks = []
        desc.history = []
        desc.n_indexed = 0
        self._seq_owner.pop(desc.uid, None)

    # ------------------------------------------------------------------
    # prefix cache: lookup / copy-on-write / registration
    # ------------------------------------------------------------------
    def lookup(self, desc: SequenceDescriptor, tokens: Sequence[int]) -> int:
        """Map the longest fully-cached block chain of ``tokens`` into a
        FRESH ``desc``; returns how many leading tokens of ``tokens`` are
        thereby already in the KV cache (their prefill can be skipped).

        Capped at ``len(tokens) - 1``: the engine must still run at least the
        final prompt token to produce logits — a full-prompt hit therefore
        leaves one token pending, whose write lands inside the last shared
        block and triggers copy-on-write."""
        if not self.prefix_cache:
            return 0
        if desc.blocks or desc.seen_tokens:
            raise AssertionError(
                f"uid {desc.uid}: prefix lookup on a non-fresh sequence")
        self.stats["lookups"] += 1
        bs = self.block_size
        chain: List[int] = []
        parent = _ROOT
        while (len(chain) + 1) * bs <= min(
                len(tokens), self.max_blocks_per_seq * bs):
            key = (parent, tuple(int(t) for t in
                                 tokens[len(chain) * bs:(len(chain) + 1) * bs]))
            b = self._index.get(key)
            if b is None:
                break
            if b < _ROOT:
                # hit on a demoted block: promote it back onto the device.
                # The chain built so far is refcounted, so the allocation
                # inside _promote can never demote or evict it from under us.
                b = self._promote(b, desc.uid)
                if b is None:  # no device room: truncate the hit here
                    break
            else:
                self._incref(b)
            chain.append(b)
            parent = b
        if not chain:
            return 0
        skipped = min(len(chain) * bs, len(tokens) - 1)
        desc.blocks = list(chain)
        desc.n_indexed = len(chain)
        self.stats["hits"] += 1
        self.stats["hit_blocks"] += len(chain)
        self.stats["skipped_prefill_tokens"] += skipped
        return skipped

    def probe(self, tokens: Sequence[int]) -> int:
        """Read-only affinity probe (docs/SERVING.md engine pool): how many
        leading FULL blocks of ``tokens`` the content index currently holds.
        Walks the same root-anchored chain as :meth:`lookup` but touches
        nothing — no refcounts, no LRU order, no stats — so a router may
        score every replica per placement without perturbing any cache.
        Deterministic: the exact chained index, not a hash sketch.

        The probe sees EVERY tier: demoted and spilled blocks keep their
        index entries (at negative ids, with child keys rechained by
        ``_rekey``), so the walk crosses tier boundaries transparently and the
        affinity score counts content one promotion away — exactly what a
        placement should weigh, since a hit on a demoted block is a block
        copy, not a recompute."""
        if not self.prefix_cache:
            return 0
        bs = self.block_size
        hits = 0
        parent = _ROOT
        while (hits + 1) * bs <= min(len(tokens),
                                     self.max_blocks_per_seq * bs):
            key = (parent, tuple(int(t) for t in
                                 tokens[hits * bs:(hits + 1) * bs]))
            b = self._index.get(key)
            if b is None:
                break
            hits += 1
            parent = b
        return hits

    def copy_on_write(self, desc: SequenceDescriptor, j: int) -> Tuple[int, int]:
        """Detach ``desc``'s shared block ``j`` before a write: allocate a
        private block, hand back ``(src, dst)`` so the engine copies the KV
        content on device, and repoint the descriptor. Never mutates ``src``
        — other holders keep reading it."""
        src = desc.blocks[j]
        dst = self._allocate(desc.uid)  # src holds refs > 1 → cannot be evicted
        self._decref(src)
        desc.blocks[j] = dst
        desc.n_indexed = min(desc.n_indexed, j)
        self.stats["cow_copies"] += 1
        return src, dst

    def register(self, desc: SequenceDescriptor,
                 limit: Optional[int] = None):
        """Index every newly-filled full block of ``desc`` (chained on its
        predecessor). If an identical block is already indexed, the duplicate
        is deduplicated: ``desc`` adopts the canonical block and its own copy
        returns to the free list — identical content, identical KV.

        ``limit`` caps registration at the first ``limit`` logical tokens:
        only blocks lying ENTIRELY below that boundary are indexed. The
        pipelined dispatch path uses this to publish absorbed (committed)
        content while a provisional tail is still in flight — the index must
        never cover a position a rollback could truncate."""
        if not self.prefix_cache:
            return
        bs = self.block_size
        n_full = desc.seen_tokens // bs
        if limit is not None:
            n_full = min(n_full, limit // bs)
        while desc.n_indexed < n_full:
            j = desc.n_indexed
            if len(desc.history) < (j + 1) * bs:
                raise AssertionError(
                    f"uid {desc.uid}: history shorter than cached tokens")
            parent = desc.blocks[j - 1] if j else _ROOT
            key = (parent, tuple(desc.history[j * bs:(j + 1) * bs]))
            own = desc.blocks[j]
            existing = self._index.get(key)
            if existing is not None and existing < _ROOT:
                # identical content sits demoted in the host or NVMe tier;
                # our copy is freshly written on device and bitwise the same,
                # so adopt it as the canonical block: drop the tiered payload
                # and rekey the demoted id (and any tiered children) onto
                # our block.
                if existing in self._nvme:
                    del self._nvme[existing]
                    if self.drop_fn is not None:
                        self.drop_fn(existing)
                else:
                    self._drop_payload(self._host.pop(existing, None))
                self._rekey(existing, own)
                self._rest_uncharge(own)  # adopted into a live chain: in use
                self.stats["dedup_blocks"] += 1
            elif existing is not None and existing != own:
                self._incref(existing)
                self._decref(own)  # own is unindexed → straight to free list
                desc.blocks[j] = existing
                self.stats["dedup_blocks"] += 1
            elif existing is None:
                self._index[key] = own
                self._meta[own] = (key, parent)
                if parent != _ROOT:
                    self._children.setdefault(parent, set()).add(own)
                # First indexer owns the block: shared content is billed to
                # whoever cached it first, later dedup hits ride for free.
                o = self._seq_owner.get(desc.uid)
                if o is not None:
                    self._block_owner[own] = o
            desc.n_indexed = j + 1

    # ------------------------------------------------------------------
    # invariants (exercised by tests; cheap enough for debug asserts)
    # ------------------------------------------------------------------
    def check_invariants(self, descs: Iterable[SequenceDescriptor] = ()):
        """Raise AssertionError if internal bookkeeping is inconsistent."""
        assert all(r > 0 for r in self._ref.values()), "non-positive refcount"
        free, lru, ref = set(self._free), set(self._lru), set(self._ref)
        host, nvme = set(self._host), set(self._nvme)
        assert not (free & lru) and not (free & ref) and not (lru & ref), \
            "block in more than one pool"
        assert len(free) == len(self._free), "duplicate block in free list"
        assert 0 not in free | lru | ref, "trash block 0 escaped reservation"
        assert len(free | lru | ref) <= self.num_blocks - 1, "phantom block"
        assert all(b < _ROOT for b in host), "device id in the host tier"
        assert all(b < _ROOT for b in nvme), "device id in the NVMe tier"
        assert not (host & nvme), "block resident in both spill tiers"
        assert len(host) <= max(self.host_tier_blocks, 0), "host tier overfull"
        assert len(nvme) <= max(self.nvme_blocks, 0), "NVMe tier overfull"
        for b in host:
            assert b in self._meta, "host-tier block missing from the index"
            kids = self._children.get(b, ())
            assert all(c < _ROOT for c in kids), \
                "host-tier block anchors a device-resident child"
        for b in nvme:
            assert b in self._meta, "NVMe-tier block missing from the index"
            kids = self._children.get(b, ())
            assert all(c in nvme for c in kids), \
                "NVMe-tier block anchors a child above it in the hierarchy"
        for key, b in self._index.items():
            assert self._meta.get(b, (None,))[0] == key, "index/meta mismatch"
            parent = key[0]
            assert parent == _ROOT or parent in self._meta, \
                "indexed block chained on an unindexed parent"
            assert b >= 0 or b in host or b in nvme, \
                "index entry at a demoted block with no tier residence"
        for b in self._meta:
            assert b in ref or b in lru or b in host or b in nvme, \
                "indexed block is in the free list"
        for parent, kids in self._children.items():
            for c in kids:
                assert self._meta.get(c, (None, None))[1] == parent, \
                    "children edge without matching meta parent"
        for _, dst in self._pending_promotions:
            assert dst in ref, "pending promotion targets an unreferenced block"
        assert set(self._block_owner) <= set(self._meta), \
            "owned block missing from the index"
        rest: Dict[str, int] = {}
        for b, o in self._block_owner.items():
            if b not in ref:
                rest[o] = rest.get(o, 0) + 1
        assert rest == self._owner_rest, (
            f"per-tenant at-rest ledger {self._owner_rest} != recount {rest}")
        descs = list(descs)
        if descs:
            counted: Dict[int, int] = {}
            for d in descs:
                for b in d.blocks:
                    counted[b] = counted.get(b, 0) + 1
            assert counted == self._ref, (
                f"refcounts {self._ref} != descriptor holdings {counted}")


class DSStateManager:
    """Slot allocator + sequence registry (reference ``ragged_manager.py:19``)."""

    def __init__(self, max_seqs: int, max_seq_len: int):
        self.max_seqs = max_seqs
        self.max_seq_len = max_seq_len
        self._free: List[int] = list(range(max_seqs))[::-1]
        self.seqs: Dict[int, SequenceDescriptor] = {}

    # reference ``can_schedule`` / ``query`` (engine_v2.py:158,184)
    def can_allocate(self, n_seqs: int = 1) -> bool:
        return len(self._free) >= n_seqs

    def get_or_create_sequence(self, uid: int) -> SequenceDescriptor:
        if uid in self.seqs:
            return self.seqs[uid]
        if not self._free:
            raise PoolExhaustedError(
                f"no free KV slots for uid {uid} (max_seqs={self.max_seqs})",
                uid=uid)
        slot = self._free.pop()
        desc = SequenceDescriptor(uid=uid, slot=slot)
        self.seqs[uid] = desc
        return desc

    def flush_sequence(self, uid: int):
        """Release a finished sequence's slot (reference ``flush_sequence``)."""
        desc = self.seqs.pop(uid, None)
        if desc is not None:
            self._free.append(desc.slot)

    @property
    def n_active(self) -> int:
        return len(self.seqs)

    def active(self) -> List[SequenceDescriptor]:
        return [d for d in self.seqs.values() if not d.done]
