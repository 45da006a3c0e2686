"""Continuous-batching inference engine, paged mode (counterpart of ``deepspeed_tpu/inference/v2/engine_v2.py``).

``InferenceEngineV2(paged=True)`` keeps the KV cache as one blocked pool
``(L, kvh, num_blocks, block_size, hd)`` shared by all sequences through
per-sequence block tables (``ragged_manager.BlockedKVCache``). Every engine
step is one ragged forward over a fixed number of token rows: prefill-chunk
tokens and decode tokens mixed, each row a length-1 segment with its own
position and its sequence's block table. Two row counts exist, as in the JAX
engine: ``token_budget`` and, for a pure decode round, ``max_seqs``.

``put(uids, tokens)`` is the reference surface: new sequences join, pending
tokens advance, and per-uid last-token logits (or selected tokens) come back.
``put(max_steps=...)`` bounds the dispatches (chunked prefill), and the
calls ``ContinuousBatchScheduler`` makes of its engine are here:
``set_sampling``/``refresh_bias`` (per-row threefry sampling and the
per-slot logit-bias pool), ``prefill_backlog``, ``monitor_events``,
``rebuild``, ``prefix_probe`` and ``set_kv_owner``/``set_kv_quota``.
"""

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ...accelerator import resolve_device
from ...models.transformer import sample_or_argmax
from ...ops.quantizer.woq import group_of
from ...ops.quantizer.woq_gemm import check_woq_config
from ...ops.transformer.paged_attention import check_kernel_config
from ...resilience.errors import (ContextOverflowError, EngineUsageError,
                                  PoolExhaustedError)
from ...utils.logging import log_dist
from .ragged_manager import BlockedKVCache, DSStateManager

# the ROADMAP.md items that lift each unported part of the engine
_ENGINE_ITEM = "ROADMAP.md Queue 1 item 5, the rest of the paged engine"
_TIER_ITEM = "ROADMAP.md Queue 1 item 9, KV tiers and swap"


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to deepspeed_tpu_torch ({item})")


class InferenceEngineV2:
    """Continuous-batching engine over a ``TransformerLM``, paged mode.

    The pool ``self.kv`` is updated in place: ``forward_paged`` writes each
    step's K/V with ``index_put_`` and the copy-on-write block copy uses
    ``copy_``, where the JAX engine donates the pool to each compiled
    program and gets a new one back (``engine_v2.py:422``).

    Runs on ``device`` (default ``"cuda"``); without CUDA it raises unless
    ``device="cpu"`` is passed, which runs the plain attention. On CUDA the
    model's attention shape must be one the paged-attention kernel takes,
    and every weight-only-quantized leaf one the WOQ kernel takes;
    otherwise construction raises.
    """

    def __init__(self, model, params=None, *, max_seqs: Optional[int] = None,
                 max_seq_len: Optional[int] = None, prefill_chunk: int = 256,
                 dtype: torch.dtype = torch.float32, paged: bool = False,
                 block_size: int = 64, num_blocks: Optional[int] = None,
                 token_budget: int = 0, prefix_cache: bool = True,
                 decode_horizon: int = 1, host_tier_blocks: int = 0,
                 nvme_tier_blocks: int = 0, nvme_tier_dir: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda"):
        if not paged:
            raise _not_ported("slot mode (paged=False)", _ENGINE_ITEM)
        if decode_horizon != 1:
            raise _not_ported(f"fused multi-token decode (decode_horizon="
                              f"{decode_horizon})", _ENGINE_ITEM)
        if host_tier_blocks or nvme_tier_blocks or nvme_tier_dir:
            raise _not_ported("the host and NVMe KV tiers", _TIER_ITEM)
        self.device = resolve_device(device)
        self.paged = True  # the scheduler reads it
        self.model = model
        self.cfg = model.config
        if self.device.type == "cuda":
            check_kernel_config(self.cfg.num_heads, self.cfg.kv_heads,
                                self.cfg.head_dim, dtype)
        if max_seqs is None:
            max_seqs = 32
        self.max_seqs = max_seqs
        self.max_seq_len = max_seq_len or model.config.max_seq_len
        self.prefill_chunk = prefill_chunk
        self.dtype = dtype
        # every step is ONE ragged forward over exactly token_budget rows
        # (prefill chunks and decodes mixed); a pure decode round uses the
        # max_seqs-row shape instead
        self.token_budget = token_budget or max(max_seqs, min(prefill_chunk, 256))
        if params is None:
            params = model.init_params(
                torch.Generator(device=self.device).manual_seed(0))
        self.params = self._cast_params(params)
        if self.device.type == "cuda":
            self._check_woq_leaves()
        self.state = DSStateManager(max_seqs, self.max_seq_len)
        self.flush_noops = 0  # idempotent-flush debug counter (see flush())
        self.rebuilds = 0     # engine-loss rebuilds (see rebuild())
        #: rows deferred out of a ragged dispatch because their blocks could
        #: not be allocated
        self.plan_deferrals = 0
        #: ragged forwards dispatched (each runs every layer's attention once)
        self.ragged_steps = 0
        # per-shape host scratch for the step inputs, zeroed in place
        self._scratch: Dict[Tuple, Tuple[np.ndarray, ...]] = {}
        self.prefix_cache = bool(prefix_cache)
        max_blocks_per_seq = -(-self.max_seq_len // block_size)
        if num_blocks is None:
            num_blocks = 1 + max_seqs * max_blocks_per_seq  # = slot capacity
        self.block_mgr = BlockedKVCache(num_blocks, block_size, max_blocks_per_seq,
                                        prefix_cache=self.prefix_cache)
        self.kv = model.init_kv_pool(num_blocks, block_size, dtype=dtype,
                                     device=self.device)
        # per-request sampling (``engine_v2.py:190-203``): duck-typed params
        # records (``.seed``/``.temperature``/``.top_k``/``.top_p``) fill
        # per-row arrays each step; bias rows live in a (max_seqs, V) fp32
        # per-slot pool on the device, written at (re-)registration only
        self._sampling: Dict[int, object] = {}
        self._bias_rows: Dict[int, np.ndarray] = {}   # uid -> host row
        self._bias_slots: Dict[int, int] = {}         # uid -> installed slot
        self._bias_pool: Optional[torch.Tensor] = None
        log_dist(
            f"InferenceEngineV2(paged): blocks={num_blocks}x{block_size} "
            f"seqs<={max_seqs} ctx={self.max_seq_len} chunk={prefill_chunk} "
            f"token_budget={self.token_budget} "
            f"prefix_cache={'on' if self.prefix_cache else 'off'} "
            f"device={self.device}",
            ranks=[0],
        )

    def _cast_params(self, tree):
        """Every leaf to the engine's device; float leaves to its dtype,
        except weight-only-quantized leaves, which keep their storage dtype
        (int8 codes, fp32 ``::scale``), as ``engine_v2.py:256-267``. A
        method, not a recursive closure over ``self``: that closure would be
        a reference cycle keeping a deleted engine's device memory until the
        garbage collector runs."""
        out = {}
        for name, a in tree.items():
            if isinstance(a, dict):
                out[name] = self._cast_params(a)
                continue
            a = torch.as_tensor(a)
            if not a.is_floating_point() or name.endswith("::scale"):
                out[name] = a.to(device=self.device)
            else:
                out[name] = a.to(device=self.device, dtype=self.dtype)
        return out

    def _check_woq_leaves(self) -> None:
        """Run the WOQ kernel's gate over every quantized leaf, stacked
        (L, ng, packed, Out), so a tree the kernel cannot take raises here."""
        for name, codes in self.params.get("blocks", {}).items():
            if "::q" in name:
                bits = int(name.rsplit("::q", 1)[1])
                ng, packed, out = codes.shape[-3:]
                group = group_of(bits, packed)
                check_woq_config(ng * group, out, bits, group, self.dtype)

    def _cow(self, src: int, dst: int) -> None:
        """Copy-on-write: duplicate pool block ``src`` into ``dst`` in every
        layer and KV head, in place (the JAX ``_get_cow`` program)."""
        for pool in self.kv:  # (L, kvh, NB, BS, hd); block axis = 2
            pool[:, :, dst].copy_(pool[:, :, src])

    def _ragged(self, ids, tables, starts, logit_rows, greedy: bool, sampling):
        """THE paged-mode step (``_get_ragged``): one ragged forward over the
        rows, projecting only ``logit_rows`` through the vocabulary head.
        Each host array moves to the device in one copy. With ``greedy``
        the rows' tokens are selected on the device from ``lg +
        bias_pool[slots]`` (every step, as the JAX program does: a zero
        row leaves argmax unchanged); ``sampling`` is the step's per-row
        host arrays (slots, seeds, positions, temps, top-ks, top-ps), and
        only the slots cross to the device unless a row samples."""
        dev = self.device
        lg = self.model.forward_paged(
            self.params, torch.from_numpy(ids).to(dev), self.kv,
            torch.from_numpy(tables).to(dev), torch.from_numpy(starts).to(dev),
            logit_rows=torch.from_numpy(logit_rows).to(dev))
        self.ragged_steps += 1
        if greedy:
            slots, seeds, poss, temps, top_ks, top_ps = sampling
            lg = lg + self._bias()[torch.from_numpy(slots).to(dev)]
            return sample_or_argmax(lg, seeds, poss, temps, top_ks, top_ps)
        return lg.float()

    def _scratch_for(self, key: Tuple, shapes, dtypes) -> Tuple[np.ndarray, ...]:
        """Per-shape preallocated host arrays, zeroed in place."""
        bufs = self._scratch.get(key)
        if bufs is None:
            bufs = tuple(np.zeros(s, dt) for s, dt in zip(shapes, dtypes))
            self._scratch[key] = bufs
        else:
            for a in bufs:
                a.fill(0)
        return bufs

    def _put_paged(self, out: Dict[int, object], greedy: bool = False,
                   max_steps: Optional[int] = None) -> None:
        """Advance pending tokens through fixed-budget ragged steps
        (``engine_v2.py:1007``): sequences with the fewest pending tokens go
        first, so live decodes always beat prefill chunks. ``max_steps``
        bounds the dispatches (``None`` drains everything, ``0`` dispatches
        nothing); a sequence whose prompt is not fully consumed keeps its
        ``pending`` tail across calls."""
        steps = 0
        while max_steps is None or steps < max_steps:
            work = [d for d in self.state.seqs.values() if d.in_flight > 0]
            if not work:
                return
            steps += 1
            work.sort(key=lambda d: (d.in_flight, d.slot))
            # decode-round shape: every pending item is one token and they fit
            # in max_seqs rows, so the step does not pay the budget's padding
            if (self.token_budget > self.max_seqs
                    and len(work) <= self.max_seqs
                    and all(d.in_flight == 1 for d in work)):
                T = self.max_seqs
            else:
                T = self.token_budget
            plan: List[Tuple] = []
            used = 0
            for d in work:
                if used >= T:
                    break
                take = min(d.in_flight, self.prefill_chunk, T - used)
                if d.seen_tokens + take > self.max_seq_len:
                    raise ContextOverflowError(
                        f"uid {d.uid}: prompt exceeds context "
                        f"({d.seen_tokens}+{take} > {self.max_seq_len})",
                        uid=d.uid)
                plan.append((d, take))
                used += take
            # allocate blocks for the whole step before mutating any sequence;
            # a row whose blocks cannot be allocated is deferred, and the step
            # raises only when nothing at all can run
            ready: List[Tuple] = []
            pool_exhausted: Optional[PoolExhaustedError] = None
            for d, take in plan:
                try:
                    self.block_mgr.ensure(d, d.seen_tokens + take)
                except PoolExhaustedError as e:
                    pool_exhausted = e
                    self.plan_deferrals += 1
                    continue
                ready.append((d, take))
            if not ready:
                raise pool_exhausted
            plan = ready
            if self.prefix_cache:
                # copy-on-write: a write landing inside a block another
                # sequence also references must first detach a private copy
                bs = self.block_mgr.block_size
                for d, take in plan:
                    first = d.seen_tokens // bs
                    last = min((d.seen_tokens + take - 1) // bs, len(d.blocks) - 1)
                    for j in range(first, last + 1):
                        if self.block_mgr.refcount(d.blocks[j]) > 1:
                            src, dst = self.block_mgr.copy_on_write(d, j)
                            self._cow(src, dst)
            M = self.max_seqs
            (ids, tables, starts, logit_rows, slots, seeds, poss, top_ks,
             temps, top_ps) = self._scratch_for(
                ("ragged", T),
                ((T, 1), (T, self.block_mgr.max_blocks_per_seq), (T,),
                 (M,), (M,), (M,), (M,), (M,), (M,), (M,)),
                (np.int32,) * 8 + (np.float32, np.float32))
            finals = []
            r = 0
            for d, take in plan:
                completes = take == d.in_flight
                r0 = r
                self.block_mgr.fill_table_row(d, tables[r0])
                if take > 1:
                    tables[r0 + 1:r0 + take] = tables[r0]
                for j in range(take):
                    ids[r, 0] = d.pending[j]
                    starts[r] = d.seen_tokens + j
                    r += 1
                if completes:
                    logit_rows[len(finals)] = r - 1
                    # the produced token's absolute index: seen_tokens is
                    # pre-advance here, so the key's position is seen + take
                    self._fill_sampling(d, len(finals), slots, seeds, temps,
                                        top_ks, top_ps, poss, d.seen_tokens + take)
                    finals.append(d)
                if self.prefix_cache:
                    d.history.extend(d.pending[:take])
                del d.pending[:take]
                d.seen_tokens += take
            lg = self._ragged(ids, tables, starts, logit_rows, greedy,
                              (slots, seeds, poss, temps, top_ks, top_ps))
            if self.prefix_cache:
                # the step's writes are issued: every block it filled holds
                # valid prefix content, publish it to the content index
                for d, _ in plan:
                    self.block_mgr.register(d)
            # the step's one device-to-host transfer
            lg = lg[:len(finals)].cpu().numpy()
            for i, d in enumerate(finals):
                out[d.uid] = int(lg[i]) if greedy else lg[i]

    # ------------------------------------------------------------------
    # reference surface
    # ------------------------------------------------------------------
    def put(self, batch_uids: Sequence[int], batch_tokens: Sequence[Sequence[int]],
            greedy: bool = False, max_steps: Optional[int] = None) -> Dict[int, object]:
        """Advance the engine with new/continuing requests (``engine_v2.py:1150``).

        For each uid the tokens are queued (chunked prefill); pending tokens
        then advance through ragged steps. Returns {uid: (V,) float32 numpy
        logits} for every sequence whose pending tokens were all consumed,
        or with ``greedy=True`` {uid: int token} selected on the device
        (argmax, or a threefry draw for a row registered with a
        temperature through ``set_sampling``).

        ``max_steps`` bounds the ragged dispatches: ``None`` drains every
        pending token, ``0`` only registers (the prefix-cache lookup still
        runs), ``N`` runs at most N steps. A sequence whose prompt is not
        fully consumed yields no entry yet.
        """
        if len(batch_uids) > self.state.max_seqs:
            raise EngineUsageError(
                f"batch of {len(batch_uids)} exceeds {self.state.max_seqs} slots")
        for uid, toks in zip(batch_uids, batch_tokens):
            desc = self.state.get_or_create_sequence(uid)
            if self._bias_rows:
                # (re-)bind a pending bias row to this uid's slot: fresh
                # admission, re-admission after preemption, replay
                self._install_bias(desc)
            if toks is not None and len(toks):
                fresh = (self.prefix_cache and desc.seen_tokens == 0
                         and not desc.blocks and not desc.pending)
                desc.pending.extend(int(t) for t in toks)
                if fresh and len(desc.pending) > 1:
                    # prefix-cache admission: map every fully-cached prompt
                    # block into the table and skip those tokens' prefill
                    skipped = self.block_mgr.lookup(desc, desc.pending)
                    if skipped:
                        desc.history.extend(desc.pending[:skipped])
                        del desc.pending[:skipped]
                        desc.seen_tokens = skipped
        out: Dict[int, object] = {}
        self._put_paged(out, greedy=greedy, max_steps=max_steps)
        return out

    def decode_step(self, tokens: Dict[int, int],
                    greedy: bool = False) -> Dict[int, object]:
        """One continuous-batching decode step (``engine_v2.py:1250``): feed
        each live uid its sampled token and get next-token logits (or, with
        ``greedy=True``, the on-device argmax token) for all of them."""
        # all-or-nothing validation before any state is touched
        for uid in tokens:
            d = self.state.seqs[uid]
            if d.seen_tokens + d.in_flight >= self.max_seq_len:
                raise ContextOverflowError(
                    f"uid {uid}: context full ({d.seen_tokens} >= "
                    f"{self.max_seq_len}); flush the sequence or raise "
                    "max_seq_len", uid=uid)
        for uid in tokens:
            d = self.state.seqs[uid]
            self.block_mgr.ensure(d, d.seen_tokens + d.in_flight + 1)
        uids = list(tokens)
        return self.put(uids, [[tokens[u]] for u in uids], greedy=greedy)

    # ------------------------------------------------------------------
    # per-request sampling state (``engine_v2.py:862-963``)
    # ------------------------------------------------------------------
    def _bias(self) -> torch.Tensor:
        """The (max_seqs, vocab) fp32 per-slot bias pool on the device,
        made at first use; zero rows leave selection untouched."""
        if self._bias_pool is None:
            self._bias_pool = torch.zeros((self.max_seqs, self.cfg.vocab_size),
                                          dtype=torch.float32, device=self.device)
        return self._bias_pool

    def _install_bias(self, d) -> None:
        """Copy ``d.uid``'s pending bias row into its slot's pool row, once
        per (uid, slot) binding: re-registration after preemption or a
        rebuild installs into the new slot."""
        row = self._bias_rows.get(d.uid)
        if row is None or self._bias_slots.get(d.uid) == d.slot:
            return
        self._bias()[d.slot].copy_(torch.from_numpy(row))
        self._bias_slots[d.uid] = d.slot

    def _drop_bias(self, uid: int) -> None:
        slot = self._bias_slots.pop(uid, None)
        if slot is not None and self._bias_pool is not None:
            self._bias_pool[slot].zero_()

    def set_sampling(self, uid: int, params, bias_row=None) -> None:
        """Register (or with ``params=None`` clear) a request's sampling
        state before its tokens are fed. ``params`` is duck-typed: the
        engine reads ``.seed``/``.temperature``/``.top_k``/``.top_p``.
        ``bias_row`` is the combined logit-bias row ((vocab,) fp32) or
        None; it is installed into the slot pool at registration and again
        at every slot re-binding. Cleared by :meth:`flush`; re-admission
        re-registers, and the counter-based keys make its replayed samples
        bitwise those of the first pass."""
        if params is None:
            self._sampling.pop(uid, None)
            self._bias_rows.pop(uid, None)
            self._drop_bias(uid)
            return
        self._sampling[uid] = params
        if bias_row is None:
            self._bias_rows.pop(uid, None)
            self._drop_bias(uid)
        else:
            self._bias_rows[uid] = np.asarray(bias_row, np.float32)
            d = self.state.seqs.get(uid)
            if d is not None:
                self._install_bias(d)

    def refresh_bias(self, uid: int, bias_row) -> None:
        """Replace a resident request's bias row (dynamic logit processors
        recompute it per committed token); rewrites the slot's row even when
        the binding is unchanged."""
        if bias_row is None:
            self._bias_rows.pop(uid, None)
            self._drop_bias(uid)
            return
        self._bias_rows[uid] = np.asarray(bias_row, np.float32)
        self._bias_slots.pop(uid, None)
        d = self.state.seqs.get(uid)
        if d is not None:
            self._install_bias(d)

    def _fill_sampling(self, d, i, slots, seeds, temps, top_ks, top_ps, poss,
                       pos) -> None:
        """Row ``i`` of the step's sampling arrays from ``d.uid``'s
        registered params (zeros, plain argmax, otherwise)."""
        slots[i] = d.slot
        sp = self._sampling.get(d.uid)
        if sp is not None:
            seeds[i] = sp.seed
            temps[i] = sp.temperature
            top_ks[i] = sp.top_k
            top_ps[i] = sp.top_p
            poss[i] = pos

    def flush(self, uid: int) -> None:
        """Release a sequence's slot and KV blocks. Idempotent: flushing an
        unknown uid is a counted no-op, never a double free. The sampling
        state goes too: re-admission registers it again."""
        self._sampling.pop(uid, None)
        self._bias_rows.pop(uid, None)
        self._drop_bias(uid)
        if uid not in self.state.seqs:
            self.flush_noops += 1
            log_dist(f"flush({uid}): unknown uid (no-op #{self.flush_noops})",
                     ranks=[0], level=10)  # DEBUG
            return
        self.block_mgr.free(self.state.seqs[uid])
        self.state.flush_sequence(uid)

    def preempt(self, uid: int) -> int:
        """Evict a live sequence under pool pressure; returns how many blocks
        it held. With the prefix cache on, its full blocks stay indexed."""
        desc = self.state.seqs.get(uid)
        freed = len(desc.blocks) if desc is not None else 0
        self.flush(uid)
        return freed

    def rebuild(self) -> None:
        """Engine-loss rebuild (``engine_v2.py:1754``): fresh sequence
        state, block manager and KV pool of the same geometry; the weights
        stay. Resident sequences are not migrated: the scheduler replays
        them from its journal, and the counter-based keys make replayed
        samples bitwise. The host tier and swap store are item 9's and do
        not exist here."""
        old = self.block_mgr
        self.state = DSStateManager(self.max_seqs, self.max_seq_len)
        self._sampling.clear()
        self._bias_rows.clear()
        self._bias_slots.clear()
        self._bias_pool = None
        self.rebuilds += 1
        self.block_mgr = BlockedKVCache(old.num_blocks, old.block_size,
                                        old.max_blocks_per_seq,
                                        prefix_cache=self.prefix_cache)
        self.kv = None  # the old pool leaves the device before the new one
        self.kv = self.model.init_kv_pool(old.num_blocks, old.block_size,
                                          dtype=self.dtype, device=self.device)
        log_dist(f"InferenceEngineV2.rebuild #{self.rebuilds}: block pool replaced "
                 f"({old.num_blocks}x{old.block_size}, prefix cache cold)", ranks=[0])

    def prefill_backlog(self) -> int:
        """Pending (registered but undispatched) tokens across all resident
        sequences: the chunked-prefill backlog. Zero on a drained engine."""
        return sum(d.in_flight for d in self.state.seqs.values())

    def prefix_probe(self, tokens) -> int:
        """Leading full blocks of ``tokens`` present in the prefix content
        index (0 with the prefix cache off); read-only."""
        if not self.prefix_cache:
            return 0
        return self.block_mgr.probe(tokens)

    def set_kv_owner(self, uid: int, owner: str) -> None:
        """Tag ``uid``'s KV blocks with a tenant, billed against its quota."""
        self.block_mgr.set_seq_owner(uid, owner)

    def set_kv_quota(self, owner: str, max_blocks) -> None:
        """Cap ``owner``'s at-rest prefix-cache blocks (``None`` lifts it)."""
        self.block_mgr.set_owner_quota(owner, max_blocks)

    def query(self) -> Tuple[int, int]:
        """(free sequence slots, per-sequence token capacity bounded by the
        free block pool)."""
        free_slots = self.state.max_seqs - self.state.n_active
        return free_slots, min(self.max_seq_len,
                               self.block_mgr.free_blocks * self.block_mgr.block_size)

    def prefix_cache_stats(self) -> Dict[str, float]:
        """Prefix-cache counters: lookups, hits, hit_rate, hit_blocks,
        skipped_prefill_tokens, cow_copies, dedup_blocks, evicted_blocks,
        cached_blocks, free_blocks. Empty when the cache is off."""
        if not self.prefix_cache:
            return {}
        s = dict(self.block_mgr.stats)
        s["hit_rate"] = (s["hits"] / s["lookups"]) if s["lookups"] else 0.0
        s["cached_blocks"] = self.block_mgr.cached_blocks
        s["free_blocks"] = self.block_mgr.free_blocks
        # the KV tiers' and swap's gauges and counters, zero without them
        # (item 9), so dashboards read the same keys as the JAX engine's
        for k in ("host_blocks", "host_capacity_blocks", "host_bytes", "nvme_blocks",
                  "nvme_capacity_blocks", "nvme_bytes", "swap_out", "swap_in",
                  "swap_out_blocks", "swap_in_blocks", "swap_export", "swap_import",
                  "export_blocks", "import_blocks", "orphan_drops", "swap_out_bytes",
                  "swap_in_bytes"):
            s[k] = 0
        return s

    def monitor_events(self, step: int = 0) -> List[Tuple[str, float, int]]:
        """Prefix-cache counters as ``(label, value, step)`` events
        (``engine_v2.py:1864``). The JAX engine's ``serve/transfer/*``
        events come with its TransferEngine (ROADMAP.md Queue 1 item 9)."""
        return [(f"inference/prefix_cache/{k}", float(v), step)
                for k, v in sorted(self.prefix_cache_stats().items())]

    def can_schedule(self, n_new: int = 1) -> bool:
        """Admit only if every new sequence gets a slot and one prefill
        chunk of blocks."""
        if not self.state.can_allocate(n_new):
            return False
        per_seq = self.block_mgr.blocks_needed(min(self.prefill_chunk, self.max_seq_len))
        return self.block_mgr.free_blocks >= n_new * per_seq

    # ------------------------------------------------------------------
    # not in this slice
    # ------------------------------------------------------------------
    def decode_multi(self, tokens, horizon):
        raise _not_ported("decode_multi (fused multi-token decode)", _ENGINE_ITEM)

    def verify_multi(self, tokens, drafts):
        raise _not_ported("verify_multi (speculative verification)", _ENGINE_ITEM)

    def decode_dispatch(self, tokens):
        raise _not_ported("decode_dispatch (pipelined dispatch)", _ENGINE_ITEM)

    def commit_step(self, uid, drop=0, retain=0):
        raise _not_ported("commit_step (pipelined dispatch)", _ENGINE_ITEM)

    def rollback(self, uid, n=0):
        raise _not_ported("rollback", _ENGINE_ITEM)

    def load_params(self, params, version=None):
        raise _not_ported("load_params (hot weight swap)", _ENGINE_ITEM)

    def swap_out(self, uid):
        raise _not_ported("swap_out", _TIER_ITEM)

    def swap_in(self, uid):
        raise _not_ported("swap_in", _TIER_ITEM)

    def export_swap(self, uid):
        raise _not_ported("export_swap (cross-engine KV handoff)", _TIER_ITEM)

    def import_swap(self, uid, payload):
        raise _not_ported("import_swap (cross-engine KV handoff)", _TIER_ITEM)
