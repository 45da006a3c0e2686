"""Continuous-batching inference engine (counterpart of ``deepspeed_tpu/inference/v2/engine_v2.py``).

Two KV layouts, as in the JAX engine. ``paged=False`` (the default) keeps a
dense slot cache ``(L, max_seqs, max_seq_len, kvh, hd)``, one row a slot:
``put`` prefills pending prompt tokens in chunks of at most
``prefill_chunk``, grouped by padded segment length (a power-of-two bucket
from 16), each group one slot prefill program; ``decode_step`` runs one
program over every slot, writing K/V only for the slots it feeds. Slot
programs read and write the cache in place: a group's attention reads its
slots' rows of the whole cache through the flash forward kernel's
per-row offsets and row index (``attention.py``), with no gathered copy.

``InferenceEngineV2(paged=True)`` keeps the KV cache as one blocked pool
``(L, kvh, num_blocks, block_size, hd)`` shared by all sequences through
per-sequence block tables (``ragged_manager.BlockedKVCache``). Every engine
step is one ragged forward over a fixed number of token rows: prefill-chunk
tokens and decode tokens mixed, each row a length-1 segment with its own
position and its sequence's block table. Two row counts exist, as in the JAX
engine: ``token_budget`` and, for a pure decode round, ``max_seqs``.

``put(uids, tokens)`` is the reference surface: new sequences join, pending
tokens advance, and per-uid last-token logits (or selected tokens) come back.
``put(max_steps=...)`` bounds the dispatches (chunked prefill). The
multi-token steps are here too: ``decode_multi`` (the fused decode horizon),
``verify_multi`` (speculative verification), ``decode_dispatch`` /
``commit_step`` (pipelined dispatch), ``rollback`` and ``load_params``, with
the calls ``ContinuousBatchScheduler`` makes of its engine:
``set_sampling``/``refresh_bias`` (per-row threefry sampling and the per-slot
logit-bias pool), ``prefill_backlog``, ``monitor_events``, ``rebuild``,
``prefix_probe`` and ``set_kv_owner``/``set_kv_quota``.

**Step programs.** The JAX engine compiles a fixed set of step programs and
counts their traces (``ragged_cache_size <= 4``, ``fused_cache_size <= 1``,
``verify_cache_size <= 1``; in slot mode one prefill trace per bucket and
group size, at most 32 a bucket, and at most 2 decode traces, one per
greedy mode). Here each program is a :class:`_StepProgram`:
fixed-shape inputs staged through one host buffer (pinned on the card) and
one device buffer, and on the card one captured CUDA graph per variant.
The counters count the same keys (program, row shape, greedy mode); the
graphs are counted by ``captured_graphs``, which can exceed them because the
port decides the all-greedy skip of sampled selection on the host, so one
key may hold an argmax graph and a sampled one. A key's first step runs
eagerly on a side stream (the warm-up CUDA graphs need) and is then
captured; later steps replay on the engine's stream, in order with the eager
copy-on-write copies. The graphs hold the weights, the KV pool and the bias
pool by address: ``rebuild`` zeroes the pools in place, and ``load_params``,
which rebinds the weights (the caller's trees are never written), drops the
graphs, to be captured again at each key's next step. On the CPU, or with
``capture=False``, every step runs eagerly over the same staged inputs. The
engine's graphs share one memory pool (``torch.cuda.graph_pool_handle``):
they run one at a time on one stream and every step's output is read
before the next step runs, so the up to 32 slot prefill graphs at
llama-7b's size do not each keep a pool of their own. Each program's body
is a module function wrapped by ``analysis.program_audit.audited_program``
under the JAX manifest's name (``engine_v2.ragged`` and the rest), which
under ``DSTPU_AUDIT`` fingerprints a key's eager step and bounds its
signatures; a graph captured unaudited is captured again once the audit is
armed. ``DSTPU_SANITIZE=1`` builds the allocator checked
(``CheckedBlockedKVCache``), here and at every ``rebuild``.

**KV tiers and swap** (paged mode, with the prefix cache;
``engine_v2.py:447-807``). ``host_tier_blocks > 0`` turns pool eviction into
demotion: the block is gathered (a fresh copy) and copied to pinned host
memory through the engine's :class:`~deepspeed_tpu_torch.runtime.transfer_engine.TransferEngine`
(``self.transfer``), and a later prefix hit promotes it back: the payloads
land in a staging buffer, cross in one copy a chunk, and are written into
their pool blocks before the next step reads the pool, on the same stream
and outside any graph. ``nvme_tier_blocks`` with ``nvme_tier_dir`` spills the
host tier's oldest blocks to disk. ``swap_out`` / ``swap_in`` park a
preempted sequence's KV in the host swap store and land it back by block
copy; ``export_swap`` / ``import_swap`` hand it to another engine under a
CRC, and take the JAX engine's payloads as they are (numpy blocks).
``transfer_overlap=False`` is the synchronous twin.
"""

import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ...accelerator import resolve_device
from ...analysis.program_audit import audit_mode, audited_program
from ...analysis.sanitizer import (check_transfer_ledger, checked_cache_cls,
                                   sanitize_enabled)
from ...models.transformer import row_keys, sample_or_argmax
from ...ops import launch_counters
from ...ops.quantizer.woq import group_of
from ...ops.quantizer.woq_gemm import check_woq_config
from ...ops.transformer import flash_attention
from ...ops.transformer.paged_attention import check_kernel_config
from ...resilience.errors import (ContextOverflowError, EngineUsageError,
                                  PoolExhaustedError)
from ...runtime.transfer_engine import (TransferCorruptError, TransferEngine,
                                        blocks_crc32, dtype_name, host_array,
                                        host_tensor)
from ...utils.logging import log_dist
from .ragged_manager import BlockedKVCache, DSStateManager

_TORCH_DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(np.float32): torch.float32}


def _weak_method(obj, name: str) -> Callable:
    """``getattr(obj, name)`` as a hook that holds ``obj`` weakly: the block
    manager's tier hooks would otherwise make a reference cycle through the
    engine, and a deleted engine's device memory would wait for the garbage
    collector."""
    ref = weakref.ref(obj)

    def call(*args):
        return getattr(ref(), name)(*args)

    return call


def _bucket(n: int, lo: int = 16) -> int:
    """The slot prefill's segment length for ``n`` tokens: a power of two
    from ``lo`` (``engine_v2.py:44``)."""
    b = lo
    while b < n:
        b *= 2
    return b


def _host_keys(out: np.ndarray, seeds, positions) -> None:
    """Write the threefry keys of (``seeds``, ``positions``) into ``out``
    (..., 2) int32 as their uint32 words."""
    out[...] = row_keys(np.ascontiguousarray(seeds), np.ascontiguousarray(positions)
                        ).numpy().astype(np.uint32).view(np.int32)


# ---------------------------------------------------------------------------
# the step programs' bodies: module functions of explicit tensors, wrapped
# per engine by ``audited_program`` (``analysis/program_audit.py``) at the
# registration sites of the JAX engine's ``audited_jit`` programs
# ---------------------------------------------------------------------------

def _ragged_step(model, params, kv, bias_pool, ids, tables, starts, logit_rows, slots,
                 seeds, top_ks, temps, top_ps, keys, *, greedy: bool, sampled: bool):
    lg = model.forward_paged(params, ids, kv, tables, starts, logit_rows=logit_rows)
    if not greedy:
        return lg.float()
    return sample_or_argmax(lg, seeds, None, temps, top_ks, top_ps,
                            bias=bias_pool[slots], keys=keys, sampled=sampled)


def _multi_step(model, params, kv, bias_pool, lead, tables, starts, slots, seeds,
                top_ks, temps, top_ps, keys, width: Tuple[int, ...], *, sampled: bool):
    multi = model.decode_paged_multi if width else model.verify_paged_multi
    return multi(params, kv, lead, tables, starts, *width,
                 sampling=(seeds, temps, top_ks, top_ps, bias_pool[slots]),
                 keys=keys, sampled=sampled)


def _slot_prefill_step(model, params, kv, ids, starts, slots, n_valid):
    return model.forward_with_cache(params, ids, kv, starts, kv_rows=slots,
                                    n_valid=n_valid).float()


def _slot_decode_step(model, params, kv, toks, poss, active, *, greedy: bool):
    lg = model.forward_with_cache(params, toks[:, None], kv, poss, active=active)
    return torch.argmax(lg, dim=-1).to(torch.int32) if greedy else lg.float()


def _cow_step(kv, src: int, dst: int) -> None:
    for pool in kv:  # (L, kvh, NB, BS, hd); block axis = 2
        pool[:, :, dst].copy_(pool[:, :, src])


def _gather_step(kv, block: int) -> torch.Tensor:
    k, v = kv
    return torch.stack((k[:, :, block], v[:, :, block]))


def _scatter_step(kv, batch, row: int, dst: int) -> None:
    k, v = kv
    k[:, :, dst].copy_(batch[row, 0])
    v[:, :, dst].copy_(batch[row, 1])


def _bias_set_step(bias_pool, slot: int, row) -> None:
    bias_pool[slot].copy_(row)


class DecodeDispatchHandle:
    """One in-flight decode round (``engine_v2.py:51``):
    :meth:`InferenceEngineV2.decode_dispatch` returns this instead of host
    tokens. The round's (R,) tokens are copied without blocking into a
    pinned host buffer, and :meth:`fetch` waits on the event recorded after
    that copy alone, so the caller plans and dispatches the next round while
    this one runs. Fetch it before the next ``decode_dispatch`` and once per
    dispatch; later calls return the cached result."""

    __slots__ = ("uids", "span", "_host", "_event", "_out", "_eng")

    def __init__(self, uids: List[int], host: torch.Tensor, event=None, eng=None):
        self.uids = uids          # row order of the dispatched round
        self.span = 1             # cache positions each row advanced
        self._host = host         # the tokens' host buffer, filled by the copy
        self._event = event       # recorded after the copy (None on the CPU)
        self._out: Optional[Dict[int, int]] = None
        self._eng = eng           # owner: cleared of this handle at fetch

    def fetch(self) -> Dict[int, int]:
        """Wait for the round's tokens and return ``{uid: int token}``."""
        if self._out is None:
            if self._event is not None:
                self._event.synchronize()  # dstpu-lint: ignore[DSTPU001] the round's one wait
            toks = self._host.numpy()  # dstpu-lint: ignore[DSTPU001] a view of the filled host buffer
            self._out = {uid: int(toks[i]) for i, uid in enumerate(self.uids)}
            self._host = self._event = None
        if self._eng is not None:
            if self._eng._undrained_dispatch is self:
                self._eng._undrained_dispatch = None
            self._eng = None
        return self._out


class _StepProgram:
    """One fixed-shape step program: the counterpart of one compiled JAX
    program at one input shape.

    Every input is a 4-byte field of one host buffer (pinned on the card)
    and of one device buffer with the same layout, so a step's inputs cross
    in one ``copy_``. The engine fills the host fields (numpy views) in
    place after :meth:`stage`, which first waits on the event recorded
    after the previous copy: the host never rewrites the pinned buffer
    before that copy has read it. :meth:`run` then copies and runs the
    step: eagerly on the CPU or with capture off; on the card, a variant's
    first step eagerly on a side stream and then its capture into a CUDA
    graph, and every later step as a replay of that graph on the current
    stream."""

    def __init__(self, device: torch.device, fields):
        sizes = [int(np.prod(shape)) for shape, _ in fields]
        cuda = device.type == "cuda"
        self.host = torch.zeros(sum(sizes), dtype=torch.int32, pin_memory=cuda)
        self.dev = torch.zeros(sum(sizes), dtype=torch.int32, device=device)
        flat = self.host.numpy()
        views, args, off = [], [], 0
        for (shape, dt), n in zip(fields, sizes):
            views.append(flat[off:off + n].view(dt).reshape(shape))
            args.append(self.dev[off:off + n].view(_TORCH_DTYPES[np.dtype(dt)]).reshape(shape))
            off += n
        self.views, self.args = tuple(views), tuple(args)
        self._copied = torch.cuda.Event() if cuda else None
        #: variant -> (graph, its output, the launches its capture counted,
        #: whether the program audit was armed at the capture)
        self.graphs: Dict[Tuple, Tuple] = {}
        self.captures = 0  # graphs captured, including those dropped since

    def stage(self) -> Tuple[np.ndarray, ...]:
        """The host fields, zeroed, once the last copy has read them."""
        if self._copied is not None:
            self._copied.synchronize()  # dstpu-lint: ignore[DSTPU001] the last copy has read the buffer
        self.host.zero_()
        return self.views

    def run(self, variant: Tuple, step: Callable[[], torch.Tensor], capture: bool,
            side: Optional[Callable[[], object]] = None,
            pool: Optional[Callable[[], object]] = None) -> torch.Tensor:
        """Copy the staged inputs to the device, then run ``step`` (a
        function of ``self.args`` and the engine's tensors): eagerly, or
        with ``capture`` (on the card) as set out in the class docstring,
        the graph's memory from the pool ``pool()`` returns. Returns the
        step's output: on a replay the graph's own output tensor, valid
        until the next replay of any graph of that pool."""
        self.dev.copy_(self.host, non_blocking=True)
        if self._copied is not None:
            self._copied.record()
        if not capture:
            return step()
        entry = self.graphs.get(variant)
        if entry is not None and not entry[3] and audit_mode():
            # the armed audit fingerprints a program's eager calls, which a
            # replay does not make: a graph captured unaudited is captured
            # again, once no replay of it is in flight
            torch.cuda.synchronize()  # dstpu-lint: ignore[DSTPU001] armed audit only
            entry = None
        if entry is not None:
            graph, out, counts, _ = entry
            graph.replay()
            launch_counters.add(counts)  # a replay runs no Python
            return out
        cur, stream = torch.cuda.current_stream(), side()
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            out = step()
        cur.wait_stream(stream)
        out.record_stream(cur)
        before = launch_counters.snapshot()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool() if pool else None, stream=stream):
            static = step()
        after = launch_counters.snapshot()
        # what every wrapper counted while capturing, each replay's launches;
        # a counter registered meanwhile started from 0
        counts = [a - (before[i] if i < len(before) else 0) for i, a in enumerate(after)]
        launch_counters.add([-n for n in counts])  # the capture launched nothing
        self.graphs[variant] = (graph, static, counts, bool(audit_mode()))
        self.captures += 1
        return out


class InferenceEngineV2:
    """Continuous-batching engine over a ``TransformerLM``, in slot mode
    (``paged=False``, the default, 8 slots) or paged mode (32 slots).

    The cache ``self.kv`` is updated in place: ``forward_paged`` and
    ``forward_with_cache`` write each step's K/V with ``index_put_`` and the
    copy-on-write block copy uses ``copy_``, where the JAX engine donates the
    cache to each compiled program and gets a new one back
    (``engine_v2.py:422``).

    Runs on ``device`` (default ``"cuda"``); without CUDA it raises unless
    ``device="cpu"`` is passed, which runs the plain attention. On CUDA the
    model's attention shape must be one the paged-attention kernel (paged)
    or the flash kernel (slot mode) takes, and every weight-only-quantized
    leaf one the WOQ kernel takes; otherwise construction raises.
    ``decode_horizon`` is the one fused horizon besides 1 (paged:
    ``decode_multi``, ``verify_multi``). The KV tiers and swap take
    ``host_tier_blocks``, ``nvme_tier_blocks`` with ``nvme_tier_dir`` and
    ``transfer_overlap`` (module docstring). ``capture``
    (default on; an attribute read at every step) replays captured CUDA
    graphs on the card; turning it off runs every step eagerly, which
    exists so that tests can hold the two against each other, as
    ``jax.disable_jit`` does for the JAX engine.
    """

    def __init__(self, model, params=None, *, max_seqs: Optional[int] = None,
                 max_seq_len: Optional[int] = None, prefill_chunk: int = 256,
                 dtype: torch.dtype = torch.float32, paged: bool = False,
                 block_size: int = 64, num_blocks: Optional[int] = None,
                 token_budget: int = 0, prefix_cache: bool = True,
                 decode_horizon: int = 1, host_tier_blocks: int = 0,
                 transfer_overlap: bool = True, nvme_tier_blocks: int = 0,
                 nvme_tier_dir: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda", capture: bool = True):
        # the one fused horizon besides 1 (``engine_v2.py:119-128``)
        if decode_horizon < 1:
            raise ValueError(f"decode_horizon must be >= 1, got {decode_horizon}")
        if decode_horizon > 1 and not paged:
            raise ValueError("decode_horizon > 1 is paged-mode only (the "
                             "fused loop runs over the blocked pool)")
        self.device = resolve_device(device)
        self.paged = bool(paged)  # the scheduler reads it
        self.model = model
        self.cfg = model.config
        if self.device.type == "cuda":
            check = check_kernel_config if self.paged else flash_attention.check_kernel_config
            check(self.cfg.num_heads, self.cfg.kv_heads, self.cfg.head_dim, dtype)
        # the slot layout dedicates max_seqs x max_seq_len of cache, so its
        # default width stays small (``engine_v2.py:106-107``)
        if max_seqs is None:
            max_seqs = 32 if self.paged else 8
        self.max_seqs = max_seqs
        self.max_seq_len = max_seq_len or model.config.max_seq_len
        self.prefill_chunk = prefill_chunk
        self.dtype = dtype
        # every step is ONE ragged forward over exactly token_budget rows
        # (prefill chunks and decodes mixed); a pure decode round uses the
        # max_seqs-row shape instead
        self.token_budget = token_budget or max(max_seqs, min(prefill_chunk, 256))
        self.decode_horizon = decode_horizon
        #: 1 .. decode_horizon: the positions past a row's start that a
        #: sampled fused or verify step keys
        self._horizon_steps = np.arange(1, decode_horizon + 1, dtype=np.int32)
        self.capture = bool(capture)
        if params is None:
            params = model.init_params(
                torch.Generator(device=self.device).manual_seed(0))
        self.params = self._cast_params(params)
        if self.device.type == "cuda":
            self._check_woq_leaves()
        #: label of the served weights, set by ``load_params``
        self.weights_version = None
        self.state = DSStateManager(max_seqs, self.max_seq_len)
        self.flush_noops = 0  # idempotent-flush debug counter (see flush())
        self.rebuilds = 0     # engine-loss rebuilds (see rebuild())
        #: rows deferred out of a ragged dispatch because their blocks could
        #: not be allocated
        self.plan_deferrals = 0
        #: ragged forwards dispatched (each runs every layer's attention once)
        self.ragged_steps = 0
        #: slot programs dispatched, prefill groups and decode steps (each
        #: runs every layer's attention once)
        self.slot_steps = 0
        # per-shape step programs (staged inputs, graphs), made at first use
        self._scratch: Dict[Tuple, _StepProgram] = {}
        # (program, rows, greedy) keys built: the JAX engine's trace keys
        self._keys: set = set()
        # the step programs under their manifest names (``engine_v2.py:347-
        # 880``); the slot prefill's, one a bucket, are made at first use
        self._ragged_fn = audited_program("engine_v2.ragged", _ragged_step, max_traces=4,
                                          variants=("sampled",))
        self._fused_fn = audited_program("engine_v2.fused", _multi_step, max_traces=1,
                                         variants=("sampled",))
        self._verify_fn = audited_program("engine_v2.verify", _multi_step, max_traces=1,
                                          variants=("sampled",))
        self._decode_fn = audited_program("engine_v2.decode", _slot_decode_step, max_traces=2)
        self._prefill_fns: Dict[int, object] = {}
        self._cow_fn = audited_program("engine_v2.cow", _cow_step)
        self._tier_gather_fn = audited_program("engine_v2.tier_gather", _gather_step)
        self._tier_scatter_fn = audited_program("engine_v2.tier_scatter", _scatter_step)
        self._bias_set_fn = audited_program("engine_v2.bias_set", _bias_set_step)
        self._side_stream = None
        self._graph_pool = None  # one memory pool for every graph (module docstring)
        self._dispatch_host: Optional[torch.Tensor] = None
        #: the one unfetched pipelined dispatch (scratch-reuse contract)
        self._undrained_dispatch: Optional[DecodeDispatchHandle] = None
        self.prefix_cache = bool(prefix_cache) and self.paged
        # the host tier needs the prefix cache (its content index finds
        # demoted blocks), the NVMe tier the host tier and a directory
        # (``engine_v2.py:156-166``)
        self.host_tier_blocks = host_tier_blocks if self.prefix_cache else 0
        self.nvme_tier_blocks = nvme_tier_blocks \
            if (self.host_tier_blocks and nvme_tier_dir) else 0
        #: the engine's one owner of host-device byte movement
        self.transfer = TransferEngine(
            overlap=transfer_overlap,
            nvme_dir=nvme_tier_dir if self.nvme_tier_blocks else None, device=self.device)
        #: swapped-out preemption victims and imported handoffs: uid ->
        #: (block payloads, history, seen_tokens); a cache, never the source
        #: of truth (engine loss, weight swaps and flushes drop entries)
        self._swaps: Dict[int, Tuple] = {}
        #: uids whose entry came from another engine through ``import_swap``
        self._swap_imports: set = set()
        self.swap_stats = {"swap_out": 0, "swap_in": 0,
                           "swap_out_blocks": 0, "swap_in_blocks": 0,
                           "swap_export": 0, "swap_import": 0,
                           "export_blocks": 0, "import_blocks": 0,
                           "orphan_drops": 0}
        if self.paged:
            max_blocks_per_seq = -(-self.max_seq_len // block_size)
            if num_blocks is None:
                num_blocks = 1 + max_seqs * max_blocks_per_seq  # = slot capacity
            self.block_mgr = self._new_block_mgr(num_blocks, block_size, max_blocks_per_seq)
            self.block_mgr.demote_fn = _weak_method(self, "_demote_block")
            self._bind_nvme_tier()
            self.kv = model.init_kv_pool(num_blocks, block_size, dtype=dtype,
                                         device=self.device)
            #: device bytes of one block's K+V over all layers: the unit of
            #: every tier and swap byte counter and of the scheduler's
            #: swap-vs-recompute cost model
            self.block_bytes = sum(a.numel() * a.element_size() for a in self.kv) // num_blocks
        else:
            self.block_mgr = None
            self.block_bytes = 0
            # slot cache (L, max_seqs, max_seq_len, kvh, hd)
            self.kv = model.init_kv_cache(max_seqs, self.max_seq_len, dtype=dtype,
                                          device=self.device)
        # per-request sampling (``engine_v2.py:190-203``): duck-typed params
        # records (``.seed``/``.temperature``/``.top_k``/``.top_p``) fill
        # per-row arrays each step; bias rows live in a (max_seqs, V) fp32
        # per-slot pool on the device, written at (re-)registration only
        self._sampling: Dict[int, object] = {}
        self._bias_rows: Dict[int, np.ndarray] = {}   # uid -> host row
        self._bias_slots: Dict[int, int] = {}         # uid -> installed slot
        # made with the engine and written in place: the step graphs read it
        # by address; zero rows leave selection untouched
        self._bias_pool = torch.zeros((max_seqs, self.cfg.vocab_size),
                                      dtype=torch.float32, device=self.device)
        if self.paged:
            log_dist(
                f"InferenceEngineV2(paged): blocks={num_blocks}x{block_size} "
                f"seqs<={max_seqs} ctx={self.max_seq_len} chunk={prefill_chunk} "
                f"token_budget={self.token_budget} decode_horizon={decode_horizon} "
                f"prefix_cache={'on' if self.prefix_cache else 'off'} "
                f"host_tier_blocks={self.host_tier_blocks} device={self.device}",
                ranks=[0],
            )
        else:
            log_dist(f"InferenceEngineV2: slots={max_seqs} ctx={self.max_seq_len} "
                     f"chunk={prefill_chunk} device={self.device}", ranks=[0])

    def _new_block_mgr(self, num_blocks: int, block_size: int,
                       max_blocks_per_seq: int) -> BlockedKVCache:
        """The paged pool's allocator (``engine_v2.py:215-228``): in checked
        mode (``DSTPU_SANITIZE=1``) the sanitizing cache, which re-verifies
        its invariants against the live descriptors after every operation;
        it reads them through a weak reference, so the engine stays free of
        reference cycles."""
        kw = dict(prefix_cache=self.prefix_cache, host_tier_blocks=self.host_tier_blocks)
        if not sanitize_enabled():
            return BlockedKVCache(num_blocks, block_size, max_blocks_per_seq, **kw)
        ref = weakref.ref(self)
        return checked_cache_cls()(num_blocks, block_size, max_blocks_per_seq,
                                   descs=lambda: ref().state.seqs.values(), **kw)

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
        layer and KV head, in place (the JAX ``_get_cow`` program), eagerly
        on the engine's stream, in order with the steps' replays."""
        self._cow_fn(self.kv, src, dst)

    def _cow_span(self, d, n: int) -> None:
        """Detach a private copy of every block shared with another
        sequence that ``d``'s next ``n`` writes land in: shared blocks are
        immutable. Fresh blocks have refcount 1 and are skipped."""
        if not self.prefix_cache:
            return
        bs = self.block_mgr.block_size
        first = d.seen_tokens // bs
        last = min((d.seen_tokens + n - 1) // bs, len(d.blocks) - 1)
        for j in range(first, last + 1):
            if self.block_mgr.refcount(d.blocks[j]) > 1:
                src, dst = self.block_mgr.copy_on_write(d, j)
                self._cow(src, dst)

    # ------------------------------------------------------------------
    # step programs (``engine_v2.py:381-425, 809-857, 979-1005``)
    # ------------------------------------------------------------------
    def _program(self, key: Tuple, fields) -> _StepProgram:
        """The step program of ``key`` (made at first use) with its host
        fields zeroed and ready to fill."""
        prog = self._scratch.get(key)
        if prog is None:
            prog = self._scratch[key] = _StepProgram(self.device, fields)
        prog.stage()
        return prog

    def _capturing(self) -> bool:
        return self.capture and self.device.type == "cuda"

    def _side(self):
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(self.device)
        return self._side_stream

    def _pool(self):
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        return self._graph_pool

    def _ragged_program(self, T: int) -> _StepProgram:
        M, maxb = self.max_seqs, self.block_mgr.max_blocks_per_seq
        i32, f32 = np.int32, np.float32
        return self._program(("ragged", T), (
            ((T, 1), i32), ((T, maxb), i32), ((T,), i32),          # ids, tables, starts
            ((M,), i32), ((M,), i32), ((M,), i32), ((M,), i32),   # logit rows, slots, seeds, poss
            ((M,), i32), ((M,), f32), ((M,), f32), ((M, 2), i32)))  # top-ks, temps, top-ps, keys

    def _ragged(self, prog: _StepProgram, T: int, greedy: bool) -> torch.Tensor:
        """THE paged-mode step (``_get_ragged``): one ragged forward over the
        T rows staged in ``prog``, projecting only the logit rows through the
        vocabulary head. With ``greedy`` the rows' tokens are selected on
        the device from ``lg + bias_pool[slots]`` (every step, as the JAX
        program does: a zero row leaves argmax unchanged), under threefry
        keys derived on the host when a row samples; otherwise the (M, V)
        fp32 logits come back."""
        _, _, _, _, _, seeds, poss, _, temps, _, keys = prog.views
        sampled = bool(greedy and (temps > 0).any())
        if sampled:
            _host_keys(keys, seeds, poss)
        self._keys.add(("ragged", T, greedy))
        self.ragged_steps += 1
        ids, tables, starts, logit_rows, slots, seeds, _, top_ks, temps_d, top_ps, keys_d = \
            prog.args

        def step():
            return self._ragged_fn(self.model, self.params, self.kv, self._bias_pool, ids,
                                   tables, starts, logit_rows, slots, seeds, top_ks, temps_d,
                                   top_ps, keys_d, greedy=greedy, sampled=sampled)

        return prog.run((greedy, sampled), step, self._capturing(), self._side, self._pool)

    # ------------------------------------------------------------------
    # slot-mode programs (``engine_v2.py:321-379``)
    # ------------------------------------------------------------------
    def _slot_prefill(self, grp: List, S: int) -> np.ndarray:
        """One slot prefill program: the group's next segments of at most
        ``S`` tokens (``S`` a bucket) at their slots' offsets, written into
        the cache in place; returns each row's fp32 logits at its last valid
        token. Keyed by (S, group size), as the JAX engine's vmapped trace."""
        n = len(grp)
        prog = self._program(("prefill", S, n), (((n, S), np.int32), ((n,), np.int32),
                                                 ((n,), np.int32), ((n,), np.int32)))
        ids, starts, slots, nval = prog.views
        for i, d in enumerate(grp):
            take = min(S, d.in_flight, self.prefill_chunk)
            ids[i, :take] = d.pending[:take]
            del d.pending[:take]
            starts[i] = d.seen_tokens
            slots[i] = d.slot
            nval[i] = take
            d.seen_tokens += take
        self._keys.add(("prefill", S, n))
        self.slot_steps += 1
        ids_d, starts_d, slots_d, nval_d = prog.args
        fn = self._prefill_fns.get(S)
        if fn is None:
            fn = self._prefill_fns[S] = audited_program("engine_v2.prefill", _slot_prefill_step,
                                                        max_traces=32)

        def step():
            return fn(self.model, self.params, self.kv, ids_d, starts_d, slots_d, nval_d)

        return prog.run((), step, self._capturing(), self._side, self._pool).cpu().numpy()

    def _slot_decode(self, tokens: Dict[int, int], greedy: bool) -> Dict[int, object]:
        """One decode step over every slot (``_get_decode``): the fed slots
        write their token's K/V at their position, the others write nothing
        (``active``); returns each fed uid's fp32 logits or, with ``greedy``,
        its argmax token. Keyed by ``greedy``, as the JAX trace."""
        M = self.max_seqs
        prog = self._program(("decode", greedy), (((M,), np.int32),) * 3)
        toks, poss, active = prog.views
        by_slot: Dict[int, int] = {}
        for uid, tok in tokens.items():
            d = self.state.seqs[uid]
            toks[d.slot] = tok
            poss[d.slot] = d.seen_tokens
            active[d.slot] = 1
            by_slot[d.slot] = uid
            d.seen_tokens += 1
        self._keys.add(("decode", greedy))
        self.slot_steps += 1
        toks_d, poss_d, active_d = prog.args

        def step():
            return self._decode_fn(self.model, self.params, self.kv, toks_d, poss_d, active_d,
                                   greedy=greedy)

        lg = prog.run((), step, self._capturing(), self._side, self._pool).cpu().numpy()
        return {uid: (int(lg[slot]) if greedy else lg[slot]) for slot, uid in by_slot.items()}

    def _slot_program_counts(self) -> Tuple[Dict[int, int], int]:
        """The slot programs built: ({S: prefill keys of bucket S}, decode
        keys), the counts the JAX engine's ``_prefill_fns[S]._cache_size()``
        and ``_decode_fn._cache_size()`` give (bounds 32 and 2)."""
        prefill: Dict[int, int] = {}
        for k in self._keys:
            if k[0] == "prefill":
                prefill[k[1]] = prefill.get(k[1], 0) + 1
        return prefill, sum(k[0] == "decode" for k in self._keys)

    @property
    def ragged_cache_size(self) -> int:
        """Ragged step keys built, (rows, greedy): at most 4, two row shapes
        (the budget and the decode round) in each greedy mode, as the JAX
        engine's trace count (``engine_v2.py:997``)."""
        return sum(k[0] == "ragged" for k in self._keys)

    @property
    def fused_cache_size(self) -> int:
        """Fused-horizon programs built: at most 1 (``engine_v2.py:980``)."""
        return sum(k[0] == "fused" for k in self._keys)

    @property
    def verify_cache_size(self) -> int:
        """Verification programs built: at most 1 (``engine_v2.py:989``)."""
        return sum(k[0] == "verify" for k in self._keys)

    @property
    def captured_graphs(self) -> int:
        """CUDA graphs captured over all programs (0 on the CPU or with
        capture off). A key may hold two, its all-greedy and its sampled
        graph, so this can exceed the sum of the three counters above."""
        return sum(len(p.graphs) for p in self._scratch.values())

    @property
    def graph_captures(self) -> int:
        """CUDA graphs captured over the engine's life: ``captured_graphs``
        plus those ``load_params`` dropped, so the re-captures after a
        weight swap are ``graph_captures - captured_graphs``."""
        return sum(p.captures for p in self._scratch.values())

    def _put_paged(self, out: Dict[int, object], greedy: bool = False,
                   max_steps: Optional[int] = None) -> None:
        """Advance pending tokens through fixed-budget ragged steps
        (``engine_v2.py:1007``): sequences with the fewest pending tokens go
        first, so live decodes always beat prefill chunks. ``max_steps``
        bounds the dispatches (``None`` drains everything, ``0`` dispatches
        nothing); a sequence whose prompt is not fully consumed keeps its
        ``pending`` tail across calls."""
        # queued promotions (admission-time hits on demoted blocks) land
        # before a step reads the pool
        self._drain_promotions()
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
            for d, take in plan:
                self._cow_span(d, take)
            prog = self._ragged_program(T)
            (ids, tables, starts, logit_rows, slots, seeds, poss, top_ks,
             temps, top_ps, _) = prog.views
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
            lg = self._ragged(prog, T, greedy)
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
    # KV tiers: data movement (``engine_v2.py:447-585``)
    # ------------------------------------------------------------------
    def _tier_gather(self, block: int) -> torch.Tensor:
        """Pool block ``block`` as one fresh (2, L, kvh, BS, hd) tensor, K
        stacked on V (the JAX ``_get_tier_gather`` program), on the engine's
        stream in order with its steps."""
        return self._tier_gather_fn(self.kv, block)

    def _tier_buf_shape(self) -> Tuple[int, ...]:
        """The staging batch of promotions and swap-ins: (max_blocks_per_seq,
        2, L, kvh, BS, hd), the JAX engine's fixed capacity (a larger batch
        goes in chunks)."""
        k = self.kv[0]
        return ((self.block_mgr.max_blocks_per_seq, 2)
                + tuple(k.shape[:2]) + tuple(k.shape[3:]))

    def _bind_nvme_tier(self) -> None:
        """Wire the allocator's NVMe hooks to the TransferEngine's store
        (nothing with the tier off)."""
        if not self.nvme_tier_blocks:
            return
        self.block_mgr.nvme_blocks = self.nvme_tier_blocks
        self.block_mgr.spill_fn = _weak_method(self, "_spill_block")
        self.block_mgr.load_fn = _weak_method(self, "_load_block")
        self.block_mgr.drop_fn = _weak_method(self, "_drop_block")

    def _spill_block(self, hid: int, payload) -> bool:
        """Host-LRU eviction hook: write one host-tier payload to the NVMe
        store (manifest last, with its CRC) instead of dropping it."""
        arr = self.transfer.drain_before([payload])[0]
        if arr is None:
            return False
        self.transfer.nvme.save(f"kvblock_{-hid}", arr)
        return True

    def _load_block(self, hid: int):
        """Promotion hook for an NVMe block; None on a file that fails
        verification, and the allocator then truncates the hit there."""
        try:
            return self.transfer.nvme.load(f"kvblock_{-hid}")
        except TransferCorruptError:
            return None

    def _drop_block(self, hid: int) -> None:
        self.transfer.nvme.delete(f"kvblock_{-hid}")

    def _demote_block(self, block: int):
        """The allocator's ``demote_fn``: gather one pool block and start its
        copy to the host; the payload is an open ticket, settled when a
        promotion or a spill needs it."""
        return self.transfer.submit_d2h(self._tier_gather(block))

    def _scatter_blocks(self, payloads, dsts) -> None:
        """Land host payloads (tickets, CPU tensors or numpy blocks) in pool
        blocks ``dsts``: settle the tickets, stage up to the staging batch's
        capacity, copy the whole batch to the card (the JAX engine's one
        ``device_put`` a chunk) and write each row into its block, on the
        engine's stream before the next step reads the pool."""
        if not payloads:
            return
        te = self.transfer
        buf = te.acquire_staging(self._tier_buf_shape(), self.kv[0].dtype)
        try:
            cap = buf.shape[0]
            for base in range(0, len(dsts), cap):
                chunk = range(base, min(base + cap, len(dsts)))
                vals = te.drain_before([payloads[j] for j in chunk])
                for i, val in enumerate(vals):
                    buf[i].copy_(host_tensor(val))
                batch = te.submit_h2d(buf).value
                for i, j in enumerate(chunk):
                    self._tier_scatter_fn(self.kv, batch, i, dsts[j])
        finally:
            te.release_staging(buf)

    def _drain_promotions(self) -> None:
        """Land every queued promotion before the next step reads the pool
        (a prefix hit on a demoted block rekeys the bookkeeping at once and
        queues the bytes here)."""
        if not self.host_tier_blocks:
            return
        orders = self.block_mgr.take_promotions()
        if orders:
            self._scatter_blocks([p for p, _ in orders], [d for _, d in orders])
            if sanitize_enabled():
                check_transfer_ledger(self.transfer)

    # ------------------------------------------------------------------
    # swap preemption and the cross-engine handoff (``engine_v2.py:590-807``)
    # ------------------------------------------------------------------
    @staticmethod
    def _cancel_payloads(payloads) -> None:
        """Drop payloads without landing them: open tickets settle into the
        ledger's cancelled bucket (host arrays pass)."""
        for p in payloads:
            cancel = getattr(p, "cancel", None)
            if cancel is not None:
                cancel()

    def _drop_swaps(self) -> None:
        """Drop every swap-store entry, cancelling its open tickets; each
        imported entry dropped here is an orphaned handoff
        (``orphan_drops``)."""
        for payloads, _, _ in self._swaps.values():
            self._cancel_payloads(payloads)
        self.swap_stats["orphan_drops"] += len(self._swap_imports)
        self._swap_imports.clear()
        self._swaps.clear()

    def swap_resident(self, uid: int) -> bool:
        """True when ``uid``'s KV is parked in the host swap store."""
        return uid in self._swaps

    def swap_out(self, uid: int) -> bool:
        """Preempt a live sequence by parking its KV in host memory: start
        the copy of every held block, then flush the sequence (slot and
        blocks reclaimed). Returns False, doing nothing, where swapping does
        not apply (no host tier, unknown uid, pending prefill, uncommitted
        speculation): the caller flushes and replays instead."""
        if not self.host_tier_blocks:
            return False
        d = self.state.seqs.get(uid)
        if d is None or not d.at_rest:
            return False
        payloads = [self.transfer.submit_d2h(self._tier_gather(b)) for b in d.blocks]
        entry = (payloads, list(d.history), d.seen_tokens)
        self.flush(uid)
        self._swaps[uid] = entry
        self.swap_stats["swap_out"] += 1
        self.swap_stats["swap_out_blocks"] += len(payloads)
        return True

    def swap_in(self, uid: int) -> bool:
        """Re-admit a swapped-out sequence by block copy: allocate blocks,
        land the payloads, restore the descriptor as it was at swap-out and
        register it (the dedup pass folds it back onto shared index
        blocks). Returns False, with the entry consumed and every partial
        step undone, when no slot or not enough blocks are free: the caller
        replays the prompt instead."""
        entry = self._swaps.pop(uid, None)
        if entry is None:
            return False
        self._swap_imports.discard(uid)  # landing: the import is not orphaned
        payloads, history, seen = entry
        if not self.state.can_allocate():
            self._cancel_payloads(payloads)
            return False
        desc = self.state.get_or_create_sequence(uid)
        try:
            self.block_mgr.ensure(desc, seen)
        except (PoolExhaustedError, ContextOverflowError):
            self.block_mgr.free(desc)
            self.state.flush_sequence(uid)
            self._cancel_payloads(payloads)
            return False
        assert len(desc.blocks) == len(payloads), f"uid {uid}: swap-in geometry drift"
        self._drain_promotions()  # pool writes in queue order
        self._scatter_blocks(payloads, desc.blocks)
        if sanitize_enabled():
            check_transfer_ledger(self.transfer)
        desc.history = list(history)
        desc.seen_tokens = seen
        desc.n_indexed = 0
        if self.prefix_cache:
            self.block_mgr.register(desc)
        if self._bias_rows:
            self._install_bias(desc)  # re-bind the bias row to the new slot
        self.swap_stats["swap_in"] += 1
        self.swap_stats["swap_in_blocks"] += len(payloads)
        return True

    def export_ready(self, uid: int) -> bool:
        """True when ``uid``'s KV could be exported now: parked in the swap
        store, or live and at rest (False on slot engines)."""
        if not self.paged:
            return False
        if uid in self._swaps:
            return True
        d = self.state.seqs.get(uid)
        return d is not None and d.at_rest

    def export_swap(self, uid: int):
        """Take ``uid``'s at-rest KV out of this engine for another engine:
        copy every block to the host (the handoff's one wait), flush the
        sequence and return a payload dict stamped with a CRC32 over the
        block bytes. Blocks are numpy arrays, as the JAX engine's (CPU
        tensors where numpy has no such dtype: bfloat16), so a payload of
        either package imports into the other. Returns None, leaving the
        engine unchanged, where export does not apply: the caller replays."""
        if not self.paged:
            return None
        entry = self._swaps.pop(uid, None)
        if entry is not None:
            self._swap_imports.discard(uid)
            payloads, history, seen = entry
            blocks = self.transfer.drain_before(payloads)
        else:
            d = self.state.seqs.get(uid)
            if d is None or not d.at_rest:
                return None
            tickets = [self.transfer.submit_d2h(self._tier_gather(b)) for b in d.blocks]
            blocks = self.transfer.drain_before(tickets)
            history, seen = list(d.history), d.seen_tokens
            self.flush(uid)
        if any(b is None for b in blocks):
            return None  # a payload did not settle: the caller replays
        tensors = [host_tensor(b) for b in blocks]
        blocks = [host_array(t) for t in tensors]
        self.swap_stats["swap_export"] += 1
        self.swap_stats["export_blocks"] += len(blocks)
        return {
            "uid": uid,
            "blocks": blocks,
            "history": list(history),
            "seen_tokens": int(seen),
            "nbytes": sum(t.numel() * t.element_size() for t in tensors),
            "crc32": blocks_crc32(blocks),
            "block_shape": tuple(self._tier_buf_shape()[1:]),
            "dtype": dtype_name(self.kv[0]),
        }

    def import_swap(self, uid: int, payload) -> int:
        """Install another engine's exported payload (either package's) in
        this engine's swap store, from where ``swap_in`` lands it. Validates
        first, so a refused import leaves the engine untouched: a uid
        already swap-resident or live, or geometry drift (block shape or
        dtype, block count for ``seen_tokens``) raise
        :class:`EngineUsageError`; a CRC mismatch raises
        ``TransferCorruptError``. Returns the payload's byte count."""
        if not self.paged:
            raise EngineUsageError("import_swap is paged-mode only", uid=uid)
        if uid in self._swaps:
            raise EngineUsageError(
                f"uid {uid}: double import — already swap-resident here", uid=uid)
        if uid in self.state.seqs:
            raise EngineUsageError(
                f"uid {uid}: import over a live sequence — the uid would "
                "be resident in two stores", uid=uid)
        blocks = payload["blocks"]
        seen = int(payload["seen_tokens"])
        shape = tuple(self._tier_buf_shape()[1:])
        dtype = dtype_name(self.kv[0])
        need = self.block_mgr.blocks_needed(seen)
        if len(blocks) != need or len(blocks) > self.block_mgr.max_blocks_per_seq:
            raise EngineUsageError(
                f"uid {uid}: import geometry drift — {len(blocks)} blocks "
                f"for {seen} tokens (this pool needs {need}, cap "
                f"{self.block_mgr.max_blocks_per_seq})", uid=uid)
        for b in blocks:
            if tuple(b.shape) != shape or dtype_name(b) != dtype:
                raise EngineUsageError(
                    f"uid {uid}: import geometry drift — block "
                    f"{tuple(b.shape)}/{dtype_name(b)} vs pool {shape}/{dtype}", uid=uid)
        if blocks_crc32(blocks) != int(payload["crc32"]):
            raise TransferCorruptError(
                f"uid {uid}: handoff payload failed CRC verification")
        self._swaps[uid] = (list(blocks), list(payload["history"]), seen)
        self._swap_imports.add(uid)
        self.swap_stats["swap_import"] += 1
        self.swap_stats["import_blocks"] += len(blocks)
        return int(payload["nbytes"])

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

        In slot mode every pending token is prefilled (``greedy`` and
        ``max_steps`` are paged-mode only, as in the JAX engine), in chunks
        of at most ``prefill_chunk`` grouped by bucket, and the logits of
        each sequence whose prompt is consumed come back.
        """
        if len(batch_uids) > self.state.max_seqs:
            raise EngineUsageError(
                f"batch of {len(batch_uids)} exceeds {self.state.max_seqs} slots")
        if greedy and not self.paged:
            raise ValueError(
                "put(greedy=True) is paged-mode only (the slot prefill path "
                "returns logits; decode_step supports greedy in both modes)")
        if max_steps is not None and not self.paged:
            raise ValueError(
                "put(max_steps=...) is paged-mode only (slot prefill has no "
                "mixed ragged dispatch to bound)")
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
        if self.paged:
            self._put_paged(out, greedy=greedy, max_steps=max_steps)
        else:
            self._put_slots(out)
        return out

    def _put_slots(self, out: Dict[int, object]) -> None:
        """Slot mode's chunked prefill (``engine_v2.py:1208-1248``): each
        round takes every pending sequence's next chunk, grouped by padded
        segment length; a sequence near the end of its slot gets an
        exact-fit segment, and one whose chunk does not fit raises."""
        while True:
            work = [d for d in self.state.seqs.values() if d.in_flight > 0]
            if not work:
                return
            groups: Dict[int, List] = {}
            for d in work:
                take = min(self.prefill_chunk, d.in_flight)
                room = self.max_seq_len - d.seen_tokens
                if room < take:
                    raise ContextOverflowError(
                        f"uid {d.uid}: prompt exceeds slot context "
                        f"({d.seen_tokens}+{take} > {self.max_seq_len})", uid=d.uid)
                groups.setdefault(min(_bucket(take), room), []).append(d)
            for S, grp in groups.items():
                lg = self._slot_prefill(grp, S)
                for i, d in enumerate(grp):
                    if d.in_flight == 0:  # the prompt is consumed: its logits are live
                        out[d.uid] = lg[i]

    def decode_step(self, tokens: Dict[int, int],
                    greedy: bool = False) -> Dict[int, object]:
        """One continuous-batching decode step (``engine_v2.py:1250``): feed
        each live uid its sampled token and get next-token logits (or, with
        ``greedy=True``, the on-device argmax token) for all of them."""
        if not self.paged:
            # every uid validated before any state is touched
            for uid in tokens:
                d = self.state.seqs[uid]
                if d.seen_tokens >= self.max_seq_len:
                    raise ContextOverflowError(
                        f"uid {uid}: context full ({d.seen_tokens} >= {self.max_seq_len}); "
                        "flush the sequence or raise max_seq_len", uid=uid)
            return self._slot_decode(tokens, greedy)
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
    def _install_bias(self, d) -> None:
        """Copy ``d.uid``'s pending bias row into its slot's pool row, once
        per (uid, slot) binding: re-registration after preemption or a
        rebuild installs into the new slot."""
        row = self._bias_rows.get(d.uid)
        if row is None or self._bias_slots.get(d.uid) == d.slot:
            return
        self._bias_set_fn(self._bias_pool, d.slot, torch.from_numpy(row))
        self._bias_slots[d.uid] = d.slot

    def _drop_bias(self, uid: int) -> None:
        slot = self._bias_slots.pop(uid, None)
        if slot is not None:
            self._bias_pool[slot].zero_()

    def set_sampling(self, uid: int, params, bias_row=None) -> None:
        """Register (or with ``params=None`` clear) a request's sampling
        state before its tokens are fed. ``params`` is duck-typed: the
        engine reads ``.seed``/``.temperature``/``.top_k``/``.top_p``.
        ``bias_row`` is the combined logit-bias row ((vocab,) fp32) or
        None; it is installed into the slot pool at registration and again
        at every slot re-binding. Cleared by :meth:`flush`; re-admission
        re-registers, and the counter-based keys make its replayed samples
        bitwise those of the first pass. Paged mode only."""
        if not self.paged:
            raise ValueError("set_sampling is paged-mode only (sampled "
                             "selection rides the ragged/fused/verify "
                             "programs)")
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

    def _fill_sampling(self, d, i, slots, seeds, temps, top_ks, top_ps, poss=None,
                       pos=0) -> None:
        """Row ``i`` of the step's sampling arrays from ``d.uid``'s
        registered params (zeros, plain argmax, otherwise)."""
        slots[i] = d.slot
        sp = self._sampling.get(d.uid)
        if sp is not None:
            seeds[i] = sp.seed
            temps[i] = sp.temperature
            top_ks[i] = sp.top_k
            top_ps[i] = sp.top_p
            if poss is not None:
                poss[i] = pos

    def flush(self, uid: int) -> None:
        """Release a sequence's slot and (paged) KV blocks. Idempotent:
        flushing an unknown uid is a counted no-op, never a double free. The
        sampling state goes too: re-admission registers it again. A
        swapped-out uid's entry is dropped (an imported one is counted in
        ``orphan_drops``)."""
        self._sampling.pop(uid, None)
        self._bias_rows.pop(uid, None)
        self._drop_bias(uid)
        if uid not in self.state.seqs:
            entry = self._swaps.pop(uid, None)
            if entry is not None:
                self._cancel_payloads(entry[0])
                if uid in self._swap_imports:
                    self._swap_imports.discard(uid)
                    self.swap_stats["orphan_drops"] += 1
                return
            self.flush_noops += 1
            log_dist(f"flush({uid}): unknown uid (no-op #{self.flush_noops})",
                     ranks=[0], level=10)  # DEBUG
            return
        if self.paged:
            self.block_mgr.free(self.state.seqs[uid])
        self.state.flush_sequence(uid)

    def preempt(self, uid: int) -> int:
        """Evict a live sequence under pool pressure; returns how many blocks
        it held (0 in slot mode). With the prefix cache on, its full blocks
        stay indexed."""
        desc = self.state.seqs.get(uid)
        freed = len(desc.blocks) if (desc is not None and self.paged) else 0
        self.flush(uid)
        return freed

    def rebuild(self) -> None:
        """Engine-loss rebuild (``engine_v2.py:1754``): fresh sequence state
        and block manager, and a KV pool and bias pool as a fresh engine has
        them; the weights and the step programs stay. The pools are zeroed
        in place, not reallocated, so the captured graphs, which hold them
        by address, replay against them unchanged (the JAX engine keeps its
        compiled programs across a rebuild too). Resident sequences are not
        migrated: the scheduler replays them from its journal, and the
        counter-based keys make replayed samples bitwise. An unfetched
        dispatch dies with the incarnation. The host and NVMe tiers and the
        swap store die with it too (caches of a pool that no longer exists):
        open transfer tickets are cancelled, swap entries dropped and the
        old tier's NVMe files deleted. A slot engine's cache is zeroed in
        place likewise."""
        self.state = DSStateManager(self.max_seqs, self.max_seq_len)
        self._undrained_dispatch = None
        self.transfer.cancel_all()
        self._drop_swaps()  # counts any orphaned handoff imports
        self._sampling.clear()
        self._bias_rows.clear()
        self._bias_slots.clear()
        self._bias_pool.zero_()
        self.rebuilds += 1
        for pool in self.kv:
            pool.zero_()
        if not self.paged:
            log_dist(f"InferenceEngineV2.rebuild #{self.rebuilds}: slot cache cleared "
                     f"({self.max_seqs} slots), step programs retained", ranks=[0])
            return
        old = self.block_mgr
        self.block_mgr = self._new_block_mgr(old.num_blocks, old.block_size,
                                             old.max_blocks_per_seq)
        if self.nvme_tier_blocks:
            for hid in list(old._nvme):
                self._drop_block(hid)
        self.block_mgr.demote_fn = _weak_method(self, "_demote_block")
        self._bind_nvme_tier()
        log_dist(f"InferenceEngineV2.rebuild #{self.rebuilds}: block pool cleared "
                 f"({old.num_blocks}x{old.block_size}, prefix cache cold), step "
                 "programs retained", ranks=[0])

    def _drop_graphs(self) -> None:
        """Drop every captured graph: each key's next step runs eagerly and
        is captured again."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # no replay of a graph dropped here runs on
        for prog in self._scratch.values():
            prog.graphs.clear()

    def prefill_backlog(self) -> int:
        """Pending (registered but undispatched) tokens across all resident
        sequences: the chunked-prefill backlog. Zero on a drained engine."""
        return sum(d.in_flight for d in self.state.seqs.values())

    def prefix_probe(self, tokens) -> int:
        """Leading full blocks of ``tokens`` present in the prefix content
        index, either tier (0 for slot engines or with the prefix cache
        off); read-only."""
        if not self.prefix_cache:
            return 0
        return self.block_mgr.probe(tokens)

    def set_kv_owner(self, uid: int, owner: str) -> None:
        """Tag ``uid``'s KV blocks with a tenant, billed against its quota
        (a no-op on slot engines)."""
        if self.paged:
            self.block_mgr.set_seq_owner(uid, owner)

    def set_kv_quota(self, owner: str, max_blocks) -> None:
        """Cap ``owner``'s at-rest prefix-cache blocks (``None`` lifts it; a
        no-op on slot engines)."""
        if self.paged:
            self.block_mgr.set_owner_quota(owner, max_blocks)

    def query(self) -> Tuple[int, int]:
        """(free sequence slots, per-sequence token capacity, in paged mode
        bounded by the free block pool)."""
        free_slots = self.state.max_seqs - self.state.n_active
        if not self.paged:
            return free_slots, self.max_seq_len
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
        # the host and NVMe tiers' gauges and the swap counters (zero with
        # the tiers off)
        s["host_blocks"] = self.block_mgr.host_blocks
        s["host_capacity_blocks"] = self.host_tier_blocks
        s["host_bytes"] = self.block_mgr.host_blocks * self.block_bytes
        nvme_res = self.block_mgr.nvme_resident_blocks
        s["nvme_blocks"] = nvme_res
        s["nvme_capacity_blocks"] = self.nvme_tier_blocks
        s["nvme_bytes"] = nvme_res * self.block_bytes
        s.update(self.swap_stats)
        s["swap_out_bytes"] = self.swap_stats["swap_out_blocks"] * self.block_bytes
        s["swap_in_bytes"] = self.swap_stats["swap_in_blocks"] * self.block_bytes
        return s

    def monitor_events(self, step: int = 0) -> List[Tuple[str, float, int]]:
        """Prefix-cache counters as ``(label, value, step)`` events
        (``engine_v2.py:1864``), and the TransferEngine's bandwidth EMAs and
        ledger bytes under ``serve/transfer/*``."""
        events = [(f"inference/prefix_cache/{k}", float(v), step)
                  for k, v in sorted(self.prefix_cache_stats().items())]
        events.extend(self.transfer.monitor_events("serve/transfer", step))
        return events

    def can_schedule(self, n_new: int = 1) -> bool:
        """Admit only if every new sequence gets a slot and, in paged mode,
        one prefill chunk of blocks."""
        if not self.state.can_allocate(n_new):
            return False
        if not self.paged:
            return True
        per_seq = self.block_mgr.blocks_needed(min(self.prefill_chunk, self.max_seq_len))
        return self.block_mgr.free_blocks >= n_new * per_seq

    # ------------------------------------------------------------------
    # multi-token steps (``engine_v2.py:1304-1706``)
    # ------------------------------------------------------------------
    def _check_multi(self, tokens, K: int, what: str) -> List:
        """The fused and verify steps' all-or-nothing validation and block
        pre-allocation (positions seen .. seen+K-1, so a raise leaves every
        descriptor intact and the step retries verbatim), then
        copy-on-write over every block the K writes reach. Returns the
        descriptors in slot order, the row order of the program."""
        if not self.paged:
            raise ValueError(f"{what} is paged-mode only")
        if len(tokens) > self.max_seqs:
            raise EngineUsageError(
                f"batch of {len(tokens)} exceeds {self.max_seqs} slots")
        for uid in tokens:
            d = self.state.seqs[uid]  # unknown uid: loud KeyError
            if d.in_flight:
                raise EngineUsageError(
                    f"uid {uid}: {d.in_flight} pending prefill tokens — "
                    f"drain before {what}", uid=uid)
            if d.seen_tokens + K > self.max_seq_len:
                raise ContextOverflowError(
                    f"uid {uid}: {what} width {K} exceeds context "
                    f"({d.seen_tokens}+{K} > {self.max_seq_len}); collapse "
                    "to horizon 1 or flush the sequence", uid=uid)
        self._drain_promotions()  # queued tier promotions land first
        for uid in tokens:
            d = self.state.seqs[uid]
            self.block_mgr.ensure(d, d.seen_tokens + K)
        descs = sorted((self.state.seqs[u] for u in tokens), key=lambda d: d.slot)
        for d in descs:
            self._cow_span(d, K)
        return descs

    def _multi_program(self, name: str, B: int, K: int) -> _StepProgram:
        """The fused (``toks`` (B,), keys (K, B, 2)) or verify (``segs``
        (B, K), keys (B, K, 2)) program's staged inputs."""
        i32, f32 = np.int32, np.float32
        lead, keys = (((B,), i32), ((K, B, 2), i32)) if name == "fused" else \
            (((B, K), i32), ((B, K, 2), i32))
        return self._program((name, B, K), (
            lead, ((B, self.block_mgr.max_blocks_per_seq), i32), ((B,), i32),
            ((B,), i32), ((B,), i32), ((B,), i32), ((B,), f32), ((B,), f32), keys))

    def _run_multi(self, name: str, prog: _StepProgram, K: int) -> np.ndarray:
        """Run the fused or verify program staged in ``prog``; returns the
        (B, K) tokens on the host (the step's one device-to-host copy)."""
        lead, tables, starts, slots, seeds, top_ks, temps, top_ps, keys = prog.views
        sampled = bool((temps > 0).any())
        if sampled:
            # the keys of positions starts+1 .. starts+K, derived on the host
            # and copied with the other inputs: (K, B) fused, (B, K) verify
            steps = self._horizon_steps
            if name == "fused":
                pos, rows = starts[None, :] + steps[:, None], seeds[None, :]
            else:
                pos, rows = starts[:, None] + steps[None, :], seeds[:, None]
            _host_keys(keys, np.broadcast_to(rows, pos.shape), pos)
        self._keys.add((name, len(starts), K))
        a = prog.args
        fn, width = (self._fused_fn, (K,)) if name == "fused" else (self._verify_fn, ())

        def step():
            # staged: lead, tables, starts, slots, seeds, top-ks, temps, top-ps, keys
            return fn(self.model, self.params, self.kv, self._bias_pool, a[0], a[1], a[2],
                      a[3], a[4], a[5], a[6], a[7], a[8], width, sampled=sampled)

        return prog.run((True, sampled), step, self._capturing(), self._side,
                        self._pool).cpu().numpy()

    def decode_multi(self, tokens: Dict[int, int], horizon: int) -> Dict[int, List[int]]:
        """Fused multi-token decode (``engine_v2.py:1304``): feed each live
        uid its last sampled token and advance ``horizon`` rounds in one
        step program, each round's on-device selection fed to the next, one
        (max_seqs, horizon) int32 copy back. Returns ``{uid: [t1..tK]}``; the
        last token of each list is selected but not yet written to the
        cache (the ``decode_step`` contract, K times over).

        Horizons are ``{1, decode_horizon}``: 1 delegates to the ragged
        decode round. Blocks for all K writes are pre-allocated, and the
        step's tokens are not registered in the prefix index until
        :meth:`rollback` commits them (``uncommitted``). Validation is
        all-or-nothing."""
        if not self.paged:
            raise ValueError("decode_multi is paged-mode only")
        if horizon == 1:
            return {u: [t] for u, t in self.decode_step(tokens, greedy=True).items()}
        if horizon != self.decode_horizon:
            raise ValueError(
                f"horizon {horizon} not in {{1, {self.decode_horizon}}} — "
                "fixed-shape discipline: the engine runs exactly one "
                "fused horizon (set decode_horizon at construction)")
        if not tokens:
            return {}
        K = horizon
        descs = self._check_multi(tokens, K, "fused decode")
        B = self.max_seqs
        prog = self._multi_program("fused", B, K)
        toks, tables, starts, slots, seeds, top_ks, temps, top_ps, _ = prog.views
        for r, d in enumerate(descs):
            toks[r] = tokens[d.uid]
            self.block_mgr.fill_table_row(d, tables[r])
            starts[r] = d.seen_tokens
            self._fill_sampling(d, r, slots, seeds, temps, top_ks, top_ps)
        ys = self._run_multi("fused", prog, K)
        out: Dict[int, List[int]] = {}
        for r, d in enumerate(descs):
            seq = [int(t) for t in ys[r]]
            if self.prefix_cache:
                # the cache now holds the fed token and the first K-1 samples
                d.history.append(int(tokens[d.uid]))
                d.history.extend(seq[:-1])
            d.seen_tokens += K
            d.uncommitted = K  # rollback may truncate at most this step
            out[d.uid] = seq
        return out

    def verify_multi(self, tokens: Dict[int, int],
                     drafts: Dict[int, Sequence[int]]) -> Dict[int, List[int]]:
        """Speculative verification (``engine_v2.py:1405``): feed each live
        uid its last sampled token and up to ``decode_horizon - 1`` draft
        tokens, run the target over every position in one step program
        (B·K rows of one forward), and return ``{uid: [g1 ..
        g_{len(draft)+1}]}``: ``g_j`` is the selection after the fed token
        and the first j-1 drafts (a sampled row's own draw under the key of
        its position). The caller accepts the longest matching prefix and
        must :meth:`rollback` the rest, padding included, before the next
        dispatch. Drafts never reach the prefix index before that commit.
        Validation is all-or-nothing."""
        if not self.paged:
            raise ValueError("verify_multi is paged-mode only")
        K = self.decode_horizon
        if K <= 1:
            raise EngineUsageError(
                "verify_multi needs decode_horizon > 1 (the verification "
                "width is the engine's one fused horizon)")
        if not tokens:
            return {}
        for uid in tokens:
            ds = drafts.get(uid, ())
            if len(ds) > K - 1:
                raise EngineUsageError(
                    f"uid {uid}: {len(ds)} draft tokens exceed the verify "
                    f"width {K - 1} (= decode_horizon - 1)", uid=uid)
        descs = self._check_multi(tokens, K, "speculative verification")
        B = self.max_seqs
        prog = self._multi_program("verify", B, K)
        segs, tables, starts, slots, seeds, top_ks, temps, top_ps, _ = prog.views
        fed: Dict[int, List[int]] = {}
        for r, d in enumerate(descs):
            row = [int(tokens[d.uid])] + [int(t) for t in drafts.get(d.uid, ())]
            fed[d.uid] = row
            segs[r, :len(row)] = row  # positions past the draft stay 0 (padding)
            self.block_mgr.fill_table_row(d, tables[r])
            starts[r] = d.seen_tokens
            self._fill_sampling(d, r, slots, seeds, temps, top_ks, top_ps)
        ys = self._run_multi("verify", prog, K)
        out: Dict[int, List[int]] = {}
        for r, d in enumerate(descs):
            row = fed[d.uid]
            if self.prefix_cache:
                # the cache now holds the fed token, the drafts and the pad
                d.history.extend(row)
                d.history.extend([0] * (K - len(row)))
            d.seen_tokens += K
            d.uncommitted = K  # the caller commits or rolls back first
            out[d.uid] = [int(t) for t in ys[r, :len(row)]]
        return out

    def decode_dispatch(self, tokens: Dict[int, int]) -> DecodeDispatchHandle:
        """Dispatch one ragged decode round without waiting for its result
        (``engine_v2.py:1515``): ``decode_step(tokens, greedy=True)``'s
        step at the decode-round shape, whose (R,) tokens are copied without
        blocking into a pinned host buffer; the returned handle's
        :meth:`~DecodeDispatchHandle.fetch` waits for that copy alone.

        ``seen_tokens``/``history`` grow by the fed token at dispatch and
        ``uncommitted`` by 1 (stacked: with one round in flight a sequence
        can carry two provisional tokens); nothing is registered in the
        prefix index until :meth:`commit_step`. Validation is
        all-or-nothing, and the previous round's handle must be fetched
        first."""
        if not self.paged:
            raise ValueError("decode_dispatch is paged-mode only")
        if not tokens:
            raise EngineUsageError("decode_dispatch with an empty feed")
        if self._undrained_dispatch is not None:
            raise EngineUsageError(
                "decode_dispatch: the previous round's handle is unfetched "
                "— drain it first (the step's staged inputs are reused per "
                "round, so a second dispatch would corrupt the in-flight feed)")
        descs = self._check_multi(tokens, 1, "pipelined decode")
        T = self.max_seqs if self.token_budget > self.max_seqs else self.token_budget
        prog = self._ragged_program(T)
        (ids, tables, starts, logit_rows, slots, seeds, poss, top_ks,
         temps, top_ps, _) = prog.views
        for r, d in enumerate(descs):
            tok = int(tokens[d.uid])
            ids[r, 0] = tok
            self.block_mgr.fill_table_row(d, tables[r])
            starts[r] = d.seen_tokens
            logit_rows[r] = r  # every row is a final: one token per uid
            self._fill_sampling(d, r, slots, seeds, temps, top_ks, top_ps,
                                poss=poss, pos=d.seen_tokens + 1)
            if self.prefix_cache:
                d.history.append(tok)
            d.seen_tokens += 1
            d.uncommitted += 1  # stacked: commit_step settles each absorb
        toks = self._ragged(prog, T, True)
        if self._dispatch_host is None:
            self._dispatch_host = torch.zeros(
                self.max_seqs, dtype=torch.int32, pin_memory=self.device.type == "cuda")
        host = self._dispatch_host
        host.copy_(toks, non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        handle = DecodeDispatchHandle([d.uid for d in descs], host, event, eng=self)
        self._undrained_dispatch = handle
        return handle

    def commit_step(self, uid: int, drop: int = 0, retain: int = 0) -> int:
        """Settle one absorbed pipelined round for ``uid``
        (``engine_v2.py:1617``): truncate the newest ``drop`` provisional
        tokens, leave ``retain`` uncommitted (the successor round still
        running), and register prefix content strictly below the committed
        boundary. ``drop=0, retain=0`` is ``rollback(uid, 0)``. Idempotent
        on unknown uids. A freed tail block may be reallocated while the
        successor round runs; that is safe because the steps run in
        dispatch order on one stream and attention reads only positions
        below each row's length. Returns the block references released."""
        if not self.paged:
            raise ValueError("commit_step is paged-mode only")
        d = self.state.seqs.get(uid)
        if d is None:
            return 0
        if drop + retain > d.uncommitted:
            raise EngineUsageError(
                f"uid {uid}: commit_step(drop={drop}, retain={retain}) "
                f"exceeds the {d.uncommitted} provisional tokens — committed "
                "tokens are immutable (the prefix index may already cover "
                "them)", uid=uid)
        freed = 0
        if drop:
            if drop >= d.seen_tokens:
                raise ValueError(
                    f"uid {uid}: cannot roll back {drop} of {d.seen_tokens} "
                    "cached tokens (at least one must remain)")
            d.seen_tokens -= drop
            if self.prefix_cache:
                del d.history[-drop:]
            freed = self.block_mgr.rollback(d, d.seen_tokens)
        d.uncommitted = retain  # committed before register: in-flight and
        if self.prefix_cache:   # discarded tokens are never indexed
            self.block_mgr.register(d, limit=d.seen_tokens - retain)
        return freed

    def rollback(self, uid: int, n: int = 0) -> int:
        """Truncate the last ``n`` cached tokens of a live sequence and
        commit the rest (``engine_v2.py:1659``): ``seen_tokens``/``history``
        shrink, the over-allocated tail blocks are released refcount-exactly,
        and only then are the kept full blocks registered in the prefix
        index. ``n=0`` is the pure commit. ``n`` may not exceed the tokens of
        the last ``decode_multi``/``verify_multi`` (``uncommitted``):
        committed tokens are immutable. Idempotent on unknown uids. Returns
        the block references released."""
        if not self.paged:
            raise ValueError("rollback is paged-mode only")
        d = self.state.seqs.get(uid)
        if d is None:
            return 0
        freed = 0
        if n:
            if n < 0 or n >= d.seen_tokens:
                raise ValueError(
                    f"uid {uid}: cannot roll back {n} of {d.seen_tokens} "
                    "cached tokens (at least one must remain)")
            if n > d.uncommitted:
                raise EngineUsageError(
                    f"uid {uid}: rollback of {n} tokens exceeds the "
                    f"{d.uncommitted} generated by the last fused/verify "
                    "dispatch — committed tokens are immutable (the prefix "
                    "index may already cover them)", uid=uid)
            if d.in_flight:
                raise EngineUsageError(
                    f"uid {uid}: rollback with {d.in_flight} pending tokens", uid=uid)
            d.seen_tokens -= n
            if self.prefix_cache:
                del d.history[-n:]
            freed = self.block_mgr.rollback(d, d.seen_tokens)
        d.uncommitted = 0  # committed before register: drafts never indexed
        if self.prefix_cache:
            self.block_mgr.register(d)
        return freed

    def load_params(self, params, version=None) -> None:
        """Same-shape weight swap (``engine_v2.py:269``): ``params`` (the
        served tree's structure and shapes) is cast as at construction and
        served from the next step on. The trees are never written: the
        engine rebinds ``self.params``, as the JAX engine does, so the old
        tree stays as its other holders (another engine, a draft model)
        see it. The captured step graphs, which read the old weights by
        address, are dropped; each key is captured again at its next step
        (``graph_captures`` counts it; the cache counters, like the JAX
        engine's traces, do not change). Refuses while a sequence is
        resident (its KV was computed under the old weights), and flushes
        the prefix index of both tiers and the swap store, which hold
        old-weights KV."""
        if self.state.n_active:
            raise EngineUsageError(
                f"load_params with {self.state.n_active} resident "
                "sequence(s) — drain the engine first (their cached KV "
                "was computed under the old weights)")
        self._match_params(self.params, params, "")
        new = self._cast_params(params)
        self._drop_graphs()
        self.params = new
        self.weights_version = version
        if self.paged:
            self.block_mgr.flush_cache()  # both tiers
            self._drop_swaps()

    def _match_params(self, served, tree, path: str) -> None:
        """Raise unless ``tree`` has the served weights' structure and
        shapes."""
        if not isinstance(tree, dict) or set(tree) != set(served):
            raise ValueError(f"load_params: the tree at '{path}' does not have the "
                             "served weights' structure")
        for name, dst in served.items():
            if isinstance(dst, dict):
                self._match_params(dst, tree[name], f"{path}/{name}")
                continue
            shape = tuple(torch.as_tensor(tree[name]).shape)
            if shape != tuple(dst.shape):
                raise ValueError(f"load_params: '{path}/{name}' has shape "
                                 f"{shape}, the served leaf {tuple(dst.shape)}")
