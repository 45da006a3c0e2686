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
``verify_cache_size <= 1``). Here each program is a :class:`_StepProgram`:
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
``capture=False``, every step runs eagerly over the same staged inputs.
"""

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ...accelerator import resolve_device
from ...models.transformer import row_keys, sample_or_argmax
from ...ops import launch_counters
from ...ops.quantizer.woq import group_of
from ...ops.quantizer.woq_gemm import check_woq_config
from ...ops.transformer.paged_attention import check_kernel_config
from ...resilience.errors import (ContextOverflowError, EngineUsageError,
                                  PoolExhaustedError)
from ...utils.logging import log_dist
from .ragged_manager import BlockedKVCache, DSStateManager

# the ROADMAP.md items that lift each unported part of the engine
_SLOT_ITEM = "ROADMAP.md Queue 1 item 5c, slot mode"
_TIER_ITEM = "ROADMAP.md Queue 1 item 9, KV tiers and swap"

_TORCH_DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(np.float32): torch.float32}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to deepspeed_tpu_torch ({item})")


def _host_keys(out: np.ndarray, seeds, positions) -> None:
    """Write the threefry keys of (``seeds``, ``positions``) into ``out``
    (..., 2) int32 as their uint32 words."""
    out[...] = row_keys(np.ascontiguousarray(seeds), np.ascontiguousarray(positions)
                        ).numpy().astype(np.uint32).view(np.int32)


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
                self._event.synchronize()
            toks = self._host.numpy()
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
        #: variant -> (graph, its output, the launches its capture counted)
        self.graphs: Dict[Tuple, Tuple] = {}
        self.captures = 0  # graphs captured, including those dropped since

    def stage(self) -> Tuple[np.ndarray, ...]:
        """The host fields, zeroed, once the last copy has read them."""
        if self._copied is not None:
            self._copied.synchronize()
        self.host.zero_()
        return self.views

    def run(self, variant: Tuple, step: Callable[[], torch.Tensor], capture: bool,
            side: Optional[Callable[[], object]] = None) -> torch.Tensor:
        """Copy the staged inputs to the device, then run ``step`` (a
        function of ``self.args`` and the engine's tensors): eagerly, or
        with ``capture`` (on the card) as set out in the class docstring.
        Returns the step's output: on a replay the graph's own output
        tensor, valid until the next replay."""
        self.dev.copy_(self.host, non_blocking=True)
        if self._copied is not None:
            self._copied.record()
        if not capture:
            return step()
        entry = self.graphs.get(variant)
        if entry is not None:
            graph, out, counts = entry
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
        with torch.cuda.graph(graph, stream=stream):
            static = step()
        after = launch_counters.snapshot()
        # what every wrapper counted while capturing, each replay's launches;
        # a counter registered meanwhile started from 0
        counts = [a - (before[i] if i < len(before) else 0) for i, a in enumerate(after)]
        launch_counters.add([-n for n in counts])  # the capture launched nothing
        self.graphs[variant] = (graph, static, counts)
        self.captures += 1
        return out


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
    otherwise construction raises. ``decode_horizon`` is the one fused
    horizon besides 1 (``decode_multi``, ``verify_multi``). ``capture``
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
                 nvme_tier_blocks: int = 0, nvme_tier_dir: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda", capture: bool = True):
        # the one fused horizon besides 1 (``engine_v2.py:119-128``)
        if decode_horizon < 1:
            raise ValueError(f"decode_horizon must be >= 1, got {decode_horizon}")
        if decode_horizon > 1 and not paged:
            raise ValueError("decode_horizon > 1 is paged-mode only (the "
                             "fused loop runs over the blocked pool)")
        if not paged:
            raise _not_ported("slot mode (paged=False)", _SLOT_ITEM)
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
        self.decode_horizon = decode_horizon
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
        # per-shape step programs (staged inputs, graphs), made at first use
        self._scratch: Dict[Tuple, _StepProgram] = {}
        # (program, rows, greedy) keys built: the JAX engine's trace keys
        self._keys: set = set()
        self._side_stream = None
        self._dispatch_host: Optional[torch.Tensor] = None
        #: the one unfetched pipelined dispatch (scratch-reuse contract)
        self._undrained_dispatch: Optional[DecodeDispatchHandle] = None
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
        # made with the engine and written in place: the step graphs read it
        # by address; zero rows leave selection untouched
        self._bias_pool = torch.zeros((max_seqs, self.cfg.vocab_size),
                                      dtype=torch.float32, device=self.device)
        log_dist(
            f"InferenceEngineV2(paged): blocks={num_blocks}x{block_size} "
            f"seqs<={max_seqs} ctx={self.max_seq_len} chunk={prefill_chunk} "
            f"token_budget={self.token_budget} decode_horizon={decode_horizon} "
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
        layer and KV head, in place (the JAX ``_get_cow`` program), eagerly
        on the engine's stream, in order with the steps' replays."""
        for pool in self.kv:  # (L, kvh, NB, BS, hd); block axis = 2
            pool[:, :, dst].copy_(pool[:, :, src])

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
            lg = self.model.forward_paged(self.params, ids, self.kv, tables, starts,
                                          logit_rows=logit_rows)
            if not greedy:
                return lg.float()
            return sample_or_argmax(lg, seeds, None, temps_d, top_ks, top_ps,
                                    bias=self._bias_pool[slots], keys=keys_d, sampled=sampled)

        return prog.run((greedy, sampled), step, self._capturing(), self._side)

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
    def _install_bias(self, d) -> None:
        """Copy ``d.uid``'s pending bias row into its slot's pool row, once
        per (uid, slot) binding: re-registration after preemption or a
        rebuild installs into the new slot."""
        row = self._bias_rows.get(d.uid)
        if row is None or self._bias_slots.get(d.uid) == d.slot:
            return
        self._bias_pool[d.slot].copy_(torch.from_numpy(row))
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
        """Engine-loss rebuild (``engine_v2.py:1754``): fresh sequence state
        and block manager, and a KV pool and bias pool as a fresh engine has
        them; the weights and the step programs stay. The pools are zeroed
        in place, not reallocated, so the captured graphs, which hold them
        by address, replay against them unchanged (the JAX engine keeps its
        compiled programs across a rebuild too). Resident sequences are not
        migrated: the scheduler replays them from its journal, and the
        counter-based keys make replayed samples bitwise. An unfetched
        dispatch dies with the incarnation. The host tier and swap store
        are item 9's and do not exist here."""
        old = self.block_mgr
        self.state = DSStateManager(self.max_seqs, self.max_seq_len)
        self._undrained_dispatch = None
        self._sampling.clear()
        self._bias_rows.clear()
        self._bias_slots.clear()
        self._bias_pool.zero_()
        self.rebuilds += 1
        self.block_mgr = BlockedKVCache(old.num_blocks, old.block_size,
                                        old.max_blocks_per_seq,
                                        prefix_cache=self.prefix_cache)
        for pool in self.kv:
            pool.zero_()
        log_dist(f"InferenceEngineV2.rebuild #{self.rebuilds}: block pool cleared "
                 f"({old.num_blocks}x{old.block_size}, prefix cache cold), step "
                 "programs retained", ranks=[0])

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
    # multi-token steps (``engine_v2.py:1304-1706``)
    # ------------------------------------------------------------------
    def _check_multi(self, tokens, K: int, what: str) -> List:
        """The fused and verify steps' all-or-nothing validation and block
        pre-allocation (positions seen .. seen+K-1, so a raise leaves every
        descriptor intact and the step retries verbatim), then
        copy-on-write over every block the K writes reach. Returns the
        descriptors in slot order, the row order of the program."""
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
            steps = np.arange(1, K + 1, dtype=np.int32)
            if name == "fused":
                pos, rows = starts[None, :] + steps[:, None], seeds[None, :]
            else:
                pos, rows = starts[:, None] + steps[None, :], seeds[:, None]
            _host_keys(keys, np.broadcast_to(rows, pos.shape), pos)
        self._keys.add((name, len(starts), K))
        a = prog.args
        multi = (self.model.decode_paged_multi if name == "fused"
                 else self.model.verify_paged_multi)
        width = (K,) if name == "fused" else ()

        def step():
            sampling = (a[4], a[6], a[5], a[7], self._bias_pool[a[3]])
            return multi(self.params, self.kv, a[0], a[1], a[2], *width, sampling=sampling,
                         keys=a[8], sampled=sampled)

        return prog.run((True, sampled), step, self._capturing(), self._side).cpu().numpy()

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
        the prefix index, which holds old-weights KV."""
        if self.state.n_active:
            raise EngineUsageError(
                f"load_params with {self.state.n_active} resident "
                "sequence(s) — drain the engine first (their cached KV "
                "was computed under the old weights)")
        self._match_params(self.params, params, "")
        new = self._cast_params(params)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # no replay of a graph dropped here runs on
        for prog in self._scratch.values():
            prog.graphs.clear()
        self.params = new
        self.weights_version = version
        self.block_mgr.flush_cache()

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

    def swap_out(self, uid):
        raise _not_ported("swap_out", _TIER_ITEM)

    def swap_in(self, uid):
        raise _not_ported("swap_in", _TIER_ITEM)

    def export_swap(self, uid):
        raise _not_ported("export_swap (cross-engine KV handoff)", _TIER_ITEM)

    def import_swap(self, uid, payload):
        raise _not_ported("import_swap (cross-engine KV handoff)", _TIER_ITEM)
