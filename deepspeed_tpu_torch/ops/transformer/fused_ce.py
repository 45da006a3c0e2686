"""Fused linear cross-entropy, forward and backward (counterpart of ``deepspeed_tpu/ops/transformer/fused_ce.py``).

``fused_ce_loss(x, w, labels)`` is the per-row ``logsumexp(x @ w^T) -
(x @ w^T)[label]`` in fp32, differentiable in ``x`` and ``w`` through
``_FusedCE`` (the port's ``jax.custom_vjp``, ``fused_ce.py:190-209``). W is
(V, H), the embedding-table layout, so a tied head needs no transpose and
dW comes out ready to add to the embedding's gradient. The op has no
parameter tree of its own: ``models/weights.py`` ``params_from_jax`` needs
nothing for it.

Two wrappers launch the hand-written Hopper kernels
(``deepspeed_tpu_torch/csrc/fused_ce.cu``) for CUDA tensors:
``fused_ce_fwd`` (the GEMM with its logsumexp epilogue, then the ordered
merge of the vocab chunks) and ``fused_ce_bwd`` (the dlogits pass, then the
dX and dW GEMMs). For bf16 and fp16 the three GEMMs are one persistent,
warp-specialised ``wgmma`` kernel fed by TMA, walking the work that
:func:`plan` lays out, and the one-hot terms of dX and dW are added in
fp32 apart from the GEMMs (:func:`label_rows`, a kernel of its own, indexes
them for dW); fp32
keeps FMA tiles. For CPU tensors they run the
plain versions ``fused_ce_fwd_plain`` and ``fused_ce_bwd_plain``, which the
CPU tests and the card's checks use; they never run in the kernels' place
on the card.

The arithmetic, the same for kernel and plain version, rounds where the TPU
kernel rounds: s = x @ W^T from x and W upcast to fp32 (a product of two
16-bit values is exact in fp32, so only the order of the sum differs);
the residual ``lg`` = s in x's dtype; ``dlg = ((exp(float(lg) - lse) -
onehot) * g)`` in x's dtype; dx and dw each summed in fp32 and rounded once.
The TPU backward rounds dW as N / R partial sums to x's dtype before adding
them (``fused_ce.py:172-173``); the port does not, which for 16-bit types
is more exact by those roundings. A label outside [0, V) hits no column, so
its row's loss is lse alone, as in the JAX package.

What the kernels take: the JAX gate's shapes (N, V and H multiples of 128,
H <= 8192; ``_pick_blocks``' VMEM arithmetic was Mosaic's and only its
conditions for None carry over), float32, bfloat16 or float16 with x and W
of one dtype, contiguous and 16-byte aligned, int32 labels and fp32 g. On
the card anything else raises; nothing falls back to the plain version.
"""

import ctypes
import functools
from typing import List, NamedTuple, Tuple

import torch

from ..launch_counters import register as _register_counters

#: calls of :func:`fused_ce_fwd` that launched its kernels (CUDA tensors only)
fwd_launches = 0
#: calls of :func:`fused_ce_bwd` that launched its kernels (CUDA tensors only)
bwd_launches = 0

_register_counters(globals(), "fwd_launches", "bwd_launches")

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_H = 8192           # fused_ce.py:233
# output tiles (rows, columns) of the kernels: fp32 FMA tiles, 16-bit wgmma tiles
_TILES = {torch.float32: (64, 128), torch.bfloat16: (128, 256), torch.float16: (128, 256)}
_K_STEP = 64            # the 16-bit kernels' K step
# a forward chunk's cost beside a tile's: its partials and a step of the
# ordered merge take about half a K step (on an H100 the merge took 0.42 us
# a chunk, a K step of a 128 x 256 tile ~0.9 us)
_CHUNK_COST_STEPS = 0.5
_lib = None
_residency = {}         # (device index, dtype) -> (CTAs an SM, SMs)


def _gate(N: int, V: int, H: int) -> None:
    """The JAX gate (``fused_ce.py:231-234``). ``_pick_blocks`` returns None
    exactly when N or V is not a multiple of 128: 128 is in both of its
    candidate lists and its row cap is at least 128."""
    if N % 128 or V % 128 or H % 128 or H > _MAX_H:
        raise NotImplementedError(f"fused_ce: unsupported shape N={N} V={V} H={H}")


def check_kernel_config(N: int, V: int, H: int, dtype: torch.dtype) -> None:
    """Raise ``NotImplementedError`` if the CUDA kernels cannot take this
    head: the JAX gate's shapes, and a dtype the kernels have."""
    _gate(N, V, H)
    if dtype not in _KERNEL_DTYPES:
        raise NotImplementedError(
            f"fused_ce CUDA kernels: dtype {dtype} not in {list(_KERNEL_DTYPES)}")


def _onehot(labels, V: int):
    """(N, V) bool: column index == label, as the kernel compares them (no
    gather: a label outside [0, V) matches no column)."""
    cols = torch.arange(V, device=labels.device, dtype=torch.int64)
    return cols[None, :] == labels.to(torch.int64)[:, None]


def fused_ce_fwd_plain(x, w, labels, write_logits: bool = True):
    """The forward kernels' function in plain PyTorch: (lg (N, V) in x's
    dtype or None, lse (N,) fp32, nll (N,) fp32)."""
    s = x.float() @ w.float().t()
    lse = torch.logsumexp(s, dim=-1)
    gold = torch.where(_onehot(labels, w.shape[0]), s, 0.0).sum(-1)
    return (s.to(x.dtype) if write_logits else None), lse, lse - gold


def fused_ce_bwd_plain(lg, lse, labels, g, x, w):
    """The backward kernels' function in plain PyTorch: (dx (N, H) in x's
    dtype, dw (V, H) in w's dtype)."""
    p = torch.exp(lg.float() - lse[:, None])
    dlg = ((p - _onehot(labels, lg.shape[1]).float()) * g.float()[:, None]).to(x.dtype)
    dx = (dlg.float() @ w.float()).to(x.dtype)
    dw = (dlg.float().t() @ x.float()).to(w.dtype)
    return dx, dw


class Plan(NamedTuple):
    """How the kernels cut one head into work. Output tiles are ``tile_m``
    x ``tile_n``. The forward's work units are (row block, chunk), a chunk
    being ``tiles_per_chunk`` consecutive vocab tiles (the last may hold
    fewer), ``chunks`` of them a row; ``*_ctas`` are the CTAs each 16-bit
    kernel runs persistently (fp32: the grids' sizes, for the record)."""
    tile_m: int
    tile_n: int
    tiles_per_chunk: int
    chunks: int
    fwd_ctas: int
    dx_ctas: int
    dw_ctas: int


def _count(lo: int, hi: int, b: int, ctas: int) -> int:
    """How many u in [lo, hi) have u % ctas == b."""
    first = lo + (b - lo) % ctas
    return 0 if first >= hi else (hi - 1 - first) // ctas + 1


def _max_tiles(mt: int, nt: int, per: int, ctas: int) -> int:
    """The most tiles any CTA takes when ``ctas`` CTAs walk the units of
    :func:`cta_tiles` (row blocks fastest; the last chunk holds nt - (chunks
    - 1) per tiles)."""
    chunks = -(-nt // per)
    units, last = mt * chunks, nt - (chunks - 1) * per
    return max(_count(0, units, b, ctas) * per
               - _count(units - mt, units, b, ctas) * (per - last) for b in range(ctas))


@functools.lru_cache(maxsize=None)
def plan(N: int, V: int, H: int, dtype: torch.dtype, ctas_per_sm: int, sms: int) -> Plan:
    """The kernels' work for a head (N, H) x (V, H) of ``dtype`` on a card
    of ``sms`` SMs that holds ``ctas_per_sm`` of the kernel's CTAs on each.

    16-bit: every CTA walks units u = cta, cta + ctas, ... (:func:`cta_tiles`).
    The forward's chunk length minimises the most K steps any CTA runs, each
    chunk counting ``_CHUNK_COST_STEPS`` more (its partials and its merge);
    of equal plans the fewest chunks. dX and dW take one tile a unit.
    fp32: a CTA per (64-row tile, chunk); the chunks minimise (waves of CTAs)
    x (tiles a CTA), of equal ones the fewest chunks."""
    _gate(N, V, H)
    tile_m, tile_n = _TILES[dtype]
    slots = ctas_per_sm * sms
    mt, nt, ht = N // tile_m, -(-V // tile_n), -(-H // tile_n)
    best = None
    if dtype == torch.float32:
        for per in range(1, nt + 1):
            chunks = -(-nt // per)
            cost = -(-mt * chunks // slots) * per
            if best is None or cost <= best[0]:
                best = (cost, per, chunks)
        _, per, chunks = best
        return Plan(tile_m, tile_n, per, chunks, mt * chunks, ht * mt, ht * (V // tile_m))
    for per in range(nt, 0, -1):  # the fewest chunks first: ties keep them
        chunks = -(-nt // per)
        if per > 1 and -(-nt // (per - 1)) == chunks:
            continue  # the same chunks as a shorter one, which evens the tiles
        ctas = min(slots, mt * chunks)
        cost = _max_tiles(mt, nt, per, ctas) * (H // _K_STEP) + chunks * _CHUNK_COST_STEPS
        if best is None or cost < best[0]:
            best = (cost, per, chunks, ctas)
    _, per, chunks, ctas = best
    return Plan(tile_m, tile_n, per, chunks, ctas, min(slots, mt * ht),
                min(slots, (V // tile_m) * ht))


def cta_tiles(mt: int, nt: int, per: int, ctas: int, n_fastest: bool = False
              ) -> List[List[Tuple[int, int, int]]]:
    """The 16-bit kernels' schedule (``ce_gemm`` in ``fused_ce.cu``), as
    each CTA walks it: for CTA b, the (row block, chunk, column tile) of its
    tiles in order. Units u = b, b + ctas, ... are (row block m, chunk c),
    row blocks fastest unless ``n_fastest``; chunk c holds the column tiles
    [c per, min(nt, c per + per))."""
    chunks = -(-nt // per)
    out = []
    for b in range(ctas):
        tiles = []
        for u in range(b, mt * chunks, ctas):
            m, c = (u // chunks, u % chunks) if n_fastest else (u % mt, u // mt)
            tiles += [(m, c, t) for t in range(c * per, min(nt, c * per + per))]
        out.append(tiles)
    return out


def residency(device, dtype) -> Tuple[int, int]:
    """(CTAs of ``dtype``'s kernels an SM holds at once, as the CUDA runtime
    reports it, SMs of the card)."""
    key = (device.index, dtype)
    if key not in _residency:
        lib = _kernel_lib()
        with torch.cuda.device(device):
            per_sm = lib.dstt_fused_ce_ctas_per_sm(_KERNEL_DTYPES[dtype])
        if per_sm <= 0:
            raise RuntimeError("fused_ce occupancy query failed: "
                               + lib.dstt_cuda_error_string(-per_sm).decode())
        _residency[key] = (per_sm, torch.cuda.get_device_properties(device).multi_processor_count)
    return _residency[key]


def kernel_plan(x, w) -> Plan:
    """:func:`plan` for CUDA tensors x (N, H) and w (V, H) on their card."""
    N, H = x.shape
    return plan(N, w.shape[0], H, x.dtype, *residency(x.device, x.dtype))


def label_rows_plain(labels, V: int):
    """The index of the label terms that the 16-bit backward adds apart from
    the GEMMs, all int32, in plain PyTorch:

    - order (N,): the rows whose label lies in [0, V), sorted by label and
      ascending within one (its first starts[V] entries; the kernel leaves
      the rest unset);
    - starts (V + 1,): label v's rows are order[starts[v]:starts[v + 1]];
    - slot (V,): each label some row has numbered 0, 1, ... in label order
      (its fp32 scratch row), -1 for the others;
    - vlist (min(N, V),): the label of each slot, -1 past the last."""
    lab = labels.to(torch.int32)
    key = torch.where((lab >= 0) & (lab < V), lab, V)
    sorted_key, order = torch.sort(key, stable=True)
    starts = torch.searchsorted(sorted_key, torch.arange(V + 1, device=labels.device,
                                                         dtype=torch.int32), out_int32=True)
    has = starts[1:] > starts[:-1]
    slot = torch.where(has, torch.cumsum(has, 0, dtype=torch.int32) - 1, -1).to(torch.int32)
    S = min(len(lab), V)
    vlist = torch.full((S + 1,), -1, dtype=torch.int32, device=labels.device)
    vlist.scatter_(0, torch.where(has, slot, S).long(),
                   torch.arange(V, dtype=torch.int32, device=labels.device))
    return order.to(torch.int32), starts, slot, vlist[:S]


def label_rows(labels, V: int):
    """:func:`label_rows_plain`'s index: for int32 CUDA labels one kernel
    launch (``ce_label_rows_kernel``), for CPU labels the plain version."""
    if labels.device.type == "cpu":
        return label_rows_plain(labels, V)
    if labels.dtype != torch.int32 or labels.dim() != 1 or not labels.is_contiguous():
        raise ValueError(f"labels must be contiguous int32 (N,), got {labels.dtype} "
                         f"{tuple(labels.shape)}")
    N = labels.shape[0]
    i32 = dict(dtype=torch.int32, device=labels.device)
    order, starts, slot = torch.empty(N, **i32), torch.empty(V + 1, **i32), torch.empty(V, **i32)
    vlist, work = torch.empty(min(N, V), **i32), torch.empty(V + N, **i32)
    lib = _kernel_lib()
    with torch.cuda.device(labels.device):
        err = lib.dstt_fused_ce_label_rows(
            labels.data_ptr(), N, V, order.data_ptr(), starts.data_ptr(), slot.data_ptr(),
            vlist.data_ptr(), work.data_ptr(), torch.cuda.current_stream(labels.device).cuda_stream)
    _raise_if(err, lib, "label index")
    return order, starts, slot, vlist


def _kernel_lib():
    global _lib
    if _lib is None:
        from ..op_builder import FusedCEBuilder

        lib = FusedCEBuilder().load()
        lib.dstt_fused_ce_fwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                                          + [ctypes.c_void_p])
        lib.dstt_fused_ce_bwd.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 6
                                          + [ctypes.c_void_p])
        for fn in (lib.dstt_fused_ce_fwd, lib.dstt_fused_ce_bwd):
            fn.restype = ctypes.c_int
        lib.dstt_fused_ce_label_rows.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                                                 + [ctypes.c_void_p] * 6)
        lib.dstt_fused_ce_label_rows.restype = ctypes.c_int
        lib.dstt_fused_ce_ctas_per_sm.argtypes = [ctypes.c_int]
        lib.dstt_fused_ce_ctas_per_sm.restype = ctypes.c_int
        lib.dstt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dstt_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_cuda_inputs(x, w, labels, extra=()):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"fused_ce expects x (N, H) and w (V, H), got {tuple(x.shape)} / "
                         f"{tuple(w.shape)}")
    N, H = x.shape
    V = w.shape[0]
    check_kernel_config(N, V, H, x.dtype)
    if w.dtype != x.dtype:
        raise ValueError(f"w dtype {w.dtype} != x dtype {x.dtype}")
    if labels.dtype != torch.int32 or tuple(labels.shape) != (N,):
        raise ValueError(f"labels must be int32 (N,), got {labels.dtype} {tuple(labels.shape)}")
    for name, t in (("x", x), ("w", w), ("labels", labels)) + tuple(extra):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def _raise_if(err, lib, what):
    if err:
        raise RuntimeError(f"fused_ce {what} kernel launch failed: "
                           + lib.dstt_cuda_error_string(err).decode())


def fused_ce_fwd(x, w, labels, write_logits: bool = True):
    """(lg or None, lse, nll): lg (N, V) in x's dtype (only with
    ``write_logits``), lse and nll (N,) fp32. CPU tensors run the plain
    version; CUDA tensors launch the forward kernels or raise."""
    global fwd_launches
    if x.device.type == "cpu":
        return fused_ce_fwd_plain(x, w, labels, write_logits)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ce: unsupported device {x.device}")
    _check_cuda_inputs(x, w, labels)
    N, H = x.shape
    V = w.shape[0]
    p = kernel_plan(x, w)
    lg = torch.empty((N, V), dtype=x.dtype, device=x.device) if write_logits else None
    part = torch.empty((3, p.chunks, N), dtype=torch.float32, device=x.device)
    lse = torch.empty(N, dtype=torch.float32, device=x.device)
    nll = torch.empty(N, dtype=torch.float32, device=x.device)
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        err = lib.dstt_fused_ce_fwd(
            x.data_ptr(), w.data_ptr(), labels.data_ptr(),
            None if lg is None else lg.data_ptr(), part.data_ptr(), lse.data_ptr(),
            nll.data_ptr(), _KERNEL_DTYPES[x.dtype], N, V, H, p.tiles_per_chunk, p.chunks,
            p.fwd_ctas, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_if(err, lib, "forward")
    fwd_launches += 1
    return lg, lse, nll


def fused_ce_bwd(lg, lse, labels, g, x, w):
    """(dx, dw) in x's and w's dtype from the forward's residual ``lg``, its
    ``lse`` and the upstream fp32 gradient ``g`` of nll. CPU tensors run the
    plain version; CUDA tensors launch the backward kernels or raise."""
    global bwd_launches
    if x.device.type == "cpu":
        return fused_ce_bwd_plain(lg, lse, labels, g, x, w)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ce: unsupported device {x.device}")
    _check_cuda_inputs(x, w, labels, (("lg", lg), ("lse", lse), ("g", g)))
    N, H = x.shape
    V = w.shape[0]
    if lg.dtype != x.dtype or tuple(lg.shape) != (N, V):
        raise ValueError(f"lg must be {x.dtype} ({N}, {V}), got {lg.dtype} {tuple(lg.shape)}")
    for name, t in (("lse", lse), ("g", g)):
        if t.dtype != torch.float32 or tuple(t.shape) != (N,):
            raise ValueError(f"{name} must be float32 ({N},), got {t.dtype} {tuple(t.shape)}")
    p = kernel_plan(x, w)
    dlg = torch.empty_like(lg)
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    rows = (None,) * 6
    if x.dtype != torch.float32:  # the label terms, kept out of the 16-bit GEMMs
        rows = (torch.empty(N, dtype=x.dtype, device=x.device), *label_rows(labels, V),
                torch.empty((min(N, V), H), dtype=torch.float32, device=x.device))
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        err = lib.dstt_fused_ce_bwd(
            lg.data_ptr(), lse.data_ptr(), labels.data_ptr(), g.data_ptr(), x.data_ptr(),
            w.data_ptr(), dlg.data_ptr(), *(None if t is None else t.data_ptr()
                                            for t in rows),
            dx.data_ptr(), dw.data_ptr(),
            _KERNEL_DTYPES[x.dtype], N, V, H, p.dx_ctas, p.dw_ctas,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_if(err, lib, "backward")
    bwd_launches += 1
    return dx, dw


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, labels, keep_residual):
        # the no-grad primal (fused_ce.py:190-195) writes no (N, V) residual
        lg, lse, nll = fused_ce_fwd(x, w, labels, write_logits=keep_residual)
        if keep_residual:
            ctx.save_for_backward(lg, lse, labels, x, w)
        return nll

    @staticmethod
    def backward(ctx, g):
        lg, lse, labels, x, w = ctx.saved_tensors
        dx, dw = fused_ce_bwd(lg, lse, labels, g.float().contiguous(), x, w)
        return dx, dw, None, None


def fused_ce_loss(x, w, labels):
    """Per-row ``logsumexp(x @ w^T) - (x @ w^T)[label]`` (f32), fused.

    ``x``: (N, H) activations; ``w``: (V, H) vocab table (embedding layout);
    ``labels``: (N,) integer — must be valid indices (mask outside; rows
    whose label is out of range still produce a finite lse-based value).
    Returns (N,) f32, differentiable in ``x`` and ``w``. Raises
    ``NotImplementedError`` for shapes the kernel does not cover — catch it
    and use the unfused logsumexp/gather path. The (N, V) residual is
    written only when autograd will need it (grad mode on and ``x`` or ``w``
    requiring grad).
    """
    N, H = x.shape
    V, H2 = w.shape
    if H != H2:
        raise ValueError(f"x H={H} vs w H={H2}")
    _gate(N, V, H)
    keep = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    return _FusedCE.apply(x, w, labels.to(torch.int32).contiguous(), keep)
