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
dX and dW GEMMs). For CPU tensors they run the plain versions
``fused_ce_fwd_plain`` and ``fused_ce_bwd_plain``, which the CPU tests and
the card's checks use; they never run in the kernels' place on the card.

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

import torch

#: calls of :func:`fused_ce_fwd` that launched its kernels (CUDA tensors only)
fwd_launches = 0
#: calls of :func:`fused_ce_bwd` that launched its kernels (CUDA tensors only)
bwd_launches = 0

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_H = 8192           # fused_ce.py:233
_TILE_ROWS, _TILE_V = 64, 128
_lib = None
_fwd_slots = {}         # (device index, dtype) -> forward CTAs the card holds at once


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


def plan(N: int, V: int, slots: int):
    """(vocab tiles a forward CTA takes, chunks) for a card that holds
    ``slots`` forward CTAs at once. A CTA's time grows with its tiles, so
    the forward takes about (waves of CTAs) x (tiles a CTA): the plan
    minimises that product, and of equal ones takes the fewest chunks."""
    v_tiles, row_tiles = V // _TILE_V, N // _TILE_ROWS
    best = None
    for per in range(1, v_tiles + 1):
        chunks = -(-v_tiles // per)
        cost = -(-row_tiles * chunks // slots) * per
        if best is None or cost <= best[0]:
            best = (cost, per, chunks)
    return best[1], best[2]


def fwd_slots(device, dtype) -> int:
    """Forward CTAs of ``dtype`` the card holds at once: its SMs times the
    kernel's residency on one SM, as the CUDA runtime reports it."""
    key = (device.index, dtype)
    if key not in _fwd_slots:
        lib = _kernel_lib()
        with torch.cuda.device(device):
            per_sm = lib.dstt_fused_ce_fwd_ctas_per_sm(_KERNEL_DTYPES[dtype])
        if per_sm <= 0:
            raise RuntimeError("fused_ce forward occupancy query failed: "
                               + lib.dstt_cuda_error_string(-per_sm).decode())
        _fwd_slots[key] = per_sm * torch.cuda.get_device_properties(device).multi_processor_count
    return _fwd_slots[key]


def _kernel_lib():
    global _lib
    if _lib is None:
        from ..op_builder import FusedCEBuilder

        lib = FusedCEBuilder().load()
        lib.dstt_fused_ce_fwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                                          + [ctypes.c_void_p])
        lib.dstt_fused_ce_bwd.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                                          + [ctypes.c_void_p])
        for fn in (lib.dstt_fused_ce_fwd, lib.dstt_fused_ce_bwd):
            fn.restype = ctypes.c_int
        lib.dstt_fused_ce_fwd_ctas_per_sm.argtypes = [ctypes.c_int]
        lib.dstt_fused_ce_fwd_ctas_per_sm.restype = ctypes.c_int
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
    per, chunks = plan(N, V, fwd_slots(x.device, x.dtype))
    lg = torch.empty((N, V), dtype=x.dtype, device=x.device) if write_logits else None
    part = torch.empty((3, chunks, N), dtype=torch.float32, device=x.device)
    lse = torch.empty(N, dtype=torch.float32, device=x.device)
    nll = torch.empty(N, dtype=torch.float32, device=x.device)
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        err = lib.dstt_fused_ce_fwd(
            x.data_ptr(), w.data_ptr(), labels.data_ptr(),
            None if lg is None else lg.data_ptr(), part.data_ptr(), lse.data_ptr(),
            nll.data_ptr(), _KERNEL_DTYPES[x.dtype], N, V, H, per,
            torch.cuda.current_stream(x.device).cuda_stream)
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
    dlg = torch.empty_like(lg)
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        err = lib.dstt_fused_ce_bwd(
            lg.data_ptr(), lse.data_ptr(), labels.data_ptr(), g.data_ptr(), x.data_ptr(),
            w.data_ptr(), dlg.data_ptr(), dx.data_ptr(), dw.data_ptr(),
            _KERNEL_DTYPES[x.dtype], N, V, H, torch.cuda.current_stream(x.device).cuda_stream)
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
