"""Flash attention, forward and backward (counterpart of ``deepspeed_tpu/ops/transformer/flash_attention.py``).

``flash_attention`` is the entry on the model's (B, S, heads, hd) surface,
registered as ``"pallas_flash"`` as in the JAX package, and differentiable
through ``_FlashAttention`` (the port's ``jax.custom_vjp``). Its forward
keeps q, k, v, out and lse for the backward (``ctx.save_for_backward``), so
the backward never re-runs the forward: the port's form of the JAX
residuals named ``"attn_out"`` / ``"attn_lse"`` (``flash_attention.py:234-244``).
The forward runs as the dispatcher operation ``dstt::flash_attention_fwd``,
so that under activation checkpointing a remat policy can keep those two
outputs and the recompute does not launch the kernel again
(``runtime/activation_checkpointing/policies.py``).

Two wrappers launch the hand-written Hopper kernels
(``deepspeed_tpu_torch/csrc/flash_attention.cu``) for CUDA tensors:
``flash_attention_fwd`` (out, lse) and ``flash_attention_bwd`` (dq, dk, dv;
one call launches the dK/dV and the dQ kernels). For CPU tensors they run
the plain versions ``flash_attention_plain`` and ``flash_attention_bwd_plain``,
which the CPU tests and the card's checks use; they never run in the
kernels' place on the card.

What the kernels take (the Hopper counterpart of the TPU gate at
``flash_attention.py:261-287``, whose 128-multiple sequence and VMEM limits
were Mosaic's and do not carry over): head_dim 32, 64, 128 or 256 (the JAX
gate's 64/128/256, and 32, which the JAX package sends to its XLA path, so
that a model such as ``llama-tiny`` runs on the card); any sequence
length (a tail tile is masked); any GQA group ``nh / kvh``; float32,
bfloat16 or float16 with q, k, v (and do) of one dtype; a contiguous last
dimension, 16-byte-aligned data and row strides. Bias and softcap raise
``NotImplementedError``.

The forward also takes the slot engine's two arguments (``attention.py``):
``q_offset``, one causal offset a row ((B,) int32 on the card: query i of
row b sees keys <= i + q_offset[b]), and ``kv_rows``, the (B,) int32 batch
rows of k and v that the rows of q read, so that a group of slots attends
to a whole (max_seqs, T, kvh, hd) cache in place. With either,
``flash_attention`` runs the forward alone and refuses inputs that need
gradients: the backward kernels take neither (the slot engine serves, it
does not train).
"""

import ctypes
from typing import Optional, Tuple

import torch

from .attention import causal_mask, register_impl
from ..launch_counters import register as _register_counters

NEG_INF = -1e30

#: kernel launches made by :func:`flash_attention_fwd` (CUDA tensors only)
fwd_launches = 0
#: calls of :func:`flash_attention_bwd` that launched its kernels
bwd_launches = 0

_register_counters(globals(), "fwd_launches", "bwd_launches")

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_KERNEL_HEAD_DIMS = (32, 64, 128, 256)
_lib = None


def check_kernel_config(num_heads: int, kv_heads: int, head_dim: int,
                        dtype: torch.dtype) -> None:
    """Raise ``NotImplementedError`` if the CUDA kernels cannot serve this
    attention shape. The training engine calls it at construction, so a
    model the kernels cannot serve fails there and not in the middle of a
    step."""
    if head_dim not in _KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"flash attention CUDA kernel: head_dim {head_dim} not in {_KERNEL_HEAD_DIMS}")
    if kv_heads <= 0 or num_heads % kv_heads:
        raise NotImplementedError(
            f"flash attention CUDA kernel: num_heads {num_heads} is not a multiple "
            f"of kv_heads {kv_heads}")
    if dtype not in _KERNEL_DTYPES:
        raise NotImplementedError(
            f"flash attention CUDA kernel: dtype {dtype} not in {list(_KERNEL_DTYPES)}")


def _scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else float(scale)


def _scores(q, k, causal, num_kv_groups, scale, q_offset=0):
    """fp32 scores (B, kvh, g, Sq, Skv), masked keys at NEG_INF, and q as
    (B, Sq, kvh, g, hd)."""
    B, Sq, nh, hd = q.shape
    Skv, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, kvh, num_kv_groups, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if causal:
        s = s.masked_fill(~causal_mask(Sq, Skv, q_offset, q.device), NEG_INF)
    return s, qg


def flash_attention_plain(q, k, v, *, causal: bool = True, num_kv_groups: int = 1,
                          scale: Optional[float] = None, q_offset=0, kv_rows=None):
    """The kernel's function in plain PyTorch: (out (B, Sq, nh, hd) in q's
    dtype, lse (B, nh, Sq) fp32). As the kernel, p is rounded to v's dtype
    before P.V and the sum l is taken over the unrounded p. ``q_offset`` and
    ``kv_rows`` as in the module docstring."""
    if kv_rows is not None:
        rows = kv_rows.to(device=k.device, dtype=torch.long)
        k, v = k[rows], v[rows]
    B, Sq, nh, hd = q.shape
    s, _ = _scores(q, k, causal, num_kv_groups, _scale(q, scale), q_offset)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float()) / l
    out = o.permute(0, 3, 1, 2, 4).reshape(B, Sq, nh, hd).to(q.dtype)
    lse = (m + torch.log(l))[..., 0].reshape(B, nh, Sq)
    return out, lse


def _delta(out, do):
    """delta = sum(do * o) over hd, (B, nh, Sq) fp32: computed outside the
    kernel, as the JAX package does (``flash_attention.py:184``)."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, out, lse, do, *, causal: bool = True,
                              num_kv_groups: int = 1, scale: Optional[float] = None):
    """The backward kernels' function in plain PyTorch: (dq, dk, dv) in the
    dtypes of q, k, v. p is rounded to do's dtype before P^T dO and dS to
    q's dtype before the dK and dQ products (``flash_attention.py:159,163``);
    dk and dv sum the group's query heads in fp32."""
    B, Sq, nh, hd = q.shape
    Skv, kvh = k.shape[1], k.shape[2]
    g = num_kv_groups
    sc = _scale(q, scale)
    s, qg = _scores(q, k, causal, g, sc)
    p = torch.exp(s - lse.reshape(B, kvh, g, Sq)[..., None])
    dog = do.reshape(B, Sq, kvh, g, hd).float()
    delta = _delta(out, do).reshape(B, kvh, g, Sq)[..., None]
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(do.dtype).float(), dog)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = (p * (dp - delta) * sc).to(q.dtype).float()
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg.float())
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float())
    return dq.reshape(B, Sq, nh, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _kernel_lib():
    global _lib
    if _lib is None:
        from ..op_builder import FlashAttentionBuilder

        lib = FlashAttentionBuilder().load()
        lib.dstt_flash_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
            + [ctypes.c_float] + [ctypes.c_void_p] * 4)
        lib.dstt_flash_attention_bwd.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
        for fn in (lib.dstt_flash_attention_fwd, lib.dstt_flash_attention_bwd):
            fn.restype = ctypes.c_int
        lib.dstt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dstt_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_cuda_inputs(q, k, v, num_kv_groups, extra=(), any_kv_batch=False):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention expects q (B, Sq, nh, hd) and k/v (B, Skv, kvh, hd)")
    B, Sq, nh, hd = q.shape
    if (k.shape != v.shape or (k.shape[0] != B and not any_kv_batch)
            or k.shape[3] != hd):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    kvh = k.shape[2]
    if kvh * num_kv_groups != nh:
        raise ValueError(f"num_heads {nh} != kv_heads {kvh} x num_kv_groups {num_kv_groups}")
    check_kernel_config(nh, kvh, hd, q.dtype)
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(extra):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous last dimension")
        if t.data_ptr() % 16 or any(st * t.element_size() % 16 for st in t.stride()[:3]):
            raise ValueError(f"{name}'s data and row strides must be 16-byte aligned")
    if max(q.numel(), k.numel()) >= 2 ** 31:
        raise ValueError("flash attention: sizes must fit in int32")


def _strides(*ts):
    vals = [st for t in ts for st in t.stride()[:3]]
    vals += [0] * (12 - len(vals))
    return (ctypes.c_longlong * 12)(*vals)


def _raise_if(err, lib, what):
    if err:
        raise RuntimeError(f"flash attention {what} kernel launch failed: "
                           + lib.dstt_cuda_error_string(err).decode())


def _row_index(t, B, device, what):
    """A (B,) int32 contiguous CUDA tensor of per-row indices, or raise."""
    if (not isinstance(t, torch.Tensor) or t.shape != (B,) or t.dtype != torch.int32
            or t.device != device or not t.is_contiguous()):
        raise ValueError(f"flash attention: {what} must be a contiguous ({B},) int32 "
                         f"tensor on {device}")
    return t


def flash_attention_fwd(q, k, v, *, causal: bool = True, num_kv_groups: int = 1,
                        scale: Optional[float] = None, q_offset=0, kv_rows=None):
    """(out, lse): out (B, Sq, nh, hd) in q's dtype, contiguous; lse
    (B, nh, Sq) fp32. CPU tensors run the plain version; CUDA tensors launch
    the forward kernel or raise. ``q_offset`` (an int, or a (B,) int32
    tensor on q's device) and ``kv_rows`` ((B,) int32, rows of k/v, which
    may then have any batch) as in the module docstring; the caller keeps
    ``kv_rows`` inside k's batch and the offsets >= 0 (the kernel reads
    them on the card, where checking would cost a copy to the host)."""
    global fwd_launches
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, num_kv_groups=num_kv_groups,
                                     scale=scale, q_offset=q_offset, kv_rows=kv_rows)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_cuda_inputs(q, k, v, num_kv_groups, any_kv_batch=kv_rows is not None)
    B, Sq, nh, hd = q.shape
    offsets = None
    if isinstance(q_offset, torch.Tensor):
        offsets = _row_index(q_offset, B, q.device, "q_offset")
    elif q_offset:
        offsets = torch.full((B,), int(q_offset), dtype=torch.int32, device=q.device)
    rows = None if kv_rows is None else _row_index(kv_rows, B, q.device, "kv_rows")
    if rows is not None and offsets is None:  # the kernel's row index rides with offsets
        offsets = torch.zeros((B,), dtype=torch.int32, device=q.device)
    out = torch.empty((B, Sq, nh, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, nh, Sq), dtype=torch.float32, device=q.device)
    lib = _kernel_lib()
    with torch.cuda.device(q.device):
        err = lib.dstt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _KERNEL_DTYPES[q.dtype], B, Sq, k.shape[1], nh, k.shape[2], hd, int(causal),
            _scale(q, scale), _strides(q, k, v),
            None if offsets is None else offsets.data_ptr(),
            None if rows is None else rows.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if(err, lib, "forward")
    fwd_launches += 1
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, do, *, causal: bool = True,
                        num_kv_groups: int = 1, scale: Optional[float] = None):
    """(dq, dk, dv) in the dtypes of q, k, v, contiguous. CPU tensors run the
    plain version; CUDA tensors launch the dK/dV and dQ kernels or raise."""
    global bwd_launches
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                         num_kv_groups=num_kv_groups, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if do.stride(-1) != 1:
        do = do.contiguous()
    _check_cuda_inputs(q, k, v, num_kv_groups, extra=(("do", do),))
    B, Sq, nh, hd = q.shape
    if do.shape != q.shape or lse.shape != (B, nh, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"do {tuple(do.shape)} / lse {tuple(lse.shape)} {lse.dtype} do not "
                         f"match q {tuple(q.shape)}")
    delta = _delta(out, do)
    lse = lse.contiguous()
    dq = torch.empty((B, Sq, nh, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty(tuple(k.shape), dtype=k.dtype, device=q.device)
    dv = torch.empty(tuple(v.shape), dtype=v.dtype, device=q.device)
    lib = _kernel_lib()
    with torch.cuda.device(q.device):
        err = lib.dstt_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _KERNEL_DTYPES[q.dtype], B, Sq, k.shape[1], nh, k.shape[2], hd, int(causal),
            _scale(q, scale), _strides(q, k, v, do),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if(err, lib, "backward")
    bwd_launches += 1
    return dq, dk, dv


@torch.library.custom_op("dstt::flash_attention_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                  num_kv_groups: int, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_fwd` as a dispatcher operation, so that a remat
    policy sees it and can keep its outputs (``attn_out``, ``attn_lse``;
    ``runtime/activation_checkpointing/policies.py``): a kept output is
    not recomputed, so the kernel does not run again in the backward."""
    return flash_attention_fwd(q, k, v, causal=causal, num_kv_groups=num_kv_groups,
                               scale=scale)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, num_kv_groups, scale):
        out, lse = _flash_fwd_op(q, k, v, causal, num_kv_groups, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, num_kv_groups=num_kv_groups, scale=scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, **ctx.opts)
        return dq, dk, dv, None, None, None


@register_impl("pallas_flash")
def flash_attention(q, k, v, *, causal=True, q_offset=0, num_kv_groups=1,
                    softcap=0.0, bias=None, scale=None, kv_rows=None):
    """Flash attention entry (same (B, S, h, d) surface as
    ``attention.xla_attention``), differentiable in q, k and v. The JAX
    entry's ``block_q`` / ``block_k`` chose TPU tiles; the CUDA kernels pick
    their own. With a ``q_offset`` or ``kv_rows`` it runs the forward alone
    and raises if an input needs gradients."""
    if bias is not None or (softcap and softcap > 0.0):
        raise NotImplementedError("flash kernel: bias/softcap/q_offset unsupported")
    offset = isinstance(q_offset, torch.Tensor) or q_offset != 0
    if offset or kv_rows is not None:
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            raise NotImplementedError(
                "flash kernel: bias/softcap/q_offset unsupported in the backward (a "
                "q_offset or kv_rows forward serves the slot engine and does not train)")
        return flash_attention_fwd(q, k, v, causal=bool(causal), num_kv_groups=int(num_kv_groups),
                                   scale=_scale(q, scale), q_offset=q_offset, kv_rows=kv_rows)[0]
    return _FlashAttention.apply(q, k, v, bool(causal), int(num_kv_groups), _scale(q, scale))
