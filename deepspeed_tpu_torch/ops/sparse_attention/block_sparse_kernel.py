"""Block-sparse attention, forward and backward (counterpart of ``deepspeed_tpu/ops/sparse_attention/block_sparse_kernel.py``).

``block_sparse_attention(q, k, v, layout, block, ...)`` is attention over a
(heads, Sq / block, Skv / block) block layout that visits only the layout's
active blocks, on the model's (B, S, heads, hd) surface, differentiable
through ``_BlockSparseAttention`` (the port's ``jax.custom_vjp``). Its
forward keeps q, k, v, out and lse for the backward.

``layout_to_lists`` compacts a layout into per-row and per-column block
lists. For CUDA tensors the lists, with the order in which the kernels take
the rows and columns (longest lists first), go to the card once per layout
and stay there in a bounded cache, as the JAX package's ``_FN_CACHE`` keeps
them. Two wrappers launch the hand-written Hopper kernels
(``deepspeed_tpu_torch/csrc/block_sparse_attention.cu``, the flash kernels
of ``attention_kernels.cuh`` over the lists): ``block_sparse_attention_fwd``
(out, lse) and ``block_sparse_attention_bwd`` (dq, dk, dv; one call launches
the dK/dV and the dQ kernels). For CPU tensors they run the plain versions
``block_sparse_attention_plain`` and ``block_sparse_attention_bwd_plain``,
which the CPU tests and the card's checks use; on the card they never run
in the kernels' place.

The plain versions compute the kernels' function, edge cases included: a
query row that sees no key (a query block with no active block) gets o = 0,
lse = -1e30 and dq = 0, as the TPU kernel gives (``:94-96``), where the
masked path of ``SparseSelfAttention`` gives the mean of v.

The gates. The JAX kernel's own (``:294-300``): ``NotImplementedError`` for
a block under 128 or one that does not divide both sequence lengths (the
case ``SparseSelfAttention`` sends down its masked path), ``ValueError``
for a layout of the wrong shape. Then the CUDA kernels' (``check_kernel_config``,
before any launch): the flash kernels' head_dim (32, 64, 128, 256), dtypes and
GQA rule, and a block that is a multiple of 64, the largest tile. The JAX
wrapper's VMEM guard (``:311-312``) was a TPU limit and is not carried over:
the kernels stage tiles, not whole K/V windows. A failed build or launch
raises ``RuntimeError``, never ``NotImplementedError``, so that no caller
mistakes it for a gate.
"""

import ctypes
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..transformer import flash_attention as fa
from ..transformer.flash_attention import NEG_INF
from ..launch_counters import register as _register_counters

#: kernel launches made by :func:`block_sparse_attention_fwd` (CUDA tensors only)
fwd_launches = 0
#: calls of :func:`block_sparse_attention_bwd` that launched its kernels
bwd_launches = 0

_register_counters(globals(), "fwd_launches", "bwd_launches")

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_TILE = 64  # the kernels' largest tile: a layout block is walked as whole tiles
_lib = None


def layout_to_lists(layout: np.ndarray, causal: bool):
    """(H, nQ, nK) bool → compacted per-row / per-column block index lists.

    Returns (kcnt (H,nQ), kidx (H,nQ,MAXK), qcnt (H,nK), qidx (H,nK,MAXQ))
    int32, zero-padded. Under ``causal`` the layout is intersected with the
    block-level lower triangle first.
    """
    H, nQ, nK = layout.shape
    lay = layout.copy()
    if causal:
        tri = np.tril(np.ones((nQ, nK), bool))
        lay &= tri[None]
    kcnt = lay.sum(axis=2).astype(np.int32)
    qcnt = lay.sum(axis=1).astype(np.int32)
    maxk = max(1, int(kcnt.max()))
    maxq = max(1, int(qcnt.max()))
    kidx = np.zeros((H, nQ, maxk), np.int32)
    qidx = np.zeros((H, nK, maxq), np.int32)
    for h in range(H):
        for i in range(nQ):
            nz = np.nonzero(lay[h, i])[0]
            kidx[h, i, : len(nz)] = nz
        for j in range(nK):
            nz = np.nonzero(lay[h, :, j])[0]
            qidx[h, j, : len(nz)] = nz
    return kcnt, kidx, qcnt, qidx


def kernel_gate(block: int, seq_q: int, seq_kv: int) -> None:
    """The JAX kernel's gate (``block_sparse_kernel.py:294-297``)."""
    if block < 128 or seq_q % block or seq_kv % block:
        raise NotImplementedError("block_sparse kernel: block must be >=128 "
                                  "and divide both sequence lengths")


def _check_layout(layout, num_heads, seq_q, seq_kv, block):
    want = (num_heads, seq_q // block, seq_kv // block)
    if tuple(layout.shape) != want:
        raise ValueError(f"layout shape {tuple(layout.shape)} != {want}")


def check_kernel_config(num_heads: int, kv_heads: int, head_dim: int, dtype: torch.dtype,
                        block: int) -> None:
    """Raise ``NotImplementedError`` if the CUDA kernels cannot serve this
    shape: the flash kernels' limits, and a block that is not a multiple of
    the 64-row tile."""
    fa.check_kernel_config(num_heads, kv_heads, head_dim, dtype)
    if block % _TILE:
        raise NotImplementedError(
            f"block-sparse attention CUDA kernel: block {block} is not a multiple of {_TILE}")


# ----------------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------------

def _visible(layout, block, causal, kvh, g, device):
    """(kvh, g, Sq, Skv) bool: the keys each query row sees, as the kernels
    visit them (the layout's blocks and, under ``causal``, qpos >= kpos)."""
    lay = torch.from_numpy(np.ascontiguousarray(layout, dtype=bool)).to(device)
    vis = lay.repeat_interleave(block, 1).repeat_interleave(block, 2)
    if causal:
        vis &= torch.ones(vis.shape[1:], dtype=torch.bool, device=device).tril()
    return vis.reshape(kvh, g, *vis.shape[1:])


def block_sparse_attention_plain(q, k, v, layout, block: int, *, causal: bool = False,
                                 num_kv_groups: int = 1, scale: Optional[float] = None):
    """The forward kernel's function in plain PyTorch: (out (B, Sq, nh, hd)
    in q's dtype, lse (B, nh, Sq) fp32). As the kernel, p is rounded to v's
    dtype before P.V, and a row that sees no key gets out 0 and lse -1e30."""
    B, Sq, nh, hd = q.shape
    kvh, g = k.shape[2], num_kv_groups
    vis = _visible(layout, block, causal, kvh, g, q.device)
    s, _ = fa._scores(q, k, False, g, fa._scale(q, scale))
    s = s.masked_fill(~vis, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~vis, 0.0)
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float()) / l
    out = o.permute(0, 3, 1, 2, 4).reshape(B, Sq, nh, hd).to(q.dtype)
    lse = (m + torch.log(l))[..., 0].reshape(B, nh, Sq)
    return out, lse


def block_sparse_attention_bwd_plain(q, k, v, out, lse, do, layout, block: int, *,
                                     causal: bool = False, num_kv_groups: int = 1,
                                     scale: Optional[float] = None):
    """The backward kernels' function in plain PyTorch: (dq, dk, dv) in the
    dtypes of q, k, v. p is rounded to do's dtype before P^T dO and dS to
    q's dtype before the dK and dQ products; dk and dv sum the group's query
    heads in fp32."""
    B, Sq, nh, hd = q.shape
    kvh, g = k.shape[2], num_kv_groups
    sc = fa._scale(q, scale)
    vis = _visible(layout, block, causal, kvh, g, q.device)
    s, qg = fa._scores(q, k, False, g, sc)
    p = torch.exp(s - lse.reshape(B, kvh, g, Sq)[..., None]).masked_fill(~vis, 0.0)
    dog = do.reshape(B, Sq, kvh, g, hd).float()
    delta = fa._delta(out, do).reshape(B, kvh, g, Sq)[..., None]
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(do.dtype).float(), dog)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = (p * (dp - delta) * sc).to(q.dtype).float()
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg.float())
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float())
    return dq.reshape(B, Sq, nh, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------------------------
# the CUDA kernels
# ----------------------------------------------------------------------------

class _Lists(NamedTuple):
    """A layout's block lists on the card, in the kernels' argument order."""
    kcnt: torch.Tensor
    kidx: torch.Tensor
    qcnt: torch.Tensor
    qidx: torch.Tensor
    q_order: torch.Tensor   # h * nQ + i, longest kcnt first
    kv_order: torch.Tensor  # kh * nK + j, longest sum of the group's qcnt first
    max_k: int
    max_q: int

    def pointers(self):
        return [t.data_ptr() for t in self[:6]]


_LISTS: "OrderedDict[tuple, _Lists]" = OrderedDict()
_LISTS_MAX = 16  # bounds the lists pinned on the card, as the JAX _FN_CACHE_MAX


def _device_lists(layout, causal: bool, num_kv_groups: int, device) -> _Lists:
    key = (layout.shape, layout.tobytes(), bool(causal), num_kv_groups, str(device))
    hit = _LISTS.get(key)
    if hit is None:
        if len(_LISTS) >= _LISTS_MAX:
            _LISTS.popitem(last=False)
        kcnt, kidx, qcnt, qidx = layout_to_lists(layout, causal)
        H, nK = qcnt.shape
        group_qcnt = qcnt.reshape(H // num_kv_groups, num_kv_groups, nK).sum(1)
        orders = [np.argsort(-c.reshape(-1), kind="stable").astype(np.int32)
                  for c in (kcnt, group_qcnt)]
        hit = _LISTS[key] = _Lists(
            *(torch.from_numpy(a).to(device) for a in (kcnt, kidx, qcnt, qidx, *orders)),
            kidx.shape[2], qidx.shape[2])
    return hit


def _kernel_lib():
    global _lib
    if _lib is None:
        from ..op_builder import BlockSparseAttentionBuilder

        lib = BlockSparseAttentionBuilder().load()
        tail = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_float] + [
            ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_void_p]
        lib.dstt_block_sparse_attention_fwd.argtypes = [ctypes.c_void_p] * 5 + tail
        lib.dstt_block_sparse_attention_bwd.argtypes = [ctypes.c_void_p] * 9 + tail
        for fn in (lib.dstt_block_sparse_attention_fwd, lib.dstt_block_sparse_attention_bwd):
            fn.restype = ctypes.c_int
        lib.dstt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dstt_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _prepare_cuda(q, k, v, layout, block, num_kv_groups, extra=()):
    """Check what the kernels take; returns the layout as a bool array."""
    fa._check_cuda_inputs(q, k, v, num_kv_groups, extra)
    layout = np.asarray(layout, bool)
    _check_layout(layout, q.shape[2], q.shape[1], k.shape[1], block)
    check_kernel_config(q.shape[2], k.shape[2], q.shape[3], q.dtype, block)
    if q.shape[1] % block or k.shape[1] % block:
        raise ValueError(f"block {block} does not divide the sequence lengths "
                         f"{q.shape[1]}, {k.shape[1]}")
    return layout


def _raise_if(err, lib, what):
    if err:
        raise RuntimeError(f"block-sparse attention {what} kernel launch failed: "
                           + lib.dstt_cuda_error_string(err).decode())


def block_sparse_attention_fwd(q, k, v, layout, block: int, *, causal: bool = False,
                               num_kv_groups: int = 1, scale: Optional[float] = None):
    """(out, lse): out (B, Sq, nh, hd) in q's dtype, contiguous; lse
    (B, nh, Sq) fp32. CPU tensors run the plain version; CUDA tensors launch
    the forward kernel or raise."""
    global fwd_launches
    if q.device.type == "cpu":
        return block_sparse_attention_plain(q, k, v, layout, block, causal=causal,
                                            num_kv_groups=num_kv_groups, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"block_sparse_attention: unsupported device {q.device}")
    layout = _prepare_cuda(q, k, v, layout, block, num_kv_groups)
    lists = _device_lists(layout, causal, num_kv_groups, q.device)
    B, Sq, nh, hd = q.shape
    out = torch.empty((B, Sq, nh, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, nh, Sq), dtype=torch.float32, device=q.device)
    lib = _kernel_lib()
    with torch.cuda.device(q.device):
        err = lib.dstt_block_sparse_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            *lists.pointers(), _KERNEL_DTYPES[q.dtype], B, Sq, k.shape[1], nh, k.shape[2], hd,
            int(causal), fa._scale(q, scale), block, lists.max_k, lists.max_q,
            fa._strides(q, k, v), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if(err, lib, "forward")
    fwd_launches += 1
    return out, lse


def block_sparse_attention_bwd(q, k, v, out, lse, do, layout, block: int, *,
                               causal: bool = False, num_kv_groups: int = 1,
                               scale: Optional[float] = None):
    """(dq, dk, dv) in the dtypes of q, k, v, contiguous. CPU tensors run the
    plain version; CUDA tensors launch the dK/dV and dQ kernels or raise."""
    global bwd_launches
    if q.device.type == "cpu":
        return block_sparse_attention_bwd_plain(q, k, v, out, lse, do, layout, block,
                                                causal=causal, num_kv_groups=num_kv_groups,
                                                scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"block_sparse_attention: unsupported device {q.device}")
    if do.stride(-1) != 1:
        do = do.contiguous()
    layout = _prepare_cuda(q, k, v, layout, block, num_kv_groups, extra=(("do", do),))
    B, Sq, nh, hd = q.shape
    if do.shape != q.shape or lse.shape != (B, nh, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"do {tuple(do.shape)} / lse {tuple(lse.shape)} {lse.dtype} do not "
                         f"match q {tuple(q.shape)}")
    lists = _device_lists(layout, causal, num_kv_groups, q.device)
    delta = fa._delta(out, do)
    lse = lse.contiguous()
    dq = torch.empty((B, Sq, nh, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty(tuple(k.shape), dtype=k.dtype, device=q.device)
    dv = torch.empty(tuple(v.shape), dtype=v.dtype, device=q.device)
    lib = _kernel_lib()
    with torch.cuda.device(q.device):
        err = lib.dstt_block_sparse_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *lists.pointers(),
            _KERNEL_DTYPES[q.dtype], B, Sq, k.shape[1], nh, k.shape[2], hd, int(causal),
            fa._scale(q, scale), block, lists.max_k, lists.max_q, fa._strides(q, k, v, do),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if(err, lib, "backward")
    bwd_launches += 1
    return dq, dk, dv


class _BlockSparseAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, layout, block, causal, num_kv_groups, scale):
        out, lse = block_sparse_attention_fwd(q, k, v, layout, block, causal=causal,
                                              num_kv_groups=num_kv_groups, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(layout=layout, block=block, causal=causal,
                        num_kv_groups=num_kv_groups, scale=scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = block_sparse_attention_bwd(q, k, v, out, lse, do, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def block_sparse_attention(q, k, v, layout: np.ndarray, block: int, *,
                           causal: bool = False, num_kv_groups: int = 1,
                           scale: Optional[float] = None):
    """Attention over a (H, nQ, nK) block layout, visiting only its active
    blocks: q (B, Sq, nh, hd), k / v (B, Skv, kvh, hd), as
    ``attention.xla_attention``; returns (B, Sq, nh, hd) in q's dtype,
    differentiable in q, k and v."""
    B, Sq, nh, hd = q.shape
    Skv = k.shape[1]
    kernel_gate(block, Sq, Skv)
    layout = np.asarray(layout, bool)
    _check_layout(layout, nh, Sq, Skv, block)
    return _BlockSparseAttention.apply(q, k, v, layout, block, bool(causal),
                                       int(num_kv_groups), fa._scale(q, scale))
