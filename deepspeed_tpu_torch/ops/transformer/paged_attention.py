"""Paged decode attention (counterpart of ``deepspeed_tpu/ops/transformer/paged_attention.py``).

One query token per row against a blocked KV pool, addressed through
per-row block tables. ``paged_decode_attention`` is the wrapper: for CPU
tensors it runs ``paged_decode_attention_plain``; for CUDA tensors it
launches the hand-written Hopper kernel
(``deepspeed_tpu_torch/csrc/paged_attention.cu``) or raises. It never
falls back to the plain version on the card.

What the kernel takes (the Hopper counterpart of the TPU gate at
``deepspeed_tpu/models/transformer.py:579-587``, whose ``hd in (64, 128,
256)`` and ``block_size % 8`` limits came from Mosaic's tiling): head_dim
32, 64, 128 or 256 (a key's score is spread over hd / 32 lanes, 32 dims a
lane); any block size; any group ``nh / kvh`` (query heads are taken in
chunks of at most 8 per CTA); float32, bfloat16 or float16 with q and the
pools of one dtype; contiguous tensors whose data starts on a 16-byte
boundary.

How a call is split: ``plan``, a pure function of the table width, the
block size and head_dim (never of the batch or of ``lens``), gives the
wrapper the number of partitions it passes to the kernel; a row's table
slots are dealt round-robin to them, and their softmax states fold in
partition order. The kernel's host code picks the launch shape from the
batch: at decode (fewer than 4 CTAs an SM from the rows alone) the
partitions of a (row, kv head, head chunk) run as one thread-block
cluster, a CTA each; with more rows a CTA takes up to 16 consecutive
rows (8 in float32) that hold the same table (a prefill chunk's rows are
one sequence) and walks their partitions in turn, reading each K/V tile
once for all of them (in 16 bits on the tensor cores, the rows x query
heads as the 16 rows of ``mma.sync`` products). The arithmetic is the same either way: one launch a call, and a
row's output does not depend on the batch it is in.
"""

import functools
from typing import List, Optional, Tuple

import torch

from .attention import xla_attention
from ..launch_counters import register as _register_counters

NEG_INF = -1e30

#: kernel launches made by :func:`paged_decode_attention` (CUDA tensors only)
launches = 0

_register_counters(globals(), "launches")

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_KERNEL_HEAD_DIMS = (32, 64, 128, 256)
#: the kernel's cluster size limit (the portable one) and the fewest keys a
#: partition is given, as the table allows
MAX_PARTS, MIN_PART_KEYS = 8, 256
_lib = None


@functools.lru_cache(maxsize=1024)
def plan(max_blocks: int, block_size: int, head_dim: int) -> Tuple[int, int, int]:
    """(parts, blocks a partition holds at most, keys a pipeline tile) of
    the kernel: ``parts = min(8, MAXB, ceil(MAXB * BS / 256))`` (at least
    1) partitions a row, which the wrapper passes to the kernel, partition
    p taking table slots p, p + parts, p + 2 parts, ...; tiles of ``4096 //
    head_dim`` keys (``csrc/paged_attention.cu`` ``Cfg::TK``). A pure
    function of the table's shape: the launch shape is known without
    reading ``lens``, and no row's arithmetic depends on the batch."""
    parts = max(1, min(MAX_PARTS, max_blocks, -(-max_blocks * block_size // MIN_PART_KEYS)))
    return parts, -(-max_blocks // parts), 4096 // head_dim


def partition_slots(length: int, max_blocks: int, block_size: int, part: int) -> List[int]:
    """The table slots partition ``part`` reads for a row of ``length``
    keys, walked as the kernel walks them: its keys below ``length`` are
    a prefix of ``vkeys`` keys, key k at offset k % BS of slot part +
    parts * (k // BS) (empty: the partition does no work; partition 0
    still writes the row)."""
    parts = plan(max_blocks, block_size, 32)[0]
    length = max(length, 0)
    nblk = min(-(-length // block_size), max_blocks)
    if part >= nblk:
        return []
    nb = (nblk - 1 - part) // parts + 1  # the partition's blocks
    last = part + parts * (nb - 1)
    vkeys = ((nb - 1) * block_size + length - (nblk - 1) * block_size
             if last == nblk - 1 else nb * block_size)
    slots = []
    for k in range(vkeys):
        slot = part + parts * (k // block_size)
        if slot * block_size + k % block_size >= length:
            break
        if not slots or slots[-1] != slot:
            slots.append(slot)
    return slots


def check_kernel_config(num_heads: int, kv_heads: int, head_dim: int,
                        dtype: torch.dtype) -> None:
    """Raise ``NotImplementedError`` if the CUDA kernel cannot serve this
    attention shape. The engine calls it at construction, so a model the
    kernel cannot serve fails there and not in the middle of a step."""
    if head_dim not in _KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"paged_decode_attention CUDA kernel: head_dim {head_dim} not in "
            f"{_KERNEL_HEAD_DIMS}")
    if kv_heads <= 0 or num_heads % kv_heads:
        raise NotImplementedError(
            f"paged_decode_attention CUDA kernel: num_heads {num_heads} is not "
            f"a multiple of kv_heads {kv_heads}")
    if dtype not in _KERNEL_DTYPES:
        raise NotImplementedError(
            f"paged_decode_attention CUDA kernel: dtype {dtype} not in "
            f"{list(_KERNEL_DTYPES)}")


def paged_decode_attention_plain(q, k_pool, v_pool, tables, lens, *,
                                 scale: Optional[float] = None):
    """The gather and position-mask version: gather each row's table blocks
    into a logical cache, mask keys at positions ``>= lens``, softmax in
    fp32 (the JAX package's non-kernel branch, ``transformer.py:596-607``,
    and the oracle of ``tests/unit/test_paged_kernel.py:14``). Rows with
    ``lens == 0`` give zeros, as the kernel does."""
    B, nh, hd = q.shape
    kvh, _, BS, _ = k_pool.shape
    T = tables.shape[1] * BS
    idx = tables.long()
    # (kvh, B, MAXB, BS, hd) -> (B, T, kvh, hd): the logical cache of each row
    gk = k_pool[:, idx].permute(1, 2, 3, 0, 4).reshape(B, T, kvh, hd)
    gv = v_pool[:, idx].permute(1, 2, 3, 0, 4).reshape(B, T, kvh, hd)
    valid = torch.arange(T, device=q.device)[None, :] < lens[:, None]  # (B, T)
    bias = torch.where(valid, 0.0, NEG_INF)[:, None, None, None, :]  # (B,1,1,1,T)
    out = xla_attention(q[:, None], gk, gv, causal=False,
                        num_kv_groups=nh // kvh, bias=bias, scale=scale)[:, 0]
    return out.masked_fill((lens <= 0)[:, None, None], 0.0)


def _kernel_lib():
    global _lib
    if _lib is None:
        import ctypes

        from ..op_builder import PagedAttentionBuilder

        lib = PagedAttentionBuilder().load()
        fn = lib.dstt_paged_decode_attention
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.dstt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dstt_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_cuda_inputs(q, k_pool, v_pool, tables, lens) -> None:
    if q.dim() != 3 or k_pool.dim() != 4 or tables.dim() != 2 or lens.dim() != 1:
        raise ValueError("paged_decode_attention expects q (B, nh, hd), pools "
                         "(kvh, NB, BS, hd), tables (B, MAXB) and lens (B,)")
    B, nh, hd = q.shape
    kvh, NB, BS, hd_k = k_pool.shape
    if v_pool.shape != k_pool.shape or hd_k != hd:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)} / {tuple(v_pool.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if tables.shape[0] != B or lens.shape[0] != B:
        raise ValueError(f"tables {tuple(tables.shape)} / lens {tuple(lens.shape)} "
                         f"do not match batch {B}")
    check_kernel_config(nh, kvh, hd, q.dtype)
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("lens", lens)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"pool dtype {k_pool.dtype}/{v_pool.dtype} != q dtype {q.dtype}")
    if tables.dtype != torch.int32 or lens.dtype != torch.int32:
        raise ValueError("tables and lens must be int32")
    if max(B, NB * BS * hd * kvh, tables.numel()) >= 2 ** 31:
        raise ValueError("paged_decode_attention: sizes must fit in int32")


def paged_decode_attention(q, k_pool, v_pool, tables, lens, *,
                           scale: Optional[float] = None):
    """One-token decode attention against a blocked KV pool.

    q: (B, nh, hd); k_pool / v_pool: (kvh, NB, BS, hd), kv-head-major;
    tables: (B, MAXB) int32 pool block ids (0-padded; block 0 is the trash
    block); lens: (B,) int32 valid token counts (position + 1). Returns
    (B, nh, hd) in q's dtype. The JAX function's ``stream`` flag chose a TPU
    layout only and has no counterpart here.
    """
    global launches
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, tables, lens,
                                            scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
    _check_cuda_inputs(q, k_pool, v_pool, tables, lens)
    B, nh, hd = q.shape
    kvh, NB, BS, _ = k_pool.shape
    out = torch.empty_like(q)
    if B == 0:
        return out
    MAXB = tables.shape[1]
    lib = _kernel_lib()
    with torch.cuda.device(q.device):
        err = lib.dstt_paged_decode_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
            lens.data_ptr(), out.data_ptr(), _KERNEL_DTYPES[q.dtype], B, nh, kvh,
            hd, NB, BS, MAXB, plan(MAXB, BS, hd)[0],
            float(hd ** -0.5 if scale is None else scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("paged_decode_attention kernel launch failed: "
                           + lib.dstt_cuda_error_string(err).decode())
    launches += 1
    return out
