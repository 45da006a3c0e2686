"""Weight-only-quantized matmul (counterpart of ``deepspeed_tpu/ops/quantizer/woq_gemm.py``).

``woq_matmul(x, codes, scale, num_bits)`` is ``x @ dequant(codes, scale)``
with the dequantization inside the weight reads: the dequantized weight
never goes to device memory. For CPU tensors it runs
``woq_matmul_plain``; for CUDA tensors it launches the hand-written Hopper
kernel (``deepspeed_tpu_torch/csrc/woq_gemm.cu``) or raises. It never falls
back to the plain version, or to a dequantized copy and ``torch.matmul``,
on the card.

The operand rule, the same for kernel and plain version: the weight is
formed in fp32 as ``_dequant_leaf`` forms it (``code * scale``), rounded to
``x``'s dtype, and the products accumulate in fp32; the result is
``(B, Out)`` fp32. For fp32 ``x`` this is the Pallas kernel's function
(``woq_gemm.py:57-60``); for bf16 ``x`` it is the JAX serving path's
``h @ _dequant_leaf(..., h.dtype)`` with fp32 accumulation. Kernel and plain
version then differ only in the order of an fp32 sum.

Routes (``plan``): up to ``GEMV_MAX_ROWS`` rows the few-rows kernel
(decode: ``woq_gemv_kernel``, a cp.async ring of code slabs, x and scale
rows, the products on ``mma.sync`` for 16-bit x (FMAs for fp32), its K
splits summed inside a thread-block cluster, one launch a call); more rows
in bfloat16 or float16 the tensor-core kernel
(``woq_mma_kernel``: a 4-stage ring of x tiles and code slabs, each weight
dequantized once a CTA; 256-row tiles copy x by TMA and multiply on
``wgmma``, 64-row tiles on ``mma.sync``; prefill); more rows in
float32 the FMA tile kernel (the tests' dtype).

What the kernel takes: ``x`` (B, In) contiguous in float32, bfloat16 or
float16; ``codes`` int8 (ng, packed, Out) and ``scale`` fp32 (ng, 1, Out),
contiguous, as ``quantize_leaf`` makes them (a layer's slice of a stacked
leaf is such a view); 8-, 6- or 4-bit codes; any group the quantizer makes
(a multiple of the packing unit, power of two or not); Out a multiple of 8
(the kernels read eight columns' codes in one 8-byte load). The few-rows
and tensor-core kernels copy x in 16-byte pieces (or by TMA): an x that
does not start on 16 bytes, or an In that is not a multiple of 8, is first
copied into a zero-padded buffer.
"""

import ctypes
import functools

import torch

from .woq import PACK_UNIT, _dequant_leaf, group_of
from ..launch_counters import register as _register_counters

#: kernel launches made by :func:`woq_matmul` (CUDA tensors only)
launches = 0
#: those of them that ran a many-rows kernel (``mma`` or ``fma``: prefill)
tiled_launches = 0

_register_counters(globals(), "launches", "tiled_launches")

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_KINDS = {"gemv": 0, "fma": 1, "mma": 2}
#: rows up to which the few-rows kernel runs (decode); more take a tiled one
GEMV_MAX_ROWS = 8
#: the few-rows kernel's columns a CTA, and the most K splits a column tile
#: takes (a cluster: the portable size)
GEMV_COLS, GEMV_MAX_SPLITS = 128, 8
_TARGET_CTAS = 528      # FMA grids: 4 CTAs on each of the H100's 132 SMs
#: the fp32 FMA tile kernel's tile and K step
FMA_TILE_M, FMA_TILE_N, FMA_TILE_K = 64, 64, 32
#: the tensor-core kernel's K step and columns a CTA (rows: ``mma_tile``)
MMA_TILE_K, MMA_TILE_N = 64, 128
_MIN_STAGED_GROUP = 32  # smaller groups read their scales from L1, not a staged row
_MAX_SPLITS = 8         # more splits cost more in partial sums than waves save
_lib = None


def check_woq_config(in_dim: int, out_dim: int, num_bits: int, group: int,
                     dtype: torch.dtype) -> None:
    """Raise ``NotImplementedError`` if the CUDA kernel cannot take this
    projection. The engine calls it for every quantized leaf at
    construction, so a tree the kernel cannot take fails there and not in
    the middle of a step."""
    if num_bits not in PACK_UNIT:
        raise NotImplementedError(f"woq_matmul CUDA kernel: {num_bits}-bit codes")
    if dtype not in _KERNEL_DTYPES:
        raise NotImplementedError(
            f"woq_matmul CUDA kernel: activations of dtype {dtype} not in "
            f"{list(_KERNEL_DTYPES)}")
    unit = PACK_UNIT[num_bits][0]
    if group <= 0 or group % unit or in_dim % group:
        raise NotImplementedError(
            f"woq_matmul CUDA kernel: group {group} is not a multiple of the "
            f"int{num_bits} packing unit {unit} dividing In {in_dim}")
    if out_dim <= 0 or out_dim % 8:
        raise NotImplementedError(
            f"woq_matmul CUDA kernel: Out {out_dim} is not a multiple of 8")


def woq_matmul_plain(x, codes, scale, num_bits: int):
    """The plain version: the weight dequantized in fp32, rounded to ``x``'s
    dtype, then an fp32 product. (B, Out) fp32."""
    w = _dequant_leaf(codes, scale, num_bits, x.dtype)
    return x.to(torch.float32) @ w.to(torch.float32)


def gemv_ctas_per_sm(x_dtype: torch.dtype) -> int:
    """Resident CTAs of the few-rows kernel on one H100 SM: 3 for 16-bit x
    (its registers are held to 3 CTAs' share, its 4-stage ring takes 47.6
    KB), else 2 (the fp32 FMA path's 128 registers)."""
    return 3 if x_dtype != torch.float32 else 2


def mma_tile(rows: int):
    """(rows, columns) of a tensor-core CTA's tile: 64 rows up to 64 (the
    ``mma.sync`` tile, which does not pay for 256 rows' products), else 256
    (the ``wgmma`` tile, which dequantizes each weight once in the grid at
    256 rows); 128 columns."""
    return (64 if rows <= 64 else 256), MMA_TILE_N


@functools.lru_cache(maxsize=4096)
def plan(rows: int, in_dim: int, out_dim: int, group: int,
         x_dtype: torch.dtype = torch.bfloat16, ctas_per_sm: int = 1, sms: int = 132):
    """(kernel, tile_m, tile_n, splits, split_len) for one call.

    - ``gemv`` (rows <= ``GEMV_MAX_ROWS``): columns in tiles of
      ``tile_n`` = ``GEMV_COLS``, K in ``splits`` runs of ``split_len``
      groups, at most ``GEMV_MAX_SPLITS`` (one cluster a column tile, its
      splits summed there in order): as many splits as fit one wave of
      ``gemv_ctas_per_sm`` CTAs on each of ``sms`` SMs (measured: a
      second, partial wave costs more than the longer K runs it saves).
      ``tile_m`` is 0. Never a function of ``rows``: a row's sums are the
      same at 1 and at 8 rows;
    - ``fma`` (more rows, float32 x): 64 x 64 tiles, K in runs of
      ``split_len`` rows (a multiple of ``FMA_TILE_K``), as many CTAs as
      four an SM;
    - ``mma`` (more rows, 16-bit x): ``mma_tile`` tiles; K in runs of
      ``split_len`` rows (a multiple of ``MMA_TILE_K``). ``ctas_per_sm`` is
      the card's own residency for that kernel (``_residency``) and ``sms``
      its SM count: with no split, a grid of ``tiles`` CTAs takes
      ceil(tiles / slots) waves of all K steps; ``splits`` runs trade that
      for ceil(tiles * splits / slots) waves of a split's steps. The
      fewest splits within 5% of the fewest wave-steps win, and only if
      they save a tenth over no split: each split adds its partial sums
      to a reduction pass. Tiles that fill whole waves take no split.

    Partial sums of a tiled kernel's split go to a workspace that a second
    pass adds in a fixed order: repeated calls are bitwise equal. A pure
    function of its arguments (cached)."""
    ng = in_dim // group
    if rows <= GEMV_MAX_ROWS:
        slots = gemv_ctas_per_sm(x_dtype) * sms
        splits = max(1, min(GEMV_MAX_SPLITS, ng, slots // -(-out_dim // GEMV_COLS)))
        per = -(-ng // splits)
        return "gemv", 0, GEMV_COLS, -(-ng // per), per
    if x_dtype == torch.float32:
        tiles = -(-rows // FMA_TILE_M) * -(-out_dim // FMA_TILE_N)
        k_tiles = -(-in_dim // FMA_TILE_K)
        splits = 1 if tiles >= _TARGET_CTAS else min(k_tiles, -(-_TARGET_CTAS // tiles))
        per = -(-k_tiles // splits)
        return "fma", FMA_TILE_M, FMA_TILE_N, -(-k_tiles // per), per * FMA_TILE_K
    tile_m, tile_n = mma_tile(rows)
    tiles = -(-rows // tile_m) * -(-out_dim // tile_n)
    k_steps = -(-in_dim // MMA_TILE_K)
    slots = max(1, ctas_per_sm) * sms

    cost = {}  # splits -> wave-steps of the grid
    for s in range(1, min(k_steps, _MAX_SPLITS) + 1):
        per = -(-k_steps // s)
        cost[s] = -(-tiles * -(-k_steps // per) // slots) * per
    # the fewest splits within 5% of the fewest wave-steps, if that saves
    # a tenth: each split adds its partial sums to the reduction's bytes
    splits = min(s for s in cost if cost[s] <= 1.05 * min(cost.values()))
    if cost[splits] > 0.9 * cost[1]:
        splits = 1
    per = -(-k_steps // splits)
    return "mma", tile_m, tile_n, -(-k_steps // per), per * MMA_TILE_K


def _kernel_lib():
    global _lib
    if _lib is None:
        from ..op_builder import WoqGemmBuilder

        lib = WoqGemmBuilder().load()
        fn = lib.dstt_woq_matmul
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.dstt_woq_mma_ctas_per_sm.argtypes = [ctypes.c_int] * 4
        lib.dstt_woq_mma_ctas_per_sm.restype = ctypes.c_int
        lib.dstt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dstt_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def _residency(device_index: int, dtype: torch.dtype, num_bits: int, tile_m: int,
               small_group: bool):
    """(CTAs of the tensor-core kernel resident on one SM, SMs) on the card,
    from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` (its registers
    and dynamic shared memory); raises if the query fails."""
    lib = _kernel_lib()
    with torch.cuda.device(device_index):
        n = lib.dstt_woq_mma_ctas_per_sm(_KERNEL_DTYPES[dtype], num_bits, tile_m,
                                         1 if small_group else _MIN_STAGED_GROUP)
    if n <= 0:
        raise RuntimeError("woq_matmul: the tensor-core kernel cannot be resident: "
                           + (lib.dstt_cuda_error_string(-n).decode() if n < 0
                              else "0 CTAs an SM"))
    return n, torch.cuda.get_device_properties(device_index).multi_processor_count


def _check_cuda_inputs(x, codes, scale, num_bits, group) -> None:
    B, In = x.shape
    ng, _, Out = codes.shape
    check_woq_config(In, Out, num_bits, group, x.dtype)
    if codes.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(f"codes must be int8 and scale float32, got {codes.dtype} / "
                         f"{scale.dtype}")
    if tuple(scale.shape) != (ng, 1, Out):
        raise ValueError(f"scale {tuple(scale.shape)} does not match codes "
                         f"{tuple(codes.shape)}")
    for name, t, align in (("x", x, x.element_size()), ("codes", codes, 8),
                           ("scale", scale, 16)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % align:
            raise ValueError(f"{name} must start on a {align}-byte boundary")
    if max(B, In, Out) >= 2 ** 31 // 8:
        raise ValueError("woq_matmul: sizes must fit in int32")


def woq_matmul(x, codes, scale, num_bits: int):
    """``x @ dequant(codes, scale)`` with dequant fused into the weight reads.

    - ``x``: (B, In) activations (float32, bfloat16 or float16)
    - ``codes``: (ng, packed, Out) int8 from ``quantize_leaf``
    - ``scale``: (ng, 1, Out) fp32
    Returns (B, Out) fp32. The JAX function's ``block_out`` chose a TPU
    tiling only and has no counterpart here.
    """
    global launches, tiled_launches
    B, In = x.shape
    ng, packed, Out = codes.shape
    group = group_of(num_bits, packed)
    if ng * group != In:
        raise ValueError(f"codes {tuple(codes.shape)} (group {group}) != In {In}")
    if x.device.type == "cpu":
        return woq_matmul_plain(x, codes, scale, num_bits)
    if x.device.type != "cuda":
        raise ValueError(f"woq_matmul: unsupported device {x.device}")
    _check_cuda_inputs(x, codes, scale, num_bits, group)
    out = torch.empty((B, Out), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    ctas, sms = 1, 132
    if B > GEMV_MAX_ROWS and x.dtype != torch.float32:
        ctas, sms = _residency(x.device.index if x.device.index is not None
                               else torch.cuda.current_device(), x.dtype, num_bits,
                               mma_tile(B)[0], group < _MIN_STAGED_GROUP)
    kind, tile_m, tile_n, splits, split_len = plan(B, In, Out, group, x.dtype, ctas, sms)
    x_ld = In
    if kind != "fma" and (x.data_ptr() % 16 or In % 8):
        # the few-rows and tensor-core kernels copy x in 16-byte pieces:
        # rows padded to a multiple of 8 elements with zeros, on a fresh
        # allocation
        x_ld = -(-In // 8) * 8
        padded = x.new_zeros((B, x_ld))
        padded[:, :In] = x
        x = padded
    work = (torch.empty((splits, B, Out), dtype=torch.float32, device=x.device)
            if splits > 1 and kind != "gemv" else None)
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        err = lib.dstt_woq_matmul(
            x.data_ptr(), codes.data_ptr(), scale.data_ptr(), out.data_ptr(),
            None if work is None else work.data_ptr(), _KERNEL_DTYPES[x.dtype], num_bits,
            B, In, Out, group, _KINDS[kind], tile_m, splits, split_len, x_ld,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("woq_matmul kernel launch failed: "
                           + lib.dstt_cuda_error_string(err).decode())
    launches += 1
    if kind != "gemv":
        tiled_launches += 1
    return out
