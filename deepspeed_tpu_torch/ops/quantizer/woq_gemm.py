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

What the kernel takes: ``x`` (B, In) contiguous in float32, bfloat16 or
float16; ``codes`` int8 (ng, packed, Out) and ``scale`` fp32 (ng, 1, Out),
contiguous, as ``quantize_leaf`` makes them (a layer's slice of a stacked
leaf is such a view); 8-, 6- or 4-bit codes; any group the quantizer makes
(a multiple of the packing unit, power of two or not); Out a multiple of 8
(the kernel reads eight columns' codes in one 8-byte load).
"""

import ctypes

import torch

from .woq import PACK_UNIT, _dequant_leaf, group_of

#: kernel launches made by :func:`woq_matmul` (CUDA tensors only)
launches = 0

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: rows up to which the few-rows kernel runs (decode); more take the tiled one
GEMV_MAX_ROWS = 8
_GEMV_COLS = 256        # columns a few-rows CTA covers (32 lanes x 8)
_TILE_M, _TILE_N, _TILE_K = 64, 64, 32
_TARGET_CTAS = 528      # 4 CTAs on each of the H100's 132 SMs
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


def plan(rows: int, in_dim: int, out_dim: int, group: int):
    """(kernel, splits, split_len) for one call: the few-rows kernel splits
    K into ``splits`` runs of ``split_len`` groups, the tiled one into runs
    of ``split_len`` rows of K (a multiple of its K tile), so that enough
    CTAs fill the card. Partial sums of a split go to a workspace that a
    second pass adds in a fixed order: repeated calls are bitwise equal."""
    ng = in_dim // group
    if rows <= GEMV_MAX_ROWS:
        col_tiles = -(-out_dim // _GEMV_COLS)
        splits = min(ng, -(-_TARGET_CTAS // col_tiles))
        per = -(-ng // splits)
        return "gemv", -(-ng // per), per
    tiles = -(-rows // _TILE_M) * -(-out_dim // _TILE_N)
    k_tiles = -(-in_dim // _TILE_K)
    splits = 1 if tiles >= _TARGET_CTAS else min(k_tiles, -(-_TARGET_CTAS // tiles))
    per = -(-k_tiles // splits)
    return "tiled", -(-k_tiles // per), per * _TILE_K


def _kernel_lib():
    global _lib
    if _lib is None:
        from ..op_builder import WoqGemmBuilder

        lib = WoqGemmBuilder().load()
        fn = lib.dstt_woq_matmul
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.dstt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dstt_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


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
    global launches
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
    kind, splits, split_len = plan(B, In, Out, group)
    work = (torch.empty((splits, B, Out), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        err = lib.dstt_woq_matmul(
            x.data_ptr(), codes.data_ptr(), scale.data_ptr(), out.data_ptr(),
            None if work is None else work.data_ptr(), _KERNEL_DTYPES[x.dtype], num_bits,
            B, In, Out, group, int(kind == "tiled"), splits, split_len,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("woq_matmul kernel launch failed: "
                           + lib.dstt_cuda_error_string(err).decode())
    launches += 1
    return out
