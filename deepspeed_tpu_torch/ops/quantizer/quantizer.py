"""Block quantization ops (counterpart of ``deepspeed_tpu/ops/quantizer/quantizer.py``).

Symmetric or asymmetric N-bit block quantization used by ZeRO++ (the qwZ
weight all-gather, the qgZ gradient all-to-all). As in the JAX package these
are plain elementwise tensor ops, not kernels: the codes are int8 whatever
``num_bits`` (<= 8), and the same float32 arithmetic in the same order
(``x / scale``, round half to even, clip), so codes and scales equal the
JAX package's bit for bit. The collectives take a group of the topology
(``comm``) where the JAX ones take a mesh axis inside ``shard_map``.
``fake_quantize`` (QAT) stays with ``compression/`` (ROADMAP.md Queue 1
item 17).
"""

from typing import Tuple

import torch

from ...comm import comm as dist


def _blocked(x, num_groups: int):
    flat = x.reshape(-1)
    n = flat.shape[0]
    if n % num_groups:
        raise ValueError(f"size {n} not divisible by {num_groups} groups")
    return flat.reshape(num_groups, n // num_groups)


def quantize(x, num_bits: int = 8, num_groups: int = 1,
             symmetric: bool = True) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Blockwise quantize -> (int8 codes, scale (G, 1), zero-point (G, 1));
    the range is [-2^(b-1), 2^(b-1)-1] symmetric, [0, 2^b-1] asymmetric."""
    g = _blocked(x.to(torch.float32), num_groups)
    if symmetric:
        qmax = 2.0 ** (num_bits - 1) - 1
        scale = torch.amax(torch.abs(g), dim=-1, keepdim=True) / qmax
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        codes = torch.clamp(torch.round(g / scale), -qmax - 1, qmax)
        zero = torch.zeros_like(scale)
    else:
        qmax = 2.0 ** num_bits - 1
        lo = torch.amin(g, dim=-1, keepdim=True)
        hi = torch.amax(g, dim=-1, keepdim=True)
        scale = (hi - lo) / qmax
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        zero = lo
        codes = torch.clamp(torch.round((g - zero) / scale), 0, qmax)
    # int8 storage: XLA's float-to-int8 conversion saturates (an 8-bit
    # asymmetric code above 127 is stored as 127), torch's wraps
    return torch.clamp(codes, -128, 127).to(torch.int8), scale, zero


def dequantize(codes, scale, zero, orig_shape) -> torch.Tensor:
    g = codes.to(torch.float32) * scale + zero
    return g.reshape(orig_shape)


def quantized_all_gather(x, group=None, num_bits: int = 8, num_groups: int = 16):
    """qwZ-style gather: quantize, all-gather the codes, scales and zero
    points, dequantize: ``(n,) + x.shape`` in group-rank order."""
    codes, scale, zero = quantize(x, num_bits, num_groups)
    codes_g = dist.inprog_all_gather(codes, group, tiled=False, log_name="qwz_codes")
    scale_g = dist.inprog_all_gather(scale, group, tiled=False, log_name="qwz_scales")
    zero_g = dist.inprog_all_gather(zero, group, tiled=False, log_name="qwz_zeros")
    return torch.stack([dequantize(c, s, z, x.shape)
                        for c, s, z in zip(codes_g, scale_g, zero_g)])


def quantized_reduce_scatter(grad, group=None, num_bits: int = 8, num_groups: int = 16):
    """qgZ-style reduction (``all_to_all_quant_reduce``): each chunk of
    ``grad``'s leading dim (one a destination rank, so it must equal the
    group's size) quantized, the codes all-to-all'd, dequantized and summed."""
    n = dist.get_world_size(group)
    if grad.shape[0] != n:
        raise ValueError(f"leading dim {grad.shape[0]} must equal the group's size {n}")
    parts = [quantize(chunk, num_bits, num_groups) for chunk in grad]
    codes, scale, zero = (torch.stack(t) for t in zip(*parts))
    codes = dist.inprog_all_to_all(codes, group, 0, 0, tiled=False, log_name="qgz_codes")
    scale = dist.inprog_all_to_all(scale, group, 0, 0, tiled=False, log_name="qgz_scales")
    zero = dist.inprog_all_to_all(zero, group, 0, 0, tiled=False, log_name="qgz_zeros")
    deq = torch.stack([dequantize(c, s, z, grad.shape[1:]) for c, s, z in zip(codes, scale, zero)])
    return torch.sum(deq, dim=0)
