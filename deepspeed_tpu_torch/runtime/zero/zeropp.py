"""ZeRO++ quantized collectives (counterpart of ``deepspeed_tpu/runtime/zero/zeropp.py``).

- **qwZ** (``zero_quantized_weights``): a stage-3 weight gather moves int8
  block codes and float32 block scales instead of the weight: each rank
  quantizes its shard in flat blocks of ``block`` elements, the codes and
  scales are all-gathered, every rank dequantizes (``gather_param_leaf``,
  the JAX ``_gather_param_leaf`` :166). The backward is straight through:
  the gradient is reduced as for the unquantized gather.
- **qgZ** (``zero_quantized_gradients``): the gradient's mean over the
  data-parallel ranks in two int8 hops (``quantized_reduce_leaf``, the JAX
  ``_quantized_reduce_leaf`` :213): each rank quantizes one chunk a
  destination, an all-to-all delivers them, each rank dequantizes and sums
  its chunk (a reduce-scatter); then the reduced chunk is quantized again
  and all-gathered. ``hops=1`` stops after the first hop: the caller that
  needs only its own chunk (stages 2 and 3) saves the second.
- **hpZ** (``zero_hpz_partition_size``): stage-3 weights shard over the
  ``hpz`` axis alone (``partition.stage_param_specs``), so their gathers run
  inside an hpz group; the engine passes that group.

The block quantizer and the layouts are the JAX package's, so the codes and
scales are bit for bit its own on the same inputs.
"""

import torch

from ...comm import comm as dist


def block_quantize_rows(x, num_bits: int):
    """Symmetric block quantization over the last axis -> (int8 codes,
    float32 scales with a last axis of 1)."""
    qmax = 2.0 ** (num_bits - 1) - 1
    scale = torch.amax(torch.abs(x), dim=-1, keepdim=True) / qmax
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    codes = torch.clamp(torch.round(x / scale), -qmax - 1, qmax).to(torch.int8)
    return codes, scale


def gather_param_leaf(x, group, axis: int, quantized: bool, num_bits: int = 8,
                      block: int = 512, log_name: str = "param_gather"):
    """``x`` (this rank's shard) gathered over ``group`` and concatenated
    along ``axis``; ``quantized``: over the qwZ wire."""
    if not quantized:
        return dist.inprog_all_gather(x, group, axis=axis, tiled=True, log_name=log_name)
    n = x.numel()
    nb = -(-n // block)
    flat = x.reshape(-1).to(torch.float32)
    if nb * block != n:
        flat = torch.cat([flat, flat.new_zeros(nb * block - n)])
    codes, scale = block_quantize_rows(flat.reshape(nb, block), num_bits)
    g_codes = dist.inprog_all_gather(codes, group, tiled=False, log_name="qwz_codes")
    g_scale = dist.inprog_all_gather(scale, group, tiled=False, log_name="qwz_scales")
    deq = (g_codes.to(torch.float32) * g_scale).reshape(g_codes.shape[0], -1)
    deq = deq[:, :n].to(x.dtype)
    return torch.cat([d.reshape(x.shape) for d in deq], dim=axis)


def quantized_reduce_leaf(g, group, dp_size: int, num_bits: int = 8, block: int = 512,
                          hops: int = 2):
    """The mean of ``g`` over ``group`` through int8 all-to-all (and, with
    ``hops=2``, int8 all-gather). ``hops=2``: ``g``'s shape, on every rank.
    ``hops=1``: this rank's flat chunk of ``ceil(n / dp_size)`` elements of
    the mean (the padding past ``n`` zero)."""
    n = g.numel()
    flat = g.reshape(-1).to(torch.float32)
    per = -(-n // dp_size)
    # blocks of ~block elements, never spanning two destinations' chunks
    ng = max(1, per // block)
    while per % ng:
        ng -= 1
    pad = dp_size * per - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    chunks = flat.reshape(dp_size, ng, per // ng)
    # hop 1: quantize a chunk a destination, all-to-all, dequantize and sum
    codes, scale = block_quantize_rows(chunks, num_bits)
    codes = dist.inprog_all_to_all(codes, group, 0, 0, tiled=False, log_name="qgz_codes")
    scale = dist.inprog_all_to_all(scale, group, 0, 0, tiled=False, log_name="qgz_scales")
    shard = torch.sum(codes.to(torch.float32) * scale, dim=0)  # (ng, per / ng)
    if hops == 1:
        return shard.reshape(-1) / dp_size
    # hop 2: quantize the reduced chunk, all-gather, dequantize
    codes2, scale2 = block_quantize_rows(shard[None], num_bits)
    codes2 = dist.inprog_all_gather(codes2, group, axis=0, tiled=True, log_name="qgz_codes")
    scale2 = dist.inprog_all_gather(scale2, group, axis=0, tiled=True, log_name="qgz_scales")
    full = (codes2.to(torch.float32) * scale2).reshape(-1)[:n] / dp_size
    return full.reshape(g.shape).to(g.dtype)
