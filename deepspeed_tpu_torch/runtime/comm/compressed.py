"""Error-feedback compressed all-reduce for the 1-bit optimizers (counterpart of ``deepspeed_tpu/runtime/comm/compressed.py``).

Reference ``deepspeed/runtime/comm/nccl.py:52 compressed_allreduce``: the
gradient plus the rank's carried error is sign-compressed (one bit an
element and one float32 scale, the mean magnitude), the packed sign bits
and the scales are all-gathered, and every rank unpacks and averages the
``W`` sign planes itself (the reference's server stage on each rank). The
compression residual stays on the rank as the error fed into its next call:
information is delayed, never lost. Signs pack eight to a byte, least
significant bit first, as in the JAX package, so the packed bytes are its
own; ``wire="int8"`` moves one byte a sign instead.
"""

from typing import Tuple

import torch

from ...comm import comm as dist


def pack_bits(bits_flat: torch.Tensor) -> torch.Tensor:
    """(n,) {0, 1} -> (ceil(n / 8),) uint8, least significant bit first."""
    n = bits_flat.numel()
    n8 = -(-n // 8) * 8
    b = torch.zeros(n8, dtype=torch.uint8, device=bits_flat.device)
    b[:n] = bits_flat.to(torch.uint8)
    weights = (1 << torch.arange(8, dtype=torch.int32, device=b.device)).to(torch.uint8)
    return torch.sum(b.reshape(-1, 8).to(torch.int32) * weights.to(torch.int32),
                     dim=1).to(torch.uint8)


def unpack_signs(packed: torch.Tensor, n: int) -> torch.Tensor:
    """(..., nb) uint8 -> (..., n) float32 signs (+1 / -1)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    flat = bits.reshape(*packed.shape[:-1], -1)[..., :n]
    return flat.to(torch.float32) * 2.0 - 1.0


def compressed_allreduce(grad, error, group=None, wire: str = "1bit"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 1-bit error-feedback mean of ``grad`` over ``group``: (the mean
    approximation in ``grad``'s dtype and shape, this rank's new error)."""
    corrected = grad.to(torch.float32) + error
    scale = torch.mean(torch.abs(corrected))
    n = corrected.numel()
    bits = (corrected >= 0).reshape(-1)
    local_signs = torch.where(bits, 1.0, -1.0).reshape(corrected.shape)
    new_error = corrected - scale * local_signs
    g_scale = dist.inprog_all_gather(scale.reshape(1), group, tiled=True,
                                     log_name="onebit_scales")  # (W,)
    if wire == "int8":
        g_signs = dist.inprog_all_gather(local_signs.to(torch.int8).reshape(-1), group,
                                         tiled=False, log_name="onebit_signs")
        planes = g_signs.to(torch.float32)
    else:
        g_packed = dist.inprog_all_gather(pack_bits(bits), group, tiled=False,
                                          log_name="onebit_signs")  # (W, n / 8) uint8
        planes = unpack_signs(g_packed, n)
    reduced = torch.einsum("w,wn->n", g_scale, planes) / g_scale.numel()
    return reduced.reshape(grad.shape).to(grad.dtype), new_error

