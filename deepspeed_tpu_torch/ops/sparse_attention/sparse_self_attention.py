"""Sparse self-attention op (counterpart of ``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``).

``SparseSelfAttention(config)(q, k, v)`` is attention restricted to the
config's block layout, on the model's (B, S, heads, hd) surface. It has two
paths, as in the JAX package:

- the block-sparse kernels (``block_sparse_kernel.py``), which visit only
  the layout's active blocks. ``use_kernel="auto"`` takes them for CUDA
  tensors, where the JAX package took them on a TPU; ``"always"`` takes
  them for any tensor (the plain versions on the CPU);
- the masked path: the layout as an additive bias (``layout_to_bias``) over
  the port's plain ``xla_attention``. It runs for CPU tensors under
  ``"auto"``, for any tensor under ``"never"`` (the numerics oracle), and
  under ``"auto"`` on the card only for what the JAX kernel's own gate
  rejects: a block under 128, or one that does not divide the sequence.

On the card anything else the CUDA kernels do not take (a head_dim other
than 32, 64, 128 or 256, a block that is not a multiple of 64) raises; the
masked path never stands in for a kernel there.
"""

from typing import Optional

import numpy as np
import torch

from ..transformer.attention import xla_attention
from .block_sparse_kernel import block_sparse_attention, kernel_gate
from .sparsity_config import SparsityConfig


def layout_to_bias(layout: np.ndarray, block: int, device=None) -> torch.Tensor:
    """(H, nb, nb) block layout → (H, S, S) fp32 additive bias (0 / -1e30),
    built on ``device``."""
    lay = torch.from_numpy(np.ascontiguousarray(layout, dtype=bool)).to(device)
    dense = lay.repeat_interleave(block, 1).repeat_interleave(block, 2)
    return torch.zeros(dense.shape, dtype=torch.float32, device=device).masked_fill_(
        ~dense, -1e30)


class SparseSelfAttention:
    """reference ``SparseSelfAttention``: attention restricted to a block layout."""

    def __init__(self, sparsity_config: SparsityConfig, key_padding_mask_mode="add",
                 attn_mask_mode="mul", max_seq_length: int = 2048):
        self.config = sparsity_config
        self._bias_cache = {}
        self._layout_cache = {}

    def _layout(self, seq_len: int):
        if seq_len not in self._layout_cache:
            self._layout_cache[seq_len] = self.config.make_layout(seq_len)
        return self._layout_cache[seq_len]

    def _bias(self, seq_len: int, device):
        key = (seq_len, str(device))
        if key not in self._bias_cache:
            self._bias_cache[key] = layout_to_bias(self._layout(seq_len), self.config.block,
                                                   device)
        return self._bias_cache[key]

    def __call__(self, q, k, v, *, causal: Optional[bool] = None,
                 use_kernel: str = "auto"):
        """q/k/v: (B, S, h, d). Causality defaults to the layout's attention mode.

        ``use_kernel``: "auto" takes the block-sparse kernels for CUDA
        tensors when the JAX gate admits the layout block, "never" forces
        the masked path, "always" raises ``NotImplementedError`` where the
        gate does not admit it.
        """
        S = q.shape[1]
        if causal is None:
            causal = getattr(self.config, "attention", "bidirectional") == "unidirectional"
        if use_kernel == "always" or (use_kernel == "auto" and q.device.type == "cuda"):
            try:
                kernel_gate(self.config.block, S, k.shape[1])
            except NotImplementedError:
                if use_kernel == "always":
                    raise
            else:
                return block_sparse_attention(q, k, v, self._layout(S), self.config.block,
                                              causal=causal)
        bias = self._bias(S, q.device)  # (H, S, S)
        # broadcast over (B, heads, groups, Sq, Sk) logits
        return xla_attention(q, k, v, causal=causal, bias=bias[None, :, None, :, :])
