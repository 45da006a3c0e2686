"""Sparse attention (counterpart of ``deepspeed_tpu/ops/sparse_attention``): block layouts, the block-sparse kernels and ``SparseSelfAttention``."""

from .sparse_self_attention import SparseSelfAttention, layout_to_bias  # noqa: F401
from .sparsity_config import (  # noqa: F401
    BigBirdSparsityConfig,
    BSLongformerSparsityConfig,
    DenseSparsityConfig,
    FixedSparsityConfig,
    SparsityConfig,
    VariableSparsityConfig,
)
