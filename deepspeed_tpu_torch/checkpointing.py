"""``deepspeed.checkpointing`` parity alias (counterpart of ``deepspeed_tpu/checkpointing.py``):
activation checkpointing at the package's top level; the implementation
lives in ``runtime/activation_checkpointing/checkpointing.py``."""

from .runtime.activation_checkpointing.checkpointing import (  # noqa: F401
    RNGStatesTracker,
    checkpoint,
    checkpoint_wrapped,
    configure,
    get_cuda_rng_tracker,
    is_configured,
    model_parallel_cuda_manual_seed,
)
