"""Activation checkpointing (counterpart of ``deepspeed_tpu/runtime/activation_checkpointing/``)."""

from .checkpointing import (  # noqa: F401
    RNGStatesTracker,
    checkpoint,
    checkpoint_wrapped,
    configure,
    get_cuda_rng_tracker,
    is_configured,
    model_parallel_cuda_manual_seed,
)
