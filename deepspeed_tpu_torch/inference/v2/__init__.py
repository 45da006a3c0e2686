"""Inference v2: continuous batching, paged mode (counterpart of ``deepspeed_tpu/inference/v2``)."""

from ...resilience.errors import (ContextOverflowError,  # noqa: F401
                                  EngineUsageError, PoolExhaustedError)
from .engine_v2 import InferenceEngineV2  # noqa: F401
from .ragged_manager import (BlockedKVCache, DSStateManager,  # noqa: F401
                             SequenceDescriptor)
