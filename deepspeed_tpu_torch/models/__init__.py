"""Model families (counterpart of ``deepspeed_tpu/models``)."""

from .transformer import (  # noqa: F401
    MODEL_PRESETS,
    TransformerConfig,
    TransformerLM,
    build_model,
    gpt2_config,
    llama_config,
    sample_or_argmax,
)
from .weights import params_from_jax, params_to_numpy, tp_layout, tp_shard_params  # noqa: F401
