"""Post-training weight-only quantization for inference (counterpart of ``deepspeed_tpu/inference/quantization``).

Usage::

    model, qparams = quantize_model(model, params, num_bits=8)  # 8 | 6 | 4
    engine = InferenceEngineV2(model, qparams, paged=True, dtype=torch.bfloat16)

The op layer lives in ``ops/quantizer/woq.py``; ``woq_matmul`` is the
dequant-in-reads GEMM, a hand-written CUDA kernel on the card.
"""

from ...ops.quantizer.woq import (  # noqa: F401
    DEFAULT_TARGETS,
    dequant_params,
    quantize_param_tree,
    quantized_tp_specs,
)
from ...ops.quantizer.woq_gemm import woq_matmul  # noqa: F401


def quantize_model(model, params, num_bits: int = 8, group_size: int = 128,
                   targets=DEFAULT_TARGETS):
    """Quantize a ``TransformerLM``'s matmul weights for serving.

    Returns ``(model, quantized_params)``: the model is unchanged (its
    blocks run ``::q4``/``::q6``/``::q8`` leaves through ``woq_matmul``).
    The tree is quantized on the device its leaves lie on, one layer at a
    time; the caller drops the float tree afterwards to free it.
    """
    return model, quantize_param_tree(params, num_bits=num_bits,
                                      group_size=group_size, targets=targets)
