"""Quantizers (counterpart of ``deepspeed_tpu/ops/quantizer``): weight-only quantization."""
