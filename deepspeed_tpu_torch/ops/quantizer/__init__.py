"""Quantizers (counterpart of ``deepspeed_tpu/ops/quantizer``): weight-only
quantization and the ZeRO++ block quantizers (``quantizer.py``)."""
