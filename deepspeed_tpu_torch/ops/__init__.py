"""Operators and their kernels (counterpart of ``deepspeed_tpu/ops``)."""
