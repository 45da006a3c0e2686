"""Inference engines (counterpart of ``deepspeed_tpu/inference``)."""
