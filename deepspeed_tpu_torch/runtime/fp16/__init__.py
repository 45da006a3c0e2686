"""Loss scaling (counterpart of ``deepspeed_tpu/runtime/fp16``)."""
