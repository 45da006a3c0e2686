"""ZeRO config (counterpart of ``deepspeed_tpu/runtime/zero``)."""
