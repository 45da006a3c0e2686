"""Compressed collectives (counterpart of ``deepspeed_tpu/runtime/comm``)."""
