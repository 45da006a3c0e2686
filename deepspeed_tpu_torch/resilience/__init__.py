"""Resilience types (counterpart of ``deepspeed_tpu/resilience``); the slice holds the error taxonomy only."""
