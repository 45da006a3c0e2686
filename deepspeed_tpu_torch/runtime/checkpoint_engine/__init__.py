"""Checkpoint engines (counterpart of ``deepspeed_tpu/runtime/checkpoint_engine``)."""
