"""Checkpoint tools (counterpart of ``deepspeed_tpu/checkpoint``)."""

from .universal import ds_to_universal, load_universal_into_engine  # noqa: F401
