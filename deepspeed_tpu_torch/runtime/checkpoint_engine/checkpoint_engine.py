"""Checkpoint engine ABC (a copy of ``deepspeed_tpu/runtime/checkpoint_engine/checkpoint_engine.py``).

Engines persist nested trees of arrays (numpy arrays or CPU tensors) plus
JSON-able metadata. Values are saved as full arrays keyed by tree path, so
a checkpoint is topology-independent: either package reloads it under any
layout.
"""

import abc


class CheckpointEngine(abc.ABC):
    def __init__(self, config_params=None):
        self.config_params = config_params

    def create(self, tag: str):
        """Hook called once per checkpoint tag before saves (logging/placeholders)."""

    @abc.abstractmethod
    def save(self, state_dict: dict, path: str):
        ...

    @abc.abstractmethod
    def load(self, path: str, map_location=None) -> dict:
        ...

    @abc.abstractmethod
    def makedirs(self, path: str, exist_ok: bool = True):
        ...

    def commit(self, tag: str) -> bool:
        """Mark a tag durable (async engines flush here)."""
        return True
