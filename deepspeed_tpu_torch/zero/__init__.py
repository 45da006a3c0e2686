"""ZeRO public API (counterpart of ``deepspeed_tpu/zero/__init__.py``).

``zero.Init`` (reference ``runtime/zero/partition_parameters.py:783``)
partitions parameters as they are built so that a model larger than one
device never exists whole on one. On one card there is nothing to partition
across: parameters are born whole on the engine's device, in the dtype the
context names, and ``initialize_params`` is a call of the model's own
initializer. Multi-rank construction comes with ROADMAP.md Queue 1 item 13b.
"""

from typing import Optional

import torch

from ..utils.tree import tree_map


class Init:
    """Context manager for API parity; the work happens in ``initialize_params``.

    Usage (reference-style)::

        with deepspeed_tpu_torch.zero.Init(dtype=torch.bfloat16):
            params = deepspeed_tpu_torch.zero.initialize_params(model, generator)
    """

    def __init__(self, module=None, data_parallel_group=None, mem_efficient_linear=True,
                 remote_device=None, pin_memory=False, config_dict_or_path=None,
                 config=None, enabled=True, dtype=None, mpu=None,
                 sequence_data_parallel_group=None):
        self.enabled = enabled
        self.dtype = dtype

    def __enter__(self):
        self._prev = _active
        if self.enabled:
            _set_active(self)
        return self

    def __exit__(self, *exc):
        if self.enabled:
            _set_active(self._prev)
        return False


_active: Optional[Init] = None


def _set_active(ctx):
    global _active
    _active = ctx


def is_zero_init_active() -> bool:
    return _active is not None


def sharded_dual_init(model, generator, lp_dtype, param_shardings=None, opt_shardings=None,
                      device=None):
    """The lp parameters (and with ``opt_shardings`` the fp32 master) from
    one call of the model's initializer, both cast from the same fp32 draw,
    so lp == cast(master) by construction (the JAX ``sharded_dual_init``).
    On one card the shardings only say whether a master is wanted."""
    params = model.init_params(generator)
    if device is not None:
        params = tree_map(lambda p: p.to(device), params)
    lp = tree_map(lambda p: p.to(lp_dtype), params)
    master = tree_map(lambda p: p.to(torch.float32), params) if opt_shardings is not None \
        else None
    return lp, master


def initialize_params(model, generator, stage: int = 3, topology=None, dtype=None,
                      persistence_threshold: int = 0, device=None):
    """``model``'s parameters from ``generator``, whole on ``device`` (the
    generator's by default), in ``dtype`` or the active ``Init``'s, else
    fp32 (the JAX ``initialize_params`` on one device)."""
    dt = dtype or (_active.dtype if _active is not None and _active.dtype else None)
    lp, _ = sharded_dual_init(model, generator, dt if dt is not None else torch.float32,
                              device=device)
    return lp
