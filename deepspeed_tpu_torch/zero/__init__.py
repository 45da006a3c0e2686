"""ZeRO public API (counterpart of ``deepspeed_tpu/zero/__init__.py``).

``zero.Init`` (reference ``runtime/zero/partition_parameters.py:783``)
partitions parameters as they are built so that a model larger than one
device never exists whole on one. ``initialize_params`` draws the model's
parameters from the generator and, at stage 3 over more than one
data-parallel rank, keeps this rank's shard of each leaf
(``stage_param_specs``: the rank's chunk of the dimension the rules shard)
and moves only the shards to ``device``: every leaf is whole on the host
for a moment, never on the card. On one rank the parameters are whole, in
the dtype the context names.
"""

from typing import Optional

import torch

from ..comm.topology import get_topology
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
    """``model``'s parameters from ``generator`` in ``dtype`` or the active
    ``Init``'s, else fp32 (the JAX ``initialize_params``): at stage 3 over
    more than one rank of ``topology`` (the process's by default) this
    rank's shard of each leaf, else whole; on ``device`` (the generator's
    by default)."""
    from ..runtime.zero.data_parallel import LeafShard
    from ..runtime.zero.partition import stage_param_specs

    dt = dtype or (_active.dtype if _active is not None and _active.dtype else None)
    dt = dt if dt is not None else torch.float32
    topo = topology or get_topology()
    if stage < 3 or topo.data_parallel_size == 1:
        return sharded_dual_init(model, generator, dt, device=device)[0]
    whole = model.init_params(generator)
    specs = stage_param_specs(whole, stage, topo, persistence_threshold=persistence_threshold)
    dev = device if device is not None else generator.device
    return tree_map(lambda p, spec: LeafShard(spec, topo).take(p).to(device=dev, dtype=dt,
                                                                       copy=True),
                    whole, specs)
