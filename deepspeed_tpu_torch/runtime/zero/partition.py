"""ZeRO stage sharding rules and the flat partition plan (counterpart of ``deepspeed_tpu/runtime/zero/partition.py``).

| stage | params      | grads            | optimizer state (incl. fp32 master) |
|-------|-------------|------------------|--------------------------------------|
| 0     | replicated  | replicated       | replicated                           |
| 1     | replicated  | replicated       | sharded over ZeRO axes               |
| 2     | replicated  | sharded (r-sctr) | sharded                              |
| 3     | sharded     | sharded          | sharded                              |

The rules (``partition.py:51-145``) are pure functions over leaf shapes. A
spec is a tuple with one entry a dimension (``None``, an axis name, or a
tuple of axis names), as a JAX ``PartitionSpec``'s entries; an unsharded
leaf's spec is ``()``. A leaf shards its largest dimension divisible by the
ZeRO degree (the first such, on a tie); a leaf with none, or at stage 3
one smaller than ``stage3_param_persistence_threshold``, stays whole. With
an ``hpz`` axis larger than 1, stage-3 weights shard over ``hpz`` alone.
The engine (``runtime/engine.py``) reads the rules over the ranks of the
process group: rank ``r``'s shard of a leaf sharded over axes ``A`` on
dimension ``d`` is chunk ``topology.rank_in(A)`` of ``d``.

``PartitionPlan`` (``:147-197``) is the host tier's flat cross-replica
partition: the JAX plan's bounds for any leaf list and shard count, so the
port writes and reads the JAX package's shard files.
"""

from typing import Optional

import numpy as np

from ...comm.topology import HPZ_AXIS, ZERO_AXES
from ...utils.tree import tree_map


def _spec_axes(spec) -> set:
    used = set()
    for entry in spec or ():
        if entry is None:
            continue
        used.update(entry if isinstance(entry, (tuple, list)) else (entry,))
    return used


def shard_leaf_spec(shape, tp_spec: Optional[tuple], topo, min_size: int = 1,
                    axes=None) -> tuple:
    """ZeRO axes added to a leaf's spec (on top of its TP spec)."""
    cand = ZERO_AXES if axes is None else axes
    degree = int(np.prod([topo.get_dim(a) for a in cand]))
    entries = list(tp_spec) if tp_spec is not None else []
    entries += [None] * (len(shape) - len(entries))
    if degree == 1 or int(np.prod(shape or (1,))) < min_size:
        return tuple(entries)
    used = _spec_axes(tp_spec)
    zero_axes = tuple(a for a in cand if topo.get_dim(a) > 1 and a not in used)
    if not zero_axes:
        return tuple(entries)
    zdeg = int(np.prod([topo.get_dim(a) for a in zero_axes]))
    best, best_size = -1, 0
    for i, d in enumerate(shape):
        if entries[i] is None and d % zdeg == 0 and d > best_size:
            best, best_size = i, d
    if best < 0:
        return tuple(entries)
    entries[best] = zero_axes if len(zero_axes) > 1 else zero_axes[0]
    return tuple(entries)


def _shape(leaf):
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _specs(params, tp_specs, rule):
    if tp_specs is None:
        return tree_map(lambda p: rule(_shape(p), None), params)
    return tree_map(lambda p, tp: rule(_shape(p), tp), params, tp_specs)


def _whole(tp):
    return tuple(tp) if tp is not None else ()


def stage_param_specs(params, stage: int, topo, tp_specs=None, persistence_threshold: int = 0):
    """The lp parameters' specs. With an ``hpz`` axis larger than 1, stage-3
    weights shard over ``hpz`` only (ZeRO++ hpZ): their gathers stay inside
    an hpz group, while gradients and optimizer state keep the full shard."""
    param_axes = (HPZ_AXIS,) if topo.get_dim(HPZ_AXIS) > 1 else None

    def rule(shape, tp):
        if stage >= 3:
            return shard_leaf_spec(shape, tp, topo, min_size=max(1, persistence_threshold),
                                   axes=param_axes)
        return _whole(tp)

    return _specs(params, tp_specs, rule)


def stage_grad_specs(params, stage: int, topo, tp_specs=None):
    """Gradients: reduce-scattered from stage 2, sharded like the optimizer state."""
    return _specs(params, tp_specs, lambda shape, tp: shard_leaf_spec(shape, tp, topo)
                  if stage >= 2 else _whole(tp))


def stage_opt_specs(params, stage: int, topo, tp_specs=None):
    """Optimizer state (fp32 master and moments): sharded from stage 1."""
    return _specs(params, tp_specs, lambda shape, tp: shard_leaf_spec(shape, tp, topo)
                  if stage >= 1 else _whole(tp))


def batch_spec(topo) -> tuple:
    """The global batch split over the full data-parallel degree on its
    leading dimension (and ``seq`` on dimension 1, which raises earlier)."""
    dp_axes = tuple(a for a in ZERO_AXES if topo.get_dim(a) > 1)
    dims = [dp_axes if len(dp_axes) > 1 else (dp_axes[0] if dp_axes else None)]
    if topo.get_dim("seq") > 1:
        dims.append("seq")
    return tuple(dims)


class PartitionPlan:
    """Flat cross-replica partition of a parameter leaf list.

    Each leaf's flattened elements split into ``num_shards`` contiguous
    ranges with bounds ``(size * r) // num_shards``: every rank's shard
    differs by at most one element and no divisibility constraint is imposed
    on the leaf shapes. Rank ``r`` owns ``[bounds[r], bounds[r+1])`` of every
    leaf; the host Adam update is elementwise, so stepping the shards
    independently is bitwise identical to stepping the whole leaf.
    """

    def __init__(self, leaves, num_shards: int, sanitize: bool = False):
        self.num_shards = max(1, int(num_shards))
        self.leaf_shapes = [tuple(getattr(l, "shape", ())) for l in leaves]
        self.leaf_sizes = [int(np.prod(s or (1,))) for s in self.leaf_shapes]
        self.bounds = [
            tuple((size * r) // self.num_shards for r in range(self.num_shards + 1))
            for size in self.leaf_sizes
        ]
        if sanitize:
            from ...analysis.sanitizer import check_shard_conservation

            check_shard_conservation(self.leaf_sizes, self.bounds)

    def slices(self, rank: int):
        """Per-leaf ``(lo, hi)`` flat ranges owned by ``rank``."""
        return [(b[rank], b[rank + 1]) for b in self.bounds]

    def shard_sizes(self, rank: int):
        return [b[rank + 1] - b[rank] for b in self.bounds]

    def shard_bytes(self, rank: int, itemsize: int = 4) -> int:
        return sum(self.shard_sizes(rank)) * itemsize

    @property
    def total_elements(self) -> int:
        return sum(self.leaf_sizes)

    def describe(self) -> dict:
        """JSON-serializable plan record for sharded-checkpoint metadata."""
        return {
            "num_shards": self.num_shards,
            "leaf_sizes": list(self.leaf_sizes),
            "leaf_shapes": [list(s) for s in self.leaf_shapes],
            "bounds": [list(b) for b in self.bounds],
        }


def estimate_static_state_per_chip(n_params: int, zero_stage: int, zero_degree: int, mp: int,
                                   dtype_bytes: int = 2, offload_opt_fraction: float = 0.0,
                                   weight_shard_degree: int = 0,
                                   has_master: bool = True) -> float:
    """Per-rank bytes of the static training state (weights, gradients, fp32
    master and Adam moments) under the ZeRO rules and a model degree ``mp``
    (a copy of the JAX package's ``autotuning/autotuner.py:42``, the model
    its engine's memory preflight uses). ``zero_degree`` is the ZeRO degree
    gradients (stage >= 2) and optimizer state (stage >= 1) shard over;
    ``weight_shard_degree`` what stage-3 weights shard over (the hpz size
    when hpz > 1; 0: the ZeRO degree); ``offload_opt_fraction`` the share of
    the optimizer state offloaded; ``has_master``: a mixed-precision run
    keeps an fp32 master beside the moments (12 bytes a parameter, else 8)."""
    p = n_params / max(1, mp)
    weights = p * dtype_bytes
    grads = p * 4
    opt = p * (12 if has_master else 8) * max(0.0, 1.0 - offload_opt_fraction)
    if zero_stage >= 1:
        opt /= zero_degree
    if zero_stage >= 2:
        grads /= zero_degree
    if zero_stage >= 3:
        weights /= (weight_shard_degree or zero_degree)
    return weights + grads + opt
