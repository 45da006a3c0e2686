"""ZeRO flat partition plan (counterpart of ``deepspeed_tpu/runtime/zero/partition.py``).

Only ``PartitionPlan`` (``partition.py:147-197``) is ported: the host tier's
flat cross-replica partition of the parameter leaves. The GSPMD spec rules
of that module (``:51-145``) place leaves over a device mesh; one card has
none, and they come with the multi-rank half of ZeRO (ROADMAP.md Queue 1
item 13b). On one card ``num_shards`` is the data-parallel size, 1; the
plan gives the JAX plan's bounds for any leaf list and shard count, so the
port writes and reads the JAX package's shard files.
"""

import numpy as np


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
