"""Rank topology (counterpart of ``deepspeed_tpu/comm/topology.py``).

The JAX package lays its devices out as a mesh with the axes ``(pipe, data,
hpz, expert, seq, model)`` and runs a collective over a mesh axis. The port
runs one process a rank over ``torch.distributed``: the same axes, in the
same order (outermost first, so the last axis varies fastest across
consecutive ranks), over the ranks of the process group, and one
``dist.new_group`` for each axis larger than 1, whose members are the ranks
that differ in that axis alone.

The data-parallel degree that ZeRO shards over is ``data * hpz * expert``.
``hpz`` is the ZeRO++ hpZ secondary partition, carved out of ``data``
(``runtime/config.py:75``): when it is larger than 1, stage-3 weights shard
over the ``hpz`` ranks alone, so their gathers stay inside an hpz group,
while the gradients and the optimizer state still shard over the whole
data-parallel degree. ``model`` is the tensor-parallel axis, the innermost,
so a TP group is consecutive ranks and the ZeRO groups join the ranks of
one model coordinate (``runtime/tensor_parallel.py``). ``data``, ``hpz`` and
``model`` are ported; ``seq``, ``pipe`` and ``expert`` larger than 1 raise
``NotImplementedError`` naming their ROADMAP.md items.
"""

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..utils.logging import logger

MESH_AXES = ("pipe", "data", "hpz", "expert", "seq", "model")

PIPE_AXIS = "pipe"
DATA_AXIS = "data"
EXPERT_AXIS = "expert"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"
HPZ_AXIS = "hpz"
#: the axes ZeRO shards gradients and optimizer state over
ZERO_AXES = ("data", "hpz", "expert")

_UNPORTED_AXES = {
    "seq": "ROADMAP.md Queue 1 item 17, sequence parallelism",
    "pipe": "ROADMAP.md Queue 1 item 17, runtime/pipe",
    "expert": "ROADMAP.md Queue 1 item 17, moe/",
}

AxisGroup = Union[None, str, Sequence[str]]


def check_ported_axes(**sizes) -> None:
    """Raise for an axis larger than 1 that the port does not run."""
    for axis, item in _UNPORTED_AXES.items():
        if sizes.get(axis, 1) > 1:
            raise NotImplementedError(
                f"a '{axis}' axis of {sizes[axis]} is not ported to deepspeed_tpu_torch "
                f"({item})")


def normalize_axes(group: AxisGroup) -> Tuple[str, ...]:
    """A group named by axis: ``None`` is the ZeRO degree, a string one axis,
    a sequence several."""
    if group is None:
        return ZERO_AXES
    if isinstance(group, str):
        return (group,)
    return tuple(group)


class MeshTopology:
    """The axes' sizes over ``world_size`` ranks, this process's coordinates
    and, once :meth:`build_groups` has run (in every rank), one process group
    an axis larger than 1. Without a process group (one rank, or a test of
    the sharding rules) only the sizes and coordinates are known."""

    def __init__(self, data: int = 0, model: int = 1, pipe: int = 1, seq: int = 1,
                 expert: int = 1, hpz: int = 1, world_size: int = 1, rank: int = 0):
        check_ported_axes(model=model, pipe=pipe, seq=seq, expert=expert)
        denom = model * pipe * seq * expert * hpz
        if data in (0, None):
            if world_size % denom:
                raise ValueError(f"world size {world_size} not divisible by "
                                 f"model*pipe*seq*expert*hpz={denom}")
            data = world_size // denom
        if data * denom != world_size:
            raise ValueError(
                f"mesh {dict(pipe=pipe, data=data, hpz=hpz, expert=expert, seq=seq, model=model)} "
                f"needs {data * denom} ranks, have {world_size}")
        self.axis_sizes: Dict[str, int] = dict(pipe=pipe, data=data, hpz=hpz, expert=expert,
                                               seq=seq, model=model)
        self.rank = int(rank)
        shape = tuple(self.axis_sizes[a] for a in MESH_AXES)
        self.ranks = np.arange(world_size).reshape(shape)
        self.coords = {a: int(i) for a, i in zip(MESH_AXES, np.unravel_index(self.rank, shape))}
        self._groups: Dict[Tuple[str, ...], object] = {}

    # ----------------------- sizes -----------------------
    def get_dim(self, axis: str) -> int:
        return self.axis_sizes[axis]

    @property
    def world_size(self) -> int:
        return int(self.ranks.size)

    @property
    def data_parallel_size(self) -> int:
        """The ZeRO degree: ``data * hpz * expert``."""
        return int(np.prod([self.axis_sizes[a] for a in ZERO_AXES]))

    @property
    def model_parallel_size(self) -> int:
        return self.axis_sizes["model"]

    @property
    def pipe_parallel_size(self) -> int:
        return self.axis_sizes["pipe"]

    @property
    def sequence_parallel_size(self) -> int:
        return self.axis_sizes["seq"]

    @property
    def expert_parallel_size(self) -> int:
        return self.axis_sizes["expert"]

    def size_of(self, group: AxisGroup) -> int:
        return int(np.prod([self.axis_sizes[a] for a in normalize_axes(group)]))

    # ----------------------- ranks -----------------------
    def group_ranks(self, group: AxisGroup, rank: Optional[int] = None) -> List[int]:
        """The global ranks of ``rank``'s group over the axes of ``group``,
        in the order of their coordinates over those axes (row-major, the
        axes in ``MESH_AXES`` order)."""
        axes = normalize_axes(group)
        r = self.rank if rank is None else int(rank)
        coords = np.unravel_index(r, self.ranks.shape)
        sel = tuple(slice(None) if a in axes else int(c) for a, c in zip(MESH_AXES, coords))
        return [int(x) for x in self.ranks[sel].reshape(-1)]

    def rank_in(self, group: AxisGroup) -> int:
        """This rank's index inside its group over ``group``'s axes: the
        shard index that a spec entry naming those axes gives it."""
        return self.group_ranks(group).index(self.rank)

    def all_groups(self, group: AxisGroup) -> List[List[int]]:
        """Every group over ``group``'s axes, as lists of global ranks."""
        seen, out = set(), []
        for r in range(self.world_size):
            g = self.group_ranks(group, r)
            if g[0] not in seen:
                seen.add(g[0])
                out.append(g)
        return out

    # ----------------------- process groups -----------------------
    def build_groups(self) -> None:
        """One ``dist.new_group`` for each axis larger than 1 (and for the
        ZeRO axes together when they are not the whole world). Every rank
        calls this, in the same order: group creation is collective."""
        import torch.distributed as dist

        wanted = [(a,) for a in MESH_AXES if self.axis_sizes[a] > 1]
        zero = self._live(ZERO_AXES)
        if len(zero) > 1:
            wanted.append(zero)
        for axes in wanted:
            members = self.all_groups(axes)
            if len(members) == 1 and len(members[0]) == self.world_size:
                self._groups[axes] = None  # the world group
                continue
            mine, _ = dist.new_subgroups_by_enumeration(members)
            self._groups[axes] = mine

    def group(self, group: AxisGroup):
        """The process group of this rank over ``group``'s axes (``None`` is
        torch's world group)."""
        axes = self._live(normalize_axes(group))
        if self.size_of(axes) == self.world_size:
            return None
        if axes not in self._groups:
            raise ValueError(f"no process group over {axes}: build_groups() has not run")
        return self._groups[axes]

    def _live(self, axes) -> Tuple[str, ...]:
        """``axes`` larger than 1, in ``MESH_AXES`` order."""
        return tuple(a for a in MESH_AXES if a in axes and self.axis_sizes[a] > 1)


_topology: Optional[MeshTopology] = None


def initialize_topology(mesh_config=None, world_size: int = 1, rank: int = 0,
                        **kwargs) -> MeshTopology:
    """Build (or rebuild) the process-wide topology over ``world_size``
    ranks; with a process group up, its axis groups too."""
    global _topology
    if mesh_config is not None:
        kwargs = dict(data=mesh_config.data, model=mesh_config.model, pipe=mesh_config.pipe,
                      seq=mesh_config.seq, expert=mesh_config.expert,
                      hpz=getattr(mesh_config, "hpz", 1))
    topo = MeshTopology(world_size=world_size, rank=rank, **kwargs)
    import torch.distributed as dist

    if world_size > 1 and dist.is_available() and dist.is_initialized():
        topo.build_groups()
        logger.debug(f"MeshTopology: {topo.axis_sizes} over {world_size} ranks, "
                     f"rank {rank} at {topo.coords}")
    _topology = topo
    return topo


def get_topology(required: bool = True) -> Optional[MeshTopology]:
    """The process-wide topology; one rank of data parallelism by default."""
    global _topology
    if _topology is None and required:
        _topology = MeshTopology()
    return _topology


def reset_topology():
    global _topology
    _topology = None
