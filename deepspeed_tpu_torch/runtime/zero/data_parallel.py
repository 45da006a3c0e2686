"""ZeRO across data-parallel ranks: the shards a rank owns, and the collectives that move them.

The JAX engine states ZeRO as sharding rules over one mesh
(``partition.py``) and lets the SPMD partitioner place the collectives.
The port runs one process a rank, and :class:`DataParallel` turns the same
rules into this rank's shards and eager collectives (``comm``):

- a leaf's **layout** under a spec (:class:`LeafShard`): the dimension
  sharded, the axes it is sharded over, and this rank's chunk of it;
- **reduction**: each micro-step's local gradient is reduce-scattered
  (summed, then scaled by ``1/dp``) onto the stage-2 gradient layout, at
  every stage, so the sums form in one order and stages 1-3 reach stage
  0's parameters bit for bit; a leaf with no dimension divisible by the
  degree is all-reduced whole. ZeRO++ qgZ replaces the reduce-scatter by
  the int8 all-to-all of ``zeropp.quantized_reduce_leaf`` (and, where the
  whole mean is wanted, its int8 all-gather);
- the **stage-3 forward** (:meth:`DataParallel.stage3_tree`): the weights
  live as shards and are gathered just in time, a layer's slice of a
  stacked block leaf before that block and a whole leaf at its first use,
  and released after it; autograd keeps no gathered weight for the
  backward (a saved-tensor hook swaps it for a token and gathers it again
  when the backward needs it); the gather's backward reduces the weight's
  gradient onto its shard. ZeRO++ qwZ moves these gathers as int8 codes
  and block scales (``zeropp.gather_param_leaf``); hpZ runs them inside
  the ``hpz`` group.

Under tensor parallelism the leaves are a rank's TP shards
(``runtime/tensor_parallel.py``): ZeRO shards each one on the largest
dimension its TP spec left unsharded that divides by the ZeRO degree (the
JAX rule, ``partition.py:51-79``), its collectives run on the data group
(the ranks of one model coordinate), and the gradient norm sums a
TP-sharded leaf's squares over the model group too, a replicated one once.

Bucketing and overlap of the collectives with the backward are not done:
one collective a leaf (a layer's slice at stage 3), in leaf order.
"""

import functools
import weakref
from typing import Dict, List, Optional, Sequence

import torch

from ...comm import comm as dist
from ...comm.topology import MODEL_AXIS, ZERO_AXES, get_topology
from ...utils.tree import tree_leaves, tree_unflatten
from ..tensor_parallel import strip_model
from .partition import shard_leaf_spec, stage_opt_specs, stage_param_specs
from .zeropp import gather_param_leaf, quantized_reduce_leaf

_COMM_DTYPES = {None: torch.float32, "fp32": torch.float32, "bf16": torch.bfloat16,
                "fp16": torch.float16}


class LeafShard:
    """A leaf's layout under one spec: ``dim`` (None: whole), the ``axes``
    it is sharded over, their size ``n`` and this rank's chunk ``index``."""

    __slots__ = ("dim", "axes", "n", "index")

    def __init__(self, spec, topo):
        self.dim, self.axes, self.n, self.index = None, (), 1, 0
        for i, e in enumerate(spec):
            if e is not None:
                self.dim, self.axes = i, (tuple(e) if isinstance(e, (tuple, list)) else (e,))
                self.n, self.index = topo.size_of(self.axes), topo.rank_in(self.axes)
                break

    @property
    def sharded(self) -> bool:
        return self.dim is not None

    def same(self, other) -> bool:
        return (self.dim, self.axes) == (other.dim, other.axes)

    def chunk_shape(self, shape) -> tuple:
        """The shape of this rank's chunk of a leaf of ``shape``."""
        shape = list(shape)
        if self.sharded:
            shape[self.dim] //= self.n
        return tuple(shape)

    def layer(self) -> "LeafShard":
        """The layout of one layer's slice of a stacked leaf sharded on a
        dimension after the first."""
        out = LeafShard((), None)
        out.dim, out.axes, out.n, out.index = self.dim - 1, self.axes, self.n, self.index
        return out

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of ``full`` (a view)."""
        if not self.sharded:
            return full
        size = full.shape[self.dim] // self.n
        return full.narrow(self.dim, self.index * size, size)

    def gather(self, shard: torch.Tensor, quantized: bool = False,
               log_name: str = "param_gather") -> torch.Tensor:
        if not self.sharded:
            return shard
        return gather_param_leaf(shard, self.axes, self.dim, quantized, log_name=log_name)


class DataParallel:
    """This rank's layouts of every leaf (in ``tree_leaves`` order) at one
    ZeRO stage over a topology, and the collectives of a training step."""

    def __init__(self, params, stage: int, topo, persistence_threshold: int = 0,
                 comm_dtype: Optional[str] = None, qgz: bool = False, qwz: bool = False,
                 stacked: Optional[Sequence[bool]] = None, tp=None):
        self.stage = int(stage)
        self.dp = topo.data_parallel_size
        self.qgz, self.qwz = bool(qgz), bool(qwz) and self.stage >= 3
        self.comm_dtype = _COMM_DTYPES[comm_dtype]
        self.shapes = [tuple(p.shape) for p in tree_leaves(params)]
        #: the rank's tensor-parallel layout (``TensorParallel``), or None
        self.tp = tp
        tps = None if tp is None else tree_unflatten(params, tp.spec_leaves())

        def local(specs):  # the TP-local leaves' layouts: the model axis is this rank's
            return [LeafShard(strip_model(s), topo) for s in _spec_leaves(specs)]

        self.red = local(tree_unflatten(params, [
            shard_leaf_spec(s, t, topo) for s, t in zip(
                self.shapes, tp.spec_leaves() if tp is not None else [None] * len(self.shapes))]))
        self.opt = local(stage_opt_specs(params, self.stage, topo, tps))
        self.param = local(stage_param_specs(
            params, self.stage, topo, tps,
            persistence_threshold=persistence_threshold if self.stage >= 3 else 0))
        #: the rank's rows of a global batch start at row_index * rows
        self.row_index = topo.rank_in(ZERO_AXES)
        #: leaves stacked by layer (the model's ``stacked_leaves``): their
        #: collectives run a layer at a time, so no collective holds more
        #: than a layer of one leaf, at every stage alike
        self.stacked = list(stacked) if stacked is not None else [False] * len(self.shapes)
        # the stage-3 weights gathered and still alive, by id, and how to
        # gather each again (saved_weights' hook)
        self._live = weakref.WeakValueDictionary()
        self._regather: Dict[int, object] = {}

    # ------------------------------------------------------------------
    # shards
    # ------------------------------------------------------------------
    def _by_layer(self, j: int, lay: LeafShard) -> bool:
        return self.stacked[j] and lay.sharded and lay.dim > 0

    def gather_leaf(self, j: int, shard, lay: LeafShard, quantized: bool = False,
                    log_name: str = "param_gather") -> torch.Tensor:
        """Leaf ``j`` whole from this rank's chunk under ``lay`` (collective)."""
        if not self._by_layer(j, lay):
            return lay.gather(shard, quantized, log_name)
        layer = lay.layer()
        out = torch.empty(self.shapes[j], dtype=shard.dtype, device=shard.device)
        for i in range(out.shape[0]):
            out[i] = layer.gather(shard[i], quantized, log_name)
        return out

    def gather_list(self, shards, layouts, log_name: str = "param_gather") -> List[torch.Tensor]:
        """Whole leaves from shards (collective)."""
        return [self.gather_leaf(j, s, lay, log_name=log_name)
                for j, (s, lay) in enumerate(zip(shards, layouts))]

    # ------------------------------------------------------------------
    # gradients
    # ------------------------------------------------------------------
    def reduce_leaf(self, g: torch.Tensor, lay: LeafShard, j: Optional[int] = None
                    ) -> torch.Tensor:
        """The mean over the ranks of the local gradient ``g`` (of leaf
        ``j``, when given): this rank's chunk under ``lay``."""
        if j is not None and self._by_layer(j, lay):
            layer = lay.layer()
            out = torch.empty(lay.chunk_shape(g.shape), dtype=self.comm_dtype, device=g.device)
            for i in range(g.shape[0]):
                out[i] = self.reduce_leaf(g[i], layer)
            return out
        g = g.to(self.comm_dtype)
        if not lay.sharded:
            if self.qgz:
                return quantized_reduce_leaf(g, ZERO_AXES, self.dp)
            return dist.all_reduce(g.clone(), group=ZERO_AXES,
                                   log_name="grad_all_reduce").mul_(1.0 / self.dp)
        if self.qgz:
            moved = g.movedim(lay.dim, 0).contiguous()
            shard = quantized_reduce_leaf(moved, lay.axes, self.dp, hops=1)
            shard = shard.reshape((moved.shape[0] // lay.n,) + tuple(moved.shape[1:]))
            shard = shard.movedim(0, lay.dim)
        else:
            shard = dist.inprog_reduce_scatter(g, lay.axes, lay.dim,
                                               log_name="grad_reduce_scatter")
            shard.mul_(1.0 / self.dp)
        return shard.contiguous()

    def reduce_list(self, grads: list, skip=()) -> List[Optional[torch.Tensor]]:
        """Every leaf's reduced chunk on the reduction layout (leaf ``j`` in
        ``skip``, reduced elsewhere, gives None). Each local gradient is
        dropped from ``grads`` once reduced."""
        out = []
        for j, lay in enumerate(self.red):
            g, grads[j] = grads[j], None
            out.append(None if j in skip else self.reduce_leaf(g, lay, j))
        return out

    def full_grads(self, shards) -> List[torch.Tensor]:
        """Whole reduced gradients from the reduced chunks (stages 0 and 1)."""
        return self.gather_list(shards, self.red, log_name="grad_gather")

    def norm_and_overflow(self, shards, fp16: bool):
        """(global gradient norm, overflow flag or None) from the reduced
        chunks on the reduction layout: a whole leaf counts on group rank 0
        only, and under tensor parallelism a replicated leaf on model
        coordinate 0 only."""
        first = self.row_index == 0
        tp = self.tp
        chunks = [s if (lay.sharded or first) and (tp is None or tp.counts(j)) else None
                  for j, (s, lay) in enumerate(zip(shards, self.red))]
        groups = (ZERO_AXES,) if tp is None else (ZERO_AXES, MODEL_AXIS)
        return chunks_norm_and_overflow(chunks, fp16, shards[0].device, groups=groups)

    def step_grads(self, acc, inv: float):
        """The step's gradients from the accumulated reduced ones (``acc``,
        emptied: the step owns them, and unscales them by ``inv`` in place):
        (the gradients of this rank's master shards, the reduced chunks the
        norm counts; views of the same storage)."""
        if self.stage <= 1:
            # the reduced gradients whole, as stages 0 and 1 hold them
            fulls = acc["fulls"] if acc["fulls"] is not None else self.full_grads(acc["shards"])
            grads = [_own_f32(f).mul_(inv) for f in fulls]
            counted = [lay.take(g) for g, lay in zip(grads, self.red)]
            if self.stage == 1:
                grads = [lay.take(g) for g, lay in zip(grads, self.opt)]
        else:
            grads = counted = [_own_f32(g).mul_(inv) for g in acc["shards"]]
        acc.clear()
        return grads, counted

    def lp_leaf(self, j: int, master: torch.Tensor, dtype) -> torch.Tensor:
        """Leaf ``j``'s lp values on this rank's parameter layout from its
        updated master chunk: the chunk itself where the layouts agree (the
        caller casts it), else every rank's chunk all-gathered in ``dtype``
        (and at hpZ cut again)."""
        olay, play = self.opt[j], self.param[j]
        if olay.same(play):
            return master
        return play.take(self.gather_leaf(j, master.to(dtype), olay))

    # ------------------------------------------------------------------
    # stage 3
    # ------------------------------------------------------------------
    def stage3_tree(self, params, anchors, on_grad):
        """A view of the stage-3 parameter tree for one forward: sharded
        leaves gathered at first use (a stacked block leaf a layer at a
        time), persistent leaves as they are. ``on_grad(j,
        layer, grad)`` receives each gathered weight's gradient in the
        backward. Use under :meth:`saved_weights` so that autograd keeps
        no gathered weight."""
        leaves = list(tree_leaves(params))
        objs = []
        for j, p in enumerate(leaves):
            lay, red = self.param[j], self.red[j]
            if not lay.sharded:
                objs.append(p)
            elif self._by_layer(j, lay) and self._by_layer(j, red):
                objs.append(_LayerStack(self, j, p, anchors[j], on_grad))
            else:
                objs.append(_LazyLeaf(self, j, p, anchors[j], on_grad))
        return _wrap(tree_unflatten(params, objs))

    def saved_weights(self):
        """A saved-tensor hook context: a gathered weight (or a view of one)
        that autograd saves is replaced by a token, gathered again when the
        backward unpacks it."""
        return torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack)

    def _register(self, full, regather):
        self._live[id(full)] = full
        self._regather[id(full)] = regather
        weakref.finalize(full, self._regather.pop, id(full), None)

    def _pack(self, t):
        if not self._live or not isinstance(t, torch.Tensor):
            return t
        base = t if t._base is None else t._base
        if self._live.get(id(base)) is not base:
            return t
        return (self._regather[id(base)], tuple(t.size()), tuple(t.stride()),
                t.storage_offset())

    @staticmethod
    def _unpack(packed):
        if isinstance(packed, torch.Tensor):
            return packed
        regather, size, stride, offset = packed
        return regather().as_strided(size, stride, offset)


def batch_rows(batch, dp: int, index: int):
    """Rank ``index``'s rows of the global micro-batch over ``dp`` ranks:
    every tensor leaf whose dim 0 splits over the degree is split
    (``batch_spec``), others pass whole. Returns (rows, (first row, global
    rows) or None where nothing was split)."""
    found = []
    rows = _cut_rows(batch, dp, index, found)
    return rows, (found[-1] if found else None)


def _cut_rows(x, dp: int, index: int, found: list):
    """``x``'s leaves cut to rank ``index``'s rows (module-level: a nested
    recursive function would be a reference cycle); each cut leaf appends
    (first row, global rows) to ``found``."""
    if isinstance(x, dict):
        return {k: _cut_rows(v, dp, index, found) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_cut_rows(v, dp, index, found) for v in x)
    if not hasattr(x, "shape") or len(x.shape) == 0 or x.shape[0] % dp:
        return x
    per = x.shape[0] // dp
    found.append((index * per, x.shape[0]))
    return x[index * per:(index + 1) * per]


def _own_f32(g: torch.Tensor) -> torch.Tensor:
    """``g`` as float32: itself when it is (the caller owns it), else a copy."""
    return g if g.dtype == torch.float32 else g.float()


def chunks_norm_and_overflow(chunks, fp16: bool, device, groups=(ZERO_AXES,)):
    """(norm, overflow flag or None) of a gradient whose chunks the ranks of
    ``groups`` hold without overlap (a chunk None: counted on another rank):
    each chunk's sum of squares, and under fp16 the count of non-finite
    elements, all-reduced in one vector over each group in turn, so every
    rank holds the same values."""
    zero = torch.zeros((), device=device)
    sq = [zero if c is None else torch.sum(torch.square(c.float())) for c in chunks]
    if fp16:
        sq.append(torch.stack([zero if c is None else (~torch.isfinite(c)).sum().float()
                               for c in chunks]).sum())
    v = torch.stack(sq)
    for group in groups:
        v = dist.all_reduce(v, group=group, log_name="grad_norm")
    if fp16:
        return torch.sqrt(v[:-1].sum()), v[-1] > 0
    return torch.sqrt(v.sum()), None


def reduce_plan_slices(full: torch.Tensor, bounds, group=ZERO_AXES) -> torch.Tensor:
    """This rank's ``PartitionPlan`` slice (``bounds``: the leaf's ``n + 1``
    offsets) of the mean of ``full`` over the ranks, flat float32: one
    reduce-scatter of the slices padded to the widest (summed, then scaled
    by ``1/n`` as :meth:`DataParallel.reduce_leaf`)."""
    n = len(bounds) - 1
    sizes = [bounds[r + 1] - bounds[r] for r in range(n)]
    flat = full.reshape(-1)
    buf = torch.zeros((n, max(sizes)), dtype=torch.float32, device=full.device)
    for r in range(n):
        buf[r, :sizes[r]] = flat[bounds[r]:bounds[r + 1]]
    out = torch.empty(max(sizes), dtype=torch.float32, device=full.device)
    dist.reduce_scatter_tensor(out, buf.view(-1), group=group, log_name="grad_reduce_scatter")
    return out[:sizes[get_topology().rank_in(group)]].mul_(1.0 / n)


def gather_plan_slices(local: torch.Tensor, bounds, group=ZERO_AXES) -> torch.Tensor:
    """A leaf's whole flat values from every rank's ``PartitionPlan`` slice
    (``bounds``: the leaf's ``n + 1`` offsets): one all-gather of the
    slices padded to the widest."""
    n = len(bounds) - 1
    sizes = [bounds[r + 1] - bounds[r] for r in range(n)]
    buf = torch.zeros(max(sizes), dtype=local.dtype, device=local.device)
    buf[:local.numel()] = local.reshape(-1)
    out = dist.inprog_all_gather(buf, group, tiled=False, log_name="slice_gather")
    return torch.cat([out[r, :sizes[r]] for r in range(n)])


def _spec_leaves(specs):
    """Spec tuples in ``tree_leaves`` order (a spec is a tuple, not a leaf
    container)."""
    if isinstance(specs, dict):
        for k in sorted(specs):
            yield from _spec_leaves(specs[k])
    else:
        yield specs


class _Gather(torch.autograd.Function):
    """A shard gathered into the whole weight; the backward hands the
    weight's gradient to ``on_grad`` and gives the leaf's anchor a zero."""

    @staticmethod
    def forward(ctx, anchor, shard, gather, on_grad):
        ctx.on_grad = on_grad
        return gather(shard)

    @staticmethod
    def backward(ctx, grad):
        ctx.on_grad(grad)
        return grad.new_zeros(()), None, None, None


class _LazyLeaf:
    """A sharded leaf gathered whole at its first use in a forward. What the
    autograd graph keeps (the backward's callback, the gather again) holds
    the shard, never the gathered weight."""

    def __init__(self, dp: DataParallel, j, shard, anchor, on_grad):
        self.dp, self.j, self.shard, self.anchor, self.on_grad = dp, j, shard, anchor, on_grad
        self.full = None

    def _gathered(self, lay, shard, layer):
        dp, qwz = self.dp, self.dp.qwz

        def gather(s):
            return lay.gather(s, qwz)

        if not torch.is_grad_enabled():
            return gather(shard)
        full = _Gather.apply(self.anchor, shard, gather,
                             functools.partial(self.on_grad, self.j, layer))
        dp._register(full, functools.partial(gather, shard))
        return full

    def get(self) -> torch.Tensor:
        if self.full is None:
            self.full = self._gathered(self.dp.param[self.j], self.shard.detach(), None)
        return self.full

    def __getitem__(self, i):
        return self.get()[i]

    @property
    def dtype(self):
        return self.shard.dtype

    def is_floating_point(self):
        return self.shard.is_floating_point()


class _LayerStack(_LazyLeaf):
    """A stacked block leaf ``(L, ...)`` sharded after its first dimension:
    ``stack[i]`` gathers layer ``i``'s slice."""

    def __getitem__(self, i):
        return self._gathered(self.dp.param[self.j].layer(), self.shard[i].detach(), i)


class _Stage3Tree(dict):
    """A parameter dict whose values may be lazy leaves: indexing (and
    ``get``) gathers; ``items`` / ``values`` hand a stacked leaf over as its
    ``_LayerStack``, which a layer loop indexes."""

    def __getitem__(self, k):
        v = dict.__getitem__(self, k)
        if isinstance(v, _LayerStack):
            return v
        return v.get() if isinstance(v, _LazyLeaf) else v

    def get(self, k, default=None):
        return self[k] if k in self else default


def _wrap(tree):
    if isinstance(tree, dict):
        return _Stage3Tree({k: _wrap(v) for k, v in tree.items()})
    return tree
