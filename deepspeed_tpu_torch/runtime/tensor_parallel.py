"""Tensor parallelism over the mesh's ``model`` axis: the collectives and a rank's layout.

The JAX package shards the model's leaves by ``TransformerLM.tp_specs``
(column-parallel ``wq/wk/wv/w_up/w_gate``, row-parallel ``wo/w_down``,
vocab-parallel ``wte``/``lm_head``) and lets GSPMD place the collectives.
The port runs one process a rank, so it states them in Megatron's layout,
each through the ``comm`` facade on the ``model`` group (so the comms logger
counts its bytes):

- :func:`copy_to_model`: the identity forward whose backward all-reduces,
  ahead of the column-parallel projections and the vocab-parallel head;
- :func:`reduce_from_model`: an all-reduce forward whose backward is the
  identity, after the row-parallel projections and the vocab-parallel
  embedding lookup;
- :func:`gather_from_model`: a rank's shard along one dimension
  all-gathered into the whole (the logits that leave the model for
  sampling or for ``logits()``); the backward keeps the rank's slice;
- :func:`vocab_parallel_embed`: the lookup of the ids in this rank's rows
  of the vocabulary, the others masked to zero, then the all-reduce;
- :func:`vocab_parallel_nll`: the next-token loss over logits sharded on
  the vocabulary: the shard's max and sum of exponentials, all-reduced as
  MAX then SUM, the gold logit from the shard that owns it, all-reduced as
  SUM; ``-100`` ignored. Its backward is ``softmax_shard - onehot_shard``.

Each function takes ``tp``, the ``(degree, this rank's model coordinate)``
layout of the model that calls it (``TransformerLM.tp``, which the engines
set from their topology); at a degree of 1 every function is the identity
and adds no op.

:class:`TensorParallel` is a rank's layout of a parameter tree under the
specs: which dimension each leaf shards over the ``model`` axis, its TP
shard of a global leaf (:meth:`TensorParallel.local`), the global leaves
from every rank's shards (:meth:`TensorParallel.full`, collective), and
which leaves a norm counts on this rank (a replicated leaf once, on model
coordinate 0).
"""

from typing import List, Optional, Sequence

import torch

from ..comm import comm as dist
from ..comm.topology import MODEL_AXIS
from ..utils.tree import tree_leaves, tree_unflatten


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return dist.all_reduce(g.contiguous().clone(), group=MODEL_AXIS,
                               log_name="tp_grad_all_reduce")


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return dist.all_reduce(x.contiguous().clone(), group=MODEL_AXIS,
                               log_name="tp_all_reduce")

    @staticmethod
    def backward(ctx, g):
        return g


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, rank):
        ctx.dim, ctx.size, ctx.rank = dim, x.shape[dim], rank
        return dist.inprog_all_gather(x.contiguous(), MODEL_AXIS, axis=dim,
                                      log_name="tp_all_gather")

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None


def copy_to_model(x, tp):
    return x if tp[0] == 1 else _CopyToModel.apply(x)


def reduce_from_model(x, tp):
    return x if tp[0] == 1 else _ReduceFromModel.apply(x)


def gather_from_model(x, tp, dim: int = -1):
    if tp[0] == 1:
        return x
    return _GatherFromModel.apply(x, dim % x.dim(), tp[1])


def vocab_parallel_embed(wte, ids, tp):
    """``wte[ids]`` over this rank's rows of a vocabulary-sharded table: an
    id outside them looks up zeros, and the all-reduce sums the one row
    each id has (exact: every other term is zero)."""
    n, r = tp
    if n == 1:
        return wte[ids]
    vs = wte.shape[0]
    local = ids.long() - r * vs
    out = (local < 0) | (local >= vs)
    x = wte[local.clamp(0, vs - 1)].masked_fill(out[..., None], 0)
    return reduce_from_model(x, tp)


class _VocabParallelNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lg, labels, r):
        vs = lg.shape[-1]
        lg = lg.float()
        m = dist.all_reduce(lg.amax(-1).contiguous(), op="max", group=MODEL_AXIS,
                            log_name="tp_loss_max")
        e = torch.exp(lg - m[..., None])
        s = dist.all_reduce(e.sum(-1).contiguous(), group=MODEL_AXIS, log_name="tp_loss_sum")
        local = labels.long() - r * vs
        own = (labels != -100) & (local >= 0) & (local < vs)
        idx = local.clamp(0, vs - 1)
        gold = torch.where(own, lg.gather(-1, idx[..., None])[..., 0], 0.0)
        gold = dist.all_reduce(gold.contiguous(), group=MODEL_AXIS, log_name="tp_loss_gold")
        ctx.save_for_backward(e, s, own, idx)
        return m + torch.log(s) - gold

    @staticmethod
    def backward(ctx, g):
        e, s, own, idx = ctx.saved_tensors
        grad = e / s[..., None] * g[..., None]
        hit = torch.where(own, g, 0.0)
        grad.scatter_add_(-1, idx[..., None], -hit[..., None])
        return grad, None, None


def vocab_parallel_nll(lg, labels, tp):
    """Per-token ``logsumexp(logits) - logits[label]`` (fp32) where ``lg``
    is this rank's shard of the vocabulary (the whole at a degree of 1);
    a ``-100`` label gives ``logsumexp`` alone (the caller masks it)."""
    if tp[0] == 1:
        lg = lg.float()
        safe = torch.where(labels != -100, labels, torch.zeros_like(labels)).long()
        return torch.logsumexp(lg, dim=-1) - lg.gather(-1, safe[..., None])[..., 0]
    return _VocabParallelNLL.apply(lg, labels, tp[1])


def spec_dim(spec) -> Optional[int]:
    """The dimension a spec shards over the ``model`` axis (None: replicated)."""
    for i, e in enumerate(spec or ()):
        names = e if isinstance(e, (tuple, list)) else (e,)
        if MODEL_AXIS in names:
            return i
    return None


def strip_model(spec) -> tuple:
    """A spec with the ``model`` axis taken out of every entry: the layout
    of a TP-local leaf, whose ``model`` dimension this rank already holds."""
    out = []
    for e in spec or ():
        if isinstance(e, (tuple, list)):
            rest = tuple(a for a in e if a != MODEL_AXIS)
            out.append(rest if len(rest) > 1 else (rest[0] if rest else None))
        else:
            out.append(None if e == MODEL_AXIS else e)
    return tuple(out)


def shard_leaf(a, dim: Optional[int], n: int, rank: int, name: str = "leaf"):
    """Rank ``rank``'s slice of ``a`` (numpy or tensor) on ``dim`` over
    ``n`` ranks; ``ValueError`` naming the leaf where ``n`` does not divide
    that dimension."""
    if dim is None or n == 1:
        return a
    size = a.shape[dim]
    if size % n:
        raise ValueError(f"tensor parallelism: leaf '{name}' has {size} along dimension "
                         f"{dim}, which a model degree of {n} does not divide")
    k = size // n
    if isinstance(a, torch.Tensor):
        return a.narrow(dim, rank * k, k)
    idx = [slice(None)] * a.ndim
    idx[dim] = slice(rank * k, (rank + 1) * k)
    return a[tuple(idx)]


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


class TensorParallel:
    """A rank's layout of a parameter tree over the ``model`` axis:
    ``dims[j]`` the dimension leaf ``j`` (``tree_leaves`` order) shards on
    (None: replicated), ``global_shapes[j]`` its whole shape."""

    def __init__(self, specs, global_shapes, n: int, rank: int):
        self.n, self.rank = int(n), int(rank)
        self.specs = specs
        self.names = [k for k, _ in _named_leaves(global_shapes)]
        self.global_shapes = [tuple(s) for s in tree_leaves(global_shapes)]
        self.dims = [spec_dim(spec_at(specs, name.split("/"))) for name in self.names]
        for name, shape, d in zip(self.names, self.global_shapes, self.dims):
            if d is not None and shape[d] % self.n:
                raise ValueError(
                    f"tensor parallelism: leaf '{name}' has {shape[d]} along dimension {d}, "
                    f"which a model degree of {self.n} does not divide")

    def local_shape(self, j: int) -> tuple:
        shape, d = list(self.global_shapes[j]), self.dims[j]
        if d is not None:
            shape[d] //= self.n
        return tuple(shape)

    def spec_leaves(self) -> List[tuple]:
        return [spec_at(self.specs, name.split("/")) or () for name in self.names]

    def local(self, tree, copy: bool = False):
        """``tree`` with every leaf of the global shape cut to this rank's
        shard; a leaf already of the local shape passes (a tree drawn as
        shards). Anything else raises ``ValueError``. ``copy``: each cut of
        a tensor a contiguous tensor of its own (the whole tree can then be
        dropped), else a view."""
        names = [k for k, _ in _named_leaves(tree)]
        if names != self.names:
            raise ValueError(f"tensor parallelism: the tree's leaves {names} are not the "
                             f"model's {self.names}")
        leaves = list(tree_leaves(tree))
        out = []
        for j, a in enumerate(leaves):
            shape = tuple(a.shape)
            if shape == self.local_shape(j):
                out.append(a)
            elif shape == self.global_shapes[j]:
                cut = shard_leaf(a, self.dims[j], self.n, self.rank, self.names[j])
                if copy and isinstance(cut, torch.Tensor) and cut is not a:
                    cut = cut.contiguous().clone()
                out.append(cut)
            else:
                raise ValueError(
                    f"tensor parallelism: leaf '{self.names[j]}' has shape {shape}: neither "
                    f"the model's {self.global_shapes[j]} nor its model-degree-{self.n} "
                    f"shard {self.local_shape(j)}")
        return tree_unflatten(tree, out)

    def full_leaf(self, j: int, t: torch.Tensor) -> torch.Tensor:
        """Leaf ``j`` whole from this rank's shard ``t`` (collective)."""
        d = self.dims[j]
        if d is None:
            return t
        return dist.inprog_all_gather(t.contiguous(), MODEL_AXIS, axis=d,
                                      log_name="tp_param_gather")

    def full(self, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [self.full_leaf(j, t) for j, t in enumerate(leaves)]

    def counts(self, j: int) -> bool:
        """Whether leaf ``j`` counts toward a norm on this rank: a sharded
        leaf on every rank, a replicated one on model coordinate 0."""
        return self.dims[j] is not None or self.rank == 0


def spec_at(specs, path):
    """The spec at ``path`` (a sequence of keys) of a spec tree; None where
    the tree names no spec (a replicated leaf)."""
    node = specs
    for k in path:
        if not isinstance(node, dict) or k not in node:
            return None
        node = node[k]
    return node
