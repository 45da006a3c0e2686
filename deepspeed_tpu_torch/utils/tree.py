"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

Leaves are visited in sorted-key order, the order ``jax.tree.leaves`` gives
for dicts, so sums over leaves run in the JAX package's order.
"""

from typing import Any, Callable, Dict, Iterator, Tuple


def tree_leaves(tree) -> Iterator[Any]:
    if tree is None:
        return
    if not isinstance(tree, dict):
        yield tree
        return
    for k in sorted(tree):
        yield from tree_leaves(tree[k])


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_unflatten(tree, leaves):
    """A tree shaped like ``tree`` whose leaves, in sorted-key order, are
    ``leaves`` (the inverse of :func:`tree_leaves`)."""
    return _build(tree, iter(leaves))


def _build(t, it):
    # module-level, not a closure over ``it``: a nested recursive function
    # is a reference cycle, which would keep ``leaves`` alive until the
    # collector runs
    if isinstance(t, dict):
        return {k: _build(t[k], it) for k in sorted(t)}
    return next(it)


def tree_unzip(tree: Dict, n: int) -> Tuple[Dict, ...]:
    """A tree of n-tuples -> n trees."""
    return tuple(tree_map(lambda t, i=i: t[i], tree) for i in range(n))
