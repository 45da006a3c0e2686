"""Remat policies on PyTorch's selective activation checkpointing: the port's
counterpart of ``jax.checkpoint_policies`` and ``jax.ad_checkpoint.checkpoint_name``.

A policy is a predicate ``policy(op, args) -> bool`` over the dispatcher
operations that a checkpointed function runs: True keeps the operation's
output for the backward, False recomputes it there. ``remat(fn, policy)``
runs ``fn`` under ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``
with the policy as its selective-checkpoint context; ``policy=None`` keeps
nothing but the inputs (``jax.checkpoint`` without a policy). A kept output
is returned as it was on the recompute, so the operation does not run again.

Names. ``checkpoint_name(x, name)`` is an operation of its own
(``dstt::checkpoint_name``: a copy of ``x`` whose gradient passes through
unchanged), so that a policy sees it. The flash forward
(``dstt::flash_attention_fwd``, ``ops/transformer/flash_attention.py``)
carries the names ``attn_out`` and ``attn_lse`` of its two outputs, as the
JAX kernel names its residuals (``flash_attention.py:242-243``).

Dots. ``aten.mm`` is a dot with no batch dimension (``h @ w`` with ``h``
(B, S, H) and ``w`` (H, N) folds to one); ``aten.bmm`` and ``aten.baddbmm``
carry one (the plain attention's einsums).
"""

from typing import Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ...ops.transformer import flash_attention  # noqa: F401  (registers dstt::flash_attention_fwd)

Policy = Callable[..., bool]

#: the flash forward's output names (``flash_attention.py:242-243``)
FLASH_NAMES = ("attn_out", "attn_lse")


@torch.library.custom_op("dstt::checkpoint_name", mutates_args=())
def _checkpoint_name_op(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()


def _pass_grad_setup(ctx, inputs, output):
    pass


def _pass_grad(ctx, grad):
    return grad, None


_checkpoint_name_op.register_autograd(_pass_grad, setup_context=_pass_grad_setup)


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` under ``name``, visible to :func:`save_only_these_names`."""
    return _checkpoint_name_op(x, name)


def op_names(op, args) -> Tuple[str, ...]:
    """The names an operation's output carries."""
    if op is torch.ops.dstt.checkpoint_name.default:
        return (args[1],)
    if op is torch.ops.dstt.flash_attention_fwd.default:
        return FLASH_NAMES
    return ()


_NO_BATCH_DOTS = (torch.ops.aten.mm.default,)
_BATCH_DOTS = (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def dots_with_no_batch_dims_saveable(op, args) -> bool:
    return op in _NO_BATCH_DOTS


def dots_saveable(op, args) -> bool:
    return op in _NO_BATCH_DOTS or op in _BATCH_DOTS


def save_only_these_names(*names: str) -> Policy:
    keep = frozenset(names)
    return lambda op, args: bool(keep.intersection(op_names(op, args)))


def save_from_both_policies(a: Policy, b: Policy) -> Policy:
    return lambda op, args: a(op, args) or b(op, args)


def _context(policy: Policy):
    def decide(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if policy(op, args)
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return create_selective_checkpoint_contexts(decide)


def remat(fn: Callable, policy: Optional[Policy] = None) -> Callable:
    """``fn`` rematerialised in the backward under ``policy``."""
    if policy is None:
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                    context_fn=lambda: _context(policy))
