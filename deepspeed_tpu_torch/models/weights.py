"""Parameters from the JAX package, and back to numpy for comparisons.

``params_from_jax`` turns the JAX ``TransformerLM``'s parameter pytree, given
as numpy arrays, into the port's parameter dictionary, so both packages
compute the same function on the same weights. Both multiply ``x @ W``, so
no leaf is transposed. The stacked ``(L, ...)`` block leaves stay stacked:
the port's ``forward_paged`` reads layer ``i`` as the view ``leaf[i]``.
Weight-only-quantized leaves (``<name>::q8|q6|q4`` int8 codes and
``<name>::scale`` fp32 scales, ``ops/quantizer/woq.py``) come across bit
for bit.
"""

from typing import Any, Dict, Optional

import numpy as np
import torch

_WOQ_SUFFIXES = {"q8": np.int8, "q6": np.int8, "q4": np.int8, "scale": np.float32}


def _to_tensor(name: str, a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    if "::" in name:
        suffix = name.rsplit("::", 1)[1]
        if suffix not in _WOQ_SUFFIXES or a.dtype != _WOQ_SUFFIXES[suffix]:
            raise NotImplementedError(
                f"parameter '{name}' ({a.dtype}) is not a weight-only-quantized leaf "
                f"the port knows (::q8, ::q6, ::q4 int8 codes; ::scale float32)")
    elif not np.issubdtype(a.dtype, np.floating):
        raise NotImplementedError(f"parameter '{name}' has dtype {a.dtype}: only "
                                  "floating leaves and quantized codes are ported")
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Nested dict of tensors (the port's parameters, any device) -> nested
    dict of numpy arrays with the same keys, for comparisons with the JAX
    package; bfloat16 leaves come back as float32 (numpy has no bfloat16),
    int8 codes as int8."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = params_to_numpy(v)
        else:
            t = v.detach().cpu()
            out[k] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return out


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Nested dict of numpy arrays (e.g. ``jax.tree.map(np.asarray, params)``)
    -> nested dict of CPU tensors with the same keys. The engine moves and
    casts them to its device and dtype."""
    return {k: params_from_jax(v) if isinstance(v, dict) else _to_tensor(k, v)
            for k, v in tree.items()}


def tp_layout(model, tp_size: int, tp_rank: int, params: Optional[Dict[str, Any]] = None):
    """Model coordinate ``tp_rank``'s ``TensorParallel`` layout over a
    ``model`` axis of ``tp_size``: ``model.tp_specs`` over its whole leaves'
    shapes, or, for a weight-only-quantized ``params`` (whole or a rank's
    shards), ``quantized_tp_specs`` over the whole codes' and scales'
    shapes. A dimension the degree does not divide raises ``ValueError``
    naming the leaf and the degree."""
    from ..ops.quantizer.woq import group_of, quantized_tp_specs
    from ..runtime.tensor_parallel import TensorParallel

    model.check_tp(tp_size)
    specs, shapes = model.tp_specs, model.param_shapes()
    blocks = (params or {}).get("blocks", {})
    if any("::q" in k for k in blocks):
        specs = quantized_tp_specs(specs, params)
        dense, qshapes = shapes["blocks"], {}
        for k, v in blocks.items():
            base, _, suffix = k.partition("::")
            if not suffix:
                qshapes[k] = dense[k]
            elif suffix != "scale":
                *lead, n_in, n_out = dense[base]
                g = group_of(int(suffix[1:]), v.shape[-2])
                qshapes[k] = (*lead, n_in // g, v.shape[-2], n_out)
                qshapes[base + "::scale"] = (*lead, n_in // g, 1, n_out)
        shapes = dict(shapes, blocks=qshapes)
    return TensorParallel(specs, shapes, tp_size, tp_rank)


def tp_shard_params(params: Dict[str, Any], model, tp_size: int, tp_rank: int) -> Dict[str, Any]:
    """Model coordinate ``tp_rank``'s shards of a whole parameter tree (numpy
    arrays, e.g. the JAX package's, or tensors from :func:`params_from_jax`)
    over a ``model`` axis of ``tp_size``, cut by :func:`tp_layout` as the JAX
    package places them. A tensor shard is a contiguous copy, so the whole
    tree can be dropped."""
    return tp_layout(model, tp_size, tp_rank, params).local(params, copy=True)
