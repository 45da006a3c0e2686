"""TiledLinear: memory-bounded large linear layers (counterpart of ``deepspeed_tpu/runtime/zero/tiling.py``).

Reference: ``deepspeed/runtime/zero/tiling.py`` (``TiledLinear``): one huge
Linear split into an ``in_splits x out_splits`` grid of sub-linears, each
tile its own parameter leaf, so a residency window releases and gathers a
tile at a time. Numerics match a dense Linear: column blocks sum over the
input split in split order, row blocks concatenate over the output split.
``remat_tile`` recomputes each tile's product in the backward
(``torch.utils.checkpoint``) instead of keeping it.
"""

from typing import Optional

import numpy as np
import torch


class TiledLinear:
    """Engine model-protocol linear over an in_splits x out_splits tile grid."""

    def __init__(self, in_features: int, out_features: int, *, in_splits: int = 1,
                 out_splits: int = 1, bias: bool = True, remat_tile: bool = False,
                 init_scale: float = 0.02):
        if in_features % in_splits or out_features % out_splits:
            raise ValueError(f"tiling {in_splits}x{out_splits} must divide "
                             f"({in_features}, {out_features})")
        self.in_features = in_features
        self.out_features = out_features
        self.in_splits = in_splits
        self.out_splits = out_splits
        self.use_bias = bias
        self.remat_tile = remat_tile
        self.init_scale = init_scale

    def init_params(self, generator: Optional[torch.Generator] = None, device=None):
        """Normal(0, ``init_scale``) tiles drawn from ``generator`` (a torch
        generator: the JAX package's ``PRNGKey`` draws other numbers), a
        zero bias."""
        ib = self.in_features // self.in_splits
        ob = self.out_features // self.out_splits
        dev = device if device is not None else (generator.device if generator else "cpu")
        params = {}
        for i in range(self.in_splits):
            for o in range(self.out_splits):
                params[f"w_{i}_{o}"] = torch.randn((ib, ob), generator=generator,
                                                   device=dev) * self.init_scale
        if self.use_bias:
            params["bias"] = torch.zeros((self.out_features,), device=dev)
        return params

    def apply(self, params, x):
        """x (..., in_features) -> (..., out_features)."""
        ib = self.in_features // self.in_splits
        outs = []
        for o in range(self.out_splits):
            acc = None
            for i in range(self.in_splits):
                xi = x[..., i * ib:(i + 1) * ib]
                w = params[f"w_{i}_{o}"].to(x.dtype)
                if self.remat_tile and torch.is_grad_enabled():
                    from torch.utils.checkpoint import checkpoint

                    part = checkpoint(torch.matmul, xi, w, use_reentrant=False)
                else:
                    part = xi @ w
                acc = part if acc is None else acc + part
            outs.append(acc)
        y = torch.cat(outs, dim=-1)
        if self.use_bias:
            y = y + params["bias"].to(x.dtype)
        return y

    def dense_weight(self, params) -> np.ndarray:
        """(in_features, out_features) dense view (checkpoint export)."""
        rows = [np.concatenate([np.asarray(params[f"w_{i}_{o}"].detach().cpu())
                                for o in range(self.out_splits)], axis=1)
                for i in range(self.in_splits)]
        return np.concatenate(rows, axis=0)

    @classmethod
    def from_dense(cls, w, bias=None, *, in_splits: int = 1, out_splits: int = 1,
                   remat_tile: bool = False):
        """Build (module, params) from an existing dense weight."""
        w = torch.as_tensor(np.asarray(w) if not isinstance(w, torch.Tensor) else w)
        mod = cls(w.shape[0], w.shape[1], in_splits=in_splits, out_splits=out_splits,
                  bias=bias is not None, remat_tile=remat_tile)
        ib = w.shape[0] // in_splits
        ob = w.shape[1] // out_splits
        params = {f"w_{i}_{o}": w[i * ib:(i + 1) * ib, o * ob:(o + 1) * ob].clone()
                  for i in range(in_splits) for o in range(out_splits)}
        if bias is not None:
            params["bias"] = torch.as_tensor(np.asarray(bias) if not isinstance(
                bias, torch.Tensor) else bias).clone()
        return mod, params
