"""1-bit Adam, 0/1 Adam and 1-bit LAMB (counterpart of ``deepspeed_tpu/ops/adam/onebit_adam.py``).

Reference ``deepspeed/runtime/fp16/onebit/{adam,zoadam,lamb}.py``: Adam
while the variance estimate settles (``freeze_step`` steps), then the
variance is frozen and only the momentum moves, so the update is linear in
the gradient and the gradient can travel sign-compressed. The compression
lives in the engine's gradient path (``runtime/comm/compressed.py``); these
classes are the frozen-variance update rules on ``FusedAdam``'s protocol,
in the JAX package's arithmetic order.
"""

import torch

from ...utils.tree import tree_leaves, tree_map, tree_unflatten, tree_unzip
from ..optimizers import FusedAdam, OptState


class OnebitAdam(FusedAdam):
    """Adam until ``freeze_step``, then momentum with the frozen ``sqrt(v)``
    preconditioner."""

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 freeze_step: int = 100, bias_correction=True, adam_w_mode=True,
                 cuda_aware=False, comm_backend_name="nccl", **kw):
        super().__init__(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                         bias_correction=bias_correction, adam_w_mode=adam_w_mode)
        self.freeze_step = freeze_step

    def _frozen(self, step):
        return step > self.freeze_step

    def _bias(self, step):
        b1, b2 = self.betas
        if not self.bias_correction:
            return 1.0, 1.0
        sf = step.to(torch.float32)
        dev = step.device
        return (1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=dev), sf),
                1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=dev), sf))

    def _leaf(self, frozen, bc1, bc2, lr):
        b1, b2 = self.betas

        def upd(p, g, m, v, w):
            g = g.float()
            if not self.adam_w_mode:
                g = g + w * p
            m_ = b1 * m + (1.0 - b1) * g
            # the variance stops moving once frozen: the update is then linear
            # in the gradient, which is what lets it travel sign-compressed
            v_ = torch.where(frozen, v, b2 * v + (1.0 - b2) * (g * g))
            denom = torch.sqrt(v_ / bc2) + self.eps
            new_p = p - lr * (m_ / bc1) / denom
            if self.adam_w_mode:
                new_p = new_p - lr * w * p
            return new_p, m_, v_

        return upd

    def update(self, grads, state: OptState, master_params, lr, weight_decay_mask=None):
        step = state.step + 1
        bc1, bc2 = self._bias(step)
        lr = torch.as_tensor(lr, dtype=torch.float32, device=step.device)
        wd = self._wd_tree(master_params, weight_decay_mask)
        upd = self._leaf(self._frozen(step), bc1, bc2, lr)
        new_p, new_m, new_v = tree_unzip(
            tree_map(upd, master_params, grads, state.m, state.v, wd), 3)
        return new_p, OptState(step=step, m=new_m, v=new_v)


class ZeroOneAdam(OnebitAdam):
    """0/1 Adam: as 1-bit Adam, with the variance refreshed every
    ``var_update_scaler`` steps after the freeze instead of held."""

    def __init__(self, *args, var_update_scaler: int = 16, **kw):
        kw.pop("var_freeze_step", None)
        super().__init__(*args, **kw)
        self.var_update_scaler = var_update_scaler

    def _frozen(self, step):
        refresh = (step % self.var_update_scaler) == 0
        return (step > self.freeze_step) & ~refresh


class OnebitLamb(OnebitAdam):
    """1-bit LAMB: the frozen-variance Adam update with a per-tensor trust
    ratio on the applied step.

    Where the engine holds the leaves in shards (ZeRO stage >= 1 across
    ranks, or tensor parallelism) it sets ``reduce_squares``: a function
    from the (2, leaves) squared sums of this rank's shards of the weights
    and the updates to the whole leaves' (all-reduced over each shard's
    groups); the trust ratio then comes from their square roots, with the
    same clamps."""

    def __init__(self, *args, max_coeff=10.0, min_coeff=0.01, **kw):
        super().__init__(*args, **kw)
        self.max_coeff = max_coeff
        self.min_coeff = min_coeff
        self.reduce_squares = None

    def _trust(self, w_norm, u_norm):
        return torch.where((w_norm > 0) & (u_norm > 0),
                           torch.clamp(w_norm / u_norm, self.min_coeff, self.max_coeff),
                           torch.ones_like(w_norm))

    def update(self, grads, state: OptState, master_params, lr, weight_decay_mask=None):
        if self.reduce_squares is None:
            return super().update(grads, state, master_params, lr, weight_decay_mask)
        b1, b2 = self.betas
        step = state.step + 1
        bc1, bc2 = self._bias(step)
        frozen = self._frozen(step)
        lr = torch.as_tensor(lr, dtype=torch.float32, device=step.device)
        wd = self._wd_tree(master_params, weight_decay_mask)
        ps, ms, vs, us = [], [], [], []
        for p, g, m, v, w in zip(*(tree_leaves(t) for t in (master_params, grads, state.m,
                                                            state.v, wd))):
            g = g.float()
            m_ = b1 * m + (1.0 - b1) * g
            v_ = torch.where(frozen, v, b2 * v + (1.0 - b2) * (g * g))
            ps.append(p)
            ms.append(m_)
            vs.append(v_)
            us.append((m_ / bc1) / (torch.sqrt(v_ / bc2) + self.eps) + w * p)
        sq = torch.stack([torch.stack([torch.sum(torch.square(t)) for t in ts])
                          for ts in (ps, us)])
        norms = torch.sqrt(self.reduce_squares(sq))
        new_p = [p - lr * self._trust(norms[0, j], norms[1, j]) * u
                 for j, (p, u) in enumerate(zip(ps, us))]
        return (tree_unflatten(master_params, new_p),
                OptState(step=step, m=tree_unflatten(master_params, ms),
                         v=tree_unflatten(master_params, vs)))

    def _leaf(self, frozen, bc1, bc2, lr):
        b1, b2 = self.betas

        def upd(p, g, m, v, w):
            g = g.float()
            m_ = b1 * m + (1.0 - b1) * g
            v_ = torch.where(frozen, v, b2 * v + (1.0 - b2) * (g * g))
            update = (m_ / bc1) / (torch.sqrt(v_ / bc2) + self.eps) + w * p
            w_norm = torch.linalg.vector_norm(p.reshape(-1))
            u_norm = torch.linalg.vector_norm(update.reshape(-1))
            return p - lr * self._trust(w_norm, u_norm) * update, m_, v_

        return upd
