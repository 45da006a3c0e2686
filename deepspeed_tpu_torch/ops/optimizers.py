"""Optimizer update rules (counterpart of ``deepspeed_tpu/ops/optimizers.py``).

The same functional protocol as the JAX package:

    init(master_params)                  -> OptState(step, m, v)
    update(grads, state, master_params, lr, weight_decay_mask=None)
        -> (new_master_params, new_state)

over nested dicts of tensors. ``master_params`` are fp32; precision
wrapping (lp params, loss scaling, clipping) lives in the engine. The
update is plain per-leaf PyTorch arithmetic in the order of
``optimizers.py:87-117``: in the JAX package it is XLA-fused elementwise
code, not a Pallas kernel. ``step`` is a 0-d int32 tensor and the bias
corrections are fp32 tensors on the params' device, as in JAX, so a step
never syncs the host. Ported: ``FusedAdam`` (Adam and AdamW) and the 1-bit
family on it (``ops/adam/onebit_adam.py``); the other optimizers raise
(ROADMAP.md Queue 1 item 17).
"""

from typing import NamedTuple, Optional

import torch

from ..utils.tree import tree_leaves, tree_map, tree_unzip

_OPT_ITEM = "ROADMAP.md Queue 1 item 17, the remaining optimizers"


def _tree_zeros_like(tree, dtype=torch.float32):
    return tree_map(lambda p: torch.zeros_like(p, dtype=dtype), tree)


class OptState(NamedTuple):
    step: torch.Tensor  # scalar int32
    m: object  # first-moment tree (or None)
    v: object  # second-moment tree (or None)


class Optimizer:
    """Base: hyperparameters fixed at construction, lr passed per-step."""

    def __init__(self, lr: float = 1e-3, weight_decay: float = 0.0):
        self.lr = lr
        self.weight_decay = weight_decay

    @property
    def defaults(self):
        return {"lr": self.lr, "weight_decay": self.weight_decay}

    def init(self, master_params) -> OptState:
        raise NotImplementedError

    def update(self, grads, state: OptState, master_params, lr, weight_decay_mask=None):
        raise NotImplementedError

    def _wd_tree(self, master_params, weight_decay_mask):
        if weight_decay_mask is None:
            return tree_map(lambda p: self.weight_decay, master_params)
        return tree_map(lambda p, m: self.weight_decay * m, master_params, weight_decay_mask)


class FusedAdam(Optimizer):
    """Adam/AdamW (reference ``ops/adam/fused_adam.py:18``; ``adam_w_mode`` toggles
    decoupled weight decay exactly as the reference flag does)."""

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 bias_correction=True, adam_w_mode=True, amsgrad=False,
                 moment_dtype=None):
        super().__init__(lr, weight_decay)
        if amsgrad:
            raise ValueError("FusedAdam does not support the AMSGrad variant (parity with reference)")
        self.betas = betas
        self.eps = eps
        self.bias_correction = bias_correction
        self.adam_w_mode = adam_w_mode
        # precision-aware moments: stored in moment_dtype, computed in fp32
        if isinstance(moment_dtype, str):
            moment_dtype = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                            "float32": torch.float32}[moment_dtype]
        self.moment_dtype = moment_dtype

    def init(self, master_params) -> OptState:
        md = self.moment_dtype or torch.float32
        dev = next(tree_leaves(master_params)).device
        return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                        m=_tree_zeros_like(master_params, md),
                        v=_tree_zeros_like(master_params, md))

    def update(self, grads, state, master_params, lr, weight_decay_mask=None):
        b1, b2 = self.betas
        step = state.step + 1
        dev = step.device
        lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)
        if self.bias_correction:
            sf = step.to(torch.float32)
            bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=dev), sf)
            bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=dev), sf)
        else:
            bc1 = bc2 = 1.0
        wd = self._wd_tree(master_params, weight_decay_mask)
        md = self.moment_dtype

        def upd(p, g, m, v, w):
            g = g.float()
            if not self.adam_w_mode:
                g = g + w * p  # classic Adam: decay folded into the gradient
            m_ = b1 * m.float() + (1.0 - b1) * g
            v_ = b2 * v.float() + (1.0 - b2) * (g * g)
            denom = torch.sqrt(v_ / bc2) + self.eps
            new_p = p - lr * (m_ / bc1) / denom
            if self.adam_w_mode:
                new_p = new_p - lr * w * p
            if md is not None:
                m_, v_ = m_.to(md), v_.to(md)
            return new_p, m_, v_

        flat = tree_map(upd, master_params, grads, state.m, state.v, wd)
        new_p, new_m, new_v = tree_unzip(flat, 3)
        return new_p, OptState(step=step, m=new_m, v=new_v)


OPTIMIZER_CLASSES = {
    "adam": FusedAdam,
    "adamw": FusedAdam,
    "fusedadam": FusedAdam,
}


def build_optimizer(name: str, params_dict: Optional[dict] = None) -> Optimizer:
    """Construct an optimizer from a DeepSpeed config ``optimizer`` block."""
    name = name.lower()
    params = dict(params_dict or {})
    params.pop("torch_adam", None)  # reference-only knob
    for k in ("cuda_aware", "comm_backend_name"):
        params.pop(k, None)  # reference comm knobs
    if name in ("onebitadam", "zerooneadam", "onebitlamb"):
        from .adam.onebit_adam import OnebitAdam, OnebitLamb, ZeroOneAdam

        cls = {"onebitadam": OnebitAdam, "zerooneadam": ZeroOneAdam,
               "onebitlamb": OnebitLamb}[name]
        return cls(**params)
    if name not in OPTIMIZER_CLASSES:
        raise NotImplementedError(
            f"optimizer type '{name}' is not ported to deepspeed_tpu_torch ({_OPT_ITEM}); "
            f"ported: {sorted(OPTIMIZER_CLASSES)}")
    # reference semantics: "Adam" forces AdamW logic unless adam_w_mode is
    # explicitly set (engine.py:1290, ADAM_W_MODE_DEFAULT=True)
    params.setdefault("adam_w_mode", True)
    return OPTIMIZER_CLASSES[name](**params)
