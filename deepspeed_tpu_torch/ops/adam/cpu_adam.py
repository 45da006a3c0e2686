"""Host CPU Adam for ZeRO-Offload (counterpart of ``deepspeed_tpu/ops/adam/cpu_adam.py``).

``DeepSpeedCPUAdam`` updates fp32 buffers in host RAM in place (the
offloaded master and moments) through ``csrc/cpu_adam.cpp``, built with
``g++ -march=native -fopenmp`` at first use and called through ``ctypes``.
This is host code by design, as in the JAX package: there is no CUDA
counterpart. Buffers are numpy arrays or CPU torch tensors, fp32 and
contiguous; nothing is copied.

``adam_step_plain`` is the same arithmetic in plain PyTorch, for tests: it
holds the library's update at a tolerance (the library may contract to
FMAs under ``-march=native``).
"""

import ctypes
from typing import Optional

import numpy as np
import torch

from ..op_builder import CPUAdamBuilder

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = CPUAdamBuilder().load()
        lib.ds_sq_norm.restype = ctypes.c_double
        _lib = lib
    return _lib


def _ptr(a, ctype=ctypes.c_float):
    """A pointer to ``a``'s first element (a contiguous numpy array or CPU
    tensor); the buffer is written through it in place."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu" or not a.is_contiguous():
            raise ValueError("the host library takes contiguous CPU tensors")
        return ctypes.cast(a.data_ptr(), ctypes.POINTER(ctype))
    if not a.flags["C_CONTIGUOUS"]:
        raise ValueError("the host library takes contiguous arrays")
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _is_f32(a) -> bool:
    return (a.dtype == torch.float32) if isinstance(a, torch.Tensor) else a.dtype == np.float32


def _size(a) -> int:
    return a.numel() if isinstance(a, torch.Tensor) else a.size


class DeepSpeedCPUAdam:
    """In-place fused Adam/AdamW on host fp32 buffers (``cpu_adam.py:35``)."""

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 bias_correction=True, adamw_mode=True, amsgrad=False,
                 fp32_optimizer_states=True):
        if amsgrad:
            raise ValueError("DeepSpeedCPUAdam does not support AMSGrad (parity with reference)")
        self.lr = lr
        self.betas = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.bias_correction = bias_correction
        self.adamw_mode = adamw_mode
        self._lib = _load()

    def step_flat(self, p, g, m, v, step: int, lr: Optional[float] = None,
                  grad_scale: float = 1.0, clip_coef: float = 1.0):
        """One update on a flat fp32 shard; p/m/v updated in place."""
        n = _size(p)
        if not (_is_f32(p) and _is_f32(g) and _is_f32(m) and _is_f32(v)):
            raise TypeError("step_flat takes fp32 buffers")
        if not (_size(g) == _size(m) == _size(v) == n):
            raise ValueError(f"step_flat: sizes {_size(g)}, {_size(m)}, {_size(v)} vs {n}")
        self._lib.ds_adam_step(
            _ptr(p), _ptr(g), _ptr(m), _ptr(v), ctypes.c_int64(n),
            ctypes.c_float(self.lr if lr is None else lr),
            ctypes.c_float(self.betas[0]), ctypes.c_float(self.betas[1]),
            ctypes.c_float(self.eps), ctypes.c_float(self.weight_decay),
            ctypes.c_int64(step), ctypes.c_int(1 if self.adamw_mode else 0),
            ctypes.c_int(1 if self.bias_correction else 0),
            ctypes.c_float(grad_scale), ctypes.c_float(clip_coef))

    def sq_norm(self, g, grad_scale: float = 1.0) -> float:
        return float(self._lib.ds_sq_norm(_ptr(g), ctypes.c_int64(_size(g)),
                                          ctypes.c_float(grad_scale)))

    def f32_to_bf16(self, src) -> np.ndarray:
        """``src``'s bf16 bits (round to nearest even) as uint16."""
        out = np.empty(tuple(src.shape), dtype=np.uint16)
        self._lib.ds_f32_to_bf16(_ptr(out, ctypes.c_uint16), _ptr(src),
                                 ctypes.c_int64(_size(src)))
        return out


def adam_step_plain(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                    step: int, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                    weight_decay: float = 0.0, adamw: bool = True,
                    bias_correction: bool = True, grad_scale: float = 1.0,
                    clip_coef: float = 1.0) -> None:
    """``ds_adam_step`` in plain PyTorch on fp32 tensors, in place, in the
    library's order of operations (every constant an fp32 value)."""
    f32 = torch.float32

    def c(x):
        return torch.tensor(x, dtype=f32)

    b1, b2 = c(betas[0]), c(betas[1])
    one = c(1.0)
    bc1 = one - torch.pow(b1, c(float(step))) if bias_correction else one
    bc2 = one - torch.pow(b2, c(float(step))) if bias_correction else one
    gmul = c(grad_scale) * c(clip_coef)
    lr_, wd, eps_ = c(lr), c(weight_decay), c(eps)
    grad = g * gmul
    if not adamw and weight_decay != 0.0:
        grad = grad + wd * p
    m_ = b1 * m + (one - b1) * grad
    v_ = b2 * v + (one - b2) * grad * grad
    m.copy_(m_)
    v.copy_(v_)
    denom = torch.sqrt(v_ / bc2) + eps_
    newp = p - lr_ * ((m_ / bc1) / denom)
    if adamw and weight_decay != 0.0:
        newp = newp - lr_ * wd * p
    p.copy_(newp)
