"""Loss scaling for fp16 training (counterpart of ``deepspeed_tpu/runtime/fp16/loss_scaler.py``).

``LossScalerState`` holds 0-d tensors on the engine's device, and the
dynamic scaler's update is ``torch.where`` arithmetic on them, so a step
updates the scale without a host sync, as the JAX package's ``lax.cond``
does. ``has_overflow`` is True when any gradient element is inf or nan.
"""

from typing import NamedTuple

import torch

from ...utils.tree import tree_leaves


class LossScalerState(NamedTuple):
    cur_scale: torch.Tensor  # f32 scalar
    cur_hysteresis: torch.Tensor  # i32 scalar
    last_overflow_iter: torch.Tensor  # i32 scalar
    iter_: torch.Tensor  # i32 scalar


def has_overflow(grads) -> torch.Tensor:
    """True if any grad element is inf/nan (reference ``_has_inf_or_nan``)."""
    flags = [~torch.isfinite(g).all() for g in tree_leaves(grads)]
    if not flags:
        return torch.tensor(False)
    return torch.stack(flags).any()


def _state(scale, hysteresis, device) -> LossScalerState:
    return LossScalerState(
        cur_scale=torch.tensor(scale, dtype=torch.float32, device=device),
        cur_hysteresis=torch.tensor(hysteresis, dtype=torch.int32, device=device),
        last_overflow_iter=torch.tensor(-1, dtype=torch.int32, device=device),
        iter_=torch.tensor(0, dtype=torch.int32, device=device),
    )


class BaseLossScaler:
    dynamic = False

    def __init__(self, scale: float = 1.0):
        self.init_scale = float(scale)

    def init_state(self, device="cpu") -> LossScalerState:
        return _state(self.init_scale, 1, device)

    def update(self, state: LossScalerState, overflow: torch.Tensor) -> LossScalerState:
        return state._replace(iter_=state.iter_ + 1)


class LossScaler(BaseLossScaler):
    """Static scale (config ``fp16.loss_scale`` > 0)."""


class DynamicLossScaler(BaseLossScaler):
    """Dynamic scale with growth window + hysteresis (reference semantics):
    overflow → consume hysteresis, then halve the scale; ``scale_window`` clean
    iterations → double the scale."""

    dynamic = True

    def __init__(self, init_scale=2**32, scale_factor=2.0, scale_window=1000,
                 min_scale=1.0, delayed_shift=1, consecutive_hysteresis=False):
        super().__init__(init_scale)
        self.scale_factor = float(scale_factor)
        self.scale_window = int(scale_window)
        self.min_scale = float(min_scale)
        self.delayed_shift = int(delayed_shift)
        self.consecutive_hysteresis = consecutive_hysteresis

    def init_state(self, device="cpu") -> LossScalerState:
        return _state(self.init_scale, self.delayed_shift, device)

    def update(self, state: LossScalerState, overflow: torch.Tensor) -> LossScalerState:
        s = state
        overflow = torch.as_tensor(overflow, device=s.cur_scale.device)
        # on overflow: consume hysteresis, then shrink
        shrink = s.cur_hysteresis <= 1
        ov_scale = torch.where(
            shrink, torch.clamp(s.cur_scale / self.scale_factor, min=self.min_scale),
            s.cur_scale)
        ov_hyst = torch.where(shrink, s.cur_hysteresis, s.cur_hysteresis - 1)
        # clean: grow every scale_window iterations since the last overflow
        grow = torch.remainder(s.iter_ - s.last_overflow_iter,
                               self.scale_window) == self.scale_window - 1
        cl_scale = torch.where(grow, s.cur_scale * self.scale_factor, s.cur_scale)
        cl_hyst = (torch.full_like(s.cur_hysteresis, self.delayed_shift)
                   if not self.consecutive_hysteresis else s.cur_hysteresis)
        return LossScalerState(
            cur_scale=torch.where(overflow, ov_scale, cl_scale),
            cur_hysteresis=torch.where(overflow, ov_hyst, cl_hyst),
            last_overflow_iter=torch.where(overflow, s.iter_, s.last_overflow_iter),
            iter_=s.iter_ + 1,
        )


def CreateLossScaler(fp16_config, dtype_is_fp16: bool) -> BaseLossScaler:
    """Factory mirroring reference ``loss_scaler.CreateLossScaler``."""
    if not dtype_is_fp16:
        return LossScaler(scale=1.0)
    if fp16_config.dynamic_loss_scale:
        return DynamicLossScaler(
            init_scale=2**fp16_config.initial_scale_power,
            scale_window=fp16_config.loss_scale_window,
            min_scale=fp16_config.min_loss_scale,
            delayed_shift=fp16_config.hysteresis,
            consecutive_hysteresis=fp16_config.consecutive_hysteresis,
        )
    return LossScaler(scale=fp16_config.loss_scale)
