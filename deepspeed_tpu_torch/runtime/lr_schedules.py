"""LR schedules (a copy of ``deepspeed_tpu/runtime/lr_schedules.py``: host-only Python).

Parity with reference ``runtime/lr_schedules.py`` (schedule names :18-22:
``LRRangeTest``, ``OneCycle``, ``WarmupLR``, ``WarmupDecayLR``, ``WarmupCosineLR``).
Schedules are host-side: the engine reads ``get_lr()`` each optimizer step and feeds
the scalar into the update.
"""

import math
from typing import List

LR_SCHEDULE = "lr_schedule"
LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
WARMUP_COSINE_LR = "WarmupCosineLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR, WARMUP_COSINE_LR]

WARMUP_LOG_RATE = "log"
WARMUP_LINEAR_RATE = "linear"


class _LRSchedule:
    """Step-indexed schedule over a single LR (engine keeps one param group)."""

    def __init__(self, optimizer, last_batch_iteration: int = -1):
        self.optimizer = optimizer
        self.last_batch_iteration = last_batch_iteration
        self._last_lr: List[float] = [self._base_lr()]

    def _base_lr(self) -> float:
        return getattr(self.optimizer, "lr", 1e-3) if self.optimizer is not None else 1e-3

    def get_lr(self) -> List[float]:
        raise NotImplementedError

    def get_last_lr(self) -> List[float]:
        return self._last_lr

    def step(self, last_batch_iteration: int = None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration
        self._last_lr = self.get_lr()
        if self.optimizer is not None and hasattr(self.optimizer, "lr"):
            self.optimizer.lr = self._last_lr[0]

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]
        self._last_lr = self.get_lr()


class LRRangeTest(_LRSchedule):
    """LR range test sweep (reference ``lr_schedules.py:267``)."""

    def __init__(self, optimizer, lr_range_test_min_lr=1e-3, lr_range_test_step_size=2000,
                 lr_range_test_step_rate=1.0, lr_range_test_staircase=False,
                 last_batch_iteration=-1):
        self.min_lr = lr_range_test_min_lr
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase
        super().__init__(optimizer, last_batch_iteration)

    def get_lr(self):
        it = max(0, self.last_batch_iteration)
        if self.staircase:
            interval = float(it // self.step_size)
        else:
            interval = it / self.step_size
        return [self.min_lr * (1 + interval * self.step_rate)]


class OneCycle(_LRSchedule):
    """1-cycle policy (reference ``OneCycle``): LR up-down cycle + optional decay."""

    def __init__(self, optimizer, cycle_min_lr, cycle_max_lr, decay_lr_rate=0.0,
                 cycle_first_step_size=2000, cycle_second_step_size=None,
                 cycle_first_stair_count=0, cycle_second_stair_count=None,
                 decay_step_size=0, cycle_momentum=False, cycle_min_mom=0.8,
                 cycle_max_mom=0.9, decay_mom_rate=0.0, last_batch_iteration=-1):
        self.cycle_min_lr = cycle_min_lr
        self.cycle_max_lr = cycle_max_lr
        self.decay_lr_rate = decay_lr_rate
        self.first_size = cycle_first_step_size
        self.second_size = cycle_second_step_size if cycle_second_step_size is not None else cycle_first_step_size
        self.decay_step_size = decay_step_size
        self.total_size = self.first_size + self.second_size
        super().__init__(optimizer, last_batch_iteration)

    def get_lr(self):
        it = max(0, self.last_batch_iteration)
        if it <= self.total_size:
            if it <= self.first_size:
                pct = it / self.first_size
            else:
                pct = 1.0 - (it - self.first_size) / self.second_size
            lr = self.cycle_min_lr + (self.cycle_max_lr - self.cycle_min_lr) * pct
        else:
            # decay phase
            decay_steps = it - self.total_size
            if self.decay_step_size > 0:
                decay_epochs = decay_steps // self.decay_step_size
            else:
                decay_epochs = decay_steps
            lr = self.cycle_min_lr * (1.0 / (1.0 + self.decay_lr_rate * decay_epochs))
        return [lr]


class WarmupLR(_LRSchedule):
    """Warmup to a target LR, then hold (reference ``WarmupLR``)."""

    def __init__(self, optimizer, warmup_min_lr=0.0, warmup_max_lr=0.001,
                 warmup_num_steps=1000, warmup_type=WARMUP_LOG_RATE,
                 last_batch_iteration=-1):
        self.warmup_min_lr = warmup_min_lr
        self.warmup_max_lr = warmup_max_lr
        self.warmup_num_steps = max(2, warmup_num_steps)
        if warmup_type not in (WARMUP_LOG_RATE, WARMUP_LINEAR_RATE):
            raise ValueError(f"warmup_type must be 'log' or 'linear', got {warmup_type}")
        self.warmup_type = warmup_type
        self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps)
        super().__init__(optimizer, last_batch_iteration)

    def _get_gamma(self):
        it = self.last_batch_iteration
        if it < self.warmup_num_steps:
            if self.warmup_type == WARMUP_LOG_RATE:
                return self.inverse_log_warm_up * math.log(it + 1)
            return min(1.0, it / self.warmup_num_steps)
        return 1.0

    def get_lr(self):
        if self.last_batch_iteration < 0:
            return [0.0]
        gamma = self._get_gamma()
        return [self.warmup_min_lr + (self.warmup_max_lr - self.warmup_min_lr) * gamma]


class WarmupDecayLR(WarmupLR):
    """Warmup then linear decay to 0 at ``total_num_steps`` (reference ``WarmupDecayLR``)."""

    def __init__(self, optimizer, total_num_steps, warmup_min_lr=0.0, warmup_max_lr=0.001,
                 warmup_num_steps=1000, warmup_type=WARMUP_LOG_RATE, last_batch_iteration=-1):
        self.total_num_steps = total_num_steps
        super().__init__(optimizer, warmup_min_lr, warmup_max_lr, warmup_num_steps,
                         warmup_type, last_batch_iteration)

    def _get_gamma(self):
        it = self.last_batch_iteration
        if it < self.warmup_num_steps:
            return super()._get_gamma()
        return max(
            0.0,
            float(self.total_num_steps - it) / float(max(1.0, self.total_num_steps - self.warmup_num_steps)),
        )


class WarmupCosineLR(_LRSchedule):
    """Linear warmup then cosine decay (reference ``WarmupCosineLR``)."""

    def __init__(self, optimizer, total_num_steps, warmup_min_ratio=0.0,
                 warmup_num_steps=1000, cos_min_ratio=0.0001, last_batch_iteration=-1):
        self.total_num_steps = total_num_steps
        self.warmup_min_ratio = warmup_min_ratio
        self.warmup_num_steps = max(2, warmup_num_steps)
        self.cos_min_ratio = cos_min_ratio
        # capture the peak lr once: step() writes back into optimizer.lr, so
        # reading it per-step would compound the ratio
        self.base_lr = getattr(optimizer, "lr", 1e-3) if optimizer is not None else 1e-3
        super().__init__(optimizer, last_batch_iteration)

    def get_lr_ratio(self):
        it = max(0, self.last_batch_iteration)
        if it < self.warmup_num_steps:
            return self.warmup_min_ratio + (1.0 - self.warmup_min_ratio) * (it / self.warmup_num_steps)
        progress = (it - self.warmup_num_steps) / max(1, self.total_num_steps - self.warmup_num_steps)
        progress = min(1.0, progress)
        cos = 0.5 * (1.0 + math.cos(math.pi * progress))
        return self.cos_min_ratio + (1.0 - self.cos_min_ratio) * cos

    def get_lr(self):
        return [self.base_lr * self.get_lr_ratio()]


SCHEDULE_CLASSES = {
    LR_RANGE_TEST: LRRangeTest,
    ONE_CYCLE: OneCycle,
    WARMUP_LR: WarmupLR,
    WARMUP_DECAY_LR: WarmupDecayLR,
    WARMUP_COSINE_LR: WarmupCosineLR,
}


def build_lr_scheduler(name: str, optimizer, params: dict):
    if name not in SCHEDULE_CLASSES:
        raise ValueError(f"unknown scheduler '{name}' (valid: {VALID_LR_SCHEDULES})")
    return SCHEDULE_CLASSES[name](optimizer, **params)
