"""Wall-clock and throughput timers (counterpart of ``deepspeed_tpu/utils/timer.py``).

The same timers as the JAX package (``SynchronizedWallClockTimer``,
``ThroughputTimer``, ``NoopTimer``). PyTorch returns before the card
finishes, so a timer that synchronizes calls ``torch.cuda.synchronize()``
(when CUDA is in use) before it reads the host clock.
"""

import time
from collections import OrderedDict

import torch

from .logging import log_dist

FORWARD_MICRO_TIMER = "fwd_microstep"
FORWARD_GLOBAL_TIMER = "fwd"
BACKWARD_MICRO_TIMER = "bwd_microstep"
BACKWARD_GLOBAL_TIMER = "bwd"
BACKWARD_INNER_MICRO_TIMER = "bwd_inner_microstep"
BACKWARD_INNER_GLOBAL_TIMER = "bwd_inner"
BACKWARD_REDUCE_MICRO_TIMER = "bwd_allreduce_microstep"
BACKWARD_REDUCE_GLOBAL_TIMER = "bwd_allreduce"
STEP_MICRO_TIMER = "step_microstep"
STEP_GLOBAL_TIMER = "step"


def _device_sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class SynchronizedWallClockTimer:
    """Group of named timers, optionally synchronizing device work before reads."""

    class Timer:
        def __init__(self, name):
            self.name_ = name
            self.started_ = False
            self.start_time = time.time()
            self.total_ = 0.0  # running total since last reset, in seconds
            self.count_ = 0  # readings since last reset, for means

        def start(self, sync=False):
            assert not self.started_, f"{self.name_} timer has already been started"
            if sync:
                _device_sync()
            self.start_time = time.time()
            self.started_ = True

        def stop(self, reset=False, sync=False, record=None):
            assert self.started_, "timer is not started"
            if sync:
                _device_sync()
            elapsed = time.time() - self.start_time
            if reset:
                self.total_ = elapsed
                self.count_ = 1
            else:
                self.total_ += elapsed
                self.count_ += 1
            self.started_ = False

        def reset(self):
            self.started_ = False
            self.total_ = 0.0
            self.count_ = 0

        def elapsed(self, reset=True):
            started = self.started_
            if started:
                self.stop()
            total = self.total_
            if reset:
                self.reset()
            if started:
                self.start()
            return total

        def mean(self):
            return (self.total_ / self.count_) if self.count_ else 0.0

    def __init__(self):
        self.timers = OrderedDict()

    def __call__(self, name):
        if name not in self.timers:
            self.timers[name] = self.Timer(name)
        return self.timers[name]

    def has_timer(self, name):
        return name in self.timers

    @staticmethod
    def memory_usage():
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return "mem stats unavailable"
        return (f"mem in-use {torch.cuda.memory_allocated() / 2**30:.2f} GB | "
                f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GB")

    def log(self, names, normalizer=1.0, reset=True, memory_breakdown=False, ranks=None):
        assert normalizer > 0.0
        string = "time (ms)"
        for name in names:
            if name in self.timers:
                elapsed_time = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
                string += f" | {name}: {elapsed_time:.2f}"
        if memory_breakdown:
            string += " | " + self.memory_usage()
        log_dist(string, ranks=ranks or [0])

    def get_mean(self, names, normalizer=1.0):
        assert normalizer > 0.0
        return {name: self.timers[name].mean() * 1000.0 / normalizer
                for name in names if name in self.timers}


class NoopTimer:
    class Timer:
        def start(self, **kwargs):
            ...

        def reset(self):
            ...

        def stop(self, **kwargs):
            ...

        def elapsed(self, **kwargs):
            return 0.0

        def mean(self):
            return 0.0

    def __init__(self):
        self.timer = self.Timer()

    def __call__(self, name):
        return self.timer

    def has_timer(self, name):
        return True

    def log(self, names, normalizer=1.0, reset=True, memory_breakdown=False, ranks=None):
        ...

    def get_mean(self, names, normalizer=1.0):
        return {}


class ThroughputTimer:
    """Samples/sec (reference ``utils/timer.py:198``)."""

    def __init__(self, batch_size, start_step=2, steps_per_output=50, monitor_memory=False,
                 logging_fn=None):
        self.start_time = 0
        self.end_time = 0
        self.started = False
        self.batch_size = max(1, batch_size)
        self.start_step = start_step
        self.epoch_count = 0
        self.micro_step_count = 0
        self.global_step_count = 0
        self.total_elapsed_time = 0
        self.step_elapsed_time = 0
        self.steps_per_output = steps_per_output
        self.monitor_memory = monitor_memory
        self.logging = logging_fn or log_dist
        self.initialized = False

    def update_epoch_count(self):
        self.epoch_count += 1
        self.micro_step_count = 0

    def _init_timer(self):
        self.initialized = True

    def start(self):
        self._init_timer()
        self.started = True
        if self.global_step_count >= self.start_step:
            _device_sync()
            self.start_time = time.time()

    def stop(self, global_step=False, report_speed=True):
        if not self.started:
            return
        self.started = False
        self.micro_step_count += 1
        if global_step:
            self.global_step_count += 1
        if self.start_time > 0:
            _device_sync()
            self.end_time = time.time()
            duration = self.end_time - self.start_time
            self.total_elapsed_time += duration
            self.step_elapsed_time += duration
            if global_step:
                if report_speed and self.steps_per_output and \
                        self.global_step_count % self.steps_per_output == 0:
                    self.logging(
                        f"epoch={self.epoch_count}/micro_step={self.micro_step_count}/"
                        f"global_step={self.global_step_count}, "
                        f"RunningAvgSamplesPerSec={self.avg_samples_per_sec():.6g}, "
                        f"CurrSamplesPerSec={self.batch_size / self.step_elapsed_time:.6g}")
                self.step_elapsed_time = 0

    def avg_samples_per_sec(self):
        if self.global_step_count > self.start_step and self.total_elapsed_time > 0:
            samples = self.batch_size * (self.global_step_count - self.start_step)
            return samples / self.total_elapsed_time
        return float("-inf")


def trim_mean(data, trim_percent):
    """Trimmed mean (drop ``trim_percent`` of the tails on each side)."""
    assert 0.0 <= trim_percent <= 1.0
    n = len(data)
    if n == 0:
        return 0.0
    data_ = sorted(data)
    trim_count = int(trim_percent * n)
    trimmed = data_[trim_count:n - trim_count] or data_
    return sum(trimmed) / len(trimmed)
