"""Data loading (counterpart of ``deepspeed_tpu/runtime/dataloader.py``).

``DeepSpeedDataLoader`` batches a map-style or iterable dataset with the
JAX package's order (numpy shuffling seeded per epoch) and collation
(samples stacked into numpy arrays), then moves each batch to the engine's
device as tensors. ``RepeatingLoader`` restarts an exhausted loader.
"""

import math
from typing import Iterator

import numpy as np
import torch

from ..utils.tree import tree_map


class RepeatingLoader:
    """Wraps an iterator to restart on StopIteration (reference ``RepeatingLoader``)."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __len__(self):
        return len(self.loader)

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)


def _to_numpy_batch(samples):
    """Collate a list of samples (tuples/dicts/arrays) into stacked numpy arrays."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: np.stack([np.asarray(s[k]) for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return tuple(np.stack([np.asarray(s[i]) for s in samples]) for i in range(len(first)))
    return np.stack([np.asarray(s) for s in samples])


def to_device(batch, device):
    """numpy arrays or tensors (in dicts, tuples or bare) -> tensors on ``device``."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(to_device(b, device) for b in batch)
    return tree_map(lambda x: torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
                    .to(device), batch)


class DeepSpeedDataLoader:
    """Batches a map-style or iterable dataset onto ``device``.

    ``batch_size`` is the micro-batch (one card: the global micro-batch).
    Deterministic shuffling via a numpy RNG seeded per epoch (``set_epoch``
    keeps the DistributedSampler-compatible surface).
    """

    def __init__(self, dataset, batch_size: int, device, collate_fn=None,
                 shuffle: bool = False, seed: int = 1234, drop_last: bool = True,
                 pin_memory: bool = False, num_local_io_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.collate_fn = collate_fn or _to_numpy_batch
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        try:
            self._len = len(dataset)
        except TypeError:
            self._len = None

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        if self._len is None:
            raise TypeError("underlying dataset has no __len__")
        if self.drop_last:
            return self._len // self.batch_size
        return math.ceil(self._len / self.batch_size)

    def __iter__(self) -> Iterator:
        if self._len is not None:
            order = np.arange(self._len)
            if self.shuffle:
                rng = np.random.default_rng(self.seed + self.epoch)
                rng.shuffle(order)
            for b in range(len(self)):
                idx = order[b * self.batch_size:(b + 1) * self.batch_size]
                if len(idx) < self.batch_size and self.drop_last:
                    return
                samples = [self.dataset[int(i)] for i in idx]
                yield to_device(self.collate_fn(samples), self.device)
        else:
            buf = []
            for sample in self.dataset:
                buf.append(sample)
                if len(buf) == self.batch_size:
                    yield to_device(self.collate_fn(buf), self.device)
                    buf = []
            if buf and not self.drop_last:
                yield to_device(self.collate_fn(buf), self.device)
