"""Bounded exponential backoff with deterministic jitter.

A copy of ``deepspeed_tpu/resilience/retry.py`` for the port, which imports nothing
of the JAX package; the text below is the JAX module's.

Retry policy for :class:`~deepspeed_tpu.resilience.errors.TransientEngineError`:
attempt ``k`` (1-based) sleeps ``min(cap_s, base_s * 2**(k-1))`` scaled by a
jitter factor in ``[1, 1 + jitter]``. The jitter is *deterministic*: it is
drawn from a generator seeded with ``(seed, key, attempt)``, so two runs with
the same seed and the same fault sequence back off identically — chaos tests
are reproducible to the wall-clock, and a fleet of schedulers seeded
differently still de-synchronizes its retries (the thundering-herd property
jitter exists for)."""

import zlib
from typing import Union

import numpy as np


class RetryPolicy:
    """``max_attempts`` counts calls, not retries: the first attempt plus up
    to ``max_attempts - 1`` retries; the policy neither sleeps nor swallows —
    the caller owns the loop and the sleep fn (injectable in tests)."""

    def __init__(self, max_attempts: int = 4, base_s: float = 0.01,
                 cap_s: float = 0.25, jitter: float = 0.25, seed: int = 0):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        self.max_attempts = max_attempts
        self.base_s = base_s
        self.cap_s = cap_s
        self.jitter = jitter
        self.seed = seed

    @staticmethod
    def _key_int(key: Union[int, str]) -> int:
        return zlib.crc32(key.encode()) if isinstance(key, str) else int(key)

    def delay(self, attempt: int, key: Union[int, str] = 0) -> float:
        """Backoff before retry number ``attempt`` (1-based) of the call
        stream named ``key`` (a site name or uid)."""
        if attempt < 1:
            raise ValueError(f"attempt is 1-based, got {attempt}")
        d = min(self.cap_s, self.base_s * (2 ** (attempt - 1)))
        u = np.random.default_rng(
            (self.seed, self._key_int(key), attempt)).random()
        return d * (1.0 + self.jitter * u)
