"""Counter-based threefry2x32 random keys and draws, bit for bit as ``jax.random``.

The serving stack samples under ``fold_in(PRNGKey(seed), position)``
(``models/transformer.py`` ``sample_or_argmax``), so a sampled stream is a
pure function of (seed, position) and replays bitwise. This module computes
those keys and the draws built on them exactly as jax's default PRNG does in
its **partitionable** mode (``jax_threefry_partitionable``, the default
since jax 0.5):

- ``PRNGKey(seed)``: the key ``(seed >> 32, seed & 0xFFFFFFFF)``; seeds are
  32-bit, so the high word is 0 (jax ``prng.py`` ``threefry_seed``);
- ``threefry_2x32``: 20 rounds in five groups of four, rotations 13/15/26/6
  and 17/29/16/24, key schedule ``(k1, k2, k1 ^ k2 ^ 0x1BD11BDA)`` with the
  group counter added (jax ``prng.py`` ``_threefry2x32_lowering``);
- ``fold_in(key, data)``: ``threefry_2x32(key, (0, data))``;
- ``split(key, num)``: the fold-like split, key ``i`` the two output words of
  ``threefry_2x32(key, (0, i))`` (jax ``prng.py`` ``_threefry_split_foldlike``:
  the counters laid out as ``random_bits`` lays out a ``(num,)`` draw, the
  words stacked, not xored);
- ``random_bits``: the hash of the 64-bit row-major index of each element,
  split into (high, low) words, and the two output words xored;
- ``uniform``: ``bits >> 9 | 0x3F800000`` bit-cast to float32, minus 1,
  scaled into ``[minval, maxval)`` and clamped below at ``minval``;
- ``bernoulli`` (low mode): ``uniform(key, shape) < p``, ``p`` rounded to
  float32 first (jax ``random.py`` ``_bernoulli``);
- ``gumbel`` (low mode): ``-log(-log(uniform(tiny, 1)))``;
- ``categorical``: ``argmax(gumbel + logits)`` over the last axis.

Everything works on tensors of any device and is batched over keys: a key
is an int64 tensor ``(..., 2)`` holding two uint32 words (torch's uint32
lacks arithmetic on some devices, so the words live in int64 and every
add and rotate is masked back to 32 bits). A draw of ``shape`` under keys
``(..., 2)`` has shape ``(..., *shape)``, each batch entry its own key, as
``jax.vmap`` over the keys gives. The bits and the uniforms are exact; the
Gumbel transform goes through the device's ``log`` and may differ from
XLA's in the last place.
"""

from typing import Optional, Sequence, Union

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Device = Optional[Union[str, torch.device]]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry_2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                  x2: torch.Tensor):
    """The Threefry-2x32 hash of the counter words ``(x1, x2)`` under the
    key words ``(k1, k2)``; int64 tensors holding uint32 values, broadcast
    together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def _words(a, device: Device) -> torch.Tensor:
    """Integers (Python, numpy or tensor, possibly negative int32) as int64
    holding their low 32 bits."""
    t = torch.as_tensor(a, device=device)
    if t.is_floating_point() or t.dtype == torch.bool:
        raise TypeError(f"PRNG seeds and fold-in data must be integers, got {t.dtype}")
    return t.to(torch.int64) & _MASK


def PRNGKey(seed, device: Device = None) -> torch.Tensor:
    """``jax.random.PRNGKey`` for 32-bit seeds: ``(..., 2)`` int64 keys
    ``(0, seed mod 2**32)`` for a seed or a tensor of seeds."""
    lo = _words(seed, device)
    return torch.stack((torch.zeros_like(lo), lo), dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: a new key from ``key`` (..., 2) and 32-bit
    ``data`` (a scalar or a tensor broadcasting against the key's batch)."""
    d = _words(data, key.device)
    y1, y2 = threefry_2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(..., num, 2)`` keys from keys ``(..., 2)``."""
    idx = torch.arange(int(num), dtype=torch.int64, device=key.device)
    b1, b2 = threefry_2x32(key[..., 0, None], key[..., 1, None], idx >> 32, idx & _MASK)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int],
                partitionable: bool = True, offset: int = 0) -> torch.Tensor:
    """32-bit ``jax.random.bits``: ``(..., *shape)`` int64 tensor of uint32
    values. Only the partitionable counter layout is implemented. The
    counters are the elements' row-major indices, so ``offset`` (added to
    them) draws a window of a larger draw: rows ``[r, r + shape[0])`` of a
    draw whose rows hold ``m`` elements each are ``offset = r * m``."""
    if not partitionable:
        raise NotImplementedError(
            "threefry random bits in jax's non-partitionable mode "
            "(jax_threefry_partitionable=False) are not implemented")
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    idx = (torch.arange(n, dtype=torch.int64, device=key.device) + int(offset)).reshape(shape)
    hi, lo = idx >> 32, idx & _MASK
    expand = (...,) + (None,) * len(shape)
    b1, b2 = threefry_2x32(key[..., 0][expand], key[..., 1][expand], hi, lo)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, offset: int = 0) -> torch.Tensor:
    """float32 ``jax.random.uniform`` on ``[minval, maxval)`` (``offset`` as
    for :func:`random_bits`)."""
    bits = random_bits(key, shape, offset=offset)
    one = 0x3F800000  # the bits of 1.0f
    floats = (((bits >> 9) | one).to(torch.int32)).view(torch.float32) - 1.0
    # the bounds and their difference rounded to float32 first, as jax does
    lo = np.float32(minval)
    scale = np.float32(maxval) - lo
    return torch.clamp_min(floats * float(scale) + float(lo), float(lo))


def bernoulli(key: torch.Tensor, p, shape: Sequence[int], offset: int = 0) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for a float ``p`` (a number or
    a tensor broadcasting against ``shape``): a bool tensor ``(..., *shape)``
    (``offset`` as for :func:`random_bits`)."""
    p32 = torch.as_tensor(np.float32(p) if not isinstance(p, torch.Tensor) else p,
                          device=key.device).to(torch.float32)
    return uniform(key, shape, offset=offset) < p32


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """float32 ``jax.random.gumbel`` in its default ("low") mode."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(uniform(key, shape, tiny, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis: one draw
    per key; ``key`` (..., 2) matches ``logits``' leading axes."""
    g = gumbel(key, logits.shape[-1:])
    return torch.argmax(g + logits, dim=-1)
