"""The port's threefry keys and draws (``deepspeed_tpu_torch.utils.prng``)
against ``jax.random``, the JAX package's sampler keys.

On the CPU: ``PRNGKey``, ``fold_in``, ``split`` (num 1, 2, 3, 7), the 32-bit
bits, ``uniform`` and ``bernoulli`` (p 0, 0.1, 0.5, 0.9 and 1, odd and 0-d
shapes) are bitwise jax's (partitionable threefry, this jax's default) for seeds 0, 1,
2**31 - 1 and -1, positions 0 to 4096 and shapes (1,), (7,), (512,) and
(3, 5); Gumbel noise within rtol 1e-6 plus atol 1e-6 (the two packages'
``log`` may differ in the last place, and ``-log(-log u)`` passes zero, where
a relative bound alone means nothing); ``categorical`` equal to jax's
wherever the top-2 margin of ``gumbel + logits`` exceeds 1e-4, with fewer
than 1% of draws excluded by that rule.

On a card (``cuda``-marked; run there with ``python -m pytest --noconftest
-m cuda tests/test_torch_prng.py``): ``sample_or_argmax`` over a seeded
(64, 32000) block, bf16-rounded logits in fp32, across temperatures, top-k
and top-p, against the same call on the CPU: bits and uniforms bitwise,
tokens under the same margin rule. The card has no JAX, so this file
imports it only inside the tests that use it.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.models import sample_or_argmax
from deepspeed_tpu_torch.utils import prng

SEEDS = (0, 1, 2**31 - 1, -1)
POSITIONS = (0, 1, 2, 37, 1000, 4095, 4096)
SHAPES = ((1,), (7,), (512,), (3, 5))
MARGIN = 1e-4


@pytest.fixture(scope="module")
def jr():
    import jax

    assert jax.config.jax_threefry_partitionable
    return jax.random


def _u32(a):
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in_bitwise(jr, seed):
    key = jr.PRNGKey(seed)
    assert np.array_equal(_u32(key), prng.PRNGKey(seed).numpy())
    for pos in POSITIONS:
        assert np.array_equal(_u32(jr.fold_in(key, pos)),
                              prng.fold_in(prng.PRNGKey(seed), pos).numpy()), pos
    # batched: one key a seed, one position a key
    seeds = torch.tensor(SEEDS, dtype=torch.int32)
    pos = torch.tensor(POSITIONS[:len(SEEDS)], dtype=torch.int32)
    got = prng.fold_in(prng.PRNGKey(seeds), pos).numpy()
    want = np.stack([_u32(jr.fold_in(jr.PRNGKey(s), int(p))) for s, p in zip(SEEDS, pos)])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_uniform_bitwise(jr, seed, shape):
    import jax.numpy as jnp

    for pos in POSITIONS:
        key = jr.fold_in(jr.PRNGKey(seed), pos)
        tkey = prng.fold_in(prng.PRNGKey(seed), pos)
        assert np.array_equal(_u32(jr.bits(key, shape, jnp.uint32)),
                              prng.random_bits(tkey, shape).numpy()), pos
        want = np.asarray(jr.uniform(key, shape))
        got = prng.uniform(tkey, shape).numpy()
        assert got.dtype == np.float32
        assert np.array_equal(want.view(np.int32), got.view(np.int32)), pos
        tiny = np.finfo(np.float32).tiny
        want = np.asarray(jr.uniform(key, shape, minval=tiny, maxval=1.0))
        assert np.array_equal(want.view(np.int32),
                              prng.uniform(tkey, shape, tiny, 1.0).numpy().view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_close(jr, seed):
    for pos in POSITIONS:
        key = jr.fold_in(jr.PRNGKey(seed), pos)
        want = np.asarray(jr.gumbel(key, (512,)))
        got = prng.gumbel(prng.fold_in(prng.PRNGKey(seed), pos), (512,)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_categorical_under_margin_rule(jr):
    rng = np.random.default_rng(0)
    R, V = 256, 1000
    logits = (rng.standard_normal((R, V)) * 2).astype(np.float32)
    seeds = rng.integers(0, 2**31 - 1, R)
    pos = rng.integers(0, 4097, R)
    keys = [jr.fold_in(jr.PRNGKey(int(s)), int(p)) for s, p in zip(seeds, pos)]
    want = np.array([int(jr.categorical(k, logits[r])) for r, k in enumerate(keys)])
    tkeys = prng.fold_in(prng.PRNGKey(torch.from_numpy(seeds)), torch.from_numpy(pos))
    got = prng.categorical(tkeys, torch.from_numpy(logits)).numpy()
    z = np.stack([np.asarray(jr.gumbel(k, (V,))) for k in keys]) + logits
    top2 = np.sort(z, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > MARGIN
    assert np.array_equal(got[clear], want[clear])
    assert (~clear).sum() < 0.01 * R


@pytest.mark.parametrize("seed", SEEDS)
def test_split_bitwise(jr, seed):
    for pos in (0, 37):
        key = jr.fold_in(jr.PRNGKey(seed), pos)
        tkey = prng.fold_in(prng.PRNGKey(seed), pos)
        for num in (1, 2, 3, 7):
            want = _u32(jr.split(key, num))
            assert want.shape == (num, 2)
            assert np.array_equal(prng.split(tkey, num).numpy(), want), (pos, num)
        # unpacking as the reference's ``rng, r1 = split(rng)``
        a, b = prng.split(tkey)
        ja, jb = jr.split(key)
        assert np.array_equal(a.numpy(), _u32(ja)) and np.array_equal(b.numpy(), _u32(jb))


@pytest.mark.parametrize("p", [0.0, 0.1, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5), (13, 17, 3)])
def test_bernoulli_bitwise(jr, p, shape):
    for seed in SEEDS:
        key = jr.fold_in(jr.PRNGKey(seed), 11)
        want = np.asarray(jr.bernoulli(key, p, shape))
        got = prng.bernoulli(prng.fold_in(prng.PRNGKey(seed), 11), p, shape).numpy()
        assert got.dtype == np.bool_ and got.shape == want.shape == shape
        assert np.array_equal(got, want), seed


def test_non_partitionable_mode_and_float_seeds_raise():
    key = prng.PRNGKey(0)
    with pytest.raises(NotImplementedError, match="non-partitionable"):
        prng.random_bits(key, (4,), partitionable=False)
    with pytest.raises(TypeError):
        prng.PRNGKey(1.5)


def _sampling_grid(R, V, seed=0):
    rng = np.random.default_rng(seed)
    lg = torch.from_numpy((rng.standard_normal((R, V)) * 3).astype(np.float32))
    lg = lg.to(torch.bfloat16).float()
    temps = np.array([(0.0, 0.5, 0.7, 1.0, 1.5)[i % 5] for i in range(R)], np.float32)
    top_ks = np.array([(0, 1, 50, V)[i % 4] for i in range(R)], np.int32)
    top_ps = np.array([(1.0, 0.9, 0.5, 1e-6)[(i // 4) % 4] for i in range(R)], np.float32)
    seeds = rng.integers(0, 2**31 - 1, R).astype(np.int32)
    pos = rng.integers(0, 4097, R).astype(np.int32)
    return lg, seeds, pos, temps, top_ks, top_ps


@pytest.mark.cuda
def test_cuda_sample_or_argmax_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: checks the draw on the card")
    dev = torch.device("cuda")
    lg, seeds, pos, temps, top_ks, top_ps = _sampling_grid(64, 32000)
    key = prng.fold_in(prng.PRNGKey(torch.from_numpy(seeds)), torch.from_numpy(pos))
    dkey = prng.fold_in(prng.PRNGKey(torch.from_numpy(seeds).to(dev)),
                        torch.from_numpy(pos).to(dev))
    assert torch.equal(dkey.cpu(), key)
    assert torch.equal(prng.random_bits(dkey, (32000,)).cpu(), prng.random_bits(key, (32000,)))
    u = prng.uniform(key, (32000,))
    assert torch.equal(prng.uniform(dkey, (32000,)).cpu().view(torch.int32), u.view(torch.int32))
    cpu = sample_or_argmax(lg, seeds, pos, temps, top_ks, top_ps)
    card = sample_or_argmax(lg.to(dev), seeds, pos, temps, top_ks, top_ps).cpu()
    assert card.dtype == torch.int32
    greedy = temps == 0
    assert torch.equal(card[greedy], cpu[greedy])
    x, edge = masked_rows(lg, temps, top_ks, top_ps)
    top2 = (prng.gumbel(key, (32000,)) + x).topk(2, dim=-1).values
    clear = torch.from_numpy(~greedy & ~edge) & ((top2[:, 0] - top2[:, 1]) > MARGIN)
    assert torch.equal(card[clear], cpu[clear])
    excluded = int((~greedy).sum()) - int(clear.sum())
    assert excluded <= 0.01 * int((~greedy).sum()), excluded


def masked_rows(lg, temps, top_ks, top_ps, edge_tol=1e-6):
    """The temperature/top-k/top-p-shaped rows ``sample_or_argmax`` draws
    from (the same arithmetic, a row at a time), and for each row whether a
    token sits within ``edge_tol`` of the nucleus edge (``cumsum - probs``
    against ``top_p``), where a sum in another order may flip it."""
    rows, edge = [], []
    for r in range(lg.shape[0]):
        t = float(temps[r]) if temps[r] > 0 else 1.0
        x = lg[r].float() / t
        srt = torch.sort(x, descending=True).values
        tk = int(top_ks[r])
        if tk > 0:
            x = torch.where(x < srt[min(max(tk - 1, 0), x.numel() - 1)], -torch.inf, x)
        probs = torch.softmax(srt, -1)
        before = torch.cumsum(probs, -1) - probs
        keep = before < float(top_ps[r])
        keep[0] = True
        if top_ps[r] < 1.0:
            x = torch.where(x < srt[keep].min(), -torch.inf, x)
        edge.append(top_ps[r] < 1.0 and bool(((before - float(top_ps[r])).abs()
                                              < edge_tol).any()))
        rows.append(x)
    return torch.stack(rows), np.array(edge)
