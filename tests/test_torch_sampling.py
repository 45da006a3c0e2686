"""The port's sampled decoding against the JAX package's, on the CPU.

``sample_or_argmax`` over a grid of temperatures {0, 0.5, 1, 1.5}, top-k
{0, 1, 50, V} and top-p {1, 0.9, 0.5, 1e-6}, several seeds and positions
each, with greedy and sampled rows mixed in one batch, tied logits and rows
holding ``-inf`` entries. Greedy rows are bitwise the JAX package's tokens.
A sampled row must equal its token wherever the top-2 margin of ``gumbel +
x`` (x the shaped logits) exceeds 1e-4 and no token sits within 1e-6 of
the nucleus edge (``cumsum - probs`` against ``top_p``, a sum whose order
differs between XLA and torch); fewer than 1% of the draws may be excluded.

The host-side records: ``SamplingParams`` (its validation errors, ``child``
and the dict round trip), ``derive_child_seed``, ``StopScanner`` and
``combined_bias`` equal to ``deepspeed_tpu.serve.sampling``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.transformer import sample_or_argmax as jax_sample
from deepspeed_tpu.serve import sampling as jsp
from deepspeed_tpu_torch.models import sample_or_argmax
from deepspeed_tpu_torch.serve import sampling as tsp
from deepspeed_tpu_torch.utils import prng
from tests.test_torch_prng import MARGIN, masked_rows

V = 512
TEMPS = (0.0, 0.5, 1.0, 1.5)
TOP_KS = (0, 1, 50, V)
TOP_PS = (1.0, 0.9, 0.5, 1e-6)


def _grid(reps=3, seed=0):
    rng = np.random.default_rng(seed)
    combos = [(t, k, p) for t in TEMPS for k in TOP_KS for p in TOP_PS] * reps
    R = len(combos) + 3
    lg = (rng.standard_normal((R, V)) * 3).astype(np.float32)
    lg[-3, :] = 1.0          # every logit tied
    lg[-2, 5:] = -np.inf     # only 5 finite entries
    lg[-1, ::2] = -np.inf    # half masked
    extra = [(1.0, 0, 1.0), (0.7, 50, 0.9), (0.0, 0, 1.0)]
    temps, top_ks, top_ps = (np.array(c, dt) for c, dt in zip(
        zip(*(combos + extra)), (np.float32, np.int32, np.float32)))
    seeds = rng.integers(0, 2**31 - 1, R).astype(np.int32)
    pos = rng.integers(0, 4097, R).astype(np.int32)
    return lg, seeds, pos, temps, top_ks, top_ps


def _compare(lg, seeds, pos, temps, top_ks, top_ps):
    want = np.asarray(jax.jit(jax_sample)(jnp.asarray(lg), seeds, pos, temps, top_ks, top_ps))
    got = sample_or_argmax(torch.from_numpy(lg), seeds, pos, temps, top_ks, top_ps)
    assert got.dtype == torch.int32
    got = got.numpy()
    greedy = temps == 0
    assert np.array_equal(got[greedy], want[greedy])
    x, edge = masked_rows(torch.from_numpy(lg), temps, top_ks, top_ps)
    keys = prng.fold_in(prng.PRNGKey(torch.from_numpy(seeds)), torch.from_numpy(pos))
    top2 = (prng.gumbel(keys, (lg.shape[1],)) + x).topk(2, dim=-1).values.numpy()
    clear = ~greedy & ~edge & ((top2[:, 0] - top2[:, 1]) > MARGIN)
    assert np.array_equal(got[clear], want[clear])
    excluded = int((~greedy).sum() - clear.sum())
    assert excluded <= 0.01 * int((~greedy).sum()), excluded
    return got


def test_grid_matches_jax():
    got = _compare(*_grid())
    assert 0 <= got[-3] < V and got[-2] < 5 and got[-1] % 2 == 1  # masked entries never drawn


def test_all_greedy_batch_is_argmax():
    lg, seeds, pos, temps, top_ks, top_ps = _grid()
    temps = np.zeros_like(temps)
    got = _compare(lg, seeds, pos, temps, top_ks, top_ps)
    assert np.array_equal(got, np.asarray(jnp.argmax(jnp.asarray(lg), -1)))
    # temps=None: every row greedy, the first index on ties
    assert np.array_equal(sample_or_argmax(torch.from_numpy(lg)).numpy(), got)


@pytest.mark.parametrize("seed", [1, 2])
def test_replayed_key_draws_the_same_token(seed):
    lg, seeds, pos, temps, top_ks, top_ps = _grid(reps=1, seed=seed)
    a = sample_or_argmax(torch.from_numpy(lg), seeds, pos, temps, top_ks, top_ps)
    perm = np.random.default_rng(seed).permutation(len(lg))
    b = sample_or_argmax(torch.from_numpy(lg[perm]), seeds[perm], pos[perm], temps[perm],
                         top_ks[perm], top_ps[perm])
    assert torch.equal(a[perm], b)  # a row's draw depends on its own key only


@pytest.mark.parametrize("kwargs,match", [
    (dict(temperature=-1.0), "temperature"),
    (dict(temperature=float("inf")), "temperature"),
    (dict(top_k=-1), "top_k"),
    (dict(top_p=0.0), "top_p"),
    (dict(top_p=1.5), "top_p"),
    (dict(seed=-1), "seed"),
    (dict(seed=2**31), "seed"),
    (dict(n=0), "n must"),
    (dict(n=3, best_of=2), "best_of"),
    (dict(stop=[()]), "empty stop"),
    (dict(logit_bias={-1: 1.0}), "logit_bias"),
])
def test_sampling_params_validation_matches_jax(kwargs, match):
    for mod in (jsp, tsp):
        with pytest.raises(ValueError, match=match):
            mod.SamplingParams(**kwargs)


def test_sampling_params_child_and_round_trip():
    kw = dict(temperature=0.7, top_k=40, top_p=0.9, seed=12345, n=3, best_of=4,
              stop=[5, (7, 8)], logit_bias={3: 2.0, 1: -1.5})
    j, t = jsp.SamplingParams(**kw), tsp.SamplingParams(**kw)
    assert t.to_dict() == j.to_dict()
    assert t.stop == j.stop == ((5,), (7, 8))
    assert tsp.SamplingParams.from_dict(t.to_dict()) == t
    for i in range(4):
        assert t.child(i).to_dict() == j.child(i).to_dict()
        assert tsp.derive_child_seed(12345, i) == jsp.derive_child_seed(12345, i)
    assert t.child(0).seed == t.seed and t.child(1).n == 1
    for p in (t, tsp.SamplingParams(), tsp.SamplingParams(stop=[3]),
              tsp.SamplingParams(logit_bias={1: 1.0})):
        q = jsp.SamplingParams.from_dict(p.to_dict())
        assert (p.is_greedy, p.needs_engine, p.dynamic) == (q.is_greedy, q.needs_engine,
                                                            q.dynamic)


def test_stop_scanner_matches_jax():
    rng = np.random.default_rng(3)
    stops = [(4,), (1, 2, 3), (2, 2)]
    toks = rng.integers(0, 6, 400).tolist()
    for history in ([], [1, 2], [9, 2]):
        j, t = jsp.StopScanner(stops, history=history), tsp.StopScanner(stops, history=history)
        assert [t.push(x) for x in toks] == [j.push(x) for x in toks]
    assert tsp.StopScanner([]).push(1) == 0


def test_combined_bias_matches_jax():
    class Proc:
        dynamic = True

        def __call__(self, ctx, vocab):
            m = np.zeros(vocab, np.float32)
            m[len(ctx) % vocab] = -np.inf
            return m

    kw = dict(temperature=0.5, seed=1, logit_bias={3: 2.5, 7: -1.0})
    for procs in ((), (Proc(),), (Proc(), lambda ctx, v: None)):
        j = jsp.combined_bias(jsp.SamplingParams(processors=procs, **kw), 16, [1, 2, 3])
        t = tsp.combined_bias(tsp.SamplingParams(processors=procs, **kw), 16, [1, 2, 3])
        assert np.array_equal(j, t)
    assert tsp.combined_bias(tsp.SamplingParams(), 16) is None
    assert tsp.SamplingParams(processors=(Proc(),)).dynamic
    with pytest.raises(ValueError, match="vocab size"):
        tsp.combined_bias(tsp.SamplingParams(logit_bias={20: 1.0}), 16)
    with pytest.raises(ValueError, match="shape"):
        tsp.combined_bias(tsp.SamplingParams(processors=(lambda c, v: np.zeros(3),)), 16)
