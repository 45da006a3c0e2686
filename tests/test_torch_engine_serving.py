"""The port's paged engine, the calls the scheduler makes of it, against the
JAX package's engine on the CPU (fp32, ``params_from_jax`` weights, the
engine geometry and prompts of ``test_torch_engine_v2.py``).

- ``put(max_steps=0)`` registers (the prefix-cache lookup runs) and
  dispatches nothing; ``max_steps=1`` / ``N`` run at most that many ragged
  steps; ``None`` drains. ``prefill_backlog`` follows the same numbers in
  both packages, and every logit row returned is allclose at atol 1e-4.
- ``monitor_events``: the prefix-cache events equal the JAX engine's, and
  so do the ``serve/transfer/*`` labels and byte counters (the bandwidth
  gauges read the wall clock).
- ``set_sampling``/``refresh_bias``: sampled rows, a static bias row and a
  per-step refreshed one, each engine fed its own tokens: the streams equal
  the JAX engine's token for token; a zero bias leaves greedy tokens
  unchanged.
- ``rebuild``: fresh state and pool of the same geometry, the same
  counters as the JAX engine's, and the same tokens served again.
- ``prefix_probe``, ``set_kv_owner``/``set_kv_quota``: equal probes and
  owner views.
"""

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu.serve import SamplingParams as JaxSP
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.models import build_model, params_from_jax
from deepspeed_tpu_torch.serve import SamplingParams

MODEL = ("llama-tiny", dict(vocab_size=256, hidden_size=128, num_layers=2,
                            num_heads=2, num_kv_heads=1, intermediate_size=256,
                            max_seq_len=256))
ENGINE = dict(max_seqs=4, max_seq_len=256, prefill_chunk=32, paged=True,
              block_size=16, token_budget=32, prefix_cache=True)
_rng = np.random.default_rng(0)
P1 = _rng.integers(0, 256, 32).tolist()
P2 = _rng.integers(0, 256, 70).tolist()
P3 = _rng.integers(0, 256, 45).tolist()


@pytest.fixture(scope="module")
def models():
    jm = jax_build_model(MODEL[0], **MODEL[1])
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    return jm, params, build_model(MODEL[0], **MODEL[1]), params_from_jax(params)


def pair(models, **kw):
    jm, params, tm, tparams = models
    opts = dict(ENGINE, **kw)
    return (JaxEngine(jm, params, dtype=np.float32, **opts),
            InferenceEngineV2(tm, tparams, dtype=torch.float32, device="cpu", **opts))


def _close(a, b):
    assert sorted(a) == sorted(b)
    for u in a:
        np.testing.assert_allclose(b[u], a[u], atol=1e-4, rtol=0)


def test_put_max_steps_and_prefill_backlog(models):
    je, te = pair(models)
    for eng in (je, te):
        assert eng.put([1, 2], [P2, P1], max_steps=0) == {}
    assert te.prefill_backlog() == je.prefill_backlog() == len(P1) + len(P2)
    assert te.ragged_steps == 0
    for steps in (1, 1, 2, None):
        out_j = je.put([], [], max_steps=steps)
        out_t = te.put([], [], max_steps=steps)
        _close(out_j, out_t)
        assert te.prefill_backlog() == je.prefill_backlog()
    assert te.prefill_backlog() == 0 and te.ragged_steps == 4
    # a third prompt arrives while 1 and 2 decode: one step advances all
    toks = {1: 7, 2: 9}
    for eng in (je, te):
        eng.put([3], [P3], max_steps=0)
    out_j = je.put([1, 2], [[toks[1]], [toks[2]]], max_steps=1)
    out_t = te.put([1, 2], [[toks[1]], [toks[2]]], max_steps=1)
    _close(out_j, out_t)
    assert sorted(out_t) == [1, 2] and te.prefill_backlog() == je.prefill_backlog() > 0
    for u in (1, 2, 3):
        assert te.block_mgr.table_row(te.state.seqs[u]).tolist() == \
            je.block_mgr.table_row(je.state.seqs[u]).tolist()


def test_monitor_events_match_jax(models):
    je, te = pair(models)
    for eng in (je, te):
        eng.put([1], [P1], greedy=True)
        eng.put([2], [P1 + P3[:5]], greedy=True)  # a prefix hit
        eng.flush(1)
    jall, tall = je.monitor_events(step=5), te.monitor_events(step=5)
    assert [e[0] for e in tall] == [e[0] for e in jall]
    jev = [e for e in jall if not e[0].endswith("_bytes_per_s")]
    assert [e for e in tall if not e[0].endswith("_bytes_per_s")] == jev
    assert dict((k, v) for k, v, _ in jev)["inference/prefix_cache/hits"] >= 1
    assert te.prefix_cache_stats() == je.prefix_cache_stats()


class Proc:
    """A dynamic processor masking the context's last token."""
    dynamic = True

    def __call__(self, ctx, vocab):
        row = np.zeros(vocab, np.float32)
        row[ctx[-1]] = -np.inf
        return row


def _sampled_run(eng, sp_cls, steps=8):
    """Two sampled rows (one biased), one greedy: prefill, then decode in
    lockstep on the engine's own tokens; ``refresh_bias`` each step."""
    sp_a = sp_cls(temperature=0.8, top_k=40, top_p=0.9, seed=3)
    sp_b = sp_cls(temperature=1.2, seed=4, logit_bias={11: 5.0})
    eng.set_sampling(1, sp_a)
    eng.set_sampling(2, sp_b, bias_row=np.where(np.arange(256) == 11, 5.0, 0.0))
    out = eng.put([1, 2, 3], [P1, P2, P3], greedy=True)
    streams = {u: [out[u]] for u in out}
    for _ in range(steps):
        feed = {u: s[-1] for u, s in streams.items()}
        row = Proc()(P1 + streams[1], 256)
        eng.refresh_bias(1, row)
        out = eng.decode_step(feed, greedy=True)
        for u in out:
            streams[u].append(int(out[u]))
    return streams


def test_sampling_and_bias_pool_match_jax(models):
    je, te = pair(models)
    js = _sampled_run(je, JaxSP)
    ts = _sampled_run(te, SamplingParams)
    assert ts == js
    assert ts[1] != _greedy_stream(models)  # the sampled row is not argmax
    assert all(t != p for t, p in zip(ts[1][1:], ts[1]))  # the processor's mask held
    assert te._bias_slots and te._bias_pool.abs().sum() > 0
    for u in (1, 2, 3):
        te.flush(u)
    assert not te._bias_slots and float(te._bias_pool.abs().sum()) == 0.0
    assert not te._sampling


def _greedy_stream(models, steps=8):
    _, te = pair(models)
    out = te.put([1], [P1], greedy=True)
    s = [out[1]]
    for _ in range(steps):
        s.append(int(te.decode_step({1: s[-1]}, greedy=True)[1]))
    return s


def test_zero_bias_and_greedy_params_leave_argmax_unchanged(models):
    _, te = pair(models)

    class Greedy:
        seed, temperature, top_k, top_p = 9, 0.0, 0, 1.0

    te.set_sampling(1, Greedy(), bias_row=np.zeros(256, np.float32))
    out = te.put([1], [P1], greedy=True)
    s = [out[1]]
    for _ in range(8):
        s.append(int(te.decode_step({1: s[-1]}, greedy=True)[1]))
    assert s == _greedy_stream(models)


def test_rebuild_matches_jax(models):
    je, te = pair(models)
    first = {}
    for eng in (je, te):
        eng.set_sampling(2, JaxSP(temperature=0.9, seed=1) if eng is je
                         else SamplingParams(temperature=0.9, seed=1))
        first[eng is te] = eng.put([1, 2], [P1, P2], greedy=True)
        eng.rebuild()
        assert eng.rebuilds == 1 and not eng.state.seqs and eng.prefill_backlog() == 0
        assert eng.block_mgr.free_blocks == eng.block_mgr.num_blocks - 1
    assert first[True] == first[False]
    assert te.prefix_cache_stats() == je.prefix_cache_stats()
    assert [tuple(a.shape) for a in te.kv] == [tuple(a.shape) for a in je.kv]
    # the rebuilt engine serves the same tokens again (the sampled row
    # re-registered, as a scheduler's replay does)
    te.set_sampling(2, SamplingParams(temperature=0.9, seed=1))
    assert te.put([1, 2], [P1, P2], greedy=True) == first[True]


def test_prefix_probe_and_owner_quotas_match_jax(models):
    je, te = pair(models)
    for eng in (je, te):
        eng.set_kv_owner(1, "a")
        eng.set_kv_owner(2, "b")
        eng.set_kv_quota("a", 1)
        eng.put([1, 2], [P2, P3], greedy=True)
        eng.flush(1)
        eng.flush(2)
    for toks in (P2, P3, P2[:40], P1, []):
        assert te.prefix_probe(toks) == je.prefix_probe(toks)
    assert te.block_mgr.owner_view() == je.block_mgr.owner_view()
    assert te.block_mgr.owner_view()["a"]["at_rest"] <= 1
    for eng in (je, te):
        eng.set_kv_quota("a", None)
    assert te.block_mgr.owner_view() == je.block_mgr.owner_view()
    _, off = pair(models, prefix_cache=False)
    assert off.prefix_probe(P2) == 0
