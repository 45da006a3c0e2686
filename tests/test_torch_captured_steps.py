"""The engine's step programs: counters, staged inputs and captured graphs.

On the CPU: the step-program counters (``ragged_cache_size``,
``fused_cache_size``, ``verify_cache_size``) equal the JAX package's trace
counts over a workload that reaches every key; the sampling keys staged on
the host are ``jax.random``'s bit for bit (K positions a row); ``rebuild``
keeps the pools a graph holds in place; ``load_params`` serves the new
weights as the JAX package's does and writes no tree it was given, so a
swap back serves the first weights again. The ``cuda``-marked tests hold
captured steps against eager ones bitwise at every key (greedy, sampled,
logits, fused, verify, dispatch), with equal launch counts, and replays
after ``rebuild`` and re-captures after ``load_params``
(``python -m pytest --noconftest -m cuda tests/test_torch_captured_steps.py``
on the card).
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch.serve as ts
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.models import build_model
from deepspeed_tpu_torch.models.transformer import row_keys
from deepspeed_tpu_torch.ops.quantizer import woq_gemm
from deepspeed_tpu_torch.ops.transformer import paged_attention
from deepspeed_tpu_torch.resilience.errors import EngineUsageError
from deepspeed_tpu_torch.utils import prng

try:  # the CPU half compares with the JAX package, which the card lacks
    import jax

    import deepspeed_tpu.serve as js
    from deepspeed_tpu_torch.models import params_from_jax
    from tests.test_torch_fused_decode import (ENGINE, engine, models,  # noqa: F401
                                               one_torch_thread, prompts)
except ImportError:  # pragma: no cover - the card
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="compares with the JAX package")


def _workload(eng, kind):
    """Every ragged key (budget and decode-round rows, logits and tokens),
    a sampled row, a fused step and a verify step."""
    pkg = js if kind == "jax" else ts
    p1, p2, p3 = prompts()
    lg = eng.put([1], [p1])  # budget rows, logits
    eng.set_sampling(2, pkg.SamplingParams(temperature=0.7, top_k=20, seed=3))
    first = eng.put([2, 3], [p2, p3], greedy=True)  # budget rows, tokens
    t1 = int(np.argmax(lg[1]))
    dec = eng.decode_step({1: t1, **first}, greedy=True)  # decode-round rows
    dlg = eng.decode_step({u: 5 for u in dec})  # decode-round rows, logits
    fused = eng.decode_multi({u: 7 for u in dlg}, 4)
    for u in fused:
        eng.rollback(u, 1)
    ver = eng.verify_multi({u: s[-1] for u, s in fused.items()}, {1: [4, 5], 2: [6]})
    for u, s in ver.items():
        eng.rollback(u, 4 - len(s))
    return ([float(np.abs(lg[1]).sum())], first, dec, fused, ver,
            (eng.ragged_cache_size, eng.fused_cache_size, eng.verify_cache_size))


@needs_jax
def test_counters_match_jax_trace_counts(models):
    j = _workload(engine("jax", models, decode_horizon=4), "jax")
    eng = engine("torch", models, decode_horizon=4)
    t = _workload(eng, "torch")
    assert t[-1] == j[-1] == (4, 1, 1)
    assert t[1:-1] == j[1:-1]
    np.testing.assert_allclose(t[0], j[0], rtol=1e-5)
    assert eng.captured_graphs == 0  # eager on the CPU
    assert sorted(eng._scratch) == [("fused", 4, 4), ("ragged", 4), ("ragged", 16),
                                    ("verify", 4, 4)]


@needs_jax
def test_capture_off_is_the_same_eager_path(models):
    a = _workload(engine("torch", models, decode_horizon=4), "torch")
    b = _workload(engine("torch", models, decode_horizon=4, capture=False), "torch")
    assert a == b


@needs_jax
@pytest.mark.parametrize("K", [1, 4])
def test_staged_keys_are_jax_fold_in_keys(models, K):
    """The keys the fused program reads for positions starts+1 .. starts+K
    are ``jax.random.fold_in(PRNGKey(seed), pos)``'s words."""
    eng = engine("torch", models, decode_horizon=4)
    eng.set_sampling(1, ts.SamplingParams(temperature=0.9, seed=2**31 - 5))
    eng.put([1], [prompts(1)[0]], greedy=True)
    d = eng.state.seqs[1]
    start = d.seen_tokens
    out = eng.decode_multi({1: 3}, 4) if K == 4 else eng.decode_step({1: 3}, greedy=True)
    assert out
    prog = eng._scratch[("fused", 4, 4)] if K == 4 else eng._scratch[("ragged", 4)]
    keys = prog.views[-1]
    row = keys[:, 0] if K == 4 else keys[:1]
    want = np.stack([np.asarray(jax.random.key_data(jax.random.fold_in(
        jax.random.PRNGKey(2**31 - 5), start + j + 1))) for j in range(K)])
    assert np.array_equal(row.view(np.uint32), want.astype(np.uint32))
    got = row_keys(np.full(K, 2**31 - 5, np.int32), start + 1 + np.arange(K, dtype=np.int32))
    assert torch.equal(got, prng.fold_in(prng.PRNGKey(2**31 - 5),
                                         torch.arange(start + 1, start + 1 + K)))


@needs_jax
def test_rebuild_keeps_the_pools_in_place(models):
    eng = engine("torch", models)
    ptrs = [t.data_ptr() for t in (*eng.kv, eng._bias_pool)]
    eng.set_sampling(1, ts.SamplingParams(seed=1), bias_row=np.ones(128, np.float32))
    first = eng.put([1], [prompts(1)[0]], greedy=True)
    eng.rebuild()
    assert [t.data_ptr() for t in (*eng.kv, eng._bias_pool)] == ptrs
    assert all(float(t.abs().sum()) == 0.0 for t in (*eng.kv, eng._bias_pool))
    eng.set_sampling(1, ts.SamplingParams(seed=1), bias_row=np.ones(128, np.float32))
    assert eng.put([1], [prompts(1)[0]], greedy=True) == first


def _leaves(tree):
    return [v.clone() if isinstance(v, torch.Tensor) else _leaves(v) for v in tree.values()]


def _same(a, b):
    return all(_same(x, y) if isinstance(x, list) else torch.equal(x, y) for x, y in zip(a, b))


@needs_jax
def test_load_params_swaps_in_place_and_matches_jax(models):
    """The swap serves the new weights (the JAX engine's tokens and a fresh
    engine's), writes neither tree, and a swap back serves the first
    weights again (v0 -> v1 -> v0)."""
    jm, params, tm, tparams = models
    new = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(1)))
    tnew = params_from_jax(new)
    kept = (_leaves(tparams), _leaves(tnew))
    je, te = engine("jax", models), engine("torch", models)
    v0 = {}
    for eng in (je, te):
        v0[eng is te] = eng.put([1], [prompts(1)[0]], greedy=True)
    with pytest.raises(EngineUsageError, match="resident"):
        te.load_params(tnew)
    out = {}
    for eng, tree in ((je, new), (te, tnew)):
        eng.flush(1)
        eng.load_params(tree, version="v1")
        assert eng.weights_version == "v1" and eng.block_mgr.cached_blocks == 0
        out[eng is te] = eng.put([2], [prompts(1)[0]], greedy=True)
    assert out[True] == out[False] and out[True] != v0[True]
    fresh = InferenceEngineV2(tm, tnew, device="cpu", **ENGINE)
    assert fresh.put([2], [prompts(1)[0]], greedy=True) == out[True]
    assert _same(_leaves(tparams), kept[0]) and _same(_leaves(tnew), kept[1])
    for eng, tree in ((je, params), (te, tparams)):  # back to v0
        eng.flush(2)
        eng.load_params(tree, version="v0")
        assert eng.put([3], [prompts(1)[0]], greedy=True) == {3: v0[eng is te][1]}
    assert _same(_leaves(tparams), kept[0]) and _same(_leaves(tnew), kept[1])
    te.flush(3)
    bad = params_from_jax(new)
    bad["blocks"]["wq"] = bad["blocks"]["wq"][:, :8]
    with pytest.raises(ValueError, match="shape"):
        te.load_params(bad)
    del bad["blocks"]["wq"]
    with pytest.raises(ValueError, match="structure"):
        te.load_params(bad)


def test_every_wrapper_registers_its_launch_counters():
    """The engine adds a replay's launches to every registered counter, so
    every kernel wrapper's counters must be registered."""
    from deepspeed_tpu_torch.ops import launch_counters
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse_kernel
    from deepspeed_tpu_torch.ops.transformer import flash_attention, fused_ce

    names = launch_counters.names()
    for mod, counters in ((paged_attention, ("launches",)),
                          (woq_gemm, ("launches", "tiled_launches")),
                          (flash_attention, ("fwd_launches", "bwd_launches")),
                          (fused_ce, ("fwd_launches", "bwd_launches")),
                          (block_sparse_kernel, ("fwd_launches", "bwd_launches"))):
        for c in counters:
            assert f"{mod.__name__}.{c}" in names
    before = launch_counters.snapshot()
    launch_counters.add([1] * len(before))
    assert woq_gemm.tiled_launches == before[names.index(f"{woq_gemm.__name__}.tiled_launches")] + 1
    launch_counters.add([-1] * len(before))
    assert launch_counters.snapshot() == before


@needs_jax
def test_dispatch_handle_fetches_once(models):
    eng = engine("torch", models)
    t = int(eng.put([1, 2], prompts(2), greedy=True)[1])
    h = eng.decode_dispatch({1: t, 2: 9})
    assert eng._undrained_dispatch is h and h.uids == [1, 2] and h.span == 1
    first = h.fetch()
    assert eng._undrained_dispatch is None and h.fetch() is first
    eng.rebuild()
    assert eng._undrained_dispatch is None


# --------------------------------------------------------------------------
# on the card: captured against eager
# --------------------------------------------------------------------------
CARD_MODEL = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
                  intermediate_size=512, max_seq_len=256)
CARD_ENGINE = dict(max_seqs=4, max_seq_len=256, prefill_chunk=32, block_size=16,
                   token_budget=32, num_blocks=80, paged=True, decode_horizon=4)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: captures the engine's step graphs")
    m = build_model("llama-tiny", **CARD_MODEL)
    params = m.init_params(torch.Generator(device="cuda").manual_seed(0))
    return m, params


def _card_workload(eng):
    rng = np.random.default_rng(0)
    ps = [rng.integers(0, 512, n).tolist() for n in (40, 33, 21)]
    eng.set_sampling(2, ts.SamplingParams(temperature=0.8, top_k=50, top_p=0.9, seed=4))
    out = [eng.put([1], [ps[0]])[1].tobytes(), eng.put([2, 3], ps[1:], greedy=True)]
    toks = {1: 11, **out[-1]}
    for _ in range(3):  # the decode round, twice each variant: capture then replay
        toks = eng.decode_step(toks, greedy=True)
        out.append(toks)
    for _ in range(2):
        f = eng.decode_multi(toks, 4)
        for u in f:
            eng.rollback(u, 0)
        toks = {u: s[-1] for u, s in f.items()}
        out.append(f)
    for _ in range(2):
        v = eng.verify_multi(toks, {1: [3, 4, 5], 3: [6]})
        for u, s in v.items():
            eng.rollback(u, 4 - len(s))
        toks = {u: s[-1] for u, s in v.items()}
        out.append(v)
    for _ in range(2):
        h = eng.decode_dispatch(toks)
        toks = h.fetch()
        for u in toks:
            eng.commit_step(u)
        out.append(toks)
    out.append(eng.decode_step({u: 1 for u in toks})[1].tobytes())
    return out


def _launches():
    return paged_attention.launches, woq_gemm.launches


@pytest.mark.cuda
def test_cuda_captured_matches_eager_bitwise(card):
    m, params = card
    runs = {}
    for capture in (False, True):
        eng = InferenceEngineV2(m, params, device="cuda", capture=capture, **CARD_ENGINE)
        before = _launches()
        runs[capture] = (_card_workload(eng), [a - b for a, b in zip(_launches(), before)],
                         eng.ragged_steps, eng.captured_graphs,
                         (eng.ragged_cache_size, eng.fused_cache_size, eng.verify_cache_size))
    eager, captured = runs[False], runs[True]
    assert captured[0] == eager[0]
    assert captured[1] == eager[1] and captured[2] == eager[2]
    assert captured[4] == eager[4] == (4, 1, 1)
    assert eager[3] == 0 and captured[3] >= 6


@pytest.mark.cuda
def test_cuda_replay_after_rebuild_and_load_params(card):
    """Replays after ``rebuild`` are bitwise the first run; after
    ``load_params`` every graph is captured again and serves the new
    weights (an eager engine's tokens), the trees stay as they were, and a
    swap back replays the first run bitwise."""
    m, params = card
    kept = _leaves(params)
    eng = InferenceEngineV2(m, params, device="cuda", **CARD_ENGINE)
    first = _card_workload(eng)
    graphs = eng.captured_graphs
    eng.rebuild()
    assert _card_workload(eng) == first and eng.captured_graphs == graphs
    assert eng.graph_captures == graphs
    new = m.init_params(torch.Generator(device="cuda").manual_seed(1))
    kept_new = _leaves(new)
    eng.rebuild()
    eng.load_params(new)
    assert eng.captured_graphs == 0
    swapped = _card_workload(eng)
    assert eng.captured_graphs == graphs and eng.graph_captures == 2 * graphs
    assert (eng.ragged_cache_size, eng.fused_cache_size, eng.verify_cache_size) == (4, 1, 1)
    ref = InferenceEngineV2(m, new, device="cuda", capture=False, **CARD_ENGINE)
    assert _card_workload(ref) == swapped != first
    assert _same(_leaves(params), kept) and _same(_leaves(new), kept_new)
    eng.rebuild()
    eng.load_params(params)
    assert _card_workload(eng) == first
