"""The port's paged ``InferenceEngineV2`` against the JAX package's, on the CPU.

The scenario of ``examples/serve_paged.py``: two prompts prefilled in chunks
over several token budgets, decode rounds, a request arriving mid-stream
whose prompt equals an earlier one (a full-prompt prefix hit, so a
copy-on-write block copy). Logits from ``put``/``decode_step`` with
``greedy=False`` match at atol 1e-4 (both fp32) with the tokens fed in
lockstep; greedy token streams are identical wherever the top-2 logit
margin exceeds 1e-3. The JAX side runs its default attention, and once more
through its Pallas paged kernel in interpret mode.
"""

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.models import build_model, params_from_jax
from tests.torch_checked import checked_mode  # noqa: F401  (autouse: checked mode)

MODEL = ("llama-tiny", dict(vocab_size=256, hidden_size=128, num_layers=2,
                            num_heads=2, num_kv_heads=1, intermediate_size=256,
                            max_seq_len=256))
ENGINE = dict(max_seqs=4, max_seq_len=256, prefill_chunk=32, paged=True,
              block_size=16, token_budget=32, prefix_cache=True)
_rng = np.random.default_rng(0)
P1 = _rng.integers(0, 256, 32).tolist()   # two full blocks: a repeat is a full hit
P2 = _rng.integers(0, 256, 70).tolist()   # several budgets of prefill


@pytest.fixture(scope="module")
def models():
    jm = jax_build_model(MODEL[0], **MODEL[1])
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    return jm, params, build_model(MODEL[0], **MODEL[1]), params_from_jax(params)


def jax_engine(models):
    jm, params, _, _ = models
    return JaxEngine(jm, params, dtype=np.float32, **ENGINE)


def torch_engine(models):
    _, _, tm, tparams = models
    return InferenceEngineV2(tm, tparams, dtype=torch.float32, device="cpu", **ENGINE)


def scenario(eng, greedy, choices=None):
    """Returns (records, choices): every put/decode_step result in order and
    the token fed for each (step, uid). ``choices`` replays another run's."""
    records, made = [], []
    it = iter(choices or ())

    def choose(out):
        toks = {u: (int(v) if greedy else int(np.argmax(v))) for u, v in sorted(out.items())}
        if choices is not None:
            toks = next(it)
        made.append(toks)
        return dict(toks)

    out = eng.put([1, 2], [P1, P2], greedy=greedy)
    records.append(out)
    for step in range(8):
        toks = choose(out)
        if step == 3:  # arrival mid-stream, same prompt as uid 1
            arrived = eng.put([3], [P1], greedy=greedy)
            records.append(arrived)
            toks.update(choose(arrived))
        out = eng.decode_step(toks, greedy=greedy)
        records.append(out)
    return records, made


def assert_logits_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for uid in w:
            np.testing.assert_allclose(g[uid], np.asarray(w[uid], np.float32),
                                       atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def jax_logits_run(models):
    return scenario(jax_engine(models), greedy=False)


def test_put_logits_match_jax(models, jax_logits_run):
    jrec, jchoices = jax_logits_run
    eng = torch_engine(models)
    trec, _ = scenario(eng, greedy=False, choices=jchoices)
    assert_logits_match(trec, jrec)
    stats = eng.prefix_cache_stats()
    assert stats["hits"] >= 1 and stats["cow_copies"] >= 1


def test_put_logits_match_jax_pallas_kernel(models, monkeypatch):
    monkeypatch.setenv("DSTPU_FORCE_PAGED_KERNEL", "1")
    jrec, jchoices = scenario(jax_engine(models), greedy=False)
    trec, _ = scenario(torch_engine(models), greedy=False, choices=jchoices)
    assert_logits_match(trec, jrec)


def test_greedy_streams_match_jax(models, jax_logits_run):
    jrec, _ = jax_logits_run
    # decisions in scenario order, with the JAX top-2 margin behind each
    margins = []
    for rec in jrec[:-1]:
        margins.append(min(float(np.diff(np.sort(v)[-2:])[0]) for v in rec.values()))
    _, jg = scenario(jax_engine(models), greedy=True)
    _, tg = scenario(torch_engine(models), greedy=True)
    n = next((i for i, m in enumerate(margins) if m <= 1e-3), len(margins))
    assert len(tg) == len(jg) == len(margins) and n > 0
    assert tg[:n] == jg[:n]


def test_block_tables_and_stats_match_jax(models, jax_logits_run):
    _, jchoices = jax_logits_run
    je, te = jax_engine(models), torch_engine(models)
    scenario(je, greedy=False)
    scenario(te, greedy=False, choices=jchoices)
    for uid, jd in je.state.seqs.items():
        td = te.state.seqs[uid]
        assert (td.blocks, td.seen_tokens, td.history) == (jd.blocks, jd.seen_tokens,
                                                           jd.history)
    js, ts = je.prefix_cache_stats(), te.prefix_cache_stats()
    assert ts == {k: js[k] for k in ts}
    assert te.query() == je.query() and te.can_schedule(1) == je.can_schedule(1)
    free0 = te.block_mgr.num_blocks - 1
    for uid in (1, 2, 3):
        assert te.preempt(uid) == je.preempt(uid)
    te.flush(1)  # idempotent: a counted no-op
    assert te.flush_noops == 1 and te.block_mgr.free_blocks == free0


@pytest.mark.parametrize("kwargs,item", [
    (dict(nvme_tier_blocks=4, nvme_tier_dir="nvme"), "item 9"),
    (dict(paged=False), "item 5c"),
    (dict(host_tier_blocks=4), "item 9"),
])
def test_unported_options_raise_naming_roadmap_item(models, kwargs, item):
    # ported since: slot mode (item 5c) and the KV tiers (item 9) construct,
    # gated as the JAX engine gates them (the NVMe tier needs the host tier)
    jm, params, tm, tparams = models
    opts = dict(ENGINE, **kwargs)
    je = JaxEngine(jm, params, dtype=np.float32, **opts)
    te = InferenceEngineV2(tm, tparams, device="cpu", **opts)
    for attr in ("paged", "max_seqs", "prefix_cache", "host_tier_blocks", "nvme_tier_blocks",
                 "block_bytes"):
        assert getattr(te, attr) == getattr(je, attr), (item, attr)
    assert (te.transfer.nvme is None) == (je.transfer.nvme is None)


def test_sampling_with_temperature_raises(models):
    eng = torch_engine(models)

    class Greedy:
        seed, temperature, top_k, top_p = 7, 0.0, 0, 1.0

    class Sampled(Greedy):
        temperature = 0.8

    eng.set_sampling(1, Greedy())
    # a temperature is taken since threefry sampling was ported; swap_out,
    # ported since, declines without a host tier (the caller replays)
    eng.set_sampling(2, Sampled())
    assert eng._sampling[2].temperature == 0.8
    assert eng.swap_out(1) is False


def test_deleted_engine_is_freed_without_the_garbage_collector(models):
    # no reference cycle through the engine: its pool and weights leave the
    # device as soon as the last reference goes, as a serving loop that
    # swaps engines needs
    import gc
    import weakref

    eng = torch_engine(models)
    eng.put([1], [P1], greedy=True)
    ref = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        assert ref() is None
    finally:
        gc.enable()
