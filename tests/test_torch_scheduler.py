"""The port's ``ContinuousBatchScheduler`` over its paged engine against the
JAX package's, on the CPU.

Both packages get the same fp32 weights (``params_from_jax``), the same
engine geometry, one fake clock each (a millisecond a read), no backoff
sleeps, and the same scripted requests with explicit uids. Token streams
must be equal, and so must every counter the schedulers report (the
``serve/*`` events, prefill/decode/sampling/fault counters, preemptions,
prefix-cache hits, request states), except the wall-clock latencies and the
``serve/transfer/*`` events (the TransferEngine's bandwidth, which reads the
wall clock). A stream that differs must do so first at a
draw whose top-2 margin is under 1e-4 (for a sampled row the margin of
``gumbel + x``, x the shaped logits, or a token within 1e-6 of the nucleus
edge), recomputed from the port's logits at that position; such draws are
counted and must stay under 1% of a test's draws, and counters are compared
only for runs whose streams agree. Within the port, the chunked and
monolithic schedules and a preempted run against its uncontended twin are
held bitwise equal.

Scenarios: chunked prefill with live decoders, the chunked/monolithic A/B,
priority preemption and re-admission (greedy and sampled), sampled streams,
stop sequences, logit bias, fan-out and a dynamic logit processor, cancel,
deadline expiry and queue-full backpressure, engine loss through a stub that
raises ``UnrecoverableEngineError`` once, two tenants with cache quotas, the
options once unported (swap, KV tiers, slot mode; their scenarios are in
``tests/test_torch_slot_engine.py`` and ``tests/test_torch_kv_tier.py``), and
``DSTPU_SANITIZE=1``.
"""

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu.resilience.errors as jerr
import deepspeed_tpu.serve as js
import deepspeed_tpu_torch.resilience.errors as terr
import deepspeed_tpu_torch.serve as ts
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.models import build_model, params_from_jax
from deepspeed_tpu_torch.utils import prng
from tests.test_torch_prng import MARGIN, masked_rows
from tests.torch_checked import checked_mode  # noqa: F401  (autouse: checked mode)

V = 128
MODEL = dict(vocab_size=V, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
             intermediate_size=128, max_seq_len=128)
ENGINE = dict(max_seqs=4, max_seq_len=128, prefill_chunk=16, block_size=16,
              token_budget=16, num_blocks=33, paged=True)
PKG = {"jax": (js, jerr), "torch": (ts, terr)}


@pytest.fixture(scope="module")
def models():
    jm = jax_build_model("llama-tiny", **MODEL)
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    return jm, params, build_model("llama-tiny", **MODEL), params_from_jax(params)


def engine(kind, models, **kw):
    jm, params, tm, tparams = models
    opts = dict(ENGINE, **kw)
    if kind == "jax":
        return JaxEngine(jm, params, dtype=np.float32, **opts)
    return InferenceEngineV2(tm, tparams, dtype=torch.float32, device="cpu", **opts)


class Clock:
    """A fake scheduling clock: each read advances a millisecond."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


def _counters(sched, eng):
    """Every reported counter that does not read the wall clock."""
    ev = {k: v for k, v, _ in sched.monitor_events()
          if "lat" not in k and not k.startswith("serve/transfer/")}
    ev["prefix_hits"] = eng.prefix_cache_stats().get("hits", 0)
    return ev


_JAX_ENGINES = {}


def reusable_engine(kind, models, **kw):
    """The port's engine fresh; the JAX package's one per geometry, rebuilt
    before each run: a rebuild keeps its compiled programs (most of a run's
    time here) and leaves a fresh engine's state, so the run's streams and
    counters are a fresh engine's (``tests/test_torch_fused_decode.py``).
    No test here compares trace counts."""
    if kind == "torch":
        return engine(kind, models, **kw)
    key = tuple(sorted(kw.items()))
    eng = _JAX_ENGINES.get(key)
    if eng is None:
        eng = _JAX_ENGINES[key] = engine(kind, models, **kw)
    else:
        eng.rebuild()
    return eng


def run(kind, models, script, eng_kw=None, sched_kw=None, wrap=None):
    """One package's run of ``script(sched, pkg, clock) -> requests``;
    returns (requests, counters, scheduler, engine)."""
    pkg, err = PKG[kind]
    eng = reusable_engine(kind, models, **(eng_kw or {}))
    drive = wrap(eng, err) if wrap else eng
    clock = Clock()
    sched = pkg.ContinuousBatchScheduler(drive, clock=clock, sleep=lambda s: None,
                                         **(sched_kw or {}))
    reqs = script(sched, pkg, clock)
    sched.close()
    return reqs, _counters(sched, eng), sched, eng


def margin_at(models, context, sp):
    """The selection margin of the draw after ``context`` on the port's fp32
    logits, and whether a token sits at the nucleus edge."""
    _, _, tm, tparams = models
    eng = InferenceEngineV2(tm, tparams, dtype=torch.float32, device="cpu", paged=True,
                            max_seqs=1, max_seq_len=128, block_size=16,
                            prefill_chunk=128, token_budget=128)
    lg = torch.from_numpy(eng.put([1], [list(context)])[1])
    bias = None if sp is None else ts.combined_bias(sp, V, context)
    if bias is not None:
        lg = lg + torch.from_numpy(bias)
    if sp is None or sp.is_greedy:
        top2 = lg.topk(2).values
        return float(top2[0] - top2[1]), False
    x, edge = masked_rows(lg[None], [sp.temperature], [sp.top_k], [sp.top_p])
    key = prng.fold_in(prng.PRNGKey(sp.seed), len(context))
    top2 = (prng.gumbel(key, (V,)) + x[0]).topk(2).values
    return float(top2[0] - top2[1]), bool(edge[0])


def assert_same(models, jax_run, torch_run):
    """Streams equal (under the margin rule), then counters equal."""
    (jreqs, jc, *_), (treqs, tc, *_) = jax_run, torch_run
    assert len(jreqs) == len(treqs)
    excluded, draws = 0, 0
    for jr, tr in zip(jreqs, treqs):
        draws += len(jr.tokens)
        if tr.tokens == jr.tokens:
            continue
        i = next((k for k, (a, b) in enumerate(zip(jr.tokens, tr.tokens)) if a != b), None)
        assert i is not None, (jr.uid, jr.tokens, tr.tokens)
        sp = jr.sampling
        m, edge = margin_at(models, jr.prompt + jr.tokens[:i],
                            None if sp is None else ts.SamplingParams.from_dict(sp.to_dict()))
        assert m < MARGIN or edge, (jr.uid, i, m, jr.tokens, tr.tokens)
        excluded += 1
    assert excluded <= 0.01 * draws, (excluded, draws)
    if excluded == 0:
        assert [r.state.value for r in treqs] == [r.state.value for r in jreqs]
        assert [r.preemptions for r in treqs] == [r.preemptions for r in jreqs]
        assert tc == jc, {k: (jc.get(k), tc.get(k)) for k in set(jc) | set(tc)
                          if jc.get(k) != tc.get(k)}
    return excluded


def both(models, script, **kw):
    j, t = run("jax", models, script, **kw), run("torch", models, script, **kw)
    assert_same(models, j, t)
    return j, t


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, n).tolist() for n in lens]


# --------------------------------------------------------------------------
# chunked prefill
# --------------------------------------------------------------------------
def interleave_script(sched, pkg, clock):
    """A live decoder gains one token a step while a long prompt is mid
    PREFILL (budget 16 = 1 decode row + 15 chunk rows)."""
    short, long_ = _prompts(11, (4, 48))
    a = sched.submit(short, max_new_tokens=12, uid=1)
    while a.state is not pkg.RequestState.DECODE or len(a.tokens) < 1:
        sched.step()
    b = sched.submit(long_, max_new_tokens=4, uid=2)
    for _ in range(3):
        n = len(a.tokens)
        sched.step()
        assert len(a.tokens) == n + 1 and b.state is pkg.RequestState.PREFILL
        assert sched.engine.prefill_backlog() > 0
    sched.run_until_complete()
    return [a, b]


def test_chunked_prefill_decoders_advance_mid_prefill(models):
    (_, jc, *_), (reqs, tc, sched, _) = both(models, interleave_script)
    assert all(r.state.value == "done" for r in reqs)
    assert tc["serve/prefill/interleaved_steps"] >= 3 and tc["serve/prefill/chunks"] >= 3


def ab_script(sched, pkg, clock):
    reqs = [sched.submit(p, max_new_tokens=6, uid=i + 1, arrival_time=0.01 * i)
            for i, p in enumerate(_prompts(23, (40, 6, 33, 17)))]
    sched.run_until_complete()
    return reqs


@pytest.mark.parametrize("chunked", [True, False], ids=["chunked", "monolithic"])
def test_chunked_and_monolithic_match_jax(models, chunked):
    both(models, ab_script, sched_kw=dict(chunked_prefill=chunked))


def test_chunked_vs_monolithic_bitwise_in_the_port(models):
    streams, chunks = {}, {}
    for chunked in (True, False):
        reqs, c, *_ = run("torch", models, ab_script, sched_kw=dict(chunked_prefill=chunked))
        streams[chunked] = [r.tokens for r in reqs]
        chunks[chunked] = c["serve/prefill/chunks"]
    assert streams[True] == streams[False]
    assert chunks[True] > 0 and chunks[False] == 0


# --------------------------------------------------------------------------
# preemption
# --------------------------------------------------------------------------
def _preempt_script(sampled):
    def script(sched, pkg, clock):
        pa, pb = _prompts(1, (48, 48))
        spa = pkg.SamplingParams(temperature=0.8, seed=11) if sampled else None
        spb = pkg.SamplingParams(temperature=0.8, seed=22) if sampled else None
        a = sched.submit(pa, max_new_tokens=24, priority=0, uid=1, sampling=spa)
        for _ in range(4):
            sched.step()
        b = sched.submit(pb, max_new_tokens=8, priority=5, uid=2, sampling=spb)
        sched.run_until_complete()
        return [a, b]
    return script


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "temp0.8"])
def test_priority_preemption_and_readmission(models, sampled):
    # 6 usable blocks; A peaks at 5, B at 4: they cannot coexist
    _, (reqs, tc, sched, eng) = both(models, _preempt_script(sampled),
                                     eng_kw=dict(num_blocks=7))
    a, b = reqs
    assert a.preemptions > 0 and tc["serve/preemptions"] > 0
    assert tc["prefix_hits"] > 0  # the victim replayed through the prefix cache
    # replay is bitwise within the port: each request alone, on an ample pool
    pa, pb = _prompts(1, (48, 48))
    for req, prompt, n, seed in ((a, pa, 24, 11), (b, pb, 8, 22)):
        def solo(sched, pkg, clock, prompt=prompt, n=n, seed=seed, uid=req.uid):
            sp = pkg.SamplingParams(temperature=0.8, seed=seed) if sampled else None
            r = sched.submit(prompt, max_new_tokens=n, uid=uid, sampling=sp)
            sched.run_until_complete()
            return [r]
        alone, *_ = run("torch", models, solo, eng_kw=dict(num_blocks=64))
        assert alone[0].tokens == req.tokens


# --------------------------------------------------------------------------
# sampling, stop sequences, bias, fan-out, logit processors
# --------------------------------------------------------------------------
def sampled_script(sched, pkg, clock):
    prompts = _prompts(5, (20, 33, 9, 41, 16))
    grid = [(0.7, 0, 1.0), (1.0, 20, 0.9), (1.5, 5, 1.0), (0.5, 0, 0.5), (0.0, 0, 1.0)]
    reqs = [sched.submit(p, max_new_tokens=10, uid=i + 1, priority=i % 2,
                         sampling=pkg.SamplingParams(temperature=t, top_k=k, top_p=q,
                                                     seed=100 + i))
            for i, (p, (t, k, q)) in enumerate(zip(prompts, grid))]
    sched.run_until_complete()
    return reqs


def test_sampled_streams_match_jax(models):
    _, (reqs, tc, *_) = both(models, sampled_script)
    assert tc["serve/sampling/sampled_tokens"] > 0


class Mask:
    """A dynamic logit processor: forbids the last context token."""
    dynamic = True

    def __call__(self, context, vocab):
        row = np.zeros(vocab, np.float32)
        row[context[-1]] = -np.inf
        return row


def semantics_script(sched, pkg, clock):
    # explicit uids far above the auto-numbered fan-out sibling's
    p1, p2, p3 = _prompts(7, (12, 30, 18))
    stop_first = sched.submit(p1, max_new_tokens=16, uid=10001,
                              sampling=pkg.SamplingParams(stop=[(t,) for t in range(0, V, 3)]))
    biased = sched.submit(p2, max_new_tokens=6, uid=10002,
                          sampling=pkg.SamplingParams(temperature=0.9, seed=3,
                                                      logit_bias={17: 1e4}))
    fan = sched.submit(p3, max_new_tokens=8, uid=10003,
                       sampling=pkg.SamplingParams(temperature=1.0, seed=9, n=2))
    single = sched.submit(p3, max_new_tokens=8, uid=10004,
                          sampling=pkg.SamplingParams(temperature=1.0, seed=9))
    masked = sched.submit(p1, max_new_tokens=8, uid=10005,
                          sampling=pkg.SamplingParams(temperature=0.8, seed=4,
                                                      processors=(Mask(),)))
    sched.run_until_complete()
    return [stop_first, biased] + list(fan.fanout) + [single, masked]


def test_stop_bias_fanout_and_dynamic_processor(models):
    _, (reqs, tc, *_) = both(models, semantics_script)
    stop_first, biased, child0, child1, single, masked = reqs
    # the stream ends at its first stop token: nothing is generated past it
    assert stop_first.tokens[-1] % 3 == 0
    assert all(t % 3 for t in stop_first.tokens[:-1])
    assert biased.tokens == [17] * 6
    assert child0.tokens == single.tokens and child1.tokens != child0.tokens
    ctx = masked.prompt + masked.tokens
    assert all(ctx[len(masked.prompt) + i] != ctx[len(masked.prompt) + i - 1]
               for i in range(len(masked.tokens)))
    assert tc["serve/sampling/bias_refreshes"] > 0 and tc["serve/sampling/stop_hits"] == 1


# --------------------------------------------------------------------------
# cancel, deadlines, backpressure
# --------------------------------------------------------------------------
def lifecycle_script(sched, pkg, clock):
    p = _prompts(9, (10, 20, 15, 25, 8, 12))
    a = sched.submit(p[0], max_new_tokens=20, uid=1)
    b = sched.submit(p[1], max_new_tokens=20, uid=2, deadline=clock.t + 0.03)
    sched.step()
    c = sched.submit(p[2], max_new_tokens=5, uid=3)
    for _ in range(2):
        sched.step()
    assert sched.cancel(1) and not sched.cancel(1)
    rejected = 0
    for i, prompt in enumerate(p[3:]):
        try:
            sched.submit(prompt, max_new_tokens=4, uid=4 + i)
        except pkg.QueueFullError:
            rejected += 1
    assert rejected == 1
    sched.run_until_complete()
    return [a, b, c]


def test_cancel_deadline_and_backpressure(models):
    _, (reqs, tc, *_) = both(models, lifecycle_script, sched_kw=dict(max_queue=2))
    a, b, c = reqs
    assert (a.state.value, b.state.value, c.state.value) == ("cancelled", "cancelled", "done")
    assert b.cancel_reason == "deadline"
    assert tc["serve/deadline_cancels"] == 1 and tc["serve/admission_rejects"] == 1


# --------------------------------------------------------------------------
# engine loss
# --------------------------------------------------------------------------
class LosesOnce:
    """An engine whose ``nth`` dispatch call raises ``UnrecoverableEngineError``
    before touching any state; every other attribute is the engine's."""

    def __init__(self, eng, err, nth):
        self._eng, self._err, self._nth, self._calls = eng, err, nth, 0

    def __getattr__(self, name):
        return getattr(self._eng, name)

    def _count(self):
        self._calls += 1
        if self._calls == self._nth:
            raise self._err.UnrecoverableEngineError("engine lost (stub)")

    def put(self, *args, **kwargs):
        self._count()
        return self._eng.put(*args, **kwargs)

    def decode_step(self, *args, **kwargs):
        self._count()
        return self._eng.decode_step(*args, **kwargs)


def test_engine_loss_rebuild_and_journal_replay(models):
    def wrap(eng, err):
        return LosesOnce(eng, err, nth=9)

    ref, *_ = run("torch", models, sampled_script)
    j, t = both(models, sampled_script, wrap=wrap)
    reqs, tc, sched, eng = t
    assert eng.rebuilds == 1 and tc["serve/faults/engine_rebuilds"] == 1
    assert tc["serve/faults/recovery_replays"] > 0 and len(sched.journal) == 0
    assert [r.tokens for r in reqs] == [r.tokens for r in ref]  # bitwise the loss-free run


# --------------------------------------------------------------------------
# tenancy
# --------------------------------------------------------------------------
def tenancy_script(sched, pkg, clock):
    prompts = _prompts(13, (40, 36, 20, 24, 33, 17))
    reqs = [sched.submit(p, max_new_tokens=5, uid=i + 1, tenant=("a", "b")[i % 2])
            for i, p in enumerate(prompts)]
    sched.run_until_complete()
    return reqs


def test_two_tenants_with_cache_quotas(models):
    def with_tenants(kind):
        reg = PKG[kind][0].TenantRegistry()
        reg.register("a", weight=2.0, cache_blocks=2)
        reg.register("b", weight=1.0, cache_blocks=1, slo="batch")
        return reg

    j = run("jax", models, tenancy_script, sched_kw=dict(tenancy=with_tenants("jax")))
    t = run("torch", models, tenancy_script, sched_kw=dict(tenancy=with_tenants("torch")))
    assert_same(models, j, t)
    eng = t[3]
    assert eng.block_mgr.owner_view() == j[3].block_mgr.owner_view()
    assert {o: v["quota"] for o, v in eng.block_mgr.owner_view().items()} == {"a": 2, "b": 1}
    assert all(r.state.value == "done" for r in t[0])


# --------------------------------------------------------------------------
# once-unported options and checked mode
# --------------------------------------------------------------------------
@pytest.mark.parametrize("call,item", [
    (lambda eng, models: eng.swap_in(1), "item 9"),
    (lambda eng, models: eng.export_swap(1), "item 9"),
    (lambda eng, models: engine("torch", models, paged=False), "item 5c"),
    (lambda eng, models: ts.ContinuousBatchScheduler(eng, swap_preemption=True), "item 9"),
])
def test_unported_options_raise_at_construction(models, call, item):
    # ported since (ROADMAP.md items 5c and 9): each call now behaves as
    # the JAX package's does on the same engine
    eng = engine("torch", models)
    got = call(eng, models)
    if isinstance(got, InferenceEngineV2):
        assert not got.paged and got.max_seqs == ENGINE["max_seqs"]
    elif isinstance(got, ts.ContinuousBatchScheduler):
        assert got.swap_preemption is True
    else:  # swap_in declines, export_swap has nothing to export
        assert got == call(engine("jax", models), models), item
    assert not eng.state.seqs
    with pytest.raises(KeyError):  # an empty payload, as in the JAX package
        eng.import_swap(1, {})


def test_engine_with_a_tier_raises_at_construction(models):
    # ported since (item 9): a tiered engine is served, its tier reported
    eng = engine("torch", models, host_tier_blocks=8)
    sched = ts.ContinuousBatchScheduler(eng, clock=Clock(), sleep=lambda s: None)
    sched.submit([1, 2, 3, 4, 5], max_new_tokens=3, uid=900)
    sched.run_until_complete()
    assert eng.prefix_cache_stats()["host_capacity_blocks"] == 8
    assert "serve/kvtier/demotions" in {k for k, _, _ in sched.monitor_events()}


@pytest.mark.parametrize("script", [interleave_script, _preempt_script(True)],
                         ids=["chunked", "preemption"])
def test_sanitize_mode_raises_nothing(models, monkeypatch, script):
    monkeypatch.setenv("DSTPU_SANITIZE", "1")
    from deepspeed_tpu_torch.analysis import sanitizer

    assert sanitizer.sanitize_enabled()
    calls = []
    for name in ("check_prefill_ownership", "check_drained", "check_transition"):
        fn = getattr(sanitizer, name)
        monkeypatch.setattr(sanitizer, name,
                            lambda *a, _fn=fn, _n=name, **k: (calls.append(_n), _fn(*a, **k))[1])
    reqs, *_ = run("torch", models, script, eng_kw=dict(num_blocks=7))
    assert all(r.state.value == "done" for r in reqs)
    assert {"check_prefill_ownership", "check_drained", "check_transition"} <= set(calls)
