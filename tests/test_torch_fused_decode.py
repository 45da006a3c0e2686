"""The port's fused decode horizon against the JAX package's, on the CPU.

The scenarios of the JAX package's ``tests/unit/test_fused_decode.py``, each
run through both packages: ``decode_multi`` and ``rollback`` on the engine,
and ``ContinuousBatchScheduler(decode_horizon=4)`` over it. Both packages get
the same fp32 weights (``params_from_jax``), the same engine geometry, a fake
clock each and the same requests with explicit uids. Tokens, block tables,
``seen_tokens``, ``history``, ``uncommitted``, the blocks a rollback releases,
the step-program counters (``ragged_cache_size``, ``fused_cache_size``,
``verify_cache_size``, on fresh engines) and the ``serve/*`` counters must be
equal, under the margin rule of ``tests/test_torch_scheduler.py``. Within the port, K fused
rounds must give K single steps' tokens bitwise, greedy and sampled.

This module also holds the harness the speculation and pipelined-dispatch
tests share: the engine geometry, the scheduler runs, and a fault-injecting
proxy that raises each package's own error types.
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
from tests.test_torch_scheduler import Clock, assert_same
from tests.torch_checked import checked_mode  # noqa: F401  (autouse: checked mode)

MODEL = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
             intermediate_size=128, max_seq_len=128)
ENGINE = dict(max_seqs=4, max_seq_len=128, prefill_chunk=16, block_size=16,
              token_budget=16, num_blocks=64, paged=True)
PKG = {"jax": (js, jerr), "torch": (ts, terr)}
KINDS = ("jax", "torch")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while the module runs: the tiny model's ops gain
    nothing from more, and with several test workers a thread pool each
    oversubscribes the cores (these files ran ~3x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def prompts(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, ln).tolist() for ln in (33, 30, 28)][:n]


def counters(sched, eng):
    """Every reported counter that does not read the wall clock."""
    ev = {k: v for k, v, _ in sched.monitor_events()
          if "lat" not in k and not k.endswith("_ms") and not k.startswith("serve/transfer/")
          and not k.endswith("bytes_per_s")}
    ev["prefix_hits"] = eng.prefix_cache_stats().get("hits", 0)
    return ev


_JAX_ENGINES = {}


def reusable_engine(kind, models, **kw):
    """An engine for a run whose trace counts are not compared. The port's is fresh. The JAX
    package's is one per geometry, rebuilt before each run: a rebuild keeps
    the compiled programs (``engine_v2.py:1754``), whose compilation is
    ~2.5 s of a run's ~2.6 here, and leaves the state of a fresh engine, so
    the run's streams and ``serve/*`` counters are a fresh engine's. Its
    trace counts then cover every run of that geometry, so the exact counts
    are compared on fresh engines (``test_torch_captured_steps.py``, the
    engine tests here and in ``test_torch_speculation.py``)."""
    if kind == "torch":
        return engine(kind, models, **kw)
    key = tuple(sorted(kw.items()))  # every module builds the same weights
    eng = _JAX_ENGINES.get(key)
    if eng is None:
        eng = _JAX_ENGINES[key] = engine(kind, models, **kw)
    else:
        eng.rebuild()
    return eng


class Injector:
    """The JAX package's ``FaultInjector`` semantics for the kinds these
    tests use, raising the given package's errors: ``transient`` faults on
    calls ``nth .. nth+count-1`` of a site, a ``persistent`` fault on every
    call of a site that carries ``uid``, and ``device_lost`` at call ``nth``
    (every call then raises until the engine is rebuilt). Each fires before
    delegation."""

    def __init__(self, err, *specs):
        self.err, self.specs = err, [dict(s) for s in specs]
        self.calls, self.fired, self.dead, self.deaths = {}, {}, False, 0

    def on_call(self, site, uids):
        n = self.calls[site] = self.calls.get(site, 0) + 1
        if self.dead:
            raise self.err.DeviceLostError(f"dead at {site}")
        for s in self.specs:
            if s["site"] != site:
                continue
            kind = s["kind"]
            if kind == "persistent" and s["uid"] in uids:
                self.fired[kind] = self.fired.get(kind, 0) + 1
                raise self.err.RequestFailedError(s["uid"], f"persistent at {site}")
            if kind != "persistent" and s["nth"] <= n < s["nth"] + s.get("count", 1):
                self.fired[kind] = self.fired.get(kind, 0) + 1
                if kind == "device_lost":
                    self.dead, self.deaths = True, self.deaths + 1
                    raise self.err.DeviceLostError(f"device lost at {site} call {n}")
                raise self.err.TransientEngineError(f"transient at {site} call {n}")

    def wrap(self, eng):
        return _Injected(eng, self)


class _Injected:
    _SITES = {"put": "put", "decode_step": "decode_step", "decode_dispatch": "decode_step",
              "decode_multi": "decode_multi", "verify_multi": "verify_multi",
              "flush": "flush", "preempt": "preempt"}

    def __init__(self, eng, injector):
        self.inner, self.injector = eng, injector

    def rebuild(self, *a, **kw):
        out = self.inner.rebuild(*a, **kw)
        self.injector.dead = False
        return out

    def __getattr__(self, name):
        fn = getattr(self.inner, name)
        site = self._SITES.get(name)
        if site is None:
            return fn

        def call(first, *a, **kw):
            uids = [first] if isinstance(first, int) else list(first)
            self.injector.on_call(site, uids)
            return fn(first, *a, **kw)
        return call


def run_sched(kind, models, prompts_, *, gen=16, eos=None, priorities=None, sampling=None,
              uids=None, faults=(), sched_kw=None, **ekw):
    """One package's run of ``prompts_`` through a fresh engine and
    scheduler; returns (requests, counters, scheduler, engine, injector)."""
    pkg, err = PKG[kind]
    eng = reusable_engine(kind, models, **ekw)
    inj = Injector(err, *faults) if faults else None
    kw = dict(sched_kw or {})
    if "proposer" in kw and callable(kw["proposer"]):
        kw["proposer"] = kw["proposer"](kind)
    sched = pkg.ContinuousBatchScheduler(inj.wrap(eng) if inj else eng, clock=Clock(),
                                         sleep=lambda s: None, **kw)
    uids = uids or [1000 + i for i in range(len(prompts_))]
    prios = priorities or [0] * len(prompts_)
    reqs = []
    for i, (p, pr) in enumerate(zip(prompts_, prios)):
        sp = None
        if sampling is not None:
            sp = pkg.SamplingParams(**sampling[i]) if isinstance(sampling, list) \
                else pkg.SamplingParams(**sampling)
        reqs.append(sched.submit(p, max_new_tokens=gen, eos_token=eos, priority=pr,
                                 uid=uids[i], sampling=sp))
    sched.run_until_complete()
    if kind == "torch":  # the JAX engine's bounds (4, 1, 1) on every run
        assert eng.ragged_cache_size <= 4 and eng.fused_cache_size <= 1
        assert eng.verify_cache_size <= 1
    return reqs, counters(sched, eng), sched, eng, inj


def both(models, *args, **kw):
    """``run_sched`` in both packages; asserts streams (margin rule) and
    counters equal, returns the port's run."""
    j = run_sched("jax", models, *args, **kw)
    t = run_sched("torch", models, *args, **kw)
    assert_same(models, j, t)
    return t


def tokens(run):
    return [r.tokens for r in run[0]]


def seq_view(eng, uid):
    d = eng.state.seqs[uid]
    return (list(d.blocks), d.seen_tokens, list(d.history), d.uncommitted)


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------
def singles(eng, uid, prompt, n):
    t = int(eng.put([uid], [prompt], greedy=True)[uid])
    out = []
    for _ in range(n):
        t = int(eng.decode_step({uid: t}, greedy=True)[uid])
        out.append(t)
    return out


def test_decode_multi_bitwise_vs_single_steps(models):
    prompt = prompts(1)[0]
    ref = singles(engine("torch", models), 1, prompt, 8)
    got = {}
    for kind in KINDS:
        eng = engine(kind, models, decode_horizon=4)
        t = int(eng.put([7], [prompt], greedy=True)[7])
        seq = eng.decode_multi({7: t}, 4)[7]
        eng.rollback(7, 0)
        seq += eng.decode_multi({7: seq[-1]}, 4)[7]
        got[kind] = (seq, seq_view(eng, 7), eng.fused_cache_size, eng.ragged_cache_size)
    assert got["torch"][0] == ref  # the port's own twin, bitwise
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_decode_multi_sampled_rows_bitwise_vs_single_steps(models, temperature):
    """Mixed rows (one sampled, one greedy): the fused rounds draw under the
    keys of positions starts+1 .. starts+K, as K single steps do."""
    sp = ts.SamplingParams(temperature=temperature, top_k=20, seed=5)
    p1, p2 = prompts(2)
    ref = engine("torch", models)
    fused = engine("torch", models, decode_horizon=4)
    streams = []
    for eng in (ref, fused):
        eng.set_sampling(1, sp)
        first = eng.put([1, 2], [p1, p2], greedy=True)
        toks, out = dict(first), {1: [], 2: []}
        while len(out[1]) < 8:
            if eng is ref:
                step = {u: [t] for u, t in eng.decode_step(toks, greedy=True).items()}
            else:
                step = eng.decode_multi(toks, 4)
                for u in step:
                    eng.rollback(u, 0)
            for u, seq in step.items():
                out[u] += seq
                toks[u] = seq[-1]
        streams.append(out)
    assert streams[0] == streams[1]
    jeng = reusable_engine("jax", models, decode_horizon=4)
    jeng.set_sampling(1, js.SamplingParams(temperature=temperature, top_k=20, seed=5))
    jout = jeng.decode_multi(jeng.put([1, 2], [p1, p2], greedy=True), 4)
    assert {u: s[:4] for u, s in streams[1].items()} == jout


def test_horizon_restriction_and_trace_bound(models):
    seen = {}
    for kind in KINDS:
        eng = engine(kind, models, decode_horizon=4)
        t = int(eng.put([1], [prompts(1)[0]], greedy=True)[1])
        with pytest.raises(ValueError, match="fixed-shape"):
            eng.decode_multi({1: t}, 3)
        out1 = eng.decode_multi({1: t}, 1)  # delegates to the ragged round
        assert len(out1[1]) == 1 and eng.fused_cache_size == 0
        a = eng.decode_multi({1: out1[1][0]}, 4)
        b = eng.decode_multi({1: 5}, 4)
        assert eng.fused_cache_size == 1 and eng.ragged_cache_size <= 4
        seen[kind] = (out1, a, b, eng.ragged_cache_size, eng.fused_cache_size,
                      eng.verify_cache_size)
    assert seen["torch"] == seen["jax"]
    _, _, tm, tparams = models
    with pytest.raises(ValueError):
        engine("torch", models, decode_horizon=0)
    with pytest.raises(ValueError, match="paged"):
        InferenceEngineV2(tm, tparams, paged=False, decode_horizon=4, device="cpu")


def test_rollback_frees_blocks_and_indexes_only_kept(models):
    seen = {}
    for kind in KINDS:
        eng = reusable_engine(kind, models, decode_horizon=4)
        t = int(eng.put([1], [prompts(1)[0][:17]], greedy=True)[1])
        eng.decode_multi({1: t}, 4)
        d = eng.state.seqs[1]
        seen_tokens, blocks = d.seen_tokens, len(d.blocks)
        free_before = len(eng.block_mgr._free)
        freed = eng.rollback(1, 3)
        assert d.seen_tokens == seen_tokens - 3 and len(d.history) == seen_tokens - 3
        assert freed == blocks - len(d.blocks)
        assert len(eng.block_mgr._free) == free_before + freed
        eng.block_mgr.check_invariants(eng.state.seqs.values())
        view = seq_view(eng, 1)
        hist = list(d.history)
        eng.flush(1)
        d2 = eng.state.get_or_create_sequence(2)
        hit = eng.block_mgr.lookup(d2, hist + [99] * 8)
        assert hit == (len(hist) // 16) * 16
        eng.flush(2)
        eng.block_mgr.check_invariants([])
        seen[kind] = (freed, view, hit, eng.prefix_cache_stats())
    assert seen["torch"][:3] == seen["jax"][:3]
    ts_, js_ = seen["torch"][3], seen["jax"][3]
    assert ts_ == {k: js_[k] for k in ts_}


def test_rollback_validation_and_idempotence(models):
    for kind in KINDS:
        err = PKG[kind][1]
        eng = reusable_engine(kind, models, decode_horizon=4)
        eng.put([5], [prompts(1)[0]], greedy=True)
        with pytest.raises(ValueError, match="roll back"):
            eng.rollback(5, 10_000)
        assert eng.rollback(424242) == 0  # unknown uid: a no-op
        d = eng.state.seqs[5]
        with pytest.raises(err.ContextOverflowError):
            d.seen_tokens = eng.max_seq_len - 2  # 2 < K positions left
            eng.decode_multi({5: 1}, 4)


def test_put_scratch_arrays_are_reused(models):
    """The ragged and fused inputs are staged in per-shape buffers filled
    in place, one set per program shape (budget, decode round, fused)."""
    eng = engine("torch", models, decode_horizon=4)
    t = int(eng.put([1], [prompts(1)[0]], greedy=True)[1])
    t2 = int(eng.decode_step({1: t}, greedy=True)[1])
    ids_before = {k: id(p.views[0]) for k, p in eng._scratch.items()}
    host_before = {k: p.host.data_ptr() for k, p in eng._scratch.items()}
    eng.decode_step({1: t2}, greedy=True)
    eng.decode_multi({1: 3}, 4)
    assert {k: id(p.views[0]) for k, p in eng._scratch.items() if k in ids_before} == ids_before
    assert {k: p.host.data_ptr() for k, p in eng._scratch.items()
            if k in host_before} == host_before
    assert len(eng._scratch) <= 3


# --------------------------------------------------------------------------
# the scheduler
# --------------------------------------------------------------------------
@pytest.mark.parametrize("sampling", [None, dict(temperature=0.8, top_k=40, seed=31)],
                         ids=["greedy", "sampled"])
def test_bitwise_k_vs_1_end_to_end(models, sampling):
    one = both(models, prompts(), sampling=sampling)
    four = both(models, prompts(), sampling=sampling, decode_horizon=4)
    assert tokens(four) == tokens(one)
    assert four[1]["serve/decode/fused_steps"] > 0
    assert one[1]["serve/decode/fused_steps"] == 0
    assert four[2].metrics.tokens_generated == one[2].metrics.tokens_generated
    eng = four[3]
    assert eng.ragged_cache_size <= 4 and eng.fused_cache_size == 1
    assert not eng.state.seqs


def _solo_refs(models, cache={}):
    """Each prompt's uncontended single-step stream in the port."""
    if "refs" not in cache:
        cache["refs"] = [tokens(run_sched("torch", models, [p]))[0] for p in prompts()]
    return cache["refs"]


def test_bitwise_under_preemption_churn(models):
    run = both(models, prompts(), decode_horizon=4, num_blocks=7, priorities=[2, 1, 0])
    assert run[2].metrics.preemptions > 0
    assert run[1]["serve/decode/fused_steps"] > 0
    assert tokens(run) == _solo_refs(models)
    eng = run[3]
    assert eng.ragged_cache_size <= 4 and eng.fused_cache_size <= 1
    eng.block_mgr.check_invariants([])


def test_bitwise_under_injected_faults(models):
    run = both(models, prompts(), decode_horizon=4,
               faults=[dict(site="decode_multi", kind="transient", nth=2, count=2)])
    assert run[4].fired["transient"] == 2
    assert tokens(run) == _solo_refs(models)
    run = both(models, prompts(), decode_horizon=4,
               faults=[dict(site="decode_multi", kind="persistent", uid=1001)])
    reqs, eng = run[0], run[3]
    assert reqs[1].state.value == "failed"
    assert reqs[0].tokens == _solo_refs(models)[0] and reqs[2].tokens == _solo_refs(models)[2]
    assert not eng.state.seqs and not eng.block_mgr._ref


def test_eos_overrun_rollback_bitwise(models):
    prompt = prompts(1)[0]
    ref = tokens(run_sched("torch", models, [prompt], gen=24))[0]
    idx = next(j for j, t in enumerate(ref) if ref.index(t) == j and j >= 2 and j % 4 != 0)
    expected = ref[:idx + 1]
    for K, want_rollback in ((1, False), (4, True)):
        run = both(models, [prompt], gen=24, eos=ref[idx], decode_horizon=K)
        (req,), eng = run[0], run[3]
        assert req.state.value == "done" and req.tokens == expected
        assert (run[1]["serve/decode/rollback_tokens"] > 0) is want_rollback
        assert run[2].metrics.tokens_generated == len(expected)
        assert not eng.state.seqs and not eng.block_mgr._ref
        eng.block_mgr.check_invariants([])


def _collapse_conditions(kind, models):
    pkg = PKG[kind][0]
    eng = engine(kind, models, decode_horizon=4)
    sched = pkg.ContinuousBatchScheduler(eng, chunked_prefill=False, clock=Clock(),
                                         sleep=lambda s: None)
    r1 = sched.submit(prompts(1)[0], max_new_tokens=12, uid=1)
    sched.step()
    assert r1.state.value == "decode"
    feed = {r1.uid: r1.tokens[-1]}
    now = sched._clock()
    got = [sched._effective_horizon(now, feed)]
    r2 = sched.submit([5, 6, 7], max_new_tokens=4, arrival_time=now, uid=2)
    got.append(sched._effective_horizon(now, feed))  # an admission is queued
    sched.cancel(r2.uid)
    got.append(sched._effective_horizon(now, feed))
    r1.max_new_tokens = len(r1.tokens) + 2  # < K tokens remaining
    got.append(sched._effective_horizon(now, feed))
    r1.max_new_tokens = 12
    r1.deadline = now + 1.0
    sched._token_est_s = 10.0  # the horizon's budget is far past the deadline
    got.append(sched._effective_horizon(now, feed))
    sched._token_est_s = 1e-9
    got.append(sched._effective_horizon(now, feed))
    r1.deadline = None
    sched._stalled = True
    got.append(sched._effective_horizon(now, feed))
    sched._stalled = False
    d = eng.state.seqs[r1.uid]
    seen = d.seen_tokens
    d.seen_tokens = eng.max_seq_len - 2  # < K positions left
    got.append(sched._effective_horizon(now, feed))
    d.seen_tokens = seen
    sched.close()
    return got


def test_adaptive_horizon_collapse_conditions(models):
    got = _collapse_conditions("torch", models)
    assert got == [4, 1, 4, 1, 1, 4, 1, 1]
    assert got == _collapse_conditions("jax", models)


def test_scheduler_horizon_must_match_engine(models):
    eng = engine("torch", models, decode_horizon=4)
    with pytest.raises(ValueError, match="compiled horizon"):
        ts.ContinuousBatchScheduler(eng, decode_horizon=8)
    assert ts.ContinuousBatchScheduler(eng).decode_horizon == 4
    assert ts.ContinuousBatchScheduler(eng, decode_horizon=1).decode_horizon == 1


def test_watchdog_budget_scales_with_horizon():
    for pkg in (js, ts):
        wd = pkg.StepWatchdog(step_budget_s=0.1, escalate_after=2)
        assert wd.observe("decode", 0.5, scale=8) == (False, False)
        assert wd.observe("decode", 0.9, scale=8) == (True, False)
        assert wd.observe("decode", 0.11) == (True, True)  # escalates
        assert wd.breaches == 2 and wd.escalations == 1


def test_decode_metrics_reach_monitor_events(models):
    run = both(models, prompts(1), gen=12, decode_horizon=4)
    events = {e[0]: e[1] for e in run[2].monitor_events(step=2)}
    assert events["serve/decode/fused_steps"] > 0
    assert events["serve/decode/horizon"] >= 1.0
    assert "serve/decode/rollback_tokens" in events
    assert max(run[2].metrics.step_batch) >= 4  # batch x horizon a dispatch
