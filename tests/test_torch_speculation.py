"""The port's speculative decoding against the JAX package's, on the CPU.

The scenarios of the JAX package's ``tests/unit/test_speculation.py``, each
run through both packages: the proposers (prompt lookup, a draft model's
greedy loop, the acceptance policy), the engine's ``verify_multi`` with its
validation and the ``rollback`` contract, and ``ContinuousBatchScheduler``
with a proposer against the plain scheduler (greedy and sampled, a stop
token inside an accepted draft, preemption churn, faults on the
``verify_multi`` site, acceptance collapse, chunked prefill), plus the
sanitizer's speculation checks: the checked cache refusing a register
during an uncommitted verify, and an uncommitted verify across a step
boundary. The harness is ``tests/test_torch_fused_decode.py``'s. Streams,
block state and counters must be equal across packages under the margin
rule; inside the port, speculative streams must equal plain ones bitwise
(fp32 on the CPU).
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu.serve as js
import deepspeed_tpu_torch.serve as ts
from deepspeed_tpu_torch.analysis.sanitizer import SanitizerError
from tests.test_torch_scheduler import Clock
from tests.test_torch_fused_decode import (KINDS, PKG, both, engine, models,  # noqa: F401
                                           one_torch_thread, prompts, reusable_engine, run_sched, seq_view,
                                           singles, tokens)
from tests.torch_checked import checked_mode  # noqa: F401  (autouse: checked mode)

LOOKUP = {"proposer": lambda kind: PKG[kind][0].PromptLookupProposer()}


def draft_kw(models):
    """Scheduler options with the target model as its own draft model."""
    jm, params, tm, tparams = models
    return {"proposer": lambda kind: (
        js.DraftModelProposer(jm, params, window=64, max_draft=3) if kind == "jax"
        else ts.DraftModelProposer(tm, tparams, window=64, max_draft=3))}


def garbage_proposer(pkg):
    """A proposer whose drafts the target always rejects."""

    class Garbage(pkg.DraftProposer):
        def propose(self, uid, context, k):
            return [(int(context[-1]) + 1) % 100 + 1] * k

    return Garbage()


# --------------------------------------------------------------------------
# proposers and the acceptance policy (host code, both packages)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", [js, ts], ids=["jax", "torch"])
def test_prompt_lookup_most_recent_match(pkg):
    p = pkg.PromptLookupProposer(max_ngram=2)
    ctx = [1, 2, 7, 8, 1, 2, 9, 9, 1, 2]
    assert p.propose(0, ctx, 3) == [9, 9, 1]
    assert p.propose(0, [1, 2, 3, 4, 5], 3) == []
    assert p.propose(0, ctx, 0) == []


def test_prompt_lookup_drafts_cycles_and_falls_back():
    for pkg in (js, ts):
        assert pkg.PromptLookupProposer().propose(0, [40, 41] * 6, 5) == [40, 41, 40, 41, 40]
        assert pkg.PromptLookupProposer(max_ngram=3).propose(0, [5, 6, 1, 2, 5], 2) == [6, 1]
        with pytest.raises(ValueError, match="min_ngram"):
            pkg.PromptLookupProposer(max_ngram=0)


def test_draft_model_matches_manual_greedy_and_jax(models):
    jm, params, tm, tparams = models
    prop = ts.DraftModelProposer(tm, tparams, window=64, max_draft=3)
    ctx = [int(t) for t in np.random.default_rng(1).integers(0, 128, 40)]
    got = prop.propose(1, ctx, 3)
    win = torch.zeros(64, dtype=torch.int32)
    win[:40] = torch.tensor(ctx)
    want = []
    for cur in range(40, 43):
        nxt = int(torch.argmax(tm.logits(tparams, win[None])[0, cur - 1]))
        want.append(nxt)
        win[cur] = nxt
    assert got == want
    assert prop.propose(1, ctx, 2) == want[:2]  # the budget slices a fixed loop
    assert js.DraftModelProposer(jm, params, window=64, max_draft=3).propose(1, ctx, 3) == got
    with pytest.raises(ValueError, match="window"):
        ts.DraftModelProposer(tm, tparams, window=4, max_draft=8)


@pytest.mark.parametrize("pkg", [js, ts], ids=["jax", "torch"])
def test_policy_ema_budget_and_collapse(pkg):
    pol = pkg.SpecPolicy(pkg.PromptLookupProposer(), ema_alpha=0.5, floor=0.35, revive_after=2)
    assert pol.budget(1, 7) == 7
    pol.observe(1, proposed=4, accepted=0)
    assert pol.rate(1) == 0.0
    assert [pol.budget(1, 7) for _ in range(3)] == [0, 0, 1]
    pol.observe(1, proposed=1, accepted=1)
    assert pol.rate(1) == 0.5 and pol.budget(1, 7) == round(0.5 * 7)
    pol.forget(1)
    assert pol.rate(1) == 1.0


@pytest.mark.parametrize("pkg", [js, ts], ids=["jax", "torch"])
def test_policy_collect_skips_empty_and_zero_budget(pkg):
    pol = pkg.SpecPolicy(pkg.PromptLookupProposer(), floor=0.35)
    ctx = {1: [4, 5] * 6, 2: [1, 2, 3, 4, 5]}
    drafts = pol.collect([1, 2], lambda u: ctx[u], 3)
    assert 1 in drafts and 2 not in drafts
    pol.observe(1, proposed=3, accepted=0)
    assert pol.collect([1, 2], lambda u: ctx[u], 3) == {}


# --------------------------------------------------------------------------
# the engine's verify_multi and the rollback contract
# --------------------------------------------------------------------------
def _verify_script(eng, prompt, ref):
    """Perfect, garbage and empty drafts in turn; returns every output and
    the sequence's state after each commit."""
    t0 = int(eng.put([7], [prompt], greedy=True)[7])
    seen = [eng.verify_multi({7: t0}, {7: ref[:3]})]
    assert eng.state.seqs[7].uncommitted == 4
    eng.rollback(7, 0)
    seen.append(seq_view(eng, 7))
    seen.append(eng.verify_multi({7: ref[3]}, {7: [(ref[4] + 1) % 128, 5, 9]}))
    eng.rollback(7, 3)
    seen.append(eng.verify_multi({7: ref[4]}, {}))
    eng.rollback(7, 3)
    seen.append(seq_view(eng, 7))
    return seen


def test_verify_bitwise_vs_sequential_greedy(models):
    prompt = prompts(1)[0]
    ref = singles(engine("torch", models), 1, prompt, 8)
    out = {k: _verify_script(reusable_engine(k, models, decode_horizon=4), prompt, ref)
           for k in KINDS}
    t = out["torch"]
    assert t[0][7] == ref[:4] and t[2][7][0] == ref[4] and t[3][7] == [ref[5]]
    assert t[4][1] == len(prompt) + 6 and len(t[4][2]) == t[4][1]
    assert t == out["jax"]


def test_verify_partial_acceptance_prefix(models):
    prompt = prompts(1)[0]
    ref = singles(engine("torch", models), 1, prompt, 4)
    seen = {}
    for kind in KINDS:
        eng = reusable_engine(kind, models, decode_horizon=4)
        t0 = int(eng.put([7], [prompt], greedy=True)[7])
        g = eng.verify_multi({7: t0}, {7: [ref[0], (ref[1] + 1) % 128, 0]})[7]
        assert g[:2] == ref[:2]  # one accepted draft, then the bonus token
        eng.rollback(7, 2)
        assert eng.state.seqs[7].seen_tokens == len(prompt) + 2
        seen[kind] = (g, seq_view(eng, 7))
    assert seen["torch"] == seen["jax"]


def test_verify_validation_surface(models):
    for kind in KINDS:
        err = PKG[kind][1]
        eng = reusable_engine(kind, models, decode_horizon=4)
        t0 = int(eng.put([1], [prompts(1)[0]], greedy=True)[1])
        with pytest.raises(err.EngineUsageError, match="exceed the verify"):
            eng.verify_multi({1: t0}, {1: [1, 2, 3, 4]})
        assert eng.verify_multi({}, {}) == {}
        with pytest.raises(KeyError):
            eng.verify_multi({99: 1}, {})
        d = eng.state.seqs[1]
        seen = d.seen_tokens
        d.seen_tokens = eng.max_seq_len - 2
        with pytest.raises(err.ContextOverflowError):
            eng.verify_multi({1: t0}, {1: [1]})
        d.seen_tokens = seen
        eng2 = reusable_engine(kind, models, decode_horizon=4)
        eng2.put([2], [prompts(1)[0]], greedy=True, max_steps=0)
        with pytest.raises(err.EngineUsageError, match="pending prefill"):
            eng2.verify_multi({2: 5}, {2: [1]})
        eng3 = reusable_engine(kind, models)
        eng3.put([3], [[5, 6, 7]], greedy=True)
        with pytest.raises(err.EngineUsageError, match="decode_horizon"):
            eng3.verify_multi({3: 5}, {})


def test_verify_trace_bound(models):
    seen = {}
    for kind in KINDS:
        eng = engine(kind, models, decode_horizon=4)
        toks = {uid: int(eng.put([uid], [p], greedy=True)[uid])
                for uid, p in zip((1, 2, 3), prompts())}
        assert eng.verify_cache_size == 0
        outs = []
        for drafts in ({1: [5, 6, 7]}, {1: [5], 2: [8, 9]}, {}):
            out = eng.verify_multi(toks, drafts)
            outs.append(out)
            for uid in toks:
                assert len(out[uid]) == len(drafts.get(uid, ())) + 1
                eng.rollback(uid, 4 - len(out[uid]))
                toks[uid] = out[uid][-1]
        outs.append(eng.decode_multi(toks, 4))
        for uid in toks:
            eng.rollback(uid, 0)
        assert eng.verify_cache_size == 1 and eng.fused_cache_size == 1
        assert eng.ragged_cache_size <= 4
        seen[kind] = (outs, eng.ragged_cache_size, [seq_view(eng, u) for u in (1, 2, 3)])
    assert seen["torch"] == seen["jax"]


def test_drafts_never_reach_prefix_index(models):
    seen = {}
    for kind in KINDS:
        eng = reusable_engine(kind, models, decode_horizon=4)
        t0 = int(eng.put([1], [prompts(1)[0][:15]], greedy=True)[1])
        eng.verify_multi({1: t0}, {1: [3, 4, 5]})
        eng.rollback(1, 2)
        hist = list(eng.state.seqs[1].history)
        assert len(hist) == 17
        eng.flush(1)
        d2 = eng.state.get_or_create_sequence(2)
        assert eng.block_mgr.lookup(d2, hist + [99] * 15) == 16
        eng.flush(2)
        eng.block_mgr.check_invariants([])
        seen[kind] = hist
    assert seen["torch"] == seen["jax"]


def test_rollback_rejects_n_beyond_uncommitted(models):
    for kind in KINDS:
        err = PKG[kind][1]
        eng = reusable_engine(kind, models, decode_horizon=4)
        t0 = int(eng.put([5], [prompts(1)[0]], greedy=True)[5])
        with pytest.raises(ValueError, match="roll back"):
            eng.rollback(5, 10_000)
        with pytest.raises(err.EngineUsageError, match="committed tokens"):
            eng.rollback(5, 1)
        eng.decode_multi({5: t0}, 4)
        with pytest.raises(err.EngineUsageError, match="committed tokens"):
            eng.rollback(5, 5)
        eng.rollback(5, 2)
        with pytest.raises(err.EngineUsageError, match="committed tokens"):
            eng.rollback(5, 1)
        assert eng.state.seqs[5].uncommitted == 0


def test_rollback_after_quarantine_is_idempotent(models):
    eng = engine("torch", models, decode_horizon=4)
    t0 = int(eng.put([5], [prompts(1)[0]], greedy=True)[5])
    eng.decode_multi({5: t0}, 4)
    eng.flush(5)
    assert [eng.rollback(5, 3), eng.rollback(5, 3), eng.rollback(5, 0)] == [0, 0, 0]
    assert 5 not in eng.state.seqs
    eng.block_mgr.check_invariants([])


# --------------------------------------------------------------------------
# the scheduler with a proposer
# --------------------------------------------------------------------------
def _plain(models, cache={}):
    """The plain scheduler's streams, greedy and sampled, in the port."""
    if not cache:
        cache["greedy"] = tokens(run_sched("torch", models, prompts()))
        cache["solo"] = [tokens(run_sched("torch", models, [p]))[0] for p in prompts()]
    return cache


def test_spec_bitwise_and_counters(models):
    run = both(models, prompts(), decode_horizon=4, sched_kw=LOOKUP)
    sched, eng = run[2], run[3]
    assert tokens(run) == _plain(models)["greedy"]
    spec = sched.metrics.spec
    # how many drafts the target accepts depends on the random weights; the
    # counts equal the JAX package's (``both``), and a draft model that is
    # the target itself accepts every draft (the last scheduler test)
    assert spec["steps"] > 0 and 0.0 <= spec["acceptance_rate"] <= 1.0
    assert eng.verify_cache_size == 1 and eng.ragged_cache_size <= 4
    ev = {k: v for k, v, _ in sched.monitor_events(step=3)}
    assert ev["serve/spec/steps"] > 0
    assert "serve/spec/acceptance_rate" in ev and "serve/spec/draft_horizon" in ev
    assert not eng.state.seqs


def test_spec_under_temperature_token_for_token(models):
    sp = dict(temperature=0.8, seed=31)
    plain = both(models, prompts(), sampling=sp)
    run = both(models, prompts(), decode_horizon=4, sampling=sp, sched_kw=LOOKUP)
    assert tokens(run) == tokens(plain)
    assert tokens(run) != _plain(models)["greedy"]  # sampling was on
    assert run[2].metrics.spec["steps"] > 0
    assert run[3].verify_cache_size == 1 and not run[3].state.seqs


def test_eos_inside_accepted_draft_prefix(models):
    prompt = prompts(1)[0]
    ref = tokens(run_sched("torch", models, [prompt], gen=24))[0]
    idx = next(j for j, t in enumerate(ref) if ref.index(t) == j and j >= 2 and j % 4 != 0)
    run = both(models, [prompt], gen=24, eos=ref[idx], decode_horizon=4, sched_kw=LOOKUP)
    (req,), eng = run[0], run[3]
    assert req.state.value == "done" and req.tokens == ref[:idx + 1]
    assert run[2].metrics.tokens_generated == idx + 1
    assert not eng.state.seqs and not eng.block_mgr._ref
    eng.block_mgr.check_invariants([])


def test_bitwise_under_preemption_churn(models):
    run = both(models, prompts(), decode_horizon=4, num_blocks=7, priorities=[2, 1, 0],
               sched_kw=LOOKUP)
    assert run[2].metrics.preemptions > 0
    assert tokens(run) == _plain(models)["solo"]
    assert run[3].verify_cache_size <= 1
    run[3].block_mgr.check_invariants([])


def test_fault_during_verify_retries_step_verbatim(models):
    """Faults on the ``verify_multi`` site, with the target as its own
    draft model so that every round verifies whatever the weights."""
    solo = _plain(models)["solo"]
    run = both(models, prompts(), decode_horizon=4, sched_kw=draft_kw(models),
               faults=[dict(site="verify_multi", kind="transient", nth=2, count=2)])
    assert run[4].fired["transient"] == 2 and run[4].calls["verify_multi"] > 2
    assert tokens(run) == solo
    run = both(models, prompts(), decode_horizon=4, sched_kw=draft_kw(models),
               faults=[dict(site="verify_multi", kind="persistent", uid=1001)])
    reqs, eng = run[0], run[3]
    assert reqs[1].state.value == "failed"
    assert reqs[0].tokens == solo[0] and reqs[2].tokens == solo[2]
    assert not eng.state.seqs and not eng.block_mgr._ref


def test_acceptance_collapse_degrades_to_fused(models):
    kw = {"proposer": lambda kind: PKG[kind][0].SpecPolicy(
        garbage_proposer(PKG[kind][0]), ema_alpha=1.0, revive_after=100)}
    run = both(models, prompts(2), decode_horizon=4, sched_kw=kw)
    assert tokens(run) == _plain(models)["greedy"][:2]
    m = run[2].metrics
    assert m.spec["degraded_steps"] > 0 and m.decode["fused_steps"] > 0
    assert m.spec["rollback_tokens"] <= m.decode["rollback_tokens"]


def test_composes_with_chunked_prefill(models):
    def staggered(kind):
        pkg = PKG[kind][0]
        eng = engine(kind, models, decode_horizon=4)
        sched = pkg.ContinuousBatchScheduler(eng, proposer=pkg.PromptLookupProposer(),
                                             clock=Clock(), sleep=lambda s: None)
        t0 = sched._clock()
        reqs = [sched.submit(p, max_new_tokens=16, arrival_time=t0 + i * 1e-3, uid=1000 + i)
                for i, p in enumerate(prompts())]
        sched.run_until_complete()
        assert sched.metrics.prefill["chunks"] > 0 and not eng.state.seqs
        return [r.tokens for r in reqs]

    got = staggered("torch")
    assert got == _plain(models)["solo"]
    assert got == staggered("jax")


def test_proposer_requires_horizon_engine(models):
    for kind in KINDS:
        pkg = PKG[kind][0]
        with pytest.raises(ValueError, match="decode_horizon"):
            pkg.ContinuousBatchScheduler(engine(kind, models),
                                         proposer=pkg.PromptLookupProposer())


def test_draft_model_target_as_draft_accepts_every_draft(models):
    """A ``DraftModelProposer`` whose draft is the target itself: the
    context fits its window, so each draft is the target's own greedy
    continuation and the verifier accepts it; the streams are the plain
    scheduler's."""
    run = both(models, prompts(2), decode_horizon=4, sched_kw=draft_kw(models))
    assert tokens(run) == _plain(models)["greedy"][:2]
    spec = run[2].metrics.spec
    assert spec["steps"] > 0 and spec["acceptance_rate"] == 1.0


def test_register_during_speculation_is_caught(models, monkeypatch):
    """Registering a descriptor while its verify dispatch is uncommitted
    would let the prefix index cover unverified drafts: the checked cache
    refuses, and takes the registration once the rollback commits."""
    monkeypatch.setenv("DSTPU_SANITIZE", "1")
    eng = engine("torch", models, decode_horizon=4)
    t0 = int(eng.put([1], [prompts(1)[0]], greedy=True)[1])
    eng.verify_multi({1: t0}, {1: [3, 4, 5]})
    with pytest.raises(SanitizerError, match="uncommitted"):
        eng.block_mgr.register(eng.state.seqs[1])
    eng.rollback(1, 3)  # the legal path commits first
    eng.block_mgr.register(eng.state.seqs[1])


def test_uncommitted_across_step_boundary_is_caught(models, monkeypatch):
    """A scheduler that forgets to commit an absorbed verify trips the
    sanitizer's speculation check at the step boundary."""
    monkeypatch.setenv("DSTPU_SANITIZE", "1")
    eng = engine("torch", models, decode_horizon=4)
    sched = ts.ContinuousBatchScheduler(eng, proposer=ts.PromptLookupProposer(),
                                        sleep=lambda s: None)
    sched.submit(prompts(1)[0], max_new_tokens=8)
    monkeypatch.setattr(eng.__class__, "rollback", lambda self, uid, n=0: 0)
    with pytest.raises(SanitizerError, match="uncommitted"):
        for _ in range(64):
            if not sched.step():
                break
