"""The port's pipelined dispatch against the JAX package's, on the CPU.

The scenarios of the JAX package's ``tests/unit/test_pipelined_dispatch.py``
that run on one engine, each through both packages: the ``pipelined=True``
scheduler against its synchronous twin (plain greedy, EOS, a stop sequence's
speculative-absorb rollback, sampled, preemption churn, the same churn
with a host tier and forced swap preemption, a device loss with a
round in flight, detach/adopt migration, cancellation mid-flight, the stage
timing split), the engine seam (``decode_dispatch`` / ``commit_step``), and
the ``check_pipeline_coherence`` sanitizer's planted violations. Inside the
port the pipelined streams must equal the synchronous ones bitwise; across
packages streams and counters must be equal under the margin rule. The
harness is ``tests/test_torch_fused_decode.py``'s.

Not ported: the checked cache's register guard (ROADMAP.md Queue 1 item
10). The engine pool's two-phase step over pipelined replicas is held in
``tests/test_torch_pool.py``.
"""

import numpy as np
import pytest

import deepspeed_tpu_torch.serve as ts
from deepspeed_tpu_torch.analysis.sanitizer import (SanitizerError, check_pipeline_coherence,
                                                    check_speculation_commit)
from deepspeed_tpu_torch.resilience.errors import EngineUsageError
from deepspeed_tpu_torch.resilience.recovery import RequestJournal
from tests.test_torch_fused_decode import (PKG, engine, models,  # noqa: F401
                                           one_torch_thread, prompts, reusable_engine, run_sched, singles,
                                           tokens)
from tests.test_torch_scheduler import Clock, assert_same
from tests.torch_checked import checked_mode  # noqa: F401  (autouse: checked mode)


def twin(models, prompts_, **kw):
    """The port's synchronous and pipelined runs and the JAX package's
    pipelined run: the port's two bitwise equal, the pipelined runs equal
    across packages, every run drained. Returns (sync, pipe) port runs."""
    sched_kw = dict(kw.pop("sched_kw", None) or {})
    sync = run_sched("torch", models, prompts_, sched_kw=dict(sched_kw, pipelined=False), **kw)
    pipe = run_sched("torch", models, prompts_, sched_kw=dict(sched_kw, pipelined=True), **kw)
    jpipe = run_sched("jax", models, prompts_, sched_kw=dict(sched_kw, pipelined=True), **kw)
    assert tokens(pipe) == tokens(sync)
    assert_same(models, jpipe, pipe)
    for run in (pipe, jpipe):
        assert run[2]._inflight is None
        assert not run[3].state.seqs and not run[3].block_mgr._ref
    return sync, pipe


# --------------------------------------------------------------------------
# bitwise twins
# --------------------------------------------------------------------------
def test_pipelined_requires_paged():
    class SlotEngine:
        paged, decode_horizon = False, 1

    for kind in ("jax", "torch"):
        with pytest.raises(ValueError, match="paged"):
            PKG[kind][0].ContinuousBatchScheduler(SlotEngine(), pipelined=True)


def test_plain_greedy(models):
    _, pipe = twin(models, prompts())
    p = pipe[2].metrics.pipeline
    assert p["dispatches"] > 0 and p["in_flight"] == 0.0
    assert p["speculative_rollbacks"] == 0


def test_eos_finish(models):
    sync = run_sched("torch", models, prompts())
    eos = tokens(sync)[0][7]
    _, pipe = twin(models, prompts(), eos=eos)
    assert any(len(t) < 16 for t in tokens(pipe))
    assert pipe[2].metrics.pipeline["speculative_rollbacks"] == 0


def test_stop_sequence_speculative_rollback(models):
    sync = run_sched("torch", models, prompts())
    stop = tuple(tokens(sync)[1][5:7])
    _, pipe = twin(models, prompts(), sampling=[dict(stop=(stop,))] * 3)
    assert len(tokens(pipe)[1]) < 16
    assert pipe[2].metrics.sampling["stop_hits"] >= 1
    assert pipe[2].metrics.pipeline["speculative_rollbacks"] >= 1


def test_sampled(models):
    twin(models, prompts(), uids=[901, 902, 903],
         sampling=[dict(temperature=0.8, top_k=40, seed=100 + i) for i in range(3)])


def test_preemption_churn(models):
    rng = np.random.default_rng(0)
    ps = [rng.integers(1, 127, 17).tolist() for _ in range(4)]
    _, pipe = twin(models, ps, gen=40, num_blocks=13,
                   sched_kw={"retry": PKG["torch"][0].RetryPolicy(max_attempts=5)})
    assert pipe[2].metrics.preemptions > 0


def test_kv_swap(models):
    """The churn with a host tier and forced swap preemption: victims leave
    through swap-out and re-admit through swap-in under the pipelined loop."""
    rng = np.random.default_rng(0)
    ps = [rng.integers(1, 127, 17).tolist() for _ in range(4)]
    _, pipe = twin(models, ps, gen=40, num_blocks=13, host_tier_blocks=32,
                   sched_kw={"retry": PKG["torch"][0].RetryPolicy(max_attempts=5),
                             "swap_preemption": True})
    assert pipe[2].metrics.preemptions > 0
    kv = pipe[2].metrics.kvtier
    assert kv["swap_out"] >= 1 and kv["swap_in"] >= 1


def test_mid_step_engine_loss(models):
    sync = run_sched("torch", models, prompts(), gen=12)
    loss = [dict(site="decode_step", kind="device_lost", nth=4)]
    runs = {kind: run_sched(kind, models, prompts(), gen=12, faults=loss,
                            sched_kw={"pipelined": True})
            for kind in ("jax", "torch")}
    pipe = runs["torch"]
    assert pipe[4].deaths == 1 and pipe[3].rebuilds == 1
    assert all(r.state.value == "done" for r in pipe[0])
    assert tokens(pipe) == tokens(sync)
    assert pipe[2].metrics.faults["engine_losses"] == 1 and len(pipe[2].journal) == 0
    assert_same(models, runs["jax"], pipe)


def _migrate(kind, models):
    pkg = PKG[kind][0]
    src = pkg.ContinuousBatchScheduler(engine(kind, models), pipelined=True, clock=Clock(),
                                       sleep=lambda s: None)
    reqs = [src.submit(p, max_new_tokens=12, uid=1000 + i) for i, p in enumerate(prompts())]
    for _ in range(30):  # past prefill, into pipelined decode
        src.step()
        if src._inflight is not None:
            break
    assert src._inflight is not None
    entry = src.detach(reqs[0].uid)
    assert src._inflight is None  # detach drained the pipe
    dst = pkg.ContinuousBatchScheduler(engine(kind, models), pipelined=True, clock=Clock(),
                                       sleep=lambda s: None)
    moved = dst.adopt(entry)
    src.run_until_complete()
    dst.run_until_complete()
    src.close()
    dst.close()
    return [moved.tokens] + [r.tokens for r in reqs[1:]]


def test_migration_detach_adopt(models):
    got = _migrate("torch", models)
    assert got == tokens(run_sched("torch", models, prompts(), gen=12))
    assert got == _migrate("jax", models)


def _cancel(kind, models):
    pkg = PKG[kind][0]
    eng = reusable_engine(kind, models)
    sched = pkg.ContinuousBatchScheduler(eng, pipelined=True, clock=Clock(),
                                         sleep=lambda s: None)
    reqs = [sched.submit(p, max_new_tokens=12, uid=1000 + i) for i, p in enumerate(prompts())]
    for _ in range(30):
        sched.step()
        if sched._inflight is not None and reqs[2].uid in sched._inflight["rows"]:
            break
    assert sched.cancel(reqs[2].uid)
    sched.run_until_complete()
    assert reqs[2].state.value == "cancelled"
    sched.close()
    assert not eng.state.seqs and not eng.block_mgr._ref
    return [r.tokens for r in reqs]


def test_cancel_mid_flight(models):
    got = _cancel("torch", models)
    assert got[:2] == tokens(run_sched("torch", models, prompts(), gen=12))[:2]
    assert got == _cancel("jax", models)


def test_stage_timing_split(models):
    sync = run_sched("torch", models, prompts())
    assert sync[2].metrics.pipeline["device_wait_ms"] == 0.0
    _, pipe = twin(models, prompts())
    p = pipe[2].metrics.pipeline
    assert p["device_wait_ms"] > 0.0 and p["absorb_ms"] > 0.0
    events = dict((k, v) for k, v, _ in pipe[2].metrics.events())
    assert events["serve/pipeline/dispatches"] == p["dispatches"]


# --------------------------------------------------------------------------
# the engine seam
# --------------------------------------------------------------------------
def test_dispatch_matches_decode_step_bitwise(models):
    prompt = prompts(1)[0]
    ref = singles(engine("torch", models), 1, prompt, 6)
    got = {}
    for kind in ("jax", "torch"):
        eng = engine(kind, models)
        t = int(eng.put([7], [prompt], greedy=True)[7])
        seq = []
        for _ in range(6):
            h = eng.decode_dispatch({7: t})
            t = h.fetch()[7]
            assert h.fetch() == {7: t}  # idempotent
            eng.commit_step(7, 0, 0)
            seq.append(t)
        d = eng.state.seqs[7]
        got[kind] = (seq, d.seen_tokens, list(d.blocks), d.uncommitted,
                     eng.ragged_cache_size)
        eng.flush(7)
    assert got["torch"][0] == ref
    assert got["torch"] == got["jax"]


def test_double_dispatch_same_uid_raises(models):
    eng = engine("torch", models)
    t = int(eng.put([1], [prompts(1)[0]], greedy=True)[1])
    h = eng.decode_dispatch({1: t})
    with pytest.raises(EngineUsageError, match="drain"):
        eng.decode_dispatch({1: t})
    h.fetch()
    eng.commit_step(1, 0, 0)
    with pytest.raises(EngineUsageError, match="empty feed"):
        eng.decode_dispatch({})
    eng.flush(1)


def test_commit_drop_rolls_back_the_fed_position(models):
    seen = {}
    for kind in ("jax", "torch"):
        eng = reusable_engine(kind, models)
        t = int(eng.put([1], [prompts(1)[0]], greedy=True)[1])
        d = eng.state.seqs[1]
        seen0 = d.seen_tokens
        h = eng.decode_dispatch({1: t})
        assert d.seen_tokens == seen0 + 1 and d.uncommitted == 1
        out = h.fetch()
        eng.commit_step(1, drop=1, retain=0)
        assert d.seen_tokens == seen0 and d.uncommitted == 0
        seen[kind] = (out, list(d.blocks), list(d.history))
        eng.flush(1)
        assert not eng.block_mgr._ref
    assert seen["torch"] == seen["jax"]


# --------------------------------------------------------------------------
# check_pipeline_coherence: planted violations
# --------------------------------------------------------------------------
class _FakeReq:
    def __init__(self, state=ts.RequestState.DECODE):
        self.state = state


def _inflight_state(models):
    """An engine with uid 1 in flight and a coherent journal and live view."""
    eng = engine("torch", models)
    prompt = prompts(1)[0]
    t = int(eng.put([1], [prompt], greedy=True)[1])
    journal = RequestJournal()
    req = ts.Request(prompt=list(prompt), max_new_tokens=8, uid=1)
    journal.record(req)
    req.tokens.append(t)
    journal.commit(req)
    handle = eng.decode_dispatch({1: t})
    return eng, journal, {1: _FakeReq()}, handle


def test_coherent_state_is_silent(models):
    eng, journal, live, handle = _inflight_state(models)
    check_pipeline_coherence(eng, journal, live, {1: 1}, dispatch_uids=[1])
    handle.fetch()
    eng.commit_step(1, 0, 0)
    check_pipeline_coherence(eng, journal, live, {})
    eng.flush(1)


@pytest.mark.parametrize("plant,match", [
    (lambda eng, journal, live: check_pipeline_coherence(eng, journal, live, {1: 1},
                                                         dispatch_uids=[1, 1]),
     "double-feed"),
    (lambda eng, journal, live: check_pipeline_coherence(eng, journal, live, {1: 2}),
     "ledger drift"),
    (lambda eng, journal, live: check_pipeline_coherence(eng, journal, {}, {1: 1}),
     "no live request"),
], ids=["double_feed", "ledger_drift", "no_live_request"])
def test_planted_ledger_violations_raise(models, plant, match):
    eng, journal, live, _ = _inflight_state(models)
    with pytest.raises(SanitizerError, match=match):
        plant(eng, journal, live)


def test_journal_ahead_of_absorb_raises(models):
    eng, journal, live, _ = _inflight_state(models)
    journal.get(1).tokens.append(42)  # a token of the unabsorbed round
    with pytest.raises(SanitizerError, match="journal ahead"):
        check_pipeline_coherence(eng, journal, live, {1: 1})


def test_rollback_refcount_drift_raises(models):
    eng, journal, live, handle = _inflight_state(models)
    handle.fetch()
    eng.commit_step(1, 0, 0)
    d = eng.state.seqs[1]
    d.blocks = d.blocks + [d.blocks[-1]] * 2  # two phantom blocks
    with pytest.raises(SanitizerError, match="refcount drift"):
        check_pipeline_coherence(eng, journal, live, {})


def test_speculation_check_honours_inflight_allowance(models):
    eng, _, _, handle = _inflight_state(models)
    with pytest.raises(SanitizerError, match="uncommitted speculation"):
        check_speculation_commit(eng)
    check_speculation_commit(eng, inflight={1: 1})
    handle.fetch()
    eng.commit_step(1, 0, 0)
    check_speculation_commit(eng)
    eng.flush(1)
