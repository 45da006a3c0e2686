"""The port's host-side serving modules against the JAX package's, on the CPU.

One scripted sequence of calls runs, under one fake clock, on both
packages' ``CircuitBreaker``, ``RetryPolicy``, ``StepWatchdog``,
``RecoveryPolicy``/``RequestJournal``, ``TenantRegistry`` and
``ServeMetrics`` (with ``PoolMetrics``). Each script records what it sees —
states, gauges, delays, raised error types, snapshots — and the two
packages' records must be equal, element for element.
"""

import importlib

import numpy as np
import pytest

PACKAGES = ("deepspeed_tpu", "deepspeed_tpu_torch")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def both(script):
    records = [script(pkg) for pkg in PACKAGES]
    assert records[0] == records[1]
    assert len(records[0]) > 5
    return records[1]


def _raised(fn, *args, **kwargs):
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:  # the type's name is what both packages must agree on
        return ("raised", type(e).__name__)


def breaker_script(pkg):
    b = mod(pkg, "resilience.breaker").CircuitBreaker(failure_threshold=3, cooldown_s=0.5,
                                                      shed_priority_floor=2)
    rec, t = [], 0.0
    for event in ("f", "s", "f", "f", "f", "shed0", "shed2", "poll", "wait", "poll", "f",
                  "wait", "poll", "s", "f", "rearm", "s", "f", "f", "f", "rearm", "f"):
        t += 0.1
        if event == "f":
            b.on_failure(t)
        elif event == "s":
            b.on_success(t)
        elif event.startswith("shed"):
            rec.append(b.should_shed(int(event[4:]), t))
        elif event == "poll":
            rec.append(b.poll(t).value)
        elif event == "wait":
            t += 0.6
        else:
            b.rearm_half_open(t)
        rec.append((event, b.state.value, b.state_gauge, b.consecutive_failures))
    rec.append((b.opens, b.half_opens, b.closes, [(round(x, 6), s) for x, s in b.transitions]))
    rec.append(_raised(type(b), failure_threshold=0))
    return rec


def retry_script(pkg):
    R = mod(pkg, "resilience.retry").RetryPolicy
    rec = []
    for kw in ({}, dict(max_attempts=6, base_s=0.002, cap_s=0.05, jitter=0.5, seed=7)):
        p = R(**kw)
        for key in (0, 17, "put", "decode_step"):
            rec.append([p.delay(a, key=key) for a in range(1, p.max_attempts + 1)])
    rec.append(_raised(R(), 0))
    rec.append(_raised(R().delay, 0))
    return rec


def watchdog_script(pkg):
    W = mod(pkg, "resilience.watchdog").StepWatchdog
    rec = []
    for kw in ({}, dict(step_budget_s=0.01, escalate_after=2),
               dict(step_budget_s=0.01, escalate_after=1, hard_breach_after=2)):
        w = W(**kw)
        for kind, d, scale in (("decode", 0.005, 1), ("decode", 0.02, 1), ("prefill", 0.03, 1),
                               ("decode", 0.015, 2), ("mixed", 0.05, 1), ("decode", 0.001, 1),
                               ("decode", 0.05, 1), ("decode", 0.05, 1), ("decode", 0.05, 1)):
            rec.append((kind, _raised(w.observe, kind, d, scale)))
        rec.append((w.breaches, w.escalations, w.hard_breaches, w.worst_s,
                    sorted(w.breaches_by_kind.items())))
    rec.append(_raised(W, escalate_after=0))
    rec.append(_raised(W, hard_breach_after=0))
    return rec


class _Req:
    def __init__(self, uid, prompt, sampling=None, tenant=None):
        self.uid, self.prompt, self.tokens = uid, list(prompt), []
        self.max_new_tokens, self.priority, self.deadline = 8, uid % 3, None
        self.arrival_time, self.eos_token = 0.1 * uid, None
        self.sampling, self.tenant, self.slo = sampling, tenant, None


def recovery_script(pkg):
    rmod = mod(pkg, "resilience.recovery")
    j, pol = rmod.RequestJournal(), rmod.RecoveryPolicy(max_consecutive_rebuilds=2)
    sp = mod(pkg, "serve.sampling").SamplingParams(temperature=0.7, seed=5)
    reqs = [_Req(u, range(u, u + 4), sampling=sp if u % 2 else None,
                 tenant="a" if u == 3 else None) for u in (1, 2, 3)]
    rec = []
    for r in reqs:
        j.record(r)
    for step, r in enumerate(reqs * 2):
        r.tokens.append(step)
        j.commit(r)
    j.resolve(2)
    entry = j.detach(3)
    rec.append((entry.uid, entry.replay_tokens(), entry.tenant, entry.commits))
    j.adopt(entry)
    rec.append([(e.uid, e.prompt, e.tokens, e.priority, e.arrival_time,
                 None if e.sampling is None else e.sampling.to_dict()) for e in j.live()])
    rec.append((len(j), j.uids(), 2 in j, j.records, j.commit_points, j.resolutions,
                j.detaches, j.adoptions))
    for t, ok in ((1.0, False), (2.0, False), (3.0, False), (4.0, True), (5.0, False)):
        if ok:
            pol.note_engine_ok()
        admitted = pol.admit(t, "DeviceLostError")
        if admitted:
            pol.note_rebuilt(t, replayed=2, cancelled=0)
        rec.append((admitted, pol.rebuilds, pol.enabled))
    rec.append(pol.trail)
    rec.append((rmod.RecoveryPolicy(0).enabled, _raised(rmod.RecoveryPolicy, -1)))
    return rec


def tenancy_script(pkg):
    tmod = mod(pkg, "serve.tenancy")
    reg = tmod.TenantRegistry()
    reg.add_class("gold", priority=3, deadline_s=2.0)
    reg.register("a", weight=2.0, rate=100.0, burst=150.0, max_outstanding=2, cache_blocks=4)
    reg.register("b", weight=1.0, slo="gold")
    rec = [_raised(reg.register, "c", weight=0.0), _raised(reg.register, "c", slo="nope"),
           _raised(reg.spec, "zz"), _raised(reg.resolve, "a", "nope")]
    now = 0.0
    for i in range(8):
        now += 0.25
        tenant = "ab"[i % 2]
        spec, cls = reg.resolve(tenant, None)
        rec.append((tenant, cls.name, cls.priority, cls.deadline_s))
        rec.append(_raised(reg.precheck, tenant, 1, 60.0, now))
        got = _raised(reg.charge, tenant, 60.0, now)
        rec.append(got)
        if got[0] == "ok":
            reg.note_outstanding(tenant, 100 + i)
            rec.append(reg.wfq_tag(tenant, cls.name, 60.0))
        if i % 3 == 2:
            reg.release("a", 100 + i - 2)
        rec.append((reg.outstanding("a"), reg.outstanding("b")))
    reg.on_service(5.0)
    rec.append((reg.vtime, sorted(s.tenant_id for s in reg.tenants()), "a" in reg))
    rec.append(repr(reg.view()))
    return rec


def metrics_script(pkg):
    smod = mod(pkg, "serve.metrics")
    breaker = mod(pkg, "resilience.breaker").CircuitBreaker()
    watchdog = mod(pkg, "resilience.watchdog").StepWatchdog(step_budget_s=0.01)
    sp = mod(pkg, "serve.sampling").SamplingParams(temperature=0.5, logit_bias={1: 1.0})
    rec = []
    for replica in (None, 3):
        m = smod.ServeMetrics(replica_id=replica)
        m.submitted, m.admitted, m.completed, m.preemptions = 9, 8, 7, 2
        m.ttft_s.extend([0.01, 0.02, 0.05])
        m.tokens_generated = 40
        for i in range(5):
            m.observe_step(0.001 * (i + 1), batch=i + 1, horizon=1)
            m.observe_decode(1, fused=False)
            m.observe_gauges(queue_depth=i, live=4 - i)
            m.observe_prefill_backlog(10 * i)
        m.observe_prefill_chunk(15, interleaved=True)
        m.observe_prefill_chunk(16, interleaved=False)
        m.observe_prefill_deferred()
        m.observe_sampling_admit(sp)
        m.observe_sampled_token()
        m.observe_fanout(3)
        m.observe_stop_hit()
        m.observe_bias_refresh()
        m.observe_rollback(2)
        m.observe_tenant("a", "admitted")
        m.observe_tenant("a", "tokens", 5.0)
        breaker.on_failure(1.0)
        watchdog.observe("decode", 0.02)
        m.observe_resilience(breaker, watchdog)
        m.faults["shed"] += 1
        rec.append(m.summary())
        rec.append(m.events(step=4))
    pm = smod.PoolMetrics()
    pm.observe_placement(3)
    pm.observe_migration(rebalance=True)
    pm.observe_drain(0.5)
    pm.observe_death(replayed=2, cancelled=1)
    pm.observe_gauges([1, 2, 3], serving=3, draining=0, dead=1)
    rec.append(pm.summary())
    rec.append(pm.events(step=1))
    return rec


@pytest.mark.parametrize("script", [breaker_script, retry_script, watchdog_script,
                                    recovery_script, tenancy_script, metrics_script],
                         ids=["breaker", "retry", "watchdog", "recovery", "tenancy", "metrics"])
def test_host_module_matches_jax(script):
    both(script)


def test_request_lifecycle_and_sanitizer_match_jax(monkeypatch):
    monkeypatch.setenv("DSTPU_SANITIZE", "1")
    rec = []
    for pkg in PACKAGES:
        rmod = mod(pkg, "serve.request")
        S = rmod.RequestState
        r = rmod.Request(prompt=[1, 2, 3], max_new_tokens=2, uid=77)
        seen = [r.state.value]
        for nxt in (S.PREFILL, S.DECODE, S.PREEMPTED, S.QUEUED, S.PREFILL, S.DECODE, S.DONE):
            r.state = nxt
            seen.append((r.state.value, r.finished))
        r._emit(5)
        seen.append((r.tokens, r.remaining, r.replay_tokens(), list(r.new_tokens())))
        seen.append(_raised(setattr, r, "state", S.DECODE))
        rec.append(seen)
    assert rec[0] == rec[1]
    assert rec[1][-1] == ("raised", "IllegalTransitionError")
    san = mod("deepspeed_tpu_torch", "analysis.sanitizer")
    assert issubclass(san.SanitizerError, AssertionError)
    assert san.LEGAL_TRANSITIONS == mod("deepspeed_tpu", "analysis.sanitizer").LEGAL_TRANSITIONS


def test_prompt_lookup_proposer_and_spec_policy_match_jax():
    rng = np.random.default_rng(4)
    rec = []
    for pkg in PACKAGES:
        smod = mod(pkg, "serve.speculation")
        pol = smod.SpecPolicy(smod.PromptLookupProposer(max_ngram=3), revive_after=2)
        out = []
        for step in range(12):
            ctx = rng.integers(0, 5, 30).tolist() if step % 3 else [1, 2, 3, 1, 2, 3, 1, 2]
            drafts = pol.collect([1, 2], lambda uid, c=ctx: c[uid:], 4)
            out.append(drafts)
            for uid, d in drafts.items():
                pol.observe(uid, len(d), len(d) // (step % 4 + 1))
            out.append((pol.rate(1), pol.rate(2), pol.budget(1, 4)))
        pol.forget(1)
        out.append(_raised(smod.PromptLookupProposer, 2, 3))
        rec.append(out)
        rng = np.random.default_rng(4)
    assert rec[0] == rec[1]
