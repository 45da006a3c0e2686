"""The port's disaggregated pool, elastic scaling, trace generator and the
pool's KV-tier scenarios against the JAX package's, on the CPU.

- ``DisaggPool`` (``tests/unit/test_disagg.py``): role validation; a 1P+2D
  pool's KV-transfer handoffs (greedy and sampled) with the same streams,
  owners, counters, handoff bytes and ``swap_stats`` as the JAX pool's; the
  handoff payload crossing packages (each package's pool importing the
  other's exported payloads continues to the same streams); the fallback
  ladder (export failure, import rejection, a CRC corruption) replaying
  every handoff; the prefill worker's death; a deadline expiring
  mid-handoff; a clean run under ``DSTPU_SANITIZE=1``.
- ``scale_to`` and ``ElasticController``
  (``tests/unit/test_elastic_pool.py:109-424``): grow, no-op, shrink
  mid-flight, a failed grow, typed bounds, a pre-built pool, retirement,
  tenants; the controller's decisions over a stub pool and over a live
  pool under a fake clock.
- ``generate_trace`` and ``jain_fairness``: equal for the same seed.
- The KV-tier scenarios that need the pool (``tests/unit/test_kv_tier.py``):
  replica-prefixed tier events, the router's probe counting demoted
  blocks, detach/adopt of a swap-resident victim, and a rolling update
  flushing the host tier.
"""

import numpy as np
import pytest

import deepspeed_tpu.serve as js
import deepspeed_tpu_torch.serve as ts
from deepspeed_tpu_torch.analysis.sanitizer import check_tier_conservation
from tests.test_torch_pool import (KINDS, Side, _margin_models, both, make_pool,  # noqa: F401
                                   models, observe, one_torch_thread, reference, streams,
                                   workload)
from tests.test_torch_scheduler import Clock, assert_same
from tests.torch_checked import checked_mode  # noqa: F401  (autouse: checked mode)


def _disagg(side, roles, **kw):
    return make_pool(side, len(roles) if roles else 2, cls=side.serve.DisaggPool,
                     roles=roles, **kw)


# ---------------------------------------------------------------------------
# roles
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("roles", [["prefill", "verifier"], ["prefill"],
                                   ["decode", "decode"], ["prefill", "prefill"]])
def test_role_validation_equal(models, roles):
    msgs = []
    for kind in KINDS:
        with pytest.raises(ValueError) as e:
            _disagg(Side(kind, models), roles)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_roles_by_sequence_and_dict(models):
    for kind in KINDS:
        pool, _, _ = _disagg(Side(kind, models), ["prefill", "decode", "mixed"])
        pool.set_roles({0: "mixed"})
        assert [r.role for r in pool.replicas] == ["mixed", "decode", "mixed"]
        pool.close()


# ---------------------------------------------------------------------------
# the handoff
# ---------------------------------------------------------------------------
def _handoff(side, sample=False, payloads=None, breaker=None, seed=61, n=6, gen=6):
    """A 1P+2D pool (1P+1D with a ``breaker``) over the workload. The
    prefill engine's exports are recorded (``rec["out"]``); with
    ``payloads`` the export still runs (the uid leaves the source) but the
    handoff carries ``payloads[uid]`` instead."""
    prompts, uids, gen = workload(seed=seed, n=n, gen=gen, base=8600)
    sp = {u: side.serve.SamplingParams(temperature=0.8, seed=u) for u in uids} \
        if sample else {}
    ref = reference(side, prompts, uids, gen, sampling=sp or None)
    roles = ["prefill", "decode"] if breaker else ["prefill", "decode", "decode"]
    pool, engines, _ = _disagg(side, roles)
    rec = {"out": {}}
    export = engines[0].export_swap

    def recorded(uid):
        p = export(uid)
        if p is not None:
            rec["out"][uid] = p
            if payloads is not None:
                return payloads[uid]
        return p

    engines[0].export_swap = recorded
    if breaker:
        breaker(side, engines)
    reqs = [pool.submit(p, max_new_tokens=gen, uid=u, sampling=sp.get(u))
            for p, u in zip(prompts, uids)]
    first = [pool.owner_of(u) for u in uids]
    pool.run_until_complete()
    if payloads is None:
        assert streams(reqs) == ref
    swaps = [dict(e.swap_stats) for _, e in sorted(engines.items())]
    fused = engines[0].fused_cache_size
    pool.close()
    return reqs, dict(observe(pool, reqs), first=first, swaps=swaps, fused=fused,
                      payloads=rec["out"])


def _strip(obs):
    return {k: v for k, v in obs.items() if k != "payloads"}


def _handoff_stripped(side, **kw):
    reqs, obs = _handoff(side, **kw)
    return reqs, _strip(obs)


@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "temp0.8"])
def test_1p2d_kv_handoffs_match_jax(models, sample):
    runs = {k: _handoff(Side(k, models), sample=sample) for k in KINDS}
    (jreqs, jobs), (treqs, tobs) = runs["jax"], runs["torch"]
    assert_same(_margin_models(models), (jreqs, None), (treqs, None))
    assert _strip(tobs) == _strip(jobs)
    n = len(treqs)
    pm = tobs["pool"]
    assert tobs["first"] == [0] * n and pm["handoffs"] == pm["handoffs_kv"] == n
    assert pm["handoff_bytes"] > 0 and tobs["fused"] == 0
    assert tobs["swaps"][0]["swap_export"] == n
    assert tobs["swaps"][1]["swap_import"] + tobs["swaps"][2]["swap_import"] == n
    # the payloads: the same metadata, blocks within fp32 tolerance
    for uid, tp in tobs["payloads"].items():
        jp = jobs["payloads"][uid]
        assert {k: v for k, v in tp.items() if k not in ("blocks", "crc32")} == \
            {k: v for k, v in jp.items() if k not in ("blocks", "crc32")}
        for a, b in zip(tp["blocks"], jp["blocks"]):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-5, rtol=0)


@pytest.mark.parametrize("src", KINDS)
def test_handoff_payload_crosses_packages(models, src):
    """One package's exported payloads carried by the other package's
    pool: the importing decode worker continues each request to the
    exporting package's streams."""
    dst = "torch" if src == "jax" else "jax"
    sreqs, sobs = _handoff(Side(src, models))
    dreqs, dobs = _handoff(Side(dst, models), payloads=sobs["payloads"])
    assert_same(_margin_models(models), (sreqs, None), (dreqs, None))
    assert dobs["pool"]["handoffs_kv"] == len(dreqs)
    assert dobs["pool"]["handoff_bytes"] == sobs["pool"]["handoff_bytes"]


def _export_fails(side, engines):
    def boom(uid):
        raise side.res.TransientEngineError("injected export failure")
    engines[0].export_swap = boom


def _import_rejected(side, engines):
    def boom(uid, payload):
        raise side.res.EngineUsageError("injected import rejection")
    engines[1].import_swap = boom


def _crc_tampered(side, engines):
    orig = engines[0].export_swap

    def tampered(uid):
        p = orig(uid)
        if p is not None:
            p = dict(p)
            p["crc32"] = int(p["crc32"]) ^ 1
        return p
    engines[0].export_swap = tampered


@pytest.mark.parametrize("breaker", [_export_fails, _import_rejected, _crc_tampered],
                         ids=["export-failure", "import-rejection", "crc-corruption"])
def test_handoff_degrades_to_replay(models, breaker):
    jobs, tobs = both(models, _handoff_stripped, breaker=breaker, seed=73, n=4, gen=4)
    pm = tobs["pool"]
    assert pm["handoffs"] == 4 and pm["handoffs_kv"] == 0
    assert tobs["swaps"][1]["swap_import"] == 0 and tobs["swaps"][1]["orphan_drops"] == 0


def _prefill_death(side):
    prompts, uids, gen = workload(seed=79, n=4, gen=4, base=8600)
    ref = reference(side, prompts, uids, gen)
    pool, _, inj = _disagg(side, ["prefill", "decode", "decode"],
                           specs_for={0: [dict(site="put", kind="device_lost", nth=2)]})
    reqs = [pool.submit(p, max_new_tokens=gen, uid=u) for p, u in zip(prompts, uids)]
    pool.run_until_complete()
    assert streams(reqs) == ref
    pool.close()
    return reqs, dict(observe(pool, reqs), deaths=inj[0].deaths)


def test_prefill_worker_death_replays(models):
    jobs, tobs = both(models, _prefill_death)
    assert tobs["deaths"] == 1 and tobs["replicas"][0][1] == "dead"
    assert tobs["pool"]["replica_deaths"] == 1 and tobs["pool"]["death_replays"] >= 1


def _deadline_handoff(side):
    t = [0.0]
    pool, _, _ = _disagg(side, ["prefill", "decode"], clock=lambda: t[0])
    prompt = np.random.default_rng(89).integers(0, 128, 40).tolist()
    doomed = pool.submit(prompt, max_new_tokens=4, uid=8800, deadline=5.0)
    pool.step()
    t[0] = 10.0
    moved = pool._handoff(pool.replica(0), pool.replica(1), 8800)
    out = (moved, doomed.state.value, doomed.cancel_reason, type(doomed.error).__name__,
           dict(pool._inflight_handoffs))
    pool.close()
    return [doomed], dict(observe(pool, [doomed]), out=out)


def test_deadline_expired_mid_handoff_cancelled_typed(models):
    jobs, tobs = both(models, _deadline_handoff)
    assert tobs["out"] == (0, "cancelled", "deadline", "RequestFailedError", {})
    assert tobs["pool"]["handoffs"] == 0


def _sanitized_disagg(side, monkeypatch):
    monkeypatch.setenv("DSTPU_SANITIZE", "1")
    return _handoff_stripped(side, seed=67, n=4, gen=4)


def test_clean_disagg_run_under_the_sanitizer(models, monkeypatch):
    both(models, _sanitized_disagg, monkeypatch=monkeypatch)


def test_disagg_sanitizer_refuses_two_owners():
    from deepspeed_tpu.analysis import sanitizer as jsan
    from deepspeed_tpu_torch.analysis import sanitizer as tsan

    class J:
        def __init__(self, uids):
            self._u = list(uids)

        def uids(self):
            return list(self._u)

        def __contains__(self, uid):
            return uid in self._u

    msgs = []
    for san in (jsan, tsan):
        views = [(0, "prefill", J([5]), {5: object()}), (1, "decode", J([]), {})]
        with pytest.raises(san.SanitizerError) as e:
            san.check_disagg_ownership(views, {5: None}, set())
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# elastic scaling
# ---------------------------------------------------------------------------
def _serving(pool):
    return [r.replica_id for r in pool.replicas if r.state == "serving"]


def _scale(side):
    prompts, uids, gen = workload(seed=29, n=6, gen=8, base=9100)
    ref = reference(side, prompts, uids, gen)
    log = []
    pool, _, _ = make_pool(side, 1)
    log.append(pool.scale_to(3))
    log.append(_serving(pool))
    reqs = [pool.submit(p, max_new_tokens=gen, uid=u) for p, u in zip(prompts, uids)]
    log.append([pool.owner_of(u) for u in uids])
    for _ in range(3):
        pool.step()
    log.append(pool.scale_to(3))
    pool.enable_health()
    log.append(pool.scale_to(1))
    log.append((_serving(pool), len(pool.replicas), pool.health_monitor.state_of(2)))
    pool.run_until_complete()
    assert streams(reqs) == ref
    try:
        pool.scale_to(0)
    except ValueError as e:
        log.append(str(e))
    pool.close()
    try:
        pool.scale_to(3)
    except side.serve.SchedulerClosedError as e:
        log.append(type(e).__name__)
    return reqs, dict(observe(pool, reqs), log=log)


def test_scale_to_grow_shrink_and_bounds(models):
    jobs, tobs = both(models, _scale)
    log = tobs["log"]
    assert log[0] == 2 and log[1] == [0, 1, 2] and log[3] == 0 and log[4] == -2
    assert log[5] == ([0], 1, None) and log[-1] == "SchedulerClosedError"
    assert tobs["pool"]["scale_ups"] == 2 and tobs["pool"]["scale_downs"] == 2


def _grow_failure(side):
    def factory(i):
        if i == 2:
            raise RuntimeError(f"provisioning replica {i} denied")
        return side.engine(i)

    pool = side.serve.EnginePool.build(factory, 1, clock=Clock(), sleep=lambda s: None,
                                       retry=side.res.RetryPolicy(max_attempts=5))
    got = pool.scale_to(3)
    r = pool.submit([5, 6, 7, 8], max_new_tokens=3, uid=50)
    pool.run_until_complete()
    pool.close()
    return [r], dict(observe(pool, [r]), got=got)


def test_grow_failure_absorbed(models):
    jobs, tobs = both(models, _grow_failure)
    assert tobs["got"] == 1 and tobs["pool"]["scale_up_failures"] == 1


def test_prebuilt_pool_can_shrink_but_not_grow(models):
    for kind in KINDS:
        side = Side(kind, models)
        scheds = [side.serve.ContinuousBatchScheduler(
            side.engine(i), replica_id=i, escalate_losses=True, sleep=lambda s: None)
            for i in range(2)]
        pool = side.serve.EnginePool(scheds)
        with pytest.raises(side.res.EngineUsageError, match="build\\(\\) recipe"):
            pool.scale_to(3)
        assert pool.scale_to(1) == -1
        pool.close()


def _tenants(side):
    reg = side.serve.TenantRegistry()
    reg.register("a", weight=2.0, cache_blocks=3)
    reg.register("b")
    prompts, uids, gen = workload(seed=31, n=4, base=9100)
    ref = reference(side, prompts, uids, gen)
    pool, engines, _ = make_pool(side, 1, tenancy=reg)
    pool.scale_to(2)
    quota = dict(engines[1].block_mgr._owner_quota)
    reqs = [pool.submit(p, max_new_tokens=gen, uid=u, tenant=("a" if i % 2 == 0 else "b"))
            for i, (p, u) in enumerate(zip(prompts, uids))]
    for _ in range(2):
        pool.step()
    pool.scale_to(1)
    pool.run_until_complete()
    assert streams(reqs) == ref
    out = (quota, reg.outstanding("a"), reg.outstanding("b"), [r.tenant for r in reqs])
    pool.close()
    return reqs, dict(observe(pool, reqs), out=out)


def test_tenants_across_scaling(models):
    jobs, tobs = both(models, _tenants)
    assert tobs["out"] == ({"a": 3}, 0, 0, ["a", "b", "a", "b"])


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _StubSched:
    def __init__(self):
        self.live_count = self.queue_depth = self.backlog = 0

    def prefill_backlog_tokens(self):
        return self.backlog


class _StubReplica:
    def __init__(self, rid):
        self.replica_id, self.state, self.limit, self.scheduler = rid, "serving", None, \
            _StubSched()


class _StubPool:
    def __init__(self, n, clock):
        self.replicas = [_StubReplica(i) for i in range(n)]
        self._clock, self.resizes = clock, []

    def scale_to(self, n):
        cur = len(self.replicas)
        self.resizes.append(n)
        if n > cur:
            self.replicas += [_StubReplica(i) for i in range(cur, n)]
        else:
            del self.replicas[n:]
        return n - cur


def _controller(serve, script, n=1, **kw):
    """Drive ``serve.ElasticController`` over a stub pool: each script op
    sets loads (live per replica, backlog on replica 0), advances the
    clock, and ticks; returns every tick's result, the resizes and the
    counters."""
    clock = _Clock()
    pool = _StubPool(n, clock)
    for k, v in dict(min_replicas=1, max_replicas=4, capacity_per_replica=4,
                     hysteresis_ticks=3, cooldown_s=5.0).items():
        kw.setdefault(k, v)
    ctl = serve.ElasticController(pool, **kw)
    out = []
    for live, backlog, dt in script:
        for r in pool.replicas:
            r.scheduler.live_count = live[r.replica_id] if isinstance(live, list) else live
        pool.replicas[0].scheduler.backlog = backlog
        clock.t += dt
        out.append((ctl.tick(), round(ctl.utilization(), 12)))
    return out, pool.resizes, ctl.counters


_CONTROL = {
    "hysteresis": (1, {}, [(4, 0, 0)] * 3 + [(0, 0, 10.0)] + [(4, 0, 0)] * 2),
    "cooldown": (1, {}, [(4, 0, 0)] * 8 + [(4, 0, 6.0)] + [(4, 0, 0)] * 2),
    "backlog": (1, dict(backlog_high_tokens=512), [(0, 600, 0)] * 3),
    "idle-min": (2, {}, [(0, 0, 0)] * 3 + [(0, 0, 10.0)] + [(0, 0, 0)] * 5),
    "deferred": (2, dict(scale_down_at=0.45, scale_up_at=0.6),
                 [([3, 0], 0, 0)] * 3 + [([1, 0], 0, 0)] * 3),
}


@pytest.mark.parametrize("name", list(_CONTROL))
def test_elastic_controller_decisions_equal(name):
    n, kw, script = _CONTROL[name]
    assert _controller(js, script, n, **kw) == _controller(ts, script, n, **kw)


def test_elastic_controller_validation_equal():
    msgs = []
    for serve in (js, ts):
        pool = _StubPool(1, _Clock())
        for kw in (dict(min_replicas=3, max_replicas=2),
                   dict(scale_up_at=0.3, scale_down_at=0.5)):
            with pytest.raises(ValueError) as e:
                serve.ElasticController(pool, **kw)
            msgs.append(str(e.value))
    assert msgs[:2] == msgs[2:]


def _flood(side):
    prompts, uids, gen = workload(seed=37, n=6, gen=4, base=9100)
    ref = reference(side, prompts, uids, gen)
    clock = _Clock()
    pool, _, _ = make_pool(side, 1, clock=clock)
    ctl = side.serve.ElasticController(pool, min_replicas=1, max_replicas=2,
                                       capacity_per_replica=2, hysteresis_ticks=2,
                                       cooldown_s=0.0, scale_up_at=0.75, scale_down_at=0.25)
    reqs = [pool.submit(p, max_new_tokens=gen, uid=u) for p, u in zip(prompts, uids)]
    ticks = []
    for _ in range(200):
        if not pool.step():
            break
        clock.t += 1.0
        ticks.append(ctl.tick())
    for _ in range(10):
        clock.t += 1.0
        ticks.append(ctl.tick())
    assert streams(reqs) == ref
    out = (ticks, dict(ctl.counters), _serving(pool))
    pool.close()
    return reqs, dict(observe(pool, reqs), out=out)


def test_elastic_flood_then_valley(models):
    jobs, tobs = both(models, _flood)
    ticks, counters, serving = tobs["out"]
    assert counters["ups"] >= 1 and counters["downs"] >= 1 and serving == [0]


# ---------------------------------------------------------------------------
# the trace generator
# ---------------------------------------------------------------------------
def test_generate_trace_and_fairness_equal():
    def loads(pkg):
        return [pkg.TenantLoad("a", 4.0), pkg.TenantLoad("b", 1.5, slo="batch",
                                                         burst_prob=0.5, shared_prefixes=1),
                pkg.TenantLoad("c", 0.0)]

    for seed in (0, 5):
        traces = [pkg.generate_trace(loads(pkg), seed=seed, duration_s=20.0, vocab=500)
                  for pkg in (js, ts)]
        assert [tuple(vars(r).values()) for r in traces[0]] == \
            [tuple(vars(r).values()) for r in traces[1]]
        assert len(traces[1]) > 20
    for xs in ({"a": 1.0, "b": 1.0}, {"a": 1.0, "b": 0.0}, {"a": 3.0, "b": 1.0, "c": 2.0},
               {"a": float("nan"), "b": 2.0}, {}):
        assert js.jain_fairness(xs) == ts.jain_fairness(xs)
    with pytest.raises(ValueError):
        ts.generate_trace(loads(ts), seed=0, duration_s=0.0)


# ---------------------------------------------------------------------------
# the KV tiers in a pool
# ---------------------------------------------------------------------------
def test_kvtier_events_are_replica_prefixed():
    out = []
    for serve in (js, ts):
        m0, m1 = serve.ServeMetrics(), serve.ServeMetrics(replica_id=1)
        m1.observe_swap_preemption(True)
        m1.observe_swap_readmit(0.002, 1.0e6)
        ev1 = {label: v for label, v, _ in m1.events()}
        assert ev1["serve/replica1/kvtier/swap_preemptions"] == 1.0
        assert ev1["serve/replica1/kvtier/bw_bytes_per_s"] == 1.0e6
        assert ev1["serve/replica1/kvtier/swap_readmit_p95_ms"] == 2.0
        assert not any(label.startswith("serve/kvtier/") for label in ev1)
        out.append(({label for label, _, _ in m0.events()}, ev1))
    assert out[0] == out[1] and "serve/kvtier/swap_preemptions" in out[1][0]


def test_router_probe_counts_demoted_blocks(models):
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, 128, 32).tolist()
    big = rng.integers(0, 128, 128).tolist()
    got = []
    for kind in KINDS:
        eng = Side(kind, models).engine(0, num_blocks=9, host_tier_blocks=16)
        eng.put([1], [prompt], greedy=True)
        eng.flush(1)
        on_device = eng.prefix_probe(prompt)
        eng.put([2], [big], greedy=True)
        eng.flush(2)
        got.append((on_device, eng.block_mgr.host_blocks, eng.prefix_probe(prompt)))
    assert got[0] == got[1] and got[1][0] == got[1][2] == 2 and got[1][1] >= 2


def _pressure(side, num_blocks, host):
    sched = side.serve.ContinuousBatchScheduler(
        side.engine(0, num_blocks=num_blocks, host_tier_blocks=host), clock=Clock(),
        sleep=lambda s: None, swap_preemption=True if host else None,
        retry=side.res.RetryPolicy(max_attempts=5))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 127, 17).tolist() for _ in range(4)]
    reqs = [sched.submit(p, max_new_tokens=40, uid=100 + i) for i, p in enumerate(prompts)]
    return sched, sched.engine, reqs


def _detach_swapped(side):
    base, _, breqs = _pressure(side, 41, 0)
    base.run_until_complete()
    base.close()
    ref = streams(breqs)
    sched_a, eng_a, reqs = _pressure(side, 13, 32)
    for _ in range(400):
        if eng_a._swaps or not sched_a.step():
            break
    victim = next(iter(eng_a._swaps))
    eng_b = side.engine(1, num_blocks=41, host_tier_blocks=32)
    sched_b = side.serve.ContinuousBatchScheduler(eng_b, clock=Clock(), sleep=lambda s: None,
                                                  swap_preemption=True)
    entry = sched_a.detach(victim)
    resident = eng_a.swap_resident(victim)
    if side.kind == "torch":
        check_tier_conservation(eng_a)
    adopted = sched_b.adopt(entry)
    sched_a.run_until_complete()
    sched_b.run_until_complete()
    assert streams(reqs) == ref
    eng_a.block_mgr.check_invariants(eng_a.state.seqs.values())
    out = (victim, resident, adopted.state.value, sched_a.metrics.kvtier["demotions"] >= 1)
    sched_a.close()
    sched_b.close()
    return reqs, {"out": out}


def test_detach_adopt_swap_resident_victim(models):
    jobs, tobs = both(models, _detach_swapped)
    assert tobs["out"][1:] == (False, "done", True)


def _rolling_host_tier(side):
    rng = np.random.default_rng(10)
    prompt = rng.integers(0, 128, 32).tolist()
    big = rng.integers(0, 128, 128).tolist()

    def fresh(params):
        eng = side.engine(2, num_blocks=41, host_tier_blocks=0)
        eng.load_params(params)
        s = side.serve.ContinuousBatchScheduler(eng, clock=Clock(), sleep=lambda s_: None)
        r = s.submit(prompt, max_new_tokens=6, uid=1)
        s.run_until_complete()
        s.close()
        return list(r.tokens)

    v1, v2 = fresh(side.params), fresh(side.params2)
    assert v1 != v2
    pool, _, _ = make_pool(side, 2, eng_kw=dict(num_blocks=9, host_tier_blocks=16))
    e0 = pool.replica(0).engine
    e0.put([50], [prompt], greedy=True)
    e0.flush(50)
    e0.put([51], [big], greedy=True)
    e0.flush(51)
    parked = (e0.block_mgr.host_blocks >= 2, e0.block_mgr.probe(prompt) >= 2)
    t = e0.put([52], [[3, 4, 5]], greedy=True)
    e0.decode_step({52: int(t[52])}, greedy=True)
    swapped = e0.swap_out(52)
    pool.drain(0)
    pool.load_weights(0, side.params2, version="v2")
    flushed = (e0.block_mgr.host_blocks, bool(e0._swaps), e0.block_mgr.probe(prompt))
    pool.undrain(0)
    pool.drain(1)
    req = pool.submit(prompt, max_new_tokens=6, uid=9100)
    pool.run_until_complete()
    pool.undrain(1)
    pool.close()
    assert list(req.tokens) == v2
    return [req], dict(observe(pool, [req]), out=(parked, swapped, flushed))


def test_rolling_update_flushes_host_tier(models):
    jobs, tobs = both(models, _rolling_host_tier)
    assert tobs["out"] == ((True, True), True, (0, False, 0))
