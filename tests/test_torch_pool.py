"""The port's ``EnginePool`` against the JAX package's, on the CPU.

The scenarios of the JAX package's ``tests/unit/test_pool.py``, each run
through both packages over the micro model it uses (llama-tiny, vocab 128,
hidden 64, 2 layers, blocks of 16): the same fp32 weights
(``params_from_jax``), the same engine geometry, a fake clock each (a
millisecond a read), no backoff sleeps, the same requests with explicit
uids, and each package's own ``FaultInjector`` where a replica dies. Held
equal across the packages: token streams (under the margin rule of
``tests/test_torch_scheduler.py``), request states, owner maps, replica
states, ``PoolMetrics`` counters, the pool's ``monitor_events`` (labels and
values, the wall-clock gauges excepted), the recovery trail, and every
decision (placements, migrations, rebalance moves, absorption targets).
Within the port, the reference's own invariants are held as it holds them:
a migrated, rebalanced or death-replayed request gives the uninterrupted
single-engine stream, and the ownership sanitizer refuses planted
violations.

This module also holds the harness the resilience, disaggregation and
elastic tests share: ``Side`` (one package's classes and reusable engines),
``make_pool``, ``observe`` and ``both``.
"""

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu.analysis.sanitizer as jsan
import deepspeed_tpu.resilience as jres
import deepspeed_tpu.serve as js
import deepspeed_tpu.serve.pool as jpool
import deepspeed_tpu_torch.analysis.sanitizer as tsan
import deepspeed_tpu_torch.resilience as tres
import deepspeed_tpu_torch.serve as ts
import deepspeed_tpu_torch.serve.pool as tpool
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu.runtime.transfer_engine import TransferEngine as JaxTransferEngine
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.models import build_model, params_from_jax
from tests.test_torch_scheduler import Clock, assert_same
from tests.torch_checked import checked_mode  # noqa: F401  (autouse: checked mode)

MODEL = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
             intermediate_size=128, max_seq_len=128)
ENGINE = dict(max_seqs=4, max_seq_len=128, prefill_chunk=16, block_size=16,
              token_budget=16, num_blocks=33, paged=True)
KINDS = ("jax", "torch")
# gauges and events that read the wall clock
_WALL = ("drain_duration_s", "handoff_p95_s")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the micro model gains nothing from more, and
    parallel test workers with a pool of threads each oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jm = jax_build_model("llama-tiny", **MODEL)
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    params2 = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(1)))
    return {"jm": jm, "params": params, "params2": params2,
            "tm": build_model("llama-tiny", **MODEL),
            "tparams": params_from_jax(params), "tparams2": params_from_jax(params2)}


# JAX engines kept across tests, one per (replica slot, geometry): compiling
# an engine's programs is most of a short run here; a rebuild keeps them
_JAX = {}


class Side:
    """One package: its serve / resilience / sanitizer / pool modules, and
    engines. The port's engines are fresh; the JAX package's are reused
    per (slot, geometry), rebuilt to a fresh engine's state (an empty pool,
    a cold prefix cache, a new TransferEngine, the first weights, zeroed
    counters)."""

    def __init__(self, kind, models):
        self.kind, self.models = kind, models
        jx = kind == "jax"
        self.serve = js if jx else ts
        self.res = jres if jx else tres
        self.san = jsan if jx else tsan
        self.pool_mod = jpool if jx else tpool
        self.params = models["params"] if jx else models["tparams"]
        self.params2 = models["params2"] if jx else models["tparams2"]

    def engine(self, slot=0, **kw):
        opts = dict(ENGINE, **kw)
        m = self.models
        if self.kind == "torch":
            return InferenceEngineV2(m["tm"], m["tparams"], dtype=torch.float32,
                                     device="cpu", **opts)
        key = (slot, tuple(sorted(opts.items())))
        eng = _JAX.get(key)
        if eng is None:
            eng = _JAX[key] = JaxEngine(m["jm"], m["params"], dtype=np.float32, **opts)
            return eng
        for name in ("export_swap", "import_swap"):  # a test's patches on the instance
            eng.__dict__.pop(name, None)
        eng.rebuild()
        if eng.params is not m["params"]:
            eng.load_params(m["params"])
        eng.weights_version, eng.rebuilds = None, 0
        eng.transfer = JaxTransferEngine(overlap=opts.get("transfer_overlap", True))
        eng.swap_stats = dict.fromkeys(eng.swap_stats, 0)
        return eng


def make_pool(side, n, *, specs_for=None, eng_kw=None, cls=None, clock=None, **kw):
    """An n-replica pool of ``side`` built through ``build`` (the
    reference's ``_pool``): ``specs_for`` maps replica id -> fault specs
    (that engine wrapped by the package's own ``FaultInjector``). Returns
    (pool, engines, injectors)."""
    engines, injectors = {}, {}

    def factory(i):
        eng = side.engine(i, **(eng_kw or {}))
        engines[i] = eng
        if specs_for and i in specs_for:
            injectors[i] = side.res.FaultInjector(
                [side.res.FaultSpec(**s) for s in specs_for[i]])
            return injectors[i].wrap(eng)
        return eng

    kw.setdefault("retry", side.res.RetryPolicy(max_attempts=5))
    kw.setdefault("sleep", lambda s: None)
    pool_cls = cls or side.serve.EnginePool
    pool = pool_cls.build(factory, n, clock=clock or Clock(), **kw)
    return pool, engines, injectors


def workload(seed=17, n=6, lo=8, hi=25, gen=6, base=9000):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 128, int(rng.integers(lo, hi))).tolist() for _ in range(n)]
    return prompts, [base + i for i in range(n)], gen


def sampled(side, uids):
    return {u: side.serve.SamplingParams(temperature=0.8, seed=u) for u in uids}


def events(pool, step=0):
    return {lab: v for lab, v, _ in pool.monitor_events(step)
            if "lat" not in lab and not lab.endswith(("_ms", "_s", "bytes_per_s"))
            and "/transfer/" not in lab}


def observe(pool, reqs):
    """What a pool run decided and produced, without the wall clock."""
    return {
        "states": {r.uid: r.state.value for r in reqs},
        "owners": dict(pool._owner),
        "replicas": [(r.replica_id, r.state, r.role) for r in pool.replicas],
        "pool": {k: v for k, v in pool.metrics.pool.items() if k not in _WALL},
        "events": events(pool),
        "trail": [ev for _, ev in pool.recovery.trail],
    }


def both(models, scenario, **kw):
    """``scenario(side, **kw) -> (requests, observation)`` in both
    packages: streams under the margin rule, observations equal. Returns
    the two observations."""
    (jreqs, jobs), (treqs, tobs) = (scenario(Side(k, models), **kw) for k in KINDS)
    assert_same(_margin_models(models), (jreqs, None), (treqs, None))
    if [r.tokens for r in jreqs] == [r.tokens for r in treqs]:
        assert tobs == jobs
    return jobs, tobs


def _margin_models(models):
    return models["jm"], models["params"], models["tm"], models["tparams"]


_REF = {}


def reference(side, prompts, uids, gen, sampling=None, **eng_kw):
    """The fault-free single-engine streams of ``side`` (memoized). Its
    engine is slot 0's: call it before a pool holding slot 0 is built (a
    reused JAX engine is rebuilt here)."""
    key = (side.kind, tuple(map(tuple, prompts)), tuple(uids), gen,
           tuple(sorted((sampling or {}).keys())), tuple(sorted(eng_kw.items())))
    if key not in _REF:
        sched = side.serve.ContinuousBatchScheduler(
            side.engine(0, **eng_kw), clock=Clock(), sleep=lambda s: None,
            retry=side.res.RetryPolicy(max_attempts=5))
        reqs = [sched.submit(p, max_new_tokens=gen, uid=u, sampling=(sampling or {}).get(u))
                for p, u in zip(prompts, uids)]
        sched.run_until_complete()
        sched.close()
        assert all(r.state.value == "done" for r in reqs)
        _REF[key] = {r.uid: list(r.tokens) for r in reqs}
    return _REF[key]


def streams(reqs):
    return {r.uid: list(r.tokens) for r in reqs}


# ---------------------------------------------------------------------------
# router policy (pure: the router duck-types its replica handles)
# ---------------------------------------------------------------------------
class _StubSched:
    def __init__(self, live=0, queued=0):
        self.live_count, self.queue_depth = live, queued


class _StubReplica:
    def __init__(self, rid, live=0, queued=0, hits=0, role="mixed"):
        self.replica_id, self.scheduler, self._hits = rid, _StubSched(live, queued), hits
        self.engine, self.role = self, role

    def prefix_probe(self, prompt):
        return self._hits


@pytest.mark.parametrize("reps,kw", [
    ([], {}),
    ([(1, 0, 0, 0), (0, 0, 0, 0)], {}),
    ([(0, 3, 0, 0), (1, 1, 0, 0)], {}),
    ([(0, 2, 3, 0), (1, 4, 0, 0)], {}),
    ([(0, 5, 0, 2), (1, 0, 0, 0)], {}),
    ([(0, 0, 0, 1), (1, 0, 0, 3)], {}),
    ([(0, 5, 0, 9), (1, 0, 0, 0)], {"affinity": False}),
], ids=["empty", "tie", "least-loaded", "queued", "affinity", "more-hits", "affinity-off"])
def test_router_policy(reps, kw):
    """Placement and hits of both routers over the same stub replicas."""
    got = []
    for r in (js.Router(**kw), ts.Router(**kw)):
        rep, hits = r.place([1, 2, 3], [_StubReplica(*a) for a in reps])
        got.append((None if rep is None else rep.replica_id, hits,
                    [type(r).load(_StubReplica(*a)) for a in reps]))
    assert got[0] == got[1]
    assert ts.PHASE_ROLES == js.PHASE_ROLES


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_router_phase_filter(phase):
    reps = [(0, 1, 0, 0, "prefill"), (1, 0, 0, 0, "decode"), (2, 3, 0, 1, "mixed")]
    got = [r.place([1], [_StubReplica(*a) for a in reps], phase=phase)
           for r in (js.Router(), ts.Router())]
    assert [(rep.replica_id, h) for rep, h in got][0] == [(rep.replica_id, h)
                                                         for rep, h in got][1]


def test_pool_metrics_counters():
    out = []
    for pm in (js.PoolMetrics(), ts.PoolMetrics()):
        pm.observe_placement(0)
        pm.observe_placement(3)
        pm.observe_migration()
        pm.observe_migration(rebalance=True)
        pm.observe_gauges([4, 1, 2], serving=2, draining=1, dead=0)
        pm.observe_death(2, 1)
        pm.observe_scale(1, 0, 0)
        pm.observe_handoff(True, 4096, 0.25)
        out.append((dict(pm.pool), [(k, v) for k, v, _ in pm.events(3)]))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# control plane, placement, migration
# ---------------------------------------------------------------------------
def _control_plane(side):
    """The reference's validation cases on one 2-replica pool; returns the
    type and message of each refusal."""
    pool, _, _ = make_pool(side, 2)
    out = []

    def refused(fn, *a):
        try:
            fn(*a)
        except Exception as e:  # noqa: BLE001 - recorded and compared
            out.append((type(e).__name__, str(e)))
            return
        out.append(None)

    refused(side.serve.EnginePool, [])
    refused(pool.replica, 7)
    refused(pool.migrate, 12345, 1)
    refused(pool.undrain, 0)
    refused(pool.revive, 0)
    refused(pool.load_weights, 0, None)
    req = pool.submit([1, 2, 3], max_new_tokens=2, uid=9960)
    assert pool.migrate(req.uid, pool.owner_of(req.uid)) is req
    out.append(pool.rebalance(max_moves=4))
    h = pool.health()
    out.append([(r["replica_id"], r["state"], r["live"], r["queued"]) for r in h["replicas"]])
    pool.drain(0)
    refused(pool.drain, 1)
    pool.undrain(0)
    pool.run_until_complete()
    pool.close()
    refused(pool.submit, [1, 2, 3])
    return [req], dict(observe(pool, [req]), refusals=out)


def test_control_plane_validation(models):
    jobs, tobs = both(models, _control_plane)
    assert tobs["refusals"][0][0] == "ValueError" and "at least one" in tobs["refusals"][0][1]
    assert tobs["refusals"][-1][0] == "SchedulerClosedError"


def test_duplicate_replica_ids_rejected(models):
    for kind in KINDS:
        side = Side(kind, models)
        scheds = [side.serve.ContinuousBatchScheduler(side.engine(i), replica_id=0,
                                                      sleep=lambda s: None)
                  for i in range(2)]
        with pytest.raises(ValueError, match="duplicate replica ids"):
            side.serve.EnginePool(scheds)


def _placement(side):
    """Least-loaded spread on cold caches, then affinity: a prompt whose
    two full blocks a replica caches lands there, the more loaded one."""
    pool, engines, _ = make_pool(side, 2)
    prompts, uids, gen = workload(n=4, gen=3)
    reqs = [pool.submit(p, max_new_tokens=gen, uid=u) for p, u in zip(prompts, uids)]
    spread = [pool.owner_of(u) for u in uids]
    pool.run_until_complete()
    shared = np.random.default_rng(5).integers(0, 128, 32).tolist()
    reqs.append(pool.submit(shared + [1, 2, 3], max_new_tokens=4, uid=9301))
    placed = [pool.owner_of(9301)]
    pool.run_until_complete()
    reqs.append(pool.submit(prompts[0], max_new_tokens=8, uid=9303))  # load on replica 0
    reqs.append(pool.submit(shared + [9, 9, 9, 9], max_new_tokens=4, uid=9302))
    placed += [pool.owner_of(9303), pool.owner_of(9302)]
    probe = [e.prefix_probe(shared) for _, e in sorted(engines.items())]
    pool.run_until_complete()
    pool.close()
    return reqs, dict(observe(pool, reqs), spread=spread, placed=placed, probe=probe)


def test_placement_least_loaded_then_affinity(models):
    jobs, tobs = both(models, _placement)
    assert tobs["spread"] == [0, 1, 0, 1] and tobs["probe"] == [2, 0]
    assert tobs["placed"] == [0, 0, 0]  # the follow-up goes where its prefix lives, loaded
    assert tobs["pool"]["placement_hits"] >= 1 and tobs["pool"]["affinity_blocks"] >= 2


def test_full_replicas_fall_through_then_reject(models):
    for kind in KINDS:
        side = Side(kind, models)
        pool, _, _ = make_pool(side, 2, max_queue=1)
        pool.submit([1, 2, 3], max_new_tokens=2, uid=9450)
        pool.submit([4, 5, 6], max_new_tokens=2, uid=9451)
        with pytest.raises(side.serve.QueueFullError):
            pool.submit([7, 8, 9], max_new_tokens=2, uid=9452)
        pool.run_until_complete()
        pool.close()


def _migration(side, steps, sample):
    prompts, uids, gen = workload(n=4, gen=4)
    sp = sampled(side, uids) if sample else {}
    ref = reference(side, prompts, uids, gen, sampling=sp or None)
    pool, _, _ = make_pool(side, 2)
    reqs = [pool.submit(p, max_new_tokens=gen, uid=u, sampling=sp.get(u))
            for p, u in zip(prompts, uids)]
    for _ in range(steps):
        pool.step()
    victim = reqs[0]
    assert not victim.finished
    src = pool.owner_of(victim.uid)
    pool.migrate(victim.uid, 1 - src)
    journals = (victim.uid in pool.replica(1 - src).scheduler.journal,
                victim.uid in pool.replica(src).scheduler.journal)
    pool.run_until_complete()
    assert streams(reqs) == ref  # the reference's own invariant, in each package
    pool.close()
    return reqs, dict(observe(pool, reqs), journals=journals)


@pytest.mark.parametrize("steps,sample", [(1, False), (4, False), (4, True)],
                         ids=["prefill-greedy", "decode-greedy", "decode-temp0.8"])
def test_migration_matches_jax_and_never_migrated(models, steps, sample):
    jobs, tobs = both(models, _migration, steps=steps, sample=sample)
    assert tobs["journals"] == (True, False) and tobs["pool"]["migrations"] == 1


def _rebalance(side):
    prompts, uids, gen = workload(n=4, gen=4)
    ref = reference(side, prompts, uids, gen)
    pool, _, _ = make_pool(side, 2)
    pool.drain(1)
    reqs = [pool.submit(p, max_new_tokens=gen, uid=u) for p, u in zip(prompts, uids)]
    pool.undrain(1)
    moved = pool.rebalance(max_moves=6)
    owners = dict(pool._owner)
    pool.run_until_complete()
    assert streams(reqs) == ref
    pool.close()
    return reqs, dict(observe(pool, reqs), moved=moved, after=owners)


def test_rebalance_matches_jax(models):
    jobs, tobs = both(models, _rebalance)
    assert tobs["moved"] > 0 and tobs["pool"]["rebalances"] == tobs["moved"]


# ---------------------------------------------------------------------------
# the ownership sanitizer, on planted violations
# ---------------------------------------------------------------------------
def _views(pool):
    return [(r.replica_id, r.scheduler.journal, r.scheduler._all)
            for r in pool.replicas if r.state != tpool.DEAD]


@pytest.mark.parametrize("kind", KINDS)
def test_ownership_sanitizer_refuses_planted_violations(models, kind):
    side = Side(kind, models)
    check = side.san.check_pool_ownership
    pool, _, _ = make_pool(side, 2)
    req = pool.submit([1, 2, 3, 4, 5], max_new_tokens=4, uid=9600)
    src = pool.owner_of(req.uid)
    entry = pool.replica(src).scheduler.detach(req.uid)
    pool.replica(0).scheduler.adopt(entry)
    pool.replica(1).scheduler.journal.adopt(entry)
    with pytest.raises(side.san.SanitizerError, match="double adopt"):
        check(_views(pool), pool._owner)
    pool.replica(1).scheduler.journal.detach(req.uid)
    pool._owner[req.uid] = 1
    with pytest.raises(side.san.SanitizerError, match="owner map"):
        check(_views(pool), pool._owner)
    pool._owner[req.uid] = 0
    pool.replica(0).scheduler._all.pop(req.uid)
    with pytest.raises(side.san.SanitizerError, match="orphaned entry"):
        check(_views(pool), pool._owner)
    pool.replica(0).scheduler._all[req.uid] = req
    entry = pool.replica(0).scheduler.journal.detach(req.uid)
    with pytest.raises(side.san.SanitizerError, match="unreplayable"):
        check(_views(pool), pool._owner)
    pool.replica(0).scheduler.journal.adopt(entry)
    check(_views(pool), pool._owner)
    pool.run_until_complete()
    pool.close()
    assert req.state.value == "done"


def _sanitized(side, monkeypatch):
    monkeypatch.setenv("DSTPU_SANITIZE", "1")
    prompts, uids, gen = workload(n=4, gen=4)
    pool, _, _ = make_pool(side, 2)
    reqs = [pool.submit(p, max_new_tokens=gen, uid=u) for p, u in zip(prompts, uids)]
    pool.step()
    pool.migrate(uids[1], 1 - pool.owner_of(uids[1]))
    pool.run_until_complete()
    pool.close()
    return reqs, observe(pool, reqs)


def test_sanitized_pool_run_matches_jax(models, monkeypatch):
    both(models, _sanitized, monkeypatch=monkeypatch)


# ---------------------------------------------------------------------------
# replica death
# ---------------------------------------------------------------------------
def _death(side, sample):
    prompts, uids, gen = workload(n=4, gen=4)
    sp = sampled(side, uids) if sample else {}
    ref = reference(side, prompts, uids, gen, sampling=sp or None)
    pool, engines, inj = make_pool(
        side, 3, specs_for={0: [dict(site="put", kind="device_lost", nth=2)]})
    reqs = [pool.submit(p, max_new_tokens=gen, uid=u, sampling=sp.get(u))
            for p, u in zip(prompts, uids)]
    pool.run_until_complete()
    assert streams(reqs) == ref
    dead_journal = len(pool.replica(0).scheduler.journal)
    pool.close()
    return reqs, dict(observe(pool, reqs), deaths=inj[0].deaths, dead_journal=dead_journal)


@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "temp0.8"])
def test_death_replays_across_two_survivors(models, sample):
    jobs, tobs = both(models, _death, sample=sample)
    assert tobs["deaths"] == 1 and tobs["dead_journal"] == 0
    assert [s for _, s, _ in tobs["replicas"]] == ["dead", "serving", "serving"]
    assert tobs["pool"]["replica_deaths"] == 1 and tobs["pool"]["death_replays"] == 2
    assert any(ev.startswith("engine_lost:DeviceLostError") for ev in tobs["trail"])


def _death_alone(side):
    prompts, uids, gen = workload(n=3, gen=4)
    ref = reference(side, prompts, uids, gen)
    pool, engines, inj = make_pool(
        side, 1, specs_for={0: [dict(site="put", kind="device_lost", nth=2)]})
    reqs = [pool.submit(p, max_new_tokens=gen, uid=u) for p, u in zip(prompts, uids)]
    pool.run_until_complete()
    assert streams(reqs) == ref
    pool.close()
    return reqs, dict(observe(pool, reqs), deaths=inj[0].deaths, revivals=inj[0].revivals,
                      rebuilds=engines[0].rebuilds,
                      own=pool.replica(0).scheduler.recovery.rebuilds)


def test_death_without_survivors_recovers_in_place(models):
    jobs, tobs = both(models, _death_alone)
    assert (tobs["deaths"], tobs["revivals"], tobs["rebuilds"], tobs["own"]) == (1, 1, 1, 1)
    assert tobs["trail"] == [] and tobs["replicas"][0][1] == "serving"


def test_death_budget_exhausted_escalates(models):
    for kind in KINDS:
        side = Side(kind, models)
        pool, _, _ = make_pool(side, 2,
                               recovery=side.res.RecoveryPolicy(max_consecutive_rebuilds=0),
                               specs_for={0: [dict(site="put", kind="device_lost", nth=1)]})
        pool.submit([1, 2, 3, 4, 5, 6, 7, 8], max_new_tokens=4, uid=9700)
        with pytest.raises(side.res.UnrecoverableEngineError):
            pool.run_until_complete()


def _deadline_in_death(side):
    t = [0.0]
    pool, _, _ = make_pool(side, 2, clock=lambda: t[0])
    pool.drain(1)
    doomed = pool.submit([1, 2, 3, 4, 5, 6, 7, 8], max_new_tokens=4, uid=9710, deadline=5.0)
    safe = pool.submit([9, 8, 7, 6, 5, 4, 3, 2], max_new_tokens=4, uid=9711)
    pool.undrain(1)
    pool.step()
    t[0] = 10.0
    pool._absorb_replica_loss(pool.replica(0), side.res.DeviceLostError("simulated loss"))
    err = (type(doomed.error).__name__, doomed.cancel_reason)
    pool.run_until_complete()
    pool.close()
    return [doomed, safe], dict(observe(pool, [doomed, safe]), err=err)


def test_deadline_expired_during_death_cancelled_typed(models):
    jobs, tobs = both(models, _deadline_in_death)
    assert tobs["err"] == ("RequestFailedError", "deadline")
    assert tobs["states"] == {9710: "cancelled", 9711: "done"}
    assert tobs["pool"]["death_cancelled"] == 1 and tobs["pool"]["death_replays"] == 1


def _revive(side):
    prompts, uids, gen = workload(n=4, gen=3)
    pool, _, _ = make_pool(side, 2, specs_for={0: [dict(site="put", kind="device_lost",
                                                        nth=1)]})
    reqs = [pool.submit(p, max_new_tokens=gen, uid=u) for p, u in zip(prompts, uids)]
    pool.run_until_complete()
    pool.revive(0)
    reqs.append(pool.submit([5, 5, 5, 5, 5], max_new_tokens=3, uid=9800))
    late_owner = pool.owner_of(9800)
    pool.run_until_complete()
    pool.close()
    return reqs, dict(observe(pool, reqs), late_owner=late_owner)


def test_revive_rejoins_empty_and_serves(models):
    jobs, tobs = both(models, _revive)
    assert tobs["late_owner"] == 0 and set(tobs["states"].values()) == {"done"}


# ---------------------------------------------------------------------------
# drain and rolling weight updates
# ---------------------------------------------------------------------------
def _drain(side):
    prompts, uids, gen = workload(n=4, gen=4)
    ref = reference(side, prompts, uids, gen)
    pool, _, _ = make_pool(side, 2)
    reqs = [pool.submit(p, max_new_tokens=gen, uid=u) for p, u in zip(prompts, uids)]
    for _ in range(2):
        pool.step()
    moved = pool.drain(0)
    owners = dict(pool._owner)
    pool.undrain(0)
    pool.run_until_complete()
    assert streams(reqs) == ref
    pool.close()
    return reqs, dict(observe(pool, reqs), moved=moved, drained_owners=owners)


def test_drain_migrates_all_and_rejoins(models):
    jobs, tobs = both(models, _drain)
    assert tobs["moved"] == 2 and set(tobs["drained_owners"].values()) == {1}
    assert tobs["pool"]["drains"] == 1


def _rolling(side, wrapper):
    prompts, uids, gen = workload(n=4, gen=5)
    pool, engines, _ = make_pool(side, 2)
    reqs = [pool.submit(p, max_new_tokens=gen, uid=u, deadline=1e9)
            for p, u in zip(prompts, uids)]
    versions = []
    if wrapper:
        pool.rolling_update(side.params2, version="v2", steps_between=2)
    else:
        for _ in range(2):
            pool.step()
        pool.drain(0)
        pool.load_weights(0, side.params2, version="v2")
        pool.undrain(0)
        versions.append([e.weights_version for _, e in sorted(engines.items())])
        for _ in range(2):
            pool.step()
        # a request admitted after replica 0's update, placed there
        reqs.append(pool.submit(prompts[0], max_new_tokens=gen, uid=9990))
        pool.drain(1)
        pool.load_weights(1, side.params2, version="v2")
        pool.undrain(1)
    versions.append([e.weights_version for _, e in sorted(engines.items())])
    pool.run_until_complete()
    rejects = [(r.scheduler.metrics.admission_rejects, r.scheduler.metrics.deadline_cancels)
               for r in pool.replicas]
    pool.close()
    return reqs, dict(observe(pool, reqs), versions=versions, rejects=rejects)


@pytest.mark.parametrize("wrapper", [False, True], ids=["by-hand", "rolling_update"])
def test_rolling_update_v1_v2_side_by_side(models, wrapper):
    jobs, tobs = both(models, _rolling, wrapper=wrapper)
    assert tobs["versions"][-1] == ["v2", "v2"]
    if not wrapper:
        assert tobs["versions"][0] == ["v2", None]
    assert tobs["rejects"] == [(0, 0), (0, 0)] and set(tobs["states"].values()) == {"done"}
    assert tobs["pool"]["weight_swaps"] == 2


def test_v2_request_matches_a_single_v2_engine(models):
    """After a rolling update a new request's stream is the one a single
    engine over v2 gives, in each package."""
    prompt = workload(n=1, gen=6)[0][0]
    for kind in KINDS:
        side = Side(kind, models)
        pool, _, _ = make_pool(side, 2)
        pool.rolling_update(side.params2, version="v2")
        req = pool.submit(prompt, max_new_tokens=6, uid=9991)
        pool.run_until_complete()
        pool.close()
        eng = side.engine(0)
        eng.load_params(side.params2, version="v2")
        sched = side.serve.ContinuousBatchScheduler(eng, clock=Clock(), sleep=lambda s: None)
        one = sched.submit(prompt, max_new_tokens=6, uid=9991)
        sched.run_until_complete()
        sched.close()
        assert req.tokens == one.tokens
        if kind == "jax":
            eng.load_params(models["params"])


def test_load_params_flushes_prefix_cache_and_refuses_residents(models):
    for kind in KINDS:
        side = Side(kind, models)
        eng = side.engine(0)
        sched = side.serve.ContinuousBatchScheduler(eng, clock=Clock(), sleep=lambda s: None)
        prompt = list(range(40))
        sched.submit(prompt, max_new_tokens=2, uid=9900)
        sched.run_until_complete()
        assert eng.prefix_probe(prompt) == 2
        eng.load_params(side.params2, version="v2")
        assert eng.prefix_probe(prompt) == 0
        eng.load_params(side.params)
        sched.submit(list(range(20)), max_new_tokens=6, uid=9910)
        for _ in range(3):
            sched.step()
        with pytest.raises(side.res.EngineUsageError, match="drain"):
            eng.load_params(side.params)
        sched.run_until_complete()
        sched.close()


# ---------------------------------------------------------------------------
# pipelined replicas: the two-phase step (tests/unit/test_pipelined_dispatch.py)
# ---------------------------------------------------------------------------
def _pipelined(side, pipelined, lose=False):
    prompts = workload(seed=5, n=3, gen=8)[0] + workload(seed=6, n=3, gen=8)[0]
    uids = [700 + i for i in range(len(prompts))]
    specs = {0: [dict(site="decode_step", kind="device_lost", nth=2)]} if lose else None
    pool, _, inj = make_pool(side, 3 if not lose else 2, pipelined=pipelined, specs_for=specs)
    reqs = [pool.submit(p, max_new_tokens=8, uid=u) for p, u in zip(prompts, uids)]
    pool.run_until_complete()
    pool.close()
    return reqs, dict(observe(pool, reqs), deaths=inj[0].deaths if lose else 0)


@pytest.mark.parametrize("lose", [False, True], ids=["three-replicas", "lost-in-dispatch"])
def test_pipelined_pool_matches_jax_and_synchronous(models, lose):
    """Dispatch-all then absorb-all over pipelined replicas: the JAX pool's
    streams and decisions, and within the port bitwise the synchronous
    pool's streams (a replica lost in the dispatch phase is absorbed and
    not stepped again)."""
    jobs, tobs = both(models, _pipelined, pipelined=True, lose=lose)
    sync, _ = _pipelined(Side("torch", models), False, lose)
    piped, _ = _pipelined(Side("torch", models), True, lose)
    assert streams(piped) == streams(sync)
    assert set(tobs["states"].values()) == {"done"} and tobs["deaths"] == int(lose)


@pytest.mark.parametrize("kind", KINDS)
def test_heartbeat_fed_at_each_replicas_own_absorb(models, kind):
    side = Side(kind, models)
    t = [0.0]
    pool, _, _ = make_pool(side, 3, pipelined=True, clock=lambda: t[0])
    mon = pool.enable_health(side.res.HealthMonitor(clock=lambda: t[0], lease_s=30.0))
    for rep in pool.replicas:
        orig = rep.scheduler.step_absorb

        def absorb(_orig=orig):
            out = _orig()
            t[0] += 10.0  # this replica's host phase burns 10 s
            return out
        rep.scheduler.step_absorb = absorb
    pool.step()
    deadlines = [mon.lease_deadline_of(r.replica_id) for r in pool.replicas]
    assert deadlines == [40.0, 50.0, 60.0] and all(d > t[0] for d in deadlines)
    pool.close()


# ---------------------------------------------------------------------------
# observability, streaming, shutdown
# ---------------------------------------------------------------------------
def _labels(side):
    pool, _, _ = make_pool(side, 2)
    prompts, uids, gen = workload(n=2, gen=3)
    reqs = [pool.submit(p, max_new_tokens=gen, uid=u) for p, u in zip(prompts, uids)]
    pool.step()
    h = pool.health()
    health = [(r["replica_id"], r["state"], type(r["breaker"]).__name__) for r in h["replicas"]]
    pool.run_until_complete()
    labels = [lab for lab, _, _ in pool.monitor_events(7)]
    pool.close()
    return reqs, dict(observe(pool, reqs), labels=labels, health=health)


def test_replica_labels_and_health_view(models):
    jobs, tobs = both(models, _labels)
    labels = tobs["labels"]
    assert jobs["labels"] == labels and len(labels) == len(set(labels))
    assert "serve/replica0/submitted" in labels and "serve/replica1/submitted" in labels
    assert any(lab.startswith("replica0/inference/") for lab in labels)
    assert not any(lab.startswith("serve/") and not lab.startswith(("serve/replica",
                                                                     "serve/pool/"))
                   for lab in labels)
    assert tobs["health"] == [(0, "serving", "float"), (1, "serving", "float")]


def _stream(side):
    prompt = list(range(12))
    pool, _, _ = make_pool(side, 2)
    req = pool.submit(prompt, max_new_tokens=5, uid=9940)
    got = []
    for i, tok in enumerate(pool.stream(req)):
        got.append(tok)
        if i == 2:
            pool.migrate(req.uid, 1 - pool.owner_of(req.uid))
    pool.close()
    assert got == req.tokens
    return [req], observe(pool, [req])


def test_stream_follows_migration(models):
    jobs, tobs = both(models, _stream)
    assert tobs["pool"]["migrations"] == 1


def _close(side):
    pool, engines, _ = make_pool(side, 2)
    prompts, uids, gen = workload(n=4, gen=3)
    reqs = [pool.submit(p, max_new_tokens=gen, uid=u) for p, u in zip(prompts, uids)]
    pool.close()
    assert all(r.finished for r in reqs) and not any(e.state.seqs for e in engines.values())
    return reqs, observe(pool, reqs)


def test_close_drains(models):
    both(models, _close)
