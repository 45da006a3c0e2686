"""The port's fault injection, health supervision, adaptive limits and
durable journal against the JAX package's, on the CPU.

- ``FaultInjector``: ``random_plan`` gives the same plan for the same seed
  (numpy draws, as the reference); on a stub engine each kind fires at the
  same calls with each package's own error types; ``InjectedTrainEngine``
  wraps the port's training engine.
- ``HealthMonitor`` and ``AdaptiveLimit``: the reference's unit scenarios
  (``tests/unit/test_pool_health.py``) scripted on a virtual timeline, the
  verdicts, states, views and counters of both packages equal; in a pool,
  lease expiry absorbed through journal replay, limits and their ledger,
  and the health sanitizer on a planted leak, decided on the pool's
  injected clock and equal across the packages.
- ``DurableRequestJournal``: files byte-identical for the same entries
  (record/adopt v1, v2 and v3 kinds, commits, resolves, detaches), the
  same torn-tail repair; a pool run with durable journals writes the same
  bytes in both packages; and a journal directory written by either
  package restores in the other to the same streams
  (``tests/unit/test_pool_restore.py:85-177``).
"""

import os
import shutil

import numpy as np
import pytest

import deepspeed_tpu.resilience as jres
import deepspeed_tpu.serve as js
import deepspeed_tpu_torch.resilience as tres
import deepspeed_tpu_torch.serve as ts
from deepspeed_tpu.resilience.journal_store import _unframe
from tests.test_torch_pool import (KINDS, Side, both, make_pool, models,  # noqa: F401
                                   observe, one_torch_thread, reference, streams, workload)
from tests.test_torch_scheduler import Clock
from tests.torch_checked import checked_mode  # noqa: F401  (autouse: checked mode)

PKGS = {"jax": (jres, js), "torch": (tres, ts)}


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------
def _spec_fields(inj):
    return [(s.site, s.kind, s.nth, s.count, s.latency_s, s.uid) for s in inj.specs]


@pytest.mark.parametrize("kw", [
    dict(horizon=200, rate=0.05),
    dict(horizon=300, rate=0.03, latency_s=0.01, n_device_lost=2),
    dict(horizon=100, rate=0.1, max_burst=4, n_degraded=3, degraded_span=7),
])
def test_random_plan_same_seed_same_plan(kw):
    for seed in (0, 7, 2**31 - 1):
        plans = [pkg.FaultInjector.random_plan(seed, sleep=lambda s: None, **kw)
                 for pkg, _ in PKGS.values()]
        assert _spec_fields(plans[0]) == _spec_fields(plans[1]) and plans[1].specs
        assert plans[1].seed == seed


class _StubEngine:
    def __init__(self):
        self.calls, self.rebuilds = [], 0

    def __getattr__(self, name):
        def call(*a, **kw):
            self.calls.append(name)
            return name
        return call

    def rebuild(self):
        self.rebuilds += 1


def _drive(res):
    slept = []
    inj = res.FaultInjector([
        res.FaultSpec(site="put", kind="transient", nth=2, count=2),
        res.FaultSpec(site="decode_step", kind="latency", nth=1, latency_s=0.5),
        res.FaultSpec(site="decode_step", kind="persistent", uid=7),
        res.FaultSpec(site="put", kind="degraded", nth=5, count=2, latency_s=0.25),
        res.FaultSpec(site="verify_multi", kind="device_lost", nth=1),
    ], sleep=slept.append)
    eng = _StubEngine()
    wrapped = inj.wrap(eng)
    log = []
    script = ([("put", [1], [[1, 2]])] * 7 + [("decode_step", {3: 1})] * 2
              + [("decode_step", {7: 1}), ("flush", 7), ("verify_multi", {1: 1}, {1: [2]}),
                 ("put", [1], [[1]]), ("rebuild",), ("put", [2], [[3]])])
    for name, *args in script:
        try:
            log.append((name, getattr(wrapped, name)(*args)))
        except Exception as e:  # noqa: BLE001 - the error type is compared
            log.append((name, type(e).__name__))
    return log, eng.calls, slept, dict(inj.fired), inj.deaths, inj.revivals


def test_injected_engine_fires_the_same_faults():
    j, t = (_drive(res) for res, _ in PKGS.values())
    assert j == t
    assert ("put", "TransientEngineError") in t[0] and ("put", "DeviceLostError") in t[0]


def test_injected_train_engine_wraps_the_port_engine():
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import build_model

    model = build_model("llama-tiny", vocab_size=64, hidden_size=64, num_layers=1,
                        num_heads=2, num_kv_heads=2, intermediate_size=64, max_seq_len=32)
    cfg = {"train_batch_size": 2, "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
           "steps_per_print": 0}
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")
    inj = tres.FaultInjector([tres.FaultSpec(site="train_batch", kind="transient", nth=1),
                              tres.FaultSpec(site="step", kind="device_lost", nth=1)])
    wrapped = tres.InjectedTrainEngine(engine, inj)
    batch = {"input_ids": np.zeros((2, 16), np.int32)}
    with pytest.raises(tres.TransientEngineError):
        wrapped.train_batch(iter([batch]))
    assert engine.global_steps == 0  # the fault fired before delegation
    loss = wrapped.train_batch(iter([batch]))
    assert np.isfinite(float(loss)) and engine.global_steps == 1
    wrapped.backward(wrapped.forward(batch))
    with pytest.raises(tres.DeviceLostError):
        wrapped.step()
    assert engine.global_steps == 1
    wrapped.rebuild()
    wrapped.step()
    assert engine.global_steps == 2 and inj.revivals == 1


# ---------------------------------------------------------------------------
# health and limits, scripted
# ---------------------------------------------------------------------------
def _mon(res, **kw):
    kw.setdefault("slo_s", 0.1)
    kw.setdefault("window", 2)
    kw.setdefault("k_windows", 2)
    kw.setdefault("lease_s", 10.0)
    kw.setdefault("probe_backoff_s", 1.0)
    kw.setdefault("probe_backoff_max_s", 4.0)
    kw.setdefault("recovery_probes", 2)
    return res.HealthMonitor(clock=lambda: 0.0, **kw)


# each op: (method, args...); every op's return value and the states after
# it are recorded; the scenarios of the reference's TestHealthMonitor
_HEALTH = {
    "hysteresis": ({}, [("attach", 0, 0.0)] + [("observe", 0, 0.01, 1.0, 0.0)] * 2
                   + [("observe", 0, 0.5, 1.0, 0.0)] * 2 + [("poll", 0.0)]
                   + [("observe", 0, 0.5, 1.0, 0.0)] * 2 + [("poll", 0.0), ("poll", 0.0)]),
    "clean-window": ({}, [("attach", 0, 0.0)] + [("observe", 0, 0.5, 1.0, 0.0)] * 2
                     + [("observe", 0, 0.01, 1.0, 0.0)] * 2
                     + [("observe", 0, 0.5, 1.0, 0.0)] * 2),
    "scale": ({}, [("attach", 0, 0.0)] + [("observe", 0, 0.4, 8.0, 0.0)] * 2),
    "adaptive-slo": (dict(slo_s=None, slo_factor=4.0),
                     [("attach", 0, 0.0), ("attach", 1, 0.0), ("slo",)]
                     + [("observe", 0, 0.01, 1.0, 0.0)] * 4 + [("slo",)]
                     + [("observe", 1, 0.1, 1.0, 0.0)] * 4 + [("poll", 0.0)]),
    "lease": ({}, [("attach", 0, 0.0), ("attach", 1, 0.0), ("heartbeat", 0, 8.0),
                   ("poll", 11.0), ("observe", 0, 0.01, 1.0, 15.0), ("poll", 20.0),
                   ("poll", 30.0)]),
    "deferred": ({}, [("attach", 0, 0.0)] + [("observe", 0, 0.5, 1.0, 0.0)] * 4
                 + [("poll", 0.0), ("note_deferred", 0)]
                 + [("observe", 0, 0.5, 1.0, 0.0)] * 2 + [("poll", 0.0)]),
    "probes": ({}, [("attach", 0, 0.0)] + [("observe", 0, 0.5, 1.0, 0.0)] * 4
               + [("poll", 0.0), ("probe_due", 0, 100.0), ("note_drained", 0, 0.0),
                  ("probe_due", 0, 0.5), ("probe_due", 0, 1.0),
                  ("observe_probe", 0, 0.5, 1.0, 1.0), ("probe_due", 0, 2.5),
                  ("probe_due", 0, 3.0), ("probe_failed", 0, 3.0), ("probe_due", 0, 7.0),
                  ("probe_failed", 0, 7.0), ("probe_due", 0, 11.0),
                  ("observe_probe", 0, 0.01, 1.0, 11.0), ("probe_due", 0, 15.0),
                  ("observe_probe", 0, 0.01, 1.0, 15.0)]
               + [("observe", 0, 0.5, 1.0, 15.0)] * 2),
    "quarantined-ignores": ({}, [("attach", 0, 0.0)] + [("observe", 0, 0.5, 1.0, 0.0)] * 4
                            + [("observe", 0, 0.01, 1.0, 0.0), ("poll", 1e9),
                               ("note_lost", 0), ("note_revived", 0, 2.0),
                               ("quarantined_ids",)]),
}

_KW = {"attach": ("now",), "observe": ("scale", "now"), "heartbeat": ("now",),
       "poll": ("now",), "note_drained": ("now",), "probe_due": ("now",),
       "observe_probe": ("scale", "now"), "probe_failed": ("now",),
       "note_revived": ("now",)}


def _script(mon, ops):
    out = []
    for name, *args in ops:
        kws = _KW.get(name, ())
        pos = args[:len(args) - len(kws)]
        kw = dict(zip(kws, args[len(args) - len(kws):]))
        ret = getattr(mon, name)(*pos, **kw)
        out.append((name, ret, {r: mon.state_of(r) for r in sorted(mon._replicas)}))
    return out, mon.summary()


@pytest.mark.parametrize("name", list(_HEALTH))
def test_health_monitor_decisions_equal(name):
    kw, ops = _HEALTH[name]
    j, t = (_script(_mon(res, **kw), ops) for res, _ in PKGS.values())
    assert t == j


def test_adaptive_limit_decisions_equal():
    rng = np.random.default_rng(3)
    rtts = np.concatenate([np.full(20, 0.01), rng.uniform(0.01, 0.05, 40),
                           np.full(30, 0.2), [0.0, -1.0], np.full(30, 0.01)])
    out = []
    for res, _ in PKGS.values():
        errs = []
        for bad in (dict(initial=0), dict(min_limit=5, initial=2),
                    dict(max_limit=2, initial=4), dict(decrease=1.0),
                    dict(alpha=3.0, beta=2.0)):
            try:
                res.AdaptiveLimit(**bad)
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        lim = res.AdaptiveLimit(initial=4, min_limit=1, max_limit=16)
        trace = []
        for i, r in enumerate(rtts):
            if i % 3 == 0:
                lim.admit(i)
            if i % 5 == 0:
                lim.release(i - 3)
            lim.observe(float(r))
            trace.append((lim.limit, lim.inflight, lim.has_headroom(), lim.headroom()))
        out.append((errs, trace, lim.view()))
    assert out[0] == out[1]


class _LimReplica:
    def __init__(self, res, rid, hits, room, role="mixed"):
        self.replica_id, self.role = rid, role
        self.scheduler = type("S", (), {"live_count": 0, "queue_depth": 0})()
        self.engine = self
        self._hits = hits
        self.limit = res.AdaptiveLimit(initial=1, min_limit=1, max_limit=1)
        if not room:
            self.limit.admit(1)

    def prefix_probe(self, prompt):
        return self._hits


@pytest.mark.parametrize("rooms", [(False, True), (False, False), (True, True)])
def test_router_limit_filter(rooms):
    got = []
    for res, serve in PKGS.values():
        reps = [_LimReplica(res, 0, 5, rooms[0]), _LimReplica(res, 1, 0, rooms[1])]
        rep, hits = serve.Router().place([1, 2], reps)
        got.append((None if rep is None else rep.replica_id, hits))
    assert got[0] == got[1]


# ---------------------------------------------------------------------------
# health and limits in a pool
# ---------------------------------------------------------------------------
def _lease(side):
    prompts, uids, gen = workload(seed=31, n=4, gen=5)
    ref = reference(side, prompts, uids, gen)
    t = [0.0]
    pool, _, _ = make_pool(side, 2, clock=lambda: t[0])
    mon = pool.enable_health(side.res.HealthMonitor(clock=lambda: t[0], lease_s=5.0,
                                                    slo_s=1e9))
    reqs = [pool.submit(p, max_new_tokens=gen, uid=u) for p, u in zip(prompts, uids)]
    pool.step()
    t[0] = 100.0
    mon.heartbeat(1, now=t[0])
    supervised = pool._supervise()
    lost = (pool.replica(0).state, mon.state_of(0))
    pool.run_until_complete()
    assert streams(reqs) == ref
    pool.revive(0)
    revived = (pool.replica(0).state, mon.state_of(0), mon.lease_deadline_of(0))
    reqs.append(pool.submit([1, 2, 3], max_new_tokens=2, uid=9820))
    pool.run_until_complete()
    pool.close()
    # the latency EMAs are of wall-clock dispatch times
    health = {r: {k: v for k, v in h.items() if k != "ema_s"} for r, h in mon.summary().items()}
    return reqs, dict(observe(pool, reqs), supervised=supervised, lost=lost, revived=revived,
                      health=health)


def test_lease_expiry_absorbed_and_revived(models):
    jobs, tobs = both(models, _lease)
    assert tobs["supervised"] and tobs["lost"] == ("dead", "lost")
    assert tobs["revived"] == ("serving", "serving", 105.0)
    assert tobs["pool"]["lease_expiries"] == 1 and tobs["pool"]["replica_deaths"] == 1


def _limits(side, monkeypatch):
    monkeypatch.setenv("DSTPU_SANITIZE", "1")
    prompts, uids, gen = workload(seed=37, n=5, gen=4)
    pool, _, _ = make_pool(side, 2)
    pool.enable_limits(lambda rid: side.res.AdaptiveLimit(initial=1, min_limit=1,
                                                          max_limit=1))
    reqs, refused = [], []
    for p, u in zip(prompts, uids):
        try:
            reqs.append(pool.submit(p, max_new_tokens=gen, uid=u))
        except Exception as e:  # noqa: BLE001 - the refusal is compared
            refused.append((u, type(e).__name__))
    ledgers = [sorted(r.limit._inflight) for r in pool.replicas]
    pool.migrate(reqs[0].uid, 1 - pool.owner_of(reqs[0].uid))
    after = [sorted(r.limit._inflight) for r in pool.replicas]
    pool.run_until_complete()
    final = [sorted(r.limit._inflight) for r in pool.replicas]
    # a planted leak: the ledger holds a uid the pool does not own
    pool.replicas[0].limit.admit(424242)
    try:
        pool.step()
        leak = None
    except side.san.SanitizerError as e:
        leak = str(e).split(":")[0]
    pool.replicas[0].limit.release(424242)
    pool.close()
    return reqs, dict(observe(pool, reqs), refused=refused, ledgers=ledgers, after=after,
                      final=final, leak=leak)


def test_limits_ledger_and_health_sanitizer(models, monkeypatch):
    jobs, tobs = both(models, _limits, monkeypatch=monkeypatch)
    assert tobs["refused"] and tobs["pool"]["limit_rejects"] == len(tobs["refused"])
    assert tobs["final"] == [[], []] and tobs["leak"] is not None


# ---------------------------------------------------------------------------
# the durable journal
# ---------------------------------------------------------------------------
def _entries(res, serve):
    E = res.JournalEntry
    sp = serve.SamplingParams(temperature=0.8, top_k=40, top_p=0.9, seed=77,
                              stop=((5, 6),), logit_bias={3: -2.0})
    return [
        E(uid=1, prompt=[1, 2, 3], tokens=[], max_new_tokens=8, priority=0, deadline=None,
          arrival_time=0.25, eos_token=None),
        E(uid=2, prompt=[4, 5], tokens=[9], max_new_tokens=4, priority=3, deadline=12.5,
          arrival_time=1.0 / 3.0, eos_token=2, sampling=sp),
        E(uid=3, prompt=[6], tokens=[], max_new_tokens=2, priority=0, deadline=None,
          arrival_time=2.0, eos_token=None, tenant="acme", slo="interactive"),
        E(uid=4, prompt=[7, 8, 9], tokens=[1, 2], max_new_tokens=5, priority=1,
          deadline=None, arrival_time=3.5, eos_token=None,
          sampling=serve.SamplingParams(temperature=1.2, seed=5), tenant="beta"),
    ]


class _Req:
    """What ``record``/``commit`` read of a request."""

    def __init__(self, e):
        self.__dict__.update(vars(e))


def _write(res, serve, path, fsync):
    es = _entries(res, serve)
    with res.DurableRequestJournal(path, fsync=fsync) as j:
        for e in es[:3]:
            j.record(_Req(e))
        r = _Req(es[0])
        r.tokens = [11, 12]
        j.commit(r)
        r.tokens = [11, 12, 13]
        j.commit(r)
        j.commit(r)  # nothing new: no record
        moved = j.detach(2)
        j.adopt(moved)
        j.adopt(es[3])
        j.resolve(3)
        j.resolve(999)  # unknown: nothing appended
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("fsync", [False, True])
def test_journal_files_byte_identical(tmp_path, fsync):
    files = [_write(res, serve, str(tmp_path / f"{k}.journal"), fsync)
             for k, (res, serve) in PKGS.items()]
    assert files[0] == files[1]
    kinds = [_unframe(ln + "\n")["kind"] for ln in files[1].decode().splitlines()]
    assert kinds == ["record", "record.v2", "record.v3", "commit", "commit", "detach",
                     "adopt.v2", "adopt.v3", "resolve"]


def test_journal_reopen_and_torn_tail_equal(tmp_path):
    out = []
    for k, (res, serve) in PKGS.items():
        path = str(tmp_path / f"{k}.journal")
        _write(res, serve, path, False)
        with open(path, "ab") as f:
            f.write(b"0000dead {\"kind\": \"record\", \"uid\"")  # a torn append
        with open(path + ".compact", "w") as f:
            f.write("stale")
        j = res.DurableRequestJournal(path)
        live = [(e.uid, e.prompt, e.tokens, e.deadline, e.arrival_time, e.tenant, e.slo,
                 None if e.sampling is None else e.sampling.to_dict()) for e in j.live()]
        stats = (j.replayed_records, j.corrupt_tail_truncations, j.corrupt_tail_dropped_bytes,
                 j.stale_compact_cleanups)
        reclaimed = j.compact()
        j.close()
        with open(path, "rb") as f:
            out.append((live, stats, reclaimed, f.read()))
    assert out[0] == out[1]
    assert out[1][1][1] == 1


def _durable_run(side, directory, steps, sample=False):
    """A 2-replica pool with durable journals under ``directory``, crashed
    after ``steps`` pool steps (abandoned, no close). Returns the uids
    live at the crash, their owners and the requests."""
    prompts, uids, gen = workload(seed=43 if not sample else 47, n=5 if not sample else 4)
    sp = {u: side.serve.SamplingParams(temperature=0.8, seed=u) for u in uids} if sample \
        else {}
    pool, _, _ = make_pool(side, 2, journal_factory=lambda i: side.res.DurableRequestJournal(
        side.serve.EnginePool.journal_path(directory, i)))
    reqs = [pool.submit(p, max_new_tokens=gen, uid=u, sampling=sp.get(u))
            for p, u in zip(prompts, uids)]
    for _ in range(steps):
        if not pool.step():
            break
    live = sorted(u for rep in pool.replicas for u in rep.scheduler.journal.uids())
    owners = {u: pool.owner_of(u) for u in live}
    for rep in pool.replicas:
        rep.scheduler.journal.close()
    return live, owners, reqs, (prompts, uids, gen, sp)


def _restore(side, directory):
    pool = side.serve.EnginePool.restore(
        directory, lambda i: side.engine(i), clock=Clock(),
        retry=side.res.RetryPolicy(max_attempts=5), sleep=lambda s: None)
    restored = sorted(pool._requests)
    owners = {u: pool.owner_of(u) for u in restored}
    pool.run_until_complete()
    out = {u: (pool._requests[u].state.value, list(pool._requests[u].tokens))
           for u in restored}
    left = [rep.scheduler.journal.uids() for rep in pool.replicas]
    counters = (len(pool.replicas), pool.metrics.pool["restores"],
                pool.metrics.pool["restored_requests"])
    pool.close()
    return out, owners, left, counters


def _files(directory):
    names = sorted(os.listdir(directory))
    return {n: open(os.path.join(directory, n), "rb").read() for n in names}


@pytest.mark.parametrize("steps,sample", [(0, False), (3, False), (3, True)],
                         ids=["queued", "mid-decode", "mid-decode-sampled"])
def test_journal_directory_restores_across_packages(models, tmp_path, steps, sample):
    """Each package's crashed pool writes the same journal bytes; each
    package restores its own directory and the other's to the same
    streams, owners and counters, and every restored stream is the
    uninterrupted single-engine one."""
    runs, dirs = {}, {}
    for kind in KINDS:
        d = str(tmp_path / kind)
        os.makedirs(d)
        dirs[kind] = d
        runs[kind] = _durable_run(Side(kind, models), d, steps, sample)
    assert runs["jax"][:2] == runs["torch"][:2] and runs["torch"][0]
    assert _files(dirs["jax"]) == _files(dirs["torch"])
    live, owners, _, (prompts, uids, gen, _) = runs["torch"]
    results = []
    for writer in KINDS:
        for reader in KINDS:
            d = str(tmp_path / f"{writer}-to-{reader}")
            shutil.copytree(dirs[writer], d)
            side = Side(reader, models)
            out, rowners, left, counters = _restore(side, d)
            ref = reference(side, prompts, uids, gen, sampling=runs[reader][3][3] or None)
            assert sorted(out) == live and rowners == owners
            assert all(s == "done" and toks == ref[u] for u, (s, toks) in out.items())
            assert left == [[], []] and counters == (2, 1, len(live))
            results.append(out)
    assert all(r == results[0] for r in results)


def test_membership_from_files_and_empty_directory(models, tmp_path):
    for kind in KINDS:
        side = Side(kind, models)
        d = str(tmp_path / kind)
        os.makedirs(d)
        prompts, uids, gen = workload(seed=53, n=6)
        pool, _, _ = make_pool(side, 3, journal_factory=lambda i: side.res.DurableRequestJournal(
            side.serve.EnginePool.journal_path(d, i)))
        for p, u in zip(prompts, uids):
            pool.submit(p, max_new_tokens=gen, uid=u)
        pool.step()
        lost = sorted(u for u in uids if pool.owner_of(u) == 1)
        live = sorted(u for rep in pool.replicas for u in rep.scheduler.journal.uids())
        for rep in pool.replicas:
            rep.scheduler.journal.close()
        os.remove(side.serve.EnginePool.journal_path(d, 1))
        out, _, _, counters = _restore(side, d)
        assert counters[0] == 3 and sorted(out) == sorted(set(live) - set(lost))
        empty = str(tmp_path / f"{kind}-empty")
        os.makedirs(empty)
        with pytest.raises(ValueError, match="nothing to restore"):
            side.serve.EnginePool.restore(empty, lambda i: None)
