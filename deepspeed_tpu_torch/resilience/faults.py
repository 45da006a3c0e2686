"""Deterministic, seeded fault injection for the serving stack.

A copy of ``deepspeed_tpu/resilience/faults.py`` for the port, which imports nothing
of the JAX package; the text below is the JAX module's. ``InjectedTrainEngine``
wraps the port's ``DeepSpeedEngine`` and, in place, its checkpoint engine, so
the ``ckpt_save`` / ``ckpt_commit`` sites fire inside ``save_checkpoint``.

At TPU-fleet scale faults are the steady state; a serving loop that has only
ever seen healthy engines is untested where it matters. ``FaultInjector``
injects faults at the engine call sites the scheduler uses — ``put``,
``decode_step``, ``decode_multi``, ``verify_multi``, ``flush``,
``preempt`` — through :class:`InjectedEngine`, a transparent proxy the
scheduler cannot distinguish from the real engine.

**Contract: faults fire BEFORE the wrapped call delegates.** The real
engine's host state is never mutated by a faulted call, so a retried call
passes identical arguments and containment (preempt + re-admit uninvolved
requests) starts from consistent state. This mirrors the engine's own
all-or-nothing validation discipline (a raise leaves every descriptor
intact).

**Zero overhead when disabled:** injection only exists if you wrap the
engine. An unwrapped engine has no injector code on its call path at all; a
wrapped injector with an empty plan is a counter increment per call.

A fault **plan** is a list of :class:`FaultSpec`:

- ``kind="transient"``: raise ``TransientEngineError`` on calls
  ``nth .. nth+count-1`` to ``site`` (1-based, counted per site).
- ``kind="latency"``: sleep ``latency_s`` before delegating on those calls —
  the watchdog sees the spike as a genuine slow step.
- ``kind="degraded"``: a *sustained* per-replica slowdown over the dispatch
  surface (``put``/``decode_step``/``decode_multi``/``verify_multi``): every
  call in the window ``nth .. nth+count-1`` sleeps ``latency_s`` before
  delegating — the
  gray-failure shape (a replica that is slow, not dead) the pool's
  :class:`~deepspeed_tpu.resilience.health.HealthMonitor` exists to detect.
  ``nth`` is the start index and ``nth + count`` the stop index, so a plan
  states exactly when the replica sickens and when it heals (quarantine
  probes advance the same per-site counter, which is how a probed replica
  eventually observes the recovery).
- ``kind="persistent"``: raise ``RequestFailedError(uid)`` whenever ``uid``
  appears in a request-processing call (``put``/``decode_step``/
  ``decode_multi``/``verify_multi``) — *every* time, which is what
  makes it persistent: retries keep failing until the scheduler quarantines
  the request. Restricted to the request-processing sites so a teardown path
  (``flush``/``preempt``) can always reclaim the quarantined blocks.
- ``kind="device_lost"``: on the ``nth`` call to ``site`` the fake device
  dies — ``DeviceLostError`` is raised and the injector marks the engine
  **permanently dead**: every subsequent call to *any* site keeps raising
  until :meth:`FaultInjector.revive` runs (which
  :meth:`InjectedEngine.rebuild` does after the real rebuild succeeds).
  This is the whole-engine failure mode recovery exists for; the arm sites
  mirror the dispatch surface (``put``/``decode_multi``/``verify_multi``).

``seed`` drives :meth:`FaultInjector.random_plan` (the randomized soak
test); explicit plans are deterministic by construction."""

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from .errors import DeviceLostError, RequestFailedError, TransientEngineError

#: the engine surface the scheduler drives (and therefore the fault surface)
SITES = ("put", "decode_step", "decode_multi", "verify_multi", "flush",
         "preempt")
#: the training dispatch surface (docs/RESILIENCE.md training section):
#: the ``DeepSpeedEngine`` calls a ``TrainingSupervisor`` drives, plus the
#: checkpoint-engine calls riding inside ``save_checkpoint``
#: (``ckpt_save``/``ckpt_commit``) — a torn save is a first-class fault.
TRAIN_SITES = ("train_batch", "backward", "step", "save_checkpoint",
               "load_checkpoint", "ckpt_save", "ckpt_commit")
ALL_SITES = SITES + TRAIN_SITES
_PERSISTENT_SITES = ("put", "decode_step", "decode_multi", "verify_multi")
#: sites a device-loss plan can arm on — the dispatch surface. The *effect*
#: is global regardless (once dead, every site raises), but arming on a
#: dispatch makes the death land mid-prefill / mid-decode / mid-speculation,
#: the lifecycle edges recovery must cover. ``train_batch``/``step`` are the
#: training equivalents: the death lands mid-train-step, between the last
#: durable checkpoint and the next — the replay window recovery must close.
_DEVICE_LOST_SITES = ("put", "decode_step", "decode_multi", "verify_multi",
                      "train_batch", "step")
#: ``random_plan``'s default scatter — the SERVING dispatch surface only,
#: so pre-training seeded plans are reproduced verbatim (same seed, same
#: plan is an API promise); training soaks pass ``device_lost_sites``
#: explicitly
_SERVING_DEVICE_LOST_SITES = ("put", "decode_multi", "verify_multi")
#: sites a degraded (sustained-slowdown) plan can arm on — the serving
#: dispatch surface: the slowdown must land on the calls whose wall time
#: the scheduler measures and feeds the pool's HealthMonitor. Includes
#: ``decode_step`` (unlike device-lost scatter): at decode_horizon=1 the
#: steady-state decode rides it, and a gray replica that is only slow on
#: decode is exactly the shape the detector must see.
_DEGRADED_SITES = ("put", "decode_step", "decode_multi", "verify_multi")


@dataclass
class FaultSpec:
    """One planned fault. ``site`` is one of :data:`ALL_SITES` (serving
    :data:`SITES` + training :data:`TRAIN_SITES`) or ``"*"``."""

    site: str
    #: transient | persistent | latency | degraded | device_lost
    kind: str = "transient"
    nth: Optional[int] = None        # 1-based per-site call index
    count: int = 1                   # consecutive calls affected from nth
    uid: Optional[int] = None        # persistent: the culpable request
    latency_s: float = 0.0
    message: str = ""
    fired: int = field(default=0, compare=False)  # runtime hit counter

    def __post_init__(self):
        if self.site != "*" and self.site not in ALL_SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"expected one of {ALL_SITES} or '*'")
        if self.kind == "persistent":
            if self.uid is None:
                raise ValueError("persistent fault needs a culpable uid")
            if self.site not in _PERSISTENT_SITES:
                raise ValueError(
                    "persistent faults are restricted to request-processing "
                    f"sites {_PERSISTENT_SITES} (a faulted flush/preempt "
                    "would leak the quarantined request's blocks)")
        elif self.kind == "device_lost":
            if self.nth is None:
                raise ValueError("device_lost fault needs nth (1-based "
                                 "per-site call index)")
            if self.site not in _DEVICE_LOST_SITES:
                raise ValueError(
                    "device_lost faults arm on the dispatch surface "
                    f"{_DEVICE_LOST_SITES}; once fired, EVERY site raises "
                    "until the engine is rebuilt")
        elif self.kind == "degraded":
            if self.nth is None:
                raise ValueError("degraded fault needs nth (the 1-based "
                                 "start call index; nth+count is the stop)")
            if self.latency_s <= 0.0:
                raise ValueError("degraded fault needs latency_s > 0 (the "
                                 "sustained per-call slowdown)")
            if self.site not in _DEGRADED_SITES:
                raise ValueError(
                    "degraded faults arm on the serving dispatch surface "
                    f"{_DEGRADED_SITES} — the calls whose wall time feeds "
                    "the health monitor")
        elif self.kind in ("transient", "latency"):
            if self.nth is None:
                raise ValueError(f"{self.kind} fault needs nth (1-based "
                                 "per-site call index)")
        else:
            raise ValueError(f"unknown fault kind {self.kind!r}")


class FaultInjector:
    """Holds the plan, counts per-site calls, fires matching specs.

    ``sleep`` is injectable so latency faults are testable without real
    waiting. ``enabled`` can be flipped at runtime (a kill switch for live
    chaos drills)."""

    def __init__(self, plan: Sequence[Union[FaultSpec, dict]] = (),
                 seed: int = 0, sleep: Callable[[float], None] = time.sleep):
        self.specs: List[FaultSpec] = [
            s if isinstance(s, FaultSpec) else FaultSpec(**s) for s in plan]
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.sleep = sleep
        self.enabled = True
        self.calls: Dict[str, int] = {s: 0 for s in ALL_SITES}
        self.fired: Dict[str, int] = {"transient": 0, "persistent": 0,
                                      "latency": 0, "degraded": 0,
                                      "device_lost": 0}
        #: death message while the fake device is dead; None = alive
        self.device_lost: Optional[str] = None
        self.deaths = 0      # device_lost specs that fired
        self.revivals = 0    # rebuilds observed via revive()
        self.dead_calls = 0  # calls rejected while dead (beyond the death)

    def inject(self, **kw) -> FaultSpec:
        """Append one spec to the live plan (uid-dependent specs are
        installed after submission, when uids exist)."""
        spec = FaultSpec(**kw)
        self.specs.append(spec)
        return spec

    @classmethod
    def random_plan(cls, seed: int, *, horizon: int, rate: float = 0.02,
                    sites: Sequence[str] = ("put", "decode_step"),
                    max_burst: int = 2, latency_s: float = 0.0,
                    n_device_lost: int = 0,
                    device_lost_sites: Sequence[str] = (
                        _SERVING_DEVICE_LOST_SITES),
                    n_degraded: int = 0,
                    degraded_sites: Sequence[str] = _DEGRADED_SITES,
                    degraded_latency_s: float = 0.05,
                    degraded_span: int = 40,
                    sleep: Callable[[float], None] = time.sleep
                    ) -> "FaultInjector":
        """Seeded randomized plan for soak testing: each site gets transient
        bursts at ~``rate`` per call over ``horizon`` calls (and latency
        spikes when ``latency_s > 0``). ``n_device_lost`` scatters that many
        whole-engine deaths over ``device_lost_sites`` — the engine-loss
        soak mixes them into the ordinary chaos plan. ``n_degraded``
        scatters that many sustained gray-failure windows (each
        ``degraded_span`` calls of ``degraded_latency_s`` slowdown) over
        ``degraded_sites`` — what the health-monitor soak injects. Same seed,
        same plan — the soak is rerunnable bit-for-bit. Degraded draws run
        AFTER the pre-existing draws, so a plan with ``n_degraded=0`` is
        byte-identical to one built before the kind existed (same-seed
        reproducibility is an API promise)."""
        rng = np.random.default_rng(seed)
        specs: List[FaultSpec] = []
        for site in sites:
            for n in range(1, horizon + 1):
                if rng.random() < rate:
                    kind = ("latency" if latency_s > 0 and rng.random() < 0.3
                            else "transient")
                    specs.append(FaultSpec(
                        site=site, kind=kind, nth=n,
                        count=int(rng.integers(1, max_burst + 1)),
                        latency_s=latency_s if kind == "latency" else 0.0))
        for _ in range(n_device_lost):
            site = device_lost_sites[int(rng.integers(len(device_lost_sites)))]
            specs.append(FaultSpec(site=site, kind="device_lost",
                                   nth=int(rng.integers(1, horizon + 1))))
        for _ in range(n_degraded):
            site = degraded_sites[int(rng.integers(len(degraded_sites)))]
            specs.append(FaultSpec(
                site=site, kind="degraded",
                nth=int(rng.integers(1, horizon + 1)),
                count=degraded_span, latency_s=degraded_latency_s))
        return cls(specs, seed=seed, sleep=sleep)

    def wrap(self, engine) -> "InjectedEngine":
        return InjectedEngine(engine, self)

    def on_call(self, site: str, uids: Sequence[int]) -> None:
        """Fault gate, called by the proxy before delegating. Latency specs
        sleep (several can stack); the first matching raising spec raises."""
        self.calls[site] += 1
        if self.device_lost is not None:
            # permanently dead: the device does not come back on its own.
            # Every site — including teardown — raises until revive().
            self.dead_calls += 1
            raise DeviceLostError(self.device_lost)
        if not self.enabled or not self.specs:
            return
        n = self.calls[site]
        for spec in self.specs:
            if spec.site not in (site, "*"):
                continue
            if spec.kind == "persistent":
                if spec.uid in uids:
                    spec.fired += 1
                    self.fired["persistent"] += 1
                    raise RequestFailedError(
                        spec.uid, spec.message or
                        f"injected persistent fault on uid {spec.uid} "
                        f"at {site} (call {n})")
            elif spec.nth <= n < spec.nth + spec.count:
                spec.fired += 1
                if spec.kind == "latency":
                    self.fired["latency"] += 1
                    self.sleep(spec.latency_s)
                elif spec.kind == "degraded":
                    # sustained slowdown: delay, then DELEGATE — the call
                    # succeeds slow, which is exactly what makes the gray
                    # failure invisible to the typed-error paths
                    self.fired["degraded"] += 1
                    self.sleep(spec.latency_s)
                elif spec.kind == "device_lost":
                    self.fired["device_lost"] += 1
                    self.deaths += 1
                    self.device_lost = (
                        spec.message or
                        f"injected device loss at {site} call {n}")
                    raise DeviceLostError(self.device_lost)
                else:
                    self.fired["transient"] += 1
                    raise TransientEngineError(
                        spec.message or
                        f"injected transient fault at {site} call {n}")

    def revive(self) -> None:
        """A fresh engine incarnation replaced the dead one (called by
        :meth:`InjectedEngine.rebuild` after the inner rebuild succeeds).
        Planned specs stay armed — a later ``device_lost`` spec can kill
        the *next* incarnation too, which is what the N>=2-deaths
        acceptance row exercises."""
        if self.device_lost is not None:
            self.revivals += 1
            self.device_lost = None


class InjectedEngine:
    """Fault-injecting proxy over an ``InferenceEngineV2`` (duck-typed).

    Only the scheduler-facing step/teardown methods are intercepted; every other
    attribute (``state``, ``kv``, ``paged``, ``query``, …) resolves straight
    through to the inner engine, so the scheduler, the bench, and the tests
    are oblivious to the wrapping."""

    def __init__(self, engine, injector: FaultInjector):
        self.inner = engine
        self.injector = injector

    def put(self, batch_uids, batch_tokens, *a, **kw):
        self.injector.on_call("put", list(batch_uids))
        return self.inner.put(batch_uids, batch_tokens, *a, **kw)

    def decode_step(self, tokens, *a, **kw):
        self.injector.on_call("decode_step", list(tokens))
        return self.inner.decode_step(tokens, *a, **kw)

    def decode_dispatch(self, tokens, *a, **kw):
        # the pipelined deferred-sync twin of decode_step shares its fault
        # site: a faulted dispatch never enters the in-flight ledger, so the
        # retry (or the recovery replay) re-plans the WHOLE round
        self.injector.on_call("decode_step", list(tokens))
        return self.inner.decode_dispatch(tokens, *a, **kw)

    def decode_multi(self, tokens, *a, **kw):
        # fires BEFORE delegation like every site: a faulted fused step never
        # half-advances the horizon — the retry re-runs the WHOLE step
        self.injector.on_call("decode_multi", list(tokens))
        return self.inner.decode_multi(tokens, *a, **kw)

    def verify_multi(self, tokens, drafts, *a, **kw):
        # same pre-delegation contract as decode_multi: a faulted verify
        # never advances any cache position, and the scheduler retries the
        # step with the SAME drafts — the verified round is verbatim
        self.injector.on_call("verify_multi", list(tokens))
        return self.inner.verify_multi(tokens, drafts, *a, **kw)

    def flush(self, uid):
        self.injector.on_call("flush", [uid])
        return self.inner.flush(uid)

    def preempt(self, uid):
        self.injector.on_call("preempt", [uid])
        return self.inner.preempt(uid)

    def rebuild(self, *a, **kw):
        # NOT a fault site: the dead incarnation is being REPLACED, not
        # called — rebuild bypasses the gate, and a successful rebuild
        # revives the injector so the new incarnation serves (until a later
        # device_lost spec kills it too)
        out = self.inner.rebuild(*a, **kw)
        self.injector.revive()
        return out

    def __getattr__(self, name):
        return getattr(self.inner, name)


class _InjectedCheckpointEngine:
    """Fault proxy over a checkpoint engine's durability surface: ``save``
    (each state-dict file) and ``commit`` (the tag's durability point).
    Faulting them *before* delegation models a torn write the atomic
    rename discipline turns into a clean absence — a faulted ``ckpt_save``
    leaves the previous file intact, a faulted ``ckpt_commit`` leaves
    ``latest`` on the previous durable tag."""

    def __init__(self, engine, injector: FaultInjector):
        self.inner = engine
        self.injector = injector

    def save(self, state_dict, path):
        self.injector.on_call("ckpt_save", [])
        return self.inner.save(state_dict, path)

    def commit(self, tag):
        self.injector.on_call("ckpt_commit", [])
        return self.inner.commit(tag)

    def __getattr__(self, name):
        return getattr(self.inner, name)


class InjectedTrainEngine:
    """Fault-injecting proxy over a ``DeepSpeedEngine`` (duck-typed) — the
    training counterpart of :class:`InjectedEngine`, consumed by
    ``resilience.training.TrainingSupervisor``.

    Same pre-delegation contract: a faulted call never half-mutates the
    engine, so a retry re-runs the micro-step verbatim (the supervisor
    re-pulls the same batches). The engine's own checkpoint engine is
    wrapped in place so the ``ckpt_save``/``ckpt_commit`` sites fire inside
    ``save_checkpoint``'s real write path, not on a parallel copy.

    ``rebuild()`` models training's recovery shape: unlike serving there is
    no pool geometry to reconstruct — the engine object (and its compiled
    programs) survives; only device state is declared lost. Rebuild
    therefore just revives the injector; the supervisor then restores
    device state via ``load_checkpoint`` (which is itself a fault site, so
    a storm can hit the recovery path too)."""

    def __init__(self, engine, injector: FaultInjector):
        self.inner = engine
        self.injector = injector
        # an engine without a checkpoint engine (a test double) is left as is
        ckpt = getattr(engine, "checkpoint_engine", None)
        if ckpt is not None:
            engine.checkpoint_engine = _InjectedCheckpointEngine(ckpt, injector)

    def train_batch(self, data_iter=None):
        self.injector.on_call("train_batch", [])
        return self.inner.train_batch(data_iter)

    def forward(self, *a, **kw):
        # not a fault site of its own: the fused paths never call it, and
        # the unfused loop's fault surface is train_batch/backward/step
        return self.inner.forward(*a, **kw)

    def backward(self, *a, **kw):
        self.injector.on_call("backward", [])
        return self.inner.backward(*a, **kw)

    def step(self, *a, **kw):
        self.injector.on_call("step", [])
        return self.inner.step(*a, **kw)

    def save_checkpoint(self, *a, **kw):
        self.injector.on_call("save_checkpoint", [])
        return self.inner.save_checkpoint(*a, **kw)

    def load_checkpoint(self, *a, **kw):
        self.injector.on_call("load_checkpoint", [])
        return self.inner.load_checkpoint(*a, **kw)

    def rebuild(self):
        self.injector.revive()
        return self

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __setattr__(self, name, value):
        # the proxy owns only its two plumbing slots; every other assignment
        # lands on the inner engine so callers that set engine attributes
        # (tests pinning compiled fns, schedulers) hit the real object
        if name in ("inner", "injector"):
            object.__setattr__(self, name, value)
        else:
            setattr(self.inner, name, value)
