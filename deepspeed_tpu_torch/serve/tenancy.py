"""Multi-tenant QoS: tenants, SLO classes, rate limits, fair queueing
(docs/SERVING.md "Multi-tenant QoS").

A copy of ``deepspeed_tpu/serve/tenancy.py`` for the port, which imports nothing
of the JAX package; the text below is the JAX module's.

At pool scale traffic arrives from *tenants*, not anonymous requests.
One :class:`TenantRegistry` (shared by every replica of a pool) holds
the QoS policy and the cross-replica state it needs:

- **SLO classes** map a named service tier onto the primitives the
  scheduler already enforces: a ``priority`` int (the circuit breaker's
  shed floor and the preemption victim ordering read it unchanged) and
  an optional default ``deadline_s`` budget (fed to the existing
  ``deadline_guard`` early-shed path when the caller gives no explicit
  deadline).
- **Token-bucket rate limits** bound each tenant's *offered load* at
  admission: a bucket of ``burst`` tokens refilling at ``rate`` tokens
  per second, charged ``len(prompt) + max_new_tokens`` per submit.
  An empty bucket raises
  :class:`~deepspeed_tpu.resilience.errors.TenantThrottledError` with
  the refill time. Refill is computed from the clock value the caller
  passes in — the registry never reads a wall clock (DSTPU005), so a
  replayed trace throttles identically.
- **Weighted fair queueing** replaces the global priority int as the
  admission order. Flows are keyed ``(tenant, slo_class)``; each
  submission gets start/finish *virtual-time* tags (start-time fair
  queueing): ``start = max(V, finish[flow])``, ``finish = start +
  cost / weight``. The scheduler admits the smallest finish tag and
  advances ``V`` to the served start tag. Under saturation each
  tenant's admitted share converges to its weight regardless of how
  fast it submits — a tenant flooding the queue only stretches its own
  finish tags.
- **Outstanding-request quotas** (``max_outstanding``) cap a tenant's
  concurrent footprint pool-wide. Tracked as a uid set so migration
  (detach/adopt moves the uid, not new load) and replay are idempotent;
  exceeded quota raises
  :class:`~deepspeed_tpu.resilience.errors.QuotaExceededError`, which
  the pool does NOT retry on another replica (the quota is
  tenant-global).
- **Prefix-cache block quotas** (``cache_blocks``) are *enforced* in
  :class:`~deepspeed_tpu.inference.v2.ragged_manager.BlockedKVCache`
  (the scheduler pushes them over the engine's ``set_kv_quota`` seam);
  the registry is just the policy source.

Determinism: no wall clock, no RNG, no set iteration on a decision
path — bucket refill uses caller-passed ``now``; WFQ tags are pure
functions of prior admissions. The registry is a *policy* object: it
holds no engine or scheduler references and survives replica death,
migration, and restore untouched.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..resilience.errors import QuotaExceededError, TenantThrottledError


@dataclass(frozen=True)
class SLOClass:
    """A named service tier: the admission-priority int the breaker /
    preemption machinery already understands, plus an optional default
    deadline budget (seconds from arrival) applied when a submission
    carries no explicit deadline."""
    name: str
    priority: int = 0
    deadline_s: Optional[float] = None


#: the default tier ladder — ``shed_priority_floor=1`` on an open
#: breaker sheds batch first, then standard, keeping interactive alive
DEFAULT_SLO_CLASSES = (
    SLOClass("interactive", priority=2, deadline_s=None),
    SLOClass("standard", priority=1, deadline_s=None),
    SLOClass("batch", priority=0, deadline_s=None),
)


class _TokenBucket:
    """Deterministic token bucket: ``level`` refills at ``rate``/s from
    the last observed clock value, capped at ``burst``. The caller
    passes ``now`` explicitly — a replayed trace refills identically."""

    __slots__ = ("rate", "burst", "level", "last")

    def __init__(self, rate: float, burst: float):
        if rate <= 0 or burst <= 0:
            raise ValueError(
                f"token bucket needs rate > 0 and burst > 0 "
                f"(got rate={rate}, burst={burst})")
        self.rate = float(rate)
        self.burst = float(burst)
        self.level = float(burst)
        self.last = 0.0

    def _refill(self, now: float) -> None:
        if now > self.last:
            self.level = min(self.burst, self.level
                             + (now - self.last) * self.rate)
            self.last = now

    def try_take(self, cost: float, now: float) -> bool:
        self._refill(now)
        if self.level >= cost:
            self.level -= cost
            return True
        return False

    def shortfall_s(self, cost: float) -> float:
        """Seconds of refill needed before ``cost`` could be covered
        (0 when it already can). Call after a refill."""
        missing = cost - self.level
        return max(0.0, missing) / self.rate


@dataclass
class TenantSpec:
    """One tenant's QoS policy. ``weight`` is its WFQ share;
    ``rate``/``burst`` its token bucket (None = unlimited);
    ``max_outstanding`` its concurrent-request cap (None = unlimited);
    ``cache_blocks`` its prefix-cache at-rest block quota (None =
    unlimited; enforced inside ``BlockedKVCache``); ``slo`` its default
    SLO class."""
    tenant_id: str
    weight: float = 1.0
    rate: Optional[float] = None
    burst: Optional[float] = None
    max_outstanding: Optional[int] = None
    cache_blocks: Optional[int] = None
    slo: str = "standard"
    bucket: Optional[_TokenBucket] = field(default=None, repr=False)


class TenantRegistry:
    """The pool-wide tenant policy + WFQ/quota state. One instance is
    shared by every scheduler of a pool so outstanding-request quotas
    and virtual time are tenant-global, not per-replica."""

    def __init__(self, classes: Optional[List[SLOClass]] = None):
        self._classes: Dict[str, SLOClass] = {
            c.name: c for c in (classes or DEFAULT_SLO_CLASSES)}
        self._tenants: Dict[str, TenantSpec] = {}
        #: WFQ virtual time — advanced to each served start tag
        self._vtime = 0.0
        #: flow key (tenant, slo) -> last assigned finish tag
        self._flow_finish: Dict[Tuple[str, str], float] = {}
        #: tenant -> uids currently outstanding anywhere in the pool
        self._outstanding: Dict[str, Set[int]] = {}

    # ------------------------------------------------------------------
    # policy registration
    # ------------------------------------------------------------------
    def add_class(self, name: str, *, priority: int = 0,
                  deadline_s: Optional[float] = None) -> SLOClass:
        cls = SLOClass(name, priority=priority, deadline_s=deadline_s)
        self._classes[name] = cls
        return cls

    def register(self, tenant_id: str, *, weight: float = 1.0,
                 rate: Optional[float] = None,
                 burst: Optional[float] = None,
                 max_outstanding: Optional[int] = None,
                 cache_blocks: Optional[int] = None,
                 slo: str = "standard") -> TenantSpec:
        """Register (or re-register) a tenant. ``burst`` defaults to
        one second of ``rate`` when a rate is set."""
        if weight <= 0:
            raise ValueError(f"tenant {tenant_id!r}: weight must be > 0 "
                             f"(got {weight})")
        if slo not in self._classes:
            raise ValueError(
                f"tenant {tenant_id!r}: unknown SLO class {slo!r} "
                f"(have {sorted(self._classes)})")
        bucket = None
        if rate is not None:
            bucket = _TokenBucket(rate, burst if burst is not None else rate)
        spec = TenantSpec(tenant_id, weight=weight, rate=rate, burst=burst,
                          max_outstanding=max_outstanding,
                          cache_blocks=cache_blocks, slo=slo, bucket=bucket)
        self._tenants[tenant_id] = spec
        return spec

    def __contains__(self, tenant_id: str) -> bool:
        return tenant_id in self._tenants

    def spec(self, tenant_id: str) -> TenantSpec:
        try:
            return self._tenants[tenant_id]
        except KeyError:
            raise ValueError(
                f"unknown tenant {tenant_id!r} — register it on the "
                f"TenantRegistry before submitting") from None

    def tenants(self) -> List[TenantSpec]:
        """Specs in registration-stable (insertion) order."""
        return list(self._tenants.values())

    def slo_class(self, name: str) -> SLOClass:
        try:
            return self._classes[name]
        except KeyError:
            raise ValueError(
                f"unknown SLO class {name!r} "
                f"(have {sorted(self._classes)})") from None

    def resolve(self, tenant_id: str,
                slo: Optional[str] = None) -> Tuple[TenantSpec, SLOClass]:
        """The (spec, class) pair governing one submission — the
        tenant's default class unless the call overrides it."""
        spec = self.spec(tenant_id)
        return spec, self.slo_class(slo if slo is not None else spec.slo)

    # ------------------------------------------------------------------
    # admission-time checks (called by the scheduler, typed errors out)
    # ------------------------------------------------------------------
    def charge(self, tenant_id: str, cost: float, now: float) -> None:
        """Admission gate, in order: outstanding quota, then the token
        bucket (a quota-rejected request must not drain the bucket).
        Raises typed; on success the bucket is charged."""
        spec = self.spec(tenant_id)
        if spec.max_outstanding is not None:
            have = len(self._outstanding.get(tenant_id, ()))
            if have >= spec.max_outstanding:
                raise QuotaExceededError(
                    f"tenant {tenant_id!r} is at its outstanding-request "
                    f"quota ({have}/{spec.max_outstanding}); retry after "
                    f"its own requests finish", tenant=tenant_id)
        if spec.bucket is not None and not spec.bucket.try_take(cost, now):
            raise TenantThrottledError(
                f"tenant {tenant_id!r} throttled: token bucket cannot "
                f"cover cost {cost:.0f} (level {spec.bucket.level:.1f}, "
                f"rate {spec.bucket.rate:.1f}/s)", tenant=tenant_id,
                retry_after_s=spec.bucket.shortfall_s(cost))

    def precheck(self, tenant_id: str, count: int, total_cost: float,
                 now: float) -> None:
        """Check-only variant of :meth:`charge` for atomic multi-request
        admission (``n > 1`` sampling fanout): verify the outstanding
        quota fits ``count`` more requests and the bucket can cover
        ``total_cost``, mutating nothing. A subsequent per-request
        :meth:`charge` of each share is then guaranteed to succeed (the
        bucket only refills between calls, never drains)."""
        spec = self.spec(tenant_id)
        if spec.max_outstanding is not None:
            have = len(self._outstanding.get(tenant_id, ()))
            if have + count > spec.max_outstanding:
                raise QuotaExceededError(
                    f"tenant {tenant_id!r}: fanout of {count} would exceed "
                    f"its outstanding-request quota "
                    f"({have}+{count} > {spec.max_outstanding})",
                    tenant=tenant_id)
        if spec.bucket is not None:
            spec.bucket._refill(now)
            if spec.bucket.level < total_cost:
                raise TenantThrottledError(
                    f"tenant {tenant_id!r} throttled: token bucket cannot "
                    f"cover fanout cost {total_cost:.0f} "
                    f"(level {spec.bucket.level:.1f})", tenant=tenant_id,
                    retry_after_s=spec.bucket.shortfall_s(total_cost))

    def note_outstanding(self, tenant_id: str, uid: int) -> None:
        """Record a uid as outstanding (idempotent — adopt after
        migration or restore re-notes the same uid harmlessly)."""
        self._outstanding.setdefault(tenant_id, set()).add(uid)

    def release(self, tenant_id: str, uid: int) -> None:
        """A uid reached a terminal state anywhere in the pool."""
        uids = self._outstanding.get(tenant_id)
        if uids is not None:
            uids.discard(uid)

    def outstanding(self, tenant_id: str) -> int:
        return len(self._outstanding.get(tenant_id, ()))

    # ------------------------------------------------------------------
    # weighted fair queueing (start-time fair queueing tags)
    # ------------------------------------------------------------------
    def wfq_tag(self, tenant_id: str, slo: str,
                cost: float) -> Tuple[float, float]:
        """Assign (start, finish) virtual-time tags to one submission of
        ``cost`` service units on flow ``(tenant, slo)`` and advance the
        flow's finish time. Back-to-back submissions of one flow queue
        behind each other in virtual time; an idle flow's next
        submission starts at the current virtual time (no banked
        credit)."""
        spec = self.spec(tenant_id)
        key = (tenant_id, slo)
        start = max(self._vtime, self._flow_finish.get(key, 0.0))
        finish = start + cost / spec.weight
        self._flow_finish[key] = finish
        return start, finish

    def on_service(self, start_tag: float) -> None:
        """A tagged request entered service — virtual time advances to
        its start tag (monotone; never goes backwards)."""
        if start_tag > self._vtime:
            self._vtime = start_tag

    @property
    def vtime(self) -> float:
        return self._vtime

    def view(self) -> Dict[str, object]:
        """Introspection snapshot (tests, health endpoints)."""
        return {
            "vtime": self._vtime,
            "tenants": {
                t.tenant_id: {
                    "weight": t.weight,
                    "slo": t.slo,
                    "outstanding": self.outstanding(t.tenant_id),
                    "bucket_level": (None if t.bucket is None
                                     else t.bucket.level),
                    "cache_blocks": t.cache_blocks,
                } for t in self._tenants.values()},
        }
