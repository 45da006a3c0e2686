"""Seeded multi-tenant production-trace generator (docs/SERVING.md
"Multi-tenant QoS"; the ``multi_tenant`` bench row replays these).

A copy of ``deepspeed_tpu/serve/trace.py`` for the port, which imports nothing
of the JAX package; the text below is the JAX module's.

Production serving load is none of the things microbenchmarks are: it
is bursty (arrivals cluster), diurnal (load swings over the day), heavy
tailed (most prompts are short, a few are enormous) and skewed (a few
tenants dominate). This module synthesizes all four shapes from ONE
integer seed, so a trace is a value — the same seed replays the exact
same offered load against a static pool, an elastic pool, or next
month's scheduler, and differences in the results are differences in
the system, never in the workload.

Per tenant, arrivals are a non-homogeneous Poisson process (thinning
against a sinusoidal diurnal envelope), each arrival optionally
expanding into a short Poisson burst (the retry/fan-page shape). Prompt
lengths are lognormal (heavy tail, clipped to a ceiling); prompts draw
their head from a small per-tenant pool of shared prefixes — tenants
re-send their own system prompts, which is exactly the locality the
prefix cache and its per-tenant quotas are fighting over.

Determinism (DSTPU005): everything derives from ``random.Random(seed)``
— no wall clock, no global RNG; arrival times are VIRTUAL seconds, the
replayer maps them onto its own injected clock.
"""

import math
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["TraceRequest", "TenantLoad", "generate_trace", "jain_fairness"]


@dataclass(frozen=True)
class TraceRequest:
    """One offered request: arrives at virtual second ``at``."""
    at: float
    tenant: str
    slo: str
    prompt: Tuple[int, ...]
    max_new_tokens: int


@dataclass
class TenantLoad:
    """One tenant's offered-load shape inside a trace.

    ``rate_hz`` is the tenant's mean arrival rate at the diurnal PEAK;
    a misbehaving tenant is modeled by multiplying it (the bench's 10×
    aggressor) — nothing else about the trace changes, which is the
    point: isolation means the others' percentiles stay put anyway."""
    tenant_id: str
    rate_hz: float
    slo: str = "standard"
    prompt_len_median: int = 48
    prompt_len_sigma: float = 0.6      # lognormal shape: heavy tail
    prompt_len_max: int = 160
    max_new_tokens: int = 16
    shared_prefixes: int = 3           # system prompts this tenant re-sends
    shared_prefix_len: int = 16
    burst_prob: float = 0.15           # arrival expands into a burst
    burst_mean: float = 2.0            # extra arrivals per burst (geometric)


def _envelope(t: float, period_s: float, floor: float) -> float:
    """Diurnal rate multiplier in [floor, 1]: a full sinusoidal 'day'
    every ``period_s`` virtual seconds, peak at t = period/4."""
    return floor + (1.0 - floor) * 0.5 * (1.0 + math.sin(
        2.0 * math.pi * t / period_s))


def generate_trace(tenants: Sequence[TenantLoad], *,
                   seed: int,
                   duration_s: float,
                   diurnal_period_s: Optional[float] = None,
                   diurnal_floor: float = 0.25,
                   vocab: int = 1000) -> List[TraceRequest]:
    """Synthesize the merged, time-ordered request trace.

    Each tenant is an independent thinned Poisson process under the
    shared diurnal envelope (``diurnal_period_s`` defaults to the full
    duration: one valley mid-trace — the window an elastic pool earns
    its keep in). Returns requests sorted by ``(at, tenant, seq)``;
    token ids avoid 0/1 (reserved pad/EOS in the bench model).
    """
    if duration_s <= 0:
        raise ValueError("duration_s must be positive")
    period = diurnal_period_s or duration_s
    out: List[TraceRequest] = []
    for tl in tenants:
        # one private stream per tenant: adding a tenant (or boosting
        # one's rate) never perturbs another tenant's arrivals
        # str seeds hash deterministically (SHA-512 inside random.seed);
        # a tuple seed would TypeError and hash() is salted per process
        rng = random.Random(f"{seed}:{tl.tenant_id}")  # dstpu-lint: ignore[DSTPU005]
        prefixes = [
            tuple(rng.randrange(2, vocab) for _ in range(tl.shared_prefix_len))
            for _ in range(max(1, tl.shared_prefixes))]

        def one_prompt() -> Tuple[int, ...]:
            n = int(rng.lognormvariate(math.log(tl.prompt_len_median),
                                       tl.prompt_len_sigma))
            n = max(4, min(n, tl.prompt_len_max))
            head = rng.choice(prefixes)
            body = tuple(rng.randrange(2, vocab)
                         for _ in range(max(1, n - len(head))))
            return head + body

        t = 0.0
        lam = tl.rate_hz
        if lam <= 0:
            continue
        while True:
            t += rng.expovariate(lam)           # homogeneous candidate
            if t >= duration_s:
                break
            if rng.random() >= _envelope(t, period, diurnal_floor):
                continue                        # thinned out of the valley
            n_arrivals = 1
            if rng.random() < tl.burst_prob:
                # geometric burst: mean burst_mean extra arrivals
                p = 1.0 / (1.0 + tl.burst_mean)
                while rng.random() > p:
                    n_arrivals += 1
            for j in range(n_arrivals):
                out.append(TraceRequest(
                    at=t + j * 1e-4,            # burst: near-simultaneous
                    tenant=tl.tenant_id, slo=tl.slo,
                    prompt=one_prompt(),
                    max_new_tokens=tl.max_new_tokens))
    out.sort(key=lambda r: (r.at, r.tenant))
    return out


def jain_fairness(values: Dict[str, float]) -> float:
    """Jain's fairness index over per-tenant values (1.0 = perfectly
    fair, 1/n = one tenant takes everything). The bench reports it over
    per-tenant goodput shares normalized by offered load."""
    xs = [v for v in values.values() if v == v]  # drop NaNs
    if not xs:
        return 1.0
    s = sum(xs)
    ss = sum(x * x for x in xs)
    if ss == 0:
        return 1.0
    return (s * s) / (len(xs) * ss)
