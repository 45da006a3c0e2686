"""Serving request lifecycle.

A copy of ``deepspeed_tpu/serve/request.py`` for the port, which imports nothing
of the JAX package; the text below is the JAX module's.

A :class:`Request` is the unit of work the scheduler moves through

``QUEUED -> PREFILL -> DECODE -> {DONE, CANCELLED, FAILED}``
with ``PREEMPTED -> QUEUED`` as the eviction edge: a preempted request
re-enters the queue carrying its already-generated tokens appended to the
prompt, so re-admission replays the whole committed history through
``InferenceEngineV2.put`` — and, in paged mode, the block-level prefix cache
(docs/PREFIX_CACHING.md) maps the full blocks of that history straight back
into the block table, making preemption cheap.

Reference analogue: ``deepspeed-mii`` request objects / vLLM's
``SequenceStatus`` — here host-side only, the engine never sees this type.
"""

import enum
import itertools
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from ..analysis import sanitizer as _sanitizer

_uid_counter = itertools.count(1)


class RequestState(enum.Enum):
    QUEUED = "queued"        # waiting for admission (initial, or re-queued)
    PREFILL = "prefill"      # admitted; prompt tokens being consumed
    DECODE = "decode"        # live continuous-batching member
    PREEMPTED = "preempted"  # transient: evicted under pressure, re-queued
    DONE = "done"            # max_new_tokens generated
    CANCELLED = "cancelled"  # user cancel / expired deadline / drain reject
    FAILED = "failed"        # quarantined: persistent per-request fault

    @property
    def finished(self) -> bool:
        return self in (RequestState.DONE, RequestState.CANCELLED,
                        RequestState.FAILED)


@dataclass
class Request:
    """One generation request and its runtime bookkeeping.

    ``priority``: larger is more important (default 0). ``deadline`` and
    ``arrival_time`` are absolute values of the scheduler's clock; a request
    whose deadline passes while still QUEUED is cancelled, never admitted.
    """

    prompt: List[int]
    max_new_tokens: int = 32
    priority: int = 0
    deadline: Optional[float] = None
    arrival_time: float = 0.0
    #: stop token: generation finishes once this token is emitted (it IS
    #: emitted — the consumer sees it). Under fused multi-token decode the
    #: ≤K−1 tokens a horizon generates past it are rolled back
    #: (docs/SERVING.md), so the output is identical to single-step decode.
    eos_token: Optional[int] = None
    uid: int = field(default_factory=lambda: next(_uid_counter))
    #: streaming callback, invoked as ``on_token(request, token)`` per token
    on_token: Optional[Callable[["Request", int], None]] = None
    #: per-request decoding policy (docs/SAMPLING.md): a
    #: ``serve.sampling.SamplingParams`` record, or None for plain greedy.
    #: Always a CONCRETE single-stream record here (``n == 1``): submit()
    #: expands ``n > 1`` fanout into sibling requests with derived seeds
    #: before any Request exists, so replay never re-fans-out.
    sampling: Optional[object] = None
    #: multi-tenant QoS identity (docs/SERVING.md "Multi-tenant QoS"):
    #: the owning tenant id and resolved SLO-class name, set by submit()
    #: when the scheduler has a ``TenantRegistry``. They ride the journal
    #: (record.v3) so identity survives preempt/migrate/restore; ``None``
    #: on untenanted schedulers — behavior is then exactly pre-tenancy.
    tenant: Optional[str] = None
    slo: Optional[str] = None

    # -- runtime state (scheduler-owned) --------------------------------
    state: RequestState = RequestState.QUEUED
    tokens: List[int] = field(default_factory=list)  # generated so far
    preemptions: int = 0
    admitted_time: Optional[float] = None   # first admission
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    cancel_reason: Optional[str] = None
    #: terminal failure context: the persistent fault that quarantined this
    #: request (FAILED), or the typed ``RequestFailedError`` attached when a
    #: deadline expires during engine-loss recovery (CANCELLED,
    #: docs/RESILIENCE.md) — ``stream()`` re-raises it either way, so pull
    #: consumers are unblocked with a reason and never hang
    error: Optional[BaseException] = None
    _cursor: int = 0  # streaming iterator position into ``tokens``

    @property
    def finished(self) -> bool:
        return self.state.finished

    @property
    def remaining(self) -> int:
        return max(0, self.max_new_tokens - len(self.tokens))

    def replay_tokens(self) -> List[int]:
        """Prompt plus every generated token — what re-admission after a
        preemption must feed ``put`` so the next decode continues exactly
        where the evicted sequence left off (the last generated token has
        not been fed to the engine yet; prefilling it yields the logits the
        next decode step would have produced, bitwise — every ragged row is
        its own length-1 sequence against the pool)."""
        return list(self.prompt) + list(self.tokens)

    def new_tokens(self) -> List[int]:
        """Tokens generated since the last call (streaming pull surface)."""
        out = self.tokens[self._cursor:]
        self._cursor = len(self.tokens)
        return out

    def _emit(self, token: int) -> None:
        self.tokens.append(token)
        if self.on_token is not None:
            self.on_token(self, token)

    def __setattr__(self, name: str, value) -> None:
        # checked mode (docs/ANALYSIS.md): every lifecycle transition is
        # validated against the legal graph. Off (the default), this is
        # one string compare per attribute assignment — unmeasurable.
        if name == "state" and _sanitizer.sanitize_enabled():
            _sanitizer.check_transition(
                getattr(self, "uid", None), getattr(self, "state", None),
                value)
        object.__setattr__(self, name, value)
