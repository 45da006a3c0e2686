"""Typed fault taxonomy for the serving stack (docs/RESILIENCE.md).

A copy of ``deepspeed_tpu/resilience/errors.py``: the port raises the same
types without importing the JAX package.

Every error the engine or the fault layer can surface into
``ContinuousBatchScheduler.step()`` is a named type here, so the scheduler
dispatches on ``isinstance`` instead of string-matching messages. The split
that matters operationally:

- **capacity signals** (:class:`PoolExhaustedError`,
  :class:`ContextOverflowError`): normal pressure, handled by preemption /
  per-request quarantine — never a breaker failure.
- **transient faults** (:class:`TransientEngineError`): the call may succeed
  if simply retried — bounded exponential backoff with deterministic jitter
  (``resilience.retry.RetryPolicy``); each occurrence feeds the circuit
  breaker.
- **persistent per-request faults** (:class:`RequestFailedError`): retrying
  cannot help and exactly one request is culpable — it is quarantined into
  the terminal ``FAILED`` state while uninvolved live requests are preempted
  and re-admitted losslessly.
- **shedding** (:class:`SheddingError`): the breaker is open and the
  submission's priority is below the shed floor — the caller is told to back
  off, typed, at admission time.
- **engine loss** (:class:`UnrecoverableEngineError`,
  :class:`DeviceLostError`): the engine *as a whole* is dead or wedged —
  per-request handling cannot help. The scheduler answers with engine-loss
  recovery (``resilience.recovery``): rebuild a fresh engine and replay
  every journaled live request bitwise-losslessly.

All subclass ``RuntimeError`` so pre-taxonomy callers catching
``RuntimeError`` keep working, and message texts are unchanged from the
string-era raises (compat)."""

from typing import Optional


class PoolExhaustedError(RuntimeError):
    """A shared pool (KV block pool or sequence-slot pool) has no capacity
    left for this allocation. Recoverable by preemption: evicting a victim
    frees capacity and the call can be retried verbatim.

    ``uid`` (when known) is the request whose allocation hit the wall — NOT
    a culprit; any resident sequence may be holding the capacity."""

    def __init__(self, message: str, uid: Optional[int] = None):
        super().__init__(message)
        self.uid = uid


class ContextOverflowError(RuntimeError):
    """A single sequence ran past its maximum context length. Per-request
    and permanent: preemption cannot help, only failing (or flushing) the
    culpable ``uid`` can."""

    def __init__(self, message: str, uid: Optional[int] = None):
        super().__init__(message)
        self.uid = uid


class EngineUsageError(RuntimeError):
    """The caller broke the engine's calling contract: a batch wider than
    the slot pool, fused decode with prefill tokens still pending, a
    rollback of in-flight work. Not a fault and not pressure — there is no
    retry, preemption, or quarantine story; the calling code is wrong and
    must be fixed. Typed (DSTPU003) so no dispatcher ever string-matches
    it; ``uid`` names the offending sequence when one is attributable."""

    def __init__(self, message: str, uid: Optional[int] = None):
        super().__init__(message)
        self.uid = uid


class TransientEngineError(RuntimeError):
    """An engine call failed in a way that a bounded retry may fix
    (runtime hiccup, transport blip, injected transient fault). The fault
    layer guarantees the engine's host-side state was NOT mutated by the
    failed call, so the retry passes the same arguments."""


class RequestFailedError(RuntimeError):
    """A persistent failure attributable to exactly one request. The
    scheduler quarantines ``uid`` (terminal ``FAILED`` state, blocks
    flushed, streaming consumers unblocked with this error) and contains
    the blast radius by preempting + re-admitting uninvolved requests."""

    def __init__(self, uid: int, message: str = ""):
        super().__init__(message or f"persistent engine fault on uid {uid}")
        self.uid = uid


class SheddingError(RuntimeError):
    """Load shed at admission: the circuit breaker is open and the request's
    priority is below the shed floor. Retry after the breaker's cooldown, or
    resubmit at a priority at or above the floor."""


class DeadlineShedError(SheddingError):
    """Deadline-aware early rejection at admission: the scheduler's
    predicted TTFT (pending prefill backlog x its per-token dispatch EMA)
    already exceeds the request's deadline, so admitting it would only
    burn prefill compute on a request guaranteed to expire in queue.
    Subclasses :class:`SheddingError` — callers with shed handling keep
    working; ``predicted_s``/``remaining_s`` carry the decision inputs."""

    def __init__(self, message: str, predicted_s: float = 0.0,
                 remaining_s: float = 0.0):
        super().__init__(message)
        self.predicted_s = predicted_s
        self.remaining_s = remaining_s


class TenantThrottledError(SheddingError):
    """Per-tenant token-bucket rate limit hit at admission
    (docs/SERVING.md "Multi-tenant QoS"): the tenant's bucket cannot cover
    this request's cost. Subclasses :class:`SheddingError` — shed handling
    keeps working; ``tenant`` names the throttled flow and
    ``retry_after_s`` how long the bucket needs to refill the shortfall."""

    def __init__(self, message: str, tenant: str = "",
                 retry_after_s: float = 0.0):
        super().__init__(message)
        self.tenant = tenant
        self.retry_after_s = retry_after_s


class QuotaExceededError(SheddingError):
    """A tenant's hard admission quota is exhausted (max outstanding
    requests): unlike a throttle, no amount of waiting on THIS replica
    helps until the tenant's own requests finish — and unlike
    ``QueueFullError`` the pool must not retry it elsewhere (the quota is
    tenant-global, not per-replica). ``tenant`` names the flow."""

    def __init__(self, message: str, tenant: str = ""):
        super().__init__(message)
        self.tenant = tenant


class WatchdogTimeoutError(RuntimeError):
    """A step (or the close() drain) exceeded its wall-clock budget past the
    point of escalation. Raised only where there is no in-band way to keep
    going; ordinary breaches are counted and escalated to the breaker."""


class UnrecoverableEngineError(RuntimeError):
    """The engine as a whole is dead or wedged: retry cannot fix it, no
    single request is culpable, and preemption has nothing left to preempt
    onto. Raised by the watchdog's consecutive hard-breach escalation (a
    dispatch that never comes back fast enough no matter what) and
    subclassed by :class:`DeviceLostError`. The scheduler's response is
    **engine-loss recovery** (docs/RESILIENCE.md): discard the engine,
    rebuild pools of identical geometry, and replay every journaled live
    request through normal admission — bitwise lossless under greedy."""


class CheckpointCorruptError(RuntimeError):
    """A checkpoint tag failed integrity verification on load: torn write
    (npz present but its metadata/manifest missing or unparsable), truncated
    archive, or a per-array checksum mismatch against the tag's manifest.
    Per-tag and permanent — retrying the same read returns the same bytes.
    The recovery answer is the durable-tag ring: fall back to the previous
    tag that verifies (``DeepSpeedEngine.load_checkpoint`` does this
    automatically when following the ``latest`` pointer, counting each hop
    in ``ckpt_corrupt_fallbacks``). ``tag``/``path`` name the rejected
    checkpoint when known."""

    def __init__(self, message: str, tag: Optional[str] = None,
                 path: Optional[str] = None):
        super().__init__(message)
        self.tag = tag
        self.path = path


class ReplicaLostError(UnrecoverableEngineError):
    """A pool replica's heartbeat lease expired: its control loop has not
    reported a single step within the lease window — not slow (the gray
    path), but *gone* (wedged dispatch, dead thread, vanished host). The
    pool's answer is the same journal-replay absorption a loud device
    loss gets: survivors adopt every journaled live request bitwise."""


class DeviceLostError(UnrecoverableEngineError):
    """The accelerator (or its runtime) is gone: device reset, XLA abort,
    preempted TPU slice. Everything resident on the device — KV pool,
    sequence state — is lost with it; only host-side state (the request
    journal) survives. At pod scale this is routine, not exceptional
    (arXiv:2011.03641), which is why it gets a recovery path instead of a
    crash."""
