"""Resilience types (counterpart of ``deepspeed_tpu/resilience``): the error
taxonomy, and the circuit breaker, retry policy, step watchdog and
engine-loss recovery the serving scheduler composes. Fault injection,
health, limits, the durable journal and the training supervisor come with
ROADMAP.md Queue 1 items 8 and 12."""

from .breaker import BreakerState, CircuitBreaker  # noqa: F401
from .errors import (CheckpointCorruptError,  # noqa: F401
                     ContextOverflowError, DeadlineShedError,
                     DeviceLostError, EngineUsageError, PoolExhaustedError,
                     QuotaExceededError, ReplicaLostError,
                     RequestFailedError, SheddingError, TenantThrottledError,
                     TransientEngineError, UnrecoverableEngineError,
                     WatchdogTimeoutError)
from .recovery import (JournalEntry, RecoveryPolicy,  # noqa: F401
                       RequestJournal)
from .retry import RetryPolicy  # noqa: F401
from .watchdog import StepWatchdog  # noqa: F401
