"""Resilience types (counterpart of ``deepspeed_tpu/resilience``): the error
taxonomy, and the circuit breaker, retry policy, step watchdog and
engine-loss recovery the serving scheduler composes, and the engine pool's
seeded fault injection, health supervision, adaptive limits and durable
journal, and the training supervisor (``resilience/training.py``)."""

from .breaker import BreakerState, CircuitBreaker  # noqa: F401
from .errors import (CheckpointCorruptError,  # noqa: F401
                     ContextOverflowError, DeadlineShedError,
                     DeviceLostError, EngineUsageError, PoolExhaustedError,
                     QuotaExceededError, ReplicaLostError,
                     RequestFailedError, SheddingError, TenantThrottledError,
                     TransientEngineError, UnrecoverableEngineError,
                     WatchdogTimeoutError)
from .faults import (ALL_SITES, SITES, TRAIN_SITES,  # noqa: F401
                     FaultInjector, FaultSpec, InjectedEngine,
                     InjectedTrainEngine)
from .health import HealthMonitor, ReplicaHealth  # noqa: F401
from .journal_store import DurableRequestJournal  # noqa: F401
from .limits import AdaptiveLimit  # noqa: F401
from .recovery import (JournalEntry, RecoveryPolicy,  # noqa: F401
                       RequestJournal)
from .retry import RetryPolicy  # noqa: F401
from .training import TrainingSupervisor  # noqa: F401
from .watchdog import StepWatchdog  # noqa: F401
