"""Serving layer over the paged engine (counterpart of ``deepspeed_tpu/serve``).

The request lifecycle, ``ContinuousBatchScheduler`` (admission, chunked
prefill, preemption, streaming, graceful drain, failure containment and
engine-loss recovery) with threefry-sampled decoding, stop sequences,
logit bias and fan-out, multi-tenant QoS, the prompt-lookup draft proposer
and the serving metrics; over the schedulers, the engine pool (prefix-
affinity router, migration, rolling updates, replica-loss absorption,
health supervision, durable-journal restore), disaggregated prefill/decode
serving, the elastic controller and the seeded trace generator.
"""

from ..resilience import (AdaptiveLimit, CircuitBreaker,  # noqa: F401
                          DeadlineShedError, DurableRequestJournal,
                          FaultInjector, FaultSpec, HealthMonitor,
                          PoolExhaustedError, ReplicaLostError,
                          RequestFailedError, RetryPolicy, SheddingError,
                          StepWatchdog, TransientEngineError)
from .disagg import ROLES, DisaggPool  # noqa: F401
from .elastic import ElasticController  # noqa: F401
from .metrics import PoolMetrics, ServeMetrics  # noqa: F401
from .pool import EnginePool, Replica  # noqa: F401
from .request import Request, RequestState  # noqa: F401
from .router import PHASE_ROLES, Router  # noqa: F401
from .tenancy import (DEFAULT_SLO_CLASSES, SLOClass,  # noqa: F401
                      TenantRegistry, TenantSpec)
from .trace import (TenantLoad, TraceRequest,  # noqa: F401
                    generate_trace, jain_fairness)
from .sampling import (LogitProcessor, SamplingParams,  # noqa: F401
                       StopScanner, combined_bias, sample_or_argmax)
from .scheduler import (ContinuousBatchScheduler, QueueFullError,  # noqa: F401
                        SchedulerClosedError)
from .speculation import (DraftModelProposer, DraftProposer,  # noqa: F401
                          PromptLookupProposer, SpecPolicy)
