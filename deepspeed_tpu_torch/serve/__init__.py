"""Serving layer over the paged engine (counterpart of ``deepspeed_tpu/serve``).

The request lifecycle, ``ContinuousBatchScheduler`` (admission, chunked
prefill, preemption, streaming, graceful drain, failure containment and
engine-loss recovery) with threefry-sampled decoding, stop sequences,
logit bias and fan-out, multi-tenant QoS, the prompt-lookup draft proposer
and the serving metrics. The pool, router, disaggregation, elastic
controller and trace generator come with ROADMAP.md Queue 1 item 8.
"""

from ..resilience import (CircuitBreaker, DeadlineShedError,  # noqa: F401
                          PoolExhaustedError, RequestFailedError, RetryPolicy,
                          SheddingError, StepWatchdog, TransientEngineError)
from .metrics import PoolMetrics, ServeMetrics  # noqa: F401
from .request import Request, RequestState  # noqa: F401
from .tenancy import (DEFAULT_SLO_CLASSES, SLOClass,  # noqa: F401
                      TenantRegistry, TenantSpec)
from .sampling import (LogitProcessor, SamplingParams,  # noqa: F401
                       StopScanner, combined_bias, sample_or_argmax)
from .scheduler import (ContinuousBatchScheduler, QueueFullError,  # noqa: F401
                        SchedulerClosedError)
from .speculation import (DraftModelProposer, DraftProposer,  # noqa: F401
                          PromptLookupProposer, SpecPolicy)
