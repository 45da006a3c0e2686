"""ZeRO-Infinity tensor-swapping tier (counterpart of ``deepspeed_tpu/runtime/swap_tensor/``).

``StreamedParamStore``: host/NVMe parameter store with read-ahead
(reference ``partitioned_param_swapper.py:36``).
``StreamedZeroEngine``: layer-streamed training engine whose parameters
never fully reside on the device.

The optimizer-state swap tier lives in ``runtime/zero/offload.py``
(``OffloadedAdamState``, reference ``partitioned_optimizer_swapper.py``).
"""

from .param_swapper import StreamedParamStore  # noqa: F401
from .streamed import StreamedZeroEngine  # noqa: F401
