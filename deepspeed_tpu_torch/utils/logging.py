"""Rank-aware logging utilities (counterpart of ``deepspeed_tpu/utils/logging.py``).

``logger`` and ``log_dist`` as in the JAX package. The rank is
``torch.distributed``'s when a process group is up, else the ``RANK``
environment variable, else 0.
"""

import functools
import logging
import os
import sys

LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


@functools.lru_cache(None)
def _create_logger(name: str = "DeepSpeedTPUTorch", level=logging.INFO) -> logging.Logger:
    lg = logging.getLogger(name)
    lg.setLevel(level)
    lg.propagate = False
    handler = logging.StreamHandler(stream=sys.stderr)
    handler.setFormatter(logging.Formatter(
        fmt="[%(asctime)s] [%(levelname)s] [%(name)s:%(lineno)d] %(message)s"))
    lg.addHandler(handler)
    return lg


logger = _create_logger(
    level=LOG_LEVELS.get(os.environ.get("DSTPU_LOG_LEVEL", "info").lower(), logging.INFO)
)


def _process_index() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def log_dist(message: str, ranks=None, level=logging.INFO) -> None:
    """Log ``message`` only on the given ranks (default: all).

    ``ranks=[-1]`` or ``None`` logs everywhere; ``ranks=[0]`` logs on the lead
    process only.
    """
    my_rank = _process_index()
    if ranks is None or -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")
