"""Host-device transfer discipline for tooling (counterpart of ``deepspeed_tpu/utils/transfer.py``).

Two rules for every tool that moves large trees between the host and the
card:

1. **Chunking** (``chunked_device_put`` / ``chunked_device_get``): never let
   more than ``MAX_INFLIGHT_BYTES`` of one transfer be outstanding; a leaf
   larger than the limit goes in axis-0 chunks. Both delegate to the
   process-wide :class:`~deepspeed_tpu_torch.runtime.transfer_engine.TransferEngine`,
   so tooling traffic rides the same byte ledger and bandwidth EMAs as the
   KV tiers.
2. **Drain on signal** (``install_transfer_guard``): SIGTERM / SIGINT drain
   the card's outstanding work (``torch.cuda.synchronize``, bounded by a
   timeout) before the process exits, instead of dying with copies queued.
"""

import signal
import sys
from typing import Any

import torch

#: the cap on outstanding bytes (kept in the TransferEngine)
from ..runtime.transfer_engine import MAX_INFLIGHT_BYTES, default_engine

#: how long the signal guard waits for in-flight device work before exiting
DRAIN_TIMEOUT_S = 120.0


def chunked_device_put(tree: Any, sharding=None, *,
                       limit_bytes: int = MAX_INFLIGHT_BYTES) -> Any:
    """Copy a tree of host leaves to the card with bounded bytes a flight
    (``TransferEngine.put_tree``); ``sharding`` raises ``NotImplementedError``
    (ROADMAP.md Queue 1 item 13d)."""
    return default_engine().put_tree(tree, sharding, limit_bytes=limit_bytes)


def chunked_device_get(tree: Any, *, limit_bytes: int = MAX_INFLIGHT_BYTES) -> Any:
    """Fetch a tree of tensors to CPU tensors with bounded bytes a flight
    (``TransferEngine.get_tree``)."""
    return default_engine().get_tree(tree, limit_bytes=limit_bytes)


_guard_installed = False


def install_transfer_guard(drain_timeout_s: float = DRAIN_TIMEOUT_S) -> None:
    """Install SIGTERM/SIGINT handlers that drain the card's work before
    exit: the handler waits on ``torch.cuda.synchronize`` in a watchdog
    thread (bounded by ``drain_timeout_s``), then exits 143/130 as the
    signal would have."""
    global _guard_installed
    if _guard_installed:
        return
    _guard_installed = True

    def _handler(signum, frame):
        import threading

        print(f"[transfer-guard] signal {signum}: draining in-flight device "
              f"work (<= {drain_timeout_s:.0f}s) before exit", file=sys.stderr,
              flush=True)
        done = threading.Event()

        def _drain():
            try:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
            except Exception:
                pass
            done.set()

        t = threading.Thread(target=_drain, daemon=True)
        t.start()
        done.wait(drain_timeout_s)
        print(f"[transfer-guard] drain {'complete' if done.is_set() else 'TIMED OUT'}"
              "; exiting", file=sys.stderr, flush=True)
        sys.exit(128 + signum)

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _handler)
        except (ValueError, OSError):  # non-main thread / unsupported
            pass
