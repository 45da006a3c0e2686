"""Parameter swapping for the ZeRO-Infinity parameter tier (counterpart of ``deepspeed_tpu/runtime/swap_tensor/param_swapper.py``).

Parameters are grouped per transformer layer (one group a layer's slice of
the stacked block leaves, and group 0 the stem: embeddings, head, final
norm). During the streamed step (``swap_tensor.streamed.StreamedZeroEngine``)
at most two groups are live on the device at a time: the stem and the
layer computing, the next layer's upload in flight.

- ``device="cpu"``: the fp32 master (shared with the host optimizer state)
  is the store. ``prefetch`` starts the group's upload through
  ``TransferEngine.submit_h2d(settle=False)``: on the card the master is
  page-locked (the engine registers it, :class:`HostRegistration`), so the
  copy runs on the transfer engine's side stream under the compute of the
  layer before; ``get`` settles it and casts to the compute dtype on the
  device, as the JAX store's ``jnp.asarray(master).astype(dtype)`` does.
- ``device="nvme"``: compute-dtype copies of each group also live in one
  file a group (``param_group_{i}.bin``: the sorted leaves' words back to
  back), read through the AIO library into a pinned staging buffer, one
  group ahead, and rewritten after the optimizer's sweep. A writeback may
  be queued (``wait=False``): its buffer is held until the write lands, at
  most two are in flight, and the next read of that group drains it first.
"""

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..zero.offload import lp_cast


class HostRegistration:
    """``cudaHostRegister`` over the memory of CPU tensors, so that copies
    from and to them run asynchronously, as from memory pinned at
    allocation, without a second copy of the bytes. Each tensor's range is
    widened to whole pages and overlapping ranges are merged (the driver
    refuses a page registered twice). The tensors are kept alive until
    :meth:`close` unregisters them (freeing registered memory would leave
    its pages locked)."""

    def __init__(self, tensors):
        page = os.sysconf("SC_PAGE_SIZE")
        spans = sorted((t.data_ptr() // page * page,
                        -(-(t.data_ptr() + t.numel() * t.element_size()) // page) * page)
                       for t in tensors if t.numel())
        merged: List[List[int]] = []
        for lo, hi in spans:
            if merged and lo <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        self._tensors = list(tensors)
        self._ptrs: List[int] = []
        self.nbytes = 0
        cudart = torch.cuda.cudart()
        try:
            for lo, hi in merged:
                torch.cuda.check_error(cudart.cudaHostRegister(lo, hi - lo, 0))
                self._ptrs.append(lo)
                self.nbytes += hi - lo
        except Exception:
            self.close()
            raise

    def close(self):
        if self._ptrs:
            cudart = torch.cuda.cudart()
            for p in self._ptrs:
                torch.cuda.check_error(cudart.cudaHostUnregister(p))
        self._ptrs = []
        self._tensors = []

    def __del__(self):  # pragma: no cover - best effort at teardown
        try:
            self.close()
        except Exception:
            pass


class StreamedParamStore:
    """Host/NVMe-resident per-group parameter store with read-ahead.

    ``groups``: list of dicts name -> fp32 numpy array: the same buffers the
    host optimizer updates in place, so ``get`` always sees the latest
    weights without an explicit sync in cpu mode. ``transfer`` is the
    engine's ``TransferEngine``: every byte up rides its ledger."""

    def __init__(self, groups: List[Dict[str, np.ndarray]], *, device: str = "cpu",
                 nvme_path: Optional[str] = None, compute_dtype=torch.bfloat16,
                 transfer=None, aio_threads: int = 4):
        from ..transfer_engine import default_engine

        self.groups = groups
        self.device = device
        self.compute_dtype = compute_dtype
        self.transfer = transfer if transfer is not None else default_engine()
        self._pending: Dict[int, tuple] = {}  # gi -> upload tickets, or (buf, read id)
        self._wpending: Dict[int, tuple] = {}  # gi -> (buf, write id)
        self._live = 0
        self.max_live_groups = 0  # peak simultaneously-fetched groups (tests)
        #: host seconds blocked in ``get`` on an upload or a read
        self.stats = {"h2d_wait_s": 0.0, "read_wait_s": 0.0, "writeback_s": 0.0}
        self._meta = [[(k, tuple(g[k].shape), g[k].size) for k in sorted(g)] for g in groups]
        if device == "nvme":
            from ...ops.aio.py_aio import AsyncIOHandle

            if not nvme_path:
                raise ValueError("offload_param.nvme_path required for device='nvme'")
            os.makedirs(nvme_path, exist_ok=True)
            self._aio = AsyncIOHandle(num_threads=aio_threads)
            self._paths = [os.path.join(nvme_path, f"param_group_{i}.bin")
                           for i in range(len(groups))]
            for gi in range(len(groups)):
                self.writeback(gi, wait=True)
        else:
            self._aio = None

    # ------------------------------------------------------------------
    def _flat_cast(self, gi: int) -> torch.Tensor:
        """Group ``gi``'s leaves in the compute dtype, back to back (the
        host cast of the JAX store: ``lp_cast``'s bits)."""
        total = sum(n for _, _, n in self._meta[gi])
        out = torch.empty((total,), dtype=self.compute_dtype)
        off = 0
        for name, _, n in self._meta[gi]:
            lp_cast(torch.from_numpy(self.groups[gi][name]).reshape(-1), self.compute_dtype,
                    out=out[off:off + n])
            off += n
        return out

    def writeback(self, gi: int, wait: bool = True):
        """NVMe mode: rewrite a group's compute-dtype file after its master
        was updated by the optimizer sweep. No-op in cpu mode.

        ``wait=False`` queues the write (the reference's
        ``pipelined_optimizer_swapper`` double buffering): the buffer is held
        until the write lands, the next read of the same group drains it
        first, and at most two writes are in flight."""
        if self._aio is None:
            return
        t0 = time.perf_counter()
        self._drain_write(gi)
        buf = self._flat_cast(gi)
        rid = self._aio.pwrite(self._paths[gi], buf)
        if wait:
            if self._aio.wait(rid) != 0:
                raise OSError(f"NVMe writeback failed (group {gi})")
        else:
            self._wpending[gi] = (buf, rid)
            while len(self._wpending) > 2:
                self._drain_write(next(iter(self._wpending)))
        self.stats["writeback_s"] += time.perf_counter() - t0

    def _drain_write(self, gi: int):
        if gi in self._wpending:
            _, rid = self._wpending.pop(gi)
            if self._aio.wait(rid) != 0:
                raise OSError(f"NVMe writeback failed (group {gi})")

    @property
    def writes_in_flight(self) -> int:
        return len(self._wpending)

    def prefetch(self, gi: int):
        """Start group ``gi``'s read-ahead: cpu, its uploads (in flight while
        the caller's compute runs; call it after enqueueing that compute,
        since the compute stream waits for an upload from its submit on);
        nvme, the AIO read into a staging buffer."""
        if gi in self._pending or not 0 <= gi < len(self.groups):
            return
        te = self.transfer
        if self._aio is None:
            g = self.groups[gi]
            self._pending[gi] = tuple(te.submit_h2d(torch.from_numpy(g[name]), settle=False)
                                      for name, _, _ in self._meta[gi])
            return
        self._drain_write(gi)  # a queued writeback must land first
        total = sum(n for _, _, n in self._meta[gi])
        buf = te.acquire_staging((total,), self.compute_dtype)
        self._pending[gi] = (buf, self._aio.pread(self._paths[gi], buf))

    def get(self, gi: int) -> Dict[str, torch.Tensor]:
        """Group ``gi`` on the device, in the compute dtype."""
        self._live += 1
        self.max_live_groups = max(self.max_live_groups, self._live)
        if gi not in self._pending:
            self.prefetch(gi)
        te = self.transfer
        if self._aio is None:
            t0 = time.perf_counter()
            ups = te.drain_before(self._pending.pop(gi))
            self.stats["h2d_wait_s"] += time.perf_counter() - t0
            return {name: t.to(self.compute_dtype)
                    for (name, _, _), t in zip(self._meta[gi], ups)}
        buf, rid = self._pending.pop(gi)
        t0 = time.perf_counter()
        if self._aio.wait(rid) != 0:
            raise OSError(f"NVMe param read failed (group {gi})")
        t1 = time.perf_counter()
        flat = te.drain_before([te.submit_h2d(buf, settle=False)])[0]
        self.stats["read_wait_s"] += t1 - t0
        self.stats["h2d_wait_s"] += time.perf_counter() - t1
        te.release_staging(buf)
        out, off = {}, 0
        for name, shape, n in self._meta[gi]:
            out[name] = flat[off:off + n].view(shape)
            off += n
        return out

    def release(self, n: int = 1):
        """Mark ``n`` fetched groups as no longer device-resident."""
        self._live = max(0, self._live - n)

    def close(self):
        """Land every queued write and close the AIO handle."""
        if self._aio is not None:
            for gi in list(self._wpending):
                self._drain_write(gi)
            self._aio.close()
