"""ZeRO-Offload / Offload++ / ZeRO-Infinity optimizer-state offload (counterpart of ``deepspeed_tpu/runtime/zero/offload.py``).

The lp (compute-dtype) parameters stay on the card; only the fp32 master
copy and the Adam moments move to host RAM (``device="cpu"``), or the
moments to NVMe files read and written through the threaded AIO library
(``device="nvme"``, the next leaf's moments read ahead while the current
leaf computes). Host leaves are stepped by the C++ CPU Adam. ``ratio`` < 1
offloads the largest leaves until ``ratio`` of the optimizer-state bytes is
on the host and keeps the rest on the device (twin-flow,
``split_by_ratio``).

How a gradient reaches the host. The JAX engine submits every host leaf's
device-to-host copy up front and settles one leaf at a time. The port
streams each leaf in chunks of ``chunk_elements`` through the
TransferEngine in the compute dtype: the next chunk's copy is in flight
while the host Adam steps the current one, so the host holds a chunk or two
of gradient, never the whole gradient (llama-7b's is 13.5 GB in bf16, beside
81 GB of master and moments). The ledger moves the JAX engine's bytes, and
the update has its bits: Adam is elementwise, so a leaf stepped chunk by
chunk is bitwise the leaf stepped whole. ``on_chunk`` hands the engine each
updated chunk: it casts the chunk and starts its upload, which runs while
the tier steps the next chunk.
"""

import os
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

#: elements a gradient chunk: 16 MiB of bf16, half the TransferEngine's
#: in-flight cap, so one chunk copies while the one before it is stepped
CHUNK_ELEMENTS = 1 << 23

# the quiet NaN of bfloat16 by sign, as int16 words (0x7fc0, 0xffc0)
_BF16_QNAN = (0x7FC0, 0xFFC0 - 0x10000)


def host_f32(leaf) -> np.ndarray:
    """A fresh fp32 host copy of ``leaf`` (a tensor on any device, or an
    array), in its shape: the C++ updater writes it in place."""
    t = leaf.detach() if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))
    out = torch.empty(tuple(t.shape), dtype=torch.float32)
    out.copy_(t)
    return out.numpy()


def lp_cast(src: torch.Tensor, dtype: torch.dtype,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``src`` (fp32, on the CPU) cast to ``dtype`` with the bits of the JAX
    package's host cast (``master_np.astype(np_compute)``): round to nearest
    even, infinities kept; a bfloat16 NaN becomes the quiet NaN of its sign
    (ml_dtypes' 0x7fc0 / 0xffc0), where torch's cast writes other NaN words.
    For float16 a NaN with a payload may keep other bits than numpy's (the
    update is skipped on fp16 overflow, so a master never holds one)."""
    if out is None:
        out = torch.empty(src.shape, dtype=dtype)
    out.copy_(src)
    if dtype == torch.bfloat16 and not bool(torch.isfinite(out.sum())):
        nan = torch.isnan(src)
        if bool(nan.any()):
            words = out.view(torch.int16)
            neg = torch.signbit(src[nan])
            words[nan] = torch.where(neg, torch.tensor(_BF16_QNAN[1], dtype=torch.int16),
                                     torch.tensor(_BF16_QNAN[0], dtype=torch.int16))
    return out


class OffloadedAdamState:
    """Host/NVMe-resident fp32 master + moments for a subset of leaves."""

    def __init__(self, leaves: List, device: str = "cpu", nvme_path: Optional[str] = None,
                 aio_threads: int = 4, copy: bool = True):
        """``copy=False`` adopts ``leaves`` (C-contiguous, writable fp32
        numpy arrays) as the master instead of copying them: the
        parameter-streaming engine's groups and this state then share one
        fp32 copy of the model."""
        self.device = device
        if copy:
            self.master = [host_f32(l) for l in leaves]
        else:
            for l in leaves:
                if not (isinstance(l, np.ndarray) and l.dtype == np.float32
                        and l.flags["C_CONTIGUOUS"] and l.flags["WRITEABLE"]):
                    raise ValueError("copy=False takes C-contiguous, writable fp32 arrays")
            self.master = list(leaves)
        self.step_count = 0
        #: the TransferEngine every gradient byte rides; the engine wires its
        #: own, standalone callers fall back to the process-wide default
        self.transfer = None
        self.chunk_elements = CHUNK_ELEMENTS
        self._scratch: Optional[torch.Tensor] = None
        #: seconds summed over steps: waiting for gradient chunks, their cast
        #: to fp32, the C++ Adam
        self.stats = {"d2h_wait_s": 0.0, "grad_cast_s": 0.0, "adam_s": 0.0}
        if device == "nvme":
            from ...ops.aio.py_aio import AsyncIOHandle

            if not nvme_path:
                raise ValueError("offload_optimizer.nvme_path required for device='nvme'")
            os.makedirs(nvme_path, exist_ok=True)
            self._aio = AsyncIOHandle(num_threads=aio_threads)
            self._paths = [os.path.join(nvme_path, f"optstate_{i}.bin")
                           for i in range(len(self.master))]
            for i, m in enumerate(self.master):
                buf = np.zeros((2, m.size), np.float32)  # [m; v]
                if self._aio.wait(self._aio.pwrite(self._paths[i], buf)) != 0:
                    raise OSError(f"NVMe write failed for leaf {i} ({self._paths[i]})")
            self.m = self.v = None
        else:
            self._aio = None
            self.m = [np.zeros(l.size, np.float32) for l in self.master]
            self.v = [np.zeros(l.size, np.float32) for l in self.master]

    # ------------------------------------------------------------------
    def _engine(self):
        from ..transfer_engine import default_engine

        return self.transfer if self.transfer is not None else default_engine()

    def _materialize(self, g) -> np.ndarray:
        """A whole leaf's gradient (an open ticket, settled through its own
        engine, or a host array) as a flat fp32 host array."""
        from ..transfer_engine import TransferTicket

        if isinstance(g, TransferTicket):
            g = g.wait()
        if isinstance(g, torch.Tensor):
            return g.detach().reshape(-1).to(torch.float32).numpy()  # dstpu-lint: ignore[DSTPU001]
        return np.ascontiguousarray(g, dtype=np.float32).reshape(-1)

    def _as_f32(self, host: torch.Tensor) -> np.ndarray:
        """A settled chunk as fp32: its own buffer when it is fp32, else
        converted into the tier's reused scratch."""
        host = host.reshape(-1)
        if host.dtype == torch.float32:
            return host.numpy()
        n = host.numel()
        if self._scratch is None or self._scratch.numel() < n:
            self._scratch = torch.empty(max(n, self.chunk_elements), dtype=torch.float32)
        s = self._scratch[:n]
        s.copy_(host)
        return s.numpy()

    def _grad_chunks(self, g, n: int):
        """``(lo, hi, fp32 gradient of [lo, hi))`` over one leaf of ``n``
        elements. A tensor streams through the TransferEngine in chunks,
        the next chunk's copy submitted before the current one is settled;
        a ticket or a host array comes whole."""
        if not isinstance(g, torch.Tensor):
            yield 0, n, self._materialize(g)
            return
        te = self._engine()
        flat = g.detach().reshape(-1)
        c = self.chunk_elements
        bounds = [(lo, min(lo + c, n)) for lo in range(0, n, c)]
        st = self.stats
        tickets = deque([te.submit_d2h(flat[bounds[0][0]:bounds[0][1]])])
        for k, (lo, hi) in enumerate(bounds):
            if k + 1 < len(bounds):
                a, b = bounds[k + 1]
                tickets.append(te.submit_d2h(flat[a:b]))
            t0 = time.perf_counter()
            host = te.drain_before([tickets.popleft()])[0]
            t1 = time.perf_counter()
            g = self._as_f32(host)
            st["d2h_wait_s"] += t1 - t0
            st["grad_cast_s"] += time.perf_counter() - t1
            yield lo, hi, g

    def _fetch_mv(self, i) -> Tuple[np.ndarray, int]:
        buf = np.empty((2, self.master[i].size), np.float32)
        rid = self._aio.pread(self._paths[i], buf)
        return buf, rid

    def _moments(self, i: int):
        """Leaf ``i``'s RAM (m, v) views and the buffer to save back after
        its update (None: nothing to save)."""
        return self.m[i], self.v[i], None

    def _save_moments(self, i: int, buf) -> None:
        """Write back what ``_moments`` returned as ``buf`` (subclasses)."""

    def _spans(self, i: int, n: int) -> List[Tuple[int, int]]:
        """The flat ranges of leaf ``i`` (``n`` elements) that one
        ``step_flat`` each updates: the whole leaf here."""
        return [(0, n)]

    def adam_step(self, opt, grads: List, lr: float, grad_scale: float = 1.0,
                  clip_coef: float = 1.0, on_leaf=None, on_chunk=None) -> List[np.ndarray]:
        """Update all offloaded leaves in place; returns the master list.

        ``grads`` entries are tensors (streamed, see the module docstring),
        open :class:`TransferTicket`\\ s or host arrays. Each chunk of a leaf
        is stepped over its ``_spans``; ``on_chunk(i, lo, hi, master_chunk)``
        fires after each updated chunk, ``on_leaf(i, master_i)`` after leaf
        ``i``'s last. NVMe: the moments move through a 2-deep pipeline, leaf
        i+1's read in flight while leaf i computes (reference
        ``pipelined_optimizer_swapper``)."""
        self.step_count += 1
        n = len(self.master)
        kw = dict(lr=lr, grad_scale=grad_scale, clip_coef=clip_coef)

        def step_leaf(i, m, v):
            p = self.master[i].reshape(-1)
            spans = self._spans(i, p.size)
            for lo, hi, g in self._grad_chunks(grads[i], p.size):
                t0 = time.perf_counter()
                for a, b in spans:
                    a, b = max(a, lo), min(b, hi)
                    if a < b:
                        opt.step_flat(p[a:b], g[a - lo:b - lo], m[a:b], v[a:b],
                                      self.step_count, **kw)
                self.stats["adam_s"] += time.perf_counter() - t0
                if on_chunk is not None:
                    on_chunk(i, lo, hi, p[lo:hi])

        if self._aio is None:
            for i in range(n):
                m, v, buf = self._moments(i)
                step_leaf(i, m, v)
                self._save_moments(i, buf)
                if on_leaf is not None:
                    on_leaf(i, self.master[i])
            return self.master
        pending = {0: self._fetch_mv(0)} if n else {}
        for i in range(n):
            buf, rid = pending.pop(i)
            if i + 1 < n:
                pending[i + 1] = self._fetch_mv(i + 1)
            if self._aio.wait(rid) != 0:
                raise OSError(f"NVMe read failed for leaf {i} ({self._paths[i]})")
            step_leaf(i, buf[0], buf[1])
            wid = self._aio.pwrite(self._paths[i], buf)
            if on_leaf is not None:
                on_leaf(i, self.master[i])
            if self._aio.wait(wid) != 0:
                raise OSError(f"NVMe write failed for leaf {i} ({self._paths[i]})")
        return self.master

    def state_dict(self) -> Dict:
        # copies: the live buffers keep changing in place as training goes on
        master = [np.array(m, copy=True) for m in self.master]
        if self._aio is None:
            return {"master": master,
                    "m": [np.array(x, copy=True) for x in self.m],
                    "v": [np.array(x, copy=True) for x in self.v],
                    "step": self.step_count}
        mv = []
        for i in range(len(self.master)):
            buf, rid = self._fetch_mv(i)
            if self._aio.wait(rid) != 0:
                raise OSError(f"NVMe read failed for leaf {i} ({self._paths[i]})")
            mv.append(buf)
        return {"master": master, "mv": mv, "step": self.step_count}

    def load_state_dict(self, sd: Dict):
        self.step_count = int(sd["step"])
        for i, m in enumerate(sd["master"]):
            self.master[i][...] = np.asarray(m, np.float32).reshape(self.master[i].shape)
        if self._aio is None:
            for i in range(len(self.m)):
                self.m[i][...] = np.asarray(sd["m"][i], np.float32).reshape(-1)
                self.v[i][...] = np.asarray(sd["v"][i], np.float32).reshape(-1)
        else:
            for i, buf in enumerate(sd["mv"]):
                buf = np.ascontiguousarray(buf, dtype=np.float32)
                if self._aio.wait(self._aio.pwrite(self._paths[i], buf)) != 0:
                    raise OSError(f"NVMe write failed for leaf {i} ({self._paths[i]})")


def split_by_ratio(leaves: List, ratio: float) -> Tuple[List[int], List[int]]:
    """Offload++ twin-flow split: offload leaves (largest first) until ``ratio``
    of total optimizer-state bytes is host-resident; the rest stays on device."""
    sizes = [(int(np.prod(tuple(l.shape))) if hasattr(l, "shape") else l.size, i)
             for i, l in enumerate(leaves)]
    total = sum(s for s, _ in sizes) or 1
    host, dev = [], []
    acc = 0
    for s, i in sorted(sizes, reverse=True):
        if acc / total < ratio:
            host.append(i)
            acc += s
        else:
            dev.append(i)
    return sorted(host), sorted(dev)
