"""Host-device TransferEngine (counterpart of ``deepspeed_tpu/runtime/transfer_engine.py``).

The one owner of the serving engine's host<->device byte movement: KV
demotion to the host tier and promotion back, swap preemption, the
cross-engine handoff, and the tooling transfers of ``utils/transfer.py``.
It keeps the JAX engine's contract call for call:

- a bounded pool of reusable host staging buffers (``acquire_staging`` /
  ``release_staging``, two a shape and dtype);
- ``submit_d2h`` returns an open :class:`TransferTicket`; the host waits
  for the bytes only at the next dispatch boundary, where ``drain_before``
  settles exactly the payloads that boundary depends on;
- ``submit_h2d`` ships one host buffer and settles at submit: the source
  may be rewritten once it returns;
- per-direction bandwidth EMAs (``s_per_byte``), read by the scheduler's
  swap-vs-recompute cost model;
- the byte ledger, per direction submitted == completed + cancelled + in
  flight, which ``analysis.sanitizer.check_transfer_ledger`` verifies;
- an optional NVMe tier (:class:`NVMeStore`): blocks written data first and
  manifest last, with a CRC and a two-slot generation ring.

``overlap=False`` is the synchronous twin of every path: ``submit_d2h``
copies at once, and the bytes are the same either way.

How a ticket moves bytes here. On the card ``submit_d2h`` first clones the
source into a buffer of its own on the compute stream (the JAX gather
returns a fresh array; here the engine's pool is rewritten by the next
step, and a block demoted now may be handed out again), then copies the
clone into pinned host memory on a side stream, after an event recorded on
the compute stream, and records an event after the copy. The clone stays
referenced (and recorded on the side stream) until the ticket settles,
which waits on that event. ``submit_h2d`` copies on a second side stream
and waits for that copy before it returns, so a staging buffer that the
caller refills chunk by chunk is never rewritten under a copy in flight
(a non-blocking copy, unlike ``jax.device_put``, does not snapshot host
memory); the compute stream waits on the copy's event before it reads the
result. On the CPU the payload is a clone taken at submit, and with
``overlap`` the ticket stays open until drained, as the JAX engine's
tickets do on its CPU: the ledger, the in-flight cap, cancellation and the
staging pool behave as the JAX engine's for the same calls.

Payloads are CPU tensors (numpy has no bfloat16). The NVMe store writes a
bfloat16 block as raw 16-bit words under the manifest dtype ``"bfloat16"``,
as the JAX store writes it, so either package reads the other's files.
"""

import json
import os
import time
import zlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..utils.tree import tree_leaves, tree_unflatten
from .checkpoint_engine.native_checkpoint_engine import _atomic_json_dump, _file_crc32

#: hard cap on outstanding device-to-host bytes (the JAX package's)
MAX_INFLIGHT_BYTES = 32 * 1024 * 1024

#: staging buffers kept per (shape, dtype) key: two is the double buffer
STAGING_POOL_DEPTH = 2

# the ROADMAP.md item that lifts ``put_tree``'s sharding argument
_ZERO_ITEM = "ROADMAP.md Queue 1 item 13, ZeRO and runtime/comm"


class TransferCorruptError(Exception):
    """An NVMe-tier read failed verification on every ring slot."""


# ---------------------------------------------------------------------------
# host arrays: CPU tensors, numpy arrays (the JAX package's payloads)
# ---------------------------------------------------------------------------

def dtype_name(a) -> str:
    """The dtype of a tensor or numpy array as numpy spells it
    (``"float32"``, ``"bfloat16"``): the name payloads and manifests carry."""
    if isinstance(a, torch.Tensor):
        return str(a.dtype).replace("torch.", "")
    return str(np.asarray(a).dtype)


def host_tensor(a) -> torch.Tensor:
    """A CPU tensor holding ``a``'s bytes and dtype: a tensor moves to the
    CPU, a numpy array is wrapped (a bfloat16 one, from the JAX package's
    ``ml_dtypes``, through its 16-bit words)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    arr = np.ascontiguousarray(a)
    if not arr.flags.writeable:  # e.g. a JAX array's host view
        arr = arr.copy()
    if str(arr.dtype) == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def host_array(t: torch.Tensor):
    """A CPU tensor as the numpy array the JAX package's payloads hold, or
    the tensor itself where numpy has no such dtype (bfloat16)."""
    t = t.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _raw_bytes(a) -> np.ndarray:
    """``a``'s bytes as a flat uint8 array (any dtype, tensor or numpy)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bool:
            t = t.to(torch.uint8)
        return t.reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    try:
        return int(leaf.size) * int(np.dtype(leaf.dtype).itemsize)
    except Exception:
        return 0


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def blocks_crc32(arrays) -> int:
    """CRC32 over a sequence of host arrays (CPU tensors or numpy arrays),
    chained in order over their bytes: the JAX package's value for the same
    bytes, so a handoff payload verifies in either package."""
    crc = 0
    for a in arrays:
        crc = zlib.crc32(_raw_bytes(a), crc)
    return crc & 0xFFFFFFFF


# ---------------------------------------------------------------------------
class TransferTicket:
    """Receipt for one submitted transfer (``transfer_engine.py:78``).

    ``open`` is True while the bytes may still be in flight; the payload is
    read through ``TransferEngine.drain_before`` (or ``wait()``), which
    closes the ticket and settles the ledger. Reading ``.value`` on an open
    ticket is recorded as a ledger violation under ``DSTPU_SANITIZE`` (and
    still materializes)."""

    __slots__ = ("tid", "direction", "nbytes", "open", "buffer_key",
                 "_raw", "_result", "_engine")

    def __init__(self, engine, tid: int, direction: str, nbytes: int, raw):
        self._engine = engine
        self.tid = tid
        self.direction = direction
        self.nbytes = nbytes
        self.open = True
        #: staging-pool key this ticket pins (None when no pool buffer rides)
        self.buffer_key = None
        # in flight: the CPU clone, or on the card (device clone, pinned
        # host tensor, the copy's event)
        self._raw = raw
        self._result = None

    def wait(self):
        """Materialize this ticket's payload (closing it)."""
        return self._engine.drain_before([self])[0]

    def cancel(self):
        """Discard this transfer without reading it; settles the ledger
        into ``cancelled_bytes``. No-op on a closed ticket."""
        self._engine.cancel_ticket(self)

    @property
    def value(self):
        """The payload. On an open ticket this is an undrained dependent
        read, recorded as a ledger violation under the sanitizer."""
        if self.open:
            self._engine._record_violation(
                f"ticket {self.tid} ({self.direction}, {self.nbytes} B) "
                "read while open — dependent read without drain_before")
            return self._engine.drain_before([self])[0]
        return self._result

    def __repr__(self):  # pragma: no cover - debug aid
        state = "open" if self.open else "done"
        return (f"TransferTicket(tid={self.tid}, {self.direction}, "
                f"{self.nbytes}B, {state})")


class NVMeStore:
    """Keyed array store on disk under the manifest-last + CRC protocol
    (``transfer_engine.py:131``).

    Layout per key: ``<key>.<slot>.bin`` (raw bytes) and ``<key>.<slot>.json``
    (the manifest, written last by atomic rename: the data's CRC32, shape,
    dtype and a generation that grows). ``save`` alternates between
    ``ring_slots`` slots, so a torn or corrupt newest write falls back one
    slot (``ring_fallbacks``); a missing manifest is a torn write. ``load``
    returns a CPU tensor."""

    def __init__(self, root: str, ring_slots: int = 2):
        self.root = root
        self.ring_slots = max(1, int(ring_slots))
        os.makedirs(root, exist_ok=True)
        self._gen: Dict[str, int] = {}
        self.counters = {"saves": 0, "loads": 0, "ring_fallbacks": 0,
                         "corrupt_reads": 0, "bytes_written": 0,
                         "bytes_read": 0}

    def _paths(self, key: str, slot: int):
        base = os.path.join(self.root, f"{key}.{slot}")
        return base + ".bin", base + ".json"

    def save(self, key: str, arr) -> None:
        """Write ``arr`` (a tensor or numpy array) under ``key``: data
        first, manifest last."""
        raw = _raw_bytes(arr)
        shape = list(arr.shape)
        gen = self._gen.get(key, -1) + 1
        slot = gen % self.ring_slots
        data, manifest = self._paths(key, slot)
        # the slot's old manifest goes first: if the data write below is
        # torn, a stale manifest must not validate the new bytes
        try:
            os.remove(manifest)
        except FileNotFoundError:
            pass
        with open(data, "wb") as f:
            f.write(raw.tobytes())
        _atomic_json_dump({
            "crc32": _file_crc32(data), "nbytes": int(raw.nbytes),
            "shape": shape, "dtype": dtype_name(arr), "gen": gen,
        }, manifest)
        self._gen[key] = gen
        self.counters["saves"] += 1
        self.counters["bytes_written"] += int(raw.nbytes)

    def _load_slot(self, key: str, slot: int) -> Optional[torch.Tensor]:
        data, manifest = self._paths(key, slot)
        try:
            with open(manifest) as f:
                meta = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None  # torn write: the manifest never committed
        try:
            if _file_crc32(data) != meta["crc32"]:
                return None
            raw = np.fromfile(data, dtype=np.uint8)
            if raw.nbytes != meta["nbytes"]:
                return None
            if meta["dtype"] == "bfloat16":
                t = torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(raw.view(np.dtype(meta["dtype"])))
            return t.reshape(meta["shape"])
        except (OSError, ValueError, KeyError, TypeError, RuntimeError):
            return None

    def load(self, key: str) -> torch.Tensor:
        """Read ``key``'s newest complete version; fall back one ring slot
        per corrupt or torn read; raise :class:`TransferCorruptError` when
        no slot verifies."""
        slots = []
        for slot in range(self.ring_slots):
            _, manifest = self._paths(key, slot)
            try:
                with open(manifest) as f:
                    slots.append((json.load(f).get("gen", -1), slot))
            except (OSError, json.JSONDecodeError):
                continue
        first = True
        for _, slot in sorted(slots, reverse=True):  # newest gen first
            arr = self._load_slot(key, slot)
            if arr is not None:
                if not first:
                    self.counters["ring_fallbacks"] += 1
                self.counters["loads"] += 1
                self.counters["bytes_read"] += _nbytes(arr)
                return arr
            self.counters["corrupt_reads"] += 1
            first = False
        raise TransferCorruptError(
            f"NVMe store: no complete slot verifies for key {key!r} "
            f"({len(slots)} manifest(s) found)")

    def delete(self, key: str) -> None:
        for slot in range(self.ring_slots):
            for path in self._paths(key, slot):
                try:
                    os.remove(path)
                except FileNotFoundError:
                    pass
        self._gen.pop(key, None)

    def has(self, key: str) -> bool:
        return any(os.path.exists(self._paths(key, s)[1])
                   for s in range(self.ring_slots))


class TransferEngine:
    """The one owner of host-device byte movement (``transfer_engine.py:252``).

    ``device`` is where ``submit_h2d`` lands bytes (``"cuda"`` unless the
    caller asks for the CPU), resolved at the first transfer that needs it;
    device-to-host copies read their source's device. Staging buffers are
    pinned when that device is a GPU."""

    def __init__(self, *, overlap: bool = True,
                 limit_bytes: int = MAX_INFLIGHT_BYTES,
                 nvme_dir: Optional[str] = None, nvme_ring_slots: int = 2,
                 device: Union[str, torch.device] = "cuda"):
        self.overlap = bool(overlap)
        self.limit_bytes = int(limit_bytes)
        self.nvme = NVMeStore(nvme_dir, nvme_ring_slots) if nvme_dir else None
        self._device_spec = device
        self._device: Optional[torch.device] = None
        self._streams: Dict[str, object] = {}
        self._next_tid = 0
        #: open tickets in submit order (FIFO: the in-flight cap drains oldest)
        self._open: "OrderedDict[int, TransferTicket]" = OrderedDict()
        # the byte ledger: per direction, submitted == completed + cancelled
        # + inflight at every drain boundary (check_transfer_ledger)
        self.submitted_bytes = {"d2h": 0, "h2d": 0}
        self.completed_bytes = {"d2h": 0, "h2d": 0}
        self.cancelled_bytes = {"d2h": 0, "h2d": 0}
        self.inflight_bytes = {"d2h": 0, "h2d": 0}
        self.submitted_transfers = {"d2h": 0, "h2d": 0}
        #: wall seconds per byte, EMA per direction (0.0 = unmeasured): d2h
        #: measured at the delayed sync, h2d around the copy
        self._ema_s_per_byte = {"d2h": 0.0, "h2d": 0.0}
        # staging pool: (shape, dtype) -> list of [buffer, owner|None]
        self._staging: Dict[tuple, List[list]] = {}
        #: sanitizer-recorded ledger violations (read and cleared by
        #: check_transfer_ledger; recorded only under DSTPU_SANITIZE)
        self.violations: List[str] = []

    @property
    def device(self) -> torch.device:
        if self._device is None:
            from ..accelerator import resolve_device

            self._device = resolve_device(self._device_spec)
        return self._device

    def _stream(self, direction: str, device: torch.device):
        """The side stream of one direction on ``device`` (made at first use)."""
        key = (direction, device.index)
        s = self._streams.get(key)
        if s is None:
            s = self._streams[key] = torch.cuda.Stream(device)
        return s

    # ------------------------------------------------------------------
    # ledger / sanitizer support
    # ------------------------------------------------------------------
    def _record_violation(self, msg: str) -> None:
        from ..analysis.sanitizer import sanitize_enabled

        if sanitize_enabled():
            self.violations.append(msg)

    def ledger(self) -> Dict[str, Dict[str, int]]:
        """Snapshot of the byte ledger (for dashboards and the checker)."""
        return {
            "submitted": dict(self.submitted_bytes),
            "completed": dict(self.completed_bytes),
            "cancelled": dict(self.cancelled_bytes),
            "inflight": dict(self.inflight_bytes),
        }

    def s_per_byte(self, direction: str) -> float:
        """Bandwidth EMA (wall seconds per byte); 0.0 until measured."""
        return self._ema_s_per_byte[direction]

    def _note(self, direction: str, nbytes: int, dt: float) -> None:
        if nbytes <= 0 or dt <= 0.0:
            return
        spb = dt / nbytes
        prev = self._ema_s_per_byte[direction]
        self._ema_s_per_byte[direction] = spb if prev == 0.0 \
            else 0.5 * prev + 0.5 * spb

    def monitor_events(self, prefix: str, step: int = 0):
        """``(label, value, step)`` gauges: the bandwidth EMAs and cumulative
        ledger bytes under ``<prefix>/``, and the NVMe counters with a store."""
        out = []
        for d in ("d2h", "h2d"):
            spb = self._ema_s_per_byte[d]
            out.append((f"{prefix}/{d}_bytes_per_s",
                        (1.0 / spb) if spb > 0 else 0.0, step))
            out.append((f"{prefix}/{d}_submitted_bytes",
                        float(self.submitted_bytes[d]), step))
            out.append((f"{prefix}/{d}_completed_bytes",
                        float(self.completed_bytes[d]), step))
        if self.nvme is not None:
            for k, v in self.nvme.counters.items():
                out.append((f"{prefix}/nvme_{k}", float(v), step))
        return out

    # ------------------------------------------------------------------
    # staging pool
    # ------------------------------------------------------------------
    def _alloc_buffer(self, shape, dtype) -> torch.Tensor:
        # a pool miss allocates here; steady state reuses pooled buffers
        return torch.empty(tuple(shape), dtype=dtype,
                           pin_memory=self.device.type == "cuda")

    def acquire_staging(self, shape, dtype) -> torch.Tensor:
        """Check a host staging buffer out of the bounded pool. A buffer is
        handed out again only after ``release_staging``."""
        dtype = _torch_dtype(dtype)
        key = (tuple(shape), str(dtype))
        pool = self._staging.setdefault(key, [])
        for entry in pool:
            if entry[1] is None:
                entry[1] = True  # checked out (owner bound at submit)
                return entry[0]
        if len(pool) >= STAGING_POOL_DEPTH:
            self._record_violation(
                f"staging pool for {key} exhausted ({len(pool)} buffers all "
                "checked out) — a buffer was re-requested while its ticket "
                "is open")
        buf = self._alloc_buffer(shape, dtype)
        pool.append([buf, True])
        return buf

    def release_staging(self, buf: torch.Tensor) -> None:
        """Return a staging buffer to the pool (its transfer has settled)."""
        key = (tuple(buf.shape), str(buf.dtype))
        for entry in self._staging.get(key, ()):
            if entry[0] is buf:
                entry[1] = None
                return

    def staging_buffers(self) -> int:
        return sum(len(v) for v in self._staging.values())

    # ------------------------------------------------------------------
    # D2H: a snapshot at submit, the wait delayed to the dispatch boundary
    # ------------------------------------------------------------------
    def _start_d2h(self, arr: torch.Tensor):
        """The in-flight state of one overlapped copy (class docstring)."""
        if arr.device.type != "cuda":
            return arr.detach().clone()
        src = arr.detach().clone()  # the snapshot, on the compute stream
        side = self._stream("d2h", src.device)
        side.wait_stream(torch.cuda.current_stream(src.device))
        host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        with torch.cuda.stream(side):
            host.copy_(src, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        src.record_stream(side)  # its memory is not reused before the copy ends
        return src, host, done

    def submit_d2h(self, arr) -> TransferTicket:
        """Start one device-to-host transfer of ``arr`` (a tensor); returns
        an open ticket with ``overlap``, else a settled one. The payload is
        ``arr``'s value at submit either way."""
        nb = _nbytes(arr)
        if self.inflight_bytes["d2h"] + nb > self.limit_bytes:
            # cap in flight: settle the oldest transfers until there is room
            self.drain_oldest(nb)
        tid = self._next_tid
        self._next_tid += 1
        t = TransferTicket(self, tid, "d2h", nb, None)
        self.submitted_bytes["d2h"] += nb
        self.submitted_transfers["d2h"] += 1
        if self.overlap and isinstance(arr, torch.Tensor):
            t._raw = self._start_d2h(arr)
            self.inflight_bytes["d2h"] += nb
            self._open[tid] = t
        else:
            t0 = time.perf_counter()
            t._result = (arr.detach().to("cpu", copy=True) if isinstance(arr, torch.Tensor)
                         else host_tensor(np.array(arr)))
            self._note("d2h", nb, time.perf_counter() - t0)
            t.open = False
            self.completed_bytes["d2h"] += nb
        return t

    # ------------------------------------------------------------------
    # H2D: one copy, settled at submit
    # ------------------------------------------------------------------
    def submit_h2d(self, host_arr, sharding=None) -> TransferTicket:
        """Ship one host buffer (a tensor or numpy array) to the engine's
        device. The ticket settles at submit and the source may be rewritten
        once this returns (class docstring)."""
        if sharding is not None:
            raise NotImplementedError(
                f"TransferEngine.submit_h2d(sharding=...) is not ported ({_ZERO_ITEM})")
        src = host_tensor(host_arr)
        nb = _nbytes(src)
        tid = self._next_tid
        self._next_tid += 1
        t = TransferTicket(self, tid, "h2d", nb, None)
        self.submitted_bytes["h2d"] += nb
        self.submitted_transfers["h2d"] += 1
        dev = self.device
        t0 = time.perf_counter()
        if dev.type == "cuda":
            # allocated and written on the side stream, so that the copy
            # waits for no compute work; the compute stream waits for it
            cur, side = torch.cuda.current_stream(dev), self._stream("h2d", dev)
            with torch.cuda.stream(side):
                out = torch.empty(src.shape, dtype=src.dtype, device=dev)
                out.copy_(src, non_blocking=src.is_pinned())
                done = torch.cuda.Event()
                done.record(side)
            done.synchronize()  # the source is read: the caller may refill it
            cur.wait_event(done)
            out.record_stream(cur)
        else:
            out = src.clone()
        self._note("h2d", nb, time.perf_counter() - t0)
        t._result = out
        t.open = False
        self.completed_bytes["h2d"] += nb
        return t

    # ------------------------------------------------------------------
    # the dispatch boundary: settle exactly what the next step depends on
    # ------------------------------------------------------------------
    def _settle(self, t: TransferTicket):
        t0 = time.perf_counter()
        raw = t._raw
        if isinstance(raw, tuple):  # on the card: wait for the copy's event
            _, host, done = raw
            done.synchronize()
            t._result = host
        else:
            t._result = raw
        self._note("d2h", t.nbytes, time.perf_counter() - t0)
        t._raw = None
        t.open = False
        self._open.pop(t.tid, None)
        self.inflight_bytes["d2h"] -= t.nbytes
        self.completed_bytes["d2h"] += t.nbytes
        if t.buffer_key is not None:
            self.release_staging_by_key(t.buffer_key, t.tid)

    def release_staging_by_key(self, key, tid) -> None:
        for entry in self._staging.get(key, ()):
            if entry[1] == tid:
                entry[1] = None

    def drain_before(self, dependents) -> List[Any]:
        """Settle every ticket in ``dependents`` and return their payloads,
        in order; other entries (host arrays, NVMe loads) pass through."""
        out = []
        for d in dependents:
            if isinstance(d, TransferTicket):
                if d.open:
                    self._settle(d)
                out.append(d._result)
            else:
                out.append(d)
        return out

    def drain_oldest(self, need_bytes: int) -> None:
        """Settle open tickets oldest-first until ``need_bytes`` fits under
        the in-flight cap."""
        while self._open and (self.inflight_bytes["d2h"] + need_bytes
                              > self.limit_bytes):
            self._settle(next(iter(self._open.values())))

    def drain_all(self) -> None:
        """Settle every open ticket."""
        while self._open:
            self._settle(next(iter(self._open.values())))

    def cancel_ticket(self, t: TransferTicket) -> None:
        """Drop an open transfer whose payload lost its owner; its bytes
        move to the ``cancelled`` bucket. No-op when closed. A copy still
        running on the card finishes into memory nobody reads (the source
        is recorded on its stream)."""
        if not t.open:
            return
        self._open.pop(t.tid, None)
        self.inflight_bytes[t.direction] -= t.nbytes
        self.cancelled_bytes[t.direction] += t.nbytes
        t.open = False
        t._raw = None
        t._result = None
        if t.buffer_key is not None:
            self.release_staging_by_key(t.buffer_key, t.tid)

    def cancel_all(self) -> None:
        """Cancel every open ticket (engine loss)."""
        while self._open:
            self.cancel_ticket(next(iter(self._open.values())))

    # ------------------------------------------------------------------
    # tree transfers (``utils/transfer.py`` delegates here)
    # ------------------------------------------------------------------
    def put_tree(self, tree: Any, sharding=None, *,
                 limit_bytes: Optional[int] = None) -> Any:
        """Copy a tree (nested dicts) of host leaves to the engine's device
        with bounded bytes a flight: a leaf over the limit goes in axis-0
        chunks. Leaves already on the device pass through."""
        if sharding is not None:
            raise NotImplementedError(
                f"TransferEngine.put_tree(sharding=...) is not ported ({_ZERO_ITEM})")
        limit = self.limit_bytes if limit_bytes is None else int(limit_bytes)
        out = []
        for leaf in tree_leaves(tree):
            if isinstance(leaf, torch.Tensor) and leaf.device == self.device:
                out.append(leaf)
                continue
            arr = host_tensor(leaf if isinstance(leaf, torch.Tensor) else np.asarray(leaf))
            nb = _nbytes(arr)
            if nb > limit and arr.dim() >= 1 and arr.shape[0] > 1:
                rows = max(1, int(arr.shape[0] * limit / nb))
                parts = [self.submit_h2d(arr[s:s + rows])._result
                         for s in range(0, arr.shape[0], rows)]
                out.append(torch.cat(parts, dim=0))
                continue
            out.append(self.submit_h2d(arr)._result)
        return tree_unflatten(tree, out)

    def get_tree(self, tree: Any, *, limit_bytes: Optional[int] = None) -> Any:
        """Fetch a tree of tensors to CPU tensors with bounded bytes a
        flight: a leaf over the limit in axis-0 slices."""
        limit = self.limit_bytes if limit_bytes is None else int(limit_bytes)
        out = []
        for leaf in tree_leaves(tree):
            nb = _nbytes(leaf)
            shape = tuple(getattr(leaf, "shape", ()))
            if nb > limit and len(shape) >= 1 and shape[0] > 1:
                rows = max(1, int(shape[0] * limit / nb))
                parts = [self.drain_before([self.submit_d2h(leaf[s:s + rows])])[0]
                         for s in range(0, shape[0], rows)]
                out.append(torch.cat(parts, dim=0))
            else:
                out.append(self.drain_before([self.submit_d2h(leaf)])[0])
        return tree_unflatten(tree, out)


_default: Optional[TransferEngine] = None


def default_engine() -> TransferEngine:
    """Process-wide engine for tooling transfers (``utils/transfer.py``)."""
    global _default
    if _default is None:
        _default = TransferEngine()
    return _default
