"""Python handle over the threaded async-I/O library (counterpart of ``deepspeed_tpu/ops/aio/py_aio.py``).

``csrc/aio.cpp`` (a copy of the repository's ``csrc/aio/aio.cpp``), built
with ``g++`` at first use: a handle owns N worker threads that drain a
request queue of ``pread`` / ``pwrite`` sub-requests, completion by request
id. Buffers are numpy arrays or contiguous CPU tensors.
"""

import ctypes

import torch

from ..op_builder import AsyncIOBuilder

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = AsyncIOBuilder().load()
        lib.ds_aio_handle_new.restype = ctypes.c_void_p
        lib.ds_aio_handle_new2.restype = ctypes.c_void_p
        lib.ds_aio_handle_new2.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int64]
        lib.ds_aio_pread.restype = ctypes.c_int64
        lib.ds_aio_pwrite.restype = ctypes.c_int64
        lib.ds_aio_pread.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
                                     ctypes.c_int64, ctypes.c_int64]
        lib.ds_aio_pwrite.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
                                      ctypes.c_int64, ctypes.c_int64]
        lib.ds_aio_wait.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.ds_aio_wait_all.argtypes = [ctypes.c_void_p]
        lib.ds_aio_handle_free.argtypes = [ctypes.c_void_p]
        lib.ds_aio_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        _lib = lib
    return _lib


def _addr_and_nbytes(buf):
    if isinstance(buf, torch.Tensor):
        if buf.device.type != "cpu" or not buf.is_contiguous():
            raise ValueError("AsyncIOHandle takes contiguous CPU tensors")
        return ctypes.c_void_p(buf.data_ptr()), buf.numel() * buf.element_size()
    if not buf.flags["C_CONTIGUOUS"]:
        raise ValueError("AsyncIOHandle takes contiguous arrays")
    return buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes


class AsyncIOHandle:
    """Threaded async pread/pwrite (reference ``aio_handle``).

    ``num_threads`` is the queue depth (concurrent in-flight sub-requests);
    requests larger than ``block_size`` split into block-sized sub-requests
    fanned across the pool. ``use_direct`` stages I/O through 4 KiB-aligned
    bounce buffers with O_DIRECT; ``stats()`` reports whether the direct path
    engaged (vs the filesystem refusing it)."""

    def __init__(self, num_threads: int = 4, use_direct: bool = False,
                 block_size: int = 8 << 20):
        if block_size < 4096:
            raise ValueError(
                f"block_size {block_size} below the 4 KiB floor (O_DIRECT "
                "alignment unit); the C side would silently keep its default")
        if block_size % 4096:
            raise ValueError(
                f"block_size {block_size} is not a 4 KiB multiple: every "
                "sub-request offset (k * block_size) would be unaligned for "
                "O_DIRECT (the C side rounds up; keep the two in agreement)")
        self._h = None
        self._lib = _load()
        self._h = self._lib.ds_aio_handle_new2(
            ctypes.c_int(num_threads), ctypes.c_int(1 if use_direct else 0),
            ctypes.c_int64(block_size))

    def pread(self, path: str, buf, offset: int = 0) -> int:
        """Submit an async read into ``buf``; returns a request id."""
        addr, nbytes = _addr_and_nbytes(buf)
        return self._lib.ds_aio_pread(self._h, path.encode(), addr, ctypes.c_int64(nbytes),
                                      ctypes.c_int64(offset))

    def pwrite(self, path: str, buf, offset: int = 0) -> int:
        addr, nbytes = _addr_and_nbytes(buf)
        return self._lib.ds_aio_pwrite(self._h, path.encode(), addr, ctypes.c_int64(nbytes),
                                       ctypes.c_int64(offset))

    def wait(self, req_id: int) -> int:
        """Block until the request completes; 0 = success."""
        return self._lib.ds_aio_wait(self._h, ctypes.c_int64(req_id))

    def wait_all(self) -> int:
        return self._lib.ds_aio_wait_all(self._h)

    def stats(self) -> dict:
        """O_DIRECT engagement counters: {"direct_opens", "fallback_opens"}."""
        out = (ctypes.c_int64 * 2)()
        self._lib.ds_aio_stats(self._h, out)
        return {"direct_opens": int(out[0]), "fallback_opens": int(out[1])}

    def close(self):
        if self._h is not None:
            self._lib.ds_aio_handle_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - best effort
        try:
            self.close()
        except Exception:
            pass
