"""The port's async-I/O handle (``deepspeed_tpu_torch/ops/aio/py_aio.py`` over
``csrc/aio.cpp``) against the JAX package's (``deepspeed_tpu/ops/aio``), on
the CPU: both libraries are built with g++ at first use.

The cases of ``tests/unit/test_aio.py`` and ``test_aio_failure_paths.py``
run on the port's handle; a file written by one package's handle is read
back by the other's, byte for byte, whatever the request splitting and the
O_DIRECT mode of each side.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.aio.py_aio import AsyncIOHandle


def _jax_handle(**kw):
    from deepspeed_tpu.ops.aio.py_aio import AsyncIOHandle as JaxHandle

    return JaxHandle(**kw)


HANDLES = {"port": AsyncIOHandle, "jax": _jax_handle}


def _data(n, seed=0):
    return np.random.default_rng(seed).integers(0, 255, n, dtype=np.uint8)


def _roundtrip(h, path, n, seed=0):
    data = _data(n, seed)
    assert h.wait(h.pwrite(path, data)) == 0
    buf = np.empty_like(data)
    assert h.wait(h.pread(path, buf)) == 0
    np.testing.assert_array_equal(buf, data)


@pytest.mark.parametrize("qd", [1, 4])
def test_roundtrip_with_request_splitting(tmp_path, qd):
    """A request far larger than ``block_size`` splits into sub-requests
    across the pool and completes as one id with the right bytes."""
    h = AsyncIOHandle(num_threads=qd, block_size=1 << 16)
    _roundtrip(h, str(tmp_path / "f.bin"), (1 << 20) + 12345)
    h.close()


def test_many_concurrent_requests(tmp_path):
    h = AsyncIOHandle(num_threads=4, block_size=1 << 16)
    datas = [_data(200_000, i) for i in range(8)]
    rids = [h.pwrite(str(tmp_path / f"f{i}.bin"), d) for i, d in enumerate(datas)]
    assert all(h.wait(r) == 0 for r in rids)
    bufs = [np.empty_like(d) for d in datas]
    for i, b in enumerate(bufs):
        h.pread(str(tmp_path / f"f{i}.bin"), b)
    assert h.wait_all() == 0
    for b, d in zip(bufs, datas):
        np.testing.assert_array_equal(b, d)
    h.close()


@pytest.mark.parametrize("offset", [0, 100])
def test_o_direct_roundtrip_and_engagement(tmp_path, offset):
    """O_DIRECT mode: an odd length, and a request at an offset that is not
    a 4 KiB multiple, round-trip exactly through the aligned bounce path or
    the fallback; the stats count every open as direct or fallback."""
    h = AsyncIOHandle(num_threads=2, use_direct=True, block_size=1 << 16)
    path = str(tmp_path / "d.bin")
    assert h.wait(h.pwrite(path, np.zeros(1 << 18, np.uint8))) == 0
    data = _data((1 << 17) + 777, seed=7)
    assert h.wait(h.pwrite(path, data, offset=offset)) == 0
    buf = np.empty_like(data)
    assert h.wait(h.pread(path, buf, offset=offset)) == 0
    np.testing.assert_array_equal(buf, data)
    st = h.stats()
    assert st["direct_opens"] + st["fallback_opens"] >= 3
    h.close()


def test_block_size_must_be_4k_multiple():
    with pytest.raises(ValueError, match="4 KiB multiple"):
        AsyncIOHandle(num_threads=1, block_size=5000)
    with pytest.raises(ValueError, match="4 KiB floor"):
        AsyncIOHandle(num_threads=1, block_size=1024)


def test_torch_buffers_round_trip(tmp_path):
    """CPU tensors are buffers too (the port's tiers hold torch memory)."""
    h = AsyncIOHandle(num_threads=2, block_size=1 << 16)
    src = torch.from_numpy(np.random.default_rng(3).standard_normal(50_001).astype(np.float32))
    path = str(tmp_path / "t.bin")
    assert h.wait(h.pwrite(path, src)) == 0
    back = torch.empty_like(src)
    assert h.wait(h.pread(path, back)) == 0
    assert torch.equal(back, src)
    with pytest.raises(ValueError, match="contiguous"):
        h.pwrite(path, src[::2])
    h.close()


@pytest.mark.parametrize("case", ["missing_file", "missing_dir", "short_read"])
def test_error_returns_are_nonzero(tmp_path, case):
    """A failed request reports a nonzero status, never success: a read of a
    missing file, a write into a missing directory, and a read past the end
    of a truncated file (a torn state file)."""
    h = AsyncIOHandle(num_threads=1)
    buf = np.zeros(4096, np.uint8)  # alive until the request completes
    if case == "missing_file":
        rid = h.pread(str(tmp_path / "does_not_exist.bin"), buf)
    elif case == "missing_dir":
        rid = h.pwrite(str(tmp_path / "no" / "such" / "f.bin"), buf)
    else:
        p = tmp_path / "short.bin"
        p.write_bytes(b"x" * 64)
        rid = h.pread(str(p), buf)
    assert h.wait(rid) != 0
    h.close()


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
@pytest.mark.parametrize("direct", [False, True])
def test_files_cross_between_the_packages(tmp_path, writer, reader, direct):
    """A file one package's handle writes (split into 64 KiB requests) is
    read back by the other's (256 KiB requests), byte for byte."""
    w = HANDLES[writer](num_threads=3, use_direct=direct, block_size=1 << 16)
    r = HANDLES[reader](num_threads=2, use_direct=direct, block_size=1 << 18)
    path = str(tmp_path / "x.bin")
    data = _data((1 << 20) + 4099, seed=11)
    assert w.wait(w.pwrite(path, data)) == 0
    buf = np.empty_like(data)
    assert r.wait(r.pread(path, buf)) == 0
    np.testing.assert_array_equal(buf, data)
    w.close()
    r.close()
