"""The port's TransferEngine and NVMe store against the JAX package's, on the CPU.

The scenarios of the JAX package's ``tests/unit/test_transfer_engine.py``
for ``TransferEngine`` and ``NVMeStore``, each run through both packages
with the same calls: the ticket ledger (an open D2H ticket settled at the
drain, H2D settled at submit), overlap on against off bitwise, the
in-flight cap draining oldest first, cancel accounting, the staging pool's
reuse, the chunked tree transfers, and the ledger checker's planted
violations. After the same calls the port's ledger (submitted, completed,
cancelled, in flight, per direction) and its open tickets equal the JAX
engine's. The NVMe store: the generation ring, a corrupt newest slot
falling back one slot, a torn write (no manifest), every slot corrupt, and
delete/has; and files cross between the packages in both directions, fp32
and bfloat16 (the port writes bfloat16 as raw 16-bit words under the
manifest dtype the JAX store writes).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.runtime.transfer_engine as jte
import deepspeed_tpu_torch.runtime.transfer_engine as tte
from deepspeed_tpu.analysis.sanitizer import SanitizerError as JaxSanitizerError
from deepspeed_tpu_torch.analysis.sanitizer import SanitizerError, check_transfer_ledger
from deepspeed_tpu_torch.utils import transfer as ttransfer
from tests.torch_checked import checked_mode  # noqa: F401  (autouse: checked mode)


def arrays(n=256, seed=0):
    """The same float32 values as a JAX device array and a CPU tensor."""
    a = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def engines(**kw):
    return jte.TransferEngine(**kw), tte.TransferEngine(device="cpu", **kw)


def same_ledger(je, te):
    assert te.ledger() == je.ledger()
    assert list(te._open) == list(je._open)
    assert te.submitted_transfers == je.submitted_transfers


@pytest.fixture
def sanitize(monkeypatch):
    monkeypatch.setenv("DSTPU_SANITIZE", "1")


# ---------------------------------------------------------------------------
# tickets and the ledger
# ---------------------------------------------------------------------------
def test_d2h_open_ticket_settles_at_drain():
    je, te = engines(overlap=True)
    ja, ta = arrays(seed=1)
    jt, tt = je.submit_d2h(ja), te.submit_d2h(ta)
    assert tt.open and tt.direction == "d2h" and tt.nbytes == jt.nbytes == 256 * 4
    same_ledger(je, te)
    ta.add_(1.0)  # the payload is the value at submit
    out = te.drain_before([tt, "host-passthrough"])
    je.drain_before([jt])
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ja))
    assert out[1] == "host-passthrough" and not tt.open
    same_ledger(je, te)
    check_transfer_ledger(te)


def test_overlap_off_is_bitwise_synchronous_twin():
    ja, ta = arrays(seed=2)
    on, off = tte.TransferEngine(overlap=True, device="cpu"), \
        tte.TransferEngine(overlap=False, device="cpu")
    t_on, t_off = on.submit_d2h(ta), off.submit_d2h(ta)
    assert t_on.open and not t_off.open
    assert torch.equal(t_on.wait(), t_off.value)
    assert off.s_per_byte("d2h") > 0
    jon, joff = jte.TransferEngine(overlap=True), jte.TransferEngine(overlap=False)
    jon.drain_before([jon.submit_d2h(ja)])
    joff.submit_d2h(ja)
    same_ledger(jon, on)
    same_ledger(joff, off)
    for e in (on, off):
        check_transfer_ledger(e)


def test_h2d_settles_at_submit_and_roundtrips():
    je, te = engines()
    host = np.arange(96, dtype=np.float32)
    tt = te.submit_h2d(host)
    je.submit_h2d(host)
    assert not tt.open
    host += 1.0  # rewriting the source after submit leaves the payload
    np.testing.assert_array_equal(tt.value.numpy(), np.arange(96, dtype=np.float32))
    same_ledger(je, te)
    assert te.s_per_byte("h2d") > 0
    check_transfer_ledger(te)


def test_cap_in_flight_drains_oldest_first():
    je, te = engines(overlap=True, limit_bytes=4096)
    jts, tts = [], []
    for i in range(8):
        jts.append(je.submit_d2h(jnp.full((256,), float(i), jnp.float32)))
        tts.append(te.submit_d2h(torch.full((256,), float(i))))
        same_ledger(je, te)
    assert te.ledger()["inflight"]["d2h"] <= 4096
    assert [t.open for t in tts] == [t.open for t in jts]
    assert not tts[0].open  # the oldest was settled to make room
    for i, v in enumerate(te.drain_before(tts)):
        assert torch.equal(v, torch.full((256,), float(i)))
    je.drain_before(jts)
    same_ledger(je, te)
    check_transfer_ledger(te)


def test_cancel_accounting():
    je, te = engines(overlap=True)
    (ja1, ta1), (ja2, ta2) = arrays(seed=3), arrays(seed=4)
    j1, j2 = je.submit_d2h(ja1), je.submit_d2h(ja2)
    t1, t2 = te.submit_d2h(ta1), te.submit_d2h(ta2)
    t1.cancel()
    j1.cancel()
    assert not t1.open and t1.value is None
    same_ledger(je, te)
    assert te.ledger()["cancelled"]["d2h"] == t1.nbytes
    check_transfer_ledger(te)
    t1.cancel()  # double cancel: a no-op
    j1.cancel()
    te.cancel_all()
    je.cancel_all()
    assert not te._open and not t2.open
    same_ledger(je, te)
    check_transfer_ledger(te)


def test_bandwidth_ema_and_monitor_gauges(tmp_path):
    je, te = engines(overlap=True)
    te.drain_before([te.submit_d2h(arrays(seed=5)[1])])
    te.submit_h2d(np.ones(64, np.float32))
    assert te.s_per_byte("d2h") > 0 and te.s_per_byte("h2d") > 0
    labels = [label for label, _, _ in te.monitor_events("serve/transfer", 5)]
    assert labels == [label for label, _, _ in je.monitor_events("serve/transfer", 5)]
    assert not any("nvme" in label for label in labels)
    nv = tte.TransferEngine(nvme_dir=str(tmp_path / "t"), device="cpu")
    jnv = jte.TransferEngine(nvme_dir=str(tmp_path / "j"))
    assert [e[0] for e in nv.monitor_events("p")] == [e[0] for e in jnv.monitor_events("p")]


def test_staging_pool_reuses_released_buffers():
    je, te = engines()
    b1 = te.acquire_staging((4, 4), torch.float32)
    jb1 = je.acquire_staging((4, 4), np.float32)
    te.release_staging(b1)
    je.release_staging(jb1)
    b2 = te.acquire_staging((4, 4), np.float32)  # a numpy dtype names the same pool
    je.acquire_staging((4, 4), np.float32)
    assert b2 is b1  # pooled, not reallocated
    b3 = te.acquire_staging((4, 4), torch.float32)  # the double buffer
    je.acquire_staging((4, 4), np.float32)
    assert b3 is not b2 and te.staging_buffers() == je.staging_buffers() == 2


def test_put_get_tree_chunked_bitwise():
    rng = np.random.default_rng(6)
    tree = {"w": rng.standard_normal((64, 8)).astype(np.float32),
            "b": np.arange(7, dtype=np.int32)}
    for overlap in (True, False):
        je, te = engines(overlap=overlap, limit_bytes=512)
        back = te.get_tree(te.put_tree(tree))
        jax.tree.map(np.testing.assert_array_equal, je.get_tree(je.put_tree(tree)), tree)
        for k in tree:
            np.testing.assert_array_equal(back[k].numpy(), tree[k])
        same_ledger(je, te)
        assert te.ledger()["inflight"] == {"d2h": 0, "h2d": 0}
        check_transfer_ledger(te)


def test_sharding_and_the_default_engine():
    te = tte.TransferEngine(device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        te.put_tree({"a": np.zeros(3, np.float32)}, sharding=object())
    with pytest.raises(NotImplementedError, match="item 13"):
        te.submit_h2d(np.zeros(3, np.float32), sharding=object())
    assert tte.default_engine() is tte.default_engine()
    assert tte.MAX_INFLIGHT_BYTES == jte.MAX_INFLIGHT_BYTES
    assert tte.STAGING_POOL_DEPTH == jte.STAGING_POOL_DEPTH
    # the tooling helpers fetch through the process-wide engine on any device
    x = {"x": torch.arange(12, dtype=torch.float32).reshape(3, 4)}
    got = ttransfer.chunked_device_get(x, limit_bytes=16)
    assert torch.equal(got["x"], x["x"])


# ---------------------------------------------------------------------------
# the ledger checker: planted violations (sanitize armed)
# ---------------------------------------------------------------------------
def test_ledger_checker_is_duck_typed():
    check_transfer_ledger(None)
    check_transfer_ledger(object())


@pytest.mark.parametrize("plant,match", [
    ("conservation", "not conserved"),
    ("inflight", "disagrees"),
    ("closed", "closed but still tracked"),
])
def test_planted_ledger_violations_are_caught(sanitize, plant, match):
    """The same plant trips both packages' checkers with the same message."""
    from deepspeed_tpu.analysis.sanitizer import check_transfer_ledger as jax_check

    for eng, arr, check, err in ((jte.TransferEngine(overlap=True), arrays(seed=7)[0],
                                  jax_check, JaxSanitizerError),
                                 (tte.TransferEngine(overlap=True, device="cpu"),
                                  arrays(seed=7)[1], check_transfer_ledger, SanitizerError)):
        t = eng.submit_d2h(arr)
        check(eng)
        if plant == "conservation":
            eng.drain_before([t])
            eng.completed_bytes["d2h"] += 128
        elif plant == "inflight":
            eng.inflight_bytes["d2h"] += 64
        else:
            t.open = False
        with pytest.raises(err, match=match):
            check(eng)


def test_undrained_value_read_is_recorded(sanitize):
    te = tte.TransferEngine(overlap=True, device="cpu")
    _, ta = arrays(seed=10)
    t = te.submit_d2h(ta)
    assert torch.equal(t.value, ta)
    assert not t.open
    with pytest.raises(SanitizerError, match="without drain_before"):
        check_transfer_ledger(te)
    check_transfer_ledger(te)  # reported once


def test_staging_reissue_while_open_is_recorded(sanitize):
    te = tte.TransferEngine(device="cpu")
    for _ in range(tte.STAGING_POOL_DEPTH):
        te.acquire_staging((8,), torch.float32)
    te.acquire_staging((8,), torch.float32)
    with pytest.raises(SanitizerError, match="re-requested"):
        check_transfer_ledger(te)


# ---------------------------------------------------------------------------
# the NVMe store
# ---------------------------------------------------------------------------
def test_roundtrip_and_generation_ring(tmp_path):
    store = tte.NVMeStore(str(tmp_path), ring_slots=2)
    a0 = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    store.save("k", a0)
    assert torch.equal(store.load("k"), a0)
    store.save("k", a0 + 1.0)
    store.save("k", a0 + 2.0)  # gen 2 cycles back onto slot 0
    assert torch.equal(store.load("k"), a0 + 2.0)
    assert store.counters["saves"] == 3 and store.counters["ring_fallbacks"] == 0
    assert store.counters["bytes_written"] == 3 * a0.numel() * 4


def _corrupt(path):
    with open(path, "wb") as f:
        f.write(b"\xff" * os.path.getsize(path))


def test_corrupt_newest_falls_back_one_slot(tmp_path):
    store = tte.NVMeStore(str(tmp_path), ring_slots=2)
    a0, a1 = torch.arange(16, dtype=torch.float32), torch.full((16,), 9.0)
    store.save("k", a0)
    store.save("k", a1)
    _corrupt(os.path.join(str(tmp_path), "k.1.bin"))
    assert torch.equal(store.load("k"), a0)
    assert store.counters["ring_fallbacks"] == 1 and store.counters["corrupt_reads"] == 1


def test_missing_manifest_is_a_torn_write(tmp_path):
    store = tte.NVMeStore(str(tmp_path), ring_slots=2)
    store.save("k", torch.arange(8, dtype=torch.float32))
    store.save("k", torch.ones(8))
    os.remove(os.path.join(str(tmp_path), "k.1.json"))
    assert torch.equal(store.load("k"), torch.arange(8, dtype=torch.float32))
    assert store.counters["ring_fallbacks"] == 0 and store.counters["corrupt_reads"] == 0


def test_all_slots_corrupt_raises(tmp_path):
    store = tte.NVMeStore(str(tmp_path), ring_slots=2)
    store.save("k", torch.arange(8, dtype=torch.float32))
    store.save("k", torch.ones(8))
    for slot in (0, 1):
        _corrupt(os.path.join(str(tmp_path), f"k.{slot}.bin"))
    with pytest.raises(tte.TransferCorruptError, match="no complete slot"):
        store.load("k")
    assert store.counters["corrupt_reads"] == 2


def test_delete_and_has(tmp_path):
    store = tte.NVMeStore(str(tmp_path), ring_slots=2)
    assert not store.has("k")
    store.save("k", torch.zeros(4))
    assert store.has("k")
    store.delete("k")
    assert not store.has("k")
    with pytest.raises(tte.TransferCorruptError):
        store.load("k")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_store_files_cross_between_packages(tmp_path, dtype):
    """A directory written by either package's store loads bitwise in the
    other's, manifests included (same CRC, shape, dtype and generation)."""
    vals = np.random.default_rng(12).standard_normal((2, 3, 4, 8)).astype(np.float32)
    jarr = np.asarray(jnp.asarray(vals, dtype=jnp.dtype(dtype)))
    tarr = torch.from_numpy(vals).to(getattr(torch, dtype))
    words = (lambda a: a.view(np.uint16)) if dtype == "bfloat16" else (lambda a: a)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jte.NVMeStore(jdir).save("kvblock_3", jarr)
    tte.NVMeStore(tdir).save("kvblock_3", tarr)
    for suffix in (".0.bin", ".0.json"):
        with open(os.path.join(jdir, "kvblock_3" + suffix), "rb") as a, \
                open(os.path.join(tdir, "kvblock_3" + suffix), "rb") as b:
            assert a.read() == b.read()
    got = tte.NVMeStore(jdir).load("kvblock_3")
    assert got.dtype == tarr.dtype and torch.equal(got, tarr)
    back = jte.NVMeStore(tdir).load("kvblock_3")
    assert str(back.dtype) == dtype
    np.testing.assert_array_equal(words(back), words(jarr))


def test_blocks_crc32_matches_jax():
    vals = np.random.default_rng(13).standard_normal((3, 5)).astype(np.float32)
    blocks = [vals, vals * 2]
    assert tte.blocks_crc32([torch.from_numpy(b) for b in blocks]) == jte.blocks_crc32(blocks)
    bf = np.asarray(jnp.asarray(vals, jnp.bfloat16))
    assert tte.blocks_crc32([torch.from_numpy(vals).to(torch.bfloat16)]) == \
        jte.blocks_crc32([bf])
