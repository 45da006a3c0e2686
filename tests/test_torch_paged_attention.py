"""The port's paged decode attention.

On the CPU: the plain version against the JAX package's Pallas kernel, run
in interpret mode as the JAX package's own tests run it, with ``stream=True``
and ``stream=False``, head_dim 32 included; atol 2e-5, as
``tests/unit/test_paged_kernel.py``. The kernel's plan, a pure function of
the table's shape (never of the batch), whose partition count the
wrapper passes to the kernel: its partitions cover every block of a row
once for every length, at most 8 (one portable cluster).
On a card: the CUDA kernel against the plain version, in float32 at atol
1e-5 and in bfloat16 / float16 at atol/rtol 1e-2 (both accumulate in
float32 and round once), around each partition boundary, bitwise on a
repeat and whatever batch a row is in, rows of one shared table (a
prefill chunk) and mixed batches included. The card has no JAX, so this
file imports it only for the tests that use it, and runs there with
``python -m pytest --noconftest -m cuda tests/test_torch_paged_attention.py``.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.transformer import paged_attention as pa


def make_case(B, nh, kvh, hd, BS, MAXB, lens, seed=0):
    rng = np.random.default_rng(seed)
    NB = 1 + B * MAXB
    q = rng.standard_normal((B, nh, hd)).astype(np.float32)
    kp = rng.standard_normal((kvh, NB, BS, hd)).astype(np.float32)
    vp = rng.standard_normal((kvh, NB, BS, hd)).astype(np.float32)
    tables = np.zeros((B, MAXB), np.int32)
    perm = rng.permutation(np.arange(1, NB)).astype(np.int32)
    for b in range(B):
        n = -(-lens[b] // BS)
        tables[b, :n] = perm[b * MAXB:b * MAXB + n]
    return q, kp, vp, tables, np.asarray(lens, np.int32)


@pytest.fixture
def jax_kernel():
    jax_paged = pytest.importorskip("deepspeed_tpu.ops.transformer.paged_attention")
    return jax_paged.paged_decode_attention


@pytest.mark.parametrize("stream", [True, False])
@pytest.mark.parametrize("kvh,nh,hd", [(4, 4, 64), (2, 8, 64), (1, 8, 64),  # MHA/GQA/MQA
                                       (2, 4, 128), (2, 8, 32), (4, 4, 32)])
def test_plain_matches_jax_pallas_kernel(kvh, nh, hd, stream, jax_kernel):
    import jax.numpy as jnp

    BS, MAXB = 16, 5
    args = make_case(4, nh, kvh, hd, BS, MAXB, lens=[7, 0, 33, 80])
    ref = jax_kernel(*(jnp.asarray(a) for a in args), stream=stream)
    out = pa.paged_decode_attention(*(torch.from_numpy(a) for a in args))
    assert out.shape == (4, nh, hd) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


def test_lens_zero_rows_are_finite_zeros():
    args = make_case(3, 4, 2, 64, 16, 3, lens=[0, 5, 0])
    out = pa.paged_decode_attention(*(torch.from_numpy(a) for a in args)).numpy()
    assert np.isfinite(out).all()
    assert not out[[0, 2]].any() and out[1].any()


def test_cpu_tensors_take_the_plain_version_without_launching():
    before = pa.launches
    args = make_case(2, 4, 4, 64, 16, 2, lens=[3, 20])
    pa.paged_decode_attention(*(torch.from_numpy(a) for a in args))
    assert pa.launches == before


@pytest.mark.parametrize("hd,nh,kvh,dtype,ok", [
    (128, 32, 32, torch.bfloat16, True), (64, 64, 8, torch.float32, True),
    (256, 8, 1, torch.float16, True), (32, 4, 2, torch.float32, True),
    (32, 32, 32, torch.bfloat16, True), (80, 32, 32, torch.bfloat16, False),
    (16, 4, 4, torch.bfloat16, False),
    (128, 6, 4, torch.bfloat16, False), (128, 8, 8, torch.float64, False),
])
def test_kernel_gate(hd, nh, kvh, dtype, ok):
    if ok:
        pa.check_kernel_config(nh, kvh, hd, dtype)
    else:
        with pytest.raises(NotImplementedError):
            pa.check_kernel_config(nh, kvh, hd, dtype)


@pytest.mark.parametrize("maxb,bs", [(64, 64), (16, 64), (8, 64), (5, 16), (1, 64),
                                     (3, 7), (64, 16), (130, 32)])
def test_plan_partitions_cover_every_block_once(maxb, bs):
    parts, per, _ = pa.plan(maxb, bs, 128)
    assert 1 <= parts <= pa.MAX_PARTS and parts <= maxb
    assert parts * per >= maxb and (parts - 1) * per < maxb
    for length in range(maxb * bs + 1):
        nblk = -(-length // bs)
        slots = [pa.partition_slots(length, maxb, bs, p) for p in range(parts)]
        flat = sorted(s for part in slots for s in part)
        assert flat == list(range(nblk))  # every block of the row once, no other
        assert all(len(part) <= per for part in slots)
        # the partitions holding a block are the first min(parts, nblk): a
        # partition that starts at or past lens does no work
        assert [p for p in range(parts) if slots[p]] == list(range(min(parts, nblk)))


def test_plan_is_the_main_paths_eight_partitions():
    # llama-7b's engine: 64 table slots of 64 keys; the longest decode row
    # (2132 keys, 34 blocks) runs on 8 CTAs of at most 5 blocks each
    assert pa.plan(64, 64, 128) == (8, 8, 32)
    assert max(len(pa.partition_slots(2132, 64, 64, p)) for p in range(8)) == 5
    assert pa.plan(64, 64, 32)[2] == 128 and pa.plan(64, 64, 256)[2] == 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-5, 0.0),
                                             (torch.bfloat16, 1e-2, 1e-2)])
@pytest.mark.parametrize("nh,kvh,hd,BS", [(32, 32, 128, 64), (64, 8, 128, 64),
                                          (8, 2, 64, 16), (12, 4, 256, 32)])
def test_cuda_kernel_matches_plain(nh, kvh, hd, BS, dtype, atol, rtol, cuda):
    MAXB = 8
    args = make_case(5, nh, kvh, hd, BS, MAXB, lens=[1, 3 * BS + 5, MAXB * BS, 0, BS])
    q, kp, vp, tables, lens = (torch.from_numpy(a).to(cuda) for a in args)
    q, kp, vp = (t.to(dtype) for t in (q, kp, vp))
    before = pa.launches
    out = pa.paged_decode_attention(q, kp, vp, tables, lens)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    ref = pa.paged_decode_attention_plain(q, kp, vp, tables, lens)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    assert not out[3].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-5, 0.0),
                                             (torch.bfloat16, 1e-2, 1e-2),
                                             (torch.float16, 1e-2, 1e-2)])
@pytest.mark.parametrize("nh,kvh,hd,BS,MAXB", [
    (32, 32, 128, 64, 64),   # llama-7b's engine: 8 partitions a row
    (4, 2, 32, 16, 32),      # head_dim 32 (llama-tiny)
    (64, 8, 128, 64, 64),    # GQA 8 with long rows
    (8, 1, 256, 16, 20),     # MQA, head_dim 256, 5 partitions
    (6, 3, 64, 7, 40),       # an odd block size
])
def test_cuda_kernel_partition_boundaries(nh, kvh, hd, BS, MAXB, dtype, atol, rtol, cuda):
    parts = pa.plan(MAXB, BS, hd)[0]
    # around the boundaries where another partition wakes (a block more) and
    # where every partition holds a block (parts blocks), a full table, 0
    lens = sorted({max(0, n) for n in (1, BS - 1, BS, BS + 1, parts * BS - 1, parts * BS,
                                       parts * BS + 1, MAXB * BS - 1, MAXB * BS, 0)
                   if n <= MAXB * BS})
    args = make_case(len(lens), nh, kvh, hd, BS, MAXB, lens=lens, seed=3)
    q, kp, vp, tables, ln = (torch.from_numpy(a).to(cuda) for a in args)
    q, kp, vp = (t.to(dtype) for t in (q, kp, vp))
    out = pa.paged_decode_attention(q, kp, vp, tables, ln)
    torch.cuda.synchronize()
    ref = pa.paged_decode_attention_plain(q, kp, vp, tables, ln)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    assert not out[lens.index(0)].any()
    assert torch.equal(out, pa.paged_decode_attention(q, kp, vp, tables, ln))


@pytest.mark.cuda
def test_cuda_kernel_rows_do_not_depend_on_the_batch(cuda):
    # one row alone, among 8 and among 256 rows: bitwise equal. The rows
    # share the pool's blocks (as prefix hits do), so the pool stays small.
    BS, MAXB, nh = 64, 64, 32
    NB = 1 + 8 * MAXB
    gen = torch.Generator(device=cuda).manual_seed(4)
    kp, vp = (torch.randn(nh, NB, BS, 128, device=cuda, generator=gen).to(torch.bfloat16)
              for _ in range(2))
    q = torch.randn(256, nh, 128, device=cuda, generator=gen).to(torch.bfloat16)
    tables = torch.randint(1, NB, (256, MAXB), device=cuda, generator=gen, dtype=torch.int32)
    ln = torch.randint(0, MAXB * BS + 1, (256,), device=cuda, generator=gen, dtype=torch.int32)
    full = pa.paged_decode_attention(q, kp, vp, tables, ln)  # one CTA a row
    for rows in ([200], list(range(196, 204))):  # partitions split over clusters
        idx = torch.tensor(rows, device=cuda)
        args = (q[idx].contiguous(), kp, vp, tables[idx].contiguous(), ln[idx].contiguous())
        part = pa.paged_decode_attention(*args)
        assert torch.equal(part, full[idx])
        torch.testing.assert_close(part.float(), pa.paged_decode_attention_plain(*args).float(),
                                   atol=1e-2, rtol=1e-2)


def _shared_table_case(cuda, B, lens, nh=32, kvh=32, hd=128, BS=64, MAXB=64, seed=5,
                       dtype=torch.bfloat16):
    # B rows of one sequence (one table), as a prefill chunk's rows are
    gen = torch.Generator(device=cuda).manual_seed(seed)
    NB = 1 + MAXB
    kp, vp = (torch.randn(kvh, NB, BS, hd, device=cuda, generator=gen).to(dtype)
              for _ in range(2))
    q = torch.randn(B, nh, hd, device=cuda, generator=gen).to(dtype)
    table = torch.randperm(MAXB, device=cuda, generator=gen).to(torch.int32) + 1
    tables = table[None].repeat(B, 1).contiguous()
    return q, kp, vp, tables, torch.tensor(lens, dtype=torch.int32, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,heads,atol,rtol", [(torch.bfloat16, 32, 1e-2, 1e-2),
                                                   (torch.float32, 8, 1e-5, 0.0)])
@pytest.mark.parametrize("lens", [list(range(1, 257)),             # a 256-token prompt
                                  list(range(1793, 2049)),         # its 8th chunk
                                  [0] * 3 + list(range(500, 753))])
def test_cuda_kernel_rows_of_one_table_do_not_depend_on_the_batch(lens, dtype, heads, atol,
                                                                  rtol, cuda):
    # a prefill chunk: 16 rows a CTA (8 in fp32) share each K/V tile; each
    # row alone (split over a cluster) is bitwise its row of the chunk
    q, kp, vp, tables, ln = _shared_table_case(cuda, len(lens), lens, nh=heads, kvh=heads,
                                               dtype=dtype)
    before = pa.launches
    full = pa.paged_decode_attention(q, kp, vp, tables, ln)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    torch.testing.assert_close(full.float(), pa.paged_decode_attention_plain(
        q, kp, vp, tables, ln).float(), atol=atol, rtol=rtol)
    for rows in ([0], [5], [len(lens) - 1], list(range(3, 11))):
        idx = torch.tensor(rows, device=cuda)
        part = pa.paged_decode_attention(q[idx].contiguous(), kp, vp, tables[idx].contiguous(),
                                         ln[idx].contiguous())
        assert torch.equal(part, full[idx])


@pytest.mark.cuda
def test_cuda_kernel_mixed_batch_of_decode_rows_and_a_chunk(cuda):
    # decode rows of other sequences, then a chunk of one sequence starting
    # inside an 8-row group: every row bitwise as when computed alone
    q, kp, vp, tables, ln = _shared_table_case(cuda, 300, list(range(1000, 1300)), seed=6)
    gen = torch.Generator(device=cuda).manual_seed(7)
    tables[:5] = torch.randint(1, kp.shape[1], (5, tables.shape[1]), device=cuda,
                               generator=gen, dtype=torch.int32)
    ln[:5] = torch.tensor([4096, 1, 2000, 64, 65], dtype=torch.int32, device=cuda)
    full = pa.paged_decode_attention(q, kp, vp, tables, ln)
    torch.testing.assert_close(full.float(), pa.paged_decode_attention_plain(
        q, kp, vp, tables, ln).float(), atol=1e-2, rtol=1e-2)
    for r in (0, 2, 4, 5, 7, 8, 299):
        alone = pa.paged_decode_attention(q[r:r + 1].clone(), kp, vp, tables[r:r + 1].clone(),
                                          ln[r:r + 1].clone())
        assert torch.equal(alone, full[r:r + 1])
