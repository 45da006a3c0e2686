"""The port's paged decode attention.

On the CPU: the plain version against the JAX package's Pallas kernel, run
in interpret mode as the JAX package's own tests run it, with ``stream=True``
and ``stream=False``; atol 2e-5, as ``tests/unit/test_paged_kernel.py``.
On a card: the CUDA kernel against the plain version, in float32 at atol
1e-5 and in bfloat16 at atol/rtol 1e-2 (both accumulate in float32 and
round once). The card has no JAX, so this file imports it only for the
tests that use it, and runs there with
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
                                       (2, 4, 128)])
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
    (256, 8, 1, torch.float16, True), (80, 32, 32, torch.bfloat16, False),
    (128, 6, 4, torch.bfloat16, False), (128, 8, 8, torch.float64, False),
])
def test_kernel_gate(hd, nh, kvh, dtype, ok):
    if ok:
        pa.check_kernel_config(nh, kvh, hd, dtype)
    else:
        with pytest.raises(NotImplementedError):
            pa.check_kernel_config(nh, kvh, hd, dtype)


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
