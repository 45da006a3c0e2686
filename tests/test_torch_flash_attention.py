"""The port's flash attention and its dispatch.

On the CPU: the plain forward (out and lse) against the JAX package's Pallas
kernel run in interpret mode, as the JAX package's own tests run it, and the
port's gradients (its autograd Function over the plain backward) against
``jax.grad`` of that kernel, at ``tests/unit/test_models.py:108-133``'s shapes.
fp32 throughout; out and lse at atol 2e-5 (the paged kernel's tolerance),
gradients at atol 1e-4 (three chained fp32 products over 256 keys).
At head_dim 32, outside the Pallas gate, the plain forward and the port's
gradients against the JAX package's ``attention()`` dispatch, which runs XLA
there, at the same tolerances.
On a card: the CUDA kernels against the plain versions, fp32 at atol 1e-5
(gradients at 1e-5 of max(1, their max): dk and dv sum g * S products in
another order than the plain version's GEMM), bf16 and fp16 at atol/rtol
1e-2 (gradients at 1e-2 of their max), and a repeated 16-bit call bitwise
equal to the first. The card has no
JAX, so this file imports it only in the tests that use it, and runs there
with ``python -m pytest --noconftest -m cuda tests/test_torch_flash_attention.py``.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.transformer import attention as att
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

SHAPES = [(4, 64), (2, 64), (1, 128), (4, 128), (2, 128), (1, 64)]  # (kvh, hd)


def make_qkv(B, S, nh, kvh, hd, seed=0, Skv=None):
    rng = np.random.default_rng(seed)
    Skv = Skv or S
    return (rng.standard_normal((B, S, nh, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, kvh, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, kvh, hd)).astype(np.float32))


@pytest.fixture
def jax_flash():
    return pytest.importorskip("deepspeed_tpu.ops.transformer.flash_attention")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kvh,hd", SHAPES)
def test_plain_forward_matches_jax_pallas_kernel(kvh, hd, causal, jax_flash):
    import jax.numpy as jnp

    B, S, nh = 2, 256, 4
    q, k, v = make_qkv(B, S, nh, kvh, hd)
    g = nh // kvh
    tr = lambda a: jnp.transpose(jnp.asarray(a), (0, 2, 1, 3))  # noqa: E731
    ref_out, ref_lse = jax_flash._fwd(tr(q), tr(k), tr(v), causal=causal, num_kv_groups=g,
                                      scale=hd ** -0.5, block_q=128, block_k=128)
    out, lse = fa.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                        torch.from_numpy(v), causal=causal, num_kv_groups=g)
    assert out.shape == (B, S, nh, hd) and lse.shape == (B, nh, S)
    np.testing.assert_allclose(out.numpy(), np.transpose(np.asarray(ref_out), (0, 2, 1, 3)),
                               atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0], atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kvh,hd", SHAPES)
def test_gradients_match_jax_grad_of_pallas_kernel(kvh, hd, causal, jax_flash):
    import jax
    import jax.numpy as jnp

    B, S, nh = 2, 256, 4
    q, k, v = make_qkv(B, S, nh, kvh, hd, seed=1)
    w = np.random.default_rng(2).standard_normal((B, S, nh, hd)).astype(np.float32)
    g = nh // kvh

    def loss(q_, k_, v_):
        out = jax_flash.flash_attention(q_, k_, v_, causal=causal, num_kv_groups=g)
        return jnp.sum(out * jnp.asarray(w))

    ref = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal, num_kv_groups=g)
    (out * torch.from_numpy(w)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.fixture
def jax_attention():
    pytest.importorskip("jax")
    import importlib

    return importlib.import_module("deepspeed_tpu.ops.transformer.attention")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kvh", [4, 2, 1])
def test_head_dim_32_plain_forward_matches_jax_dispatch(kvh, causal, jax_attention):
    # head_dim 32 is outside the Pallas gate: the JAX dispatch runs XLA
    import jax.numpy as jnp

    B, S, nh, hd = 2, 130, 4, 32
    q, k, v = make_qkv(B, S, nh, kvh, hd, seed=5)
    g = nh // kvh
    ref = jax_attention.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=causal, num_kv_groups=g, impl="pallas_flash")
    out, lse = fa.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                        torch.from_numpy(v), causal=causal, num_kv_groups=g)
    assert out.shape == (B, S, nh, hd) and lse.shape == (B, nh, S)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kvh", [4, 2])
def test_head_dim_32_gradients_match_jax_grad_of_dispatch(kvh, causal, jax_attention):
    import jax
    import jax.numpy as jnp

    B, S, nh, hd = 2, 130, 4, 32
    q, k, v = make_qkv(B, S, nh, kvh, hd, seed=6)
    w = np.random.default_rng(7).standard_normal((B, S, nh, hd)).astype(np.float32)
    g = nh // kvh

    def loss(q_, k_, v_):
        out = jax_attention.attention(q_, k_, v_, causal=causal, num_kv_groups=g,
                                      impl="pallas_flash")
        return jnp.sum(out * jnp.asarray(w))

    ref = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal, num_kv_groups=g)
    (out * torch.from_numpy(w)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_autograd_of_plain_attention(causal):
    q, k, v = make_qkv(2, 100, 4, 2, 64, seed=3)  # S not a multiple of any tile
    do = torch.from_numpy(np.random.default_rng(4).standard_normal(q.shape).astype(np.float32))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    att.xla_attention(tq, tk, tv, causal=causal, num_kv_groups=2).backward(do)
    out, lse = fa.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                        causal=causal, num_kv_groups=2)
    grads = fa.flash_attention_bwd_plain(*(torch.from_numpy(a) for a in (q, k, v)), out, lse,
                                         do, causal=causal, num_kv_groups=2)
    for got, want in zip(grads, (tq.grad, tk.grad, tv.grad)):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_attention_on_cpu_runs_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in make_qkv(1, 64, 4, 2, 64))
    before = (fa.fwd_launches, fa.bwd_launches)
    assert att.get_default_impl() is None and att._auto_impl(q) == "xla"
    out = att.attention(q, k, v, causal=True, num_kv_groups=2)
    torch.testing.assert_close(out, att.xla_attention(q, k, v, causal=True, num_kv_groups=2),
                               atol=0, rtol=0)
    att.set_default_impl("pallas_flash")
    try:
        forced = att.attention(q, k, v, causal=True, num_kv_groups=2)
        # bias is not the kernel's: on the CPU the dispatch runs the plain version
        bias = torch.zeros(1, 1, 1, 1, 64)
        biased = att.attention(q, k, v, causal=True, num_kv_groups=2, bias=bias)
    finally:
        att.set_default_impl(None)
    torch.testing.assert_close(forced, out, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(biased, out, atol=1e-6, rtol=1e-6)
    assert (fa.fwd_launches, fa.bwd_launches) == before


@pytest.mark.parametrize("kw", [dict(bias=torch.zeros(1, 1, 1, 1, 8)), dict(softcap=30.0),
                                dict(q_offset=3)])
def test_flash_entry_refuses_what_the_kernel_does_not_compute(kw):
    # an offset runs the forward since slot mode; only its backward is refused
    q = torch.zeros(1, 8, 2, 64, requires_grad="q_offset" in kw)
    with pytest.raises(NotImplementedError, match="bias/softcap/q_offset"):
        fa.flash_attention(q, q, q, **kw)


@pytest.mark.parametrize("hd,nh,kvh,dtype,ok", [
    (128, 32, 32, torch.bfloat16, True), (128, 64, 8, torch.float32, True),
    (64, 4, 2, torch.float16, True), (256, 8, 1, torch.bfloat16, True),
    (32, 8, 4, torch.bfloat16, True), (48, 8, 4, torch.bfloat16, False),
    (80, 32, 32, torch.bfloat16, False),
    (128, 6, 4, torch.bfloat16, False), (128, 8, 8, torch.float64, False),
])
def test_kernel_gate(hd, nh, kvh, dtype, ok):
    if ok:
        fa.check_kernel_config(nh, kvh, hd, dtype)
    else:
        with pytest.raises(NotImplementedError):
            fa.check_kernel_config(nh, kvh, hd, dtype)


def test_plain_rounds_p_to_v_dtype_before_pv():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in make_qkv(1, 32, 2, 2, 64))
    out, lse = fa.flash_attention_plain(q, k, v, causal=True)
    ref = att.xla_attention(q, k, v, causal=True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=1e-2)


# ----------------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _close_rel(got, want, tol, floor=0.0):
    scale = max(floor, want.float().abs().max().item() + 1e-6)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * scale, f"max err {err:.3g} > {tol} x {scale:.3g}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,S,nh,kvh,hd,causal,Skv", [
    (2, 256, 4, 4, 128, True, None), (1, 256, 8, 2, 64, False, None),
    (1, 200, 4, 1, 256, True, None), (2, 1000, 4, 2, 128, True, None),
    (1, 1000, 4, 4, 64, False, None), (2, 130, 8, 1, 128, True, None),
    (1, 130, 4, 2, 32, True, None), (1, 1000, 4, 4, 32, False, None),
    (1, 130, 4, 2, 128, False, 300), (1, 300, 8, 1, 64, False, 130),
])
def test_cuda_kernels_match_plain(B, S, nh, kvh, hd, causal, Skv, dtype, cuda):
    q, k, v = (torch.from_numpy(a).to(cuda, dtype) for a in make_qkv(B, S, nh, kvh, hd, Skv=Skv))
    do = torch.randn(q.shape, generator=torch.Generator(cuda).manual_seed(0), device=cuda,
                     dtype=torch.float32).to(dtype)
    g = nh // kvh
    f0, b0 = fa.fwd_launches, fa.bwd_launches
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, num_kv_groups=g)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal, num_kv_groups=g)
    torch.cuda.synchronize()
    assert (fa.fwd_launches, fa.bwd_launches) == (f0 + 1, b0 + 1)
    if dtype != torch.float32:  # no atomics, sums in a fixed order: bitwise repeats
        out2, lse2 = fa.flash_attention_fwd(q, k, v, causal=causal, num_kv_groups=g)
        grads2 = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal, num_kv_groups=g)
        assert torch.equal(out, out2) and torch.equal(lse, lse2)
        assert all(torch.equal(a, b) for a, b in zip(grads, grads2))
    ref_out, ref_lse = fa.flash_attention_plain(q, k, v, causal=causal, num_kv_groups=g)
    ref_grads = fa.flash_attention_bwd_plain(q, k, v, ref_out, ref_lse, do, causal=causal,
                                             num_kv_groups=g)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref_out, atol=1e-5, rtol=0)
        torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=0)
        for got, want in zip(grads, ref_grads):  # dk/dv sum g * S products
            _close_rel(got, want, 1e-5, floor=1.0)
    else:
        torch.testing.assert_close(out.float(), ref_out.float(), atol=1e-2, rtol=1e-2)
        torch.testing.assert_close(lse, ref_lse, atol=1e-2, rtol=1e-2)
        for got, want in zip(grads, ref_grads):
            _close_rel(got, want, 1e-2)


@pytest.mark.cuda
def test_cuda_llama_tiny_trains_through_the_kernel(cuda):
    # head_dim 32: the engine takes it on the card, its attention launches
    # the kernels, and fp32 losses follow the same engine on the CPU
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import build_model

    model = build_model("llama-tiny", vocab_size=512, num_layers=2, max_seq_len=256)
    assert model.config.head_dim == 32
    params = model.init_params(torch.Generator().manual_seed(0))
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "eps": 1e-6}}}
    engines = [deepspeed_tpu_torch.initialize(model=model, model_parameters=params,
                                              config=dict(cfg), device=d)[0]
               for d in ("cpu", cuda)]
    rng = np.random.default_rng(0)
    f0, b0 = fa.fwd_launches, fa.bwd_launches
    for _ in range(2):
        batch = {"input_ids": rng.integers(0, 512, (2, 200)).astype(np.int32)}
        ref, got = (float(e.train_batch(iter([batch]))) for e in engines)
        assert np.isfinite(got) and abs(got - ref) <= 1e-5 * abs(ref), (got, ref)
    assert (fa.fwd_launches - f0, fa.bwd_launches - b0) == (2 * 2, 2 * 2)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(bias=0), dict(softcap=30.0), dict(q_offset=3)])
def test_cuda_dispatch_raises_instead_of_running_the_plain_version(kw, cuda):
    # an offset runs the kernel's forward since slot mode: with gradients
    # (the backward kernels take none) it raises
    q = torch.zeros(1, 128, 2, 64, device=cuda, dtype=torch.bfloat16,
                    requires_grad="q_offset" in kw)
    if "bias" in kw:
        kw = dict(bias=torch.zeros(1, 1, 1, 1, 128, device=cuda))
    with pytest.raises(NotImplementedError):
        att.attention(q, q, q, causal=True, **kw)
    with pytest.raises(NotImplementedError):  # head_dim 48: not the kernels'
        att.attention(q[..., :48].contiguous(), q[..., :48].contiguous(),
                      q[..., :48].contiguous())
    with pytest.raises(ValueError):
        att.attention(q, q, q, impl="xla")
