"""The port's block-sparse attention and ``SparseSelfAttention``.

On the CPU, on the same numpy-seeded fp32 inputs as the JAX package:
``layout_to_lists`` exactly; the plain forward (out and lse) against the JAX
kernel run in Pallas interpret mode, as ``tests/unit/test_block_sparse.py``
runs it, at atol 2e-5; the port's gradients (its autograd Function over the
plain backward) against ``jax.grad`` of that kernel at 1e-4 of their max;
the masked path against the JAX package's at atol 1e-5; and the gates. The
cases cover causal and not, a GQA group of 2 with layouts that differ
within the group, and a layout with empty query blocks (o = 0 there, as the
kernel gives, not the masked path's mean of v). Each JAX result is computed
once per module.
On a card: the CUDA kernels against the plain versions, fp32 at atol 1e-5
(gradients at 1e-5 of max(1, their max)), bf16 at atol/rtol 1e-2
(gradients at 1e-2 of their max), and a repeated backward bitwise equal.
The card has no JAX, so this file imports it only in the tests that use it,
and runs there with ``python -m pytest --noconftest -m cuda
tests/test_torch_block_sparse.py``.
"""

import functools

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.sparse_attention import block_sparse_kernel as bs
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as sc
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import SparseSelfAttention

S, BLOCK, HD = 512, 128, 64


def empty_row_layout():
    """Two heads over 4 x 4 blocks: head 0 has no block in row 2, head 1 none
    in row 0 (and, under causal, only blocks at or left of the diagonal)."""
    lay = np.zeros((2, 4, 4), bool)
    lay[0, 0, 0] = lay[0, 1, [0, 1]] = lay[0, 3, [1, 3]] = True
    lay[1, 1, [0, 1]] = lay[1, 2, [0, 2, 3]] = lay[1, 3, :] = True
    return lay


# name: (layout, kv heads, causal); q has as many heads as the layout
CASES = {
    "fixed-causal": (sc.FixedSparsityConfig(num_heads=4, block=BLOCK, num_local_blocks=2,
                                            attention="unidirectional").make_layout(S), 4, True),
    "bigbird": (sc.BigBirdSparsityConfig(num_heads=4, block=BLOCK, num_random_blocks=1,
                                         num_sliding_window_blocks=1).make_layout(S), 4, False),
    "fixed-gqa2": (sc.FixedSparsityConfig(num_heads=4, block=BLOCK, num_local_blocks=2,
                                          different_layout_per_head=True,
                                          num_different_global_patterns=2).make_layout(S), 2,
                   False),
    "empty-rows-causal": (empty_row_layout(), 2, True),
    "empty-rows": (empty_row_layout(), 1, False),
}


def inputs(name, seed=0, hd=HD):
    """q, k, v and the loss weight (or do) of one case, fp32 numpy."""
    layout, kvh, _ = CASES[name]
    nh = layout.shape[0]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, S, nh, hd)).astype(np.float32),
            rng.standard_normal((1, S, kvh, hd)).astype(np.float32),
            rng.standard_normal((1, S, kvh, hd)).astype(np.float32),
            rng.standard_normal((1, S, nh, hd)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_ref():
    """(name, what) → the JAX kernel's ``"fwd"`` (out, lse) or ``"grads"``
    (dq, dk, dv), each computed once."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    jbs = pytest.importorskip("deepspeed_tpu.ops.sparse_attention.block_sparse_kernel")

    @functools.lru_cache(maxsize=None)
    def run(name, what):
        layout, kvh, causal = CASES[name]
        g = layout.shape[0] // kvh
        q, k, v, w = (jnp.asarray(a) for a in inputs(name))
        if what == "fwd":
            tr = lambda a: jnp.transpose(a, (0, 2, 1, 3))  # noqa: E731
            kcnt, kidx, _, _ = jbs.layout_to_lists(layout, causal)
            out, lse = jbs._sparse_fwd(tr(q), tr(k), tr(v), jnp.asarray(kcnt),
                                       jnp.asarray(kidx), causal=causal, g=g,
                                       scale=HD ** -0.5, block=BLOCK)
            return np.transpose(np.asarray(out), (0, 2, 1, 3)), np.asarray(lse)[..., 0]

        def loss(q_, k_, v_):
            o = jbs.block_sparse_attention(q_, k_, v_, layout, BLOCK, causal=causal,
                                           num_kv_groups=g)
            return jnp.sum(o * w)

        return tuple(np.asarray(x) for x in jax.grad(loss, argnums=(0, 1, 2))(q, k, v))

    return run


LIST_LAYOUTS = [CASES["fixed-causal"][0], CASES["bigbird"][0], CASES["fixed-gqa2"][0],
                empty_row_layout(),
                sc.VariableSparsityConfig(num_heads=3, block=16, num_random_blocks=1,
                                          local_window_blocks=[1, 3]).make_layout(256)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("i", range(len(LIST_LAYOUTS)))
def test_layout_to_lists_equals_the_jax_package(i, causal):
    jbs = pytest.importorskip("deepspeed_tpu.ops.sparse_attention.block_sparse_kernel")
    layout = LIST_LAYOUTS[i]
    for got, want in zip(bs.layout_to_lists(layout, causal), jbs.layout_to_lists(layout, causal)):
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_layout_to_lists_empty_row():
    kcnt, kidx, qcnt, qidx = bs.layout_to_lists(empty_row_layout(), causal=True)
    assert list(kcnt[0]) == [1, 2, 0, 2] and list(kcnt[1]) == [0, 2, 2, 4]
    assert list(kidx[1, 2, :2]) == [0, 2] and list(qcnt[1]) == [3, 2, 2, 1]


@pytest.mark.parametrize("name", list(CASES))
def test_plain_forward_matches_jax_kernel(name, jax_ref):
    layout, kvh, causal = CASES[name]
    q, k, v, _ = (torch.from_numpy(a) for a in inputs(name))
    out, lse = bs.block_sparse_attention_plain(q, k, v, layout, BLOCK, causal=causal,
                                               num_kv_groups=layout.shape[0] // kvh)
    ref_out, ref_lse = jax_ref(name, "fwd")
    assert out.shape == q.shape and lse.shape == (1, layout.shape[0], S)
    np.testing.assert_allclose(out.numpy(), ref_out, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=2e-5, rtol=1e-6)
    if name.startswith("empty-rows"):
        empty = ~bs.layout_to_lists(layout, causal)[0].astype(bool)  # (H, nQ)
        rows = np.repeat(empty, BLOCK, axis=1)  # (H, S)
        assert rows.any() and not out.numpy().transpose(0, 2, 1, 3)[0][rows].any()
        assert (lse.numpy()[0][rows] == np.float32(-1e30)).all()


@pytest.mark.parametrize("name", ["fixed-causal", "bigbird", "fixed-gqa2", "empty-rows-causal"])
def test_gradients_match_jax_grad_of_kernel(name, jax_ref):
    layout, kvh, causal = CASES[name]
    q, k, v, w = inputs(name)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = (bs.fwd_launches, bs.bwd_launches)
    out = bs.block_sparse_attention(tq, tk, tv, layout, BLOCK, causal=causal,
                                    num_kv_groups=layout.shape[0] // kvh)
    (out * torch.from_numpy(w)).sum().backward()
    assert (bs.fwd_launches, bs.bwd_launches) == before  # CPU: the plain versions
    for got, want in zip((tq.grad, tk.grad, tv.grad), jax_ref(name, "grads")):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max())


_BIGBIRD_16 = dict(num_heads=4, block=16, num_random_blocks=1, num_sliding_window_blocks=3)


@pytest.mark.parametrize("cfg_name,kw,seq,mode", [
    ("FixedSparsityConfig", dict(num_heads=4, block=BLOCK, num_local_blocks=2,
                                 attention="unidirectional"), S, "never"),
    ("BigBirdSparsityConfig", _BIGBIRD_16, 256, "never"),
    ("BigBirdSparsityConfig", _BIGBIRD_16, 256, "auto"),  # block < 128: the masked path
])
def test_masked_path_matches_the_jax_package(cfg_name, kw, seq, mode):
    jsa = pytest.importorskip("deepspeed_tpu.ops.sparse_attention")
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, seq, 4, HD)).astype(np.float32) for _ in range(3))
    want = np.asarray(jsa.SparseSelfAttention(getattr(jsa, cfg_name)(**kw))(
        *(jnp.asarray(a) for a in (q, k, v)), use_kernel=mode))
    before = bs.fwd_launches
    got = SparseSelfAttention(getattr(sc, cfg_name)(**kw))(
        *(torch.from_numpy(a) for a in (q, k, v)), use_kernel=mode)
    assert bs.fwd_launches == before
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_always_on_cpu_runs_the_plain_kernel_path():
    layout, _, causal = CASES["fixed-causal"]
    q, k, v, _ = (torch.from_numpy(a) for a in inputs("fixed-causal"))
    sa = SparseSelfAttention(sc.FixedSparsityConfig(num_heads=4, block=BLOCK,
                                                    num_local_blocks=2,
                                                    attention="unidirectional"))
    got = sa(q, k, v, use_kernel="always")
    want, _ = bs.block_sparse_attention_plain(q, k, v, layout, BLOCK, causal=causal)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    torch.testing.assert_close(got, sa(q, k, v, use_kernel="never"), atol=1e-5, rtol=1e-5)


def test_gates_raise_as_the_jax_package():
    jbs = pytest.importorskip("deepspeed_tpu.ops.sparse_attention.block_sparse_kernel")
    jsa = pytest.importorskip("deepspeed_tpu.ops.sparse_attention")
    import jax.numpy as jnp

    x = np.zeros((1, 256, 2, HD), np.float32)
    lay = np.ones((2, 2, 2), bool)
    for mod, arr in ((bs, torch.from_numpy(x)), (jbs, jnp.asarray(x))):
        with pytest.raises(NotImplementedError):  # S not a multiple of the block
            mod.block_sparse_attention(arr[:, :200], arr[:, :200], arr[:, :200], lay, 128)
        with pytest.raises(NotImplementedError):  # block < 128
            mod.block_sparse_attention(arr, arr, arr, np.ones((2, 4, 4), bool), 64)
        with pytest.raises(ValueError, match="layout shape"):
            mod.block_sparse_attention(arr, arr, arr, np.ones((3, 2, 2), bool), 128)
    for mod, arr in ((sc, torch.from_numpy(x)), (jsa, jnp.asarray(x))):
        sa = (SparseSelfAttention if mod is sc else jsa.SparseSelfAttention)(
            mod.FixedSparsityConfig(num_heads=2, block=16))
        with pytest.raises(NotImplementedError):
            sa(arr, arr, arr, use_kernel="always")


@pytest.mark.parametrize("block,hd,dtype,ok", [
    (128, 128, torch.bfloat16, True), (256, 64, torch.float32, True),
    (192, 256, torch.float16, True), (160, 128, torch.bfloat16, False),
    (128, 32, torch.bfloat16, True), (128, 48, torch.bfloat16, False),
    (128, 128, torch.float64, False),
])
def test_kernel_gate(block, hd, dtype, ok):
    if ok:
        bs.check_kernel_config(8, 4, hd, dtype, block)
    else:
        with pytest.raises(NotImplementedError):
            bs.check_kernel_config(8, 4, hd, dtype, block)


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


def _card_case(name, hd, dtype, dev):
    layout, kvh, causal = CASES[name]
    q, k, v, do = (torch.from_numpy(a).to(dev, dtype) for a in inputs(name, hd=hd))
    return layout, layout.shape[0] // kvh, causal, q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,hd", [("fixed-causal", 128), ("bigbird", 64),
                                     ("fixed-gqa2", 256), ("empty-rows-causal", 64),
                                     ("empty-rows", 128), ("fixed-gqa2", 32)])
def test_cuda_kernels_match_plain(name, hd, dtype, cuda):
    layout, g, causal, q, k, v, do = _card_case(name, hd, dtype, cuda)
    kw = dict(causal=causal, num_kv_groups=g)
    f0, b0 = bs.fwd_launches, bs.bwd_launches
    out, lse = bs.block_sparse_attention_fwd(q, k, v, layout, BLOCK, **kw)
    grads = bs.block_sparse_attention_bwd(q, k, v, out, lse, do, layout, BLOCK, **kw)
    again = bs.block_sparse_attention_bwd(q, k, v, out, lse, do, layout, BLOCK, **kw)
    torch.cuda.synchronize()
    assert (bs.fwd_launches, bs.bwd_launches) == (f0 + 1, b0 + 2)
    for a, b in zip(grads, again):
        assert torch.equal(a, b), "the backward does not repeat bitwise"
    ref_out, ref_lse = bs.block_sparse_attention_plain(q, k, v, layout, BLOCK, **kw)
    ref_grads = bs.block_sparse_attention_bwd_plain(q, k, v, ref_out, ref_lse, do, layout,
                                                    BLOCK, **kw)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref_out, atol=1e-5, rtol=0)
        torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=0)
        for got, want in zip(grads, ref_grads):
            _close_rel(got, want, 1e-5, floor=1.0)
    else:
        torch.testing.assert_close(out.float(), ref_out.float(), atol=1e-2, rtol=1e-2)
        torch.testing.assert_close(lse, ref_lse, atol=1e-2, rtol=1e-2)
        for got, want in zip(grads, ref_grads):
            _close_rel(got, want, 1e-2)


@pytest.mark.cuda
def test_cuda_sparse_self_attention_paths(cuda):
    cfg = sc.FixedSparsityConfig(num_heads=4, block=BLOCK, num_local_blocks=2,
                                 attention="unidirectional")
    sa = SparseSelfAttention(cfg)
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in inputs("fixed-causal")[:3])
    f0 = bs.fwd_launches
    out = sa(q, k, v)  # auto on the card: the kernel
    assert bs.fwd_launches == f0 + 1
    ref, _ = bs.block_sparse_attention_plain(q, k, v, cfg.make_layout(S), BLOCK, causal=True)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=1e-2)
    small = SparseSelfAttention(sc.FixedSparsityConfig(num_heads=4, block=16))
    small(q, k, v)  # block < 128: the JAX gate's masked path
    assert bs.fwd_launches == f0 + 1
    x = q[..., :32].contiguous()  # head_dim 32: the kernel
    sa(x, x, x)
    assert bs.fwd_launches == f0 + 2
    with pytest.raises(NotImplementedError):  # head_dim 48: raises out of auto
        x = q[..., :48].contiguous()
        sa(x, x, x)
    with pytest.raises(NotImplementedError):  # a block that is not a multiple of 64
        SparseSelfAttention(sc.FixedSparsityConfig(num_heads=4, block=160))(
            q[:, :480], k[:, :480], v[:, :480])


def test_builders_cover_every_source_and_hash_the_shared_header(tmp_path, monkeypatch):
    import os
    import shutil

    from deepspeed_tpu_torch.ops import op_builder as ob

    csrc = os.path.join(ob._PKG_ROOT, "csrc")
    assert {b().source_path() for b in ob.ALL_BUILDERS} == {
        os.path.join(csrc, f) for f in os.listdir(csrc) if f.endswith(".cu")}
    # an edit to the header the attention sources include names a new library
    shutil.copytree(csrc, tmp_path / "csrc")
    monkeypatch.setattr(ob, "_PKG_ROOT", str(tmp_path))
    before = [b().lib_path() for b in (ob.FlashAttentionBuilder, ob.BlockSparseAttentionBuilder)]
    header = tmp_path / "csrc" / "attention_kernels.cuh"
    header.write_text(header.read_text() + "\n")
    after = [b().lib_path() for b in (ob.FlashAttentionBuilder, ob.BlockSparseAttentionBuilder)]
    assert all(a != b for a, b in zip(before, after))
