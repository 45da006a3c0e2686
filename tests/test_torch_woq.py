"""The port's weight-only quantization and ``woq_matmul``.

On the CPU, against the JAX package, on the same numpy inputs:

- ``quantize_leaf`` / ``quantize_param_tree`` give the JAX package's codes
  byte for byte and its scales exactly, for 4, 6 and 8 bits, with a group
  that divides In and one that ``_group_size`` walks down to (a group that
  is not a power of two); ``dequant_params`` agrees at atol 0, over every
  byte value as well;
- ``woq_matmul`` (its plain version on the CPU) matches the JAX Pallas
  kernel in interpret mode at rtol 1e-5 / atol 1e-4, the JAX package's own
  tolerance (``tests/unit/test_woq.py:169``).

On the CPU, the grid plan: it covers K exactly once at each kernel's K
step, routes by rows and x's dtype, and splits K only where the card's
residency leaves a wave short; the decode GEMV's splits (one cluster a
column tile, at most 8) cover every group once and never depend on the
number of rows.

On a card (``cuda``-marked, skipped here): the CUDA kernel against the plain
version. Both form each weight as ``code * scale`` in fp32, round it to x's
dtype and sum products in fp32, so they differ only in the order of an fp32
sum: rtol 1e-5 / atol 1e-4 for every x dtype; a GEMV row computed alone is
bitwise its row of the 8-row call. Run there with
``python -m pytest --noconftest -m cuda tests/test_torch_woq.py``.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.quantization import quantize_model
from deepspeed_tpu_torch.models import build_model, params_from_jax, params_to_numpy
from deepspeed_tpu_torch.ops.quantizer import woq, woq_gemm

# (In, Out, requested group): one group that divides In, one that the
# quantizer walks down to (200 asks 128, gets 100 for int8/int4, 100 for int6)
LEAF_CASES = [(256, 48, 128), (200, 40, 128), (384, 24, 96)]


@pytest.fixture
def jax_woq():
    return pytest.importorskip("deepspeed_tpu.ops.quantizer.woq")


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("In,Out,group", LEAF_CASES)
def test_quantize_leaf_bytes_match_jax(bits, In, Out, group, jax_woq):
    w = np.random.default_rng(bits).standard_normal((2, In, Out)).astype(np.float32)
    w[1, :group] = 0.0  # an all-zero group: its scale becomes 1
    jc, js = jax_woq.quantize_leaf(w, bits, group)
    tc, ts = woq.quantize_leaf(torch.from_numpy(w), bits, group)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    want = jax_woq.dequant_params({"w::q%d" % bits: jc, "w::scale": js}, np.float32)["w"]
    got = woq.dequant_params({"w::q%d" % bits: tc, "w::scale": ts}, torch.float32)["w"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_dequant_matches_jax_over_every_byte(bits, jax_woq):
    import jax.numpy as jnp

    # every byte value, several times, in random rows and columns
    packed = {8: 256, 4: 256, 6: 768}[bits]
    rng = np.random.default_rng(1)
    codes = np.arange(packed * 3, dtype=np.int64).reshape(1, packed, 3)
    codes = (rng.permutation(codes.size).reshape(codes.shape) % 256).astype(np.uint8)
    codes = codes.view(np.int8)
    scale = rng.uniform(0.5, 2.0, (1, 1, 3)).astype(np.float32)
    want = jax_woq.dequant_params({"w::q%d" % bits: jnp.asarray(codes),
                                   "w::scale": jnp.asarray(scale)}, np.float32)["w"]
    got = woq.dequant_params({"w::q%d" % bits: torch.from_numpy(codes),
                              "w::scale": torch.from_numpy(scale)}, torch.float32)["w"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unpack_every_byte_value_int4_sign_extension():
    b = torch.arange(-128, 128, dtype=torch.int8).reshape(1, 256, 1)
    w = woq._dequant_leaf(b, torch.ones(1, 1, 1), 4, torch.float32).reshape(256, 2)
    ref = np.array([[((v & 15) ^ 8) - 8, v >> 4] for v in range(-128, 128)], np.float32)
    np.testing.assert_array_equal(w.numpy(), ref)


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_quantize_param_tree_matches_jax(bits, jax_woq):
    import jax

    from deepspeed_tpu.models import build_model as jax_build_model

    kw = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
              intermediate_size=96, max_seq_len=32)
    jm = jax_build_model("llama-tiny", **kw)
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    jq = jax.tree.map(np.asarray, jax_woq.quantize_param_tree(jp, bits, 64))
    _, tq = quantize_model(build_model("llama-tiny", **kw), params_from_jax(jp),
                           num_bits=bits, group_size=64)
    tq = params_to_numpy(tq)
    assert sorted(tq["blocks"]) == sorted(jq["blocks"])
    for k, v in jq["blocks"].items():
        assert tq["blocks"][k].dtype == v.dtype, k
        np.testing.assert_array_equal(tq["blocks"][k], v, err_msg=k)
    np.testing.assert_array_equal(tq["wte"], jq["wte"])


def test_quantize_param_tree_rejects_bad_bits_and_trees():
    with pytest.raises(ValueError):
        woq.quantize_param_tree({"blocks": {}}, num_bits=5)
    with pytest.raises(ValueError):
        woq.quantize_param_tree({"wte": torch.zeros(2, 2)})
    with pytest.raises(ValueError):
        woq._group_size(30, 16, 6)
    # ported since (tensor parallelism): the JAX mapping of a model's specs
    # onto a quantized tree, entry for entry
    from jax.sharding import PartitionSpec as P

    from deepspeed_tpu.ops.quantizer import woq as jwoq

    q = {"blocks": {"wq::q8": 0, "wq::scale": 0, "w_down::q8": 0, "w_down::scale": 0,
                    "ln1_scale": 0, "extra": 0}, "wte": 0}
    tp = {"wte": ("model", None), "blocks": {"wq": (None, None, "model"),
                                             "w_down": (None, "model", None),
                                             "ln1_scale": (None, None)}}
    got = woq.quantized_tp_specs(tp, q)
    want = jwoq.quantized_tp_specs({"wte": P("model", None), "blocks": {
        k: P(*v) for k, v in tp["blocks"].items()}}, q)
    assert got["wte"] == ("model", None)
    assert sorted(got["blocks"]) == sorted(want["blocks"])
    for k, spec in want["blocks"].items():
        assert tuple(got["blocks"][k]) == tuple(spec), k


def _gemm_case(B, In, Out, group, bits, seed=0):
    rng = np.random.default_rng(seed)
    w = (0.02 * rng.standard_normal((In, Out))).astype(np.float32)
    x = rng.standard_normal((B, In)).astype(np.float32)
    codes, scale = woq.quantize_leaf(torch.from_numpy(w), bits, group)
    return torch.from_numpy(x), codes, scale


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("B", [1, 8, 37])
@pytest.mark.parametrize("In,group", [(256, 128), (384, 96)])
def test_woq_matmul_matches_jax_pallas_kernel(bits, B, In, group):
    jax_gemm = pytest.importorskip("deepspeed_tpu.ops.quantizer.woq_gemm")
    import jax.numpy as jnp

    x, codes, scale = _gemm_case(B, In, 384, group, bits, seed=B)
    assert woq.group_of(bits, codes.shape[1]) == group
    ref = jax_gemm.woq_matmul(jnp.asarray(x.numpy()), jnp.asarray(codes.numpy()),
                              jnp.asarray(scale.numpy()), bits)
    before = woq_gemm.launches
    out = woq_gemm.woq_matmul(x, codes, scale, bits)
    assert woq_gemm.launches == before  # CPU tensors take the plain version
    assert out.shape == (B, 384) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


def test_woq_matmul_rounds_the_weight_to_x_dtype():
    x, codes, scale = _gemm_case(4, 256, 64, 128, 8)
    xb = x.to(torch.bfloat16)
    w = woq.dequant_params({"w::q8": codes, "w::scale": scale}, torch.bfloat16)["w"]
    ref = xb.float() @ w.float()
    torch.testing.assert_close(woq_gemm.woq_matmul(xb, codes, scale, 8), ref,
                               rtol=1e-6, atol=1e-6)


def test_woq_matmul_rejects_mismatched_codes():
    x, codes, scale = _gemm_case(2, 256, 64, 128, 8)
    with pytest.raises(ValueError):
        woq_gemm.woq_matmul(x[:, :128], codes, scale, 8)


@pytest.mark.parametrize("In,Out,bits,group,dtype,ok", [
    (4096, 11008, 8, 128, torch.bfloat16, True), (11008, 4096, 6, 128, torch.float32, True),
    (200, 40, 4, 100, torch.float16, True), (4096, 4100, 8, 128, torch.bfloat16, False),
    (4096, 4096, 8, 128, torch.float64, False), (4096, 4096, 6, 130, torch.bfloat16, False),
    (4096, 4096, 5, 128, torch.bfloat16, False), (4096, 4096, 8, 96, torch.bfloat16, False),
])
def test_kernel_gate(In, Out, bits, group, dtype, ok):
    if ok:
        woq_gemm.check_woq_config(In, Out, bits, group, dtype)
    else:
        with pytest.raises(NotImplementedError):
            woq_gemm.check_woq_config(In, Out, bits, group, dtype)


@pytest.mark.parametrize("rows,In,Out,group", [
    (1, 4096, 4096, 128), (8, 4096, 11008, 128), (8, 11008, 4096, 128),
    (37, 4096, 4096, 128), (256, 4096, 11008, 128), (9, 200, 40, 100),
])
def test_plan_covers_k_exactly_once(rows, In, Out, group):
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for ctas in (1, 2, 3):
            kind, _, _, splits, split_len = woq_gemm.plan(rows, In, Out, group, dtype, ctas, 132)
            extent = In // group if kind == "gemv" else In
            if kind == "mma":
                assert split_len % woq_gemm.MMA_TILE_K == 0
            elif kind == "fma":
                assert split_len % woq_gemm.FMA_TILE_K == 0
            # every split is non-empty and together they cover K
            assert (splits - 1) * split_len < extent <= splits * split_len
            assert 1 <= splits <= 65535


@pytest.mark.parametrize("rows,dtype,kind,tile", [
    (1, torch.bfloat16, "gemv", (0, 128)), (8, torch.float32, "gemv", (0, 128)),
    (9, torch.float32, "fma", (64, 64)), (256, torch.float32, "fma", (64, 64)),
    (9, torch.bfloat16, "mma", (64, 128)), (64, torch.float16, "mma", (64, 128)),
    (65, torch.bfloat16, "mma", (256, 128)), (129, torch.float16, "mma", (256, 128)),
    (256, torch.bfloat16, "mma", (256, 128)), (300, torch.bfloat16, "mma", (256, 128)),
])
def test_plan_routes_by_rows_and_dtype(rows, dtype, kind, tile):
    # decode rows take the few-rows kernel (128-column tiles at 4096 columns);
    # more rows in fp32 the FMA tile kernel, in 16 bits the tensor-core
    # kernel: 64-row tiles up to 64 rows, else 256
    kind_, tile_m, tile_n, _, _ = woq_gemm.plan(rows, 4096, 4096, 128, dtype, 1, 132)
    assert (kind_, (tile_m, tile_n)) == (kind, tile)


@pytest.mark.parametrize("rows,In,Out,ctas,sms,splits", [
    # 32 tiles of 256 x 128 on 132 SMs at 1 CTA an SM: a quarter of a wave,
    # so K splits in 4 (one full wave of a quarter of the steps)
    (256, 4096, 4096, 1, 132, 4), (256, 11008, 4096, 1, 132, 4),
    # 86 tiles: 0.65 of a wave; 3 splits make 2 nearly full waves
    (256, 4096, 11008, 1, 132, 3),
    # tiles that fill whole waves take no split
    (256, 4096, 132 * 128, 1, 132, 1), (256, 4096, 2 * 132 * 128, 1, 132, 1),
    (64, 4096, 2 * 132 * 128, 2, 132, 1), (300, 4096, 66 * 128, 1, 132, 1),
])
def test_plan_splits_k_only_when_waves_gain(rows, In, Out, ctas, sms, splits):
    assert woq_gemm.plan(rows, In, Out, 128, torch.bfloat16, ctas, sms)[3] == splits


GEMV_SHAPES = [(4096, 4096, 128), (4096, 11008, 128), (11008, 4096, 128), (384, 264, 96),
               (4000, 1024, 125), (200, 40, 100), (512, 384, 128), (64, 8, 1), (4096, 4096, 2)]


@pytest.mark.parametrize("In,Out,group", GEMV_SHAPES)
def test_gemv_plan_covers_every_group_once_in_one_cluster(In, Out, group):
    ng = In // group
    for sms in (132, 114, 8):
        kind, _, ncol, splits, per = woq_gemm.plan(8, In, Out, group, torch.bfloat16, 1, sms)
        assert kind == "gemv" and ncol == woq_gemm.GEMV_COLS
        assert 1 <= splits <= woq_gemm.GEMV_MAX_SPLITS  # a portable cluster
        # split z takes groups [z * per, min(ng, z * per + per)): each once
        covered = [g for z in range(splits) for g in range(z * per, min(ng, z * per + per))]
        assert covered == list(range(ng)) and (splits - 1) * per < ng
        tiles = -(-Out // ncol)
        # splits only as many as one wave of CTAs takes (or none to take)
        slots = woq_gemm.gemv_ctas_per_sm(torch.bfloat16) * sms
        assert splits == 1 or tiles * splits <= slots


@pytest.mark.parametrize("In,Out,group", GEMV_SHAPES)
def test_gemv_plan_never_depends_on_rows(In, Out, group):
    # a row's sums are the same at 1 and at 8 rows: one plan for every row count
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        plans = {woq_gemm.plan(r, In, Out, group, dtype, 1, 132) for r in range(1, 9)}
        assert len(plans) == 1


def test_gemv_plan_at_the_main_paths_shapes():
    # llama-7b's projections at 8 decode rows, bf16: one wave of 256-344
    # CTAs at 3 an SM; fp32 x (2 an SM) takes fewer splits where a wave is short
    assert woq_gemm.plan(8, 4096, 4096, 128) == ("gemv", 0, 128, 8, 4)
    assert woq_gemm.plan(8, 4096, 11008, 128) == ("gemv", 0, 128, 4, 8)
    assert woq_gemm.plan(8, 11008, 4096, 128) == ("gemv", 0, 128, 8, 11)
    assert woq_gemm.plan(8, 4096, 11008, 128, torch.float32) == ("gemv", 0, 128, 3, 11)
    assert woq_gemm.gemv_ctas_per_sm(torch.float32) == 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("B,In,Out,group", [
    (1, 512, 384, 128), (8, 384, 264, 96), (37, 200, 40, 100), (256, 1024, 520, 64),
    # tile cuts: 65-256 rows in one 256-row tile, 300 in two
    (100, 640, 136, 64), (129, 512, 264, 64), (255, 384, 136, 96), (300, 200, 40, 100),
    # llama-7b's w_gate / w_up and w_down at the prefill row count
    (256, 4096, 11008, 128), (256, 11008, 4096, 128)])
def test_cuda_kernel_matches_plain(B, In, Out, group, bits, dtype, cuda):
    x, codes, scale = _gemm_case(B, In, Out, group, bits, seed=B)
    x, codes, scale = x.to(cuda, dtype), codes.to(cuda), scale.to(cuda)
    before = woq_gemm.launches
    out = woq_gemm.woq_matmul(x, codes, scale, bits)
    torch.cuda.synchronize()
    assert woq_gemm.launches == before + 1
    ref = woq_gemm.woq_matmul_plain(x, codes, scale, bits)
    assert out.dtype == torch.float32 and out.shape == (B, Out)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)
    again = woq_gemm.woq_matmul(x, codes, scale, bits)
    assert torch.equal(out, again)  # no atomics: repeated calls are bitwise equal


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("In,Out,group", [
    (4096, 11008, 128),  # llama-7b's w_gate / w_up: 3 splits a cluster
    (4096, 4096, 128),   # 8 splits a cluster
    (4000, 1032, 125),   # int8 group 125 (odd K starts: x read unaligned), Out 1032 = 8 mod 16
    (1024, 520, 16),     # a group below 32: scales from L1
])
def test_cuda_gemv_one_row_equals_eight_rows(In, Out, group, bits, dtype, cuda):
    x, codes, scale = _gemm_case(8, In, Out, group, bits, seed=In + Out)
    x, codes, scale = x.to(cuda, dtype), codes.to(cuda), scale.to(cuda)
    before = woq_gemm.launches
    out = woq_gemm.woq_matmul(x, codes, scale, bits)
    torch.cuda.synchronize()
    assert woq_gemm.launches == before + 1 and woq_gemm.plan(
        8, In, Out, woq.group_of(bits, codes.shape[1]), dtype)[0] == "gemv"
    torch.testing.assert_close(out, woq_gemm.woq_matmul_plain(x, codes, scale, bits),
                               rtol=1e-5, atol=1e-4)
    for r in (0, 5, 7):  # a row alone, and among 3: bitwise its row of the 8
        assert torch.equal(woq_gemm.woq_matmul(x[r:r + 1].contiguous(), codes, scale, bits),
                           out[r:r + 1])
    assert torch.equal(woq_gemm.woq_matmul(x[5:8].contiguous(), codes, scale, bits), out[5:8])
