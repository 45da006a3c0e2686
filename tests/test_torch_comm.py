"""The communication facade over ``torch.distributed`` (``deepspeed_tpu_torch/comm``), on gloo ranks.

Two and four rank processes (``tests/torch_multirank.py``: a module
fixture starts them once, ``file://`` rendezvous in a temporary directory,
torch on one thread each) run every op of the facade over the world, the
ZeRO axes and, at four ranks with ``hpz`` 2, the ``data`` and ``hpz`` axis
groups; the results equal numpy's sums, gathers and exchanges exactly
(small integers in float32), and the comms logger counts each op and its
message bytes. Then the ZeRO++ quantizers and collectives
(``ops/quantizer/quantizer.py``, ``runtime/zero/zeropp.py``) and the 1-bit
error-feedback all-reduce (``runtime/comm/compressed.py``) at two ranks
against the JAX functions run under ``jax.shard_map`` on a sub-mesh of 2
of the 8 virtual devices, with the same per-rank inputs: codes, scales,
zero points and packed sign bits bitwise, and every dequantized or reduced
value bitwise too (products of int8 codes and float32 scales, summed over
two ranks), except the 1-bit all-reduce's values and error: its scale is a
mean over the tensor, whose float32 sum may round differently in the last
place, so those at rtol 1e-6.
"""

import numpy as np
import pytest

from tests.torch_multirank import Ranks, facade_ops, quantized_ops


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    r = Ranks(2, tmp_path_factory.mktemp("comm2"))
    yield r
    r.close()


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    r = Ranks(4, tmp_path_factory.mktemp("comm4"))
    yield r
    r.close()


def _expected(n):
    xs = [np.arange(8, dtype=np.float32) + 10 * r for r in range(n)]
    bigs = [np.arange(8 * n, dtype=np.float32) * (r + 1) for r in range(n)]
    ms = [np.arange(12, dtype=np.float32).reshape(3, 4) + r for r in range(n)]
    ws = [np.arange(3 * 4 * n, dtype=np.float32).reshape(3, 4 * n) * (r + 1) for r in range(n)]
    return xs, bigs, ms, ws


@pytest.mark.parametrize("world", [2, 4])
def test_every_facade_op_over_the_world(world, ranks2, ranks4):
    ranks = ranks2 if world == 2 else ranks4
    outs = ranks.run(facade_ops, world, 1)
    xs, bigs, ms, ws = _expected(world)
    total = sum(bigs)
    for r, o in enumerate(outs):
        assert o["world"] == o["dp"] == world and o["rank"] == r
        ones = [x + 1 for x in xs]
        np.testing.assert_array_equal(o["all_reduce_sum"], sum(ones))
        np.testing.assert_array_equal(o["all_reduce_avg"], sum(ones) / world)
        np.testing.assert_array_equal(o["all_reduce_max"], np.max(ones, axis=0))
        np.testing.assert_array_equal(o["all_reduce_min"], np.min(ones, axis=0))
        np.testing.assert_array_equal(o["all_reduce_prod"], np.prod(ones, axis=0))
        np.testing.assert_array_equal(o["broadcast"], xs[world - 1])
        np.testing.assert_array_equal(o["all_gather_into_tensor"], np.concatenate(xs))
        np.testing.assert_array_equal(o["reduce_scatter_tensor"], total[8 * r:8 * r + 8])
        np.testing.assert_array_equal(o["all_to_all_single"],
                                      np.concatenate([b[8 * r:8 * r + 8] for b in bigs]))
        np.testing.assert_array_equal(o["inprog_all_gather_axis1"], np.concatenate(ms, 1))
        np.testing.assert_array_equal(o["inprog_all_gather_untiled"], np.stack(ms))
        np.testing.assert_array_equal(o["inprog_reduce_scatter_dim1"],
                                      sum(ws)[:, 4 * r:4 * r + 4])
        # split axis 1 of (3, n, 4) into n chunks: chunk r from every rank,
        # concatenated along axis 1 in source order
        np.testing.assert_array_equal(o["inprog_all_to_all"], np.concatenate(
            [w.reshape(3, world, 4)[:, r:r + 1] for w in ws], axis=1))
        np.testing.assert_array_equal(o["psum"], sum(xs))
        np.testing.assert_array_equal(o["pmean"], sum(xs) / world)
        np.testing.assert_array_equal(o["pmax"], xs[-1])
        np.testing.assert_array_equal(o["pmin"], xs[0])
        # the logger: one record a call, keyed by message bytes (a gather's or
        # a scatter's shard times the group: calc_bw_log's convention)
        log = o["log"]
        assert log["all_reduce"] == {32: 9}  # five reductions, four p* ops
        assert log["broadcast"] == {32: 1} and log["barrier"] == {0: 1}
        assert log["all_gather_into_tensor"] == {32 * world: 1, 48 * world: 2}
        assert log["reduce_scatter_tensor"] == {32 * world: 1, 48 * world: 1}
        assert log["all_to_all_single"] == {32 * world: 1, 48 * world: 1}
        assert o["summary"] == log


def test_axis_groups_at_four_ranks(ranks4):
    """``data`` 2 x ``hpz`` 2: an axis names the ranks that differ in it
    alone (``hpz`` the inner, consecutive pairs)."""
    outs = ranks4.run(facade_ops, 2, 2)
    xs = [np.arange(8, dtype=np.float32) + 10 * r for r in range(4)]
    for r, o in enumerate(outs):
        assert o["world"] == o["dp"] == 4
        hpz = [r - r % 2, r - r % 2 + 1]
        data = [r % 2, r % 2 + 2]
        assert o["ranks_hpz"] == hpz and o["ranks_data"] == data
        assert (o["rank"], o["rank_in_hpz"], o["rank_in_data"]) == (r, r % 2, r // 2)
        np.testing.assert_array_equal(o["psum_hpz"], sum(xs[i] for i in hpz))
        np.testing.assert_array_equal(o["psum_data"], sum(xs[i] for i in data))
        np.testing.assert_array_equal(o["gather_hpz"], np.concatenate([xs[i] for i in hpz]))
        np.testing.assert_array_equal(o["gather_data"], np.concatenate([xs[i] for i in data]))
        np.testing.assert_array_equal(o["psum"], sum(xs))
        assert o["log"]["all_reduce"][32] == 9 + 2


def _jax_side(xs, gs, es):
    """The JAX functions on the same per-rank inputs, one rank a device of
    a 2-device sub-mesh: each output stacked on a leading rank axis."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from deepspeed_tpu.ops.quantizer import quantizer as q
    from deepspeed_tpu.runtime.comm import compressed as c
    from deepspeed_tpu.runtime.zero import zeropp as z

    mesh = Mesh(np.array(jax.devices()[:2]), ("x",))

    def body(x, g, e):
        x, g, e = x[0], g[0], e[0]
        red, err = c.compressed_allreduce(g, e, ("x",))
        outs = {
            "all_gather": q.quantized_all_gather(x, "x", 8, 16),
            "reduce_scatter": q.quantized_reduce_scatter(g.reshape(2, -1), "x", 8, 16),
            "qwz_gather": z._gather_param_leaf(x, ("x",), 1, True),
            "qgz_mean": z._quantized_reduce_leaf(g, ("x",), 2, 8, 512),
            "onebit": red, "onebit_error": err,
        }
        return {k: v[None] for k, v in outs.items()}

    # eager (op by op, no jit): XLA's compiled float32 arithmetic may take
    # another last bit than the op-by-op result the port reproduces
    f = jax.shard_map(body, mesh=mesh, in_specs=(P("x"), P("x"), P("x")),
                      out_specs=P("x"), check_vma=False)
    got = jax.tree.map(np.asarray, f(jnp.asarray(xs), jnp.asarray(gs), jnp.asarray(es)))
    local = [dict(zip(("codes", "scale", "zero"), map(np.asarray, q.quantize(x, 8, 16))),
                  asym=[np.asarray(t) for t in q.quantize(x, 8, 16, symmetric=False)],
                  packed=np.asarray(c._pack_bits((jnp.asarray(g) + e >= 0).reshape(-1))))
             for x, g, e in zip(xs, gs, es)]
    return got, local


def test_quantized_and_onebit_collectives_match_jax(ranks2):
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((2, 6, 64)).astype(np.float32)       # a weight shard a rank
    xs[1, 2] = 0.0                                                # an all-zero block
    gs = (rng.standard_normal((2, 1024)) * 1e-2).astype(np.float32)  # a gradient a rank
    es = (rng.standard_normal((2, 1024)) * 1e-3).astype(np.float32)  # a carried error
    outs = ranks2.run(quantized_ops, xs, gs, es)
    got, local = _jax_side(xs, gs, es)
    for r, o in enumerate(outs):
        for k in ("codes", "scale", "zero", "packed"):
            np.testing.assert_array_equal(o[k], local[r][k], err_msg=k)
        for a, b in zip(o["asym"], local[r]["asym"]):
            np.testing.assert_array_equal(a, b)
        for k in ("all_gather", "reduce_scatter", "qwz_gather", "qgz_mean"):
            np.testing.assert_array_equal(o[k], got[k][r], err_msg=k)
        for k in ("onebit", "onebit_error"):
            np.testing.assert_allclose(o[k], got[k][r], rtol=1e-6, atol=1e-9, err_msg=k)
    # the first qgZ hop alone: this rank's half of the two-hop mean before
    # its second quantization (within one int8 step of it)
    for r, o in enumerate(outs):
        half = outs[r]["qgz_mean"][512 * r:512 * r + 512]
        assert np.max(np.abs(o["qgz_hop1"] - half)) <= 2 * np.max(np.abs(half)) / 127
