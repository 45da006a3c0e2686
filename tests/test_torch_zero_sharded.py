"""ZeRO-2/3 on one device: the port's ``PartitionPlan``, sharded host tier,
stage-3 residency and sharded checkpoints against the JAX package's, on the
CPU (the harness of ``test_torch_zero_offload.py``).

- ``PartitionPlan``: the JAX plan's bounds and record for the same leaves at
  1, 3 and 8 shards, so each package writes and reads the other's shard
  files.
- The tier alone: 1, 3 and 8 shards, bitwise the JAX tier's update.
- Engines: stage 2 (sharded tier) and stage 3 (with a residency window
  tight enough to release and prefetch) against the JAX engines of the same
  configuration: losses at rtol 1e-5, fp32 parameters at rtol 1e-5 / atol
  2e-5; the JAX tier has 8 shards (its test mesh), the port's 1. The
  ``train/zero`` counters equal the JAX engine's where the shard count does
  not enter (all but ``shard_bytes``). Inside the port, flat offload at
  stage 0, stage 2 and stage 3 give bitwise the same losses and parameters
  (``tests/unit/test_zero_sharded.py:154-178``).
- Checkpoints: a port sharded tag (one shard file) loads into the JAX
  engine and the JAX tag (8 shard files) into the port, the two steps after
  either load matching the saver's; a flat-offload engine takes a sharded
  tag; a torn shard falls back through the durable-tag ring; ``zero_to_fp32``
  and the universal conversion consolidate the port's shard files; a stage-2
  engine without offload saves its device moments per shard.
- ``TiledLinear`` and ``zero.initialize_params`` against the JAX package's.
"""

import os

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.resilience.errors import CheckpointCorruptError
from deepspeed_tpu_torch.runtime.zero.partition import PartitionPlan
from deepspeed_tpu_torch.utils.tree import tree_leaves

from tests.test_torch_zero_offload import (assert_leaves_equal, config,  # noqa: F401
                                           fp32_leaves, jax_model_and_params, make_runs,
                                           one_thread, port_engine, port_vs_jax, train)
from tests.torch_checked import checked_mode  # noqa: F401  (autouse: checked mode)

KNOBS = {"stage3_max_live_parameters": 1, "stage3_param_persistence_threshold": 64,
         "stage3_prefetch_bucket_size": 1 << 16}
CONFIGS = {
    "s2": lambda f: config(2, {"device": "cpu"}),
    "s3": lambda f: config(3, {"device": "cpu"}, **KNOBS),
}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return make_runs(tmp_path_factory, CONFIGS)


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_partition_plan_matches_jax(shards):
    from deepspeed_tpu.runtime.zero.partition import PartitionPlan as JaxPlan

    rng = np.random.default_rng(shards)
    leaves = [np.zeros(tuple(rng.integers(1, 30, rng.integers(0, 4)))) for _ in range(11)]
    leaves.append(np.zeros((2,)))  # smaller than the shard count: late ranks empty
    ours = PartitionPlan([torch.from_numpy(a) for a in leaves], shards, sanitize=True)
    theirs = JaxPlan(leaves, shards)
    assert ours.describe() == theirs.describe()
    for r in range(shards):
        assert ours.slices(r) == theirs.slices(r)
        assert ours.shard_bytes(r) == theirs.shard_bytes(r)
    assert ours.total_elements == theirs.total_elements


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_sharded_tier_step_matches_jax_tier(shards):
    """The port's tier over a plan of 1, 3 or 8 shards, its gradients
    streamed in 7-element chunks that straddle the ranks' bounds, against
    the JAX package's tier over the JAX plan: master and moments bitwise
    after three steps (the same C++ Adam, per (leaf, rank) slice)."""
    from deepspeed_tpu.ops.adam.cpu_adam import DeepSpeedCPUAdam as JaxCPUAdam
    from deepspeed_tpu.runtime.zero.partition import PartitionPlan as JaxPlan
    from deepspeed_tpu.runtime.zero.sharded import ZeroShardedTier as JaxTier

    from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam
    from deepspeed_tpu_torch.runtime.zero.sharded import ZeroShardedTier

    rng = np.random.default_rng(10 + shards)
    shapes = [(5, 9), (37,), (2,), (4, 3, 5), (1,)]
    leaves = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    ours = ZeroShardedTier([torch.from_numpy(a) for a in leaves],
                           PartitionPlan([torch.from_numpy(a) for a in leaves], shards))
    ours.chunk_elements = 7
    theirs = JaxTier(leaves, JaxPlan(leaves, shards))
    kw = dict(betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1)
    opt, jopt = DeepSpeedCPUAdam(**kw), JaxCPUAdam(**kw)
    for lr, scale, clip in ((1e-3, 1.0, 1.0), (5e-4, 0.5, 0.8), (2e-3, 0.25, 1.0)):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        ours.adam_step(opt, [torch.from_numpy(g.copy()) for g in grads], lr,
                       grad_scale=scale, clip_coef=clip)
        theirs.adam_step(jopt, grads, lr, grad_scale=scale, clip_coef=clip)
    for j in range(len(leaves)):
        assert np.array_equal(ours.master[j], theirs.master[j])
        assert np.array_equal(ours.m[j], theirs.m[j]) and np.array_equal(ours.v[j], theirs.v[j])
    assert ours.counters == theirs.counters


@pytest.mark.parametrize("name", ["s2", "s3"])
def test_sharded_tier_matches_jax_and_crosses_checkpoints(jax_runs, tmp_path, name):
    """Stage 2 and 3: the JAX engine's losses, parameters and counters; the
    port's one-shard tag into the 8-shard JAX engine and back."""
    run = jax_runs(name)
    eng = port_vs_jax(run, run.cfg, tmp_path)
    assert eng._zero_tier is not None and eng._zero_tier.plan.num_shards == 1
    assert run.engine._zero_tier.plan.num_shards == 8
    got, want = eng.zero_metrics(), dict(run.metrics)
    assert got.pop("shard_bytes") == 3 * 4 * sum(eng._zero_tier.plan.leaf_sizes)
    want.pop("shard_bytes")
    assert got == want
    assert eng.master_params is None and eng.opt_state is None
    names = os.listdir(tmp_path / "port")
    assert "optim_states.shard00.ckpt" in names
    assert "optim_states.shard00.ckpt.manifest.json" in names
    if name == "s3":
        assert got["gathers"] > got["reduce_scatters"] and got["prefetch_hits"] > 0


def test_stage0_2_3_offload_twins_bitwise():
    """Flat offload at stage 0, the sharded tier at stage 2 and stage 3 with
    a tight residency window: the same losses and fp32 parameters, bitwise;
    in bf16 too. Stage 3 releases leaves between steps (their device storage
    freed) and the next forward gathers them back; the tier's shard file
    (``shard_state_dict``) holds its moments, and ``load_full_moments``
    writes them back."""
    for bf16 in (False, True):
        e0 = port_engine(config(0, {"device": "cpu"}, bf16=bf16))
        assert e0._zero_tier is None
        l0 = train(e0, 4)
        p0 = fp32_leaves(e0)
        for stage, kw in ((2, {}), (3, KNOBS)):
            eng = port_engine(config(stage, {"device": "cpu"}, bf16=bf16, **kw))
            np.testing.assert_array_equal(train(eng, 4), l0)
            assert_leaves_equal(fp32_leaves(eng), p0)
    tier = eng._zero_tier
    ms, vs = tier.full_moments()
    shard = tier.shard_state_dict(0)
    assert shard["num_shards"] == 1
    for a, b in zip(shard["m"] + shard["v"], ms + vs):
        np.testing.assert_array_equal(a, b)
    tier.load_full_moments([m * 2 for m in ms], vs, step=9)
    assert tier.step_count == 9 and np.array_equal(tier.m[0], 2 * shard["m"][0])
    tier.load_full_moments(shard["m"], shard["v"], step=4)
    leaves = list(tree_leaves(eng.params))
    assert eng._z3_released
    assert any(leaves[j].untyped_storage().nbytes() == 0 for j in eng._z3_released)
    train(eng, 1, start=4)
    default = port_engine(config(3, {"device": "cpu"}))
    train(default, 2)
    assert not default._z3_released and default.zero_metrics()["prefetch_hits"] == 0


def test_ratio_and_nvme_fall_back_to_the_flat_tier(tmp_path):
    """At stage 2, ``ratio`` < 1 and ``nvme`` take the flat tier
    (``engine.py:470-474``); ``nvme_path`` on the cpu tier puts the moments
    on NVMe under the TransferEngine's store, bitwise the RAM moments."""
    eng = port_engine(config(2, {"device": "cpu", "ratio": 0.5}))
    assert eng._zero_tier is None and eng._offload_mgr["dev_idx"]
    nv = port_engine(config(2, {"device": "nvme", "nvme_path": str(tmp_path / "a")}))
    assert nv._zero_tier is None and nv._offload_mgr["host"]._aio is not None
    ram = port_engine(config(2, {"device": "cpu"}))
    disk = port_engine(config(2, {"device": "cpu", "nvme_path": str(tmp_path / "b")}))
    assert disk._zero_tier.nvme_store is not None and disk._zero_tier.m is None
    np.testing.assert_array_equal(train(ram, 3), train(disk, 3))
    assert_leaves_equal(fp32_leaves(ram), fp32_leaves(disk))
    assert disk._transfer.nvme.counters["saves"] > 0
    disk.save_checkpoint(str(tmp_path / "ck"), tag="t")
    back = port_engine(config(2, {"device": "cpu"}))
    back.load_checkpoint(str(tmp_path / "ck"), tag="t")
    np.testing.assert_array_equal(train(back, 1, start=3), train(disk, 1, start=3))


def test_sharded_tag_into_flat_and_device_engines(jax_runs, tmp_path):
    """The JAX 8-shard tag into the port's flat-offload engine (bitwise the
    port's sharded resume) and into its device engine (close: the device
    Adam's arithmetic order); the port's flat-offload tag into a sharded
    engine, bitwise."""
    run = jax_runs("s2")
    sharded = port_engine(run.cfg)
    sharded.load_checkpoint(run.dir, tag="jax")
    ref = train(sharded, 2, start=2)
    flat = port_engine(config(0, {"device": "cpu"}))
    flat.load_checkpoint(run.dir, tag="jax")
    np.testing.assert_array_equal(train(flat, 2, start=2), ref)
    dev = port_engine(config(0))
    dev.load_checkpoint(run.dir, tag="jax")
    np.testing.assert_allclose(train(dev, 2, start=2), ref, rtol=1e-4, atol=1e-4)
    flat = port_engine(config(0, {"device": "cpu"}))
    train(flat, 2)
    flat.save_checkpoint(str(tmp_path), tag="flat")
    rest = train(flat, 2, start=2)
    back = port_engine(config(2, {"device": "cpu"}))
    back.load_checkpoint(str(tmp_path), tag="flat")
    np.testing.assert_array_equal(train(back, 2, start=2), rest)


def test_torn_shard_falls_back_through_the_ring(tmp_path):
    """A shard file missing from the newest tag: a load from ``latest``
    falls back to the previous durable tag; the named tag raises."""
    d = str(tmp_path)
    eng = port_engine(config(2, {"device": "cpu"}))
    train(eng, 1)
    eng.save_checkpoint(d)
    train(eng, 1, start=1)
    eng.save_checkpoint(d)
    os.remove(os.path.join(d, "global_step2", "optim_states.shard00.ckpt"))
    res = port_engine(config(2, {"device": "cpu"}))
    with pytest.raises(CheckpointCorruptError):
        res.load_checkpoint(d, tag="global_step2")
    res.load_checkpoint(d)
    assert res.global_steps == 1 and res.ckpt_corrupt_fallbacks == 1


def test_zero_to_fp32_and_universal_consolidate_port_shards(tmp_path):
    """The port's shard files through ``zero_to_fp32`` (the engine's fp32
    parameters) and through both packages' universal conversion (the
    moments, equal); the universal directory loads into a sharded engine
    and continues bitwise."""
    from deepspeed_tpu.checkpoint.universal import ds_to_universal as jax_to_universal

    from deepspeed_tpu_torch.checkpoint.universal import (ds_to_universal,
                                                          load_universal_into_engine)
    from deepspeed_tpu_torch.utils import zero_to_fp32

    eng = port_engine(config(2, {"device": "cpu"}))
    train(eng, 2)
    d = str(tmp_path / "ckpt")
    eng.save_checkpoint(d, tag="t0")
    ref = train(eng, 2, start=2)
    sd = zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(d, tag="t0")
    flat = [np.asarray(sd[k]) for k in sorted(sd)]
    assert len(flat) == len(eng._zero_tier.master)
    ours, theirs = str(tmp_path / "u_port"), str(tmp_path / "u_jax")
    ds_to_universal(d, ours, tag="t0")
    jax_to_universal(d, theirs, tag="t0")
    for p in sorted(os.listdir(os.path.join(ours, "zero"))):
        for f in ("fp32.npy", "exp_avg.npy", "exp_avg_sq.npy"):
            np.testing.assert_array_equal(np.load(os.path.join(ours, "zero", p, f)),
                                          np.load(os.path.join(theirs, "zero", p, f)))
    res = port_engine(config(2, {"device": "cpu"}))
    load_universal_into_engine(res, ours)
    np.testing.assert_array_equal(train(res, 2, start=2), ref)


def test_device_stage2_saves_sharded_and_restores(tmp_path):
    """No offload: the moments stay on the device (stage 2 is stage 0's
    arithmetic on one card), and the tag still holds one file a rank."""
    eng = port_engine(config(2))
    assert eng._offload_mgr is None and eng.opt_state is not None
    np.testing.assert_array_equal(train(eng, 2), train(port_engine(config(0)), 2))
    eng.save_checkpoint(str(tmp_path), tag="t0")
    assert "optim_states.shard00.ckpt" in os.listdir(tmp_path / "t0")
    ref = train(eng, 2, start=2)
    res = port_engine(config(2))
    res.load_checkpoint(str(tmp_path), tag="t0")
    np.testing.assert_array_equal(train(res, 2, start=2), ref)


def test_tiled_linear_and_initialize_params_match_jax():
    """``TiledLinear`` over the JAX module's tiles gives its outputs and its
    dense weight; ``from_dense`` round-trips; ``zero.initialize_params``
    gives the JAX tree's structure, shapes and dtypes (under ``Init``'s
    dtype too)."""
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu import zero as jax_zero
    from deepspeed_tpu.runtime.zero.tiling import TiledLinear as JaxTiled

    from deepspeed_tpu_torch import zero
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.runtime.zero.tiling import TiledLinear

    jt = JaxTiled(64, 96, in_splits=2, out_splits=3)
    jp = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(1)))
    x = np.random.default_rng(0).standard_normal((5, 64)).astype(np.float32)
    tt = TiledLinear(64, 96, in_splits=2, out_splits=3)
    tp = {k: torch.from_numpy(v.copy()) for k, v in jp.items()}
    np.testing.assert_allclose(tt.apply(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(jt.apply(jp, jnp.asarray(x))), atol=1e-6)
    np.testing.assert_array_equal(tt.dense_weight(tp), jt.dense_weight(jp))
    mod, back = TiledLinear.from_dense(tt.dense_weight(tp), tp["bias"], in_splits=2,
                                       out_splits=3)
    np.testing.assert_array_equal(mod.dense_weight(back), jt.dense_weight(jp))
    remat = TiledLinear(64, 96, in_splits=2, out_splits=3, remat_tile=True)
    xt = torch.from_numpy(x).requires_grad_()
    g1 = torch.autograd.grad(remat.apply(tp, xt).square().sum(), xt)[0]
    g2 = torch.autograd.grad(tt.apply(tp, xt).square().sum(), xt)[0]
    assert torch.equal(g1, g2)

    want = jax_zero.initialize_params(jt, jax.random.PRNGKey(0))
    got = zero.initialize_params(tt, torch.Generator().manual_seed(0))
    assert sorted(want) == sorted(got)
    for k in want:
        assert tuple(want[k].shape) == tuple(got[k].shape) and got[k].dtype == torch.float32
    with zero.Init(dtype=torch.bfloat16):
        assert zero.is_zero_init_active()
        lp = zero.initialize_params(tt, torch.Generator().manual_seed(0))
    assert not zero.is_zero_init_active()
    for k in got:
        assert lp[k].dtype == torch.bfloat16 and torch.equal(lp[k], got[k].to(torch.bfloat16))
    model = build_model("gpt2-125m", vocab_size=128, hidden_size=64, num_layers=2,
                        num_heads=4, max_seq_len=32)
    shapes = [tuple(a.shape) for a in jax.tree.leaves(jax_model_and_params()[1])]
    assert shapes == [tuple(b.shape) for b in tree_leaves(
        zero.initialize_params(model, torch.Generator().manual_seed(0)))]


def test_supervisor_report_carries_zero_metrics(tmp_path):
    """``TrainingSupervisor.report()`` carries the sharded tier's
    ``train/zero`` counters, as the JAX package's does
    (``tests/unit/test_zero_sharded.py:230``)."""
    from deepspeed_tpu_torch.resilience import TrainingSupervisor

    from tests.test_torch_zero_offload import batch

    eng = port_engine(config(2, {"device": "cpu"}))
    sup = TrainingSupervisor(eng, lambda k: iter([batch(k)]), str(tmp_path),
                             sleep=lambda s: None)
    sup.run(2)
    zero = sup.report()["zero"]
    n = len(eng._zero_tier.master)
    assert zero["reduce_scatters"] == zero["gathers"] == 2 * n
    assert zero["shard_bytes"] == eng._zero_tier.shard_bytes(0)
