"""ZeRO across ranks: ``deepspeed_tpu_torch.initialize`` over a gloo process group, on the CPU.

Two rank processes (four for hpZ; ``tests/torch_multirank.py``: a module
fixture starts them once, ``file://`` rendezvous in a temporary directory,
torch on one thread each) train a micro llama (hidden 64, 4 heads, 2 KV
heads, 2 layers, vocab 512, S 32) in fp32 from the JAX package's
``init_params(PRNGKey(0))`` weights (``params_from_jax``), each rank given
the global batch of 8 sequences a micro-step:

- bitwise twins: stages 1, 2 and 3 (persistence threshold 0) give stage
  0's losses and fp32 masters bit for bit over 5 steps, and so do gradient
  accumulation over 2 micro-steps and bf16; after every step every rank's
  gathered parameters are bitwise equal;
- against JAX: the JAX engine on its 8-device ``{"data": 8}`` mesh with
  the same global batch; the same mean-gradient math summed in another
  order, so losses at rtol 1e-5 and masters at atol 1e-5;
- sharding is real: a rank's stage-3 parameter bytes are the whole leaves
  plus half the sharded ones, and the optimizer state halves from stage 1;
- an fp16 overflow on one rank skips the step on both; a rank's dropout
  masks are its rows of the one-rank step's;
- hpZ: at four ranks ``zero_hpz_partition_size`` 2 gives hpz 1's losses
  and masters bit for bit;
- the sharded cpu-offload tier (stage 2), each rank training on its rows
  and stepping its ``PartitionPlan`` slice with the C++ CPU Adam, gives the
  flat tier's masters (stage 1, every rank stepping whole leaves) bit for
  bit, and both hold one rank's run on the global batch within the
  summation-order tolerances above;
- checkpoints: a 2-rank stage-3 tag loads at 1 rank and in the JAX engine
  with every master and moment bitwise, and a JAX tag loads at 2 ranks
  bitwise; a universal directory loads into 2 ranks at stage 2 as each
  rank's rows of the one-rank load, bitwise;
- ``OnebitLamb`` at stages 1 and 2, its trust ratio's norms all-reduced
  over the master's shards, against the JAX engine before its freeze step,
  and lowering the loss at every compressed step after it (stage 1).

Adam's eps is 1e-6, as in ``test_torch_train_engine.py``: the first steps'
updates of tiny gradients keep their sign under last-bit differences.
"""

import functools
import os

import numpy as np
import pytest
import torch

from tests.torch_multirank import (Ranks, checkpoint_cycle, dropout_masks, offload_tier,
                                   overflow_on_one_rank, train, unported)

PRESET = "llama-tiny"
MODEL_KW = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                intermediate_size=128, max_seq_len=32)
S, ROWS, STEPS = 32, 8, 5


def _config(stage=0, **kw):
    zero = {"stage": stage}
    if stage == 3:
        zero["stage3_param_persistence_threshold"] = 0
    cfg = {"train_batch_size": ROWS, "gradient_clipping": 1.0,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1,
                                                     "eps": 1e-6}},
           "zero_optimization": zero, "steps_per_print": 0, "seed": 0}
    for k, v in kw.items():
        if k == "zero_optimization":
            cfg[k] = dict(zero, **v)
        else:
            cfg[k] = v
    return cfg


def _batches(n=3, seed=0, rows=ROWS):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 512, (rows, S)).astype(np.int32)} for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _jax_params():
    import jax

    from deepspeed_tpu.models import build_model

    jm = build_model(PRESET, **MODEL_KW)
    return jm, jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))


def _leaves(tree):
    from deepspeed_tpu_torch.utils.tree import tree_leaves

    return list(tree_leaves(tree))


def _bitwise(a, b):
    return all(np.array_equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread in this process too (its one-rank runs are held
    bitwise against the ranks')."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    r = Ranks(2, tmp_path_factory.mktemp("ranks2"))
    yield r
    r.close()


@pytest.fixture(scope="module")
def runs(ranks2):
    """Two-rank runs by configuration, each made once for the module."""
    cache = {}

    def get(key, config, batches=None, steps=STEPS):
        if key not in cache:
            cache[key] = ranks2.run(train, PRESET, MODEL_KW, config, _jax_params()[1],
                                    batches or _batches(), steps)
        return cache[key]

    return get


def _stage(runs, stage, **extra):
    name = "-".join(f"{k}" for k in extra)
    cfg = _config(stage, **extra)
    if extra.get("gradient_accumulation_steps"):
        cfg["train_batch_size"] = ROWS * extra["gradient_accumulation_steps"]
    return runs((stage, name), cfg)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_stages_give_stage0_bitwise(runs, stage):
    base, got = _stage(runs, 0)[0], _stage(runs, stage)[0]
    assert got["losses"] == base["losses"]
    assert _bitwise(got["master"], base["master"])
    assert got["losses"][-1] < got["losses"][0]


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_ranks_parameters_bitwise_equal_after_every_step(runs, stage):
    a, b = _stage(runs, stage)
    assert len(a["states"]) == STEPS and a["states"] == b["states"]
    assert a["losses"] == b["losses"]


@pytest.mark.parametrize("extra", [{"gradient_accumulation_steps": 2},
                                   {"bf16": {"enabled": True}}], ids=["gas2", "bf16"])
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_gas_and_bf16_stages_give_stage0_bitwise(runs, stage, extra):
    base, got = _stage(runs, 0, **extra), _stage(runs, stage, **extra)
    assert got[0]["losses"] == base[0]["losses"]
    assert _bitwise(got[0]["master"], base[0]["master"])
    assert got[0]["states"] == got[1]["states"]


def test_matches_jax_engine_on_eight_devices(runs):
    """The JAX engine at ``{"data": 8}`` (stage 2) against the port's two
    ranks at stages 0 and 3: the same global batches, the same steps."""
    import deepspeed_tpu

    jm, params = _jax_params()
    jeng = deepspeed_tpu.initialize(model=jm, model_parameters=params,
                                    config=dict(_config(2), mesh={"data": 8}))[0]
    batches = _batches()
    jl = [float(jeng.train_batch(iter([batches[i % len(batches)]]))) for i in range(STEPS)]
    import jax

    want = jax.tree.map(np.asarray, jeng.params)
    for stage in (0, 3):
        got = _stage(runs, stage)[0]
        np.testing.assert_allclose(got["losses"], jl, rtol=1e-5)
        for a, b in zip(_leaves(got["master"]), _leaves(want)):
            np.testing.assert_allclose(a, b, atol=1e-5)


def test_stage3_params_actually_sharded(runs):
    """Between steps a rank holds the whole leaves (no dimension divisible
    by 2) and half of every sharded one; the optimizer state (master and
    moments) halves from stage 1."""
    from deepspeed_tpu_torch.comm.topology import MeshTopology
    from deepspeed_tpu_torch.runtime.zero.data_parallel import LeafShard
    from deepspeed_tpu_torch.runtime.zero.partition import stage_param_specs

    shapes = {k: v for k, v in _jax_params()[1].items()}
    topo = MeshTopology(world_size=2)
    specs = stage_param_specs(shapes, 3, topo)
    whole = sharded = 0
    for a, spec in zip(_leaves(shapes), _spec_leaves(specs)):
        if LeafShard(spec, topo).sharded:
            sharded += a.nbytes
        else:
            whole += a.nbytes
    assert sharded > 0
    per_rank = [r["param_bytes"] for r in _stage(runs, 3)]
    assert per_rank == [whole + sharded // 2] * 2
    assert _stage(runs, 0)[0]["param_bytes"] == whole + sharded
    opt = [_stage(runs, s)[0]["opt_bytes"] for s in range(4)]
    assert opt[1] == opt[2] == opt[3] < opt[0] and opt[1] * 2 >= opt[0]


def _spec_leaves(specs):
    if isinstance(specs, dict):
        for k in sorted(specs):
            yield from _spec_leaves(specs[k])
    else:
        yield specs


def test_fp16_overflow_on_one_rank_skips_the_step_on_both(ranks2):
    cfg = _config(2, fp16={"enabled": True, "initial_scale_power": 8})
    outs = ranks2.run(overflow_on_one_rank, PRESET, MODEL_KW, cfg, _jax_params()[1],
                      _batches(), 1, 1)
    assert [o["skipped"] for o in outs] == [1, 1]
    assert outs[0]["states"] == outs[1]["states"]
    assert outs[0]["states"][1] == outs[0]["states"][0]  # the skipped step changed nothing
    assert outs[0]["states"][2] != outs[0]["states"][1]
    assert outs[0]["scales"] == outs[1]["scales"]


def test_dropout_masks_are_the_one_rank_steps_rows(ranks2):
    """Each rank's masks are its rows of the masks one rank draws for the
    global batch (threefry counters are positions in the whole draw)."""
    from tests.torch_multirank import dropout_masks as one_rank

    mk = dict(MODEL_KW, dropout=0.1)
    batch = _batches(1)[0]
    outs = ranks2.run(dropout_masks, PRESET, mk, _config(0), _jax_params()[1], batch)
    ref = one_rank(0, PRESET, mk, _config(0), _jax_params()[1], batch)
    assert len(ref) == len(outs[0]) == 2 * MODEL_KW["num_layers"]
    for i, whole in enumerate(ref):
        np.testing.assert_array_equal(np.concatenate([o[i] for o in outs]), whole)
        assert 0 < whole.mean() < 1


def test_hpz2_gives_hpz1_bitwise_at_four_ranks(tmp_path):
    r = Ranks(4, tmp_path)
    try:
        base = r.run(train, PRESET, MODEL_KW, _config(3), _jax_params()[1], _batches(), 4)
        hpz = r.run(train, PRESET, MODEL_KW,
                    _config(3, zero_optimization={"zero_hpz_partition_size": 2}),
                    _jax_params()[1], _batches(), 4)
    finally:
        r.close()
    assert hpz[0]["losses"] == base[0]["losses"]
    assert _bitwise(hpz[0]["master"], base[0]["master"])
    assert len({o["states"][-1] for o in hpz}) == 1
    # weights shard over the hpz pair alone: twice the bytes of hpz 1
    assert hpz[0]["param_bytes"] > base[0]["param_bytes"]


def test_sharded_offload_tier_gives_the_flat_tier_bitwise(ranks2, tmp_path):
    """Each rank trains on its rows of the global batch. The sharded tier
    (stage 2) reduce-scatters the gradients onto the ranks' ``PartitionPlan``
    slices and steps its slice with the C++ CPU Adam; the flat tier (stage
    1) all-reduces them and steps whole leaves. The two give the same
    masters bit for bit: a mean over two ranks is one addition and an exact
    halving either way, and the clipping threshold is above every step's
    norm (asserted), so the coefficient is 1 on both tiers whatever order
    their norms sum in. Against one rank's flat tier on the global batch:
    the same mean-gradient math summed in another order, so losses and norms
    at rtol 1e-5, masters at atol 1e-5, moments at rtol 1e-4 (a gradient
    summed over the wrong count of rows scales ``m`` and ``v``, which Adam's
    update alone would hide). The sharded tier's tag (a moment file a rank)
    loads at one rank bitwise."""
    from tests.torch_multirank import offload_tier as one_rank

    params, batches, clip = _jax_params()[1], _batches(), 100.0
    flat_cfg = _config(1, gradient_clipping=clip,
                       zero_optimization={"offload_optimizer": {"device": "cpu"}})
    cfg = _config(2, gradient_clipping=clip,
                  zero_optimization={"offload_optimizer": {"device": "cpu"}})
    flat = ranks2.run(offload_tier, PRESET, MODEL_KW, flat_cfg, params, batches, 3)
    sharded = ranks2.run(offload_tier, PRESET, MODEL_KW, cfg, params, batches, 3, str(tmp_path))
    ref = one_rank(0, PRESET, MODEL_KW, flat_cfg, params, batches, 3)
    assert all(0 < n < clip for n in ref["norms"])
    half = ROWS // 2
    for r in range(2):  # each rank's forwards ran its half of the rows
        want = [batches[i % len(batches)]["input_ids"][r * half:(r + 1) * half, 0].tolist()
                for i in range(3)]
        assert sharded[r]["rows_seen"] == flat[r]["rows_seen"] == want
    assert [o["tier_rank"] for o in sharded] == [0, 1]
    assert sharded[0]["losses"] == flat[0]["losses"]
    for a, b in zip(sharded[0]["masters"], flat[0]["masters"]):
        assert _bitwise(a, b)
    assert all(_bitwise(a, b) for a, b in zip(sharded[0]["masters"], sharded[1]["masters"]))
    for got in (sharded[0], flat[0]):
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
        np.testing.assert_allclose(got["norms"], ref["norms"], rtol=1e-5)
        for a, b in zip(_leaves(got["master"]), _leaves(ref["master"])):
            np.testing.assert_allclose(a, b, atol=1e-5)
        for k in ("m", "v"):
            for a, b in zip(got[k], ref[k]):
                b = b.reshape(-1)
                np.testing.assert_allclose(a.reshape(-1), b, rtol=1e-4,
                                           atol=1e-4 * np.abs(b).max())
    # each rank's host tier holds its half of the optimizer state
    assert sharded[0]["host_bytes"] + sharded[1]["host_bytes"] == flat[0]["host_bytes"]
    one = one_rank(0, PRESET, MODEL_KW, cfg, params, batches, 0, None, str(tmp_path))
    assert one["tier_rank"] is None and one["step"] == sharded[0]["step"] == 3
    assert _bitwise(one["master"], sharded[0]["master"])
    for k in ("m", "v"):
        assert all(np.array_equal(a, b.reshape(-1)) for a, b in zip(sharded[0][k], one[k]))


def test_stage3_offload_across_ranks_raises_naming_its_item(ranks2):
    cfg = _config(3, zero_optimization={"offload_optimizer": {"device": "cpu"}})
    for msg in ranks2.run(unported, PRESET, MODEL_KW, cfg, _jax_params()[1]):
        assert msg is not None and "stage 3 with offload_optimizer across ranks" in msg
        assert "item 13d" in msg


@pytest.mark.parametrize("stage", [1, 2])
def test_onebit_lamb_across_ranks_matches_jax(ranks2, stage):
    """``OnebitLamb`` with its master in shards: the trust ratio's two norms
    are the shards' squares all-reduced. Before ``freeze_step`` (here past
    the run) it is the JAX engine's LAMB on ``{"data": 8}`` over the same
    global batches, to this file's summation-order tolerances; at stage 1
    with a freeze at step 2 the compressed steps lower the loss at every
    step, and the ranks stay bitwise equal."""
    import deepspeed_tpu

    jm, params = _jax_params()
    opt = {"type": "OneBitLamb", "params": {"lr": 1e-3, "freeze_step": 100, "eps": 1e-6}}
    cfg = _config(stage, optimizer=opt)
    got = ranks2.run(train, PRESET, MODEL_KW, cfg, params, _batches(), 3)
    jeng = deepspeed_tpu.initialize(model=jm, model_parameters=params,
                                    config=dict(cfg, mesh={"data": 8}))[0]
    batches = _batches()
    jl = [float(jeng.train_batch(iter([batches[i]]))) for i in range(3)]
    import jax

    np.testing.assert_allclose(got[0]["losses"], jl, rtol=1e-5)
    for a, b in zip(_leaves(got[0]["master"]), _leaves(jax.tree.map(np.asarray, jeng.params))):
        np.testing.assert_allclose(a, b, atol=1e-5)
    assert got[0]["states"] == got[1]["states"]
    if stage == 1:
        comp = dict(opt, params=dict(opt["params"], freeze_step=2))
        run = ranks2.run(train, PRESET, MODEL_KW, _config(1, optimizer=comp),
                         params, _batches(n=1), 5)
        losses = run[0]["losses"]
        assert all(b < a for a, b in zip(losses[2:], losses[3:])), losses
        assert run[0]["states"] == run[1]["states"]


def test_universal_tag_loads_into_two_ranks_as_the_one_rank_loads_rows(ranks2, tmp_path):
    """A universal directory (from a one-rank stage-2 tag) loaded at stage 2
    into two ranks: each rank's fp32 master and moments are its rows of
    the one-rank load's, bit for bit, at the same step."""
    from deepspeed_tpu_torch.checkpoint.universal import ds_to_universal
    from tests.torch_multirank import universal_load

    params, cfg = _jax_params()[1], _config(2)
    checkpoint_cycle(0, PRESET, MODEL_KW, cfg, params, _batches(), 2, str(tmp_path / "ck"))
    u = ds_to_universal(str(tmp_path / "ck"), str(tmp_path / "u"))
    one = universal_load(0, PRESET, MODEL_KW, cfg, params, u)
    two = ranks2.run(universal_load, PRESET, MODEL_KW, cfg, params, u)
    assert one["step"] == 2 and all(o["step"] == 2 and o["global_steps"] == 2 for o in two)
    sharded = 0
    for o in two:
        for k in ("master", "m", "v"):
            for whole, mine, (dim, n, index) in zip(one[k], o[k], o["layouts"]):
                if dim is not None:
                    size = whole.shape[dim] // n
                    whole = np.take(whole, range(index * size, (index + 1) * size), axis=dim)
                    sharded += 1
                np.testing.assert_array_equal(mine, whole)
    assert sharded > 0


def _assert_state(a, b):
    assert a["step"] == b["step"]
    for k in ("master", "m", "v"):
        assert _bitwise(a[k], b[k]), k


def _jax_state(jeng):
    import jax

    get = functools.partial(jax.tree.map, np.asarray)
    return {"master": get(jeng.params), "m": get(jeng.opt_state.m),
            "v": get(jeng.opt_state.v), "step": int(jeng.opt_state.step)}


def test_checkpoints_cross_ranks_and_packages(ranks2, tmp_path):
    """A 2-rank stage-3 tag at 1 rank and in the JAX engine; a JAX tag at 2 ranks."""
    import deepspeed_tpu

    from tests.torch_multirank import checkpoint_cycle as one_rank

    jm, params = _jax_params()
    cfg = _config(3)
    d2 = str(tmp_path / "two")
    two = ranks2.run(checkpoint_cycle, PRESET, MODEL_KW, cfg, params, _batches(), 2, d2)
    assert sorted(f for f in os.listdir(os.path.join(d2, "global_step2"))
                  if f.endswith(".ckpt")) == [
        "model_states.ckpt", "optim_states.ckpt", "optim_states.shard00.ckpt",
        "optim_states.shard01.ckpt"]
    one = one_rank(0, PRESET, MODEL_KW, cfg, params, _batches(), 0, load_dir=d2)
    _assert_state(one["loaded"], two[0]["trained"])
    jeng = deepspeed_tpu.initialize(model=jm, model_parameters=params,
                                    config=dict(cfg, mesh={"data": 8}))[0]
    jeng.load_checkpoint(d2)
    _assert_state(_jax_state(jeng), two[0]["trained"])
    # a JAX tag (its 8 shard files) at 2 ranks
    jeng.train_batch(iter([_batches(seed=4)[0]]))
    dj = str(tmp_path / "jax")
    jeng.save_checkpoint(dj)
    back = ranks2.run(checkpoint_cycle, PRESET, MODEL_KW, cfg, params, _batches(), 0,
                      None, dj)
    for o in back:
        _assert_state(o["loaded"], _jax_state(jeng))
