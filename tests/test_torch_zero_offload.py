"""ZeRO-Offload on one device: the port's host libraries and its flat
offload tier against the JAX package's, on the CPU.

Host libraries: the port's ``csrc/cpu_adam.cpp`` (a copy of the
repository's ``csrc/adam/cpu_adam.cpp``, built by the port's own builder)
gives the JAX package's library bitwise on the same arrays, Adam step, bf16
cast and squared norm alike; the plain PyTorch Adam holds both at rtol 1e-6
(``-march=native`` may contract to FMAs). The engine's host cast of the
master (``lp_cast``) gives the JAX package's ``astype`` bits, NaN and
infinities included.

Engines (a micro gpt2: hidden 64, 2 layers, 4 heads, vocab 128, S 32, 8
rows a step; AdamW, clipping 1.0, eps 1e-6 as in
``test_torch_train_engine.py``): the port with cpu offload, the legacy
``nvme`` (AIO) tier and a twin-flow ``ratio`` 0.5 against the JAX engine of
the same configuration on its 8-device test mesh: losses at rtol 1e-5, the
final fp32 parameters at rtol 1e-5 / atol 2e-5 (the JAX engine sums its
gradients over 8 shards in another order). Inside the port: ``nvme`` gives
``cpu``'s bits, a leaf streamed in chunks the bits of the leaf whole, and
``ratio`` 0.5 stays within 1e-4 of the device engine. Checkpoints: an
``offload_host`` tag of either package loads into the other, under the same
split and resharded to another ``ratio``; the two steps after the load
match the other package's. One JAX engine a configuration, run once for the
module (its tag saved after 2 steps, then loaded with the port's tag).
"""

import functools
import os

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import build_model, params_from_jax
from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam, adam_step_plain
from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
from deepspeed_tpu_torch.runtime.zero.offload import lp_cast, split_by_ratio
from deepspeed_tpu_torch.utils.tree import tree_leaves

MB, SEQ = 8, 32
MODEL = ("gpt2-125m", dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
                           max_seq_len=SEQ))
PARAM_TOL = dict(rtol=1e-5, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: bitwise twins need repeatable CPU matmuls, and
    parallel test workers with a pool each oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the shared harness (test_torch_zero_sharded.py imports it)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_model_and_params():
    import jax

    from deepspeed_tpu.models import build_model as jax_build_model

    jm = jax_build_model(MODEL[0], **MODEL[1])
    # jitted: one compile, where op-by-op dispatch of the initializer takes ~6 s
    return jm, jax.tree.map(np.asarray, jax.jit(jm.init_params)(jax.random.PRNGKey(0)))


def config(stage, offload=None, bf16=False, **zero_kw):
    zero = {"stage": stage, **zero_kw}
    if offload is not None:
        zero["offload_optimizer"] = offload
    cfg = {"train_batch_size": MB,
           "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.01,
                                                     "eps": 1e-6}},
           "zero_optimization": zero, "gradient_clipping": 1.0, "steps_per_print": 0}
    if bf16:
        cfg["bf16"] = {"enabled": True}
    return cfg


def port_engine(cfg):
    params = jax_model_and_params()[1]
    return deepspeed_tpu_torch.initialize(model=build_model(MODEL[0], **MODEL[1]),
                                          model_parameters=params_from_jax(params),
                                          config=cfg, device="cpu")[0]


def jax_engine(cfg):
    import deepspeed_tpu
    from deepspeed_tpu.comm import topology as topo_mod

    topo_mod.reset_topology()
    jm, params = jax_model_and_params()
    return deepspeed_tpu.initialize(model=jm, model_parameters=params, config=cfg)[0]


def batch(k):
    rng = np.random.default_rng(1000 + k)
    return {"input_ids": rng.integers(0, 128, (MB, SEQ)).astype(np.int32)}


def train(engine, n, start=0):
    out = []
    for k in range(start, start + n):
        loss = engine(batch(k))
        engine.backward(loss)
        engine.step()
        out.append(float(loss.detach()) if isinstance(loss, torch.Tensor) else float(loss))
    return np.asarray(out, np.float64)


def fp32_leaves(engine):
    """The engine's fp32 parameters in tree order, as numpy."""
    fp = engine.get_fp32_params()
    if isinstance(engine, DeepSpeedEngine):
        return [t.numpy() for t in tree_leaves(fp)]
    import jax

    return [np.asarray(x) for x in jax.tree.leaves(fp)]


def assert_leaves_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def assert_leaves_close(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, **PARAM_TOL)


class JaxRun:
    """One JAX engine of a configuration: 2 steps, its tag ``jax`` saved,
    2 more steps; the engine kept to load the port's tag into."""

    def __init__(self, cfg, root):
        self.cfg = cfg
        self.dir = str(root)
        self.engine = jax_engine(cfg)
        first = train(self.engine, 2)
        self.engine.save_checkpoint(self.dir, tag="jax")
        self.losses = np.concatenate([first, train(self.engine, 2, start=2)])
        self.params = fp32_leaves(self.engine)
        self.metrics = self.engine.zero_metrics()

    def resume(self, tag_dir, tag):
        """The JAX engine loaded from ``tag``, then steps 3-4."""
        self.engine.load_checkpoint(tag_dir, tag=tag)
        return train(self.engine, 2, start=2)


def make_runs(tmp_path_factory, configs):
    runs = {}

    def get(name):
        if name not in runs:
            runs[name] = JaxRun(configs[name](tmp_path_factory), tmp_path_factory.mktemp(name))
        return runs[name]

    return get


def port_vs_jax(run, cfg, tmp_path):
    """The port under ``cfg`` against ``run``: 4 steps, then its tag after
    step 2 into the JAX engine and the JAX tag into a fresh port engine."""
    eng = port_engine(cfg)
    first = train(eng, 2)
    eng.save_checkpoint(str(tmp_path), tag="port")
    rest = train(eng, 2, start=2)
    np.testing.assert_allclose(np.concatenate([first, rest]), run.losses, rtol=1e-5)
    assert_leaves_close(fp32_leaves(eng), run.params)
    # the JAX tag into the port: steps 3-4 as the JAX engine's
    res = port_engine(cfg)
    res.load_checkpoint(run.dir, tag="jax")
    np.testing.assert_allclose(train(res, 2, start=2), run.losses[2:], rtol=1e-5)
    assert_leaves_close(fp32_leaves(res), run.params)
    # the port's tag into the JAX engine: steps 3-4 as the port's
    np.testing.assert_allclose(run.resume(str(tmp_path), "port"), rest, rtol=1e-5)
    return eng


# ---------------------------------------------------------------------------
# host libraries
# ---------------------------------------------------------------------------

def _adam_case(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(2)] + [
        np.zeros(n, np.float32), np.zeros(n, np.float32)]


@pytest.mark.parametrize("adamw,wd", [(True, 0.01), (False, 0.1), (True, 0.0)])
def test_cpu_adam_library_bitwise_and_plain_version(adamw, wd):
    """``ds_adam_step`` of the port's library and the JAX package's, on
    the same arrays over 3 steps (with an unscale and a clip coefficient),
    bitwise; the plain PyTorch version of the port within rtol 1e-6."""
    from deepspeed_tpu.ops.adam.cpu_adam import DeepSpeedCPUAdam as JaxCPUAdam

    kw = dict(lr=1e-3, betas=(0.9, 0.99), eps=1e-8, weight_decay=wd, adamw_mode=adamw)
    ours, theirs = DeepSpeedCPUAdam(**kw), JaxCPUAdam(**kw)
    a = _adam_case(100_003, seed=1)
    b = [x.copy() for x in a]
    t = [torch.from_numpy(x.copy()) for x in a]
    for step in (1, 2, 3):
        a[1] = b[1] = np.random.default_rng(step).standard_normal(a[1].size).astype(np.float32)
        t[1] = torch.from_numpy(a[1].copy())
        ours.step_flat(*a, step, grad_scale=0.5, clip_coef=0.75)
        theirs.step_flat(*b, step, grad_scale=0.5, clip_coef=0.75)
        adam_step_plain(*t, step, 1e-3, betas=(0.9, 0.99), eps=1e-8, weight_decay=wd,
                        adamw=adamw, grad_scale=0.5, clip_coef=0.75)
    for x, y, z in zip(a, b, t):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_allclose(z.numpy(), x, rtol=1e-6, atol=1e-7)


def test_bf16_cast_and_norm_bitwise_jax_library_and_astype():
    """``ds_f32_to_bf16`` and ``ds_sq_norm`` of both libraries on the same
    array; and the engine's ``lp_cast`` against the JAX package's host cast
    (``astype``), NaNs with payloads, signed NaN and infinities included."""
    import ml_dtypes

    from deepspeed_tpu.ops.adam.cpu_adam import DeepSpeedCPUAdam as JaxCPUAdam

    rng = np.random.default_rng(5)
    x = rng.standard_normal(70_001).astype(np.float32) * 3
    special = np.array([0x7FFFFFFF, 0x7F800001, 0xFFC00001, 0x7FBFFFFF, 0x3F80FFFF,
                        0x3F808000, 0x3F818000, 0x7F800000, 0xFF800000, 0x7F7FFFFF,
                        0x00000001, 0x80000000, 0x7FC00000, 0xFFC00000], np.uint32)
    x[:special.size] = special.view(np.float32)
    finite = np.where(np.isfinite(x), x, 1.0).astype(np.float32)
    ours, theirs = DeepSpeedCPUAdam(), JaxCPUAdam()
    np.testing.assert_array_equal(ours.f32_to_bf16(finite), theirs.f32_to_bf16(finite))
    assert ours.sq_norm(finite, 0.5) == theirs.sq_norm(finite, 0.5)
    got = lp_cast(torch.from_numpy(x), torch.bfloat16).view(torch.int16).numpy()
    with np.errstate(invalid="ignore"):
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(got.view(np.uint16), want)
    fin16 = np.where(np.isnan(x), 1.0, x).astype(np.float32)
    got16 = lp_cast(torch.from_numpy(fin16), torch.float16).view(torch.int16).numpy()
    with np.errstate(over="ignore"):
        np.testing.assert_array_equal(got16.view(np.uint16),
                                      fin16.astype(np.float16).view(np.uint16))


def test_split_by_ratio_matches_jax():
    from deepspeed_tpu.runtime.zero.offload import split_by_ratio as jax_split

    rng = np.random.default_rng(2)
    leaves = [np.zeros(tuple(rng.integers(1, 40, rng.integers(1, 4)))) for _ in range(17)]
    for ratio in (0.0, 0.25, 0.4, 0.5, 0.9, 1.0):
        assert split_by_ratio(leaves, ratio) == jax_split(leaves, ratio)
    assert split_by_ratio([np.zeros(100), np.zeros(50), np.zeros(10)], 0.6) == ([0], [1, 2])


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

CONFIGS = {
    "cpu": lambda f: config(0, {"device": "cpu"}),
    "nvme": lambda f: config(1, {"device": "nvme", "nvme_path": str(f.mktemp("nvme_jax"))}),
    "ratio": lambda f: config(1, {"device": "cpu", "ratio": 0.5}),
}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return make_runs(tmp_path_factory, CONFIGS)


def test_cpu_offload_matches_jax_and_crosses_checkpoints(jax_runs, tmp_path):
    """cpu offload at stage 0: the JAX engine's losses and parameters; its
    tag into the port and the port's into it (the ``offload_host`` format);
    no fp32 master or moment on the engine's device. (``nvme`` and ``ratio``
    below run at stage 1, the sharded file's engines at 2 and 3.)"""
    run = jax_runs("cpu")
    eng = port_vs_jax(run, run.cfg, tmp_path)
    assert eng.master_params is None and eng.opt_state is None
    assert eng._offload_mgr["dev_idx"] == [] and eng._zero_tier is None
    led = eng._transfer.ledger()
    assert led["submitted"]["d2h"] == led["completed"]["d2h"] > 0
    assert led["inflight"] == {"d2h": 0, "h2d": 0}


def test_nvme_offload_matches_jax_and_cpu_bitwise(jax_runs, tmp_path):
    """The legacy ``nvme`` tier (moments in AIO files, read ahead a leaf):
    the JAX engine's numbers, and bitwise the port's ``cpu`` tier."""
    run = jax_runs("nvme")
    cfg = config(1, {"device": "nvme", "nvme_path": str(tmp_path / "nvme")})
    eng = port_vs_jax(run, cfg, tmp_path / "ckpt")
    assert any(f.startswith("optstate_") for f in os.listdir(tmp_path / "nvme"))
    cpu = port_engine(config(1, {"device": "cpu"}))
    nv = port_engine(config(1, {"device": "nvme", "nvme_path": str(tmp_path / "nvme2")}))
    np.testing.assert_array_equal(train(cpu, 4), train(nv, 4))
    assert_leaves_equal(fp32_leaves(cpu), fp32_leaves(nv))
    assert eng._offload_mgr["host"]._aio is not None


def test_twin_flow_ratio_matches_jax_and_the_device_engine(jax_runs, tmp_path):
    """``ratio`` 0.5: the largest leaves on the host, the rest stepped on
    the device by ``FusedAdam``: the JAX engine's numbers, and within 1e-4
    of the device engine (``test_zero_sharded.py:180-196``)."""
    run = jax_runs("ratio")
    eng = port_vs_jax(run, run.cfg, tmp_path)
    mgr = eng._offload_mgr
    assert mgr["host_idx"] and mgr["dev_idx"]
    assert (mgr["host_idx"], mgr["dev_idx"]) == (
        run.engine._offload_mgr["host_idx"], run.engine._offload_mgr["dev_idx"])
    dev = port_engine(config(0))
    np.testing.assert_allclose(train(port_engine(run.cfg), 4), train(dev, 4),
                               rtol=1e-4, atol=1e-4)


def test_ratio_reshard_crosses_both_ways(jax_runs, tmp_path):
    """A ratio-1 tag loads into a ratio-0.5 engine (the split changes, the
    state is resharded, ``engine.py:2409``), each package's tag into the
    other's engine; the two steps after the load match the saver's."""
    cpu_run, ratio_run = jax_runs("cpu"), jax_runs("ratio")
    # the port's ratio-1 tag into the JAX ratio-0.5 engine
    eng = port_engine(cpu_run.cfg)
    train(eng, 2)
    eng.save_checkpoint(str(tmp_path), tag="port")
    rest = train(eng, 2, start=2)
    np.testing.assert_allclose(ratio_run.resume(str(tmp_path), "port"), rest, rtol=1e-5)
    # the JAX ratio-1 tag into the port's ratio-0.5 engine
    res = port_engine(ratio_run.cfg)
    res.load_checkpoint(cpu_run.dir, tag="jax")
    np.testing.assert_allclose(train(res, 2, start=2), cpu_run.losses[2:], rtol=1e-5)


def test_chunked_stream_is_bitwise_the_whole_leaf():
    """A leaf's gradient streamed through the TransferEngine in chunks of
    1000 elements (each copy in flight while the chunk before it is
    stepped) gives the bits of chunks larger than any leaf; with transfer
    overlap off too. bf16: the lp parameters are the host cast of the
    master."""
    runs = []
    for chunk, overlap in ((1 << 30, True), (1000, True), (1000, False)):
        eng = port_engine(config(1, {"device": "cpu"}, bf16=True, transfer_overlap=overlap))
        eng._offload_mgr["host"].chunk_elements = chunk
        runs.append((train(eng, 3), fp32_leaves(eng), eng))
    for losses, leaves, _ in runs[1:]:
        np.testing.assert_array_equal(losses, runs[0][0])
        assert_leaves_equal(leaves, runs[0][1])
    eng = runs[1][2]
    assert eng._transfer.submitted_transfers["d2h"] > 3 * len(eng._offload_mgr["host_idx"])
    for p, m in zip(tree_leaves(eng.params), runs[1][1]):
        assert p.dtype == torch.bfloat16
        assert torch.equal(p.detach().view(torch.int16),
                           lp_cast(torch.from_numpy(m), torch.bfloat16).view(torch.int16))


def test_fp16_overflow_keeps_adam_step_parity():
    """An fp16 step whose gradients overflow is skipped, the loss scale
    halves, and the host Adam's step count still advances
    (``engine.py:1226-1233``)."""
    eng = port_engine(config(1, {"device": "cpu"}) | {"fp16": {
        "enabled": True, "initial_scale_power": 16, "hysteresis": 1}})
    before = fp32_leaves(eng)
    scale = eng.loss_scale()
    loss = eng(batch(0))
    eng.backward(loss)
    eng._acc_grads["wte"][0, 0] = float("inf")
    eng.step()
    assert eng.skipped_steps == 1 and eng.loss_scale() == scale / 2
    assert eng._offload_mgr["host"].step_count == 1
    assert_leaves_equal(fp32_leaves(eng), before)


def test_module_only_load_writes_the_offloaded_master(tmp_path):
    """``load_checkpoint(..., load_optimizer_states=False)`` into a cpu-offload
    engine: the host fp32 master becomes the tag's module weights, bitwise,
    and the next step is the device engine's after the same sequence (2
    steps, save, 1 step, the module-only load, 1 step; the moments and
    Adam's step count stay the engine's own). The JAX engine keeps the
    master it had and steps that over the loaded weights (ROADMAP.md
    Queue 3)."""
    from deepspeed_tpu_torch.runtime.checkpoint_engine.native_checkpoint_engine import (
        NativeCheckpointEngine)

    out = {}
    for name, cfg in (("offload", config(0, {"device": "cpu"})), ("device", config(0))):
        eng = port_engine(cfg)
        train(eng, 2)
        eng.save_checkpoint(str(tmp_path / name), tag="t")
        train(eng, 1, start=2)
        eng.load_checkpoint(str(tmp_path / name), tag="t", load_optimizer_states=False)
        module = NativeCheckpointEngine().load(
            os.path.join(tmp_path / name, "t", "model_states.ckpt"))["module"]
        want = [np.asarray(torch.as_tensor(x).float()) for x in tree_leaves(module)]
        assert_leaves_equal(fp32_leaves(eng), want)
        if name == "offload":
            assert_leaves_equal(eng._offload_mgr["host"].master, want)
            assert eng._offload_mgr["host"].step_count == 3
        out[name] = (train(eng, 1, start=3), fp32_leaves(eng))
    np.testing.assert_allclose(out["offload"][0], out["device"][0], rtol=1e-5)
    assert_leaves_close(out["offload"][1], out["device"][1])
