"""The training slice as a whole: the port's ``initialize`` -> ``DeepSpeedEngine``
over ``TransformerLM.apply`` against the JAX package's, on the CPU.

Both engines start from the same weights (the JAX ``init_params(PRNGKey(0))``,
converted with ``params_from_jax``) and take the same numpy batches: a micro
llama (hidden 256, 4 heads, 2 KV heads, 2 layers, vocab 512, S 128) and a
micro gpt2 (hidden 256, 4 heads so hd 64, learned positions, LayerNorm,
GELU, tied head), fp32. The JAX engine runs data-parallel over the test
mesh's 8 virtual devices and the port on one device, with the same global
batch of 8 sequences a micro-step (``train_batch_size`` 8 resolves to a
micro-batch of 1 there and of 8 here).

Adam's first step divides each gradient by its own magnitude, so where a
gradient is tiny its sign alone decides the update and the two packages'
last-bit differences would flip it; ``eps`` 1e-6 (above those gradients)
keeps the first steps comparable. Tolerances: losses at rtol 1e-5,
gradients at atol 1e-6, grad norms at rtol 1e-4, parameters after the
steps at atol 2e-5, lr exactly.
"""

import functools

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import build_model, params_from_jax, params_to_numpy
from deepspeed_tpu_torch.ops.transformer import attention as tatt

MODELS = {
    "llama": ("llama-tiny", dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
                                 num_kv_heads=2, intermediate_size=512, max_seq_len=128)),
    "gpt2": ("gpt2-125m", dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
                               max_seq_len=128)),
}
S, ROWS = 128, 8


def _config(gas=1, **kw):
    cfg = {
        "train_batch_size": ROWS * gas,
        "gradient_accumulation_steps": gas,
        "gradient_clipping": 1.0,
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1,
                                                  "eps": 1e-6}},
        "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 0,
                                                     "warmup_max_lr": 1e-3,
                                                     "warmup_num_steps": 2}},
        "steps_per_print": 0,
        "seed": 0,
    }
    cfg.update(kw)
    return cfg


def _batches(vocab, n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, (ROWS, S)).astype(np.int32)}
            for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _jax_model_and_params(name):
    """The JAX model and its ``init_params(PRNGKey(0))`` as numpy, built once
    a model for the module (callers treat the arrays as read-only)."""
    import jax

    from deepspeed_tpu.models import build_model as jax_build_model

    preset, mkw = MODELS[name]
    jm = jax_build_model(preset, **mkw)
    return jm, jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread for the module: the CPU's multi-threaded matrix
    products do not repeat bitwise from run to run (the bitwise tests need
    that), and under parallel test workers a thread pool each oversubscribes
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engines(name, config, **kw):
    import deepspeed_tpu

    preset, mkw = MODELS[name]
    jm, params = _jax_model_and_params(name)
    jeng, _, _, _ = deepspeed_tpu.initialize(model=jm, model_parameters=params,
                                             config=dict(config), **kw)
    teng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=build_model(preset, **mkw), model_parameters=params_from_jax(params),
        config=dict(config), device="cpu", **kw)
    return jeng, teng, jm


def _assert_params_close(jeng, teng, atol=2e-5):
    import jax

    want = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jeng.params))
    got = params_to_numpy(teng.params)
    for path, a in want:
        leaf = got
        for k in path:
            leaf = leaf[k.key]
        np.testing.assert_allclose(leaf, a, atol=atol, err_msg=jax.tree_util.keystr(path))


def _assert_grads_close(jgrads, tgrads, atol=1e-6):
    import jax

    for path, a in jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jgrads)):
        leaf = tgrads
        for k in path:
            leaf = leaf[k.key]
        np.testing.assert_allclose(leaf.detach().numpy(), a, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", list(MODELS))
def test_apply_loss_and_gradients_match_jax(name):
    import jax
    import jax.numpy as jnp

    preset, mkw = MODELS[name]
    jm, params = _jax_model_and_params(name)
    tm = build_model(preset, **mkw)
    ids = _batches(512, 1, seed=5)[0]["input_ids"][:2]
    labels = ids.copy()
    labels[:, :7] = -100  # explicit labels with ignored positions
    # one compiled program a batch signature (op-by-op dispatch compiles
    # every primitive of the graph on its own)
    value_and_grad = jax.jit(jax.value_and_grad(jm.apply))
    for batch in ({"input_ids": ids}, {"input_ids": ids, "labels": labels}):
        jl, jg = value_and_grad(jax.tree.map(jnp.asarray, params),
                                jax.tree.map(jnp.asarray, batch))
        tp = {k: (v if not torch.is_tensor(v) else v.requires_grad_())
              for k, v in params_from_jax(params).items()}
        for blk in tp["blocks"].values():
            blk.requires_grad_()
        tl = tm.apply(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
        tl.backward()
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
        grads = {k: (v.grad if torch.is_tensor(v) else {b: w.grad for b, w in v.items()})
                 for k, v in tp.items()}
        _assert_grads_close(jg, grads)


@pytest.mark.parametrize("name", list(MODELS))
def test_gas1_train_batch_matches_jax(name):
    """3 fused ``train_batch`` steps fed by each engine's own data loader
    (the same seeded shuffle), then an eval-mode forward."""
    data = [{"input_ids": r} for b in _batches(512, 3, seed=1) for r in b["input_ids"]]
    jeng, teng, _ = _engines(name, _config(), training_data=data)
    assert len(teng.training_dataloader) == len(jeng.training_dataloader) == 3
    for _ in range(3):
        assert teng.get_lr() == jeng.get_lr()
        jl, tl = float(jeng.train_batch()), float(teng.train_batch())
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        np.testing.assert_allclose(float(teng.get_global_grad_norm()),
                                   float(jeng.get_global_grad_norm()), rtol=1e-4)
    assert teng.get_lr() == jeng.get_lr() == [1e-3]
    assert (teng.global_steps, teng.micro_steps) == (jeng.global_steps, jeng.micro_steps)
    _assert_params_close(jeng, teng)
    batch = _batches(512, 1, seed=9)[0]
    jeng.eval()
    teng.eval()
    tl = teng(batch)
    assert tl.dtype == torch.float32 and not tl.requires_grad
    np.testing.assert_allclose(float(tl), float(jeng(batch)), rtol=1e-5)


@pytest.mark.parametrize("name", list(MODELS))
def test_gas2_forward_backward_step_matches_jax(name):
    """2 optimizer steps of 2 micro-steps each through forward/backward/step;
    the first micro-step's gradients (loss / GAS, fp32 accumulation buffer)."""
    jeng, teng, _ = _engines(name, _config(gas=2))
    batches = _batches(512, 4, seed=2)
    for step in range(2):
        for micro in range(2):
            b = batches[2 * step + micro]
            jl = jeng(b)
            jeng.backward(jl)
            tl = teng(b)
            teng.backward(tl)
            np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
            if step == 0 and micro == 0:
                _assert_grads_close(jeng._acc_grads, teng._acc_grads)
            assert not teng.is_gradient_accumulation_boundary() or micro == 1
        jeng.step()
        teng.step()
        assert teng.get_lr() == jeng.get_lr()
        np.testing.assert_allclose(float(teng.get_global_grad_norm()),
                                   float(jeng.get_global_grad_norm()), rtol=1e-4)
    assert teng.global_steps == jeng.global_steps == 2
    _assert_params_close(jeng, teng)


def test_one_step_with_the_jax_flash_kernel():
    """One ``train_batch`` with both dispatches forced to ``"pallas_flash"``:
    the JAX Pallas kernel in interpret mode, the port's autograd Function
    over the plain forward and backward."""
    import importlib

    # the package re-exports the function ``attention`` over the module's name
    jatt = importlib.import_module("deepspeed_tpu.ops.transformer.attention")
    jatt.set_default_impl("pallas_flash")
    tatt.set_default_impl("pallas_flash")
    try:
        jeng, teng, _ = _engines("llama", _config())
        b = _batches(512, 1, seed=3)[0]
        jl, tl = float(jeng.train_batch(iter([b]))), float(teng.train_batch(iter([b])))
    finally:
        jatt.set_default_impl(None)
        tatt.set_default_impl(None)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(float(teng.get_global_grad_norm()),
                               float(jeng.get_global_grad_norm()), rtol=1e-4)
    _assert_params_close(jeng, teng)


def _port_engine(name, config):
    preset, mkw = MODELS[name]
    params = _jax_model_and_params(name)[1]
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=build_model(preset, **mkw), model_parameters=params_from_jax(params),
        config=config, device="cpu")
    return eng


@pytest.mark.parametrize("precision", [{}, {"bf16": {"enabled": True}}])
def test_fused_train_batch_is_bitwise_forward_backward_step(precision, one_thread):
    """The port's internal twin: at GAS=1 ``train_batch`` (the fused
    micro-step) and forward/backward/step give bitwise-equal parameters."""
    fused = _port_engine("llama", _config(**precision))
    split = _port_engine("llama", _config(**precision))
    for b in _batches(512, 3, seed=4):
        lf = fused.train_batch(iter([b]))
        ls = split(b)
        split.backward(ls)
        split.step()
        assert torch.equal(lf, ls.detach())
    for a, c in zip(fused.params["blocks"].values(), split.params["blocks"].values()):
        assert torch.equal(a, c)
    assert torch.equal(fused.params["wte"], split.params["wte"])
    if precision:
        assert fused.params["wte"].dtype == torch.bfloat16
        for a, c in zip(fused.master_params["blocks"].values(),
                        split.master_params["blocks"].values()):
            assert a.dtype == torch.float32 and torch.equal(a, c)


def test_bf16_engine_keeps_fp32_master_and_trains():
    eng = _port_engine("gpt2", _config(bf16={"enabled": True}))
    assert eng.params["wte"].dtype == torch.bfloat16
    assert eng.master_params["wte"].dtype == torch.float32
    b = _batches(512, 1, seed=6)[0]
    losses = [float(eng.train_batch(iter([b]))) for _ in range(4)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    np.testing.assert_array_equal(
        eng.params["wte"].detach().float().numpy(),
        eng.master_params["wte"].to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("key,value,match", [
    ("zero_optimization", {"stage": 1}, "item 13"),
    ("zero_optimization", {"offload_optimizer": {"device": "cpu"}}, "item 13"),
    ("mesh", {"data": 1}, "item 13"),
    ("optimizer", {"type": "OneBitAdam", "params": {}}, "item 13"),
    ("steps_per_execution", 2, "item 17"),
    ("progressive_layer_drop", {"enabled": True}, "item 17"),
    ("compression_training", {"weight_quantization": {}}, "item 17"),
])
def test_unported_config_raises_naming_the_item(key, value, match):
    with pytest.raises(NotImplementedError, match=match):
        _port_engine("llama", _config(**{key: value}))


def test_checkpoints_and_unported_model_fields_raise(tmp_path):
    """Checkpoints are ported: a save loads back, but an optimizer-offload
    checkpoint (``offload_host``, ZeRO's) raises naming item 13; so do the
    unported model fields, naming themselves."""
    from deepspeed_tpu_torch.runtime.checkpoint_engine.native_checkpoint_engine import (
        NativeCheckpointEngine)

    eng = _port_engine("llama", _config())
    eng.save_checkpoint(str(tmp_path))
    assert eng.load_checkpoint(str(tmp_path))[0].endswith("global_step0/model_states.ckpt")
    NativeCheckpointEngine().save({"offload_host": {"step": 0}, "scaler": None},
                                  str(tmp_path / "global_step0" / "optim_states.ckpt"))
    with pytest.raises(NotImplementedError, match="item 13"):
        eng.load_checkpoint(str(tmp_path))
    preset, mkw = MODELS["llama"]
    for field, value in (("remat", True), ("progressive_layer_drop", True)):
        m = build_model(preset, **dict(mkw, **{field: value}))
        with pytest.raises(NotImplementedError, match=field):
            m.apply(m.init_params(torch.Generator().manual_seed(0)),
                    torch.zeros((1, 8), dtype=torch.int32))
