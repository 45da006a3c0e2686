"""Training dropout in the port against the JAX package's, on the CPU.

The port's ``_dropout`` draws its keep-mask with ``prng.bernoulli`` under
the reference's chain of keys (``split(rng, L)``, a per-layer split into
``(r_drop, r_pld)``, then one split for the attention output and one for
the MLP output), and its engine passes ``fold_in(PRNGKey(seed),
micro_steps)`` to every training-mode call, as the JAX engine does. Held
here, fp32: ``_dropout`` bitwise the reference's (mask and values);
``apply(train=True, rng)`` loss and gradients at atol 2e-5 of the JAX
model's; three ``train_batch`` steps with dropout 0.1 at the JAX engine's
losses (rtol 1e-5); ``train=False`` ignoring dropout; with dropout 0 the
engine's losses bitwise those of a model called without a key; PLD and
random-LTD still refused, naming ROADMAP.md Queue 1 item 17. The model is
the pool tests' micro llama (vocab 128, hidden 64, 2 layers) on batches of
8 x 32 tokens.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.models import build_model, params_from_jax
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.utils import prng
from tests.test_torch_train_engine import _assert_grads_close, _config

PRESET = "llama-tiny"
MODEL = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
             intermediate_size=128, max_seq_len=64)
ROWS, S = 8, 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the micro model gains nothing from more, and
    parallel test workers with a pool of threads each oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, MODEL["vocab_size"], (ROWS, S)).astype(np.int32)}
            for _ in range(n)]


def _jax_key(seed, pos):
    import jax

    return jax.random.fold_in(jax.random.PRNGKey(seed), pos)


def _words(key):
    """A jax key's two uint32 words as the port's int64 key."""
    return torch.from_numpy(np.asarray(key).astype(np.int64))


@pytest.mark.parametrize("rate,shape", [(0.1, (2, 16, 64)), (0.5, (3, 7, 5)), (0.9, (33,)),
                                        (0.1, ())])
def test_dropout_bitwise_the_reference(rate, shape):
    from deepspeed_tpu.models import transformer as jt

    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    key = _jax_key(3, 5)
    want = np.asarray(jt._dropout(x, rate, key, True))
    got = tt._dropout(torch.from_numpy(x), rate, _words(key), True).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    for train, key_ in ((False, key), (True, None)):  # no draw: x itself
        t = torch.from_numpy(x)
        assert tt._dropout(t, rate, None if key_ is None else _words(key_),
                           train) is t


def _models(**kw):
    import jax

    from deepspeed_tpu.models import build_model as jax_build_model

    jm, tm = jax_build_model(PRESET, **MODEL, **kw), build_model(PRESET, **MODEL, **kw)
    return jm, tm, jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))


def test_apply_with_a_key_matches_jax_loss_and_gradients():
    import jax
    import jax.numpy as jnp

    jm, tm, params = _models(dropout=0.1)
    batch = {"input_ids": _batches(1, seed=5)[0]["input_ids"][:2]}
    key = _jax_key(0, 3)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jm.apply(
        p, jax.tree.map(jnp.asarray, batch), train=True, rng=key)))(
        jax.tree.map(jnp.asarray, params))
    tp = params_from_jax(params)
    for leaf in [v for k, v in tp.items() if k != "blocks"] + list(tp["blocks"].values()):
        leaf.requires_grad_()
    tl = tm.apply(tp, {"input_ids": torch.from_numpy(batch["input_ids"])}, train=True,
                  rng=_words(key))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), atol=2e-5)
    grads = {k: (v.grad if torch.is_tensor(v) else {b: w.grad for b, w in v.items()})
             for k, v in tp.items()}
    _assert_grads_close(jg, grads, atol=2e-5)
    # the masks bite: without a key the MLP's output gradient is another
    # (a tenth of it zeroed, the rest scaled)
    pp = params_from_jax(params)
    pp["blocks"]["w_down"].requires_grad_()
    plain = tm.apply(pp, {"input_ids": torch.from_numpy(batch["input_ids"])})
    plain.backward()
    g0, g1 = pp["blocks"]["w_down"].grad, tp["blocks"]["w_down"].grad
    assert float((g0 - g1).norm() / g0.norm()) > 0.05
    # train=False ignores dropout and the key
    with torch.no_grad():
        ev = tm.apply(params_from_jax(params), {"input_ids": torch.from_numpy(
            batch["input_ids"])}, train=False, rng=_words(key))
    assert torch.equal(ev, plain.detach())
    np.testing.assert_allclose(ev.item(), float(jm.apply(params, batch, train=False,
                                                         rng=key)), atol=2e-5)


def test_three_train_batch_steps_match_jax():
    import deepspeed_tpu
    import deepspeed_tpu_torch

    cfg = _config()
    jm, tm, params = _models(dropout=0.1)
    jeng, _, _, _ = deepspeed_tpu.initialize(model=jm, model_parameters=params, config=dict(cfg))
    teng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=tm, model_parameters=params_from_jax(params), config=dict(cfg), device="cpu")
    losses = []
    for b in _batches(3, seed=1):
        jl, tl = float(jeng.train_batch(iter([b]))), float(teng.train_batch(iter([b])))
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        losses.append(tl)
    assert teng.micro_steps == jeng.micro_steps == 3
    # the engine's key for micro-step k is fold_in(PRNGKey(seed), k)
    assert torch.equal(teng._micro_step_key(), prng.fold_in(prng.PRNGKey(cfg["seed"]), 3))


def test_dropout_zero_engine_losses_bitwise_a_keyless_model(monkeypatch):
    """With dropout 0 the engine's key changes nothing: its losses are
    bitwise those of an engine whose model is called with ``rng=None``
    (one thread: threaded matmuls do not repeat bitwise)."""
    import deepspeed_tpu_torch

    _, tm, params = _models()
    keyed, keyless = (deepspeed_tpu_torch.initialize(
        model=tm, model_parameters=params_from_jax(params), config=_config(),
        device="cpu")[0] for _ in range(2))
    monkeypatch.setattr(keyless, "_micro_step_key", lambda: None)
    for b in _batches(2, seed=4):
        a, c = keyed.train_batch(iter([b])), keyless.train_batch(iter([b]))
        assert torch.equal(a, c)
        la, lc = keyed(b), keyless(b)
        keyed.backward(la)
        keyless.backward(lc)
        keyed.step()
        keyless.step()
        assert torch.equal(la, lc)


@pytest.mark.parametrize("field", ["progressive_layer_drop", "random_ltd"])
def test_pld_and_random_ltd_still_raise_naming_item_17(field):
    m = build_model(PRESET, **dict(MODEL, dropout=0.1, **{field: True}))
    with pytest.raises(NotImplementedError, match=rf"{field}.*item 17"):
        m.apply(m.init_params(torch.Generator().manual_seed(0)),
                torch.zeros((1, 8), dtype=torch.int32), rng=prng.PRNGKey(0))
