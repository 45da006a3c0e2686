"""Activation checkpointing in the port against the JAX package's, on the CPU.

``TransformerConfig(remat=True)`` reruns each block in the backward under
one of the JAX package's seven ``remat_policy`` values (port
``models/transformer.py`` ``_ckpt`` on PyTorch's selective checkpointing,
``runtime/activation_checkpointing/policies.py``). Held here, fp32, torch
on one thread:

- for every policy, with and without dropout 0.1, on the param-swap tests'
  micro gpt2 (hidden 64, 4 layers, 4 heads, vocab 256, S 32) and a micro
  llama: the loss and every gradient bitwise the port's without remat (the
  recompute reruns the same operations on the same inputs and redraws the
  same threefry masks); and for every policy within atol 1e-5 of
  ``jax.grad`` of the JAX model under the same policy
  (``tests/unit/test_models.py:44-55``), the gpt2 with dropout and the
  llama without;
- what a block keeps for its backward: the bytes the CPU allocator holds
  after the block's forward (``torch.profiler`` with ``profile_memory``)
  order as ``full`` < ``dots_lean`` < ``dots_plain`` < ``dots`` <
  ``dots_ln`` < ``dots_elem`` < no remat, ``dots_batch`` equal to
  ``dots_plain`` (the flash forward has no batch dot), and the flash
  forward runs again in the backward exactly under ``full``,
  ``dots_plain`` and ``dots_batch`` (its residuals are named, not dots);
- an unknown policy raises the JAX package's ``ValueError`` text;
- the ``deepspeed.checkpointing`` API: ``RNGStatesTracker.add`` / ``fork``
  and ``model_parallel_cuda_manual_seed`` give the JAX tracker's keys
  bitwise; ``checkpoint(fn, x)`` and ``checkpoint_wrapped`` give ``fn``'s
  gradient, with and without ``cpu_checkpointing``; ``configure`` reads
  the config's ``activation_checkpointing`` block;
- an engine over a remat model trains bitwise the engine without remat.

On a card (``cuda``-marked, skipped here): the flash kernels' launch counts
a remat step takes under each policy, and its peak memory in the order
above.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import build_model, params_from_jax
from deepspeed_tpu_torch.models.transformer import TransformerLM
from deepspeed_tpu_torch.ops.transformer import attention as tatt
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
from deepspeed_tpu_torch.utils.tree import tree_leaves

POLICIES = ("full", "dots", "dots_plain", "dots_batch", "dots_ln", "dots_elem", "dots_lean")
MODELS = {
    "gpt2": ("gpt2-125m", dict(hidden_size=64, num_layers=4, num_heads=4, vocab_size=256,
                               max_seq_len=32)),
    "llama": ("llama-tiny", dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                                 num_kv_heads=2, intermediate_size=192, max_seq_len=32)),
}
ROWS, S = 2, 32
#: the kept-bytes case: a llama block wide enough that each kept tensor shows
WIDE = ("llama-tiny", dict(vocab_size=128, hidden_size=256, num_layers=1, num_heads=4,
                           num_kv_heads=2, intermediate_size=688, max_seq_len=256))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: bitwise comparisons need repeatable CPU matmuls,
    and parallel test workers with a pool each oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_params(name, dropout):
    import jax

    from deepspeed_tpu.models import build_model as jax_build_model

    preset, mkw = MODELS[name]
    jm = jax_build_model(preset, **mkw, dropout=dropout)
    return jax.tree.map(np.asarray, jax.jit(jm.init_params)(jax.random.PRNGKey(0)))


def _batch(name):
    vocab = MODELS[name][1]["vocab_size"]
    return np.random.default_rng(7).integers(0, vocab, (ROWS, S)).astype(np.int32)


def _key():
    import jax

    return jax.random.fold_in(jax.random.PRNGKey(0), 3)


def _port_loss_and_grads(name, dropout, policy):
    preset, mkw = MODELS[name]
    remat = dict(remat=True, remat_policy=policy) if policy else {}
    tm = build_model(preset, **mkw, dropout=dropout, **remat)
    tp = params_from_jax(_jax_params(name, dropout))
    leaves = list(tree_leaves(tp))
    for leaf in leaves:
        leaf.requires_grad_()
    rng = torch.from_numpy(np.asarray(_key()).astype(np.int64)) if dropout else None
    loss = tm.apply(tp, {"input_ids": torch.from_numpy(_batch(name))}, train=True, rng=rng)
    return loss.detach(), torch.autograd.grad(loss, leaves)


@functools.lru_cache(maxsize=None)
def _port_reference(name, dropout):
    return _port_loss_and_grads(name, dropout, None)


def _jax_loss_and_grads(name, dropout, policy):
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.models import build_model as jax_build_model

    preset, mkw = MODELS[name]
    jm = jax_build_model(preset, **mkw, dropout=dropout, remat=True, remat_policy=policy)
    key = _key() if dropout else None
    batch = {"input_ids": jnp.asarray(_batch(name))}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply(p, batch, train=True, rng=key)))(
        jax.tree.map(jnp.asarray, _jax_params(name, dropout)))
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", list(MODELS))
def test_remat_bitwise_no_remat(name, policy, dropout):
    loss, grads = _port_loss_and_grads(name, dropout, policy)
    ref_loss, ref_grads = _port_reference(name, dropout)
    assert torch.equal(loss, ref_loss)
    assert len(grads) == len(ref_grads)
    for g, r in zip(grads, ref_grads):
        assert torch.equal(g, r), "a gradient under remat differs from the one without"


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name,dropout", [("gpt2", 0.1), ("llama", 0.0)])
def test_remat_close_to_jax_under_the_same_policy(name, dropout, policy):
    """One JAX compile a case (~1 s): the micro gpt2 with dropout, the micro
    llama without."""
    loss, grads = _port_loss_and_grads(name, dropout, policy)
    jl, jg = _jax_loss_and_grads(name, dropout, policy)
    np.testing.assert_allclose(loss.item(), jl, atol=1e-5)
    # both trees flatten in sorted-key order (blocks/<leaf> under "blocks")
    assert len(jg) == len(grads)
    for g, want in zip(grads, jg):
        np.testing.assert_allclose(g.numpy(), want, atol=1e-5)


def _kept_bytes_and_recomputes(policy):
    """Bytes the CPU allocator holds after one block's forward (its output
    left out), and the flash forwards its backward runs again."""
    preset, mkw = WIDE
    remat = dict(remat=True, remat_policy=policy) if policy else {}
    tm = build_model(preset, **mkw, **remat)
    params = tm.init_params(torch.Generator().manual_seed(0))
    blk = {k: w[0].clone().requires_grad_() for k, w in params["blocks"].items()}
    B, T = 2, mkw["max_seq_len"]
    x = torch.randn((B, T, mkw["hidden_size"]), generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    positions = torch.arange(T).expand(B, T)
    block = tm._ckpt(tm._block) if policy else tm._block
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                profile_memory=True) as prof:
        y = block(x, blk, positions, None, True)
    kept = sum(e.self_cpu_memory_usage for e in prof.key_averages()) - y.numel() * 4
    calls = []
    real = fa.flash_attention_plain

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    fa.flash_attention_plain = counted
    try:
        y.sum().backward()
    finally:
        fa.flash_attention_plain = real
    return kept, len(calls)


def test_kept_bytes_follow_the_policy_order():
    """The flash path on the CPU (its plain version behind the same
    dispatcher operation the card runs), one llama block at hidden 256."""
    tatt.set_default_impl("pallas_flash")
    try:
        got = {p: _kept_bytes_and_recomputes(p) for p in POLICIES + (None,)}
    finally:
        tatt.set_default_impl(None)
    kept = {p: b for p, (b, _) in got.items()}
    order = ("full", "dots_lean", "dots_plain", "dots", "dots_ln", "dots_elem", None)
    assert all(kept[a] < kept[b] for a, b in zip(order, order[1:])), kept
    assert kept["dots_batch"] == kept["dots_plain"]
    # what dots_lean leaves out of dots: the gate and up projections' outputs
    B, T, I = 2, WIDE[1]["max_seq_len"], WIDE[1]["intermediate_size"]
    assert kept["dots"] - kept["dots_lean"] == 2 * B * T * I * 4
    recomputes = {p: n for p, (_, n) in got.items()}
    assert recomputes == {"full": 1, "dots_plain": 1, "dots_batch": 1, "dots": 0,
                          "dots_ln": 0, "dots_elem": 0, "dots_lean": 0, None: 0}


def test_unknown_policy_raises_the_jax_error():
    from deepspeed_tpu.models import build_model as jax_build_model

    preset, mkw = MODELS["llama"]
    ids = _batch("llama")
    jm = jax_build_model(preset, **mkw, remat=True, remat_policy="dots_all")
    with pytest.raises(ValueError) as want:
        jm.apply(jm.init_params(_key()), {"input_ids": ids})
    tm = build_model(preset, **mkw, remat=True, remat_policy="dots_all")
    params = tm.init_params(torch.Generator().manual_seed(0))
    for leaf in tree_leaves(params):
        leaf.requires_grad_()
    with pytest.raises(ValueError) as got:
        tm.apply(params, {"input_ids": torch.from_numpy(ids)})
    assert str(got.value) == str(want.value)


def test_rng_tracker_keys_bitwise_jax():
    from deepspeed_tpu.runtime.activation_checkpointing import checkpointing as jck

    from deepspeed_tpu_torch import checkpointing as tck

    for mod in (jck, tck):
        mod.get_cuda_rng_tracker().reset()
    jt, tt = jck.RNGStatesTracker(), tck.RNGStatesTracker()
    for t in (jt, tt):
        t.add("a", 5)
        t.add("b", 2**31 + 7)
    for name in ("a", "b", "a", "a", "b"):
        want, got = np.asarray(jt.fork(name)).astype(np.int64), tt.fork(name)
        assert np.array_equal(got.numpy(), want)
    with pytest.raises(Exception, match="already exists"):
        tt.add("a", 1)
    with pytest.raises(Exception, match="not added"):
        tt.fork("c")
    assert jck.model_parallel_cuda_manual_seed(11) == tck.model_parallel_cuda_manual_seed(11)
    for _ in range(3):
        want = np.asarray(jck.get_cuda_rng_tracker().fork()).astype(np.int64)
        assert np.array_equal(tck.get_cuda_rng_tracker().fork().numpy(), want)
    states = tck.get_cuda_rng_tracker().get_states()
    assert set(states) == {"model-parallel-rng"}
    assert torch.equal(states["model-parallel-rng"],
                       torch.from_numpy(np.asarray(jck.get_cuda_rng_tracker().get_states()[
                           "model-parallel-rng"]).astype(np.int64)))


@pytest.mark.parametrize("cpu_checkpointing", [False, True])
def test_checkpoint_gives_the_functions_gradient(cpu_checkpointing):
    from deepspeed_tpu_torch import checkpointing as ck
    from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing as ckm
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

    saved = dict(ckm._config)
    ck.configure(deepspeed_config=DeepSpeedConfig({
        "train_batch_size": 1,
        "activation_checkpointing": {"cpu_checkpointing": cpu_checkpointing,
                                     "partition_activations": True,
                                     "number_checkpoints": 4}}))
    try:
        cfg = ckm._config
        assert cfg["cpu_checkpointing"] is cpu_checkpointing
        assert cfg["partition_activations"] and cfg["num_checkpoints"] == 4
        w = torch.randn((16, 16), generator=torch.Generator().manual_seed(0),
                        requires_grad=True)
        x = torch.randn((4, 16), generator=torch.Generator().manual_seed(1),
                        requires_grad=True)

        def fn(h):
            return torch.tanh(h @ w).square().sum(-1)

        want = torch.autograd.grad(fn(x).sum(), (x, w))
        for call in (lambda: ck.checkpoint(fn, x), lambda: ck.checkpoint_wrapped(fn)(x)):
            got = torch.autograd.grad(call().sum(), (x, w))
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    finally:
        ckm._config.update(saved)
    assert ck.is_configured()


def test_remat_engine_trains_bitwise_the_engine_without():
    name = "llama"
    preset, mkw = MODELS[name]
    params = _jax_params(name, 0.1)
    cfg = {"train_batch_size": ROWS, "gradient_clipping": 1.0, "steps_per_print": 0,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1}},
           "seed": 0}
    losses = []
    for remat in ({}, dict(remat=True, remat_policy="dots")):
        eng = deepspeed_tpu_torch.initialize(
            model=build_model(preset, **mkw, dropout=0.1, **remat),
            model_parameters=params_from_jax(params), config=dict(cfg), device="cpu")[0]
        losses.append([eng.train_batch(iter([{"input_ids": _batch(name)}]))
                       for _ in range(3)])
        losses[-1].append(tree_leaves(eng.params))
    for a, b in zip(losses[0][:3], losses[1][:3]):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(losses[0][3], losses[1][3]))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_remat_launches_and_peak_memory(cuda):
    """A llama at hidden 1024, hd 128, 2 layers, bf16, 2 x 1024 tokens: one
    forward and backward a policy, its flash launches (forward 2 x L where
    the policy names no flash residual, else L; backward L) and its peak
    memory in the policies' order, gradients bitwise those without remat."""
    base = build_model("llama-tiny", vocab_size=1024, hidden_size=1024, num_layers=2,
                       num_heads=8, num_kv_heads=8, intermediate_size=2816,
                       max_seq_len=1024).config
    params = TransformerLM(base).init_params(torch.Generator(device=cuda).manual_seed(0),
                                             dtype=torch.bfloat16)
    ids = torch.randint(0, 1024, (2, 1024), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(1))
    leaves = list(tree_leaves(params))
    for leaf in leaves:
        leaf.requires_grad_()
    out = {}
    for policy in (None,) + POLICIES:
        cfg = dataclasses.replace(base, remat=True, remat_policy=policy) if policy else base
        model = TransformerLM(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        fa.fwd_launches = fa.bwd_launches = 0
        loss = model.apply(params, {"input_ids": ids})
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        out[policy] = (loss, grads, torch.cuda.max_memory_allocated() - before,
                       fa.fwd_launches, fa.bwd_launches)
    L = base.num_layers
    ref_loss, ref_grads = out[None][:2]
    for policy, (loss, grads, peak, fwd, bwd) in out.items():
        assert torch.equal(loss, ref_loss)
        assert all(torch.equal(a, b) for a, b in zip(grads, ref_grads))
        want = 2 * L if policy in ("full", "dots_plain", "dots_batch") else L
        assert (fwd, bwd) == (want, L), policy
    peak = {p: v[2] for p, v in out.items()}
    order = ("full", "dots_lean", "dots", "dots_ln", "dots_elem", None)
    assert all(peak[a] < peak[b] for a, b in zip(order, order[1:])), peak
    assert peak["dots_plain"] < peak["dots"], peak
