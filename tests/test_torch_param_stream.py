"""The ZeRO-Infinity parameter tier in the port against the JAX package's, on the CPU.

``zero_optimization: {"stage": 3, "offload_param": {"device": "cpu" |
"nvme"}}`` makes ``initialize`` build ``StreamedZeroEngine`` (port
``runtime/swap_tensor/streamed.py``): the model runs one layer at a time,
its weights streamed from the host fp32 master (or NVMe files) by
``StreamedParamStore``, the master and moments stepped by the C++ CPU Adam.

Held here, on ``tests/unit/test_param_swap.py``'s micro gpt2 (hidden 64, 4
layers, 4 heads, vocab 256, S 32, 2 rows a micro-step, AdamW lr 1e-3,
clipping 1.0) and a micro llama, fp32, torch on one thread:

- the port's streamed engine against the JAX streamed engine from the same
  weights over 5 steps: losses and the fp32 masters at rtol 1e-5 (atol 2e-5
  on the masters, as ``test_torch_zero_offload.py`` holds the offloaded
  engines), at most 2 groups live on the device in each;
- the cases of ``test_param_swap.py`` inside the port: streamed against the
  resident engine with the optimizer offloaded (rtol 1e-4); ``nvme``
  bitwise ``cpu``, with the stem's file and one a layer; stage < 3 and the
  refused arguments raising the JAX package's ``ValueError``; GAS 2 against
  the resident engine at GAS 2 (rtol 2e-4); the async writeback in flight
  when a step returns and the trajectory bitwise ``cpu``'s;
- dropout: the keys each block draws under are the JAX streamed engine's
  chain bitwise (``fold_in(fold_in(PRNGKey(seed), micro_step), m)``, then
  ``fold_in(., layer)``), layer 0's mask bitwise ``jax.random.bernoulli``'s,
  and 3 steps at the JAX streamed engine's losses (rtol 1e-5);
- ``state_dict`` / ``load_state_dict``: a fresh engine loaded with a
  step-2 state takes steps 3-4 bitwise the original's.

On a card (``cuda``-marked, skipped here): the streamed engine small on the
card against its CPU twin, and its flash launches (2 x L forwards a step:
the forward and the recompute; L backwards).
"""

import functools
import os

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import build_model, params_from_jax
from deepspeed_tpu_torch.runtime.swap_tensor import StreamedZeroEngine
from deepspeed_tpu_torch.utils import prng
from deepspeed_tpu_torch.utils.tree import tree_map

MB, SEQ, STEPS, LR = 2, 32, 5, 1e-3
MODELS = {
    "gpt2": ("gpt2-125m", dict(hidden_size=64, num_layers=4, num_heads=4, vocab_size=256,
                               max_seq_len=SEQ)),
    "llama": ("llama-tiny", dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                                 num_kv_heads=2, intermediate_size=192, max_seq_len=SEQ)),
}
PARAM_TOL = dict(rtol=1e-5, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: bitwise twins need repeatable CPU matmuls, and
    parallel test workers with a pool each oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(offload_param=None, stage=3, gas=1, **kw):
    zero = {"stage": stage}
    if offload_param is not None:
        zero["offload_param"] = offload_param
    cfg = {"train_micro_batch_size_per_gpu": MB, "gradient_accumulation_steps": gas,
           "optimizer": {"type": "adamw", "params": {"lr": LR}},
           "zero_optimization": zero, "gradient_clipping": 1.0, "steps_per_print": 0}
    cfg.update(kw)
    return cfg


def batches(n=STEPS, rows=MB, seed=11):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 256, (rows, SEQ), dtype=np.int32)}
            for _ in range(n)]


def _one_device():
    import jax

    from deepspeed_tpu.comm import topology as topo_mod

    topo_mod.reset_topology()
    topo_mod.initialize_topology(data=1, model=1, seq=1, pipe=1, expert=1,
                                 devices=np.array(jax.devices()[:1]))


def _jax_initial_params(jeng):
    """The JAX streamed engine's weights before its first step, as the
    port's nested tree (its groups stacked back into the block leaves)."""
    groups = [{k: np.array(v) for k, v in g.items()} for g in jeng._groups]
    tree = dict(groups[0])
    tree["blocks"] = {k: np.stack([g[k] for g in groups[1:]]) for k in groups[1]}
    return tree


def port_model(name, tree=None, **kw):
    """The port's model; with ``tree``, its ``init_params`` returns those
    weights (the streamed engine draws its own, as the JAX engine does)."""
    preset, mkw = MODELS[name]
    model = build_model(preset, **mkw, **kw)
    if tree is not None:
        model.init_params = lambda *a, **k: params_from_jax(tree)
    return model


@functools.lru_cache(maxsize=None)
def jax_run(name, dropout=0.0):
    """The JAX streamed engine (cpu tier): its initial weights, its losses
    over ``STEPS`` steps and its final fp32 masters. One engine a
    configuration for the module."""
    import deepspeed_tpu
    from deepspeed_tpu.models import build_model as jax_build_model

    _one_device()
    preset, mkw = MODELS[name]
    jeng = deepspeed_tpu.initialize(model=jax_build_model(preset, **mkw, dropout=dropout),
                                    config=config({"device": "cpu"}))[0]
    tree = _jax_initial_params(jeng)
    losses = [float(jeng.train_batch(iter([b]))) for b in batches()]
    return tree, losses, [np.array(m) for m in jeng.adam_state.master], jeng.store.max_live_groups


def streamed(name, offload_param=None, tree=None, **kw):
    dropout = kw.pop("dropout", 0.0)
    if tree is None:
        tree = jax_run(name)[0]
    return deepspeed_tpu_torch.initialize(
        model=port_model(name, tree, dropout=dropout),
        config=config(offload_param or {"device": "cpu"}, **kw), device="cpu")[0]


def run(engine, bs):
    return [float(engine.train_batch(iter([b]))) for b in bs]


@pytest.mark.parametrize("name", list(MODELS))
def test_streamed_matches_the_jax_streamed_engine(name):
    tree, want, masters, jax_live = jax_run(name)
    eng = streamed(name, tree=tree)
    assert isinstance(eng, StreamedZeroEngine)
    got = run(eng, batches())
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert len(eng.adam_state.master) == len(masters)
    for a, b in zip(eng.adam_state.master, masters):
        np.testing.assert_allclose(a, b, **PARAM_TOL)
    assert eng.store.max_live_groups <= 2 and jax_live <= 2
    assert eng.global_steps == STEPS and eng.global_samples == STEPS * MB


def test_streamed_cpu_matches_resident():
    tree = jax_run("gpt2")[0]
    got = run(streamed("gpt2", tree=tree), batches())
    ref = deepspeed_tpu_torch.initialize(
        model=port_model("gpt2"), model_parameters=params_from_jax(tree),
        config=config(zero_optimization={"stage": 0, "offload_optimizer": {"device": "cpu"}}),
        device="cpu")[0]
    want = []
    for b in batches():
        loss = ref(b)
        ref.backward(loss)
        ref.step()
        want.append(float(loss.detach()))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_streamed_nvme_bitwise_cpu(tmp_path):
    cpu = streamed("gpt2")
    nv = streamed("gpt2", {"device": "nvme", "nvme_path": str(tmp_path)})
    files = [f for f in os.listdir(tmp_path) if f.startswith("param_group")]
    assert sorted(files) == [f"param_group_{i}.bin" for i in range(1 + 4)]  # stem + layers
    assert run(nv, batches()) == run(cpu, batches())
    for a, b in zip(nv.adam_state.master, cpu.adam_state.master):
        assert np.array_equal(a, b)
    # a layer's file holds its master's words (fp32 compute), sorted leaves back to back
    nv.store.close()
    words = np.fromfile(os.path.join(tmp_path, "param_group_1.bin"), np.float32)
    g = nv._groups[1]
    assert np.array_equal(words, np.concatenate([g[k].reshape(-1) for k in sorted(g)]))


def test_requires_stage3_and_refuses_what_the_jax_engine_refuses():
    import deepspeed_tpu
    from deepspeed_tpu.models import build_model as jax_build_model

    preset, mkw = MODELS["gpt2"]
    cfg = config({"device": "cpu"}, stage=1)
    with pytest.raises(ValueError, match="stage 3") as got:
        deepspeed_tpu_torch.initialize(model=port_model("gpt2"), config=cfg, device="cpu")
    _one_device()
    with pytest.raises(ValueError, match="stage 3") as want:
        deepspeed_tpu.initialize(model=jax_build_model(preset, **mkw), config=cfg)
    assert str(got.value) == str(want.value)
    params = port_model("gpt2").init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match=r"\['model_parameters'\]"):
        deepspeed_tpu_torch.initialize(model=port_model("gpt2"), model_parameters=params,
                                       config=config({"device": "cpu"}), device="cpu")


def test_gas2_matches_resident_gas2():
    tree = jax_run("gpt2")[0]
    micros = batches(2 * STEPS, seed=5)
    eng = streamed("gpt2", tree=tree, gas=2)
    it = iter(list(micros))
    got = [float(eng.train_batch(it)) for _ in range(STEPS)]
    ref = deepspeed_tpu_torch.initialize(
        model=port_model("gpt2"), model_parameters=params_from_jax(tree),
        config=config(gas=2, zero_optimization={"stage": 0, "offload_optimizer": {
            "device": "cpu"}}), device="cpu")[0]
    it = iter(list(micros))
    want = [float(ref.train_batch(it)) for _ in range(STEPS)]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert eng.micro_steps == 2 * STEPS and eng.global_steps == STEPS


def test_dropout_masks_are_the_jax_streamed_engines(monkeypatch):
    import jax

    tree, want, _, _ = jax_run("gpt2", dropout=0.1)
    eng = streamed("gpt2", tree=tree, dropout=0.1, gas=2)
    keys = []
    real = eng.model._block

    def recording(x, blk, positions, rng=None, train=False):
        keys.append(rng.clone())
        return real(x, blk, positions, rng=rng, train=train)

    monkeypatch.setattr(eng.model, "_block", recording)
    eng.train_batch(iter(batches(2)))
    L, seed = 4, eng.config.seed  # the config's default, 1234 in both packages
    # the forward's L draws, then the recompute's L in reverse, a micro-step
    for m in range(2):
        base = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), m), m)
        want_keys = [np.asarray(jax.random.fold_in(base, i)).astype(np.int64)
                     for i in range(L)]
        got = keys[2 * L * m: 2 * L * (m + 1)]
        for i in range(L):
            assert np.array_equal(got[i].numpy(), want_keys[i])
            assert np.array_equal(got[2 * L - 1 - i].numpy(), want_keys[i])
    # layer 0's first mask (the attention output's), bitwise jax.random's
    _, r1 = jax.random.split(jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(seed), 0), 0), 0))
    shape = (MB, SEQ, MODELS["gpt2"][1]["hidden_size"])
    mask = prng.bernoulli(prng.split(keys[0])[1], 0.9, shape)
    assert np.array_equal(mask.numpy(), np.asarray(jax.random.bernoulli(r1, 0.9, shape)))
    # the whole run against the JAX streamed engine with dropout
    eng = streamed("gpt2", tree=tree, dropout=0.1)
    np.testing.assert_allclose(run(eng, batches()[:3]), want[:3], rtol=1e-5)


def test_async_writeback_overlaps_and_is_correct(tmp_path):
    eng = streamed("gpt2", {"device": "nvme", "nvme_path": str(tmp_path)})
    losses, saw_inflight = [], False
    for b in batches():
        losses.append(float(eng.train_batch(iter([b]))))
        saw_inflight |= eng.store.writes_in_flight > 0
    assert saw_inflight, "writeback never overlapped"
    assert losses == run(streamed("gpt2"), batches())


@pytest.mark.parametrize("tier", ["cpu", "nvme"])
def test_state_dict_round_trip(tier, tmp_path):
    off = ({"device": "cpu"} if tier == "cpu"
           else {"device": "nvme", "nvme_path": str(tmp_path / "a")})
    a = streamed("gpt2", off)
    bs = batches(4)
    run(a, bs[:2])
    sd = a.state_dict()
    if tier == "nvme":
        off = dict(off, nvme_path=str(tmp_path / "b"))
    b = deepspeed_tpu_torch.initialize(model=port_model("gpt2"), config=config(off),
                                       device="cpu")[0]  # other weights: seed 0's draw
    assert not all(np.array_equal(x, y) for x, y in
                   zip(b.adam_state.master, a.adam_state.master))
    b.load_state_dict(sd)
    assert b.global_steps == 2 and b.adam_state.step_count == 2
    assert run(b, bs[2:]) == run(a, bs[2:])
    for x, y in zip(b.adam_state.master, a.adam_state.master):
        assert np.array_equal(x, y)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["cpu", "nvme"])
def test_cuda_streamed_small_vs_cpu_twin(tier, cuda, tmp_path):
    """A llama at hidden 256 (hd 64), 3 layers, fp32, 3 steps of 2 x 128
    tokens on the card against the same engine on the CPU: losses at rtol
    1e-5, masters at atol 1e-5 (the flash kernel's sums run in another
    order than the CPU's plain attention). Adam's eps 1e-6, as in
    ``chip_smoke.py`` phase b: Adam's first steps divide each gradient by
    its own magnitude, so at eps 1e-8 a tiny gradient's last-bit difference
    flips its update's sign."""
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    model_kw = dict(vocab_size=512, hidden_size=256, num_layers=3, num_heads=4,
                    num_kv_heads=2, intermediate_size=512, max_seq_len=128)
    rng = np.random.default_rng(3)
    bs = [{"input_ids": rng.integers(0, 512, (2, 128), dtype=np.int32)} for _ in range(3)]
    # one draw for both engines (each would draw on its own device's generator)
    weights = build_model("llama-tiny", **model_kw).init_params(torch.Generator().manual_seed(0))
    engines = []
    for dev in ("cpu", cuda):
        off = ({"device": "cpu"} if tier == "cpu"
               else {"device": "nvme", "nvme_path": str(tmp_path / str(dev))})
        cfg = config(off, optimizer={"type": "adamw", "params": {"lr": LR, "eps": 1e-6}})
        model = build_model("llama-tiny", **model_kw)
        model.init_params = lambda *a, **k: tree_map(lambda t: t.clone(), weights)
        engines.append(deepspeed_tpu_torch.initialize(model=model, config=cfg, device=dev)[0])
    f0, b0 = fa.fwd_launches, fa.bwd_launches
    got = run(engines[1], bs)
    assert (fa.fwd_launches - f0, fa.bwd_launches - b0) == (2 * 3 * 3, 3 * 3)
    np.testing.assert_allclose(got, run(engines[0], bs), rtol=1e-5)
    for a, b in zip(engines[1].adam_state.master, engines[0].adam_state.master):
        np.testing.assert_allclose(a, b, atol=1e-5)
    assert engines[1].store.max_live_groups <= 2
    for e in engines:
        e.close()
