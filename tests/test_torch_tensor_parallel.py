"""Tensor parallelism in training: ``deepspeed_tpu_torch.initialize`` over a ``model`` axis, on the CPU.

Two and four gloo rank processes (``tests/torch_multirank.py``: module
fixtures start them once, torch on one thread each) train a micro llama
(hidden 64, 4 heads, 2 KV heads, 2 layers, vocab 512, S 32) and, for the
tied vocabulary-parallel embedding and the column-parallel MLP bias, the
JAX ZeRO++ test's micro gpt2, in fp32 from the JAX package's
``init_params(PRNGKey(0))`` weights, each rank given the global batch of 8
sequences a step:

- against JAX: the JAX engine on its 8-device ``{"data": 4, "model": 2}``
  mesh (the same mean-gradient math as any data degree; GSPMD places its
  TP collectives where the port runs Megatron's) with the same batches:
  TP 2 and data 2 x model 2 at ZeRO stages 0-3 give its losses and
  gradient norms at rtol 1e-5 and its masters after 3 steps at atol 1e-5
  (a row-parallel all-reduce sums the partial products in another order,
  so TP = N is not bitwise TP = 1, as ``tests/unit/test_state_dict_factory.py:79-81``
  says of GSPMD);
- bitwise: data 2 x model 2 at stages 1-3 give stage 0's losses and masters
  bit for bit, a run repeats bit for bit, the TP ranks' replicated leaves
  (norm scales, and gpt2's biases and positions) are equal after every
  step, and the dropout masks every TP rank draws are jax's;
- clipping (in every run above: clip 0.5 under the norms' values) and the
  fp16 loss scale: an fp16 run skips the steps the JAX engine skips with
  the same scales, and an overflow on one TP rank skips the step on all;
- ZeRO++ qwZ and qgZ at stage 3 with data 2 x model 2, held to the JAX
  ``test_zeropp.py:67,136`` checks (the first loss within 5% + 0.05 of the
  unquantized run's, and the curve trains);
- checkpoints: a tag saved at data 2 x model 2 loads at one process, at
  model 4 and in the JAX engine with every master and moment bitwise, and a
  JAX tag loads at data 2 x model 2 bitwise;
- ``mpu`` accepted; a model axis the heads, the KV heads or the world do
  not divide raises ``ValueError``.

A ``cuda``-marked test holds the kernels of this slice's path at a TP
rank's shapes of llama-7b to their plain versions on the card.

Adam's eps is 1e-6, as in ``test_torch_zero_multirank.py``.
"""

import functools
import os

import numpy as np
import pytest
import torch

from tests.torch_multirank import (Ranks, dropout_masks, tp_checkpoint, tp_layout_is_the_models,
                                   tp_refusal, tp_train)

PRESET = "llama-tiny"
MODEL_KW = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                intermediate_size=128, max_seq_len=32)
GPT2_KW = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=32)
S, ROWS, STEPS = 32, 8, 3
JAX_MESH = {"data": 4, "model": 2}
CLIP = 0.5
#: four KV heads, so that a model axis of 4 divides them
MK4 = dict(MODEL_KW, num_kv_heads=4)


def _config(stage=0, mesh=None, **kw):
    zero = {"stage": stage, "stage3_param_persistence_threshold": 0} if stage == 3 else {
        "stage": stage}
    cfg = {"train_batch_size": ROWS, "gradient_clipping": CLIP,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1,
                                                     "eps": 1e-6}},
           "zero_optimization": zero, "steps_per_print": 0, "seed": 0}
    if mesh is not None:
        cfg["mesh"] = dict(mesh)
    for k, v in kw.items():
        cfg[k] = dict(zero, **v) if k == "zero_optimization" else v
    return cfg


def _batches(n=3, seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, (ROWS, S)).astype(np.int32)}
            for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _jax_params(preset=PRESET, kw=tuple(sorted(MODEL_KW.items()))):
    import jax

    from deepspeed_tpu.models import build_model

    jm = build_model(preset, **dict(kw))
    return jm, jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))


def _gpt2():
    return "gpt2-125m", GPT2_KW, _jax_params("gpt2-125m", tuple(sorted(GPT2_KW.items())))[1]


def _leaves(tree):
    from deepspeed_tpu_torch.utils.tree import tree_leaves

    return list(tree_leaves(tree))


def _bitwise(a, b):
    return all(np.array_equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    r = Ranks(2, tmp_path_factory.mktemp("tp2"))
    yield r
    r.close()


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    r = Ranks(4, tmp_path_factory.mktemp("tp4"))
    yield r
    r.close()


@pytest.fixture(scope="module")
def runs(ranks2, ranks4):
    """Runs by (preset, mesh, stage, extra), each made once for the module."""
    cache = {}

    def get(mesh, stage=0, preset=PRESET, steps=STEPS, inject=None, **extra):
        key = (preset, tuple(sorted(mesh.items())), stage, repr(sorted(extra.items())), inject)
        if key not in cache:
            ranks = ranks4 if int(np.prod(list(mesh.values()))) == 4 else ranks2
            mkw, params = ((MODEL_KW, _jax_params()[1]) if preset == PRESET
                           else _gpt2()[1:])
            vocab = mkw["vocab_size"]
            cache[key] = ranks.run(tp_train, preset, mkw, _config(stage, mesh, **extra),
                                   params, _batches(vocab=vocab), steps, inject)
        return cache[key]

    return get


@functools.lru_cache(maxsize=None)
def _jax_run(preset=PRESET, fp16=False):
    """The JAX engine at ``JAX_MESH`` over the same batches: losses, grad
    norms, masters, scales, skipped steps."""
    import jax

    import deepspeed_tpu

    if preset == PRESET:
        jm, params = _jax_params()
        vocab = MODEL_KW["vocab_size"]
    else:
        jm, params = _jax_params(preset, tuple(sorted(GPT2_KW.items())))
        vocab = GPT2_KW["vocab_size"]
    extra = {"fp16": {"enabled": True, "initial_scale_power": 24}} if fp16 else {}
    jeng = deepspeed_tpu.initialize(model=jm, model_parameters=params,
                                    config=_config(2, JAX_MESH, **extra))[0]
    assert jeng.topology.model_parallel_size == 2
    batches = _batches(vocab=vocab)
    losses, norms, scales = [], [], []
    for i in range(STEPS):
        losses.append(float(jeng.train_batch(iter([batches[i % len(batches)]]))))
        norms.append(float(jeng.get_global_grad_norm()))
        scales.append(float(jeng.loss_scale()) if hasattr(jeng, "loss_scale")
                      else float(jeng.scaler_state.cur_scale))
    return {"losses": losses, "norms": norms, "scales": scales,
            "skipped": jeng.skipped_steps, "master": jax.tree.map(np.asarray, jeng.params)}


def _assert_close_to_jax(got, want):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=1e-5)
    assert all(n > CLIP for n in want["norms"])  # the clip acted
    for a, b in zip(_leaves(got["master"]), _leaves(want["master"])):
        np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.mark.parametrize("mesh,stage", [({"model": 2}, 0), ({"data": 2, "model": 2}, 0),
                                        ({"data": 2, "model": 2}, 1),
                                        ({"data": 2, "model": 2}, 2),
                                        ({"data": 2, "model": 2}, 3)],
                         ids=["tp2-s0", "dp2tp2-s0", "dp2tp2-s1", "dp2tp2-s2", "dp2tp2-s3"])
def test_matches_jax_engine_at_its_mesh(runs, mesh, stage):
    outs = runs(mesh, stage)
    _assert_close_to_jax(outs[0], _jax_run())
    assert outs[0]["losses"][-1] < outs[0]["losses"][0]
    # every rank gathers the same global parameters after every step
    assert all(o["states"] == outs[0]["states"] for o in outs)


def test_gpt2_tied_vocab_parallel_head_matches_jax(runs):
    """gpt2: the tied ``wte`` is vocabulary-parallel in the embedding and
    the head, ``mlp_up_bias`` column-parallel, the LayerNorm biases and
    ``wpe`` replicated."""
    outs = runs({"model": 2}, 0, preset="gpt2-125m")
    _assert_close_to_jax(outs[0], _jax_run("gpt2-125m"))
    assert outs[0]["repl"] == outs[1]["repl"]


def test_tp_matches_one_process_and_halves_the_parameters(runs):
    """TP 2 against one process on the same global batch: the same
    function summed in another order; each rank holds its shards of the
    sharded leaves and the replicated ones whole."""
    one = tp_train(0, PRESET, MODEL_KW, _config(0), _jax_params()[1], _batches(), STEPS)
    tp = runs({"model": 2}, 0)
    np.testing.assert_allclose(tp[0]["losses"], one["losses"], rtol=1e-5)
    for a, b in zip(_leaves(tp[0]["master"]), _leaves(one["master"])):
        np.testing.assert_allclose(a, b, atol=1e-5)
    params = _jax_params()[1]
    repl = sum(params[k].nbytes for k in ("lnf_scale",)) + sum(
        params["blocks"][k].nbytes for k in ("ln1_scale", "ln2_scale"))
    whole = sum(a.nbytes for a in _leaves(params))
    assert [o["param_bytes"] for o in tp] == [repl + (whole - repl) // 2] * 2
    assert [o["coords"]["model"] for o in tp] == [0, 1]
    # a rank's shards drawn alone are the whole draw's, cut
    from deepspeed_tpu_torch.models import build_model, tp_shard_params

    model = build_model(PRESET, **MODEL_KW)
    whole_t = model.init_params(torch.Generator().manual_seed(3))
    for r in range(2):
        drawn = model.init_params(torch.Generator().manual_seed(3), tp=(2, r))
        assert all(torch.equal(a, b) for a, b in zip(
            _leaves(drawn), _leaves(tp_shard_params(whole_t, model, 2, r))))


@pytest.mark.parametrize("mesh,stage", [({"model": 2}, 0), ({"data": 2, "model": 2}, 1),
                                        ({"data": 2, "model": 2}, 3)],
                         ids=["tp2-s0", "dp2tp2-s1", "dp2tp2-s3"])
def test_memory_estimate_takes_the_model_degree(runs, mesh, stage):
    """The engine's static-state estimate is the JAX preflight's function
    (``autotuning/autotuner.py:42``) at the mesh's ZeRO and model degrees."""
    from deepspeed_tpu.autotuning.autotuner import estimate_static_state_per_chip

    n = sum(a.size for a in _leaves(_jax_params()[1]))
    dp = mesh.get("data", 1)
    want = estimate_static_state_per_chip(n, stage, zero_degree=dp, mp=2, dtype_bytes=4,
                                          weight_shard_degree=dp, has_master=False)
    assert [o["static_state_bytes"] for o in runs(mesh, stage)] == [want] * (2 * dp)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_zero_stages_under_tp_give_stage0_bitwise(runs, stage):
    base, got = runs({"data": 2, "model": 2}, 0), runs({"data": 2, "model": 2}, stage)
    assert got[0]["losses"] == base[0]["losses"]
    assert _bitwise(got[0]["master"], base[0]["master"])


def test_replicated_leaves_bitwise_across_tp_ranks_and_runs_repeat(runs, ranks4):
    """The TP ranks of one data coordinate (consecutive ranks) hold their
    replicated leaves bit for bit equal after every step; a second run of
    the same configuration repeats the first bit for bit."""
    for stage in (0, 3):
        outs = runs({"data": 2, "model": 2}, stage)
        assert [o["coords"]["model"] for o in outs] == [0, 1, 0, 1]
        assert outs[0]["repl"] == outs[1]["repl"] and outs[2]["repl"] == outs[3]["repl"]
        assert len(outs[0]["repl"]) == STEPS and outs[0]["repl"][0] != outs[0]["repl"][-1]
    again = ranks4.run(tp_train, PRESET, MODEL_KW, _config(3, {"data": 2, "model": 2}),
                       _jax_params()[1], _batches(), STEPS)
    first = runs({"data": 2, "model": 2}, 3)
    assert again[0]["losses"] == first[0]["losses"]
    assert _bitwise(again[0]["master"], first[0]["master"])


def test_dropout_masks_are_jax_on_every_tp_rank(ranks2):
    """Dropout acts on the replicated (B, S, H) tensors after the
    all-reduces: both TP ranks draw the JAX chain's masks for step 0
    (``split(fold_in(PRNGKey(0), 0), L)``, per layer ``split`` into
    ``(r_drop, r_pld)``, then one ``split`` each for the attention output
    and the MLP)."""
    import jax

    mk = dict(MODEL_KW, dropout=0.1)
    batch = _batches(1)[0]
    outs = ranks2.run(dropout_masks, PRESET, mk, _config(0, {"model": 2}), _jax_params()[1],
                      batch)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    want = []
    for r in jax.random.split(key, MODEL_KW["num_layers"]):
        rng = jax.random.split(r)[0]
        for _ in range(2):
            rng, sub = jax.random.split(rng)
            want.append(np.asarray(jax.random.bernoulli(sub, 0.9, (ROWS, S, 64))))
    for o in outs:
        assert len(o) == len(want)
        for a, b in zip(o, want):
            np.testing.assert_array_equal(a, b)


def test_fp16_scale_agrees_with_jax_and_one_ranks_overflow_skips_all(runs):
    """fp16 from a loss scale of 2**24: the TP 2 run skips the steps and
    moves the scale as the JAX engine does; an infinite loss on TP rank 1
    at step 1 skips that step on both ranks."""
    fp16 = {"enabled": True, "initial_scale_power": 24}
    got = runs({"model": 2}, 0, fp16=fp16)
    want = _jax_run(fp16=True)
    assert got[0]["skipped"] == want["skipped"] > 0
    assert got[0]["scales"] == want["scales"]
    bad = runs({"model": 2}, 0, fp16={"enabled": True, "initial_scale_power": 8},
               inject=(1, 1))
    assert [o["skipped"] for o in bad] == [1, 1]
    assert bad[0]["states"][1] == bad[0]["states"][0] != bad[0]["states"][2]
    assert bad[0]["scales"] == bad[1]["scales"] and bad[0]["repl"] == bad[1]["repl"]


@pytest.mark.parametrize("quant", [{"zero_quantized_weights": True},
                                   {"zero_quantized_gradients": True}], ids=["qwz", "qgz"])
def test_zeropp_at_stage3_with_tp(runs, quant):
    """``tests/unit/test_zeropp.py:67,136``: qwZ and qgZ with data 2 x model
    2 at stage 3, the first loss within 5% + 0.05 of the unquantized run's,
    finite, and the curve trains."""
    ref = runs({"data": 2, "model": 2}, 3)[0]["losses"]
    got = runs({"data": 2, "model": 2}, 3, steps=5, zero_optimization=quant)
    losses = got[0]["losses"]
    assert abs(losses[0] - ref[0]) < 0.05 * abs(ref[0]) + 0.05
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert got[0]["repl"] == got[1]["repl"]


def _assert_state(a, b):
    assert a["step"] == b["step"]
    for k in ("master", "m", "v"):
        assert _bitwise(a[k], b[k]), k


def test_checkpoints_cross_tp_degrees_and_packages(ranks4, tmp_path):
    """A data 2 x model 2 stage-2 tag (global leaves, a moment file a data
    rank) at one process, at model 4 and in the JAX engine; a JAX tag at
    data 2 x model 2; every master and moment bitwise."""
    import jax

    import deepspeed_tpu

    jm, params = _jax_params(PRESET, tuple(sorted(MK4.items())))
    d = str(tmp_path / "tp")
    saved = ranks4.run(tp_checkpoint, PRESET, MK4, _config(2, {"data": 2, "model": 2}),
                       params, _batches(), 2, d)
    assert sorted(f for f in os.listdir(os.path.join(d, "global_step2"))
                  if f.endswith(".ckpt")) == [
        "model_states.ckpt", "optim_states.ckpt", "optim_states.shard00.ckpt",
        "optim_states.shard01.ckpt"]
    want = saved[0]["trained"]
    one = tp_checkpoint(0, PRESET, MK4, _config(2), params, _batches(), 0, load_dir=d)
    _assert_state(one["loaded"], want)
    tp4 = ranks4.run(tp_checkpoint, PRESET, MK4, _config(2, {"model": 4}), params, _batches(),
                     0, None, d)
    for o in tp4:
        _assert_state(o["loaded"], want)
    jeng = deepspeed_tpu.initialize(model=jm, model_parameters=params,
                                    config=_config(2, JAX_MESH))[0]
    jeng.load_checkpoint(d)
    get = functools.partial(jax.tree.map, np.asarray)
    _assert_state({"master": get(jeng.params), "m": get(jeng.opt_state.m),
                   "v": get(jeng.opt_state.v), "step": int(jeng.opt_state.step)}, want)
    jeng.train_batch(iter([_batches(seed=4)[0]]))
    dj = str(tmp_path / "jax")
    jeng.save_checkpoint(dj)
    back = ranks4.run(tp_checkpoint, PRESET, MK4, _config(2, {"data": 2, "model": 2}),
                      params, _batches(), 0, None, dj)
    jstate = {"master": get(jeng.params), "m": get(jeng.opt_state.m),
              "v": get(jeng.opt_state.v), "step": int(jeng.opt_state.step)}
    for o in back:
        _assert_state(o["loaded"], jstate)


def test_mpu_accepted_and_degrees_that_do_not_divide_raise(ranks2, monkeypatch):
    """``mpu`` is accepted and ignored with the JAX package's log message;
    a model axis above the world, or one the KV heads do not divide, raises
    ``ValueError`` naming what it shards."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import build_model, params_from_jax
    from deepspeed_tpu_torch.utils import logging as port_logging

    warned = []
    monkeypatch.setattr(port_logging.logger, "warning", lambda msg, *a, **k: warned.append(msg))
    model = build_model(PRESET, **MODEL_KW)
    eng = deepspeed_tpu_torch.initialize(model=model, model_parameters=params_from_jax(
        _jax_params()[1]), config=_config(0), mpu=object(), device="cpu")[0]
    assert eng._tp is None and np.isfinite(float(eng.train_batch(iter(_batches(1)))))
    assert any("mpu argument is accepted for parity but ignored" in m for m in warned)
    with pytest.raises(ValueError, match=r"world size 1 not divisible by model\(2\)"):
        deepspeed_tpu_torch.initialize(model=model, config=_config(0, {"model": 2}),
                                       device="cpu")
    mk = dict(MODEL_KW, num_kv_heads=1)
    jm, params = _jax_params(PRESET, tuple(sorted(mk.items())))
    for msg in ranks2.run(tp_refusal, PRESET, mk, _config(0, {"model": 2}), params):
        assert msg.startswith("ValueError") and "'blocks/wk'" in msg and "kv_heads=1" in msg
        assert "model degree of 2" in msg


def test_tp_layout_is_the_models_not_the_process(ranks2):
    """A model runs at the layout its engine gives it: the model a TP 2
    engine was built from still computes TP 1's loss over the whole tree in
    a process whose topology has a ``model`` axis, bitwise its loss before
    the engine; the engine's copy runs at (2, rank) and its loss is the
    JAX engine's within the TP tolerance."""
    jm, params = _jax_params()
    batch = _batches(1)[0]
    want = float(jm.apply(params, {"input_ids": batch["input_ids"]}, train=False))
    for rank, got in enumerate(ranks2.run(tp_layout_is_the_models, PRESET, MODEL_KW,
                                          _config(0, {"model": 2}), params, batch)):
        assert got["before"] == got["after"]
        assert got["model_tp"] == (1, 0) and got["engine_tp"] == (2, rank)
        assert got["topology_tp"] == 2
        np.testing.assert_allclose(got["tp"], want, rtol=1e-5)
        np.testing.assert_allclose(got["before"], want, rtol=1e-5)


@pytest.mark.cuda
def test_kernels_at_tp_rank_shapes_on_the_card():
    """The kernels this slice's path runs, at a TP 2 rank's shapes of
    llama-7b, against their plain versions on the card: the flash forward
    and backward at 16 of 32 heads (S 2048, bf16), the slot-cache forward
    at 16 heads (prefill and decode), and ``woq_matmul`` on the int8 code
    shards of ``wo`` (In 2048, Out 4096), ``wq`` (In 4096, Out 2048),
    ``w_up`` (In 4096, Out 5504) and ``w_down`` (In 5504, Out 4096, 43
    groups), at the decode rows (4) and the prefill's (512)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from deepspeed_tpu_torch.ops.quantizer import woq
    from deepspeed_tpu_torch.ops.quantizer.woq_gemm import woq_matmul, woq_matmul_plain
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    cuda = torch.device("cuda")
    g = torch.Generator(cuda).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda, dtype=torch.bfloat16)

    q, k, v = randn(1, 2048, 16, 128), randn(1, 2048, 16, 128), randn(1, 2048, 16, 128)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    rout, rlse = fa.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), rout.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=1e-3)
    do = randn(1, 2048, 16, 128)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=5e-2, rtol=5e-2)
    # the slot cache: the prefill (4 rows of 128 from 0), then decode (4
    # rows, one query each at offsets 128..131)
    ck, cv = randn(4, 160, 16, 128), randn(4, 160, 16, 128)
    for Sq, off in ((128, torch.zeros(4, device=cuda, dtype=torch.int32)),
                    (1, torch.arange(128, 132, device=cuda, dtype=torch.int32))):
        qd = randn(4, Sq, 16, 128)
        o1 = fa.flash_attention_fwd(qd, ck, cv, causal=True, q_offset=off)[0]
        o2 = fa.flash_attention_plain(qd, ck, cv, causal=True, q_offset=off)[0]
        torch.testing.assert_close(o1.float(), o2.float(), atol=2e-2, rtol=2e-2)
    for In, Out in ((2048, 4096), (4096, 2048), (4096, 5504), (5504, 4096)):
        w = 0.02 * torch.randn((In, Out), generator=g, device=cuda)
        codes, scale = woq.quantize_leaf(w, 8, 128)
        for rows in (4, 512):
            x = torch.randn((rows, In), generator=g, device=cuda, dtype=torch.bfloat16)
            # fp32 out from the same fp32 products: the smoke's WOQ_TOL
            torch.testing.assert_close(woq_matmul(x, codes, scale, 8),
                                       woq_matmul_plain(x, codes, scale, 8), atol=1e-4,
                                       rtol=1e-5)
