"""The v1 inference engine: ``deepspeed_tpu_torch.init_inference`` with tensor parallelism, on the CPU.

A micro llama (hidden 64, 8 heads, 4 KV heads, 2 layers, vocab 128, S 32)
from the JAX package's ``init_params(PRNGKey(0))`` weights serves in fp32
at ``tensor_parallel={"tp_size": N}`` for N = 1 (this process), 2 and 4
(gloo rank processes, ``tests/torch_multirank.py``, started once a module),
each rank given the whole tree and cutting its shards:

- greedy tokens equal the JAX engine's (``init_inference`` at tp_size 2 on
  the 8-device mesh) under the margin rule (ROADMAP "How a slice is
  tested", rule 2: exactly, up to the first position whose top-2 logit
  margin under the JAX model is below 1e-4), equal the port's at TP 1, and
  every rank emits the same stream (JAX ``test_inference.py:60``);
  sampled tokens (temperature, top-k, top-p under the threefry key chain)
  likewise; the prefill logits within atol 3e-5 of JAX's;
- int8 WOQ (group 32) at TP 2: the codes leaves sharded as the JAX
  engine's placement shards them (``quantized_tp_specs``), int8 kept, the
  greedy tokens JAX's WOQ engine's (JAX ``test_woq.py:86``); a tree whose
  ``w_down`` group count the degree does not divide raises ``ValueError``
  naming the leaf, where the JAX engine's placement refuses the same tree;
- ``state_dict_factory`` sets (JAX ``test_state_dict_factory.py:36-110``):
  written at degree 4, merged bit for bit, served at TP 2 bitwise the TP 2
  engine on the original weights, resharded offline, and crossing
  packages both ways with every leaf bitwise.
"""

import functools

import numpy as np
import pytest
import torch

from tests.torch_multirank import RankError, Ranks, tp_generate

PRESET = "llama-tiny"
MODEL_KW = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=8, num_kv_heads=4,
                intermediate_size=128, max_seq_len=32)
NEW = 8
GREEDY = dict(max_new_tokens=NEW, temperature=0.0)
SAMPLED = dict(max_new_tokens=NEW, temperature=0.8, top_k=20, top_p=0.9, seed=3)
MARGIN = 1e-4


def _prompts(seed=0):
    return np.random.default_rng(seed).integers(0, 128, (2, 8)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax(kw=tuple(sorted(MODEL_KW.items()))):
    import jax

    from deepspeed_tpu.models import build_model

    jm = build_model(PRESET, **dict(kw))
    return jm, jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _jax_quantized(kw=tuple(sorted(MODEL_KW.items()))):
    import jax

    from deepspeed_tpu.inference.quantization import quantize_model

    jm, params = _jax(kw)
    return jax.tree.map(np.asarray, quantize_model(jm, params, num_bits=8, group_size=32)[1])


@functools.lru_cache(maxsize=None)
def _jax_generate(kind):
    """The JAX engine at tp_size 2: (tokens, each generated position's
    top-2 logit margin under its own forward of the prompt and the tokens)."""
    import jax.numpy as jnp

    import deepspeed_tpu
    from deepspeed_tpu.comm import topology as topo_mod

    jm, params = _jax()
    if kind == "woq":
        params = _jax_quantized()
    topo_mod.reset_topology()
    eng = deepspeed_tpu.init_inference(jm, config={"tensor_parallel": {"tp_size": 2}},
                                       params=params, dtype="fp32")
    assert eng.topology.model_parallel_size == 2
    ids = jnp.asarray(_prompts())
    toks = np.asarray(eng.generate(ids, **(SAMPLED if kind == "sampled" else GREEDY)))
    lg = np.asarray(eng.forward(jnp.concatenate([ids, jnp.asarray(toks)], axis=1)))
    top2 = np.sort(lg[:, ids.shape[1] - 1:-1], axis=-1)[..., -2:]
    prefill = np.asarray(eng.forward(ids))
    topo_mod.reset_topology()
    return toks, top2[..., 1] - top2[..., 0], prefill


def _assert_margin_equal(got, want, margins):
    """Rows equal up to the first position whose margin is below
    ``MARGIN``: there a last-bit difference may pick the other token, and
    the rows diverge from it by design."""
    for g, w, m in zip(got, want, margins):
        low = np.nonzero(m < MARGIN)[0]
        n = len(w) if low.size == 0 else low[0]
        np.testing.assert_array_equal(g[:n], w[:n])
    assert (margins >= MARGIN).mean() > 0.5  # the rule leaves most positions checked


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    r = Ranks(2, tmp_path_factory.mktemp("inf2"))
    yield r
    r.close()


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    r = Ranks(4, tmp_path_factory.mktemp("inf4"))
    yield r
    r.close()


@pytest.fixture(scope="module")
def served(ranks2, ranks4):
    """Port runs by (tp, kind), each made once for the module: every rank's
    output."""
    cache = {}

    def get(tp, kind="greedy"):
        if (tp, kind) not in cache:
            params = _jax_quantized() if kind == "woq" else _jax()[1]
            gen = SAMPLED if kind == "sampled" else GREEDY
            args = (PRESET, MODEL_KW, params, tp, _prompts(), gen)
            if tp == 1:
                out = [tp_generate(0, *args, forward=True)]
            else:
                out = (ranks2 if tp == 2 else ranks4).run(tp_generate, *args, None, True)
            cache[(tp, kind)] = out
        return cache[(tp, kind)]

    return get


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_greedy_tokens_match_jax_and_tp1(served, tp):
    outs = served(tp)
    want, margins, prefill = _jax_generate("greedy")
    assert all(o["tp"] == tp for o in outs)
    for o in outs:  # every rank emits the same stream
        np.testing.assert_array_equal(o["tokens"], outs[0]["tokens"])
    _assert_margin_equal(outs[0]["tokens"], want, margins)
    _assert_margin_equal(outs[0]["tokens"], served(1)[0]["tokens"], margins)
    np.testing.assert_allclose(outs[0]["logits"], prefill, atol=3e-5)
    assert outs[0]["shapes"]["wq"] == (2, 64, 64 // tp)  # the rank's heads
    assert outs[-1]["shapes"]["w_down"] == (2, 128 // tp, 64)


@pytest.mark.parametrize("tp", [1, 2])
def test_sampled_tokens_match_jax(served, tp):
    outs = served(tp, "sampled")
    want, margins, _ = _jax_generate("sampled")
    for o in outs:
        np.testing.assert_array_equal(o["tokens"], outs[0]["tokens"])
    _assert_margin_equal(outs[0]["tokens"], want, margins)
    assert not np.array_equal(outs[0]["tokens"], served(tp)[0]["tokens"])


def test_woq_int8_at_tp2_shards_codes_and_matches_jax(served):
    outs = served(2, "woq")
    want, margins, _ = _jax_generate("woq")
    q = _jax_quantized()["blocks"]
    for o in outs:
        np.testing.assert_array_equal(o["tokens"], outs[0]["tokens"])
        assert o["dtypes"]["wq::q8"] == "torch.int8" and o["dtypes"]["wq::scale"] == "torch.float32"
        # column-parallel codes split on `out`, row-parallel ones on the groups
        assert o["shapes"]["wq::q8"] == q["wq::q8"].shape[:-1] + (q["wq::q8"].shape[-1] // 2,)
        ng = q["w_down::q8"].shape[1]
        assert o["shapes"]["w_down::q8"] == (2, ng // 2) + q["w_down::q8"].shape[2:]
        assert o["shapes"]["w_down::scale"][1] == ng // 2
    _assert_margin_equal(outs[0]["tokens"], want, margins)


def test_group_count_the_degree_does_not_divide_raises(ranks2):
    """``w_down`` of an MLP width of 96 in groups of 32 has 3 groups: a
    model degree of 2 shards the heads and ``w_up`` but not those groups."""
    import deepspeed_tpu
    from deepspeed_tpu.comm import topology as topo_mod

    kw = tuple(sorted(dict(MODEL_KW, intermediate_size=96).items()))
    qp = _jax_quantized(kw)
    assert qp["blocks"]["w_down::q8"].shape[1] == 3
    topo_mod.reset_topology()
    with pytest.raises(Exception):
        deepspeed_tpu.init_inference(_jax(kw)[0], config={"tensor_parallel": {"tp_size": 2}},
                                     params=qp, dtype="fp32")
    topo_mod.reset_topology()
    with pytest.raises(RankError, match=r"ValueError: tensor parallelism: leaf "
                                        r"'blocks/w_down::q8' has 3 along dimension 1"):
        ranks2.run(tp_generate, PRESET, dict(kw), qp, 2, _prompts(), GREEDY)


def test_mp_sets_merge_serve_reshard_and_cross_packages(ranks2, tmp_path):
    from deepspeed_tpu.runtime import state_dict_factory as jsdf
    from deepspeed_tpu_torch.models import build_model, params_from_jax
    from deepspeed_tpu_torch.runtime import state_dict_factory as sdf
    from deepspeed_tpu_torch.runtime.checkpoint_engine.native_checkpoint_engine import \
        NativeCheckpointEngine

    jm, params = _jax()
    model = build_model(PRESET, **MODEL_KW)
    tp = params_from_jax(params)
    d4, d2 = str(tmp_path / "mp4"), str(tmp_path / "mp2")
    sdf.save_mp_sharded(tp, model.tp_specs, 4, d4)
    assert sdf.detect_mp_degree(d4) == 4
    sd0 = NativeCheckpointEngine().load(f"{d4}/mp_rank_00_model_states.ckpt")
    assert sd0["shards"]["['blocks']['wq']"].shape == (2, 64, 16)
    assert int(sd0["axes"]["['blocks']['ln1_scale']"]) == -1
    merged = sdf.load_mp_merged(d4, tp)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(merged), _leaves(tp)))
    # served at TP 2 from the set: bitwise the TP 2 engine on the original weights
    args = (PRESET, MODEL_KW, params, 2, _prompts(), GREEDY)
    from_set = ranks2.run(tp_generate, *args, d4, True)
    direct = ranks2.run(tp_generate, *args, None, True)
    for a, b in zip(from_set, direct):
        np.testing.assert_array_equal(a["logits"], b["logits"])
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    # offline 4 -> 2, and the refusals
    sdf.reshard_mp_checkpoint(d4, d2, tp, model.tp_specs, 2)
    assert sdf.detect_mp_degree(d2) == 2
    assert all(torch.equal(a, b) for a, b in zip(_leaves(sdf.load_mp_merged(d2, tp)),
                                                 _leaves(tp)))
    big = build_model(PRESET, **dict(MODEL_KW, hidden_size=128)).init_params(
        torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="checkpoint shape"):
        sdf.load_mp_merged(d2, big)
    # across packages, both ways
    got = jsdf.load_mp_merged(d4, params)
    assert all(np.array_equal(np.asarray(a), b) for a, b in zip(_leaves(got), _leaves(params)))
    dj = str(tmp_path / "jax")
    jsdf.save_mp_sharded(params, jm.tp_specs, 4, dj)
    back = sdf.load_mp_merged(dj, tp)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(back), _leaves(tp)))
    import os

    os.unlink(f"{dj}/mp_rank_01_model_states.ckpt")
    with pytest.raises(FileNotFoundError, match="contiguous"):
        sdf.detect_mp_degree(dj)


def _leaves(tree):
    from deepspeed_tpu_torch.utils.tree import tree_leaves

    return list(tree_leaves(tree))
