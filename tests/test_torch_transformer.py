"""The port's ``TransformerLM.forward_paged`` against the JAX package's, on the CPU.

Same numpy inputs to both: the JAX parameters (with every norm scale and
bias perturbed, so the bias paths carry non-zero values), a random pool,
block tables and starts. fp32; logits at atol/rtol 1e-4, the written pool at
atol 1e-5 (block 0, the trash block that padding rows write, is excluded:
duplicate scatter targets have no defined winner in either package).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu_torch.models import (TransformerLM, build_model, llama_config,
                                        params_from_jax, sample_or_argmax)

MODELS = {
    # hd 64, so the JAX package's paged-kernel branch is reachable
    "llama": ("llama-tiny", dict(vocab_size=512, hidden_size=256, num_layers=2,
                                 num_heads=4, num_kv_heads=2,
                                 intermediate_size=512, max_seq_len=256)),
    "gpt2": ("gpt2-125m", dict(vocab_size=512, hidden_size=128, num_layers=2,
                               num_heads=2, max_seq_len=256)),
}
BS, MAXB = 16, 8


def _jax_params(model, seed=0):
    params = jax.tree.map(np.asarray, model.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        name = str(path[-1])
        if "scale" in name or "bias" in name:
            return (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, params)


def _inputs(cfg, B, S, seed=1):
    rng = np.random.default_rng(seed)
    NB = 1 + B * MAXB
    shape = (cfg.num_layers, cfg.kv_heads, NB, BS, cfg.head_dim)
    pool = (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))
    tables = np.zeros((B, MAXB), np.int32)
    perm = rng.permutation(np.arange(1, NB))
    starts = np.asarray([0, 5, 37, 70, 0][:B], np.int32)
    for b in range(B - 1):  # the last row is padding: all-zero table, start 0
        tables[b] = perm[b * MAXB:(b + 1) * MAXB]
    ids = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return ids, pool, tables, starts


@pytest.mark.parametrize("name,S,ragged,force_kernel", [
    ("llama", 1, False, False),
    ("llama", 1, False, True),   # JAX side through its Pallas kernel (interpret)
    ("llama", 5, True, False),
    ("gpt2", 1, False, False),
    ("gpt2", 5, True, False),
])
def test_forward_paged_matches_jax(name, S, ragged, force_kernel, monkeypatch):
    preset, kw = MODELS[name]
    jm = jax_build_model(preset, **kw)
    tm = build_model(preset, **kw)
    params = _jax_params(jm)
    B = 5
    ids, pool, tables, starts = _inputs(jm.config, B, S)
    n_valid = np.asarray([5, 3, 1, 4, 2], np.int32) if ragged else None
    logit_rows = np.asarray([2, 0, 3], np.int32) if ragged else None
    if force_kernel:
        monkeypatch.setenv("DSTPU_FORCE_PAGED_KERNEL", "1")
    ref, (rk, rv) = jm.forward_paged(
        params, jnp.asarray(ids), (jnp.asarray(pool[0]), jnp.asarray(pool[1])),
        jnp.asarray(tables), jnp.asarray(starts),
        n_valid=None if n_valid is None else jnp.asarray(n_valid),
        logit_rows=None if logit_rows is None else jnp.asarray(logit_rows))

    kv = (torch.from_numpy(pool[0].copy()), torch.from_numpy(pool[1].copy()))
    out = tm.forward_paged(
        params_from_jax(params), torch.from_numpy(ids), kv,
        torch.from_numpy(tables), torch.from_numpy(starts),
        n_valid=None if n_valid is None else torch.from_numpy(n_valid),
        logit_rows=None if logit_rows is None else torch.from_numpy(logit_rows))

    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    for got, want in zip(kv, (rk, rv)):
        np.testing.assert_allclose(got.numpy()[:, :, 1:], np.asarray(want)[:, :, 1:],
                                   atol=1e-5)


@pytest.mark.parametrize("preset,kw", list(MODELS.values()), ids=list(MODELS))
def test_init_params_matches_jax_leaves(preset, kw):
    jp = jax_build_model(preset, **kw).init_params(jax.random.PRNGKey(0))
    tp = build_model(preset, **kw).init_params(torch.Generator().manual_seed(0))
    jshapes = {k: tuple(v.shape) for k, v in jax.tree_util.tree_leaves_with_path(jp)
               for k in [jax.tree_util.keystr(k)]}
    flat = {}

    def walk(prefix, tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(f"{prefix}['{k}']", v)
            else:
                flat[f"{prefix}['{k}']"] = tuple(v.shape)

    walk("", tp)
    assert flat == jshapes


@pytest.mark.parametrize("field,value", [
    ("pos_embedding", "alibi"), ("norm_position", "post"), ("parallel_block", True),
    ("num_experts", 4), ("logit_softcap", 30.0), ("mlm_head", True),
    ("activation", "relu"), ("qkv_bias", True), ("embed_scale", 2.0),
])
def test_unported_branch_raises_naming_field_and_item(field, value):
    with pytest.raises(NotImplementedError, match=rf"{field}.*ROADMAP\.md Queue 1 item"):
        TransformerLM(llama_config("tiny", **{field: value}))


def test_sample_or_argmax_greedy_first_index_on_ties():
    lg = torch.tensor([[0.0, 3.0, 3.0, 1.0], [2.0, 2.0, 2.0, 2.0]])
    want = np.asarray(jnp.argmax(jnp.asarray(lg.numpy()), -1)).tolist()
    zeros = np.zeros(2, np.int32)
    for temps in (None, np.zeros(2, np.float32)):
        toks = sample_or_argmax(lg, zeros, zeros, temps, zeros, np.ones(2, np.float32))
        assert toks.dtype == torch.int32
        assert toks.tolist() == want
    # a sampled row beside a greedy one: the greedy row keeps its argmax
    toks = sample_or_argmax(lg, zeros, zeros, np.asarray([0.0, 0.7], np.float32), zeros,
                            np.ones(2, np.float32))
    assert toks[0] == want[0] and 0 <= int(toks[1]) < 4


def test_params_from_jax_bfloat16_and_woq_leaves():
    a = jnp.arange(6, dtype=jnp.float32).reshape(2, 3) / 7
    t = params_from_jax({"w": np.asarray(a.astype(jnp.bfloat16))})["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(a.astype(jnp.bfloat16).astype(jnp.float32)))
    codes = np.arange(-128, 128, dtype=np.int8).reshape(2, 128, 1)
    scale = np.full((2, 1, 1), 0.25, np.float32)
    q = params_from_jax({"wq::q8": codes, "wq::scale": scale})
    assert q["wq::q8"].dtype == torch.int8 and q["wq::scale"].dtype == torch.float32
    np.testing.assert_array_equal(q["wq::q8"].numpy(), codes)
    np.testing.assert_array_equal(q["wq::scale"].numpy(), scale)
    with pytest.raises(NotImplementedError, match="weight-only-quantized leaf"):
        params_from_jax({"wq::codes": np.zeros((2, 2), np.int8)})
