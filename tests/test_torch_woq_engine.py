"""The weight-only-quantized serving slice against the JAX package, on the CPU.

``quantize_model`` -> ``InferenceEngineV2(paged=True)`` -> ``put`` /
``decode_step``: the scenario of ``tests/test_torch_engine_v2.py`` (two
prompts prefilled over several token budgets, decode rounds, a request
arriving mid-stream that repeats a prompt: a full prefix hit and a
copy-on-write block copy) on the same quantized tree in both packages, the
port's carried across by ``params_from_jax``. fp32; logits at atol 1e-4
with the tokens fed in lockstep; greedy streams identical wherever the JAX
top-2 margin exceeds 1e-3. int8 in full, int6 and int4 through ``put`` and
a few decode steps; ``logits`` of both packages at atol 1e-4; the engine
keeps codes int8 and scales fp32 on its device.
"""

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.quantization import quantize_model as jax_quantize_model
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu_torch.inference.quantization import quantize_model
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.models import build_model, params_from_jax
from deepspeed_tpu_torch.ops.quantizer import woq_gemm

MODEL = ("llama-tiny", dict(vocab_size=256, hidden_size=128, num_layers=2,
                            num_heads=2, num_kv_heads=1, intermediate_size=256,
                            max_seq_len=256))
ENGINE = dict(max_seqs=4, max_seq_len=256, prefill_chunk=32, paged=True,
              block_size=16, token_budget=32, prefix_cache=True)
_rng = np.random.default_rng(0)
P1 = _rng.integers(0, 256, 32).tolist()   # two full blocks: a repeat is a full hit
P2 = _rng.integers(0, 256, 70).tolist()   # several budgets of prefill


@pytest.fixture(scope="module")
def models():
    jm = jax_build_model(MODEL[0], **MODEL[1])
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    return jm, params, build_model(MODEL[0], **MODEL[1])


def quantized(models, bits):
    """(JAX engine, port engine) over one ``quantize_model`` tree."""
    jm, params, tm = models
    _, jq = jax_quantize_model(jm, params, num_bits=bits, group_size=64)
    jq = jax.tree.map(np.asarray, jq)
    return (JaxEngine(jm, jq, dtype=np.float32, **ENGINE),
            InferenceEngineV2(tm, params_from_jax(jq), dtype=torch.float32, device="cpu",
                              **ENGINE))


def scenario(eng, greedy, steps=8, choices=None):
    """(records, choices): every put/decode_step result in order and the
    token fed for each (step, uid); ``choices`` replays another run's."""
    records, made = [], []
    it = iter(choices or ())

    def choose(out):
        toks = {u: (int(v) if greedy else int(np.argmax(v))) for u, v in sorted(out.items())}
        if choices is not None:
            toks = next(it)
        made.append(toks)
        return dict(toks)

    out = eng.put([1, 2], [P1, P2], greedy=greedy)
    records.append(out)
    for step in range(steps):
        toks = choose(out)
        if step == 3:  # arrival mid-stream, same prompt as uid 1
            arrived = eng.put([3], [P1], greedy=greedy)
            records.append(arrived)
            toks.update(choose(arrived))
        out = eng.decode_step(toks, greedy=greedy)
        records.append(out)
    return records, made


def assert_logits_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for uid in w:
            np.testing.assert_allclose(g[uid], np.asarray(w[uid], np.float32),
                                       atol=1e-4, rtol=0)


@pytest.mark.parametrize("bits,steps", [(8, 8), (6, 4), (4, 4)])
def test_woq_put_logits_match_jax(models, bits, steps):
    je, te = quantized(models, bits)
    jrec, jchoices = scenario(je, greedy=False, steps=steps)
    trec, _ = scenario(te, greedy=False, steps=steps, choices=jchoices)
    assert_logits_match(trec, jrec)
    if steps > 3:
        stats = te.prefix_cache_stats()
        assert stats["hits"] >= 1 and stats["cow_copies"] >= 1


def test_woq_greedy_streams_match_jax(models):
    je, te = quantized(models, 8)
    jrec, _ = scenario(je, greedy=False)
    margins = [min(float(np.diff(np.sort(v)[-2:])[0]) for v in rec.values())
               for rec in jrec[:-1]]
    je, _ = quantized(models, 8)
    _, jg = scenario(je, greedy=True)
    _, tg = scenario(te, greedy=True)
    n = next((i for i, m in enumerate(margins) if m <= 1e-3), len(margins))
    assert len(tg) == len(jg) == len(margins) and n > 0
    assert tg[:n] == jg[:n]


def test_woq_logits_match_jax(models):
    jm, params, tm = models
    _, jq = jax_quantize_model(jm, params, num_bits=8, group_size=64)
    ids = np.random.default_rng(3).integers(0, 256, (2, 24)).astype(np.int32)
    want = np.asarray(jm.logits(jq, ids))
    got = tm.logits(params_from_jax(jax.tree.map(np.asarray, jq)), torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_engine_keeps_quantized_storage_dtypes(models):
    _, params, tm = models
    _, qp = quantize_model(tm, params_from_jax(params), num_bits=8, group_size=64)
    eng = InferenceEngineV2(tm, qp, dtype=torch.bfloat16, device="cpu", **ENGINE)
    blocks = eng.params["blocks"]
    assert blocks["wq::q8"].dtype == torch.int8
    assert blocks["wq::scale"].dtype == torch.float32
    assert blocks["ln1_scale"].dtype == torch.bfloat16
    torch.testing.assert_close(blocks["wq::q8"], qp["blocks"]["wq::q8"], rtol=0, atol=0)
    before = woq_gemm.launches
    out = eng.put([1], [P1], greedy=True)
    assert 0 <= out[1] < 256 and woq_gemm.launches == before  # CPU: the plain version


def test_woq_training_raises_naming_roadmap_item(models):
    _, params, tm = models
    _, qp = quantize_model(tm, params_from_jax(params), num_bits=8, group_size=64)
    ids = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 14"):
        tm.apply(qp, {"input_ids": ids})


# ROADMAP.md Queue 3's repro of the quantized eval loss: the JAX package gives
# 6.295340538 (fp) and 6.295094967 (int8) on this model and batch
EVAL_MODEL = ("llama-tiny", dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
                                 num_kv_heads=2, intermediate_size=256))


@pytest.fixture(scope="module")
def eval_models():
    jm = jax_build_model(EVAL_MODEL[0], **EVAL_MODEL[1])
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    ids = np.random.default_rng(0).integers(0, 512, (2, 16)).astype(np.int32)
    return jm, params, build_model(EVAL_MODEL[0], **EVAL_MODEL[1]), ids


@pytest.mark.parametrize("bits", [8, 6, 4])
def test_woq_eval_loss_matches_jax(eval_models, bits):
    jm, params, tm, ids = eval_models
    _, jq = jax_quantize_model(jm, params, num_bits=bits, group_size=64)
    jq = jax.tree.map(np.asarray, jq)
    want = float(jm.apply(jq, {"input_ids": ids}, train=False))
    if bits == 8:
        assert abs(want - 6.295094967) <= 1e-6
    tq = params_from_jax(jq)
    got = float(tm.apply(tq, {"input_ids": torch.from_numpy(ids)}, train=False))
    assert abs(got - want) <= 1e-4, (got, want)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 14"):
        tm.apply(tq, {"input_ids": torch.from_numpy(ids)}, train=True)
