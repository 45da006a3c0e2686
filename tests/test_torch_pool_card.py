"""The engine pool on the card against the same pool on the CPU.

``cuda``-marked (they skip without a card): a tiny fp32 llama (head_dim
64, two replicas of a paged engine) serves two greedy and two sampled
requests through ``EnginePool`` with a request migrated mid-decode, and
through a ``DisaggPool`` (one prefill and one decode worker) whose every
request leaves its prefill worker by a KV handoff. On the card the paged
kernel runs (its launches counted, never the plain version); the streams
equal the CPU pool's, but where a stream turns at a draw whose top-2 margin
on the CPU engine's fp32 logits is under 1e-4 (the margin of ``gumbel + x``
for a sampled row, or a token at the nucleus edge). The card has no JAX:
run there with ``python -m pytest --noconftest -m cuda
tests/test_torch_pool_card.py``.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.models import build_model
from deepspeed_tpu_torch.ops.transformer import paged_attention as pa
from deepspeed_tpu_torch.serve import DisaggPool, EnginePool, SamplingParams
from deepspeed_tpu_torch.utils import prng
from tests.test_torch_prng import MARGIN, masked_rows

MODEL = dict(vocab_size=256, hidden_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
             intermediate_size=512, max_seq_len=256)
ENGINE = dict(paged=True, max_seqs=4, max_seq_len=256, prefill_chunk=32, block_size=16,
              token_budget=32, num_blocks=64, dtype=torch.float32)
SAMPLING = {3: dict(temperature=0.8, seed=3), 4: dict(temperature=1.0, top_k=20, seed=4)}


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pool's paged kernel has no CPU mode")
    return torch.device("cuda")


def _setup():
    model = build_model("llama-tiny", **MODEL)
    return model, model.init_params(torch.Generator().manual_seed(0))


def _run(model, params, device, disagg):
    cls = DisaggPool if disagg else EnginePool
    kw = {"roles": ["prefill", "decode"]} if disagg else {}
    engines = [InferenceEngineV2(model, params, device=device, **ENGINE) for _ in range(2)]
    pool = cls.build(lambda i: engines[i], 2, clock=_Clock(), sleep=lambda s: None,
                     age_weight=0.0, **kw)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, n).tolist() for n in (40, 70, 25, 50)]
    reqs = [pool.submit(p, max_new_tokens=12, uid=1 + i,
                        sampling=SamplingParams(**SAMPLING[1 + i]) if 1 + i in SAMPLING
                        else None)
            for i, p in enumerate(prompts)]
    moved = False
    while pool.step():
        r = reqs[1]
        if not disagg and not moved and len(r.tokens) >= 3 and not r.finished:
            pool.migrate(r.uid, 1 - pool.owner_of(r.uid))
            moved = True
    assert all(r.state.value == "done" for r in reqs)
    pm = dict(pool.metrics.pool)
    pool.close()
    return reqs, pm


def _margin(model, params, context, uid):
    eng = InferenceEngineV2(model, params, device="cpu", **ENGINE)
    lg = torch.from_numpy(np.asarray(eng.put([1], [list(context)])[1], np.float32))
    sp = SAMPLING.get(uid)
    if sp is None:
        top2 = lg.topk(2).values
        return float(top2[0] - top2[1]), False
    x, edge = masked_rows(lg[None], [sp["temperature"]], [sp.get("top_k", 0)], [1.0])
    key = prng.fold_in(prng.PRNGKey(sp["seed"]), len(context))
    top2 = (prng.gumbel(key, (lg.shape[-1],)) + x[0]).topk(2).values
    return float(top2[0] - top2[1]), bool(edge[0])


@pytest.mark.cuda
@pytest.mark.parametrize("disagg", [False, True], ids=["migration", "disagg-handoff"])
def test_cuda_pool_matches_cpu(disagg):
    dev = _card()
    model, params = _setup()
    cpu, cpu_pm = _run(model, params, "cpu", disagg)
    n0 = pa.launches
    card, card_pm = _run(model, params, dev, disagg)
    assert pa.launches > n0  # the paged kernel ran on the card
    if disagg:
        assert card_pm["handoffs_kv"] == card_pm["handoffs"] == len(card)
        assert cpu_pm["handoffs_kv"] == len(cpu)
    else:
        assert card_pm["migrations"] >= 1
    for c, g in zip(cpu, card):
        if c.tokens == g.tokens:
            continue
        i = next(k for k, (a, b) in enumerate(zip(c.tokens, g.tokens)) if a != b)
        margin, edge = _margin(model, params, c.prompt + c.tokens[:i], c.uid)
        assert margin < MARGIN or edge, (c.uid, i, margin, c.tokens, g.tokens)
