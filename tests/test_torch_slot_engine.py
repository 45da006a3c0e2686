"""The port's slot mode (``InferenceEngineV2(paged=False)``) against the JAX package's, on the CPU.

Both packages get the same fp32 weights (``params_from_jax``) and the same
calls. Held equal, at atol 2e-5 on fp32 logits and exactly on tokens:

- the model's cache path: ``forward_with_cache`` and
  ``forward_with_cache_all`` against the JAX model on the same cache, at
  per-row offsets (the JAX engine vmaps its scalar offset over slots; the
  port takes a (B,) tensor), with the written caches equal too;
- ``xla_attention`` with a (B,) ``q_offset`` and ``kv_rows`` against the JAX
  ``xla_attention`` row by row, and the flash kernel's plain version
  against both;
- the slot scenarios of the JAX package's ``tests/unit/test_inference_v2.py``:
  staggered requests, flush frees capacity, context overflow raises,
  greedy on device; paged against slot inside the port (as
  ``test_paged_matches_slot_engine``); the slot programs counted as the JAX
  engine counts its traces;
- decode computes every slot but writes only the fed ones: a live slot
  that is not fed keeps its cache bitwise;
- ``ContinuousBatchScheduler`` over slot engines, greedy streams and
  counters equal to the JAX scheduler's, with a priority preemption, and
  ``chunked_prefill=True`` refused as in the JAX package.

The ``cuda``-marked test holds the flash forward kernel with offsets and
``kv_rows`` against its plain version on the card. The card has no JAX:
this file imports it only inside the tests that use it, and runs there with
``python -m pytest --noconftest -m cuda tests/test_torch_slot_engine.py``.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.models import build_model, params_from_jax
from deepspeed_tpu_torch.ops.transformer import attention as att
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

MODEL = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
             intermediate_size=128, max_seq_len=128)
ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while the module runs (as the other serving files)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jax = pytest.importorskip("jax")
    from deepspeed_tpu.models import build_model as jax_build_model

    jm = jax_build_model("llama-tiny", **MODEL)
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    return jm, params, build_model("llama-tiny", **MODEL), params_from_jax(params)


def engines(models, **kw):
    from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine

    jm, params, tm, tparams = models
    return (JaxEngine(jm, params, dtype=np.float32, **kw),
            InferenceEngineV2(tm, tparams, dtype=torch.float32, device="cpu", **kw))


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# the model's cache path and attention with per-row offsets
# ---------------------------------------------------------------------------
def _cache(B, T, seed=0):
    cfg = build_model("llama-tiny", **MODEL).config
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, B, T, cfg.kv_heads, cfg.head_dim)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("S", [1, 5])
def test_forward_with_cache_matches_jax(models, S):
    import jax.numpy as jnp

    jm, params, tm, tparams = models
    B, T = 3, 32
    offs = np.array([0, 7, 20], np.int32)
    ids = np.random.default_rng(1).integers(0, 128, (B, S)).astype(np.int32)
    ck, cv = _cache(B, T)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    last = tm.forward_with_cache(tparams, torch.from_numpy(ids), (tk, tv),
                                 torch.from_numpy(offs))
    tk2, tv2 = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    full = tm.forward_with_cache_all(tparams, torch.from_numpy(ids), (tk2, tv2),
                                     torch.from_numpy(offs))
    assert torch.equal(tk, tk2) and torch.equal(tv, tv2)
    for b in range(B):  # the JAX model at row b's scalar offset
        jl, (jk, jv) = jm.forward_with_cache(
            params, jnp.asarray(ids[b:b + 1]), (jnp.asarray(ck[:, b:b + 1]),
                                                jnp.asarray(cv[:, b:b + 1])), int(offs[b]))
        jf, _ = jm.forward_with_cache_all(
            params, jnp.asarray(ids[b:b + 1]), (jnp.asarray(ck[:, b:b + 1]),
                                                jnp.asarray(cv[:, b:b + 1])), int(offs[b]))
        close(last[b].numpy(), jl[0])
        close(full[b].numpy(), jf[0])
        close(tk[:, b].numpy(), jk[:, 0])
        close(tv[:, b].numpy(), jv[:, 0])


def test_forward_with_cache_rows_active_and_n_valid(models):
    """``kv_rows`` runs a group of rows against their rows of a larger cache
    in place; ``active`` leaves an unfed row's cache bitwise; ``n_valid``
    projects each row's last valid position, as the JAX prefill keeps it."""
    _, _, tm, tparams = models
    ck, cv = _cache(4, 32, seed=2)
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 128, (2, 8)).astype(np.int32))
    offs, rows = torch.tensor([4, 10], dtype=torch.int32), torch.tensor([3, 1], dtype=torch.int32)
    nval = torch.tensor([8, 5], dtype=torch.int32)
    kv = (torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()))
    got = tm.forward_with_cache(tparams, ids, kv, offs, kv_rows=rows, n_valid=nval)
    for i, r in enumerate(rows.tolist()):
        one = (torch.from_numpy(ck[:, r:r + 1].copy()), torch.from_numpy(cv[:, r:r + 1].copy()))
        ref = tm.forward_with_cache_all(tparams, ids[i:i + 1], one, offs[i:i + 1])
        close(got[i].numpy(), ref[0, int(nval[i]) - 1].numpy())
        assert torch.equal(kv[0][:, r], one[0][:, 0]) and torch.equal(kv[1][:, r], one[1][:, 0])
    for r in (0, 2):  # rows no segment names are untouched
        assert np.array_equal(kv[0][:, r].numpy(), ck[:, r])
    kv = (torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()))
    tm.forward_with_cache(tparams, ids[:, :1].repeat(2, 1), kv, torch.tensor([3, 9, 0, 1]),
                          active=torch.tensor([1, 0, 1, 0], dtype=torch.int32))
    for r, fed in enumerate((True, False, True, False)):
        assert np.array_equal(kv[0][:, r].numpy(), ck[:, r]) != fed


def test_attention_with_row_offsets_and_rows_matches_jax():
    import jax.numpy as jnp

    jatt = pytest.importorskip("importlib").import_module(
        "deepspeed_tpu.ops.transformer.attention")
    rng = np.random.default_rng(4)
    B, Sq, Bkv, Skv, nh, kvh, hd = 3, 4, 5, 40, 4, 2, 16
    q = rng.standard_normal((B, Sq, nh, hd)).astype(np.float32)
    k = rng.standard_normal((Bkv, Skv, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((Bkv, Skv, kvh, hd)).astype(np.float32)
    offs, rows = np.array([0, 17, 36], np.int32), np.array([4, 0, 2], np.int32)
    got = att.xla_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            causal=True, q_offset=torch.from_numpy(offs), num_kv_groups=2,
                            kv_rows=torch.from_numpy(rows))
    plain, lse = fa.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                          torch.from_numpy(v), q_offset=torch.from_numpy(offs),
                                          num_kv_groups=2, kv_rows=torch.from_numpy(rows))
    for b in range(B):
        ref = jatt.xla_attention(jnp.asarray(q[b:b + 1]), jnp.asarray(k[rows[b]][None]),
                                 jnp.asarray(v[rows[b]][None]), causal=True,
                                 q_offset=int(offs[b]), num_kv_groups=2)
        close(got[b].numpy(), ref[0])
        close(plain[b].numpy(), ref[0])
        one = att.xla_attention(torch.from_numpy(q[b:b + 1]),
                                torch.from_numpy(k[rows[b]][None]),
                                torch.from_numpy(v[rows[b]][None]), q_offset=int(offs[b]),
                                num_kv_groups=2)
        assert torch.equal(got[b], one[0])  # a tensor offset is the int's mask, row by row
    assert lse.shape == (B, nh, Sq)


def test_flash_entry_refuses_offsets_with_gradients():
    q = torch.zeros(1, 8, 2, 64, requires_grad=True)
    k = torch.zeros(1, 8, 2, 64)
    with pytest.raises(NotImplementedError, match="backward"):
        fa.flash_attention(q, k, k, q_offset=torch.tensor([2], dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="backward"):
        fa.flash_attention(q, k, k, kv_rows=torch.tensor([0], dtype=torch.int32))
    with torch.no_grad():  # serving: the forward alone
        out = fa.flash_attention(q, k, k, q_offset=2)
    assert out.shape == q.shape


# ---------------------------------------------------------------------------
# the slot engine: ``tests/unit/test_inference_v2.py``'s scenarios
# ---------------------------------------------------------------------------
def test_staggered_requests_match_jax(models):
    je, te = engines(models, max_seqs=4, max_seq_len=64, prefill_chunk=16)
    rng = np.random.default_rng(0)
    prompts = {1: rng.integers(0, 128, (5,)).tolist(),
               2: rng.integers(0, 128, (23,)).tolist()}  # 23 > chunk: split prefill
    jo, to = je.put([1, 2], [prompts[1], prompts[2]]), te.put([1, 2], [prompts[1], prompts[2]])
    assert set(to) == set(jo) == {1, 2}
    for step in range(6):
        for u in jo:
            close(to[u], jo[u])
        toks = {u: int(np.argmax(jo[u])) for u in jo}
        if step == 2:  # uid 3 joins mid-stream
            p3 = rng.integers(0, 128, (9,)).tolist()
            j3, t3 = je.put([3], [p3]), te.put([3], [p3])
            close(t3[3], j3[3])
            toks[3] = int(np.argmax(j3[3]))
        jo, to = je.decode_step(toks), te.decode_step(toks)
        assert list(to) == list(jo)
    for u in jo:
        close(to[u], jo[u])
    for uid in (1, 2, 3):
        jd, td = je.state.seqs[uid], te.state.seqs[uid]
        assert (td.slot, td.seen_tokens) == (jd.slot, jd.seen_tokens)
    # the slot programs, counted as the JAX engine counts its traces
    prefill, decode = te._slot_program_counts()
    assert prefill == {S: f._cache_size() for S, f in je._prefill_fns.items()}
    assert decode == je._decode_fn._cache_size() == 1
    assert max(prefill.values()) <= 32


def test_flush_frees_capacity(models):
    je, te = engines(models, max_seqs=2, max_seq_len=32)
    for e in (je, te):
        e.put([1, 2], [[3, 4, 5], [6, 7]])
    assert not te.can_schedule(1) and not je.can_schedule(1)
    for e in (je, te):
        e.flush(1)
    assert te.can_schedule(1) and te.query() == je.query() == (1, 32)
    te.flush(1)  # unknown now: a counted no-op
    assert te.flush_noops == 1
    assert te.prefix_cache_stats() == je.prefix_cache_stats() == {}
    assert te.prefix_probe([1, 2, 3]) == 0 and te.preempt(2) == 0
    assert not te.export_ready(2) and te.export_swap(2) is None and not te.swap_out(2)


def test_context_overflow_raises(models):
    from deepspeed_tpu.resilience.errors import ContextOverflowError as JaxOverflow

    from deepspeed_tpu_torch.resilience.errors import ContextOverflowError

    je, te = engines(models, max_seqs=1, max_seq_len=16, prefill_chunk=16)
    with pytest.raises(JaxOverflow):
        je.put([1], [list(range(40))])
    with pytest.raises(ContextOverflowError):
        te.put([1], [list(range(40))])
    assert te.state.seqs[1].seen_tokens == je.state.seqs[1].seen_tokens == 16
    # a full slot refuses the next decode before touching any state
    with pytest.raises(ContextOverflowError):
        te.decode_step({1: 3})
    assert te.state.seqs[1].seen_tokens == 16


def test_greedy_on_device_matches_host_argmax_and_jax(models):
    je, te = engines(models, max_seqs=4, max_seq_len=64, prefill_chunk=16)
    _, _, tm, tparams = models
    tg = InferenceEngineV2(tm, tparams, dtype=torch.float32, device="cpu", max_seqs=4,
                           max_seq_len=64, prefill_chunk=16)
    rng = np.random.default_rng(9)
    prompts = {1: rng.integers(0, 128, (9,)).tolist(), 2: rng.integers(0, 128, (5,)).tolist()}
    jo, to = je.put([1, 2], list(prompts.values())), te.put([1, 2], list(prompts.values()))
    tg.put([1, 2], list(prompts.values()))
    for _ in range(3):
        toks = {u: int(np.argmax(v)) for u, v in to.items()}
        assert toks == {u: int(np.argmax(v)) for u, v in jo.items()}
        got = tg.decode_step(toks, greedy=True)
        jo, to = je.decode_step(toks), te.decode_step(toks)
        assert got == {u: int(np.argmax(v)) for u, v in to.items()}
    assert te._slot_program_counts()[1] == 1 and tg._slot_program_counts()[1] == 1


def test_paged_matches_slot_engine(models):
    """The same staggered workload through the port's paged and slot
    engines gives the same logits (atol 2e-4, as the JAX test)."""
    _, _, tm, tparams = models
    rng = np.random.default_rng(1)
    prompts = {1: rng.integers(0, 128, (5,)).tolist(), 2: rng.integers(0, 128, (23,)).tolist()}

    def run(paged):
        eng = InferenceEngineV2(tm, tparams, dtype=torch.float32, device="cpu", max_seqs=4,
                                max_seq_len=64, prefill_chunk=16, paged=paged, block_size=16)
        out = eng.put([1, 2], [prompts[1], prompts[2]])
        hist = [dict(out)]
        for _ in range(5):
            out = eng.decode_step({u: int(np.argmax(out[u])) for u in out})
            hist.append(dict(out))
        return hist

    for s, p in zip(run(False), run(True)):
        assert set(s) == set(p)
        for u in s:
            close(p[u], s[u], atol=2e-4)


def test_decode_leaves_unfed_slots_bitwise(models):
    """A live slot that is not fed this step (one mid-prefill under the
    scheduler) keeps its cache bitwise: its row computes at position 0 but
    writes nothing."""
    _, _, tm, tparams = models
    eng = InferenceEngineV2(tm, tparams, dtype=torch.float32, device="cpu", max_seqs=4,
                            max_seq_len=64, prefill_chunk=16)
    rng = np.random.default_rng(5)
    out = eng.put([1, 2, 3], [rng.integers(0, 128, n).tolist() for n in (7, 12, 30)])
    before = [c.clone() for c in eng.kv]
    slot2 = eng.state.seqs[2].slot
    eng.decode_step({u: int(np.argmax(out[u])) for u in (1, 3)})
    for c, b in zip(eng.kv, before):
        assert torch.equal(c[:, slot2], b[:, slot2])
        assert not torch.equal(c, b)  # the fed slots did write


def test_paged_only_calls_refuse(models):
    _, _, tm, tparams = models
    eng = InferenceEngineV2(tm, tparams, dtype=torch.float32, device="cpu", max_seqs=2,
                            max_seq_len=32)
    assert not eng.paged and eng.max_seqs == 2 and eng.block_mgr is None
    with pytest.raises(ValueError, match="paged-mode only"):
        eng.put([1], [[1, 2]], greedy=True)
    with pytest.raises(ValueError, match="paged-mode only"):
        eng.put([1], [[1, 2]], max_steps=1)
    eng.put([1], [[1, 2]])

    class Greedy:
        seed, temperature, top_k, top_p = 1, 0.0, 0, 1.0

    for call in (lambda: eng.set_sampling(1, Greedy()), lambda: eng.decode_multi({1: 3}, 1),
                 lambda: eng.verify_multi({1: 3}, {}), lambda: eng.decode_dispatch({1: 3}),
                 lambda: eng.rollback(1, 0), lambda: eng.commit_step(1)):
        with pytest.raises(ValueError, match="paged-mode only"):
            call()
    from deepspeed_tpu_torch.resilience.errors import EngineUsageError

    with pytest.raises(EngineUsageError, match="paged-mode only"):
        eng.import_swap(5, {})
    defaults = InferenceEngineV2(tm, tparams, dtype=torch.float32, device="cpu")
    assert defaults.max_seqs == 8 and defaults.kv[0].shape == (2, 8, 128, 2, 16)
    eng.rebuild()  # zeroed in place
    assert not eng.state.seqs and eng.kv[0].abs().sum() == 0


# ---------------------------------------------------------------------------
# the scheduler over slot engines
# ---------------------------------------------------------------------------
def test_scheduler_over_slot_engines_matches_jax(models):
    """Greedy streams and counters of ``ContinuousBatchScheduler`` over the
    two packages' slot engines, with a priority arrival that preempts a
    request (replayed on re-admission); ``chunked_prefill=True`` needs a
    paged engine in both packages."""
    import deepspeed_tpu.serve as js

    import deepspeed_tpu_torch.serve as ts
    from tests.test_torch_scheduler import Clock, _counters

    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, 128, n).tolist() for n in (12, 30, 7, 20)]
    runs = {}
    for kind, pkg, eng in zip(("jax", "torch"), (js, ts),
                              engines(models, max_seqs=3, max_seq_len=96, prefill_chunk=16)):
        with pytest.raises(ValueError, match="paged"):
            pkg.ContinuousBatchScheduler(eng, chunked_prefill=True)
        sched = pkg.ContinuousBatchScheduler(eng, clock=Clock(), sleep=lambda s: None)
        reqs = [sched.submit(p, max_new_tokens=8, uid=500 + i, priority=1)
                for i, p in enumerate(prompts[:3])]
        for _ in range(3):
            sched.step()
        reqs.append(sched.submit(prompts[3], max_new_tokens=8, uid=600, priority=100))
        sched.run_until_complete()
        sched.close()
        runs[kind] = ([r.tokens for r in reqs], [r.state.value for r in reqs],
                      sched.metrics.preemptions, _counters(sched, eng))
    assert runs["torch"] == runs["jax"]
    assert runs["torch"][2] >= 1 and set(runs["torch"][1]) == {"done"}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Bkv,Skv,nh,kvh,hd,offs,rows", [
    (4, 1, 4, 700, 8, 8, 128, [36, 299, 0, 650], None),          # decode rows
    (2, 64, 6, 600, 8, 4, 64, [64, 500], [5, 2]),                 # a chunk at an offset
    (3, 16, 3, 300, 4, 2, 32, [0, 100, 284], [2, 0, 1]),          # a 16-row bucket
    (2, 130, 2, 400, 4, 1, 256, [0, 270], None),                  # tail tiles
])
def test_cuda_offset_kernel_matches_plain(B, Sq, Bkv, Skv, nh, kvh, hd, offs, rows, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    q = torch.randn((B, Sq, nh, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((Bkv, Skv, kvh, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((Bkv, Skv, kvh, hd), generator=gen, device=dev).to(dtype)
    off = torch.tensor(offs, dtype=torch.int32, device=dev)
    kr = None if rows is None else torch.tensor(rows, dtype=torch.int32, device=dev)
    f0 = fa.fwd_launches
    out, lse = fa.flash_attention_fwd(q, k, v, num_kv_groups=nh // kvh, q_offset=off, kv_rows=kr)
    out2, lse2 = fa.flash_attention_fwd(q, k, v, num_kv_groups=nh // kvh, q_offset=off,
                                        kv_rows=kr)
    assert fa.fwd_launches == f0 + 2
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, num_kv_groups=nh // kvh, q_offset=off,
                                            kv_rows=kr)
    atol, rtol = (1e-5, 0) if dtype == torch.float32 else (1e-2, 1e-2)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=atol, rtol=rtol)
    # offset 0 and no rows: bitwise the plain causal call
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    kk, vv = (k, v) if rows is None else (k[kr.long()], v[kr.long()])
    base = fa.flash_attention_fwd(q, kk.contiguous(), vv.contiguous(), num_kv_groups=nh // kvh)
    same = fa.flash_attention_fwd(q, kk.contiguous(), vv.contiguous(), num_kv_groups=nh // kvh,
                                  q_offset=zero)
    assert torch.equal(base[0], same[0]) and torch.equal(base[1], same[1])
