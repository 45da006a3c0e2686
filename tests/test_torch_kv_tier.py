"""The port's KV tiers, swap preemption and KV handoff against the JAX package's, on the CPU.

The serving scenarios of the JAX package's ``tests/unit/test_kv_tier.py``
and ``TestServingNVMeTier`` (``tests/unit/test_transfer_engine.py``), each run
through both packages with the same fp32 weights (``params_from_jax``), the
same engine geometry and the same calls:

- a prefix demoted to the host tier by pool pressure promotes back and
  serves bitwise the logits of a cold untiered port engine (and the JAX
  engine's at atol 2e-5), with equal ``prefix_cache_stats``;
- ``swap_out`` / ``swap_in`` resume bitwise against a never-swapped twin;
  the swap edges refuse cleanly; ``rebuild`` and ``load_params`` drop both
  tiers and the swap store;
- the pressure workload (4 prompts, a 12-block pool) through
  ``ContinuousBatchScheduler`` in every ``swap_preemption`` mode, greedy and
  sampled: streams equal to the JAX package's and to the unpressured
  untiered baseline (inside the port bitwise, so swap and replay give the
  same tokens), and in the forced modes ``swap_stats``,
  ``prefix_cache_stats``, the scheduler's counters and the TransferEngine
  ledger equal to the JAX engine's; the tier off behaves as the untiered
  scheduler; an engine loss with a live swap entry replays bitwise;
- the NVMe tier: a prefix spilled device -> host -> disk promotes back
  bitwise with overlap on and off, and a corrupt block file degrades to
  recompute;
- the cross-package handoff: the JAX engine's ``export_swap`` payload lands
  through the port's ``import_swap`` / ``swap_in`` and continues to the JAX
  continuation's greedy tokens, and the reverse.

JAX engines are reused across tests of one geometry: rebuilt before each
use (compiling their programs is most of a run), with a fresh
TransferEngine and zeroed ``swap_stats``, which a rebuild keeps, so that
each run starts from a fresh engine's state.
- the tier sanitizer (``check_tier_conservation``): each planted violation
  of ``TestTierConservationSanitizer`` raises in both packages with the same
  message, and, armed (the module runs in checked mode), a planted leak
  surfaces from the port's scheduler step.

The pool's replica prefixes, the
router's probe, a swap-resident victim's migration and the rolling update
are in ``tests/test_torch_disagg_elastic.py``.
"""

import glob
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu.resilience.errors as jerr
import deepspeed_tpu.serve as js
import deepspeed_tpu_torch.resilience.errors as terr
import deepspeed_tpu_torch.serve as ts
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu.resilience import RetryPolicy as JaxRetryPolicy
from deepspeed_tpu.runtime.transfer_engine import TransferCorruptError as JaxCorruptError
from deepspeed_tpu.runtime.transfer_engine import TransferEngine as JaxTransferEngine
import deepspeed_tpu.analysis.sanitizer as jsan
import deepspeed_tpu.inference.v2.ragged_manager as jrm
import deepspeed_tpu_torch.analysis.sanitizer as tsan
import deepspeed_tpu_torch.inference.v2.ragged_manager as trm
from deepspeed_tpu_torch.analysis.sanitizer import check_transfer_ledger
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.models import build_model, params_from_jax
from deepspeed_tpu_torch.resilience.retry import RetryPolicy
from deepspeed_tpu_torch.runtime.transfer_engine import TransferCorruptError
from tests.test_torch_fused_decode import Injector
from tests.test_torch_scheduler import Clock, assert_same
from tests.torch_checked import checked_mode  # noqa: F401  (autouse: checked mode)

MODEL = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
             intermediate_size=128, max_seq_len=128)
ENGINE = dict(max_seqs=4, max_seq_len=128, prefill_chunk=16, block_size=16, token_budget=16,
              paged=True)
PKG = {"jax": (js, jerr, JaxRetryPolicy, JaxCorruptError),
       "torch": (ts, terr, RetryPolicy, TransferCorruptError)}
ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jm = jax_build_model("llama-tiny", **MODEL)
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    return jm, params, build_model("llama-tiny", **MODEL), params_from_jax(params)


_JAX = {}


def engine(kind, models, **kw):
    """A fresh port engine, or the JAX engine of this geometry rebuilt (a
    rebuild leaves a fresh engine's state and keeps the compiled programs)."""
    jm, params, tm, tparams = models
    opts = dict(ENGINE, **kw)
    if kind == "torch":
        return InferenceEngineV2(tm, tparams, dtype=torch.float32, device="cpu", **opts)
    key = tuple(sorted(opts.items()))
    eng = _JAX.get(key)
    if eng is None:
        eng = _JAX[key] = JaxEngine(jm, params, dtype=np.float32, **opts)
    else:
        eng.rebuild()
        nvme = eng.transfer.nvme
        eng.transfer = JaxTransferEngine(overlap=opts.get("transfer_overlap", True),
                                         nvme_dir=nvme.root if nvme else None)
        eng.swap_stats = dict.fromkeys(eng.swap_stats, 0)
    return eng


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def both(models, fn, **kw):
    """``fn(eng)`` on the JAX engine and a port engine of geometry ``kw``;
    returns ((engine, result, ledger) of each)."""
    je, te = engine("jax", models, **kw), engine("torch", models, **kw)
    jr, tr = fn(je), fn(te)
    return (je, jr, je.transfer.ledger()), (te, tr, te.transfer.ledger())


# ---------------------------------------------------------------------------
# the engine: demote / promote, swap round trips
# ---------------------------------------------------------------------------
def _prefix_workload(seed=7):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 128, 32).tolist(), rng.integers(0, 128, 128).tolist(),
            rng.integers(0, 128, 8).tolist())


def test_demoted_prefix_promotes_bitwise(models):
    a, big, tail = _prefix_workload()

    def run(eng):
        eng.put([1], [a], greedy=True)
        eng.flush(1)
        eng.put([2], [big], greedy=True)  # demotes a's chain
        eng.flush(2)
        demoted = eng.prefix_cache_stats()
        return demoted, eng.put([3], [a + tail])[3], eng.prefix_cache_stats()

    (je, (jd, jw, js_), jled), (te, (td, tw, ts_), tled) = both(
        models, run, num_blocks=9, host_tier_blocks=16)
    assert td["demoted_blocks"] >= 2 and td["host_blocks"] >= 2
    assert ts_["promoted_blocks"] >= 2 and ts_["skipped_prefill_tokens"] >= 32
    cold = engine("torch", models, num_blocks=9, host_tier_blocks=0)
    assert np.array_equal(tw, cold.put([3], [a + tail])[3])
    close(tw, jw)
    assert (td, ts_) == (jd, js_)
    assert tled == jled
    te.block_mgr.check_invariants(te.state.seqs.values())


def test_swap_roundtrip_resumes_bitwise(models):
    prompt = np.random.default_rng(8).integers(0, 128, 20).tolist()
    je = engine("jax", models, num_blocks=17, host_tier_blocks=8)
    te, twin = (engine("torch", models, num_blocks=17, host_tier_blocks=8) for _ in range(2))
    jw, w, t = je.put([1], [prompt]), te.put([1], [prompt]), twin.put([1], [prompt])
    for phase in range(2):
        for _ in range(3):
            tok = {1: int(np.argmax(w[1]))}
            assert tok == {1: int(np.argmax(jw[1]))}
            jw, w, t = je.decode_step(dict(tok)), te.decode_step(dict(tok)), \
                twin.decode_step(dict(tok))
            assert np.array_equal(w[1], t[1])
            close(w[1], jw[1])
        if phase == 0:
            assert te.swap_out(1) and je.swap_out(1)
            assert te.swap_resident(1) and 1 not in te.state.seqs
            s = te.prefix_cache_stats()
            assert s["swap_out"] == 1 and s["swap_out_bytes"] == 2 * te.block_bytes > 0
            assert te.swap_in(1) and je.swap_in(1)
            assert not te.swap_resident(1) and 1 in te.state.seqs
    assert te.prefix_cache_stats() == je.prefix_cache_stats()
    te.block_mgr.check_invariants(te.state.seqs.values())


def test_swap_edges_refuse_cleanly(models):
    def run(eng):
        got = [eng.swap_out(99)]                       # unknown uid
        t = eng.put([1], [[5, 6, 7, 8]], greedy=True)
        eng.decode_step({1: int(t[1])}, greedy=True)
        got += [eng.swap_out(1), eng.swap_in(2)]       # no entry for uid 2
        eng.flush(1)                                   # cancel while swapped out
        got += [eng.swap_resident(1), eng.swap_in(1), eng.export_ready(1)]
        return got

    (je, jr, jled), (te, tr, tled) = both(models, run, num_blocks=17, host_tier_blocks=8)
    assert tr == jr == [False, True, False, False, False, False]
    assert tled == jled  # the flushed entry's tickets were cancelled
    te.block_mgr.check_invariants([])
    untiered = engine("torch", models, num_blocks=17, host_tier_blocks=0)
    t = untiered.put([1], [[5, 6, 7, 8]], greedy=True)
    untiered.decode_step({1: int(t[1])}, greedy=True)
    assert not untiered.swap_out(1)                    # tier off: always replay


def test_rebuild_and_load_params_drop_tier_and_swaps(models):
    _, _, _, tparams = models

    def run(eng):
        rng = np.random.default_rng(9)
        eng.put([1], [rng.integers(0, 128, 32).tolist()], greedy=True)
        eng.flush(1)
        eng.put([2], [rng.integers(0, 128, 128).tolist()], greedy=True)
        eng.flush(2)
        t = eng.put([3], [rng.integers(0, 128, 8).tolist()], greedy=True)
        eng.decode_step({3: int(t[3])}, greedy=True)
        out = [eng.swap_out(3), eng.block_mgr.host_blocks > 0, bool(eng._swaps)]
        eng.rebuild()
        out += [eng.block_mgr.host_blocks, bool(eng._swaps), eng.swap_in(3)]
        t = eng.put([4], [rng.integers(0, 128, 8).tolist()], greedy=True)
        eng.decode_step({4: int(t[4])}, greedy=True)
        out.append(eng.swap_out(4))
        eng.load_params(tparams if isinstance(eng, InferenceEngineV2) else models[1])
        out += [eng.block_mgr.host_blocks, bool(eng._swaps)]
        return out

    (_, jr, jled), (te, tr, tled) = both(models, run, num_blocks=9, host_tier_blocks=16)
    assert tr == jr == [True, True, True, 0, False, False, True, 0, False]
    assert tled == jled  # the dropped entries' tickets were cancelled
    te.block_mgr.check_invariants([])


# ---------------------------------------------------------------------------
# the scheduler: swap-vs-recompute preemption
# ---------------------------------------------------------------------------
def _filtered(sched, eng):
    """The scheduler's counters that read no clock."""
    ev = {k: v for k, v, _ in sched.monitor_events()
          if not any(s in k for s in ("lat", "serve/transfer/", "_ms", "bytes_per_s"))}
    ev["prefix_hits"] = eng.prefix_cache_stats().get("hits", 0)
    return ev


def run_pressure(kind, models, *, num_blocks, host_tier_blocks, swap=None, sampled=False,
                 lose_after_swap=False):
    """The JAX test's pressure workload: four 17-token prompts decoding 40
    tokens through a ``num_blocks`` pool."""
    pkg, err, retry, _ = PKG[kind]
    eng = engine(kind, models, num_blocks=num_blocks, host_tier_blocks=host_tier_blocks)
    inj = Injector(err) if lose_after_swap else None
    sched = pkg.ContinuousBatchScheduler(inj.wrap(eng) if inj else eng, clock=Clock(),
                                         sleep=lambda s: None, swap_preemption=swap,
                                         retry=retry(max_attempts=5))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 127, 17).tolist() for _ in range(4)]
    reqs = [sched.submit(p, max_new_tokens=40, uid=100 + i,
                         sampling=(pkg.SamplingParams(temperature=0.8, seed=200 + i)
                                   if sampled else None))
            for i, p in enumerate(prompts)]
    if lose_after_swap:
        for _ in range(400):
            if eng._swaps or not sched.step():
                break
        assert eng._swaps, "the pressure workload must produce a swap victim"
        inj.dead = True  # the engine dies between steps, the entry live
    sched.run_until_complete()
    assert all(r.state.value == "done" for r in reqs)
    return reqs, _filtered(sched, eng), sched, eng, (eng.transfer.ledger(), eng.swap_stats)


_BASE = {}


def baseline(models, sampled):
    """The untiered, unpressured run of each package (41 blocks)."""
    if sampled not in _BASE:
        runs = [run_pressure(k, models, num_blocks=41, host_tier_blocks=0, sampled=sampled)
                for k in ("jax", "torch")]
        assert runs[1][2].metrics.preemptions == 0
        assert_same(models, *runs)
        _BASE[sampled] = [[r.tokens for r in run[0]] for run in runs]
    return _BASE[sampled]


@pytest.mark.parametrize("swap,sampled", [(True, False), (None, False), (False, False),
                                          (True, True)],
                         ids=["forced-swap", "auto", "forced-recompute", "forced-swap-temp0.8"])
def test_pressure_workload_bitwise(models, swap, sampled):
    jbase, tbase = baseline(models, sampled)
    j = run_pressure("jax", models, num_blocks=13, host_tier_blocks=32, swap=swap,
                     sampled=sampled)
    t = run_pressure("torch", models, num_blocks=13, host_tier_blocks=32, swap=swap,
                     sampled=sampled)
    reqs, counters, sched, eng, (ledger, swaps) = t
    assert [r.tokens for r in reqs] == tbase  # swap, replay and no pressure agree bitwise
    assert [r.tokens for r in j[0]] == jbase
    assert sched.metrics.preemptions >= 1
    kv = sched.metrics.kvtier
    assert kv["demotions"] >= 1
    if swap is False:
        assert kv["recompute_preemptions"] >= 1 and kv["swap_out"] == kv["swap_in"] == 0
    else:
        assert kv["swap_preemptions"] >= 1 and kv["swap_out"] >= 1 and kv["swap_in"] >= 1
        assert kv["swap_in_bytes"] > 0 and kv["bw_bytes_per_s"] > 0
        assert sched._swap_s_per_byte > 0
    if swap is not None:  # auto mode decides on measured wall-clock bandwidth
        assert_same(models, j[:2], t[:2])
        assert swaps == j[4][1] and ledger == j[4][0]
        assert eng.prefix_cache_stats() == j[3].prefix_cache_stats()
    check_transfer_ledger(eng.transfer)  # conserved
    assert eng.ragged_cache_size <= 4
    eng.block_mgr.check_invariants(eng.state.seqs.values())


def test_tier_off_is_the_untiered_scheduler(models):
    jbase, tbase = baseline(models, False)
    j = run_pressure("jax", models, num_blocks=13, host_tier_blocks=0)
    t = run_pressure("torch", models, num_blocks=13, host_tier_blocks=0)
    assert [r.tokens for r in t[0]] == tbase
    assert_same(models, j[:2], t[:2])
    kv = t[2].metrics.kvtier
    assert t[2].metrics.preemptions >= 1
    assert kv["swap_preemptions"] == kv["recompute_preemptions"] == kv["demotions"] == 0
    assert not t[3]._swaps and t[4][0]["submitted"] == {"d2h": 0, "h2d": 0}


def test_engine_loss_with_live_swap_entry_bitwise(models):
    """The engine dies while a victim's KV sits in the swap store: the
    rebuild drops the store and cancels its tickets, journal replay
    re-admits everyone, and every stream stays bitwise."""
    _, tbase = baseline(models, False)
    j = run_pressure("jax", models, num_blocks=13, host_tier_blocks=32, swap=True,
                     lose_after_swap=True)
    t = run_pressure("torch", models, num_blocks=13, host_tier_blocks=32, swap=True,
                     lose_after_swap=True)
    reqs, _, sched, eng, (ledger, _) = t
    assert eng._swaps == {} and eng.rebuilds >= 1
    assert sched.metrics.faults["engine_losses"] >= 1
    assert [r.tokens for r in reqs] == tbase
    assert_same(models, j[:2], t[:2])
    assert ledger["cancelled"] == j[4][0]["cancelled"]


# ---------------------------------------------------------------------------
# the NVMe tier
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_nvme_dir(tmp_path_factory):
    """The JAX NVMe-tiered engine's directory: one for the module, so that
    the engine is reused (its directory is fixed at construction)."""
    return str(tmp_path_factory.mktemp("jax_nvme"))


def _spill_prefix(eng):
    a, big, tail = _prefix_workload(21)
    eng.put([1], [a], greedy=True)
    eng.flush(1)
    eng.put([2], [big], greedy=True)  # demotes a's chain through the host tier
    eng.flush(2)
    s = eng.prefix_cache_stats()
    assert s["nvme_spilled_blocks"] >= 1 and s["nvme_blocks"] >= 1
    return a + tail


def _nvme_run(eng, corrupt):
    prompt = _spill_prefix(eng)
    if corrupt:
        for p in glob.glob(os.path.join(eng.transfer.nvme.root, "kvblock_*.bin")):
            with open(p, "wb") as f:
                f.write(b"\xff" * os.path.getsize(p))
    return eng.put([3], [prompt])[3], eng.prefix_cache_stats()


@pytest.mark.parametrize("overlap,corrupt", [(True, False), (False, False), (True, True)],
                         ids=["overlap-on", "overlap-off", "corrupt-block"])
def test_nvme_spill_promote_bitwise(models, jax_nvme_dir, tmp_path, overlap, corrupt):
    """A prefix spilled device -> host -> NVMe by pool pressure promotes
    back (or, with every block file corrupted, fails its CRC and
    recomputes) and serves bitwise a cold untiered engine's logits."""
    tier = dict(num_blocks=9, host_tier_blocks=1, nvme_tier_blocks=16, transfer_overlap=overlap)
    jax_nvme = engine("jax", models, nvme_tier_dir=jax_nvme_dir, **tier)
    te = engine("torch", models, nvme_tier_dir=str(tmp_path), **tier)
    assert te.transfer.overlap == overlap and te.nvme_tier_blocks == 16
    jw, js_ = _nvme_run(jax_nvme, corrupt)
    tw, ts_ = _nvme_run(te, corrupt)
    cold = engine("torch", models, num_blocks=9, host_tier_blocks=0)
    assert np.array_equal(tw, cold.put([3], [_prefix_workload(21)[0] +
                                             _prefix_workload(21)[2]])[3])
    close(tw, jw)
    assert ts_ == js_
    nv = te.transfer.nvme.counters
    assert nv == jax_nvme.transfer.nvme.counters
    assert te.transfer.ledger() == jax_nvme.transfer.ledger()
    if corrupt:
        assert ts_["nvme_corrupt_blocks"] >= 1 and nv["corrupt_reads"] >= 1
    else:
        assert ts_["nvme_loaded_blocks"] >= 1 and ts_["skipped_prefill_tokens"] >= 32
    te.block_mgr.check_invariants(te.state.seqs.values())
    with pytest.raises(TransferCorruptError):
        te.transfer.nvme.load("kvblock_missing")


# ---------------------------------------------------------------------------
# the cross-package handoff
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("src", ["jax", "torch"])
def test_handoff_crosses_packages(models, src):
    """One package's ``export_swap`` payload goes through the other's
    ``import_swap`` and ``swap_in`` and continues to the tokens the source
    package's own continuation gives; both refuse a payload whose CRC does
    not verify and a double import."""
    dst = "torch" if src == "jax" else "jax"
    prompt = np.random.default_rng(31).integers(0, 128, 37).tolist()
    a = engine(src, models, num_blocks=17, host_tier_blocks=8)
    t = a.put([1], [prompt], greedy=True)
    for _ in range(2):
        t = a.decode_step({1: int(t[1])}, greedy=True)
    feed = int(t[1])
    payload = a.export_swap(1)
    assert payload is not None and 1 not in a.state.seqs
    assert payload["dtype"] == "float32" and len(payload["blocks"]) == 3
    assert all(isinstance(b, np.ndarray) for b in payload["blocks"])
    # the source's own continuation: its payload back in, then decode
    a.import_swap(1, payload)
    assert a.swap_in(1)
    want = []
    for _ in range(4):
        feed_a = {1: want[-1] if want else feed}
        want.append(int(a.decode_step(feed_a, greedy=True)[1]))
    b = engine(dst, models, num_blocks=17, host_tier_blocks=8)
    bad = dict(payload, crc32=(int(payload["crc32"]) + 1) & 0xFFFFFFFF)
    with pytest.raises(PKG[dst][3]):
        b.import_swap(1, bad)
    assert b.import_swap(1, payload) == payload["nbytes"]
    with pytest.raises((jerr.EngineUsageError, terr.EngineUsageError), match="double import"):
        b.import_swap(1, payload)
    assert b.swap_in(1) and b.state.seqs[1].seen_tokens == payload["seen_tokens"]
    got = []
    for _ in range(4):
        got.append(int(b.decode_step({1: got[-1] if got else feed}, greedy=True)[1]))
    assert got == want
    swaps = b.swap_stats
    assert swaps["swap_import"] == swaps["swap_in"] == 1 and swaps["orphan_drops"] == 0


# ---------------------------------------------------------------------------
# the tier sanitizer: planted violations, both packages
# ---------------------------------------------------------------------------

SAN = {"jax": (jsan, jrm), "torch": (tsan, trm)}


def _stub_engine(mgr, seqs=None, swaps=None):
    return SimpleNamespace(block_mgr=mgr, state=SimpleNamespace(seqs=seqs or {}),
                           _swaps=swaps or {})


def _tiered_mgr(rm):
    mgr = rm.BlockedKVCache(9, block_size=4, max_blocks_per_seq=8, prefix_cache=True,
                            host_tier_blocks=8)
    a = rm.SequenceDescriptor(uid=1, slot=0)
    skipped = mgr.lookup(a, [1, 1, 1, 1, 2, 2, 2, 2])
    a.history.extend([1, 1, 1, 1, 2, 2, 2, 2][skipped:])
    mgr.ensure(a, 8)
    a.seen_tokens = 8
    mgr.register(a)
    mgr.free(a)
    b = rm.SequenceDescriptor(uid=2, slot=1)
    mgr.ensure(b, 7 * 4)  # one demotion
    assert mgr.host_blocks == 1
    return mgr, b


def _plant_dangling(mgr, b):
    del mgr._host[next(iter(mgr._host))]
    return _stub_engine(mgr)


def _plant_leak(mgr, b):
    del mgr._ref[b.blocks[-1]]
    return _stub_engine(mgr)


def _plant_overlap(mgr, b):
    mgr._free.append(b.blocks[0])
    return _stub_engine(mgr)


def _plant_resident_swap(mgr, b):
    return _stub_engine(mgr, seqs={5: object()}, swaps={5: ([], [], 0)})


def _plant_payload_count(mgr, b):
    return _stub_engine(mgr, swaps={7: ([None], list(range(24)), 24)})


def _plant_unpinned_promotion(mgr, b):
    mgr._pending_promotions.append((None, next(iter(mgr._lru))))
    return _stub_engine(mgr)


TIER_PLANTS = {"clean": (lambda mgr, b: _stub_engine(mgr), None),
               "dangling_demoted_index": (_plant_dangling, "no tier residence"),
               "device_pool_leak": (_plant_leak, "not conserved"),
               "free_and_referenced": (_plant_overlap, "free AND referenced"),
               "resident_uid_with_swap": (_plant_resident_swap, "engine-resident"),
               "swap_payload_count": (_plant_payload_count, "payload"),
               "unpinned_pending_promotion": (_plant_unpinned_promotion, "promotion")}


@pytest.mark.parametrize("name", sorted(TIER_PLANTS))
def test_tier_conservation_plants_raise_as_in_jax(name):
    plant, match = TIER_PLANTS[name]
    msgs = {}
    for kind, (san, rm) in SAN.items():
        eng = plant(*_tiered_mgr(rm))
        try:
            san.check_tier_conservation(eng)
            msgs[kind] = None
        except san.SanitizerError as e:
            msgs[kind] = str(e)
    if match is None:
        assert msgs == {"jax": None, "torch": None}
    else:
        assert msgs["torch"] is not None and match in msgs["torch"]
        assert msgs["torch"] == msgs["jax"]


def test_tier_check_armed_in_scheduler_step(models):
    """Checked mode (armed for this module) runs the tier check every
    scheduler step: a planted leak surfaces as a SanitizerError out of
    ``step()``, over the checked cache."""
    eng = engine("torch", models, num_blocks=17, host_tier_blocks=8)
    assert isinstance(eng.block_mgr, tsan.checked_cache_cls())
    sched = ts.ContinuousBatchScheduler(eng, sleep=lambda s: None)
    sched.submit([1, 2, 3, 4, 5], max_new_tokens=3, uid=900)
    sched.step()
    eng.block_mgr._free.pop()
    with pytest.raises(tsan.SanitizerError, match="tier conservation"):
        sched.step()

