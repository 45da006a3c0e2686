"""The port's step-program audit (``analysis/program_audit.py``) on the CPU.

- Every registered program of the port — the paged engine's ragged, fused,
  verify, copy-on-write, tier gather/scatter and bias programs, the slot
  engine's prefill and decode, the training engine's forward and backward —
  driven armed against the packaged ``programs.json``: each is pinned, no
  digest drifts, no bound is passed, no program holds a host sync.
  ``DSTPU_AUDIT=write python -m pytest tests/test_torch_program_audit.py -k
  every_program`` re-pins them (then review the diff). This module arms the
  port's audit through ``armed``: ``DSTPU_AUDIT`` would arm the JAX
  package's audit too.
- Fingerprints do not depend on the model's width or depth.
- Each failure raises ``ProgramAuditError`` naming the registration site:
  an unpinned program, a digest drift, an extra trace, a ``.item()``
  planted in a registered step.
- ``check_manifest`` passes over the port's tree, and the manifest's
  programs and ``max_traces`` are the JAX manifest's.
- The port's engine and the JAX engine, on the same traffic, count the same
  traces, within the bounds.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.analysis import program_audit as pa
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.models import build_model
from tests.test_torch_scheduler import ENGINE, MODEL, engine, models

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(os.path.abspath(deepspeed_tpu_torch.__file__))
assert models  # the module-scoped weights fixture, shared with the scheduler's tests


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sampler(seed, temperature=0.8):
    return SimpleNamespace(seed=seed, temperature=temperature, top_k=0, top_p=1.0)


def drive_paged(model_kw=MODEL):
    """The paged engine's programs: ragged (two row shapes, greedy and
    logits, all-greedy and sampled), copy-on-write, demotion and promotion
    through the host tier, a bias row, the fused horizon and verification."""
    m = build_model("llama-tiny", **model_kw)
    rng = np.random.default_rng(3)
    V = model_kw["vocab_size"]
    eng = InferenceEngineV2(m, None, device="cpu", dtype=torch.float32,
                            **dict(ENGINE, num_blocks=9, decode_horizon=4, host_tier_blocks=16))
    a = rng.integers(0, V, 32).tolist()                   # 2 full blocks
    eng.put([1], [a], greedy=True)                          # ragged, budget rows
    eng.put([2], [a])                                       # full-prompt hit: COW; logits
    eng.decode_step({1: 3, 2: 4})                           # ragged, decode rows, logits
    eng.flush(1)
    eng.flush(2)
    eng.put([5], [rng.integers(0, V, 20).tolist()])        # logits, budget rows
    eng.flush(5)
    eng.put([3], [rng.integers(0, V, 100).tolist()], greedy=True)  # demotes a's chain
    eng.flush(3)
    eng.set_sampling(4, _sampler(7), bias_row=np.linspace(-1, 1, V, dtype=np.float32))
    t = eng.put([4], [a + [5, 6]], greedy=True)             # promotes it; bias row; sampled
    eng.decode_step({4: int(t[4])}, greedy=True)            # decode rows, sampled
    ys = eng.decode_multi({4: int(t[4])}, 4)                # fused, sampled
    eng.rollback(4)                                         # commit all K
    eng.set_sampling(4, None)
    eng.verify_multi({4: ys[4][-1]}, {4: [1, 2, 3]})        # verify, all greedy
    eng.rollback(4, 3)                                      # accept one
    ys = eng.decode_multi({4: 9}, 4)                        # fused, all greedy
    eng.rollback(4)
    eng.set_sampling(4, _sampler(8))
    eng.verify_multi({4: ys[4][-1]}, {4: [1, 2, 3]})        # verify, sampled
    eng.rollback(4, 3)
    return eng


def drive_slot(model_kw=MODEL):
    """The slot engine's prefill (two buckets) and decode (both modes)."""
    m = build_model("llama-tiny", **model_kw)
    eng = InferenceEngineV2(m, None, device="cpu", dtype=torch.float32, max_seqs=2,
                            max_seq_len=128, prefill_chunk=32)
    eng.put([1, 2], [list(range(5)), list(range(20))])
    eng.decode_step({1: 1, 2: 2}, greedy=True)
    eng.decode_step({1: 1, 2: 2})
    return eng


def drive_training(model_kw=MODEL):
    """The training engine's forward and backward: the fused GAS=1 step and
    the split forward/backward of GAS=2."""
    rng = np.random.default_rng(0)
    batches = [{"input_ids": rng.integers(0, model_kw["vocab_size"], (2, 32)).astype(np.int32)}
               for _ in range(3)]
    engines = []
    for gas in (1, 2):
        config = {"train_batch_size": 2 * gas, "gradient_accumulation_steps": gas,
                  "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}, "seed": 0}
        eng = deepspeed_tpu_torch.initialize(model=build_model("llama-tiny", **model_kw),
                                             config=config, device="cpu")[0]
        eng.train_batch(iter(batches))
        engines.append(eng)
    return engines


DRIVERS = (drive_paged, drive_slot, drive_training)
ALL_PROGRAMS = {"engine_v2.ragged", "engine_v2.fused", "engine_v2.verify", "engine_v2.cow",
                "engine_v2.tier_gather", "engine_v2.tier_scatter", "engine_v2.bias_set",
                "engine_v2.prefill", "engine_v2.decode", "engine.fwd_bwd"}


def test_every_program_is_pinned_and_clean():
    """Armed check (or, under ``DSTPU_AUDIT=write``, the re-pin) of every
    registered program against the packaged manifest."""
    mode = "write" if pa.audit_mode() == "write" else "check"
    reg = pa.ProgramRegistry()
    with pa.armed(mode, reg):
        paged, slot, training = (drive() for drive in DRIVERS)
        assert paged.ragged_cache_size == 4 and paged.fused_cache_size == 1
        assert paged.verify_cache_size == 1
        assert pa.assert_trace_bounds(paged, registry=reg) == [
            ("engine_v2.ragged", 4, 4), ("engine_v2.fused", 1, 1),
            ("engine_v2.verify", 1, 1)]
    assert set(reg.observed) == ALL_PROGRAMS
    assert paged._ragged_fn.trace_count == paged.ragged_cache_size
    assert paged.prefix_cache_stats()["promoted_blocks"] >= 2
    for name, fps in reg.observed.items():
        for fp in fps.values():
            assert fp["syncs"] == [], (name, fp["syncs"])
    if mode == "check":
        assert reg.digests_comparable("cpu"), "the manifest was pinned with another torch"


def test_fingerprints_do_not_depend_on_width_or_depth():
    small = dict(MODEL, hidden_size=32, num_layers=1, intermediate_size=64)
    big = dict(MODEL, hidden_size=128, num_layers=3, num_heads=8, intermediate_size=256)
    reg_s, reg_b = pa.ProgramRegistry("/none"), pa.ProgramRegistry("/none")
    for kw, reg in ((small, reg_s), (big, reg_b)):
        reg._pin = lambda *a: None  # observe only
        with pa.armed("write", reg):
            drive_paged(kw)
            drive_slot(kw)
    for name in reg_s.observed:
        assert set(reg_s.observed[name]) == set(reg_b.observed[name]), name


# ---------------------------------------------------------------------------
# each failure names its registration site
# ---------------------------------------------------------------------------

def _site(name):
    return pa.registered_program_names([PKG_DIR])[name][0]


def _manifest(tmp_path, programs, same_torch=True):
    path = tmp_path / "programs.json"
    path.write_text(json.dumps({"version": 1, "device": "cpu",
                                "torch": torch.__version__ if same_torch else "0.0",
                                "programs": programs}))
    return pa.ProgramRegistry(str(path))


def _paged():
    return InferenceEngineV2(build_model("llama-tiny", **MODEL), None, device="cpu",
                             dtype=torch.float32, **ENGINE)


def test_unpinned_program_raises_naming_its_site(tmp_path):
    with pa.armed("check", _manifest(tmp_path, {})):
        with pytest.raises(pa.ProgramAuditError, match="not pinned") as e:
            _paged().put([1], [[1, 2, 3]], greedy=True)
    assert _site("engine_v2.ragged") in str(e.value)
    assert "engine_v2.py:" in _site("engine_v2.ragged")


def test_digest_drift_raises_naming_what_moved(tmp_path):
    pinned = {"engine_v2.ragged": {"max_traces": 4, "variants": [
        {"digest": "0000000000000000", "ops": ["aten::mm"], "in": [], "out": [],
         "promotions": [], "kernels": []}]}}
    with pa.armed("check", _manifest(tmp_path, pinned)):
        with pytest.raises(pa.ProgramAuditError, match="drifted") as e:
            _paged().put([1], [[1, 2, 3]], greedy=True)
    assert _site("engine_v2.ragged") in str(e.value) and "new op(s)" in str(e.value)
    # another torch: the digest is not compared, the bound still is
    with pa.armed("check", _manifest(tmp_path, pinned, same_torch=False)):
        _paged().put([1], [[1, 2, 3]], greedy=True)


def test_extra_trace_raises_naming_its_site(tmp_path):
    reg = pa.ProgramRegistry(str(tmp_path / "programs.json"))
    with pa.armed("write", reg):
        eng = _paged()
        eng.put([1], [[1, 2, 3]], greedy=True)
    man = json.loads((tmp_path / "programs.json").read_text())
    assert man["device"] == "cpu" and man["torch"] == torch.__version__
    assert man["programs"]["engine_v2.ragged"]["sites"] == ["deepspeed_tpu_torch/inference/v2/engine_v2.py"]
    man["programs"]["engine_v2.ragged"]["max_traces"] = 1
    (tmp_path / "programs.json").write_text(json.dumps(man))
    with pa.armed("check", pa.ProgramRegistry(str(tmp_path / "programs.json"))):
        eng = _paged()
        t = eng.put([1], [[1, 2, 3]], greedy=True)    # the pinned signature
        with pytest.raises(pa.ProgramAuditError, match="exceeding the pinned bound 1") as e:
            eng.decode_step({1: int(t[1])}, greedy=True)  # decode rows: a second trace
    assert _site("engine_v2.ragged") in str(e.value)


def test_planted_item_in_a_step_raises_naming_its_site(monkeypatch):
    model = build_model("llama-tiny", **MODEL)
    real = model.forward_paged

    def leaky(params, ids, *a, **kw):
        if int(ids.sum().item()) < 0:  # the plant: a host read inside the step
            raise AssertionError
        return real(params, ids, *a, **kw)

    monkeypatch.setattr(model, "forward_paged", leaky)
    eng = InferenceEngineV2(model, None, device="cpu", dtype=torch.float32, **ENGINE)
    with pa.armed("check"):
        with pytest.raises(pa.ProgramAuditError, match="host sync") as e:
            eng.put([1], [[1, 2, 3]], greedy=True)
    assert "aten::_local_scalar_dense" in str(e.value)
    assert _site("engine_v2.ragged") in str(e.value)


def test_off_is_a_pass_through(monkeypatch):
    monkeypatch.delenv("DSTPU_AUDIT", raising=False)
    assert pa.audit_mode() == ""
    eng = _paged()
    eng.put([1], [[1, 2, 3]], greedy=True)
    assert eng._ragged_fn.trace_count == 0 and not eng._ragged_fn._seen
    with pa.armed(""):
        monkeypatch.setenv("DSTPU_AUDIT", "1")
        assert pa.audit_mode() == ""  # armed() wins over the variable
    assert pa.audit_mode() == "check"


def test_split_program_records_forward_and_backward():
    reg = pa.ProgramRegistry("/none")
    with pa.armed("write", reg):
        reg._pin = lambda *a: None
        fwd_only = pa.audited_program("t.split", lambda x: (x * 2).sum())
        x = torch.ones(3, requires_grad=True)
        loss = fwd_only.begin(x)
        fwd_only.end(lambda: torch.autograd.grad(loss, [x]))
    (fp,) = reg.observed["t.split"].values()
    assert "aten::mul" in fp["ops"] and "aten::sum" in fp["ops"]
    assert "aten::expand" in fp["ops"]  # the backward of the sum
    assert fp["in"] == ["float32[r1]"] and "float32[r0]" in fp["out"]


# ---------------------------------------------------------------------------
# the manifest against the tree and against the JAX package's
# ---------------------------------------------------------------------------

def test_check_manifest_passes_over_the_port():
    assert pa.check_manifest([PKG_DIR]) == []
    assert set(pa.registered_program_names([PKG_DIR])) == ALL_PROGRAMS


def test_manifest_matches_the_jax_manifest():
    with open(os.path.join(_REPO, "deepspeed_tpu", "analysis", "programs.json")) as fh:
        jax_man = json.load(fh)
    with open(pa.default_manifest_path()) as fh:
        man = json.load(fh)
    unported = man.get("unported", {})
    assert all(isinstance(why, str) and why for why in unported.values())
    assert set(man["programs"]) | set(unported) == set(jax_man["programs"])
    for name, entry in man["programs"].items():
        assert entry["max_traces"] == jax_man["programs"][name]["max_traces"], name
    assert man["device"] == "cpu"


def test_engine_trace_counts_match_the_jax_engine(models):
    """The same traffic through both packages: greedy and logits rounds at
    both row shapes, then a sampled request; the audited port counts the
    JAX engine's traces."""
    from deepspeed_tpu.analysis.program_audit import \
        ENGINE_TRACE_PROPS as JAX_PROPS  # noqa: N811

    def traffic(eng):
        eng.put([1, 2], [list(range(20)), list(range(7))], greedy=True)
        eng.decode_step({1: 1, 2: 2}, greedy=True)
        eng.decode_step({1: 1, 2: 2})
        eng.put([3], [list(range(30, 50))])
        return {prop: getattr(eng, prop) for prop in JAX_PROPS.values()}

    want = traffic(engine("jax", models))
    with pa.armed("check"):
        eng = engine("torch", models)
        got = traffic(eng)
        bounds = pa.assert_trace_bounds(eng)
    assert got == want and got["ragged_cache_size"] == 4
    assert eng._ragged_fn.trace_count == 4
    assert all(obs <= bound for _, obs, bound in bounds)
