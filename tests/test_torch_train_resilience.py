"""Fault-tolerant training in the port, held to the JAX package's
``tests/unit/test_train_resilience.py`` on the CPU.

- the native checkpoint engine's typed errors (torn, truncated, garbage and
  bit-rotted files, the pre-manifest compat load);
- the sanitizer's training checks on planted corruption, and armed
  (``DSTPU_SANITIZE=1``, as the JAX suite runs) under every real save here;
- the resume matrix: kill at every step, restore, replay, bitwise, for fp32
  and bf16 with an fp32 master, with the training key, the counters and the
  internal loader's position persisting (torch on one thread: the CPU's
  threaded products do not repeat bitwise);
- the durable-tag ring: a corrupt ``latest`` falls back, a named tag raises;
- ``TrainingSupervisor``: each scripted scenario of the JAX suite run through
  both packages' supervisors, their reports equal; ``InjectedTrainEngine``'s
  checkpoint sites firing inside the real ``save_checkpoint``; and the chaos
  run (a transient storm, a faulted save, a device loss, a faulted restore)
  whose loss curve is bitwise the fault-free one in the port, and within
  rtol 1e-5 of the JAX supervisor's under the same plan, its report equal.

The model is the JAX suite's micro gpt2 (hidden 32, one layer, two heads,
vocab 128, sequences of 16), a global batch of 8 rows (the JAX engine's 8
virtual devices a row each), AdamW without clipping, stage 0.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.analysis.sanitizer import (SanitizerError,
                                                    check_gather_conservation,
                                                    check_offload_split,
                                                    check_shard_conservation)
from deepspeed_tpu_torch.models import build_model, params_from_jax
from deepspeed_tpu_torch.resilience import (CheckpointCorruptError, FaultInjector,
                                            FaultSpec, InjectedTrainEngine,
                                            TrainingSupervisor, TransientEngineError)
from deepspeed_tpu_torch.runtime.checkpoint_engine.native_checkpoint_engine import (
    NativeCheckpointEngine)

ROWS, SEQ, V, STEPS = 8, 16, 128, 5
MKW = dict(hidden_size=32, num_layers=1, num_heads=2, vocab_size=V, max_seq_len=SEQ)
CONFIGS = {"plain": {}, "mixed": {"bf16": {"enabled": True}}}


def _config(variant="plain", **kw):
    cfg = {
        "train_batch_size": ROWS,
        "gradient_accumulation_steps": 1,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
        "gradient_clipping": 0.0,
        "steps_per_print": 0,
    }
    cfg.update({k: dict(v) for k, v in CONFIGS[variant].items()})
    cfg.update(kw)
    return cfg


def _batches_for(k):
    """The replay primitive: the batches of global step k as a pure
    function of k."""
    rng = np.random.default_rng(1000 + k)
    return [{"input_ids": rng.integers(0, V, (ROWS, SEQ), dtype=np.int32)}]


_INIT = {}


def _init():
    """The JAX package's ``init_params(PRNGKey(0))`` for the micro gpt2."""
    if not _INIT:
        import jax

        from deepspeed_tpu.models import build_model as jax_build_model

        _INIT["p"] = jax.tree.map(np.asarray, jax_build_model(
            "gpt2-125m", **MKW).init_params(jax.random.PRNGKey(0)))
    return _INIT["p"]


def _mk_engine(variant="plain", **kw):
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=build_model("gpt2-125m", **MKW), model_parameters=params_from_jax(_init()),
        config=_config(variant), device="cpu", **kw)
    return eng


def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.fixture(scope="module", autouse=True)
def checked_one_thread():
    """Sanitizer armed and torch on one thread for the whole module."""
    n, env = torch.get_num_threads(), os.environ.get("DSTPU_SANITIZE")
    torch.set_num_threads(1)
    os.environ["DSTPU_SANITIZE"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        os.environ.pop("DSTPU_SANITIZE", None)
    else:
        os.environ["DSTPU_SANITIZE"] = env


# ---------------------------------------------------------------------------
# checkpoint integrity: manifest-last durable writes
# ---------------------------------------------------------------------------

class TestCheckpointIntegrity:
    STATE = {"module": {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
                        "b": torch.ones((4,), dtype=torch.bfloat16)},
             "global_steps": 3}

    def _save(self, tmp_path):
        eng = NativeCheckpointEngine()
        path = str(tmp_path / "model_states.ckpt")
        eng.save(self.STATE, path)
        return eng, path

    def test_round_trip_and_sidecars(self, tmp_path):
        eng, path = self._save(tmp_path)
        assert os.path.exists(path + ".manifest.json")
        assert os.path.exists(path + ".meta.json")
        loaded = eng.load(path)
        np.testing.assert_array_equal(loaded["module"]["w"], self.STATE["module"]["w"])
        assert torch.equal(loaded["module"]["b"], self.STATE["module"]["b"])
        assert loaded["global_steps"] == 3
        assert eng.stats["saves"] == eng.stats["loads"] == 1
        assert eng.stats["bytes_written"] == os.path.getsize(path)

    def test_bit_rot_raises_typed(self, tmp_path):
        eng, path = self._save(tmp_path)
        with open(path, "r+b") as f:  # flip bytes mid-file: crc must catch it
            f.seek(os.path.getsize(path) // 2)
            f.write(b"\xff\xff\xff\xff")
        with pytest.raises(CheckpointCorruptError, match="checksum"):
            eng.load(path)

    def test_truncation_raises_typed(self, tmp_path):
        eng, path = self._save(tmp_path)
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
        with pytest.raises(CheckpointCorruptError):
            eng.load(path)

    def test_torn_write_raises_typed(self, tmp_path):
        # no manifest AND no meta = the writer died mid-save
        eng, path = self._save(tmp_path)
        os.remove(path + ".manifest.json")
        os.remove(path + ".meta.json")
        with pytest.raises(CheckpointCorruptError, match="torn"):
            eng.load(path)

    def test_legacy_manifestless_checkpoint_still_loads(self, tmp_path):
        # meta without manifest = written before the manifest protocol:
        # loads unverified rather than refusing old checkpoints
        eng, path = self._save(tmp_path)
        os.remove(path + ".manifest.json")
        loaded = eng.load(path)
        np.testing.assert_array_equal(loaded["module"]["w"], self.STATE["module"]["w"])

    def test_garbage_manifest_raises_typed(self, tmp_path):
        eng, path = self._save(tmp_path)
        with open(path + ".manifest.json", "w") as f:
            f.write("{not json")
        with pytest.raises(CheckpointCorruptError):
            eng.load(path)

    def test_the_jax_package_raises_on_the_same_corruption(self, tmp_path):
        """The JAX engine reads the port's manifest: the same bit rot fails
        its verify too."""
        from deepspeed_tpu.resilience import CheckpointCorruptError as JaxCorrupt
        from deepspeed_tpu.runtime.checkpoint_engine.native_checkpoint_engine import (
            NativeCheckpointEngine as JaxEngine)

        _, path = self._save(tmp_path)
        assert JaxEngine().load(path)["global_steps"] == 3
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            f.write(b"\xff\xff\xff\xff")
        with pytest.raises(JaxCorrupt, match="checksum"):
            JaxEngine().load(path)


# ---------------------------------------------------------------------------
# sanitizer checks: planted corruption must fire
# ---------------------------------------------------------------------------

class TestSanitizerChecks:
    def _trees(self):
        src = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
               "b": torch.ones((4,), dtype=torch.bfloat16), "n": 3}
        host = {"a": src["a"].clone(), "b": src["b"].clone(), "n": 3}
        return src, host

    def test_gather_conservation_passes_on_faithful_gather(self):
        src, host = self._trees()
        check_gather_conservation(src, host)
        check_gather_conservation(src, {**host, "a": host["a"].numpy()})

    def test_gather_conservation_catches_dropped_partition(self):
        src, host = self._trees()
        host["a"] = host["a"][:1]  # a part went missing in the gather
        with pytest.raises(SanitizerError, match="dropped or duplicated"):
            check_gather_conservation(src, host)

    def test_gather_conservation_catches_structure_drift(self):
        src, host = self._trees()
        del host["b"]
        with pytest.raises(SanitizerError):
            check_gather_conservation(src, host)

    def test_gather_conservation_catches_lossy_cast(self):
        src, host = self._trees()
        host["a"] = host["a"].to(torch.float16)
        with pytest.raises(SanitizerError, match="lossy"):
            check_gather_conservation(src, host)

    def test_gather_conservation_catches_a_leaf_that_is_no_snapshot(self):
        src, host = self._trees()
        host["a"] = src["a"].numpy()  # shares the parameter's storage
        with pytest.raises(SanitizerError, match="snapshot"):
            check_gather_conservation(src, host)
        host["a"] = src["a"][:]
        with pytest.raises(SanitizerError, match="snapshot"):
            check_gather_conservation(src, host)

    def test_gather_conservation_catches_non_array_leaf(self):
        src, host = self._trees()
        host["a"] = 1.5  # a Python number where the tensor was
        with pytest.raises(SanitizerError, match="not a host array"):
            check_gather_conservation(src, host)

    def test_offload_split_passes_on_disjoint_cover(self):
        check_offload_split([0, 2], [1, 3], 4)

    def test_offload_split_catches_overlap(self):
        with pytest.raises(SanitizerError, match="stepped twice"):
            check_offload_split([0, 1], [1, 2], 3)

    def test_offload_split_catches_missing_leaf(self):
        with pytest.raises(SanitizerError):
            check_offload_split([0], [2], 3)  # leaf 1 is stepped by nobody

    def test_offload_split_catches_duplicate_index(self):
        with pytest.raises(SanitizerError):
            check_offload_split([0, 0], [1], 2)

    def test_offload_split_catches_out_of_range(self):
        with pytest.raises(SanitizerError):
            check_offload_split([0, 5], [1], 2)

    def _plan(self):
        # two leaves (10 and 7 elements) over 4 shards, balanced bounds
        sizes = [10, 7]
        bounds = [tuple((s * r) // 4 for r in range(5)) for s in sizes]
        return sizes, bounds

    def _slices(self, sizes, bounds, dtype=np.float32):
        full = [np.arange(s, dtype=dtype) for s in sizes]
        return [[full[j][bounds[j][r]:bounds[j][r + 1]]
                 for j in range(len(sizes))] for r in range(4)]

    def test_shard_conservation_passes_on_faithful_plan(self):
        sizes, bounds = self._plan()
        check_shard_conservation(sizes, bounds)
        check_shard_conservation(sizes, bounds, self._slices(sizes, bounds), np.float32)

    @pytest.mark.parametrize("bad,match", [
        ((0, (0, 2, 5, 7, 9)), "do not cover"),  # last element never stepped
        ((1, (0, 4, 2, 5, 7)), "backwards"),  # rank-1/2 shards overlap
        ((1, (0, 3, 7)), "disagree"),  # leaf 1 thinks there are 2 shards
    ])
    def test_shard_conservation_catches_bad_bounds(self, bad, match):
        sizes, bounds = self._plan()
        bounds[bad[0]] = bad[1]
        with pytest.raises(SanitizerError, match=match):
            check_shard_conservation(sizes, bounds)

    def test_shard_conservation_catches_truncated_shard_file(self):
        sizes, bounds = self._plan()
        slices = self._slices(sizes, bounds)
        slices[2][0] = slices[2][0][:-1]  # shard file lost an element
        with pytest.raises(SanitizerError, match="not conserved"):
            check_shard_conservation(sizes, bounds, slices, np.float32)

    def test_shard_conservation_catches_missing_rank(self):
        sizes, bounds = self._plan()
        slices = self._slices(sizes, bounds)[:-1]
        with pytest.raises(SanitizerError, match="missing or duplicated"):
            check_shard_conservation(sizes, bounds, slices, np.float32)

    def test_shard_conservation_catches_lossy_cast(self):
        sizes, bounds = self._plan()
        slices = self._slices(sizes, bounds, dtype=np.float16)
        with pytest.raises(SanitizerError, match="dtype"):
            check_shard_conservation(sizes, bounds, slices, np.float32)

    def test_save_runs_the_gather_check(self, tmp_path, monkeypatch):
        """``save_checkpoint`` holds its gather to the source under the
        sanitizer: a host copy that hands back the live tensors fails."""
        from deepspeed_tpu_torch.runtime import engine as engine_mod

        eng = _mk_engine()
        monkeypatch.setattr(engine_mod, "_host_copy", lambda t: t.detach())
        with pytest.raises(SanitizerError, match="snapshot"):
            eng.save_checkpoint(str(tmp_path))


# ---------------------------------------------------------------------------
# resume matrix: kill at every step k, restore, replay — bitwise
# ---------------------------------------------------------------------------

class TestResumeMatrix:
    @pytest.mark.parametrize("variant", sorted(CONFIGS))
    def test_kill_at_every_step_resumes_bitwise(self, variant, tmp_path):
        d = str(tmp_path)
        ref = _mk_engine(variant)
        ref.save_checkpoint(d)  # global_step0: the kill-before-step-1 target
        ref_losses = []
        for k in range(STEPS):
            ref_losses.append(ref.train_batch(iter(_batches_for(k))))
            if k < STEPS - 1:
                ref.save_checkpoint(d)  # global_step{k+1}
        ref_losses = torch.stack(ref_losses)

        # ONE resumed engine re-restored for every kill point: the ring holds
        # every tag, and load_checkpoint must fully reset derived state
        res = _mk_engine(variant)
        for kill in range(STEPS):
            res.load_checkpoint(d, tag=f"global_step{kill}")
            assert res.global_steps == kill
            assert res.micro_steps == kill  # gas=1: one micro-step per step
            replay = torch.stack([res.train_batch(iter(_batches_for(k)))
                                  for k in range(kill, STEPS)])
            assert torch.equal(ref_losses[kill:], replay), (kill, ref_losses, replay)
        _assert_trees_equal(ref.params, res.params)
        if variant == "mixed":
            _assert_trees_equal(ref.master_params, res.master_params)
        _assert_trees_equal(ref.opt_state.m, res.opt_state.m)
        _assert_trees_equal(ref.opt_state.v, res.opt_state.v)

    def test_rng_and_counters_persist(self, ring, tmp_path):
        d = str(tmp_path)
        ref, res = ring["ref"], ring["res"]
        ref.save_checkpoint(d)  # a step-4 checkpoint outside the ring dir
        # plant a divergent training key: load must restore the saved one
        res._rng = torch.tensor([5, 999], dtype=torch.int64)
        res.load_checkpoint(d)
        assert torch.equal(res._rng, ref._rng) and res._rng.dtype == torch.int64
        assert res.global_steps == 4
        assert res.micro_steps == 4

    def test_a_saved_key_other_than_the_seeds_is_taken(self, tmp_path):
        """A run whose key is not ``PRNGKey(config.seed)`` resumes under the
        saved key: the resumed step draws its dropout masks from it."""
        eng = _mk_engine()
        eng._rng = torch.tensor([3, 4], dtype=torch.int64)
        eng.save_checkpoint(str(tmp_path))
        res = _mk_engine()
        res.load_checkpoint(str(tmp_path))
        assert res._rng.tolist() == [3, 4]

    def test_internal_dataloader_position_resumes(self, tmp_path):
        d = str(tmp_path)
        rng = np.random.default_rng(42)
        # a dataset of SAMPLES (the loader collates ROWS of them per batch):
        # a 4-batch epoch the RepeatingLoader cycles
        data = [{"input_ids": rng.integers(0, V, (SEQ,), dtype=np.int32)}
                for _ in range(4 * ROWS)]

        ref = _mk_engine(training_data=list(data))
        ref_losses = []
        for k in range(6):
            ref_losses.append(ref.train_batch())
            if k == 1:
                ref.save_checkpoint(d)

        res = _mk_engine(training_data=list(data))
        res.load_checkpoint(d)
        assert res._data_position == 2  # two batches consumed pre-kill
        replay = [res.train_batch() for _ in range(2, 6)]  # past the epoch's end
        assert res._data_position == 6
        assert torch.equal(torch.stack(ref_losses[2:]), torch.stack(replay))


# ---------------------------------------------------------------------------
# durable-tag ring: corrupt latest falls back, explicit tag refuses
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    """One durable-tag ring (tags global_step0..3) + one restore engine,
    shared across the fallback tests: each test works on a COPY of the
    pristine ring dir and re-restores the same engine. The reference engine
    takes one extra step past the ring so the bitwise-replay test has a
    target."""
    d = str(tmp_path_factory.mktemp("ring"))
    ref = _mk_engine()
    ref.save_checkpoint(d)
    for k in range(3):
        ref.train_batch(iter(_batches_for(k)))
        ref.save_checkpoint(d)  # tags global_step1..3
    loss3 = ref.train_batch(iter(_batches_for(3)))
    return {"dir": d, "ref": ref, "res": _mk_engine(), "loss3": loss3}


class TestCorruptTagFallback:
    def _copy(self, ring, tmp_path):
        d = str(tmp_path / "ring")
        shutil.copytree(ring["dir"], d)
        ring["res"].ckpt_corrupt_fallbacks = 0
        return d, ring["res"]

    @staticmethod
    def _corrupt(d, tag):
        path = os.path.join(d, tag, "model_states.ckpt")
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)

    def test_latest_falls_back_to_previous_durable_tag(self, ring, tmp_path):
        d, res = self._copy(ring, tmp_path)
        self._corrupt(d, "global_step3")
        res.load_checkpoint(d)
        assert res.global_steps == 2  # newest verifiable tag won
        assert res.ckpt_corrupt_fallbacks == 1

    def test_fallback_skips_multiple_corrupt_tags(self, ring, tmp_path):
        d, res = self._copy(ring, tmp_path)
        self._corrupt(d, "global_step3")
        self._corrupt(d, "global_step2")
        res.load_checkpoint(d)
        assert res.global_steps == 1
        assert res.ckpt_corrupt_fallbacks == 2

    def test_explicit_tag_raises_instead_of_substituting(self, ring, tmp_path):
        d, res = self._copy(ring, tmp_path)
        self._corrupt(d, "global_step3")
        with pytest.raises(CheckpointCorruptError) as ei:
            res.load_checkpoint(d, tag="global_step3")
        assert ei.value.tag == "global_step3"
        assert res.ckpt_corrupt_fallbacks == 0

    def test_every_tag_corrupt_raises(self, ring, tmp_path):
        d, res = self._copy(ring, tmp_path)
        for tag in ("global_step0", "global_step1", "global_step2", "global_step3"):
            self._corrupt(d, tag)
        with pytest.raises(CheckpointCorruptError, match="no loadable"):
            res.load_checkpoint(d)
        assert res.ckpt_corrupt_fallbacks == 4

    def test_a_corrupt_optimizer_file_falls_back_before_any_state_changes(
            self, ring, tmp_path):
        d, res = self._copy(ring, tmp_path)
        res.load_checkpoint(d, tag="global_step1")
        path = os.path.join(d, "global_step3", "optim_states.ckpt")
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            f.write(b"\x00\xff\x00\xff")
        with pytest.raises(CheckpointCorruptError, match="checksum"):
            res.load_checkpoint(d, tag="global_step3")
        assert res.global_steps == 1  # the model file verified, nothing moved
        res.load_checkpoint(d)
        assert res.global_steps == 2 and res.ckpt_corrupt_fallbacks == 1

    def test_fallback_resumes_bitwise_from_surviving_tag(self, ring, tmp_path):
        d, res = self._copy(ring, tmp_path)
        self._corrupt(d, "global_step3")
        res.load_checkpoint(d)  # lands on global_step2
        res.train_batch(iter(_batches_for(2)))
        r3 = res.train_batch(iter(_batches_for(3)))
        assert torch.equal(ring["loss3"], r3)
        _assert_trees_equal(ring["ref"].params, res.params)


# ---------------------------------------------------------------------------
# TrainingSupervisor state machine on a scripted fake engine, both packages
# ---------------------------------------------------------------------------

def _fake_engine_cls(errors):
    class FakeEngine:
        """Scripted engine: ``faults`` maps (site, call#) -> exception to
        raise before the call takes effect (the InjectedTrainEngine
        contract); ``errors`` is one package's error module."""

        def __init__(self, faults=None):
            self.global_steps = 0
            self.ckpt_corrupt_fallbacks = 0
            self.faults = {k: getattr(errors, name)(msg)
                           for k, (name, msg) in dict(faults or {}).items()}
            self.calls = {"train_batch": 0, "save_checkpoint": 0,
                          "load_checkpoint": 0, "rebuild": 0}
            self.saved_step = None
            self.dead = False

        def _gate(self, site):
            self.calls[site] += 1
            exc = self.faults.pop((site, self.calls[site]), None)
            if exc is not None:
                if isinstance(exc, errors.DeviceLostError):
                    self.dead = True
                raise exc
            if self.dead:
                raise errors.DeviceLostError("still dead")

        def train_batch(self, data_iter=None):
            self._gate("train_batch")
            self.global_steps += 1
            return float(self.global_steps)

        def save_checkpoint(self, save_dir, tag=None):
            self._gate("save_checkpoint")
            self.saved_step = self.global_steps

        def load_checkpoint(self, load_dir, tag=None):
            self._gate("load_checkpoint")
            assert self.saved_step is not None, "restore before any durable save"
            self.global_steps = self.saved_step

        def rebuild(self):
            self.calls["rebuild"] += 1
            self.dead = False
            return self

    return FakeEngine


def _both_packages(faults=None, run=4, raises=None, **kw):
    """The scenario through the port's supervisor and the JAX package's;
    their reports (and fake engines' call counts) must be equal. Returns
    the port's report and engine."""
    import deepspeed_tpu.resilience as jres

    import deepspeed_tpu_torch.resilience as tres
    from deepspeed_tpu_torch.resilience import errors as terrors

    out = []
    for pkg, errors in ((tres, terrors), (jres, jres)):
        eng = _fake_engine_cls(errors)(faults)
        args = {"retry": pkg.RetryPolicy(max_attempts=3, base_s=0.0),
                "recovery": pkg.RecoveryPolicy(max_consecutive_rebuilds=3),
                "sleep": lambda s: None}
        for name, value in kw.items():  # (class name, kwargs) or a plain value
            args[name] = (getattr(pkg, value[0])(**value[1]) if isinstance(value, tuple)
                          else value() if callable(value) else value)
        sup = pkg.TrainingSupervisor(eng, lambda k: [k], "/unused", **args)
        if raises is not None:
            with pytest.raises(getattr(pkg, raises), match="budget"):
                sup.run(run)
            out.append((None, eng.calls, None))
            continue
        losses = sup.run(run)
        out.append((sup.report(), eng.calls, dict(losses)))
    assert out[0] == out[1]
    return out[0][0], out[0][1]


class TestSupervisor:
    def test_fault_free_run_banks_every_step(self):
        rep, _ = _both_packages(run=6, save_interval=2)
        assert rep["goodput_ratio"] == 1.0
        assert rep["retries"] == rep["recoveries"] == 0
        # run-start save + saves at steps 2 and 4 (not at 6: run is over)
        assert rep["saves"] == 3

    def test_transient_is_retried_in_place(self):
        rep, _ = _both_packages({("train_batch", 2): ("TransientEngineError", "blip")}, run=3)
        assert rep["retries"] == 1 and rep["recoveries"] == 0
        assert rep["net_steps"] == 3 and rep["attempts"] == 4
        assert rep["goodput_ratio"] == pytest.approx(3 / 4)

    def test_transient_storm_escalates_to_recovery(self):
        rep, calls = _both_packages({("train_batch", k): ("TransientEngineError", "storm")
                                     for k in range(2, 5)}, run=3)
        assert rep["recoveries"] == 1 and rep["net_steps"] == 3
        assert calls["load_checkpoint"] == 1

    def test_device_lost_routes_to_checkpoint_recovery(self):
        rep, calls = _both_packages({("train_batch", 3): ("DeviceLostError", "killed")},
                                    save_interval=1)
        assert rep["recoveries"] == 1 and calls["rebuild"] == 1
        assert rep["net_steps"] == 4 and rep["replayed_steps"] == 0
        assert rep["breaker_state"] in ("HALF_OPEN", "CLOSED")

    def test_recovery_replays_steps_since_last_save(self):
        rep, _ = _both_packages({("train_batch", 4): ("DeviceLostError", "killed")},
                                run=5, save_interval=2)
        assert rep["replayed_steps"] == 1 and rep["net_steps"] == 5

    def test_device_lost_mid_restore_readmits_and_finishes(self):
        rep, calls = _both_packages({("train_batch", 2): ("DeviceLostError", "killed"),
                                     ("load_checkpoint", 1): ("DeviceLostError", "again")},
                                    run=3, save_interval=1)
        assert rep["recoveries"] == 1 and calls["rebuild"] == 2 and rep["net_steps"] == 3

    def test_recovery_budget_exhaustion_raises_typed(self):
        _both_packages({("train_batch", k): ("DeviceLostError", "cursed")
                        for k in range(2, 12)}, run=5, raises="UnrecoverableEngineError",
                       recovery=("RecoveryPolicy", {"max_consecutive_rebuilds": 2}))

    def test_watchdog_hard_breach_triggers_recovery(self):
        def clock():
            ticks = iter(range(0, 1000, 10))  # every step takes 10s of fake time
            return lambda: float(next(ticks))

        rep, _ = _both_packages(save_interval=1, clock=clock,
                                watchdog=("StepWatchdog", {"step_budget_s": 1.0,
                                                           "escalate_after": 1,
                                                           "hard_breach_after": 2}))
        assert rep["watchdog_breaches"] >= 2 and rep["recoveries"] >= 1
        assert rep["net_steps"] == 4

    def test_save_that_keeps_faulting_is_abandoned_not_fatal(self):
        rep, _ = _both_packages({("save_checkpoint", k): ("TransientEngineError", "io")
                                 for k in range(2, 5)}, run=2, save_interval=1)
        assert rep["save_failures"] == 1 and rep["net_steps"] == 2

    def test_bad_save_interval_rejected(self):
        with pytest.raises(ValueError):
            TrainingSupervisor(_fake_engine_cls(None)(), lambda k: [k], "/unused",
                               save_interval=-1)


# ---------------------------------------------------------------------------
# InjectedTrainEngine over the real engine: the checkpoint sites
# ---------------------------------------------------------------------------

def test_checkpoint_sites_fire_inside_the_real_save(tmp_path):
    """``ckpt_save`` and ``ckpt_commit`` fire in ``save_checkpoint``'s own
    writes: a fault at the second file (the optimizer's) leaves the model
    file written, no commit and ``latest`` on the previous tag."""
    eng = _mk_engine()
    inner_ckpt = eng.checkpoint_engine
    inj = FaultInjector([FaultSpec(site="ckpt_save", kind="transient", nth=4)],
                        sleep=lambda s: None)
    wrapped = InjectedTrainEngine(eng, inj)
    assert eng.checkpoint_engine is not inner_ckpt
    wrapped.save_checkpoint(str(tmp_path))  # saves #1-2
    wrapped.train_batch(iter(_batches_for(0)))
    with pytest.raises(TransientEngineError):
        wrapped.save_checkpoint(str(tmp_path))  # save #4: the optimizer file
    assert inj.calls["ckpt_save"] == 4 and inj.calls["ckpt_commit"] == 1
    assert (tmp_path / "latest").read_text() == "global_step0"
    assert (tmp_path / "global_step1" / "model_states.ckpt").exists()
    assert not (tmp_path / "global_step1" / "optim_states.ckpt").exists()
    assert inner_ckpt.stats["saves"] == 3


# ---------------------------------------------------------------------------
# acceptance: chaos training run, bitwise loss-curve parity
# ---------------------------------------------------------------------------

PLAN = [
    dict(site="train_batch", kind="transient", nth=2, count=2),
    dict(site="ckpt_save", kind="transient", nth=3),
    dict(site="train_batch", kind="device_lost", nth=9),
    dict(site="load_checkpoint", kind="transient", nth=1),
    dict(site="train_batch", kind="latency", nth=12, latency_s=0.0),
]


def _chaos(pkg, engine, d):
    inj = pkg.FaultInjector([pkg.FaultSpec(**s) for s in PLAN], seed=0, sleep=lambda s: None)
    sup = pkg.TrainingSupervisor(
        pkg.InjectedTrainEngine(engine, inj), _batches_for, d, save_interval=2,
        retry=pkg.RetryPolicy(max_attempts=4, base_s=0.0),
        recovery=pkg.RecoveryPolicy(max_consecutive_rebuilds=3), sleep=lambda s: None)
    sup.run(STEPS + 3)
    return sup


def test_storm_plus_device_loss_resumes_bitwise(tmp_path):
    import jax

    import deepspeed_tpu
    import deepspeed_tpu.resilience as jres
    from deepspeed_tpu.comm import topology as topo_mod
    from deepspeed_tpu.models import build_model as jax_build_model

    import deepspeed_tpu_torch.resilience as tres

    ref = _mk_engine()
    sup_ref = TrainingSupervisor(ref, _batches_for, str(tmp_path / "ref"), save_interval=2,
                                 sleep=lambda s: None)
    sup_ref.run(STEPS + 3)
    ref_curve = torch.stack(sup_ref.loss_curve())
    assert sup_ref.report()["goodput_ratio"] == 1.0

    eng = _mk_engine()
    sup = _chaos(tres, eng, str(tmp_path / "chaos"))
    rep = sup.report()
    assert rep["retries"] >= 1 and rep["recoveries"] >= 1
    assert rep["faults_fired"]["device_lost"] == 1
    assert rep["net_steps"] == STEPS + 3
    assert 0.0 < rep["goodput_ratio"] < 1.0
    assert torch.equal(ref_curve, torch.stack(sup.loss_curve()))
    _assert_trees_equal(ref.params, eng.params)

    # the JAX package's supervisor and engine under the same plan
    topo_mod.reset_topology()
    jm = jax_build_model("gpt2-125m", **MKW)
    jeng, _, _, _ = deepspeed_tpu.initialize(model=jm, model_parameters=_init(),
                                             config=_config())
    jsup = _chaos(jres, jeng, str(tmp_path / "jax"))
    jrep = jsup.report()
    assert rep == jrep
    np.testing.assert_allclose(ref_curve.numpy(),
                               np.asarray([float(x) for x in jsup.loss_curve()]), rtol=1e-5)
