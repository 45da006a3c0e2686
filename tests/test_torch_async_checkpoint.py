"""The port's async checkpoint engine, held to the JAX package's
``tests/unit/test_async_checkpoint.py`` on the CPU: FIFO order and
read-your-writes, a writer error surfacing at ``wait`` and keeping
``latest`` off that tag while a later tag still saves, the drain at exit,
a crash with a save in flight resuming from the last complete tag, and
``save_checkpoint`` returning before the write. Added here: the snapshot —
a save taken before a step that updates the parameters in place writes the
pre-step bytes, however late the writer runs, and the JAX package reads
them.
"""

import gc
import os
import subprocess
import sys
import threading
import time
import weakref

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import build_model
from deepspeed_tpu_torch.runtime.checkpoint_engine import native_checkpoint_engine
from deepspeed_tpu_torch.runtime.checkpoint_engine.async_checkpoint_engine import (
    AsyncCheckpointEngine)
from deepspeed_tpu_torch.runtime.checkpoint_engine.native_checkpoint_engine import (
    NativeCheckpointEngine)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_engine(**extra):
    """The micro gpt2 of the JAX package's checkpoint tests, async saves."""
    model = build_model("gpt2-125m", hidden_size=32, num_layers=1, num_heads=2,
                        vocab_size=128, max_seq_len=16)
    cfg = {"train_batch_size": 8, "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
           "checkpoint": {"async_save": True}, "steps_per_print": 0, **extra}
    return deepspeed_tpu_torch.initialize(
        model=model, model_parameters=model.init_params(torch.Generator().manual_seed(0)),
        config=cfg, device="cpu")[0]


def train(engine, steps, seed=0):
    batch = {"input_ids": np.random.default_rng(seed).integers(0, 128, (8, 16)).astype(np.int32)}
    for _ in range(steps):
        engine.backward(engine(batch))
        engine.step()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TestAsyncEngineUnit:
    def test_read_your_writes_and_order(self, tmp_path):
        eng = AsyncCheckpointEngine()
        p = str(tmp_path / "a.ckpt")
        eng.save({"x": np.arange(4), "n": 3}, p)
        eng.save({"x": np.arange(4) * 2, "n": 4}, p)  # newer snapshot wins
        out = eng.load(p)  # waits for the in-flight saves first
        np.testing.assert_array_equal(out["x"], np.arange(4) * 2)
        assert out["n"] == 4
        eng.close()

    def test_enqueue_task_ordering(self, tmp_path):
        eng = AsyncCheckpointEngine()
        order = []
        eng.save({"x": np.zeros(8)}, str(tmp_path / "b.ckpt"))
        eng.enqueue_task(lambda: order.append("after_save"))
        eng.wait()
        assert order == ["after_save"]
        assert os.path.exists(tmp_path / "b.ckpt")
        eng.close()

    def test_writer_error_surfaces_at_wait(self, tmp_path):
        eng = AsyncCheckpointEngine()
        blocker = tmp_path / "not-a-dir"
        blocker.write_text("file, not dir")  # makedirs under a file must fail
        eng.save({"x": np.zeros(2)}, str(blocker / "sub" / "x.ckpt"))
        with pytest.raises(RuntimeError, match="async checkpoint save of"):
            eng.wait()
        eng.close()


def test_save_is_off_the_step_path(tmp_path, monkeypatch):
    """save_checkpoint returns while the (artificially slow) write is still
    in flight; wait() is the durability barrier."""
    engine = make_engine()
    assert isinstance(engine.checkpoint_engine, AsyncCheckpointEngine)
    train(engine, 2)

    real_save = native_checkpoint_engine.NativeCheckpointEngine.save

    def slow_save(self, sd, path):
        time.sleep(1.0)
        real_save(self, sd, path)

    monkeypatch.setattr(native_checkpoint_engine.NativeCheckpointEngine, "save", slow_save)
    t0 = time.perf_counter()
    engine.save_checkpoint(str(tmp_path), tag="t2")
    returned = time.perf_counter() - t0
    assert returned < 0.9, f"save_checkpoint blocked {returned:.2f}s"
    assert not (tmp_path / "latest").exists()  # not before the files are durable
    engine.checkpoint_engine.wait()
    assert (tmp_path / "latest").read_text().strip() == "t2"
    engine2 = make_engine()
    engine2.load_checkpoint(str(tmp_path))
    assert torch.equal(engine.params["wte"], engine2.params["wte"])
    assert engine2.global_steps == 2


def test_snapshot_holds_the_pre_step_bytes(tmp_path, monkeypatch):
    """The writer runs only after the next step has updated every parameter
    and moment in place: the files hold the state at the save, which the
    JAX package reads back as well."""
    from deepspeed_tpu.runtime.checkpoint_engine.native_checkpoint_engine import (
        NativeCheckpointEngine as JaxEngine)

    engine = make_engine(bf16={"enabled": True})
    train(engine, 1)
    before = {k: v.detach().clone() for k, v in engine.params["blocks"].items()}
    master = engine.master_params["wte"].clone()
    m_before = engine.opt_state.m["wte"].clone()
    gate = threading.Event()
    real_save = native_checkpoint_engine.NativeCheckpointEngine.save

    def gated_save(self, sd, path):
        gate.wait(30)
        real_save(self, sd, path)

    monkeypatch.setattr(native_checkpoint_engine.NativeCheckpointEngine, "save", gated_save)
    engine.save_checkpoint(str(tmp_path), tag="t1")
    train(engine, 1, seed=1)  # in place, while the writer waits
    assert not torch.equal(engine.params["blocks"]["wq"], before["wq"])
    gate.set()
    engine.checkpoint_engine.wait()
    monkeypatch.undo()
    res = make_engine(bf16={"enabled": True})
    res.load_checkpoint(str(tmp_path))
    for k, v in before.items():
        assert torch.equal(res.params["blocks"][k], v), k
    assert torch.equal(res.master_params["wte"], master)
    assert torch.equal(res.opt_state.m["wte"], m_before)
    theirs = JaxEngine().load(str(tmp_path / "t1" / "model_states.ckpt"))
    np.testing.assert_array_equal(theirs["module"]["wte"], master.numpy())


_CRASH_CHILD = """
import os, sys, time
import numpy as np
sys.path.insert(0, {repo!r})
from deepspeed_tpu_torch.runtime.checkpoint_engine import native_checkpoint_engine
from tests.test_torch_async_checkpoint import make_engine, train
d = {d!r}
engine = make_engine()
train(engine, 3)
engine.save_checkpoint(d, tag="t3")
engine.checkpoint_engine.wait()   # t3 fully durable
# the exact params the survivor must resume with
np.save(os.path.join(d, "expected.npy"), engine.params["blocks"]["wq"].detach().numpy())
train(engine, 2)
# every further write stalls: the t5 save will be in flight at crash time
real_save = native_checkpoint_engine.NativeCheckpointEngine.save
native_checkpoint_engine.NativeCheckpointEngine.save = (
    lambda self, sd, path: (time.sleep(60), real_save(self, sd, path)))
engine.save_checkpoint(d, tag="t5")   # returns immediately (async)
os._exit(9)                           # hard crash, t5 write in flight
"""


def _child(src, d):
    env = {k: v for k, v in os.environ.items() if k != "DSTPU_SANITIZE"}
    return subprocess.run([sys.executable, "-c", src.format(repo=_REPO, d=str(d))], env=env,
                          capture_output=True, text=True, timeout=300, cwd=_REPO)


def test_crash_during_inflight_save_resumes_bit_identical(tmp_path):
    """Train → durable save t3 → train → crash while async save t5 is in
    flight. `latest` must still point at t3 and a fresh engine must resume
    bit-identical to the recorded t3 state."""
    proc = _child(_CRASH_CHILD, tmp_path)
    assert proc.returncode == 9, f"child: {proc.stderr[-2000:]}"
    assert (tmp_path / "latest").read_text().strip() == "t3", "latest moved past the crash"
    # the t5 model file must not exist as a complete checkpoint
    assert not os.path.exists(tmp_path / "t5" / "model_states.ckpt")
    engine = make_engine()
    path, _ = engine.load_checkpoint(str(tmp_path))
    assert path is not None and engine.global_steps == 3
    np.testing.assert_array_equal(engine.params["blocks"]["wq"].detach().numpy(),
                                  np.load(tmp_path / "expected.npy"))


def test_failed_save_blocks_latest_pointer(tmp_path):
    """A failed queued save must poison later ordered tasks: the `latest`
    pointer cannot advance onto a tag with missing files."""
    eng = AsyncCheckpointEngine()
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("x")
    ran = []
    eng.save({"x": np.zeros(2)}, str(blocker / "t5" / "model.ckpt"))
    eng.enqueue_task(lambda: ran.append("latest"))
    with pytest.raises(RuntimeError):
        eng.wait()
    assert ran == [], "`latest` task ran after a failed save"
    eng.close()


_EXIT_CHILD = """
import sys, time
sys.path.insert(0, {repo!r})
from deepspeed_tpu_torch.runtime.checkpoint_engine import native_checkpoint_engine
from tests.test_torch_async_checkpoint import make_engine, train
engine = make_engine()
train(engine, 1)
real_save = native_checkpoint_engine.NativeCheckpointEngine.save
native_checkpoint_engine.NativeCheckpointEngine.save = (
    lambda self, sd, path: (time.sleep(0.5), real_save(self, sd, path)))
engine.save_checkpoint({d!r}, tag="final")
# NO wait(), NO close(): normal interpreter exit must drain the queue
"""


def test_normal_exit_drains_queue(tmp_path):
    """A script ending right after save_checkpoint() must not lose the
    checkpoint: the atexit hook drains the writer queue."""
    proc = _child(_EXIT_CHILD, tmp_path)
    assert proc.returncode == 0, f"child: {proc.stderr[-2000:]}"
    assert (tmp_path / "latest").read_text().strip() == "final"
    assert os.path.exists(tmp_path / "final" / "model_states.ckpt")


def test_later_tags_recover_after_one_failed_save(tmp_path):
    """A transient save failure must not freeze `latest` forever: the next
    save_checkpoint batch (its own window) succeeds and its ordered task
    runs."""
    eng = AsyncCheckpointEngine()
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("x")
    ran = []
    # window 1: failing save + its task → task skipped
    eng.save({"x": np.zeros(2)}, str(blocker / "t5" / "model.ckpt"))
    eng.enqueue_task(lambda: ran.append("t5"))
    # window 2: healthy save + its task → task RUNS despite the old error
    eng.save({"x": np.ones(2)}, str(tmp_path / "t6.ckpt"))
    eng.enqueue_task(lambda: ran.append("t6"))
    with pytest.raises(RuntimeError):
        eng.wait()
    assert ran == ["t6"]
    assert os.path.exists(tmp_path / "t6.ckpt")
    eng.close()


def test_load_unaffected_by_unrelated_save_error(tmp_path):
    """wait(path)/load(path) must not raise another path's stored error."""
    eng = AsyncCheckpointEngine()
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("x")
    good = str(tmp_path / "good.ckpt")
    eng.save({"x": np.zeros(2)}, str(blocker / "bad" / "x.ckpt"))
    eng.save({"x": np.arange(3)}, good)
    out = eng.load(good)  # must succeed despite the bad save's error
    np.testing.assert_array_equal(out["x"], np.arange(3))
    with pytest.raises(RuntimeError):
        eng.wait()  # the unscoped barrier still surfaces it
    eng.close()


def test_a_failed_tag_keeps_latest_while_the_next_tag_saves(tmp_path, monkeypatch):
    """Through the engine: a writer error on one tag surfaces at ``wait``
    and ``latest`` stays on the previous tag; the next tag saves and moves
    it."""
    engine = make_engine()
    engine.save_checkpoint(str(tmp_path))  # global_step0
    engine.checkpoint_engine.wait()
    train(engine, 1)
    real_save = native_checkpoint_engine.NativeCheckpointEngine.save

    def failing(self, sd, path):
        raise OSError("disk full")

    monkeypatch.setattr(native_checkpoint_engine.NativeCheckpointEngine, "save", failing)
    engine.save_checkpoint(str(tmp_path))  # global_step1, fails on the writer
    for f in ("model", "optim"):  # each failed file surfaces at one wait
        with pytest.raises(RuntimeError, match=f"global_step1/{f}_states"):
            engine.checkpoint_engine.wait()
    assert (tmp_path / "latest").read_text() == "global_step0"
    monkeypatch.setattr(native_checkpoint_engine.NativeCheckpointEngine, "save", real_save)
    train(engine, 1)
    engine.save_checkpoint(str(tmp_path))
    engine.checkpoint_engine.wait()
    assert (tmp_path / "latest").read_text() == "global_step2"
    engine.checkpoint_engine.close()


@pytest.mark.parametrize("kind", ["native", "async"])
def test_written_state_is_freed_without_the_garbage_collector(kind, tmp_path):
    """Once a save is written, the checkpoint engine holds nothing of the
    tree it was given (on the card, the pinned buffers the next save's
    gather takes again from the allocator's cache), and a load's arrays go
    with the caller's last reference: held with the cyclic garbage
    collector off, on a numpy leaf (the archive holds a tensor leaf as a
    view of its storage)."""
    eng = NativeCheckpointEngine() if kind == "native" else AsyncCheckpointEngine()
    path = str(tmp_path / "s.ckpt")
    w = np.ones((3, 4), np.float32)
    saved = weakref.ref(w)
    gc.collect()
    gc.disable()
    try:
        eng.save({"module": {"w": w, "t": torch.ones(2, dtype=torch.bfloat16)}, "l": [1]},
                 path)
        del w
        if kind == "async":
            eng.wait()
        assert saved() is None
        back = eng.load(path)
        read = weakref.ref(back["module"]["w"])
        del back
        assert read() is None
    finally:
        gc.enable()
        if kind == "async":
            eng.close()
