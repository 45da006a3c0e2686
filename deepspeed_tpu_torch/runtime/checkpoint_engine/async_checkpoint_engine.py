"""Async checkpoint engine: serialization + disk writes off the step path (a copy of
``deepspeed_tpu/runtime/checkpoint_engine/async_checkpoint_engine.py`` but for
``commit``, whose marker here does not let a failed save's ``latest`` through).

Fills the role of the reference's Nebula engine
(reference runtime/checkpoint_engine/nebula_checkpoint_engine.py:1, config
nebula/config.py:1): ``save()`` snapshots the already-host-resident state and
returns immediately; a single writer thread serializes and writes in FIFO
order, overlapping checkpoint I/O with the training steps that follow. The
device→host gather stays on the caller (the unavoidable synchronous slice) —
what moves off the step path is npz serialization and disk I/O, which dominate
checkpoint latency at large model sizes.

Durability contract:
- every file is written tmp→``os.replace``, so a partially-written file never
  shadows a complete one;
- ``commit(tag)`` is *eventually durable* (nebula semantics): it returns
  immediately; once the writer drains everything queued before it, the tag is
  complete on disk. ``DeepSpeedEngine.save_checkpoint`` rides the ``latest``
  pointer write on the same FIFO queue (``enqueue_task``), so ``latest`` can
  never point at a tag whose files are still in flight — a crash mid-save
  resumes from the previous complete checkpoint;
- ``wait()`` is the hard barrier (drains the queue, re-raises writer errors);
  ``load()`` on a path with an in-flight save waits for that save first
  (read-your-writes within a process).
"""

import atexit
import os
import queue
import threading


def _key(path):
    """Canonical key for read-your-writes tracking: an equivalent spelling
    (relative vs absolute, redundant separators) must hit the same in-flight
    entry, else a load can race a queued save of the same file."""
    return os.path.abspath(os.path.normpath(path)) if path is not None else None

from ...utils.logging import logger
from .native_checkpoint_engine import NativeCheckpointEngine


class AsyncCheckpointEngine(NativeCheckpointEngine):
    def __init__(self, config_params=None):
        super().__init__(config_params)
        self._q = queue.Queue()
        self._cv = threading.Condition()
        self._enq_seq = 0    # items handed to the queue
        self._done_seq = 0   # items fully executed (FIFO ⇒ monotone)
        self._inflight = {}  # path -> newest enqueued seq for that path
        self._errors = []    # (seq, path, exception), surfaced at wait()
        self._prev_task_seq = 0  # seq of the last executed ordered task
        self._thread = threading.Thread(
            target=self._drain, name="dstpu-async-ckpt", daemon=True)
        self._thread.start()
        # drain on normal interpreter exit — without this, a script whose last
        # act is save_checkpoint() would exit with the writes still queued and
        # the daemon writer killed mid-flight (rc=0, checkpoint silently gone)
        self._atexit = atexit.register(self._drain_at_exit)

    def _drain_at_exit(self):
        try:
            self.wait()
        except Exception as e:
            logger.error(f"[AsyncCheckpointEngine] exit drain: {e}")

    # ------------------------------------------------------------------
    def _drain(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            seq, fn, path, gated = item
            item = None
            try:
                poisoned = False
                if gated:
                    # ordered side-effect (the `latest` pointer write): skip
                    # it iff a save IN ITS OWN WINDOW — enqueued after the
                    # previous task, before this one — failed, or `latest`
                    # would advance onto a tag with missing files. Earlier
                    # windows' errors must NOT freeze later, successful tags.
                    with self._cv:
                        lo = self._prev_task_seq
                        poisoned = any(lo < es < seq
                                       for es, _p, _e in self._errors)
                        self._prev_task_seq = seq
                if poisoned:
                    logger.error(
                        "[AsyncCheckpointEngine] skipping queued task: a save "
                        "in its batch failed (error surfaces at wait())")
                else:
                    fn()
            except Exception as e:
                logger.error(f"[AsyncCheckpointEngine] write failed: {e}")
                with self._cv:
                    self._errors.append((seq, path, e))
            finally:
                fn = None  # the task's state is freed before the save counts as done
                with self._cv:
                    self._done_seq = seq
                    if path is not None and self._inflight.get(path) == seq:
                        del self._inflight[path]
                    self._cv.notify_all()

    def _enqueue(self, fn, path=None, gated=False):
        path = _key(path)
        with self._cv:
            self._enq_seq += 1
            seq = self._enq_seq
            if path is not None:
                self._inflight[path] = seq
        self._q.put((seq, fn, path, gated))
        return seq

    # ------------------------------------------------------------------
    def save(self, state_dict, path):
        """Enqueue and return. ``state_dict`` leaves must be host-owned (the
        engine's ``_gather_to_host`` yields fresh CPU copies, so the training
        loop updating its tensors in place cannot race the writer)."""
        self._enqueue(
            lambda: NativeCheckpointEngine.save(self, state_dict, path),
            path=path)

    def enqueue_task(self, fn):
        """Run ``fn`` on the writer thread after everything queued so far —
        used for ordered side-effects like the ``latest`` pointer write."""
        self._enqueue(fn, gated=True)

    def wait(self, path=None, raise_errors=True):
        """Block until the newest save for ``path`` (or the whole queue) has
        fully hit disk. With ``raise_errors``, re-raise the first stored
        writer error — scoped to ``path`` when one is given, so a load of an
        intact checkpoint is not failed by an earlier unrelated save error."""
        path = _key(path)
        with self._cv:
            target = self._inflight.get(path, 0) if path is not None \
                else self._enq_seq
            self._cv.wait_for(lambda: self._done_seq >= target)
            if not raise_errors:
                for _s, p, e in self._errors:
                    logger.error(
                        f"[AsyncCheckpointEngine] pending save error for "
                        f"{p}: {e}")
                return
            for i, (_s, p, e) in enumerate(self._errors):
                if path is None or p == path:
                    del self._errors[i]
                    raise RuntimeError(
                        f"async checkpoint save of {p} failed") from e

    def load(self, path, map_location=None):
        self.wait(path)  # read-your-writes; raises only THIS path's error
        return super().load(path, map_location)

    def commit(self, tag) -> bool:
        """Eventually-durable commit (reference nebula commit): non-blocking;
        the tag is complete once the queue drains past this point. Use
        ``wait()`` for a hard durability barrier. The marker is no gated
        task: were it one (as in the JAX package), it would close the
        window of the tag's saves, and the ``latest`` write queued after it
        would run even when those saves failed."""
        self._enqueue(lambda: logger.debug(f"[AsyncCheckpointEngine] tag {tag} durable"))
        return True

    def close(self):
        self.wait()
        self._q.put(None)
        self._thread.join()
        atexit.unregister(self._drain_at_exit)
