"""Fault-tolerant training supervision (a copy of ``deepspeed_tpu/resilience/training.py``
for the port, which imports nothing of the JAX package; the text below is the JAX
module's, with the port's names).

:class:`TrainingSupervisor` owns a ``DeepSpeedEngine``-compatible train
loop the way ``ContinuousBatchScheduler`` owns the inference engine: every
engine call goes through the seeded fault gate (wrap the engine in
:class:`~deepspeed_tpu_torch.resilience.faults.InjectedTrainEngine` to arm it),
transient faults are retried with the bounded deterministic backoff,
wall-clock is watched per step, and whole-engine loss is answered with
checkpoint-based recovery instead of a crash.

The state machine (mirrors the serving scheduler's):

- **healthy**: ``train_batch`` per step, watchdog observes the wall clock,
  breaker records successes, checkpoints are taken on the save cadence.
- **transient fault**: the fault layer guarantees the engine was not
  mutated, so the step re-runs *verbatim* — same batches, regenerated from
  the step index by ``batch_fn`` — under ``RetryPolicy`` backoff; each
  occurrence feeds the breaker. A storm that outlives the retry budget
  escalates to recovery.
- **engine loss** (``DeviceLostError``, watchdog hard breach,
  ``UnrecoverableEngineError``): admit a rebuild under the
  ``RecoveryPolicy`` budget, revive the engine (training rebuild keeps the
  engine object — only device state is lost),
  restore from the last durable checkpoint tag (itself retried/re-admitted:
  the restore path is a fault site too), re-arm the breaker HALF_OPEN, and
  let the main loop **replay forward** to the pre-fault step.

Replay is implicit: ``load_checkpoint`` rolls ``engine.global_steps`` back
to the restored tag, and the loop condition is on ``global_steps`` — so the
loop simply re-executes the lost steps. Because the checkpoint carries the
*complete* step state (params, optimizer moments, loss-scaler, training
PRNGKey, micro-step counter, dataset position — docs/RESILIENCE.md
completeness table) and ``batch_fn`` is a pure function of the step index,
the replayed steps reproduce the uninterrupted run's loss curve **bitwise**
(the ``test_bitwise_cpu_zero1`` discipline, now under chaos); replayed
losses overwrite their slots in :attr:`losses` with identical values.

Determinism discipline (DSTPU005): injectable monotonic clock and sleep,
seeded retry jitter, seeded fault plans, insertion-ordered dicts — a chaos
run replays bit-for-bit from its seeds."""

import time
from typing import Callable, Dict, List, Optional

from .breaker import CircuitBreaker
from .errors import (DeviceLostError, TransientEngineError,
                     UnrecoverableEngineError)
from .recovery import RecoveryPolicy
from .retry import RetryPolicy
from .watchdog import StepWatchdog


class TrainingSupervisor:
    """Owns the train loop over a (possibly fault-injected) training engine.

    ``batch_fn(step_idx)`` must return the micro-batches of global step
    ``step_idx`` — a list of ``gradient_accumulation_steps`` batches — and
    must be a pure function of the index (same index, same batches): it is
    the replay primitive. ``save_dir`` is the durable-tag ring directory;
    ``save_interval`` is in global steps (0 disables periodic saves; the
    run-start save that guarantees a restore target still happens).

    The collaborators default to fresh instances so the supervisor is
    usable with one argument each for engine/batch_fn/save_dir; tests
    inject configured ones (and a fake clock/sleep)."""

    def __init__(self, engine, batch_fn: Callable[[int], List],
                 save_dir: str, *, save_interval: int = 0,
                 retry: Optional[RetryPolicy] = None,
                 watchdog: Optional[StepWatchdog] = None,
                 recovery: Optional[RecoveryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        if save_interval < 0:
            raise ValueError(f"save_interval must be >= 0, got {save_interval}")
        self.engine = engine
        self.batch_fn = batch_fn
        self.save_dir = save_dir
        self.save_interval = save_interval
        self.retry = retry or RetryPolicy()
        self.watchdog = watchdog or StepWatchdog()
        self.recovery = recovery if recovery is not None else RecoveryPolicy()
        self.breaker = breaker or CircuitBreaker()
        self.clock = clock
        self.sleep = sleep
        #: loss per global step, keyed by the step index the loss belongs
        #: to; replayed steps overwrite their slot (bitwise-identically,
        #: which the chaos tests assert). Values are whatever the engine
        #: returned — tensors on the engine's device; conversion is the reader's business
        #: (loss_curve()), never the loop's (no per-step host sync).
        self.losses: Dict[int, object] = {}
        # ---- chaos accounting (the bench's goodput inputs) ----
        self.attempts = 0          # train_batch calls, incl. failed ones
        self.steps_completed = 0   # successful train_batch calls
        self.retries = 0           # transient retries taken
        self.recoveries = 0        # checkpoint recoveries completed
        self.replayed_steps = 0    # steps re-run because a recovery rolled back
        self.saves = 0             # durable checkpoints taken
        self.save_failures = 0     # save attempts abandoned after retries

    # ------------------------------------------------------------------
    def run(self, until_step: int) -> Dict[int, object]:
        """Train until ``engine.global_steps >= until_step``, surviving the
        armed fault plan. Returns :attr:`losses` (step -> loss)."""
        # a restore target must exist BEFORE the first fault can demand one
        if self.engine.global_steps < until_step:
            self._save_checkpoint()
        while self.engine.global_steps < until_step:
            before = self.engine.global_steps
            self._run_one_step()
            after = self.engine.global_steps
            if (self.save_interval and after > before
                    and after % self.save_interval == 0
                    and after < until_step):
                self._save_checkpoint()
        return self.losses

    def loss_curve(self) -> List:
        """Losses in step order — the curve the chaos tests compare bitwise
        against a fault-free reference run."""
        return [self.losses[k] for k in sorted(self.losses)]

    # ------------------------------------------------------------------
    def _run_one_step(self) -> None:
        """One global step with transient retry; faults past retry (or any
        engine-loss signal) route to checkpoint recovery and return — the
        caller's loop condition drives the replay."""
        k = self.engine.global_steps
        batches = self.batch_fn(k)
        attempt = 1
        while True:
            t0 = self.clock()
            try:
                # fresh iterator per attempt over the SAME batches: the
                # fault layer fires before dispatch, so a failed attempt
                # consumed nothing and the retry re-runs verbatim
                loss = self.engine.train_batch(iter(batches))
                self.attempts += 1
            except TransientEngineError as e:
                self.attempts += 1
                self.breaker.on_failure(self.clock())
                if attempt >= self.retry.max_attempts:
                    # transient storm outlived the retry budget: the engine
                    # is effectively lost to us — recover from checkpoint
                    self._recover(f"transient storm at step {k}: {e}")
                    return
                self.sleep(self.retry.delay(attempt, f"train_batch:{k}"))
                attempt += 1
                self.retries += 1
                continue
            except (DeviceLostError, UnrecoverableEngineError) as e:
                self.attempts += 1
                self.breaker.on_failure(self.clock())
                self._recover(str(e))
                return
            try:
                self.watchdog.observe("train_batch", self.clock() - t0)
            except UnrecoverableEngineError as e:
                # hard breach: the step APPLIED but the dispatch pattern
                # says the engine is wedged — recovery restores the last
                # durable tag and replays (bitwise, so no step is damaged)
                self._recover(str(e))
                return
            self.breaker.on_success(self.clock())
            self.recovery.note_engine_ok()
            self.losses[k] = loss
            self.steps_completed += 1
            return

    # ------------------------------------------------------------------
    def _save_checkpoint(self) -> bool:
        """Durable save with transient retry. A save that keeps faulting is
        abandoned (logged via the counter): the previous durable tag stands
        and correctness is unaffected — only the replay window grows."""
        attempt = 1
        while True:
            try:
                self.engine.save_checkpoint(self.save_dir)
                self.saves += 1
                return True
            except TransientEngineError:
                self.breaker.on_failure(self.clock())
                if attempt >= self.retry.max_attempts:
                    self.save_failures += 1
                    return False
                self.sleep(self.retry.delay(attempt, "save_checkpoint"))
                attempt += 1
            except (DeviceLostError, UnrecoverableEngineError) as e:
                self.breaker.on_failure(self.clock())
                self._recover(f"engine lost during save: {e}")
                return False

    # ------------------------------------------------------------------
    def _recover(self, reason: str) -> None:
        """Checkpoint-based recovery: admit under the budget, revive the
        engine, restore the last durable tag (retried; a repeat device loss
        mid-restore re-admits within the same budget), re-arm the breaker."""
        now = self.clock()
        if not self.recovery.admit(now, reason):
            raise UnrecoverableEngineError(
                f"recovery budget exhausted "
                f"({self.recovery.max_consecutive_rebuilds} consecutive "
                f"rebuilds with no healthy step): {reason}")
        pre_fault = self.engine.global_steps
        if hasattr(self.engine, "rebuild"):
            self.engine.rebuild()
        attempt = 1
        while True:
            try:
                self.engine.load_checkpoint(self.save_dir)
                break
            except TransientEngineError as e:
                if attempt >= self.retry.max_attempts:
                    raise UnrecoverableEngineError(
                        f"restore kept faulting transient past the retry "
                        f"budget: {e}") from e
                self.sleep(self.retry.delay(attempt, "load_checkpoint"))
                attempt += 1
            except DeviceLostError as e:
                # the replacement died before restore finished — one more
                # budget admission per death, then revive and re-restore
                now = self.clock()
                if not self.recovery.admit(now, f"device lost mid-restore: {e}"):
                    raise UnrecoverableEngineError(
                        "recovery budget exhausted while restoring: "
                        f"{e}") from e
                if hasattr(self.engine, "rebuild"):
                    self.engine.rebuild()
                attempt = 1
        restored = self.engine.global_steps
        replayed = max(0, pre_fault - restored)
        self.replayed_steps += replayed
        self.recoveries += 1
        self.recovery.note_rebuilt(self.clock(), replayed=replayed,
                                   cancelled=0)
        self.breaker.rearm_half_open(self.clock())

    # ------------------------------------------------------------------
    def report(self) -> Dict[str, object]:
        """Chaos-run accounting for the bench row. ``goodput_ratio`` is
        net steps banked per train_batch attempt — 1.0 on a fault-free run,
        degraded by retries and replays on a chaotic one."""
        injector = getattr(self.engine, "injector", None)
        return {
            "steps_completed": self.steps_completed,
            "net_steps": int(self.engine.global_steps),
            "attempts": self.attempts,
            "retries": self.retries,
            "recoveries": self.recoveries,
            "replayed_steps": self.replayed_steps,
            "saves": self.saves,
            "save_failures": self.save_failures,
            "ckpt_corrupt_fallbacks": int(
                getattr(self.engine, "ckpt_corrupt_fallbacks", 0)),
            "goodput_ratio": (
                float(self.engine.global_steps) / self.attempts
                if self.attempts else 1.0),
            "watchdog_breaches": self.watchdog.breaches,
            "breaker_state": self.breaker.state.name,
            "faults_fired": dict(injector.fired) if injector else {},
            # ZeRO sharded-tier traffic (empty dict when the engine runs
            # without the tier — or is a fake without the accessor)
            "zero": (self.engine.zero_metrics()
                     if hasattr(self.engine, "zero_metrics") else {}),
        }
