"""The training engine at ZeRO stage 0 on one device (counterpart of ``deepspeed_tpu/runtime/engine.py``).

``DeepSpeedEngine`` holds the model's parameters (fp32, or bf16/fp16 lp
parameters with an fp32 master copy), the optimizer and its state, the loss
scaler, the lr scheduler and the data loader, and runs the reference
surface: ``forward`` / ``backward`` / ``step``, ``train_batch``, ``eval``.

Where the JAX engine compiles programs, the port runs eagerly:

- ``forward`` builds the autograd graph and returns the loss tensor;
  ``backward`` runs it. The JAX ``LazyLoss`` (``engine.py:127``), which
  deferred the fused program to ``backward``, has no counterpart beyond
  that tensor.
- Gradients come from ``torch.autograd.grad`` (never accumulated into
  ``.grad``): each micro-step's gradients in the lp dtype, accumulated
  across micro-steps in ``_grad_acc_dtype`` as ``engine.py:1577-1616`` does.
- The step follows ``step_fn`` (``engine.py:831-848``): unscale by
  ``1/cur_scale``; fp32 global norm over all leaves and clipping by
  ``min(1, clip/(gnorm+1e-6))``; the optimizer on the fp32 master (or the
  fp32 params); the update skipped on fp16 overflow; the result cast back
  into the lp parameters in place, so the autograd leaves persist.
- ``train_batch`` at gradient_accumulation_steps 1 is the fused micro-step
  (``engine.py:1863``): forward, backward and step in one call.
- Every training-mode call of the model takes the key
  ``fold_in(PRNGKey(config.seed), micro_steps)`` (``engine.py:752``,
  ``:870``), so dropout draws the JAX engine's masks; evaluation takes none.

``save_checkpoint`` / ``load_checkpoint`` write and read the JAX
package's checkpoint format (``runtime/checkpoint_engine``): a tag saved by
either package loads in the other. A save copies every tensor into a fresh
host buffer (pinned on the card) before it returns, so the async engine
writes the state of the step it was called at; a load reads and verifies both files before it changes any state,
writes the lp parameters in place and rebinds the master copy and the
moments, as each step does.

Runs on ``device`` (default ``"cuda"``); without CUDA it raises unless
``device="cpu"`` is passed. On CUDA the model's attention shape must be one
the flash kernels take, checked at construction. What the port does not run
yet raises ``NotImplementedError`` naming its ROADMAP.md item.
"""

import os
import time
from typing import Union

import numpy as np
import torch

from ..accelerator import resolve_device
from ..ops.optimizers import build_optimizer
from ..ops.transformer.flash_attention import check_kernel_config
from ..resilience.errors import CheckpointCorruptError, EngineUsageError
from ..utils import prng
from ..utils.logging import log_dist, logger
from ..utils.timer import (BACKWARD_MICRO_TIMER, FORWARD_MICRO_TIMER, STEP_MICRO_TIMER,
                           NoopTimer, SynchronizedWallClockTimer, ThroughputTimer)
from ..utils.tree import tree_leaves, tree_map, tree_unflatten
from .checkpoint_engine.native_checkpoint_engine import NativeCheckpointEngine
from .config import DeepSpeedConfig
from .constants import CURRICULUM_LEARNING_LEGACY
from .dataloader import DeepSpeedDataLoader, RepeatingLoader, to_device
from .fp16.loss_scaler import CreateLossScaler, LossScalerState, has_overflow
from .lr_schedules import build_lr_scheduler

_ZERO_ITEM = "ROADMAP.md Queue 1 item 13, ZeRO and offload"
_FEATURE_ITEM = "ROADMAP.md Queue 1 item 17"
_PERIPHERY_ITEM = "ROADMAP.md Queue 1 item 18, periphery"


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to deepspeed_tpu_torch ({item})")


def _global_norm(grads) -> torch.Tensor:
    return torch.sqrt(torch.stack([torch.sum(torch.square(g.float()))
                                   for g in tree_leaves(grads)]).sum())


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A fresh host copy of ``t``: on the card one pinned buffer, filled by
    one copy queued on the current stream, which the caller waits for."""
    t = t.detach()
    if t.device.type == "cpu":
        return t.clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def _gather_to_host(tree):
    """A host copy of ``tree``: every tensor copied once into a buffer of
    its own (``_host_copy``; on the card the copies are waited for together
    at the end), every dict's keys in sorted order (the order the JAX
    package's gather, a ``jax.tree.map``, gives the checkpoint's metadata);
    other leaves pass. Under ``DSTPU_SANITIZE=1`` the copy is held to its
    source (``check_gather_conservation``)."""
    streams = set()

    def copy(t):
        if isinstance(t, dict):
            return {k: copy(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(copy(v) for v in t)
        if not isinstance(t, torch.Tensor):
            return t
        if t.is_cuda:
            streams.add(torch.cuda.current_stream(t.device))
        return _host_copy(t)

    out = copy(tree)
    for s in streams:
        s.synchronize()
    from ..analysis.sanitizer import sanitize_enabled

    if sanitize_enabled():
        from ..analysis.sanitizer import check_gather_conservation

        check_gather_conservation(tree, out)
    return out


def _host_tensor(x) -> torch.Tensor:
    """A leaf read from a checkpoint (a numpy array, or a CPU tensor for a
    dtype numpy lacks) as a CPU tensor."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def _match(template, saved, what):
    """``saved`` (a checkpoint's tree of host leaves) in ``template``'s
    structure, each leaf a CPU tensor of the template leaf's shape."""
    if isinstance(template, dict):
        if not isinstance(saved, dict) or set(saved) != set(template):
            raise ValueError(
                f"checkpoint {what} does not match the engine's parameter tree: keys "
                f"{sorted(saved) if isinstance(saved, dict) else type(saved).__name__} "
                f"vs {sorted(template)}")
        return {k: _match(template[k], saved[k], f"{what}/{k}") for k in template}
    t = _host_tensor(saved)
    if tuple(t.shape) != tuple(template.shape):
        raise ValueError(f"checkpoint {what} has shape {tuple(t.shape)}, the engine's "
                         f"parameter {tuple(template.shape)}")
    return t


def _check_supported(config: DeepSpeedConfig, model) -> None:
    pld = config.progressive_layer_drop or {}
    routing = (config.data_efficiency_config or {}).get("data_routing", {})
    curriculum = config._param_dict.get(CURRICULUM_LEARNING_LEGACY, {}) or {}
    unsupported = (
        ("steps_per_execution > 1", config.steps_per_execution > 1, _FEATURE_ITEM),
        ("compression_training", bool(config.compression_config)
         or getattr(model, "_compression_scheduler", None) is not None, _FEATURE_ITEM),
        ("curriculum_learning", bool(curriculum.get("enabled")), _FEATURE_ITEM),
        ("progressive_layer_drop", bool(pld.get("enabled")), _FEATURE_ITEM),
        ("random_ltd", bool(routing.get("enabled")), _FEATURE_ITEM),
        ("monitors (csv/tensorboard/wandb)",
         any(m.enabled for m in config.monitor_config.values()), _PERIPHERY_ITEM),
        ("flops_profiler", config.flops_profiler_config.enabled, _PERIPHERY_ITEM),
        ("elasticity", config.elasticity_enabled, _PERIPHERY_ITEM),
    )
    for what, bad, item in unsupported:
        if bad:
            raise _not_ported(what, item)


class DeepSpeedEngine:
    def __init__(self, model, config: DeepSpeedConfig, optimizer=None, lr_scheduler=None,
                 training_data=None, collate_fn=None, model_params=None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.config = config
        self.module = model
        _check_supported(config, model)
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self._cached = None  # the loss of the last training-mode forward
        self._training = True
        self._train_iter = None
        self._last_global_norm = None
        # batches consumed from the engine-owned training iterator: saved, so
        # a resume continues at the same dataset position
        self._data_position = 0
        # durable-tag ring fallbacks taken because `latest` pointed at a
        # checkpoint that failed integrity verification
        self.ckpt_corrupt_fallbacks = 0
        if config.checkpoint_config.async_save:
            from .checkpoint_engine.async_checkpoint_engine import AsyncCheckpointEngine

            self.checkpoint_engine = AsyncCheckpointEngine()
        else:
            self.checkpoint_engine = NativeCheckpointEngine()
        self.loaded_checkpoint_tag = None
        #: seconds in the save's device-to-host gather and the load's host-to-device
        #: restore (the checkpoint engine's ``stats`` holds the file side)
        self.ckpt_stats = {"gather_s": 0.0, "restore_s": 0.0}

        # ---- precision ----
        if config.fp16_enabled:
            self.compute_dtype = torch.float16
        elif config.bfloat16_enabled or config.amp_enabled:
            self.compute_dtype = torch.bfloat16
        else:
            self.compute_dtype = torch.float32
        self._mixed = self.compute_dtype != torch.float32

        # ---- timers ----
        self.wall_clock_breakdown = config.wall_clock_breakdown
        self.timers = SynchronizedWallClockTimer() if self.wall_clock_breakdown else NoopTimer()
        self.tput_timer = ThroughputTimer(batch_size=config.train_batch_size,
                                          steps_per_output=config.steps_per_print or 50)

        # ---- model params + apply fn ----
        params, self._apply_fn = self._extract_model(model, model_params)
        mc = getattr(model, "config", None)
        if self.device.type == "cuda" and mc is not None and hasattr(mc, "head_dim"):
            check_kernel_config(mc.num_heads, mc.kv_heads, mc.head_dim, self.compute_dtype)

        def lp(p):  # a fresh tensor: the lp params are updated in place
            t = torch.as_tensor(p).detach()
            out = t.to(device=self.device, dtype=self.compute_dtype)
            return (out.clone() if out is t else out).requires_grad_()

        self.params = tree_map(lp, params)
        # the master copy is rebound (never written in place) each step, so
        # it may share storage with the caller's fp32 tensors
        self.master_params = (tree_map(lambda p: torch.as_tensor(p).detach().to(
            device=self.device, dtype=torch.float32), params) if self._mixed else None)

        # the base key of every training-mode forward (engine.py:342)
        self._rng = prng.PRNGKey(config.seed, device=self.device)

        # ---- optimizer ----
        self.client_optimizer = optimizer
        if optimizer is not None:
            self.optimizer = optimizer
        elif config.optimizer_name is not None:
            self.optimizer = build_optimizer(config.optimizer_name, config.optimizer_params)
        else:
            self.optimizer = None
        self.opt_state = (self.optimizer.init(self._update_target())
                          if self.optimizer is not None else None)

        # ---- loss scaling ----
        self.loss_scaler = CreateLossScaler(config.fp16_config, config.fp16_enabled)
        self.scaler_state = self.loss_scaler.init_state(self.device)

        # ---- lr scheduler ----
        self.client_lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler = lr_scheduler
        elif config.scheduler_name is not None:
            self.lr_scheduler = build_lr_scheduler(config.scheduler_name, self.optimizer,
                                                   config.scheduler_params)
        else:
            self.lr_scheduler = None

        # ---- gradient accumulation buffer ----
        self._acc_grads = None

        # ---- dataloader ----
        self.training_dataloader = None
        if training_data is not None:
            self.training_dataloader = self.deepspeed_io(training_data, collate_fn=collate_fn)

        log_dist(
            f"DeepSpeedEngine: zero_stage=0 dtype={self.compute_dtype} device={self.device} "
            f"batch=({config.train_batch_size},{config.train_micro_batch_size_per_gpu},"
            f"{config.gradient_accumulation_steps})",
            ranks=[0],
        )

    def _extract_model(self, model, model_params=None):
        """Accept (params, apply_fn) pairs, objects exposing
        ``.params``/``.apply``, or ``.init_params``/``.apply``. A model built
        here takes ``init_params(torch.Generator(device).manual_seed(0))``:
        the JAX engine's ``PRNGKey(0)`` draws other numbers."""
        if isinstance(model, tuple) and len(model) == 2:
            return model
        if model_params is not None:
            return model_params, model.apply
        if hasattr(model, "params") and hasattr(model, "apply"):
            return model.params, model.apply
        if hasattr(model, "init_params") and hasattr(model, "apply"):
            gen = torch.Generator(device=self.device).manual_seed(0)
            return model.init_params(gen), model.apply
        raise TypeError(
            "model must be (params, apply_fn), or expose .params/.apply or .init_params/.apply")

    def _update_target(self):
        """What the optimizer updates: the fp32 master, or the fp32 params."""
        if self._mixed:
            return self.master_params
        return tree_map(lambda p: p.detach(), self.params)

    @staticmethod
    def _loss_of(out):
        return out[0] if isinstance(out, tuple) else out

    # ------------------------------------------------------------------
    # reference API surface
    # ------------------------------------------------------------------
    def train(self, mode: bool = True):
        self._training = mode
        return self

    def eval(self):
        return self.train(False)

    def __call__(self, batch, **kwargs):
        return self.forward(batch, **kwargs)

    def forward(self, batch, **kwargs):
        """The micro-step loss. In training mode the autograd graph is kept
        for ``backward``; after ``eval()`` the loss is computed with
        ``train=False`` and no graph, as an fp32 scalar."""
        if kwargs:
            raise TypeError(
                f"forward() got unexpected kwargs {sorted(kwargs)}: pass model inputs "
                "inside `batch` (the apply_fn receives it whole)")
        self.timers(FORWARD_MICRO_TIMER).start()
        batch = to_device(batch, self.device)
        if not self._training:
            with torch.no_grad():
                loss = self._loss_of(self._apply_fn(self.params, batch, train=False,
                                                    rng=None)).float()
            self.timers(FORWARD_MICRO_TIMER).stop()
            return loss
        loss = self._loss_of(self._apply_fn(self.params, batch, train=True,
                                            rng=self._micro_step_key()))
        self._cached = loss
        self.timers(FORWARD_MICRO_TIMER).stop()
        return loss

    def _micro_step_key(self):
        """The micro-step's key, ``fold_in(base, micro_steps)`` as the JAX
        engine derives it on the device (``engine.py:752``)."""
        return prng.fold_in(self._rng, self.micro_steps)

    def _grads_of(self, scaled):
        """Gradients of ``scaled`` w.r.t. the lp params, in their dtype; a
        parameter the loss does not reach gets zeros, as under ``jax.grad``."""
        leaves = list(tree_leaves(self.params))
        gs = torch.autograd.grad(scaled, leaves, allow_unused=True)
        return tree_unflatten(self.params, [torch.zeros_like(p) if g is None else g
                                            for p, g in zip(leaves, gs)])

    def backward(self, loss=None, retain_graph: bool = False):
        """Run the last forward's graph and fold its gradients into the
        accumulation buffer. With gradient_accumulation_steps == 1 the buffer
        is the gradients themselves."""
        if self._cached is None:
            raise EngineUsageError("backward() called without a preceding forward()")
        self.timers(BACKWARD_MICRO_TIMER).start()
        gas = self.config.gradient_accumulation_steps
        grads = self._grads_of(self._cached.float() * self.scaler_state.cur_scale / gas)
        self._cached = None
        if gas == 1:
            self._acc_grads = grads
        elif self._acc_grads is None:
            acc_dtype = self._grad_acc_dtype()
            self._acc_grads = tree_map(lambda g: g.to(acc_dtype), grads)
        else:
            self._acc_grads = tree_map(lambda a, g: a + g.to(a.dtype), self._acc_grads, grads)
        self.micro_steps += 1
        self.timers(BACKWARD_MICRO_TIMER).stop()
        return loss

    def _grad_acc_dtype(self):
        name = self.config.gradient_accumulation_dtype
        if name is None:
            return torch.float32 if self._mixed else self.compute_dtype
        return {"fp32": torch.float32, "fp16": torch.float16, "bf16": torch.bfloat16}[name]

    def is_gradient_accumulation_boundary(self) -> bool:
        return self.micro_steps % self.config.gradient_accumulation_steps == 0

    def get_lr(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler.get_last_lr()
        return [self.optimizer.lr if self.optimizer else 0.0]

    @torch.no_grad()
    def _apply_update(self, acc_grads, lr):
        """``step_fn`` (``engine.py:831-848``). Returns (gnorm, overflow)."""
        cfg = self.config
        inv = 1.0 / self.scaler_state.cur_scale
        grads = tree_map(lambda g: g.float() * inv, acc_grads)
        overflow = (has_overflow(grads) if cfg.fp16_enabled
                    else torch.zeros((), dtype=torch.bool, device=self.device))
        gnorm = _global_norm(grads)
        if cfg.gradient_clipping > 0:
            coef = torch.clamp(cfg.gradient_clipping / (gnorm + 1e-6), max=1.0)
            grads = tree_map(lambda g: g * coef, grads)
        target = self._update_target()
        new_master, new_opt = self.optimizer.update(grads, self.opt_state, target, lr)
        if cfg.fp16_enabled:  # skip the update entirely on overflow
            def keep(old, new):
                return tree_map(lambda o, n: torch.where(overflow, o, n), old, new)

            new_master = keep(target, new_master)
            new_opt = type(new_opt)(*(keep(o, n) for o, n in zip(self.opt_state, new_opt)))
        for p, n in zip(tree_leaves(self.params), tree_leaves(new_master)):
            p.copy_(n)  # cast back to the lp dtype, in place
        if self._mixed:
            self.master_params = new_master
        self.opt_state = new_opt
        self.scaler_state = self.loss_scaler.update(self.scaler_state, overflow)
        return gnorm, overflow

    def _after_step(self, gnorm, overflow):
        self._last_global_norm = gnorm
        self.global_steps += 1
        self.global_samples += self.config.train_batch_size
        # only fp16 can overflow; bool(overflow) is a host sync, paid only there
        if self.config.fp16_enabled and bool(overflow):
            self.skipped_steps += 1
            log_dist(f"[step {self.global_steps}] overflow: skipping step, loss scale -> "
                     f"{float(self.scaler_state.cur_scale)}", ranks=[0])
        elif self.lr_scheduler is not None:
            self.lr_scheduler.step()
        every = self.config.steps_per_print
        if every and self.global_steps % every == 0:
            log_dist(f"step={self.global_steps} lr={self.get_lr()} "
                     f"grad_norm={float(gnorm):.4f} skipped={self.skipped_steps}", ranks=[0])

    def step(self):
        """Optimizer step at gradient-accumulation boundaries (no-op otherwise)."""
        if self.micro_steps == 0 or not self.is_gradient_accumulation_boundary():
            return
        if self.optimizer is None:
            raise EngineUsageError("no optimizer configured")
        self.timers(STEP_MICRO_TIMER).start()
        gnorm, overflow = self._apply_update(self._acc_grads, self.get_lr()[0])
        self._acc_grads = None
        self._after_step(gnorm, overflow)
        self.timers(STEP_MICRO_TIMER).stop()
        if self.wall_clock_breakdown and self.config.steps_per_print and \
                self.global_steps % self.config.steps_per_print == 0:
            self.timers.log([FORWARD_MICRO_TIMER, BACKWARD_MICRO_TIMER, STEP_MICRO_TIMER])

    def train_batch(self, data_iter=None):
        """One full global batch = GAS micro-steps + optimizer step. Returns the
        mean micro-loss."""
        if data_iter is None and self.training_dataloader is None:
            raise ValueError("train_batch needs a data_iter or training_data at init")
        if data_iter is not None:
            it = data_iter
        else:
            if self._train_iter is None:
                inner = iter(RepeatingLoader(self.training_dataloader))
                # resume: skip to the saved dataset position (the repeating
                # loader repeats the epoch order, so the position modulo the
                # epoch's length is the offset in the epoch; an iterable
                # dataset has no length and is not skipped)
                if self._data_position:
                    try:
                        epoch_len = len(self.training_dataloader)
                    except TypeError:
                        epoch_len = 0
                    for _ in range(self._data_position % epoch_len if epoch_len else 0):
                        next(inner)
                self._train_iter = self._count_batches(inner)
            it = self._train_iter
        self.tput_timer.start()
        if (self.config.gradient_accumulation_steps == 1 and self.optimizer is not None
                and self._training):
            loss = self._fused_micro_step(next(it))
            self.tput_timer.stop(global_step=True)
            return loss
        losses = []
        for _ in range(self.config.gradient_accumulation_steps):
            loss = self.forward(next(it))
            self.backward(loss)
            losses.append(loss.detach().float())
        self.step()
        self.tput_timer.stop(global_step=True)
        return torch.stack(losses).mean()

    def _count_batches(self, inner):
        """The engine-owned iterator: every batch pulled moves
        ``_data_position``, which checkpoints save. The positions of a
        ``data_iter`` the caller passes are the caller's to keep."""
        for batch in inner:
            self._data_position += 1
            yield batch

    def _fused_micro_step(self, batch):
        """Forward, backward and step in one call (the GAS=1 path)."""
        self.timers(STEP_MICRO_TIMER).start()
        batch = to_device(batch, self.device)
        lr = self.get_lr()[0]
        loss = self._loss_of(self._apply_fn(self.params, batch, train=True,
                                            rng=self._micro_step_key()))
        grads = self._grads_of(loss.float() * self.scaler_state.cur_scale)
        gnorm, overflow = self._apply_update(grads, lr)
        self.micro_steps += 1
        self._after_step(gnorm, overflow)
        self.timers(STEP_MICRO_TIMER).stop()
        return loss.detach()

    def deepspeed_io(self, dataset, batch_size=None, collate_fn=None, shuffle=True):
        """Build the data loader (reference ``engine.py:1697 deepspeed_io``)."""
        return DeepSpeedDataLoader(
            dataset,
            batch_size=batch_size or self.config.train_micro_batch_size_per_gpu,
            device=self.device, collate_fn=collate_fn, shuffle=shuffle,
            seed=self.config.seed, drop_last=self.config.dataloader_drop_last)

    # ------------------------------------------------------------------
    # checkpoints (reference engine.py:1962-2360, stage 0)
    # ------------------------------------------------------------------
    def _to_device(self, tree):
        """A tree of host leaves (tensors or numpy arrays) on the engine's
        device, one copy a leaf."""
        return tree_map(lambda t: _host_tensor(t).to(self.device), tree)

    def _ckpt_paths(self, save_dir, tag):
        d = os.path.join(save_dir, str(tag))
        return d, os.path.join(d, "model_states.ckpt"), os.path.join(d, "optim_states.ckpt")

    @staticmethod
    def _durable_tags_before(load_dir, tag):
        """The durable-tag ring behind ``tag``: every other ``global_step<N>``
        directory under ``load_dir`` that has a model file, newest first.
        These are the fallback candidates when the tag ``latest`` points at
        fails integrity verification — sorted descending so the fallback
        loses the fewest steps."""
        def step_of(name):
            try:
                return int(name[len("global_step"):])
            except ValueError:
                return -1

        try:
            names = os.listdir(load_dir)
        except OSError:
            return []
        ring = [n for n in names
                if n != tag and n.startswith("global_step") and step_of(n) >= 0
                and os.path.exists(os.path.join(load_dir, n, "model_states.ckpt"))]
        return sorted(ring, key=step_of, reverse=True)

    def save_checkpoint(self, save_dir, tag=None, client_state=None, save_latest=True,
                        exclude_frozen_parameters=False):
        """Save the step state under ``save_dir/tag`` (default
        ``global_step<N>``): ``model_states.ckpt`` (the fp32 master when
        mixed, else the params; counters, the training key, the dataset
        position, the lr schedule, ``client_state``) and
        ``optim_states.ckpt`` (Adam's step and moments, the loss scaler),
        then ``latest``. Every tensor is copied to the host before this
        returns; the async engine writes the files later, and ``latest``
        only after them."""
        if tag is None:
            tag = f"global_step{self.global_steps}"
        d, model_path, optim_path = self._ckpt_paths(save_dir, tag)
        self.checkpoint_engine.makedirs(d, exist_ok=True)
        self.checkpoint_engine.create(tag)
        cfg = self.config
        model_sd = {
            "module": self.master_params if self._mixed else self.params,
            "dtype": str(self.compute_dtype).replace("torch.", ""),
            "global_steps": self.global_steps,
            "global_samples": self.global_samples,
            "skipped_steps": self.skipped_steps,
            # bitwise resume needs all three: the training key each
            # micro-step folds, the micro-step counter it folds with, and
            # the dataset position
            "rng": self._rng.cpu().numpy().astype(np.uint32),
            "micro_steps": self.micro_steps,
            "data_position": self._data_position,
            "ds_config_batch": [cfg.train_batch_size, cfg.train_micro_batch_size_per_gpu,
                                cfg.gradient_accumulation_steps],
            "client_state": client_state or {},
        }
        if self.lr_scheduler is not None:
            model_sd["lr_scheduler"] = self.lr_scheduler.state_dict()
        optim_sd = None
        if self.opt_state is not None:
            optim_sd = {"step": self.opt_state.step, "m": self.opt_state.m,
                        "v": self.opt_state.v, "scaler": self.scaler_state._asdict()}
        t0 = time.perf_counter()
        model_sd = _gather_to_host(model_sd)
        if optim_sd is not None:
            optim_sd = _gather_to_host(optim_sd)
        self.ckpt_stats["gather_s"] += time.perf_counter() - t0
        self.checkpoint_engine.save(model_sd, model_path)
        if optim_sd is not None:
            self.checkpoint_engine.save(optim_sd, optim_path)

        self.checkpoint_engine.commit(tag)
        if save_latest:
            def _write_latest():
                # tmp → os.replace: a crash mid-write must never leave a
                # truncated `latest` shadowing the previous complete pointer
                final = os.path.join(save_dir, "latest")
                tmp = final + ".tmp"
                with open(tmp, "w") as f:
                    f.write(str(tag))
                os.replace(tmp, final)

            if hasattr(self.checkpoint_engine, "enqueue_task"):
                # async engine: the pointer write rides the FIFO queue, so
                # `latest` moves only after every file of this tag is on disk
                self.checkpoint_engine.enqueue_task(_write_latest)
            else:
                _write_latest()
        log_dist(f"saved checkpoint {tag} to {save_dir}", ranks=[0])
        return True

    def _read_tag(self, load_dir, tag, from_latest, want_optim):
        """Both files of the first tag that verifies (``tag``, then the ring
        behind it when it came from ``latest``), a sharded optimizer file
        consolidated; nothing of the engine changes here."""
        tags = [tag] + (self._durable_tags_before(load_dir, tag) if from_latest else [])
        last_err = None
        for t in tags:
            d, model_path, optim_path = self._ckpt_paths(load_dir, t)
            try:
                m_sd = self.checkpoint_engine.load(model_path)
                o_sd = (self.checkpoint_engine.load(optim_path)
                        if want_optim and os.path.exists(optim_path) else None)
                if o_sd is not None and "zero_sharded" in o_sd:
                    # a JAX stage>=2 save: full moments from the per-rank
                    # files, inside the ring loop, so a torn shard falls back
                    # like any other corrupt file
                    from .checkpoint_engine.consolidate import (consolidate_sharded_optim,
                                                                consolidated_as_trees)

                    o_sd = consolidated_as_trees(
                        consolidate_sharded_optim(self.checkpoint_engine, d, o_sd), self.params)
            except CheckpointCorruptError as e:
                e.tag = e.tag or t
                last_err = e
                if from_latest:
                    # one fallback hop per corrupt tag skipped over
                    self.ckpt_corrupt_fallbacks += 1
                    logger.warning(
                        f"checkpoint tag '{t}' failed integrity verification "
                        f"({e}); falling back to the previous durable tag")
                    continue
                raise
            return t, model_path, m_sd, o_sd
        raise CheckpointCorruptError(
            f"no loadable checkpoint under {load_dir}: 'latest' tag and "
            f"every earlier durable tag failed verification "
            f"(last: {last_err})", tag=tag) from last_err

    def load_checkpoint(self, load_dir, tag=None, load_module_strict=True,
                        load_optimizer_states=True, load_lr_scheduler_states=True,
                        load_module_only=False):
        """Restore a tag saved by either package (``latest`` when ``tag`` is
        None, falling back through the durable-tag ring past a corrupt one;
        a named tag that fails verification raises). Returns
        ``(model_path, client_state)``, or ``(None, {})`` when there is no
        ``latest``."""
        if hasattr(self.checkpoint_engine, "wait"):
            # async engine: every queued file and `latest` must be on disk;
            # an earlier unrelated save's error is logged, not raised
            self.checkpoint_engine.wait(raise_errors=False)
        if self.config.load_universal_checkpoint and os.path.exists(
                os.path.join(load_dir, "universal_meta.pkl")):
            from ..checkpoint.universal import load_universal_into_engine

            load_universal_into_engine(self, load_dir)
            self.loaded_checkpoint_tag = "universal"
            return load_dir, {}
        from_latest = tag is None
        if tag is None:
            latest = os.path.join(load_dir, "latest")
            if not os.path.isfile(latest):
                logger.warning(f"no 'latest' file at {load_dir}; nothing loaded")
                return None, {}
            with open(latest) as f:
                tag = f.read().strip()
        want_optim = load_optimizer_states and not load_module_only
        tag, model_path, model_sd, optim_sd = self._read_tag(load_dir, tag, from_latest,
                                                             want_optim)
        if optim_sd is not None and "offload_host" in optim_sd:
            raise _not_ported("loading an optimizer-offload checkpoint (offload_host)",
                              _ZERO_ITEM)
        module = _match(self.params, model_sd["module"], "module")
        m = v = None
        if optim_sd is not None and self.opt_state is not None:
            m, v = (None if optim_sd[k] is None else _match(self.params, optim_sd[k], k)
                    for k in ("m", "v"))

        t0 = time.perf_counter()
        self._restore_params(module)
        self.global_steps = int(model_sd.get("global_steps", 0))
        self.global_samples = int(model_sd.get("global_samples", 0))
        self.skipped_steps = int(model_sd.get("skipped_steps", 0))
        # a checkpoint without "micro_steps" was taken at a GAS boundary
        self.micro_steps = int(model_sd.get(
            "micro_steps", self.global_steps * self.config.gradient_accumulation_steps))
        self._data_position = int(model_sd.get("data_position", 0))
        saved_rng = model_sd.get("rng")
        if saved_rng is not None:
            self._rng = torch.from_numpy(np.asarray(saved_rng).astype(np.int64)).to(self.device)
        # in-flight micro-step state means nothing across a restore: the
        # resumed run re-pulls its batches
        self._cached = None
        self._acc_grads = None
        self._train_iter = None
        if load_lr_scheduler_states and self.lr_scheduler is not None \
                and "lr_scheduler" in model_sd:
            self.lr_scheduler.load_state_dict(model_sd["lr_scheduler"])
        if optim_sd is not None and self.opt_state is not None:
            self.opt_state = type(self.opt_state)(
                step=torch.tensor(int(np.asarray(optim_sd["step"])), dtype=torch.int32,
                                  device=self.device),
                m=None if m is None else self._to_device(m),
                v=None if v is None else self._to_device(v))
            self._restore_scaler(optim_sd.get("scaler"))
        self.ckpt_stats["restore_s"] += time.perf_counter() - t0
        self.loaded_checkpoint_tag = tag
        log_dist(f"loaded checkpoint {tag} from {load_dir}", ranks=[0])
        return model_path, model_sd.get("client_state", {})

    def _restore_params(self, module):
        """Write a tree of host fp32 leaves (the params' structure) into the
        engine: the lp parameters in place (the autograd leaves persist),
        the master copy rebound, as a step rebinds it."""
        dev = self._to_device(tree_map(lambda t: t.float(), module))
        with torch.no_grad():
            for p, n in zip(tree_leaves(self.params), tree_leaves(dev)):
                p.copy_(n)
        if self._mixed:
            self.master_params = dev

    def _restore_scaler(self, sc):
        if sc is None:
            return
        dev = self.device
        self.scaler_state = LossScalerState(
            cur_scale=torch.tensor(float(np.asarray(sc["cur_scale"])), dtype=torch.float32,
                                   device=dev),
            cur_hysteresis=torch.tensor(int(np.asarray(sc["cur_hysteresis"])),
                                        dtype=torch.int32, device=dev),
            last_overflow_iter=torch.tensor(int(np.asarray(sc["last_overflow_iter"])),
                                            dtype=torch.int32, device=dev),
            iter_=torch.tensor(int(np.asarray(sc["iter_"])), dtype=torch.int32, device=dev))

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def get_global_grad_norm(self):
        return self._last_global_norm

    def zero_optimization(self) -> bool:
        return False

    def zero_optimization_stage(self) -> int:
        return 0

    def get_fp32_params(self):
        """Full-precision view of the module weights, as CPU fp32 tensors."""
        src = self.master_params if self._mixed else self.params
        return tree_map(lambda p: p.detach().float().cpu(), src)

    @property
    def train_batch_size(self):
        return self.config.train_batch_size

    @property
    def train_micro_batch_size_per_gpu(self):
        return self.config.train_micro_batch_size_per_gpu

    @property
    def gradient_accumulation_steps(self):
        return self.config.gradient_accumulation_steps

    def loss_scale(self):
        return float(self.scaler_state.cur_scale)
