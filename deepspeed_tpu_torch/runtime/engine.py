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

Runs on ``device`` (default ``"cuda"``); without CUDA it raises unless
``device="cpu"`` is passed. On CUDA the model's attention shape must be one
the flash kernels take, checked at construction. What the port does not run
yet raises ``NotImplementedError`` naming its ROADMAP.md item.
"""

from typing import Union

import torch

from ..accelerator import resolve_device
from ..ops.optimizers import build_optimizer
from ..ops.transformer.flash_attention import check_kernel_config
from ..resilience.errors import EngineUsageError
from ..utils import prng
from ..utils.logging import log_dist
from ..utils.timer import (BACKWARD_MICRO_TIMER, FORWARD_MICRO_TIMER, STEP_MICRO_TIMER,
                           NoopTimer, SynchronizedWallClockTimer, ThroughputTimer)
from ..utils.tree import tree_leaves, tree_map, tree_unflatten
from .config import DeepSpeedConfig
from .constants import CURRICULUM_LEARNING_LEGACY
from .dataloader import DeepSpeedDataLoader, RepeatingLoader, to_device
from .fp16.loss_scaler import CreateLossScaler, has_overflow
from .lr_schedules import build_lr_scheduler

_CKPT_ITEM = "ROADMAP.md Queue 1 item 12, checkpoints"
_FEATURE_ITEM = "ROADMAP.md Queue 1 item 17"
_PERIPHERY_ITEM = "ROADMAP.md Queue 1 item 18, periphery"


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to deepspeed_tpu_torch ({item})")


def _global_norm(grads) -> torch.Tensor:
    return torch.sqrt(torch.stack([torch.sum(torch.square(g.float()))
                                   for g in tree_leaves(grads)]).sum())


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
                self._train_iter = iter(RepeatingLoader(self.training_dataloader))
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

    def save_checkpoint(self, *args, **kwargs):
        raise _not_ported("save_checkpoint", _CKPT_ITEM)

    def load_checkpoint(self, *args, **kwargs):
        raise _not_ported("load_checkpoint", _CKPT_ITEM)

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
