"""The training engine (counterpart of ``deepspeed_tpu/runtime/engine.py``).

``DeepSpeedEngine`` holds the model's parameters (fp32, or bf16/fp16 lp
parameters with an fp32 master copy), the optimizer and its state, the loss
scaler, the lr scheduler and the data loader, and runs the reference
surface: ``forward`` / ``backward`` / ``step``, ``train_batch``, ``eval``.

ZeRO on one card. Stages 1-3 with the optimizer state on the device are
the stage-0 arithmetic, as in the JAX package at a ZeRO degree of 1; a
stage >= 2 engine saves its moments in the sharded format. With
``offload_optimizer`` (``cpu`` or ``nvme``) the engine never builds the fp32
master or the optimizer state on the device: they live in host RAM (the
moments optionally on NVMe) and the C++ CPU Adam steps them
(``_step_offload``, ``engine.py:1207-1293``): the gradient norm on the device,
the clip coefficient on the host, each leaf's gradient streamed to the host
in the compute dtype while the previous chunk is stepped, each updated chunk
cast on the host into one of two pinned staging buffers and uploaded into
the lp parameter in place, the upload running while the next chunk is
stepped; ``ratio`` < 1
keeps the smallest leaves on the device, stepped by ``FusedAdam``. At stage
>= 2 with ``cpu`` and ratio 1 the host tier is the sharded one
(``ZeroShardedTier``) and stage 3 adds parameter residency
(``_z3_release_and_prefetch``, ``_ensure_zero3_params``). Every offload
byte rides one TransferEngine ledger.

ZeRO across ranks. With a process group larger than one rank
(``comm.init_distributed``, one process a rank), the engine is
data-parallel over the topology's ZeRO axes (``runtime/zero/data_parallel.py``):
every rank passes the global micro-batch and keeps its rows; each
micro-step's gradient is reduce-scattered onto the stage-2 layout at every
stage (one reduction order, so stages 1-3 reach stage 0's parameters bit
for bit); stages 0 and 1 all-gather the reduced shards; from stage 1 the
fp32 master and the moments are this rank's shard and the updated lp shard
is all-gathered; at stage 3 the weights live as shards, gathered a layer
before its forward and again before its backward. The gradient norm is the
all-reduced sum of the shards' squares and an fp16 overflow is all-reduced,
so every rank skips the same steps. ZeRO++ (qwZ, qgZ, hpZ) and the 1-bit
optimizers' compressed all-reduce (``_onebit_active``) ride the same path.
The offload tiers at N ranks all-reduce the gradient; the sharded tier
then steps only this rank's ``PartitionPlan`` slice. A checkpoint keeps
the JAX package's layout: rank 0 writes the module tree and the meta, each
rank its moments' shard file.

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

Tensor parallelism. With a ``model`` axis larger than 1 (the ``mesh``
block, one process a rank) the engine holds this rank's TP shards of the
leaves by the model's ``tp_specs`` (``runtime/tensor_parallel.py``; a whole
tree given is cut, a tree of shards taken as it is), and ZeRO shards those
over the data group. The model runs its collectives on the model group; the
gradients of replicated leaves are the same on every TP rank (their inputs
are, after the all-reduces) and are not reduced over it. The gradient norm
and the fp16 overflow count a TP-sharded leaf on every rank and a
replicated one once; 1-bit LAMB's trust ratio takes its norms over the
shard's groups. Checkpoints gather the model axis as well as the ZeRO
shards, so the files hold the JAX package's global leaves, and a load
slices them. The offload tiers under tensor parallelism are ROADMAP.md
Queue 1 item 13d and raise.

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

import inspect
import os
import time
from typing import Union

import numpy as np
import torch

from ..accelerator import resolve_device
from ..analysis.program_audit import audited_program
from ..comm import comm as dist
from ..comm.topology import MESH_AXES, MODEL_AXIS, ZERO_AXES, get_topology
from ..ops.optimizers import OptState, build_optimizer
from ..ops.transformer.flash_attention import check_kernel_config
from ..resilience.errors import CheckpointCorruptError, EngineUsageError
from ..utils import prng
from ..utils.logging import log_dist, logger
from ..utils.timer import (BACKWARD_MICRO_TIMER, FORWARD_MICRO_TIMER, STEP_MICRO_TIMER,
                           NoopTimer, SynchronizedWallClockTimer, ThroughputTimer)
from ..utils.tree import tree_leaves, tree_map, tree_unflatten
from .zero.offload import host_f32, lp_cast
from .checkpoint_engine.native_checkpoint_engine import NativeCheckpointEngine
from .config import DeepSpeedConfig
from .constants import CURRICULUM_LEARNING_LEGACY
from .dataloader import DeepSpeedDataLoader, RepeatingLoader, to_device
from .fp16.loss_scaler import CreateLossScaler, LossScalerState, has_overflow
from .lr_schedules import build_lr_scheduler

_FEATURE_ITEM = "ROADMAP.md Queue 1 item 17"
_PERIPHERY_ITEM = "ROADMAP.md Queue 1 item 18, periphery"
_HOST_TIERS_ITEM = "ROADMAP.md Queue 1 item 13d, host tiers across ranks"


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


def _offload_as_full_lists(optim_sd, saved_h, saved_d, n):
    """Per-leaf (master, m, v) flat fp32 lists of an ``offload_host`` file
    under its saved split (``saved_h`` None: every leaf on the host)."""
    oh = optim_sd["offload_host"]
    saved_h = list(range(n)) if saved_h is None else list(saved_h)
    gmaster, gm, gv = [None] * n, [None] * n, [None] * n

    def f32(a):
        return np.asarray(_host_tensor(a).float().contiguous(), np.float32).reshape(-1)

    for j, i in enumerate(saved_h):
        gmaster[i] = f32(oh["master"][j])
        if "mv" in oh:  # the nvme tier's state: [m; v] stacked
            gm[i], gv[i] = f32(np.asarray(oh["mv"][j])[0]), f32(np.asarray(oh["mv"][j])[1])
        else:
            gm[i], gv[i] = f32(oh["m"][j]), f32(oh["v"][j])
    od = optim_sd.get("offload_dev")
    for j, i in enumerate(saved_d or []):
        gmaster[i], gm[i], gv[i] = f32(od["master"][j]), f32(od["m"][j]), f32(od["v"][j])
    return gmaster, gm, gv


def _offload_as_full(optim_sd, n):
    """An ``offload_host`` file as full-leaf moments (for a device engine)."""
    _, gm, gv = _offload_as_full_lists(optim_sd, optim_sd.get("host_idx"),
                                       optim_sd.get("dev_idx"), n)
    return {"step": int(optim_sd["offload_host"]["step"]), "scaler": optim_sd.get("scaler"),
            "m": gm, "v": gv}


def _place(a, plan, j, rank):
    """Rank ``rank``'s flat slice ``a`` of leaf ``j`` at its place in a
    zero leaf (what the shard-file writer slices it from again)."""
    out = np.zeros(plan.leaf_sizes[j], np.float32)
    lo, hi = plan.bounds[j][rank], plan.bounds[j][rank + 1]
    out[lo:hi] = np.asarray(a, np.float32).reshape(-1)
    return out


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


def _train_forward(apply_fn, params, batch, rng):
    """The training micro-step's forward, the first half of the audited
    ``engine.fwd_bwd`` program (its backward is the second)."""
    return apply_fn(params, batch, train=True, rng=rng)


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
        self.topology = get_topology()
        # tensor parallelism: this rank's shards by the model's tp_specs
        # (engine.py:354-358, 476-480)
        self._tp = self._setup_tensor_parallel(model)
        tp_n = 1 if self._tp is None else self._tp.n
        if self._tp is not None:
            params = self._tp.local(params)
            # the model runs over this rank's layout, not the process's
            self.module = model = model.with_tp(self._tp.n, self._tp.rank)
            self._apply_fn = model.apply
        mc = getattr(model, "config", None)
        if self.device.type == "cuda" and mc is not None and hasattr(mc, "head_dim"):
            check_kernel_config(mc.num_heads // tp_n, mc.kv_heads // tp_n, mc.head_dim,
                                self.compute_dtype)

        def lp(p):  # a fresh tensor: the lp params are updated in place
            t = torch.as_tensor(p).detach()
            out = t.to(device=self.device, dtype=self.compute_dtype)
            return (out.clone() if out is t else out).requires_grad_()

        # ---- ZeRO (engine.py:454-474) ----
        zc = config.zero_config
        self.zero_stage = int(zc.stage)
        off = zc.offload_optimizer
        self._offload_enabled = bool(off is not None and off.device in ("cpu", "nvme"))
        # the sharded host tier: stage >= 2 with the whole optimizer state in
        # host RAM; partial (ratio < 1) or NVMe offload takes the flat tier
        self._zero_sharded_planned = bool(self.zero_stage >= 2 and off is not None
                                          and off.device == "cpu" and off.ratio == 1.0)
        if self._offload_enabled and self._tp is not None:
            raise _not_ported("offload_optimizer under tensor parallelism (a host tier a "
                              "rank)", _HOST_TIERS_ITEM)

        # ---- data parallelism over the process group (engine.py:454-480) ----
        self.dp_world_size = config.dp_world_size
        if self.topology.data_parallel_size != self.dp_world_size:
            raise ValueError(
                f"the config's data-parallel size {self.dp_world_size} differs from the "
                f"topology's {self.topology.data_parallel_size}: build the engine through "
                "deepspeed_tpu_torch.initialize, which joins the process group")
        self._dpz = None  # the device path's shards and collectives at dp > 1
        if self.dp_world_size > 1:
            # each rank keeps its rows of the global micro-batch (batch_spec)
            self._row_index = self.topology.rank_in(ZERO_AXES)
            self._rows = None  # (first row, global rows) of the last forward
            try:
                self._apply_takes_rows = "rows" in inspect.signature(self._apply_fn).parameters
            except (TypeError, ValueError):
                self._apply_takes_rows = False
        if self.dp_world_size > 1 and not self._offload_enabled:
            self._setup_data_parallel(model, params)
        else:
            self.params = tree_map(lp, params)
            # the master copy is rebound (never written in place) each step, so
            # it may share storage with the caller's fp32 tensors; under offload
            # it lives on the host (_setup_offload)
            self.master_params = (tree_map(lambda p: torch.as_tensor(p).detach().to(
                device=self.device, dtype=torch.float32), params)
                if self._mixed and not self._offload_enabled else None)

        # the base key of every training-mode forward (engine.py:342)
        self._rng = prng.PRNGKey(config.seed, device=self.device)
        # the training step's forward and backward under their manifest name
        # (``engine.py:775``): ``begin`` runs the forward, ``end`` the backward
        self._fwd_bwd = audited_program("engine.fwd_bwd", _train_forward, max_traces=4)

        # ---- optimizer ----
        self.client_optimizer = optimizer
        if optimizer is not None:
            self.optimizer = optimizer
        elif config.optimizer_name is not None:
            self.optimizer = build_optimizer(config.optimizer_name, config.optimizer_params)
        else:
            self.optimizer = None
        self._setup_sharded_norms()
        self._ef_errors = None  # the 1-bit optimizers' error feedback, a leaf each
        self._offload_mgr = None
        self._transfer = None  # the offload tiers' TransferEngine
        self._zero_tier = None  # the sharded host tier (stage >= 2, cpu, ratio 1)
        self._z3_residency = False
        self._z3_released = {}  # leaf -> its host compute-dtype cast
        self._z3_prefetched = set()
        # the leaves' writeback order of the first completed step: the order
        # a forward consumes them, for stage-3 release and prefetch
        self._z3_schedule = []
        #: seconds in the offloaded step's parts, summed over steps (h2d_s:
        #: submitting the uploads; h2d_wait_s: waiting for them to finish)
        self.offload_stats = {"norm_s": 0.0, "lp_cast_s": 0.0, "h2d_s": 0.0,
                              "h2d_wait_s": 0.0, "device_subset_s": 0.0}
        if self.optimizer is not None and self._offload_enabled:
            self.opt_state = None
            self._setup_offload(off, params)
        else:
            self.opt_state = (self.optimizer.init(self._update_target())
                              if self.optimizer is not None else None)

        # ---- loss scaling ----
        self.loss_scaler = CreateLossScaler(config.fp16_config, config.fp16_enabled)
        self.scaler_state = self.loss_scaler.init_state(self.device)
        # the step's overflow flags, made once (never written in place)
        self._no_overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        self._overflow = torch.ones((), dtype=torch.bool, device=self.device)

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

        self.static_state_bytes = self._memory_preflight()
        log_dist(
            f"DeepSpeedEngine: zero_stage={self.zero_stage} dtype={self.compute_dtype} "
            f"device={self.device} offload={off.device if self._offload_enabled else 'none'} "
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
        """What the optimizer updates: the fp32 master (at dp > 1 always this
        rank's shards of it), or the fp32 params."""
        if self._mixed or self._dpz is not None:
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
        if self._z3_residency:
            self._ensure_zero3_params()
        if self.dp_world_size > 1:
            loss = self._dp_forward(batch, train=self._training)
            self._cached = loss if self._training else None
            self.timers(FORWARD_MICRO_TIMER).stop()
            return loss
        batch = to_device(batch, self.device)
        if not self._training:
            with torch.no_grad():
                loss = self._loss_of(self._apply_fn(self.params, batch, train=False,
                                                    rng=None)).float()
            self.timers(FORWARD_MICRO_TIMER).stop()
            return loss
        loss = self._loss_of(self._fwd_bwd.begin(self._apply_fn, self.params, batch,
                                                 self._micro_step_key()))
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
        cached = self._cached
        if self._dpz is not None:
            grads = self._fwd_bwd.end(
                lambda: self._dp_grads(cached, self.scaler_state.cur_scale / gas))
            self._cached = None
            self._acc_grads = self._dp_fold(self._acc_grads, grads)
            self.micro_steps += 1
            self.timers(BACKWARD_MICRO_TIMER).stop()
            return loss
        grads = self._fwd_bwd.end(
            lambda: self._grads_of(cached.float() * self.scaler_state.cur_scale / gas))
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
        """``step_fn`` (``engine.py:831-848``), or the offloaded step. Returns
        (gnorm, overflow). At dp > 1 the gradients are this rank's reduced
        chunks (``DataParallel.step_grads``): the norm and the overflow flag
        come from every rank's, the optimizer updates this rank's master
        shards, and the lp parameters are gathered from the updated shards
        where their layout differs."""
        if self._offload_mgr is not None:
            return self._step_offload(acc_grads, lr)
        cfg = self.config
        dpz = self._dpz
        inv = 1.0 / self.scaler_state.cur_scale
        target = self._update_target()
        if dpz is None and self._tp is not None:
            from .zero.data_parallel import chunks_norm_and_overflow

            grads = [g.float() * inv for g in tree_leaves(acc_grads)]
            gnorm, overflow = chunks_norm_and_overflow(
                [g if self._tp.counts(j) else None for j, g in enumerate(grads)],
                cfg.fp16_enabled, self.device, groups=(MODEL_AXIS,))
        elif dpz is None:
            grads = [g.float() * inv for g in tree_leaves(acc_grads)]
            tree = tree_unflatten(acc_grads, grads)
            overflow = has_overflow(tree) if cfg.fp16_enabled else None
            gnorm = _global_norm(tree)
        else:
            # the accumulation is the step's own: unscaled (and clipped) in place
            grads, counted = dpz.step_grads(acc_grads, inv)
            gnorm, overflow = dpz.norm_and_overflow(counted, cfg.fp16_enabled)
        if overflow is None:
            overflow = self._no_overflow
        if cfg.gradient_clipping > 0:
            coef = torch.clamp(cfg.gradient_clipping / (gnorm + 1e-6), max=1.0)
            for g in grads:
                g.mul_(coef)
        new_master, new_opt = self.optimizer.update(tree_unflatten(target, grads),
                                                    self.opt_state, target, lr)
        if cfg.fp16_enabled:  # skip the update entirely on overflow
            def keep(old, new):
                return tree_map(lambda o, n: torch.where(overflow, o, n), old, new)

            new_master = keep(target, new_master)
            new_opt = type(new_opt)(*(keep(o, n) for o, n in zip(self.opt_state, new_opt)))
        for j, (p, n) in enumerate(zip(tree_leaves(self.params), tree_leaves(new_master))):
            # cast back to the lp dtype, in place
            p.copy_(n if dpz is None else dpz.lp_leaf(j, n, self.compute_dtype))
        if self._mixed or dpz is not None:
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
        if self._z3_residency and not bool(overflow):
            self._z3_release_and_prefetch()
        every = self.config.steps_per_print
        if every and self.global_steps % every == 0:
            # the offloaded step skips the norm when clipping is off
            gn = float("nan") if gnorm is None else float(gnorm)
            zero = self.zero_metrics()
            log_dist(f"step={self.global_steps} lr={self.get_lr()} grad_norm={gn:.4f} "
                     f"skipped={self.skipped_steps}" + (f" zero={zero}" if zero else ""),
                     ranks=[0])

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
        return self._mean_over_ranks(torch.stack(losses).mean())

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
        if self._z3_residency:
            self._ensure_zero3_params()
        lr = self.get_lr()[0]
        if self.dp_world_size > 1:
            loss = self._dp_forward(batch, train=True)
        else:
            batch = to_device(batch, self.device)
            loss = self._loss_of(self._fwd_bwd.begin(self._apply_fn, self.params, batch,
                                                     self._micro_step_key()))
        if self._dpz is not None:
            grads = self._dp_fold(None, self._fwd_bwd.end(
                lambda: self._dp_grads(loss, self.scaler_state.cur_scale)))
        else:  # at dp > 1 under offload, the step reduces them
            grads = self._fwd_bwd.end(
                lambda: self._grads_of(loss.float() * self.scaler_state.cur_scale))
        loss = loss.detach()  # the graph goes before the update's buffers come
        gnorm, overflow = self._apply_update(grads, lr)
        self.micro_steps += 1
        self._after_step(gnorm, overflow)
        self.timers(STEP_MICRO_TIMER).stop()
        return self._mean_over_ranks(loss)

    # ------------------------------------------------------------------
    # ZeRO across data-parallel ranks (engine.py:454-480, 943-1120)
    # ------------------------------------------------------------------
    def _setup_data_parallel(self, model, params):
        """This rank's shards: the lp parameters under ``stage_param_specs``
        (whole below stage 3), the fp32 master under ``stage_opt_specs``
        (kept at every stage and precision, so the update is one path), an
        anchor a stage-3 sharded leaf (what autograd differentiates: the
        gather's backward reduces the weight's gradient itself)."""
        from .zero.data_parallel import DataParallel

        zc = self.config.zero_config
        # leaves the model stacks by layer: their gathers and reductions run
        # a layer at a time
        stacked = getattr(model, "stacked_leaves", None)
        dpz = DataParallel(params, self.zero_stage, self.topology,
                           persistence_threshold=zc.param_persistence_threshold,
                           comm_dtype=self.config.communication_data_type,
                           qgz=zc.zero_quantized_gradients, qwz=zc.zero_quantized_weights,
                           stacked=stacked(params) if stacked is not None else None,
                           tp=self._tp)
        self._dpz = dpz
        dev = self.device

        def fresh(view, dtype):
            return torch.empty(tuple(view.shape), dtype=dtype, device=dev).copy_(view)

        leaves = [torch.as_tensor(p).detach() for p in tree_leaves(params)]
        self.params = tree_unflatten(params, [
            fresh(lay.take(t), self.compute_dtype).requires_grad_(not lay.sharded)
            for t, lay in zip(leaves, dpz.param)])
        self.master_params = tree_unflatten(params, [
            fresh(lay.take(t), torch.float32) for t, lay in zip(leaves, dpz.opt)])
        self._z3_anchors = [torch.zeros((), device=dev, requires_grad=True)
                            if lay.sharded else None for lay in dpz.param]
        self._z3_red = None  # the gathers' reduced gradients of one micro-step

    def _memory_preflight(self) -> float:
        """The per-rank static state (weights, gradients, fp32 master and
        moments) under the ZeRO rules and the model degree, as the JAX
        engine's preflight estimates it (``engine.py:620-675``); a warning
        when it passes 92% of the card's memory. Returns the bytes."""
        from .zero.partition import estimate_static_state_per_chip

        topo = self.topology
        shapes = [tuple(t.shape) for t in tree_leaves(self.global_template())]
        n_params = sum(int(np.prod(s)) for s in shapes)
        zero_degree = max(1, topo.data_parallel_size)
        hpz = topo.get_dim("hpz")
        off = self.config.zero_config.offload_optimizer
        off_frac = (max(0.0, min(1.0, off.ratio)) if self._offload_enabled else 0.0)
        est = estimate_static_state_per_chip(
            n_params, self.zero_stage, zero_degree=zero_degree, mp=topo.model_parallel_size,
            dtype_bytes=2 if self._mixed else 4, offload_opt_fraction=off_frac,
            weight_shard_degree=hpz if hpz > 1 else zero_degree, has_master=self._mixed)
        if self.device.type == "cuda":
            cap = float(torch.cuda.get_device_properties(self.device).total_memory)
            if est > 0.92 * cap:
                logger.warning(
                    f"memory preflight: static state needs ~{est / 2**30:.1f} GiB a rank "
                    f"(params {n_params / 1e6:.0f}M, stage {self.zero_stage}, zero_degree "
                    f"{zero_degree}, mp {topo.model_parallel_size}) vs ~{cap / 2**30:.1f} "
                    "GiB on the card; activations come on top")
        return est

    def _setup_tensor_parallel(self, model):
        """This rank's ``TensorParallel`` layout over a ``model`` axis larger
        than 1 (None otherwise): the model's ``tp_specs`` over its whole
        leaves' shapes, the heads and widths checked."""
        n = self.topology.model_parallel_size
        if n == 1:
            return None
        from ..models.weights import tp_layout

        if not hasattr(model, "with_tp"):
            raise ValueError("a 'model' axis larger than 1 needs a model with tp_specs "
                             "(models.TransformerLM)")
        return tp_layout(model, n, self.topology.coords[MODEL_AXIS])

    def _setup_sharded_norms(self):
        """1-bit LAMB over leaves held in shards (ZeRO stage >= 1 across
        ranks, or tensor parallelism): its trust ratio's two norms are the
        squares summed over each shard's groups (``onebit_adam.py:100-140``
        on the whole leaf)."""
        from ..ops.adam.onebit_adam import OnebitLamb

        if not isinstance(self.optimizer, OnebitLamb):
            return
        dp_sharded = ([lay.sharded for lay in self._dpz.opt] if self._dpz is not None
                      else None)
        if dp_sharded is None and self._tp is None:
            return
        tp = self._tp
        first_dp = self._dpz is None or self._dpz.row_index == 0

        def reduce_squares(sq):  # (k, leaves) squared sums of this rank's shards
            n = sq.shape[-1]
            keep = torch.tensor([(dp_sharded is None or dp_sharded[j] or first_dp)
                                 and (tp is None or tp.counts(j)) for j in range(n)],
                                device=sq.device)
            sq = torch.where(keep, sq, torch.zeros_like(sq))
            if dp_sharded is not None:
                sq = dist.all_reduce(sq, group=ZERO_AXES, log_name="lamb_norms")
            if tp is not None:
                sq = dist.all_reduce(sq, group=MODEL_AXIS, log_name="lamb_norms")
            return sq

        self.optimizer.reduce_squares = reduce_squares

    def _apply_dp(self, params, batch, train=True, rng=None):
        """The model's apply on this rank's rows; dropout draws those rows
        of the global batch's masks where the apply takes ``rows``."""
        if self._apply_takes_rows and self._rows is not None:
            return self._apply_fn(params, batch, train=train, rng=rng, rows=self._rows)
        return self._apply_fn(params, batch, train=train, rng=rng)

    def _dp_forward(self, batch, train: bool):
        """This rank's loss on its rows of the global micro-batch: in
        training the autograd graph is kept (at stage 3 of the device path
        over weights gathered just in time), in evaluation the mean over the
        ranks."""
        from .zero.data_parallel import batch_rows

        dpz = self._dpz
        rows, self._rows = batch_rows(batch, self.dp_world_size, self._row_index)
        rows = to_device(rows, self.device)
        params = self.params
        stage3 = dpz is not None and self.zero_stage >= 3
        if stage3:
            self._z3_red = [None] * len(dpz.param)
            params = dpz.stage3_tree(self.params, self._z3_anchors, self._z3_on_grad)
        if not train:
            with torch.no_grad():
                loss = self._loss_of(self._apply_dp(params, rows, train=False)).float()
            return self._mean_over_ranks(loss)
        key = self._micro_step_key()
        if stage3:
            with dpz.saved_weights():
                return self._loss_of(self._fwd_bwd.begin(self._apply_dp, params, rows, key))
        return self._loss_of(self._fwd_bwd.begin(self._apply_dp, params, rows, key))

    def _z3_on_grad(self, j, layer, grad):
        """A gathered weight's gradient in the backward: reduced onto its
        shard (a layer's slice of a stacked leaf into that layer's rows)."""
        dpz = self._dpz
        red = dpz.red[j]
        if layer is None:
            self._z3_red[j] = dpz.reduce_leaf(grad, red)
            return
        if self._z3_red[j] is None:
            self._z3_red[j] = torch.zeros(red.chunk_shape(dpz.shapes[j]), dtype=dpz.comm_dtype,
                                          device=grad.device)
        self._z3_red[j][layer] = dpz.reduce_leaf(grad, red.layer())

    def _onebit_active(self) -> bool:
        """The 1-bit optimizers' compressed phase: at dp > 1, stage <= 1,
        once ``freeze_step`` updates have been applied (overflow-skipped
        steps do not warm the variance, so they do not count)."""
        from ..ops.adam.onebit_adam import OnebitAdam

        if not isinstance(self.optimizer, OnebitAdam) or self.zero_stage > 1:
            return False
        return (self.global_steps - self.skipped_steps) >= self.optimizer.freeze_step

    def _dp_grads(self, loss, scale):
        """One micro-step's gradients reduced over the ranks: (this rank's
        chunk of each leaf's mean on the reduction layout, the whole means
        where the path made them: the 1-bit all-reduce and qgZ at stages 0
        and 1)."""
        dpz = self._dpz
        scaled = loss.float() * scale
        leaves = list(tree_leaves(self.params))
        if self.zero_stage >= 3:
            inputs = [a if a is not None else p for a, p in zip(self._z3_anchors, leaves)]
        else:
            inputs = leaves
        local = [torch.zeros_like(p) if g is None else g for p, g in
                 zip(leaves, torch.autograd.grad(scaled, inputs, allow_unused=True))]
        if self.zero_stage >= 3:
            z3 = self._z3_red
            self._z3_red = None
            skip = {j for j, a in enumerate(self._z3_anchors) if a is not None}
            shards = dpz.reduce_list(local, skip=skip)
            for j in skip:  # a leaf the forward did not reach has zero gradients
                shards[j] = z3[j] if z3[j] is not None else torch.zeros(
                    dpz.red[j].chunk_shape(dpz.shapes[j]), dtype=dpz.comm_dtype,
                    device=self.device)
            return shards, None
        if self._onebit_active():
            return self._onebit_reduce(local, scale)
        if dpz.qgz and self.zero_stage <= 1:
            from .zero.zeropp import quantized_reduce_leaf

            fulls = [quantized_reduce_leaf(g.to(dpz.comm_dtype), ZERO_AXES, dpz.dp)
                     for g in local]
            return [lay.take(f).contiguous() for f, lay in zip(fulls, dpz.red)], fulls
        return dpz.reduce_list(local), None

    def _onebit_reduce(self, local, scale):
        """``_onebit_fwd_bwd`` (``engine.py:977``): the local gradients,
        unscaled, through the error-feedback 1-bit all-reduce, rescaled; the
        error is kept in unscaled units and cleared of non-finite values (an
        fp16 overflow would poison it for good)."""
        from .comm.compressed import compressed_allreduce

        dpz = self._dpz
        if self._ef_errors is None:
            self._ef_errors = [torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                               for g in local]
        inv = 1.0 / scale
        fulls = []
        for j, g in enumerate(local):
            red, err = compressed_allreduce(g.float() * inv, self._ef_errors[j], ZERO_AXES)
            self._ef_errors[j] = torch.where(torch.isfinite(err), err, torch.zeros_like(err))
            fulls.append(red * scale)
        return [lay.take(f).contiguous() for f, lay in zip(fulls, dpz.red)], fulls

    def _dp_fold(self, acc, grads):
        """Fold one micro-step's reduced gradients into the accumulation
        (``_grad_acc_dtype`` past the first micro-step, as one rank folds)."""
        shards, fulls = grads
        if self.config.gradient_accumulation_steps == 1 or acc is None:
            if self.config.gradient_accumulation_steps > 1:
                dt = self._grad_acc_dtype()
                shards = [g.to(dt) for g in shards]
                fulls = None if fulls is None else [g.to(dt) for g in fulls]
            return {"shards": shards, "fulls": fulls}
        add = lambda a, g: a + g.to(a.dtype)  # noqa: E731
        return {"shards": [add(a, g) for a, g in zip(acc["shards"], shards)],
                "fulls": None if fulls is None or acc["fulls"] is None
                else [add(a, g) for a, g in zip(acc["fulls"], fulls)]}

    def _mean_over_ranks(self, loss):
        """A loss averaged over the data-parallel ranks (itself on one)."""
        if self.dp_world_size == 1:
            return loss
        return dist.all_reduce(loss.detach().float().clone(), op="avg", group=ZERO_AXES,
                               log_name="loss_mean")

    def _dp_full(self, shards, layouts):
        """Whole leaves (a tree) from this rank's shards: collective."""
        return tree_unflatten(self.params, self._dpz.gather_list(list(shards), layouts))

    # ------------------------------------------------------------------
    # ZeRO-Offload / Offload++ / ZeRO-Infinity (engine.py:1119-1418)
    # ------------------------------------------------------------------
    def _setup_offload(self, off, fp32_params):
        """The host tier (flat, or sharded at stage >= 2 with cpu and ratio
        1), the device subset of a twin-flow split, the CPU Adam and the
        TransferEngine. The host master is copied from the caller's fp32
        tree, not from the lp parameters."""
        from ..analysis.sanitizer import sanitize_enabled
        from ..ops.adam.cpu_adam import DeepSpeedCPUAdam
        from ..ops.optimizers import FusedAdam
        from .transfer_engine import TransferEngine
        from .zero.offload import OffloadedAdamState, split_by_ratio

        if not isinstance(self.optimizer, FusedAdam):
            raise ValueError("offload_optimizer requires an Adam-family optimizer "
                             "(reference forces DeepSpeedCPUAdam)")
        if self.zero_stage >= 3 and self.dp_world_size > 1:
            raise _not_ported("ZeRO stage 3 with offload_optimizer across ranks (the "
                              "weights sharded, and the tier's parameter residency)",
                              _HOST_TIERS_ITEM)
        leaves = list(tree_leaves(fp32_params))
        host_idx, dev_idx = split_by_ratio(leaves, off.ratio)
        if sanitize_enabled():
            from ..analysis.sanitizer import check_offload_split

            check_offload_split(host_idx, dev_idx, len(leaves))
        opt = self.optimizer
        cpu_opt = DeepSpeedCPUAdam(lr=opt.lr, betas=opt.betas, eps=opt.eps,
                                   weight_decay=opt.weight_decay,
                                   bias_correction=opt.bias_correction,
                                   adamw_mode=opt.adam_w_mode)
        zc = self.config.zero_config
        # nvme_path on the sharded (cpu) tier puts its moments on NVMe; the
        # device="nvme" tier reads and writes its own files through AIO
        nvme_dir = off.nvme_path if (self._zero_sharded_planned and off.nvme_path) else None
        self._transfer = TransferEngine(overlap=bool(zc.transfer_overlap), nvme_dir=nvme_dir,
                                        device=self.device)
        dev_state = None
        host_leaves = [leaves[i] for i in host_idx]
        if self._zero_sharded_planned:
            from .zero.partition import PartitionPlan
            from .zero.sharded import ZeroShardedTier

            plan = PartitionPlan(host_leaves, self.config.dp_world_size,
                                 sanitize=sanitize_enabled())
            # one rank of a group holds and steps its own slices
            rank = self.topology.rank_in(ZERO_AXES) if self.dp_world_size > 1 else None
            host_state = ZeroShardedTier(host_leaves, plan, stage=self.zero_stage,
                                         nvme_store=self._transfer.nvme if nvme_dir else None,
                                         rank=rank)
            self._zero_tier = host_state
            self._z3_residency = self.zero_stage >= 3
        else:
            host_state = OffloadedAdamState(host_leaves, device=off.device,
                                            nvme_path=off.nvme_path)
            if dev_idx:
                master = [torch.from_numpy(host_f32(leaves[i])).to(self.device) for i in dev_idx]
                dev_state = {"master": master,
                             "m": [torch.zeros_like(t) for t in master],
                             "v": [torch.zeros_like(t) for t in master]}
        host_state.transfer = self._transfer
        self._offload_mgr = {"host_idx": host_idx, "dev_idx": dev_idx, "host": host_state,
                             "dev": dev_state, "cpu_opt": cpu_opt}
        log_dist(f"ZeRO-Offload: {len(host_idx)} leaves -> {off.device} (ratio={off.ratio}), "
                 f"{len(dev_idx)} stay on the device"
                 + (f"; stage-{self.zero_stage} sharded tier" if self._zero_tier else ""),
                 ranks=[0])

    @torch.no_grad()
    def _step_offload(self, acc_grads, lr):
        """The optimizer step with offloaded states (``engine.py:1207``).
        Returns (gnorm, overflow); gnorm is None when clipping is off."""
        mgr = self._offload_mgr
        cfg = self.config
        st = self.offload_stats
        host_idx = mgr["host_idx"]
        tier = self._zero_tier
        # at dp > 1 the gradients are this rank's rows': a rank of the sharded
        # tier steps its plan slices of their mean, the flat tier whole leaves
        sliced = tier is not None and tier.rank is not None
        if sliced:
            from .zero.data_parallel import reduce_plan_slices

            grads_flat = list(tree_leaves(acc_grads))
            for j, i in enumerate(host_idx):
                grads_flat[i] = reduce_plan_slices(grads_flat[i], tier.plan.bounds[j])
        else:
            if self.dp_world_size > 1:
                acc_grads = tree_map(lambda g: dist.all_reduce(
                    g.float(), op="avg", group=ZERO_AXES, log_name="grad_all_reduce"), acc_grads)
            grads_flat = list(tree_leaves(acc_grads))
        t0 = time.perf_counter()
        inv_scale = 1.0 / float(self.scaler_state.cur_scale)
        clip = cfg.gradient_clipping > 0
        # overflow covers every gradient, host and device leaves, and is
        # decided before any update runs
        if sliced:  # from every rank's slices
            from .zero.data_parallel import chunks_norm_and_overflow

            norm, bad = (chunks_norm_and_overflow(grads_flat, cfg.fp16_enabled, self.device)
                         if clip or cfg.fp16_enabled else (None, None))
            overflow = bad is not None and bool(bad)
        else:
            overflow = bool(has_overflow(acc_grads)) if cfg.fp16_enabled else False
            norm = _global_norm(acc_grads) if clip else None
        gnorm = None
        clip_coef = 1.0
        if clip:
            # the norm of the scaled gradients on the device, unscaled on the host
            gnorm = float(norm) * inv_scale
            clip_coef = min(1.0, cfg.gradient_clipping / (gnorm + 1e-6))
        st["norm_s"] += time.perf_counter() - t0
        if overflow:
            mgr["host"].step_count += 1  # Adam's step parity with skipped steps
            self.scaler_state = self.loss_scaler.update(self.scaler_state, self._overflow)
            return gnorm, True

        params_flat = list(tree_leaves(self.params))
        # the device subset first, so it runs on the card under the host work
        if mgr["dev"] is not None:
            t0 = time.perf_counter()
            d = mgr["dev"]
            keys = [f"{j:06d}" for j in range(len(mgr["dev_idx"]))]
            inv = torch.tensor(inv_scale, dtype=torch.float32, device=self.device)
            coef = torch.tensor(clip_coef, dtype=torch.float32, device=self.device)
            grads = {k: grads_flat[i].float() * inv * coef
                     for k, i in zip(keys, mgr["dev_idx"])}
            state = OptState(
                step=torch.tensor(mgr["host"].step_count, dtype=torch.int32, device=self.device),
                m=dict(zip(keys, d["m"])), v=dict(zip(keys, d["v"])))
            new_master, new_state = self.optimizer.update(
                grads, state, dict(zip(keys, d["master"])), lr)
            d["master"] = [new_master[k] for k in keys]
            d["m"] = [new_state.m[k] for k in keys]
            d["v"] = [new_state.v[k] for k in keys]
            for t, i in zip(d["master"], mgr["dev_idx"]):
                params_flat[i].copy_(t)  # cast into the lp parameter in place
            st["device_subset_s"] += time.perf_counter() - t0

        te = self._transfer
        # a rank of a group steps its slice: where each host leaf starts
        offs = ([tier.plan.bounds[j][tier.rank] for j in range(len(host_idx))]
                if sliced else [0] * len(host_idx))
        sched = self._z3_schedule
        record = tier is not None and len(sched) < len(host_idx)
        if record:
            del sched[:]  # re-record from scratch if an earlier step aborted
        lp_dtype = self.compute_dtype
        itemsize = lp_dtype.itemsize
        # the updated chunks go up in the compute dtype through two pinned
        # staging buffers in turn: the host casts a chunk into one while the
        # other's upload runs, and the tier steps the next chunk under both;
        # a buffer is refilled only once its last upload has settled
        ring = []       # [staging buffer, its open upload or None]
        uploads = []    # every open upload, in submit order

        def on_chunk(j, lo, hi, p_chunk):
            src = torch.from_numpy(p_chunk)  # fp32: the master is the source
            if lp_dtype != torch.float32:
                k = len(uploads) % 2
                if len(ring) <= k:
                    ring.append([te.acquire_staging((mgr["host"].chunk_elements,), lp_dtype),
                                 None])
                buf, last = ring[k]
                t0 = time.perf_counter()
                if last is not None:
                    te.drain_before([last])  # the buffer's last upload has read it
                t1 = time.perf_counter()
                src = lp_cast(src, lp_dtype, out=buf[:hi - lo])
                st["h2d_wait_s"] += t1 - t0
                st["lp_cast_s"] += time.perf_counter() - t1
            t0 = time.perf_counter()
            o = offs[j]
            uploads.append(te.submit_h2d(
                src, out=params_flat[host_idx[j]].detach().view(-1)[o + lo:o + hi],
                settle=False))
            st["h2d_s"] += time.perf_counter() - t0
            if ring:
                ring[k][1] = uploads[-1]

        def on_leaf(j, master):
            if tier is not None:  # the updated leaf's all-gather
                tier.counters["gathers"] += 1
                tier.counters["offload_bytes_out"] += master.size * itemsize
            if record:
                sched.append(j)

        host_grads = [grads_flat[i] for i in host_idx]
        try:
            mgr["host"].adam_step(mgr["cpu_opt"], host_grads, lr,
                                  grad_scale=inv_scale, clip_coef=clip_coef,
                                  on_leaf=on_leaf, on_chunk=on_chunk)
        finally:
            t0 = time.perf_counter()
            te.drain_before(uploads)
            st["h2d_wait_s"] += time.perf_counter() - t0
            for slot in ring:
                te.release_staging(slot[0])
        if sliced:
            # every rank's updated slices into every rank's lp parameters
            from .zero.data_parallel import gather_plan_slices

            for j, i in enumerate(host_idx):
                flat = params_flat[i].detach().view(-1)
                flat.copy_(gather_plan_slices(flat[offs[j]:offs[j] + tier.master[j].size],
                                              tier.plan.bounds[j]))
        if cfg.fp16_enabled:
            self.scaler_state = self.loss_scaler.update(self.scaler_state, self._no_overflow)
        from ..analysis.sanitizer import sanitize_enabled

        if sanitize_enabled():
            # the step boundary: every gradient chunk drained, every upload
            # settled, nothing in flight
            from ..analysis.sanitizer import check_transfer_ledger

            check_transfer_ledger(te)
        return gnorm, False

    # ------------------------------------------------------------------
    # ZeRO-3 parameter residency (engine.py:1334-1418)
    # ------------------------------------------------------------------
    def _z3_upload(self, j, lp):
        """Bring released leaf ``j`` back to the device from its host cast."""
        p = list(tree_leaves(self.params))[j].detach()
        p.untyped_storage().resize_(p.numel() * p.element_size())
        self._transfer.submit_h2d(lp, out=p)
        tier = self._zero_tier
        tier.counters["gathers"] += 1
        tier.counters["offload_bytes_out"] += lp.numel() * lp.element_size()

    def _z3_release_and_prefetch(self):
        """After the step's writeback: release non-persistent lp leaves (their
        device memory freed, their host compute-dtype cast kept) until the
        live count fits ``max_live_parameters``, the leaf needed last first;
        then re-upload up to ``prefetch_bucket_size`` bytes, the leaf needed
        first first. The cast is the writeback's, so a round trip is
        byte-exact. Until a step has recorded the schedule, the largest
        leaves go first."""
        tier = self._zero_tier
        zc = self.config.zero_config
        sizes = tier.plan.leaf_sizes
        released = self._z3_released
        sched = self._z3_schedule if len(self._z3_schedule) == len(sizes) else None
        live = sum(sizes) - sum(sizes[j] for j in released)
        if live > zc.max_live_parameters:
            params_flat = list(tree_leaves(self.params))
            order = (list(reversed(sched)) if sched is not None
                     else sorted(range(len(sizes)), key=lambda j: -sizes[j]))
            for j in order:
                if live <= zc.max_live_parameters:
                    break
                if j in released or sizes[j] <= zc.param_persistence_threshold:
                    continue
                released[j] = lp_cast(torch.from_numpy(tier.master[j]), self.compute_dtype)
                params_flat[j].detach().untyped_storage().resize_(0)  # the device memory goes
                live -= sizes[j]
        if not released:
            return
        budget = int(zc.prefetch_bucket_size)
        order = [j for j in sched if j in released] if sched is not None else sorted(released)
        for j in order:
            lp = released[j]
            nbytes = lp.numel() * lp.element_size()
            if nbytes > budget:
                break
            budget -= nbytes
            self._z3_upload(j, lp)
            del released[j]
            self._z3_prefetched.add(j)

    def _ensure_zero3_params(self):
        """Before a forward: upload every leaf the window released and the
        prefetch did not restore; a restored one counts as a prefetch hit."""
        tier = self._zero_tier
        released = self._z3_released
        pre = self._z3_prefetched
        if pre:
            tier.counters["prefetch_hits"] += sum(1 for j in pre if j not in released)
            pre.clear()
        for j in sorted(released):
            self._z3_upload(j, released.pop(j))

    def _z3_reset(self):
        """Every released leaf's device memory back (its bytes about to be
        overwritten by a load), the window empty."""
        params_flat = list(tree_leaves(self.params))
        for j in self._z3_released:
            p = params_flat[j].detach()
            p.untyped_storage().resize_(p.numel() * p.element_size())
        self._z3_released.clear()
        self._z3_prefetched.clear()

    def zero_metrics(self):
        """``train/zero/*`` counter snapshot (empty without a sharded tier)."""
        tier = self._zero_tier
        if tier is None:
            return {}
        out = dict(tier.counters)
        out["shard_bytes"] = tier.shard_bytes(0)
        return out

    def transfer_metrics(self):
        """The offload TransferEngine's ledger (empty without offload)."""
        te = self._transfer
        if te is None:
            return {}
        return {f"{d}_{k}": v for k, dd in te.ledger().items()
                if isinstance(dd, dict) for d, v in dd.items()}

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

    def _save_sharded_optim(self, tag_dir, optim_path, plan, m_leaves, v_leaves, step):
        """The stage >= 2 optimizer save (``engine.py:1990``):
        ``optim_states.ckpt`` holds the partition plan, the step and the
        scaler, and the moments go one file a rank
        (``optim_states.shard<r>.ckpt``), each under the manifest-last
        protocol. The fp32 master is the module tree's. The slices are
        copies: the async engine writes them later. One process writes every
        rank's file; a rank of a group its own, and rank 0 the plan's."""
        from .checkpoint_engine.consolidate import shard_path

        optim_sd = {"zero_sharded": plan.describe(), "step": int(step),
                    "scaler": _gather_to_host(self.scaler_state._asdict())}
        m_flat = [np.asarray(m, np.float32).reshape(-1) for m in m_leaves]
        v_flat = [np.asarray(v, np.float32).reshape(-1) for v in v_leaves]
        ranks = (range(plan.num_shards) if self.dp_world_size == 1
                 else [self.topology.rank_in(ZERO_AXES)])
        shard_sds = []
        for r in ranks:
            sl = plan.slices(r)
            shard_sds.append({
                "rank": r, "num_shards": plan.num_shards,
                "m": [np.array(m_flat[j][lo:hi], copy=True) for j, (lo, hi) in enumerate(sl)],
                "v": [np.array(v_flat[j][lo:hi], copy=True) for j, (lo, hi) in enumerate(sl)],
            })
        from ..analysis.sanitizer import sanitize_enabled

        if sanitize_enabled() and self.dp_world_size == 1:
            from ..analysis.sanitizer import check_shard_conservation

            check_shard_conservation(plan.leaf_sizes, plan.bounds,
                                     [sd["m"] for sd in shard_sds], dtype=np.float32)
        if self.topology.rank == 0:
            self.checkpoint_engine.save(optim_sd, optim_path)
        if self._tp is not None and self._tp.rank != 0:
            return  # model coordinate 0 writes its data group's files
        for sd in shard_sds:
            self.checkpoint_engine.save(sd, shard_path(tag_dir, sd["rank"]))

    def _tp_full(self, tree):
        """``tree`` (this rank's TP-local leaves) with every TP-sharded leaf
        all-gathered whole over the model group: collective; the tree itself
        without tensor parallelism."""
        if self._tp is None or tree is None:
            return tree
        with torch.no_grad():
            return tree_unflatten(self.params, self._tp.full(
                [t.detach() for t in tree_leaves(tree)]))

    def _offload_master_tree(self, copy=False):
        """The full fp32 master tree from the host tier (numpy leaves) and
        the device subset (tensors); ``copy`` snapshots the host leaves."""
        mgr = self._offload_mgr
        tier = self._zero_tier
        flat = [None] * (len(mgr["host_idx"]) + len(mgr["dev_idx"]))
        for j, i in enumerate(mgr["host_idx"]):
            m = mgr["host"].master[j]
            if tier is not None and tier.rank is not None:  # every rank's slices
                from .zero.data_parallel import gather_plan_slices

                whole = gather_plan_slices(torch.from_numpy(m), tier.plan.bounds[j])
                flat[i] = whole.numpy().reshape(tier.plan.leaf_shapes[j])
                continue
            flat[i] = np.array(m, copy=True) if copy else m
        if mgr["dev"] is not None:
            for j, i in enumerate(mgr["dev_idx"]):
                flat[i] = mgr["dev"]["master"][j]
        return tree_unflatten(self.params, flat)

    def save_checkpoint(self, save_dir, tag=None, client_state=None, save_latest=True,
                        exclude_frozen_parameters=False):
        """Save the step state under ``save_dir/tag`` (default
        ``global_step<N>``): ``model_states.ckpt`` (the fp32 master when
        mixed or offloaded, else the params; counters, the training key, the
        dataset position, the lr schedule, ``client_state``) and the
        optimizer: ``optim_states.ckpt`` (Adam's step and moments, the loss
        scaler), at stage >= 2 with one moment file a rank beside it, under
        offload the host tier's state (``offload_host``, ``offload_dev``,
        the split); then ``latest``. Every tensor is copied to the host
        before this returns (and under offload with the async engine every
        host leaf too); the async engine writes the files later, and
        ``latest`` only after them."""
        if tag is None:
            tag = f"global_step{self.global_steps}"
        d, model_path, optim_path = self._ckpt_paths(save_dir, tag)
        self.checkpoint_engine.makedirs(d, exist_ok=True)
        self.checkpoint_engine.create(tag)
        cfg = self.config
        snapshot = hasattr(self.checkpoint_engine, "enqueue_task")
        dpz = self._dpz
        if self._offload_mgr is not None:
            module_state = self._offload_master_tree(copy=snapshot)
        elif dpz is not None:  # every rank's shards: collective
            module_state = self._dp_full(tree_leaves(self.master_params), dpz.opt)
        else:
            module_state = self.master_params if self._mixed else self.params
        module_state = self._tp_full(module_state)
        model_sd = {
            "module": module_state,
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
        optim_sd = sharded = None
        mgr = self._offload_mgr
        if self._zero_tier is not None:
            tier = self._zero_tier
            ms, vs = tier.full_moments()
            if tier.rank is not None:  # this rank's slices in their places
                ms, vs = ([_place(a, tier.plan, j, tier.rank) for j, a in enumerate(x)]
                          for x in (ms, vs))
            sharded = (tier.plan, ms, vs, tier.step_count)
        elif dpz is not None and self.opt_state is not None and self.opt_state.m is not None:
            # the moments whole (collective); stage >= 2 saves them a rank a file
            m_full, v_full = (self._tp_full(self._dp_full(tree_leaves(t), dpz.opt))
                              for t in (self.opt_state.m, self.opt_state.v))
            if self.zero_stage >= 2:
                from .zero.partition import PartitionPlan

                mv = _gather_to_host({"m": m_full, "v": v_full})
                m_leaves = [t.numpy() for t in tree_leaves(mv["m"])]
                v_leaves = [t.numpy() for t in tree_leaves(mv["v"])]
                sharded = (PartitionPlan(m_leaves, self.dp_world_size), m_leaves, v_leaves,
                           int(self.opt_state.step))
            else:
                optim_sd = {"step": self.opt_state.step, "m": m_full, "v": v_full,
                            "scaler": self.scaler_state._asdict()}
        elif mgr is not None:
            optim_sd = {
                "offload_host": mgr["host"].state_dict(),
                "offload_dev": None if mgr["dev"] is None else {
                    k: mgr["dev"][k] for k in ("master", "m", "v")},
                # the split at save time: a load under another ratio reshards
                "host_idx": list(mgr["host_idx"]), "dev_idx": list(mgr["dev_idx"]),
                "scaler": self.scaler_state._asdict()}
        elif self.opt_state is not None and self.zero_stage >= 2 \
                and self.opt_state.m is not None:
            # device-resident stage >= 2 moments are saved per shard too
            from .zero.partition import PartitionPlan

            mv = _gather_to_host({"m": self._tp_full(self.opt_state.m),
                                  "v": self._tp_full(self.opt_state.v)})
            m_leaves = [t.numpy() for t in tree_leaves(mv["m"])]
            v_leaves = [t.numpy() for t in tree_leaves(mv["v"])]
            sharded = (PartitionPlan(m_leaves, cfg.dp_world_size), m_leaves, v_leaves,
                       int(self.opt_state.step))
        elif self.opt_state is not None:
            optim_sd = {"step": self.opt_state.step, "m": self._tp_full(self.opt_state.m),
                        "v": self._tp_full(self.opt_state.v),
                        "scaler": self.scaler_state._asdict()}
        t0 = time.perf_counter()
        model_sd = _gather_to_host(model_sd)
        if optim_sd is not None:
            optim_sd = _gather_to_host(optim_sd)
        self.ckpt_stats["gather_s"] += time.perf_counter() - t0
        lead = self.topology.rank == 0  # rank 0 writes the module tree (engine.py:2029)
        if lead:
            self.checkpoint_engine.save(model_sd, model_path)
            if optim_sd is not None:
                self.checkpoint_engine.save(optim_sd, optim_path)
        if sharded is not None:
            self._save_sharded_optim(d, optim_path, *sharded)

        self.checkpoint_engine.commit(tag)
        if self.topology.world_size > 1:
            # every rank's files on disk before rank 0 moves `latest`
            if hasattr(self.checkpoint_engine, "wait"):
                self.checkpoint_engine.wait()
            dist.barrier(group=MESH_AXES)
        if save_latest and lead:
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
                    # a stage>=2 save of either package: full moments from
                    # the per-rank files, inside the ring loop, so a torn
                    # shard falls back like any other corrupt file
                    from .checkpoint_engine.consolidate import consolidate_sharded_optim

                    o_sd = consolidate_sharded_optim(self.checkpoint_engine, d, o_sd)
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
            if self.dp_world_size > 1 and self._offload_mgr is not None:
                raise _not_ported("loading a universal checkpoint into the offload tiers "
                                  "across ranks", _HOST_TIERS_ITEM)
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
        template = self.global_template()
        module = _match(template, model_sd["module"], "module")
        # the optimizer file in the form this engine restores (engine.py:2270-2290):
        # a consolidated sharded save, a device save into an offloaded
        # engine, an offloaded save into a device engine
        if optim_sd is not None and optim_sd.get("_consolidated"):
            optim_sd = self._adapt_consolidated_optim(optim_sd, module)
        elif optim_sd is not None and self._offload_mgr is not None \
                and "offload_host" not in optim_sd:
            optim_sd = None if optim_sd.get("m") is None else self._adapt_consolidated_optim({
                "step": int(np.asarray(optim_sd["step"])), "scaler": optim_sd.get("scaler"),
                "m": list(tree_leaves(optim_sd["m"])), "v": list(tree_leaves(optim_sd["v"]))},
                module)
        elif optim_sd is not None and self._offload_mgr is None and "offload_host" in optim_sd:
            optim_sd = self._adapt_consolidated_optim(
                _offload_as_full(optim_sd, len(list(tree_leaves(self.params)))), module)
        m = v = None
        if optim_sd is not None and self.opt_state is not None:
            m, v = (None if optim_sd[k] is None else _match(template, optim_sd[k], k)
                    for k in ("m", "v"))
        if self._tp is not None:  # this rank's TP slices of the global leaves
            module, m, v = (None if t is None else self._tp.local(t) for t in (module, m, v))
        if optim_sd is not None and self._offload_mgr is not None:
            saved_h = optim_sd.get("host_idx")
            saved_d = optim_sd.get("dev_idx") or []
            from ..analysis.sanitizer import sanitize_enabled

            if saved_h is not None and sanitize_enabled():
                from ..analysis.sanitizer import check_offload_split

                # overlapping or gappy index lists would double- or
                # un-restore optimizer leaves
                check_offload_split(saved_h, saved_d, len(list(tree_leaves(self.params))))

        t0 = time.perf_counter()
        if self._z3_residency:
            self._z3_reset()  # every leaf on the device again, the window empty
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
        if optim_sd is not None and self._offload_mgr is not None:
            self._restore_offload(optim_sd, module)
            self._restore_scaler(optim_sd.get("scaler"))
        elif optim_sd is not None and self.opt_state is not None:
            self._restore_moments(m, v, int(np.asarray(optim_sd["step"])))
            self._restore_scaler(optim_sd.get("scaler"))
        self.ckpt_stats["restore_s"] += time.perf_counter() - t0
        self.loaded_checkpoint_tag = tag
        log_dist(f"loaded checkpoint {tag} from {load_dir}", ranks=[0])
        return model_path, model_sd.get("client_state", {})

    def global_template(self):
        """The parameter tree's whole leaves as meta tensors: what a
        checkpoint holds (at dp > 1 the parameters are ZeRO shards, under
        tensor parallelism TP shards)."""
        if self._tp is not None:
            shapes = self._tp.global_shapes
        elif self._dpz is not None:
            shapes = self._dpz.shapes
        else:
            return self.params
        return tree_unflatten(self.params, [torch.empty(s, device="meta") for s in shapes])

    def _restore_moments(self, m, v, step: int):
        """The optimizer state from whole (TP-local) moment trees of host
        leaves: at dp > 1 this rank's ZeRO shards of them."""
        if self._dpz is not None:
            m, v = (None if t is None else tree_unflatten(self.params, [
                lay.take(_host_tensor(a).float()).contiguous()
                for a, lay in zip(tree_leaves(t), self._dpz.opt)]) for t in (m, v))
        self.opt_state = type(self.opt_state)(
            step=torch.tensor(int(step), dtype=torch.int32, device=self.device),
            m=None if m is None else self._to_device(m),
            v=None if v is None else self._to_device(v))

    def _restore_params(self, module):
        """Write a tree of host fp32 leaves (the params' structure) into the
        engine: the lp parameters in place (the autograd leaves persist),
        the master copy rebound, as a step rebinds it. Under offload the lp
        parameters take the host cast the step's writeback uploads, and the
        master copies are the module weights too, whether or not the
        optimizer file is loaded."""
        mgr = self._offload_mgr
        if mgr is not None:
            flat = [_host_tensor(t).float().contiguous() for t in tree_leaves(module)]
            with torch.no_grad():
                for p, t in zip(tree_leaves(self.params), flat):
                    p.copy_(lp_cast(t, self.compute_dtype))
            self._assign_host_master([flat[i].numpy() for i in mgr["host_idx"]])
            if mgr["dev"] is not None:
                mgr["dev"]["master"] = [flat[i].to(self.device) for i in mgr["dev_idx"]]
            return
        if self._dpz is not None:  # this rank's shards of the module weights
            dpz = self._dpz
            whole = [_host_tensor(t).float() for t in tree_leaves(module)]
            with torch.no_grad():
                for p, t, lay in zip(tree_leaves(self.params), whole, dpz.param):
                    p.copy_(lay.take(t))
            self.master_params = tree_unflatten(self.params, [
                lay.take(t).to(self.device).contiguous() for t, lay in zip(whole, dpz.opt)])
            return
        dev = self._to_device(tree_map(lambda t: t.float(), module))
        with torch.no_grad():
            for p, n in zip(tree_leaves(self.params), tree_leaves(dev)):
                p.copy_(n)
        if self._mixed:
            self.master_params = dev

    def _adapt_consolidated_optim(self, optim_sd, module):
        """Full-leaf moments (a consolidated sharded save, or a device save's
        leaves) in the restore format of this engine (``engine.py:2371``):
        the flat-offload format under offload, trees otherwise. The fp32
        master comes from the module tree."""
        step, sc = int(optim_sd["step"]), optim_sd.get("scaler")
        m_list, v_list = optim_sd["m"], optim_sd["v"]
        n = len(list(tree_leaves(self.params)))
        if len(m_list) != n:
            raise ValueError(f"checkpoint holds {len(m_list)} moment leaves, the parameter "
                             f"tree {n}")
        def flat32(a):
            return np.asarray(_host_tensor(a).float().contiguous(), np.float32)

        if self._offload_mgr is not None:
            return {"offload_host": {"step": step,
                                     "master": [flat32(t) for t in tree_leaves(module)],
                                     "m": [flat32(m).reshape(-1) for m in m_list],
                                     "v": [flat32(v).reshape(-1) for v in v_list]},
                    # the full-range split: the restore reshards into this
                    # engine's own split
                    "offload_dev": None, "host_idx": list(range(n)), "dev_idx": [],
                    "scaler": sc}
        shapes = [tuple(p.shape) for p in tree_leaves(module)]
        return {"step": step, "scaler": sc,
                **{k: tree_unflatten(self.params, [flat32(a).reshape(s)
                                                   for a, s in zip(lst, shapes)])
                   for k, lst in (("m", m_list), ("v", v_list))}}

    def _restore_offload(self, optim_sd, module):
        """The offload tiers from an ``offload_host`` file (``engine.py:2291-2340``):
        the same split restores as saved, another split reshards; the master
        copies are then the module weights."""
        mgr = self._offload_mgr
        saved_h = optim_sd.get("host_idx")
        saved_d = optim_sd.get("dev_idx") or []
        same_split = saved_h is None or (list(saved_h) == list(mgr["host_idx"])
                                         and list(saved_d) == list(mgr["dev_idx"]))
        if same_split:
            self._load_host_tier(optim_sd["offload_host"])
            od = optim_sd.get("offload_dev")
            if mgr["dev"] is not None and od:
                for k in ("master", "m", "v"):
                    mgr["dev"][k] = [_host_tensor(a).float().to(self.device) for a in od[k]]
        else:
            self._reshard_offload_load(optim_sd, saved_h, saved_d)
        # the module weights are the master copies (the file's own agree)
        flat = [_host_tensor(t) for t in tree_leaves(module)]
        self._assign_host_master([flat[i].float().numpy() for i in mgr["host_idx"]])
        if mgr["dev"] is not None:
            mgr["dev"]["master"] = [flat[i].float().to(self.device) for i in mgr["dev_idx"]]

    def _assign_host_master(self, whole):
        """The host tier's master from whole fp32 leaves (a rank of a group
        keeps its slices)."""
        host = self._offload_mgr["host"]
        for j, a in enumerate(whole):
            if self._zero_tier is not None:
                self._zero_tier.assign_master(j, a)
            else:
                host.master[j][...] = a.reshape(host.master[j].shape)

    def _load_host_tier(self, host_sd):
        """``host_sd`` (the flat format: ``master``, ``m``/``v`` or ``mv``,
        ``step``) into the host tier, whichever format the tier keeps."""
        host = self._offload_mgr["host"]
        if "mv" in host_sd and getattr(host, "_aio", None) is None:
            host_sd = {"step": host_sd["step"], "master": host_sd["master"],
                       "m": [np.asarray(b)[0] for b in host_sd["mv"]],
                       "v": [np.asarray(b)[1] for b in host_sd["mv"]]}
        elif "mv" not in host_sd and getattr(host, "_aio", None) is not None:
            host_sd = {"step": host_sd["step"], "master": host_sd["master"],
                       "mv": [np.stack([np.asarray(m, np.float32).reshape(-1),
                                        np.asarray(v, np.float32).reshape(-1)])
                              for m, v in zip(host_sd["m"], host_sd["v"])]}
        host.load_state_dict(host_sd)

    def _reshard_offload_load(self, optim_sd, saved_h, saved_d):
        """Offloaded state saved under another ratio split
        (``engine.py:2409``): the global per-leaf (master, m, v) from the
        saved host and device parts, redistributed into this engine's split."""
        mgr = self._offload_mgr
        n = len(mgr["host_idx"]) + len(mgr["dev_idx"])
        gmaster, gm, gv = _offload_as_full_lists(optim_sd, saved_h, saved_d, n)
        self._load_host_tier({"step": int(optim_sd["offload_host"]["step"]),
                              "master": [gmaster[i] for i in mgr["host_idx"]],
                              "m": [gm[i] for i in mgr["host_idx"]],
                              "v": [gv[i] for i in mgr["host_idx"]]})
        if mgr["dev"] is not None:
            shapes = [tuple(t.shape) for t in mgr["dev"]["master"]]
            for k, g in (("master", gmaster), ("m", gm), ("v", gv)):
                mgr["dev"][k] = [torch.from_numpy(np.asarray(g[i], np.float32).reshape(s)).to(
                    self.device) for i, s in zip(mgr["dev_idx"], shapes)]

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
        return self.zero_stage > 0

    def zero_optimization_stage(self) -> int:
        return self.zero_stage

    def get_fp32_params(self):
        """Full-precision view of the module weights, as CPU fp32 tensors
        (at dp > 1 or under tensor parallelism gathered from every rank's
        shards: a collective)."""
        if self._offload_mgr is not None:
            return tree_map(lambda p: _host_tensor(p).detach().float().cpu().clone(),
                            self._offload_master_tree())
        if self._dpz is not None:
            src = self._dp_full(tree_leaves(self.master_params), self._dpz.opt)
        else:
            src = self.master_params if self._mixed else self.params
        return tree_map(lambda p: p.detach().float().cpu(), self._tp_full(src))

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
