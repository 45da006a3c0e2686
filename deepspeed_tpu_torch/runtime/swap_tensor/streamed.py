"""ZeRO-Infinity parameter-tier training: layer-streamed execution (counterpart of ``deepspeed_tpu/runtime/swap_tensor/streamed.py``).

The whole parameter set never lives on the device. A host loop runs the
model one layer at a time: the embedding; each block's forward under
``no_grad``, keeping only the layer's input; the head's loss and its
gradient; then, in reverse, each block again under autograd (its recompute)
and its backward; last the embedding's backward. Each layer's weights come
from the ``StreamedParamStore`` (host RAM or NVMe, one group read ahead)
just before they are used and are dropped after, so of the weights the
device holds the stem and two layers whatever the depth, beside the layer
inputs and the gradient (below). The fp32
master and Adam's moments stay in host RAM (the moments optionally on NVMe)
and the C++ CPU Adam steps them (``OffloadedAdamState``): the parameter tier
composes with, and subsumes, the optimizer tier.

Where the gradients go. The JAX engine copies each layer's gradient to the
host as fp32 at once. Here each stays on the device in the compute dtype
until the optimizer's pass, which streams it down in chunks through the
TransferEngine, the next chunk's copy under the current chunk's Adam, and
widens each chunk to fp32 on the host (``OffloadedAdamState._grad_chunks``,
as the ZeRO-Offload tier does): a bf16 gradient widens exactly, so the Adam
sees the JAX engine's fp32 values. A host copy would not fit beside the
master and moments of llama-7b: 27 GB of fp32 master, 54 GB of moments
and 14 GB of gradient exceed a host of 96 GiB once the process's own
memory is counted; on the device the gradient (13.5 GB in bf16) sits beside
a working set of a few GiB. The stem's gradient is the fp32 sum of the
head's and the embedding's. With gradient accumulation the micro-steps'
gradients are summed in fp32 on the device and averaged, the JAX engine's
mean of micro-losses. The global norm for clipping is taken on the device
as the gradients are made (one accumulation step), or from the averaged
sums.

Scope, as the JAX engine's: ``TransformerLM`` dense models (no MoE, PLD or
random-LTD), bf16 or fp32, no fp16. Dropout keys are
``fold_in(fold_in(PRNGKey(seed), micro_steps), m)`` then ``fold_in(., layer)``
(``streamed.py:231-232, 277-279``): the JAX streamed engine's masks bit for
bit, by design not the resident engine's. Multi-rank streaming (the JAX
engine's ``_dp > 1``) is ROADMAP.md Queue 1 item 13d: ``initialize`` raises
for it. Checkpoints through ``state_dict`` / ``load_state_dict`` on the host
state.
"""

import time
from typing import Any, Dict, Union

import torch

from ...accelerator import resolve_device
from ...utils import prng
from ...utils.logging import log_dist
from ..zero.offload import OffloadedAdamState
from .param_swapper import HostRegistration, StreamedParamStore


class StreamedZeroEngine:
    """Training engine whose parameters never fully reside on the device."""

    def __init__(self, model, config, lr_scheduler=None,
                 device: Union[str, torch.device] = "cuda"):
        from ...models.transformer import TransformerLM

        if not isinstance(model, TransformerLM):
            raise ValueError("offload_param streaming requires a TransformerLM model")
        mcfg = model.config
        if mcfg.num_experts > 0 or mcfg.progressive_layer_drop or mcfg.random_ltd:
            raise ValueError(
                "offload_param streaming supports dense models only "
                "(no MoE / PLD / random-LTD)")
        if config.fp16_enabled:
            raise ValueError("offload_param streaming: use bf16 or fp32, not fp16")
        self.device = resolve_device(device)
        self.model = model
        self.config = config
        self.lr_scheduler = lr_scheduler
        self.optimizer = None  # reference surface: engine owns the optimizer
        self.training_dataloader = None
        self.compute_dtype = torch.bfloat16 if config.bfloat16_enabled else torch.float32
        if self.device.type == "cuda":
            from ...ops.transformer.flash_attention import check_kernel_config

            check_kernel_config(mcfg.num_heads, mcfg.kv_heads, mcfg.head_dim, self.compute_dtype)
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self._last_global_norm = None
        #: host seconds a step's parts took, summed over steps: the forward
        #: and backward loops (uploads waited for inside them), the head,
        #: the norm, the Adam (``adam_state.stats`` splits it: the gradient's
        #: D2H waits and fp32 cast, the C++ Adam), the NVMe writeback
        #: queueing; and once, the set-up's draw of the weights and
        #: page-locking (``init_s``, ``register_s``)
        self.stats = {"fwd_s": 0.0, "head_s": 0.0, "bwd_s": 0.0, "norm_s": 0.0,
                      "adam_s": 0.0, "writeback_s": 0.0}

        zc = config.zero_config
        off, opt_off = zc.offload_param, zc.offload_optimizer
        # the JAX engine draws PRNGKey(0)'s weights on the host; here the
        # generator seeded 0 on the engine's device, as the resident engine
        # draws them (``DeepSpeedEngine._extract_model``), each leaf moved to
        # the host as it is drawn: the device never holds the parameter set
        t0 = time.perf_counter()
        params = model.init_params(torch.Generator(device=self.device).manual_seed(0),
                                   dtype=torch.float32, device="cpu")
        self.stats["init_s"] = time.perf_counter() - t0
        L = mcfg.num_layers
        self.L = L
        blocks = params.pop("blocks")
        self.stem_keys = sorted(params)
        self.block_keys = sorted(blocks)
        # group 0 the stem, group 1 + i layer i: numpy views of the init
        # tensors, which become the master (no copy)
        self._groups = ([{k: params[k].numpy() for k in self.stem_keys}]
                        + [{k: blocks[k][i].numpy() for k in self.block_keys}
                           for i in range(L)])

        from ...ops.adam.cpu_adam import DeepSpeedCPUAdam
        from ...ops.optimizers import build_optimizer

        opt = build_optimizer(config.optimizer_name or "adamw", config.optimizer_params or {})
        self._lr = float(getattr(opt, "lr", 1e-3))
        if self.lr_scheduler is None and config.scheduler_name is not None:
            from ..lr_schedules import build_lr_scheduler

            self.lr_scheduler = build_lr_scheduler(
                config.scheduler_name, opt, config.scheduler_params)
        self.cpu_opt = DeepSpeedCPUAdam(
            lr=self._lr, betas=getattr(opt, "betas", (0.9, 0.999)),
            eps=getattr(opt, "eps", 1e-8),
            weight_decay=getattr(opt, "weight_decay", 0.0),
            adamw_mode=getattr(opt, "adam_w_mode", True),
        )
        self.adam_state = OffloadedAdamState(
            [g[k] for g in self._groups for k in sorted(g)],
            device=(opt_off.device if opt_off else "cpu"),
            nvme_path=(opt_off.nvme_path if opt_off else None), copy=False)

        from ..transfer_engine import TransferEngine

        self._transfer = TransferEngine(overlap=bool(zc.transfer_overlap), device=self.device)
        self.adam_state.transfer = self._transfer
        self._pinned = None
        if self.device.type == "cuda" and off.device == "cpu":
            # the master is the uploads' source: page-locked, they run async
            t0 = time.perf_counter()
            self._pinned = HostRegistration([params[k] for k in self.stem_keys]
                                            + [blocks[k] for k in self.block_keys])
            self.stats["register_s"] = time.perf_counter() - t0
        self.store = StreamedParamStore(
            self._groups, device=off.device, nvme_path=off.nvme_path,
            compute_dtype=self.compute_dtype, transfer=self._transfer)
        log_dist(
            f"StreamedZeroEngine: L={L} param tier={off.device} "
            f"opt tier={(opt_off.device if opt_off else 'cpu')} "
            f"dtype={self.compute_dtype} device={self.device}", ranks=[0])

    # ------------------------------------------------------------------
    def _head_grad(self, stem, xL, ids):
        """The head's loss (a plain ``logsumexp`` over fp32 logits, the JAX
        engine's ``head_loss``), its gradient w.r.t. the last layer's output
        and the stem's leaves (None where unused)."""
        keys = self.stem_keys
        leaves = [stem[k].detach().requires_grad_() for k in keys]
        x = xL.detach().requires_grad_()
        with torch.enable_grad():
            lg = self.model._head(dict(zip(keys, leaves)), x).float()
            labels = torch.cat([ids[:, 1:], torch.full_like(ids[:, :1], -100)], dim=1)
            mask = labels != -100
            safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
            logz = torch.logsumexp(lg, dim=-1)
            gold = lg.gather(-1, safe[..., None])[..., 0]
            loss = ((logz - gold) * mask).sum() / mask.sum().clamp(min=1)
            grads = torch.autograd.grad(loss, [x] + leaves, allow_unused=True)
        return loss.detach(), grads[0], grads[1:]

    def _embed_grad(self, stem, ids, positions, dx0):
        keys = self.stem_keys
        leaves = [stem[k].detach().requires_grad_() for k in keys]
        with torch.enable_grad():
            x0 = self.model._embed(dict(zip(keys, leaves)), ids, positions, self.compute_dtype)
            return torch.autograd.grad(x0, leaves, grad_outputs=dx0, allow_unused=True)

    def _micro_fwd_bwd(self, ids, rng_base):
        """One streamed forward and backward. Returns the loss, the
        gradients (device tensors in the master's leaf order: the stem's in
        fp32, the layers' in the compute dtype) and their squared norm (a
        device scalar)."""
        st, store, model = self.stats, self.store, self.model
        B, S = ids.shape
        L = self.L
        positions = torch.arange(S, dtype=torch.int32, device=self.device).expand(B, S)
        use_rng = model.config.dropout > 0

        def layer_rng(i):
            return prng.fold_in(rng_base, i) if use_rng else None

        t0 = time.perf_counter()
        stem = store.get(0)
        with torch.no_grad():
            x = model._embed(stem, ids, positions, self.compute_dtype)
            store.prefetch(1)
            xs = [x]
            for i in range(L):
                w = store.get(1 + i)
                x = model._block(x, w, positions, rng=layer_rng(i), train=True)
                store.prefetch(2 + i)  # after the block is enqueued: it runs under it
                xs.append(x)
                del w
                store.release()  # layer weights retire after the forward
        t1 = time.perf_counter()
        loss, dx, dstem_h = self._head_grad(stem, xs[L], ids)
        t2 = time.perf_counter()
        sq = torch.zeros((), dtype=torch.float32, device=self.device)
        layer_grads = [None] * L
        for i in reversed(range(L)):
            w = store.get(1 + i)
            leaves = [w[k].detach().requires_grad_() for k in self.block_keys]
            xin = xs[i].detach().requires_grad_()
            with torch.enable_grad():
                y = model._block(xin, dict(zip(self.block_keys, leaves)), positions,
                                 rng=layer_rng(i), train=True)
                grads = torch.autograd.grad(y, [xin] + leaves, grad_outputs=dx)
            if i > 0:
                store.prefetch(i)  # read-ahead: layer i-1's weights
            dx, layer_grads[i] = grads[0], grads[1:]
            for g in layer_grads[i]:  # leaf by leaf: an fp32 copy of one leaf at a time
                sq = sq + g.float().square().sum()
            del w, leaves, grads, y
            xs[i + 1] = None  # retire the activation stash as we go
            store.release()
        dstem_e = self._embed_grad(stem, ids, positions, dx)
        stem_grads = []
        for k, h, e in zip(self.stem_keys, dstem_h, dstem_e):
            g = torch.zeros(stem[k].shape, dtype=torch.float32, device=self.device)
            for part in (h, e):
                if part is not None:
                    g = g + part.float()
            stem_grads.append(g)
            sq = sq + g.square().sum()
        store.release()  # stem
        st["fwd_s"] += t1 - t0
        st["head_s"] += t2 - t1
        st["bwd_s"] += time.perf_counter() - t2
        return loss, stem_grads + [g for gs in layer_grads for g in gs], sq

    def train_batch(self, data_iter=None):
        """GAS micro-steps (gradients summed in fp32 on the device, the
        resident engine's mean of micro-losses) + one host Adam sweep, which
        streams the gradients down + the NVMe writeback queued (it runs
        under the next step's compute; a group's next read drains its
        pending write first)."""
        if data_iter is None:
            raise ValueError("train_batch needs a data_iter: the streamed engine takes no "
                             "training_data")
        gas = self.config.gradient_accumulation_steps
        st = self.stats
        losses = []
        B = 0
        for m in range(gas):
            batch = next(data_iter)
            ids = batch["input_ids"] if isinstance(batch, dict) else batch
            ids = torch.as_tensor(ids).to(device=self.device, dtype=torch.int32)
            B = ids.shape[0]
            rng_base = prng.fold_in(prng.fold_in(
                prng.PRNGKey(self.config.seed or 0, device=self.device), self.micro_steps), m)
            loss, grads, sq = self._micro_fwd_bwd(ids, rng_base)
            losses.append(loss)
            if gas > 1:
                if m == 0:
                    acc = [g.float() for g in grads]
                else:
                    for a, g in zip(acc, grads):
                        a.add_(g)
                del grads
            self.micro_steps += 1
        t0 = time.perf_counter()
        if gas > 1:
            inv = 1.0 / gas
            sq = None  # summed in fp32 from the first term on
            for a in acc:
                a.mul_(inv)
                term = a.square().sum().float()
                sq = term if sq is None else sq + term
            grads = acc
        clip = self.config.gradient_clipping
        clip_coef = 1.0
        gnorm = None
        if clip and clip > 0:
            gnorm = float(torch.sqrt(sq))
            clip_coef = min(1.0, clip / (gnorm + 1e-6))
        t1 = time.perf_counter()
        lr = self._current_lr()
        self.adam_state.adam_step(self.cpu_opt, grads, lr, clip_coef=clip_coef)
        del grads
        t2 = time.perf_counter()
        if self.store.device == "nvme":
            for gi in range(len(self._groups)):
                self.store.writeback(gi, wait=False)
        st["norm_s"] += t1 - t0
        st["adam_s"] += t2 - t1
        st["writeback_s"] += time.perf_counter() - t2
        self.global_steps += 1
        self.global_samples += B * gas
        self._last_global_norm = gnorm
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()
        return torch.stack(losses).mean()

    def _current_lr(self) -> float:
        if self.lr_scheduler is not None and hasattr(self.lr_scheduler, "get_lr"):
            lr = self.lr_scheduler.get_lr()
            return float(lr[0] if isinstance(lr, (list, tuple)) else lr)
        return self._lr

    def get_lr(self):
        return [self._current_lr()]

    # ------------------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {"adam": self.adam_state.state_dict(), "global_steps": self.global_steps}

    def load_state_dict(self, sd: Dict[str, Any]):
        self.adam_state.load_state_dict(sd["adam"])
        self.global_steps = int(sd.get("global_steps", 0))
        if self.store.device == "nvme":
            for gi in range(len(self._groups)):
                self.store.writeback(gi, wait=True)

    def close(self):
        """Land the queued writes and unregister the page-locked host memory
        (``HostRegistration`` also unregisters when collected)."""
        self.store.close()
        if self._pinned is not None:
            self._pinned.close()
            self._pinned = None
