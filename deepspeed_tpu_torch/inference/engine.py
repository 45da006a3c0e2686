"""Inference engine v1: tensor-parallel generation over a slot cache (counterpart of ``deepspeed_tpu/inference/engine.py``).

The JAX engine places the weights by ``tp_specs`` (or ``quantized_tp_specs``
for a weight-only-quantized tree) over the ``model`` mesh axis, and jits a
prefill and a ``lax.scan`` decode loop. The port runs one process a rank:

- the weights are cast as the JAX engine casts them (integer codes and
  ``::scale`` leaves keep their dtype) and cut to this rank's TP shards
  (``models.weights.tp_layout``; a leaf already a rank's shard is taken as
  it is) and the model runs over that layout (``TransformerLM.with_tp``);
- ``generate`` runs one prefill through ``forward_with_cache`` into the
  slot cache (``init_kv_cache``: a rank's KV heads), then one decode step a
  token, eagerly, with the JAX engine's EOS masking; the model's
  collectives run on the ``model`` group, and the logits that reach the
  sampler are all-gathered over the vocabulary, so every rank samples the
  same token;
- ``_sample_logits`` is the JAX function: greedy, or temperature, top-k and
  top-p, then ``categorical`` under the key chain ``split`` gives, in the
  port's threefry (``utils/prng.py``: jax's bits).

On the card the slot forward runs the flash kernels and a quantized tree
the WOQ kernels, at a rank's shard shapes.
"""

from typing import Optional, Union

import torch

from ..accelerator import resolve_device
from ..comm.topology import MODEL_AXIS, get_topology, initialize_topology
from ..utils import prng
from ..utils.logging import log_dist
from .config import DeepSpeedInferenceConfig

_DTYPES = {"fp32": torch.float32, "fp16": torch.float16, "bf16": torch.bfloat16,
           "float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16}


def _sample_logits(logits, key, temperature, top_k, top_p):
    """The next token from (B, V) fp32 logits (``engine.py:37-53``): argmax
    at temperature 0, else the logits scaled, cut to the top ``top_k`` and
    to the nucleus of mass ``top_p``, and one categorical draw a row under
    ``key``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / max(temperature, 1e-6)
    neg = torch.tensor(-torch.inf, dtype=logits.dtype, device=logits.device)
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg, logits)
    if top_p < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1)
        # the smallest set with cumulative mass >= top_p; at least one token
        idx = (cum < top_p).sum(dim=-1, keepdim=True)
        cutoff = srt.gather(-1, idx.clamp(max=srt.shape[-1] - 1))
        logits = torch.where(logits < cutoff, neg, logits)
    g = prng.gumbel(key.to(logits.device), logits.shape)
    return torch.argmax(g + logits, dim=-1).to(torch.int32)


class InferenceEngine:
    """Generation over a ``TransformerLM`` (``engine.py:56``), on this
    rank's tensor-parallel shards of its weights."""

    def __init__(self, model, config: Optional[DeepSpeedInferenceConfig] = None,
                 params=None, topology=None, device: Union[str, torch.device] = "cuda",
                 **kwargs):
        self.config = config or DeepSpeedInferenceConfig.from_dict(kwargs)
        self.module = model
        self.topology = topology or get_topology()
        self.device = resolve_device(device)
        self.dtype = _DTYPES[str(self.config.dtype).replace("torch.", "")]
        if params is None:
            if hasattr(model, "params"):
                params = model.params
            else:
                params = model.init_params(torch.Generator(self.device).manual_seed(0))
        tp = self.topology.model_parallel_size
        if tp > 1:
            from ..models.weights import tp_layout

            coord = self.topology.coords[MODEL_AXIS]
            params = tp_layout(model, tp, coord, params).local(params, copy=True)
            self.module = model.with_tp(tp, coord)
        self.params = self._cast(params)
        log_dist(f"InferenceEngine: dtype={self.dtype} tp={tp} device={self.device}",
                 ranks=[0])

    def _cast(self, tree, name=""):
        """Every leaf on the device; floating leaves in the engine's dtype,
        but weight-only-quantized codes and their ``::scale`` leaves as they
        are (``engine.py:74-83``)."""
        if isinstance(tree, dict):
            return {k: self._cast(v, k) for k, v in tree.items()}
        t = torch.as_tensor(tree)
        if not t.is_floating_point() or name.endswith("::scale"):
            return t.to(self.device)
        return t.to(device=self.device, dtype=self.dtype)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32, temperature: Optional[float] = None,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 eos_token_id: int = -1, seed: int = 0, **kwargs):
        """Continuations of (B, S) int32 ``input_ids`` (``engine.py:150``):
        (B, max_new_tokens) int32, the generated tokens only, padded with
        ``eos_token_id`` after a row's EOS. Prefill at positions 0..S-1,
        then token ``i`` fed at position S + i; each selection takes the
        next key of ``split(PRNGKey(seed))``'s chain."""
        cfg = self.config
        temperature = cfg.temperature if temperature is None else temperature
        top_k = cfg.top_k if top_k is None else top_k
        top_p = cfg.top_p if top_p is None else top_p
        model = self.module
        ids = torch.as_tensor(input_ids).to(device=self.device, dtype=torch.int32)
        B, S = ids.shape
        cache = model.init_kv_cache(B, S + max_new_tokens, dtype=self.dtype, device=self.device)
        key = prng.PRNGKey(seed)
        logits = model.forward_with_cache(self.params, ids, cache, 0)
        key, sub = prng.split(key)
        tok = _sample_logits(logits.float(), sub, temperature, top_k, top_p)
        eos = torch.tensor(eos_token_id, dtype=torch.int32, device=self.device)
        done = tok == eos
        out = [tok]
        for i in range(max_new_tokens - 1):
            key, sub = prng.split(key)
            logits = model.forward_with_cache(self.params, tok[:, None], cache, S + i)
            nxt = _sample_logits(logits.float(), sub, temperature, top_k, top_p)
            nxt = torch.where(done, eos, nxt)
            done = done | (nxt == eos)
            out.append(nxt)
            tok = nxt
        return torch.stack(out, dim=1)

    @torch.no_grad()
    def forward(self, input_ids, **kwargs):
        """Logits over the whole input (``engine.py:184``), (B, S, V)."""
        ids = torch.as_tensor(input_ids).to(device=self.device, dtype=torch.int32)
        return self.module.logits(self.params, ids)

    __call__ = forward


def init_inference(model, config=None, params=None, device: Union[str, torch.device] = "cuda",
                   **kwargs) -> InferenceEngine:
    """Build the v1 engine (``engine.py:189``). ``params`` overrides the
    model's own (a converted tree, or a weight-only-quantized one from
    ``inference.quantization.quantize_model``), whole or as this rank's
    shards. ``tensor_parallel={"tp_size": N}`` serves over a ``model`` axis
    of ``N`` ranks, one process a rank: it joins the process group
    (``comm.init_distributed``: the environment ``torchrun`` sets, or a group
    the caller made) and builds the model group."""
    if config is None:
        config = DeepSpeedInferenceConfig.from_dict(kwargs)
    elif isinstance(config, dict):
        merged = dict(config)
        merged.update(kwargs)
        config = DeepSpeedInferenceConfig.from_dict(merged)
    elif kwargs:
        merged = dict(config.__dict__)
        merged.update(kwargs)
        config = DeepSpeedInferenceConfig.from_dict(merged)
    import torch.distributed as torch_dist

    from ..comm import comm

    tp = config.tp_size
    if tp > 1 and not torch_dist.is_initialized():
        comm.init_distributed()
    world = torch_dist.get_world_size() if torch_dist.is_initialized() else 1
    if world % tp:
        raise ValueError(f"init_inference: tensor_parallel.tp_size={tp} needs a multiple of "
                         f"{tp} ranks, have {world}")
    topo = get_topology(required=False)
    if topo is None or topo.model_parallel_size != tp or topo.world_size != world:
        rank = torch_dist.get_rank() if torch_dist.is_initialized() else 0
        topo = initialize_topology(model=tp, world_size=world, rank=rank)
    return InferenceEngine(model, config, params=params, topology=topo, device=device)
