"""Decoder-only transformer LM, paged-serving and training subsets (counterpart of ``deepspeed_tpu/models/transformer.py``).

The same functional design as the JAX package: ``TransformerLM`` holds a
``TransformerConfig`` and works on a plain dictionary of parameters with
the JAX package's leaf names and shapes. Block leaves stay stacked along a
leading layer axis ``(L, ...)``; each layer reads its slice as a view.

Ported: ``init_params``, ``init_kv_pool``, ``forward_paged`` (with
``n_valid`` and ``logit_rows``), the slot cache (``init_kv_cache``,
``forward_with_cache``, ``forward_with_cache_all``), the multi-token programs
``decode_paged_multi``, ``verify_paged_multi`` and ``draft_greedy``,
``sample_or_argmax`` (greedy and threefry-sampled), and the
training path: ``apply`` (the next-token loss), ``logits`` and the cacheless
block, whose attention goes through ``attention()`` (the flash kernels on
the card). ``forward_paged`` and ``logits`` take weight-only-quantized
trees (``inference.quantization.quantize_model``): every ``::q{8,6,4}``
projection runs through ``woq_matmul`` (the WOQ kernel on the card). All for the branches the gpt2 and llama presets take: pre-LN;
learned or RoPE positions; LayerNorm (with its biases) or RMSNorm;
tanh-GELU or SwiGLU; tied or untied head. Training with ``dropout > 0``
draws the JAX package's masks bit for bit (``_dropout``: threefry
``bernoulli`` under the reference's chain of ``split`` keys). Configurations
that need anything else raise ``NotImplementedError`` naming the field: at
construction, or for the training-only fields (PLD, random-LTD) in
``apply``. ``remat`` reruns each block in the backward under the JAX
package's seven ``remat_policy`` values (:meth:`TransformerLM._ckpt`).

Tensor parallelism: a model returned by :meth:`TransformerLM.with_tp`
(``tp`` = (degree, model coordinate), which the engines take from their
topology; ``runtime/tensor_parallel.py``) takes this rank's shards of the
leaves by :attr:`TransformerLM.tp_specs` (the JAX property's tree) and runs
Megatron's layout: the norms' outputs enter the column-parallel
``wq/wk/wv/w_up/w_gate`` through ``copy_to_model`` (its backward
all-reduces), ``wo`` and ``w_down`` are row-parallel and their
partial sums all-reduced, ``wte`` and ``lm_head`` are vocabulary-parallel
(the embedding masked and all-reduced, the training loss
``vocab_parallel_nll``), and logits that leave the model are all-gathered
over the vocabulary. Attention runs at ``num_heads / N`` and ``kv_heads /
N`` heads a rank; the slot cache holds a rank's KV heads. Dropout acts on
the replicated ``(B, S, H)`` tensors after the all-reduces, so every rank
draws the same masks.
"""

import copy
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..accelerator import resolve_device
from ..ops.quantizer.woq_gemm import woq_matmul
from ..ops.transformer.attention import attention as _attention_op
from ..ops.transformer.paged_attention import paged_decode_attention
from ..runtime import tensor_parallel as _tp
from ..runtime.activation_checkpointing import policies as _remat
from ..utils import prng
from ..utils.tree import tree_leaves

# the ROADMAP.md items that lift each unported branch
_MODEL_ITEM = "ROADMAP.md Queue 1 item 2, the remaining TransformerLM branches"
_MOE_ITEM = "ROADMAP.md Queue 1 item 17, moe/"
_DATA_ITEM = "ROADMAP.md Queue 1 item 17, runtime/data_pipeline"
_WOQ_TRAIN_ITEM = "ROADMAP.md Queue 1 item 14, training over a quantized tree"
_WOQ_BITS = (8, 6, 4)


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: Optional[int] = None  # GQA; None = MHA
    head_dim_override: Optional[int] = None
    intermediate_size: Optional[int] = None  # None -> 4*H (gelu) or 8/3*H (swiglu)
    max_seq_len: int = 1024
    causal: bool = True
    norm_position: str = "pre"
    token_type_embedding: int = 0
    mlm_head: bool = False
    pos_embedding: str = "learned"  # "learned" | "rope" | "alibi" | "none"
    norm: str = "layernorm"  # "layernorm" | "rmsnorm"
    activation: str = "gelu"  # "gelu" (tanh) | "gelu_exact" | "relu" | "swiglu" | "geglu"
    tie_embeddings: bool = True
    qkv_bias: bool = False
    attn_out_bias: bool = False
    norm_eps: float = 1e-5
    norm_weight_offset: float = 0.0
    embed_scale: Optional[float] = None
    rope_theta: float = 10000.0
    rotary_dim: Optional[int] = None
    parallel_block: bool = False
    parallel_shared_ln: bool = True
    embed_layernorm: bool = False
    alibi_slope_scale: float = 1.0
    lm_head_bias: bool = False
    dropout: float = 0.0
    num_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_aux_loss_coef: float = 0.01
    moe_drop_tokens: bool = True
    moe_use_residual: bool = False
    progressive_layer_drop: bool = False
    random_ltd: bool = False
    random_ltd_skip_ends: int = 1
    scan_layers: bool = True
    remat: bool = False
    remat_policy: str = "full"
    param_dtype: Any = torch.float32
    logit_softcap: float = 0.0
    name: str = "transformer"

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or (self.hidden_size // self.num_heads)

    @property
    def mlp_dim(self) -> int:
        if self.intermediate_size is not None:
            return self.intermediate_size
        if self.activation == "swiglu":
            d = int(8 * self.hidden_size / 3)
            return ((d + 255) // 256) * 256
        return 4 * self.hidden_size


# ----------------------------------------------------------------------------
# presets (the JAX package's, ``transformer.py:181-233``)
# ----------------------------------------------------------------------------

def gpt2_config(size: str = "125m", **kw) -> TransformerConfig:
    tbl = {
        "125m": dict(hidden_size=768, num_layers=12, num_heads=12),
        "350m": dict(hidden_size=1024, num_layers=24, num_heads=16),
        "760m": dict(hidden_size=1536, num_layers=24, num_heads=16),
        "1.3b": dict(hidden_size=2048, num_layers=24, num_heads=16),
        "2.7b": dict(hidden_size=2560, num_layers=32, num_heads=32),
        "6.7b": dict(hidden_size=4096, num_layers=32, num_heads=32),
        "13b": dict(hidden_size=5120, num_layers=40, num_heads=40),
    }
    base = dict(
        vocab_size=50304, max_seq_len=1024, pos_embedding="learned",
        norm="layernorm", activation="gelu", tie_embeddings=True,
        name=f"gpt2-{size}",
    )
    base.update(tbl[size])
    base.update(kw)
    return TransformerConfig(**base)


def llama_config(size: str = "7b", **kw) -> TransformerConfig:
    tbl = {
        "tiny": dict(hidden_size=256, num_layers=4, num_heads=8, num_kv_heads=4,
                     intermediate_size=688, max_seq_len=2048),
        "7b": dict(hidden_size=4096, num_layers=32, num_heads=32,
                   intermediate_size=11008, max_seq_len=4096),
        "13b": dict(hidden_size=5120, num_layers=40, num_heads=40,
                    intermediate_size=13824, max_seq_len=4096),
        "70b": dict(hidden_size=8192, num_layers=80, num_heads=64, num_kv_heads=8,
                    intermediate_size=28672, max_seq_len=4096),
    }
    base = dict(
        vocab_size=32000, pos_embedding="rope", norm="rmsnorm",
        activation="swiglu", tie_embeddings=False, norm_eps=1e-5,
        name=f"llama-{size}",
    )
    base.update(tbl[size])
    base.update(kw)
    return TransformerConfig(**base)


MODEL_PRESETS = {
    "gpt2-125m": lambda **kw: gpt2_config("125m", **kw),
    "gpt2-350m": lambda **kw: gpt2_config("350m", **kw),
    "gpt2-760m": lambda **kw: gpt2_config("760m", **kw),
    "gpt2-1.3b": lambda **kw: gpt2_config("1.3b", **kw),
    "gpt2-2.7b": lambda **kw: gpt2_config("2.7b", **kw),
    "gpt2-6.7b": lambda **kw: gpt2_config("6.7b", **kw),
    "llama-tiny": lambda **kw: llama_config("tiny", **kw),
    "llama-7b": lambda **kw: llama_config("7b", **kw),
    "llama-13b": lambda **kw: llama_config("13b", **kw),
    "llama-70b": lambda **kw: llama_config("70b", **kw),
}


# ----------------------------------------------------------------------------
# functional pieces
# ----------------------------------------------------------------------------

def _norm(x, scale, bias, kind: str, eps: float):
    xf = x.float()
    if kind == "rmsnorm":
        var = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * scale.float()
    else:
        mean = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        y = (xf - mean) * torch.rsqrt(var + eps) * scale.float()
        if bias is not None:
            y = y + bias.float()
    return y.to(x.dtype)


def _rope(q, k, positions, head_dim, theta):
    """Rotary embedding (rotate-half) applied to (B,S,h,d) q/k at integer
    positions (B,S)."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=q.device) / half))
    ang = positions[..., None].float() * freqs  # (B,S,half)
    cos = ang.cos()[:, :, None, :]
    sin = ang.sin()[:, :, None, :]

    def rot(x):
        x1, x2 = x.float().chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)

    return rot(q), rot(k)


def _dropout(x, rate, key, train, rows=None):
    """``transformer.py:295-299``: keep each element with probability
    ``1 - rate`` (``prng.bernoulli`` under ``key``, bit for bit
    ``jax.random.bernoulli``) and scale the kept ones by ``1 / (1 - rate)``
    in x's dtype. Autograd saves the bool mask for the backward. ``rows``
    ``(first, total)``: x is rows ``[first, first + len(x))`` of a batch of
    ``total`` rows (a data-parallel rank's), and the mask is those rows of
    the whole batch's draw."""
    if rate == 0.0 or not train or key is None:
        return x
    if rows is None:
        keep = prng.bernoulli(key, 1.0 - rate, x.shape)
    else:
        keep = prng.bernoulli(key, 1.0 - rate, x.shape,
                              offset=rows[0] * (x.numel() // x.shape[0]))
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _project(h, blk, name: str):
    """``h @ blk[name]`` for one projection: a float leaf as ``h @ w`` in
    ``h``'s dtype; a weight-only-quantized one (``<name>::q{bits}`` with its
    ``::scale``) through ``woq_matmul`` on ``h`` flattened to (rows, In),
    fp32 out, cast back to ``h``'s dtype: the JAX block's
    ``h @ _dequant_leaf(..., h.dtype)`` (``transformer.py:521, 537-539``)."""
    w = blk.get(name)
    if w is not None:
        return h @ w.to(h.dtype)
    for bits in _WOQ_BITS:
        codes = blk.get(f"{name}::q{bits}")
        if codes is not None:
            lead = h.shape[:-1]
            out = woq_matmul(h.reshape(-1, h.shape[-1]), codes, blk[f"{name}::scale"], bits)
            return out.to(h.dtype).reshape(*lead, out.shape[-1])
    raise KeyError(name)


def _check_supported(cfg: TransformerConfig) -> None:
    unsupported = (
        ("pos_embedding", cfg.pos_embedding not in ("learned", "rope"), _MODEL_ITEM),
        ("norm_position", cfg.norm_position != "pre", _MODEL_ITEM),
        ("parallel_block", cfg.parallel_block, _MODEL_ITEM),
        ("num_experts", cfg.num_experts > 0, _MOE_ITEM),
        ("embed_layernorm", cfg.embed_layernorm, _MODEL_ITEM),
        ("token_type_embedding", cfg.token_type_embedding > 0, _MODEL_ITEM),
        ("mlm_head", cfg.mlm_head, _MODEL_ITEM),
        ("logit_softcap", bool(cfg.logit_softcap), _MODEL_ITEM),
        ("norm", cfg.norm not in ("layernorm", "rmsnorm"), _MODEL_ITEM),
        ("activation", cfg.activation not in ("gelu", "swiglu"), _MODEL_ITEM),
        ("qkv_bias", cfg.qkv_bias, _MODEL_ITEM),
        ("attn_out_bias", cfg.attn_out_bias, _MODEL_ITEM),
        ("lm_head_bias", cfg.lm_head_bias, _MODEL_ITEM),
        ("norm_weight_offset", cfg.norm_weight_offset != 0.0, _MODEL_ITEM),
        ("embed_scale", cfg.embed_scale is not None, _MODEL_ITEM),
        ("rotary_dim", cfg.rotary_dim not in (None, cfg.head_dim), _MODEL_ITEM),
    )
    for field_name, bad, item in unsupported:
        if bad:
            raise NotImplementedError(
                f"TransformerConfig.{field_name}={getattr(cfg, field_name)!r} is "
                f"not ported to deepspeed_tpu_torch ({item})")


class TransformerLM:
    """Functional decoder LM over a parameter dictionary, the paged-serving
    subset of the JAX ``TransformerLM``."""

    def __init__(self, config: TransformerConfig):
        _check_supported(config)
        self.config = config
        #: (degree, this rank's coordinate) of the ``model`` axis the
        #: functions run over: (1, 0) unless :meth:`with_tp` set it
        self.tp = (1, 0)

    def with_tp(self, n: int, rank: int) -> "TransformerLM":
        """This model over a ``model`` axis of ``n``, as its coordinate
        ``rank``: a copy whose functions take that rank's shards of the
        leaves (:attr:`tp_specs`) and run the collectives on the ``model``
        group. The engines call it with their topology's layout; ``self``
        is left as it is."""
        self.check_tp(n)
        out = copy.copy(self)
        out.tp = (int(n), int(rank))
        return out

    # ------------------------------------------------------------------
    def init_params(self, generator: torch.Generator, dtype: Optional[torch.dtype] = None,
                    device: Optional[Union[str, torch.device]] = None,
                    tp: Optional[tuple] = None) -> Dict[str, Any]:
        """Random parameters with the JAX package's leaf names and shapes
        (``transformer.py:312-402``), drawn from ``generator`` on its device
        in ``dtype`` (default ``config.param_dtype``). ``device``, when
        given, is where the leaves land: each is drawn on the generator's
        device and moved there before the next is drawn (the same values;
        the generator's device holds one leaf at a time). The values differ
        from the JAX package's for the same seed: tests convert the JAX
        parameters with ``models.weights.params_from_jax`` instead.

        ``tp`` ``(N, c)``: the leaves of model coordinate ``c`` over a
        ``model`` axis of ``N`` (:attr:`tp_specs`), each drawn whole on the
        generator's device, cut, and only the shard moved to ``device``:
        every coordinate's shards are the one tree's, and no process holds
        more than one whole leaf at a time."""
        cfg = self.config
        specs = self.tp_specs
        if tp is not None:
            self.check_tp(tp[0])
        H, L, V, I = cfg.hidden_size, cfg.num_layers, cfg.vocab_size, cfg.mlp_dim
        nh, kvh, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
        dt = dtype or cfg.param_dtype
        dev = generator.device
        out = dev if device is None else torch.device(device)
        resid_std = 0.02 / (2 * L) ** 0.5  # depth-scaled residual projections

        def cut(t, spec):
            if tp is None:
                return t.to(out)
            return _tp.shard_leaf(t, _tp.spec_dim(spec), tp[0], tp[1]).to(out).contiguous()

        def normal(shape, std=0.02, spec=None):
            return cut(torch.randn(shape, generator=generator, device=dev, dtype=dt).mul_(std),
                       spec)

        def ones(shape):
            return torch.ones(shape, device=out, dtype=dt)

        def zeros(shape, spec=None):
            return cut(torch.zeros(shape, device=dev, dtype=dt), spec)

        bs = specs["blocks"]

        blocks: Dict[str, torch.Tensor] = {
            "ln1_scale": ones((L, H)),
            "wq": normal((L, H, nh * hd), spec=bs["wq"]),
            "wk": normal((L, H, kvh * hd), spec=bs["wk"]),
            "wv": normal((L, H, kvh * hd), spec=bs["wv"]),
            "wo": normal((L, nh * hd, H), resid_std, spec=bs["wo"]),
            "ln2_scale": ones((L, H)),
            "w_down": normal((L, I, H), resid_std, spec=bs["w_down"]),
        }
        params: Dict[str, Any] = {"wte": normal((V, H), spec=specs["wte"]), "blocks": blocks,
                                  "lnf_scale": ones((H,))}
        if cfg.activation == "swiglu":
            blocks["w_gate"] = normal((L, H, I), spec=bs["w_gate"])
        blocks["w_up"] = normal((L, H, I), spec=bs["w_up"])
        if cfg.norm == "layernorm":
            blocks["ln1_bias"] = zeros((L, H))
            blocks["ln2_bias"] = zeros((L, H))
            blocks["attn_bias"] = zeros((L, H))
            blocks["mlp_bias"] = zeros((L, H))
            if cfg.activation != "swiglu":
                blocks["mlp_up_bias"] = zeros((L, I), spec=bs["mlp_up_bias"])
            params["lnf_bias"] = zeros((H,))
        if cfg.pos_embedding == "learned":
            params["wpe"] = normal((cfg.max_seq_len, H))
        if not cfg.tie_embeddings:
            params["lm_head"] = normal((H, V), spec=specs.get("lm_head"))
        return params

    def param_shapes(self) -> Dict[str, Any]:
        """The whole leaves' shapes, the tree :meth:`init_params` draws."""
        cfg = self.config
        H, L, V, I = cfg.hidden_size, cfg.num_layers, cfg.vocab_size, cfg.mlp_dim
        nh, kvh, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
        blocks = {"ln1_scale": (L, H), "wq": (L, H, nh * hd), "wk": (L, H, kvh * hd),
                  "wv": (L, H, kvh * hd), "wo": (L, nh * hd, H), "ln2_scale": (L, H),
                  "w_down": (L, I, H), "w_up": (L, H, I)}
        shapes: Dict[str, Any] = {"wte": (V, H), "blocks": blocks, "lnf_scale": (H,)}
        if cfg.activation == "swiglu":
            blocks["w_gate"] = (L, H, I)
        if cfg.norm == "layernorm":
            for k in ("ln1_bias", "ln2_bias", "attn_bias", "mlp_bias"):
                blocks[k] = (L, H)
            if cfg.activation != "swiglu":
                blocks["mlp_up_bias"] = (L, I)
            shapes["lnf_bias"] = (H,)
        if cfg.pos_embedding == "learned":
            shapes["wpe"] = (cfg.max_seq_len, H)
        if not cfg.tie_embeddings:
            shapes["lm_head"] = (H, V)
        return shapes

    @property
    def tp_specs(self) -> Dict[str, Any]:
        """Tensor parallelism over the ``model`` axis (``transformer.py:406-485``),
        for the branches the port runs: column-parallel ``wq/wk/wv/w_up/w_gate``
        (and gpt2's ``mlp_up_bias``), row-parallel ``wo/w_down``,
        vocabulary-parallel ``wte`` and ``lm_head``; norms, the other biases
        and ``wpe`` replicated. A spec is a tuple, one entry a dimension;
        block leaves lead with the layer axis."""
        cfg = self.config
        m = _tp.MODEL_AXIS
        blocks: Dict[str, Any] = {
            "ln1_scale": (None, None), "wq": (None, None, m), "wk": (None, None, m),
            "wv": (None, None, m), "wo": (None, m, None), "ln2_scale": (None, None),
            "w_down": (None, m, None), "w_up": (None, None, m),
        }
        specs: Dict[str, Any] = {"wte": (m, None), "blocks": blocks, "lnf_scale": (None,)}
        if cfg.activation == "swiglu":
            blocks["w_gate"] = (None, None, m)
        if cfg.norm == "layernorm":
            for k in ("ln1_bias", "ln2_bias", "attn_bias", "mlp_bias"):
                blocks[k] = (None, None)
            if cfg.activation != "swiglu":
                blocks["mlp_up_bias"] = (None, m)
            specs["lnf_bias"] = (None,)
        if cfg.pos_embedding == "learned":
            specs["wpe"] = (None, None)
        if not cfg.tie_embeddings:
            specs["lm_head"] = (None, m)
        return specs

    def check_tp(self, n: int) -> None:
        """``ValueError`` naming the leaf and the degree where a model axis
        of ``n`` does not divide what it shards: the heads (K/V heads are
        never replicated), the MLP width, the vocabulary."""
        cfg = self.config
        for leaf, what, size in (("blocks/wq", "num_heads", cfg.num_heads),
                                 ("blocks/wk", "kv_heads", cfg.kv_heads),
                                 ("blocks/w_up", "mlp_dim", cfg.mlp_dim),
                                 ("wte", "vocab_size", cfg.vocab_size)):
            if size % n:
                raise ValueError(f"tensor parallelism: leaf '{leaf}' shards {what}={size}, "
                                 f"which a model degree of {n} does not divide")

    @staticmethod
    def stacked_leaves(params) -> List[bool]:
        """Which leaves of ``params`` (``tree_leaves`` order) are stacked by
        layer, ``(L, ...)``: those under ``blocks``. The engine's data-parallel
        collectives run such a leaf a layer at a time."""
        return [k == "blocks" for k in sorted(params) for _ in tree_leaves(params[k])]

    # ------------------------------------------------------------------
    def init_kv_pool(self, num_blocks: int, block_size: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device: Union[str, torch.device] = "cuda"):
        """Blocked KV pool ``(L, kvh, NB, BS, hd)``, kv-head-major so a pool
        block is one contiguous (BS, hd) tile per KV head; block 0 is the
        reserved trash block that padded writes land in."""
        cfg = self.config
        dev = resolve_device(device)
        shape = (cfg.num_layers, cfg.kv_heads, num_blocks, block_size, cfg.head_dim)
        return (torch.zeros(shape, dtype=dtype, device=dev),
                torch.zeros(shape, dtype=dtype, device=dev))

    def init_kv_cache(self, batch_size: int, max_len: int,
                      dtype: torch.dtype = torch.bfloat16,
                      device: Union[str, torch.device] = "cuda"):
        """Dense slot cache ``(L, batch_size, max_len, kvh, hd)`` for K and for
        V (``transformer.py:1026``): one row a slot; under tensor
        parallelism a rank's ``kv_heads / N`` heads."""
        cfg = self.config
        dev = resolve_device(device)
        shape = (cfg.num_layers, batch_size, max_len, cfg.kv_heads // self.tp[0],
                 cfg.head_dim)
        return (torch.zeros(shape, dtype=dtype, device=dev),
                torch.zeros(shape, dtype=dtype, device=dev))

    # ------------------------------------------------------------------
    def _embed(self, params, input_ids, positions, dtype):
        cfg = self.config
        n = self.tp[0]
        wte = params["wte"]
        if wte.shape[0] * n != cfg.vocab_size:
            raise ValueError(
                f"wte has {wte.shape[0]} rows: a model degree of {n} takes the "
                f"vocabulary's {cfg.vocab_size // n}-row shards (models.weights.tp_shard_params)")
        x = _tp.vocab_parallel_embed(wte, input_ids, self.tp).to(dtype)
        if cfg.pos_embedding == "learned":
            x = x + params["wpe"][positions].to(dtype)
        return x

    def _head(self, params, x, gather=True):
        """The final norm and the vocabulary projection; under tensor
        parallelism this rank's vocabulary shard, all-gathered unless
        ``gather`` is False (the training loss takes the shard)."""
        cfg = self.config
        x = _norm(x, params["lnf_scale"], params.get("lnf_bias"), cfg.norm, cfg.norm_eps)
        w = params["wte"].T if cfg.tie_embeddings else params["lm_head"]
        lg = _tp.copy_to_model(x, self.tp) @ w.to(x.dtype)
        return _tp.gather_from_model(lg, self.tp) if gather else lg

    def _qkv(self, x, blk, positions, named=False):
        """The pre-LN block's input norm and q/k/v projections, with RoPE
        (``transformer.py:528-548``): (B, S, nh, hd) q, (B, S, kvh, hd) k/v.
        ``named``: the norm's output goes through ``checkpoint_name`` as
        ``ln_out``, for a remat policy to keep."""
        cfg = self.config
        hd = cfg.head_dim
        B, S, _ = x.shape
        h = _norm(x, blk["ln1_scale"], blk.get("ln1_bias"), cfg.norm, cfg.norm_eps)
        if named:
            h = _remat.checkpoint_name(h, "ln_out")
        h = _tp.copy_to_model(h, self.tp)
        q = _project(h, blk, "wq").reshape(B, S, -1, hd)
        kk = _project(h, blk, "wk").reshape(B, S, -1, hd)
        v = _project(h, blk, "wv").reshape(B, S, -1, hd)
        if cfg.pos_embedding == "rope":
            q, kk = _rope(q, kk, positions, hd, cfg.rope_theta)
        return q, kk, v

    def _block_out(self, x, attn, blk, rng=None, train=False, named=False, rows=None):
        """The attention output projection, the residual adds and the MLP
        (``transformer.py:631-688``), given attention's (B, S, nh, hd). With
        a key ``rng`` both outputs go through ``_dropout`` under the
        reference's splits (``:636-638``, ``:679-681``). ``named``: the
        second norm's output and the MLP's activation go through
        ``checkpoint_name`` as ``ln_out`` and ``mlp_act`` (``:650, 674``)."""
        cfg = self.config
        B, S, _ = x.shape
        dt = x.dtype
        attn_out = _tp.reduce_from_model(_project(attn.reshape(B, S, -1), blk, "wo"), self.tp)
        if "attn_bias" in blk:
            attn_out = attn_out + blk["attn_bias"].to(dt)
        if rng is not None:
            rng, r1 = prng.split(rng)
            attn_out = _dropout(attn_out, cfg.dropout, r1, train, rows)

        x = x + attn_out
        h2 = _norm(x, blk["ln2_scale"], blk.get("ln2_bias"), cfg.norm, cfg.norm_eps)
        if named:
            h2 = _remat.checkpoint_name(h2, "ln_out")
        h2 = _tp.copy_to_model(h2, self.tp)
        if cfg.activation == "swiglu":
            inter = F.silu(_project(h2, blk, "w_gate")) * _project(h2, blk, "w_up")
        else:  # tanh-approximated GELU, as jax.nn.gelu's default
            up = _project(h2, blk, "w_up")
            if "mlp_up_bias" in blk:
                up = up + blk["mlp_up_bias"].to(dt)
            inter = F.gelu(up, approximate="tanh")
        if named:
            inter = _remat.checkpoint_name(inter, "mlp_act")
        mlp_out = _tp.reduce_from_model(_project(inter, blk, "w_down"), self.tp)
        if "mlp_bias" in blk:
            mlp_out = mlp_out + blk["mlp_bias"].to(dt)
        if rng is not None:
            rng, r2 = prng.split(rng)
            mlp_out = _dropout(mlp_out, cfg.dropout, r2, train, rows)
        return x + mlp_out

    def _block(self, x, blk, positions, rng=None, train=False, rows=None):
        """One pre-LN block on (B, S, H) without a cache, the training and
        evaluation branch (``transformer.py:619-630``): causal self-attention
        through ``attention()``, so the flash kernels on the card; dropout
        under ``rng``. Under ``remat`` the block names its norms' outputs and
        the MLP's activation, as the JAX block does."""
        cfg = self.config
        q, kk, v = self._qkv(x, blk, positions, named=cfg.remat)
        attn = _attention_op(q, kk, v, causal=cfg.causal,
                             num_kv_groups=cfg.num_heads // cfg.kv_heads,
                             softcap=cfg.logit_softcap)
        return self._block_out(x, attn, blk, rng, train, named=cfg.remat, rows=rows)

    def _block_paged(self, x, blk, positions, kp, vp, tables):
        """One pre-LN block on (B, S, H) against one layer of the blocked
        pool (``kp``/``vp`` (kvh, NB, BS, hd)), in the JAX block's order
        (``transformer.py:528-548, 563-607, 631-688``):

        1. the K/V of every row is scattered into the pool at its
           block/offset, in place;
        2. attention: each (row, position) is a one-token query against its
           row's block table with ``lens = position + 1``, so prefill rows of
           one chunk see each other's keys only through step 1;
        3. the MLP.
        """
        cfg = self.config
        nh, hd = cfg.num_heads, cfg.head_dim
        B, S, _ = x.shape
        q, kk, v = self._qkv(x, blk, positions)

        BS = kp.shape[2]
        blk_idx = tables.gather(1, (positions // BS).long())  # (B, S)
        off = positions % BS
        kp[:, blk_idx, off] = kk.to(kp.dtype).permute(2, 0, 1, 3)
        vp[:, blk_idx, off] = v.to(vp.dtype).permute(2, 0, 1, 3)

        rows = tables if S == 1 else tables.repeat_interleave(S, dim=0)
        lens = (positions + 1).reshape(B * S).to(torch.int32)
        attn = paged_decode_attention(q.reshape(B * S, nh, hd), kp, vp, rows, lens)
        return self._block_out(x, attn, blk)

    def _block_cached(self, x, blk, positions, ck, cv, cache_index, kv_rows, active):
        """One pre-LN block on (B, S, H) against one layer of the slot cache
        (``ck``/``cv`` (Bc, T, kvh, hd)), the JAX block's ``kv_cache`` branch
        (``transformer.py:608-618``) for every row at once:

        1. row b's K/V are written in place at its cache row ``kv_rows[b]``
           (b by default), positions ``cache_index[b] .. + S - 1``; with
           ``active`` (B,), an inactive row writes back what its cache held
           there (bitwise unchanged), as the JAX decode's
           ``where(active, new, old)`` (``engine_v2.py:369-371``);
        2. causal attention with ``q_offset=cache_index`` over the cache
           rows (``kv_rows``), read in place;
        3. the MLP."""
        cfg = self.config
        B, S, _ = x.shape
        q, kk, v = self._qkv(x, blk, positions)
        ar = torch.arange(S, dtype=cache_index.dtype, device=x.device)
        pos = (cache_index[:, None] + ar).long()  # (B, S) write positions
        rows = (torch.arange(B, device=x.device) if kv_rows is None
                else kv_rows.long())[:, None].expand(B, S)
        kn, vn = kk.to(ck.dtype), v.to(cv.dtype)
        if active is not None:
            keep = active.bool()[:, None, None, None]
            kn = torch.where(keep, kn, ck[rows, pos])
            vn = torch.where(keep, vn, cv[rows, pos])
        ck[rows, pos] = kn
        cv[rows, pos] = vn
        attn = _attention_op(q, ck, cv, causal=True, q_offset=cache_index,
                             num_kv_groups=cfg.num_heads // cfg.kv_heads,
                             softcap=cfg.logit_softcap, kv_rows=kv_rows)
        return self._block_out(x, attn, blk)

    def _trunk_with_cache(self, params, input_ids, kv_cache, cache_index, positions=None,
                          kv_rows=None, active=None):
        """Every block against the slot cache (``transformer.py:1031``), the
        cache written in place; ``cache_index`` is an int or a (B,) integer
        tensor, one write offset a row (the JAX engine vmaps a scalar)."""
        B, S = input_ids.shape
        dev = input_ids.device
        if not isinstance(cache_index, torch.Tensor):
            cache_index = torch.full((B,), int(cache_index), dtype=torch.int32, device=dev)
        if positions is None:
            positions = cache_index[:, None] + torch.arange(S, dtype=cache_index.dtype,
                                                            device=dev)
        ck_all, cv_all = kv_cache
        x = self._embed(params, input_ids, positions, ck_all.dtype)
        blocks = params["blocks"]
        for i in range(self.config.num_layers):
            blk = {k: w[i] for k, w in blocks.items()}
            x = self._block_cached(x, blk, positions, ck_all[i], cv_all[i], cache_index,
                                   kv_rows, active)
        return x

    def forward_with_cache_all(self, params, input_ids, kv_cache, cache_index,
                               positions=None, *, kv_rows=None):
        """Run a (B, S) segment against the slot cache ``kv_cache`` (the pair
        from :meth:`init_kv_cache`), written in place where the JAX function
        returns a new cache (``transformer.py:1052``); returns (B, S, V)
        logits. ``kv_rows`` ((B,), optional) names each row's cache row, so
        a group of slots runs against the whole cache."""
        x = self._trunk_with_cache(params, input_ids, kv_cache, cache_index, positions,
                                   kv_rows)
        return self._head(params, x)

    def forward_with_cache(self, params, input_ids, kv_cache, cache_index, positions=None,
                           *, kv_rows=None, n_valid=None, active=None):
        """:meth:`forward_with_cache_all` projecting one position a row
        through the vocabulary head (``transformer.py:1225``): the last, or
        with ``n_valid`` ((B,)) row b's position ``n_valid[b] - 1`` (the JAX
        prefill projects all S and keeps that one). ``active`` ((B,)) marks
        the rows whose K/V are written (see :meth:`_block_cached`).
        Returns (B, V)."""
        x = self._trunk_with_cache(params, input_ids, kv_cache, cache_index, positions,
                                   kv_rows, active)
        B, S, _ = x.shape
        if n_valid is None:
            return self._head(params, x[:, -1])
        last = (n_valid - 1).clamp(0, S - 1).long()
        return self._head(params, x[torch.arange(B, device=x.device), last])

    def forward_paged(self, params, input_ids, kv_pool, tables, starts,
                      n_valid=None, logit_rows=None):
        """Run a (B, S) segment against the blocked pool.

        ``kv_pool`` is the (k, v) pair from :meth:`init_kv_pool`; the
        segment's K/V are written into it in place (the JAX function returns
        a new pool instead). tables: (B, MAXB) int32 pool block ids per
        sequence (0-padded); starts: (B,) int32 first logical position of the
        segment. Returns (B, V) logits at each sequence's last valid position
        (``n_valid``, default S); with ``logit_rows`` ((R,) indices) only
        those rows go through the vocabulary head and (R, V) comes back.
        """
        B, S = input_ids.shape
        positions = starts[:, None] + torch.arange(S, dtype=starts.dtype,
                                                   device=starts.device)
        kp_all, vp_all = kv_pool
        x = self._embed(params, input_ids, positions, kp_all.dtype)
        blocks = params["blocks"]
        for i in range(self.config.num_layers):
            blk = {k: w[i] for k, w in blocks.items()}
            x = self._block_paged(x, blk, positions, kp_all[i], vp_all[i], tables)
        if n_valid is None:
            last = torch.full((B,), S - 1, dtype=torch.long, device=x.device)
        else:
            last = (n_valid - 1).clamp(0, S - 1).long()
        x_last = x[torch.arange(B, device=x.device), last]  # (B, H)
        if logit_rows is not None:
            x_last = x_last[logit_rows]
        return self._head(params, x_last)

    def decode_paged_multi(self, params, kv_pool, toks, tables, starts, k: int,
                           sampling=None, keys=None, sampled=None):
        """Fused ``k``-round decode against the blocked pool
        (``transformer.py:1110``): each round runs the length-1
        :meth:`forward_paged` over all B rows and feeds its selection back
        as the next round's input on the device, with no host round trip.

        ``toks`` (B,) int32, each row's last sampled token, written at
        ``starts[r]`` in round 0; ``tables`` (B, MAXB) must already cover
        positions ``starts .. starts+k-1`` (all-zero rows are padding whose
        writes land in trash block 0). Each round computes what the ragged
        decode round computes per row, at the same (B, 1) shape, so ``k``
        fused rounds give ``k`` single steps' tokens.

        ``sampling``: None for plain argmax, else the per-row
        ``(seeds, temps, top_ks, top_ps, bias)`` with (B, V) ``bias``;
        round j selects under the key of absolute position ``starts + j +
        1``. ``keys`` (k, B, 2), when given, are those keys precomputed
        (the engine derives them on the host); ``sampled`` is the host's
        decision that some row samples (None: read ``temps``). Returns
        (B, k) int32 tokens; the pool is written in place."""
        seeds, temps, top_ks, top_ps, bias = sampling or (None,) * 5
        t, pos, ys = toks, starts, []
        for j in range(int(k)):
            lg = self.forward_paged(params, t[:, None], kv_pool, tables, pos)
            t = sample_or_argmax(lg, seeds, pos + 1, temps, top_ks, top_ps, bias=bias,
                                 keys=None if keys is None else keys[j], sampled=sampled)
            ys.append(t)
            pos = pos + 1
        return torch.stack(ys, dim=1)

    def verify_paged_multi(self, params, kv_pool, segs, tables, starts, sampling=None,
                           keys=None, sampled=None):
        """Speculative verification against the blocked pool
        (``transformer.py:1151``): B rows' K-token segments (the last
        sampled token, then K-1 drafts) as B·K length-1 rows of one
        :meth:`forward_paged`, each row with its sequence's table and
        position ``starts + j``. The segment's K/V are written before
        attention, so position j reads positions < j of the same dispatch.
        Output ``[r, j]`` is the selection after ``segs[r, :j+1]``, under
        the key of position ``starts[r] + j + 1`` for a sampled row.

        ``sampling`` as in :meth:`decode_paged_multi`, per row and repeated
        over the row's K positions; ``keys`` (B, K, 2) precomputed. Returns
        (B, K) int32."""
        B, K = segs.shape
        ids = segs.reshape(B * K, 1)
        tab = tables.repeat_interleave(K, dim=0)
        pos = (starts[:, None] + torch.arange(K, dtype=starts.dtype,
                                              device=starts.device)).reshape(B * K)
        lg = self.forward_paged(params, ids, kv_pool, tab, pos)
        if sampling is not None:
            sampling = tuple(a.repeat_interleave(K, dim=0) for a in sampling)
        seeds, temps, top_ks, top_ps, bias = sampling or (None,) * 5
        ys = sample_or_argmax(lg, seeds, pos + 1, temps, top_ks, top_ps, bias=bias,
                              keys=None if keys is None else keys.reshape(B * K, 2),
                              sampled=sampled)
        return ys.reshape(B, K)

    def draft_greedy(self, params, window, n_valid: int, k: int):
        """Greedy ``k``-token continuation for a draft model
        (``transformer.py:1204``): ``k`` rounds of the full-window
        :meth:`logits` over ``window`` (W,) int32, right-padded past
        ``n_valid`` and position-rebased (the context tail starts at
        position 0), each round's argmax at the last valid position written
        into the window on the device. The caller guarantees ``n_valid + k
        <= W``. Returns the (k,) drafted tokens on ``window``'s device."""
        win, ys = window.clone(), []
        for j in range(int(k)):
            lg = self.logits(params, win[None, :])[0]  # (W, V)
            nxt = torch.argmax(lg[n_valid + j - 1], dim=-1).to(win.dtype)
            win[n_valid + j] = nxt
            ys.append(nxt)
        return torch.stack(ys)

    # ------------------------------------------------------------------
    # training and evaluation: the full sequence, no cache
    # ------------------------------------------------------------------
    def _check_trainable(self, train: bool) -> None:
        cfg = self.config
        unsupported = (
            ("progressive_layer_drop", cfg.progressive_layer_drop, _DATA_ITEM),
            ("random_ltd", cfg.random_ltd, _DATA_ITEM),
        )
        for field_name, bad, item in unsupported:
            if bad:
                raise NotImplementedError(
                    f"TransformerConfig.{field_name}={getattr(cfg, field_name)!r} is not "
                    f"ported to the training path of deepspeed_tpu_torch ({item})")

    def _lean_policy(self):
        """``transformer.py:733-752``: dots with no batch dimension kept,
        except those whose weight's last dimension is at least 2H (the MLP's
        up and gate projections: the bulk of the activations, one cheap
        matmul to recompute), plus the flash residuals."""
        H = self.config.hidden_size
        flash = _remat.save_only_these_names(*_remat.FLASH_NAMES)

        def policy(op, args):
            if _remat.dots_with_no_batch_dims_saveable(op, args):
                return args[1].shape[-1] < 2 * H
            return flash(op, args)

        return policy

    def _ckpt(self, fn):
        """``fn`` rematerialised under ``remat_policy`` (``transformer.py:754-795``).
        What each policy keeps: ``dots`` the weight-side projections (dots
        with no batch dimension) and the flash residuals, so the backward
        recomputes no matmul and no attention forward; ``dots_ln`` also the
        two norms' outputs; ``dots_elem`` also the MLP's activation;
        ``dots_plain`` the projections alone; ``dots_batch`` every dot;
        ``dots_lean`` see :meth:`_lean_policy`; ``full`` nothing but the
        block's inputs."""
        P = _remat
        policy = {
            "dots": P.save_from_both_policies(
                P.dots_with_no_batch_dims_saveable,
                P.save_only_these_names("attn_out", "attn_lse")),
            "dots_ln": P.save_from_both_policies(
                P.dots_with_no_batch_dims_saveable,
                P.save_only_these_names("attn_out", "attn_lse", "ln_out")),
            "dots_elem": P.save_from_both_policies(
                P.dots_with_no_batch_dims_saveable,
                P.save_only_these_names("attn_out", "attn_lse", "ln_out", "mlp_act")),
            "dots_plain": P.dots_with_no_batch_dims_saveable,
            "dots_batch": P.dots_saveable,
            "dots_lean": self._lean_policy(),
            "full": None,
        }
        name = self.config.remat_policy
        if name not in policy:
            raise ValueError(
                f"unknown remat_policy {name!r} (known: {sorted(policy)})")
        return P.remat(fn, policy[name])

    def _trunk(self, params, x, positions, rng=None, train=False, rows=None):
        """Every block in turn (``transformer.py:796-849`` with
        ``scan_layers=False``: a Python loop over the stacked leaves, each
        layer reading its slice as a view, so gradients land in the stacked
        leaves), each under :meth:`_ckpt` with ``remat`` while autograd
        records. Training with dropout takes the reference's keys:
        ``split(rng, L)``, then per layer ``split`` into ``(r_drop, r_pld)``
        (``:807-811``); ``r_pld`` goes unused, as PLD is not ported, but its
        split keeps ``r_drop`` the reference's. A recompute redraws the same
        masks from the same keys. ``rows`` as for ``apply``."""
        cfg = self.config
        blocks = params["blocks"]
        rngs = (prng.split(rng, cfg.num_layers)
                if rng is not None and train and cfg.dropout > 0 else None)
        block = self._block
        if cfg.remat and torch.is_grad_enabled():
            block = self._ckpt(self._block)
        for i in range(cfg.num_layers):
            r_drop = None if rngs is None else prng.split(rngs[i])[0]
            x = block(x, {k: w[i] for k, w in blocks.items()}, positions, r_drop, train, rows)
        return x

    def _logits_aux(self, params, input_ids, positions=None, train=False, rng=None,
                    rows=None, gather=True):
        """(B, S, V) logits and the MoE aux loss, always 0 here
        (``transformer.py:934-963``). The compute dtype is that of the first
        floating leaf, in the JAX package's sorted-key order."""
        self._check_trainable(train)
        B, S = input_ids.shape
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=input_ids.device).expand(B, S)
        dtype = next((t.dtype for t in tree_leaves(params) if t.is_floating_point()),
                     torch.float32)
        x = self._embed(params, input_ids, positions, dtype)
        if rng is not None:
            rng = rng.to(x.device)
        x = self._trunk(params, x, positions, rng, train, rows)
        return (self._head(params, x, gather),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def logits(self, params, input_ids, positions=None, train=False, rng=None,
               attention_mask=None, token_type_ids=None):
        if attention_mask is not None or token_type_ids is not None:
            raise NotImplementedError(
                "logits(attention_mask / token_type_ids) is not ported "
                f"({_MODEL_ITEM})")
        return self._logits_aux(params, input_ids, positions, train, rng)[0]

    def apply(self, params, batch, train=True, rng=None, rows=None):
        """Next-token LM loss over the batch (the engine protocol,
        ``transformer.py:971-1021``).

        ``batch``: dict with ``input_ids`` (B, S) and optional ``labels``
        (shifted internally when absent; -100 = ignore) and ``positions``,
        or a bare (B, S) tensor, or an (input_ids, labels) pair. fp32
        logits; the loss is the mean of ``logsumexp - gold`` over the
        labelled tokens. Over a weight-only-quantized tree the loss is
        computed for ``train=False`` (each projection through ``_project``)
        and refused for ``train=True``. ``rows`` ``(first, total)``: the
        batch is rows ``[first, first + B)`` of a global batch of ``total``
        (a data-parallel rank's share), and dropout draws those rows of the
        global batch's masks.
        """
        if train and any("::" in k for k in params.get("blocks", {})):
            raise NotImplementedError(
                "apply (training) over weight-only-quantized leaves is not ported: "
                f"there is no gradient with respect to codes ({_WOQ_TRAIN_ITEM})")
        if isinstance(batch, dict):
            extra = sorted(set(batch) - {"input_ids", "labels", "positions"})
            if extra:
                raise NotImplementedError(
                    f"batch keys {extra} (attention masks, token types, PLD, LTD) are "
                    f"not ported ({_MODEL_ITEM}; {_DATA_ITEM})")
            input_ids, labels, positions = (batch["input_ids"], batch.get("labels"),
                                            batch.get("positions"))
        elif isinstance(batch, (tuple, list)):
            (input_ids, labels), positions = batch, None
        else:
            input_ids, labels, positions = batch, None, None
        lg, _ = self._logits_aux(params, input_ids, positions=positions, train=train, rng=rng,
                                 rows=rows, gather=False)
        if labels is None:
            if not self.config.causal:
                raise ValueError(
                    "encoder (causal=False) models need explicit labels — "
                    "next-token shifting only applies to causal LMs")
            labels = torch.cat([input_ids[:, 1:], torch.full_like(input_ids[:, :1], -100)],
                               dim=1)
        mask = labels != -100
        nll = _tp.vocab_parallel_nll(lg, labels, self.tp) * mask
        return nll.sum() / mask.sum().clamp(min=1)


def _host_any_positive(temps) -> bool:
    """``any(temps > 0)`` read on the host: numpy arrays and CPU tensors
    cost no device sync (a CUDA tensor does)."""
    if isinstance(temps, torch.Tensor):
        return bool((temps > 0).any())
    return bool((np.asarray(temps) > 0).any())


def row_keys(seeds, positions) -> torch.Tensor:
    """The counter-based keys ``fold_in(PRNGKey(seeds), positions)``,
    (..., 2) int64 words, computed where ``seeds`` and ``positions`` live
    (the engine passes host arrays: the hash's ~170 ops on a few words cost
    no launch there). Exact integer arithmetic, so the bits do not depend on
    the device."""
    return prng.fold_in(prng.PRNGKey(torch.as_tensor(seeds)), torch.as_tensor(positions))


def select_sampled(lg, temps, top_ks, top_ps, keys):
    """The sampled branch of :func:`sample_or_argmax` on (R, V) ``lg``, all
    on ``lg``'s device: ``temps``/``top_ps`` (R,) floats, ``top_ks`` (R,)
    integers, ``keys`` (R, 2) key words (int64, or int32 holding the uint32
    bits). Rows with ``temps == 0`` take plain argmax. Launches no host
    copy and reads nothing back, so it can run inside a captured step."""
    greedy = torch.argmax(lg, dim=-1).to(torch.int32)
    temps = temps.to(torch.float32)
    top_ks = top_ks.to(torch.int64)[:, None]
    top_ps = top_ps.to(torch.float32)[:, None]
    V = lg.shape[-1]
    sampled = temps > 0.0
    x = lg.float() / torch.where(sampled, temps, 1.0)[:, None]
    srt = torch.sort(x, dim=-1, descending=True).values
    kth = srt.gather(1, (top_ks - 1).clamp(0, V - 1))
    x = torch.where((top_ks > 0) & (x < kth), -torch.inf, x)
    probs = torch.softmax(srt, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_ps
    keep[:, 0] = True  # the nucleus is never empty
    thr = torch.where(keep, srt, torch.inf).amin(dim=-1, keepdim=True)
    x = torch.where((top_ps < 1.0) & (x < thr), -torch.inf, x)
    tok = prng.categorical(keys.to(torch.int64) & 0xFFFFFFFF, x).to(torch.int32)
    return torch.where(sampled, tok, greedy)


def sample_or_argmax(lg, seeds=None, positions=None, temps=None, top_ks=None,
                     top_ps=None, *, bias=None, keys=None, sampled=None):
    """Per-row token selection shared by greedy and sampled serving
    (``transformer.py:1233``), and the one the engine's step programs run:
    a row with ``temps[r] == 0`` takes plain argmax (the first index on
    ties, as ``jnp.argmax``); a row with ``temps[r] > 0`` draws one
    categorical sample from the temperature/top-k/top-p-shaped distribution
    under the counter-based key ``fold_in(PRNGKey(seeds[r]), positions[r])``
    (``utils.prng``, bit for bit jax's threefry). ``positions`` is the
    produced token's 0-based absolute index over prompt + generated, so a
    replay that re-feeds the committed history lands on the same (seed,
    position) keys and draws the same tokens. A sampled row is drawn on
    ``lg``'s device.

    Where the JAX package skips the sampling arithmetic with a ``lax.cond``
    on the device, this decides on the host, so a step whose rows are all
    greedy launches the argmax alone: ``sampled`` is that decision, read
    from ``temps`` when None (a numpy array from the caller: no sync). The
    sampled rows' arithmetic is batched over the (R, V) block
    (:func:`select_sampled`): one descending sort of the scaled rows serves
    the top-k threshold (the ``top_ks``-th value) and the top-p mass
    (``softmax`` of the sorted rows before the top-k mask, the first entry
    always kept).

    ``lg`` (R, V) logits; ``bias`` (R, V), when given, is added first (the
    engine's logit-bias rows); the per-row arguments (R,) as numpy arrays or
    tensors: ``seeds``, ``positions``, ``top_ks`` integers, ``temps``,
    ``top_ps`` float32. ``temps=None`` means every row is greedy. ``keys``
    (R, 2), when given, are the rows' keys already derived (the engine
    derives them on the host and stages them with the step's inputs, so
    with tensors on ``lg``'s device the call copies nothing and can run
    inside a captured step); else they come from ``seeds`` and
    ``positions``. Returns (R,) int32 token ids on ``lg``'s device."""
    if bias is not None:
        lg = lg + bias
    if sampled is None:
        sampled = temps is not None and _host_any_positive(temps)
    if not sampled:
        return torch.argmax(lg, dim=-1).to(torch.int32)
    dev = lg.device

    def rows(a):
        return torch.as_tensor(a).to(device=dev)

    if keys is None:
        keys = row_keys(seeds, positions)
    return select_sampled(lg, rows(temps), rows(top_ks), rows(top_ps), rows(keys))


def build_model(preset: str, **overrides) -> TransformerLM:
    if preset not in MODEL_PRESETS:
        raise ValueError(f"unknown model preset '{preset}' (known: {sorted(MODEL_PRESETS)})")
    return TransformerLM(MODEL_PRESETS[preset](**overrides))
