"""Attention: the plain version and the kernel dispatch (counterpart of ``deepspeed_tpu/ops/transformer/attention.py``).

``xla_attention`` is the always-available einsum path, named as in the JAX
package (registered as ``"xla"``). It is the CPU path, the plain version the
card's checks compare the kernels with, and the core of the paged kernel's
plain version. On the card the flash kernel (``"pallas_flash"``, the JAX
registry name, in ``flash_attention.py``) carries attention.

``attention()`` picks the registered implementation: the one forced with
``set_default_impl``, else ``"pallas_flash"`` for CUDA tensors and ``"xla"``
for CPU tensors. Where the JAX dispatch catches the kernel's
``NotImplementedError`` and runs XLA instead (``attention.py:100``), the port
does so only on the CPU: on the card a call the kernel cannot serve (bias,
softcap, a nonzero ``q_offset``, a head_dim outside 32/64/128/256) raises, and
the plain version never runs in the kernel's place.
"""

from typing import Optional

import torch

_IMPLS = {}
_DEFAULT_IMPL = None


def register_impl(name):
    def deco(fn):
        _IMPLS[name] = fn
        return fn
    return deco


def set_default_impl(name: Optional[str]):
    """Force an implementation (None = auto)."""
    global _DEFAULT_IMPL
    _DEFAULT_IMPL = name


def get_default_impl() -> Optional[str]:
    return _DEFAULT_IMPL


def _auto_impl(q) -> str:
    if _DEFAULT_IMPL is not None:
        return _DEFAULT_IMPL
    return "pallas_flash" if q.device.type == "cuda" else "xla"


@register_impl("xla")
def xla_attention(q, k, v, *, causal: bool = True, q_offset=0,
                  num_kv_groups: int = 1, softcap: float = 0.0, bias=None,
                  scale: Optional[float] = None, kv_rows=None):
    """Plain einsum attention on (B, Sq, h, d) q and (B, Skv, hkv, d) k/v.

    fp32 softmax; GQA handled by reshaping q into (hkv, groups); ``q_offset``
    (an int, or a (B,) tensor: one a row) shifts the causal diagonal (query
    i attends to keys <= i + q_offset); ``kv_rows`` ((B,), optional) takes
    row b's k/v from their batch row ``kv_rows[b]``. Returns (B, Sq, h, d)
    in q's dtype.
    """
    if kv_rows is not None:
        rows = kv_rows.to(device=k.device, dtype=torch.long)
        k, v = k[rows], v[rows]
    B, Sq, nh, hd = q.shape
    Skv, kvh = k.shape[1], k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    qg = q.reshape(B, Sq, kvh, num_kv_groups, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if softcap and softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        logits = logits.masked_fill(~causal_mask(Sq, Skv, q_offset, q.device), -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, Sq, nh, hd).to(q.dtype)


def causal_mask(Sq: int, Skv: int, q_offset, device) -> torch.Tensor:
    """True where query i may see key j, ``j <= i + q_offset``: (Sq, Skv)
    for an int offset, (B, 1, 1, Sq, Skv) for a (B,) tensor of offsets (to
    broadcast over the (B, kvh, g, Sq, Skv) scores)."""
    kpos = torch.arange(Skv, device=device)
    qpos = torch.arange(Sq, device=device)[:, None]
    if not isinstance(q_offset, torch.Tensor):
        return qpos + q_offset >= kpos[None, :]
    off = q_offset.to(device=device, dtype=torch.long).reshape(-1, 1, 1)
    return (qpos[None] + off >= kpos[None, None, :])[:, None, None]


def attention(q, k, v, *, causal=True, q_offset=0, num_kv_groups=1,
              softcap=0.0, bias=None, scale=None, impl: Optional[str] = None,
              kv_rows=None):
    """Multi-head attention with optional GQA / causal offset / softcap.

    q: (B, Sq, num_heads, head_dim); k/v: (B, Skv, kv_heads, head_dim), or
    any batch with ``kv_rows`` (B,) naming row b's. ``q_offset``: an int or
    a (B,) tensor. Returns (B, Sq, num_heads, head_dim) in q's dtype.
    """
    name = impl or _auto_impl(q)
    if name not in _IMPLS:
        raise ValueError(f"unknown attention implementation '{name}' "
                         f"(registered: {sorted(_IMPLS)})")
    on_card = q.device.type == "cuda"
    if on_card and name == "xla":
        raise ValueError("attention: the plain 'xla' version does not run in place of "
                         "the flash kernel on the card")
    kw = dict(causal=causal, q_offset=q_offset, num_kv_groups=num_kv_groups,
              softcap=softcap, bias=bias, scale=scale)
    if kv_rows is not None:
        kw["kv_rows"] = kv_rows
    if on_card:
        return _IMPLS[name](q, k, v, **kw)
    try:
        return _IMPLS[name](q, k, v, **kw)
    except NotImplementedError:
        return xla_attention(q, k, v, **kw)


from . import flash_attention  # noqa: E402,F401  (registers "pallas_flash")
