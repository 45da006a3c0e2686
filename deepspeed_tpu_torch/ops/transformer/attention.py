"""Plain attention (counterpart of ``xla_attention`` in ``deepspeed_tpu/ops/transformer/attention.py``).

Named as in the JAX package, where it is the always-available einsum path.
Here it serves the plain version of the paged kernel
(``paged_attention.paged_decode_attention_plain``), which the CPU tests and
the card's kernel-versus-plain checks run.
"""

from typing import Optional

import torch


def xla_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                  num_kv_groups: int = 1, softcap: float = 0.0, bias=None,
                  scale: Optional[float] = None):
    """Plain einsum attention on (B, Sq, h, d) q and (B, Skv, hkv, d) k/v.

    fp32 softmax; GQA handled by reshaping q into (hkv, groups); ``q_offset``
    shifts the causal diagonal (query i attends to keys <= i + q_offset).
    Returns (B, Sq, h, d) in q's dtype.
    """
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
        qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(Skv, device=q.device)[None, :]
        logits = logits.masked_fill(~(qpos >= kpos), -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, Sq, nh, hd).to(q.dtype)
