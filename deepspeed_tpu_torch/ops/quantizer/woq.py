"""Weight-only quantization (counterpart of ``deepspeed_tpu/ops/quantizer/woq.py``).

The same arithmetic as the JAX package, on tensors on whatever device they
lie: per-group symmetric codes along the contraction (input) dimension,
stored in the parameter dictionary as ``<name>::q8`` / ``::q6`` / ``::q4``
int8 codes of shape ``(..., ng, packed, out)`` beside a ``<name>::scale``
fp32 leaf of shape ``(..., ng, 1, out)``. int4 packs two codes a byte (the
low nibble is row ``2j``, the high nibble row ``2j + 1``); int6 packs four
codes into three bytes (``unpack6``).

``quantize_leaf`` gives the JAX package's bytes exactly: the same fp32
``max|x| / qmax``, the same division, half-to-even rounding
(``torch.round`` as ``np.round``), the same clip and packing. It quantizes a
stacked ``(L, in, out)`` leaf one leading slice at a time, so the fp32
temporaries stay at one layer's size and a llama-7b tree quantizes on the
card without a host copy.
"""

from typing import Dict, Tuple

import torch

# block-weight leaves that are matmul operands (quantization targets);
# norms/biases/router stay full precision like the reference skip list
DEFAULT_TARGETS = frozenset(
    {"wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down", "wi"})

#: codes per packing unit (rows of K a unit spans) and bytes a unit takes
PACK_UNIT = {8: (1, 1), 6: (4, 3), 4: (2, 1)}


def _group_size(in_dim: int, requested: int, num_bits: int) -> int:
    """Largest divisor of ``in_dim`` that is <= requested (and compatible with
    the packing unit: 2 codes/byte for int4, 4 codes/3 bytes for int6)."""
    step = PACK_UNIT[num_bits][0]
    if in_dim % step:
        raise ValueError(
            f"int{num_bits} packing needs a contraction dim divisible by "
            f"{step}, got {in_dim}")
    g = min(requested, in_dim)
    while in_dim % g or g % step:
        g -= 1
    return g


def group_of(num_bits: int, packed: int) -> int:
    """The group size of codes whose packed axis is ``packed`` long."""
    codes, nbytes = PACK_UNIT[num_bits]
    return packed // nbytes * codes


def _quantize_slice(w: torch.Tensor, num_bits: int, g: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One (in, out) matrix -> codes (ng, packed, out) int8, scale (ng, 1, out)."""
    in_dim, out = w.shape
    ng = in_dim // g
    x = w.to(torch.float32).reshape(ng, g, out)
    qmax = 2.0 ** (num_bits - 1) - 1
    scale = x.abs().amax(dim=-2, keepdim=True) / qmax
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    codes = torch.round(x / scale).clamp_(-qmax - 1, qmax).to(torch.int8)
    del x
    if num_bits == 4:
        pairs = codes.reshape(ng, g // 2, 2, out)
        lo, hi = pairs[..., 0, :], pairs[..., 1, :]
        codes = (lo & 0x0F) | (hi << 4)
    elif num_bits == 6:
        quads = codes.reshape(ng, g // 4, 4, out).view(torch.uint8)
        c0, c1, c2, c3 = (quads[..., j, :] for j in range(4))
        b0 = (c0 & 0x3F) | ((c1 & 0x03) << 6)
        b1 = ((c1 >> 2) & 0x0F) | ((c2 & 0x0F) << 4)
        b2 = ((c2 >> 4) & 0x03) | ((c3 & 0x3F) << 2)
        codes = torch.stack([b0, b1, b2], dim=-2)  # (ng, g//4, 3, out)
        codes = codes.reshape(ng, (g // 4) * 3, out).view(torch.int8)
    return codes.contiguous(), scale


def quantize_leaf(w: torch.Tensor, num_bits: int = 8, group_size: int = 128
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize (..., in, out) -> (codes int8, scale f32 (..., ng, 1, out)),
    on ``w``'s device, one (in, out) slice at a time."""
    *lead, in_dim, out = w.shape
    g = _group_size(in_dim, group_size, num_bits)
    ng = in_dim // g
    codes_per, nbytes = PACK_UNIT[num_bits]
    packed = g // codes_per * nbytes
    codes = torch.empty((*lead, ng, packed, out), dtype=torch.int8, device=w.device)
    scale = torch.empty((*lead, ng, 1, out), dtype=torch.float32, device=w.device)
    flat_w = w.reshape(-1, in_dim, out)
    flat_c = codes.reshape(-1, ng, packed, out)
    flat_s = scale.reshape(-1, ng, 1, out)
    for i in range(flat_w.shape[0]):
        flat_c[i], flat_s[i] = _quantize_slice(flat_w[i], num_bits, g)
    return codes, scale


def unpack6(u0, u1, u2):
    """Unpack three byte planes (integers 0..255) into four signed 6-bit codes."""
    c0 = u0 & 0x3F
    c1 = ((u0 >> 6) & 0x03) | ((u1 & 0x0F) << 2)
    c2 = ((u1 >> 4) & 0x0F) | ((u2 & 0x03) << 4)
    c3 = (u2 >> 2) & 0x3F
    return tuple((c ^ 32) - 32 for c in (c0, c1, c2, c3))  # sign-extend


def _dequant_leaf(codes, scale, num_bits: int, dtype):
    *lead, ng, gc, out = codes.shape
    if num_bits == 4:
        lo = ((codes << 4) >> 4).to(torch.float32)
        hi = (codes >> 4).to(torch.float32)
        x = torch.stack([lo, hi], dim=-2).reshape(*lead, ng, gc * 2, out)
    elif num_bits == 6:
        q = codes.reshape(*lead, ng, gc // 3, 3, out).to(torch.int32) & 0xFF
        cs = unpack6(q[..., 0, :], q[..., 1, :], q[..., 2, :])
        x = torch.stack(cs, dim=-2).to(torch.float32)
        x = x.reshape(*lead, ng, (gc // 3) * 4, out)
    else:
        x = codes.to(torch.float32)
    w = (x * scale).reshape(*lead, ng * x.shape[-2], out)
    return w.to(dtype)


def dequant_params(d: Dict, dtype) -> Dict:
    """Expand ``<name>::q{4,6,8}`` / ``<name>::scale`` pairs in a param dict
    back to full weights in ``dtype``."""
    if not any("::q" in k for k in d):
        return d
    out = {}
    for k, v in d.items():
        if k.endswith("::scale"):
            continue
        if k.endswith(("::q8", "::q6", "::q4")):
            base, suffix = k.rsplit("::", 1)
            out[base] = _dequant_leaf(v, d[base + "::scale"], int(suffix[1:]), dtype)
        else:
            out[k] = v
    return out


def quantize_param_tree(params: Dict, num_bits: int = 8, group_size: int = 128,
                        targets=DEFAULT_TARGETS) -> Dict:
    """Quantize the matmul weights in a TransformerLM param tree.

    Only ``blocks`` leaves named in ``targets`` (>=2-D, floating) are
    converted; everything else passes through unchanged.
    """
    if num_bits not in (4, 6, 8):
        raise ValueError(f"num_bits must be 4, 6 or 8, got {num_bits}")
    out = dict(params)
    blocks = params.get("blocks")
    if blocks is None:
        raise ValueError("expected a TransformerLM param tree with 'blocks'")
    new_blocks = {}
    for k, v in blocks.items():
        if k in targets and torch.is_tensor(v) and v.dim() >= 2 and v.is_floating_point():
            codes, scale = quantize_leaf(v, num_bits, group_size)
            new_blocks[f"{k}::q{num_bits}"] = codes
            new_blocks[f"{k}::scale"] = scale
        else:
            new_blocks[k] = v
    out["blocks"] = new_blocks
    return out


def quantized_tp_specs(tp_specs: Dict, qparams: Dict) -> Dict:
    """A model's ``tp_specs`` mapped onto a quantized tree (``woq.py:148-172``):
    codes ``(..., ng, g, out)`` keep the weight's spec with its ``in`` entry
    on ``ng`` and an unsharded group dimension; the scales take the same
    spec. A spec is a tuple, one entry a dimension."""
    out = dict(tp_specs)
    blocks = dict(tp_specs.get("blocks", {}))
    new_blocks = {}
    for k in qparams["blocks"]:
        if k.endswith("::scale"):
            continue
        if "::q" in k:
            base = k.rsplit("::", 1)[0]
            entries = list(blocks.get(base) or ())
            qspec = (*entries[:-1], None, entries[-1]) if len(entries) >= 2 else ()
            new_blocks[k] = qspec
            new_blocks[base + "::scale"] = qspec
        else:
            new_blocks[k] = blocks.get(k, ())
    out["blocks"] = new_blocks
    return out
