"""TP checkpoint sets: save at degree N, merge at load, serve at degree M (counterpart of ``deepspeed_tpu/runtime/state_dict_factory.py``).

A set is one ``mp_rank_XX_model_states.ckpt`` file a rank of degree N,
written through the port's native checkpoint engine in the JAX package's
format: each holds ``tp_degree``, ``shards`` (leaf key -> array) and
``axes`` (leaf key -> the dimension it was split on, -1 for a leaf stored
whole in rank 0's file). A leaf whose spec names the ``model`` axis is split
along that dimension into N pieces; the others live once, in rank 0's file.
The keys are ``jax.tree_util.keystr`` of the leaf's path (``['blocks']['wq']``),
so a set written by either package loads in the other, leaves bit for bit.
``load_mp_merged`` reassembles the global tree; serving it at any degree M
is ``init_inference(..., tensor_parallel={"tp_size": M})``, which cuts each
rank's shards from it.
"""

import os
import re
from typing import Dict, Optional

import numpy as np
import torch

from ..utils.logging import logger
from .checkpoint_engine.native_checkpoint_engine import NativeCheckpointEngine
from .tensor_parallel import spec_at, spec_dim

_FILE_RE = re.compile(r"mp_rank_(\d+)_model_states\.ckpt$")


def _rank_path(d: str, rank: int) -> str:
    return os.path.join(d, f"mp_rank_{rank:02d}_model_states.ckpt")


def _keyed(tree, path=()):
    """(keystr, path, leaf) for every leaf, in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _keyed(tree[k], path + (k,))
    else:
        yield "".join(f"[{k!r}]" for k in path), path, tree


def _host(a):
    """A leaf as a host array: numpy, or a CPU tensor for bfloat16 (which
    the checkpoint engine writes as its uint16 bits)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu()
        return t.contiguous() if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(a)


def _split(a, n: int, dim: int):
    if isinstance(a, torch.Tensor):
        return [p.contiguous() for p in torch.chunk(a, n, dim=dim)]
    return [np.ascontiguousarray(p) for p in np.split(a, n, axis=dim)]


def _concat(parts, dim: int):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat([torch.as_tensor(p) for p in parts], dim=dim)
    return np.concatenate(parts, axis=dim)


def save_mp_sharded(params: Dict, tp_specs: Optional[Dict], mp_degree: int, save_dir: str,
                    engine=None) -> None:
    """Write an ``mp_rank_XX_model_states.ckpt`` set at TP degree
    ``mp_degree`` from the whole tree ``params`` (tensors or numpy arrays)."""
    engine = engine or NativeCheckpointEngine()
    os.makedirs(save_dir, exist_ok=True)
    per_rank = [{"tp_degree": mp_degree, "shards": {}, "axes": {}} for _ in range(mp_degree)]
    for key, path, leaf in _keyed(params):
        arr = _host(leaf)
        dim = spec_dim(spec_at(tp_specs, path)) if tp_specs is not None else None
        if dim is not None and arr.ndim > dim and arr.shape[dim] % mp_degree == 0:
            for r, piece in enumerate(_split(arr, mp_degree, dim)):
                per_rank[r]["shards"][key] = piece
                per_rank[r]["axes"][key] = dim
        else:
            per_rank[0]["shards"][key] = arr
            per_rank[0]["axes"][key] = -1
    for r in range(mp_degree):
        engine.save(per_rank[r], _rank_path(save_dir, r))
    logger.info(f"saved mp-sharded checkpoint set (degree {mp_degree}) to {save_dir}")


def detect_mp_degree(load_dir: str) -> int:
    ranks = sorted(int(m.group(1)) for f in os.listdir(load_dir) if (m := _FILE_RE.search(f)))
    if not ranks or ranks != list(range(len(ranks))):
        raise FileNotFoundError(
            f"no contiguous mp_rank_XX_model_states.ckpt set in {load_dir} "
            f"(found ranks {ranks})")
    return len(ranks)


def _as_template(arr, leaf):
    """``arr`` in the kind and dtype of the template's ``leaf``: a tensor
    for a tensor, a numpy array for anything else."""
    if isinstance(leaf, torch.Tensor):
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.array(arr))
        return t.to(leaf.dtype)
    if isinstance(arr, torch.Tensor):
        arr = arr.float().numpy()
    return arr.astype(np.asarray(leaf).dtype) if hasattr(leaf, "dtype") else arr


def load_mp_merged(load_dir: str, params_template: Dict, engine=None) -> Dict:
    """Read an N-rank set and reassemble the whole tree in the structure of
    ``params_template``; a leaf whose shape differs from the template's
    raises ``ValueError`` (a set of another model configuration)."""
    engine = engine or NativeCheckpointEngine()
    n = detect_mp_degree(load_dir)
    rank_sds = [engine.load(_rank_path(load_dir, r)) for r in range(n)]
    merged = {}
    for key, axis in rank_sds[0]["axes"].items():
        if int(axis) < 0:
            merged[key] = rank_sds[0]["shards"][key]
    for key in {k for sd in rank_sds for k in sd["axes"] if int(sd["axes"][k]) >= 0}:
        axis = next(int(sd["axes"][key]) for sd in rank_sds if key in sd["axes"])
        merged[key] = _concat([sd["shards"][key] for sd in rank_sds], axis)

    def build(tree, path=()):
        if isinstance(tree, dict):
            return {k: build(tree[k], path + (k,)) for k in tree}
        key = "".join(f"[{k!r}]" for k in path)
        if key not in merged:
            raise KeyError(f"checkpoint set missing leaf {key}")
        arr = merged[key]
        if tuple(arr.shape) != tuple(tree.shape):
            raise ValueError(f"leaf {key}: checkpoint shape {tuple(arr.shape)} != model "
                             f"{tuple(tree.shape)} — wrong model config for this set?")
        return _as_template(arr, tree)

    return build(params_template)


def reshard_mp_checkpoint(load_dir: str, save_dir: str, params_template: Dict,
                          tp_specs: Optional[Dict], new_degree: int, engine=None) -> None:
    """Offline N -> M resharding of a set: merged whole, split again at
    ``new_degree``."""
    merged = load_mp_merged(load_dir, params_template, engine=engine)
    save_mp_sharded(merged, tp_specs, new_degree, save_dir, engine=engine)
