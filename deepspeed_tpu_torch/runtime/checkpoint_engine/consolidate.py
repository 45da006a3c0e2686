"""Sharded-checkpoint consolidation (a copy of ``deepspeed_tpu/runtime/checkpoint_engine/consolidate.py``).

A stage>=2 checkpoint of the JAX package stores optimizer moments as one
file per rank (``optim_states.shard<r>.ckpt``), each written with the same
manifest-last protocol as every other checkpoint file, next to a small
``optim_states.ckpt`` that carries only the partition plan + step + scaler.
Consolidation is the exact inverse of the save-time slicing: concatenate
each leaf's per-rank flat slices in rank order and reshape to the recorded
leaf shape, bytewise lossless. The port's engine writes the same files at
stage >= 2 and reads either package's.

Every failure raises :class:`CheckpointCorruptError` so the engine's
durable-tag ring treats a torn shard exactly like any other corrupt file:
fall back to the previous complete tag instead of half-restoring.
"""

import os
from typing import Dict

import numpy as np

from ...analysis.sanitizer import check_shard_conservation, sanitize_enabled
from ...resilience.errors import CheckpointCorruptError
from ...utils.tree import tree_leaves, tree_unflatten


def shard_path(tag_dir: str, rank: int) -> str:
    return os.path.join(tag_dir, f"optim_states.shard{rank:02d}.ckpt")


def consolidate_sharded_optim(ckpt_engine, tag_dir: str, meta_sd: Dict) -> Dict:
    """Load + verify every shard file of ``tag_dir`` and rebuild full-leaf
    moments. Returns ``{"step", "scaler", "m", "v", "leaf_shapes",
    "_consolidated": True}`` with ``m``/``v`` as lists of full per-leaf fp32
    arrays in the plan's recorded shapes."""
    info = meta_sd.get("zero_sharded")
    if not isinstance(info, dict):
        raise CheckpointCorruptError(
            f"sharded optimizer metadata missing/garbled in {tag_dir}")
    try:
        num_shards = int(info["num_shards"])
        leaf_sizes = [int(s) for s in info["leaf_sizes"]]
        leaf_shapes = [tuple(int(d) for d in s) for s in info["leaf_shapes"]]
        bounds = [tuple(int(b) for b in bs) for bs in info["bounds"]]
    except (KeyError, TypeError, ValueError) as e:
        raise CheckpointCorruptError(
            f"sharded optimizer plan unreadable in {tag_dir}: {e}") from e

    shards = []
    for r in range(num_shards):
        path = shard_path(tag_dir, r)
        if not os.path.exists(path):
            raise CheckpointCorruptError(
                f"optimizer shard {r}/{num_shards} missing at {path}")
        sd = ckpt_engine.load(path)  # raises CheckpointCorruptError on torn file
        if int(sd.get("rank", -1)) != r or \
                int(sd.get("num_shards", -1)) != num_shards:
            raise CheckpointCorruptError(
                f"optimizer shard file {path} identifies as rank "
                f"{sd.get('rank')}/{sd.get('num_shards')}, expected "
                f"{r}/{num_shards}")
        shards.append(sd)

    if sanitize_enabled():
        for kind in ("m", "v"):
            check_shard_conservation(
                leaf_sizes, bounds, [s[kind] for s in shards],
                dtype=np.float32)

    m_full, v_full = [], []
    for j in range(len(leaf_sizes)):
        for kind, out in (("m", m_full), ("v", v_full)):
            parts = [np.asarray(s[kind][j], np.float32).reshape(-1)
                     for s in shards]
            full = parts[0] if num_shards == 1 else np.concatenate(parts)
            if int(full.size) != leaf_sizes[j]:
                raise CheckpointCorruptError(
                    f"consolidated leaf {j} ({kind}) has {int(full.size)} "
                    f"elements, plan says {leaf_sizes[j]}")
            out.append(full.reshape(leaf_shapes[j]))
    return {
        "step": int(meta_sd.get("step", 0)),
        "scaler": meta_sd.get("scaler"),
        "m": m_full,
        "v": v_full,
        "leaf_shapes": leaf_shapes,
        "_consolidated": True,
    }


def consolidated_as_trees(cons: Dict, template) -> Dict:
    """``consolidate_sharded_optim``'s result as an unsharded optimizer file
    holds it: ``{"step", "scaler", "m", "v"}`` with the moments as trees of
    ``template``'s structure (the plan's leaves are ``template``'s leaves in
    sorted-key order, the JAX tree's order)."""
    shapes = [tuple(np.shape(leaf)) for leaf in tree_leaves(template)]
    if len(cons["m"]) != len(shapes):
        raise ValueError(f"sharded checkpoint holds {len(cons['m'])} moment leaves, the "
                         f"parameter tree {len(shapes)}")
    return {"step": cons["step"], "scaler": cons.get("scaler"),
            **{k: tree_unflatten(template, [np.asarray(a, np.float32).reshape(s)
                                            for a, s in zip(cons[k], shapes)])
               for k in ("m", "v")}}
