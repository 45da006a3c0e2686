"""Universal (topology-independent) checkpoints (counterpart of ``deepspeed_tpu/checkpoint/universal.py``).

Checkpoints of either package already hold every parameter as one full
array, so ``ds_to_universal`` only writes one directory a parameter
(``zero/<name>/fp32.npy``, plus ``exp_avg.npy`` and ``exp_avg_sq.npy``
where the checkpoint holds Adam's moments, a sharded JAX stage>=2 save
consolidated first) and ``universal_meta.pkl``, and
``load_universal_into_engine`` reads them back into an engine, reshaping a
leaf whose stacking differs. The files are the JAX package's layout, and
the metadata pickle holds plain Python and numpy values only, so either
package reads the other's output.
"""

import os
import pickle
from typing import Optional

import numpy as np
import torch

from ..runtime.checkpoint_engine.consolidate import (consolidate_sharded_optim,
                                                     consolidated_as_trees)
from ..runtime.checkpoint_engine.native_checkpoint_engine import NativeCheckpointEngine
from ..utils.logging import log_dist, logger
from ..utils.tree import tree_unflatten

UNIVERSAL_DIRNAME = "zero"  # parity with reference layout


def _f32(leaf) -> np.ndarray:
    """A checkpoint leaf (numpy, or a CPU tensor for a dtype numpy lacks) in fp32."""
    if isinstance(leaf, torch.Tensor):
        return leaf.float().numpy()
    return np.asarray(leaf, np.float32)


def _leaf_items(tree, prefix=""):
    """(name, leaf) in the JAX tree's order (sorted dict keys), names the
    keys joined by "/"."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_items(tree[k], f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def ds_to_universal(checkpoint_dir: str, output_dir: str, tag: Optional[str] = None):
    """Convert an engine checkpoint into the universal per-parameter layout
    (reference ``ds_to_universal.py:314 main``)."""
    eng = NativeCheckpointEngine()
    if tag is None:
        with open(os.path.join(checkpoint_dir, "latest")) as f:
            tag = f.read().strip()
    src = os.path.join(checkpoint_dir, str(tag))
    model_sd = eng.load(os.path.join(src, "model_states.ckpt"))
    optim_sd = None
    opt_path = os.path.join(src, "optim_states.ckpt")
    if os.path.exists(opt_path):
        optim_sd = eng.load(opt_path)

    if optim_sd is not None and "zero_sharded" in optim_sd:
        # stage>=2 sharded save: the per-rank moment files consolidated into
        # full leaves on the module's tree, so the per-parameter writer below
        # names them like any other checkpoint's
        optim_sd = consolidated_as_trees(consolidate_sharded_optim(eng, src, optim_sd),
                                         model_sd["module"])

    zdir = os.path.join(output_dir, UNIVERSAL_DIRNAME)
    os.makedirs(zdir, exist_ok=True)
    index = {}
    for name, leaf in _leaf_items(model_sd["module"]):
        pdir = os.path.join(zdir, name.replace("/", "."))
        os.makedirs(pdir, exist_ok=True)
        np.save(os.path.join(pdir, "fp32.npy"), _f32(leaf))
        index[name] = {"shape": list(np.shape(leaf))}
    if optim_sd is not None and "offload_host" in optim_sd:
        logger.warning(
            "ds_to_universal: checkpoint was saved with optimizer offload — "
            "offloaded Adam moments are not converted; elastic reload will "
            "reinitialize them"
        )
    if optim_sd is not None and optim_sd.get("m") is not None:
        for kind, tree in (("exp_avg", optim_sd["m"]), ("exp_avg_sq", optim_sd["v"])):
            for name, leaf in _leaf_items(tree):
                pdir = os.path.join(zdir, name.replace("/", "."))
                os.makedirs(pdir, exist_ok=True)
                np.save(os.path.join(pdir, f"{kind}.npy"), _f32(leaf))
    meta = {
        "index": index,
        "step": int(model_sd.get("global_steps", 0)),
        "global_samples": int(model_sd.get("global_samples", 0)),
        "optimizer_step": None if optim_sd is None or optim_sd.get("step") is None
        else int(np.asarray(optim_sd["step"])),
        "ds_config_batch": model_sd.get("ds_config_batch"),
        "lr_scheduler": model_sd.get("lr_scheduler"),
        "scaler": None if optim_sd is None else optim_sd.get("scaler"),
    }
    with open(os.path.join(output_dir, "universal_meta.pkl"), "wb") as f:
        pickle.dump(meta, f)
    with open(os.path.join(output_dir, "latest_universal"), "w") as f:
        f.write(UNIVERSAL_DIRNAME)
    log_dist(f"universal checkpoint written to {output_dir} ({len(index)} params)",
             ranks=[0])
    return output_dir


def load_universal_into_engine(engine, universal_dir: str):
    """Elastic reload into the port's engine (reference
    ``load_universal_checkpoint`` engine flag, ``engine.py:822``): the lp
    parameters written in place, the master copy and the moments rebound."""
    with open(os.path.join(universal_dir, "universal_meta.pkl"), "rb") as f:
        meta = pickle.load(f)
    zdir = os.path.join(universal_dir, UNIVERSAL_DIRNAME)

    host_w, host_m, host_v = [], [], []
    have_moments = True
    for name, tmpl in _leaf_items(engine.params):
        pdir = os.path.join(zdir, name.replace("/", "."))
        tmpl_shape = tuple(tmpl.shape)

        def fit(w, name=name, tmpl_shape=tmpl_shape):
            # same values, different stacking: only the leading dims split
            if tuple(w.shape) != tmpl_shape:
                if w.size != int(np.prod(tmpl_shape)):
                    raise ValueError(
                        f"universal leaf {name}: stored shape {w.shape} has "
                        f"{w.size} elements but the engine expects "
                        f"{tmpl_shape}")
                w = w.reshape(tmpl_shape)
            return torch.from_numpy(np.ascontiguousarray(w, np.float32))

        host_w.append(fit(np.load(os.path.join(pdir, "fp32.npy"))))
        m_path = os.path.join(pdir, "exp_avg.npy")
        if os.path.exists(m_path):
            host_m.append(fit(np.load(m_path)))
            host_v.append(fit(np.load(os.path.join(pdir, "exp_avg_sq.npy"))))
        else:
            have_moments = False

    opt_step = meta.get("optimizer_step")
    if opt_step is None:  # may legitimately be 0 — no falsy-or
        opt_step = meta["step"]
    engine._restore_params(tree_unflatten(engine.params, host_w))
    if engine.opt_state is not None and have_moments:
        engine.opt_state = type(engine.opt_state)(
            step=torch.tensor(int(opt_step), dtype=torch.int32, device=engine.device),
            m=engine._to_device(tree_unflatten(engine.params, host_m)),
            v=engine._to_device(tree_unflatten(engine.params, host_v)))
    engine.global_steps = meta["step"]
    engine.global_samples = meta.get("global_samples", 0)
    sc = meta.get("scaler")
    if sc is not None:
        engine._restore_scaler(sc)
    if meta.get("lr_scheduler") and engine.lr_scheduler is not None:
        engine.lr_scheduler.load_state_dict(meta["lr_scheduler"])
    log_dist(f"universal checkpoint loaded from {universal_dir} "
             f"(step {meta['step']}, device {engine.device})", ranks=[0])
