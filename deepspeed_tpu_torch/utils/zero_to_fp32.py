"""Offline checkpoint -> consolidated fp32 state dict (counterpart of ``deepspeed_tpu/utils/zero_to_fp32.py``).

Reference: ``deepspeed/utils/zero_to_fp32.py`` (``:474
get_fp32_state_dict_from_zero_checkpoint``, ``:524
convert_zero_checkpoint_to_fp32_state_dict``). Checkpoints of either
package store full arrays, so "consolidation" is a load + flatten; the CLI
surface is kept (``python -m deepspeed_tpu_torch.utils.zero_to_fp32
ckpt_dir out.npz``).
"""

import argparse
import os
from typing import Dict

import numpy as np
import torch


def _f32(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.float().numpy()
    return np.asarray(leaf, np.float32)


def get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir: str, tag=None) -> Dict[str, np.ndarray]:
    """reference ``:474`` — returns {param_name: fp32 ndarray}, names the
    module's keys joined by "."."""
    from ..runtime.checkpoint_engine.native_checkpoint_engine import NativeCheckpointEngine

    if tag is None:
        with open(os.path.join(checkpoint_dir, "latest")) as f:
            tag = f.read().strip()
    sd = NativeCheckpointEngine().load(
        os.path.join(checkpoint_dir, str(tag), "model_states.ckpt"))
    out = {}

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}.{k}" if prefix else str(k))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}.{i}")
        elif hasattr(tree, "shape"):
            out[prefix] = _f32(tree)

    walk(sd["module"])
    return out


def convert_zero_checkpoint_to_fp32_state_dict(checkpoint_dir: str, output_file: str,
                                               tag=None):
    """reference ``:524`` — writes a single consolidated .npz."""
    sd = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag)
    np.savez(output_file, **sd)
    print(f"saved {len(sd)} fp32 tensors to {output_file}")
    return output_file


def load_state_dict_from_zero_checkpoint(model_params, checkpoint_dir: str, tag=None):
    """reference ``load_state_dict_from_zero_checkpoint``: a tree shaped like
    ``model_params`` (nested dicts) whose leaves are the checkpoint's fp32
    values as CPU tensors, matched by flattened name."""
    sd = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag)

    def build(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: build(v, f"{prefix}.{k}" if prefix else str(k))
                    for k, v in tree.items()}
        if prefix not in sd:
            raise KeyError(f"checkpoint missing parameter '{prefix}'")
        return torch.from_numpy(sd[prefix])

    return build(model_params)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("checkpoint_dir")
    p.add_argument("output_file")
    p.add_argument("-t", "--tag", default=None)
    a = p.parse_args()
    convert_zero_checkpoint_to_fp32_state_dict(a.checkpoint_dir, a.output_file, a.tag)


if __name__ == "__main__":
    main()
