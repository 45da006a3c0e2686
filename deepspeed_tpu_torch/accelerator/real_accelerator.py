"""Accelerator selection (counterpart of ``deepspeed_tpu/accelerator/real_accelerator.py``).

The port runs on the card: ``get_accelerator()`` returns CUDA, and the CPU
accelerator comes back only when asked for by name. Nothing falls back to the
CPU on its own. ``resolve_device`` is the check every entry point runs on its
``device`` argument.
"""

from typing import Optional, Union

import torch

from .abstract_accelerator import DeepSpeedAccelerator

SUPPORTED_ACCELERATOR_LIST = ["cuda", "cpu"]


def get_accelerator(name: Optional[str] = None) -> DeepSpeedAccelerator:
    name = name or "cuda"
    if name == "cuda":
        from .cuda_accelerator import CUDA_Accelerator

        return CUDA_Accelerator()
    if name == "cpu":
        from .cpu_accelerator import CPU_Accelerator

        return CPU_Accelerator()
    raise ValueError(
        f"accelerator name '{name}' not in supported list {SUPPORTED_ACCELERATOR_LIST}")


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device an entry point runs on. A CUDA device without CUDA raises:
    the caller asks for the CPU explicitly (``device="cpu"``) or not at all."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; deepspeed_tpu_torch runs on the card and "
            "does not fall back to the CPU (pass device='cpu' to run the plain "
            "PyTorch versions on the CPU)")
    if dev.type not in SUPPORTED_ACCELERATOR_LIST:
        raise ValueError(f"unsupported device '{dev}' (supported: cuda, cpu)")
    return dev
