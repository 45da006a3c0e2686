"""CUDA accelerator: the port's production backend (an NVIDIA Hopper card)."""

import torch

from .abstract_accelerator import DeepSpeedAccelerator


class CUDA_Accelerator(DeepSpeedAccelerator):
    _name = "cuda"
    _communication_backend_name = "nccl"

    def is_available(self) -> bool:
        return torch.cuda.is_available()

    def device_count(self) -> int:
        return torch.cuda.device_count()

    def synchronize(self, device_index=None) -> None:
        torch.cuda.synchronize(device_index)
