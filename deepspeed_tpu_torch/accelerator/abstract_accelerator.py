"""Accelerator abstraction (counterpart of ``deepspeed_tpu/accelerator/abstract_accelerator.py``).

One seam through which the port asks for its device, memory, dtype support,
random generator and communication backend.
"""

import abc

import torch


class DeepSpeedAccelerator(abc.ABC):
    _name: str = ""
    _communication_backend_name: str = ""

    @property
    def name(self) -> str:
        return self._name

    def communication_backend_name(self) -> str:
        return self._communication_backend_name

    @abc.abstractmethod
    def is_available(self) -> bool:
        ...

    @abc.abstractmethod
    def device_count(self) -> int:
        ...

    def device_name(self, device_index=None) -> str:
        if device_index is None:
            return self._name
        return f"{self._name}:{device_index}"

    def device(self, device_index: int = 0) -> torch.device:
        if not self.is_available():
            raise RuntimeError(f"accelerator '{self._name}' is not available")
        return torch.device(self.device_name(device_index))

    def synchronize(self, device_index=None) -> None:
        ...
