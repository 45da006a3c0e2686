"""CPU accelerator: the test seam. Returned only when asked for by name
(``get_accelerator("cpu")``); the tests run the port's plain versions on it."""

from .abstract_accelerator import DeepSpeedAccelerator


class CPU_Accelerator(DeepSpeedAccelerator):
    _name = "cpu"
    _communication_backend_name = "gloo"

    def is_available(self) -> bool:
        return True

    def device_count(self) -> int:
        return 1

    def device_name(self, device_index=None) -> str:
        return "cpu"
