from .abstract_accelerator import DeepSpeedAccelerator  # noqa: F401
from .real_accelerator import get_accelerator, resolve_device  # noqa: F401
