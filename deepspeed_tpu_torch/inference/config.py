"""Inference config (a copy of ``deepspeed_tpu/inference/config.py``; reference ``deepspeed/inference/config.py``:
``DeepSpeedInferenceConfig``, 304 LoC pydantic model)."""

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ..runtime.config_utils import DeepSpeedConfigModel


@dataclass
class DeepSpeedTPConfig(DeepSpeedConfigModel):
    """reference ``inference/config.py DeepSpeedTPConfig``"""

    enabled: bool = True
    tp_size: int = 1
    mpu: Any = None
    tp_group: Any = None


@dataclass
class DeepSpeedInferenceConfig(DeepSpeedConfigModel):
    """Validated inference options (reference surface; CUDA-specific knobs are
    accepted and ignored so reference configs load unchanged)."""

    dtype: str = "bf16"  # "fp32" | "fp16" | "bf16"
    tensor_parallel: Dict[str, Any] = field(default_factory=dict)
    max_out_tokens: int = 1024
    min_out_tokens: int = 1
    max_tokens: Optional[int] = None
    # decode sampling defaults
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    # accepted for parity (kernel injection, CUDA graphs, Triton: no-ops here)
    replace_with_kernel_inject: bool = False
    enable_cuda_graph: bool = False
    use_triton: bool = False
    triton_autotune: bool = False
    checkpoint: Optional[Any] = None
    base_dir: str = ""
    set_empty_params: bool = False
    save_mp_checkpoint_path: Optional[str] = None
    injection_policy: Optional[Any] = None
    injection_policy_tuple: Optional[Any] = None
    keep_module_on_host: bool = False
    quant: Dict[str, Any] = field(default_factory=dict)
    moe: Dict[str, Any] = field(default_factory=dict)
    replace_method: str = "auto"

    @property
    def tp_size(self) -> int:
        return int(self.tensor_parallel.get("tp_size", 1)) if isinstance(
            self.tensor_parallel, dict) else getattr(self.tensor_parallel, "tp_size", 1)
