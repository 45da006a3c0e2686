"""ZeRO config block (a copy of ``deepspeed_tpu/runtime/zero/config.py``).

The port parses the whole block; its training engine runs stages 0-3, with
``offload_optimizer`` or ``offload_param``, and the ZeRO++ knobs across
ranks. Schema parity with reference ``deepspeed/runtime/zero/config.py`` (stage enum :73,
ZeRO++ knobs :264-280, offload configs in ``offload_config.py``). On TPU several CUDA
mechanism knobs (bucket sizes, overlap_comm, stream counts) do not change the compiled
program — XLA schedules collectives — so they are accepted, recorded, and surfaced via
``mechanism_noop_keys`` for observability rather than silently dropped.
"""

import dataclasses
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional

from ..config_utils import DeepSpeedConfigModel


class ZeroStageEnum(int, Enum):
    disabled = 0
    optimizer_states = 1
    gradients = 2
    weights = 3
    max_stage = 3


class OffloadDeviceEnum(str, Enum):
    none = "none"
    cpu = "cpu"
    nvme = "nvme"


@dataclass
class DeepSpeedZeroOffloadParamConfig(DeepSpeedConfigModel):
    """``zero_optimization.offload_param`` (reference ``offload_config.py``)."""

    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 5
    buffer_size: int = 100_000_000
    max_in_cpu: int = 1_000_000_000
    pin_memory: bool = False

    def _validate(self):
        OffloadDeviceEnum(self.device)


@dataclass
class DeepSpeedZeroOffloadOptimizerConfig(DeepSpeedConfigModel):
    """``zero_optimization.offload_optimizer`` incl. Offload++ partial ``ratio``."""

    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 4
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False
    ratio: float = 1.0

    def _validate(self):
        OffloadDeviceEnum(self.device)
        if not 0.0 <= self.ratio <= 1.0:
            raise ValueError(f"offload_optimizer.ratio must be in [0,1], got {self.ratio}")

    @property
    def pipeline(self):
        return self.pipeline_read or self.pipeline_write


@dataclass
class DeepSpeedZeroConfig(DeepSpeedConfigModel):
    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = 500_000_000
    use_multi_rank_bucket_allreduce: bool = True
    allgather_partitions: bool = True
    allgather_bucket_size: int = 500_000_000
    overlap_comm: Optional[bool] = None
    load_from_fp32_weights: bool = True
    elastic_checkpoint: bool = False

    # offload
    offload_param: Optional[DeepSpeedZeroOffloadParamConfig] = field(
        default=None, metadata={"submodel": DeepSpeedZeroOffloadParamConfig}
    )
    offload_optimizer: Optional[DeepSpeedZeroOffloadOptimizerConfig] = field(
        default=None, metadata={"submodel": DeepSpeedZeroOffloadOptimizerConfig}
    )

    # stage-3 knobs
    sub_group_size: int = 1_000_000_000
    cpu_offload_param: Optional[bool] = field(
        default=None, metadata={"deprecated": True, "new_param": "offload_param"}
    )
    cpu_offload_use_pin_memory: Optional[bool] = field(
        default=None, metadata={"deprecated": True, "new_param": "offload_param/offload_optimizer"}
    )
    cpu_offload: Optional[bool] = field(
        default=None, metadata={"deprecated": True, "new_param": "offload_optimizer"}
    )
    prefetch_bucket_size: int = field(default=50_000_000, metadata={"aliases": ("stage3_prefetch_bucket_size",)})
    param_persistence_threshold: int = field(
        default=100_000, metadata={"aliases": ("stage3_param_persistence_threshold",)}
    )
    model_persistence_threshold: int = field(
        default=2**63 - 1, metadata={"aliases": ("stage3_model_persistence_threshold",)}
    )
    max_live_parameters: int = field(default=1_000_000_000, metadata={"aliases": ("stage3_max_live_parameters",)})
    max_reuse_distance: int = field(default=1_000_000_000, metadata={"aliases": ("stage3_max_reuse_distance",)})
    gather_16bit_weights_on_model_save: bool = field(
        default=False, metadata={"aliases": ("stage3_gather_16bit_weights_on_model_save", "stage3_gather_fp16_weights_on_model_save")}
    )

    ignore_unused_parameters: bool = True
    legacy_stage1: bool = False
    round_robin_gradients: bool = False

    #: unified TransferEngine overlap (docs/TRANSFER.md): True = offload
    #: gradient D2H rides async tickets settled at the dispatch boundary;
    #: False = the synchronous bitwise twin (A/B arm for benches/tests)
    transfer_overlap: bool = True

    # ZeRO++ knobs
    zero_hpz_partition_size: int = 1
    zero_quantized_weights: bool = False
    zero_quantized_nontrainable_weights: bool = False
    zero_quantized_gradients: bool = False

    mics_shard_size: int = -1
    mics_hierarchical_params_gather: bool = False

    memory_efficient_linear: bool = True
    pipeline_loading_checkpoint: bool = False
    override_module_apply: bool = True

    def _validate(self):
        if not 0 <= int(self.stage) <= ZeroStageEnum.max_stage:
            raise ValueError(f"zero_optimization.stage must be 0-3, got {self.stage}")
        if self.zero_hpz_partition_size < 1:
            raise ValueError("zero_hpz_partition_size must be >= 1")

    # Knobs that tune CUDA stream/bucket mechanics the XLA compiler owns on TPU.
    mechanism_noop_keys = (
        "reduce_bucket_size",
        "allgather_bucket_size",
        "overlap_comm",
        "contiguous_gradients",
        "prefetch_bucket_size",
        "max_live_parameters",
        "max_reuse_distance",
        "use_multi_rank_bucket_allreduce",
        "round_robin_gradients",
    )


# stage-3 tuning knobs (canonical spelling -> accepted alias spellings): they
# only drive the stage-3 parameter-residency machinery, so supplying them at
# stage < 3 means the user believes they are tuning something that is inert
_STAGE3_KNOBS = {
    "prefetch_bucket_size": ("stage3_prefetch_bucket_size",),
    "param_persistence_threshold": ("stage3_param_persistence_threshold",),
    "model_persistence_threshold": ("stage3_model_persistence_threshold",),
    "max_live_parameters": ("stage3_max_live_parameters",),
    "max_reuse_distance": ("stage3_max_reuse_distance",),
    "gather_16bit_weights_on_model_save": (
        "stage3_gather_16bit_weights_on_model_save",
        "stage3_gather_fp16_weights_on_model_save",
    ),
}


def zero_config_from_dict(d) -> DeepSpeedZeroConfig:
    cfg = DeepSpeedZeroConfig.from_dict(d or {})
    # stage-3 knobs at stage < 3 were silently accepted — say so explicitly
    # (the values ARE recorded on the config; they just drive nothing)
    if cfg.stage < 3 and d:
        stray = [k for canonical, aliases in _STAGE3_KNOBS.items()
                 for k in (canonical, *aliases) if k in d]
        if stray:
            from ...utils.logging import logger

            logger.warning(
                f"zero_optimization: stage-3 knob(s) {stray} supplied at "
                f"stage={cfg.stage} — they only affect the stage-3 parameter "
                "residency window and are inert at this stage")
    # normalize legacy cpu_offload flags into offload_optimizer
    if cfg.cpu_offload and cfg.offload_optimizer is None:
        cfg.offload_optimizer = DeepSpeedZeroOffloadOptimizerConfig(device="cpu")
    if cfg.cpu_offload_param and cfg.offload_param is None:
        cfg.offload_param = DeepSpeedZeroOffloadParamConfig(device="cpu")
    return cfg
