"""Top-level config (counterpart of ``deepspeed_tpu/runtime/config.py``).

A copy of the JAX package's host-only ``DeepSpeedConfig`` (``config.py:163``):
the same JSON keys, the same blocks, the same batch-size triangle, resolved
at the world size of the process group (``train_batch_size = micro x GAS x
dp``). ZeRO stages 0-3 are accepted, with ``offload_optimizer`` to ``cpu``
or ``nvme`` (and ``ratio``), ``offload_param`` to ``cpu`` or ``nvme`` at
stage 3 (``initialize`` then builds the layer-streamed
``StreamedZeroEngine``), the ZeRO++ knobs (``zero_quantized_weights``,
``zero_quantized_gradients``, ``zero_hpz_partition_size``) and the 1-bit
optimizers. The ``mesh`` block takes ``data``, ``hpz`` and ``model`` (tensor
parallelism: the batch splits over the data degree, ``world / (model x pipe
x seq)``, alone); a ``seq``, ``pipe`` or ``expert`` axis larger than 1
raises ``NotImplementedError`` naming its ROADMAP.md item, and so does the
``pipeline`` block.
"""

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ..comm.topology import check_ported_axes
from ..utils.logging import logger
from . import constants as C
from .config_utils import DeepSpeedConfigModel, dict_raise_error_on_duplicate_keys
from .zero.config import zero_config_from_dict

PIPE_ITEM = "ROADMAP.md Queue 1 item 17, runtime/pipe"

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
FUSED_ADAM_OPTIMIZER = "fusedadam"
LAMB_OPTIMIZER = "lamb"
LION_OPTIMIZER = "lion"
SGD_OPTIMIZER = "sgd"
ADAGRAD_OPTIMIZER = "adagrad"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
ZERO_ONE_ADAM_OPTIMIZER = "zerooneadam"
ONEBIT_LAMB_OPTIMIZER = "onebitlamb"
MUADAM_OPTIMIZER = "muadam"
MUADAMW_OPTIMIZER = "muadamw"
MUSGD_OPTIMIZER = "musgd"
ONEBIT_OPTIMIZERS = (ONEBIT_ADAM_OPTIMIZER, ZERO_ONE_ADAM_OPTIMIZER, ONEBIT_LAMB_OPTIMIZER)
DEEPSPEED_OPTIMIZERS = [
    ADAM_OPTIMIZER, ADAMW_OPTIMIZER, FUSED_ADAM_OPTIMIZER, LAMB_OPTIMIZER, LION_OPTIMIZER,
    SGD_OPTIMIZER, ADAGRAD_OPTIMIZER, ONEBIT_ADAM_OPTIMIZER, ZERO_ONE_ADAM_OPTIMIZER,
    ONEBIT_LAMB_OPTIMIZER, MUADAM_OPTIMIZER, MUADAMW_OPTIMIZER, MUSGD_OPTIMIZER,
]


@dataclass
class MeshConfig(DeepSpeedConfigModel):
    """The ``mesh`` block: axis sizes over the ranks (``config.py:62``);
    ``data`` 0 fills with the ranks left over."""

    data: int = 0
    model: int = 1
    pipe: int = 1
    seq: int = 1
    expert: int = 1
    hpz: int = 1  # ZeRO++ hpZ secondary partition, carved out of data

    def _validate(self):
        for name in ("model", "pipe", "seq", "expert", "hpz"):
            if getattr(self, name) < 1:
                raise ValueError(f"mesh.{name} must be >= 1")


@dataclass
class FP16Config(DeepSpeedConfigModel):
    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0
    fp16_master_weights_and_grads: bool = False

    @property
    def dynamic_loss_scale(self) -> bool:
        return self.loss_scale == 0


@dataclass
class BF16Config(DeepSpeedConfigModel):
    enabled: bool = False
    immediate_grad_update: bool = False


@dataclass
class ActivationCheckpointingConfig(DeepSpeedConfigModel):
    partition_activations: bool = False
    contiguous_memory_optimization: bool = False
    cpu_checkpointing: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False


@dataclass
class CommsLoggerConfig(DeepSpeedConfigModel):
    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    debug: bool = False
    prof_ops: list = field(default_factory=list)


@dataclass
class MonitorSinkConfig(DeepSpeedConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"
    team: Optional[str] = None
    group: Optional[str] = None
    project: Optional[str] = None


@dataclass
class FlopsProfilerConfig(DeepSpeedConfigModel):
    enabled: bool = False
    recompute_fwd_factor: float = 0.0
    profile_step: int = 1
    module_depth: int = -1
    top_modules: int = 1
    detailed: bool = True
    output_file: Optional[str] = None


@dataclass
class CheckpointConfig(DeepSpeedConfigModel):
    tag_validation: str = "Warn"
    load_universal: bool = False
    use_node_local_storage: bool = False
    parallel_write: dict = field(default_factory=dict)
    async_save: bool = False

    def _validate(self):
        if self.tag_validation.lower().capitalize() not in C.CHECKPOINT_TAG_VALIDATION_MODES:
            raise ValueError(f"checkpoint.tag_validation must be one of {C.CHECKPOINT_TAG_VALIDATION_MODES}")


def _resolve_config_dict(config) -> Dict[str, Any]:
    if isinstance(config, dict):
        return config
    if isinstance(config, (str, os.PathLike)):
        path = str(config)
        if not os.path.exists(path):
            raise FileNotFoundError(f"DeepSpeed config path does not exist: {path}")
        with open(path, "r") as f:
            return json.load(f, object_pairs_hook=dict_raise_error_on_duplicate_keys)
    raise ValueError(f"Expected a dict or path to a JSON file, got {type(config)}")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to deepspeed_tpu_torch ({item})")


class DeepSpeedConfig:
    """Validated view over the user's JSON config (reference ``config.py:705``)."""

    def __init__(self, config, mesh_shape: Optional[Dict[str, int]] = None,
                 world_size: int = 1):
        self._param_dict = _resolve_config_dict(config)
        pd = self._param_dict
        self.world_size = world_size
        # explicit mesh_shape argument (programmatic) overrides the config block
        self.mesh_config = MeshConfig.from_dict(
            mesh_shape if mesh_shape is not None else pd.get(C.MESH, {}))
        m = self.mesh_config
        check_ported_axes(model=m.model, pipe=m.pipe, seq=m.seq, expert=m.expert)
        if pd.get(C.PIPELINE):
            raise _not_ported("the 'pipeline' block", PIPE_ITEM)

        # --- precision ---
        self.fp16_config = FP16Config.from_dict(pd.get(C.FP16, {}))
        bf16_dict = pd.get(C.BFLOAT16, pd.get(C.BFLOAT16_OLD, {}))
        self.bf16_config = BF16Config.from_dict(bf16_dict)
        self.fp16_enabled = self.fp16_config.enabled
        self.bfloat16_enabled = self.bf16_config.enabled
        if self.fp16_enabled and self.bfloat16_enabled:
            raise ValueError("fp16 and bf16 modes cannot both be enabled")
        amp = pd.get(C.AMP, {})
        self.amp_enabled = bool(amp.get(C.AMP_ENABLED, C.AMP_ENABLED_DEFAULT))
        if self.amp_enabled:
            logger.warning("amp block is apex-specific; treating it as bf16, as the JAX "
                           "package does")
        self.amp_params = amp

        # --- zero ---
        self.zero_config = zero_config_from_dict(pd.get(C.ZERO_OPTIMIZATION, {}))
        self.zero_enabled = self.zero_config.stage > 0
        self.zero_allow_untested_optimizer = pd.get(
            C.ZERO_ALLOW_UNTESTED_OPTIMIZER, C.ZERO_ALLOW_UNTESTED_OPTIMIZER_DEFAULT)
        self.zero_force_ds_cpu_optimizer = pd.get(
            C.ZERO_FORCE_DS_CPU_OPTIMIZER, C.ZERO_FORCE_DS_CPU_OPTIMIZER_DEFAULT)

        # --- optimizer / scheduler ---
        opt = pd.get(C.OPTIMIZER, None)
        self.optimizer_name = opt[C.TYPE].lower() if opt and C.TYPE in opt else None
        self.optimizer_params = (opt or {}).get(C.OPTIMIZER_PARAMS, {})
        self.optimizer_legacy_fusion = (opt or {}).get(C.LEGACY_FUSION, C.LEGACY_FUSION_DEFAULT)
        sched = pd.get(C.SCHEDULER, None)
        self.scheduler_name = sched[C.TYPE] if sched and C.TYPE in sched else None
        self.scheduler_params = (sched or {}).get(C.SCHEDULER_PARAMS, {})

        # --- gradients ---
        self.gradient_clipping = float(pd.get(C.GRADIENT_CLIPPING, C.GRADIENT_CLIPPING_DEFAULT))
        if self.gradient_clipping < 0:
            raise ValueError(
                f"gradient_clipping must be >= 0 (0 disables), got {self.gradient_clipping}")
        self.prescale_gradients = pd.get(C.PRESCALE_GRADIENTS, C.PRESCALE_GRADIENTS_DEFAULT)
        self.gradient_predivide_factor = pd.get(
            C.GRADIENT_PREDIVIDE_FACTOR, C.GRADIENT_PREDIVIDE_FACTOR_DEFAULT)
        self.sparse_gradients_enabled = pd.get(C.SPARSE_GRADIENTS, C.SPARSE_GRADIENTS_DEFAULT)

        # --- communication dtypes ---
        self.communication_data_type = pd.get(C.COMMUNICATION_DATA_TYPE,
                                              C.COMMUNICATION_DATA_TYPE_DEFAULT)
        self.seq_parallel_communication_data_type = pd.get(
            C.SEQ_PARALLEL_COMMUNICATION_DATA_TYPE,
            C.SEQ_PARALLEL_COMMUNICATION_DATA_TYPE_DEFAULT)
        self.disable_allgather = pd.get(C.DISABLE_ALLGATHER, C.DISABLE_ALLGATHER_DEFAULT)

        # --- batch triple (resolved in _configure_train_batch_size) ---
        self.train_batch_size = pd.get(C.TRAIN_BATCH_SIZE, C.TRAIN_BATCH_SIZE_DEFAULT)
        self.train_micro_batch_size_per_gpu = pd.get(
            C.TRAIN_MICRO_BATCH_SIZE_PER_GPU, C.TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT)
        self.gradient_accumulation_steps = pd.get(
            C.GRADIENT_ACCUMULATION_STEPS, C.GRADIENT_ACCUMULATION_STEPS_DEFAULT)

        # --- logging / profiling ---
        self.steps_per_print = pd.get(C.STEPS_PER_PRINT, C.STEPS_PER_PRINT_DEFAULT)
        self.steps_per_execution = int(pd.get(C.STEPS_PER_EXECUTION,
                                              C.STEPS_PER_EXECUTION_DEFAULT))
        self.wall_clock_breakdown = pd.get(C.WALL_CLOCK_BREAKDOWN, C.WALL_CLOCK_BREAKDOWN_DEFAULT)
        self.memory_breakdown = pd.get(C.MEMORY_BREAKDOWN, C.MEMORY_BREAKDOWN_DEFAULT)
        self.dump_state = pd.get(C.DUMP_STATE, C.DUMP_STATE_DEFAULT)
        self.comms_config = CommsLoggerConfig.from_dict(pd.get(C.COMMS_LOGGER, {}))
        self.flops_profiler_config = FlopsProfilerConfig.from_dict(pd.get(C.FLOPS_PROFILER, {}))
        self.monitor_config = {
            "csv_monitor": MonitorSinkConfig.from_dict(pd.get(C.MONITOR_CSV, {})),
            "tensorboard": MonitorSinkConfig.from_dict(pd.get(C.MONITOR_TENSORBOARD, {})),
            "wandb": MonitorSinkConfig.from_dict(pd.get(C.MONITOR_WANDB, {})),
        }

        # --- subsystems ---
        self.activation_checkpointing_config = ActivationCheckpointingConfig.from_dict(
            pd.get(C.ACTIVATION_CHECKPOINTING, {}))
        ckpt_dict = dict(pd.get(C.CHECKPOINT, {}))
        if C.LOAD_UNIVERSAL_CHECKPOINT in pd:
            ckpt_dict["load_universal"] = pd[C.LOAD_UNIVERSAL_CHECKPOINT]
        self.checkpoint_config = CheckpointConfig.from_dict(ckpt_dict)
        self.load_universal_checkpoint = self.checkpoint_config.load_universal
        self.use_node_local_storage = self.checkpoint_config.use_node_local_storage
        self.elasticity_enabled = bool(pd.get(C.ELASTICITY, {}).get("enabled", False))
        self.data_efficiency_config = pd.get(C.DATA_EFFICIENCY, {})
        self.compression_config = pd.get(C.COMPRESSION_TRAINING, {})
        self.autotuning_config = pd.get(C.AUTOTUNING, {})
        self.progressive_layer_drop = pd.get(C.PROGRESSIVE_LAYER_DROP, {})

        # --- misc ---
        self.seed = pd.get(C.SEED, C.SEED_DEFAULT)
        self.dataloader_drop_last = pd.get(C.DATALOADER_DROP_LAST, C.DATALOADER_DROP_LAST_DEFAULT)
        self.disable_jit = pd.get(C.DISABLE_JIT, C.DISABLE_JIT_DEFAULT)
        self.gradient_accumulation_dtype = pd.get(C.DATA_TYPES, {}).get(
            C.GRAD_ACCUM_DTYPE, C.GRAD_ACCUM_DTYPE_DEFAULT)

        self._configure_train_batch_size()
        self._do_sanity_check()

    # ------------------------------------------------------------------
    @property
    def dp_world_size(self) -> int:
        """Data-parallel replica count = world / (model*pipe*seq) (expert and
        hpz are carved out of data)."""
        m = self.mesh_config
        denom = m.model * m.pipe * m.seq
        if self.world_size % denom != 0:
            raise ValueError(f"world size {self.world_size} not divisible by model({m.model})"
                             f"*pipe({m.pipe})*seq({m.seq})")
        return self.world_size // denom

    def _configure_train_batch_size(self):
        """Resolve the (train_batch, micro_batch, grad_acc) triple like the
        reference's ``_set_batch_related_parameters``: any two imply the third."""
        tb, mb, ga = (self.train_batch_size, self.train_micro_batch_size_per_gpu,
                      self.gradient_accumulation_steps)
        dp = self.dp_world_size
        if tb is not None and mb is not None and ga is not None:
            pass
        elif tb is not None and mb is not None:
            ga = tb // (mb * dp)
        elif tb is not None and ga is not None:
            mb = tb // (dp * ga)
        elif mb is not None and ga is not None:
            tb = mb * ga * dp
        elif tb is not None:
            ga = 1
            mb = tb // dp
        elif mb is not None:
            tb = mb * dp
            ga = 1
        else:
            raise ValueError(
                "Either train_batch_size or train_micro_batch_size_per_gpu needs to be provided")
        self.train_batch_size, self.train_micro_batch_size_per_gpu, \
            self.gradient_accumulation_steps = tb, mb, ga

    def _batch_assertion(self):
        tb, mb, ga, dp = (self.train_batch_size, self.train_micro_batch_size_per_gpu,
                          self.gradient_accumulation_steps, self.dp_world_size)
        for name, n in (("Train batch size", tb), ("Micro batch size per gpu", mb),
                        ("Gradient accumulation steps", ga)):
            if n <= 0:
                raise ValueError(f"{name}: {n} has to be greater than 0")
        if tb != mb * ga * dp:
            raise ValueError(
                f"Check batch related parameters. train_batch_size is not equal to "
                f"micro_batch_per_gpu * gradient_acc_step * world_size {tb} != {mb} * {ga} * {dp}")

    def _do_sanity_check(self):
        self._batch_assertion()
        if self.optimizer_name is not None and self.optimizer_name not in DEEPSPEED_OPTIMIZERS:
            logger.warning(f"optimizer type '{self.optimizer_name}' is not a built-in optimizer name")

    def print(self, name="DeepSpeedConfig"):
        logger.info(f"{name}:")
        logger.info(json.dumps(self._param_dict, indent=2, sort_keys=True, default=str))
