"""Config key constants and defaults (a copy of ``deepspeed_tpu/runtime/constants.py``).

Copied, not imported: the JAX package's ``__init__`` imports JAX. Schema parity with the reference's ``deepspeed/runtime/constants.py``: the same JSON
keys are accepted so a DeepSpeed config file drives this framework unchanged. Keys
whose mechanism is CUDA-specific (e.g. ``amp``) are accepted and either mapped to the
TPU-native equivalent or recorded as no-ops with a warning.
"""

#############################################
# Batch size triple
#############################################
TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_BATCH_SIZE_DEFAULT = None

TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT = None

GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"
GRADIENT_ACCUMULATION_STEPS_DEFAULT = None

#############################################
# Optimizer / scheduler
#############################################
OPTIMIZER = "optimizer"
OPTIMIZER_TYPE_DEFAULT = None
OPTIMIZER_PARAMS = "params"
TYPE = "type"
LEGACY_FUSION = "legacy_fusion"
LEGACY_FUSION_DEFAULT = False

SCHEDULER = "scheduler"
SCHEDULER_TYPE_DEFAULT = None
SCHEDULER_PARAMS = "params"
MAX_GRAD_NORM = "max_grad_norm"

ZERO_ALLOW_UNTESTED_OPTIMIZER = "zero_allow_untested_optimizer"
ZERO_ALLOW_UNTESTED_OPTIMIZER_DEFAULT = False
ZERO_FORCE_DS_CPU_OPTIMIZER = "zero_force_ds_cpu_optimizer"
ZERO_FORCE_DS_CPU_OPTIMIZER_DEFAULT = True

#############################################
# Precision
#############################################
FP16 = "fp16"
FP16_ENABLED = "enabled"
FP16_ENABLED_DEFAULT = False
FP16_LOSS_SCALE = "loss_scale"
FP16_LOSS_SCALE_DEFAULT = 0
FP16_AUTO_CAST = "auto_cast"
FP16_AUTO_CAST_DEFAULT = False
FP16_INITIAL_SCALE_POWER = "initial_scale_power"
FP16_INITIAL_SCALE_POWER_DEFAULT = 16
FP16_LOSS_SCALE_WINDOW = "loss_scale_window"
FP16_LOSS_SCALE_WINDOW_DEFAULT = 1000
FP16_HYSTERESIS = "hysteresis"
FP16_HYSTERESIS_DEFAULT = 2
FP16_CONSECUTIVE_HYSTERESIS = "consecutive_hysteresis"
FP16_CONSECUTIVE_HYSTERESIS_DEFAULT = False
FP16_MIN_LOSS_SCALE = "min_loss_scale"
FP16_MIN_LOSS_SCALE_DEFAULT = 1.0
FP16_MASTER_WEIGHTS_AND_GRADS = "fp16_master_weights_and_grads"
FP16_MASTER_WEIGHTS_AND_GRADS_DEFAULT = False

BFLOAT16 = "bf16"
BFLOAT16_OLD = "bfloat16"  # reference keeps backwards compatibility
BFLOAT16_ENABLED = "enabled"
BFLOAT16_ENABLED_DEFAULT = False
BFLOAT16_IMMEDIATE_GRAD_UPDATE = "immediate_grad_update"
BFLOAT16_IMMEDIATE_GRAD_UPDATE_DEFAULT = False

AMP = "amp"
AMP_ENABLED = "enabled"
AMP_ENABLED_DEFAULT = False

#############################################
# Gradients
#############################################
GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0

PRESCALE_GRADIENTS = "prescale_gradients"
PRESCALE_GRADIENTS_DEFAULT = False

GRADIENT_PREDIVIDE_FACTOR = "gradient_predivide_factor"
GRADIENT_PREDIVIDE_FACTOR_DEFAULT = 1.0

SPARSE_GRADIENTS = "sparse_gradients"
SPARSE_GRADIENTS_DEFAULT = False

#############################################
# Communication
#############################################
COMMUNICATION_DATA_TYPE = "communication_data_type"
COMMUNICATION_DATA_TYPE_DEFAULT = None
SEQ_PARALLEL_COMMUNICATION_DATA_TYPE = "seq_parallel_communication_data_type"
SEQ_PARALLEL_COMMUNICATION_DATA_TYPE_DEFAULT = "fp32"
DISABLE_ALLGATHER = "disable_allgather"
DISABLE_ALLGATHER_DEFAULT = False

#############################################
# Logging / profiling
#############################################
STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10

# TPU-native extension (Keras `steps_per_execution` precedent): number of
# optimizer steps executed inside ONE compiled program dispatch. Amortizes
# per-dispatch host/runtime overhead; requires GAS=1 and bf16/fp32.
STEPS_PER_EXECUTION = "steps_per_execution"
STEPS_PER_EXECUTION_DEFAULT = 1

WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
WALL_CLOCK_BREAKDOWN_DEFAULT = False

DUMP_STATE = "dump_state"
DUMP_STATE_DEFAULT = False

MEMORY_BREAKDOWN = "memory_breakdown"
MEMORY_BREAKDOWN_DEFAULT = False

#############################################
# Misc engine knobs
#############################################
GRADIENT_ACCUMULATION_DTYPE = "gradient_accumulation_dtype"

USE_NODE_LOCAL_STORAGE_CHECKPOINT = "use_node_local_storage"
USE_NODE_LOCAL_STORAGE_CHECKPOINT_DEFAULT = False

LOAD_UNIVERSAL_CHECKPOINT = "load_universal_checkpoint"
LOAD_UNIVERSAL_CHECKPOINT_DEFAULT = False

CHECKPOINT = "checkpoint"
CHECKPOINT_TAG_VALIDATION = "tag_validation"
CHECKPOINT_TAG_VALIDATION_DEFAULT = "Warn"
CHECKPOINT_TAG_VALIDATION_MODES = ["Warn", "Ignore", "Fail"]
CHECKPOINT_PARALLEL_WRITE = "parallel_write"
CHECKPOINT_PARALLEL_WRITE_PIPELINE_STAGE = "pipeline_stage"

DATA_TYPES = "data_types"
GRAD_ACCUM_DTYPE = "grad_accum_dtype"
GRAD_ACCUM_DTYPE_DEFAULT = None

SEED = "seed"
SEED_DEFAULT = 1234

DATALOADER_DROP_LAST = "dataloader_drop_last"
DATALOADER_DROP_LAST_DEFAULT = False

DISABLE_JIT = "disable_jit"  # TPU-native addition: run eagerly for debugging
DISABLE_JIT_DEFAULT = False

#############################################
# Subsystem block keys
#############################################
ZERO_OPTIMIZATION = "zero_optimization"
ACTIVATION_CHECKPOINTING = "activation_checkpointing"
MONITOR_CSV = "csv_monitor"
MONITOR_TENSORBOARD = "tensorboard"
MONITOR_WANDB = "wandb"
COMMS_LOGGER = "comms_logger"
FLOPS_PROFILER = "flops_profiler"
ELASTICITY = "elasticity"
AUTOTUNING = "autotuning"
COMPRESSION_TRAINING = "compression_training"
DATA_EFFICIENCY = "data_efficiency"
CURRICULUM_LEARNING_LEGACY = "curriculum_learning"
PROGRESSIVE_LAYER_DROP = "progressive_layer_drop"
PIPELINE = "pipeline"
MESH = "mesh"  # TPU-native addition: explicit mesh axis sizes

#############################################
# Pipeline block (reference runtime/config.py get_pipeline_config)
#############################################
PIPE_REPLICATED = "ds_pipe_replicated"

#############################################
# Progressive layer drop
#############################################
PLD_ENABLED = "enabled"
PLD_ENABLED_DEFAULT = False
PLD_THETA = "theta"
PLD_THETA_DEFAULT = 1.0
PLD_GAMMA = "gamma"
PLD_GAMMA_DEFAULT = 0.001

#############################################
# Routes (for add_config_arguments)
#############################################
ROUTE_TRAIN = "train"
ROUTE_EVAL = "eval"
ROUTE_PREDICT = "predict"
ROUTE_ENCODE = "encode"
