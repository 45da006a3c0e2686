"""DeepSpeed-TPU ported to PyTorch and CUDA for NVIDIA Hopper.

The counterpart of ``deepspeed_tpu``: the same module paths and names, with
PyTorch in place of JAX and hand-written Hopper kernels in place of the
Pallas ones. It imports neither ``jax`` nor ``deepspeed_tpu``. Entry points
run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``, and raise when CUDA is absent rather than falling back.

Ported so far: the paged serving step (``inference.v2.InferenceEngineV2``
with ``paged=True`` over ``models.TransformerLM.forward_paged``) and its
``paged_decode_attention`` CUDA kernel; the training step (``initialize`` ->
``runtime.engine.DeepSpeedEngine`` ``train_batch`` / ``forward`` /
``backward`` / ``step`` over ``TransformerLM.apply``) on one card or
data-parallel over ``torch.distributed`` ranks (``comm``: one process a
rank; stages 1-3 shard across the ranks, with ZeRO++ qwZ / qgZ / hpZ and the
1-bit optimizers' compressed all-reduce), at ZeRO
stages 0-3 with the optimizer state on the card or offloaded to host RAM or
NVMe (``zero_optimization.offload_optimizer``: the C++ CPU Adam, the sharded
host tier, stage-3 residency) or with the parameters streamed a layer at a
time from host RAM or NVMe (``offload_param``, ``runtime.swap_tensor``), with
activation checkpointing under the seven remat policies
(``TransformerConfig.remat``, ``checkpointing``), and its flash-attention
forward and backward CUDA kernels; and weight-only-quantized serving
(``inference.quantization.quantize_model`` into the paged engine) with its
``woq_matmul`` CUDA kernel. Tensor parallelism over the mesh's ``model``
axis (``runtime.tensor_parallel``): training through ``initialize(...,
mesh_config={"model": N})`` under ZeRO on the data axis, and the v1
``init_inference(model, tensor_parallel={"tp_size": N})`` serving bf16 or
weight-only-quantized weights, with TP checkpoint sets
(``runtime.state_dict_factory``).
"""

__version__ = "0.1.0"

_HOST_TIERS_ITEM = "ROADMAP.md Queue 1 item 13d, host tiers across ranks"
_MODEL_ITEM = "ROADMAP.md Queue 1 item 17, runtime/pipe"


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, distributed_port: int = 29500,
               mpu=None, dist_init_required: bool = None, collate_fn=None, config=None,
               mesh_config=None, config_params=None, device="cuda"):
    """Build a training engine (``deepspeed_tpu/__init__.py:47``): the
    ``DeepSpeedEngine``, or with ``zero_optimization.offload_param`` to
    ``cpu`` or ``nvme`` at stage 3 the layer-streamed
    ``runtime.swap_tensor.StreamedZeroEngine``, which draws its own weights
    (seed 0) and refuses ``optimizer``, ``training_data``, ``collate_fn`` and
    ``model_parameters``, as the JAX package's does.

    Returns the 4-tuple ``(engine, optimizer, training_dataloader,
    lr_scheduler)``. ``model`` is a (params, apply_fn) pair or an object
    exposing ``.params``/``.apply`` or ``.init_params``/``.apply``;
    ``model_parameters`` are its parameters as a nested dict of tensors (e.g.
    from ``models.params_from_jax``). ``device`` as for every entry point of
    the port: the card unless ``"cpu"`` is asked for.

    Data and tensor parallelism: when a process group is up
    (``comm.init_distributed``, which takes the backend by name) or
    ``WORLD_SIZE`` is above 1 (then the group is joined here over ``nccl``,
    one card a rank), the engine shards over the ranks per the ``mesh``
    block or ``mesh_config`` (``data``, ``hpz``, ``model``) and
    ``zero_hpz_partition_size``; each rank passes the global batch. ``mpu``
    is accepted and ignored, as in the JAX package: tensor parallelism
    comes from the mesh.
    """
    import os

    import torch.distributed as torch_dist

    from . import comm
    from .runtime.config import DeepSpeedConfig
    from .runtime.engine import DeepSpeedEngine
    from .utils.logging import log_dist

    log_dist(f"DeepSpeed-TPU (PyTorch port) info: version={__version__}", ranks=[0])
    if model is None:
        raise ValueError("deepspeed_tpu_torch.initialize: model is a required argument")
    if config is None:
        config = config_params
    if config is None and args is not None and getattr(args, "deepspeed_config", None):
        config = args.deepspeed_config
    if config is None:
        raise ValueError("DeepSpeed requires --deepspeed_config to specify configuration "
                         "file, or a config= dict/path argument")
    if mpu is not None:
        from .utils.logging import logger

        logger.warning(
            "mpu argument is accepted for parity but ignored: tensor parallelism is "
            "configured via the 'mesh' config block")
    if type(model).__name__ in ("PipelinedLM", "PipelineModule"):
        raise NotImplementedError(
            f"pipeline models are not ported to deepspeed_tpu_torch ({_MODEL_ITEM})")
    if not torch_dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        comm.init_distributed()
    world = torch_dist.get_world_size() if torch_dist.is_initialized() else 1
    ds_config = DeepSpeedConfig(config, mesh_shape=mesh_config, world_size=world)
    # ZeRO++ hpZ / MiCS secondary partition becomes the `hpz` axis
    # (deepspeed_tpu/__init__.py:91-116)
    zc = ds_config.zero_config
    mics = zc.mics_shard_size if zc.mics_shard_size and zc.mics_shard_size > 0 else 1
    if zc.zero_hpz_partition_size > 1 and mics > 1 and zc.zero_hpz_partition_size != mics:
        raise ValueError(f"zero_hpz_partition_size={zc.zero_hpz_partition_size} conflicts "
                         f"with mics_shard_size={mics}")
    hpz = max(zc.zero_hpz_partition_size, mics)
    if hpz > 1 and zc.stage < 3:
        log_dist(f"zero_hpz_partition_size/mics_shard_size={hpz} only applies at ZeRO "
                 f"stage 3 (got stage {zc.stage}); ignoring (parity with reference)",
                 ranks=[0])
        hpz = 1
    mc = ds_config.mesh_config
    if hpz > 1 and mc.hpz != 1 and mc.hpz != hpz:
        raise ValueError(f"mesh.hpz={mc.hpz} conflicts with zero_hpz_partition_size/"
                         f"mics_shard_size={hpz}")
    if hpz > 1 and mc.hpz == 1:
        if mc.data:
            if mc.data % hpz:
                raise ValueError(f"zero_hpz_partition_size/mics_shard_size {hpz} does not "
                                 f"divide mesh.data {mc.data}")
            mc.data //= hpz
        mc.hpz = hpz
    comm.init_distributed(mesh_config=mc)
    comm.configure(config=ds_config)
    # stage-3 offload_param gets the layer-streamed ZeRO-Infinity engine
    # (deepspeed_tpu/__init__.py:122-145)
    off_p = zc.offload_param
    if off_p is not None and off_p.device in ("cpu", "nvme"):
        if zc.stage < 3:
            raise ValueError(
                "zero_optimization.offload_param requires stage 3 "
                "(parity with reference offload_param)")
        unsupported = {"optimizer": optimizer, "training_data": training_data,
                       "collate_fn": collate_fn,
                       "model_parameters": model_parameters}
        given = [k for k, v in unsupported.items() if v is not None]
        if given:
            raise ValueError(
                f"offload_param (layer-streamed) engine does not support the "
                f"{given} argument(s): the optimizer is the host CPUAdam from "
                "the config's optimizer block, and data is passed to "
                "train_batch(data_iter) directly")
        if ds_config.world_size > 1:
            raise NotImplementedError(
                "the layer-streamed engine (offload_param) across ranks is not ported to "
                f"deepspeed_tpu_torch ({_HOST_TIERS_ITEM})")
        from .runtime.swap_tensor import StreamedZeroEngine

        engine = StreamedZeroEngine(model, ds_config, lr_scheduler=lr_scheduler, device=device)
        return engine, engine.optimizer, engine.training_dataloader, engine.lr_scheduler
    engine = DeepSpeedEngine(model=model, config=ds_config, optimizer=optimizer,
                             lr_scheduler=lr_scheduler, training_data=training_data,
                             collate_fn=collate_fn, model_params=model_parameters,
                             device=device)
    return engine, engine.optimizer, engine.training_dataloader, engine.lr_scheduler


def init_inference(model, config=None, **kwargs):
    """Build the v1 inference engine (``deepspeed_tpu/__init__.py:182``):
    ``inference.engine.init_inference``, tensor-parallel over
    ``tensor_parallel={"tp_size": N}`` ranks."""
    from .inference.engine import init_inference as _init_inference

    return _init_inference(model, config=config, **kwargs)
