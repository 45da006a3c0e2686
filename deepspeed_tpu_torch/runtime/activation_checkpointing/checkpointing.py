"""Activation checkpointing API (counterpart of ``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``).

The JAX module maps the reference's Megatron-style ``checkpoint`` onto
``jax.checkpoint`` with a policy chosen from the config's knobs, and its CUDA
RNG tracker onto named functional keys. Here:

- ``checkpoint(fn, *args)`` / ``checkpoint_wrapped(fn)`` run ``fn`` under
  ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: nothing of
  ``fn`` is kept but its inputs, and the backward runs it again
  (``partition_activations`` and the default, the JAX module's
  ``nothing_saveable`` and ``jax.checkpoint``);
- with ``cpu_checkpointing`` ``fn`` runs once, and every tensor its backward
  needs lives in pinned host memory until then
  (``torch.autograd.graph.save_on_cpu(pin_memory=True)``), the counterpart
  of the JAX module's offload-to-``pinned_host`` policy;
- ``RNGStatesTracker`` holds threefry keys (``utils/prng.py``), so ``add``
  and ``fork`` give the JAX tracker's keys bit for bit, and a recompute that
  forks the same stream replays the same masks.

``model_parallel_cuda_manual_seed`` seeds the model-parallel stream at
``seed + 2718 + c`` for this rank's coordinate ``c`` on the topology's
``model`` axis, as the JAX function does for a device at that coordinate.
"""

from typing import Any, Callable, Dict

import torch

from ...utils import prng

_config: Dict[str, Any] = {
    "partition_activations": False,
    "contiguous_memory_optimization": False,
    "cpu_checkpointing": False,
    "num_checkpoints": None,
    "synchronize": False,
    "profile": False,
}


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, num_checkpoints=None,
              checkpoint_in_cpu=None, synchronize=None, profile=None):
    """``configure:1070``: record the knobs that select the policy."""
    if deepspeed_config is not None:
        ac = getattr(deepspeed_config, "activation_checkpointing_config", None)
        if ac is not None:
            _config["partition_activations"] = ac.partition_activations
            _config["contiguous_memory_optimization"] = ac.contiguous_memory_optimization
            _config["cpu_checkpointing"] = ac.cpu_checkpointing
            _config["num_checkpoints"] = ac.number_checkpoints
    for k, v in [("partition_activations", partition_activations),
                 ("contiguous_memory_optimization", contiguous_checkpointing),
                 ("num_checkpoints", num_checkpoints),
                 ("cpu_checkpointing", checkpoint_in_cpu),
                 ("synchronize", synchronize), ("profile", profile)]:
        if v is not None:
            _config[k] = v


def is_configured() -> bool:
    return True


def checkpoint(function: Callable, *args):
    """Checkpoint a forward segment (reference ``checkpoint:989``)."""
    if _config["cpu_checkpointing"]:
        with torch.autograd.graph.save_on_cpu(pin_memory=True):
            return function(*args)
    return torch.utils.checkpoint.checkpoint(function, *args, use_reentrant=False)


def checkpoint_wrapped(function: Callable) -> Callable:
    """Decorator form for building remat'd blocks."""
    return lambda *args: checkpoint(function, *args)


# ----------------------------------------------------------------------------
# RNG tracking (reference CudaRNGStatesTracker:122 / model_parallel_cuda_manual_seed)
# ----------------------------------------------------------------------------

class RNGStatesTracker:
    """Named functional PRNG keys (reference ``CudaRNGStatesTracker``): each
    state a threefry key, (2,) int64 words; forking is explicit."""

    def __init__(self):
        self.states_: Dict[str, torch.Tensor] = {}

    def reset(self):
        self.states_.clear()

    def get_states(self):
        return dict(self.states_)

    def set_states(self, states):
        self.states_ = dict(states)

    def add(self, name: str, seed: int):
        if name in self.states_:
            raise Exception(f"rng state {name} already exists")
        self.states_[name] = prng.PRNGKey(seed)

    def fork(self, name: str = "model-parallel-rng"):
        """Return a fresh subkey from the named stream (advances the stream)."""
        if name not in self.states_:
            raise Exception(f"rng state {name} not added")
        self.states_[name], sub = prng.split(self.states_[name])
        return sub


_RNG_TRACKER = RNGStatesTracker()


def get_cuda_rng_tracker() -> RNGStatesTracker:  # parity name
    return _RNG_TRACKER


def model_parallel_cuda_manual_seed(seed: int):
    """reference ``model_parallel_cuda_manual_seed``: the model-parallel
    stream at ``seed + 2718 + mp_rank``, ``mp_rank`` this rank's model
    coordinate (0 without a topology)."""
    from ...comm.topology import MODEL_AXIS, get_topology

    topo = get_topology(required=False)
    _RNG_TRACKER.reset()
    _RNG_TRACKER.add("model-parallel-rng",
                     seed + 2718 + (0 if topo is None else topo.coords[MODEL_AXIS]))
    return seed
