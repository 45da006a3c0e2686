"""Communication facade over ``torch.distributed`` (counterpart of ``deepspeed_tpu/comm/comm.py``).

The JAX facade has two surfaces: collectives inside a compiled program,
keyed by mesh axis (``inprog_*``, ``comm.py:383-446``), and eager
control-plane ops (``all_reduce`` :453, ``broadcast`` :524, ``barrier``
:533). The port runs one process a rank and every collective is eager, so
both surfaces are ``torch.distributed`` calls on the process group of an
axis of the topology (``topology.py``):

- the reference's in-place calls: ``all_reduce``, ``broadcast``,
  ``barrier``, ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
  ``all_to_all_single`` (the ones the JAX docstring names), each timed by
  ``timed_op`` into ``comms_logger`` when the logger is on, each
  synchronous (no ``async_op``: the JAX facade's run to completion too);
- the JAX package's in-program ops as functions that return a new tensor
  (``inprog_all_reduce``, ``inprog_all_gather``, ``inprog_reduce_scatter``,
  ``inprog_all_to_all``, ``psum``, ``pmean``, ``pmax``, ``pmin``), built on
  the calls above.

``group=None`` is the full ZeRO degree (``ZERO_AXES``); a group may be
named by an axis or a tuple of axes, or be a process group. A group of one
rank makes every op the identity, with no call.

Rendezvous (``init_distributed``) is the environment ``torchrun`` sets
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``)
or an explicit ``init_method`` (``file://`` in the tests). The MPI and cloud
discovery shims of the JAX facade (:61-205) are not ported (ROADMAP.md
Queue 1 item 18). The backend is explicit: ``nccl`` (the CUDA accelerator's,
one card a rank) unless the caller names ``gloo`` (CPU ranks, or ranks that
share one card); ``nccl`` with more ranks on a host than cards raises, and
nothing switches the backend or the device on its own. The gloo backend
takes every collective of this facade on CUDA tensors as they are (torch
2.11, on an H100: ``chip_smoke.py`` phase m calls each one natively on the
card and fails if one is refused), so no call is staged through host
buffers.
"""

import datetime
import functools
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.logging import logger
from .comms_logging import CommsLogger
from .topology import MESH_AXES, get_topology, initialize_topology, normalize_axes

comms_logger = CommsLogger()

ReduceOp = type("ReduceOp", (), {"SUM": "sum", "AVG": "avg", "MAX": "max", "MIN": "min",
                                 "PRODUCT": "prod"})

_TORCH_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
              "prod": dist.ReduceOp.PRODUCT}

_initialized = False


def is_initialized() -> bool:
    return _initialized


def init_distributed(dist_backend: Optional[str] = None, auto_mpi_discovery: bool = True,
                     verbose: bool = True, timeout=None, init_method: Optional[str] = None,
                     dist_init_required=None, config=None, rank: int = -1,
                     world_size: int = -1, mesh_config=None):
    """Join the process group and build the topology (reference
    ``comm.py:604``). The world is ``world_size`` or ``WORLD_SIZE`` (1 when
    neither is set: one process, no group), the rank ``rank`` or ``RANK``.
    A process group the caller already made is adopted as it is. Called
    again, only the topology is rebuilt (from ``mesh_config``)."""
    global _initialized
    if dist.is_available() and dist.is_initialized():
        world, me = dist.get_world_size(), dist.get_rank()
    else:
        world = world_size if world_size > 0 else int(os.environ.get("WORLD_SIZE", "1"))
        me = rank if rank >= 0 else int(os.environ.get("RANK", "0"))
        if world > 1 or init_method is not None:
            backend = _check_backend(dist_backend, world)
            kw = {}
            if timeout is not None:
                kw["timeout"] = (timeout if isinstance(timeout, datetime.timedelta)
                                 else datetime.timedelta(seconds=float(timeout)))
            if backend == "nccl":
                torch.cuda.set_device(get_local_rank())
            dist.init_process_group(backend, init_method=init_method or "env://", rank=me,
                                    world_size=world, **kw)
            if verbose:
                logger.info(f"torch.distributed: rank {me} of {world} over {backend}")
    initialize_topology(mesh_config=mesh_config, world_size=world, rank=me)
    _initialized = True


def _check_backend(name: Optional[str], world: int) -> str:
    """The backend the caller names, or the CUDA accelerator's (``nccl``).
    ``nccl`` needs one card a rank on this host."""
    if name is None:
        from ..accelerator import get_accelerator

        name = get_accelerator("cuda").communication_backend_name()
    if name not in ("nccl", "gloo"):
        raise ValueError(f"dist_backend must be 'nccl' or 'gloo', got {name!r}")
    if name == "nccl":
        local = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local > cards:
            raise RuntimeError(
                f"backend 'nccl' needs one CUDA card a rank: {local} ranks on this host, "
                f"{cards} cards. Ranks that share a card, or CPU ranks, pass "
                "dist_backend='gloo'")
    return name


def get_rank(group=None) -> int:
    """This process's rank in ``group`` (default: the whole world, as torch's)."""
    if group is None:
        if not (dist.is_available() and dist.is_initialized()):
            return get_topology().rank
        return dist.get_rank()
    if _is_axes(group):
        return get_topology().rank_in(normalize_axes(group))
    return dist.get_rank(group)


def get_world_size(group=None) -> int:
    """Ranks in ``group`` (default: the whole world, as torch's)."""
    if group is None:
        return get_topology().world_size
    return _group_size(group)


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def get_data_parallel_world_size() -> int:
    return get_topology().data_parallel_size


def get_model_parallel_world_size() -> int:
    return get_topology().model_parallel_size


def get_backend(group=None) -> Optional[str]:
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return dist.get_backend(_process_group(group))


def _is_axes(group) -> bool:
    return group is None or isinstance(group, str) or (
        isinstance(group, (tuple, list)) and all(a in MESH_AXES for a in group))


def _process_group(group):
    """A process group from an axis name, a tuple of axes, ``None`` (the
    ZeRO axes) or a process group."""
    return get_topology().group(group) if _is_axes(group) else group


def _group_size(group) -> int:
    if _is_axes(group):
        return get_topology().size_of(normalize_axes(group))
    return dist.get_world_size(group)


def configure(config=None, enabled=None, prof_all=None, prof_ops=None, verbose=None, debug=None):
    """Wire the comms logger (reference ``comm.py`` ``configure``)."""
    if config is not None:
        comms_logger.configure(config.comms_config if hasattr(config, "comms_config") else config)
    if enabled is not None:
        comms_logger.enabled = enabled
    if prof_all is not None:
        comms_logger.prof_all = prof_all
    if prof_ops is not None:
        comms_logger.prof_ops = prof_ops
    if verbose is not None:
        comms_logger.verbose = verbose
    if debug is not None:
        comms_logger.debug = debug


def timed_op(func):
    """Wall-clock and bandwidth record for an eager collective (reference
    ``comm.py:101``): the time to completion (a device synchronise before and
    after on the card) and the message size: what one rank puts into the
    op, for a gather or a scatter the shard, as the reference counts it."""
    import inspect

    sig = inspect.signature(func)

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if not comms_logger.enabled:
            return func(*args, **kwargs)
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        raw_name = func.__name__
        log_name = bound.arguments.get("log_name") or raw_name
        if not (comms_logger.prof_all or raw_name in comms_logger.prof_ops
                or log_name in comms_logger.prof_ops):
            return func(*args, **kwargs)
        tensors = [t for t in bound.arguments.values() if isinstance(t, torch.Tensor)]
        msg = min((t.numel() * t.element_size() for t in tensors), default=0)
        if raw_name in ("all_reduce", "broadcast", "all_to_all_single"):
            msg = tensors[-1].numel() * tensors[-1].element_size()
        cuda = any(t.is_cuda for t in tensors)
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = func(*args, **kwargs)
        if cuda:
            torch.cuda.synchronize()
        comms_logger.append(raw_name, log_name, time.perf_counter() - t0, msg,
                            _group_size(bound.arguments.get("group")))
        return result

    return wrapper


# ---------------------------------------------------------------------------
# the reference's in-place calls
# ---------------------------------------------------------------------------

@timed_op
def all_reduce(tensor, op: str = "sum", group=None, log_name: str = "all_reduce"):
    """Reduce ``tensor`` in place over the group's ranks (``avg`` is a sum
    divided by the group's size: gloo has no average)."""
    n = _group_size(group)
    if n == 1:
        return tensor
    pg = _process_group(group)
    if op in ("avg", ReduceOp.AVG):
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=pg)
        tensor.div_(n)
        return tensor
    dist.all_reduce(tensor, op=_TORCH_OPS[op], group=pg)
    return tensor


@timed_op
def broadcast(tensor, src: int = 0, group=None, log_name: str = "broadcast"):
    """``tensor`` from global rank ``src`` to every rank of the group, in place."""
    if _group_size(group) > 1:
        dist.broadcast(tensor, src, group=_process_group(group))
    return tensor


@timed_op
def barrier(group=None, log_name: str = "barrier"):
    if dist.is_available() and dist.is_initialized() and _group_size(group) > 1:
        dist.barrier(group=_process_group(group))


@timed_op
def all_gather_into_tensor(output_tensor, input_tensor, group=None,
                           log_name: str = "all_gather_into_tensor"):
    """The group's ``input_tensor``\\ s stacked along dim 0 into
    ``output_tensor`` (``n`` times as many elements), in group-rank order."""
    if _group_size(group) == 1:
        output_tensor.copy_(input_tensor.reshape(output_tensor.shape))
        return output_tensor
    # torch 2.13 renames the call (the old name warns); 2.11 has the old one only
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(output_tensor, input_tensor, group=_process_group(group))
    return output_tensor


@timed_op
def reduce_scatter_tensor(output_tensor, input_tensor, op: str = "sum", group=None,
                          log_name: str = "reduce_scatter_tensor"):
    """``input_tensor`` reduced over the group, and this rank's ``1/n`` of it
    along dim 0 into ``output_tensor``."""
    n = _group_size(group)
    if n == 1:
        output_tensor.copy_(input_tensor.reshape(output_tensor.shape))
        return output_tensor
    rop = dist.ReduceOp.SUM if op in ("avg", ReduceOp.AVG) else _TORCH_OPS[op]
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(output_tensor, input_tensor, op=rop, group=_process_group(group))
    if op in ("avg", ReduceOp.AVG):
        output_tensor.div_(n)
    return output_tensor


@timed_op
def all_to_all_single(output, input, group=None, log_name: str = "all_to_all_single"):
    """Chunk ``j`` (along dim 0, ``1/n`` of ``input``) to group rank ``j``;
    chunk ``i`` of ``output`` from group rank ``i``."""
    if _group_size(group) == 1:
        output.copy_(input)
        return output
    dist.all_to_all_single(output, input, group=_process_group(group))
    return output


def log_summary(show_straggler: bool = False):
    return comms_logger.log_all(print_log=get_rank() == 0, show_straggler=show_straggler)


def get_global_rank(group=None, group_rank: int = 0) -> int:
    if _is_axes(group):
        return get_topology().group_ranks(group)[group_rank]
    return dist.get_global_rank(group, group_rank)


def get_all_ranks_from_group(group=None):
    if _is_axes(group):
        return get_topology().group_ranks(group)
    return dist.get_process_group_ranks(group)


# ---------------------------------------------------------------------------
# the JAX package's in-program ops, as functions over the axis groups
# ---------------------------------------------------------------------------

def inprog_all_reduce(x, axis_name=None, op: str = "sum", log_name: str = "all_reduce"):
    """``lax.psum`` / ``pmean`` / ``pmax`` / ``pmin`` over the axes: a new tensor."""
    return all_reduce(x.clone(), op=op, group=axis_name, log_name=log_name)


def psum(x, axis_name=None):
    return inprog_all_reduce(x, axis_name, "sum")


def pmean(x, axis_name=None):
    return inprog_all_reduce(x, axis_name, "avg")


def pmax(x, axis_name=None):
    return inprog_all_reduce(x, axis_name, "max")


def pmin(x, axis_name=None):
    return inprog_all_reduce(x, axis_name, "min")


def inprog_all_gather(x, axis_name=None, axis: int = 0, tiled: bool = True,
                      log_name: str = "all_gather_into_tensor"):
    """``lax.all_gather``: the group's ``x`` stacked on a new leading axis
    (``tiled=False``) or concatenated along ``axis``."""
    n = _group_size(axis_name)
    x = x.contiguous()
    out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    all_gather_into_tensor(out.view(-1), x.view(-1), group=axis_name, log_name=log_name)
    if not tiled:
        return out
    return torch.cat(out.unbind(0), dim=axis)


def inprog_reduce_scatter(x, axis_name=None, scatter_dimension: int = 0, tiled: bool = True,
                          op: str = "sum", log_name: str = "reduce_scatter_tensor"):
    """``lax.psum_scatter``: ``x`` summed over the group, this rank's ``1/n``
    along ``scatter_dimension`` kept (that dimension removed with
    ``tiled=False``, where it must equal ``n``)."""
    n = _group_size(axis_name)
    d = scatter_dimension % x.dim()
    moved = x.movedim(d, 0).contiguous()
    if moved.shape[0] % n:
        raise ValueError(f"dimension {d} of {tuple(x.shape)} does not split over {n} ranks")
    out = torch.empty((moved.shape[0] // n,) + tuple(moved.shape[1:]), dtype=x.dtype,
                      device=x.device)
    reduce_scatter_tensor(out, moved, op=op, group=axis_name, log_name=log_name)
    if not tiled:
        return out[0]
    return out.movedim(0, d)


def inprog_all_to_all(x, axis_name=None, split_axis: int = 0, concat_axis: int = 0,
                      tiled: bool = True, log_name: str = "all_to_all_single"):
    """``lax.all_to_all``: ``x`` split into ``n`` chunks along ``split_axis``,
    chunk ``j`` sent to group rank ``j``, the received chunks concatenated
    along ``concat_axis`` (stacked there with ``tiled=False``, where
    ``split_axis`` must equal ``n`` and is removed)."""
    n = _group_size(axis_name)
    moved = x.movedim(split_axis, 0).contiguous()
    if moved.shape[0] % n:
        raise ValueError(f"dimension {split_axis} of {tuple(x.shape)} does not split over "
                         f"{n} ranks")
    out = torch.empty_like(moved)
    all_to_all_single(out, moved, group=axis_name, log_name=log_name)
    chunks = out.reshape((n, moved.shape[0] // n) + tuple(moved.shape[1:]))
    if not tiled:
        # (n, 1, ...) chunks: the source rank's index takes split_axis's place
        return chunks[:, 0].movedim(0, concat_axis)
    parts = [c.movedim(0, split_axis) for c in chunks.unbind(0)]
    return torch.cat(parts, dim=concat_axis)

