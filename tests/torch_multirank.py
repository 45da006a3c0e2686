"""Rank processes for the port's multi-rank tests, and what they run.

``Ranks(n, tmp_path)`` starts ``n`` processes (``spawn``), each one rank of
a gloo process group that meets through a ``file://`` rendezvous in
``tmp_path`` (no TCP port), torch on one thread. ``ranks.run(fn, *args)``
runs the module-level function ``fn(rank, *args)`` of this module in every
rank and returns the ranks' results in rank order; a rank's exception
comes back as a ``RankError`` with its traceback, and every wait has a
timeout of its own. A test module starts its ranks once (a module fixture)
and feeds them scenarios. This module imports neither JAX nor the JAX
package: the ranks run the port alone; the test process holds the JAX
side and compares.
"""

import importlib
import itertools
import multiprocessing as mp
import os
import queue
import traceback
import uuid

import numpy as np

#: seconds a scenario may take in a rank
TIMEOUT = 240


class RankError(RuntimeError):
    pass


class Ranks:
    def __init__(self, n: int, tmpdir, timeout: float = TIMEOUT):
        ctx = mp.get_context("spawn")
        self.n = n
        self.timeout = timeout
        # a fresh file: a store file left by another group would mislead this one
        init = os.path.join(str(tmpdir), f"rendezvous-{n}-{uuid.uuid4().hex}")
        self._out = ctx.Queue()
        self._ins = [ctx.Queue() for _ in range(n)]
        self._procs = [ctx.Process(target=_serve, args=(r, n, init, self._ins[r], self._out),
                                   daemon=True) for r in range(n)]
        for p in self._procs:
            p.start()
        self.run(_ready)

    def run(self, fn, *args):
        for q in self._ins:
            q.put((fn.__module__, fn.__name__, args))
        got, failed = {}, {}
        for _ in range(self.n):
            try:
                rank, ok, out = self._out.get(timeout=self.timeout)
            except queue.Empty:
                raise RankError(f"{fn.__name__}: a rank gave no result in {self.timeout} s "
                                f"(alive: {[p.is_alive() for p in self._procs]})") from None
            (got if ok else failed)[rank] = out
        if failed:  # every rank's result taken first, so none is left for the next run
            rank = min(failed)
            raise RankError(f"{fn.__name__} failed in rank {rank}:\n{failed[rank]}")
        return [got[r] for r in range(self.n)]

    def close(self):
        for q in self._ins:
            q.put(None)
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        assert not any(p.is_alive() for p in self._procs)


def _serve(rank, n, init, inq, outq):
    import torch

    torch.set_num_threads(1)
    from deepspeed_tpu_torch import comm

    comm.init_distributed("gloo", init_method=f"file://{init}", rank=rank, world_size=n,
                          verbose=False)
    while True:
        item = inq.get()
        if item is None:
            break
        module, name, args = item
        try:
            fn = getattr(importlib.import_module(module), name)
            outq.put((rank, True, fn(rank, *args)))
        except BaseException:  # a failed scenario reports and the rank serves on
            outq.put((rank, False, traceback.format_exc()))
    torch.distributed.destroy_process_group()


def _ready(rank):
    return rank


# ---------------------------------------------------------------------------
# scenarios (run in every rank; numpy in, numpy out)
# ---------------------------------------------------------------------------

def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.detach().float().cpu().numpy()


def flat_bytes(tree) -> bytes:
    """A tree's leaves' bytes in sorted-key order: equal bytes, equal trees."""
    from deepspeed_tpu_torch.utils.tree import tree_leaves

    return b"".join(np.ascontiguousarray(a).tobytes() for a in tree_leaves(tree))


def engine(preset, model_kw, config, params_np=None, **kw):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import build_model, params_from_jax

    model = build_model(preset, **model_kw)
    params = None if params_np is None else params_from_jax(params_np)
    return deepspeed_tpu_torch.initialize(model=model, model_parameters=params,
                                          config=dict(config), device="cpu", **kw)[0]


def train(rank, preset, model_kw, config, params_np, batches, steps=None, replicas=True):
    """``steps`` train_batch calls over ``batches`` in turn (a micro-batch
    each, gradient_accumulation_steps of them a step). Returns the
    losses, the fp32 master after the last step, the bytes of every step's
    gathered parameters (``replicas``), and the engine's parameter and
    optimizer-state bytes on this rank."""
    import torch

    eng = engine(preset, model_kw, config, params_np)
    losses, states = [], []
    it = itertools.cycle(batches)
    for _ in range(steps or len(batches)):
        losses.append(float(eng.train_batch(it)))
        if replicas:
            states.append(flat_bytes(_numpy_tree(eng.get_fp32_params())))
    from deepspeed_tpu_torch.utils.tree import tree_leaves

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                   if isinstance(t, torch.Tensor))

    opt = eng.opt_state
    return {"losses": losses, "master": _numpy_tree(eng.get_fp32_params()), "states": states,
            "param_bytes": nbytes(eng.params),
            "opt_bytes": nbytes(eng.master_params) + (0 if opt is None else
                                                      nbytes(opt.m) + nbytes(opt.v)),
            "skipped": eng.skipped_steps}


def unported(rank, preset, model_kw, config, params_np):
    """The message of the ``NotImplementedError`` building the engine
    raises (None if it builds)."""
    try:
        engine(preset, model_kw, config, params_np)
    except NotImplementedError as e:
        return str(e)
    return None


def overflow_on_one_rank(rank, preset, model_kw, config, params_np, batches, bad_rank, bad_step):
    """fp16 training where rank ``bad_rank``'s loss is infinite at step
    ``bad_step`` (0-based): the skipped steps, the loss scale and the bytes
    of the parameters after each step."""
    eng = engine(preset, model_kw, config, params_np)
    inner = eng._apply_fn

    def apply(*a, **k):
        out = inner(*a, **k)
        return out * float("inf") if rank == bad_rank and eng.global_steps == bad_step else out

    eng._apply_fn = apply
    states, scales = [], []
    for b in batches:
        eng.train_batch(iter([b]))
        states.append(flat_bytes(_numpy_tree(eng.get_fp32_params())))
        scales.append(eng.loss_scale())
    return {"skipped": eng.skipped_steps, "states": states, "scales": scales}


def dropout_masks(rank, preset, model_kw, config, params_np, batch):
    """The dropout masks one training step draws on this rank, in draw order."""
    from deepspeed_tpu_torch.utils import prng

    eng = engine(preset, model_kw, config, params_np)
    masks, inner = [], prng.bernoulli

    def bernoulli(*a, **k):
        out = inner(*a, **k)
        masks.append(out.numpy().copy())
        return out

    prng.bernoulli = bernoulli
    try:
        eng.train_batch(iter([batch]))
    finally:
        prng.bernoulli = inner
    return masks


def facade_ops(rank, data, hpz):
    """Every op of the facade on small tensors, over the world, the ZeRO
    axes and (with hpz > 1) each axis group; the comms logger's records."""
    import torch

    from deepspeed_tpu_torch import comm as dist
    from deepspeed_tpu_torch.comm.topology import initialize_topology

    n = data * hpz
    initialize_topology(data=data, hpz=hpz, world_size=n, rank=rank)
    dist.comms_logger.comms_dict.clear()
    dist.configure(enabled=True, prof_all=True, verbose=False)
    out = {}
    x = torch.arange(8, dtype=torch.float32) + 10 * rank
    for op in ("sum", "avg", "max", "min", "prod"):
        out[f"all_reduce_{op}"] = dist.all_reduce((x + 1).clone(), op=op).numpy()
    b = x.clone()
    dist.broadcast(b, src=n - 1)
    out["broadcast"] = b.numpy()
    dist.barrier()
    g = torch.empty(8 * n)
    dist.all_gather_into_tensor(g, x)
    out["all_gather_into_tensor"] = g.numpy()
    big = torch.arange(8 * n, dtype=torch.float32) * (rank + 1)
    rs = torch.empty(8)
    dist.reduce_scatter_tensor(rs, big)
    out["reduce_scatter_tensor"] = rs.numpy()
    a2a = torch.empty(8 * n)
    dist.all_to_all_single(a2a, big)
    out["all_to_all_single"] = a2a.numpy()
    m = torch.arange(12, dtype=torch.float32).reshape(3, 4) + rank
    out["inprog_all_gather_axis1"] = dist.inprog_all_gather(m, None, axis=1).numpy()
    out["inprog_all_gather_untiled"] = dist.inprog_all_gather(m, None, tiled=False).numpy()
    w = torch.arange(3 * 4 * n, dtype=torch.float32).reshape(3, 4 * n) * (rank + 1)
    out["inprog_reduce_scatter_dim1"] = dist.inprog_reduce_scatter(w, None, 1).numpy()
    out["inprog_all_to_all"] = dist.inprog_all_to_all(w.reshape(3, n, 4), None, 1, 1,
                                                      tiled=True).numpy()
    out["pmean"] = dist.pmean(x).numpy()
    out["psum"] = dist.psum(x).numpy()
    out["pmax"] = dist.pmax(x).numpy()
    out["pmin"] = dist.pmin(x).numpy()
    if hpz > 1:
        for axis in ("data", "hpz"):
            out[f"psum_{axis}"] = dist.psum(x, axis).numpy()
            out[f"gather_{axis}"] = dist.inprog_all_gather(x, axis).numpy()
            out[f"ranks_{axis}"] = dist.get_all_ranks_from_group(axis)
            out[f"rank_in_{axis}"] = dist.get_rank(axis)
    out["world"] = dist.get_world_size()
    out["dp"] = dist.get_data_parallel_world_size()
    out["rank"] = dist.get_rank()
    out["log"] = {name: {size: rec[0] for size, rec in recs.items()}
                  for name, recs in dist.comms_logger.comms_dict.items()}
    out["summary"] = {k: {s: v["count"] for s, v in d.items()}
                      for k, d in dist.log_summary().items()}
    dist.configure(enabled=False)
    return out


def quantized_ops(rank, xs, gs, es):
    """The ZeRO++ and 1-bit collectives on this rank's inputs (``xs[rank]``
    etc.): quantizer codes and scales, the quantized gather and
    reduce-scatter, the qwZ leaf gather, the two-hop qgZ mean (and its
    first hop), the 1-bit error-feedback all-reduce and its packed signs."""
    import torch

    from deepspeed_tpu_torch.ops.quantizer import quantizer as q
    from deepspeed_tpu_torch.runtime.comm import compressed as c
    from deepspeed_tpu_torch.runtime.zero import zeropp as z

    x, g, e = (torch.from_numpy(a[rank]) for a in (xs, gs, es))
    codes, scale, zero = q.quantize(x, 8, 16)
    red, err = c.compressed_allreduce(g, e, None)
    return {
        "codes": codes.numpy(), "scale": scale.numpy(), "zero": zero.numpy(),
        "asym": [t.numpy() for t in q.quantize(x, 8, 16, symmetric=False)],
        "all_gather": q.quantized_all_gather(x, None, 8, 16).numpy(),
        "reduce_scatter": q.quantized_reduce_scatter(g.reshape(2, -1), None, 8, 16).numpy(),
        "qwz_gather": z.gather_param_leaf(x, None, 1, True).numpy(),
        "qgz_mean": z.quantized_reduce_leaf(g, None, 2).numpy(),
        "qgz_hop1": z.quantized_reduce_leaf(g, None, 2, hops=1).numpy(),
        "onebit": red.numpy(), "onebit_error": err.numpy(),
        "packed": c.pack_bits((g + e >= 0).reshape(-1)).numpy(),
    }


def _state(eng):
    """The engine's whole fp32 master, moments and step (a collective at dp > 1)."""
    from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_unflatten

    opt = eng.opt_state
    if eng._dpz is not None:
        m, v = (eng._dp_full(tree_leaves(t), eng._dpz.opt) for t in (opt.m, opt.v))
    else:
        m, v = opt.m, opt.v
    return {"master": _numpy_tree(eng.get_fp32_params()), "m": _numpy_tree(m),
            "v": _numpy_tree(v), "step": int(opt.step),
            "global_steps": eng.global_steps}


def checkpoint_cycle(rank, preset, model_kw, config, params_np, batches, steps,
                     save_dir=None, load_dir=None):
    """Load ``load_dir``'s latest tag (if given), record the state, train
    ``steps`` steps, save to ``save_dir`` (if given); returns the state
    after the load and after the steps."""
    eng = engine(preset, model_kw, config, params_np)
    if load_dir is not None:
        eng.load_checkpoint(load_dir)
    loaded = _state(eng)
    it = itertools.cycle(batches)
    losses = [float(eng.train_batch(it)) for _ in range(steps)]
    if save_dir is not None:
        eng.save_checkpoint(save_dir)
    return {"loaded": loaded, "trained": _state(eng), "losses": losses}


def offload_tier(rank, preset, model_kw, config, params_np, batches, steps, save_dir=None,
                 load_dir=None):
    """Offloaded training (after loading ``load_dir``'s latest tag, if
    given): the fp32 master (whole) and the gradient norm after each step,
    the first token of every row each forward saw, the host tier's whole
    moments at the end (every rank's slices gathered), the optimizer-state
    bytes this rank's tier holds; the tag saved to ``save_dir`` (if given)."""
    import torch

    from deepspeed_tpu_torch.runtime.zero.data_parallel import gather_plan_slices

    eng = engine(preset, model_kw, config, params_np)
    if load_dir is not None:
        eng.load_checkpoint(load_dir)
    inner, seen = eng._apply_fn, []

    def apply(params, batch, **k):
        seen.append(batch["input_ids"][:, 0].tolist())
        return inner(params, batch, **k)

    eng._apply_fn = apply
    it = itertools.cycle(batches)
    masters, losses, norms = [], [], []
    for _ in range(steps):
        losses.append(float(eng.train_batch(it)))
        masters.append(_numpy_tree(eng.get_fp32_params()))
        norms.append(eng._last_global_norm)
    if save_dir is not None:
        eng.save_checkpoint(save_dir)
    tier = eng._zero_tier
    host = eng._offload_mgr["host"]
    ms, vs = (host.full_moments() if tier is not None else (host.m, host.v))
    if tier is not None and tier.rank is not None:
        ms, vs = ([gather_plan_slices(torch.from_numpy(a), tier.plan.bounds[j]).numpy()
                   for j, a in enumerate(x)] for x in (ms, vs))
    return {"masters": masters, "losses": losses, "norms": norms, "rows_seen": seen,
            "master": _numpy_tree(eng.get_fp32_params()),
            "m": [np.array(a, copy=True) for a in ms], "v": [np.array(a, copy=True) for a in vs],
            "step": host.step_count,
            "host_bytes": sum(3 * m.nbytes for m in host.master),
            "tier_rank": None if tier is None else tier.rank}


def wire_bytes(rank, preset, model_kw, config, params_np, batch):
    """One training step with the comms logger on: bytes by record name
    (a record's message size, calc_bw_log's convention, times its count)."""
    from deepspeed_tpu_torch import comm as dist

    eng = engine(preset, model_kw, config, params_np)
    eng.train_batch(iter([batch]))  # the first step builds what it builds
    dist.comms_logger.comms_dict.clear()
    dist.configure(enabled=True, prof_all=True, verbose=False)
    try:
        eng.train_batch(iter([batch]))
    finally:
        dist.configure(enabled=False)
    return {name: sum(size * rec[0] for size, rec in recs.items())
            for name, recs in dist.comms_logger.comms_dict.items()}


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

def _replicated_bytes(eng):
    """The bytes of this rank's copies of the leaves that tensor
    parallelism replicates (its lp parameters and fp32 master)."""
    from deepspeed_tpu_torch.utils.tree import tree_leaves

    tp = eng._tp
    keep = [j for j in range(len(tp.dims)) if tp.dims[j] is None]
    out = b""
    for tree in (eng.params, eng.master_params):
        if tree is None:
            continue
        leaves = list(tree_leaves(tree))
        out += b"".join(leaves[j].detach().float().numpy().tobytes() for j in keep)
    return out


def tp_train(rank, preset, model_kw, config, params_np, batches, steps, inject=None):
    """Training over the config's ``mesh`` (a ``model`` axis): losses, the
    global fp32 master after the last step, the gradient norm and the
    bytes of this rank's replicated leaves after every step, the loss
    scale, the skipped steps, this rank's parameter bytes and its
    coordinates. ``inject`` ``(rank, step)``: that rank's loss is infinite
    at that step (fp16)."""
    import torch

    from deepspeed_tpu_torch.utils.tree import tree_leaves

    eng = engine(preset, model_kw, config, params_np)
    if inject is not None:
        inner = eng._apply_fn

        def apply(*a, **k):
            out = inner(*a, **k)
            bad = rank == inject[0] and eng.global_steps == inject[1]
            return out * float("inf") if bad else out

        eng._apply_fn = apply
    losses, norms, repl, scales, states = [], [], [], [], []
    it = itertools.cycle(batches)
    for _ in range(steps):
        losses.append(float(eng.train_batch(it)))
        norms.append(float(eng.get_global_grad_norm()))
        repl.append(_replicated_bytes(eng) if eng._tp is not None else b"")
        scales.append(eng.loss_scale())
        states.append(flat_bytes(_numpy_tree(eng.get_fp32_params())))
    return {"losses": losses, "norms": norms, "repl": repl, "scales": scales,
            "states": states, "master": _numpy_tree(eng.get_fp32_params()),
            "skipped": eng.skipped_steps, "coords": dict(eng.topology.coords),
            "static_state_bytes": eng.static_state_bytes,
            "param_bytes": sum(t.numel() * t.element_size() for t in tree_leaves(eng.params)
                               if isinstance(t, torch.Tensor))}


def tp_refusal(rank, preset, model_kw, config, params_np, **kw):
    """The message of the ``ValueError`` or ``NotImplementedError`` building
    the engine raises (None if it builds)."""
    try:
        engine(preset, model_kw, config, params_np, **kw)
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def tp_layout_is_the_models(rank, preset, model_kw, config, params_np, batch):
    """The loss of the whole tree through a model built here, before and
    after a TP engine of the same model joins this rank to a ``model``
    axis (the TP engine runs a copy at its layout; the model keeps TP 1's),
    then the TP engine's own evaluation loss; and both layouts."""
    import torch

    from deepspeed_tpu_torch.models import build_model, params_from_jax

    model = build_model(preset, **model_kw)
    whole = params_from_jax(params_np)
    ids = {"input_ids": torch.as_tensor(batch["input_ids"])}
    before = float(model.apply(whole, ids, train=False))
    eng = engine(preset, model_kw, config, params_np)
    after = float(model.apply(whole, ids, train=False))
    eng.eval()
    tp_loss = float(eng(ids))
    return {"before": before, "after": after, "tp": tp_loss, "model_tp": model.tp,
            "engine_tp": eng.module.tp, "topology_tp": eng.topology.model_parallel_size}


def tp_checkpoint(rank, preset, model_kw, config, params_np, batches, steps, save_dir=None,
                  load_dir=None):
    """``checkpoint_cycle`` for any mesh: load ``load_dir``'s latest tag (if
    given), the whole state, ``steps`` steps, save to ``save_dir`` (if
    given). The state's master and moments are global (gathered over the
    ZeRO and model axes: collective)."""
    eng = engine(preset, model_kw, config, params_np)
    if load_dir is not None:
        eng.load_checkpoint(load_dir)
    loaded = _tp_state(eng)
    it = itertools.cycle(batches)
    losses = [float(eng.train_batch(it)) for _ in range(steps)]
    if save_dir is not None:
        eng.save_checkpoint(save_dir)
    return {"loaded": loaded, "trained": _tp_state(eng), "losses": losses}


def _tp_state(eng):
    from deepspeed_tpu_torch.utils.tree import tree_leaves

    opt = eng.opt_state
    if eng._dpz is not None:
        m, v = (eng._dp_full(tree_leaves(t), eng._dpz.opt) for t in (opt.m, opt.v))
    else:
        m, v = opt.m, opt.v
    return {"master": _numpy_tree(eng.get_fp32_params()), "m": _numpy_tree(eng._tp_full(m)),
            "v": _numpy_tree(eng._tp_full(v)), "step": int(opt.step),
            "global_steps": eng.global_steps}


def universal_load(rank, preset, model_kw, config, params_np, universal_dir):
    """An engine loading a universal directory: this rank's fp32 master and
    moments (its shards, as the engine holds them) and the step."""
    from deepspeed_tpu_torch.utils.tree import tree_leaves

    eng = engine(preset, model_kw, dict(config, checkpoint={"load_universal": True}), params_np)
    eng.load_checkpoint(universal_dir)
    opt = eng.opt_state
    own = eng.master_params if eng.master_params is not None else eng.params
    return {"master": [t.detach().float().numpy() for t in tree_leaves(own)],
            "m": [t.numpy() for t in tree_leaves(opt.m)],
            "v": [t.numpy() for t in tree_leaves(opt.v)], "step": int(opt.step),
            "global_steps": eng.global_steps,
            "layouts": None if eng._dpz is None else [
                (lay.dim, lay.n, lay.index) for lay in eng._dpz.opt]}


def tp_generate(rank, preset, model_kw, params_np, tp, prompts, gen_kw, set_dir=None,
                forward=False):
    """``init_inference`` at ``tensor_parallel={"tp_size": tp}`` in fp32 on
    the CPU over the whole tree ``params_np`` (or the set in ``set_dir``,
    merged), tokens of ``generate(prompts, **gen_kw)``; with ``forward``
    the logits of ``forward(prompts)`` too. Returns the tokens, the logits
    and this rank's leaves' shapes and dtypes."""
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models import build_model, params_from_jax

    model = build_model(preset, **model_kw)
    params = params_from_jax(params_np)
    if set_dir is not None:
        from deepspeed_tpu_torch.runtime.state_dict_factory import load_mp_merged

        params = load_mp_merged(set_dir, params)
    eng = init_inference(model, tensor_parallel={"tp_size": tp}, dtype="fp32", params=params,
                         device="cpu")
    out = {"tokens": eng.generate(prompts, **gen_kw).numpy(),
           "shapes": {k: tuple(v.shape) for k, v in eng.params["blocks"].items()},
           "dtypes": {k: str(v.dtype) for k, v in eng.params["blocks"].items()},
           "tp": eng.topology.model_parallel_size}
    if forward:
        out["logits"] = eng.forward(prompts).numpy()
    return out
