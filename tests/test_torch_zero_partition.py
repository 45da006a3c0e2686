"""The ZeRO spec rules: the port's ``runtime/zero/partition.py`` against the JAX package's.

For every leaf and every stage the port's spec (a tuple of entries) equals
the JAX ``PartitionSpec``'s entries, on the micro llama's and micro gpt2's
trees and on llama-7b's leaf shapes (``jax.eval_shape``, nothing drawn), at
ZeRO degrees 1, 2, 4 and 8 with hpz 1 and 2, and with the stage-3
persistence threshold at 0 and at its default. The JAX rules read a mesh
over that many of the 8 virtual devices; the port's a rank topology of
that many ranks, no process group. Then this rank's shard of each leaf
(``LeafShard``) reassembles the leaf over the ranks, and ``zero.Init``'s
``initialize_params`` keeps exactly that shard.
"""

import functools

import jax
import pytest
import torch

from deepspeed_tpu_torch.comm.topology import MeshTopology
from deepspeed_tpu_torch.runtime.zero import partition as tpart
from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
from deepspeed_tpu_torch.runtime.zero.data_parallel import LeafShard
from deepspeed_tpu_torch.utils.tree import tree_leaves

MODELS = {
    "llama-micro": ("llama-tiny", dict(vocab_size=512, hidden_size=64, num_layers=2,
                                       num_heads=4, num_kv_heads=2, intermediate_size=128,
                                       max_seq_len=32)),
    "gpt2-micro": ("gpt2-125m", dict(vocab_size=128, hidden_size=64, num_layers=2,
                                     num_heads=4, max_seq_len=32)),
    "llama-7b": ("llama-7b", dict(num_layers=2)),
}
MESHES = [(1, 1), (2, 1), (4, 1), (8, 1), (1, 2), (2, 2), (4, 2)]  # (data, hpz)
DEFAULT_THRESHOLD = DeepSpeedZeroConfig().param_persistence_threshold


@functools.lru_cache(maxsize=None)
def _shapes(name):
    """The JAX model's leaf shapes (ShapeDtypeStructs), nothing materialised."""
    from deepspeed_tpu.models import build_model

    preset, kw = MODELS[name]
    model = build_model(preset, **kw)
    return jax.eval_shape(model.init_params, jax.random.PRNGKey(0))


def _topologies(data, hpz):
    from deepspeed_tpu.comm.topology import MeshTopology as JaxTopology

    n = data * hpz
    return (JaxTopology(data=data, hpz=hpz, devices=jax.devices()[:n]),
            MeshTopology(data=data, hpz=hpz, world_size=n))


def _pairs(jax_specs, port_specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jax_specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    port = dict(_port_paths(port_specs))
    assert len(flat) == len(port)
    for path, spec in flat:
        key = tuple(k.key for k in path)
        yield key, tuple(spec), port[key]


def _port_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _port_paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("data,hpz", MESHES, ids=[f"data{d}-hpz{h}" for d, h in MESHES])
@pytest.mark.parametrize("name", list(MODELS))
def test_stage_specs_equal_jax(name, data, hpz):
    from deepspeed_tpu.runtime.zero import partition as jpart

    shapes = _shapes(name)
    jtopo, ttopo = _topologies(data, hpz)
    assert ttopo.data_parallel_size == jtopo.data_parallel_size
    for stage in range(4):
        for threshold in (0, DEFAULT_THRESHOLD):
            got = {
                "param": (jpart.stage_param_specs(shapes, stage, jtopo,
                                                  persistence_threshold=threshold),
                          tpart.stage_param_specs(shapes, stage, ttopo,
                                                  persistence_threshold=threshold)),
                "grad": (jpart.stage_grad_specs(shapes, stage, jtopo),
                         tpart.stage_grad_specs(shapes, stage, ttopo)),
                "opt": (jpart.stage_opt_specs(shapes, stage, jtopo),
                        tpart.stage_opt_specs(shapes, stage, ttopo)),
            }
            for kind, (js, ts) in got.items():
                for key, want, have in _pairs(js, ts):
                    assert have == want, (kind, stage, threshold, key, have, want)
    assert tpart.batch_spec(ttopo) == tuple(jpart.batch_spec(jtopo))


@pytest.mark.parametrize("data,hpz", [(2, 1), (4, 1), (2, 2)])
def test_rank_shards_reassemble_the_leaf(data, hpz):
    """Every rank's chunk under the stage-3 and optimizer specs, put back
    together in group-rank order along the sharded dimension, is the leaf;
    ``initialize_params`` under ``zero.Init`` keeps exactly the rank's
    chunk, and the chunks' bytes are the leaf's over the degree."""
    from deepspeed_tpu_torch import zero
    from deepspeed_tpu_torch.models import build_model

    preset, kw = MODELS["llama-micro"]
    model = build_model(preset, **kw)
    whole = model.init_params(torch.Generator().manual_seed(3))
    n = data * hpz
    for stage_specs in (tpart.stage_param_specs, tpart.stage_opt_specs):
        specs = stage_specs(whole, 3, MeshTopology(data=data, hpz=hpz, world_size=n))
        for j, (leaf, spec) in enumerate(zip(tree_leaves(whole), _spec_leaves(specs))):
            topos = [MeshTopology(data=data, hpz=hpz, world_size=n, rank=r) for r in range(n)]
            lays = [LeafShard(spec, t) for t in topos]
            if not lays[0].sharded:
                continue
            by_index = {lay.index: lay.take(leaf) for lay in lays}
            assert sorted(by_index) == list(range(lays[0].n))
            back = torch.cat([by_index[i] for i in range(lays[0].n)], dim=lays[0].dim)
            assert torch.equal(back, leaf), (stage_specs.__name__, j)
    with zero.Init(dtype=torch.bfloat16):
        for r in range(n):
            topo = MeshTopology(data=data, hpz=hpz, world_size=n, rank=r)
            got = zero.initialize_params(model, torch.Generator().manual_seed(3), stage=3,
                                         topology=topo)
            specs = tpart.stage_param_specs(whole, 3, topo)
            want = [LeafShard(s, topo).take(t).to(torch.bfloat16)
                    for t, s in zip(tree_leaves(whole), _spec_leaves(specs))]
            assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), want))
            sharded = [LeafShard(s, topo).sharded for s in _spec_leaves(specs)]
            degree = hpz if hpz > 1 else data  # hpZ: weights shard over hpz alone
            assert sum(a.numel() for a, s in zip(tree_leaves(got), sharded) if s) * degree \
                == sum(t.numel() for t, s in zip(tree_leaves(whole), sharded) if s)


def _spec_leaves(specs):
    if isinstance(specs, dict):
        for k in sorted(specs):
            yield from _spec_leaves(specs[k])
    else:
        yield specs
