"""The port's ``BlockedKVCache`` against the JAX package's, on one seeded
sequence of operations: admission with prefix lookup, ensure, copy-on-write,
register (with dedup), over-allocation and rollback, free, cache flush, and
LRU eviction under a small pool. After every operation the block tables,
refcounts, free and LRU lists, content index and counters must be equal."""

import numpy as np
import pytest

from deepspeed_tpu.inference.v2 import ragged_manager as jax_rm
from deepspeed_tpu_torch.inference.v2 import ragged_manager as torch_rm

BS, NUM_BLOCKS, MAX_BLOCKS = 4, 12, 6


class Side:
    """One allocator plus its live descriptors, driven like the engine."""

    def __init__(self, rm):
        self.rm = rm
        self.cache = rm.BlockedKVCache(NUM_BLOCKS, BS, MAX_BLOCKS, prefix_cache=True)
        self.descs = {}

    def admit(self, uid, prompt):
        d = self.rm.SequenceDescriptor(uid=uid, slot=uid)
        self.descs[uid] = d
        skipped = self.cache.lookup(d, prompt)
        d.history = list(prompt[:skipped])
        d.seen_tokens = skipped
        d.pending = list(prompt[skipped:])

    def advance(self, uid, new_tokens, take):
        d = self.descs[uid]
        d.pending.extend(new_tokens)
        take = min(take, len(d.pending))
        self.cache.ensure(d, d.seen_tokens + take)
        first = d.seen_tokens // BS
        last = min((d.seen_tokens + take - 1) // BS, len(d.blocks) - 1)
        for j in range(first, last + 1):
            if self.cache.refcount(d.blocks[j]) > 1:
                self.cache.copy_on_write(d, j)
        d.history.extend(d.pending[:take])
        del d.pending[:take]
        d.seen_tokens += take
        self.cache.register(d)

    def reserve(self, uid, extra):
        d = self.descs[uid]
        self.cache.ensure(d, d.seen_tokens + extra)

    def rollback(self, uid):
        d = self.descs[uid]
        return self.cache.rollback(d, d.seen_tokens)

    def free(self, uid):
        self.cache.free(self.descs.pop(uid))

    def flush_cache(self):
        self.cache.flush_cache()

    def snapshot(self):
        c = self.cache
        return {
            "free": list(c._free), "ref": dict(c._ref), "lru": list(c._lru),
            "index": dict(c._index), "meta": dict(c._meta),
            "children": {k: sorted(v) for k, v in c._children.items()},
            "stats": dict(c.stats), "free_blocks": c.free_blocks,
            "cached_blocks": c.cached_blocks,
            "descs": {u: (list(d.blocks), d.seen_tokens, list(d.history),
                          list(d.pending), d.n_indexed, c.table_row(d).tolist())
                      for u, d in self.descs.items()},
        }


def apply(side, op, args):
    try:
        return ("ok", getattr(side, op)(*args))
    except (side.rm.PoolExhaustedError, side.rm.ContextOverflowError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replay_matches_jax_block_manager(seed):
    rng = np.random.default_rng(seed)
    # prompts share prefixes so lookups hit, dedup and copy-on-write happen
    stems = [rng.integers(0, 3, 12).tolist() for _ in range(3)]
    jax_side, torch_side = Side(jax_rm), Side(torch_rm)
    next_uid = 0
    ops_seen = set()
    for _ in range(400):
        live = sorted(jax_side.descs)
        r = rng.random()
        if r < 0.2 or not live:
            stem = stems[rng.integers(len(stems))]
            prompt = stem[:rng.integers(1, 13)] + rng.integers(0, 3, rng.integers(0, 3)).tolist()
            op, args = "admit", (next_uid, prompt)
            next_uid += 1
        elif r < 0.55:
            op, args = "advance", (int(rng.choice(live)),
                                   rng.integers(0, 3, rng.integers(0, 3)).tolist(),
                                   int(rng.integers(1, 9)))
        elif r < 0.65:
            op, args = "reserve", (int(rng.choice(live)), int(rng.integers(1, 9)))
        elif r < 0.75:
            op, args = "rollback", (int(rng.choice(live)),)
        elif r < 0.97:
            op, args = "free", (int(rng.choice(live)),)
        else:
            op, args = "flush_cache", ()
        got_j = apply(jax_side, op, args)
        got_t = apply(torch_side, op, args)
        assert got_t == got_j, (op, args)
        ops_seen.add(op if got_j[0] == "ok" else got_j[0])
        assert torch_side.snapshot() == jax_side.snapshot(), (op, args)
        torch_side.cache.check_invariants(torch_side.descs.values())
    stats = torch_side.cache.stats
    assert stats["hits"] and stats["cow_copies"] and stats["evicted_blocks"]
    assert {"admit", "advance", "reserve", "rollback", "free",
            "PoolExhaustedError"} <= ops_seen
