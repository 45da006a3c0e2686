"""ZeRO-2/3 sharded optimizer tier (counterpart of ``deepspeed_tpu/runtime/zero/sharded.py``).

The compute-dtype parameters stay on the card, so the forward and backward
are the stage-0 ones, while the fp32 master and Adam moments live in host
RAM partitioned by a :class:`~.partition.PartitionPlan`: rank ``r`` owns the
flat range ``[bounds[r], bounds[r+1])`` of every leaf. One step:

  reduce-scatter  -> each leaf's gradient pulled to the host once (streamed
                     in chunks, ``offload.py``); each rank reads its slice
  sharded update  -> the C++ CPU Adam per (leaf, rank) slice; elementwise,
                     so bitwise the update of the whole leaf
  all-gather      -> the engine casts each updated chunk to the compute
                     dtype and starts its upload, which runs while the
                     next chunk computes

The plan has one shard a data-parallel rank. In one process (``rank``
None) the tier holds every leaf whole and steps every rank's slice in
turn, as the JAX tier does; one rank of a process group (``rank`` r) holds
and steps only its own slices, ``[bounds[r], bounds[r+1])`` of each leaf,
so the ranks' processes together do the one-process loop. A sharded
checkpoint writes one file a rank (``shard_state_dict``).

Stage 3 adds parameter residency in the engine (``stage3_*`` knobs): after
each step the largest non-persistent leaves are released to a host cache of
their compute-dtype cast until the live count fits ``max_live_parameters``,
a prefetch window re-uploads ``prefetch_bucket_size`` bytes, and the next
forward uploads the rest. Residency moves exact bytes, so it never changes
the math.
"""

from typing import Dict, List

import numpy as np

from .offload import OffloadedAdamState, host_f32
from .partition import PartitionPlan


class ZeroShardedTier(OffloadedAdamState):
    """Host-RAM tier holding the sharded fp32 master + Adam moments.

    With ``nvme_store`` (the TransferEngine's :class:`NVMeStore`) the
    moments live on NVMe under the manifest-last + CRC protocol, one
    ``(2, leaf_size)`` [m; v] record a leaf with a 2-slot ring: each leaf's
    moments stream disk -> RAM -> disk around its update, and a corrupt
    newest record falls back one slot (``nvme.counters['ring_fallbacks']``).
    Host RAM then holds only the fp32 master."""

    def __init__(self, leaves: List, plan: PartitionPlan, stage: int = 2, nvme_store=None,
                 rank=None):
        self.rank = rank
        if rank is not None:
            leaves = [host_f32(l).reshape(-1)[lo:hi] for l, (lo, hi)
                      in zip(leaves, plan.slices(rank))]
        super().__init__(leaves, device="cpu")
        self.plan = plan
        self.stage = int(stage)
        #: train/zero/* counters, read through engine.zero_metrics()
        self.counters: Dict[str, int] = {
            "gathers": 0,             # param all-gathers (H2D uploads of a leaf)
            "reduce_scatters": 0,     # gradient pulls (one a leaf a step)
            "prefetch_hits": 0,       # stage-3 forwards served by the window
            "offload_bytes_in": 0,    # gradient bytes, as fp32
            "offload_bytes_out": 0,   # H2D bytes (updated params, compute dtype)
        }
        self.nvme_store = nvme_store
        if nvme_store is not None:
            for j in range(len(self.master)):
                nvme_store.save(self._nvme_key(j), np.stack([self.m[j], self.v[j]]))
            self.m = self.v = None

    def _nvme_key(self, j: int) -> str:
        return f"optshard_{j}" if self.rank is None else f"optshard_r{self.rank}_{j}"

    def _moments(self, j: int):
        """Leaf ``j``'s (m, v) views plus the backing [m; v] buffer to save
        back (None when the moments are RAM-resident)."""
        if self.nvme_store is None:
            return self.m[j], self.v[j], None
        buf = self.nvme_store.load(self._nvme_key(j)).numpy()  # dstpu-lint: ignore[DSTPU001]
        return buf[0], buf[1], buf

    def _save_moments(self, j: int, buf) -> None:
        if buf is not None:
            self.nvme_store.save(self._nvme_key(j), buf)

    def _spans(self, j: int, n: int):
        """The plan's per-rank slices of leaf ``j``: ``step_flat`` runs per
        (leaf, rank), elementwise, so bitwise the update of the whole leaf.
        One rank of a group holds its slice alone: one span."""
        if self.rank is not None:
            return [(0, n)]
        b = self.plan.bounds[j]
        return list(zip(b[:-1], b[1:]))

    # ------------------------------------------------------------------
    def adam_step(self, opt, grads: List, *args, **kwargs) -> List[np.ndarray]:
        """The base class's step over the plan's slices; each leaf's
        gradient is pulled to the host once (its reduce-scatter)."""
        for p in self.master:
            self.counters["reduce_scatters"] += 1
            self.counters["offload_bytes_in"] += 4 * p.size
        return super().adam_step(opt, grads, *args, **kwargs)

    # ------------------------------------------------------------------
    def state_dict(self) -> Dict:
        """Snapshot (copies) of master + moments; NVMe moments stream up one
        leaf at a time."""
        if self.nvme_store is None:
            return super().state_dict()
        master = [np.array(p, copy=True) for p in self.master]
        m_out, v_out = [], []
        for j in range(len(self.master)):
            m, v, _ = self._moments(j)
            m_out.append(np.array(m, copy=True))
            v_out.append(np.array(v, copy=True))
        return {"master": master, "m": m_out, "v": v_out, "step": self.step_count}

    def _own(self, j: int, full) -> np.ndarray:
        """Leaf ``j``'s whole flat fp32 values cut to what this tier holds."""
        a = np.asarray(full, np.float32).reshape(-1)
        if self.rank is None:
            return a
        lo, hi = self.plan.bounds[j][self.rank], self.plan.bounds[j][self.rank + 1]
        return a[lo:hi]

    def assign_master(self, j: int, full) -> None:
        """Leaf ``j``'s master from its whole values."""
        self.master[j].reshape(-1)[...] = self._own(j, full)

    def load_state_dict(self, sd: Dict):
        """``sd`` holds whole leaves (``master``, ``m``, ``v``, ``step``)."""
        if self.rank is not None:
            sd = {"step": sd["step"],
                  **{k: [self._own(j, a) for j, a in enumerate(sd[k])]
                     for k in ("master", "m", "v")}}
        if self.nvme_store is None:
            return super().load_state_dict(sd)
        self.step_count = int(sd["step"])
        for j, p in enumerate(sd["master"]):
            self.master[j][...] = np.asarray(p, np.float32).reshape(self.master[j].shape)
        for j in range(len(self.master)):
            self.nvme_store.save(self._nvme_key(j), np.stack([
                np.asarray(sd["m"][j], np.float32).reshape(-1),
                np.asarray(sd["v"][j], np.float32).reshape(-1)]))

    # ------------------------------------------------------------------
    def shard_state_dict(self, rank: int) -> Dict:
        """Rank ``rank``'s slice of the moments: one sharded-checkpoint file.
        The fp32 master is not duplicated here: the checkpoint's module tree
        carries it. One rank of a group gives its own file only."""
        if self.rank is not None and rank != self.rank:
            raise ValueError(f"this tier holds rank {self.rank}'s slices, not rank {rank}'s")
        out_m, out_v = [], []
        for j, (lo, hi) in enumerate(self.plan.slices(rank)):
            if self.rank is not None:
                lo, hi = 0, hi - lo
            m, v, _ = self._moments(j)
            out_m.append(np.array(m[lo:hi], copy=True))
            out_v.append(np.array(v[lo:hi], copy=True))
        return {"rank": int(rank), "num_shards": self.plan.num_shards, "m": out_m, "v": out_v}

    def full_moments(self):
        """Every leaf's (m, v) as flat fp32 arrays (views of the RAM buffers,
        or copies read from NVMe): whole in one process, this rank's slices
        in a group."""
        ms, vs = [], []
        for j in range(len(self.master)):
            m, v, _ = self._moments(j)
            ms.append(m)
            vs.append(v)
        return ms, vs

    def load_full_moments(self, m_full: List, v_full: List, step: int):
        """Scatter consolidated full-leaf moments back into the tier (the
        per-rank views alias the full buffers; NVMe leaves write back)."""
        self.step_count = int(step)
        for j in range(len(self.master)):
            mf, vf = self._own(j, m_full[j]), self._own(j, v_full[j])
            if self.nvme_store is None:
                self.m[j][...] = mf
                self.v[j][...] = vf
            else:
                self.nvme_store.save(self._nvme_key(j), np.stack([mf, vf]))

    def shard_bytes(self, rank: int = 0) -> int:
        """Optimizer-state bytes rank ``rank`` owns (master + m + v, fp32)."""
        return 3 * self.plan.shard_bytes(rank if self.rank is None else self.rank, itemsize=4)
