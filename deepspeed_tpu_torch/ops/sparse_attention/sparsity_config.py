"""Block-sparse attention patterns (counterpart of ``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``).

Layout generators over a (num_blocks x num_blocks) block grid, on the host
in numpy, with the JAX package's fields, defaults and layouts:
``DenseSparsityConfig``, ``FixedSparsityConfig``, ``BigBirdSparsityConfig``,
``BSLongformerSparsityConfig``, ``VariableSparsityConfig``. BigBird and
Variable draw their random blocks from ``np.random.default_rng(seed)``, so a
seed gives the same layout bit for bit in both packages. A layout is a
boolean (heads, nb, nb) block mask that ``SparseSelfAttention`` turns into
the block lists of the block-sparse kernels or into an additive mask.
"""

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class SparsityConfig:
    num_heads: int
    block: int = 16
    different_layout_per_head: bool = False

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block:
            raise ValueError(f"seq_len {seq_len} not divisible by block {self.block}")
        n = seq_len // self.block
        return np.zeros((self.num_heads, n, n), bool)

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[...] = True
        return layout


@dataclass
class FixedSparsityConfig(SparsityConfig):
    """reference ``FixedSparsityConfig``: local blocks + periodic global blocks."""

    num_local_blocks: int = 4
    num_global_blocks: int = 1
    attention: str = "bidirectional"  # or "unidirectional"
    horizontal_global_attention: bool = False
    num_different_global_patterns: int = 1

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        for h in range(self.num_heads):
            # local windows
            for i in range(0, n, self.num_local_blocks):
                end = min(i + self.num_local_blocks, n)
                layout[h, i:end, i:end] = True
            # global columns: last block of each local window attends/attended
            pat = h % self.num_different_global_patterns if \
                self.different_layout_per_head else 0
            for i in range(0, n, self.num_local_blocks):
                g0 = min(i + self.num_local_blocks, n) - 1 - pat
                g0 = max(g0, i)
                for g in range(g0, min(g0 + self.num_global_blocks, n)):
                    layout[h, :, g] = True
                    if self.horizontal_global_attention:
                        layout[h, g, :] = True
        if self.attention == "unidirectional":
            tril = np.tril(np.ones((n, n), bool))
            layout &= tril[None]
        return layout


@dataclass
class BigBirdSparsityConfig(SparsityConfig):
    """reference ``BigBirdSparsityConfig``: random + sliding window + global."""

    num_random_blocks: int = 1
    num_sliding_window_blocks: int = 3
    num_global_blocks: int = 1
    attention: str = "bidirectional"
    seed: int = 0

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        rng = np.random.default_rng(self.seed)
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_heads):
            for i in range(n):
                layout[h, i, max(0, i - w):min(n, i + w + 1)] = True  # window
                picks = rng.choice(n, size=min(self.num_random_blocks, n),
                                   replace=False)
                layout[h, i, picks] = True  # random
            g = min(self.num_global_blocks, n)
            layout[h, :g, :] = True
            layout[h, :, :g] = True
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones((n, n), bool))[None]
        return layout


@dataclass
class BSLongformerSparsityConfig(SparsityConfig):
    """reference ``BSLongformerSparsityConfig``: sliding window + chosen global rows."""

    num_sliding_window_blocks: int = 3
    global_block_indices: Optional[List[int]] = None
    global_block_end_indices: Optional[List[int]] = None
    attention: str = "bidirectional"

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        starts = self.global_block_indices or [0]
        ends = self.global_block_end_indices or [s + 1 for s in starts]
        for h in range(self.num_heads):
            for i in range(n):
                layout[h, i, max(0, i - w):min(n, i + w + 1)] = True
            for s, e in zip(starts, ends):
                layout[h, s:e, :] = True
                layout[h, :, s:e] = True
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones((n, n), bool))[None]
        return layout


@dataclass
class VariableSparsityConfig(SparsityConfig):
    """reference ``VariableSparsityConfig``: variable local windows + globals."""

    num_random_blocks: int = 0
    local_window_blocks: Optional[List[int]] = None
    global_block_indices: Optional[List[int]] = None
    attention: str = "bidirectional"
    seed: int = 0

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[1]
        rng = np.random.default_rng(self.seed)
        windows = self.local_window_blocks or [4]
        for h in range(self.num_heads):
            i = 0
            wi = 0
            while i < n:
                wsize = windows[min(wi, len(windows) - 1)]
                end = min(i + wsize, n)
                layout[h, i:end, i:end] = True
                i = end
                wi += 1
            for g in (self.global_block_indices or [0]):
                if g < n:
                    layout[h, :, g] = True
                    layout[h, g, :] = True
            for i in range(n):
                if self.num_random_blocks:
                    picks = rng.choice(n, size=min(self.num_random_blocks, n),
                                       replace=False)
                    layout[h, i, picks] = True
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones((n, n), bool))[None]
        return layout
