"""The port's sparsity configs give the JAX package's layouts, element for
element, for each of the five families across their fields (both attention
modes, per-head layouts, horizontal globals, several global patterns,
random blocks drawn from the same seeded numpy generator)."""

import numpy as np
import pytest

from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as port

CASES = [
    ("DenseSparsityConfig", dict(num_heads=2, block=16)),
    ("FixedSparsityConfig", dict(num_heads=2, block=16)),
    ("FixedSparsityConfig", dict(num_heads=4, block=16, num_local_blocks=3, num_global_blocks=2,
                                 attention="unidirectional")),
    ("FixedSparsityConfig", dict(num_heads=4, block=32, different_layout_per_head=True,
                                 num_different_global_patterns=3, num_local_blocks=4,
                                 horizontal_global_attention=True)),
    ("FixedSparsityConfig", dict(num_heads=3, block=16, different_layout_per_head=True,
                                 num_different_global_patterns=2, attention="unidirectional")),
    ("BigBirdSparsityConfig", dict(num_heads=2, block=16)),
    ("BigBirdSparsityConfig", dict(num_heads=3, block=16, num_random_blocks=2,
                                   num_sliding_window_blocks=5, num_global_blocks=2, seed=7,
                                   attention="unidirectional")),
    ("BSLongformerSparsityConfig", dict(num_heads=2, block=16)),
    ("BSLongformerSparsityConfig", dict(num_heads=2, block=16, num_sliding_window_blocks=5,
                                        global_block_indices=[1, 6],
                                        global_block_end_indices=[3, 7],
                                        attention="unidirectional")),
    ("VariableSparsityConfig", dict(num_heads=2, block=16)),
    ("VariableSparsityConfig", dict(num_heads=3, block=16, num_random_blocks=2,
                                    local_window_blocks=[1, 2, 3], global_block_indices=[0, 5],
                                    seed=11, attention="unidirectional")),
]


@pytest.mark.parametrize("seq_len", [256, 512])
@pytest.mark.parametrize("name,kw", CASES)
def test_layouts_equal_the_jax_package(name, kw, seq_len):
    ref_mod = pytest.importorskip("deepspeed_tpu.ops.sparse_attention.sparsity_config")
    want = getattr(ref_mod, name)(**kw).make_layout(seq_len)
    got = getattr(port, name)(**kw).make_layout(seq_len)
    assert got.dtype == want.dtype == np.bool_
    np.testing.assert_array_equal(got, want)


def test_fields_and_defaults_equal_the_jax_package():
    import dataclasses

    ref_mod = pytest.importorskip("deepspeed_tpu.ops.sparse_attention.sparsity_config")
    for name in ("SparsityConfig", "FixedSparsityConfig", "BigBirdSparsityConfig",
                 "BSLongformerSparsityConfig", "VariableSparsityConfig"):
        fields = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]  # noqa: E731
        assert fields(getattr(port, name)) == fields(getattr(ref_mod, name)), name


def test_indivisible_seq_rejected():
    with pytest.raises(ValueError, match="not divisible"):
        port.FixedSparsityConfig(num_heads=2, block=16).make_layout(100)
