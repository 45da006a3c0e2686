"""ZeRO++ and the 1-bit optimizers across two gloo ranks, on the CPU.

- qwZ (int8 stage-3 weight gathers), qgZ (int8 gradient all-to-all) and
  both, at stage 3 on the JAX ZeRO++ test's micro gpt2 (vocab 128, hidden
  64, 2 layers, S 32, a global batch of 8): every step's loss within that
  test's bound of the unquantized run's (``tests/unit/test_zeropp.py:57-65``:
  ``|l_q - l| < 0.05 |l| + 0.05``), and the curve trains;
- the wire, from the comms logger over one bf16 stage-3 step of a wider
  gpt2 (hidden 256, vocab 1024): the qwZ weight gathers move under 0.65 of
  the bf16 gathers' bytes, and a qgZ + qwZ step under 0.45 of the
  unquantized step's collective bytes (the claims of
  ``tests/unit/test_zeropp_wire.py:72,82``);
- ``OnebitAdam``, ``ZeroOneAdam`` (stage 1) and ``OnebitLamb`` (stage 0)
  through ``freeze_step`` against the JAX engine at the same data degree: a
  JAX subprocess with 2 host devices and ``{"data": 2}``, so both split the
  batch over two ranks and their sign codes cover the same local
  gradients. Before the freeze the losses agree at rtol 1e-5 (full
  precision, as ``test_torch_zero_multirank.py``); after it a sign flips
  wherever the two packages' error-corrected gradient is within its
  last-bit difference of zero, and such an element's momentum moves by the
  tensor's mean magnitude, which its frozen variance may scale up: so the
  compressed phase is held at rtol 1e-3 on losses, and the masters at atol
  1e-4 and rtol 1e-4 (the last position's embedding row has a zero
  gradient until the freeze, so a variance of 0: its compressed updates
  divide the momentum by eps, the row runs to ~4e2, and a last-bit
  difference of the tensor's mean-magnitude scale shows there at ~2e-5)
  except for at most 0.1% of the elements of a leaf (at these settings up
  to 10 of 32768), which stay within 50 lr (5e-2: three compressed steps
  of a momentum over a frozen variance of near zero).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.torch_multirank import Ranks, train, wire_bytes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESET = "gpt2-125m"
MODEL_KW = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=32)
WIDE_KW = dict(vocab_size=1024, hidden_size=256, num_layers=2, num_heads=4, max_seq_len=32)


def _batches(vocab=128, n=1, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, (8, 32)).astype(np.int32)} for _ in range(n)]


def _params(model_kw):
    import torch

    from deepspeed_tpu_torch.models import build_model, params_to_numpy

    return params_to_numpy(build_model(PRESET, **model_kw).init_params(
        torch.Generator().manual_seed(0)))


def _config(stage=3, optimizer=None, **zero):
    return {"train_batch_size": 8, "steps_per_print": 0, "seed": 0,
            "optimizer": optimizer or {"type": "adamw", "params": {"lr": 1e-3}},
            "zero_optimization": dict({"stage": stage,
                                       "stage3_param_persistence_threshold": 0}, **zero)}


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    r = Ranks(2, tmp_path_factory.mktemp("zeropp"))
    yield r
    r.close()


@pytest.mark.parametrize("quant", [{"zero_quantized_weights": True},
                                   {"zero_quantized_gradients": True},
                                   {"zero_quantized_weights": True,
                                    "zero_quantized_gradients": True}],
                         ids=["qwz", "qgz", "qwz-qgz"])
def test_quantized_stage3_close_to_unquantized_and_trains(ranks2, quant):
    params, batches = _params(MODEL_KW), _batches()
    ref = ranks2.run(train, PRESET, MODEL_KW, _config(), params, batches, 6)[0]["losses"]
    got = ranks2.run(train, PRESET, MODEL_KW, _config(**quant), params, batches, 6)
    assert got[0]["states"] == got[1]["states"]
    losses = got[0]["losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    for lq, lr in zip(losses, ref):
        assert abs(lq - lr) < 0.05 * abs(lr) + 0.05, (losses, ref)


def test_wire_bytes_hold_the_zeropp_claims(ranks2):
    params, batch = _params(WIDE_KW), _batches(1024)[0]

    def step(**quant):
        cfg = _config(**quant)
        cfg["bf16"] = {"enabled": True}
        return ranks2.run(wire_bytes, PRESET, WIDE_KW, cfg, params, batch)[0]

    base, qwz, both = step(), step(zero_quantized_weights=True), step(
        zero_quantized_weights=True, zero_quantized_gradients=True)
    gathers = ("param_gather", "qwz_codes", "qwz_scales")
    gb, gq = (sum(v for k, v in d.items() if k in gathers) for d in (base, qwz))
    assert "qwz_codes" in qwz and "param_gather" not in qwz
    assert gq < 0.65 * gb, (gq, gb)
    assert "qgz_codes" in both and "grad_reduce_scatter" not in both
    assert sum(both.values()) < 0.45 * sum(base.values()), (both, base)


ONEBIT = [("OnebitAdam", 1), ("ZeroOneAdam", 1), ("OnebitLamb", 0)]
FREEZE, STEPS = 2, 5

_JAX_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
sys.path.insert(0, sys.argv[1])
import deepspeed_tpu
from deepspeed_tpu.comm import topology
from deepspeed_tpu.models import build_model
args = json.loads(sys.argv[2])
params = dict(np.load(args["params"], allow_pickle=True))["tree"].item()
out = {}
for name, stage in args["runs"]:
    topology.reset_topology()
    cfg = dict(args["config"], zero_optimization={"stage": stage},
               optimizer={"type": name, "params": {"lr": 1e-3, "freeze_step": args["freeze"]}},
               mesh={"data": 2})
    eng = deepspeed_tpu.initialize(model=build_model(args["preset"], **args["model"]),
                                   model_parameters=params, config=cfg)[0]
    batch = {"input_ids": np.asarray(args["batch"], np.int32)}
    losses = [float(eng.train_batch(iter([batch]))) for _ in range(args["steps"])]
    assert eng._ef_errors is not None, name  # the compressed phase ran
    leaves = [np.asarray(x).tolist() for x in jax.tree.leaves(eng.params)]
    out[name] = {"losses": losses, "params": leaves}
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def jax_onebit_proc(tmp_path_factory):
    """The JAX side of the 1-bit tests, started with the module so that it
    runs beside the tests before them (its jit compiles take most of it)."""
    d = tmp_path_factory.mktemp("onebit")
    params = _params(MODEL_KW)
    np.savez(d / "params.npz", tree=np.array(params, dtype=object))
    args = {"params": str(d / "params.npz"), "runs": ONEBIT, "freeze": FREEZE,
            "steps": STEPS, "preset": PRESET, "model": MODEL_KW,
            "config": {"train_batch_size": 8, "steps_per_print": 0, "seed": 0},
            "batch": _batches()[0]["input_ids"].tolist()}
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", _JAX_SCRIPT, REPO, json.dumps(args)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, cwd=REPO)
    yield params, proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate(timeout=30)


@pytest.fixture(scope="module")
def jax_onebit(jax_onebit_proc):
    params, proc = jax_onebit_proc
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-4000:]
    return params, json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("name,stage", ONEBIT)
def test_onebit_optimizers_match_jax_through_freeze(ranks2, jax_onebit, name, stage):
    params, want = jax_onebit
    cfg = _config(stage, optimizer={"type": name, "params": {"lr": 1e-3,
                                                             "freeze_step": FREEZE}})
    cfg["zero_optimization"] = {"stage": stage}
    got = ranks2.run(train, PRESET, MODEL_KW, cfg, params, _batches(), STEPS)
    assert got[0]["states"] == got[1]["states"]
    losses, jl = got[0]["losses"], want[name]["losses"]
    np.testing.assert_allclose(losses[:FREEZE + 1], jl[:FREEZE + 1], rtol=1e-5)
    np.testing.assert_allclose(losses, jl, rtol=1e-3)
    from deepspeed_tpu_torch.utils.tree import tree_leaves

    for a, b in zip(tree_leaves(got[0]["master"]), want[name]["params"]):
        b = np.asarray(b, np.float32)
        diff = np.abs(a - b)
        off = diff > 1e-4 + 1e-4 * np.abs(b)
        assert off.mean() <= 1e-3 and (diff[off].max(initial=0.0) < 5e-2), off.sum()
    assert losses[-1] < losses[0]
