"""The port's optimizer, lr schedules and loss scaler against the JAX package's.

Same numpy inputs to both. ``FusedAdam`` (AdamW and classic Adam, with and
without bias correction) over 5 steps: parameters and moments at rtol 1e-6
(the same fp32 formula in the same order; the ops may round differently in
the last bit). Every lr schedule over 100 steps: exactly equal (host
Python floats in both). The dynamic loss scaler on a fixed overflow
sequence: exactly equal state after every update.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.optimizers import FusedAdam, build_optimizer
from deepspeed_tpu_torch.runtime import lr_schedules as tls
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import (DynamicLossScaler, LossScaler,
                                                          has_overflow)


def _tree(rng, scale=1.0):
    return {"blocks": {"w": (scale * rng.standard_normal((3, 8, 16))).astype(np.float32),
                       "b": (scale * rng.standard_normal((3, 16))).astype(np.float32)},
            "wte": (scale * rng.standard_normal((32, 8))).astype(np.float32)}


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v.copy())
            for k, v in tree.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v.detach().numpy() if torch.is_tensor(v) else v)
    return out


@pytest.mark.parametrize("adam_w_mode,bias_correction",
                         [(True, True), (False, True), (True, False)])
def test_fused_adam_matches_jax_over_5_steps(adam_w_mode, bias_correction):
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.ops.optimizers import FusedAdam as JaxFusedAdam

    kw = dict(lr=1e-2, betas=(0.9, 0.95), eps=1e-6, weight_decay=0.1,
              adam_w_mode=adam_w_mode, bias_correction=bias_correction)
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng, 0.1) for _ in range(5)]
    jopt, topt = JaxFusedAdam(**kw), FusedAdam(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = _torch(params)
    ts = topt.init(tp)
    for i, g in enumerate(grads):
        lr = 1e-2 * (i + 1) / 5
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp, jnp.float32(lr))
        tp, ts = topt.update(_torch(g), ts, tp, lr)
        assert int(ts.step) == int(js.step) == i + 1
        for name, want in (("p", jp), ("m", js.m), ("v", js.v)):
            got = {"p": tp, "m": ts.m, "v": ts.v}[name]
            for key, a in _flat(jax.tree.map(np.asarray, want)).items():
                np.testing.assert_allclose(_flat(got)[key], a, rtol=1e-6, atol=1e-9,
                                           err_msg=f"{name} {key} step {i + 1}")


def test_build_optimizer_ports_adam_and_raises_for_the_rest():
    opt = build_optimizer("AdamW", {"lr": 3e-4, "weight_decay": 0.1})
    assert isinstance(opt, FusedAdam) and opt.adam_w_mode and opt.lr == 3e-4
    assert not build_optimizer("adam", {"adam_w_mode": False}).adam_w_mode
    for name in ("lamb", "lion", "sgd", "adagrad"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 17"):
            build_optimizer(name, {})


SCHEDULES = [
    ("WarmupLR", dict(warmup_min_lr=0.0, warmup_max_lr=3e-4, warmup_num_steps=2)),
    ("WarmupLR", dict(warmup_min_lr=1e-5, warmup_max_lr=1e-3, warmup_num_steps=30,
                      warmup_type="linear")),
    ("WarmupDecayLR", dict(total_num_steps=80, warmup_min_lr=0.0, warmup_max_lr=1e-3,
                           warmup_num_steps=10)),
    ("WarmupCosineLR", dict(total_num_steps=90, warmup_min_ratio=0.1, warmup_num_steps=12,
                            cos_min_ratio=0.01)),
    ("OneCycle", dict(cycle_min_lr=1e-4, cycle_max_lr=1e-2, decay_lr_rate=0.1,
                      cycle_first_step_size=20, cycle_second_step_size=30,
                      decay_step_size=5)),
    ("LRRangeTest", dict(lr_range_test_min_lr=1e-4, lr_range_test_step_size=7,
                         lr_range_test_step_rate=2.0, lr_range_test_staircase=True)),
    ("LRRangeTest", dict(lr_range_test_min_lr=1e-4, lr_range_test_step_size=7)),
]


@pytest.mark.parametrize("name,params", SCHEDULES, ids=[f"{n}-{i}" for i, (n, _) in
                                                         enumerate(SCHEDULES)])
def test_lr_schedule_matches_jax_over_100_steps(name, params):
    from deepspeed_tpu.ops.optimizers import FusedAdam as JaxFusedAdam
    from deepspeed_tpu.runtime import lr_schedules as jls

    jopt, topt = JaxFusedAdam(lr=3e-4), FusedAdam(lr=3e-4)
    js = jls.build_lr_scheduler(name, jopt, dict(params))
    ts = tls.build_lr_scheduler(name, topt, dict(params))
    assert ts.get_last_lr() == js.get_last_lr()
    for _ in range(100):
        js.step()
        ts.step()
        assert ts.get_last_lr() == js.get_last_lr()
        assert topt.lr == jopt.lr
    with pytest.raises(ValueError):
        tls.build_lr_scheduler("Nope", topt, {})


def _state(s):
    return tuple(float(np.asarray(x)) for x in s)


@pytest.mark.parametrize("kw", [
    dict(init_scale=2.0 ** 16, scale_window=4, min_scale=1.0, delayed_shift=2),
    dict(init_scale=2.0 ** 4, scale_window=3, min_scale=2.0, delayed_shift=1,
         consecutive_hysteresis=True),
])
def test_dynamic_loss_scaler_matches_jax(kw):
    import jax.numpy as jnp

    from deepspeed_tpu.runtime.fp16.loss_scaler import DynamicLossScaler as JaxScaler

    js, ts = JaxScaler(**kw), DynamicLossScaler(**kw)
    jst, tst = js.init_state(), ts.init_state()
    assert _state(tst) == _state(jst)
    seq = [0, 0, 1, 0, 1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0]
    for ov in seq:
        jst = js.update(jst, jnp.asarray(bool(ov)))
        tst = ts.update(tst, torch.tensor(bool(ov)))
        assert _state(tst) == _state(jst)
    assert tst.cur_scale.dtype == torch.float32 and tst.iter_.dtype == torch.int32


def test_static_scaler_and_has_overflow():
    st = LossScaler(scale=8.0).init_state()
    st2 = LossScaler(scale=8.0).update(st, torch.tensor(True))
    assert float(st2.cur_scale) == 8.0 and int(st2.iter_) == 1
    ok = {"a": torch.ones(3), "b": {"c": torch.zeros(2, 2)}}
    assert not bool(has_overflow(ok))
    bad = {"a": torch.ones(3), "b": {"c": torch.tensor([[0.0, float("inf")], [1.0, 2.0]])}}
    assert bool(has_overflow(bad))
    assert bool(has_overflow({"a": torch.tensor([float("nan")])}))
