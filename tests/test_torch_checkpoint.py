"""Checkpoints across the two packages: the port's ``save_checkpoint`` /
``load_checkpoint``, ``ds_to_universal`` / ``load_universal_into_engine``
and ``zero_to_fp32`` against the JAX package's, on the CPU.

The micro gpt2 of the JAX package's own checkpoint tests (hidden 32, one
layer, two heads, vocab 128, sequences of 16), fp32 or bf16 with an fp32
master, AdamW, WarmupLR and clipping, seed 7, a global batch of 8 rows.
The JAX engine runs data-parallel on the test mesh's 8 devices (a
micro-batch of 1 there, of 8 on the port's one device), at stage 0, or at
ZeRO stage 2, where its optimizer file is sharded per rank; one engine per
configuration serves the whole module (it trains 2 steps, saves, continues
2 steps, and later tests load checkpoints into it instead of building
another).

Both directions: a tag one package saves loads in the other with every
leaf, counter and key bitwise the file's (the metadata files equal too, but
for ``ds_config_batch``'s micro-batch), and in fp32 the 2 steps after it
match the other package's at the training tolerances of
``tests/test_torch_train_engine.py`` (losses rtol 1e-5, parameters atol
2e-5). In bf16 the packages' 16-bit products round differently, so there
the losses are held at rtol 1e-4 and the fp32 master at atol 1e-4.
"""

import functools
import json
import os
import pickle
import shutil
import sys

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint import ds_to_universal
from deepspeed_tpu_torch.models import build_model, params_from_jax
from deepspeed_tpu_torch.runtime.checkpoint_engine.native_checkpoint_engine import (
    NativeCheckpointEngine)
from deepspeed_tpu_torch.utils import zero_to_fp32

ROWS, SEQ, V = 8, 16, 128
MKW = dict(hidden_size=32, num_layers=1, num_heads=2, vocab_size=V, max_seq_len=SEQ)
VARIANTS = {"plain": {}, "bf16": {"bf16": {"enabled": True}},
            "zero2": {"zero_optimization": {"stage": 2}}}
TAG = "global_step2"


def _config(**kw):
    cfg = {
        "train_batch_size": ROWS,
        "gradient_accumulation_steps": 1,
        "gradient_clipping": 1.0,
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1,
                                                  "eps": 1e-6}},
        "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 0,
                                                     "warmup_max_lr": 1e-3,
                                                     "warmup_num_steps": 2}},
        "steps_per_print": 0,
        "seed": 7,
    }
    cfg.update(kw)
    return cfg


def _batch(k):
    rng = np.random.default_rng(1000 + k)
    return {"input_ids": rng.integers(0, V, (ROWS, SEQ), dtype=np.int32)}


def _bits(x):
    """A leaf of either package as a numpy array compared bit for bit."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16
                else x.numpy())
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _assert_bitwise(a, b, what):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb], what
    for (p, x), (_, y) in zip(la, lb):
        x, y = _bits(x), _bits(y)
        assert x.shape == y.shape and x.dtype == y.dtype, (what, p, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=f"{what}{p}")


def _copy(tree):
    return ({k: _copy(v) for k, v in tree.items()} if isinstance(tree, dict)
            else tree.detach().clone())


def _port_state(eng):
    """A copy of every quantity a tag holds."""
    return {"params": _copy(eng.params),
            "master": _copy(eng.master_params) if eng._mixed else None,
            "step": eng.opt_state.step.clone(), "m": _copy(eng.opt_state.m),
            "v": _copy(eng.opt_state.v), "scaler": _copy(eng.scaler_state._asdict()),
            "counters": [eng.global_steps, eng.global_samples, eng.skipped_steps,
                         eng.micro_steps, eng._data_position],
            "rng": eng._rng.numpy().astype(np.uint32),
            "lr": dict(eng.lr_scheduler.state_dict())}


def _jax_state(eng):
    import jax

    get = lambda t: jax.tree.map(np.asarray, jax.device_get(t))  # noqa: E731
    return {"params": get(eng.params), "master": get(eng.master_params) if eng._mixed else None,
            "step": get(eng.opt_state.step), "m": get(eng.opt_state.m),
            "v": get(eng.opt_state.v), "scaler": get(eng.scaler_state._asdict()),
            "counters": [eng.global_steps, eng.global_samples, eng.skipped_steps,
                         eng.micro_steps, eng._data_position],
            "rng": np.asarray(eng._rng), "lr": eng.lr_scheduler.state_dict()}


def _assert_states_equal(a, b, what):
    for k in ("params", "master", "step", "m", "v", "scaler", "rng"):
        if a[k] is None or b[k] is None:
            assert a[k] is None and b[k] is None, (what, k)
            continue
        _assert_bitwise(a[k], b[k], f"{what} {k}")
    assert a["counters"] == b["counters"] and a["lr"] == b["lr"], what


def _assert_close(port_params, jax_params, atol=2e-5):
    for (p, x), (_, y) in zip(_leaves(port_params), _leaves(jax_params)):
        x = x.detach().float().numpy()
        y = np.asarray(y, np.float32)
        np.testing.assert_allclose(x, y, atol=atol, err_msg=p)


class _JaxRun:
    """One JAX engine of a variant: 2 steps, a save under ``TAG``, 2 more."""

    def __init__(self, variant, root):
        import deepspeed_tpu
        from deepspeed_tpu.comm import topology as topo_mod
        from deepspeed_tpu.models import build_model as jax_build_model

        topo_mod.reset_topology()
        jm = jax_build_model("gpt2-125m", **MKW)
        self.init = _jax_init()
        self.engine, _, _, _ = deepspeed_tpu.initialize(
            model=jm, model_parameters=self.init, config=_config(**VARIANTS[variant]))
        self.dir = str(root)
        for k in range(2):
            self.engine.train_batch(iter([_batch(k)]))
        self.saved = _jax_state(self.engine)
        self.engine.save_checkpoint(self.dir)
        self.cont_losses = [float(self.engine.train_batch(iter([_batch(k)]))) for k in (2, 3)]
        self.cont = _jax_state(self.engine)


def _assert_continuation(eng, losses, jax_losses, jax_state):
    """The 2 steps after a load, port vs JAX: fp32 losses at rtol 1e-5 and
    parameters at atol 2e-5; bf16 losses at rtol 1e-4 and its fp32 master
    at atol 1e-4, a tenth of one step's lr (a tiny gradient's Adam update
    turns on the bf16 rounding of its forward)."""
    if eng._mixed:
        np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
        _assert_close(eng.master_params, jax_state["master"], atol=1e-4)
    else:
        np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)
        _assert_close(eng.params, jax_state["params"])


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    runs = {}

    def get(variant):
        if variant not in runs:
            runs[variant] = _JaxRun(variant, tmp_path_factory.mktemp(f"jax_{variant}"))
        return runs[variant]

    return get


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_engine(variant, init, **cfg):
    precision = {k: v for k, v in VARIANTS[variant].items() if k != "zero_optimization"}
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=build_model("gpt2-125m", **MKW), model_parameters=params_from_jax(init),
        config=_config(**precision, **cfg), device="cpu")
    return eng


@functools.lru_cache(maxsize=None)
def _jax_init(seed=0):
    """The JAX package's ``init_params(PRNGKey(seed))`` as numpy, drawn once
    a seed (read-only); seed 3 gives weights other than the runs', which a
    load must overwrite."""
    import jax

    from deepspeed_tpu.models import build_model as jax_build_model

    return jax.tree.map(np.asarray, jax_build_model("gpt2-125m", **MKW).init_params(
        jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_port_loads_the_jax_packages_checkpoint(variant, jax_runs):
    """A JAX tag (at stage 2: its per-rank moment files consolidated) loads
    into a port engine built from other weights: every leaf, counter and key
    bitwise the JAX engine's at the save; then 2 steps at tolerance."""
    run = jax_runs(variant)
    eng = _port_engine(variant, _jax_init(3))
    path, client = eng.load_checkpoint(run.dir)
    assert path == os.path.join(run.dir, TAG, "model_states.ckpt") and client == {}
    assert eng.loaded_checkpoint_tag == TAG and eng.ckpt_corrupt_fallbacks == 0
    _assert_states_equal(_port_state(eng), run.saved,
                         f"{variant}: port after load vs JAX at save")
    losses = [float(eng.train_batch(iter([_batch(k)]))) for k in (2, 3)]
    _assert_continuation(eng, losses, run.cont_losses, run.cont)


@pytest.mark.parametrize("variant", ["plain", "bf16"])
def test_jax_package_loads_the_ports_checkpoint(variant, jax_runs, tmp_path):
    """The port trains 2 steps from the run's weights and saves; its files'
    metadata equal the JAX save's, and the JAX engine loads them to the
    port's state bitwise; in fp32 the 2 steps after match at tolerance (the
    bf16 continuation across packages is held in the other direction)."""
    run = jax_runs(variant)
    eng = _port_engine(variant, run.init)
    for k in range(2):
        eng.train_batch(iter([_batch(k)]))
    eng.save_checkpoint(str(tmp_path))
    assert (tmp_path / "latest").read_text() == TAG
    for f in ("model_states.ckpt.meta.json", "optim_states.ckpt.meta.json"):
        with open(os.path.join(run.dir, TAG, f)) as a, open(tmp_path / TAG / f) as b:
            theirs, ours = json.load(a), json.load(b)
        if "ds_config_batch||1" in ours:  # the micro-batch: 1 a device there, 8 here
            assert (theirs.pop("ds_config_batch||1"), ours.pop("ds_config_batch||1")) == \
                ({"kind": "scalar", "value": 1}, {"kind": "scalar", "value": ROWS})
        assert theirs == ours, f
    saved = _port_state(eng)
    run.engine.load_checkpoint(str(tmp_path))
    _assert_states_equal(_jax_state(run.engine), saved, f"{variant}: JAX after load vs port")
    if variant == "plain":  # (a JAX step after a load compiles its programs again)
        jl = [float(run.engine.train_batch(iter([_batch(k)]))) for k in (2, 3)]
        tl = [float(eng.train_batch(iter([_batch(k)]))) for k in (2, 3)]
        _assert_continuation(eng, tl, jl, _jax_state(run.engine))


def test_16_bit_leaves_cross_bitwise(tmp_path):
    """A bf16 leaf: the port writes the uint16 view under "bfloat16" and the
    JAX package reads it as its ``ml_dtypes`` array, and back, the bits
    unchanged (no ``ml_dtypes`` on the port's side)."""
    from deepspeed_tpu.runtime.checkpoint_engine.native_checkpoint_engine import (
        NativeCheckpointEngine as JaxEngine)

    g = torch.Generator().manual_seed(0)
    t = torch.randn((3, 5), generator=g).to(torch.bfloat16)
    port_path, jax_path = str(tmp_path / "p.ckpt"), str(tmp_path / "j.ckpt")
    NativeCheckpointEngine().save({"w": t, "s": torch.tensor(1.5, dtype=torch.bfloat16),
                                   "f": torch.ones(2)}, port_path)
    with open(port_path + ".meta.json") as f:
        assert json.load(f)["w"] == {"kind": "array", "dtype": "bfloat16"}
    back = JaxEngine().load(port_path)
    assert back["w"].dtype.name == "bfloat16" and back["f"].dtype == np.float32
    np.testing.assert_array_equal(back["w"].view(np.uint16), _bits(t))
    JaxEngine().save(back, jax_path)
    again = NativeCheckpointEngine().load(jax_path)
    assert again["w"].dtype == torch.bfloat16 and again["s"].dtype == torch.bfloat16
    assert torch.equal(again["w"].view(torch.int16), t.view(torch.int16))
    assert float(again["s"]) == 1.5 and isinstance(again["f"], np.ndarray)


def test_offload_checkpoint_raises_naming_the_item(jax_runs, tmp_path):
    """An optimizer file in the offload format (``offload_host``: the host
    tier's master and flat moments, the ratio split) loads into the port's
    device engine as the same run's device-format file does: every
    quantity bitwise (``engine.py:2371``'s normalisation, run in reverse).
    ZeRO offload is ported; nothing here raises any more."""
    run = jax_runs("plain")
    d = str(tmp_path / "off")
    shutil.copytree(run.dir, d)
    optim_path = os.path.join(d, TAG, "optim_states.ckpt")
    sd = NativeCheckpointEngine().load(optim_path)
    model = NativeCheckpointEngine().load(os.path.join(d, TAG, "model_states.ckpt"))
    flat = lambda t: [np.asarray(x, np.float32).reshape(-1) for _, x in _leaves(t)]  # noqa: E731
    master = [np.asarray(x, np.float32) for _, x in _leaves(model["module"])]
    NativeCheckpointEngine().save({
        "offload_host": {"master": master, "m": flat(sd["m"]), "v": flat(sd["v"]),
                         "step": int(np.asarray(sd["step"]))},
        "offload_dev": None, "host_idx": list(range(len(master))), "dev_idx": [],
        "scaler": sd["scaler"]}, optim_path)
    eng = _port_engine("plain", run.init)
    eng.load_checkpoint(d)
    ref = _port_engine("plain", run.init)
    ref.load_checkpoint(run.dir)
    _assert_states_equal(_port_state(eng), _port_state(ref), "offload_host vs device file")


def _universal_files(d):
    out = {}
    for root, _, files in os.walk(os.path.join(d, "zero")):
        for f in files:
            out[os.path.relpath(os.path.join(root, f), d)] = np.load(os.path.join(root, f))
    with open(os.path.join(d, "universal_meta.pkl"), "rb") as f:
        return out, pickle.load(f)


@pytest.mark.parametrize("variant", ["plain", "zero2"])
def test_universal_from_either_package(variant, jax_runs, tmp_path):
    """``ds_to_universal`` of a JAX tag (stage 2: consolidated) gives the JAX
    package's files and metadata exactly; a port engine with
    ``load_universal`` restores from them to the tag's state; the JAX
    converter reads a port tag the same way the port's does."""
    from deepspeed_tpu.checkpoint import ds_to_universal as jax_ds_to_universal

    run = jax_runs(variant)
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    ds_to_universal(run.dir, ours)
    jax_ds_to_universal(run.dir, theirs)
    (fa, ma), (fb, mb) = _universal_files(ours), _universal_files(theirs)
    assert sorted(fa) == sorted(fb) and len(fa) == 3 * 17
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    assert pickle.dumps(ma) == pickle.dumps(mb)
    eng = _port_engine("plain", _jax_init(3), checkpoint={"load_universal": True})
    assert eng.load_checkpoint(ours) == (ours, {})
    assert eng.loaded_checkpoint_tag == "universal"
    want = dict(run.saved)
    got = _port_state(eng)
    for k in ("params", "step", "m", "v", "scaler"):
        _assert_bitwise(got[k], want[k], f"universal {k}")
    assert eng.global_steps == 2 and eng.lr_scheduler.state_dict() == want["lr"]
    if variant == "plain":  # a port tag through both converters
        src = str(tmp_path / "port")
        eng.save_checkpoint(src)
        ds_to_universal(src, str(tmp_path / "p1"))
        jax_ds_to_universal(src, str(tmp_path / "p2"))
        (fa, ma), (fb, mb) = (_universal_files(str(tmp_path / p)) for p in ("p1", "p2"))
        assert sorted(fa) == sorted(fb)
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
        assert pickle.dumps(ma) == pickle.dumps(mb)


def test_zero_to_fp32_over_either_packages_files(jax_runs, tmp_path, monkeypatch):
    """The fp32 state dict of a JAX bf16 tag and of a port tag equals the
    JAX tool's; the CLI writes it; ``load_state_dict_from_zero_checkpoint``
    fills the port's parameter tree."""
    from deepspeed_tpu.utils import zero_to_fp32 as jax_zero_to_fp32

    run = jax_runs("bf16")
    eng = _port_engine("bf16", run.init)
    eng.train_batch(iter([_batch(0)]))
    eng.save_checkpoint(str(tmp_path / "port"), tag="t1")
    for d, tag in ((run.dir, None), (str(tmp_path / "port"), "t1")):
        ours = zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(d, tag)
        theirs = jax_zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(d, tag)
        assert list(ours) == list(theirs) and len(ours) == 17
        for k in ours:
            assert ours[k].dtype == np.float32
            np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    out = str(tmp_path / "fp32.npz")
    monkeypatch.setattr(sys, "argv", ["zero_to_fp32", run.dir, out])
    zero_to_fp32.main()
    with np.load(out) as z:
        np.testing.assert_array_equal(z["wte"], run.saved["master"]["wte"])
    tree = zero_to_fp32.load_state_dict_from_zero_checkpoint(eng.params, run.dir)
    _assert_bitwise(tree, run.saved["master"], "zero_to_fp32 tree")


@pytest.mark.parametrize("src,dst", [("fp32", "bf16"), ("bf16", "fp32"), ("fp32", "fp16")])
def test_precision_change_on_load(src, dst, tmp_path):
    """The stage-0 rows of the JAX package's checkpoint matrix
    (``tests/unit/test_checkpoint_matrix.py``): the fp32 values a tag holds
    (the master copy when mixed) survive a load under another precision
    exactly, the lp parameters are their cast, and the engine trains on."""
    precision = {"fp32": {}, "bf16": {"bf16": {"enabled": True}},
                 "fp16": {"fp16": {"enabled": True, "initial_scale_power": 8}}}
    init = _jax_init()

    def engine(p):
        return deepspeed_tpu_torch.initialize(
            model=build_model("gpt2-125m", **MKW), model_parameters=params_from_jax(init),
            config=_config(**precision[p]), device="cpu")[0]

    a = engine(src)
    for k in range(2):
        a.train_batch(iter([_batch(k)]))
    a.save_checkpoint(str(tmp_path))
    fp32 = a.get_fp32_params()
    b = engine(dst)
    assert b.load_checkpoint(str(tmp_path))[0] is not None and b.global_steps == 2
    _assert_bitwise(b.get_fp32_params(), fp32, f"{src} -> {dst} fp32 values")
    for (p, lp), (_, w) in zip(_leaves(b.params), _leaves(fp32)):
        assert lp.dtype == b.compute_dtype and torch.equal(lp.detach(), w.to(lp.dtype)), p
    probe = _batch(9)
    b.eval()
    l0 = float(b(probe))
    b.train()
    for _ in range(3):
        b.train_batch(iter([probe]))
    b.eval()
    assert np.isfinite(float(b(probe))) and float(b(probe)) < l0


class _Stream:
    """An iterable dataset with no ``__len__``: each pass yields the same
    samples in order, as a streaming corpus does."""

    def __init__(self, n_batches):
        rng = np.random.default_rng(77)
        self.samples = [{"input_ids": rng.integers(0, V, (SEQ,), dtype=np.int32)}
                        for _ in range(n_batches * ROWS)]

    def __iter__(self):
        return iter(self.samples)


def test_iterable_training_data_saves_and_resumes_as_the_jax_package(jax_runs, tmp_path):
    """``train_batch()`` over an iterable ``training_data`` (no length, so
    no skip on resume: both packages restart the stream): from the plain
    run's tag, 2 steps in each package at tolerance; the port's save loads
    into a fresh port engine bitwise, with the dataset position 2, and its
    2 steps match the JAX engine's after the JAX engine's own save and
    load."""
    run = jax_runs("plain")
    stream = _Stream(3)
    jeng = run.engine
    jeng.load_checkpoint(run.dir)
    jeng.training_dataloader = jeng.deepspeed_io(stream)
    try:
        jl1 = [float(jeng.train_batch()) for _ in range(2)]
        jeng.save_checkpoint(str(tmp_path / "jax"))
        jeng.load_checkpoint(str(tmp_path / "jax"))
        assert jeng._data_position == 2
        jl2 = [float(jeng.train_batch()) for _ in range(2)]
        jstate = _jax_state(jeng)
    finally:
        jeng.training_dataloader = None
        jeng._train_iter = None

    eng = deepspeed_tpu_torch.initialize(
        model=build_model("gpt2-125m", **MKW), model_parameters=params_from_jax(_jax_init(3)),
        config=_config(), training_data=stream, device="cpu")[0]
    eng.load_checkpoint(run.dir)
    pl1 = [float(eng.train_batch()) for _ in range(2)]
    np.testing.assert_allclose(pl1, jl1, rtol=1e-5)
    eng.save_checkpoint(str(tmp_path / "port"))
    saved = _port_state(eng)
    res = deepspeed_tpu_torch.initialize(
        model=build_model("gpt2-125m", **MKW), model_parameters=params_from_jax(_jax_init(3)),
        config=_config(), training_data=stream, device="cpu")[0]
    res.load_checkpoint(str(tmp_path / "port"))
    _assert_states_equal(_port_state(res), saved, "port resume over a stream")
    assert res._data_position == 2
    pl2 = [float(res.train_batch()) for _ in range(2)]
    _assert_continuation(res, pl2, jl2, jstate)
