"""Checkpoints of a training engine on the card.

``cuda``-marked (they skip without a card): a small bf16 llama (head_dim
64, so the flash kernels run) trains on the card, saves, trains on; a fresh
engine from other weights loads the tag and holds every parameter, the
fp32 master, Adam's moments and step, the scaler, the counters and the key
bitwise, and repeats the continuation's losses bitwise; the tag also loads
into a CPU engine, whose state equals the card's. Synchronous and async
saves (the async file written while the next steps update the tensors in
place). The card has no JAX: run there with ``python -m pytest --noconftest
-m cuda tests/test_torch_checkpoint_card.py``.
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import build_model
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

MODEL = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
             intermediate_size=512, max_seq_len=256)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the training step's flash kernels have no CPU mode")
    return torch.device("cuda")


def _engine(device, seed, **cfg):
    model = build_model("llama-tiny", **MODEL)
    config = {"train_batch_size": 2, "bf16": {"enabled": True}, "gradient_clipping": 1.0,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1}},
              "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 2}},
              "steps_per_print": 0, "seed": 3, **cfg}
    params = model.init_params(torch.Generator().manual_seed(seed))
    return deepspeed_tpu_torch.initialize(model=model, model_parameters=params,
                                          config=config, device=device)[0]


def _batch(k):
    ids = np.random.default_rng(k).integers(0, MODEL["vocab_size"], (2, 256))
    return {"input_ids": ids.astype(np.int32)}


def _state(eng):
    """Every saved quantity, copied (CPU tensors and Python values)."""
    def cp(tree):
        return {k: cp(v) if isinstance(v, dict) else v.detach().cpu().clone()
                for k, v in tree.items()}

    return {"params": cp(eng.params), "master": cp(eng.master_params),
            "m": cp(eng.opt_state.m), "v": cp(eng.opt_state.v),
            "step": eng.opt_state.step.cpu(), "scaler": cp(eng.scaler_state._asdict()),
            "rng": eng._rng.cpu(), "lr": eng.lr_scheduler.state_dict(),
            "counters": (eng.global_steps, eng.global_samples, eng.micro_steps,
                         eng.skipped_steps)}


def _assert_equal(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


@pytest.mark.cuda
@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_cuda_save_resume_bitwise(async_save, tmp_path):
    dev = _card()
    cfg = {"checkpoint": {"async_save": True}} if async_save else {}
    eng = _engine(dev, 0, **cfg)
    for k in range(2):
        eng.train_batch(iter([_batch(k)]))
    saved = _state(eng)
    n0 = fa.fwd_launches
    eng.save_checkpoint(str(tmp_path))
    losses = [eng.train_batch(iter([_batch(k)])) for k in (2, 3)]  # the writer may lag
    assert fa.fwd_launches - n0 == 2 * MODEL["num_layers"]  # the flash kernel ran
    if async_save:
        eng.checkpoint_engine.wait()
    res = _engine(dev, 1)
    res.load_checkpoint(str(tmp_path))
    _assert_equal(_state(res), saved)
    again = [res.train_batch(iter([_batch(k)])) for k in (2, 3)]
    assert torch.equal(torch.stack(losses), torch.stack(again))
    cpu = _engine("cpu", 1)
    cpu.load_checkpoint(str(tmp_path))
    _assert_equal(_state(cpu), saved)
