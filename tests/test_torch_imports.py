"""The port stands alone: importing every module of ``deepspeed_tpu_torch``
pulls in neither ``jax`` nor ``deepspeed_tpu``, and its entry points run on
the card unless asked for the CPU."""

import os
import subprocess
import sys

import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.accelerator import get_accelerator, resolve_device
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.models import build_model

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import deepspeed_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "deepspeed_tpu"))
print(" ".join(names))
print(bad)
"""

# the training, WOQ, sparse-attention, fused-CE, serving, pool and checkpoint slices' modules:
# each must be among those the probe imported
_TRAINING_MODULES = {
    "deepspeed_tpu_torch.ops.transformer.attention",
    "deepspeed_tpu_torch.ops.transformer.flash_attention",
    "deepspeed_tpu_torch.ops.optimizers",
    "deepspeed_tpu_torch.runtime.config",
    "deepspeed_tpu_torch.runtime.config_utils",
    "deepspeed_tpu_torch.runtime.constants",
    "deepspeed_tpu_torch.runtime.zero.config",
    "deepspeed_tpu_torch.runtime.lr_schedules",
    "deepspeed_tpu_torch.runtime.fp16.loss_scaler",
    "deepspeed_tpu_torch.runtime.dataloader",
    "deepspeed_tpu_torch.runtime.engine",
    "deepspeed_tpu_torch.utils.timer",
    "deepspeed_tpu_torch.utils.tree",
    # the WOQ serving slice
    "deepspeed_tpu_torch.inference.quantization",
    "deepspeed_tpu_torch.ops.quantizer.woq",
    "deepspeed_tpu_torch.ops.quantizer.woq_gemm",
    # the block-sparse attention slice
    "deepspeed_tpu_torch.ops.sparse_attention",
    "deepspeed_tpu_torch.ops.sparse_attention.sparsity_config",
    "deepspeed_tpu_torch.ops.sparse_attention.block_sparse_kernel",
    "deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention",
    # the fused linear cross-entropy slice
    "deepspeed_tpu_torch.ops.transformer.fused_ce",
    # the serving front end: threefry sampling, the scheduler and its host modules
    "deepspeed_tpu_torch.utils.prng",
    "deepspeed_tpu_torch.analysis.sanitizer",
    "deepspeed_tpu_torch.resilience.breaker",
    "deepspeed_tpu_torch.resilience.recovery",
    "deepspeed_tpu_torch.resilience.retry",
    "deepspeed_tpu_torch.resilience.watchdog",
    "deepspeed_tpu_torch.serve",
    "deepspeed_tpu_torch.serve.metrics",
    "deepspeed_tpu_torch.serve.request",
    "deepspeed_tpu_torch.serve.sampling",
    "deepspeed_tpu_torch.serve.scheduler",
    "deepspeed_tpu_torch.serve.speculation",
    "deepspeed_tpu_torch.serve.tenancy",
    # the engine pool and its resilience modules
    "deepspeed_tpu_torch.resilience.faults",
    "deepspeed_tpu_torch.resilience.health",
    "deepspeed_tpu_torch.resilience.limits",
    "deepspeed_tpu_torch.resilience.journal_store",
    "deepspeed_tpu_torch.serve.router",
    "deepspeed_tpu_torch.serve.pool",
    "deepspeed_tpu_torch.serve.disagg",
    "deepspeed_tpu_torch.serve.elastic",
    "deepspeed_tpu_torch.serve.trace",
    # checkpoints and training resilience
    "deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine",
    "deepspeed_tpu_torch.runtime.checkpoint_engine.native_checkpoint_engine",
    "deepspeed_tpu_torch.runtime.checkpoint_engine.async_checkpoint_engine",
    "deepspeed_tpu_torch.runtime.checkpoint_engine.consolidate",
    "deepspeed_tpu_torch.resilience.training",
    "deepspeed_tpu_torch.checkpoint",
    "deepspeed_tpu_torch.checkpoint.universal",
    "deepspeed_tpu_torch.utils.zero_to_fp32",
}


def test_package_imports_neither_jax_nor_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=_REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names, bad = proc.stdout.strip().splitlines()
    names = set(names.split())
    assert len(names) >= 28 and bad == "[]"
    assert _TRAINING_MODULES <= names, sorted(_TRAINING_MODULES - names)


def test_no_source_imports_jax_even_inside_a_function():
    # the probe above sees only imports made at import time; this reads every
    # import statement of the package and of chip_smoke.py, lazy ones included
    import ast
    import glob

    files = glob.glob(os.path.join(_REPO, "deepspeed_tpu_torch", "**", "*.py"), recursive=True)
    files.append(os.path.join(_REPO, "chip_smoke.py"))
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, _REPO)}:{node.lineno} {m}" for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib", "deepspeed_tpu")]
    assert len(files) > 40 and bad == []


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")


def test_entry_points_raise_without_cuda_unless_asked_for_cpu(no_cuda):
    model = build_model("llama-tiny", vocab_size=64, hidden_size=64, num_layers=1,
                        num_heads=1, intermediate_size=64, max_seq_len=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngineV2(model, paged=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_kv_pool(4, 16)
    with pytest.raises(RuntimeError, match="not available"):
        get_accelerator().device()
    assert resolve_device("cpu").type == "cpu"
    eng = InferenceEngineV2(model, paged=True, device="cpu", max_seqs=2,
                            block_size=16)
    assert eng.kv[0].device.type == "cpu"


def test_initialize_raises_without_cuda_unless_asked_for_cpu(no_cuda):
    model = build_model("llama-tiny", vocab_size=64, hidden_size=64, num_layers=1,
                        num_heads=1, intermediate_size=64, max_seq_len=64)
    config = {"train_batch_size": 2, "optimizer": {"type": "adamw", "params": {}}}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.initialize(model=model, config=config)
    engine, opt, loader, sched = deepspeed_tpu_torch.initialize(model=model, config=config,
                                                                device="cpu")
    assert engine.device.type == "cpu" and loader is None and sched is None
    assert opt is engine.optimizer
    assert engine.params["wte"].device.type == "cpu"


def test_accelerator_defaults_to_cuda():
    assert get_accelerator().name == "cuda"
    assert get_accelerator("cpu").device().type == "cpu"
    with pytest.raises(ValueError):
        get_accelerator("tpu")
