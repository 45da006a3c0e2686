#!/usr/bin/env python3
"""Where the time of the port's paged serving steps (bf16 and int8 WOQ), training step, block-sparse attention and fused cross-entropy goes, on one NVIDIA GPU.

    python3 chip_profile.py      # from the root of a checkout, one CUDA card

First the host cost of one call of each kernel wrapper, eager, at the
serving main path's shapes (``paged_decode_attention`` at the decode step's
8 rows, ``woq_matmul`` int8 at 8 and 256 rows of (4096, 11008),
``flash_attention_fwd`` at (1, 512, 32, 128)), beside a bf16
``torch.matmul`` at the decode shape and an elementwise add: 200 calls
enqueued back to back after a warm-up, the host clock until the last call
returns (no synchronize inside the window), per call.

Then ``chip_smoke.py``'s serving main path (llama-7b, full width and depth,
random bf16 weights, the same requests; the engine's steps captured, as by
default), then traces with ``torch.profiler``:

- 5 decode steps of the requests still live (the ``max_seqs``-row shape),
  eager (``engine.capture = False``) and then as replays of the captured
  step;
- 1 prefill step (a fresh 256-token prompt: the ``token_budget``-row shape),
  eager and captured.

The same again over int8 weight-only-quantized weights
(``quantize_model(num_bits=8, group_size=128)``), where the block
projections run the WOQ kernel (group ``woq_matmul``) and only the
vocabulary head stays a cuBLAS matmul.

For each it prints the step's host-clock time, the device time summed over
its kernels, the device's idle share of the step, and the kernel time by
group (the paged-attention kernel, matrix products, the K/V scatter, the
rest) with the top kernels by device time.

Then the paged-attention kernel on the engine's pool (layer 0) at the
decode step's rows, timed with CUDA events three ways: all rows, the
longest row alone, and every row but the longest. If the longest row alone
takes about as long as all rows, the kernel's time is the serial work of
that row's CTAs, not a shortage of CTAs.

Last, the training main path of ``chip_smoke.py`` (llama-7b width, 4
layers, bf16 with an fp32 master, one 2 x 2048 batch): after 2 warm-up
steps, 2 ``train_batch`` steps traced the same way, grouped into the flash
forward and backward kernels, matrix products and the rest; then the
optimizer update alone (``step_fn``'s unscale, norm, clip, AdamW and cast
back), traced in a window of its own, which splits the rest into the
optimizer and the model's elementwise work.

Then one forward and backward of ``chip_smoke.py``'s block-sparse path
(``SparseSelfAttention`` over the Fixed layout, bf16 (1, 8192, 32, 128))
traced, grouped into the block-sparse forward and backward kernels and the
rest.

Then one forward and backward of ``chip_smoke.py``'s fused cross-entropy
path (``fused_ce_loss`` at llama-7b's head, bf16 x (4096, 4096), W (32000,
4096), then ``autograd.grad``) traced, with a group for each of its five
kernels (forward, combine, dlogits, dX, dW and, in 16 bits, the label
index and the pass that finishes dW's labelled rows: ``fused_ce_fwd`` ...
``fused_ce_dw_label``).

Last, the dequantization rates the WOQ prefill kernel's design leans on: a
small CUDA microbenchmark (built here with ``nvcc``, not part of the
package) that turns int8 codes into bf16 weights (code * scale, rounded)
three ways, 16 weights a thread an iteration on every SM, and reports
weights an SM a clock (``clock64``) for each: an ``I2F`` conversion then
FMUL and ``cvt.rn.bf16x2.f32``; the kernel's form (PRMT into 0x4B000000,
FADD, FMUL, ``cvt.rn.bf16x2.f32``); and that form with an integer
round-to-nearest-even in place of the ``cvt``. Nothing here is checked
against a reference: ``chip_smoke.py`` does that.
"""

import json
import os
import re
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def _group(name: str) -> str:
    n = name.lower()
    # the fused cross-entropy kernels, one group each: the 16-bit wgmma
    # kernels, the fp32 FMA ones and the earlier WMMA kernels' names alike
    ce = re.search(r"ce_(fwd|combine|dlogits|bwd_dx|bwd_dw|dw_label|label_rows)"
                   r"(?:_wgmma|_fma)?_kernel", n)
    if ce:
        return "fused_ce_" + ce.group(1)
    if "woq_" in n:
        return "woq_matmul"
    if "paged_decode_" in n:  # paged_decode_mma_kernel (16 bits), paged_decode_fma_kernel (fp32)
        return "paged_decode_attention"
    # the attention kernels of attention_kernels.cuh: over the dense
    # schedule (flash) or the block lists (block-sparse)
    if "attn_" in n and "_kernel" in n:
        family = "block_sparse" if "listsched" in n else "flash"
        return f"{family}_fwd" if "attn_fwd" in n else f"{family}_bwd"
    if any(k in n for k in ("gemm", "gemv", "nvjet", "cutlass", "xmma", "cublas")):
        return "matmul"
    if "index_put" in n or "indexing_backward" in n or "scatter" in n:
        return "kv_scatter"
    return "other"


def profile(fn, label, steps):
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # a short spin kernel opens the window: the trace can miss the
        # window's first kernel, and this one is left out of the sums
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if (dev_us > 0 and getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                and "spin_kernel" not in e.key):
            kernels[e.key] = (dev_us / 1e3 / steps, e.count // steps)
    busy = sum(ms for ms, _ in kernels.values())
    groups = {}
    for name, (ms, n) in kernels.items():
        g = groups.setdefault(_group(name), [0.0, 0])
        g[0] += ms
        g[1] += n
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    result = {
        "phase": label, "steps": steps, "step_ms": wall_ms, "device_ms": busy,
        "idle_share": 1.0 - busy / wall_ms,
        "kernels_per_step": sum(n for _, n in kernels.values()),
        "groups_ms": {g: round(v[0], 4) for g, v in sorted(groups.items(), key=lambda kv: -kv[1][0])},
        "top": [(name[:90], round(ms, 4), n) for name, (ms, n) in top],
    }
    print(json.dumps(result), flush=True)
    if busy == 0.0:
        raise SystemExit("the profiler recorded no device time")
    return result


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    sys.path.insert(0, HERE)
    import chip_smoke
    from deepspeed_tpu_torch.ops.transformer import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    launch_costs(dev)
    engine, _, _, real_pool, summary = chip_smoke.main_path(pa, dev)
    print(json.dumps({"main_path": {k: summary[k] for k in (
        "decode_step_ms_median", "prefill_tokens_per_s", "ragged_steps")}}), flush=True)
    live = {uid: 0 for uid in engine.state.seqs}  # any valid token will do here

    def decode():
        nonlocal live
        live = engine.decode_step(live, greedy=True)

    rng = np.random.default_rng(3)
    for capture, label in ((False, "eager"), (True, "captured")):
        engine.capture = capture
        decode()  # the step of this mode once before the window
        profile(decode, f"decode, {label} (6 live rows, max_seqs=8 row shape)", steps=5)
        prompt = rng.integers(0, engine.cfg.vocab_size, engine.token_budget).tolist()
        uid = 99 + capture
        profile(lambda: engine.put([uid], [prompt], greedy=True),
                f"prefill, {label} ({engine.token_budget}-token prompt, token_budget rows)",
                steps=1)
        engine.flush(uid)
    kernel_rows(pa, real_pool, engine.cfg, dev)
    del engine, real_pool
    torch.cuda.empty_cache()
    woq_profile(pa, dev)
    train_profile(dev)
    sparse_profile(dev)
    ce_profile(dev)
    dequant_rates(dev)


def launch_costs(dev, calls=200):
    """Host microseconds a call of each wrapper, eager (see the module
    docstring)."""
    import chip_smoke
    from deepspeed_tpu_torch.ops.quantizer import woq, woq_gemm as wq
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    from deepspeed_tpu_torch.ops.transformer import paged_attention as pa

    gen = torch.Generator(device=dev).manual_seed(5)
    bf16 = torch.bfloat16
    q = torch.randn(8, 32, 128, device=dev, generator=gen).to(bf16)
    kp = torch.randn(32, 65, 64, 128, device=dev, generator=gen).to(bf16)
    vp = kp.clone()
    tables = torch.arange(1, 65, dtype=torch.int32, device=dev).repeat(8, 1).contiguous()
    lens = torch.full((8,), 600, dtype=torch.int32, device=dev)
    codes, scale = woq.quantize_leaf(torch.randn(4096, 11008, device=dev, generator=gen)
                                     .mul_(0.02), 8, 128)
    x8, x256 = (torch.randn(r, 4096, device=dev, generator=gen).to(bf16) for r in (8, 256))
    w = torch.randn(4096, 4096, device=dev, generator=gen).to(bf16)
    fq, fk, fv, _ = chip_smoke.flash_case(1, 512, 32, 32, 128, bf16, dev)
    cases = {
        "paged_decode_attention (8 rows)": lambda: pa.paged_decode_attention(q, kp, vp, tables,
                                                                            lens),
        "woq_matmul int8 (8 rows, 4096x11008)": lambda: wq.woq_matmul(x8, codes, scale, 8),
        "woq_matmul int8 (256 rows, 4096x11008)": lambda: wq.woq_matmul(x256, codes, scale, 8),
        "flash_attention_fwd (1, 512, 32, 128)": lambda: fa.flash_attention_fwd(
            fq, fk, fv, causal=True),
        "torch.matmul bf16 (8, 4096) x (4096, 4096)": lambda: torch.matmul(x8, w),
        "torch.add bf16 (8, 4096)": lambda: torch.add(x8, x8),
    }
    result = {}
    for name, fn in cases.items():
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host_us = (time.perf_counter() - t0) * 1e6 / calls
        torch.cuda.synchronize()
        result[name] = host_us
    print(json.dumps({"host_us_per_call_eager": result,
                      "card": torch.cuda.get_device_name(dev)}), flush=True)
    return result


def woq_profile(pa, dev):
    """The int8 weight-only-quantized serving path: the same traffic, then
    5 decode steps and one prefill step traced."""
    import chip_smoke
    from deepspeed_tpu_torch.ops.quantizer import woq_gemm as wq

    engine, _, _, _, summary = chip_smoke.main_path(pa, dev, bits=8, wq=wq)
    print(json.dumps({"woq_main_path": {k: summary[k] for k in (
        "decode_step_ms_median", "prefill_tokens_per_s", "ragged_steps")}}), flush=True)
    live = {uid: 0 for uid in engine.state.seqs}

    def decode():
        nonlocal live
        live = engine.decode_step(live, greedy=True)

    profile(decode, "int8 WOQ decode (6 live rows, max_seqs=8 row shape)", steps=5)
    prompt = np.random.default_rng(3).integers(0, engine.cfg.vocab_size,
                                               engine.token_budget).tolist()
    profile(lambda: engine.put([99], [prompt], greedy=True),
            f"int8 WOQ prefill ({engine.token_budget}-token prompt, token_budget rows)",
            steps=1)
    del engine
    torch.cuda.empty_cache()


def train_profile(dev):
    """The training main path: 2 traced steps, then the optimizer alone."""
    import chip_smoke
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import build_model

    model = build_model("llama-7b", num_layers=4)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    cfg = dict(chip_smoke.TRAIN_CONFIG, steps_per_print=0)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, model_parameters=params,
                                                     config=cfg, device=dev)
    del params
    batch = {"input_ids": torch.randint(0, model.config.vocab_size, (2, 2048),
                                        dtype=torch.int32, device=dev,
                                        generator=torch.Generator(device=dev).manual_seed(0))}
    for _ in range(2):
        engine.train_batch(iter([batch]))
    step = profile(lambda: engine.train_batch(iter([batch])),
                   "train_batch (llama-7b width, 4 layers, B 2 x S 2048, bf16)", steps=2)
    loss = engine._loss_of(engine._apply_fn(engine.params, batch, train=True, rng=None))
    grads = engine._grads_of(loss.float() * engine.scaler_state.cur_scale)
    del loss
    opt = profile(lambda: engine._apply_update(grads, engine.get_lr()[0]),
                  "optimizer update alone (unscale, norm, clip, AdamW, cast back)", steps=1)
    groups = dict(step["groups_ms"])
    groups["optimizer"] = opt["device_ms"]
    groups["elementwise"] = groups.pop("other", 0.0) - opt["device_ms"]
    print(json.dumps({"train_step_breakdown": {
        "step_ms": step["step_ms"], "device_ms": step["device_ms"],
        "idle_share": step["idle_share"], "groups_ms": groups}}), flush=True)


def sparse_profile(dev):
    """One forward and backward of the block-sparse path (Fixed layout),
    after one warm-up."""
    import chip_smoke

    sa = chip_smoke.sparse_path_layouts()["fixed"]
    q, k, v = chip_smoke.sparse_inputs(dev)

    def fwd_bwd():
        out = sa(q, k, v)
        torch.autograd.grad((out.float() ** 2).sum(), (q, k, v))

    fwd_bwd()
    profile(fwd_bwd, "block-sparse fwd + bwd (Fixed, bf16 1 x 8192 x 32 x 128)", steps=1)


def ce_profile(dev):
    """One forward and backward of the fused cross-entropy path at llama-7b's
    head, after one warm-up."""
    import chip_smoke
    from deepspeed_tpu_torch.ops.transformer import fused_ce as fc

    x, w, labels, g = chip_smoke.ce_path_inputs(*chip_smoke.CE_MAIN, dev)
    x.requires_grad_()
    w.requires_grad_()

    def fwd_bwd():
        nll = fc.fused_ce_loss(x, w, labels)
        torch.autograd.grad((nll * g).sum(), (x, w))

    fwd_bwd()
    profile(fwd_bwd, "fused CE fwd + bwd (llama-7b head, bf16 N 4096 H 4096 V 32000)", steps=1)


_DEQUANT_BENCH = r"""
#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t pack_cvt(float a, float b) {
  __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&p);
}
__device__ __forceinline__ uint32_t pack_int(float a, float b) {  // RNE, finite values
  uint32_t x = __float_as_uint(a), y = __float_as_uint(b);
  x += 0x7FFFu + ((x >> 16) & 1u);
  y += 0x7FFFu + ((y >> 16) & 1u);
  return __byte_perm(x, y, 0x7632);
}

// MODE 0: I2F + FMUL + cvt; 1: PRMT + FADD + FMUL + cvt; 2: as 1 with an integer rounding
template <int MODE>
__global__ void __launch_bounds__(1024) dequant_bench(const uint32_t* in, uint32_t* out,
                                                      long long* cycles, int iters) {
  uint32_t w[4] = {in[threadIdx.x], in[threadIdx.x + 1], in[threadIdx.x + 2], in[threadIdx.x + 3]};
  const float s = __uint_as_float(0x3C000000u + (threadIdx.x & 7));
  uint32_t acc = 0;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 16; j += 2) {
      const uint32_t v = w[j / 4];
      float a, b;
      if (MODE == 0) {
        a = float(int8_t(v >> (8 * (j % 4))));
        b = float(int8_t(v >> (8 * (j % 4 + 1))));
      } else {
        const uint32_t u = v ^ 0x80808080u;
        a = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | (j % 4))) - 8388736.f;
        b = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | (j % 4 + 1))) - 8388736.f;
      }
      acc ^= MODE == 2 ? pack_int(a * s, b * s) : pack_cvt(a * s, b * s);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = w[q] * 1664525u + 1013904223u;  // new codes
  }
  __syncthreads();
  const long long t1 = clock64();
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

extern "C" int dequant_bench_run(int mode, const void* in, void* out, void* cycles, int blocks,
                                 int iters) {
  switch (mode) {
    case 0: dequant_bench<0><<<blocks, 1024>>>((const uint32_t*)in, (uint32_t*)out, (long long*)cycles, iters); break;
    case 1: dequant_bench<1><<<blocks, 1024>>>((const uint32_t*)in, (uint32_t*)out, (long long*)cycles, iters); break;
    default: dequant_bench<2><<<blocks, 1024>>>((const uint32_t*)in, (uint32_t*)out, (long long*)cycles, iters); break;
  }
  return (int)cudaGetLastError();
}
"""


def dequant_rates(dev):
    """Weights an SM turns from int8 codes into bf16 a clock, three ways (one
    1024-thread block on each SM; cycles from ``clock64`` inside the block)."""
    import ctypes

    from deepspeed_tpu_torch.ops.op_builder import CUDAOpBuilder

    src = os.path.join(HERE, "build", "dequant_bench.cu")
    os.makedirs(os.path.dirname(src), exist_ok=True)
    with open(src, "w") as f:
        f.write(_DEQUANT_BENCH)

    class Bench(CUDAOpBuilder):
        NAME = "dequant_bench"
        SOURCE = src  # absolute: os.path.join keeps it

    lib = ctypes.CDLL(Bench().build())
    lib.dequant_bench_run.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    inp = torch.randint(0, 2 ** 31, (1024 + 4,), dtype=torch.int64, device=dev).to(torch.int32)
    out = torch.empty(sms * 1024, dtype=torch.int32, device=dev)
    cycles = torch.empty(sms, dtype=torch.int64, device=dev)
    iters, result = 4096, {}
    for mode, label in enumerate(("i2f_fmul_cvt", "prmt_fadd_fmul_cvt", "prmt_fadd_fmul_int_round")):
        for _ in range(2):  # the first launch warms up
            err = lib.dequant_bench_run(mode, inp.data_ptr(), out.data_ptr(), cycles.data_ptr(),
                                        sms, iters)
            if err:
                raise SystemExit(f"dequant_bench launch failed: {err}")
            torch.cuda.synchronize()
        result[label] = 1024 * iters * 16 / float(cycles.double().median())
    print(json.dumps({"dequant_weights_per_sm_clock": result}), flush=True)


def kernel_rows(pa, real_pool, cfg, dev):
    """The kernel at the decode step's rows: all of them, the longest alone,
    and all but the longest (each a contiguous batch of its own)."""
    import chip_smoke

    kp, vp, tables, lens = real_pool
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal(
        (tables.shape[0], cfg.num_heads, cfg.head_dim)).astype(np.float32)).to(dev, kp.dtype)
    longest = int(lens.argmax())
    rest = [r for r in range(tables.shape[0]) if r != longest]
    result = {"lens": lens.tolist()}
    for label, rows in (("all_rows", list(range(tables.shape[0]))),
                        ("longest_row_only", [longest]), ("all_but_longest", rest)):
        idx = torch.tensor(rows, device=dev)
        args = (q[idx].contiguous(), kp, vp, tables[idx].contiguous(), lens[idx].contiguous())
        result[f"{label}_ms"] = chip_smoke.time_cuda(lambda: pa.paged_decode_attention(*args))
    print(json.dumps({"paged_decode_attention_rows": result}), flush=True)


if __name__ == "__main__":
    main()
