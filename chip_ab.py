#!/usr/bin/env python3
"""Time the port's attention, paged decode, fused-CE and WOQ kernels of two checkouts on one NVIDIA GPU, in turns.

    python3 chip_ab.py OLD NEW    # roots of two checkouts, e.g. a parent unpacked with git archive

Runs four turns, OLD, NEW, NEW, OLD, each in a fresh process that imports
``deepspeed_tpu_torch`` from its own checkout and builds that checkout's
kernels there. A turn times, with ``chip_smoke.py``'s ``time_cuda`` (CUDA
events behind a sleep kernel, the median of 25 after 5 warm-ups):

- the flash forward and backward at the training shape (B 2, S 2048, 32
  heads, head_dim 128, bf16, causal);
- where the checkout's forward takes row offsets, the slot forward at
  ``chip_smoke.py``'s ``SLOT_CASES`` (phase 8: a decode call, a 256-row chunk
  at offset 256, a 16-row bucket; bf16, llama-7b's heads over an 8-slot,
  4096-token cache), ``slot_<case>_ms``;
- where the checkout has them, the block-sparse forward and backward at the
  sparse path's shape (1, 8192, 32, 128) over the Fixed layout;
- where the checkout has them, the fused-CE forward (with the residual) and
  backward at llama-7b's head (N 4096, H 4096, V 32000, bf16) and at
  gpt2-6.7b's tied head (V 50304), and each of their kernels apart (the
  forward and the combine; dlogits, dX and dW), the device time a call of
  each from ``torch.profiler`` over 10 calls, grouped as ``chip_profile.py``
  groups them;
- ``paged_decode_attention`` (bf16, llama-7b's 32 heads of 128, the
  engine's table of 64 slots of 64 keys) on ``chip_smoke.paged_case``'s
  synthetic pool at the lens of the main path's last decode step
  (``DECODE_LENS``, copied from ``chip_smoke.py`` phase 5's log line), and
  at 256-row prefill chunks of one sequence, every row the same table:
  positions 1793 to 2048 (lens 1793..2048, ``paged_chunk_ms``) and a
  256-token prompt's first chunk (lens 1..256, ``paged_prompt_ms``, the
  rows of ``chip_profile.py``'s prefill step);
- ``woq_matmul`` (bf16 x) over int8, int6 and int4 codes (group 128) of
  llama-7b's three projection shapes, at 8, 37 and 256 rows, cycling
  through copies of the codes and scales that together exceed the 50 MB L2
  (as ``chip_smoke.py`` q4), so that both checkouts read them from HBM.

It prints one JSON line per turn, then ``{"ab": ...}`` with each quantity's
OLD and NEW times (the mean of each side's two turns). Nothing is checked
against a reference here: ``chip_smoke.py`` does that.

    python3 chip_ab.py --ckpt OLD NEW

times the training checkpoint's host side instead, in the same four turns,
on ``chip_smoke.py`` phase c3's engine (llama-7b width, 4 layers, bf16 with
an fp32 master, 12.86 GB a tag): a ``save_checkpoint`` into the checkout's
``build/ckpt_ab`` (``save_s``; its gather ``gather_first_s``, the first on
fresh host buffers), a second save whose files are not written
(``gather_again_s``), and a ``load_checkpoint`` of the first (``load_s``;
the host-to-device restore ``restore_s``). The tag is deleted after the turn.
Then the same leaves (master, m, v) without the engine, with a device
synchronize around each: fresh pinned buffers for all of them
(``pinned_alloc_s``), one non-blocking copy into each (``d2h_pinned_s``),
the same copies again (``d2h_pinned_again_s``), the buffers freed and asked
for again (``pinned_alloc_again_s``, from the allocator's cache), and a
blocking ``.cpu()`` of each into pageable memory (``d2h_pageable_s``).
"""

import inspect
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# the rows of chip_smoke.py phase 5: the main path's last decode step
# (6 live requests, 2 padding rows), as its log line prints them
DECODE_LENS = (69, 332, 1032, 2132, 668, 664, 1, 1)


def turn(root):
    sys.path.insert(0, os.path.abspath(root))
    import importlib.util

    import torch

    def load(name):
        spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    cs, cp = load("chip_smoke"), load("chip_profile")
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    dev = torch.device("cuda", 0)
    out = {"root": root}
    q, k, v, do = cs.flash_case(2, 2048, 32, 32, 128, torch.bfloat16, dev, seed=5)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    out["flash_fwd_ms"] = cs.time_cuda(lambda: fa.flash_attention_fwd(q, k, v, causal=True))
    out["flash_bwd_ms"] = cs.time_cuda(
        lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True))
    del q, k, v, do
    if "kv_rows" in inspect.signature(fa.flash_attention_fwd).parameters:
        for label, B, Sq, offs, rows in cs.SLOT_CASES:
            q, k, v, off, kr = cs.slot_case(B, Sq, offs, rows, torch.bfloat16, dev, seed=3)
            out[f"slot_{label.split()[0]}_ms"] = cs.time_cuda(
                lambda: fa.flash_attention_fwd(q, k, v, q_offset=off, kv_rows=kr))
            del q, k, v
        torch.cuda.empty_cache()
    if os.path.isdir(os.path.join(root, "deepspeed_tpu_torch", "ops", "sparse_attention")):
        from deepspeed_tpu_torch.ops.sparse_attention import block_sparse_kernel as bs

        layout = cs.sparse_path_layouts()["fixed"]._layout(cs.SPARSE_SHAPE[1])
        q, k, v = (t.detach() for t in cs.sparse_inputs(dev, seed=1))
        do = torch.randn_like(q)
        kw = dict(causal=True)
        o, lse = bs.block_sparse_attention_fwd(q, k, v, layout, cs.SPARSE_BLOCK, **kw)
        out["sparse_fwd_ms"] = cs.time_cuda(
            lambda: bs.block_sparse_attention_fwd(q, k, v, layout, cs.SPARSE_BLOCK, **kw))
        out["sparse_bwd_ms"] = cs.time_cuda(lambda: bs.block_sparse_attention_bwd(
            q, k, v, o, lse, do, layout, cs.SPARSE_BLOCK, **kw))
    if os.path.isfile(os.path.join(root, "deepspeed_tpu_torch", "ops", "transformer",
                                   "fused_ce.py")):
        from deepspeed_tpu_torch.ops.transformer import fused_ce as fc

        for label, (N, H, V) in (("ce_llama", cs.CE_MAIN), ("ce_gpt2", cs.CE_GPT2)):
            x, w, labels, g = cs.ce_path_inputs(N, H, V, dev, seed=1)
            lg, lse, _ = fc.fused_ce_fwd(x, w, labels)
            out[f"{label}_fwd_ms"] = cs.time_cuda(lambda: fc.fused_ce_fwd(x, w, labels))
            out[f"{label}_bwd_ms"] = cs.time_cuda(
                lambda: fc.fused_ce_bwd(lg, lse, labels, g, x, w))
            # each kernel of the two calls apart, from the profiler
            for d, fn in (("fwd", lambda: fc.fused_ce_fwd(x, w, labels)),
                          ("bwd", lambda: fc.fused_ce_bwd(lg, lse, labels, g, x, w))):
                groups = cp.profile(fn, f"{label} {d}", steps=10)["groups_ms"]
                for group, ms in groups.items():
                    if group.startswith("fused_ce_"):
                        out[f"{label}_{group[len('fused_ce_'):]}_kernel_ms"] = ms
            del x, w, lg
            torch.cuda.empty_cache()
    paged_turn(cs, dev, out)
    woq_turn(cs, dev, out)
    print(json.dumps(out), flush=True)


class _NoFiles:
    """A checkpoint engine that writes nothing: a save runs its gather only."""

    def makedirs(self, path, exist_ok=False):
        pass

    def create(self, tag):
        pass

    def save(self, state_dict, path):
        pass

    def commit(self, tag):
        return True


def ckpt_turn(root):
    """The checkpoint's host side on phase c3's engine (see the docstring)."""
    sys.path.insert(0, os.path.abspath(root))
    import importlib.util
    import shutil
    import time

    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    dev = torch.device("cuda", 0)
    engine = cs.ckpt_engine(dev, 4, 0)
    d = os.path.join(root, "build", "ckpt_ab")
    shutil.rmtree(d, ignore_errors=True)
    out = {"root": root}
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.save_checkpoint(d)
        out["save_s"] = time.perf_counter() - t0
        out["gather_first_s"] = engine.ckpt_stats["gather_s"]
        writer, engine.checkpoint_engine = engine.checkpoint_engine, _NoFiles()
        engine.save_checkpoint(d + "_none", save_latest=False)
        out["gather_again_s"] = engine.ckpt_stats["gather_s"] - out["gather_first_s"]
        engine.checkpoint_engine = writer
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.load_checkpoint(d)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        out["restore_s"] = engine.ckpt_stats["restore_s"]
    finally:
        shutil.rmtree(d, ignore_errors=True)

    from deepspeed_tpu_torch.utils.tree import tree_leaves

    leaves = [t for tree in (engine.master_params, engine.opt_state.m, engine.opt_state.v)
              for t in tree_leaves(tree)]

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[key] = time.perf_counter() - t0
        return res

    def pinned():
        return [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in leaves]

    def copies(bufs):
        for b, t in zip(bufs, leaves):
            b.copy_(t, non_blocking=True)

    bufs = timed("pinned_alloc_s", pinned)
    timed("d2h_pinned_s", lambda: copies(bufs))
    timed("d2h_pinned_again_s", lambda: copies(bufs))
    del bufs
    bufs = timed("pinned_alloc_again_s", pinned)
    del bufs
    timed("d2h_pageable_s", lambda: [t.cpu() for t in leaves])
    print(json.dumps(out), flush=True)


def paged_turn(cs, dev, out):
    """``paged_decode_attention`` at the last decode step's rows
    (``paged_decode_ms``) and at 256-row prefill chunks of one 2048-key
    sequence: its last (``paged_chunk_ms``) and its first
    (``paged_prompt_ms``)."""
    import torch

    from deepspeed_tpu_torch.ops.transformer import paged_attention as pa

    bf16 = torch.bfloat16
    q, kp, vp, tables, lens = cs.paged_case(len(DECODE_LENS), 32, 32, 128, 64, 64,
                                            list(DECODE_LENS), bf16, dev, seed=2)
    out["paged_decode_ms"] = cs.time_cuda(lambda: pa.paged_decode_attention(q, kp, vp, tables,
                                                                             lens))
    _, kp, vp, table, _ = cs.paged_case(1, 32, 32, 128, 64, 64, [2048], bf16, dev, seed=3)
    q = torch.randn(256, 32, 128, device=dev, generator=torch.Generator(device=dev)
                    .manual_seed(3)).to(bf16)
    tables = table.expand(256, -1).contiguous()
    lens = torch.arange(2048 - 255, 2049, dtype=torch.int32, device=dev)
    out["paged_chunk_ms"] = cs.time_cuda(lambda: pa.paged_decode_attention(q, kp, vp, tables,
                                                                            lens))
    lens = torch.arange(1, 257, dtype=torch.int32, device=dev)
    out["paged_prompt_ms"] = cs.time_cuda(lambda: pa.paged_decode_attention(q, kp, vp, tables,
                                                                             lens))
    del q, kp, vp
    torch.cuda.empty_cache()


def woq_turn(cs, dev, out):
    """``woq_matmul`` at the serving shapes: ``woq_{bits}_{In}x{Out}_r{rows}_ms``."""
    import itertools

    import torch

    from deepspeed_tpu_torch.ops.quantizer import woq, woq_gemm

    gen = torch.Generator(device=dev).manual_seed(11)
    for In, Out in cs.WOQ_SHAPES:
        w = torch.randn(In, Out, device=dev, generator=gen).mul_(0.02)
        for bits in (8, 6, 4):
            codes, scale = woq.quantize_leaf(w, bits, 128)
            wbytes = codes.numel() + scale.numel() * 4
            copies = [(codes, scale)] + [(codes.clone(), scale.clone())
                                         for _ in range(-(-150_000_000 // wbytes))]
            for rows in (8, 37, 256):
                x = torch.randn(rows, In, device=dev, generator=gen).to(torch.bfloat16)
                cyc = itertools.cycle(copies)
                out[f"woq_{bits}_{In}x{Out}_r{rows}_ms"] = cs.time_cuda(
                    lambda: woq_gemm.woq_matmul(x, *next(cyc), bits))
            del copies
        del w
        torch.cuda.empty_cache()


def main(old, new, turn_flag="--turn"):
    old, new = os.path.abspath(old), os.path.abspath(new)  # each turn runs in its root
    runs = []
    for label, root in (("old", old), ("new", new), ("new", new), ("old", old)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), turn_flag, root],
                              cwd=root, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"turn {label} ({root}) failed:\n{proc.stderr[-4000:]}")
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(dict(r, side=label)), flush=True)
        runs.append((label, r))
    ab = {}
    for key in sorted({k for _, r in runs for k in r if k.endswith(("_ms", "_s"))}):
        for side in ("old", "new"):
            vals = [r[key] for s, r in runs if s == side and key in r]
            if vals:
                ab.setdefault(key, {})[side] = sum(vals) / len(vals)
    print(json.dumps({"ab": ab}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--turn":
        turn(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == "--ckpt-turn":
        ckpt_turn(sys.argv[2])
    elif len(sys.argv) == 4 and sys.argv[1] == "--ckpt":
        main(sys.argv[2], sys.argv[3], "--ckpt-turn")
    elif len(sys.argv) == 3:
        main(sys.argv[1], sys.argv[2])
    else:
        raise SystemExit(__doc__)
