#!/usr/bin/env python3
"""Drive the port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

It imports ``deepspeed_tpu_torch`` from this checkout (never JAX) and runs,
in order; any failure exits non-zero and prints no result:

1. the card's name and power limit (``nvidia-smi``); the CUDA kernels are
   built from the checkout's sources into ``build/kernels/`` (set-up time);
2. each kernel against its plain PyTorch version at the slice's shapes
   (llama-7b's heads, llama-70b's GQA heads, a head_dim-64 model), bfloat16
   at atol/rtol 1e-2 and float32 at atol 1e-5, ragged lens with 1, a
   non-multiple of the block size, a full table and 0; then at the main
   path's table (64 slots of 64 keys, 8 partitions a row) llama-7b's heads
   in fp32, bf16 and fp16, head_dim 32 (llama-tiny's heads) and a GQA-8
   case, with lens around each partition boundary (a block's edge, where
   another partition wakes, and 8 blocks', where all are awake), a full
   table and 0, each call repeated and held bitwise equal; and one row
   alone, among 8 rows and among 256 rows, bitwise equal;
3. the slice at a small size: the paged engine on the card against the same
   engine on the CPU (plain attention), same weights and requests, float32
   logits at atol 1e-4, for a head_dim-64 model and for llama-tiny's heads
   (head_dim 32);
4. the main path: llama-7b at full width and depth, random bf16 weights
   from a seeded generator, served by ``InferenceEngineV2(paged=True)``:
   prompts of 37, 300, 1000 and 2100 tokens, a 640-token arrival after
   decode step 4, a request repeating that prompt after step 8 (a
   full-prompt prefix hit, so a copy-on-write block copy), 32 greedy decode
   steps, then a flush of every request. The kernels' launch counts are
   set to 0 just before and read just after. The engine's steps are captured
   CUDA graphs (its default): a key's first step runs eagerly and is
   captured, later ones replay, and each replay adds to the counts what its
   capture counted; two more decode rounds, replays, are traced with
   ``torch.profiler``: the paged (and in q3 WOQ) kernels it saw run, by
   name, must equal what the replays added to the counts and num_layers x
   rounds (x 7 projections);
5. the paged-attention kernel on the engine's own pool (layer 0) with the
   tables and lens of the last decode step: checked against the plain
   version and timed with CUDA events beside the plain version,
   ``scaled_dot_product_attention`` over the gathered cache, and the bound;
6. serving through ``ContinuousBatchScheduler`` on phase 4's engine (its
   weights, no second copy), preemption on, the real clock (admission
   without its age term, so that the schedule is a function of the traffic
   alone and a replay can be held to it): (c) first
   ``sample_or_argmax`` on the card against the CPU over a seeded
   (64, 32000) block of bf16-rounded fp32 logits across temperatures, top-k
   and top-p (threefry keys, bits and uniforms bitwise, greedy rows bitwise,
   sampled rows equal except where a draw's top-2 margin of ``gumbel + x``
   is at most 1e-4 or a token sits within 1e-6 of the nucleus edge: at most
   1% of the draws, and the count is printed), and the cost of the
   engine's selection call at 8 rows; then
   phase 4's four prompts greedy and four sampled requests over the
   640-token and 300-token prompts (temperature 0.7 and 1.0, top-k 0 and
   50, top-p 1.0 and 0.9, seeds 1-4), 32 new tokens each; once all 8 slots
   are live and decoding a priority-1000 arrival preempts the lowest
   priority, a sampled request, which is re-admitted later; then a greedy
   request that stops at its first even token and a sampled one whose logit
   bias forces token 1234. (a) every request finishes and ``close()``
   drains, the paged kernel launched num_layers x ragged steps times; (b)
   the same traffic again after a rebuild runs the same ragged steps (each
   step's tokens, tables, starts, logit rows and slots) and gives bitwise
   the same streams, the preempted one's included, and so do three further
   runs on the same engine, from the graphs already captured (no new one);
   (d) the stop ends its stream, the biased
   token is every token, and a fan-out ``n=2`` child 0 equals the ``n=1``
   stream of the same seed; (e) at phase 3's head_dim-64 fp32 size the
   scheduler on the card against the scheduler on the CPU, greedy and
   sampled, streams equal under the same margin rule. A
   ``{"serve_summary": ...}`` line gives the card, requests, tokens, wall
   seconds, TTFT/TPOT p50/p90, preemptions, prefix hits, paged launches and
   host ms a scheduler step with the engine's share.
7. the rest of the serving surface, on phase 4's weights (shared, not
   copied) in a new engine at ``decode_horizon=4``, made after phase 4's
   pool is freed: (a) phase 4's traffic eager (``engine.capture = False``),
   captured and replayed, from a rebuild each: bitwise equal streams and
   equal launch counts (32 x ragged steps), and phase 4's decode step timed
   eager and captured (host clock; device time from ``torch.profiler``);
   the paged kernels the profiler saw run equal to the launches counted
   and to 32 x steps, eager and replayed;
   (b) 8 single decode steps against two fused K=4 steps from the same
   state, greedy and with two sampled rows, bitwise; (c)-(d) 6 requests
   (4 greedy, 2 sampled, 48 new tokens) of a repeated 10-token pattern
   through the plain scheduler (horizon 1), the fused horizon, the target
   as its own draft model (window 64) and ``pipelined=True``, then with
   the greedy prompts 4000 distinct tokens each (so the prompt lookup
   drafts whenever the model gives a token of its prompt) through the plain
   scheduler and a prompt-lookup proposer: fused and pipelined streams
   bitwise the plain ones; a speculative stream may turn from the plain
   one only where the plain engine's logits there give a margin within 8
   bf16 units of the top logit (the verify GEMMs run 4x the rows), each
   turn printed; both speculative runs must verify; TTFT and TPOT stamped on the host clock
   when the step that brought the token returns; (e) at phase 3's size
   each option on the card against the CPU under the margin rule (the
   prompt-lookup run must verify), and the target as its own draft
   model on short greedy prompts: every draft accepted, streams bitwise the
   plain run's, its window forward through the flash kernel; a small bf16
   int8 WOQ engine's speculative streams (its verify rows on the
   tensor-core WOQ kernel, its decode rows on the GEMV) against its plain
   ones under (c)'s rule; (f) the step
   programs within the JAX engine's bounds (ragged 4, fused 1, verify 1). A
   ``{"horizon_summary": ...}`` line gives the card, host and device ms a
   decode step eager and captured, tokens/s, TTFT and TPOT a mode,
   acceptance, the graph counts and launches.
8. slot mode on phase 4's weights (shared): (a) the flash forward with
   per-row offsets and kv rows (llama-7b's heads over an 8-slot, 4096-token
   cache) against its plain version in bf16 and fp32: a decode call (8
   rows, one query each, four live at offsets 36/299/999/2099 and four at
   0), a 256-row chunk at offset 256 and a 16-row bucket, each call
   repeated bitwise, and with zero offsets bitwise the forward without
   them; (b) the decode and chunk calls timed with CUDA events beside the
   plain version, SDPA with a boolean mask over the same cache rows and the
   bound; (c) ``InferenceEngineV2`` with its defaults (slot mode, 8 slots,
   4096 tokens) serving phase 4's traffic: flash forward launches = 32
   layers x slot dispatches, the slot programs within the JAX engine's
   bounds (32 a bucket, 2 decode), one captured graph a program, and the
   streams equal to phase 7's paged run of the same traffic, turning only
   where the slot engine's logits give a margin within 8 bf16 units (the
   engines' GEMMs and attention kernels differ); the decode step replayed,
   host clock and traced device time, the traced flash kernels = the
   replays' counts; the memory reserved; a scheduler run over the slot
   engine finishing every request; (e) at phase 3's size the slot engine
   on the card against the CPU, fp32 logits at atol 1e-4. A
   ``{"slot_summary": ...}`` line;
9. the KV tiers on phase 4's weights: a paged engine with a 32-block pool
   (1 GiB), a 32-block host tier and a 16-block NVMe tier in a temporary
   directory (removed at the end), through
   ``ContinuousBatchScheduler(swap_preemption=True)``: 12 prompts of 384
   tokens (demotion and NVMe spills), the same prompts again newest first
   (promotion from the host tier and loads from disk), then four decoding
   requests and phase 6's priority-1000 arrival (swap-out, swap-in). Each
   of demoted, promoted, NVMe spilled and loaded, swap-out and swap-in > 0;
   every block that landed back (promotion, swap-in, an NVMe read) bitwise
   the bytes it left with; the run again with ``transfer_overlap=False``
   bitwise (streams, counters, the transfers submitted) and with preemption
   by replay (streams equal but for turns at a near tie); the ledger
   conserved. A ``{"tier_summary": ...}`` line gives the counters, the D2H
   and H2D bandwidth EMAs (GB/s) and the milliseconds a swapped-in block.
10. the engine pool on phase 4's weights (shared by every replica, never
   copied), after phase 9's engine is freed: paged llama-7b replicas of 4
   slots and 128 blocks of 64 tokens (``POOL_ENGINE``), ``age_weight=0``,
   serving ``pool_requests``: four requests sharing a 640-token prefix
   (the first alone until it has a token), phase 4's four prompts and two
   sampled requests (seeds 1-2), 24 new tokens each. (a) ``EnginePool.build
   (factory, 2)``: the shared-prefix requests placed on the replica that
   holds the prefix (placement hits >= 3), the same traffic from
   ``rebuild()`` bitwise (streams and owners), and the pool's streams
   against one engine's under phase 8's rule (a sampled row may turn where
   its two tokens' ``gumbel + x`` scores are within 8 bf16 units over the
   temperature, or either sits on the top-k boundary or the nucleus edge);
   (b) a decoding request migrated mid-stream, then ``rebalance()``; (c) a
   ``FaultInjector`` ``device_lost`` at replica 1's third ``decode_step``,
   absorbed by journal replay on replica 0; (d) ``rolling_update`` to v2
   (phase 4's tree with a new final norm and head) mid-traffic: no
   admission rejected, the graphs captured again, a request admitted after
   it against one v2 engine; (e) a ``DisaggPool`` (prefill, decode): every
   handoff by KV transfer, every exported block bitwise the source's and
   every landed block bitwise the payload (``HandoffProbe``), a corrupted
   payload refused with ``TransferCorruptError``, and corrupted handoffs
   falling back to replay; (f) a durable journal in a temporary directory
   (removed at the end), the pool dropped mid-traffic and restored on
   fresh engines: every request finishes with its committed prefix kept;
   (g) ``scale_to(3)`` then ``scale_to(2)`` mid-traffic. The paged kernel's
   count is set to 0 before (a) and read after (g): 32 layers x the ragged
   steps of every replica, replays included. A ``{"pool_summary": ...}``
   line gives the card, tokens/s, TTFT/TPOT, host ms a pool step, the
   handoffs and ms a handoff, and the memory reserved at 2 and 3 replicas.

Then weight-only-quantized serving (the bf16 engine is freed first):

q1. the WOQ kernels against their plain version: 8, 6 and 4 bits at
    llama-7b's (In, Out) with group 128, bf16 x at rows 1, 8, 37, 100, 129,
    256 and 300 (the few-rows kernel, then the tensor-core kernel's 64-row
    tile, 256-row tiles holding 100-256 rows, and two of them), fp32 x at
    1, 8, 37 and 256, fp16 x at 37 and
    256; then group 64 and In 4000 (a group that is not a power of two, a K
    tail) at 8 and 256 rows, (4032, 1032) with group 96 at 8 rows (Out a
    multiple of 8 but not of the GEMV's column tile), and codes holding
    every byte value; atol 1e-4 and rtol 1e-5 for every x dtype (both form
    the weight in fp32 and round it to x's dtype, so only an fp32 sum's
    order differs), each 16-bit call run twice and held bitwise equal, and
    each 8-row call's rows 0 and 5 computed alone and held bitwise equal to
    its rows;
q2. the WOQ engine small (llama, hd 64, fp32, int8/int6/int4 at group 64)
    on the card against the same on the CPU: logits at atol 1e-4, greedy
    streams equal;
q3. the WOQ main path: phase 4's model, engine and traffic over
    ``quantize_model(num_bits=8, group_size=128)`` of the same random bf16
    weights, quantized on the card; the WOQ and paged kernels' counts set to
    0 just before and read just after: 7 projections x 32 layers and 32
    layers a ragged step, the 256-row steps' projections through the
    tensor-core kernel (``tiled_launches``). Then int6 and int4 with 12
    decode steps;
q4. the WOQ kernels at the main path's shapes, decode (8), a short prefill
    (37) and prefill (256) rows, each width, timed with CUDA events beside
    the plain version, a bf16 ``torch.matmul`` on the weight dequantized
    beforehand, and the bound.

Then the training slice:

a. the flash-attention forward (out, lse) and backward (dq, dk, dv) kernels
   against their plain versions: llama-7b's heads (B 2, S 2048), llama-70b's
   GQA heads (nh 64, kvh 8, S 1024), head_dim 32, 64 and 256, S 1000 and 130
   (tail tiles), GQA 8, Sq 130 against Skv 1000, causal and not; float32 at
   atol 1e-5 (gradients at 1e-5 of max(1, their max)), bfloat16 and float16
   at atol/rtol 1e-2 (gradients at 1e-2 of their max), each 16-bit forward
   and backward run twice and held bitwise equal;
b. the training engine small (llama, hd 64, GQA group 2, fp32, Adam eps
   1e-6) on the card against the same engine on the CPU: 3 ``train_batch``
   steps, losses at rtol 1e-5, parameters at atol 1e-5;
c. the training main path: ``initialize`` -> ``train_batch`` x 6 on llama-7b
   at full width and 4 of its 32 layers, random weights from a seeded
   generator, bf16 with an fp32 master, AdamW, WarmupLR, one fixed 2 x 2048
   batch. The kernels' launch counts are set to 0 just before and read just
   after: 4 layers x 6 steps of each flash kernel. The losses must be finite
   and fall, and the eval loss on a fresh random batch stay above ln(V)/2
   (the fall is memorisation of the fixed batch, not a causal leak);
d. the flash kernels at the main path's shape timed with CUDA events beside
   their plain versions, ``scaled_dot_product_attention`` (forward, and the
   backward of its graph) and their bounds;
c2. phase c's model, batch and settings with ``dropout=0.1``, 6 steps, the
   flash counts set to 0 just before and read just after (4 layers x 6
   steps each): losses finite and falling; step 1's layer-0 masks (the
   attention output's and the MLP output's, (2, 2048, 4096)) drawn on the
   card bitwise the CPU's from the same keys, and those keys the
   reference's chain; the last step traced with ``torch.profiler``: the
   device ms of the threefry draws (``prng.bernoulli`` annotated) beside
   the step's, on a ``{"dropout_summary": ...}`` line.
c3. checkpoints, on phase c's model, batch and settings, the flash counts
   set to 0 just before and read just after (4 layers, or 2 when the
   checkout's disk lacks room for a tag, times the steps, + 1 x (d)'s): (a)
   3 steps, a synchronous ``save_checkpoint`` (~12.9 GB a tag), 3 steps;
   (a') 6 steps again from the same weights, bitwise (a)'s losses; (b) a
   fresh engine from other weights ``load_checkpoint``: every parameter,
   master, moment, Adam's step, the scaler, the lr state, the counters and
   the key bitwise the saved ones, the next 3 losses bitwise (a)'s; (c) (a)
   with ``async_save``, 3 steps timed under the write, the tag loaded and
   checked as in (b); (d) at depth 1, ``TrainingSupervisor`` over
   ``InjectedTrainEngine`` with a transient fault and a device loss two
   steps after the save at step 3: the loss curve bitwise the fault-free
   one, 1 recovery, 2 replayed steps; (e) a byte of (d)'s newest npz
   flipped: a load from ``latest`` falls back one tag, a load of that tag
   by name raises ``CheckpointCorruptError``. The tags go under
   ``build/ckpt_c3`` and are deleted; times on a ``{"ckpt_summary": ...}``
   line beside the card's name and power limit.

Then block-sparse attention:

s1. the block-sparse forward (out, lse) and backward (dq, dk, dv) kernels
    against their plain versions, bf16 and fp32: Fixed and BigBird at
    llama-7b's heads (S 2048), BSLongformer and Variable (random blocks)
    with GQA 2 at head_dim 64 and 256, per-head Fixed patterns with
    horizontal globals, a layout with empty query blocks (causal and not)
    and block 256; tolerances as in phase a; each backward run twice and
    held bitwise equal;
s2. the sparse path: ``SparseSelfAttention`` over
    ``FixedSparsityConfig(num_local_blocks=4, num_global_blocks=1,
    attention="unidirectional")`` and ``BigBirdSparsityConfig()`` at
    llama-7b's heads, bf16 (1, 8192, 32, 128) q, k, v from a seeded
    generator, 3 forward + backward iterations each under
    ``loss = (out.float() ** 2).sum()``. The counts are set to 0 just
    before and read just after: 3 + 3 launches per op. Outputs, losses and
    gradients must be finite, and heads 0-3 agree with the plain version
    on the 4-head slice (the plain version at 32 heads would need 8.6 GB a
    score tensor);
s3. each op's kernels at that shape timed with CUDA events beside the plain
    version (4-head slice, scaled by 8), ``scaled_dot_product_attention``
    with the layout as a boolean mask (and its backward), dense SDPA at the
    same shape (causal for Fixed) and the bounds, on a
    ``{"sparse_summary": ...}`` line.

Then fused linear cross-entropy (``fused_ce_loss``):

ce1. the fused-CE forward (lg, lse, nll) and backward (dx, dw) kernels
     against their plain versions, fp32, bf16 and fp16, at (N, H, V) of
     (256, 128, 768), (2560, 128, 640) (a vocab not a multiple of the
     forward's chunk), (256, 8192, 256) (the gate's H edge), (384, 640,
     50304) (each 128 mod 256: a half tile on every side of the 16-bit
     kernels' 128 x 256 tiles), llama-7b's head (4096, 4096, 32000) and
     gpt2-6.7b's (4096, 4096, 50304), labels including -1 and V, the forward also
     without the residual: lse and nll at atol 1e-4; lg, dx and dw in
     16 bits elementwise at rtol x (|ref| + median |ref|), rtol 1e-2 for
     bf16 and 2e-3 for fp16 (one rounding each way); fp32 lg at atol 1e-4,
     fp32 dx and dw at 1e-5 of max(1, their max); each forward and backward
     run twice and held bitwise equal. At the main shape the 16-bit grads
     check must also reject two planted faults fed to the real backward
     kernels: every p zeroed (lse + 1e4) and p from the next row's lse;
ce2. the path: ``fused_ce_loss`` at llama-7b's head, bf16 x (4096, 4096)
     with RMS-normalised rows, W (32000, 4096) ~ N(0, 0.02^2), int32 labels
     and an fp32 g from a seeded generator, 3 iterations of the loss and
     ``autograd.grad((nll * g).sum(), (x, w))``. Every count is set to 0
     just before and read just after: 3 + 3 fused-CE launches, no other
     kernel. nll, lg, dx and dw finite and within ce1's tolerances of the
     plain versions (the backward's on the forward kernel's residual, as in
     ce1), and the planted faults rejected there too; then one call under ``torch.no_grad()`` whose peak memory
     rise stays below the (N, V) bf16 residual's bytes;
ce3. the kernels at that shape and at gpt2-6.7b's tied head (V 50304)
     timed with CUDA events beside the plain versions, the unfused path a
     caller takes when ``fused_ce_loss`` raises (``F.linear``, fp32
     ``logsumexp`` minus the gold logit, and that graph's backward) and the
     bounds, on a ``{"ce_summary": ...}`` line.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (1e-2, 1e-2), torch.float16: (1e-2, 1e-2)}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def time_cuda(fn, warmup=5, iters=25):
    """Median device milliseconds of one ``fn`` call over ``iters`` calls.
    A sleep kernel holds the stream while the host enqueues every call with
    a CUDA event between each two, so each interval is device time only,
    not the host's launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    torch.cuda._sleep(100_000_000)  # ~50 ms of clock cycles: longer than the enqueueing
    events[0].record()
    for i in range(iters):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return float(np.median([events[i].elapsed_time(events[i + 1]) for i in range(iters)]))


def paged_case(B, nh, kvh, hd, BS, MAXB, lens, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    NB = 1 + B * MAXB
    q = torch.from_numpy(rng.standard_normal((B, nh, hd)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal((kvh, NB, BS, hd)).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal((kvh, NB, BS, hd)).astype(np.float32))
    tables = np.zeros((B, MAXB), np.int32)
    perm = rng.permutation(np.arange(1, NB)).astype(np.int32)
    for b, n in enumerate(lens):
        nb = -(-n // BS)
        tables[b, :nb] = perm[b * MAXB:b * MAXB + nb]
    return (q.to(dev, dtype), kp.to(dev, dtype), vp.to(dev, dtype),
            torch.from_numpy(tables).to(dev), torch.tensor(lens, dtype=torch.int32, device=dev))


def compare(out, ref, dtype):
    """Max abs error; raises if any element is outside atol + rtol * |ref|."""
    atol, rtol = TOL[dtype]
    err = (out.float() - ref.float()).abs()
    bad = err > atol + rtol * ref.float().abs()
    check(out.shape == ref.shape and out.dtype == ref.dtype,
          f"shape/dtype {tuple(out.shape)}/{out.dtype} vs {tuple(ref.shape)}/{ref.dtype}")
    check(torch.isfinite(out.float()).all().item(), "non-finite kernel output")
    check(not bad.any().item(),
          f"{int(bad.sum())} elements outside atol {atol} rtol {rtol} (max err {err.max():.3g})")
    return float(err.max())


def kernels_vs_plain(pa, dev):
    """Phase 2: the paged-attention kernel against its plain version."""
    BS, MAXB = 64, 16
    lens = [1, 100, MAXB * BS, 0, 777, BS]
    worst = 0.0
    for label, nh, kvh, hd in (("llama-7b heads", 32, 32, 128),
                               ("llama-70b GQA heads", 64, 8, 128),
                               ("gpt2-125m heads (hd 64)", 12, 12, 64)):
        for dtype in (torch.bfloat16, torch.float32):
            q, kp, vp, tables, ln = paged_case(len(lens), nh, kvh, hd, BS, MAXB, lens,
                                               dtype, dev)
            out = pa.paged_decode_attention(q, kp, vp, tables, ln)
            torch.cuda.synchronize()
            ref = pa.paged_decode_attention_plain(q, kp, vp, tables, ln)
            err = compare(out, ref, dtype)
            check(not out[lens.index(0)].any().item(), "lens == 0 row is not zero")
            worst = max(worst, err)
            log(f"kernel vs plain: paged_decode_attention {label} nh={nh} kvh={kvh} "
                f"hd={hd} BS={BS} {str(dtype)[6:]}: max_abs_err {err:.3g} ok")
    # the main path's table: 64 slots of 64 keys, 8 partitions a row (slot j
    # to partition j % 8); lens around the edges where a partition wakes
    # (BS) and where all are awake (8 BS), a full table and 0
    BS, MAXB = 64, 64
    parts = pa.plan(MAXB, BS, 128)[0]
    P = parts * BS
    lens = [1, BS - 1, BS, BS + 1, P - 1, P, P + 1, 2132, MAXB * BS - 1, MAXB * BS, 0]
    for label, nh, kvh, hd, dtypes in (
            ("llama-7b heads", 32, 32, 128, (torch.float32, torch.bfloat16, torch.float16)),
            ("llama-tiny heads (hd 32)", 8, 4, 32, (torch.float32, torch.bfloat16,
                                                    torch.float16)),
            ("GQA-8 heads", 64, 8, 128, (torch.bfloat16,))):
        for dtype in dtypes:
            q, kp, vp, tables, ln = paged_case(len(lens), nh, kvh, hd, BS, MAXB, lens, dtype,
                                               dev, seed=5)
            out = pa.paged_decode_attention(q, kp, vp, tables, ln)
            torch.cuda.synchronize()
            err = compare(out, pa.paged_decode_attention_plain(q, kp, vp, tables, ln), dtype)
            check(not out[lens.index(0)].any().item(), "lens == 0 row is not zero")
            check(torch.equal(out, pa.paged_decode_attention(q, kp, vp, tables, ln)),
                  f"paged_decode_attention {label} {dtype}: a repeat differs")
            worst = max(worst, err)
            log(f"kernel vs plain: paged_decode_attention {label} nh={nh} kvh={kvh} hd={hd} "
                f"BS={BS} MAXB={MAXB} ({parts} partitions) lens {lens} {str(dtype)[6:]}: "
                f"max_abs_err {err:.3g}, repeat bitwise equal ok")
    # a row's output does not depend on its batch: alone, among 8, among 256
    gen = torch.Generator(device=dev).manual_seed(6)
    nh, NB = 32, 1 + 8 * MAXB  # rows share the pool's blocks (as prefix hits do)
    kp = torch.randn(nh, NB, BS, 128, device=dev, generator=gen).to(torch.bfloat16)
    vp = torch.randn(nh, NB, BS, 128, device=dev, generator=gen).to(torch.bfloat16)
    q = torch.randn(256, nh, 128, device=dev, generator=gen).to(torch.bfloat16)
    tables = torch.randint(1, NB, (256, MAXB), device=dev, generator=gen, dtype=torch.int32)
    ln = torch.randint(0, MAXB * BS + 1, (256,), device=dev, generator=gen,
                       dtype=torch.int32)
    full = pa.paged_decode_attention(q, kp, vp, tables, ln)  # one CTA a row
    for rows in ([131], list(range(128, 136))):  # the partitions split over clusters
        idx = torch.tensor(rows, device=dev)
        args = (q[idx].contiguous(), kp, vp, tables[idx].contiguous(), ln[idx].contiguous())
        part = pa.paged_decode_attention(*args)
        check(torch.equal(part, full[idx]),
              f"paged_decode_attention: rows {rows[0]}..{rows[-1]} alone differ from the "
              "same rows among 256")
        worst = max(worst, compare(part, pa.paged_decode_attention_plain(*args), torch.bfloat16))
    # the rows of a prefill chunk hold one table: a CTA takes 16 of them and
    # reads each K/V tile once for all 16; each row alone (its partitions
    # split over a cluster) is bitwise its row of the chunk
    table = torch.randperm(MAXB, device=dev, generator=gen).to(torch.int32) + 1
    tables = table[None].repeat(256, 1).contiguous()
    for lo in (1, 1793):  # a 256-token prompt, and its 8th chunk
        ln = torch.arange(lo, lo + 256, device=dev, dtype=torch.int32)
        full = pa.paged_decode_attention(q, kp, vp, tables, ln)
        for rows in ([0], [200], list(range(3, 11)), list(range(248, 256))):
            idx = torch.tensor(rows, device=dev)
            args = (q[idx].contiguous(), kp, vp, tables[idx].contiguous(), ln[idx].contiguous())
            part = pa.paged_decode_attention(*args)
            check(torch.equal(part, full[idx]),
                  f"paged_decode_attention: chunk rows {rows[0]}..{rows[-1]} (lens from {lo}) "
                  "alone differ from the same rows in the chunk")
            worst = max(worst, compare(full[idx], pa.paged_decode_attention_plain(*args),
                                       torch.bfloat16))
    torch.cuda.synchronize()
    log("paged_decode_attention: a row alone, among 8 rows and among 256 rows bitwise equal, "
        "and a 256-row chunk of one table (lens 1..256, 1793..2048) bitwise equal to its "
        "rows alone, all equal to the plain version ok")
    return worst


def serve(engine, prompts, arrival, decode_steps, greedy, choices=None, stats=None,
          launches=None):
    """The main path through the engine's public surface: ``put`` the
    prompts, then ``decode_step`` rounds; ``arrival`` arrives after step 4
    and again (the same prompt, a full prefix hit) after step 8. Returns
    the per-call outputs and the tokens fed (``choices`` replays another
    run's tokens). ``stats`` collects host-clock times (each call ends in
    the step's device-to-host copy) and, with ``launches`` (a function
    reading the kernel's count), the launches of each decode step."""
    records, fed = [], []
    it = iter(choices or ())

    def choose(out):
        toks = {u: (v if greedy else int(np.argmax(v))) for u, v in sorted(out.items())}
        toks = next(it) if choices is not None else toks
        fed.append(toks)
        return dict(toks)

    t0 = time.perf_counter()
    out = engine.put(list(prompts), [list(p) for p in prompts.values()], greedy=greedy)
    if stats is not None:
        stats["prefill_s"] = time.perf_counter() - t0
    records.append(out)
    uid = max(prompts)
    for step in range(decode_steps):
        toks = choose(out)
        if arrival is not None and step in (4, 8):
            uid += 1
            arrived = engine.put([uid], [list(arrival)], greedy=greedy)
            records.append(arrived)
            toks.update(choose(arrived))
        t0, n0 = time.perf_counter(), launches() if launches else 0
        out = engine.decode_step(toks, greedy=greedy)
        if stats is not None:
            stats.setdefault("decode_s", []).append(time.perf_counter() - t0)
            if launches:
                stats.setdefault("decode_launches", []).append(launches() - n0)
        records.append(out)
    return records, fed


def small_slice_vs_cpu(dev, **widths):
    """Phase 3: the slice on the card against the plain path on the CPU
    (``widths`` override the head_dim-64 model's heads: llama-tiny's own,
    hd 32)."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models import build_model

    model = build_model("llama-tiny", vocab_size=1024, num_layers=2, intermediate_size=512,
                        max_seq_len=512,
                        **dict(dict(hidden_size=256, num_heads=4, num_kv_heads=2), **widths))
    params = model.init_params(torch.Generator().manual_seed(0))
    opts = dict(paged=True, dtype=torch.float32, max_seqs=4, block_size=16,
                prefill_chunk=64, token_budget=64, prefix_cache=True)
    rng = np.random.default_rng(1)
    prompts = {1: rng.integers(0, 1024, 20), 2: rng.integers(0, 1024, 150)}
    arrival = rng.integers(0, 1024, 48)
    ref, fed = serve(InferenceEngineV2(model, params, device="cpu", **opts),
                     prompts, arrival, 12, greedy=False)
    got, _ = serve(InferenceEngineV2(model, params, device=dev, **opts),
                   prompts, arrival, 12, greedy=False, choices=fed)
    worst = 0.0
    for g, r in zip(got, ref):
        check(sorted(g) == sorted(r), "card and CPU engines returned different uids")
        for u in r:
            err = float(np.abs(g[u] - r[u]).max())
            check(np.isfinite(g[u]).all() and err <= 1e-4,
                  f"uid {u}: card vs CPU logits differ by {err:.3g} (atol 1e-4)")
            worst = max(worst, err)
    cfg = model.config
    log(f"slice on the card vs CPU (llama {cfg.hidden_size}-wide, {cfg.num_heads} heads of "
        f"{cfg.head_dim}, 2 layers, fp32): {len(got)} calls, max_abs_err {worst:.3g} ok")


#: the counters the replay trace checks, each with the kernels (by name)
#: that one counted launch runs on the device
KERNEL_FAMILIES = (
    ("paged_attention.launches", ("paged_decode_fma_kernel", "paged_decode_mma_kernel")),
    ("woq_gemm.launches", ("woq_gemv_kernel", "woq_mma_kernel", "woq_tiled_fma_kernel")),
    ("woq_gemm.tiled_launches", ("woq_mma_kernel", "woq_tiled_fma_kernel")),
)


def family_counters(pa, wq):
    return [pa.launches, wq.launches, wq.tiled_launches]


def kernel_runs(prof):
    """The kernels of each of KERNEL_FAMILIES that a ``torch.profiler``
    trace saw run on the device, by name: a graph's replay runs its kernels
    with no Python, so this is what the counters' replay bookkeeping is held
    against."""
    ran = [0] * len(KERNEL_FAMILIES)
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        for i, (_, names) in enumerate(KERNEL_FAMILIES):
            if any(n in e.key for n in names):
                ran[i] += e.count
    return ran


def check_kernel_runs(ran, counted, want, what):
    """Kernels run (trace), launches counted (the wrappers' counters, a
    replay's added by the engine) and the expected layers x steps agree."""
    names = [n for n, _ in KERNEL_FAMILIES]
    check(ran == counted == want, f"{what}: kernels run (trace) {dict(zip(names, ran))}, "
          f"counted {dict(zip(names, counted))}, expected {dict(zip(names, want))}")


def replay_trace(engine, toks, pa, wq, projections, steps=2):
    """``steps`` more decode rounds of the main path, each a replay of the
    graph its run captured, traced with ``torch.profiler``: the paged and
    WOQ kernels the device ran, counted by name, against what the replays
    added to the counters and against num_layers x steps (x ``projections``
    WOQ projections, all on the few-rows kernel)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    L, graphs = engine.cfg.num_layers, engine.captured_graphs
    c0 = family_counters(pa, wq)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            toks = engine.decode_step(toks, greedy=True)
        torch.cuda.synchronize()
    counted = [a - b for a, b in zip(family_counters(pa, wq), c0)]
    check(engine.captured_graphs == graphs, "the traced decode rounds captured a new graph")
    ran = kernel_runs(prof)
    check_kernel_runs(ran, counted, [L * steps, projections * L * steps, 0],
                      f"{steps} replayed decode rounds")
    return {"steps": steps, "kernels_ran": ran, "launches_counted": counted}


def main_path(pa, dev, bits=None, decode_steps=32, wq=None):
    """Phase 4 (and q3 with ``bits``): llama-7b at full width and depth
    through the paged engine, bf16 weights, or with ``bits`` those weights
    through ``quantize_model(num_bits=bits, group_size=128)`` on the card
    (the bf16 tree is freed before the engine is built) and every block
    projection through the WOQ kernel (``wq``, its module)."""
    from deepspeed_tpu_torch.inference.quantization import quantize_model
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models import build_model

    model = build_model("llama-7b")
    cfg = model.config
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               dtype=torch.bfloat16)
    woq = None
    if bits is not None:
        bf16_bytes = sum(t.numel() * t.element_size() for t in params["blocks"].values())
        tq = time.perf_counter()
        _, params = quantize_model(model, params, num_bits=bits, group_size=128)
        torch.cuda.synchronize()
        woq = {"bits": bits, "group_size": 128,
               "quantize_s": time.perf_counter() - tq,
               "blocks_bf16_bytes": bf16_bytes,
               "blocks_quantized_bytes": sum(t.numel() * t.element_size()
                                             for t in params["blocks"].values())}
    engine = InferenceEngineV2(model, params, paged=True, dtype=torch.bfloat16,
                               max_seqs=8, block_size=64, prefill_chunk=256,
                               token_budget=256, prefix_cache=True, device=dev)
    del params
    torch.cuda.synchronize()
    label = f"int{bits} (group 128)" if bits else "bf16"
    log(f"set-up: llama-7b ({cfg.num_layers} layers, hidden {cfg.hidden_size}) random "
        f"{label} weights and a {engine.block_mgr.num_blocks}x{engine.block_mgr.block_size}"
        f" block pool in {time.perf_counter() - t0:.3f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    if woq is not None:
        codes = {k: v for k, v in engine.params["blocks"].items() if "::" in k}
        check(all(v.dtype == (torch.float32 if k.endswith("::scale") else torch.int8)
                  and v.device.type == "cuda" for k, v in codes.items()) and len(codes) == 14,
              "the engine did not keep int8 codes and fp32 scales on the card")
    free0 = engine.block_mgr.free_blocks
    # warm-up: one step at each of the engine's two row shapes, all rows
    # padding (table of zeros), so their K/V land in trash block 0; the
    # timed prefill and decode steps then pay no first-call cost
    for T in (engine.token_budget, engine.max_seqs):
        zeros = torch.zeros(T, dtype=torch.int32, device=dev)
        model.forward_paged(engine.params, zeros[:, None], engine.kv,
                            torch.zeros((T, engine.block_mgr.max_blocks_per_seq),
                                        dtype=torch.int32, device=dev), zeros,
                            logit_rows=zeros[:engine.max_seqs])
    torch.cuda.synchronize()
    rng = np.random.default_rng(0)
    prompts = {u: rng.integers(0, cfg.vocab_size, n)
               for u, n in zip((1, 2, 3, 4), (37, 300, 1000, 2100))}
    arrival = rng.integers(0, cfg.vocab_size, 640)
    stats = {}
    steps0 = engine.ragged_steps
    pa.launches = 0  # every kernel's count, just before the main path
    if wq is not None:
        wq.launches = wq.tiled_launches = 0
    records, _ = serve(engine, prompts, arrival, decode_steps, greedy=True, stats=stats,
                       launches=lambda: pa.launches)
    torch.cuda.synchronize()
    launches = pa.launches  # read just after
    woq_launches = wq.launches if wq is not None else 0
    woq_tiled = wq.tiled_launches if wq is not None else 0
    ragged = engine.ragged_steps - steps0
    per_step = stats["decode_launches"]
    peak = torch.cuda.max_memory_allocated()

    tokens = [t for rec in records for t in rec.values()]
    check(len(tokens) > 0 and all(0 <= t < cfg.vocab_size for t in tokens),
          "a generated token lies outside [0, vocab)")
    check(launches == cfg.num_layers * ragged and launches > 0,
          f"paged_decode_attention launched {launches} times in {ragged} ragged steps "
          f"(expected num_layers x steps = {cfg.num_layers * ragged})")
    check(set(per_step) == {cfg.num_layers},
          f"launches per decode step {sorted(set(per_step))} != {cfg.num_layers}")
    want_woq = 7 * cfg.num_layers * ragged if bits else 0
    check(woq_launches == want_woq,
          f"woq_matmul launched {woq_launches} times in {ragged} ragged steps "
          f"(expected 7 projections x num_layers x steps = {want_woq})")
    # the prefill steps (token_budget rows) run every projection through
    # the tensor-core kernel, the decode steps (max_seqs rows) none
    check(not bits or (woq_tiled > 0 and woq_tiled % (7 * cfg.num_layers) == 0),
          f"{woq_tiled} tiled WOQ launches: not 7 x num_layers a prefill step")
    pc = engine.prefix_cache_stats()
    check(pc["hits"] >= 1 and pc["cow_copies"] >= 1,
          f"the repeated prompt gave no prefix hit / copy-on-write: {pc}")

    # the last decode step's rows, as the engine built them: live rows, then
    # padding rows (all-zero table, position 0)
    M = engine.max_seqs
    live = sorted(engine.state.seqs.values(), key=lambda d: d.slot)
    tables = np.zeros((M, engine.block_mgr.max_blocks_per_seq), np.int32)
    lens = np.ones(M, np.int32)
    for r, d in enumerate(live):
        engine.block_mgr.fill_table_row(d, tables[r])
        lens[r] = d.seen_tokens
    real_pool = (engine.kv[0][0], engine.kv[1][0], torch.from_numpy(tables).to(dev),
                 torch.from_numpy(lens).to(dev))
    # the replay counts backed by a trace (decode writes only past the
    # positions ``real_pool`` covers)
    replays = replay_trace(engine, records[-1], pa, wq, 7 if bits else 0)

    decode_ms = [s * 1e3 for s in stats["decode_s"]]
    n_prefill = sum(len(p) for p in prompts.values())
    summary = {
        "model": "llama-7b", "layers": cfg.num_layers,
        "dtype": "bfloat16" + (f", int{bits} weights" if bits else ""),
        "requests": len(live), "ragged_steps": ragged,
        "prefill_tokens": n_prefill, "prefill_s": stats["prefill_s"],
        "prefill_tokens_per_s": n_prefill / stats["prefill_s"],
        "decode_steps": len(decode_ms), "decode_step_ms_median": float(np.median(decode_ms)),
        "decode_step_ms_p90": float(np.percentile(decode_ms, 90)),
        "decode_rows": len(live), "launches_per_decode_step": cfg.num_layers,
        "max_memory_allocated_gib": peak / 2**30,
        "prefix_cache": {k: pc[k] for k in ("lookups", "hits", "hit_blocks",
                                              "skipped_prefill_tokens", "cow_copies")},
        "replay_trace": replays,
    }
    if woq is not None:
        summary["woq"] = dict(woq, woq_launches=woq_launches, woq_tiled_launches=woq_tiled,
                              paged_launches=launches)
    log(f"main path ({label}): {len(tokens)} tokens, {ragged} ragged steps, "
        f"paged_decode_attention launched {launches} times (= {cfg.num_layers} layers x "
        f"{ragged} steps), woq_matmul {woq_launches} times; {replays['steps']} more rounds "
        f"replayed and traced: kernels run {replays['kernels_ran']} = counted")
    return engine, free0, launches, real_pool, summary


def kernel_on_real_pool(pa, real_pool, cfg, dev):
    """Phase 5: the kernel on the engine's pool at the last decode step."""
    import torch.nn.functional as F

    kp, vp, tables, lens = real_pool
    B, nh, hd = tables.shape[0], cfg.num_heads, cfg.head_dim
    kvh, _, BS, _ = kp.shape
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((B, nh, hd)).astype(np.float32)).to(
        dev, kp.dtype)
    out = pa.paged_decode_attention(q, kp, vp, tables, lens)
    torch.cuda.synchronize()
    ref = pa.paged_decode_attention_plain(q, kp, vp, tables, lens)
    err = compare(out, ref, kp.dtype)

    kernel_ms = time_cuda(lambda: pa.paged_decode_attention(q, kp, vp, tables, lens))
    plain_ms = time_cuda(lambda: pa.paged_decode_attention_plain(q, kp, vp, tables, lens))
    # the library yardstick: SDPA over the cache already gathered to (B, nh, T, hd)
    T = int(lens.max())
    idx = tables.long()
    gk = kp[:, idx].permute(1, 0, 2, 3, 4).reshape(B, kvh, -1, hd)[:, :, :T]
    gv = vp[:, idx].permute(1, 0, 2, 3, 4).reshape(B, kvh, -1, hd)[:, :, :T]
    gk = gk.repeat_interleave(nh // kvh, dim=1).contiguous()
    gv = gv.repeat_interleave(nh // kvh, dim=1).contiguous()
    mask = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    qs = q[:, :, None, :]
    lib = F.scaled_dot_product_attention(qs, gk, gv, attn_mask=mask)[:, :, 0]
    compare(lib, ref, kp.dtype)
    library_ms = time_cuda(lambda: F.scaled_dot_product_attention(qs, gk, gv, attn_mask=mask))

    # the bound: K and V of the keys this data needs, each read once (a block
    # shared by rows or holding keys only up to its row's length counts what
    # is needed of it), q read and the output written once
    elt = kp.element_size()
    need = {}
    tab, ln = tables.cpu().numpy(), lens.cpu().numpy()
    for r in range(B):
        for j in range(-(-int(ln[r]) // BS)):
            need[tab[r, j]] = max(need.get(tab[r, j], 0), min(BS, int(ln[r]) - j * BS))
    nbytes = (2 * sum(need.values()) * kvh * hd * elt + 2 * q.numel() * elt
              + tables.numel() * 4 + lens.numel() * 4)
    flops = 4 * int(ln.sum()) * nh * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[kp.dtype] * 1e3
    log(f"paged_decode_attention on the engine's pool (layer 0, B={B}, lens "
        f"{ln.tolist()}): max_abs_err {err:.3g}; kernel {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
        f"({nbytes} bytes, {flops} flops)")
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


# ---------------------------------------------------------------------------
# phase 6: serving through ContinuousBatchScheduler
# ---------------------------------------------------------------------------
MARGIN = 1e-4      # a draw whose top-2 margin is below this may differ (ROADMAP rule 2)
EDGE_TOL = 1e-6    # a token this close to the nucleus edge may flip


def shaped_row(lg, temp, top_k, top_p):
    """One row as ``sample_or_argmax`` shapes it before the draw (fp32 on
    the CPU), and whether a token sits within EDGE_TOL of the nucleus edge."""
    x = lg.float() / (temp if temp > 0 else 1.0)
    srt = torch.sort(x, descending=True).values
    if top_k > 0:
        x = torch.where(x < srt[min(top_k - 1, x.numel() - 1)], -torch.inf, x)
    probs = torch.softmax(srt, -1)
    before = torch.cumsum(probs, -1) - probs
    keep = before < top_p
    keep[0] = True
    if top_p < 1.0:
        x = torch.where(x < srt[keep].min(), -torch.inf, x)
    return x, top_p < 1.0 and bool(((before - top_p).abs() < EDGE_TOL).any())


def draw_margin(prng, lg, sp, position):
    """Top-2 margin of the selection for logits ``lg`` (bias added): argmax's
    for a greedy row, ``gumbel + x``'s under the row's key for a sampled one;
    and whether the row sits at the nucleus edge."""
    if sp is None or sp.temperature == 0:
        top2 = lg.float().topk(2).values
        return float(top2[0] - top2[1]), False
    x, edge = shaped_row(lg, sp.temperature, sp.top_k, sp.top_p)
    key = prng.fold_in(prng.PRNGKey(sp.seed), position)
    top2 = (prng.gumbel(key, x.shape) + x).topk(2).values
    return float(top2[0] - top2[1]), edge


def sampling_on_card(dev):
    """Check (c): ``sample_or_argmax`` on the card against the CPU over a
    seeded (64, 32000) block of bf16-rounded logits in fp32, temperatures
    0-1.5, top-k {0, 1, 50, V}, top-p {1, 0.9, 0.5, 1e-6}: keys, bits and
    uniforms bitwise, greedy rows bitwise, sampled rows under the margin
    rule. Then the cost of the engine's selection call (its inputs on the
    card, as a step program holds them) at 8 rows: wall ms a call (host
    clock, synchronized) and device operations a call (profiler), greedy
    against sampled."""
    from deepspeed_tpu_torch.models import sample_or_argmax
    from deepspeed_tpu_torch.utils import prng

    R, V = 64, 32000
    rng = np.random.default_rng(3)
    lg = torch.from_numpy((rng.standard_normal((R, V)) * 3).astype(np.float32))
    lg = lg.to(torch.bfloat16).float()
    temps = np.array([(0.0, 0.5, 0.7, 1.0, 1.5)[i % 5] for i in range(R)], np.float32)
    top_ks = np.array([(0, 1, 50, V)[i % 4] for i in range(R)], np.int32)
    top_ps = np.array([(1.0, 0.9, 0.5, 1e-6)[(i // 4) % 4] for i in range(R)], np.float32)
    seeds = rng.integers(0, 2**31 - 1, R).astype(np.int32)
    pos = rng.integers(0, 4097, R).astype(np.int32)
    key = prng.fold_in(prng.PRNGKey(torch.from_numpy(seeds)), torch.from_numpy(pos))
    dkey = prng.fold_in(prng.PRNGKey(torch.from_numpy(seeds).to(dev)),
                        torch.from_numpy(pos).to(dev))
    check(torch.equal(dkey.cpu(), key), "threefry keys on the card differ from the CPU's")
    check(torch.equal(prng.random_bits(dkey, (V,)).cpu(), prng.random_bits(key, (V,))),
          "threefry bits on the card differ from the CPU's")
    check(torch.equal(prng.uniform(dkey, (V,)).cpu().view(torch.int32),
                      prng.uniform(key, (V,)).view(torch.int32)),
          "uniforms on the card differ bitwise from the CPU's")
    cpu = sample_or_argmax(lg, seeds, pos, temps, top_ks, top_ps)
    card = sample_or_argmax(lg.to(dev), seeds, pos, temps, top_ks, top_ps)
    check(card.device.type == torch.device(dev).type,
          "the card's draw came back from another device")
    card = card.cpu()
    greedy = temps == 0
    check(torch.equal(card[greedy], cpu[greedy]), "greedy rows differ between card and CPU")
    g = prng.gumbel(key, (V,))
    excluded = 0
    for r in np.nonzero(~greedy)[0]:
        x, edge = shaped_row(lg[r], float(temps[r]), int(top_ks[r]), float(top_ps[r]))
        top2 = (g[r] + x).topk(2).values
        if edge or float(top2[0] - top2[1]) <= MARGIN:
            excluded += 1
            continue
        check(int(card[r]) == int(cpu[r]),
              f"row {r}: the card drew {int(card[r])}, the CPU {int(cpu[r])}")
    n_sampled = int((~greedy).sum())
    check(excluded <= 0.01 * n_sampled,
          f"{excluded} of {n_sampled} draws fell under the margin rule (limit 1%)")

    # the cost at the main path's selection shape (8 rows of llama-7b's
    # vocabulary) as the engine's step programs call it: the per-row
    # arrays, the bias rows and the keys (derived on the host, int32 words)
    # already on the card, the greedy-or-sampled decision made
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from deepspeed_tpu_torch.models.transformer import row_keys

    lg8 = lg[:8].to(dev)
    s8, t8, k8, p8 = (torch.from_numpy(a).to(dev) for a in (
        seeds[:8], np.full(8, 0.8, np.float32), np.full(8, 50, np.int32),
        np.full(8, 0.9, np.float32)))
    bias8 = torch.zeros((8, V), dtype=torch.float32, device=dev)
    keys8 = torch.from_numpy(row_keys(seeds[:8], pos[:8]).numpy().astype(np.uint32)
                             .view(np.int32)).to(dev)
    calls = {mode: (lambda sampled=(mode == "sampled"): sample_or_argmax(
        lg8, s8, None, t8, k8, p8, bias=bias8, keys=keys8, sampled=sampled))
        for mode in ("greedy", "sampled")}
    cost = {}
    for name, fn in calls.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(20):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = sum(e.count for e in prof.key_averages()
                  if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
        cost[name] = {"wall_ms_median": float(np.median(walls)), "device_ops": int(ops)}
    log(f"sample_or_argmax on the card vs CPU ({R} x {V}, {n_sampled} sampled rows): keys, "
        f"bits and uniforms bitwise, greedy rows bitwise, sampled rows equal with {excluded} "
        f"excluded by the margin rule; at 8 rows {cost}")
    return {"rows": R, "vocab": V, "sampled_rows": n_sampled, "excluded": excluded,
            "at_8_rows": cost}


class EngineTimer:
    """Wraps an engine's ``put`` and ``decode_step`` on the instance to sum
    the host seconds the scheduler spends inside them (each call ends in the
    step's device-to-host copy, so that time includes the device's). A call
    inside another (``decode_step`` calls ``put``) is not counted twice.
    ``schedule`` holds the host inputs of every ragged step in order."""

    def __init__(self, engine):
        self.engine, self.seconds, self.calls, self._depth = engine, 0.0, 0, 0
        self.schedule = []
        for name in ("put", "decode_step"):
            setattr(engine, name, self._timed(getattr(engine, name)))
        ragged = engine._ragged

        def recorded(prog, T, greedy):
            # the step's staged ids, tables, starts, logit rows and slots
            self.schedule.append(tuple(a.tobytes() for a in prog.views[:5]))
            return ragged(prog, T, greedy)
        engine._ragged = recorded

    def _timed(self, fn):
        def call(*args, **kwargs):
            self._depth += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self._depth -= 1
                if not self._depth:
                    self.seconds += time.perf_counter() - t0
                    self.calls += 1
        return call

    def remove(self):
        for name in ("put", "decode_step", "_ragged"):
            delattr(self.engine, name)


def serve_traffic(engine, prompts, arrival, vip_prompt, **sched_kw):
    """Phase 6's traffic through a ``ContinuousBatchScheduler`` (preemption
    on, the real clock) over ``engine``, rebuilt first so that every run
    starts from the same empty pool and cold prefix cache. Admission drops
    its age term (``age_weight=0``): with it, whether a preempted request
    overtakes a later arrival turns on the wall time between them, which
    differs from run to run, and a different schedule gives other bf16 GEMM
    shapes and so other logits. The real clock still times TTFT and TPOT.
    Returns the requests in a fixed order, the scheduler and the host timing
    with the ragged steps' inputs."""
    from deepspeed_tpu_torch.serve import ContinuousBatchScheduler, RequestState, SamplingParams

    engine.rebuild()
    V = engine.cfg.vocab_size
    sched = ContinuousBatchScheduler(engine, preemption=True, age_weight=0.0, **sched_kw)
    greedy = [sched.submit(p, max_new_tokens=32, priority=1, uid=u)
              for u, p in prompts.items()]
    grid = ((arrival, 0.7, 50, 0.9, 1), (prompts[2], 1.0, 0, 1.0, 2),
            (arrival, 1.0, 50, 1.0, 3), (prompts[2], 0.7, 0, 0.9, 4))
    sampled = [sched.submit(p, max_new_tokens=32, priority=0, uid=10 + i,
                            sampling=SamplingParams(temperature=t, top_k=k, top_p=q, seed=s))
               for i, (p, t, k, q, s) in enumerate(grid)]
    timer = EngineTimer(engine)
    step_s = []

    def step():
        t0 = time.perf_counter()
        more = sched.step()
        step_s.append(time.perf_counter() - t0)
        return more

    t_start = time.perf_counter()
    step()
    live = [r for r in greedy + sampled if r.state is not RequestState.QUEUED]
    check(len(live) == engine.max_seqs, f"{len(live)} requests live after the first step, "
          f"not all {engine.max_seqs} slots")
    # every slot live and decoding: the arrival preempts a sampled request
    # mid-stream (the lowest priority, then the most blocks held)
    while not all(r.tokens for r in live):
        check(step(), "the scheduler ran dry before every request decoded")
    vip = sched.submit(vip_prompt, max_new_tokens=32, priority=1000, uid=20)
    stop = sched.submit(prompts[1], max_new_tokens=32, priority=1, uid=21,
                        sampling=SamplingParams(stop=[(t,) for t in range(0, V, 2)]))
    biased = sched.submit(prompts[2], max_new_tokens=32, priority=1, uid=22,
                          sampling=SamplingParams(temperature=0.7, seed=5,
                                                  logit_bias={1234: 1e4}))
    while step():
        pass
    sched.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    timer.remove()
    return (greedy + sampled + [vip, stop, biased], sched,
            {"wall_s": wall, "step_s": step_s, "engine_s": timer.seconds,
             "schedule": timer.schedule})


def serve_phase(engine, pa, dev):
    """Phase 6 on phase 4's engine: (a) every request finishes and the
    scheduler drains; (b) a second run of the same traffic gives bitwise the
    same streams, the preempted sampled request's included; (d) the stop
    sequence ends its stream, the biased token is produced, and fan-out
    child 0 equals the n=1 stream. Returns the serve_summary fields."""
    from deepspeed_tpu_torch.serve import ContinuousBatchScheduler, RequestState, SamplingParams

    cfg = engine.cfg
    rng = np.random.default_rng(0)  # phase 4's prompts and arrival
    prompts = {u: rng.integers(0, cfg.vocab_size, n).tolist()
               for u, n in zip((1, 2, 3, 4), (37, 300, 1000, 2100))}
    arrival = rng.integers(0, cfg.vocab_size, 640).tolist()
    vip_prompt = np.random.default_rng(6).integers(0, cfg.vocab_size, 100).tolist()

    steps0 = engine.ragged_steps
    pa.launches = 0  # the kernel's count, just before the first run
    reqs, sched, timing = serve_traffic(engine, prompts, arrival, vip_prompt)
    launches = pa.launches  # read just after
    ragged = engine.ragged_steps - steps0
    check(all(r.state is RequestState.DONE for r in reqs),
          f"requests not done: {[(r.uid, r.state.value) for r in reqs if not r.finished]}")
    check(not engine.state.seqs and not sched.live_count and not sched.queue_depth,
          "the scheduler did not drain")
    check(launches == cfg.num_layers * ragged and launches > 0,
          f"paged_decode_attention launched {launches} times in {ragged} ragged steps")
    preempted = [r for r in reqs if r.preemptions]
    check(any(r.sampling is not None and r.sampling.temperature > 0 for r in preempted),
          f"no sampled request was preempted (preempted: {[r.uid for r in preempted]})")
    tokens = [t for r in reqs for t in r.tokens]
    check(all(0 <= t < cfg.vocab_size for t in tokens), "a token lies outside [0, vocab)")
    m = sched.metrics
    pc = engine.prefix_cache_stats()

    # (b) the same traffic again: the same ragged steps, bitwise the same streams
    again, sched2, timing2 = serve_traffic(engine, prompts, arrival, vip_prompt)
    sch, sch2 = timing["schedule"], timing2["schedule"]
    first = next((i for i, (a, b) in enumerate(zip(sch, sch2)) if a != b), None)
    check(first is None and len(sch) == len(sch2),
          f"the replayed run's schedule differs ({len(sch)} vs {len(sch2)} ragged steps, "
          f"first difference at step {first})")
    for r, r2 in zip(reqs, again):
        check(r2.tokens == r.tokens, f"uid {r.uid}: the replayed run's stream differs "
              f"({r.tokens[:8]}... vs {r2.tokens[:8]}...)")
    check(sched2.metrics.preemptions == m.preemptions,
          "the replayed run preempted a different number of times")
    # three further replays on the same engine, its steps replayed from the
    # graphs the first runs captured: the same schedule, the same streams
    graphs = engine.captured_graphs
    check(graphs > 0, "phase 6 captured no step graph")
    for k in range(3):
        more, sched_k, timing_k = serve_traffic(engine, prompts, arrival, vip_prompt)
        check(timing_k["schedule"] == sch, f"further replay {k + 1}: the schedule differs")
        for r, r2 in zip(reqs, more):
            check(r2.tokens == r.tokens, f"further replay {k + 1}, uid {r.uid}: the stream "
                  f"differs ({r.tokens[:8]}... vs {r2.tokens[:8]}...)")
        check(sched_k.metrics.preemptions == m.preemptions,
              f"further replay {k + 1} preempted a different number of times")
    check(engine.captured_graphs == graphs,
          f"the further replays captured {engine.captured_graphs - graphs} new graphs")

    # (d) stop, bias and fan-out semantics
    stop, biased = reqs[-2], reqs[-1]
    check(stop.tokens and stop.tokens[-1] % 2 == 0 and all(t % 2 for t in stop.tokens[:-1]),
          f"the stop sequence did not end its stream: {stop.tokens}")
    check(biased.tokens == [1234] * 32, f"the biased token was not produced: {biased.tokens}")
    engine.rebuild()
    fan_sched = ContinuousBatchScheduler(engine, preemption=True)
    sp = SamplingParams(temperature=1.0, top_k=50, seed=7)
    fan = fan_sched.submit(prompts[1], max_new_tokens=32, uid=30,
                           sampling=SamplingParams(temperature=1.0, top_k=50, seed=7, n=2))
    single = fan_sched.submit(prompts[1], max_new_tokens=32, uid=31, sampling=sp)
    fan_sched.run_until_complete()
    fan_sched.close()
    check(fan.fanout[0].tokens == single.tokens and len(single.tokens) == 32,
          "fan-out child 0 differs from the n=1 stream")
    check(fan.fanout[1].tokens != fan.fanout[0].tokens, "the fan-out's children are equal")
    engine.rebuild()

    ttft = np.asarray(m.ttft_s) * 1e3
    tpot = np.asarray([(r.finish_time - r.first_token_time) / (len(r.tokens) - 1) * 1e3
                       for r in reqs if len(r.tokens) > 1])
    step_ms = np.asarray(timing["step_s"]) * 1e3
    summary = {
        "model": "llama-7b", "layers": cfg.num_layers, "dtype": "bfloat16",
        "requests": len(reqs), "generated_tokens": len(tokens),
        "prompt_tokens": sum(len(r.prompt) for r in reqs), "wall_s": timing["wall_s"],
        "generated_tokens_per_s": len(tokens) / timing["wall_s"],
        "ttft_ms_p50": float(np.percentile(ttft, 50)),
        "ttft_ms_p90": float(np.percentile(ttft, 90)),
        "tpot_ms_p50": float(np.percentile(tpot, 50)),
        "tpot_ms_p90": float(np.percentile(tpot, 90)),
        "preemptions": m.preemptions, "prefix_hits": pc["hits"],
        "sampled_tokens": m.sampling["sampled_tokens"], "stop_hits": m.sampling["stop_hits"],
        "paged_launches": launches, "ragged_steps": ragged,
        "scheduler_steps": len(step_ms),
        "host_ms_per_step_mean": float(step_ms.mean()),
        "host_ms_per_step_p50": float(np.median(step_ms)),
        "engine_share": timing["engine_s"] / float(step_ms.sum() / 1e3),
        "replay_bitwise": True, "further_replays_bitwise": 3,
        "captured_graphs": engine.captured_graphs,
    }
    log(f"serving through ContinuousBatchScheduler: {len(reqs)} requests, {len(tokens)} tokens "
        f"in {timing['wall_s']:.3f} s, {m.preemptions} preemption(s), paged_decode_attention "
        f"launched {launches} times (= {cfg.num_layers} layers x {ragged} steps); the replay "
        f"run and three further replays bitwise equal; stop, bias and fan-out ok")
    return summary


def small_scheduler_vs_cpu(dev, engine_kw=None, sched_kw=None, prompts=None, greedy=False,
                           label="plain"):
    """Check (e) of phases 6 and 7: phase 3's head_dim-64 model in fp32, the
    scheduler on the card against the same on the CPU, greedy and sampled
    requests; streams equal, a divergence allowed only at a draw under the
    margin rule (recomputed from the CPU engine's logits at that position).
    ``engine_kw`` and ``sched_kw`` (a function of the engine) set phase 7's
    options, ``prompts`` other prompts and ``greedy`` greedy requests
    only. Returns the excluded draws and the card's requests and scheduler."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.serve import ContinuousBatchScheduler, SamplingParams
    from deepspeed_tpu_torch.utils import prng

    model = build_model("llama-tiny", vocab_size=1024, num_layers=2, intermediate_size=512,
                        max_seq_len=512, hidden_size=256, num_heads=4, num_kv_heads=2)
    params = model.init_params(torch.Generator().manual_seed(0))
    opts = dict(paged=True, dtype=torch.float32, max_seqs=4, block_size=16,
                prefill_chunk=64, token_budget=64, prefix_cache=True)
    rng = np.random.default_rng(4)
    prompts = prompts or [rng.integers(0, 1024, n).tolist() for n in (20, 150, 48, 90, 33, 70)]
    params_of = [None, SamplingParams(temperature=0.8, top_k=40, seed=1), None,
                 SamplingParams(temperature=1.0, top_p=0.9, seed=2),
                 SamplingParams(temperature=1.5, seed=3), SamplingParams(temperature=0.7, seed=4)]
    if greedy:
        params_of = [None] * len(prompts)

    def run(device):
        eng = InferenceEngineV2(model, params, device=device, **opts, **(engine_kw or {}))
        sched = ContinuousBatchScheduler(eng, preemption=True,
                                         **(sched_kw(eng) if sched_kw else {}))
        reqs = [sched.submit(p, max_new_tokens=16, uid=i + 1, priority=i % 2, sampling=sp)
                for i, (p, sp) in enumerate(zip(prompts, params_of))]
        sched.run_until_complete()
        sched.close()
        return reqs, sched

    (ref, _), (got, sched) = run("cpu"), run(dev)
    excluded, draws = 0, 0
    for r, g in zip(ref, got):
        draws += len(r.tokens)
        if g.tokens == r.tokens:
            continue
        i = next((k for k, (a, b) in enumerate(zip(r.tokens, g.tokens)) if a != b), None)
        check(i is not None, f"uid {r.uid}: streams of different lengths agree where both run")
        ctx = r.prompt + r.tokens[:i]
        lg = InferenceEngineV2(model, params, device="cpu", **opts).put([1], [ctx])[1]
        margin, edge = draw_margin(prng, torch.from_numpy(lg), r.sampling, len(ctx))
        check(margin <= MARGIN or edge, f"{label}: uid {r.uid}: card and CPU differ at token "
              f"{i} where the draw's margin is {margin:.3g}")
        excluded += 1
    check(excluded <= 0.01 * draws, f"{label}: {excluded} of {draws} draws excluded (limit 1%)")
    log(f"scheduler ({label}) on the card vs CPU (llama 256-wide, hd 64, fp32, {len(ref)} "
        f"requests, {sum(1 for sp in params_of[:len(prompts)] if sp)} sampled): {draws} tokens "
        f"equal, {excluded} excluded by the margin rule")
    return excluded, got, sched


# ---------------------------------------------------------------------------
# phase 7: captured steps, the fused horizon, speculation, pipelined dispatch
# ---------------------------------------------------------------------------
def decode_window(engine, prompts, capture, pa, wq, steps=4):
    """Phase 4's decode step, eager or captured: the prompts put, two decode
    steps, then ``steps`` decode steps timed on the host clock (each ends in
    the step's device-to-host copy) and traced (device time summed over the
    kernels; a short spin kernel opens the window and is left out). The
    paged kernels the trace saw run are held against the launches counted
    (by the wrapper eagerly, by the engine's bookkeeping on a replay) and
    against num_layers x steps."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    engine.rebuild()
    engine.capture = capture
    out = engine.put(list(prompts), [list(p) for p in prompts.values()], greedy=True)
    for _ in range(2):
        out = engine.decode_step(out, greedy=True)
    torch.cuda.synchronize()
    c0 = family_counters(pa, wq)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            out = engine.decode_step(out, greedy=True)
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
    counted = [a - b for a, b in zip(family_counters(pa, wq), c0)]
    ran = kernel_runs(prof)
    check_kernel_runs(ran, counted, [engine.cfg.num_layers * steps, 0, 0],
                      f"phase 7 (a), {'captured' if capture else 'eager'} decode steps")
    dev_us, ops = 0.0, 0
    for e in prof.key_averages():
        if (getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                and "spin_kernel" not in e.key):
            us = getattr(e, "self_device_time_total", None)
            dev_us += e.self_cuda_time_total if us is None else us
            ops += e.count
    for uid in list(engine.state.seqs):
        engine.flush(uid)
    return {"host_ms": host_ms, "device_ms": dev_us / 1e3 / steps if dev_us else None,
            "device_ops": ops / steps, "paged_kernels_ran": ran[0]}


def phase4_traffic(engine, pa, prompts, arrival, capture):
    """Phase 4's traffic (``serve``, 32 greedy decode steps) from a rebuilt
    engine, eager or captured; the kernel's count set to 0 just before and
    read just after."""
    engine.rebuild()
    engine.capture = capture
    stats, steps0 = {}, engine.ragged_steps
    pa.launches = 0
    records, _ = serve(engine, prompts, arrival, 32, greedy=True, stats=stats,
                       launches=lambda: pa.launches)
    torch.cuda.synchronize()
    launches, ragged = pa.launches, engine.ragged_steps - steps0
    for uid in list(engine.state.seqs):
        engine.flush(uid)
    return records, launches, ragged, stats


def fused_vs_single(engine, prompts, sampled):
    """Check (b): 8 single decode steps against two fused K=4 steps from the
    same state, greedy or with two sampled rows, bitwise."""
    from deepspeed_tpu_torch.serve import SamplingParams

    streams = []
    for fused in (False, True):
        engine.rebuild()
        engine.capture = True
        if sampled:
            engine.set_sampling(2, SamplingParams(temperature=0.8, top_k=50, seed=11))
            engine.set_sampling(4, SamplingParams(temperature=1.0, top_p=0.9, seed=12))
        toks = engine.put(list(prompts), [list(p) for p in prompts.values()], greedy=True)
        out = {u: [t] for u, t in toks.items()}
        for _ in range(2 if fused else 8):
            if fused:
                step = engine.decode_multi(toks, 4)
                for u in step:
                    engine.rollback(u, 0)
            else:
                step = {u: [t] for u, t in engine.decode_step(toks, greedy=True).items()}
            for u, seq in step.items():
                out[u] += seq
            toks = {u: seq[-1] for u, seq in step.items()}
        streams.append(out)
        for uid in list(engine.state.seqs):
            engine.flush(uid)
    check(streams[0] == streams[1], f"fused K=4 differs from 4 single steps "
          f"({'sampled' if sampled else 'greedy'}): {streams[0]} vs {streams[1]}")
    return sum(len(s) for s in streams[1].values())


def scheduler_mode(engine, prompts, samplings, **sched_kw):
    """One scheduler run of phase 7's traffic from a rebuilt engine (real
    clock, admission without its age term), stepped here so that each
    request's first and last token are stamped on the host clock when the
    step that brought them returns (after its device-to-host copy): the
    scheduler stamps them at the start of the step that emits them, before
    the device has run it. Returns the requests, the scheduler, the wall
    seconds and the host times from the submits of each request's first
    and last token."""
    from deepspeed_tpu_torch.serve import ContinuousBatchScheduler

    engine.rebuild()
    engine.capture = True
    sched = ContinuousBatchScheduler(engine, age_weight=0.0, **sched_kw)
    t0 = time.perf_counter()
    reqs = [sched.submit(p, max_new_tokens=48, uid=100 + i, sampling=sp)
            for i, (p, sp) in enumerate(zip(prompts, samplings))]
    first, last = {}, {}
    while True:
        more = sched.step()
        now = time.perf_counter() - t0
        for r in reqs:
            if r.tokens and r.uid not in first:
                first[r.uid] = now
            if r.finished and r.uid not in last:
                last[r.uid] = now
        if not more:
            break
    sched.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in reqs:  # any token ``close()`` brought in
        first.setdefault(r.uid, wall)
        last.setdefault(r.uid, wall)
    return reqs, sched, wall, (first, last)


def mode_stats(reqs, wall, stamps):
    """Tokens/s over the run; TTFT from the submits to the return of the
    step that brought the first token; TPOT from there to the last token's."""
    first, last = stamps
    tokens = sum(len(r.tokens) for r in reqs)
    ttft = np.asarray([first[r.uid] for r in reqs]) * 1e3
    tpot = np.asarray([(last[r.uid] - first[r.uid]) / (len(r.tokens) - 1) * 1e3
                       for r in reqs if len(r.tokens) > 1])
    return {"tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
            "ttft_ms_p50": float(np.percentile(ttft, 50)),
            "ttft_ms_max": float(ttft.max()),
            "tpot_ms_p50": float(np.percentile(tpot, 50)),
            "tpot_ms_p90": float(np.percentile(tpot, 90))}


def phase7_traffic(V, seed=7):
    """Phase 7's two sets of 6 prompts (4 greedy requests, then 2 sampled).
    ``pattern``: a 10-token pattern repeated 4 times, so that every prompt
    prefills in the first 256-row step and every later token of every mode
    is computed in a decode round of the same 8 rows (the condition for
    bitwise equal streams in bf16, whose GEMMs round by row count).
    ``wide``: the greedy prompts replaced by 4000 distinct tokens each
    (one eighth of llama-7b's vocabulary, none shared between them), where
    the prompt lookup drafts whenever the model gives a token its prompt
    holds. Random weights do not copy their context: on ``pattern`` no lookup
    drafted in three card runs, and a prompt of one token repeated after
    the token the model gives after it did not make the model give that
    token again (0 of 16 candidates). Their prefill runs over ~63 mixed
    steps, so decode tokens meet other row counts from mode to mode."""
    rng = np.random.default_rng(seed)
    short = [rng.integers(0, V, 10).tolist() * 4 for _ in range(6)]
    wide = np.random.default_rng(seed + 1).permutation(V)[:4 * 4000].reshape(4, 4000).tolist()
    return short, wide + short[4:]


def lookup_positions(prompts, reqs, k=3):
    """Tokens of each plain stream after which the prompt lookup has a
    draft (the context up to that token): where a speculative run of the
    same traffic can verify, when a round starts there."""
    from deepspeed_tpu_torch.serve import PromptLookupProposer

    prop = PromptLookupProposer()
    return [sum(bool(prop.propose(0, list(p) + r.tokens[:i + 1], k))
                for i in range(len(r.tokens) - 1)) for p, r in zip(prompts, reqs)]


def ulps_bf16(x):
    """One bfloat16 unit in the last place at magnitude ``x``."""
    return 2.0 ** (np.floor(np.log2(max(abs(x), 2.0 ** -126))) - 7)


def spec_vs_plain(engine, plain, spec, prompts):
    """Check (c): the speculative streams against the plain scheduler's. In
    16 bits the verify forward's GEMMs run 4x the rows of a decode round and
    may round differently, so a stream may turn at a near tie: each first
    difference is located, the plain engine's logits there recomputed
    (``put`` from a rebuilt engine) and its selection margin measured. A
    difference at a margin within 8 bf16 units of the top logit is a
    rounding turn, counted and printed; a wider one fails."""
    from deepspeed_tpu_torch.utils import prng

    found = []
    for r, g, p in zip(plain, spec, prompts):
        if g.tokens == r.tokens:
            continue
        i = next((k for k, (a, b) in enumerate(zip(r.tokens, g.tokens)) if a != b), None)
        check(i is not None, f"uid {r.uid}: spec and plain streams of different lengths "
              "agree where both run")
        ctx = list(p) + r.tokens[:i]
        engine.rebuild()
        lg = torch.from_numpy(engine.put([1], [ctx])[1])
        engine.flush(1)
        margin, edge = draw_margin(prng, lg, r.sampling, len(ctx))
        limit = 8 * ulps_bf16(float(lg.abs().max()))
        check(margin <= limit or edge, f"uid {r.uid}: spec and plain differ at token {i} "
              f"where the margin is {margin:.4g} (> {limit:.3g}, 8 bf16 units)")
        found.append({"uid": r.uid, "token": i, "margin": margin, "context_len": len(ctx),
                      "plain": r.tokens[i], "spec": g.tokens[i]})
    return found


def woq_spec_vs_plain(dev):
    """Check (e) over int8 weights: a small bf16 WOQ engine (phase q2's
    model, group 64) whose decode rounds (4 rows) run ``woq_gemv_kernel``
    and whose verify forward (16 rows) runs the tensor-core kernel, so the
    sums go in another order: the speculative streams (the target as its
    own draft model) against the plain scheduler's, turns allowed only at
    a near tie as in (c). Returns the turns and the WOQ launches."""
    from deepspeed_tpu_torch.inference.quantization import quantize_model
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.ops.quantizer import woq_gemm as wq
    from deepspeed_tpu_torch.serve import DraftModelProposer

    model = build_model("llama-tiny", vocab_size=1024, hidden_size=256, num_layers=2,
                        num_heads=4, num_kv_heads=2, intermediate_size=512, max_seq_len=512)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               dtype=torch.bfloat16)
    _, qp = quantize_model(model, params, num_bits=8, group_size=64)
    engine = InferenceEngineV2(model, qp, paged=True, dtype=torch.bfloat16, max_seqs=4,
                               block_size=16, prefill_chunk=64, token_budget=64,
                               device=dev, decode_horizon=4)
    prompts = [np.random.default_rng(8).integers(0, 1024, n).tolist() for n in (20, 30, 12, 25)]
    plain = scheduler_mode(engine, prompts, [None] * 4, decode_horizon=1)[0]
    l0, t0 = wq.launches, wq.tiled_launches
    spec, sched, _, _ = scheduler_mode(
        engine, prompts, [None] * 4,
        proposer=DraftModelProposer(model, engine.params, window=64, max_draft=3))
    launches = {"woq": wq.launches - l0, "tiled": wq.tiled_launches - t0}
    check(sched.metrics.spec["steps"] > 0 and launches["tiled"] > 0,
          f"the WOQ speculative run verified nothing on the tensor-core kernel: {launches}")
    turns = spec_vs_plain(engine, plain, spec, prompts)
    log(f"phase 7 (e), int8 WOQ: acceptance {sched.metrics.spec['acceptance_rate']:.3f}, "
        f"{len(turns)} stream(s) turned at a near tie: {turns}; launches {launches}")
    return {"acceptance_rate": sched.metrics.spec["acceptance_rate"], "turns": turns,
            "launches": launches}


def horizon_phase(params, pa, fa, wq, dev, card):
    """Phase 7 on phase 4's weights (shared, not copied) with a new engine at
    ``decode_horizon=4``, capture on. Returns the summary and the records
    of phase 4's traffic replayed (phase 8 holds the slot engine to them)."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.serve import DraftModelProposer, PromptLookupProposer, SamplingParams

    model = build_model("llama-7b")
    cfg = model.config
    engine = InferenceEngineV2(model, params, paged=True, dtype=torch.bfloat16, max_seqs=8,
                               block_size=64, prefill_chunk=256, token_budget=256,
                               prefix_cache=True, device=dev, decode_horizon=4)
    check(all(engine.params["blocks"][k] is v for k, v in params["blocks"].items()),
          "phase 7's engine copied phase 4's weights")
    rng = np.random.default_rng(0)  # phase 4's prompts and arrival
    prompts = {u: rng.integers(0, cfg.vocab_size, n)
               for u, n in zip((1, 2, 3, 4), (37, 300, 1000, 2100))}
    arrival = rng.integers(0, cfg.vocab_size, 640)

    # (a) phase 4's traffic: eager, captured (the first use of each key runs
    # eagerly, then is captured), captured again (every step a replay)
    runs = {}
    for mode, capture in (("eager", False), ("capture", True), ("replay", True)):
        runs[mode] = phase4_traffic(engine, pa, prompts, arrival, capture)
    for mode in ("capture", "replay"):
        check(runs[mode][0] == runs["eager"][0],
              f"phase 4's traffic {mode}d differs from eager")
        check(runs[mode][1:3] == runs["eager"][1:3],
              f"launches/steps {mode}d {runs[mode][1:3]} != eager {runs['eager'][1:3]}")
    launches, ragged = runs["replay"][1:3]
    check(launches == cfg.num_layers * ragged, f"paged_decode_attention launched {launches} "
          f"times in {ragged} replayed ragged steps")
    windows = {mode: decode_window(engine, prompts, capture, pa, wq)
               for mode, capture in (("eager", False), ("captured", True))}
    log(f"phase 7 (a): phase 4's traffic eager, captured and replayed bitwise equal, "
        f"{launches} paged launches in {ragged} steps each; decode step {windows}")

    # (b) fused K=4 against K single steps
    fused_tokens = [fused_vs_single(engine, prompts, s) for s in (False, True)]
    log(f"phase 7 (b): fused K=4 equals 4 single steps bitwise, greedy and sampled "
        f"({fused_tokens} tokens)")

    # (c), (d): phase 7's traffic through each scheduler mode: on the short
    # prompts the plain scheduler, the fused horizon, the target as its own
    # draft model (a 64-token window: the longer contexts are cut, so some
    # drafts fail; it drafts every round) and pipelined dispatch; on the
    # wide ones the plain scheduler and the prompt lookup
    pattern, wide = phase7_traffic(cfg.vocab_size)
    samplings = [None, None, None, None, SamplingParams(temperature=0.8, top_k=50, seed=21),
                 SamplingParams(temperature=1.0, top_p=0.9, seed=22)]
    modes = {"plain": (pattern, dict(decode_horizon=1)), "fused": (pattern, dict()),
             "spec_draft": (pattern, dict(proposer=DraftModelProposer(
                 model, engine.params, window=64, max_draft=3))),
             "pipelined": (pattern, dict(decode_horizon=1, pipelined=True)),
             "plain_wide": (wide, dict(decode_horizon=1)),
             "spec": (wide, dict(proposer=PromptLookupProposer()))}
    results, stats = {}, {}
    for name, (traffic, kw) in modes.items():
        reqs, sched, wall, stamps = scheduler_mode(engine, traffic, samplings, **kw)
        check(all(r.state.value == "done" for r in reqs), f"{name}: requests not done")
        results[name] = (reqs, sched)
        stats[name] = mode_stats(reqs, wall, stamps)
    plain = results["plain"][0]
    drafts_at = lookup_positions(wide, results["plain_wide"][0])
    for name in ("fused", "pipelined"):
        for r, g in zip(plain, results[name][0]):
            check(g.tokens == r.tokens, f"{name}: uid {r.uid} differs from the plain "
                  f"scheduler ({r.tokens[:8]}... vs {g.tokens[:8]}...)")
    for name, base, traffic in (("spec", "plain_wide", wide), ("spec_draft", "plain", pattern)):
        spec_m = results[name][1].metrics.spec
        turns = spec_vs_plain(engine, results[base][0], results[name][0], traffic)
        stats[name].update(acceptance_rate=spec_m["acceptance_rate"],
                           verify_steps=spec_m["steps"],
                           accepted_tokens=spec_m["accepted_tokens"], differs_from_plain=turns)
        log(f"phase 7 (c), {name}: acceptance {spec_m['acceptance_rate']:.3f} over "
            f"{spec_m['steps']} verify steps; {len(turns)} stream(s) turned from {base} at a "
            f"near tie: {turns}")
    for name in ("spec", "spec_draft"):  # else spec vs plain compares plain with itself
        check(results[name][1].metrics.spec["steps"] > 0,
              f"{name}: the speculative run verified nothing (the plain streams offer the "
              f"prompt lookup a draft after {drafts_at} tokens)")
    log("phase 7 (d): pipelined and fused streams bitwise equal to the plain scheduler's")

    # (f) the step-program counters
    counts = {"ragged_cache_size": engine.ragged_cache_size,
              "fused_cache_size": engine.fused_cache_size,
              "verify_cache_size": engine.verify_cache_size,
              "captured_graphs": engine.captured_graphs}
    check(counts["ragged_cache_size"] <= 4 and counts["fused_cache_size"] <= 1
          and counts["verify_cache_size"] <= 1,
          f"step programs past the JAX engine's bounds (4, 1, 1): {counts}")
    engine.kv = None
    del engine
    torch.cuda.empty_cache()

    # (e) the small model, each option on the card against the CPU; and the
    # target as its own draft model, whose window forward runs the flash kernel
    small = {}
    for label, ekw, skw in (
            ("fused", dict(decode_horizon=4), None),
            ("spec", dict(decode_horizon=4), lambda e: dict(proposer=PromptLookupProposer())),
            ("pipelined", None, lambda e: dict(pipelined=True))):
        small[label], _, ssched = small_scheduler_vs_cpu(dev, ekw, skw, label=label)
        if label == "spec":
            check(ssched.metrics.spec["steps"] > 0,
                  "the small prompt-lookup run on the card verified nothing")
            small["spec_verify_steps"] = ssched.metrics.spec["steps"]
    fa.fwd_launches = 0
    short = [np.random.default_rng(5).integers(0, 1024, n).tolist() for n in (20, 30, 12, 25)]
    plain_small = small_scheduler_vs_cpu(dev, prompts=short, greedy=True,
                                         label="plain, short greedy prompts")[1]
    excl, drafted, dsched = small_scheduler_vs_cpu(
        dev, dict(decode_horizon=4),
        lambda e: dict(proposer=DraftModelProposer(e.model, e.params, window=64, max_draft=3)),
        prompts=short, greedy=True, label="draft model = target")
    small["draft_model"] = excl
    draft_launches = fa.fwd_launches
    check(draft_launches > 0, "the draft model's forward launched no flash kernel")
    rate = dsched.metrics.spec["acceptance_rate"]
    check(rate == 1.0, f"the target as its own draft accepted {rate:.3f} of its drafts")
    for r, g in zip(plain_small, drafted):
        check(g.tokens == r.tokens, f"draft model: uid {r.uid} differs from the plain run")
    log(f"phase 7 (e): fused, spec, pipelined on the card vs CPU; the target as its own draft "
        f"accepted every draft, streams bitwise the plain run's, {draft_launches} flash "
        f"forward launches")
    woq_spec = woq_spec_vs_plain(dev)
    summary = {
        "card": card, "model": "llama-7b", "layers": cfg.num_layers, "dtype": "bfloat16",
        "decode_horizon": 4,
        "phase4_decode_step": windows,
        "phase4_traffic": {m: {"decode_step_ms_median": float(np.median(r[3]["decode_s"]) * 1e3),
                               "paged_launches": r[1], "ragged_steps": r[2]}
                           for m, r in runs.items()},
        "fused_vs_single_tokens": fused_tokens,
        "lookup_draft_positions": drafts_at,
        "modes": stats, "small_vs_cpu_excluded": small,
        "draft_model": {"acceptance_rate": rate, "flash_fwd_launches": draft_launches},
        "woq_int8_spec": woq_spec,
        "graphs": counts,
    }
    log(f"phase 7 (f): step programs {counts}")
    return summary, runs["replay"][0]


# ---------------------------------------------------------------------------
# phase 8: slot mode
# ---------------------------------------------------------------------------
#: the offset kernel's cases at llama-7b's heads over an 8-slot, 4096-token
#: cache: label, rows, query rows a row, offsets, kv rows (None: row b)
SLOT_CASES = (
    ("decode", 8, 1, (36, 299, 999, 2099, 0, 0, 0, 0), None),
    ("256-row chunk at offset 256", 1, 256, (256,), (3,)),
    ("16-row bucket", 2, 16, (0, 1000), (5, 1)),
)


def slot_case(B, Sq, offs, rows, dtype, dev, seed=0):
    """q (B, Sq, 32, 128), a slot cache (8, 4096, 32, 128) for K and for V
    from a seeded generator, and the offsets and kv rows on the card."""
    gen = torch.Generator(dev).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((B, Sq, 32, 128), (8, 4096, 32, 128), (8, 4096, 32, 128)))
    off = torch.tensor(offs, dtype=torch.int32, device=dev)
    kr = None if rows is None else torch.tensor(rows, dtype=torch.int32, device=dev)
    return q, k, v, off, kr


def slot_kernels_vs_plain(fa, dev):
    """Phase 8 (a): the flash forward with per-row offsets and kv rows
    against its plain version, bf16 and fp32, each call repeated bitwise;
    with zero offsets, bitwise the forward without them (phase a's path)."""
    worst = 0.0
    for label, B, Sq, offs, rows in SLOT_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, off, kr = slot_case(B, Sq, offs, rows, dtype, dev)
            out, lse = fa.flash_attention_fwd(q, k, v, q_offset=off, kv_rows=kr)
            again = fa.flash_attention_fwd(q, k, v, q_offset=off, kv_rows=kr)
            check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
                  f"slot {label} {dtype}: a repeated offset forward is not bitwise equal")
            ref, ref_lse = fa.flash_attention_plain(q, k, v, q_offset=off, kv_rows=kr)
            err = max(compare(out, ref, dtype), compare(lse, ref_lse, dtype))
            kk, vv = (k, v) if kr is None else (k[kr.long()].contiguous(),
                                                v[kr.long()].contiguous())
            base = fa.flash_attention_fwd(q, kk, vv)
            zero = fa.flash_attention_fwd(q, kk, vv, q_offset=torch.zeros_like(off))
            check(torch.equal(base[0], zero[0]) and torch.equal(base[1], zero[1]),
                  f"slot {label} {dtype}: zero offsets differ from the forward without them")
            worst = max(worst, err)
            log(f"kernel vs plain: flash forward with row offsets, {label} (B={B} Sq={Sq} "
                f"offsets {list(offs)} rows {rows}) {str(dtype)[6:]}: max_abs_err {err:.3g}, "
                "bitwise repeatable, zero offsets bitwise the plain causal call ok")
            del q, k, v, ref
    return worst


def slot_timing(fa, dev):
    """Phase 8 (b): the offset forward at the decode and chunk shapes, CUDA
    events, beside its plain version, SDPA with a boolean mask over the same
    cache rows (copied to (B, heads, T, hd) beforehand) and the bound."""
    import torch.nn.functional as F

    out = {}
    for label, B, Sq, offs, rows in SLOT_CASES[:2]:
        dtype = torch.bfloat16
        q, k, v, off, kr = slot_case(B, Sq, offs, rows, dtype, dev, seed=3)
        kw = dict(q_offset=off, kv_rows=kr)
        res, lse = fa.flash_attention_fwd(q, k, v, **kw)
        ref = fa.flash_attention_plain(q, k, v, **kw)[0]
        err = compare(res, ref, dtype)
        ms = time_cuda(lambda: fa.flash_attention_fwd(q, k, v, **kw))
        plain_ms = time_cuda(lambda: fa.flash_attention_plain(q, k, v, **kw), warmup=2, iters=5)
        idx = torch.arange(B, device=dev) if kr is None else kr.long()
        Skv = k.shape[1]
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k[idx], v[idx]))
        mask = (torch.arange(Skv, device=dev)[None, None, :]
                <= torch.arange(Sq, device=dev)[None, :, None] + off.long()[:, None, None])
        mask = mask[:, None]  # (B, 1, Sq, Skv)
        lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        compare(lib.transpose(1, 2), ref, dtype)
        library_ms = time_cuda(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                      attn_mask=mask))
        # the bound: each row's visible keys (offset + Sq of them) read once for
        # K and V, q and the output moved once, lse written; the products over
        # the visible (query, key) pairs at the bf16 peak
        elt, nh, kvh, hd = q.element_size(), q.shape[2], k.shape[2], q.shape[3]
        keys = sum(min(Skv, o + Sq) for o in offs)
        pairs = sum(Sq * o + Sq * (Sq + 1) // 2 for o in offs)
        nbytes = (2 * keys * kvh * hd * elt + 2 * q.numel() * elt + lse.numel() * 4
                  + 4 * B * (1 if kr is None else 2))
        flops = 4 * pairs * nh * hd
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
        out[label] = {"B": B, "Sq": Sq, "offsets": list(offs), "max_abs_err": err, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                      "library_ms": library_ms, "bytes": nbytes, "flops": flops}
        log(f"flash forward with row offsets, {label}: {ms:.4f} ms (plain {plain_ms:.4f}, "
            f"masked SDPA {library_ms:.4f}, bound {max(t_bytes, t_ops):.4f} by "
            f"{out[label]['bound_by']})")
        del q, k, v, qt, kt, vt, ref
    return out


def slot_traffic(engine, prompts, arrival, decode_steps, stats=None):
    """Phase 4's traffic through a slot engine: ``put`` returns logits (the
    slot prefill path), whose argmax is fed; ``decode_step`` selects on the
    card. Records as ``serve``'s: {uid: token} a call."""
    records = []
    out = engine.put(list(prompts), [list(p) for p in prompts.values()])
    toks = {u: int(np.argmax(v)) for u, v in sorted(out.items())}
    records.append(dict(toks))
    uid = max(prompts)
    for step in range(decode_steps):
        feed = dict(toks)
        if step in (4, 8):
            uid += 1
            arrived = engine.put([uid], [list(arrival)])
            got = {u: int(np.argmax(v)) for u, v in arrived.items()}
            records.append(dict(got))
            feed.update(got)
        t0 = time.perf_counter()
        toks = engine.decode_step(feed, greedy=True)
        if stats is not None:
            stats.setdefault("decode_s", []).append(time.perf_counter() - t0)
        records.append(dict(toks))
    return records


def streams_of(records, prompts, arrival):
    """Each uid's (context, tokens) from ``serve``-style records."""
    out = {}
    for rec in records:
        for u, t in rec.items():
            out.setdefault(u, []).append(int(t))
    return {u: (list(prompts[u]) if u in prompts else list(arrival), toks)
            for u, toks in out.items()}


def turns_at_near_ties(engine, got, want, what):
    """Streams ``got`` against ``want`` ({uid: (context, tokens)}): where
    one turns, ``engine``'s own logits at that position (``put`` from a
    rebuilt engine) must give a top-2 margin within 8 bf16 units of the top
    logit. Returns the turns."""
    from deepspeed_tpu_torch.utils import prng

    found = []
    for u, (ctx, w) in want.items():
        g = got[u][1]
        i = next((k for k, (a, b) in enumerate(zip(w, g)) if a != b), None)
        if i is None:
            check(len(g) == len(w), f"{what}: uid {u} streams of different lengths")
            continue
        context = list(ctx) + w[:i]
        engine.rebuild()
        lg = engine.put([1], [context])[1]
        lg = torch.from_numpy(np.asarray(lg, np.float32))
        engine.flush(1)
        margin, _ = draw_margin(prng, lg, None, len(context))
        limit = 8 * ulps_bf16(float(lg.abs().max()))
        check(margin <= limit, f"{what}: uid {u} turns at token {i} where the margin is "
              f"{margin:.4g} (> {limit:.3g}, 8 bf16 units)")
        found.append({"uid": u, "token": i, "margin": margin})
    return found


def small_slot_vs_cpu(dev):
    """Phase 8 (e): the slot programs at phase 3's size (head_dim 64, fp32)
    on the card against the CPU, fp32 logits at atol 1e-4."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models import build_model

    model = build_model("llama-tiny", vocab_size=1024, num_layers=2, intermediate_size=512,
                        max_seq_len=512, hidden_size=256, num_heads=4, num_kv_heads=2)
    params = model.init_params(torch.Generator().manual_seed(0))
    opts = dict(dtype=torch.float32, max_seqs=4, prefill_chunk=64)
    rng = np.random.default_rng(1)
    prompts = {1: rng.integers(0, 1024, 20), 2: rng.integers(0, 1024, 150)}
    arrival = rng.integers(0, 1024, 48)
    ref, fed = serve(InferenceEngineV2(model, params, device="cpu", **opts),
                     prompts, arrival, 12, greedy=False)
    card = InferenceEngineV2(model, params, device=dev, **opts)
    got, _ = serve(card, prompts, arrival, 12, greedy=False, choices=fed)
    worst = 0.0
    for g, r in zip(got, ref):
        check(sorted(g) == sorted(r), "card and CPU slot engines returned different uids")
        for u in r:
            err = float(np.abs(g[u] - r[u]).max())
            check(np.isfinite(g[u]).all() and err <= 1e-4,
                  f"slot uid {u}: card vs CPU logits differ by {err:.3g} (atol 1e-4)")
            worst = max(worst, err)
    check(card.captured_graphs > 0, "the small slot engine captured no graph")
    log(f"slot engine on the card vs CPU (hd 64, fp32): {len(got)} calls, max_abs_err "
        f"{worst:.3g}, {card.captured_graphs} graphs ok")
    return worst


def slot_phase(params, fa, dev, paged_records):
    """Phase 8: slot mode. The kernel checks and timing, then
    ``InferenceEngineV2(paged=False)`` with its defaults on phase 4's
    weights (shared) serving phase 4's traffic: launches, programs within
    the JAX engine's bounds, streams against phase 4's paged ones, the
    decode step's host and device ms, memory; a scheduler run; the small
    model card vs CPU."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.serve import ContinuousBatchScheduler

    kernel_err = slot_kernels_vs_plain(fa, dev)
    timing = slot_timing(fa, dev)
    torch.cuda.empty_cache()
    model = build_model("llama-7b")
    cfg = model.config
    torch.cuda.reset_peak_memory_stats()
    engine = InferenceEngineV2(model, params, dtype=torch.bfloat16, device=dev)
    check(not engine.paged and engine.max_seqs == 8 and engine.max_seq_len == 4096,
          "the default engine is not an 8-slot, 4096-token slot engine")
    check(all(engine.params["blocks"][k] is v for k, v in params["blocks"].items()),
          "phase 8's engine copied phase 4's weights")
    rng = np.random.default_rng(0)  # phase 4's prompts and arrival
    prompts = {u: rng.integers(0, cfg.vocab_size, n)
               for u, n in zip((1, 2, 3, 4), (37, 300, 1000, 2100))}
    arrival = rng.integers(0, cfg.vocab_size, 640)
    stats = {}
    steps0 = engine.slot_steps
    fa.fwd_launches = 0  # just before the slot path
    records = slot_traffic(engine, prompts, arrival, 32, stats)
    torch.cuda.synchronize()
    launches, steps = fa.fwd_launches, engine.slot_steps - steps0
    check(launches == cfg.num_layers * steps and launches > 0,
          f"flash forward launched {launches} times in {steps} slot dispatches")
    prefill, decode = engine._slot_program_counts()
    check(max(prefill.values()) <= 32 and decode <= 2,
          f"slot programs past the JAX engine's bounds (32 a bucket, 2): {prefill}, {decode}")
    graphs = engine.captured_graphs
    check(graphs == sum(prefill.values()) + decode,
          f"{graphs} graphs for {sum(prefill.values())} prefill and {decode} decode keys")
    tokens = [t for rec in records for t in rec.values()]
    check(all(0 <= t < cfg.vocab_size for t in tokens), "a token lies outside [0, vocab)")
    # the same traffic's paged streams (phase 7's run of phase 4's traffic)
    turns = turns_at_near_ties(engine, streams_of(records, prompts, arrival),
                               streams_of(paged_records, prompts, arrival), "slot vs paged")
    log(f"phase 8 (c): slot engine served phase 4's traffic, {len(tokens)} tokens, flash "
        f"forward launched {launches} times (= {cfg.num_layers} layers x {steps} slot "
        f"dispatches); programs {prefill} + {decode} decode, {graphs} graphs; streams vs "
        f"paged: {len(turns)} turn(s) at a near tie {turns}")
    # the decode step, replayed: host clock and traced device time
    engine.rebuild()
    out = engine.put(list(prompts), [list(p) for p in prompts.values()])
    toks = {u: int(np.argmax(v)) for u, v in out.items()}
    for _ in range(2):
        toks = engine.decode_step(toks, greedy=True)
    torch.cuda.synchronize()
    # a trace whose kernel records fall short of the launches is taken once
    # more: the profiler has dropped a window's records before (PERF.md §5);
    # a replay that does not run its kernels falls short both times
    for attempt in range(2):
        n0 = fa.fwd_launches
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(4):
                toks = engine.decode_step(toks, greedy=True)
            host_ms = (time.perf_counter() - t0) * 1e3 / 4
            torch.cuda.synchronize()
        dev_us, ran = 0.0, 0
        for e in prof.key_averages():
            if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
                continue
            if "spin_kernel" in e.key:
                continue
            us = getattr(e, "self_device_time_total", None)
            dev_us += e.self_cuda_time_total if us is None else us
            if "attn_fwd" in e.key:
                ran += e.count
        if ran == fa.fwd_launches - n0 or attempt:
            break
        log(f"decode replays: the trace holds {ran} flash kernels of the "
            f"{fa.fwd_launches - n0} launched; tracing the next 4 steps again")
    check(ran == fa.fwd_launches - n0 == 4 * cfg.num_layers,
          f"decode replays: flash kernels run (trace) {ran}, counted {fa.fwd_launches - n0}, "
          f"expected {4 * cfg.num_layers}")
    reserved = torch.cuda.memory_reserved()
    peak = torch.cuda.max_memory_allocated()
    # the scheduler over the slot engine
    engine.rebuild()
    sched = ContinuousBatchScheduler(engine, age_weight=0.0)
    steps0, n0 = engine.slot_steps, fa.fwd_launches
    reqs = [sched.submit(list(p), max_new_tokens=16, uid=u) for u, p in prompts.items()]
    reqs.append(sched.submit(list(arrival), max_new_tokens=16, uid=5))
    sched.run_until_complete()
    sched.close()
    check(all(r.state.value == "done" and len(r.tokens) == 16 for r in reqs),
          "the scheduler over the slot engine did not finish every request")
    sched_launches = fa.fwd_launches - n0
    check(sched_launches == cfg.num_layers * (engine.slot_steps - steps0),
          "the scheduler's slot dispatches and flash launches disagree")
    engine.kv = None
    del engine
    torch.cuda.empty_cache()
    small_err = small_slot_vs_cpu(dev)
    decode_ms = np.asarray(stats["decode_s"]) * 1e3
    summary = {
        "model": "llama-7b", "layers": cfg.num_layers, "dtype": "bfloat16",
        "slots": 8, "max_seq_len": 4096, "kernel_max_abs_err": kernel_err,
        "kernel_timing": timing, "flash_fwd_launches": launches,
        "scheduler_flash_fwd_launches": sched_launches, "slot_dispatches": steps,
        "prefill_programs": {str(k): v for k, v in prefill.items()},
        "decode_programs": decode, "captured_graphs": graphs,
        "decode_step_ms_median": float(np.median(decode_ms)),
        "decode_step_replayed_host_ms": host_ms,
        "decode_step_device_ms": dev_us / 1e3 / 4,
        "memory_reserved_gib": reserved / 2**30, "max_memory_allocated_gib": peak / 2**30,
        "turns_vs_paged": turns, "scheduler_requests": len(reqs),
        "small_vs_cpu_max_abs_err": small_err,
    }
    log(f"phase 8: decode step host {host_ms:.3f} ms (replayed; median over the traffic "
        f"{summary['decode_step_ms_median']:.3f}), device {summary['decode_step_device_ms']:.3f}"
        f" ms; memory reserved {summary['memory_reserved_gib']:.2f} GiB, peak allocated "
        f"{summary['max_memory_allocated_gib']:.2f} GiB")
    return summary, launches + sched_launches


# ---------------------------------------------------------------------------
# phase 9: the KV tiers, swap preemption
# ---------------------------------------------------------------------------
#: phase 9's paged engine: a 32-block pool (1 GiB at llama-7b) under a
#: 32-block host tier (pinned) and a 16-block NVMe tier; 1024-token slots
#: keep the staging batch (a slot's blocks) at 16 blocks
TIER_ENGINE = dict(paged=True, max_seqs=4, max_seq_len=1024, block_size=64, num_blocks=33,
                   prefill_chunk=256, token_budget=256, host_tier_blocks=32,
                   nvme_tier_blocks=16)


def tier_traffic(engine, V, swap, seed=9):
    """Phase 9's traffic through ``ContinuousBatchScheduler(swap_preemption=
    swap)`` (preemption on, admission without its age term) on a fresh
    engine: (1) 12 prompts of 384 distinct tokens, 4 new tokens each: their
    72 full blocks overflow the pool's 32, so cached prefix blocks are
    demoted to the host tier and, past its 32, spilled to NVMe; (2) the 12
    prompts again with 16-token tails, newest first, whose prefix blocks hit
    on the device, on the host tier and (the oldest) on disk; (3) four
    300-token requests decoding 48
    tokens and, once every slot decodes, phase 6's priority-1000 arrival,
    which preempts one: by swap-out and swap-in with ``swap``, by replay
    without. Returns the requests in a fixed order and the scheduler."""
    from deepspeed_tpu_torch.serve import ContinuousBatchScheduler

    rng = np.random.default_rng(seed)
    first = [rng.integers(0, V, 384).tolist() for _ in range(12)]
    sched = ContinuousBatchScheduler(engine, preemption=True, age_weight=0.0,
                                     swap_preemption=swap)
    reqs = [sched.submit(p, max_new_tokens=4, uid=100 + i) for i, p in enumerate(first)]
    sched.run_until_complete()
    reqs += [sched.submit(first[i] + rng.integers(0, V, 16).tolist(), max_new_tokens=4,
                          uid=200 + i) for i in reversed(range(len(first)))]
    sched.run_until_complete()
    live = [sched.submit(rng.integers(0, V, 300).tolist(), max_new_tokens=48, uid=300 + i)
            for i in range(4)]
    while not all(r.tokens for r in live):
        check(sched.step(), "phase 9: the scheduler ran dry before every request decoded")
    vip = sched.submit(np.random.default_rng(6).integers(0, V, 100).tolist(), max_new_tokens=16,
                       priority=1000, uid=400)
    sched.run_until_complete()
    sched.close()
    return reqs + live + [vip], sched


class TierProbe:
    """Wraps phase 9's engine on the instance to hold the KV bytes a block
    had when it left the pool (demotion, swap-out) against the bytes that
    land back (promotion, swap-in; and a spilled block against what the
    NVMe store reads back), bitwise. Each method takes the engine's own
    function and returns its wrapper."""

    def __init__(self, engine):
        self.engine, self.snaps, self.spilled = engine, {}, {}
        self.checked = {"promoted": 0, "swapped_in": 0, "nvme_loaded": 0}
        for name in ("_demote_block", "swap_out", "_spill_block", "_load_block",
                     "_scatter_blocks"):
            setattr(engine, name, getattr(self, name.lstrip("_"))(getattr(engine, name)))

    def demote_block(self, fn):
        def call(block):
            snap = self.engine._tier_gather(block)
            t = fn(block)
            self.snaps[id(t)] = (t, snap, "promoted")
            return t
        return call

    def swap_out(self, fn):
        def call(uid):
            eng = self.engine
            d = eng.state.seqs.get(uid)
            snaps = [eng._tier_gather(b) for b in d.blocks] if d is not None else []
            ok = fn(uid)
            if ok:
                for t, snap in zip(eng._swaps[uid][0], snaps):
                    self.snaps[id(t)] = (t, snap, "swapped_in")
            return ok
        return call

    def spill_block(self, fn):
        def call(hid, payload):
            entry = self.snaps.get(id(payload))
            if entry is not None:
                self.spilled[hid] = entry[1]
            return fn(hid, payload)
        return call

    def load_block(self, fn):
        def call(hid):
            arr = fn(hid)
            if arr is not None and hid in self.spilled:
                check(torch.equal(arr.to(self.engine.device), self.spilled[hid]),
                      f"NVMe block {hid}: the bytes read back differ from those spilled")
                self.checked["nvme_loaded"] += 1
            return arr
        return call

    def scatter_blocks(self, fn):
        def call(payloads, dsts):
            eng = self.engine
            fn(payloads, dsts)
            for p, d in zip(payloads, dsts):
                entry = self.snaps.get(id(p))
                if entry is not None:
                    check(torch.equal(eng._tier_gather(d), entry[1]),
                          f"pool block {d}: the bytes landed differ from those that left "
                          f"({entry[2]})")
                    self.checked[entry[2]] += 1
                elif isinstance(p, torch.Tensor):
                    check(torch.equal(eng._tier_gather(d).cpu(), p),
                          f"pool block {d}: the bytes landed differ from the NVMe block")
        return call


def tier_phase(params, dev):
    """Phase 9: phase 4's weights (shared) in a tiered paged engine
    (``TIER_ENGINE``, the NVMe tier in a temporary directory removed at the
    end) serving ``tier_traffic`` three times from fresh engines: swap
    preemption with ``transfer_overlap`` on (the blocks' bytes probed), the
    same with it off (bitwise the same streams, ledger and counters), and
    preemption by replay (the same streams but for turns at a near tie)."""
    import shutil
    import tempfile

    from deepspeed_tpu_torch.analysis.sanitizer import check_transfer_ledger
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models import build_model

    model = build_model("llama-7b")
    V = model.config.vocab_size
    root = tempfile.mkdtemp(prefix="chip_smoke_nvme_")
    runs = {}
    try:
        for name, overlap, swap in (("swap", True, True), ("swap_sync", False, True),
                                    ("replay", True, False)):
            engine = InferenceEngineV2(model, params, dtype=torch.bfloat16, device=dev,
                                       transfer_overlap=overlap,
                                       nvme_tier_dir=os.path.join(root, name), **TIER_ENGINE)
            check(engine.host_tier_blocks == 32 and engine.nvme_tier_blocks == 16
                  and engine.block_bytes == 32 * 2**20,
                  f"phase 9's engine: tiers {engine.host_tier_blocks}/{engine.nvme_tier_blocks},"
                  f" {engine.block_bytes} bytes a block")
            probe = TierProbe(engine) if name == "swap" else None
            t0 = time.perf_counter()
            reqs, sched = tier_traffic(engine, V, swap)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check(all(r.state.value == "done" for r in reqs), f"phase 9 ({name}): requests "
                  f"not done: {[(r.uid, r.state.value) for r in reqs if not r.finished]}")
            check_transfer_ledger(engine.transfer)
            te = engine.transfer
            runs[name] = {
                "streams": {r.uid: (list(r.prompt), list(r.tokens)) for r in reqs},
                "stats": engine.prefix_cache_stats(), "ledger": te.ledger(),
                "nvme": dict(te.nvme.counters), "preemptions": sched.metrics.preemptions,
                "readmit_s": list(sched.metrics.swap_readmit_s), "wall_s": wall,
                "d2h_gb_per_s": 1e-9 / te.s_per_byte("d2h") if te.s_per_byte("d2h") else 0.0,
                "h2d_gb_per_s": 1e-9 / te.s_per_byte("h2d") if te.s_per_byte("h2d") else 0.0,
                "probe": dict(probe.checked) if probe else None,
            }
            if name != "replay":
                engine.kv = None
                del engine, probe
                torch.cuda.empty_cache()
        s, sync, replay = runs["swap"], runs["swap_sync"], runs["replay"]
        st = s["stats"]
        for key in ("demoted_blocks", "promoted_blocks", "nvme_spilled_blocks",
                    "nvme_loaded_blocks", "swap_out", "swap_in"):
            check(st[key] > 0, f"phase 9: {key} is {st[key]}")
        for key, n in s["probe"].items():
            check(n > 0, f"phase 9: no {key} block was held against its bytes")
        check(sync["streams"] == s["streams"], "phase 9: overlap off changed the streams")
        # the same transfers submitted; overlap off settles each at submit,
        # so only its completed / in-flight split differs
        check(sync["ledger"]["submitted"] == s["ledger"]["submitted"]
              and sync["stats"] == s["stats"] and sync["nvme"] == s["nvme"],
              f"phase 9: overlap off changed the ledger or counters: {s['ledger']} vs "
              f"{sync['ledger']}")
        check(replay["stats"]["swap_out"] == 0 and replay["preemptions"] >= 1,
              "phase 9: the replay run swapped or did not preempt")
        turns = turns_at_near_ties(engine, replay["streams"], s["streams"], "replay vs swap")
        engine.kv = None
        del engine
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    per_block_ms = sum(s["readmit_s"]) / st["swap_in_blocks"] * 1e3
    summary = {
        "model": "llama-7b", "dtype": "bfloat16", "engine": TIER_ENGINE,
        "block_bytes": 32 * 2**20, "max_inflight_bytes": 32 * 2**20,
        "counters": {k: st[k] for k in ("demoted_blocks", "promoted_blocks",
                                        "nvme_spilled_blocks", "nvme_loaded_blocks",
                                        "host_evicted_blocks", "swap_out", "swap_in",
                                        "swap_in_blocks", "hits")},
        "blocks_held_bitwise": s["probe"], "ledger": s["ledger"],
        "ledger_overlap_off": sync["ledger"], "nvme": s["nvme"],
        "d2h_gb_per_s": s["d2h_gb_per_s"], "h2d_gb_per_s": s["h2d_gb_per_s"],
        "swap_in_ms_per_block": per_block_ms, "swap_in_s": s["readmit_s"],
        "wall_s": {k: r["wall_s"] for k, r in runs.items()},
        "overlap_off_bitwise": True, "replay_turns": turns,
    }
    log(f"phase 9: demoted {st['demoted_blocks']}, promoted {st['promoted_blocks']}, NVMe "
        f"spilled {st['nvme_spilled_blocks']} / loaded {st['nvme_loaded_blocks']}, swap out "
        f"{st['swap_out']} / in {st['swap_in']}; bytes held bitwise {s['probe']}; overlap off "
        f"bitwise; replay vs swap {len(turns)} turn(s) at a near tie; D2H "
        f"{s['d2h_gb_per_s']:.2f} GB/s, H2D {s['h2d_gb_per_s']:.2f} GB/s, swap-in "
        f"{per_block_ms:.3f} ms a block")
    return summary


# ---------------------------------------------------------------------------
# phase 10: the engine pool
# ---------------------------------------------------------------------------
# each replica: phase 4's model geometry at max_seqs 4; 128 blocks of 64
# tokens (4 GiB of bf16 KV, room for four 2100-token rows), every request
# of the traffic under 2560 tokens
POOL_ENGINE = dict(paged=True, max_seqs=4, max_seq_len=2560, block_size=64, num_blocks=128,
                   prefill_chunk=256, token_budget=256, prefix_cache=True)
POOL_NEW_TOKENS = 24


def pool_requests(V, seed=10):
    """Phase 10's traffic as (uid, prompt, sampling kwargs): the first of
    four requests sharing a 640-token prefix (submitted alone, so that its
    prefix is cached before the rest are placed), then the other three,
    phase 4's four prompts (37, 300, 1000 and 2100 tokens) and two sampled
    requests (seeds 1 and 2)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, V, 640).tolist()
    shared = [(1 + i, prefix + rng.integers(0, V, 16 + 8 * i).tolist(), None)
              for i in range(4)]
    r0 = np.random.default_rng(0)  # phase 4's prompts
    p4 = [r0.integers(0, V, n).tolist() for n in (37, 300, 1000, 2100)]
    plain = [(11 + i, p, None) for i, p in enumerate(p4)]
    sampled = [(21, p4[1], dict(temperature=0.8, top_k=50, seed=1)),
               (22, rng.integers(0, V, 200).tolist(), dict(temperature=1.0, top_p=0.9, seed=2))]
    return shared[:1], shared[1:] + plain + sampled


def pool_submit(target, reqs, max_new_tokens=POOL_NEW_TOKENS):
    from deepspeed_tpu_torch.serve import SamplingParams

    return [target.submit(p, max_new_tokens=max_new_tokens, uid=u,
                          sampling=None if s is None else SamplingParams(**s))
            for u, p, s in reqs]


def pool_drive(target, first, rest, on_step=None, step_s=None):
    """Submit ``first``, step until it has a token (its prefix blocks are
    then cached on its replica), submit ``rest`` and step to the end.
    ``on_step(i)`` runs after pool step i; ``step_s`` collects each step's
    host seconds. Returns the requests and the owners at placement."""
    reqs = pool_submit(target, first)
    while not reqs[0].tokens:
        check(target.step(), "phase 10: the first request never produced a token")
    more = pool_submit(target, rest)
    owners = {r.uid: target.owner_of(r.uid) for r in reqs + more} \
        if hasattr(target, "owner_of") else {}
    reqs += more
    i = 0
    while True:
        t0 = time.perf_counter()
        work = target.step()
        if step_s is not None:
            step_s.append(time.perf_counter() - t0)
        if on_step is not None:
            on_step(i)
        i += 1
        if not work:
            break
    check(all(r.state.value == "done" for r in reqs),
          f"phase 10: requests not done: {[(r.uid, r.state.value) for r in reqs if not r.finished]}")
    return reqs, owners


def pool_streams(reqs):
    return {r.uid: (list(r.prompt), list(r.tokens)) for r in reqs}


def sampled_tie(lg, sp, position, a, b, delta):
    """Whether a sampled row's draw could pick ``a`` in one run and ``b``
    in another, the runs' logits ``delta`` apart (phase 8's 8 bf16 units,
    as for a greedy row's top-2 margin): the two tokens' ``gumbel + x``
    scores (x = logits / temperature) within ``delta / temperature``, or
    either token on the top-k boundary (its logit within ``delta`` of the
    k-th largest, so that the candidate set itself may differ) or at the
    nucleus edge (the probability mass before it within ``delta /
    temperature`` of top-p). Returns (tie, score gap, reason)."""
    from deepspeed_tpu_torch.utils import prng

    t = sp.temperature
    x = lg.float() / t
    srt = torch.sort(lg.float(), descending=True).values
    reasons = []
    if sp.top_k > 0:
        kth = float(srt[min(sp.top_k, srt.numel()) - 1])
        if any(abs(float(lg[tok]) - kth) <= delta for tok in (a, b)):
            reasons.append("top-k boundary")
    if sp.top_p < 1.0:
        probs = torch.softmax(srt / t, -1)
        before = torch.cumsum(probs, -1) - probs
        rank = {tok: int((lg.float() > lg[tok]).sum()) for tok in (a, b)}
        if any(abs(float(before[rank[tok]]) - sp.top_p) <= delta / t for tok in (a, b)):
            reasons.append("nucleus edge")
    g = prng.gumbel(prng.fold_in(prng.PRNGKey(sp.seed), position), x.shape)
    gap = abs(float(g[a] + x[a] - g[b] - x[b]))
    if gap <= delta / t:
        reasons.append("scores")
    return bool(reasons), gap, ",".join(reasons)


def pool_turns(engine, got, want, samplings, what):
    """Streams ``got`` against ``want`` ({uid: (context, tokens)}) under
    phase 8's rule, the logits at the first turn recomputed by ``engine``
    (``put`` from a rebuild), the runs' logits allowed to differ by 8 bf16
    units of the top one: a greedy row may turn where its top-2 margin is
    within that; a sampled row where ``sampled_tie`` finds the two runs'
    tokens tied. Returns the turns."""
    from deepspeed_tpu_torch.serve import SamplingParams

    found = []
    for u, (ctx, w) in want.items():
        g = got[u][1]
        i = next((k for k, (a, b) in enumerate(zip(w, g)) if a != b), None)
        if i is None:
            check(len(g) == len(w), f"{what}: uid {u} streams of different lengths")
            continue
        context = list(ctx) + w[:i]
        engine.rebuild()
        lg = torch.from_numpy(np.asarray(engine.put([1], [context])[1], np.float32))
        engine.flush(1)
        delta = 8 * ulps_bf16(float(lg.abs().max()))
        s = samplings.get(u)
        if s is None:
            top2 = lg.topk(2).values
            margin = float(top2[0] - top2[1])
            check(margin <= delta, f"{what}: uid {u} turns at token {i} where the top-2 "
                  f"margin is {margin:.4g} (> {delta:.3g}, 8 bf16 units)")
            found.append({"uid": u, "token": i, "margin": margin})
            continue
        tie, gap, why = sampled_tie(lg, SamplingParams(**s), len(context), w[i], g[i], delta)
        check(tie, f"{what}: sampled uid {u} turns at token {i} ({w[i]} vs {g[i]}) where "
              f"the scores differ by {gap:.4g} (> {delta / s['temperature']:.3g}) and "
              f"neither token is at the top-k or nucleus edge (8 bf16 units: {delta:.3g})")
        found.append({"uid": u, "token": i, "score_gap": gap, "tie": why})
    return found


class HandoffProbe:
    """Holds every block of a KV handoff bitwise: the source's blocks on
    the card against the payload ``export_swap`` returns (the D2H), and the
    payload against the blocks ``swap_in`` lands in the destination's pool
    (the H2D). Wraps the two engines' methods on the instance, and keeps the
    host seconds of the real ``export_swap`` and ``import_swap`` calls and
    of its own copies and compares inside a handoff (``probe_s``), which
    the handoff's time excludes."""

    def __init__(self, src, dst):
        self.src, self.dst = src, dst
        self.exported = self.landed = 0
        self.export_s = self.import_s = self.probe_s = 0.0
        self.payloads, self._ids = [], set()
        src.export_swap = self._export(src.export_swap)
        dst.import_swap = self._import(dst.import_swap)
        dst._scatter_blocks = self._scatter(dst._scatter_blocks)

    def _export(self, fn):
        def call(uid):
            t0 = time.perf_counter()
            d = self.src.state.seqs.get(uid)
            snaps = [self.src._tier_gather(b).cpu() for b in d.blocks] if d is not None else []
            t1 = time.perf_counter()
            p = fn(uid)
            t2 = time.perf_counter()
            if p is not None:
                for b, s in zip(p["blocks"], snaps):
                    check(torch.equal(torch.as_tensor(b), s),
                          f"uid {uid}: an exported block differs from the source's bytes")
                    self.exported += 1
                self.payloads.append(p)
            self.export_s += t2 - t1
            self.probe_s += (t1 - t0) + (time.perf_counter() - t2)
            return p
        return call

    def _import(self, fn):
        def call(uid, payload):
            t0 = time.perf_counter()
            n = fn(uid, payload)
            self.import_s += time.perf_counter() - t0
            self._ids.update(id(b) for b in payload["blocks"])
            return n
        return call

    def _scatter(self, fn):
        def call(payloads, dsts):
            fn(payloads, dsts)
            for p, d in zip(payloads, dsts):
                if id(p) in self._ids:
                    check(torch.equal(self.dst._tier_gather(d).cpu(), torch.as_tensor(p)),
                          f"pool block {d}: the handed-off bytes landed changed")
                    self.landed += 1
        return call

    def remove(self):
        for eng, names in ((self.src, ("export_swap",)),
                           (self.dst, ("import_swap", "_scatter_blocks"))):
            for name in names:
                delattr(eng, name)


def latency_stats(reqs):
    ttft = [r.first_token_time - r.arrival_time for r in reqs]
    tpot = [(r.finish_time - r.first_token_time) / (len(r.tokens) - 1)
            for r in reqs if len(r.tokens) > 1]
    pct = lambda xs, q: float(np.percentile(np.asarray(xs) * 1e3, q))  # noqa: E731
    return {"ttft_ms_p50": pct(ttft, 50), "ttft_ms_p90": pct(ttft, 90),
            "tpot_ms_p50": pct(tpot, 50), "tpot_ms_p90": pct(tpot, 90)}


def pool_phase(params, pa, dev, card):
    """Phase 10: ``EnginePool`` over llama-7b replicas sharing phase 4's
    weights, on the paged kernel: (a) placement, and a replay from
    ``rebuild()`` bitwise; (b) migration and rebalance; (c) a replica's
    death absorbed by journal replay; (d) a rolling update to v2; (e) a
    ``DisaggPool`` handoff, its bytes held bitwise, and a CRC corruption
    refused and replayed; (f) a durable-journal restore on fresh engines;
    (g) ``scale_to(3)`` then ``scale_to(2)`` mid-traffic. Returns the
    pool_summary fields and the paged launches."""
    import shutil
    import tempfile

    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.resilience import DurableRequestJournal, FaultInjector, FaultSpec
    from deepspeed_tpu_torch.runtime.transfer_engine import TransferCorruptError, blocks_crc32
    from deepspeed_tpu_torch.serve import ContinuousBatchScheduler, DisaggPool, EnginePool

    model = build_model("llama-7b")
    cfg = model.config
    first, rest = pool_requests(cfg.vocab_size)
    samplings = {u: s for u, _, s in first + rest if s is not None}
    engines, retired = [], [0]

    def new_engine():
        eng = InferenceEngineV2(model, params, dtype=torch.bfloat16, device=dev, **POOL_ENGINE)
        check(eng.params["blocks"]["wq"].data_ptr() == params["blocks"]["wq"].data_ptr(),
              "phase 10: a replica copied the shared weights")
        engines.append(eng)
        return eng

    def retire(eng):
        retired[0] += eng.ragged_steps
        engines.remove(eng)
        eng.kv = None

    def build(cls=EnginePool, n=2, reps=None, **kw):
        reps = reps or engines[:n]
        for e in reps:
            e.rebuild()
        return cls.build(lambda i: reps[i], n, age_weight=0.0, **kw)

    t_phase = time.perf_counter()
    pa.launches = 0  # the pool path's count, just before
    e0, e1 = new_engine(), new_engine()

    # (a) placement; the same traffic again from rebuilt engines, bitwise
    pool = build()
    step_s = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs, owners = pool_drive(pool, first, rest, step_s=step_s)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hits = pool.metrics.pool["placement_hits"]
    shared_owner = owners[1]
    check(hits >= 3 and all(owners[u] == shared_owner for u in (2, 3, 4)),
          f"phase 10 (a): the shared-prefix requests were not placed by affinity: owners "
          f"{owners}, placement hits {hits}")
    lat = latency_stats(reqs)
    run_a = pool_streams(reqs)
    pool.close()
    reserved2 = torch.cuda.memory_reserved()
    pool = build()
    again, owners2 = pool_drive(pool, first, rest)
    pool.close()
    check(pool_streams(again) == run_a and owners2 == owners,
          "phase 10 (a): the replay from rebuild() differs from the first run")
    e0.rebuild()
    single = ContinuousBatchScheduler(e0, age_weight=0.0)
    sreqs, _ = pool_drive(single, first, rest)
    single.close()
    turns_single = pool_turns(e0, run_a, pool_streams(sreqs), samplings,
                              "phase 10 (a) pool vs one engine")
    log(f"phase 10 (a): placement hits {hits}, shared-prefix requests on replica "
        f"{shared_owner}, replay from rebuild() bitwise, pool vs one engine "
        f"{len(turns_single)} turn(s) at a near tie")

    # (b) migration mid-decode, then rebalance
    pool = build()
    moved = {}

    def migrate(i):
        if moved:
            return
        r = pool._requests.get(12)
        if r is not None and len(r.tokens) >= 4 and not r.finished:
            moved["uid"], moved["src"] = 12, pool.owner_of(12)
            pool.migrate(12, 1 - moved["src"])
            moved["rebalanced"] = pool.rebalance()
    mreqs, _ = pool_drive(pool, first, rest, on_step=migrate)
    migrations = pool.metrics.pool["migrations"]
    pool.close()
    check(moved and migrations >= 1, "phase 10 (b): no request was migrated mid-decode")
    turns_mig = pool_turns(e0, pool_streams(mreqs), run_a, samplings, "phase 10 (b) migration")
    log(f"phase 10 (b): uid 12 migrated from replica {moved['src']} mid-decode, rebalance "
        f"moved {moved['rebalanced']}, {migrations} migration(s); streams vs (a): "
        f"{len(turns_mig)} turn(s) at a near tie")

    # (c) replica 1 dies at its third decode_step; replica 0 replays its journal
    inj = FaultInjector([FaultSpec(site="decode_step", kind="device_lost", nth=3)])
    for e in (e0, e1):
        e.rebuild()
    pool = EnginePool.build(lambda i: (e0, inj.wrap(e1))[i], 2, age_weight=0.0)
    dreqs, _ = pool_drive(pool, first, rest)
    states = [r.state for r in pool.replicas]
    deaths, replays = pool.metrics.pool["replica_deaths"], pool.metrics.pool["death_replays"]
    pool.close()
    check(inj.deaths == 1 and states == ["serving", "dead"] and deaths == 1 and replays >= 1,
          f"phase 10 (c): deaths {inj.deaths}, states {states}, replays {replays}")
    turns_death = pool_turns(e0, pool_streams(dreqs), run_a, samplings, "phase 10 (c) death")
    log(f"phase 10 (c): replica 1 lost at its 3rd decode_step, {replays} request(s) replayed "
        f"on replica 0; streams vs (a): {len(turns_death)} turn(s) at a near tie")

    # (d) rolling update to v2 (new final norm and head, the rest shared)
    gen = torch.Generator(device=dev).manual_seed(2)
    v2 = dict(params)
    v2["lnf_scale"] = 1.0 + 0.1 * torch.randn(params["lnf_scale"].shape, generator=gen,
                                               device=dev).to(params["lnf_scale"].dtype)
    v2["lm_head"] = (0.02 * torch.randn(params["lm_head"].shape, generator=gen, device=dev)
                     ).to(params["lm_head"].dtype)
    pool = build()
    captures = [e.graph_captures for e in (e0, e1)]
    # admitted after the update: one by prefix affinity (uid 12's prompt),
    # one on the least-loaded replica, so that both replicas step on v2
    after = [(31, rest[4][1], None),
             (32, np.random.default_rng(31).integers(0, cfg.vocab_size, 200).tolist(), None)]
    late = {}

    def update(i):
        if i == 4:
            pool.rolling_update(v2, version="v2", steps_between=2)
            late["reqs"] = pool_submit(pool, after)
            late["owners"] = [pool.owner_of(u) for u, _, _ in after]
    ureqs, _ = pool_drive(pool, first, rest, on_step=update)
    rejects = [(r.scheduler.metrics.admission_rejects, r.scheduler.metrics.deadline_cancels)
               for r in pool.replicas]
    versions = [e.weights_version for e in (e0, e1)]
    swaps = pool.metrics.pool["weight_swaps"]
    pool.close()
    check(all(r.state.value == "done" for r in late["reqs"] + ureqs)
          and versions == ["v2", "v2"] and swaps == 2 and rejects == [(0, 0), (0, 0)]
          and sorted(late["owners"]) == [0, 1],
          f"phase 10 (d): versions {versions}, swaps {swaps}, rejects {rejects}, the "
          f"requests after the update on replicas {late['owners']}")
    check(all(e.graph_captures > c for e, c in zip((e0, e1), captures)),
          "phase 10 (d): the graphs were not captured again after the update")
    e0.rebuild()
    one = ContinuousBatchScheduler(e0, age_weight=0.0)
    ref_late = pool_submit(one, after)
    one.run_until_complete()
    one.close()
    turns_v2 = pool_turns(e0, pool_streams(late["reqs"]), pool_streams(ref_late), {},
                          "phase 10 (d) v2 requests")
    for e in (e0, e1):
        e.rebuild()
        e.load_params(params)
    log(f"phase 10 (d): rolling update to v2 mid-traffic, {swaps} weight swaps, no admission "
        f"rejected, graphs captured again, the two requests admitted after it (replicas "
        f"{late['owners']}) vs one v2 engine {len(turns_v2)} turn(s) at a near tie")

    # (e) disaggregation: replica 0 prefills, replica 1 decodes
    pool = build(DisaggPool, roles=["prefill", "decode"])
    probe = HandoffProbe(e0, e1)
    hreqs, _ = pool_drive(pool, first, rest)
    pm = dict(pool.metrics.pool)
    n_kv = max(pm["handoffs_kv"], 1)
    # the pool's handoff time less what the probe's own copies took
    handoff_ms = (float(np.sum(pool.metrics._handoff_s)) - probe.probe_s) / n_kv * 1e3
    split = {"export_ms": probe.export_s / n_kv * 1e3, "import_ms": probe.import_s / n_kv * 1e3}
    big = max(probe.payloads, key=lambda p: len(p["blocks"]))
    t0 = time.perf_counter()
    blocks_crc32(big["blocks"])
    split["crc_ms_largest"] = (time.perf_counter() - t0) * 1e3
    split["largest_blocks"] = len(big["blocks"])
    pool.close()
    check(pm["handoffs_kv"] > 0 and pm["handoffs"] == pm["handoffs_kv"]
          and probe.exported > 0 and probe.landed == probe.exported,
          f"phase 10 (e): handoffs {pm['handoffs']}, by KV {pm['handoffs_kv']}, blocks "
          f"exported {probe.exported}, landed bitwise {probe.landed}")
    turns_disagg = pool_turns(e0, pool_streams(hreqs), run_a, samplings, "phase 10 (e) disagg")
    e1.rebuild()
    bad = dict(probe.payloads[0], crc32=int(probe.payloads[0]["crc32"]) ^ 1)
    try:
        e1.import_swap(bad["uid"], bad)
        check(False, "phase 10 (e): a corrupted payload was imported")
    except TransferCorruptError:
        pass
    probe.remove()
    # a corruption in transit on every handoff: each falls back to journal replay
    pool = build(DisaggPool, roles=["prefill", "decode"])
    real_export = e0.export_swap

    def tampered(uid):
        p = real_export(uid)
        return None if p is None else dict(p, crc32=int(p["crc32"]) ^ 1)
    e0.export_swap = tampered
    creqs = pool_submit(pool, [(41, rest[3][1], None), (42, rest[4][1][:300], None)],
                        max_new_tokens=8)
    pool.run_until_complete()
    cm = dict(pool.metrics.pool)
    pool.close()
    del e0.export_swap
    check(cm["handoffs"] == 2 and cm["handoffs_kv"] == 0
          and all(r.state.value == "done" for r in creqs),
          f"phase 10 (e): corrupted handoffs {cm['handoffs']}, by KV {cm['handoffs_kv']}")
    log(f"phase 10 (e): {pm['handoffs_kv']} handoffs by KV transfer, 0 by replay, "
        f"{probe.exported} blocks exported and landed bitwise, {handoff_ms:.2f} ms a handoff "
        f"({split});"
        f" a corrupted payload raised TransferCorruptError and 2 corrupted handoffs replayed; "
        f"streams vs (a): {len(turns_disagg)} turn(s) at a near tie")

    # (f) a durable journal; the pool dropped mid-traffic and restored on fresh engines
    root = tempfile.mkdtemp(prefix="chip_smoke_journal_")
    try:
        pool = build(journal_factory=lambda i: DurableRequestJournal(
            EnginePool.journal_path(root, i)))
        pool_submit(pool, first + rest)
        for _ in range(12):
            pool.step()
        committed = {e.uid: list(e.tokens) for rep in pool.replicas
                     for e in rep.scheduler.journal.live()}
        for rep in pool.replicas:
            rep.scheduler.journal.close()
        del pool
        for e in (e0, e1):
            retire(e)
        del e0, e1
        torch.cuda.empty_cache()
        fresh = [new_engine(), new_engine()]
        pool = EnginePool.restore(root, lambda i: fresh[i], age_weight=0.0)
        restored = sorted(pool._requests)
        pool.run_until_complete()
        kept = all(pool._requests[u].tokens[:len(t)] == t for u, t in committed.items())
        done = all(pool._requests[u].state.value == "done" for u in restored)
        pool.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(restored == sorted(committed) and committed and kept and done,
          f"phase 10 (f): restored {restored} of {sorted(committed)}, prefixes kept {kept}")
    log(f"phase 10 (f): {len(restored)} live request(s) restored from the durable journals "
        f"on fresh engines, every one finished with its committed prefix kept")

    # (g) elastic: 2 -> 3 -> 2 replicas mid-traffic
    grown = {}

    def factory(i):
        return fresh[i] if i < 2 else grown.setdefault(i, new_engine())
    for e in fresh:
        e.rebuild()
    pool = EnginePool.build(factory, 2, age_weight=0.0)

    def scale(i):
        if i == 2:
            grown["up"] = pool.scale_to(3)
        if i == 8:
            grown["reserved3"] = torch.cuda.memory_reserved()
            grown["down"] = pool.scale_to(2)
    greqs, _ = pool_drive(pool, first, rest, on_step=scale)
    em = dict(pool.metrics.pool)
    pool.close()
    check(grown.get("up") == 1 and grown.get("down") == -1 and em["scale_ups"] == 1
          and em["scale_downs"] == 1, f"phase 10 (g): scale up {grown.get('up')}, down "
          f"{grown.get('down')}")
    log(f"phase 10 (g): scale_to(3) and scale_to(2) mid-traffic, every request finished; "
        f"memory reserved {reserved2 / 2**30:.2f} GiB at 2 replicas, "
        f"{grown['reserved3'] / 2**30:.2f} GiB at 3")

    torch.cuda.synchronize()
    launches = pa.launches  # read just after
    ragged = retired[0] + sum(e.ragged_steps for e in engines)
    check(launches == cfg.num_layers * ragged and launches > 0,
          f"phase 10: paged_decode_attention launched {launches} times in {ragged} ragged "
          f"steps over every replica (expected {cfg.num_layers * ragged})")
    for e in list(engines):
        retire(e)
    torch.cuda.empty_cache()
    tokens = sum(len(r.tokens) for r in reqs)
    summary = {
        "card": card, "model": "llama-7b", "dtype": "bfloat16", "engine": POOL_ENGINE,
        "replicas": 2, "requests": len(reqs), "new_tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall, **lat,
        "host_ms_per_pool_step": float(np.median(step_s)) * 1e3, "pool_steps": len(step_s),
        "placement_hits": hits, "migrations": migrations, "handoffs_kv": pm["handoffs_kv"],
        "handoff_ms": handoff_ms, "handoff_split": split, "handoff_bytes": pm["handoff_bytes"],
        "handoff_blocks_bitwise": probe.landed, "death_replays": replays,
        "restored": len(restored), "memory_reserved_gib": {
            "2": reserved2 / 2**30, "3": grown["reserved3"] / 2**30},
        "turns": {"single": turns_single, "migration": turns_mig, "death": turns_death,
                  "v2": turns_v2, "disagg": turns_disagg},
        "paged_launches": launches, "ragged_steps": ragged,
        "phase_s": time.perf_counter() - t_phase,
    }
    return summary, launches


WOQ_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))  # (In, Out): wq/wk/wv/wo, w_gate/w_up, w_down
WOQ_TOL = (1e-4, 1e-5)  # atol, rtol: the JAX package's own (tests/unit/test_woq.py:169)


def woq_compare(out, ref):
    """Max abs error of the WOQ kernel against its plain version. Both form
    each weight as code * scale in fp32, round it to x's dtype and add fp32
    products, so only the order of an fp32 sum differs: fp32 tolerances
    for every x dtype."""
    atol, rtol = WOQ_TOL
    check(out.shape == ref.shape and out.dtype == ref.dtype == torch.float32,
          f"shape/dtype {tuple(out.shape)}/{out.dtype} vs {tuple(ref.shape)}/{ref.dtype}")
    check(torch.isfinite(out).all().item(), "non-finite kernel output")
    err = (out - ref).abs()
    bad = err > atol + rtol * ref.abs()
    check(not bad.any().item(),
          f"{int(bad.sum())} elements outside atol {atol} rtol {rtol} (max err {err.max():.3g})")
    return float(err.max())


def woq_kernels_vs_plain(wq, dev):
    """Phase q1: the WOQ kernels against their plain version at the main
    path's shapes (bf16 x at rows 1-300, fp32 at 1-256, fp16 at 37 and 256),
    8/6/4 bits; then group 64, a group that is not a power of two with a K
    tail, and every byte value. 16-bit calls repeat bitwise."""
    from deepspeed_tpu_torch.ops.quantizer import woq

    gen = torch.Generator(device=dev).manual_seed(7)
    worst = 0.0

    def case(label, x, codes, scale, bits):
        nonlocal worst
        out = wq.woq_matmul(x, codes, scale, bits)
        torch.cuda.synchronize()
        err = woq_compare(out, wq.woq_matmul_plain(x, codes, scale, bits))
        if x.dtype != torch.float32:  # no atomics: a repeat is bitwise equal
            check(torch.equal(out, wq.woq_matmul(x, codes, scale, bits)),
                  f"woq_matmul {label} int{bits} rows {x.shape[0]}: a repeat differs")
        if x.shape[0] == 8:  # a row's sums do not depend on the other rows
            for r in (0, 5):
                check(torch.equal(wq.woq_matmul(x[r:r + 1].contiguous(), codes, scale, bits),
                                  out[r:r + 1]),
                      f"woq_matmul {label} int{bits}: row {r} alone differs from 8 rows")
        worst = max(worst, err)
        log(f"kernel vs plain: woq_matmul {label} int{bits} x {str(x.dtype)[6:]} "
            f"rows {x.shape[0]}: max_abs_err {err:.3g} ok")

    main_rows = {torch.bfloat16: (1, 8, 37, 100, 129, 256, 300), torch.float32: (1, 8, 37, 256),
                 torch.float16: (37, 256)}
    cases = [(In, Out, 128) for In, Out in WOQ_SHAPES] + [(4096, 4096, 64), (4000, 1024, 128),
                                                        (4032, 1032, 96)]
    for In, Out, group in cases:
        w = torch.randn(In, Out, device=dev, generator=gen).mul_(0.02)
        main = group == 128 and In != 4000
        for bits in (8, 6, 4):
            codes, scale = woq.quantize_leaf(w, bits, group)
            g = woq.group_of(bits, codes.shape[1])
            for dtype in ((torch.bfloat16, torch.float32, torch.float16) if main
                          else (torch.bfloat16, torch.float32)):
                for rows in (main_rows[dtype] if main else (8,) if Out == 1032 else (8, 256)):
                    x = torch.randn(rows, In, device=dev, generator=gen).to(dtype)
                    case(f"({In}, {Out}) group {g}", x, codes, scale, bits)
        del w
    # every byte value, in every column and many rows, scales of the model's size
    for bits in (8, 6, 4):
        In, Out = 1024, 512
        g = 128
        packed = {8: g, 6: g // 4 * 3, 4: g // 2}[bits]
        codes = (torch.arange(In // g * packed * Out, device=dev) * 7919 % 256).to(torch.uint8)
        codes = codes.view(torch.int8).reshape(In // g, packed, Out)
        check(torch.unique(codes).numel() == 256, "the byte case misses a byte value")
        scale = torch.rand(In // g, 1, Out, device=dev, generator=gen).add_(0.5).mul_(
            0.02 / (2 ** (bits - 1) - 1))
        for dtype in (torch.bfloat16, torch.float32):
            for rows in (8, 256):
                x = torch.randn(rows, In, device=dev, generator=gen).to(dtype)
                case("every byte value", x, codes, scale, bits)
    return worst


def small_woq_vs_cpu(wq, dev):
    """Phase q2: the WOQ engine on the card against the same on the CPU."""
    from deepspeed_tpu_torch.inference.quantization import quantize_model
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models import build_model

    model = build_model("llama-tiny", vocab_size=1024, hidden_size=256, num_layers=2,
                        num_heads=4, num_kv_heads=2, intermediate_size=512,
                        max_seq_len=512)
    params = model.init_params(torch.Generator().manual_seed(0))
    opts = dict(paged=True, dtype=torch.float32, max_seqs=4, block_size=16,
                prefill_chunk=64, token_budget=64, prefix_cache=True)
    rng = np.random.default_rng(1)
    prompts = {1: rng.integers(0, 1024, 20), 2: rng.integers(0, 1024, 150)}
    arrival = rng.integers(0, 1024, 48)
    for bits in (8, 6, 4):
        _, qp = quantize_model(model, params, num_bits=bits, group_size=64)
        l0 = wq.launches
        ref, fed = serve(InferenceEngineV2(model, qp, device="cpu", **opts),
                         prompts, arrival, 12, greedy=False)
        got, _ = serve(InferenceEngineV2(model, qp, device=dev, **opts),
                       prompts, arrival, 12, greedy=False, choices=fed)
        check(wq.launches > l0, "the card engine did not launch the WOQ kernel")
        worst = 0.0
        for g, r in zip(got, ref):
            check(sorted(g) == sorted(r), "card and CPU engines returned different uids")
            for u in r:
                err = float(np.abs(g[u] - r[u]).max())
                check(np.isfinite(g[u]).all() and err <= 1e-4,
                      f"int{bits} uid {u}: card vs CPU logits differ by {err:.3g} (atol 1e-4)")
                worst = max(worst, err)
        # greedy streams: identical wherever the CPU's top-2 margin exceeds 1e-3
        margins = [min(float(np.diff(np.sort(v)[-2:])[0]) for v in rec.values())
                   for rec in ref[:-1]]
        n = next((i for i, m in enumerate(margins) if m <= 1e-3), len(margins))
        _, cpu_toks = serve(InferenceEngineV2(model, qp, device="cpu", **opts),
                            prompts, arrival, 12, greedy=True)
        _, card_toks = serve(InferenceEngineV2(model, qp, device=dev, **opts),
                             prompts, arrival, 12, greedy=True)
        check(n > 0 and card_toks[:n] == cpu_toks[:n],
              f"int{bits}: greedy streams differ within the first {n} decisions")
        log(f"WOQ slice on the card vs CPU (llama 256-wide, hd 64, int{bits} group 64, fp32): "
            f"{len(got)} calls, logits max_abs_err {worst:.3g}, greedy streams equal over "
            f"{n} decisions ok")


def woq_timing(wq, dev):
    """Phase q4: the WOQ kernels at the main path's shapes, decode rows (8),
    a short prefill (37) and prefill rows (256), each bit width, bf16 x,
    timed with CUDA events
    over copies of the weights that together exceed the 50 MB L2 (each
    layer's weights arrive cold on the main path). Beside it: the plain
    version, and ``torch.matmul`` of x with the weight dequantized to bf16
    beforehand (cuBLAS reading 2 B a weight, the dequant left out)."""
    import itertools

    from deepspeed_tpu_torch.ops.quantizer import woq

    gen = torch.Generator(device=dev).manual_seed(11)
    rows_all, results = (8, 37, 256), []
    for In, Out in WOQ_SHAPES:
        w = torch.randn(In, Out, device=dev, generator=gen).mul_(0.02)
        for bits in (8, 6, 4):
            codes, scale = woq.quantize_leaf(w, bits, 128)
            wbytes = codes.numel() + scale.numel() * 4
            copies = [(codes, scale)] + [(codes.clone(), scale.clone())
                                         for _ in range(-(-150_000_000 // wbytes))]
            dense = woq.dequant_params({f"w::q{bits}": codes, "w::scale": scale},
                                       torch.bfloat16)["w"]
            dense_copies = [dense] + [dense.clone() for _ in range(-(-150_000_000 //
                                                                        (dense.numel() * 2)))]
            for rows in rows_all:
                x = torch.randn(rows, In, device=dev, generator=gen).to(torch.bfloat16)
                cyc, dcyc = itertools.cycle(copies), itertools.cycle(dense_copies)
                ms = time_cuda(lambda: wq.woq_matmul(x, *next(cyc), bits))
                plain_ms = time_cuda(lambda: wq.woq_matmul_plain(x, codes, scale, bits),
                                     warmup=2, iters=10)
                library_ms = time_cuda(lambda: torch.matmul(x, next(dcyc)))
                err = woq_compare(wq.woq_matmul(x, codes, scale, bits),
                                  wq.woq_matmul_plain(x, codes, scale, bits))
                nbytes = wbytes + x.numel() * 2 + rows * Out * 4
                flops = 2 * rows * In * Out
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
                r = {"bits": bits, "rows": rows, "in": In, "out": Out, "ms": ms,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "bytes": nbytes, "flops": flops, "max_abs_err": err}
                results.append(r)
                log(f"woq_matmul int{bits} ({In}, {Out}) rows {rows}: {ms:.4f} ms, bound "
                    f"{r['bound_ms']:.4f} ({r['bound_by']}), plain {plain_ms:.4f}, "
                    f"bf16 matmul on a pre-dequantized weight {library_ms:.4f}")
            del copies, dense_copies, dense
        del w
    torch.cuda.empty_cache()
    return results


def rel_err(out, ref, floor=0.0):
    """Max abs error over max(floor, the reference's max magnitude)."""
    return float((out.float() - ref.float()).abs().max()
                 / max(floor, float(ref.float().abs().max()) + 1e-6))


def flash_case(B, S, nh, kvh, hd, dtype, dev, seed=0, Skv=None):
    rng = np.random.default_rng(seed)
    Skv = Skv or S
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
                   for shape in ((B, S, nh, hd), (B, Skv, kvh, hd), (B, Skv, kvh, hd),
                                 (B, S, nh, hd)))
    return q, k, v, do


def flash_vs_plain(fa, B, S, nh, kvh, hd, causal, dtype, dev, Skv=None):
    """One case of phase a: (fwd max abs err, bwd max abs err). A 16-bit
    forward and backward run twice and must repeat bitwise."""
    q, k, v, do = flash_case(B, S, nh, kvh, hd, dtype, dev, Skv=Skv)
    g = nh // kvh
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, num_kv_groups=g)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal, num_kv_groups=g)
    if dtype != torch.float32:
        again = (fa.flash_attention_fwd(q, k, v, causal=causal, num_kv_groups=g)
                 + fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal, num_kv_groups=g))
        check(all(torch.equal(a, b) for a, b in zip((out, lse) + grads, again)),
              "a repeated 16-bit flash forward or backward is not bitwise equal")
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_plain(q, k, v, causal=causal, num_kv_groups=g)
    ref_grads = fa.flash_attention_bwd_plain(q, k, v, ref_out, ref_lse, do, causal=causal,
                                             num_kv_groups=g)
    fwd_err = max(compare(out, ref_out, dtype), compare(lse, ref_lse, dtype))
    # gradients: bf16 / fp16 at 1e-2 of their max; fp32 at 1e-5, of their max where
    # that exceeds 1 (dk/dv sum g * S products in an order the plain
    # version's GEMM does not share)
    tol, floor = (1e-5, 1.0) if dtype == torch.float32 else (1e-2, 0.0)
    bwd_err = 0.0
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref_grads):
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{name} shape/dtype {tuple(got.shape)}/{got.dtype}")
        check(torch.isfinite(got.float()).all().item(), f"non-finite {name}")
        r = rel_err(got, want, floor)
        check(r <= tol, f"{name}: max err {r:.3g} of max({floor}, its max) > {tol}")
        bwd_err = max(bwd_err, float((got.float() - want.float()).abs().max()))
    return fwd_err, bwd_err


def flash_kernels_vs_plain(fa, dev):
    """Phase a: the flash kernels against their plain versions."""
    cases = (("llama-7b heads", 2, 2048, 32, 32, 128, True, None),
             ("llama-70b GQA heads", 1, 1024, 64, 8, 128, True, None),
             ("head_dim 64, non-causal", 2, 512, 8, 4, 64, False, None),
             ("head_dim 256, GQA 4", 1, 512, 8, 2, 256, True, None),
             ("S 1000 (tail tile)", 2, 1000, 8, 8, 128, True, None),
             ("S 1000 (tail tile), non-causal", 1, 1000, 4, 2, 64, False, None),
             ("S 130 (a 2-row tail), GQA 8", 2, 130, 16, 2, 128, True, None),
             ("head_dim 32 (llama-tiny), GQA 2", 2, 1000, 8, 4, 32, True, None),
             ("Sq 130 != Skv 1000, non-causal", 1, 130, 8, 2, 128, False, 1000))
    for label, B, S, nh, kvh, hd, causal, Skv in cases:
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            fe, be = flash_vs_plain(fa, B, S, nh, kvh, hd, causal, dtype, dev, Skv=Skv)
            log(f"kernel vs plain: flash attention {label} B={B} S={S} Skv={Skv or S} nh={nh} "
                f"kvh={kvh} hd={hd} causal={causal} {str(dtype)[6:]}: fwd max_abs_err {fe:.3g}, "
                f"bwd max_abs_err {be:.3g}" + (", bitwise repeatable" if dtype != torch.float32
                                                 else "") + " ok")


TRAIN_CONFIG = {
    "train_micro_batch_size_per_gpu": 2,
    "gradient_accumulation_steps": 1,
    "bf16": {"enabled": True},
    "gradient_clipping": 1.0,
    "optimizer": {"type": "AdamW", "params": {"lr": 3e-4, "weight_decay": 0.1}},
    "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 0, "warmup_max_lr": 3e-4,
                                                 "warmup_num_steps": 2}},
    "zero_optimization": {"stage": 0},
    "steps_per_print": 1,
    "seed": 0,
}


def small_train_vs_cpu(fa, dev):
    """Phase b: the training engine on the card against the same on the CPU."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import build_model

    model = build_model("llama-tiny", vocab_size=512, hidden_size=256, num_layers=2,
                        num_heads=4, num_kv_heads=2, intermediate_size=512, max_seq_len=256)
    params = model.init_params(torch.Generator().manual_seed(0))
    cfg = dict(TRAIN_CONFIG, bf16={"enabled": False}, steps_per_print=0,
               train_micro_batch_size_per_gpu=4,
               optimizer={"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1,
                                                      "eps": 1e-6}})
    engines = [deepspeed_tpu_torch.initialize(model=model, model_parameters=params,
                                              config=dict(cfg), device=d)[0]
               for d in ("cpu", dev)]
    rng = np.random.default_rng(3)
    f0 = fa.fwd_launches
    for step in range(3):
        batch = {"input_ids": rng.integers(0, 512, (4, 256)).astype(np.int32)}
        ref, got = (float(e.train_batch(iter([batch]))) for e in engines)
        check(np.isfinite(got) and abs(got - ref) <= 1e-5 * abs(ref),
              f"step {step + 1}: card loss {got!r} vs CPU {ref!r} (rtol 1e-5)")
    ref, got = (e.get_fp32_params() for e in engines)
    pairs = ([(f"blocks/{k}", ref["blocks"][k], got["blocks"][k]) for k in ref["blocks"]]
             + [(k, ref[k], got[k]) for k in ref if k != "blocks"])
    worst = 0.0
    for name, a, b in pairs:
        err = float((a - b).abs().max())
        check(err <= 1e-5, f"parameter {name}: card vs CPU differ by {err:.3g} (atol 1e-5)")
        worst = max(worst, err)
    check(fa.fwd_launches - f0 == 2 * 3, "the card engine did not run the flash kernel")
    log(f"training slice on the card vs CPU (llama 256-wide, hd 64, GQA 2, 2 layers, fp32, "
        f"3 steps): losses within rtol 1e-5, parameters max_abs_err {worst:.3g} ok")


def train_main_path(fa, pa, dev):
    """Phase c: llama-7b width, 4 layers, 6 train_batch steps."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import build_model

    model = build_model("llama-7b", num_layers=4)
    cfg = model.config
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, model_parameters=params,
                                                     config=dict(TRAIN_CONFIG), device=dev)
    del params
    B, S = TRAIN_CONFIG["train_micro_batch_size_per_gpu"], 2048
    batch = {"input_ids": torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32,
                                        device=dev,
                                        generator=torch.Generator(device=dev).manual_seed(0))}
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in engine.params["blocks"].values()) + sum(
        engine.params[k].numel() for k in ("wte", "lm_head", "lnf_scale"))
    log(f"set-up: llama-7b width ({cfg.num_layers} of 32 layers, hidden {cfg.hidden_size}), "
        f"{n_params} params, bf16 + fp32 master + Adam state in "
        f"{time.perf_counter() - t0:.3f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")

    steps, losses, step_s, lrs = 6, [], [], []
    torch.cuda.reset_peak_memory_stats()
    fa.fwd_launches = fa.bwd_launches = pa.launches = 0  # every count, just before
    for _ in range(steps):
        lrs.append(engine.get_lr()[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(engine.train_batch(iter([batch])))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = {"fwd": fa.fwd_launches, "bwd": fa.bwd_launches, "paged": pa.launches}
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    # the loss on a fresh batch of random tokens: nothing there can be
    # learned, so a fall on the fixed batch is memorisation; were causal
    # masking leaking future tokens, this would fall as well
    engine.eval()
    held_out = float(engine({"input_ids": torch.randint(
        0, cfg.vocab_size, (B, S), dtype=torch.int32, device=dev,
        generator=torch.Generator(device=dev).manual_seed(1))}))
    engine.train()

    check(all(np.isfinite(losses)), f"non-finite training loss: {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    check(held_out > 0.5 * np.log(cfg.vocab_size),
          f"loss {held_out:.4f} on a fresh random batch: the model sees future tokens")
    check(lrs == [3e-4, 0.0, 3e-4, 3e-4, 3e-4, 3e-4], f"lr sequence {lrs}")
    want = cfg.num_layers * steps
    check(launches["fwd"] == want and launches["bwd"] == want and launches["paged"] == 0,
          f"launches {launches}; expected {want} forward and {want} backward flash launches "
          f"(num_layers x steps) and no paged launch")
    ms = [s * 1e3 for s in step_s[1:]]  # step 1 is the warm-up
    tokens = B * S
    # model FLOPs a step: 6 per parameter per token (every weight but the
    # embedding lookup, forward and backward), plus causal attention's
    # QK^T and PV forward (2 * 2 * S^2/2 * hd a head) three times over
    flops = (6 * (n_params - engine.params["wte"].numel()) * tokens
             + 3 * 2 * 2 * B * cfg.num_heads * cfg.head_dim * S * S // 2 * cfg.num_layers)
    med = float(np.median(ms))
    summary = {
        "model": "llama-7b", "layers": cfg.num_layers, "reduced": "depth 32 -> 4",
        "params": n_params, "dtype": "bfloat16 (fp32 master)", "batch": [B, S],
        "steps": steps, "losses": losses, "lrs": lrs, "held_out_loss": held_out,
        "step_ms_median": med, "step_ms_p90": float(np.percentile(ms, 90)),
        "step_ms": ms, "tokens_per_s": tokens / (med / 1e3),
        "model_flops_per_step": flops, "mfu_of_989_tflops": flops / (med / 1e3) / 989e12,
        "max_memory_allocated_gib": peak / 2**30, "launches": launches,
    }
    log(f"training main path: losses {[round(x, 4) for x in losses]}, step median "
        f"{med:.2f} ms, flash fwd/bwd launched {launches['fwd']}/{launches['bwd']} times "
        f"(= {cfg.num_layers} layers x {steps} steps)")
    del engine
    torch.cuda.empty_cache()
    return launches, summary


def dropout_train_path(fa, dev, base):
    """Phase c2: phase c with ``dropout=0.1`` (6 steps, the same batch and
    settings). The masks the engine draws on the card in step 1 for layer
    0's attention and MLP outputs are held bitwise against the port's CPU
    draw from the same keys, and those keys against the reference's chain
    computed on the CPU (``split(fold_in(PRNGKey(seed), 0), L)[0]``, split
    into ``(r_drop, r_pld)``, then ``rng, r1 = split(r_drop)`` and
    ``rng, r2 = split(rng)``). The last step is traced with
    ``torch.profiler``: the device milliseconds of the threefry draws
    (``prng.bernoulli``, annotated) beside the step's."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.utils import prng

    model = build_model("llama-7b", num_layers=4, dropout=0.1)
    cfg = model.config
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, model_parameters=params,
                                                     config=dict(TRAIN_CONFIG), device=dev)
    del params
    B, S = TRAIN_CONFIG["train_micro_batch_size_per_gpu"], 2048
    batch = {"input_ids": torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32,
                                        device=dev,
                                        generator=torch.Generator(device=dev).manual_seed(0))}
    real = prng.bernoulli
    drawn = []

    def annotated(key, p, shape):
        with torch.profiler.record_function("threefry_bernoulli"):
            keep = real(key, p, shape)
        if len(drawn) < 2:  # step 1, layer 0: the attention output, then the MLP's
            drawn.append((key.clone(), keep.clone()))
        return keep

    steps, losses, step_s = 6, [], []
    prng.bernoulli = annotated
    try:
        torch.cuda.synchronize()
        fa.fwd_launches = fa.bwd_launches = 0  # every count, just before
        for i in range(steps):
            t0 = time.perf_counter()
            if i == steps - 1:
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    losses.append(engine.train_batch(iter([batch])))
                    torch.cuda.synchronize()
            else:
                losses.append(engine.train_batch(iter([batch])))
                torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        launches = {"fwd": fa.fwd_launches, "bwd": fa.bwd_launches}  # read just after
    finally:
        prng.bernoulli = real
    losses = [float(x) for x in losses]
    want = cfg.num_layers * steps
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"phase c2: losses {losses} not finite or not falling")
    check(launches["fwd"] == want and launches["bwd"] == want,
          f"phase c2: flash launches {launches}, expected {want} each")
    # the keys: the reference's chain, on the CPU
    k = prng.split(prng.fold_in(prng.PRNGKey(TRAIN_CONFIG["seed"]), 0), cfg.num_layers)[0]
    r_drop = prng.split(k)[0]
    rng, r1 = prng.split(r_drop)
    _, r2 = prng.split(rng)
    shape = (B, S, cfg.hidden_size)
    t0 = time.perf_counter()
    for (key, mask), want_key, what in zip(drawn, (r1, r2), ("attention", "MLP")):
        check(torch.equal(key.cpu(), want_key), f"phase c2: layer 0's {what} key on the card "
              f"{key.tolist()} is not the reference chain's {want_key.tolist()}")
        cpu = prng.bernoulli(want_key, 1.0 - cfg.dropout, shape)
        check(tuple(mask.shape) == shape and torch.equal(mask.cpu(), cpu),
              f"phase c2: layer 0's {what} mask drawn on the card differs from the CPU's "
              f"({int((mask.cpu() != cpu).sum())} of {cpu.numel()} elements)")
    cpu_s = time.perf_counter() - t0
    cuda = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    step_device_ms = sum(e.self_device_time_total for e in cuda) / 1e3
    draws = [e for e in prof.events() if e.name == "threefry_bernoulli"
             and e.device_type == torch.autograd.DeviceType.CPU]
    draw_ms = sum(e.device_time_total for e in draws) / 1e3 or None  # None: no kernel linked
    check(len(draws) == 2 * cfg.num_layers,
          f"phase c2: the trace holds {len(draws)} threefry draws, expected "
          f"{2 * cfg.num_layers}")
    one_ms = time_cuda(lambda: real(r1.to(dev), 1.0 - cfg.dropout, shape), warmup=2, iters=5)
    ms = [s * 1e3 for s in step_s[1:]]
    summary = {
        "model": "llama-7b", "layers": cfg.num_layers, "dropout": cfg.dropout,
        "batch": [B, S], "steps": steps, "losses": losses, "step_ms": ms,
        "step_ms_median": float(np.median(ms)),
        "phase_c_step_ms_median": base["step_ms_median"],
        "traced_step_device_ms": step_device_ms, "threefry_draws_traced": len(draws),
        "threefry_device_ms_per_step": draw_ms, "bernoulli_ms_one_draw": one_ms,
        "masks_bitwise_cpu": {"shape": list(shape), "draws": len(drawn),
                              "cpu_draw_s": cpu_s},
        "launches": launches,
    }
    log(f"phase c2 (dropout 0.1): losses {[round(x, 4) for x in losses]}, step median "
        f"{summary['step_ms_median']:.2f} ms (phase c {base['step_ms_median']:.2f}); threefry "
        f"draws {draw_ms} of {step_device_ms:.2f} traced device ms a step "
        f"({one_ms:.3f} ms a draw); step 1's layer-0 masks bitwise the CPU's at {shape}; "
        f"flash fwd/bwd launched {launches['fwd']}/{launches['bwd']} times")
    del engine
    torch.cuda.empty_cache()
    return launches, summary


def flash_timing(fa, dev):
    """Phase d: the flash kernels at the main path's attention shape."""
    import torch.nn.functional as F

    B, S, nh, hd, dtype = 2, 2048, 32, 128, torch.bfloat16
    q, k, v, do = flash_case(B, S, nh, nh, hd, dtype, dev, seed=5)
    kw = dict(causal=True, num_kv_groups=1)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_plain(q, k, v, **kw)
    ref_grads = fa.flash_attention_bwd_plain(q, k, v, ref_out, ref_lse, do, **kw)
    fwd_err = compare(out, ref_out, dtype)
    bwd_err = 0.0
    for got, want in zip(grads, ref_grads):
        check(rel_err(got, want) <= 1e-2, "flash backward disagrees at the main shape")
        bwd_err = max(bwd_err, float((got.float() - want.float()).abs().max()))

    fwd_ms = time_cuda(lambda: fa.flash_attention_fwd(q, k, v, **kw))
    bwd_ms = time_cuda(lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, **kw))
    plain_fwd_ms = time_cuda(lambda: fa.flash_attention_plain(q, k, v, **kw), warmup=2, iters=5)
    plain_bwd_ms = time_cuda(lambda: fa.flash_attention_bwd_plain(q, k, v, ref_out, ref_lse,
                                                                  do, **kw), warmup=2, iters=5)
    # the library yardstick, on (B, nh, S, hd) copies made beforehand
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    compare(lib_out.transpose(1, 2), ref_out, dtype)
    lib_fwd_ms = time_cuda(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
    lib_graph = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    lib_bwd_ms = time_cuda(lambda: torch.autograd.grad(lib_graph, (qg, kg, vg), dot,
                                                       retain_graph=True))

    def fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        torch.autograd.grad(o, (qg, kg, vg), dot)

    lib_fwd_bwd_ms = time_cuda(fwd_bwd)

    # bounds: operations at the bf16 tensor-core peak against bytes at HBM's rate
    elt = q.element_size()
    fwd_flops = 2 * 2 * B * nh * S * S * hd // 2  # causal: half the scores
    fwd_bytes = 4 * q.numel() * elt + lse.numel() * 4  # q, k, v read; o, lse written
    bwd_flops = fwd_flops * 5 // 2  # S recomputed, dP, dV, dK, dQ: 5 products to 2
    bwd_bytes = 8 * q.numel() * elt + lse.numel() * 4  # q, k, v, o, do, lse in; dq, dk, dv out
    bounds = []
    for flops, nbytes in ((fwd_flops, fwd_bytes), (bwd_flops, bwd_bytes)):
        t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        bounds.append((max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"))
    log(f"flash attention at the main shape (B={B} S={S} nh={nh} hd={hd} bf16 causal): "
        f"fwd {fwd_ms:.4f} ms (plain {plain_fwd_ms:.4f}, SDPA {lib_fwd_ms:.4f}, bound "
        f"{bounds[0][0]:.4f}); bwd {bwd_ms:.4f} ms (plain {plain_bwd_ms:.4f}, SDPA backward "
        f"{lib_bwd_ms:.4f}, bound {bounds[1][0]:.4f}); SDPA fwd+bwd {lib_fwd_bwd_ms:.4f} ms")
    fwd = {"max_abs_err": fwd_err, "ms": fwd_ms, "plain_ms": plain_fwd_ms,
           "bound_ms": bounds[0][0], "bound_by": bounds[0][1], "library_ms": lib_fwd_ms}
    bwd = {"max_abs_err": bwd_err, "ms": bwd_ms, "plain_ms": plain_bwd_ms,
           "bound_ms": bounds[1][0], "bound_by": bounds[1][1], "library_ms": lib_bwd_ms}
    return fwd, bwd, {"sdpa_fwd_bwd_ms": lib_fwd_bwd_ms, "fwd_flops": fwd_flops,
                      "bwd_flops": bwd_flops}


SPARSE_SHAPE = (1, 8192, 32, 128)  # B, S, heads, head_dim: llama-7b's attention width
SPARSE_BLOCK = 128


def sparse_path_layouts():
    """The sparse path's two ``SparseSelfAttention`` ops at llama-7b's heads."""
    from deepspeed_tpu_torch.ops.sparse_attention import (BigBirdSparsityConfig,
                                                          FixedSparsityConfig,
                                                          SparseSelfAttention)

    nh = SPARSE_SHAPE[2]
    return {
        "fixed": SparseSelfAttention(FixedSparsityConfig(
            num_heads=nh, block=SPARSE_BLOCK, num_local_blocks=4, num_global_blocks=1,
            attention="unidirectional")),
        "bigbird": SparseSelfAttention(BigBirdSparsityConfig(num_heads=nh, block=SPARSE_BLOCK)),
    }


def sparse_inputs(dev, seed=0):
    """bf16 q, k, v of the sparse path, from a seeded generator on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(SPARSE_SHAPE, device=dev, generator=gen).to(torch.bfloat16)
                 .requires_grad_() for _ in range(3))


def _empty_rows_layout(nh, n):
    """A window of 2 blocks per query block, with every third query block of
    each head (offset by the head) left empty."""
    lay = np.zeros((nh, n, n), bool)
    for h in range(nh):
        for i in range(n):
            if (i + h) % 3 != 2:
                lay[h, i, max(0, i - 1):i + 1] = True
                lay[h, i, (i + 3) % n] = True
    return lay


def sparse_grad_check(grads, ref_grads, dtype):
    """Gradients as in phase a: bf16 at 1e-2 of their max; fp32 at 1e-5 of
    max(1, their max). Returns the max abs error."""
    tol, floor = (1e-5, 1.0) if dtype == torch.float32 else (1e-2, 0.0)
    worst = 0.0
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref_grads):
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{name} shape/dtype {tuple(got.shape)}/{got.dtype}")
        check(torch.isfinite(got.float()).all().item(), f"non-finite {name}")
        r = rel_err(got, want, floor)
        check(r <= tol, f"{name}: max err {r:.3g} of max({floor}, its max) > {tol}")
        worst = max(worst, float((got.float() - want.float()).abs().max()))
    return worst


def sparse_kernels_vs_plain(bs, dev):
    """Phase s1: the block-sparse kernels against their plain versions.
    Returns the worst (forward, backward) max abs errors."""
    from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as sc

    cases = (  # label, layout, S, kv heads, head_dim, causal
        ("Fixed local 4 global 1, llama-7b heads",
         sc.FixedSparsityConfig(num_heads=32, block=128, num_local_blocks=4,
                                attention="unidirectional").make_layout(2048), 2048, 32, 128, True),
        ("BigBird, llama-7b heads",
         sc.BigBirdSparsityConfig(num_heads=32, block=128).make_layout(2048), 2048, 32, 128, False),
        ("BSLongformer, GQA 2, hd 64",
         sc.BSLongformerSparsityConfig(num_heads=8, block=128, global_block_indices=[0, 9])
         .make_layout(2048), 2048, 4, 64, False),
        ("Variable with random blocks, GQA 2, hd 256",
         sc.VariableSparsityConfig(num_heads=8, block=128, num_random_blocks=2,
                                   local_window_blocks=[1, 2, 4], global_block_indices=[0, 3],
                                   attention="unidirectional").make_layout(1024),
         1024, 4, 256, True),
        ("Fixed per-head globals, horizontal, GQA 2",
         sc.FixedSparsityConfig(num_heads=8, block=128, different_layout_per_head=True,
                                num_different_global_patterns=4,
                                horizontal_global_attention=True).make_layout(2048),
         2048, 4, 128, False),
        ("empty query blocks", _empty_rows_layout(4, 8), 1024, 2, 128, True),
        ("empty query blocks", _empty_rows_layout(4, 8), 1024, 4, 64, False),
        ("block 256", sc.FixedSparsityConfig(num_heads=8, block=256, num_local_blocks=2)
         .make_layout(2048), 2048, 8, 128, True),
    )
    worst_f = worst_b = 0.0
    for label, layout, S, kvh, hd, causal in cases:
        nh = layout.shape[0]
        block = S // layout.shape[1]
        g = nh // kvh
        kw = dict(causal=causal, num_kv_groups=g)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = flash_case(1, S, nh, kvh, hd, dtype, dev, seed=S + hd)
            out, lse = bs.block_sparse_attention_fwd(q, k, v, layout, block, **kw)
            grads = bs.block_sparse_attention_bwd(q, k, v, out, lse, do, layout, block, **kw)
            again = bs.block_sparse_attention_bwd(q, k, v, out, lse, do, layout, block, **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(grads, again)),
                  f"{label}: a repeated backward is not bitwise equal")
            ref_out, ref_lse = bs.block_sparse_attention_plain(q, k, v, layout, block, **kw)
            ref_grads = bs.block_sparse_attention_bwd_plain(q, k, v, ref_out, ref_lse, do,
                                                            layout, block, **kw)
            fe = max(compare(out, ref_out, dtype), compare(lse, ref_lse, dtype))
            be = sparse_grad_check(grads, ref_grads, dtype)
            worst_f, worst_b = max(worst_f, fe), max(worst_b, be)
            log(f"kernel vs plain: block-sparse attention {label} S={S} nh={nh} kvh={kvh} "
                f"hd={hd} block={block} causal={causal} {str(dtype)[6:]}: fwd max_abs_err "
                f"{fe:.3g}, bwd max_abs_err {be:.3g}, backward bitwise repeatable ok")
    return worst_f, worst_b


def sparse_main_path(bs, fa, dev):
    """Phase s2: ``SparseSelfAttention`` over the Fixed and BigBird layouts
    at llama-7b's heads, 3 forward + backward iterations each through the
    public call and autograd. The counts are set to 0 just before and read
    just after; then each op's first 4 heads are checked against the plain
    version on the 4-head slice. Returns (launches, errors, per-op stats)."""
    ops = sparse_path_layouts()
    q, k, v = sparse_inputs(dev)
    B, S, nh, hd = SPARSE_SHAPE
    stats, runs = {}, {}
    f0 = (fa.fwd_launches, fa.bwd_launches)
    bs.fwd_launches = bs.bwd_launches = 0  # every count of the path, just before
    for name, sa in ops.items():
        n0, ms = (bs.fwd_launches, bs.bwd_launches), []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = sa(q, k, v)
            loss = (out.float() ** 2).sum()
            grads = torch.autograd.grad(loss, (q, k, v))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        runs[name] = (out.detach(), grads, float(loss.detach()))
        stats[name] = {"launches": [bs.fwd_launches - n0[0], bs.bwd_launches - n0[1]],
                       "fwd_bwd_ms": ms}
    torch.cuda.synchronize()
    launches = {"fwd": bs.fwd_launches, "bwd": bs.bwd_launches}  # read just after
    check(launches == {"fwd": 6, "bwd": 6}
          and all(st["launches"] == [3, 3] for st in stats.values()),
          f"block-sparse launches {launches}, per op "
          f"{ {n: st['launches'] for n, st in stats.items()} }: expected 3 + 3 per op")
    check((fa.fwd_launches, fa.bwd_launches) == f0, "the sparse path launched flash kernels")

    errs = [0.0, 0.0]
    qs, ks, vs = (t.detach()[:, :, :4] for t in (q, k, v))
    for name, sa in ops.items():
        out, grads, loss = runs[name]
        check(np.isfinite(loss) and torch.isfinite(out.float()).all().item()
              and all(torch.isfinite(g.float()).all().item() for g in grads),
              f"{name}: non-finite output, loss or gradient")
        layout = sa._layout(S)[:4]
        causal = sa.config.attention == "unidirectional"
        ref_out, ref_lse = bs.block_sparse_attention_plain(qs, ks, vs, layout, SPARSE_BLOCK,
                                                           causal=causal)
        errs[0] = max(errs[0], compare(out[:, :, :4], ref_out, torch.bfloat16))
        do = (2 * out.float()).to(out.dtype)[:, :, :4]  # d loss / d out, as autograd gave it
        ref_grads = bs.block_sparse_attention_bwd_plain(qs, ks, vs, ref_out, ref_lse, do,
                                                        layout, SPARSE_BLOCK, causal=causal)
        errs[1] = max(errs[1], sparse_grad_check([g[:, :, :4] for g in grads], ref_grads,
                                                 torch.bfloat16))
        del ref_out, ref_lse, ref_grads
        torch.cuda.empty_cache()
        log(f"sparse main path ({name}, bf16 {SPARSE_SHAPE}): 3 fwd + bwd, launches "
            f"{stats[name]['launches']}, loss {loss:.6g}, fwd+bwd ms "
            f"{[round(x, 3) for x in stats[name]['fwd_bwd_ms']]}; heads 0-3 vs plain ok")
    return launches, errs, stats


def sparse_timing(bs, dev):
    """Phase s3: each op's kernels at the path's shape, timed with CUDA events
    beside the plain version (on the 4-head slice, scaled by 8), SDPA with
    the layout as a boolean mask (and its backward), dense SDPA at the same
    shape, and the bounds."""
    import torch.nn.functional as F

    B, S, nh, hd = SPARSE_SHAPE
    blk, dtype = SPARSE_BLOCK, torch.bfloat16
    q, k, v = (t.detach() for t in sparse_inputs(dev, seed=1))
    do = torch.randn(SPARSE_SHAPE, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(2)).to(dtype)
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
    elt = q.element_size()
    results = {}
    for name, sa in sparse_path_layouts().items():
        layout = sa._layout(S)
        causal = sa.config.attention == "unidirectional"
        kw = dict(causal=causal)
        out, lse = bs.block_sparse_attention_fwd(q, k, v, layout, blk, **kw)
        fwd_ms = time_cuda(lambda: bs.block_sparse_attention_fwd(q, k, v, layout, blk, **kw))
        bwd_ms = time_cuda(lambda: bs.block_sparse_attention_bwd(q, k, v, out, lse, do, layout,
                                                                 blk, **kw))
        q4, k4, v4, o4, do4 = (t[:, :, :4] for t in (q, k, v, out, do))
        lay4, lse4 = layout[:4], lse[:, :4]
        ref4, _ = bs.block_sparse_attention_plain(q4, k4, v4, lay4, blk, **kw)
        plain_fwd_ms = nh / 4 * time_cuda(
            lambda: bs.block_sparse_attention_plain(q4, k4, v4, lay4, blk, **kw),
            warmup=2, iters=5)
        plain_bwd_ms = nh / 4 * time_cuda(
            lambda: bs.block_sparse_attention_bwd_plain(q4, k4, v4, o4, lse4, do4, lay4, blk,
                                                        **kw), warmup=2, iters=5)
        # the library yardstick: SDPA with the layout expanded to a boolean mask
        lay_t = torch.from_numpy(layout).to(dev)
        mask = lay_t.repeat_interleave(blk, 1).repeat_interleave(blk, 2)
        if causal:
            mask &= torch.ones(S, S, dtype=torch.bool, device=dev).tril()
        mask = mask[None]
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        compare(lib_out.transpose(1, 2)[:, :, :4], ref4, dtype)
        del lib_out, ref4
        lib_fwd_ms = time_cuda(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                       attn_mask=mask))
        lib_graph = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
        lib_bwd_ms = time_cuda(lambda: torch.autograd.grad(lib_graph, (qg, kg, vg), dot,
                                                           retain_graph=True))
        del lib_graph, mask
        dense_fwd_ms = time_cuda(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                         is_causal=causal))
        dense_graph = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
        dense_bwd_ms = time_cuda(lambda: torch.autograd.grad(dense_graph, (qg, kg, vg), dot,
                                                             retain_graph=True))
        del dense_graph
        torch.cuda.empty_cache()

        # bounds: the visited block pairs (a diagonal block under causal
        # counts half) at the bf16 tensor-core peak, against q, k, v, o, lse
        # (and do, dq, dk, dv) and the block lists, each moved once
        lists = bs._device_lists(layout, causal, 1, q.device)
        lay_c = layout & np.tril(np.ones(layout.shape[1:], bool)) if causal else layout
        pairs = int(lay_c.sum())
        diag = int(np.einsum("hii->", lay_c.astype(np.int64))) if causal else 0
        eff_pairs = pairs - diag / 2
        fwd_flops = B * eff_pairs * 4 * blk * blk * hd
        bwd_flops = B * eff_pairs * 10 * blk * blk * hd  # S recomputed, dP, dV, dK, dQ
        list_bytes = {d: sum(t.numel() * 4 for t in ts) for d, ts in (
            ("fwd", (lists.kcnt, lists.kidx, lists.q_order)), ("bwd", lists[:6]))}
        fwd_bytes = 4 * q.numel() * elt + lse.numel() * 4 + list_bytes["fwd"]
        bwd_bytes = 8 * q.numel() * elt + lse.numel() * 4 + list_bytes["bwd"]
        kcnt = lists.kcnt.cpu().numpy()
        r = {"causal": causal, "active_pairs": pairs, "density": pairs / layout.size,
             "row_blocks_min_max": [int(kcnt.min()), int(kcnt.max())],
             "col_blocks_max": int(lists.qcnt.max()), "dense_sdpa_fwd_ms": dense_fwd_ms,
             "dense_sdpa_bwd_ms": dense_bwd_ms}
        for d, ms, plain, lib, flops, nbytes in (
                ("fwd", fwd_ms, plain_fwd_ms, lib_fwd_ms, fwd_flops, fwd_bytes),
                ("bwd", bwd_ms, plain_bwd_ms, lib_bwd_ms, bwd_flops, bwd_bytes)):
            t_ops = flops / PEAK_FLOPS[dtype] * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            r[d] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                    "bound_ms": max(t_ops, t_bytes),
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                    "flops": flops, "bytes": nbytes}
        results[name] = r
        log(f"block-sparse {name} (bf16 {SPARSE_SHAPE}, {pairs} pairs, density "
            f"{r['density']:.4f}): fwd {fwd_ms:.4f} ms (bound {r['fwd']['bound_ms']:.4f}, "
            f"plain {plain_fwd_ms:.4f}, masked SDPA {lib_fwd_ms:.4f}, dense SDPA "
            f"{dense_fwd_ms:.4f}); bwd {bwd_ms:.4f} ms (bound {r['bwd']['bound_ms']:.4f}, "
            f"plain {plain_bwd_ms:.4f}, masked SDPA {lib_bwd_ms:.4f}, dense SDPA "
            f"{dense_bwd_ms:.4f})")
    return results


CE_MAIN = (4096, 4096, 32000)  # llama-7b's head at the training slice's 2 x 2048 batch
CE_GPT2 = (4096, 4096, 50304)  # gpt2-6.7b's tied head (vocab padded to 50304)
# N, H, V; (384, 640, 50304): each 128 mod 256, a half tile on every side of
# the 16-bit kernels' 128 x 256 tiles
CE_CASES = ((256, 128, 768), (2560, 128, 640), (256, 8192, 256), (384, 640, 50304), CE_MAIN,
            CE_GPT2)
CE_NLL_ATOL = 1e-4  # lse, nll: sums of exact (16-bit) products in fp32, in another order


def ce_case(N, H, V, dtype, dev, seed=0):
    """x, w (rows ~ N(0, 1.5^2 / H)), labels with -1 and V among them, fp32 g."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(N, H, device=dev, generator=gen).to(dtype)
    w = (torch.randn(V, H, device=dev, generator=gen) * (1.5 / H ** 0.5)).to(dtype)
    labels = torch.randint(0, V, (N,), device=dev, generator=gen, dtype=torch.int32)
    labels[:2] = torch.tensor([-1, V], dtype=torch.int32)
    g = torch.randn(N, device=dev, generator=gen)
    return x, w, labels, g


# 16-bit outputs, held elementwise: |err| <= rtol x (|ref| + median |ref|).
# Kernel and plain version form the same fp32 values up to the order of
# their sums, then round once to 16 bits, so an element may round the other
# way: one ulp, at most 2^-7 of it in bf16 and 2^-10 in fp16. The median
# term covers elements near 0, where the sums' order shows. Not held against
# the tensor's max: dW's label rows (|g x| up to ~16) and dX's -g W[label]
# term lie 10-100x above the softmax terms p g x and p g W that the check
# must see.
CE_RTOL16 = {torch.bfloat16: 1e-2, torch.float16: 2e-3}


def ce_mismatches(names, outs, refs, dtype, fp32_tol=None):
    """What of ``outs`` lies outside tolerance of ``refs``, as messages, and
    the max abs error. 16-bit: elementwise (CE_RTOL16); fp32: ``fp32_tol``
    (atol, rtol), or 1e-5 of max(1, the reference's max) where None."""
    msgs, worst = [], 0.0
    for name, got, want in zip(names, outs, refs):
        if got is None:
            continue
        if got.shape != want.shape or got.dtype != want.dtype:
            msgs.append(f"{name} shape/dtype {tuple(got.shape)}/{got.dtype}")
            continue
        if not torch.isfinite(got.float()).all().item():
            msgs.append(f"non-finite {name}")
            continue
        err = (got.float() - want.float()).abs()
        ref = want.float().abs()
        worst = max(worst, float(err.max()))
        if dtype in CE_RTOL16:
            rtol = CE_RTOL16[dtype]
            med = float(ref.flatten()[:1 << 24].median())  # median of up to 16M elements
            bad = int((err > rtol * (ref + med)).sum())
            if bad:
                msgs.append(f"{name}: {bad} elements outside {rtol} x (|ref| + median |ref| "
                            f"{med:.3g}), max err {float(err.max()):.3g}")
        elif fp32_tol is not None:
            atol, rtol = fp32_tol
            if (err > atol + rtol * ref).any().item():
                msgs.append(f"{name}: max err {float(err.max()):.3g} outside atol {atol} "
                            f"rtol {rtol}")
        else:
            r = float(err.max()) / max(1.0, float(ref.max()) + 1e-6)
            if r > 1e-5:
                msgs.append(f"{name}: max err {r:.3g} of max(1, its max) > 1e-05")
    return msgs, worst


def ce_check(fwd, ref_fwd, grads, ref_grads, dtype):
    """Kernel against plain at ce1's tolerances: the forward's outputs (lg,
    lse, nll; None where not compared) and the backward's (dx, dw). Returns
    the max abs errors (fwd, bwd)."""
    # lse, nll: exact products summed in fp32 in another order; an fp32 lg
    # sums up to 8192 products in order, cuBLAS in another
    msgs, fe = ce_mismatches(("lse", "nll"), fwd[1:], ref_fwd[1:], torch.float32,
                             fp32_tol=(CE_NLL_ATOL, 0.0))
    lg_msgs, lg_err = ce_mismatches(("lg",), fwd[:1], ref_fwd[:1], dtype,
                                    fp32_tol=(CE_NLL_ATOL, 0.0))
    grad_msgs, be = ce_mismatches(("dx", "dw"), grads, ref_grads, dtype)
    msgs += lg_msgs + grad_msgs
    check(not msgs, "; ".join(msgs))
    return max(fe, lg_err), be


def ce_faults_caught(fc, lg, lse, labels, g, x, w, ref_grads, dtype):
    """The grads check rejects a backward with a planted fault: the softmax
    term dropped (lse + 1e4 makes every p 0) or p taken with the next row's
    lse. Returns what it reported for each."""
    seen = {}
    for fault, bad_lse in (("p zeroed", lse + 1e4), ("next row's lse", lse.roll(1))):
        msgs, _ = ce_mismatches(("dx", "dw"), fc.fused_ce_bwd(lg, bad_lse, labels, g, x, w),
                                ref_grads, dtype)
        check(msgs, f"the {dtype} grads check passes a backward with {fault}")
        seen[fault] = [m.split(":")[0] for m in msgs]
    return seen


def ce_kernels_vs_plain(fc, dev):
    """Phase ce1: the fused-CE kernels against their plain versions; every
    forward and backward twice, bitwise equal. Returns the worst errors."""
    worst_f = worst_b = 0.0
    for N, H, V in CE_CASES:
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            x, w, labels, g = ce_case(N, H, V, dtype, dev)
            fwd = fc.fused_ce_fwd(x, w, labels)
            again = fc.fused_ce_fwd(x, w, labels)
            no_res = fc.fused_ce_fwd(x, w, labels, write_logits=False)
            grads = fc.fused_ce_bwd(fwd[0], fwd[1], labels, g, x, w)
            grads2 = fc.fused_ce_bwd(fwd[0], fwd[1], labels, g, x, w)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(fwd + grads, again + grads2)),
                  f"fused CE ({N}, {H}, {V}) {dtype}: a repeated call is not bitwise equal")
            check(no_res[0] is None and torch.equal(no_res[1], fwd[1])
                  and torch.equal(no_res[2], fwd[2]),
                  "the forward without the residual gives other lse / nll")
            ref_fwd = fc.fused_ce_fwd_plain(x, w, labels)
            ref_grads = fc.fused_ce_bwd_plain(fwd[0], fwd[1], labels, g, x, w)
            fe, be = ce_check(fwd, ref_fwd, grads, ref_grads, dtype)
            check(torch.equal(fwd[2][:2], fwd[1][:2]), "labels -1 and V do not give lse")
            worst_f, worst_b = max(worst_f, fe), max(worst_b, be)
            if (N, H, V) == CE_MAIN and dtype != torch.float32:
                caught = ce_faults_caught(fc, fwd[0], fwd[1], labels, g, x, w, ref_grads, dtype)
                log(f"grads check at the main shape, {str(dtype)[6:]}: planted faults "
                    f"rejected {caught}")
            del fwd, again, no_res, grads, grads2, ref_fwd, ref_grads
            log(f"kernel vs plain: fused CE N={N} H={H} V={V} {str(dtype)[6:]}: fwd max_abs_err "
                f"{fe:.3g}, bwd max_abs_err {be:.3g}, bitwise repeatable ok")
    torch.cuda.empty_cache()
    return worst_f, worst_b


def ce_path_inputs(N, H, V, dev, seed=0):
    """bf16 x with RMS-normalised rows (a final norm's output), W ~ N(0,
    0.02^2) (the lm_head transposed), int32 labels in [0, V), fp32 g."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(N, H, device=dev, generator=gen)
    x = (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-5)).to(torch.bfloat16)
    w = (torch.randn(V, H, device=dev, generator=gen) * 0.02).to(torch.bfloat16)
    labels = torch.randint(0, V, (N,), device=dev, generator=gen, dtype=torch.int32)
    g = torch.randn(N, device=dev, generator=gen)
    return x, w, labels, g


def ce_main_path(fc, counters, dev):
    """Phase ce2: ``fused_ce_loss`` at llama-7b's head, 3 forward +
    backward iterations through autograd; every count set to 0 just before
    and read just after. Returns (launches, errors, stats)."""
    N, H, V = CE_MAIN
    x, w, labels, g = ce_path_inputs(N, H, V, dev)
    x.requires_grad_()
    w.requires_grad_()
    torch.cuda.synchronize()
    for mod, name in counters:
        setattr(mod, name, 0)  # every kernel's count, just before the path
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nll = fc.fused_ce_loss(x, w, labels)
        dx, dw = torch.autograd.grad((nll * g).sum(), (x, w))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = {f"{mod.__name__.rsplit('.', 1)[1]}.{name}": getattr(mod, name)
                for mod, name in counters}  # read just after
    want = {k: (3 if k.startswith("fused_ce.") else 0) for k in launches}
    check(launches == want, f"launches {launches}; expected 3 + 3 fused-CE launches and no other")

    nll = nll.detach()
    x0, w0 = x.detach(), w.detach()
    # each stage against its plain version on the same inputs, as in ce1:
    # the backward's on the kernel forward's residual (the forward repeats
    # bitwise), whose one-ulp roundings a plain residual need not share
    fwd = fc.fused_ce_fwd(x0, w0, labels)
    check(torch.equal(fwd[2], nll), "the path's loss differs from the forward kernel's")
    ref_fwd = fc.fused_ce_fwd_plain(x0, w0, labels)
    ref_grads = fc.fused_ce_bwd_plain(fwd[0], fwd[1], labels, g, x0, w0)
    fe, be = ce_check(fwd, ref_fwd, (dx, dw), ref_grads, torch.bfloat16)
    caught = ce_faults_caught(fc, fwd[0], fwd[1], labels, g, x0, w0, ref_grads, torch.bfloat16)
    del fwd, ref_fwd, ref_grads
    torch.cuda.empty_cache()
    # the no-grad primal writes no residual
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    fwd0, bwd0 = fc.fwd_launches, fc.bwd_launches
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        nll_ng = fc.fused_ce_loss(x, w, labels)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    residual = N * V * 2
    check(rise < residual, f"the no-grad call's peak rose {rise} bytes (residual {residual})")
    check(torch.equal(nll_ng, nll), "the no-grad loss differs from the grad-mode loss")
    check((fc.fwd_launches, fc.bwd_launches) == (fwd0 + 1, bwd0),
          "the no-grad call did not run the forward kernel alone")
    stats = {"shape": [N, H, V], "dtype": "bfloat16", "launches": launches,
             "fwd_bwd_ms": ms, "mean_nll": float(nll.mean()),
             "no_grad_peak_rise_bytes": rise, "residual_bytes": residual}
    log(f"fused CE main path (llama-7b head N={N} H={H} V={V} bf16): 3 fwd + bwd, launches "
        f"{launches}, mean nll {stats['mean_nll']:.6g} (ln V = {np.log(V):.6g}), fwd+bwd ms "
        f"{[round(t, 3) for t in ms]}; vs plain: nll max_abs_err {fe:.3g}, grads {be:.3g}; "
        f"no-grad peak rise {rise} bytes ok; planted faults rejected {caught}")
    return launches, (fe, be), stats


def ce_timing(fc, dev):
    """Phase ce3: the kernels at llama-7b's and gpt2-6.7b's heads beside the
    plain versions, the unfused library path and the bounds."""
    import torch.nn.functional as F

    results = {}
    for label, (N, H, V) in (("llama-7b", CE_MAIN), ("gpt2-6.7b", CE_GPT2)):
        x, w, labels, g = ce_path_inputs(N, H, V, dev, seed=1)
        lg, lse, nll = fc.fused_ce_fwd(x, w, labels)
        fwd_ms = time_cuda(lambda: fc.fused_ce_fwd(x, w, labels))
        bwd_ms = time_cuda(lambda: fc.fused_ce_bwd(lg, lse, labels, g, x, w))
        plain_fwd_ms = time_cuda(lambda: fc.fused_ce_fwd_plain(x, w, labels), warmup=2, iters=5)
        plain_bwd_ms = time_cuda(lambda: fc.fused_ce_bwd_plain(lg, lse, labels, g, x, w),
                                 warmup=2, iters=5)
        # the library yardstick: the unfused path a caller takes when
        # fused_ce_loss raises (cuBLAS logits in bf16, fp32 logsumexp)
        lab = labels.long()[:, None]

        def lib_loss(a, b):
            logits = F.linear(a, b).float()
            return torch.logsumexp(logits, -1) - logits.gather(1, lab)[:, 0]

        lib_nll = lib_loss(x, w)
        # the library rounds the logits to bf16 before the logsumexp: ~1 ulp of |s|
        check(float((lib_nll - nll).abs().max()) < 5e-2, "the library path computes another loss")
        lib_fwd_ms = time_cuda(lambda: lib_loss(x, w))
        xg, wg = x.detach().requires_grad_(), w.detach().requires_grad_()
        lib_graph = lib_loss(xg, wg)
        lib_bwd_ms = time_cuda(lambda: torch.autograd.grad(lib_graph, (xg, wg), g,
                                                           retain_graph=True))
        del lib_graph, lib_nll
        torch.cuda.empty_cache()

        elt = x.element_size()
        xw_bytes = (N * H + V * H) * elt
        fwd_flops, bwd_flops = 2 * N * V * H, 4 * N * V * H
        fwd_bytes = xw_bytes + N * 4 + N * V * elt + 2 * N * 4  # x, w, labels; lg, lse, nll
        bwd_bytes = N * V * elt + 3 * N * 4 + 2 * xw_bytes  # lg, lse, labels, g, x, w; dx, dw
        r = {"shape": [N, H, V], "dtype": "bfloat16", "plan": fc.kernel_plan(x, w)._asdict()}
        for d, ms, plain, lib, flops, nbytes in (
                ("fwd", fwd_ms, plain_fwd_ms, lib_fwd_ms, fwd_flops, fwd_bytes),
                ("bwd", bwd_ms, plain_bwd_ms, lib_bwd_ms, bwd_flops, bwd_bytes)):
            t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            r[d] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                    "bound_ms": max(t_ops, t_bytes),
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                    "flops": flops, "bytes": nbytes, "tflops_per_s": flops / ms / 1e9}
        results[label] = r
        log(f"fused CE {label} head (N={N} H={H} V={V} bf16): fwd {fwd_ms:.4f} ms (bound "
            f"{r['fwd']['bound_ms']:.4f}, plain {plain_fwd_ms:.4f}, unfused library "
            f"{lib_fwd_ms:.4f}); bwd {bwd_ms:.4f} ms (bound {r['bwd']['bound_ms']:.4f}, plain "
            f"{plain_bwd_ms:.4f}, library backward {lib_bwd_ms:.4f})")
        del x, w, labels, g, lg, lse, nll, xg, wg
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase c3: training checkpoints
# ---------------------------------------------------------------------------
#: where phase c3 writes its tags: inside the checkout, under build/ (listed
#: in .gitignore), deleted before the phase ends
CKPT_DIR = os.path.join(HERE, "build", "ckpt_c3")
CKPT_SUP_LAYERS = 1  # (d) and (e): llama-7b width at depth 1 (~5.6 GB a tag)


def ckpt_tag_bytes(layers):
    """A tag's bytes at llama-7b width: fp32 master, Adam's m and v (12 B a
    parameter; ~202.4M a layer, 2 x 131M for the embedding and the head)."""
    per_layer = 4 * 4096 * 4096 + 3 * 4096 * 11008 + 2 * 4096
    return 12 * (layers * per_layer + 2 * 32000 * 4096 + 4096)


def ckpt_engine(dev, layers, seed, **cfg):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import build_model

    model = build_model("llama-7b", num_layers=layers)
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed))
    return deepspeed_tpu_torch.initialize(model=model, model_parameters=params,
                                          config=dict(TRAIN_CONFIG, **cfg), device=dev)[0]


def ckpt_snapshot(engine):
    """Every quantity a tag saves, cloned on the card (and the host values)."""
    def cp(tree):
        return {k: cp(v) if isinstance(v, dict) else v.detach().clone() for k, v in tree.items()}

    return {"params": cp(engine.params), "master": cp(engine.master_params),
            "m": cp(engine.opt_state.m), "v": cp(engine.opt_state.v),
            "step": engine.opt_state.step.clone(), "scaler": cp(engine.scaler_state._asdict()),
            "rng": engine._rng.clone(), "lr": engine.lr_scheduler.state_dict(),
            "counters": [engine.global_steps, engine.global_samples, engine.skipped_steps,
                         engine.micro_steps, engine._data_position]}


def ckpt_mismatches(a, b, path=""):
    """The paths where two snapshots differ, bit for bit."""
    if isinstance(a, dict):
        if sorted(a) != sorted(b):
            return [f"{path} keys"]
        return [m for k in a for m in ckpt_mismatches(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, torch.Tensor):
        same = a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
        return [] if same else [path]
    return [] if a == b else [path]


def ckpt_steps(engine, batch, n, on_step=None):
    """``n`` train_batch steps; their losses (device scalars) and wall ms."""
    losses, ms = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(engine.train_batch(iter([batch])))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms


def ckpt_phase(fa, dev, card):
    """Phase c3: phase c's model, batch and settings; (a) 3 steps, a
    synchronous save, 3 steps; (a') a second run of 6 steps from the same
    weights, bitwise (a)'s; (b) a fresh engine from other weights loads the
    tag: its state bitwise the saved one, the next 3 losses bitwise (a)'s;
    (c) (a) with ``async_save``, the steps under the write timed, then the
    tag loaded into (b)'s engine, bitwise again; (d) ``TrainingSupervisor``
    over ``InjectedTrainEngine`` at depth 1: a transient fault, a device loss
    two steps after a save, the loss curve bitwise the fault-free one; (e) a
    byte of the newest tag's npz flipped: ``latest`` falls back one tag, the
    tag by name raises ``CheckpointCorruptError``."""
    import shutil

    from deepspeed_tpu_torch.resilience import (CheckpointCorruptError, FaultInjector,
                                                FaultSpec, InjectedTrainEngine,
                                                RecoveryPolicy, RetryPolicy,
                                                TrainingSupervisor)

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    os.makedirs(CKPT_DIR)
    free = shutil.disk_usage(CKPT_DIR).free
    # one full-depth tag on disk at a time ((a)'s, then (c)'s), then (d)'s
    # two at depth 1
    need = {n: max(1.2 * ckpt_tag_bytes(n), 2.2 * ckpt_tag_bytes(CKPT_SUP_LAYERS))
            for n in (4, 2)}
    layers = 4 if free > need[4] else 2
    check(free > need[layers], f"phase c3: {free / 1e9:.1f} GB free under {CKPT_DIR}, "
          f"below the {need[layers] / 1e9:.1f} GB the phase writes at depth {layers}")
    B, S = TRAIN_CONFIG["train_micro_batch_size_per_gpu"], 2048
    summary = {"card": card, "layers": layers, "sup_layers": CKPT_SUP_LAYERS,
               "disk_free_gb": free / 1e9}
    runs = {"steps": 0, "sup_steps": 0}
    fa.fwd_launches = fa.bwd_launches = 0  # every count, just before
    try:
        # (a) 3 steps, a synchronous save, 3 more
        engine = ckpt_engine(dev, layers, 0)
        cfg = engine.module.config
        batch = {"input_ids": torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32,
                                            device=dev,
                                            generator=torch.Generator(device=dev).manual_seed(0))}
        first, _ = ckpt_steps(engine, batch, 3)
        dir_a = os.path.join(CKPT_DIR, "a")
        ck = engine.checkpoint_engine
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.save_checkpoint(dir_a)
        save_s = time.perf_counter() - t0
        saved = ckpt_snapshot(engine)
        tag_bytes = ck.stats["bytes_written"]
        summary["sync_save"] = {"s": save_s, "gather_s": engine.ckpt_stats["gather_s"],
                                "savez_s": ck.stats["savez_s"], "crc_s": ck.stats["crc_s"],
                                "bytes": tag_bytes,
                                "write_gb_per_s": tag_bytes / ck.stats["savez_s"] / 1e9}
        after, after_ms = ckpt_steps(engine, batch, 3)
        runs["steps"] += 6
        want = [float(x) for x in first + after]
        del engine
        torch.cuda.empty_cache()
        check(all(np.isfinite(want)), f"phase c3 (a): losses {want}")

        # (a') two uninterrupted runs from one state repeat bitwise
        engine = ckpt_engine(dev, layers, 0)
        again, plain_ms = ckpt_steps(engine, batch, 6)
        runs["steps"] += 6
        del engine
        torch.cuda.empty_cache()
        again = [float(x) for x in again]
        check(again == want, f"phase c3 (a'): two runs of 6 steps from one state differ: "
              f"{want} vs {again}")

        # (b) a fresh engine from other weights resumes bitwise
        engine = ckpt_engine(dev, layers, 1)
        ck = engine.checkpoint_engine
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.load_checkpoint(dir_a)
        torch.cuda.synchronize()
        summary["load"] = {"s": time.perf_counter() - t0, "verify_s": ck.stats["verify_s"],
                           "read_s": ck.stats["read_s"],
                           "restore_s": engine.ckpt_stats["restore_s"]}
        bad = ckpt_mismatches(ckpt_snapshot(engine), saved)
        check(not bad, f"phase c3 (b): the loaded state differs from the saved one at {bad}")
        resumed, _ = ckpt_steps(engine, batch, 3)
        runs["steps"] += 3
        resumed = [float(x) for x in resumed]
        check(resumed == want[3:], f"phase c3 (b): resumed losses {resumed} vs {want[3:]}")
        shutil.rmtree(dir_a)
        del engine
        torch.cuda.empty_cache()

        # (c) the same with an async save: 3 steps run under its write
        engine_c = ckpt_engine(dev, layers, 0, checkpoint={"async_save": True})
        ckpt_steps(engine_c, batch, 3)
        dir_c = os.path.join(CKPT_DIR, "c")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine_c.save_checkpoint(dir_c)
        fg_s = time.perf_counter() - t0
        under, under_ms = ckpt_steps(engine_c, batch, 3)
        t0 = time.perf_counter()
        engine_c.checkpoint_engine.wait()
        tail_s = time.perf_counter() - t0
        runs["steps"] += 6
        check([float(x) for x in under] == want[3:], "phase c3 (c): the async run's steps "
              "differ from (a)'s")
        ack = engine_c.checkpoint_engine.stats
        summary["async_save"] = {"foreground_s": fg_s,
                                 "gather_s": engine_c.ckpt_stats["gather_s"],
                                 "writer_savez_s": ack["savez_s"], "writer_crc_s": ack["crc_s"],
                                 "wait_after_3_steps_s": tail_s}
        engine_c.checkpoint_engine.close()
        del engine_c
        torch.cuda.empty_cache()
        engine = ckpt_engine(dev, layers, 1)
        engine.load_checkpoint(dir_c)
        bad = ckpt_mismatches(ckpt_snapshot(engine), saved)
        check(not bad, f"phase c3 (c): the async tag differs from the saved state at {bad}")
        resumed_c, _ = ckpt_steps(engine, batch, 3)
        runs["steps"] += 3
        check([float(x) for x in resumed_c] == want[3:], "phase c3 (c): losses resumed from "
              "the async tag differ from (a)'s")
        summary["step_ms"] = {"no_save_median": float(np.median(plain_ms[1:])),
                              "after_sync_save": after_ms,
                              "under_async_write": under_ms,
                              "under_async_write_median": float(np.median(under_ms))}
        del engine, saved
        shutil.rmtree(dir_c)
        torch.cuda.empty_cache()

        # (d) the supervisor at depth 1: a transient, then a device loss two
        # steps after the save at step 3; the curve bitwise the fault-free one
        engine = ckpt_engine(dev, CKPT_SUP_LAYERS, 0)
        clean, _ = ckpt_steps(engine, batch, 6)
        runs["sup_steps"] += 6
        clean = [float(x) for x in clean]
        del engine
        torch.cuda.empty_cache()
        engine = ckpt_engine(dev, CKPT_SUP_LAYERS, 0)
        plan = [FaultSpec(site="train_batch", kind="transient", nth=2),
                FaultSpec(site="train_batch", kind="device_lost", nth=7)]
        injector = FaultInjector(plan, seed=0, sleep=lambda s: None)
        dir_d = os.path.join(CKPT_DIR, "d")
        sup = TrainingSupervisor(InjectedTrainEngine(engine, injector), lambda k: [batch],
                                 dir_d, save_interval=3,
                                 retry=RetryPolicy(max_attempts=3, base_s=0.0),
                                 recovery=RecoveryPolicy(max_consecutive_rebuilds=2),
                                 sleep=lambda s: None)
        t0 = time.perf_counter()
        sup.run(6)
        sup_s = time.perf_counter() - t0
        report = sup.report()
        runs["sup_steps"] += report["attempts"] - report["faults_fired"]["transient"] \
            - report["faults_fired"]["device_lost"]
        curve = [float(x) for x in sup.loss_curve()]
        check(curve == clean, f"phase c3 (d): supervised curve {curve} vs fault-free {clean}")
        check((report["recoveries"], report["replayed_steps"], report["retries"],
               report["net_steps"], report["saves"]) == (1, 2, 1, 6, 2),
              f"phase c3 (d): report {report}")
        summary["supervisor"] = dict(report, wall_s=sup_s)

        # (e) a flipped byte in the newest tag: `latest` falls back one tag,
        # the tag by name raises
        with open(os.path.join(dir_d, "latest")) as f:
            newest = f.read().strip()
        check(newest == "global_step3", f"phase c3 (e): latest is {newest}")
        path = os.path.join(dir_d, newest, "model_states.ckpt")
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            byte = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([byte[0] ^ 0xFF]))
        engine.ckpt_corrupt_fallbacks = 0
        t0 = time.perf_counter()
        engine.load_checkpoint(dir_d)
        fallback_s = time.perf_counter() - t0
        check(engine.loaded_checkpoint_tag == "global_step0"
              and engine.ckpt_corrupt_fallbacks == 1 and engine.global_steps == 0,
              f"phase c3 (e): loaded {engine.loaded_checkpoint_tag} after "
              f"{engine.ckpt_corrupt_fallbacks} fallbacks")
        try:
            engine.load_checkpoint(dir_d, tag=newest)
            raised = None
        except CheckpointCorruptError as e:
            raised = str(e)
        check(raised is not None and "checksum" in raised,
              f"phase c3 (e): a load of {newest} by name did not raise: {raised}")
        summary["corrupt_tag"] = {"fallback_load_s": fallback_s, "fallbacks": 1,
                                  "named_load_raised": raised}
        del engine
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    launches = {"fwd": fa.fwd_launches, "bwd": fa.bwd_launches}  # read just after
    want_launches = layers * runs["steps"] + CKPT_SUP_LAYERS * runs["sup_steps"]
    check(launches["fwd"] == want_launches and launches["bwd"] == want_launches,
          f"phase c3: flash launches {launches}, expected {want_launches} each "
          f"({layers} layers x {runs['steps']} steps + {CKPT_SUP_LAYERS} x "
          f"{runs['sup_steps']})")
    summary["launches"] = launches
    summary["losses"] = want
    log(f"phase c3 (checkpoints, {layers} layers): a {tag_bytes / 1e9:.2f} GB tag saved in "
        f"{summary['sync_save']['s']:.2f} s and loaded in {summary['load']['s']:.2f} s; "
        f"resumed, async-resumed and supervised curves bitwise the uninterrupted ones; "
        f"async foreground {fg_s:.3f} s; corrupt tag fell back; flash launched "
        f"{launches['fwd']}/{launches['bwd']} times")
    return launches, summary


def main():
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this script needs an "
                           "NVIDIA GPU")
    if not os.path.isdir(os.path.join(HERE, "deepspeed_tpu_torch")):
        raise SmokeFailure("deepspeed_tpu_torch/ is not beside this script: run it from "
                           "the root of a checkout")
    sys.path.insert(0, HERE)
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops.op_builder import build_all
    from deepspeed_tpu_torch.ops.quantizer import woq_gemm as wq
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse_kernel as bs
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    from deepspeed_tpu_torch.ops.transformer import fused_ce as fc
    from deepspeed_tpu_torch.ops.transformer import paged_attention as pa

    check(os.path.dirname(os.path.abspath(deepspeed_tpu_torch.__file__))
          == os.path.join(HERE, "deepspeed_tpu_torch"),
          f"imported deepspeed_tpu_torch from {deepspeed_tpu_torch.__file__}, "
          "not from this checkout")
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 checks in full float32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60, check=True)
    log(smi.stdout.strip())
    t0 = time.perf_counter()
    build_all()  # one nvcc per source, all started together
    log(f"set-up: CUDA kernels built in {time.perf_counter() - t0:.1f} s "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda})")

    kernels_vs_plain(pa, dev)
    small_slice_vs_cpu(dev)
    small_slice_vs_cpu(dev, num_heads=8, num_kv_heads=4)  # llama-tiny's heads: hd 32
    fa.fwd_launches = fa.bwd_launches = 0  # the serving path's counts start at 0 too
    engine, free0, launches, real_pool, summary = main_path(pa, dev, wq=wq)
    check(fa.fwd_launches == fa.bwd_launches == 0, "the serving path launched flash kernels")
    k = kernel_on_real_pool(pa, real_pool, engine.cfg, dev)
    for uid in list(engine.state.seqs):
        engine.flush(uid)
    check(engine.block_mgr.free_blocks == free0,
          f"free blocks {engine.block_mgr.free_blocks} != {free0} after flushing")
    summary["kernel"] = {"decode_rows": int(real_pool[2].shape[0]), **k}
    log(json.dumps({"summary": summary}))
    del real_pool
    sampling = sampling_on_card(dev)
    serve_summary = serve_phase(engine, pa, dev)
    small_excluded = small_scheduler_vs_cpu(dev)[0]
    params = engine.params  # phase 7 serves the same weights
    engine.kv = None  # phase 4's pool leaves the card before phase 7's is made
    del engine
    torch.cuda.empty_cache()
    log(json.dumps({"serve_summary": dict(
        card=smi.stdout.strip(), **serve_summary, sample_or_argmax=sampling,
        small_vs_cpu_excluded=small_excluded)}))
    horizon, paged_records = horizon_phase(params, pa, fa, wq, dev, smi.stdout.strip())
    torch.cuda.empty_cache()
    log(json.dumps({"horizon_summary": horizon}))
    slot_summary, slot_launches = slot_phase(params, fa, dev, paged_records)
    log(json.dumps({"slot_summary": dict(card=smi.stdout.strip(), **slot_summary)}))
    tier_summary = tier_phase(params, dev)
    log(json.dumps({"tier_summary": dict(card=smi.stdout.strip(), **tier_summary)}))
    pool_summary, pool_launches = pool_phase(params, pa, dev, smi.stdout.strip())
    log(json.dumps({"pool_summary": pool_summary}))
    del params
    torch.cuda.empty_cache()
    fa.fwd_launches = fa.bwd_launches = 0  # phases 7-8 ran flash; WOQ serving must not

    woq_worst = woq_kernels_vs_plain(wq, dev)
    small_woq_vs_cpu(wq, dev)
    woq_summary = {}
    for bits, steps in ((8, 32), (6, 12), (4, 12)):
        engine, free0, _, real_pool, woq_summary[f"int{bits}"] = main_path(
            pa, dev, bits=bits, decode_steps=steps, wq=wq)
        check(fa.fwd_launches == fa.bwd_launches == 0, "the serving path launched flash kernels")
        for uid in list(engine.state.seqs):
            engine.flush(uid)
        check(engine.block_mgr.free_blocks == free0,
              f"free blocks {engine.block_mgr.free_blocks} != {free0} after flushing")
        del engine, real_pool
        torch.cuda.empty_cache()
    woq_launches = woq_summary["int8"]["woq"]["woq_launches"]
    woq_tiled = woq_summary["int8"]["woq"]["woq_tiled_launches"]
    woq_times = woq_timing(wq, dev)
    log(json.dumps({"woq_summary": woq_summary}))
    log(json.dumps({"woq_timing": woq_times}))
    woq_k, woq_p = (next(r for r in woq_times if (r["bits"], r["rows"], r["in"], r["out"])
                         == (8, rows, 4096, 11008)) for rows in (8, 256))

    flash_kernels_vs_plain(fa, dev)
    small_train_vs_cpu(fa, dev)
    train_launches, train_summary = train_main_path(fa, pa, dev)
    fwd, bwd, extra = flash_timing(fa, dev)
    train_summary["flash"] = {"fwd": fwd, "bwd": bwd, **extra}
    log(json.dumps({"train_summary": train_summary}))
    dropout_launches, dropout_summary = dropout_train_path(fa, dev, train_summary)
    log(json.dumps({"dropout_summary": dict(card=smi.stdout.strip(), **dropout_summary)}))
    ckpt_launches, ckpt_summary = ckpt_phase(fa, dev, smi.stdout.strip())
    log(json.dumps({"ckpt_summary": ckpt_summary}))

    sparse_fe, sparse_be = sparse_kernels_vs_plain(bs, dev)
    sparse_launches, path_errs, path_stats = sparse_main_path(bs, fa, dev)
    sparse_times = sparse_timing(bs, dev)
    for name, st in path_stats.items():
        sparse_times[name]["path"] = st
    log(json.dumps({"sparse_summary": {"shape": list(SPARSE_SHAPE), "block": SPARSE_BLOCK,
                                       "dtype": "bfloat16", "launches": sparse_launches,
                                       **sparse_times}}))
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    sparse_k = {d: dict(sparse_times["fixed"][d], max_abs_err=max(e1, e2))
                for d, e1, e2 in (("fwd", sparse_fe, path_errs[0]),
                                  ("bwd", sparse_be, path_errs[1]))}
    ce_fe, ce_be = ce_kernels_vs_plain(fc, dev)
    counters = ((fc, "fwd_launches"), (fc, "bwd_launches"), (fa, "fwd_launches"),
                (fa, "bwd_launches"), (pa, "launches"), (wq, "launches"), (wq, "tiled_launches"),
                (bs, "fwd_launches"), (bs, "bwd_launches"))
    ce_launches, ce_path_errs, ce_stats = ce_main_path(fc, counters, dev)
    ce_times = ce_timing(fc, dev)
    log(json.dumps({"ce_summary": {"path": ce_stats, **ce_times}}))
    ce_k = {d: dict({k: ce_times["llama-7b"][d][k] for k in keys[1:]},
                    max_abs_err=max(e1, e2))
            for d, e1, e2 in (("fwd", ce_fe, ce_path_errs[0]), ("bwd", ce_be, ce_path_errs[1]))}
    ce_src = "deepspeed_tpu_torch/csrc/fused_ce.cu"

    flash_src = "deepspeed_tpu_torch/csrc/flash_attention.cu"
    sparse_src = "deepspeed_tpu_torch/csrc/block_sparse_attention.cu"
    log(json.dumps({"kernels": [
        dict(name="paged_decode_attention", route="cuda",
             source="deepspeed_tpu_torch/csrc/paged_attention.cu",
             replaces="deepspeed_tpu/ops/transformer/paged_attention.py:76",
             launches=launches + pool_launches, **k),
        # the training paths' launches (phases c, c2 and c3) and the slot path's
        # (phase 8); the times at the training shape, the slot shapes' on
        # slot_summary
        dict(name="flash_attention_fwd", route="cuda", source=flash_src,
             replaces="deepspeed_tpu/ops/transformer/flash_attention.py:43",
             launches=train_launches["fwd"] + dropout_launches["fwd"] + ckpt_launches["fwd"]
             + slot_launches, **fwd),
        dict(name="flash_attention_bwd", route="cuda", source=flash_src,
             replaces="deepspeed_tpu/ops/transformer/flash_attention.py:124",
             launches=train_launches["bwd"] + dropout_launches["bwd"] + ckpt_launches["bwd"],
             **bwd),
        # int8 on w_gate/w_up's (4096, 11008): woq_matmul at decode rows (8,
        # woq_gemv_kernel; launches of every row count), woq_matmul_prefill
        # at 256 rows (woq_mma_kernel; the tiled launches); every shape,
        # width and row count is on the woq_timing line
        dict(name="woq_matmul", route="cuda", source="deepspeed_tpu_torch/csrc/woq_gemm.cu",
             replaces="deepspeed_tpu/ops/quantizer/woq_gemm.py:39", launches=woq_launches,
             max_abs_err=max(woq_worst, max(r["max_abs_err"] for r in woq_times)),
             **{k: woq_k[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms")}),
        dict(name="woq_matmul_prefill", route="cuda",
             source="deepspeed_tpu_torch/csrc/woq_gemm.cu",
             replaces="deepspeed_tpu/ops/quantizer/woq_gemm.py:39", launches=woq_tiled,
             max_abs_err=max(woq_worst, max(r["max_abs_err"] for r in woq_times)),
             **{k: woq_p[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms")}),
        # the Fixed layout's numbers; BigBird's are on the sparse_summary line
        dict(name="block_sparse_attention_fwd", route="cuda", source=sparse_src,
             replaces="deepspeed_tpu/ops/sparse_attention/block_sparse_kernel.py:64",
             launches=sparse_launches["fwd"], **{k: sparse_k["fwd"][k] for k in keys}),
        dict(name="block_sparse_attention_bwd", route="cuda", source=sparse_src,
             replaces="deepspeed_tpu/ops/sparse_attention/block_sparse_kernel.py:99,131",
             launches=sparse_launches["bwd"], **{k: sparse_k["bwd"][k] for k in keys}),
        # llama-7b's head; gpt2-6.7b's is on the ce_summary line
        dict(name="fused_ce_fwd", route="cuda", source=ce_src,
             replaces="deepspeed_tpu/ops/transformer/fused_ce.py:45",
             launches=ce_launches["fused_ce.fwd_launches"], **{k: ce_k["fwd"][k] for k in keys}),
        dict(name="fused_ce_bwd", route="cuda", source=ce_src,
             replaces="deepspeed_tpu/ops/transformer/fused_ce.py:114",
             launches=ce_launches["fused_ce.bwd_launches"], **{k: ce_k["bwd"][k] for k in keys}),
    ]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
