#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. Prints the card's name and power limit, and builds the port's CUDA
   kernels from csrc/ (one nvcc per source, all started together).
1b. fp32 phase (`--fp32` alone), first, under PyTorch's default TF32
   settings (the script turns TF32 off only after it): the four fp32
   kernels (attention forward and backward, LN+GELU forward and
   backward) against their plain versions at the training shapes, the
   attention kernels also at T = 400 and 999, the attention backward and
   the LN+GELU backward bit for bit on two calls;
   the XLS-R-300M stage-1 step in fp32 at B = 32 x 5 s (dropout 0.1,
   SpecAugment, remat) for 8 steps with exactly 48/24/7/7/1 launches a
   step, its peak memory and median ms; the same step at 2 layers, B =
   4, against the fp32 CPU run (loss, each parameter group's gradient
   cosine); the fp32 serving batch (8 x 5 s, 24/7 launches a batch)
   against the fp32 CPU run, and the conv extractor card against CPU
   (fp32 rounding, where TF32 would land ~1e-3 away); then
   `train_stage1 --compute_dtype float32 --device cuda` on a synthetic
   corpus in a child process.
2. Kernel phase: holds each hand-written kernel against its plain
   PyTorch version on the card, at the shapes the serving path gives it
   (forward kernels) and the training step gives it (dropout, backward
   kernels, SupCon), attention also at T = 400 and 999 and on the
   strided views the model passes, LN+GELU backward at the rows of each
   of the step's 7 convs and a ragged count, SupCon also at B = 128,
   129, 1024 and 4096; two calls of the attention backward, the LN+GELU
   backward and SupCon bit for bit; SupCon and its backward once under
   torch.cuda.set_sync_debug_mode("error"); times kernel, plain version
   and the nearest single PyTorch call (timed only; the port never calls
   it; SDPA on one named backend) as device time: CUDA events around
   calls queued behind a sleeping kernel. Murmur dropout
   (csrc/murmur_dropout.cu) bit for bit against its plain version,
   output and gradient, at the step's (32, 249, 1024) in bf16 and the
   compression head's in fp32, an innermost size of 1001 and a gang's
   offsets; timed at both step shapes beside its byte bound, the plain
   version and F.dropout. AdamW (csrc/adamw.cu) bit for bit against its
   plain version at XLS-R 300M's parameter list over three steps (a
   clip's scale, a missing gradient), its launches counted, timed beside
   its byte bound (20 bytes a parameter), the plain loop and
   torch.optim.AdamW(fused=True) at fp32 moments. Then the bf16
   attention kernels at XLS-R 1B's and 2B's head dims, 80 and 120, at
   the training shape (32, 16, 249, D) on strided views: forward and
   backward held to the plain version, launches by head dim counted,
   timed beside their bounds, the plain version and SDPA. `--kernels`
   runs this phase alone.
3. Serve phase: builds XLS-R-300M (24 layers, 1024 wide, 'layer' norm)
   with a linear head from seeded random numpy weights in the JAX tree
   layout, passed through the port's weight bridge; scores 4 batches of
   8 x 5 s clips and one windowed long-clip call, with the launch
   counters reset just before and read just after; compares 2 clips with
   the same model run in fp32 on the CPU; times serving, then breaks 3
   batches down by device kernel with torch.profiler.
4. Train phase: `Stage1Trainer` at XLS-R-300M width (the port's
   Stage1Config defaults with finetune_encoder=True, use_rawboost=False:
   bf16, dropout, SpecAugment, remat) takes 8 SupCon steps on one fixed
   batch of 32 x 5 s clips at alpha = 1, with the launch counters reset
   just before and read just after; checks the losses and the exact
   launch counts (the AdamW kernel's: `optim.launches` and
   `optim.tensors`); times the steps and breaks one down with
   torch.profiler. Then one step at 2 layers, B=4, dropout and
   SpecAugment off, on the card in bf16 against the CPU in fp32.
5. RawBoost phase: device RawBoost (ops/rawboost.py, plain PyTorch) on
   (32, 80,000) clips with zero-padded tails, its draws made on the
   card: 'direct' and 'fft' held against the CPU on the same draws and
   against each other, the pad mask and prob = 0 checked, once under
   set_sync_debug_mode("error"), device time and device operations
   beside a byte bound. Then the finetune step with RawBoost on (the
   Stage1Config default) and off in turns, the one with RawBoost once
   under set_sync_debug_mode("error"), and its device operations.
6. Fit phase, in a process of its own (`--fit`, with
   CUBLAS_WORKSPACE_CONFIG=:4096:8 and deterministic algorithms): writes
   a synthetic ASVspoof-2019-style corpus (64 train, 32 dev clips of
   5 s) to a temporary directory, runs `fit` for 2 epochs at XLS-R-300M
   width with device RawBoost and a dev pipe (launch counters reset just
   before and read just after), then the same run preempted at epoch 2,
   batch 1 and resumed from 'latest' through from_checkpoint, which must
   end on the same bits; times a save and a restore of the full state.
7. Pipeline phase, in the same process, from that run's full-width
   'best' checkpoint: a 32-clip eval split, `extract_embeddings` through
   `Stage1Trainer.from_checkpoint(...).embed_dataset` for train, dev and
   eval at batch 32 (launch counters reset just before and read just
   after: 24 attention and 7 LN+GELU forwards a batch, nothing else),
   extraction clips/s and device ms a batch, `train_stage2` on the card,
   `generate_scores` -> score_cm_eval.txt -> EER, and
   `SpoofScorer.from_checkpoints` against the score file and, on 4 clips,
   against an fp32 CPU scorer from the same checkpoints.
8. Front-door phase, after the serve phase: with the port's own
   writers, a finetuned reference stage-1 .pt (encoder under
   `module.model.`, positional conv as weight_g/weight_v), a frozen one,
   a linear stage-2 .pt and an HF snapshot (config.json +
   model.safetensors) at XLS-R-300M width from the seed-0 weights;
   converted back by convert_hf_checkpoint and
   convert_reference_checkpoint (the frozen one through --encoder_init)
   and held to the originals; a corpus of 64 clips of 3-7 s, half FLAC
   (tests/flac_writer.py) and half WAV, plus a missing path, served by
   ScoringServer on 127.0.0.1 (batch 8, max_wait 5 ms) from the converted
   checkpoints to 16 client threads, bare and tagged lines, with the
   launch counters reset just before the server starts and read after
   it stops (24 attention and 7 LN+GELU forwards a batch, nothing else);
   every reply against SpoofScorer.score_waveforms on the same decoded
   clip, exactly one failed decode; requests/s, latency and occupancy;
   then `python -m wav2vec_contr_loss_torch serve --list` and `--windowed
   mean` and `doctor` as processes of their own.
9. Artifact and int8 phase, after the front-door phase, from the serve
   phase's seed-0 weights and batches: a `torch.export` artifact of the
   bf16 scorer and one of the w8a8 scorer at batch 8 (export seconds,
   bytes), with `serve --artifact --list` on 8 clips as a process of its
   own beside the second export and the fp32 CPU references, its scores
   against `score_waveforms`; scorers with `quantize='w8'` and `'w8a8'`
   (int8 transformer linears, `torch._int_mm` for w8a8), each with exact
   launch counts over 4 batches (24 attention and 7 LN+GELU forwards a
   batch, nothing else), its layer mean against the bf16 scorer's, z and
   logits against the fp32 CPU run of the same mode, the fp32 CPU
   quantization error against JAX's bounds, ms a batch, device ms and
   operations, peak memory and int8 bytes; then each artifact loaded
   back by `load_exported` and run over 4 batches with exact launch
   counts against its live scorer, ms a batch, device ms and operations.
10. Bench phase, after the parallel phase, in this process:
   cli/bench_components.py on the card (BENCH_LEGS): its `main`, the
   command a user runs, for `--which all` (decode, rawboost and supcon
   at their defaults), serving at 8 x 5 s with 30 repeats, serving
   through the w8a8 scorer with 10 repeats and socket at 8 clients x 5
   requests; `bench_extract` at 32 x 5 s over 10 batches (the command
   runs 40); the model legs at XLS-R-300M width, the launch counters
   set to 0 just before each leg and read just after (serving and
   extract exactly 24 attention and 7 LN+GELU forwards a batch, supcon
   its warm-up and repeats of the kernel, nothing else); every
   measurement finite and above 0; the supcon leg's kernel against the
   plain loss on its inputs (B = 256); prints the bench's JSON and the
   phase's seconds.
11. Prints one JSON line with every kernel's numbers, then the result
   line. Any failure exits non-zero before the result line.

Needs torch with CUDA, triton and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

T_START = time.perf_counter()

from h100bench.roofline import (BF16_FLOP_PER_S, FP32_FLOP_PER_S,
                                HBM_BYTES_PER_S, TF32_FLOP_PER_S,
                                least_seconds)
from wav2vec_contr_loss_torch.bridge import random_jax_trees

# the card's name and power limit as nvidia-smi gives them, printed
# beside the timings
CARD = "not read"

BATCH = 8
SAMPLES = 80000                  # 5 s at 16 kHz, the serving clip
N_BATCHES = 4
# bf16 on the card against fp32 on the CPU through 24 layers: bf16 keeps
# 8 mantissa bits (relative rounding 2^-9 per op), and the layer mean,
# the compression projection and the L2 norm average that drift down;
# z is unit-norm and the head weights have unit scale, so the logits are
# O(1) and both are held to the same absolute bound.
Z_TOL = 5e-2                     # max |z_gpu - z_cpu|
LOGIT_TOL = 5e-2                 # max |logit_gpu - logit_cpu|

TRAIN_BATCH = 32                 # Stage1Config.batch_size
PIPE_BATCH = 32                  # extraction batch of the pipeline phase
EVAL_CLIPS = 32                  # its eval split
TRAIN_STEPS = 8
# frames after each of XLS-R's 7 convs for a 5 s clip: the LN+GELU rows
# of a train step are TRAIN_BATCH times each
TRAIN_CONV_FRAMES = (15999, 7999, 3999, 1999, 999, 499, 249)
# attention forward/backward: bf16 outputs on both sides (q/k/v/g, p and
# ds rounded to bf16 at different places: the plain autograd also rounds
# dp to bf16); the tolerances of tests/test_attention_pallas.py
ATT_FWD_TOL = dict(atol=2e-3, rtol=2e-2)
ATT_BWD_TOL = dict(atol=5e-2, rtol=5e-2)
# LN+GELU forward: bf16 outputs on both sides, fp32 statistics
# (tests/test_conv_ln_pallas.py's bf16 tolerance)
LN_FWD_TOL = dict(atol=2e-2, rtol=2e-2)
# LN+GELU backward: dx is bf16 on both sides (tests/test_conv_ln_pallas.py's
# bf16 tolerance); dscale/dbias are fp32 sums over up to 511,968 rows taken
# in another order (per-block partial sums) than autograd's
LN_DX_TOL = dict(atol=2e-2, rtol=2e-2)
LN_DPARAM_TOL = dict(atol=5e-2, rtol=1e-3)
# SupCon: fp32 on both sides; the tolerances of tests/test_supcon_pallas.py
SUPCON_LOSS_TOL = dict(atol=2e-5, rtol=2e-5)
SUPCON_GRAD_TOL = dict(atol=5e-6, rtol=5e-4)
# one train step, bf16 on the card against fp32 on the CPU, 2 layers at
# full width: measured |d loss| 7.3e-5 and a proj-gradient cosine of
# 0.99997 on an H100 (the first run of this check). The bounds leave a
# factor of ~70 on the loss and ~30 on 1 - cosine for other seeds and
# cards; a wrong kernel moves the loss by O(1e-1) and the cosine far
# below 0.999. The gradient is held by its direction because bf16 moves
# its small entries by more than their size.
STEP_LOSS_TOL = 5e-3             # |loss_gpu - loss_cpu|
STEP_GRAD_COS = 0.999            # cosine(proj grad gpu, proj grad cpu)
# the same step's encoder gradients, which only the in-model backward
# kernels (attention bwd, LN+GELU bwd and its partial sums) and the remat
# recompute on the card produce: a transformer weight of the first layer
# and the first conv LN's scale, the far end of the backward. Held by
# cosine and by the ratio of the norms gpu / cpu. Measured on an H100:
# cosines 0.9978-0.9996, norm ratios within 0.22 % of 1 (both cases);
# the limits sit ~3x and ~4.5x outside that. A remat recompute that
# draws other dropout masks than the forward fails both limits while the
# proj gradient does not move.
STEP_ENC_GRADS = ("encoder.encoder.layers.0.attention.q_proj.weight",
                  "encoder.feature_extractor.conv_layers.0.layer_norm.weight")
STEP_ENC_COS = 0.993             # cosine(gpu, cpu) of each
STEP_ENC_NORM = 0.01             # |norm ratio - 1|
# device RawBoost, card against CPU on the same draws, max |d| / peak:
# the bounds its CPU tests hold it to against the JAX function (fp32 on
# both sides; 5e-4 is the JAX file's own fft-vs-direct bound)
RB_TOL = {"direct": 1e-4, "fft": 5e-4}


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one fn() in ms: CUDA events around `iters` calls
    queued behind a sleeping kernel, so the device runs them back to back
    and the host's time between launches, which decides `cuda_ms` for
    calls of a few microseconds, stays out. Where the host was slower
    than the sleep (its cores are shared), it measures again behind a
    sleep four times as long, up to ~1.6 s."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # ~25 ms, 0.1 s, 0.4 s and 1.6 s at the H100's clock
    for cycles in (50_000_000, 200_000_000, 800_000_000, 3_200_000_000):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        if time.perf_counter() - t0 >= 1e-3:
            return start.elapsed_time(end) / iters
    raise RuntimeError("the host took longer to queue the calls than the "
                       "sleeping kernel ran: the timing would include host "
                       "time")


def sdpa_backend(dtype=torch.bfloat16):
    """(context manager factory, name) of the one SDPA backend that the
    yardstick runs on at `dtype`: cuDNN's, which takes the additive mask,
    or the memory-efficient one where cuDNN's is missing or refuses the
    dtype (fp32)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    F = torch.nn.functional
    x = torch.zeros(1, 1, 64, 64, device="cuda", dtype=dtype)
    m = torch.zeros(1, 1, 1, 64, device="cuda", dtype=dtype)
    for backend in (SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        try:
            # a refusal also warns why, once for each backend
            with sdpa_kernel([backend]), warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                F.scaled_dot_product_attention(x, x, x, attn_mask=m)
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return (lambda b=backend: sdpa_kernel([b])), backend.name
    raise RuntimeError("no SDPA backend takes an additive mask here")


def bound(nbytes: float, flops: float, flop_rate: float):
    """(least time in ms, what bounds it) on an H100 SXM, by the least-time
    rule and the peaks of h100bench/roofline.py (the card's published
    dense rates: bf16 and TF32 tensor cores, fp32 outside them; an
    fp32-accurate 3xTF32 product costs three TF32 ones)."""
    least = least_seconds(nbytes, flops, flop_rate)
    return 1e3 * least, ("bytes" if nbytes / HBM_BYTES_PER_S >= least
                         else "operations")


def serving_waves(rng, n_batches: int):
    """(n_batches, BATCH, SAMPLES) float32 clips: two zero-padded clips
    in every batch and one all-zero clip in the first."""
    w = rng.normal(0, 0.1, (n_batches, BATCH, SAMPLES)).astype(np.float32)
    w[:, 1, 60000:] = 0.0
    w[:, 5, 30000:] = 0.0
    w[0, 7] = 0.0
    return w


def kernel_phase(dev):
    from wav2vec_contr_loss_torch.ops import attention, conv_ln

    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}

    # attention at the serving shape: padded key tails and one clip with
    # no valid frame (uniform weights)
    b, h, t, d = BATCH, 16, 249, 64
    q, k, v = (torch.randn(b, h, t, d, generator=gen, device=dev)
               for _ in range(3))
    q = (q * d ** -0.5).to(torch.bfloat16)
    k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    lengths = torch.tensor([249, 249, 200, 249, 120, 249, 0, 10], device=dev)
    bias = torch.where(torch.arange(t, device=dev)[None, :] < lengths[:, None],
                       0.0, -1e30).to(torch.float32)
    err = 0.0
    for rate in (0.0, 0.1):
        got = attention.fused_attention(q, k, v, bias, 7, rate, h)
        want = attention.fused_attention_plain(q, k, v, bias, 7, rate)
        torch.cuda.synchronize()
        e = (got.float() - want.float()).abs().max().item()
        print(f"attention_fwd (8,16,249,64) rate {rate} max_abs_err={e:.3e} "
              f"(tolerance {ATT_FWD_TOL})")
        torch.testing.assert_close(got.float(), want.float(), **ATT_FWD_TOL)
        err = max(err, e)
    # ragged edges off the main path: T below one tile and below the head
    # dim; T past the earlier kernels' shared-memory caps (one and
    # several chunks of key tiles), with and without dropout
    for eb, eh, et in ((2, 3, 37), (2, 4, 400), (1, 4, 999)):
        eq, ek, ev = (torch.randn(eb, eh, et, d, generator=gen, device=dev
                                  ).to(torch.bfloat16) for _ in range(3))
        eq = (eq.float() * d ** -0.5).to(torch.bfloat16)
        ebias = torch.zeros(eb, et, device=dev)
        ebias[-1, et // 2:] = -1e30
        for rate in (0.0, 0.1):
            eg = attention.fused_attention(eq, ek, ev, ebias, 5, rate,
                                           eh).float()
            ew = attention.fused_attention_plain(eq, ek, ev, ebias, 5,
                                                 rate).float()
            e = (eg - ew).abs().max().item()
            print(f"attention_fwd ({eb},{eh},{et},{d}) rate {rate} "
                  f"max_abs_err={e:.3e}")
            torch.testing.assert_close(eg, ew, **ATT_FWD_TOL)
            err = max(err, e)
    sdpa_ctx, sdpa_name = sdpa_backend()
    mask16 = bias[:, None, None, :].to(torch.bfloat16)
    ms = device_ms(lambda: attention.fused_attention(q, k, v, bias, 0, 0.0,
                                                     h))
    wall_ms = cuda_ms(lambda: attention.fused_attention(q, k, v, bias, 0,
                                                        0.0, h))
    plain_ms = device_ms(lambda: attention.fused_attention_plain(q, k, v,
                                                                 bias))
    with sdpa_ctx():
        lib_ms = device_ms(lambda: torch.nn.functional.
                           scaled_dot_product_attention(q, k, v,
                                                        attn_mask=mask16,
                                                        scale=1.0))
    nbytes = 4 * b * h * t * d * 2 + b * t * 4
    bound_ms, bound_by = bound(nbytes, 4 * b * h * t * t * d, BF16_FLOP_PER_S)
    results["attention_fwd"] = dict(
        name="attention_fwd", route="cuda",
        source="wav2vec_contr_loss_torch/csrc/attention_fwd.cu",
        replaces="wav2vec_contr_loss_tpu/ops/attention_pallas.py:83",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=lib_ms, library=f"SDPA {sdpa_name}")
    print(f"attention_fwd (8,16,249,64) bf16 device time: kernel {ms:.4f} ms "
          f"({wall_ms:.4f} ms a call by CUDA events, host included), plain "
          f"{plain_ms:.4f} ms, SDPA on {sdpa_name} {lib_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by})")

    # LN+GELU at the first conv's rows (8 x 15999) and at a ragged count
    c = 512
    scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)
    shift = 0.1 * torch.randn(c, generator=gen, device=dev)
    err = 0.0
    for rows in (BATCH * 15999, 12347):
        x = (2.0 * torch.randn(rows, c, generator=gen, device=dev)
             ).to(torch.bfloat16)
        for gelu in (True, False):
            got = conv_ln.fused_ln_gelu(x, scale, shift, 1e-5, gelu)
            want = conv_ln.fused_ln_gelu_plain(x, scale, shift, 1e-5, gelu)
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            print(f"ln_gelu_fwd rows={rows} gelu={gelu} max_abs_err={e:.3e} "
                  f"(tolerance {LN_FWD_TOL})")
            torch.testing.assert_close(got.float(), want.float(),
                                       **LN_FWD_TOL)
            err = max(err, e)
    x = (2.0 * torch.randn(BATCH * 15999, c, generator=gen, device=dev)
         ).to(torch.bfloat16)
    s16, b16 = scale.to(torch.bfloat16), shift.to(torch.bfloat16)
    ms = device_ms(lambda: conv_ln.fused_ln_gelu(x, scale, shift, 1e-5, True))
    plain_ms = device_ms(
        lambda: conv_ln.fused_ln_gelu_plain(x, scale, shift, 1e-5, True))
    lib_ms = device_ms(lambda: torch.nn.functional.gelu(
        torch.nn.functional.layer_norm(x, (c,), s16, b16, 1e-5)))
    n = x.numel()
    # ~16 fp32 operations per element: mean, centre, square, sum,
    # normalize, scale, shift, and the GELU around erf
    bound_ms, bound_by = bound(2 * n * 2 + 2 * c * 4, 16 * n, FP32_FLOP_PER_S)
    results["ln_gelu_fwd"] = dict(
        name="ln_gelu_fwd", route="triton",
        source="wav2vec_contr_loss_torch/ops/conv_ln.py",
        replaces="wav2vec_contr_loss_tpu/ops/conv_ln_pallas.py:58",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=lib_ms)
    print(f"ln_gelu_fwd (127992,512) bf16 gelu: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, F.layer_norm+F.gelu {lib_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by})")
    return results


# murmur dropout's cases: (shape, dtype, offsets); the first two timed
DROPOUT_CASES = (((32, 249, 1024), torch.bfloat16, None),
                 ((32, 249, 1024), torch.float32, None),
                 ((32, 249, 1001), torch.bfloat16, None),
                 ((8, 249, 512), torch.bfloat16, (8, 0, 512)))
DROPOUT_RATE = 0.1


def dropout_phase(dev, results) -> None:
    """Murmur dropout's kernel against its plain version on the same
    tensors, output and gradient bit for bit; then its device time at
    the step's two shapes beside its byte bound (one read, one write),
    the plain version's and F.dropout's (timed only)."""
    from wav2vec_contr_loss_torch.ops import dropout

    gen = torch.Generator(device=dev).manual_seed(6)
    seed, rate = 2 ** 31 - 9, DROPOUT_RATE
    rows = {}
    for shape, dtype, offsets in DROPOUT_CASES:
        x = (2.0 * torch.randn(shape, generator=gen, device=dev)).to(dtype)
        g = torch.randn(shape, generator=gen, device=dev).to(dtype)
        out = []
        for fn in (dropout.murmur_dropout, dropout.murmur_dropout_plain):
            xr = x.clone().requires_grad_()
            y = fn(xr, seed, rate, offsets)
            y.backward(g)
            out.append((y.detach(), xr.grad))
        (y, dx), (yp, dxp) = out
        same = torch.equal(y, yp) and torch.equal(dx, dxp)
        print(f"murmur_dropout {shape} {dtype} offsets {offsets}: output "
              f"and gradient equal to the plain version's: {same}")
        if not same:
            raise RuntimeError("the murmur dropout kernel differs from its "
                               "plain version")
        if len(rows) < 2:
            name = "bf16" if dtype == torch.bfloat16 else "fp32"
            ms = device_ms(lambda: dropout.murmur_dropout(x, seed, rate))
            plain_ms = device_ms(
                lambda: dropout.murmur_dropout_plain(x, seed, rate))
            lib_ms = device_ms(lambda: torch.nn.functional.dropout(
                x, rate, training=True))
            bound_ms, bound_by = bound(2 * x.numel() * x.element_size(), 0,
                                       BF16_FLOP_PER_S)
            rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, library_ms=lib_ms,
                              share_of_bound=bound_ms / ms)
            print(f"murmur_dropout {shape} {name}: kernel {ms:.4f} ms "
                  f"({100 * bound_ms / ms:.1f} % of the bound), plain "
                  f"{plain_ms:.4f} ms, F.dropout {lib_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by})")
    results["murmur_dropout"] = dict(
        name="murmur_dropout", route="cuda",
        source="wav2vec_contr_loss_torch/csrc/murmur_dropout.cu",
        replaces="none: wav2vec_contr_loss_tpu/ops/fast_dropout.py is jnp "
                 "that XLA fuses", library="F.dropout",
        launches=dropout.launches, bwd_launches=dropout.bwd_launches,
        **rows)


def xlsr300m_param_shapes() -> list:
    """The shapes of the stage-1 optimizer's parameters at XLS-R 300M
    width, in its groups' order: the compression head's 2, then the
    encoder's 421 (the finetune trains all of them)."""
    from wav2vec_contr_loss_torch import XLSR_300M, Stage1Config
    from wav2vec_contr_loss_torch.models.compression import CompressionModule
    from wav2vec_contr_loss_torch.models.wav2vec2 import Wav2Vec2Encoder

    scfg = Stage1Config()
    with torch.device("meta"):
        mods = (CompressionModule(scfg.input_dim, scfg.hidden_dim,
                                  scfg.dropout), Wav2Vec2Encoder(XLSR_300M))
    return [tuple(p.shape) for m in mods for p in m.parameters()]


def optimizer_tables(opt) -> int:
    """csrc/adamw.cu launches one step of a GroupedAdamW needs."""
    from wav2vec_contr_loss_torch.train import optim

    return sum(len(optim.launch_tables([p.numel() for p in grp.params],
                                       *optim.kernel_limits()))
               for grp in opt.groups.values())


ADAMW_STEPS = 3


def adamw_phase(dev, results) -> None:
    """csrc/adamw.cu against its plain version at XLS-R 300M's parameter
    list (one group, bf16 moments, the recipe's encoder lr and weight
    decay): three steps, the first and third behind a clip's scale, the
    second with one parameter left without a gradient, parameters and
    moments bit for bit after each; then its device time beside its byte
    bound (20 bytes a parameter), the plain loop's and, as the nearest
    library call, torch.optim.AdamW(fused=True)'s at fp32 moments (not
    the same function: its moments' dtype and arithmetic; timed only)."""
    from wav2vec_contr_loss_torch import Stage1Config
    from wav2vec_contr_loss_torch.train import optim

    scfg = Stage1Config()
    hyper = dict(lr=scfg.enc_lr, weight_decay=scfg.weight_decay, b1=0.9,
                 b2=0.999, eps=1e-8)
    shapes = xlsr300m_param_shapes()
    gen = torch.Generator(device=dev).manual_seed(23)
    first = [torch.randn(s, generator=gen, device=dev) for s in shapes]
    grads = [torch.empty_like(p) for p in first]
    sides = [([p.clone() for p in first],
              [torch.zeros_like(p, dtype=torch.bfloat16) for p in first],
              [torch.zeros_like(p, dtype=torch.bfloat16) for p in first])
             for _ in range(2)]
    del first
    n = sum(p.numel() for p in sides[0][0])
    n0 = optim.launches
    for step in range(1, ADAMW_STEPS + 1):
        for g in grads:
            g.normal_(0.0, 1e-2, generator=gen)
        gs, scale = list(grads), None
        if step == 2:
            gs[5] = None
        else:
            scale = optim.clip_scale(grads, 1.0)
        for fn, (p, m, v) in zip((optim.adamw, optim.adamw_plain), sides):
            fn(p, gs, m, v, count=step, scale=scale, **hyper)
        diffs = {}
        for what, a, b in zip(("p", "mu", "nu"), sides[0], sides[1]):
            d = [ulps(x, y) for x, y in zip(a, b) if x.numel()]
            diffs[what] = (max(int(u.max()) for u in d),
                           sum(int((u != 0).sum()) for u in d))
        print(f"adamw {len(shapes)} tensors, {n} parameters, step {step} "
              f"({'scale' if scale is not None else 'no scale'}"
              f"{', one gradient None' if step == 2 else ''}): largest "
              f"difference from the plain version in units of the last "
              f"place, and elements that differ: {diffs}")
        if any(d[1] for d in diffs.values()):
            raise RuntimeError("the AdamW kernel differs from its plain "
                               "version")
    launches = optim.launches - n0
    want = ADAMW_STEPS * len(optim.launch_tables(
        [p.numel() for p in sides[0][0]], *optim.kernel_limits()))
    if launches != want:
        raise RuntimeError(f"AdamW: {launches} launches over {ADAMW_STEPS} "
                           f"steps, expected {want}")

    (p, m, v), (pp, pm, pv) = sides
    ms = device_ms(lambda: optim.adamw(p, grads, m, v, count=4, **hyper))
    # thousands of operations a call overflow the launch queue behind
    # device_ms's sleep: the plain loop's device time is the sum of its
    # operations' in a profile
    plain_ops, plain_ms = device_ops(lambda: optim.adamw_plain(
        pp, grads, pm, pv, count=4, **hyper))
    leaves = [torch.nn.Parameter(x) for x in pp]
    for leaf, g in zip(leaves, grads):
        leaf.grad = g
    lib = torch.optim.AdamW(leaves, lr=hyper["lr"], betas=(0.9, 0.999),
                            eps=hyper["eps"],
                            weight_decay=hyper["weight_decay"], fused=True)
    lib_ms = device_ms(lib.step)
    bound_ms, bound_by = bound(20 * n, 0, BF16_FLOP_PER_S)
    print(f"adamw {n} parameters in {len(shapes)} tensors, bf16 moments: "
          f"kernel {ms:.4f} ms ({100 * bound_ms / ms:.1f} % of the bound, "
          f"{ms / bound_ms:.2f}x it) in {want // ADAMW_STEPS} launch(es), "
          f"plain {plain_ms:.4f} ms in {plain_ops} device operations, "
          f"torch.optim.AdamW(fused=True) at fp32 moments {lib_ms:.4f} "
          f"ms, bound {bound_ms:.4f} ms ({bound_by}, "
          f"20 bytes a parameter) [{CARD}]")
    results["adamw"] = dict(
        name="adamw", route="cuda",
        source="wav2vec_contr_loss_torch/csrc/adamw.cu",
        replaces="none: wav2vec_contr_loss_tpu/ops/adam_bf16nu.py "
                 "_scale_by_adam_storage is jnp that XLA fuses",
        library="torch.optim.AdamW(fused=True) at fp32 moments, not the "
                "same function",
        parameters=n, tensors=len(shapes), launches=launches, ms=ms,
        plain_ms=plain_ms, plain_ops=plain_ops, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=lib_ms, share_of_bound=bound_ms / ms)


def rounded_plain(q, k, v, g, bias, seed, rate):
    """-> (out, (dq, dk, dv)) with the kernels' roundings, in fp32 on the
    card: p = softmax(q . k^T + bias) unrounded, out = bf16(p m) . v,
    out_exact = (p m) . v in bf16, D = rowsum(g * out_exact),
    dS = p * (g . v^T * m - D), dq = bf16(dS) . k, dk = bf16(dS)^T . q,
    dv = bf16(p m)^T . g; m the dropout mask (0 or 1 / (1 - rate))."""
    from wav2vec_contr_loss_torch.ops.dropout import attention_dropout_mask

    bf16 = torch.bfloat16
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    p = torch.softmax(qf @ kf.transpose(-1, -2) + bias[:, None, None, :],
                      dim=-1)
    b, h, t, _ = q.shape
    m = (attention_dropout_mask(b, h, t, seed, rate, q.device)
         if rate > 0.0 else torch.ones_like(p))
    pm = p * m
    out = (pm.to(bf16).float() @ vf).to(bf16)
    d_row = (gf * (pm @ vf).to(bf16).float()).sum(-1, keepdim=True)
    ds = (p * ((gf @ vf.transpose(-1, -2)) * m - d_row)).to(bf16).float()
    grads = (ds @ kf, ds.transpose(-1, -2) @ qf,
             pm.to(bf16).float().transpose(-1, -2) @ gf)
    return out, tuple(x.to(bf16) for x in grads)


def head_dim_errors(q, k, v, g, bias, seed: int, heads: int):
    """The attention kernels on q, k, v (cotangent g) against the plain
    version on the same inputs under the bf16 rule of PERF.md's kernel
    table, 5e-2 + 5e-2 |plain|: {check: (max |kernel - plain|, worst
    excess over the rule, held or only reported)}, with the kernel's and
    the plain version's (out, inputs) kept for timing their backward.

    The forward at rate 0.1 and 0, and the forward that writes the
    backward's residuals, are held to `fused_attention_plain`, whose
    arithmetic they are. dq, dk and dv at rate 0.1 are held to
    `rounded_plain`, the same function with the kernels' (and the Pallas
    kernel's) roundings, under the rule plus one bf16 ulp of each term of
    the product whose bf16 factor both round (2^-7 |dS| . |k| for dq,
    2^-7 |dS|^T . |q| for dk, 2^-7 |p m|^T . |g| for dv): the two round
    fp32 values that differ in their last bits, so a rounding may land a
    ulp apart, and at this shape one such term of a large dS alone passes
    5e-2 where the sum nearly cancels. Their distances to
    `fused_attention_plain`'s gradients in bf16 (its autograd rounds dP
    where the kernels round dS) and in fp32 (the exact ones) are
    reported."""
    from wav2vec_contr_loss_torch.ops import attention
    from wav2vec_contr_loss_torch.ops.dropout import attention_dropout_mask

    rule = ATT_BWD_TOL

    def excess(got, want, held=True, slack=0.0):
        got, want = got.float(), want.float()
        if not torch.isfinite(got).all():
            return float("inf"), float("inf"), held
        err = (got - want).abs()
        return (err.max().item(), (err - rule["atol"] - slack
                                   - rule["rtol"] * want.abs()).max().item(),
                held)

    checks = {}
    with torch.no_grad():
        for rate in (0.1, 0.0):
            want = attention.fused_attention_plain(q, k, v, bias, seed, rate)
            got = attention.fused_attention(q, k, v, bias, seed, rate, heads)
            checks[f"out rate {rate}"] = excess(got, want)
    ins = [x.detach().requires_grad_() for x in (q, k, v)]
    out = attention.fused_attention(*ins, bias, seed, 0.1, heads)
    checks["out rate 0.1 writing the residuals"] = excess(
        out, attention.fused_attention_plain(q, k, v, bias, seed, 0.1))
    got = torch.autograd.grad(out, ins, g, retain_graph=True)
    with torch.no_grad():
        _, rounded = rounded_plain(q, k, v, g, bias, seed, 0.1)
        qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
        b, h, t, _ = q.shape
        p = torch.softmax(qf @ kf.transpose(-1, -2)
                          + bias[:, None, None, :], dim=-1)
        m = attention_dropout_mask(b, h, t, seed, 0.1, q.device)
        pm = p * m
        d_row = (gf * (pm @ vf)).sum(-1, keepdim=True)
        ds = (p * ((gf @ vf.transpose(-1, -2)) * m - d_row)).abs_()
        ulps = (2 ** -7 * (ds @ kf.abs()),
                2 ** -7 * (ds.transpose(-1, -2) @ qf.abs()),
                2 ** -7 * (pm.transpose(-1, -2) @ gf.abs()))
        del p, m, pm, ds
    ins_p = [x.detach().requires_grad_() for x in (q, k, v)]
    out_p = attention.fused_attention_plain(*ins_p, bias, seed, 0.1)
    plain = torch.autograd.grad(out_p, ins_p, g, retain_graph=True)
    ins32 = [x.detach().float().requires_grad_() for x in (q, k, v)]
    exact = torch.autograd.grad(
        attention.fused_attention_plain(*ins32, bias, seed, 0.1), ins32,
        g.float())
    for name, a, w, u, pw, ew in zip(("dq", "dk", "dv"), got, rounded,
                                     ulps, plain, exact):
        checks[f"{name} against rounded_plain"] = excess(a, w, slack=u)
        checks[f"{name} beside fused_attention_plain in bf16"] = excess(
            a, pw, False)
        checks[f"{name} beside fused_attention_plain in fp32"] = excess(
            a, ew, False)
    return checks, out, ins, out_p, ins_p


def head_dim_phase(dev, results) -> None:
    """The bf16 attention kernels at XLS-R 1B's and 2B's head dims, 80 and
    120, at the training shape (32, 16, 249, D) on the (B, T, H, D) views
    the model passes: held to the plain version (`head_dim_errors`),
    raising on any miss, with the launches by head dim cleared just
    before and required to be 3 forward and 1 backward at D alone; then
    each kernel's device time beside its bound at the true head dim
    (never the 128 the kernels pad q . k^T to), the plain version's and
    SDPA's."""
    from wav2vec_contr_loss_torch.ops import attention

    gen = torch.Generator(device=dev).manual_seed(3)
    F = torch.nn.functional
    b, h, t = TRAIN_BATCH, 16, 249
    lengths = torch.full((b,), t, device=dev)
    lengths[1], lengths[5], lengths[9], lengths[30] = 200, 120, 10, 0
    bias = _bias_with_tails(lengths, t, dev)
    mask16 = bias[:, None, None, :].to(torch.bfloat16)
    sdpa_ctx, sdpa_name = sdpa_backend()
    seed = 123456789
    for d in (80, 120):
        q, k, v, g = (torch.randn(b, t, h, d, generator=gen, device=dev
                                  ).to(torch.bfloat16).transpose(1, 2)
                      for _ in range(4))
        q = (q.float() * d ** -0.5).to(torch.bfloat16)
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
        attention.head_dim_launches.clear()
        attention.head_dim_bwd_launches.clear()
        checks, out, ins, out_p, ins_p = head_dim_errors(q, k, v, g, bias,
                                                         seed, h)
        counts = (dict(attention.head_dim_launches),
                  dict(attention.head_dim_bwd_launches))
        for what, (err, over, held) in checks.items():
            print(f"attention {(b, h, t, d)} {what}: max_abs_err={err:.3e}, "
                  f"worst excess over the rule {over:.3e} "
                  f"({'held' if held else 'reported'})")
        print(f"attention {(b, h, t, d)} launches by head dim (forward, "
              f"backward): {counts}")
        missed = [what for what, (_, over, held) in checks.items()
                  if held and not over <= 0.0]
        if missed:
            raise RuntimeError(f"attention at head dim {d} misses the plain "
                               f"version: {missed}")
        if counts != ({d: 3}, {d: 1}):
            raise RuntimeError(f"attention at head dim {d}: launches by head "
                               f"dim {counts}, not ({{{d}: 3}}, {{{d}: 1}})")
        ms_drop = device_ms(lambda: attention.fused_attention(
            q, k, v, bias, seed, 0.1, h))
        ms_nodrop = device_ms(lambda: attention.fused_attention(
            q, k, v, bias, 0, 0.0, h))
        ms_resid = device_ms(lambda: attention.fused_attention(
            *ins, bias, seed, 0.1, h))
        bwd_ms = _grad_ms(out, ins, g)
        # rate 0, as the kernel phase times the plain forward: its mask is
        # drawn anew at each call
        plain_ms = device_ms(lambda: attention.fused_attention_plain(
            q, k, v, bias))
        plain_bwd_ms = _grad_ms(out_p, ins_p, g)
        try:
            with sdpa_ctx():
                lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask16, scale=1.0))
                lib_out = F.scaled_dot_product_attention(
                    *ins_p, attn_mask=mask16, scale=1.0)
                lib_bwd_ms = _grad_ms(lib_out, ins_p, g)
        except RuntimeError as e:       # a backend that refuses this D
            print(f"SDPA on {sdpa_name} at head dim {d}: {e}")
            lib_ms = lib_bwd_ms = None
        n = b * h * t * d
        fwd_bound, _ = bound(4 * n * 2 + b * t * 4, 4 * b * h * t * t * d,
                             BF16_FLOP_PER_S)
        bwd_bound, _ = bound(7 * n * 2 + b * t * 4,
                             5 * 2 * b * h * t * t * d, BF16_FLOP_PER_S)
        results[f"attention_d{d}"] = dict(
            name=f"attention_d{d}", route="cuda",
            source="wav2vec_contr_loss_torch/csrc/attention_fwd.cu, "
                   "attention_bwd.cu", shape=[b, h, t, d],
            max_abs_err={what: err for what, (err, *_) in checks.items()},
            launches=counts[0][d], bwd_launches=counts[1][d],
            fwd_ms=ms_drop, fwd_resid_ms=ms_resid, fwd_rate0_ms=ms_nodrop,
            bwd_ms=bwd_ms, fwd_bound_ms=fwd_bound, bwd_bound_ms=bwd_bound,
            plain_fwd_ms=plain_ms, plain_bwd_ms=plain_bwd_ms,
            library_fwd_ms=lib_ms, library_bwd_ms=lib_bwd_ms,
            library=f"SDPA {sdpa_name}")
        print(f"attention {(b, h, t, d)} device time: forward rate 0.1 "
              f"{ms_drop:.4f} ms ({ms_resid:.4f} ms writing the residuals, "
              f"{100 * fwd_bound / ms_resid:.1f} % of its bound "
              f"{fwd_bound:.4f} ms), rate 0 {ms_nodrop:.4f} ms; backward "
              f"rate 0.1 {bwd_ms:.4f} ms ({100 * bwd_bound / bwd_ms:.1f} % "
              f"of {bwd_bound:.4f} ms); plain (rate 0) {plain_ms:.4f} / "
              f"{plain_bwd_ms:.4f} ms; SDPA on {sdpa_name} {lib_ms} / "
              f"{lib_bwd_ms} ms [{CARD}]")


def kernels_main() -> int:
    """The kernel phase alone (`--kernels`), its kernels built on demand,
    with TF32 off as in `main`: attention at head dim 64, LN+GELU, SupCon,
    murmur dropout, AdamW, then attention at head dims 80 and 120."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    global CARD
    CARD = read_card()
    print(CARD)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    results = kernel_phase(dev)
    train_kernel_phase(dev, results)
    dropout_phase(dev, results)
    adamw_phase(dev, results)
    head_dim_phase(dev, results)
    print(f"kernel phase: {time.perf_counter() - t0:.1f} s (builds "
          f"included) [{CARD}]")
    print(json.dumps({"kernels": list(results.values())}))
    return 0


def ln_bwd_bound(rows: int, c: int):
    """LN+GELU backward: x and dy read, dx written (bf16), scale and bias
    read, dscale and dbias written (fp32); ~30 fp32 operations an element
    (the statistics again, GELU', the two row means, the dx epilogue, two
    column sums)."""
    n = rows * c
    return bound(3 * n * 2 + 4 * c * 4, 30 * n, FP32_FLOP_PER_S)


def _bias_with_tails(lengths, t, dev):
    return torch.where(torch.arange(t, device=dev)[None, :]
                       < lengths[:, None], 0.0, -1e30).to(torch.float32)


def _grad_ms(out, inputs, g) -> float:
    """Device time of one backward through `out`'s graph (kept alive)."""
    return device_ms(lambda: torch.autograd.grad(out, inputs, g,
                                                 retain_graph=True))


def stride_phase(dev, gen, hold, grads, seed: int) -> None:
    """A gang's attention shard: batch rows 3-10 and heads 8-15 of an
    (11, 16) grid (a data rank's rows, a tensor-parallel rank's heads) at
    T = 249, rate 0.1, through both kernels with the seed of the shard's
    first (batch, head) and the global head count as the seed stride,
    against the plain version with the same offsets; the plain mask is
    the global mask's slice, and the default stride, wrong for a shard,
    gives another output."""
    from wav2vec_contr_loss_torch.ops import attention
    from wav2vec_contr_loss_torch.ops.dropout import attention_dropout_mask

    b, h, t, d, b0, h0, heads = 8, 8, 249, 64, 3, 8, 16
    q, k, v, g = (torch.randn(b, h, t, d, generator=gen, device=dev)
                  for _ in range(4))
    q = (q * d ** -0.5).to(torch.bfloat16)
    k, v, g = (x.to(torch.bfloat16) for x in (k, v, g))
    lengths = torch.full((b,), t, device=dev)
    lengths[2] = 150
    bias = _bias_with_tails(lengths, t, dev)
    first = seed + b0 * heads + h0
    mask = attention_dropout_mask(b, h, t, first, 0.1, dev, heads)
    glob = attention_dropout_mask(b0 + b, heads, t, seed, 0.1, dev)
    part = glob[b0:, h0:]
    dropped = (int((mask == 0).sum()), int((part == 0).sum()))
    print(f"attention shard (8,8,249,64) of (11,16): mask is the global "
          f"slice: {torch.equal(mask, part)}; dropped {dropped[0]} of "
          f"{mask.numel()} (slice {dropped[1]})")
    if not torch.equal(mask, part):
        raise RuntimeError("the seed-stride mask is not the global slice")
    out, got, _ = grads(attention.fused_attention, q, k, v, g, bias, first,
                        0.1, h, heads)
    out_p, want, _ = grads(attention.fused_attention_plain, q, k, v, g,
                           bias, first, 0.1, heads)
    torch.cuda.synchronize()
    e = (out.float() - out_p.float()).abs().max().item()
    print(f"attention_fwd shard seed stride {heads} max_abs_err={e:.3e} "
          f"(tolerance {ATT_FWD_TOL})")
    torch.testing.assert_close(out.float(), out_p.float(), **ATT_FWD_TOL)
    hold(f"shard seed stride {heads} {(b, h, t, d)}", got, want)
    wrong = attention.fused_attention(q, k, v, bias, first, 0.1, h)
    e_wrong = (wrong.float() - out_p.float()).abs().max().item()
    print(f"attention_fwd shard with the default stride: max_abs_err "
          f"{e_wrong:.3e} against the shard's plain version")
    if e_wrong <= ATT_FWD_TOL["atol"] * 10:
        raise RuntimeError("the kernel ignored the seed stride")


def train_kernel_phase(dev, results) -> None:
    """The kernels of the training step at its shapes: attention with
    dropout, forward and backward; LN+GELU backward; SupCon."""
    from wav2vec_contr_loss_torch.config import SupConConfig
    from wav2vec_contr_loss_torch.losses import supcon_binary_loss
    from wav2vec_contr_loss_torch.ops import attention, conv_ln, supcon

    gen = torch.Generator(device=dev).manual_seed(1)
    F = torch.nn.functional

    # attention at the training shape: padded tails, one fully masked clip
    b, h, t, d = TRAIN_BATCH, 16, 249, 64
    lengths = torch.full((b,), t, device=dev)
    lengths[1], lengths[5], lengths[9], lengths[30] = 200, 120, 10, 0
    bias = _bias_with_tails(lengths, t, dev)
    q, k, v, g = (torch.randn(b, h, t, d, generator=gen, device=dev)
                  for _ in range(4))
    q = (q * d ** -0.5).to(torch.bfloat16)
    k, v, g = (x.to(torch.bfloat16) for x in (k, v, g))
    seed = 123456789
    err = 0.0
    for rate in (0.0, 0.1):
        got = attention.fused_attention(q, k, v, bias, seed, rate, h)
        want = attention.fused_attention_plain(q, k, v, bias, seed, rate)
        torch.cuda.synchronize()
        e = (got.float() - want.float()).abs().max().item()
        print(f"attention_fwd rate {rate} {tuple(q.shape)} max_abs_err="
              f"{e:.3e} (tolerance {ATT_FWD_TOL}: the same mask on both "
              f"sides, so the rate-0 one)")
        torch.testing.assert_close(got.float(), want.float(), **ATT_FWD_TOL)
        err = max(err, e)
    # the (B, H, T, D) views of (B, T, H, D) tensors that the model passes
    # give the same bits as contiguous copies
    qv, kv, vv = (x.transpose(1, 2).contiguous().transpose(1, 2)
                  for x in (q, k, v))
    if not torch.equal(attention.fused_attention(qv, kv, vv, bias, seed, 0.1,
                                                 h), got):
        raise RuntimeError("attention_fwd differs on strided views")
    results["attention_fwd"]["max_abs_err"] = max(
        results["attention_fwd"]["max_abs_err"], err)
    sdpa_ctx, sdpa_name = sdpa_backend()
    mask16 = bias[:, None, None, :].to(torch.bfloat16)
    ms_drop = device_ms(lambda: attention.fused_attention(q, k, v, bias, seed,
                                                          0.1, h))
    ms_nodrop = device_ms(lambda: attention.fused_attention(q, k, v, bias, 0,
                                                            0.0, h))
    # inputs that need gradients: the forward also writes the backward's
    # residuals (the remat recompute of a train step runs this one)
    qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
    ms_resid = device_ms(lambda: attention.fused_attention(qr, kr, vr, bias,
                                                           seed, 0.1, h))
    with sdpa_ctx():
        sdpa_fwd = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask16, scale=1.0))
    train_bound, _ = bound(4 * q.numel() * 2 + b * t * 4,
                           4 * b * h * t * t * d, BF16_FLOP_PER_S)
    print(f"attention_fwd {tuple(q.shape)} device time: rate 0.1 "
          f"{ms_drop:.4f} ms ({ms_resid:.4f} ms writing the backward's "
          f"residuals), rate 0 {ms_nodrop:.4f} ms, SDPA on {sdpa_name} "
          f"{sdpa_fwd:.4f} ms, bound {train_bound:.4f} ms")
    results["attention_fwd"].update(
        train_shape_ms=ms_drop, train_shape_resid_ms=ms_resid,
        train_shape_rate0_ms=ms_nodrop,
        train_shape_library_ms=sdpa_fwd, train_shape_bound_ms=train_bound)

    def grads(fn, q, k, v, g, *args):
        """(out, (dq, dk, dv), inputs) of fn(q, k, v, *args) with cotangent g"""
        ins = [x.detach().requires_grad_() for x in (q, k, v)]
        out = fn(*ins, *args)
        return out, torch.autograd.grad(out, ins, g, retain_graph=True), ins

    bwd_err = 0.0

    def hold(label, got, want):
        nonlocal bwd_err
        torch.cuda.synchronize()
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            e = (a.float() - w.float()).abs().max().item()
            bwd_err = max(bwd_err, e)
            print(f"attention_bwd {label} {name} max_abs_err={e:.3e} "
                  f"(max |plain| {w.float().abs().max().item():.3e}, "
                  f"tolerance {ATT_BWD_TOL})")
            torch.testing.assert_close(a.float(), w.float(), **ATT_BWD_TOL)

    for rate in (0.0, 0.1):
        out, got, ins = grads(attention.fused_attention, q, k, v, g, bias,
                              seed, rate, h)
        out_p, want, ins_p = grads(attention.fused_attention_plain, q, k, v,
                                   g, bias, seed, rate)
        hold(f"rate {rate} {tuple(q.shape)}", got, want)
        if rate > 0.0:
            again = torch.autograd.grad(out, ins, g, retain_graph=True)
            same = [torch.equal(a, b_) for a, b_ in zip(got, again)]
            print(f"attention_bwd: two calls bitwise equal (dq, dk, dv): "
                  f"{same}")
            if not all(same):
                raise RuntimeError("attention_bwd is not deterministic")
            ms = _grad_ms(out, ins, g)
            plain_ms = _grad_ms(out_p, ins_p, g)
    # the serving shape with its clip of no valid frame, and T past the
    # earlier kernels' caps
    eb, eh, et = BATCH, h, t
    sl = torch.tensor([249, 249, 200, 249, 120, 249, 0, 10], device=dev)
    eq, ek, ev, eg = (torch.randn(eb, eh, et, d, generator=gen, device=dev)
                      for _ in range(4))
    eq = (eq * d ** -0.5).to(torch.bfloat16)
    ek, ev, eg = (x.to(torch.bfloat16) for x in (ek, ev, eg))
    for rate in (0.0, 0.1):
        _, got, _ = grads(attention.fused_attention, eq, ek, ev, eg,
                          _bias_with_tails(sl, et, dev), seed, rate, eh)
        _, want, _ = grads(attention.fused_attention_plain, eq, ek, ev, eg,
                           _bias_with_tails(sl, et, dev), seed, rate)
        hold(f"rate {rate} {(eb, eh, et, d)}", got, want)
    for eb, eh, et in ((2, 4, 400), (1, 4, 999)):
        eq, ek, ev, eg = (torch.randn(eb, eh, et, d, generator=gen,
                                      device=dev) for _ in range(4))
        eq = (eq * d ** -0.5).to(torch.bfloat16)
        ek, ev, eg = (x.to(torch.bfloat16) for x in (ek, ev, eg))
        ebias = torch.zeros(eb, et, device=dev)
        ebias[0, et - 37:] = -1e30
        _, got, _ = grads(attention.fused_attention, eq, ek, ev, eg, ebias,
                          seed, 0.1, eh)
        _, want, _ = grads(attention.fused_attention_plain, eq, ek, ev, eg,
                           ebias, seed, 0.1)
        hold(f"rate 0.1 {(eb, eh, et, d)}", got, want)
    stride_phase(dev, gen, hold, grads, seed)
    with sdpa_ctx():
        sdpa, _, ins_l = grads(
            lambda *x: F.scaled_dot_product_attention(
                *x, attn_mask=mask16, dropout_p=0.0, scale=1.0), q, k, v, g)
        lib_ms = _grad_ms(sdpa, ins_l, g)
    n = b * h * t * d
    bound_ms, bound_by = bound(7 * n * 2 + b * t * 4, 5 * 2 * b * h * t * t * d,
                               BF16_FLOP_PER_S)
    results["attention_bwd"] = dict(
        name="attention_bwd", route="cuda",
        source="wav2vec_contr_loss_torch/csrc/attention_bwd.cu",
        replaces="wav2vec_contr_loss_tpu/ops/attention_pallas.py:96",
        max_abs_err=bwd_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=lib_ms, library=f"SDPA {sdpa_name}")
    print(f"attention_bwd {tuple(q.shape)} rate 0.1 device time: kernels "
          f"{ms:.4f} ms, plain autograd {plain_ms:.4f} ms, SDPA backward on "
          f"{sdpa_name} {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")

    # LN+GELU backward at the rows of each conv of the train step and at
    # a ragged count, with GELU and without
    c = 512
    scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)
    shift = 0.1 * torch.randn(c, generator=gen, device=dev)
    rows_main = TRAIN_BATCH * TRAIN_CONV_FRAMES[0]
    dx_err = 0.0
    step_ms, step_bound = [], []
    for rows in [TRAIN_BATCH * f for f in TRAIN_CONV_FRAMES] + [12347]:
        x = (2.0 * torch.randn(rows, c, generator=gen, device=dev)
             ).to(torch.bfloat16)
        dy = torch.randn(rows, c, generator=gen, device=dev
                         ).to(torch.bfloat16)
        for gelu in (True, False):
            ins = [a.detach().requires_grad_() for a in (x, scale, shift)]
            out = conv_ln.fused_ln_gelu(*ins, 1e-5, gelu)
            got = torch.autograd.grad(out, ins, dy, retain_graph=True)
            ins_p = [a.detach().requires_grad_() for a in (x, scale, shift)]
            out_p = conv_ln.fused_ln_gelu_plain(*ins_p, 1e-5, gelu)
            want = torch.autograd.grad(out_p, ins_p, dy, retain_graph=True)
            torch.cuda.synchronize()
            # the forward at the rows the train step gives it
            e = (out.float() - out_p.float()).abs().max().item()
            print(f"ln_gelu_fwd rows={rows} gelu={gelu} max_abs_err={e:.3e} "
                  f"(tolerance {LN_FWD_TOL})")
            torch.testing.assert_close(out.float(), out_p.float(),
                                       **LN_FWD_TOL)
            results["ln_gelu_fwd"]["max_abs_err"] = max(
                results["ln_gelu_fwd"]["max_abs_err"], e)
            for name, a, w, tol in zip(("dx", "dscale", "dbias"), got, want,
                                       (LN_DX_TOL, LN_DPARAM_TOL,
                                        LN_DPARAM_TOL)):
                e = (a.float() - w.float()).abs().max().item()
                if name == "dx":
                    dx_err = max(dx_err, e)
                print(f"ln_gelu_bwd rows={rows} gelu={gelu} {name} "
                      f"max_abs_err={e:.3e} (max |plain| "
                      f"{w.float().abs().max().item():.3e}, tolerance {tol})")
                torch.testing.assert_close(a.float(), w.float(), **tol)
            again = torch.autograd.grad(out, ins, dy, retain_graph=True)
            if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
                raise RuntimeError(f"ln_gelu_bwd rows={rows} gelu={gelu}: "
                                   f"two calls differ")
            if not gelu or rows == 12347:
                continue
            # each conv's backward as the train step runs it
            step_ms.append(_grad_ms(out, ins, dy))
            step_bound.append(ln_bwd_bound(rows, c)[0])
            if rows == rows_main:
                ms = step_ms[-1]
                plain_ms = _grad_ms(out_p, ins_p, dy)
                ins_l = [a.detach().requires_grad_() for a in (x, scale, shift)]
                lib = F.gelu(F.layer_norm(ins_l[0], (c,), ins_l[1].to(
                    torch.bfloat16), ins_l[2].to(torch.bfloat16), 1e-5))
                lib_ms = _grad_ms(lib, ins_l, dy)
    print("ln_gelu_bwd: two calls bitwise equal (dx, dscale, dbias) at every "
          "row count, gelu on and off")
    bound_ms, bound_by = ln_bwd_bound(rows_main, c)
    results["ln_gelu_bwd"] = dict(
        name="ln_gelu_bwd", route="cuda",
        source="wav2vec_contr_loss_torch/csrc/ln_gelu_bwd.cu",
        replaces="wav2vec_contr_loss_tpu/ops/conv_ln_pallas.py:69",
        max_abs_err=dx_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=lib_ms,
        train_step_ms=sum(step_ms), train_step_bound_ms=sum(step_bound))
    print(f"ln_gelu_bwd ({rows_main},{c}) bf16 gelu: kernel {ms:.4f} ms, "
          f"plain autograd {plain_ms:.4f} ms, F.layer_norm+F.gelu backward "
          f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) [{CARD}]")
    print(f"ln_gelu_bwd the train step's 7 convs "
          f"({', '.join(str(TRAIN_BATCH * f) for f in TRAIN_CONV_FRAMES)} "
          f"rows): " + ", ".join(f"{t:.4f}" for t in step_ms)
          + f" ms; sum {sum(step_ms):.4f} ms against a bound of "
          f"{sum(step_bound):.4f} ms [{CARD}]")

    # SupCon at the training shape, the edge batches, and batches past
    # the earlier kernel's cap of 128 up to 4096
    def normed(bz, dz):
        z = torch.randn(bz, dz, generator=gen, device=dev)
        return z / z.norm(dim=1, keepdim=True)

    def imbalanced(bz):
        """one bonafide (1) in five"""
        return (torch.arange(bz, device=dev) % 5 == 0).long()

    half = torch.tensor([1, 0] * (TRAIN_BATCH // 2), device=dev)
    geo_uni = SupConConfig(temperature=0.07, similarity="geodesic",
                           uniformity_weight=0.1)
    cases = [
        ("B=32 cosine", normed(TRAIN_BATCH, 256), half, 1.0, SupConConfig()),
        ("B=32 alpha 0.3 topk 4", normed(TRAIN_BATCH, 256), half, 0.3,
         SupConConfig(topk_neg=4)),
        ("no positives", normed(8, 256), torch.arange(8, device=dev), 0.5,
         SupConConfig()),
        ("all one label", normed(8, 256), torch.ones(8, device=dev,
                                                     dtype=torch.long), 0.5,
         SupConConfig(uniformity_weight=0.05)),
        ("B <= topk", normed(8, 256), half[:8], 0.7, SupConConfig()),
        ("geodesic + uniformity 0.1", normed(TRAIN_BATCH, 256), half, 0.4,
         geo_uni),
        ("B=128 balanced", normed(128, 256), torch.arange(128, device=dev) % 2,
         0.5, SupConConfig()),
        ("B=129 imbalanced", normed(129, 256), imbalanced(129), 0.5,
         SupConConfig()),
        ("B=1024 imbalanced", normed(1024, 256), imbalanced(1024), 1.0,
         SupConConfig()),
        ("B=4096 balanced, geodesic + uniformity 0.1", normed(4096, 256),
         torch.arange(4096, device=dev) % 2, 0.4, geo_uni),
    ]
    err = 0.0
    for name, z, labels, alpha, cfg in cases:
        zk = z.detach().requires_grad_()
        ak = torch.tensor(alpha, device=dev, requires_grad=True)
        loss = supcon.supcon_binary_loss_fused(zk, labels, ak, cfg)
        gz, ga = torch.autograd.grad(loss, (zk, ak))
        zp = z.detach().requires_grad_()
        ap = torch.tensor(alpha, device=dev, requires_grad=True)
        loss_p = supcon_binary_loss(zp, labels, ap, cfg)
        gzp, gap = torch.autograd.grad(loss_p, (zp, ap))
        # two calls, the same bits
        zk2 = z.detach().requires_grad_()
        loss2 = supcon.supcon_binary_loss_fused(zk2, labels, alpha, cfg)
        gz2, = torch.autograd.grad(loss2, zk2)
        torch.cuda.synchronize()
        e = (gz - gzp).abs().max().item()
        err = max(err, e, abs(loss.item() - loss_p.item()))
        print(f"supcon {name}: loss {loss.item():.6f} vs {loss_p.item():.6f}"
              f", dz max_abs_err={e:.3e} (max |plain| "
              f"{gzp.abs().max().item():.3e}), dalpha {ga.item():.6f} vs "
              f"{gap.item():.6f} (tolerances: loss {SUPCON_LOSS_TOL}, "
              f"dz and dalpha {SUPCON_GRAD_TOL})")
        torch.testing.assert_close(loss, loss_p, **SUPCON_LOSS_TOL)
        torch.testing.assert_close(gz, gzp, **SUPCON_GRAD_TOL)
        torch.testing.assert_close(ga, gap, **SUPCON_GRAD_TOL)
        if not (torch.equal(loss, loss2) and torch.equal(gz, gz2)):
            raise RuntimeError(f"supcon {name}: two calls differ")
    print("supcon: two calls bitwise equal (loss, dz) in every case")

    # the wrapper and its backward make no host-device synchronisation,
    # with a Python alpha as the trainer passes it
    z, labels = cases[0][1], cases[0][2]
    cfg = SupConConfig()
    zk = z.detach().requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = supcon.supcon_binary_loss_fused(zk, labels, 1.0, cfg)
        gz, = torch.autograd.grad(loss, zk)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("supcon: forward and backward ran under "
          "torch.cuda.set_sync_debug_mode('error') with alpha = 1.0")

    def timings(z, labels):
        alpha_dev = torch.tensor(1.0, device=dev)

        def fused():
            zk = z.detach().requires_grad_()
            torch.autograd.grad(supcon.supcon_binary_loss_fused(
                zk, labels, 1.0, cfg), zk)

        def plain():   # alpha on the device: no copy from the host
            zp = z.detach().requires_grad_()
            torch.autograd.grad(supcon_binary_loss(zp, labels, alpha_dev,
                                                   cfg), zp)

        bz, dz = z.shape
        # the plain version's ~90 operations a call take the host long
        # enough that 20 of them would outlast the sleeping kernel.
        # Bound: z read and dz written in fp32, the int64 labels read; two
        # B x B x D products, the Gram and A z (fp32, no TF32)
        return (device_ms(fused), device_ms(plain, iters=5),
                *bound(2 * bz * dz * 4 + bz * 8, 2 * 2 * bz * bz * dz,
                       FP32_FLOP_PER_S))

    ms, plain_ms, bound_ms, bound_by = timings(z, labels)
    # the two kernels alone, without the alpha fill and the backward's
    # scaling
    alpha_dev = torch.tensor(1.0, device=dev)
    kernels_ms = device_ms(lambda: supcon._launch(z, labels, alpha_dev, cfg))
    big = cases[8]
    ms_1k, plain_1k, bound_1k, by_1k = timings(big[1], big[2])
    results["supcon"] = dict(
        name="supcon", route="cuda",
        source="wav2vec_contr_loss_torch/csrc/supcon.cu",
        replaces="wav2vec_contr_loss_tpu/ops/supcon_pallas.py:44",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None, kernels_only_ms=kernels_ms,
        b1024_ms=ms_1k,
        b1024_plain_ms=plain_1k, b1024_bound_ms=bound_1k)
    print(f"supcon (32,256) fp32, loss+dz+dalpha and backward, device time: "
          f"wrapper and backward {ms:.4f} ms (the two kernels alone "
          f"{kernels_ms:.4f} ms), plain autograd {plain_ms:.4f} ms, bound "
          f"{bound_ms:.6f} ms ({bound_by}); no single PyTorch call computes "
          f"it [{CARD}]")
    print(f"supcon (1024,256): wrapper and backward {ms_1k:.4f} ms, plain "
          f"autograd "
          f"{plain_1k:.4f} ms, bound {bound_1k:.4f} ms ({by_1k}) [{CARD}]")


@functools.cache
def xlsr_weights():
    """XLS-R-300M state dicts (encoder, compression, linear head) from
    the seed-0 random trees, built once a process."""
    from wav2vec_contr_loss_torch import XLSR_300M, jax_params_to_torch

    return jax_params_to_torch(XLSR_300M,
                               *random_jax_trees(XLSR_300M, seed=0))


def serve_phase(dev, results) -> None:
    from wav2vec_contr_loss_torch import XLSR_300M, SpoofScorer, Stage2Config
    from wav2vec_contr_loss_torch.ops import attention, conv_ln

    cfg = XLSR_300M
    t0 = time.perf_counter()
    weights = xlsr_weights()
    scorer = SpoofScorer(cfg, weights, Stage2Config(), device=dev)
    n_params = sum(p.numel() for p in scorer.encoder.parameters())
    print(f"serve: XLS-R-300M encoder, {n_params} params, bf16 compute, "
          f"built from the bridge in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(1)
    waves = serving_waves(rng, N_BATCHES)
    long_clips = [rng.normal(0, 0.1, n).astype(np.float32)
                  for n in (7 * 16000, 12 * 16000, 3 * 16000)]
    n_windows = 2 + 4 + 1          # hop 2.5 s: one padded batch of 8

    attention.launches = 0
    conv_ln.launches = 0
    logits = [scorer.score_waveforms(w) for w in waves]
    long_logits = scorer.score_long_waveforms(long_clips)
    torch.cuda.synchronize()
    n_attn, n_ln = attention.launches, conv_ln.launches
    served = N_BATCHES + -(-n_windows // BATCH)
    print(f"serve: {served} batches -> attention launches {n_attn}, "
          f"LN+GELU launches {n_ln}")
    if n_attn != cfg.num_layers * served or n_ln != 7 * served:
        raise RuntimeError(f"expected {cfg.num_layers * served} attention "
                           f"and {7 * served} LN+GELU launches")
    results["attention_fwd"]["launches"] = n_attn
    results["ln_gelu_fwd"]["launches"] = n_ln
    logits = np.stack(logits)
    if not (np.isfinite(logits).all() and np.isfinite(long_logits).all()):
        raise RuntimeError("non-finite logits")
    if logits.shape != (N_BATCHES, BATCH) or long_logits.shape != (3,):
        raise RuntimeError(f"logit shapes {logits.shape} {long_logits.shape}")
    print(f"serve: logits batch 0 {np.array2string(logits[0], precision=4)}")
    print(f"serve: long-clip logits {np.array2string(long_logits, precision=4)}")

    # 2 clips (one full, one padded) against the fp32 model on the CPU
    cpu = SpoofScorer(cfg.with_(dtype="float32"), weights, Stage2Config(),
                      device="cpu")
    t0 = time.perf_counter()
    z_cpu, l_cpu = cpu.run(torch.from_numpy(waves[0, :2]))
    cpu_s = time.perf_counter() - t0
    z_gpu, l_gpu = scorer.run(torch.from_numpy(waves[0]))
    z_err = (z_gpu[:2].cpu() - z_cpu).abs().max().item()
    l_err = (l_gpu[:2].cpu() - l_cpu).abs().max().item()
    print(f"serve vs CPU fp32 ({cpu_s:.1f} s on the CPU): z max_abs_err "
          f"{z_err:.3e} (tol {Z_TOL}), logit max_abs_err {l_err:.3e} "
          f"(tol {LOGIT_TOL}); logits gpu {l_gpu[:2].tolist()} cpu "
          f"{l_cpu.tolist()}")
    if not (z_err <= Z_TOL and l_err <= LOGIT_TOL):
        raise RuntimeError("GPU bf16 serving disagrees with the CPU fp32 run")

    ms, p90 = closed_loop_ms(scorer.score_waveforms, waves)
    print(f"serve: {ms:.2f} ms per batch of {BATCH} x 5 s (closed loop, "
          f"median of 30, p90 {p90:.2f}), {1e3 * BATCH / ms:.1f} clips/s, "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_serving(scorer.score_waveforms, waves)


def profile_serving(score, waves, label: str = "profile",
                    n: int = 3) -> dict:
    """Device time by kernel over n batches of `score(batch)` under
    torch.profiler, against the wall time of the same window (the
    profiler's own host cost is in that wall time, so the busy share it
    gives is a lower bound). -> {'busy_ms', 'ops'} a batch."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for w in waves[:n]:
            score(w)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms_n = by_name.setdefault(e.name, [0.0, 0])
            ms_n[0] += e.time_range.elapsed_us() / (1e3 * n)
            ms_n[1] += 1
    if not by_name:
        print(f"{label}: the profiler recorded no device activity")
        return {"busy_ms": None, "ops": None}
    busy = sum(v[0] for v in by_name.values())
    ops = sum(v[1] for v in by_name.values()) // n
    print(f"{label}: per batch, wall {wall_ms:.2f} ms (profiler on), device "
          f"busy {busy:.2f} ms ({100 * busy / wall_ms:.1f} %), {ops} device "
          f"ops")
    for name, (ms_b, count) in sorted(by_name.items(),
                                      key=lambda kv: -kv[1][0])[:12]:
        print(f"{label}:   {ms_b:8.3f} ms  x{count // n:<4d} {name[:90]}")
    return {"busy_ms": busy, "ops": ops}


def closed_loop_ms(score, waves, n: int = 30):
    """(median, p90) ms of `score(batch)` over n closed-loop batches, each
    ended by a host read of its result, after a warm-up batch; the peak
    device memory is reset first."""
    score(waves[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        score(waves[i % len(waves)])
        times.append(time.perf_counter() - t0)
    return tuple(1e3 * float(x) for x in np.percentile(times, [50, 90]))


def train_batch(rng, n: int, samples: int = SAMPLES):
    """(n, samples) float32 clips, half bonafide (1) and half spoof (0),
    two of them zero-padded."""
    w = rng.normal(0, 0.1, (n, samples)).astype(np.float32)
    w[1, 60000 * samples // SAMPLES:] = 0.0
    w[-2, 30000 * samples // SAMPLES:] = 0.0
    labels = np.array([1, 0] * (n // 2), np.int64)
    return {"waveforms": w, "labels": labels}


def expected_train_launches(scfg, cfg, supcon: int = 1) -> dict:
    """Kernel launches of one finetune step, from the config (a
    Stage1Config, or a BaselineConfig with `supcon=0`: its loss is a BCE
    head): the remat recompute runs each layer's forward (and so its
    attention) again in the backward, and `remat_conv` the conv tower's
    LN+GELU."""
    n_conv = len(cfg.conv_dim)
    frozen = getattr(scfg, "freeze_feature_extractor", False)
    remat_conv = getattr(scfg, "remat_conv", False)
    return {
        "attention_fwd": cfg.num_layers * (2 if scfg.remat_encoder else 1),
        "attention_bwd": cfg.num_layers,
        "ln_gelu_fwd": n_conv * (2 if remat_conv and not frozen else 1),
        "ln_gelu_bwd": 0 if frozen else n_conv,
        "supcon": supcon,
    }


def _counters():
    from wav2vec_contr_loss_torch.parallel.mp_smoke import launch_counts

    return launch_counts()


def _reset_counters() -> None:
    from wav2vec_contr_loss_torch.ops import attention, conv_ln, supcon

    attention.launches = attention.bwd_launches = 0
    attention.head_dim_launches.clear()
    attention.head_dim_bwd_launches.clear()
    conv_ln.launches = conv_ln.bwd_launches = 0
    supcon.launches = 0


def train_phase(dev, results):
    from wav2vec_contr_loss_torch import XLSR_300M, Stage1Config, Stage1Trainer
    from wav2vec_contr_loss_torch.ops import dropout
    from wav2vec_contr_loss_torch.train import optim

    cfg = XLSR_300M
    scfg = Stage1Config(finetune_encoder=True, use_rawboost=False)
    t0 = time.perf_counter()
    weights = xlsr_weights()
    trainer = Stage1Trainer(scfg, cfg, weights, device=dev)
    print(f"train: XLS-R-300M finetune, B={scfg.batch_size} x 5 s, "
          f"{scfg.compute_dtype}, remat_encoder={scfg.remat_encoder}, "
          f"dropout on, SpecAugment on, adam mu/nu {scfg.adam_mu_dtype}/"
          f"{scfg.adam_nu_dtype}; built in {time.perf_counter() - t0:.1f} s")
    batch = train_batch(np.random.default_rng(2), scfg.batch_size)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    drops = (dropout.launches, dropout.bwd_launches)
    opt = (optim.launches, optim.tensors)
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = trainer.train_step(batch, 1.0)["loss"].item()  # syncs
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    counts = _counters()
    drops = (dropout.launches - drops[0], dropout.bwd_launches - drops[1])
    print(f"train: murmur dropout launches over {TRAIN_STEPS} steps: "
          f"{drops[0]} forward and recompute, {drops[1]} backward")
    if drops[1] != TRAIN_STEPS * (3 + 2 * cfg.num_layers):
        raise RuntimeError("a dropout site of the step ran no backward "
                           "kernel")
    results["murmur_dropout"]["train_launches"] = drops
    opt = (optim.launches - opt[0], optim.tensors - opt[1])
    tables = optimizer_tables(trainer.optimizer)
    n_params = len(trainer.optimizer.parameters())
    print(f"train: AdamW kernel over {TRAIN_STEPS} steps: optim.launches "
          f"{opt[0]}, optim.tensors {opt[1]} ({tables} launches and "
          f"{n_params} tensors a step)")
    if opt != (TRAIN_STEPS * tables, TRAIN_STEPS * n_params):
        raise RuntimeError("the optimizer did not update every parameter "
                           "through its tables' launches")
    results["adamw"]["train_launches"] = opt[0]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"train: losses {[round(x, 5) for x in losses]}")
    want = {k: v * TRAIN_STEPS
            for k, v in expected_train_launches(scfg, cfg).items()}
    print(f"train: launches over {TRAIN_STEPS} steps {counts}, expected "
          f"{want}")
    if counts != want:
        raise RuntimeError("train-step launch counts differ from the config")
    for name, n in counts.items():
        key = "train_launches" if name in ("attention_fwd",
                                           "ln_gelu_fwd") else "launches"
        results[name][key] = n
    if not np.isfinite(losses).all():
        raise RuntimeError("non-finite training loss")
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    print(f"train: mean loss of the first 3 steps {first:.5f}, of the "
          f"last 3 {last:.5f}")
    if not last < first:
        raise RuntimeError("the loss did not fall over the fixed batch")
    ms = 1e3 * float(np.median(times[1:]))
    print(f"train: step {ms:.1f} ms (median of steps 2-{TRAIN_STEPS}, host "
          f"clock to the loss on the host; step 1 {1e3 * times[0]:.1f} ms), "
          f"{1e3 * scfg.batch_size / ms:.1f} clips/s, peak device memory "
          f"{peak:.2f} GiB")
    return profile_step(lambda: trainer.train_step(batch, 1.0))


def profile_step(step):
    """Device time by kernel over one train step, `step()` -> its metrics
    dict, under torch.profiler. -> (device busy ms, device operations)
    of the step."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()["loss"].item()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms_n = by_name.setdefault(e.name, [0.0, 0])
            ms_n[0] += e.time_range.elapsed_us() / 1e3
            ms_n[1] += 1
    if not by_name:
        print("profile: the profiler recorded no device activity")
        return None, None
    busy = sum(v[0] for v in by_name.values())
    n_ops = sum(v[1] for v in by_name.values())
    print(f"profile: one train step, wall {wall_ms:.1f} ms (profiler on), "
          f"device busy {busy:.1f} ms ({100 * busy / wall_ms:.1f} %), "
          f"{n_ops} device ops [{CARD}]")
    for name, (ms_b, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:16]:
        print(f"profile:   {ms_b:8.2f} ms  x{n:<5d} {name[:90]}")
    # the port's own kernels in this step, by their names in the trace
    for tag in ("attention_fwd_kernel", "attention_dq_kernel",
                "attention_dkdv_kernel", "attention_fwd_f32_kernel",
                "attention_dq_f32_kernel", "attention_dkdv_f32_kernel",
                "_ln_gelu_fwd", "ln_gelu_bwd_kernel",
                "ln_gelu_sum_partials", "supcon_rows_kernel",
                "supcon_dz_kernel"):
        hits = [v for k, v in by_name.items() if tag in k]
        print(f"profile: port kernel {tag}: "
              f"{sum(v[0] for v in hits):.3f} ms in "
              f"{sum(v[1] for v in hits)} launches")
    return busy, n_ops


def step_vs_cpu(dev) -> None:
    """One train step at 2 layers and full width, B=4: bf16 on the card
    against fp32 on the CPU. First with every dropout and SpecAugment off;
    then with them on and the conv tower under remat too: the trainer
    draws its seeds and uniforms from one CPU generator and the masks
    hash only seeds and positions, so both sides drop the same elements
    and the remat recompute on the card must reproduce them."""
    from wav2vec_contr_loss_torch import (XLSR_300M, Stage1Config,
                                          Stage1Trainer, jax_params_to_torch)

    off = dict(hidden_dropout=0.0, attention_dropout=0.0,
               activation_dropout=0.0, feat_proj_dropout=0.0,
               apply_spec_augment=False)
    batch = train_batch(np.random.default_rng(4), 4)
    cases = (("dropout off", XLSR_300M.with_(num_layers=2, **off),
              dict(dropout=0.0)),
             ("dropout and SpecAugment on, remat_conv",
              XLSR_300M.with_(num_layers=2, mask_time_prob=0.2,
                              mask_time_length=5),
              dict(remat_conv=True)))
    failed = []
    for case, cfg, extra in cases:
        weights = jax_params_to_torch(cfg, *random_jax_trees(cfg, seed=3))
        kw = dict(finetune_encoder=True, use_rawboost=False, batch_size=4,
                  **extra)
        out = {}
        for name, device, dtype in (("gpu", dev, "bfloat16"),
                                    ("cpu", "cpu", "float32")):
            t0 = time.perf_counter()
            tr = Stage1Trainer(Stage1Config(compute_dtype=dtype, **kw), cfg,
                               weights, device=device)
            loss = tr.train_step(batch, 0.5)["loss"].item()
            params = dict(tr.encoder.named_parameters(prefix="encoder"))
            params["proj"] = tr.compression.proj.weight
            grads = {k: params[k].grad.detach().float().cpu()
                     for k in ("proj",) + STEP_ENC_GRADS}
            out[name] = (loss, grads, time.perf_counter() - t0)
        (lg, gg, _), (lc, gc, cpu_s) = out["gpu"], out["cpu"]
        print(f"train step vs CPU fp32, {case} ({cpu_s:.1f} s on the CPU): "
              f"loss gpu {lg:.6f} cpu {lc:.6f} (|d| {abs(lg - lc):.3e}, tol "
              f"{STEP_LOSS_TOL})")
        if not abs(lg - lc) <= STEP_LOSS_TOL:
            failed.append(f"{case}: loss")
        for key, a in gg.items():
            w = gc[key]
            cos = torch.nn.functional.cosine_similarity(
                a.flatten(), w.flatten(), dim=0).item()
            ratio = (a.norm() / w.norm()).item()
            cos_tol = STEP_GRAD_COS if key == "proj" else STEP_ENC_COS
            norm_ok = key == "proj" or abs(ratio - 1.0) <= STEP_ENC_NORM
            print(f"  grad {key}: cosine {cos:.6f} (tol >= {cos_tol}), norm "
                  f"gpu/cpu {ratio:.6f}"
                  + ("" if key == "proj" else f" (tol 1 +- {STEP_ENC_NORM})")
                  + f", max_abs_err {(a - w).abs().max().item():.3e} (max "
                  f"|cpu| {w.abs().max().item():.3e})")
            if not (cos >= cos_tol and norm_ok):
                failed.append(f"{case}: {key}")
    if failed:
        raise RuntimeError(f"the GPU bf16 train step disagrees with the CPU "
                           f"fp32 step: {failed}")


# ---- fp32 compute on the card ----------------------------------------
#
# The fp32 phase runs in `main` before the script turns TF32 off, so it
# sees what a user's process sees (PyTorch's defaults: cuBLAS without
# TF32, cuDNN with it), and the CLI leg runs in a child process of its
# own. Its kernels hold fp32 on both sides, so the tolerances are fp32
# rounding, not bf16's.
#
# attention forward and backward: the kernel and the plain version sum
# q . k, p . v, g . v and D in other orders (D is g . out in the kernel,
# sum_j dp p in autograd): ~1e-6 relative; the limit leaves two orders
# for entries of up to ~30 (dq of a clip with 10 valid frames)
ATT32_TOL = dict(atol=1e-4, rtol=1e-4)
# LN+GELU forward and dx: per-row fp32 statistics in another order, the
# Triton erf, and the backward's A&S erf (1.5e-7 absolute)
LN32_TOL = dict(atol=1e-5, rtol=1e-5)
# dscale and dbias: sums over up to 511,968 rows, the kernel's per-block
# partial sums against autograd's reduction: ~sqrt(n) x 2^-24 x |sum|,
# ~1e-4 on sums of ~700
LN32_DPARAM_TOL = dict(atol=1e-3, rtol=1e-5)
# the step at 2 layers, fp32 on the card against fp32 on the CPU: the
# same masks and draws on both sides, products summed in other orders
STEP32_LOSS_RTOL = 1e-4
STEP32_GRAD_COS = 0.9999         # each parameter group of UPDATE_GROUPS
# the fp32 serving batch against the fp32 CPU run (24 layers)
SERVE32_LOGIT_TOL = 1e-3
# the conv extractor's output, card against CPU, both fp32: fp32
# rounding through 7 convs and LayerNorms is ~1e-6 of outputs of O(1);
# cuDNN in TF32 (10 mantissa bits) lands ~1e-3 away, which this catches
FE32_TOL = 1e-4
FP32_CLI_CLIPS = 16              # the CLI leg's corpus: 2 steps of 8


def fp32_kernel_phase(dev, results) -> None:
    """The four fp32 kernels against their plain versions on the card at
    the training shapes. Attention (32, 16, 249, 64) with padded tails
    and a clip of no valid frame, rates 0 and 0.1: the forward without
    residuals (no gradient: the custom op) and with them, the backward,
    its two calls bit for bit, the (B, T, H, 64) views, a gang shard's
    seed stride; both kernels also at T = 400 and 999 (7 and 16 key
    tiles). LN+GELU at the rows of the step's 7 convs, forward and
    backward, two backward calls bit for bit. Device times of kernel,
    plain version and the nearest PyTorch call (timed only); the
    attention kernels' bounds at 3xTF32 and on FFMA, and their shares."""
    from wav2vec_contr_loss_torch.ops import attention, conv_ln

    gen = torch.Generator(device=dev).manual_seed(13)
    F = torch.nn.functional
    b, h, t, d = TRAIN_BATCH, 16, 249, 64
    lengths = torch.full((b,), t, device=dev)
    lengths[1], lengths[5], lengths[9], lengths[30] = 200, 120, 10, 0
    bias = _bias_with_tails(lengths, t, dev)
    q, k, v, g = (torch.randn(b, h, t, d, generator=gen, device=dev)
                  for _ in range(4))
    q = q * d ** -0.5
    seed = 987654321
    errs = {"fwd": 0.0, "bwd": 0.0}

    def hold(label, kind, got, want, tol):
        torch.cuda.synchronize()
        for name, a, w in zip(("out",) if kind == "fwd" else
                              ("dq", "dk", "dv"), got, want):
            if a.dtype != torch.float32:
                raise RuntimeError(f"{label} {name}: {a.dtype}, not fp32")
            e = (a - w).abs().max().item()
            errs[kind] = max(errs[kind], e)
            print(f"attention_{kind}_f32 {label} {name} max_abs_err={e:.3e} "
                  f"(max |plain| {w.abs().max().item():.3e}, tolerance "
                  f"{tol})")
            torch.testing.assert_close(a, w, **tol)

    def grads(fn, *args):
        ins = [x.detach().requires_grad_() for x in (q, k, v)]
        out = fn(*ins, *args)
        return out, torch.autograd.grad(out, ins, g, retain_graph=True), ins

    for rate in (0.0, 0.1):
        label = f"rate {rate} {(b, h, t, d)}"
        got = attention.fused_attention(q, k, v, bias, seed, rate, h)
        want = attention.fused_attention_plain(q, k, v, bias, seed, rate)
        hold(label + " no residuals", "fwd", (got,), (want,), ATT32_TOL)
        out, dgot, ins = grads(attention.fused_attention, bias, seed, rate,
                               h)
        out_p, dwant, ins_p = grads(attention.fused_attention_plain, bias,
                                    seed, rate)
        hold(label + " with residuals", "fwd", (out,), (out_p,), ATT32_TOL)
        hold(label, "bwd", dgot, dwant, ATT32_TOL)
        if rate > 0.0:
            again = torch.autograd.grad(out, ins, g, retain_graph=True)
            if not all(torch.equal(a, b_) for a, b_ in zip(dgot, again)):
                raise RuntimeError("attention_bwd_f32 is not deterministic")
            print("attention_bwd_f32: two calls bitwise equal (dq, dk, dv)")
            bwd_ms = _grad_ms(out, ins, g)
            bwd_plain_ms = _grad_ms(out_p, ins_p, g)
    qv, kv, vv = (x.transpose(1, 2).contiguous().transpose(1, 2)
                  for x in (q, k, v))
    if not torch.equal(attention.fused_attention(qv, kv, vv, bias, seed, 0.1,
                                                 h), got):
        raise RuntimeError("attention_fwd_f32 differs on strided views")
    # a shard: batch rows 3-10 and heads 8-15 of a (11, 16) grid
    first = seed + 3 * 16 + 8
    sq, sk, sv = (x[3:11, 8:] for x in (q, k, v))
    got = attention.fused_attention(sq, sk, sv, bias[3:11], first, 0.1, 8,
                                    seed_stride=16)
    want = attention.fused_attention_plain(sq, sk, sv, bias[3:11], first,
                                           0.1, 16)
    hold("shard of (11, 16), seed stride 16", "fwd", (got,), (want,),
         ATT32_TOL)
    # many key tiles: T = 400 and 999 with a padded tail, both kernels
    for eb, eh, et in ((2, 4, 400), (1, 4, 999)):
        eq, ek, ev, eg = (torch.randn(eb, eh, et, d, generator=gen,
                                      device=dev) for _ in range(4))
        eq = eq * d ** -0.5
        ebias = torch.zeros(eb, et, device=dev)
        ebias[0, et - 37:] = -1e30
        for rate in (0.0, 0.1):
            label = f"rate {rate} {(eb, eh, et, d)}"
            ins = [x.detach().requires_grad_() for x in (eq, ek, ev)]
            out = attention.fused_attention(*ins, ebias, seed, rate, eh)
            dgot = torch.autograd.grad(out, ins, eg)
            ins_p = [x.detach().requires_grad_() for x in (eq, ek, ev)]
            out_p = attention.fused_attention_plain(*ins_p, ebias, seed,
                                                    rate)
            dwant = torch.autograd.grad(out_p, ins_p, eg)
            nograd = attention.fused_attention(eq, ek, ev, ebias, seed, rate,
                                               eh)
            hold(label + " no residuals", "fwd", (nograd,),
                 (out_p.detach(),), ATT32_TOL)
            hold(label + " with residuals", "fwd", (out.detach(),),
                 (out_p.detach(),), ATT32_TOL)
            hold(label, "bwd", dgot, dwant, ATT32_TOL)

    sdpa_ctx, sdpa_name = sdpa_backend(torch.float32)
    mask = bias[:, None, None, :]
    ms = device_ms(lambda: attention.fused_attention(q, k, v, bias, seed,
                                                     0.1, h))
    ms_rate0 = device_ms(lambda: attention.fused_attention(q, k, v, bias, 0,
                                                           0.0, h))
    qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
    ms_resid = device_ms(lambda: attention.fused_attention(qr, kr, vr, bias,
                                                           seed, 0.1, h))
    # the plain version at rate 0: its mask's scale goes to the card by a
    # blocking copy, which device_ms cannot queue behind its sleep
    plain_ms = device_ms(lambda: attention.fused_attention_plain(
        q, k, v, bias))
    with sdpa_ctx():
        lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=1.0))
        sdpa, dlib, ins_l = grads(lambda *x: F.scaled_dot_product_attention(
            *x, attn_mask=mask, scale=1.0))
        lib_bwd_ms = _grad_ms(sdpa, ins_l, g)
    # SDPA's own distance to the plain version at rate 0, for scale, on
    # the clips with a valid frame (its backward parts from the plain
    # version's on the clip with none)
    out0, dplain0, _ = grads(attention.fused_attention_plain, bias, seed,
                             0.0)
    valid = lengths > 0
    lib_err = {"fwd": (sdpa - out0)[valid].abs().max().item(),
               "bwd": max((a - w)[valid].abs().max().item()
                          for a, w in zip(dlib, dplain0)),
               "bwd_empty_clip": max((a - w)[~valid].abs().max().item()
                                     for a, w in zip(dlib, dplain0))}
    print(f"SDPA on {sdpa_name} fp32 vs the plain version, rate 0, the "
          f"clips with a valid frame: max abs err out {lib_err['fwd']:.3e}, "
          f"gradients {lib_err['bwd']:.3e}; the clip with none: gradients "
          f"{lib_err['bwd_empty_clip']:.3e}")
    n = b * h * t * d
    product = 2 * b * h * t * t * d
    # two bounds for fp32-accurate work: the products on FFMA, and on the
    # tensor cores as three TF32 products each (3xTF32, what the kernels
    # run); bound_ms is the lesser, the 3xTF32 one
    bounds = {}
    for name, nbytes, products in (("fwd", 4 * n * 4 + b * t * 4, 2),
                                   ("bwd", 8 * n * 4 + b * t * 4, 5)):
        bounds[name] = (
            bound(nbytes, 3 * products * product, TF32_FLOP_PER_S),
            bound(nbytes, products * product, FP32_FLOP_PER_S))
    results["attention_fwd_f32"] = dict(
        name="attention_fwd_f32", route="cuda",
        source="wav2vec_contr_loss_torch/csrc/attention_fwd_f32.cu",
        replaces="wav2vec_contr_loss_tpu/ops/attention_pallas.py:83",
        max_abs_err=errs["fwd"], ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, library=f"SDPA {sdpa_name} fp32",
        resid_ms=ms_resid, rate0_ms=ms_rate0)
    results["attention_bwd_f32"] = dict(
        name="attention_bwd_f32", route="cuda",
        source="wav2vec_contr_loss_torch/csrc/attention_bwd_f32.cu",
        replaces="wav2vec_contr_loss_tpu/ops/attention_pallas.py:96",
        max_abs_err=errs["bwd"], ms=bwd_ms, plain_ms=bwd_plain_ms,
        library_ms=lib_bwd_ms, library=f"SDPA {sdpa_name} fp32 backward")
    for name in ("fwd", "bwd"):
        r = results[f"attention_{name}_f32"]
        (tc, tc_by), (ffma, ffma_by) = bounds[name]
        r.update(bound_ms=tc, bound_by=tc_by, tf32x3_bound_ms=tc,
                 library_max_abs_err=lib_err[name],
                 ffma_bound_ms=ffma, ffma_bound_by=ffma_by,
                 tf32x3_share=tc / r["ms"], ffma_share=ffma / r["ms"])
    fr, br = results["attention_fwd_f32"], results["attention_bwd_f32"]
    print(f"attention_fwd_f32 {(b, h, t, d)} device time: rate 0.1 "
          f"{ms:.4f} ms ({ms_resid:.4f} ms writing the backward's "
          f"residuals), rate 0 {ms_rate0:.4f} ms, plain (rate 0) "
          f"{plain_ms:.4f} ms, "
          f"SDPA on {sdpa_name} fp32 {lib_ms:.4f} ms, bound "
          f"{fr['bound_ms']:.4f} ms at 3xTF32 ({fr['bound_by']}; "
          f"{100 * fr['tf32x3_share']:.1f} % of it at rate 0.1), "
          f"{fr['ffma_bound_ms']:.4f} ms on FFMA ({fr['ffma_bound_by']}; "
          f"{100 * fr['ffma_share']:.1f} %) [{CARD}]")
    print(f"attention_bwd_f32 {(b, h, t, d)} rate 0.1 device time: kernels "
          f"{bwd_ms:.4f} ms, plain autograd {bwd_plain_ms:.4f} ms, SDPA "
          f"backward on {sdpa_name} fp32 {lib_bwd_ms:.4f} ms, bound "
          f"{br['bound_ms']:.4f} ms at 3xTF32 ({br['bound_by']}; "
          f"{100 * br['tf32x3_share']:.1f} % of it), "
          f"{br['ffma_bound_ms']:.4f} ms on FFMA ({br['ffma_bound_by']}; "
          f"{100 * br['ffma_share']:.1f} %) [{CARD}]")
    del q, k, v, g, qv, kv, vv, qr, kr, vr, out, out_p, ins, ins_p, sdpa
    del ins_l, dgot, dwant, eq, ek, ev, eg, nograd, dlib, out0, dplain0
    torch.cuda.empty_cache()

    # LN+GELU at the rows of each conv of a step (B = 32 x 5 s)
    c = 512
    scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)
    shift = 0.1 * torch.randn(c, generator=gen, device=dev)
    rows_main = TRAIN_BATCH * TRAIN_CONV_FRAMES[0]
    ln_err = {"fwd": 0.0, "bwd": 0.0}
    for rows in [TRAIN_BATCH * f for f in TRAIN_CONV_FRAMES]:
        x = 2.0 * torch.randn(rows, c, generator=gen, device=dev)
        dy = torch.randn(rows, c, generator=gen, device=dev)
        ins = [a.detach().requires_grad_() for a in (x, scale, shift)]
        out = conv_ln.fused_ln_gelu(*ins, 1e-5, True)
        got = torch.autograd.grad(out, ins, dy, retain_graph=True)
        ins_p = [a.detach().requires_grad_() for a in (x, scale, shift)]
        out_p = conv_ln.fused_ln_gelu_plain(*ins_p, 1e-5, True)
        want = torch.autograd.grad(out_p, ins_p, dy, retain_graph=True)
        nograd = conv_ln.fused_ln_gelu(x, scale, shift, 1e-5, True)
        torch.cuda.synchronize()
        for name, a, w, tol in (
                ("y", out, out_p, LN32_TOL), ("y no grad", nograd, out_p,
                                              LN32_TOL),
                ("dx", got[0], want[0], LN32_TOL),
                ("dscale", got[1], want[1], LN32_DPARAM_TOL),
                ("dbias", got[2], want[2], LN32_DPARAM_TOL)):
            if a.dtype != torch.float32:
                raise RuntimeError(f"ln_gelu {name}: {a.dtype}, not fp32")
            e = (a - w).abs().max().item()
            kind = "fwd" if name.startswith("y") else "bwd"
            if name in ("y", "y no grad", "dx"):
                ln_err[kind] = max(ln_err[kind], e)
            print(f"ln_gelu_{kind}_f32 rows={rows} {name} max_abs_err="
                  f"{e:.3e} (max |plain| {w.abs().max().item():.3e}, "
                  f"tolerance {tol})")
            torch.testing.assert_close(a, w, **tol)
        again = torch.autograd.grad(out, ins, dy, retain_graph=True)
        if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
            raise RuntimeError(f"ln_gelu_bwd_f32 rows={rows}: two calls "
                               f"differ")
        if rows == rows_main:
            fwd_ms = device_ms(lambda: conv_ln.fused_ln_gelu(
                x, scale, shift, 1e-5, True))
            fwd_plain = device_ms(lambda: conv_ln.fused_ln_gelu_plain(
                x, scale, shift, 1e-5, True))
            fwd_lib = device_ms(lambda: F.gelu(F.layer_norm(
                x, (c,), scale, shift, 1e-5)))
            ln_bwd_ms = _grad_ms(out, ins, dy)
            bwd_plain = _grad_ms(out_p, ins_p, dy)
            ins_l = [a.detach().requires_grad_() for a in (x, scale, shift)]
            lib = F.gelu(F.layer_norm(ins_l[0], (c,), ins_l[1], ins_l[2],
                                      1e-5))
            bwd_lib = _grad_ms(lib, ins_l, dy)
            del lib, ins_l
        del x, dy, ins, ins_p, out, out_p, got, want, nograd, again
    torch.cuda.empty_cache()
    print("ln_gelu_bwd_f32: two calls bitwise equal (dx, dscale, dbias) at "
          "every row count")
    n = rows_main * c
    fb, fby = bound(2 * n * 4 + 2 * c * 4, 16 * n, FP32_FLOP_PER_S)
    bb, bby = bound(3 * n * 4 + 4 * c * 4, 30 * n, FP32_FLOP_PER_S)
    results["ln_gelu_fwd_f32"] = dict(
        name="ln_gelu_fwd_f32", route="triton",
        source="wav2vec_contr_loss_torch/ops/conv_ln.py",
        replaces="wav2vec_contr_loss_tpu/ops/conv_ln_pallas.py:58",
        max_abs_err=ln_err["fwd"], ms=fwd_ms, plain_ms=fwd_plain,
        bound_ms=fb, bound_by=fby, library_ms=fwd_lib,
        library="F.layer_norm+F.gelu fp32")
    results["ln_gelu_bwd_f32"] = dict(
        name="ln_gelu_bwd_f32", route="cuda",
        source="wav2vec_contr_loss_torch/csrc/ln_gelu_bwd.cu",
        replaces="wav2vec_contr_loss_tpu/ops/conv_ln_pallas.py:69",
        max_abs_err=ln_err["bwd"], ms=ln_bwd_ms, plain_ms=bwd_plain,
        bound_ms=bb, bound_by=bby, library_ms=bwd_lib,
        library="autograd of F.layer_norm+F.gelu fp32")
    print(f"ln_gelu_fwd_f32 ({rows_main},{c}) gelu: kernel {fwd_ms:.4f} ms, "
          f"plain {fwd_plain:.4f} ms, F.layer_norm+F.gelu {fwd_lib:.4f} ms, "
          f"bound {fb:.4f} ms ({fby}) [{CARD}]")
    print(f"ln_gelu_bwd_f32 ({rows_main},{c}) gelu: kernel {ln_bwd_ms:.4f} "
          f"ms, "
          f"plain autograd {bwd_plain:.4f} ms, F.layer_norm+F.gelu backward "
          f"{bwd_lib:.4f} ms, bound {bb:.4f} ms ({bby}) [{CARD}]")


def fp32_step_config(**kw):
    """The fp32 stage-1 step: the port's Stage1Config defaults with
    finetune_encoder=True, use_rawboost=False and compute_dtype float32
    (dropout 0.1, SpecAugment, remat; grad_dtype 'auto' is fp32)."""
    from wav2vec_contr_loss_torch import Stage1Config

    return Stage1Config(finetune_encoder=True, use_rawboost=False,
                        compute_dtype="float32", **kw)


def fp32_step_phase(dev, results) -> None:
    """The XLS-R-300M stage-1 step in fp32 at B = 32 x 5 s: 8 steps on
    one fixed batch with the counters set to 0 just before and read just
    after (exactly 48/24/7/7/1 launches a step), finite losses that fall,
    the peak memory and the median ms of steps 2-8."""
    from wav2vec_contr_loss_torch import XLSR_300M, Stage1Trainer
    from wav2vec_contr_loss_torch.train.optim import resolve_grad_bf16

    cfg, scfg = XLSR_300M, fp32_step_config()
    t0 = time.perf_counter()
    trainer = Stage1Trainer(scfg, cfg, xlsr_weights(), device=dev)
    if trainer.enc_config.dtype != "float32" or resolve_grad_bf16(scfg):
        raise RuntimeError("the fp32 trainer does not compute in fp32")
    print(f"fp32 train: XLS-R-300M finetune, B={scfg.batch_size} x 5 s, "
          f"compute {trainer.enc_config.dtype}, grads fp32, built in "
          f"{time.perf_counter() - t0:.1f} s")
    batch = train_batch(np.random.default_rng(2), scfg.batch_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(trainer.train_step(batch, 1.0)["loss"].item())
        times.append(time.perf_counter() - t0)
    counts = _counters()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {k: n * TRAIN_STEPS
            for k, n in expected_train_launches(scfg, cfg).items()}
    print(f"fp32 train: losses {[round(x, 5) for x in losses]}; launches "
          f"over {TRAIN_STEPS} steps {counts}, expected {want}")
    if counts != want:
        raise RuntimeError("fp32 train-step launch counts differ from the "
                           "config")
    if not np.isfinite(losses).all():
        raise RuntimeError("non-finite fp32 training loss")
    if not np.mean(losses[-3:]) < np.mean(losses[:3]):
        raise RuntimeError("the fp32 loss did not fall over the fixed batch")
    ms = 1e3 * float(np.median(times[1:]))
    print(f"fp32 train: step {ms:.1f} ms (median of steps 2-{TRAIN_STEPS}; "
          f"step 1 {1e3 * times[0]:.1f} ms), {1e3 * scfg.batch_size / ms:.1f} "
          f"clips/s, peak device memory {peak:.2f} GiB [{CARD}]")
    for name in ("attention_fwd", "attention_bwd", "ln_gelu_fwd",
                 "ln_gelu_bwd"):
        results[f"{name}_f32"]["launches"] = counts[name]
    busy, n_ops = profile_step(lambda: trainer.train_step(batch, 1.0))
    results["attention_fwd_f32"]["fp32_step"] = dict(
        ms=ms, peak_gib=peak, losses=losses, busy_ms=busy, device_ops=n_ops)
    del trainer
    torch.cuda.empty_cache()


def fp32_step_vs_cpu(dev) -> None:
    """The fp32 step at 2 layers and full width, B = 4, dropout and
    SpecAugment on and the conv tower under remat too: the card against
    the CPU, both fp32, from the same weights, batch and draws. The loss
    within STEP32_LOSS_RTOL, and each parameter group's first-step
    gradient (UPDATE_GROUPS) at cosine >= STEP32_GRAD_COS."""
    from wav2vec_contr_loss_torch import (XLSR_300M, Stage1Trainer,
                                          jax_params_to_torch)
    from wav2vec_contr_loss_torch.parallel.mp_smoke import gradients

    cfg = XLSR_300M.with_(num_layers=2, mask_time_prob=0.2,
                          mask_time_length=5)
    weights = jax_params_to_torch(cfg, *random_jax_trees(cfg, seed=3))
    scfg = fp32_step_config(batch_size=4, remat_conv=True)
    batch = train_batch(np.random.default_rng(4), 4)
    out = {}
    for side, device in (("gpu", dev), ("cpu", "cpu")):
        t0 = time.perf_counter()
        tr = Stage1Trainer(scfg, cfg, weights, device=device)
        loss = tr.train_step(batch, 0.5)["loss"].item()
        out[side] = (loss, gradients(tr), time.perf_counter() - t0)
    (lg, gg, _), (lc, gc, cpu_s) = out["gpu"], out["cpu"]
    rel = abs(lg - lc) / abs(lc)
    cos = update_cosines(None, gg, gc)
    print(f"fp32 train step vs CPU fp32, 2 layers ({cpu_s:.1f} s on the "
          f"CPU): loss gpu {lg:.7f} cpu {lc:.7f} (relative {rel:.3e}, tol "
          f"{STEP32_LOSS_RTOL}); gradient cosines "
          + ", ".join(f"{k} {c:.7f}" for k, c in cos.items())
          + f" (tol >= {STEP32_GRAD_COS})")
    if set(cos) != set(UPDATE_GROUPS):
        raise RuntimeError(f"gradient groups {sorted(cos)}")
    if not (rel <= STEP32_LOSS_RTOL
            and all(c >= STEP32_GRAD_COS for c in cos.values())):
        raise RuntimeError("the fp32 train step on the card disagrees with "
                           "the fp32 CPU step")


def conv_extractor_vs_cpu(encoder, waves, dev) -> tuple:
    """(max |card - CPU| of the conv extractor's output, the largest CPU
    output) for `encoder` (fp32, on the card) on `waves`, against a CPU
    copy; the card side as the process's cuDNN settings make it."""
    import copy

    cpu = copy.deepcopy(encoder.feature_extractor).to("cpu")
    with torch.no_grad():
        got = encoder.feature_extractor(torch.from_numpy(waves).to(dev))
        want = cpu(torch.from_numpy(waves))
    return (got.cpu() - want).abs().max().item(), want.abs().max().item()


def fp32_serve_phase(dev, results):
    """The fp32 serving batch at XLS-R-300M width on the card: a scorer
    with compute dtype float32 scores 4 batches of 8 x 5 s (exactly 24
    attention and 7 LN+GELU launches a batch, nothing else), then ms a
    batch and peak memory. -> (scorer, the batches, batch 0's logits)
    for `fp32_serve_vs_cpu`."""
    from wav2vec_contr_loss_torch import XLSR_300M, SpoofScorer, Stage2Config

    cfg = XLSR_300M.with_(dtype="float32")
    scorer = SpoofScorer(cfg, xlsr_weights(), Stage2Config(), device=dev)
    waves = serving_waves(np.random.default_rng(1), N_BATCHES)
    _reset_counters()
    logits = np.stack([scorer.score_waveforms(w) for w in waves])
    torch.cuda.synchronize()
    counts = _counters()
    want = dict({k: 0 for k in counts},
                attention_fwd=cfg.num_layers * N_BATCHES,
                ln_gelu_fwd=7 * N_BATCHES)
    print(f"fp32 serve: {N_BATCHES} batches -> launches {counts}, expected "
          f"{want}")
    if counts != want:
        raise RuntimeError("fp32 serving launch counts differ")
    results["attention_fwd_f32"]["serving_launches"] = counts["attention_fwd"]
    results["ln_gelu_fwd_f32"]["serving_launches"] = counts["ln_gelu_fwd"]
    if not np.isfinite(logits).all():
        raise RuntimeError("non-finite fp32 logits")
    ms, p90 = closed_loop_ms(scorer.score_waveforms, waves)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"fp32 serve: {ms:.2f} ms per batch of {BATCH} x 5 s (closed "
          f"loop, median of 30, p90 {p90:.2f}), {1e3 * BATCH / ms:.1f} "
          f"clips/s, peak device memory {peak:.2f} GiB [{CARD}]")
    results["attention_fwd_f32"]["fp32_serving"] = dict(
        ms=ms, p90_ms=p90, peak_gib=peak)
    return scorer, waves, logits[0]


def fp32_serve_vs_cpu(scorer, waves, logits0, dev, results) -> None:
    """The fp32 serving batch 0 against the same model in fp32 on the
    CPU; the conv extractor card against CPU under the process's cuDNN
    defaults (TF32 on for other convs), and again with the model's TF32
    scope taken away, to show the check sees TF32."""
    from unittest import mock

    from wav2vec_contr_loss_torch import SpoofScorer, Stage2Config
    from wav2vec_contr_loss_torch.models import wav2vec2

    cpu = SpoofScorer(scorer.enc_config, xlsr_weights(), Stage2Config(),
                      device="cpu")
    t0 = time.perf_counter()
    _, want = cpu.run(torch.from_numpy(waves[0]))
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(logits0 - want.numpy()).max())
    print(f"fp32 serve vs CPU fp32, batch 0 ({cpu_s:.1f} s on the CPU): "
          f"logit max_abs_err {err:.3e} (tol {SERVE32_LOGIT_TOL}); gpu "
          f"{np.array2string(logits0, precision=5)}")
    if not err <= SERVE32_LOGIT_TOL:
        raise RuntimeError("fp32 serving on the card disagrees with the CPU")
    fe_err, fe_max = conv_extractor_vs_cpu(scorer.encoder, waves[0, :2], dev)
    with mock.patch.object(wav2vec2, "fp32_convs", contextlib.nullcontext):
        tf32_err, _ = conv_extractor_vs_cpu(scorer.encoder, waves[0, :2],
                                            dev)
    print(f"fp32 conv extractor vs CPU (cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}): max_abs_err {fe_err:.3e} of "
          f"outputs up to {fe_max:.3e} (tol {FE32_TOL}); with the model's "
          f"TF32 scope taken away {tf32_err:.3e}")
    if not fe_err <= FE32_TOL:
        raise RuntimeError("the fp32 conv extractor on the card is not fp32")
    results["attention_fwd_f32"]["fp32_serving"].update(
        logit_err=err, conv_extractor_err=fe_err,
        conv_extractor_tf32_err=tf32_err)


def fp32_cli_args(root: str, protocol: str, save: str) -> list:
    """`train_stage1 --compute_dtype float32` on the card at XLS-R-300M
    width (seeded random encoder) for one epoch of 2 steps of 8 x 2 s."""
    return ["--device", "cuda", "--compute_dtype", "float32",
            "--encoder_init", "random", "--train_root", root,
            "--train_protocol", protocol, "--epochs", "1", "--batch_size",
            "8", "--max_duration_seconds", "2", "--num_workers", "4",
            "--save_dir", save]


def start_fp32_cli(tmp: str) -> tuple:
    """Start `python -m wav2vec_contr_loss_torch.cli.train_stage1
    --compute_dtype float32 --device cuda` on a synthetic corpus, in a
    child process with PyTorch's default TF32 settings. -> what
    `finish_fp32_cli` takes."""
    root = os.path.join(tmp, "fp32_corpus")
    os.makedirs(root)
    proto = write_corpus(root, FP32_CLI_CLIPS, seed=13, seconds=2.0)
    save = os.path.join(tmp, "fp32_run")
    child = subprocess.Popen(
        [sys.executable, "-m", "wav2vec_contr_loss_torch.cli.train_stage1",
         *fp32_cli_args(root, proto, save)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    return child, save, time.perf_counter()


def finish_fp32_cli(started) -> None:
    """Wait for the child of `start_fp32_cli`: it must exit 0, train in
    fp32 and write its checkpoints."""
    from wav2vec_contr_loss_torch.train import checkpoint as ckpt

    child, save, t0 = started
    try:
        out, err = child.communicate(timeout=300)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    run = os.path.join(save, "facebook__wav2vec2-xls-r-300m")
    ok = (child.returncode == 0 and "COMPUTE_DTYPE=float32" in out
          and "Stage-1 training complete" in out
          and ckpt.checkpoint_exists(run, "latest"))
    print(f"fp32 CLI: train_stage1 --compute_dtype float32 --device cuda "
          f"exit {child.returncode} after {time.perf_counter() - t0:.1f} s "
          f"(beside the CPU references)")
    if not ok:
        print(out[-4000:])
        print(err[-4000:], file=sys.stderr)
        raise RuntimeError("train_stage1 --compute_dtype float32 on the card "
                           "failed")
    print("\n".join("fp32 CLI: " + line for line in out.splitlines()
                    if "loss" in line.lower())[-2000:])


def fp32_phase(dev, results) -> None:
    """Every fp32 leg, with PyTorch's default TF32 settings: kernels, the
    full-width step, serving on the card; then the CLI in a child while
    this process runs the CPU references (the 2-layer step, the serving
    batch, the conv extractor); the process's TF32 settings are the same
    after as before."""
    import shutil
    import tempfile

    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    t0 = time.perf_counter()
    fp32_kernel_phase(dev, results)
    fp32_step_phase(dev, results)
    scorer, waves, logits0 = fp32_serve_phase(dev, results)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fp32_")
    try:
        cli = start_fp32_cli(tmp)
        try:
            fp32_step_vs_cpu(dev)
            fp32_serve_vs_cpu(scorer, waves, logits0, dev, results)
        finally:
            finish_fp32_cli(cli)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del scorer
    torch.cuda.empty_cache()
    after = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    if after != before:
        raise RuntimeError(f"the fp32 path changed the process's TF32 "
                           f"settings: {before} -> {after}")
    print(f"fp32 phase: {time.perf_counter() - t0:.1f} s (cudnn.allow_tf32 "
          f"{after[0]}, matmul.allow_tf32 {after[1]}) [{CARD}]")


def write_corpus(root: str, n: int, seed: int, seconds: float = 5.0,
                 sr: int = 16000) -> str:
    """n 16-bit WAV clips under root, half bonafide (tones) and half
    spoof (noise), clip 3 a quarter second short (a zero-padded tail),
    and their ASVspoof-2019-LA protocol. -> the protocol's path."""
    from wav2vec_contr_loss_torch.data.audio import write_wav

    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        name = f"clip_{i:04d}.wav"
        bona = i % 2 == 0
        t = int(seconds * sr) - (sr // 4 if i == 3 else 0)
        x = (0.4 * np.sin(2 * np.pi * (220 + 30 * (i % 4)) * np.arange(t)
                          / sr) if bona else 0.2 * rng.standard_normal(t))
        write_wav(os.path.join(root, name), x.astype(np.float32), sr)
        label = "bonafide" if bona else "spoof"
        attack = "-" if bona else f"A{(i % 3) + 1:02d}"
        lines.append(f"x/{name} {attack} {label} - SPK{i % 4}")
    path = os.path.join(root, "protocol.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def device_ops(fn):
    """(device operations, their summed device ms) of one fn() call,
    from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(ev), sum(e.time_range.elapsed_us() for e in ev) / 1e3


def rawboost_phase(dev) -> None:
    """Device RawBoost (plain PyTorch, no Pallas kernel behind it) on the
    card against the CPU on the same draws, at the train step's
    (32, 80,000) with zero-padded tails; cuDNN's TF32 left at PyTorch's
    default (on), which the module must turn off for its convolutions."""
    from wav2vec_contr_loss_torch.data.rawboost import RawBoostParams
    from wav2vec_contr_loss_torch.ops.rawboost import (rawboost_batch,
                                                       rawboost_draws)

    b, t = TRAIN_BATCH, SAMPLES
    x_cpu = torch.from_numpy(train_batch(np.random.default_rng(6), b, t)[
        "waveforms"])
    x = x_cpu.to(dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    draws = rawboost_draws(gen, b, t, RawBoostParams())
    draws_cpu = draws.to("cpu")
    out, prev_tf32 = {}, torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for impl in ("direct", "fft"):
            p = RawBoostParams(fir_impl=impl)
            got = rawboost_batch(x, draws, 1.0, p)
            t0 = time.perf_counter()
            want = rawboost_batch(x_cpu, draws_cpu, 1.0, p)
            cpu_s = time.perf_counter() - t0
            err = ((got.cpu() - want).abs().max()
                   / want.abs().max()).item()
            print(f"rawboost {impl}: card vs CPU on the same draws, max "
                  f"|d| / peak {err:.3e} (tolerance {RB_TOL[impl]}; CPU "
                  f"{cpu_s:.1f} s)")
            if not err <= RB_TOL[impl]:
                raise RuntimeError(f"device RawBoost '{impl}' disagrees "
                                   f"with the CPU")
            if (got[x == 0.0] != 0.0).any():
                raise RuntimeError("RawBoost wrote into a zero pad")
            if not torch.equal(rawboost_batch(x, draws, 0.0, p), x):
                raise RuntimeError("RawBoost at prob 0 is not the identity")
            out[impl] = got
        fd = ((out["fft"] - out["direct"]).abs().max()
              / out["direct"].abs().max()).item()
        print(f"rawboost: fft vs direct on the card, max |d| / peak "
              f"{fd:.3e} (tolerance {RB_TOL['fft']}); pad mask kept, "
              f"prob 0 the identity")
        if not fd <= RB_TOL["fft"]:
            raise RuntimeError("RawBoost 'fft' disagrees with 'direct'")

        p = RawBoostParams(fir_impl="fft")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            rawboost_batch(x, rawboost_draws(gen, b, t, p), 0.7, p)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        print("rawboost: draws and batch ran under "
              "torch.cuda.set_sync_debug_mode('error')")

        # 6 filter passes reading and writing (B, T) fp32, the 4 (B, T)
        # draws read, the batch read and written; 'direct' also does
        # 6 B T CHAIN multiply-adds in fp32
        nbytes = (2 * 6 + 4 + 2) * b * t * 4
        for impl in ("direct", "fft"):
            p = RawBoostParams(fir_impl=impl)
            ms = device_ms(lambda: rawboost_batch(x, draws, 1.0, p), iters=5)
            n_ops, _ = device_ops(lambda: rawboost_batch(x, draws, 1.0, p))
            flops = 6 * b * t * 512 * 2 if impl == "direct" else 0
            bound_ms, by = bound(nbytes, flops, FP32_FLOP_PER_S)
            print(f"rawboost {impl} (32, 80000) fp32: device time {ms:.3f} "
                  f"ms in {n_ops} device ops; bound {bound_ms:.4f} ms "
                  f"({by}; bytes alone {1e3 * nbytes / HBM_BYTES_PER_S:.4f} "
                  f"ms) [{CARD}]")
        ms = device_ms(lambda: rawboost_draws(gen, b, t, p), iters=5)
        n_ops, _ = device_ops(lambda: rawboost_draws(gen, b, t, p))
        print(f"rawboost draws (32, 80000): device time {ms:.3f} ms in "
              f"{n_ops} device ops [{CARD}]")
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32


def rawboost_step_phase(dev, off_profile) -> None:
    """The XLS-R-300M finetune step at B = 32 with device RawBoost on (the
    Stage1Config default, 'fft' and 'exact') against the train phase's
    config with it off, in turns on one batch; the RawBoost step once
    under torch.cuda.set_sync_debug_mode('error')."""
    from wav2vec_contr_loss_torch import XLSR_300M, Stage1Config, Stage1Trainer

    on = Stage1Trainer(Stage1Config(finetune_encoder=True), XLSR_300M,
                       xlsr_weights(), device=dev)
    off = Stage1Trainer(Stage1Config(finetune_encoder=True,
                                     use_rawboost=False), XLSR_300M,
                        xlsr_weights(), device=dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             train_batch(np.random.default_rng(2), TRAIN_BATCH).items()}
    for tr in (on, off):
        tr.train_step(batch, 1.0)["loss"].item()          # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = on.train_step(batch, 1.0)["loss"]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print(f"train step with device RawBoost ran under "
          f"torch.cuda.set_sync_debug_mode('error'), loss {loss.item():.5f}")
    times = {"on": [], "off": []}
    for _ in range(6):
        for name, tr in (("on", on), ("off", off)):
            t0 = time.perf_counter()
            loss = tr.train_step(batch, 1.0)["loss"].item()
            times[name].append(1e3 * (time.perf_counter() - t0))
            if not np.isfinite(loss):
                raise RuntimeError(f"non-finite loss, RawBoost {name}")
    med = {k: float(np.median(v)) for k, v in times.items()}
    print(f"train step B=32 x 5 s, RawBoost on (device, fft, exact) vs off, "
          f"in turns: median of 6 {med['on']:.1f} vs {med['off']:.1f} ms "
          f"(on {[round(x, 1) for x in times['on']]}, off "
          f"{[round(x, 1) for x in times['off']]}) [{CARD}]")
    busy, n_ops = profile_step(lambda: on.train_step(batch, 1.0))
    if n_ops is not None and off_profile[1] is not None:
        print(f"train step device ops: {n_ops} with RawBoost, "
              f"{off_profile[1]} without (+{n_ops - off_profile[1]}); device "
              f"busy {busy:.1f} vs {off_profile[0]:.1f} ms [{CARD}]")


def baseline_weights(cfg, hidden_dim: int = 256, seed: int = 0):
    """Encoder, compression and classifier state dicts of the end-to-end
    baseline from seeded random trees (the seed-0 XLS-R-300M weights of
    the other phases at full width, a lecun-scaled Dense(256 -> 1))."""
    from wav2vec_contr_loss_torch import XLSR_300M, jax_params_to_torch
    from wav2vec_contr_loss_torch.bridge import dense_state_dict, random_dense

    if cfg == XLSR_300M and hidden_dim == 256 and seed == 0:
        weights = dict(xlsr_weights())
    else:
        weights = jax_params_to_torch(cfg, *random_jax_trees(
            cfg, comp_dim=hidden_dim, seed=seed))
    weights["classifier"] = dense_state_dict(random_dense(hidden_dim, 1,
                                                          seed=seed))
    return weights


def baseline_phase(dev, results) -> None:
    """The end-to-end BCE baseline at XLS-R-300M width: BaselineConfig's
    defaults (bf16, remat, dropout 0.1, device RawBoost 'fft' at 0.7, the
    clip over every gradient), pos_weight from the batch, 8 steps on one
    fixed batch of 32 x 5 s with the launch counters reset just before
    and read just after (48 attention forwards, 24 backwards, 7 LN+GELU
    forwards, 7 backwards, no SupCon a step); one step under
    set_sync_debug_mode("error"); the step's time, device busy time and
    operations, peak memory. Then a 2-layer step on the card in bf16
    against the CPU in fp32."""
    from wav2vec_contr_loss_torch import (XLSR_300M, BaselineConfig,
                                          BaselineTrainer)
    from wav2vec_contr_loss_torch.losses import pos_weight_from_labels

    cfg, bcfg = XLSR_300M, BaselineConfig()
    batch = train_batch(np.random.default_rng(5), bcfg.batch_size)
    t0 = time.perf_counter()
    trainer = BaselineTrainer(bcfg, cfg, baseline_weights(cfg), device=dev,
                              pos_weight=pos_weight_from_labels(
                                  batch["labels"]))
    print(f"baseline: XLS-R-300M end-to-end BCE, B={bcfg.batch_size} x 5 s, "
          f"{bcfg.compute_dtype}, remat_encoder={bcfg.remat_encoder}, "
          f"dropout on, device RawBoost {bcfg.rawboost_fir_impl} at "
          f"{bcfg.rawboost_prob}, clip {bcfg.grad_clip} over every "
          f"gradient; built in {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(trainer.train_step(batch)["loss"].item())   # syncs
        times.append(time.perf_counter() - t0)
    counts = _counters()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {k: v * TRAIN_STEPS for k, v in
            expected_train_launches(bcfg, cfg, supcon=0).items()}
    print(f"baseline: losses {[round(x, 5) for x in losses]}")
    print(f"baseline: launches over {TRAIN_STEPS} steps {counts}, expected "
          f"{want}")
    if counts != want:
        raise RuntimeError("baseline-step launch counts differ from the "
                           "config")
    for name, n in counts.items():
        results[name]["baseline_launches"] = n
    if not np.isfinite(losses).all():
        raise RuntimeError("non-finite baseline loss")
    ms = 1e3 * float(np.median(times[1:]))
    print(f"baseline: step {ms:.1f} ms (median of steps 2-{TRAIN_STEPS}, "
          f"host clock to the loss on the host; step 1 "
          f"{1e3 * times[0]:.1f} ms; min {1e3 * min(times[1:]):.1f}, max "
          f"{1e3 * max(times[1:]):.1f}), {1e3 * bcfg.batch_size / ms:.1f} "
          f"clips/s, peak device memory {peak:.2f} GiB [{CARD}]")
    dbatch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    trainer.train_step(dbatch)["loss"].item()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = trainer.train_step(dbatch)["loss"]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print(f"baseline: a step (device RawBoost, BCE, the clip over every "
          f"gradient, AdamW) ran under torch.cuda.set_sync_debug_mode("
          f"'error'), loss {loss.item():.5f}")
    profile_step(lambda: trainer.train_step(dbatch))
    del trainer, dbatch
    torch.cuda.empty_cache()
    baseline_step_vs_cpu(dev)


def baseline_step_vs_cpu(dev) -> None:
    """One baseline step at 2 layers and full width, B=4, dropout,
    SpecAugment and RawBoost off: bf16 on the card against fp32 on the
    CPU, held to the limits of step_vs_cpu (the loss, the gradients of
    layer 0's q_proj and conv 0's LN scale by cosine and norm ratio)."""
    from wav2vec_contr_loss_torch import (XLSR_300M, BaselineConfig,
                                          BaselineTrainer)

    cfg = XLSR_300M.with_(num_layers=2, hidden_dropout=0.0,
                          attention_dropout=0.0, activation_dropout=0.0,
                          feat_proj_dropout=0.0, apply_spec_augment=False)
    weights = baseline_weights(cfg, seed=3)
    batch = train_batch(np.random.default_rng(4), 4)
    out = {}
    for name, device, dtype in (("gpu", dev, "bfloat16"),
                                ("cpu", "cpu", "float32")):
        t0 = time.perf_counter()
        tr = BaselineTrainer(BaselineConfig(compute_dtype=dtype, dropout=0.0,
                                            use_rawboost=False, batch_size=4),
                             cfg, weights, device=device)
        loss = tr.train_step(batch)["loss"].item()
        params = dict(tr.encoder.named_parameters(prefix="encoder"))
        params["classifier"] = tr.classifier.weight
        grads = {k: params[k].grad.detach().float().cpu()
                 for k in ("classifier",) + STEP_ENC_GRADS}
        out[name] = (loss, grads, time.perf_counter() - t0)
    (lg, gg, _), (lc, gc, cpu_s) = out["gpu"], out["cpu"]
    print(f"baseline step vs CPU fp32 ({cpu_s:.1f} s on the CPU): loss gpu "
          f"{lg:.6f} cpu {lc:.6f} (|d| {abs(lg - lc):.3e}, tol "
          f"{STEP_LOSS_TOL})")
    failed = [] if abs(lg - lc) <= STEP_LOSS_TOL else ["loss"]
    for key, a in gg.items():
        w = gc[key]
        cos = torch.nn.functional.cosine_similarity(
            a.flatten(), w.flatten(), dim=0).item()
        ratio = (a.norm() / w.norm()).item()
        held = key != "classifier"
        print(f"  grad {key}: cosine {cos:.6f}"
              + (f" (tol >= {STEP_ENC_COS})" if held else "")
              + f", norm gpu/cpu {ratio:.6f}"
              + (f" (tol 1 +- {STEP_ENC_NORM})" if held else "")
              + f", max_abs_err {(a - w).abs().max().item():.3e}")
        if held and not (cos >= STEP_ENC_COS
                         and abs(ratio - 1.0) <= STEP_ENC_NORM):
            failed.append(key)
    if failed:
        raise RuntimeError(f"the GPU bf16 baseline step disagrees with the "
                           f"CPU fp32 step: {failed}")


class StepCountGuard:
    """Requests a stop at the k-th poll; fit polls once a step."""

    def __init__(self, k: int):
        self.k, self.calls = k, 0

    def requested(self, step=None):
        self.calls += 1
        return self.calls >= self.k


def _differences(a, b, path="") -> list:
    """Names of the leaves of two state trees that are not the same bits."""
    if isinstance(a, torch.Tensor):
        b = b.to(a.device)
        return [] if a.dtype == b.dtype and torch.equal(a, b) else [path]
    if isinstance(a, dict):
        return [d for k in a for d in _differences(a[k], b[k],
                                                   f"{path}.{k}")]
    if isinstance(a, (list, tuple)):
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _differences(x, y, f"{path}[{i}]")]
    return [] if a == b else [path]


def fit_phase(dev, tmp: str) -> dict:
    """`fit` at XLS-R-300M width, B = 32 x 5 s, with device RawBoost, on a
    synthetic ASVspoof-2019-style corpus written from a seed under `tmp`
    (64 train and 32 dev clips: 2 train steps and 1 dev batch an epoch),
    2 epochs: once through; once preempted at epoch 2, batch 1 and resumed
    from 'latest' through from_checkpoint and resume_cursor, into
    `tmp`/ckpt. Deterministic algorithms on; the resumed run must give the
    same bits."""
    from wav2vec_contr_loss_torch import XLSR_300M, Stage1Config, Stage1Trainer
    from wav2vec_contr_loss_torch.data import (AudioConfig, BatchPipeline,
                                               parse_asvspoof2019)
    from wav2vec_contr_loss_torch.train import checkpoint as ckpt

    cfg = XLSR_300M
    scfg = Stage1Config(finetune_encoder=True, epochs=2)
    t_phase = time.perf_counter()
    try:
        protos = {}
        for part, n, seed in (("train", 64, 21), ("dev", 32, 22)):
            os.makedirs(os.path.join(tmp, part))
            protos[part] = write_corpus(os.path.join(tmp, part), n, seed)

        def pipes():
            ds = {k: parse_asvspoof2019(v, os.path.dirname(v),
                                        audio=AudioConfig(16000, 5))
                  for k, v in protos.items()}
            return (BatchPipeline(ds["train"], scfg.batch_size,
                                  seed=scfg.seed, num_workers=8),
                    BatchPipeline(ds["dev"], scfg.batch_size,
                                  seed=scfg.seed + 1, num_workers=8))

        def log(tag):
            return lambda msg: print(f"fit {tag}: {msg}")

        torch.use_deterministic_algorithms(True)
        a = Stage1Trainer(scfg, cfg, xlsr_weights(), device=dev)
        torch.cuda.synchronize()
        _reset_counters()
        t0 = time.perf_counter()
        hist_a = a.fit(*pipes(), log_fn=log("A (through)"))
        fit_s = time.perf_counter() - t0
        counts = _counters()
        step = expected_train_launches(scfg, cfg)
        evals = {"attention_fwd": cfg.num_layers, "attention_bwd": 0,
                 "ln_gelu_fwd": len(cfg.conv_dim), "ln_gelu_bwd": 0,
                 "supcon": 1}
        want = {k: 4 * step[k] + 2 * evals[k] for k in step}
        print(f"fit A: launches over 4 train steps and 2 dev batches "
              f"{counts}, expected {want}")
        if counts != want:
            raise RuntimeError("fit launch counts differ from the config")
        if not (np.isfinite(hist_a["train_loss"]).all()
                and np.isfinite(hist_a["dev_loss"]).all()):
            raise RuntimeError("non-finite fit losses")
        a_state = ckpt.snapshot_for_save(a.state_dict())
        a_step = a.step
        del a
        torch.cuda.empty_cache()

        save = os.path.join(tmp, "ckpt")
        b = Stage1Trainer(scfg, cfg, xlsr_weights(), device=dev)
        hist_b = b.fit(*pipes(), save_dir=save,
                       preemption=StepCountGuard(3), log_fn=log("B"))
        m = ckpt.load_sidecar(save, "latest")["metrics"]
        if not (hist_b.get("preempted") and m["preempted"]
                and (m["epoch"], m["batches_done"]) == (2, 1)):
            raise RuntimeError(f"preemption not saved at epoch 2, batch 1: "
                               f"{m}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = ckpt.snapshot_for_save(b.state_dict())
        snap_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ckpt.save_checkpoint(save, "probe", None, host_state=snap)
        save_s = time.perf_counter() - t0
        nbytes = ckpt.checkpoint_bytes(save, "probe")
        for suffix in (".pt", ".config.json"):
            os.remove(os.path.join(save, "probe" + suffix))
        del b, snap
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        c = Stage1Trainer.from_checkpoint(save, "latest", device=dev)
        torch.cuda.synchronize()
        rebuild_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        c.restore(save, "latest")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        start, skip = ckpt.resume_cursor(m)
        hist_c = c.fit(*pipes(), save_dir=save, start_epoch=start,
                       skip_steps=skip, best_dev=m["best_dev"],
                       log_fn=log("C (resumed)"))
        diff = _differences(a_state, c.state_dict())
        print(f"fit: resumed vs through: step {c.step} vs {a_step}, epoch-2 "
              f"dev loss {hist_c['dev_loss']} vs {hist_a['dev_loss'][1:]}, "
              f"{len(diff)} state leaves differ {diff[:5]}")
        if diff or c.step != a_step or hist_c["dev_loss"] != \
                hist_a["dev_loss"][1:]:
            raise RuntimeError("the resumed run is not bit-identical to the "
                               "uninterrupted one")
        print(f"fit: save of the full state {nbytes} bytes "
              f"({nbytes / 2 ** 30:.2f} GiB): host snapshot {snap_s:.2f} s, "
              f"file write {save_s:.2f} s; restore into a trainer "
              f"{restore_s:.2f} s, rebuild by from_checkpoint "
              f"{rebuild_s:.2f} s [{CARD}]")
        print(f"fit: run A (2 epochs, 4 steps, 2 dev batches) {fit_s:.1f} s; "
              f"train losses {hist_a['train_loss']}, dev losses "
              f"{hist_a['dev_loss']}; phase {time.perf_counter() - t_phase:.1f}"
              f" s [{CARD}]")
        return {"fit_launches": counts}
    finally:
        torch.use_deterministic_algorithms(False)


def expected_extract_launches(cfg, n_batches: int) -> dict:
    """Kernel launches of `n_batches` extraction batches: the eval-mode
    forward runs each layer's attention and each conv's LN+GELU once, and
    no backward or loss kernel."""
    return {"attention_fwd": cfg.num_layers * n_batches,
            "attention_bwd": 0,
            "ln_gelu_fwd": len(cfg.conv_dim) * n_batches,
            "ln_gelu_bwd": 0, "supcon": 0}


def pipeline_phase(dev, tmp: str) -> dict:
    """The inference half of the main path from the fit phase's
    full-width 'best' checkpoint in `tmp`/ckpt: a third split (eval, 32
    clips of 5 s, its own seed), `extract_embeddings` through
    `Stage1Trainer.from_checkpoint(...).embed_dataset` for train (64),
    dev (32) and eval at batch PIPE_BATCH with the launch counters reset
    just before and read just after (exact per-batch counts), then
    `train_stage2` on the card (linear head, lr 5e-2, 40 epochs),
    `generate_scores` -> score_cm_eval.txt -> its EER, and
    `SpoofScorer.from_checkpoints` on the same two checkpoints: its
    dataset scores against the score file's logits, and on 4 clips the
    card in bf16 against an fp32 CPU scorer."""
    from wav2vec_contr_loss_torch import XLSR_300M, SpoofScorer, Stage1Trainer
    from wav2vec_contr_loss_torch.cli import generate_scores
    from wav2vec_contr_loss_torch.config import Stage2Config
    from wav2vec_contr_loss_torch.data import (AudioConfig, BatchPipeline,
                                               parse_asvspoof2019)
    from wav2vec_contr_loss_torch.data.pipeline import _start_fetch
    from wav2vec_contr_loss_torch.eval.extract import (extract_embeddings,
                                                       load_embeddings)
    from wav2vec_contr_loss_torch.eval.metrics import calculate_eer_from_file
    from wav2vec_contr_loss_torch.eval.score import read_score_file
    from wav2vec_contr_loss_torch.train.stage2 import train_stage2

    t_phase = time.perf_counter()
    ckpt_dir = os.path.join(tmp, "ckpt")
    protos = {part: os.path.join(tmp, part, "protocol.txt")
              for part in ("train", "dev")}
    os.makedirs(os.path.join(tmp, "eval"))
    protos["eval"] = write_corpus(os.path.join(tmp, "eval"), EVAL_CLIPS,
                                  seed=23)
    pipes = {k: BatchPipeline(parse_asvspoof2019(
                 v, os.path.dirname(v), audio=AudioConfig(16000, 5)),
                 PIPE_BATCH, num_workers=8) for k, v in protos.items()}
    if not _start_fetch(torch.zeros(4, device=dev))[1][0].is_pinned():
        raise RuntimeError("the copy back of stream_through_device does not "
                           "land in pinned memory")

    t0 = time.perf_counter()
    trainer = Stage1Trainer.from_checkpoint(ckpt_dir, "best", device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    emb_dir = os.path.join(tmp, "embeddings")
    n_clips = sum(len(p.dataset) for p in pipes.values())
    n_batches = sum(-(-len(p.dataset) // PIPE_BATCH) for p in pipes.values())
    _reset_counters()
    t0 = time.perf_counter()
    for split, pipe in pipes.items():
        extract_embeddings(trainer.embed_dataset, pipe, emb_dir, split,
                           log_fn=lambda m: print(f"pipeline: {m}"))
    extract_s = time.perf_counter() - t0
    counts = _counters()
    want = expected_extract_launches(XLSR_300M, n_batches)
    print(f"pipeline: extraction launches over {n_batches} batches {counts}, "
          f"expected {want}")
    if counts != want:
        raise RuntimeError("extraction launch counts differ from the model")
    # a second, warm pass for the throughput; then one batch's device time
    t0 = time.perf_counter()
    for pipe in pipes.values():
        trainer.embed_dataset(pipe)
    warm_s = time.perf_counter() - t0
    waves = torch.from_numpy(next(iter(pipes["eval"].sequential())).waveforms
                             ).to(dev)
    # device busy time from the profiler: the host queues one batch's
    # ~1,000 operations about as fast as the card runs them, so events
    # behind a sleeping kernel would time the host
    n_ops, batch_ms = device_ops(
        lambda: trainer.embed_step({"waveforms": waves}))
    print(f"pipeline: extraction of {n_clips} clips of 5 s in {n_batches} "
          f"batches of {PIPE_BATCH}: first pass {extract_s:.2f} s "
          f"({n_clips / extract_s:.1f} clips/s, files written), warm pass "
          f"{warm_s:.2f} s ({n_clips / warm_s:.1f} clips/s); device busy "
          f"{batch_ms:.2f} ms in {n_ops} device ops per batch of "
          f"{PIPE_BATCH} (embed_step, bf16, torch.profiler); checkpoint "
          f"load {load_s:.1f} s [{CARD}]")
    del trainer
    torch.cuda.empty_cache()

    stage2_dir = os.path.join(tmp, "stage2")
    tr_x, tr_y = load_embeddings(emb_dir, "train")
    dv_x, dv_y = load_embeddings(emb_dir, "dev")
    cfg2 = Stage2Config(in_dim=tr_x.shape[1], lr=5e-2, epochs=40)
    t0 = time.perf_counter()
    _, hist = train_stage2(cfg2, tr_x, tr_y, dv_x, dv_y, save_dir=stage2_dir,
                           log_fn=lambda m: None, device=dev)
    stage2_s = time.perf_counter() - t0
    if not np.isfinite(hist["train_loss"] + hist["dev_loss"]).all():
        raise RuntimeError("non-finite stage-2 losses")
    print(f"pipeline: stage 2 (linear head, lr 5e-2, up to 40 epochs) ran "
          f"{len(hist['train_loss'])} epochs in {stage2_s:.2f} s; last "
          f"train loss {hist['train_loss'][-1]:.4f}, dev EER "
          f"{hist['dev_eer'][-1]} [{CARD}]")

    scores_dir = os.path.join(tmp, "scores")
    generate_scores.main(["--emb_dir", emb_dir, "--stage2_dir", stage2_dir,
                          "--scores_dir", scores_dir, "--splits", "eval",
                          "--device", str(dev)])
    score_file = os.path.join(scores_dir, "score_cm_eval.txt")
    eer = calculate_eer_from_file(score_file)
    rec = read_score_file(score_file)
    print(f"pipeline: {score_file}: {len(rec)} trials, EER = {eer:.3f}% "
          f"(random-init encoder after 4 steps: no target, must be finite)")
    if len(rec) != EVAL_CLIPS or not np.isfinite([eer, *rec.scores]).all():
        raise RuntimeError("the eval score file is not whole and finite")

    scorer = SpoofScorer.from_checkpoints(ckpt_dir, stage2_dir, device=dev)
    logits, labels = scorer.score_dataset(pipes["eval"])
    err = float(np.abs(logits - rec.scores).max())
    print(f"pipeline: SpoofScorer.from_checkpoints score_dataset vs the "
          f"score file: max |d logit| {err:.3e} (tol {LOGIT_TOL})")
    if not (err <= LOGIT_TOL and
            ((labels == 1) == (rec.keys == "bonafide")).all()):
        raise RuntimeError("the scorer disagrees with the score file")
    cpu = SpoofScorer.from_checkpoints(ckpt_dir, stage2_dir, device="cpu",
                                       compute_dtype="float32")
    w4 = torch.from_numpy(next(iter(pipes["eval"].sequential())).waveforms[:4])
    t0 = time.perf_counter()
    z_cpu, l_cpu = cpu.run(w4)
    cpu_s = time.perf_counter() - t0
    z_gpu, l_gpu = scorer.run(w4)
    z_err = (z_gpu.cpu() - z_cpu).abs().max().item()
    l_err = (l_gpu.cpu() - l_cpu).abs().max().item()
    print(f"pipeline: 4 clips, card bf16 vs CPU fp32 ({cpu_s:.1f} s on the "
          f"CPU) from the same checkpoints: z max_abs_err {z_err:.3e} (tol "
          f"{Z_TOL}), logit max_abs_err {l_err:.3e} (tol {LOGIT_TOL}) "
          f"[{CARD}]")
    if not (z_err <= Z_TOL and l_err <= LOGIT_TOL):
        raise RuntimeError("the card's scorer disagrees with the CPU fp32 one")
    phase_s = time.perf_counter() - t_phase
    print(f"pipeline phase: {phase_s:.1f} s [{CARD}]")
    return {"pipeline_launches": counts,
            "extract_clips_per_s": n_clips / warm_s,
            "extract_batch_ms": batch_ms, "stage2_s": stage2_s,
            "eer": eer, "phase_s": phase_s}


def baseline_cli_phase(dev, tmp: str) -> dict:
    """The baseline recipe through its CLIs at XLS-R-300M width on the fit
    phase's corpus (64 train, 32 dev clips; the pipeline phase's 32 eval
    clips): `train_baseline --device cuda --cache_waveforms --cache_dtype
    int16` for 2 epochs (launch counters reset just before and read just
    after: 4 baseline steps and 2 dev batches; the cache decoded once and
    read on both epochs), then `score_baseline` on the eval split, whose
    file must hold the logits of `score_dataset` from the same
    checkpoint."""
    from wav2vec_contr_loss_torch import XLSR_300M, BaselineConfig
    from wav2vec_contr_loss_torch.cli import score_baseline, train_baseline
    from wav2vec_contr_loss_torch.data import (AudioConfig, AudioLoader,
                                               BatchPipeline,
                                               parse_asvspoof2019)
    from wav2vec_contr_loss_torch.data.cache import CachedLoader
    from wav2vec_contr_loss_torch.eval.score import read_score_file
    from wav2vec_contr_loss_torch.train import BaselineTrainer
    from wav2vec_contr_loss_torch.train import checkpoint as ckpt

    t_phase = time.perf_counter()
    protos = {part: os.path.join(tmp, part, "protocol.txt")
              for part in ("train", "dev", "eval")}
    save = os.path.join(tmp, "baseline")
    args = ["--device", "cuda", "--encoder_init", "random",
            "--save_dir", save, "--epochs", "2", "--batch_size", "32",
            "--num_workers", "8", "--cache_waveforms",
            os.path.join(tmp, "cache"), "--cache_dtype", "int16"]
    for part in ("train", "dev"):
        args += [f"--{part}_root", os.path.dirname(protos[part]),
                 f"--{part}_protocol", protos[part]]
    AudioLoader.reset_counters()
    rows0 = CachedLoader.rows_read
    _reset_counters()
    t0 = time.perf_counter()
    train_baseline.main(args)
    train_s = time.perf_counter() - t0
    counts = _counters()
    loads = AudioLoader.loaded_count + AudioLoader.failed_count
    rows = CachedLoader.rows_read - rows0
    step = expected_train_launches(BaselineConfig(), XLSR_300M, supcon=0)
    evals = expected_extract_launches(XLSR_300M, 1)
    want = {k: 4 * step[k] + 2 * evals[k] for k in step}
    print(f"baseline CLI: launches over 4 steps and 2 dev batches {counts}, "
          f"expected {want}")
    if counts != want:
        raise RuntimeError("train_baseline launch counts differ from the "
                           "config")
    print(f"baseline CLI: {loads - rows} clips decoded (the cache build), "
          f"{rows} cache rows read over 2 epochs (expected 96 and "
          f"{2 * (64 + 32)})")
    if (loads - rows, rows) != (96, 2 * (64 + 32)):
        raise RuntimeError("the waveform cache was not built once and read "
                           "on every epoch")
    run = os.path.join(save, "facebook__wav2vec2-xls-r-300m")
    for name in ("baseline_best", "baseline_latest"):
        if not ckpt.checkpoint_exists(run, name):
            raise RuntimeError(f"train_baseline wrote no {name}")
    m = ckpt.load_sidecar(run, "baseline_latest")["metrics"]
    if not (m["epoch"] == 2 and np.isfinite(m["dev_eer"])):
        raise RuntimeError(f"baseline_latest metrics {m}")

    scores = os.path.join(tmp, "baseline_scores")
    score_baseline.main(["--ckpt_dir", run, "--scores_dir", scores,
                         "--eval_root", os.path.dirname(protos["eval"]),
                         "--eval_protocol", protos["eval"], "--batch_size",
                         "32", "--device", "cuda"])
    rec = read_score_file(os.path.join(scores, "score_cm_eval.txt"))
    trainer = BaselineTrainer.from_checkpoint(run, "baseline_best",
                                              device=dev)
    logits, _ = trainer.score_dataset(BatchPipeline(parse_asvspoof2019(
        protos["eval"], os.path.dirname(protos["eval"]),
        audio=AudioConfig(16000, 5)), 32, num_workers=8))
    err = float(np.abs(logits - rec.scores).max())
    print(f"baseline CLI: 2 epochs in {train_s:.1f} s, dev EER "
          f"{m['dev_eer']} (finite; synthetic corpus), score_cm_eval.txt "
          f"{len(rec)} trials against score_dataset max |d| {err:.3e} (tol "
          f"1e-6: the file keeps 6 decimals); phase "
          f"{time.perf_counter() - t_phase:.1f} s [{CARD}]")
    if len(rec) != EVAL_CLIPS or not err <= 1e-6:
        raise RuntimeError("score_baseline's file disagrees with "
                           "score_dataset")
    del trainer
    torch.cuda.empty_cache()
    return {"baseline_cli_launches": counts}


def features_phase(dev, tmp: str) -> dict:
    """Stage 1 from encoder features at XLS-R-300M width:
    `extract_encoder_features` (the CLI, seeded random encoder, bf16,
    batch 32, host RawBoost on train) over the fit phase's 64 + 32 clips
    into (N, 1024, 250) fp32 memmaps, exactly 24 attention and 7 LN+GELU
    forwards a batch and nothing else; then `train_stage1 --features_dir`
    for 2 epochs, binary (exactly one SupCon launch a train step and a
    dev batch, nothing else) and multiclass (no kernel launch); the ms of
    a head-only step."""
    from wav2vec_contr_loss_torch import XLSR_300M, Stage1Trainer
    from wav2vec_contr_loss_torch.cli import (extract_encoder_features,
                                              train_stage1)

    t_phase = time.perf_counter()
    feats = os.path.join(tmp, "features")
    args = ["--device", "cuda", "--encoder_init", "random", "--out_dir",
            feats, "--batch_size", "32", "--num_workers", "8"]
    for part in ("train", "dev"):
        proto = os.path.join(tmp, part, "protocol.txt")
        args += [f"--{part}_root", os.path.dirname(proto),
                 f"--{part}_protocol", proto]
    extract = extract_encoder_features.extract_encoder_features
    spent = []

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = extract(*a, **k)
        spent.append(time.perf_counter() - t0)
        return out

    extract_encoder_features.extract_encoder_features = timed
    _reset_counters()
    try:
        extract_encoder_features.main(args)
    finally:
        extract_encoder_features.extract_encoder_features = extract
    counts = _counters()
    want = expected_extract_launches(XLSR_300M, 3)
    print(f"features: extraction launches over 3 batches {counts}, "
          f"expected {want}")
    if counts != want:
        raise RuntimeError("feature-extraction launch counts differ from "
                           "the model")
    shapes = {}
    for part, n in (("train", 64), ("dev", 32)):
        x = np.load(os.path.join(feats, f"{part}_features.npy"),
                    mmap_mode="r")
        shapes[part] = x.shape
        if (x.shape != (n, 1024, 250) or x.dtype != np.float32
                or not np.isfinite(x[:, :, :249]).all()
                or np.asarray(x[:, :, 249:]).any()):
            raise RuntimeError(f"{part} features {x.shape} {x.dtype}: not "
                               f"finite (N, 1024, 250) with a zero pad")
    print(f"features: {shapes} float32 memmaps (249 frames, padded to 250); "
          f"96 clips of 5 s in {sum(spent):.2f} s of extraction "
          f"({96 / sum(spent):.1f} clips/s, decode and the memmap writes "
          f"included): train {64 / spent[0]:.1f} clips/s with host "
          f"RawBoost, dev {32 / spent[1]:.1f} clips/s without [{CARD}]")

    out = {"features_launches": counts}
    for mode, supcon_n in (("binary", 4 + 2), ("multiclass", 0)):
        save = os.path.join(tmp, f"from_features_{mode}")
        _reset_counters()
        t0 = time.perf_counter()
        train_stage1.main(["--features_dir", feats, "--device", "cuda",
                           "--save_dir", save, "--epochs", "2",
                           "--batch_size", "32", "--loss_mode", mode,
                           "--warmup_epochs", "1", "--alpha_ramp_epochs",
                           "2"])
        fit_s = time.perf_counter() - t0
        counts = _counters()
        want = {"attention_fwd": 0, "attention_bwd": 0, "ln_gelu_fwd": 0,
                "ln_gelu_bwd": 0, "supcon": supcon_n}
        print(f"features: fit_from_features {mode} 2 epochs (4 steps, 2 dev "
              f"batches) in {fit_s:.1f} s, launches {counts}, expected "
              f"{want}")
        if counts != want:
            raise RuntimeError(f"fit_from_features {mode} launch counts "
                               f"differ")
        run = os.path.join(save, "facebook__wav2vec2-xls-r-300m")
        tr = Stage1Trainer.from_checkpoint(run, "latest", device=dev)
        batch = {"features": torch.randn(32, 250, 1024, device=dev),
                 "labels": torch.arange(32, device=dev) % 2,
                 "multi_labels": torch.arange(32, device=dev) % 3}
        losses, times = [], []
        for _ in range(8):
            t0 = time.perf_counter()
            losses.append(tr.train_step(batch, 0.5)["loss"].item())
            times.append(1e3 * (time.perf_counter() - t0))
        if not np.isfinite(losses).all():
            raise RuntimeError(f"non-finite fit_from_features {mode} loss")
        print(f"features: {mode} head-only step {np.median(times[1:]):.2f} "
              f"ms (median of steps 2-8 on a (32, 250, 1024) device batch, "
              f"host clock to the loss on the host) [{CARD}]")
        out[f"fit_from_features_{mode}_launches"] = counts
    print(f"features phase: {time.perf_counter() - t_phase:.1f} s [{CARD}]")
    return out


# ---------------------------------------------------------- front door
FRONT_CLIPS = 64                 # the served corpus: half FLAC, half WAV
FRONT_CLIENTS = 16
FRONT_BATCH = 8
FRONT_WAIT_MS = 5.0
# the server against SpoofScorer.score_waveforms on the same decoded clip:
# both bf16 on the card, same batch shape, other batch neighbours
FRONT_LOGIT_TOL = 1e-2
# `serve --windowed` against score_long_waveforms on the same 8 windows
# in one batch: the logits are printed with 6 decimals
WINDOWED_TOL = 1e-5
POS_CONV_KEY = "encoder.pos_conv_embed.conv.weight"


def load_flac_writer():
    """tests/flac_writer.py, loaded by path (it needs only numpy)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "flac_writer.py")
    spec = importlib.util.spec_from_file_location("flac_writer", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_front_door_corpus(root: str, n: int, seed: int,
                            seconds=(3.0, 7.0), sr: int = 16000) -> list:
    """n clips of seeded length in `seconds`, tones and noise, 16-bit:
    the even ones FLAC (tests/flac_writer.py, verbatim and fixed-order
    subframes in turn), the odd ones WAV. -> their paths."""
    from wav2vec_contr_loss_torch.data.audio import write_wav

    flac = load_flac_writer()
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        t = int(rng.uniform(*seconds) * sr)
        x = (0.4 * np.sin(2 * np.pi * (200 + 40 * (i % 5)) * np.arange(t)
                          / sr) if i % 4 < 2 else 0.2 * rng.standard_normal(t))
        x = np.clip(x, -1.0, 1.0).astype(np.float32)
        if i % 2 == 0:
            path = os.path.join(root, f"clip_{i:03d}.flac")
            flac.write_flac(path, (x * 32767.0).astype(np.int16), sr,
                            subframe_mode=("verbatim", "fixed1")[i // 2 % 2])
        else:
            path = os.path.join(root, f"clip_{i:03d}.wav")
            write_wav(path, x, sr)
        paths.append(path)
    return paths


def write_reference_files(tmp: str, cfg, weights, model_name: str) -> dict:
    """With the port's own writers: a finetuned reference stage-1 .pt (the
    encoder under `module.model.`, its positional conv as
    weight_g/weight_v), the same run frozen (no encoder), a linear
    stage-2 .pt and an HF snapshot of the encoder. -> their paths."""
    from wav2vec_contr_loss_torch.models.export_hf import save_hf_checkpoint
    from wav2vec_contr_loss_torch.models.ref_convert import \
        reference_encoder_state_dict

    comp, head = weights["compression"], weights["head"]
    config = {"MODEL_NAME": model_name, "INPUT_DIM": cfg.hidden_size,
              "HIDDEN_DIM": comp["proj.weight"].shape[0],
              "FINETUNE_ENCODER": True}
    comp_sd = {"mlp3.weight": comp["proj.weight"],
               "mlp3.bias": comp["proj.bias"]}
    out = {k: os.path.join(tmp, f) for k, f in (
        ("stage1", "stage1_finetuned.pt"), ("stage1_frozen",
                                            "stage1_frozen.pt"),
        ("stage2", "stage2_binary_head_best.pt"), ("hf", "hf_snapshot"))}
    torch.save({"epoch": 7, "compression_state_dict": comp_sd,
                "encoder_state_dict": reference_encoder_state_dict(
                    cfg, weights["encoder"], prefix="module.model."),
                "train_loss": 0.5, "dev_loss": 0.6, "config": config},
               out["stage1"])
    torch.save({"epoch": 7, "compression_state_dict": comp_sd,
                "train_loss": 0.5, "dev_loss": 0.6,
                "config": dict(config, FINETUNE_ENCODER=False)},
               out["stage1_frozen"])
    torch.save({"epoch": 3, "model_state_dict": {
                    "fc.weight": head["fc.weight"], "fc.bias": head["fc.bias"]},
                "dev_eer": 0.1, "config": {
                    "HEAD_TYPE": "linear",
                    "IN_DIM": comp["proj.weight"].shape[0]}},
               out["stage2"])
    save_hf_checkpoint(out["hf"], cfg, weights["encoder"])
    return out


def convert_front_door(tmp: str, files: dict, hf_config=None) -> dict:
    """The four files back through the two convert CLIs; the frozen
    stage 1 through --encoder_init. -> the output directories."""
    from wav2vec_contr_loss_torch.cli import (convert_hf_checkpoint,
                                              convert_reference_checkpoint)

    dirs = {k: os.path.join(tmp, k) for k in (
        "encoder_init", "stage1", "stage1_frozen", "stage2")}
    arch = [] if hf_config is None else ["--hf_config", hf_config]
    convert_hf_checkpoint.main(["--src", files["hf"],
                                "--out", dirs["encoder_init"]])
    convert_reference_checkpoint.main(["--src", files["stage1"],
                                       "--out", dirs["stage1"], *arch])
    convert_reference_checkpoint.main([
        "--src", files["stage1_frozen"], "--out", dirs["stage1_frozen"],
        "--encoder_init", dirs["encoder_init"]])
    convert_reference_checkpoint.main(["--src", files["stage2"],
                                       "--out", dirs["stage2"]])
    return dirs


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise distance in units in the last place of two float32 (or
    bf16) tensors of one sign pattern."""
    ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return (a.contiguous().view(ints).long()
            - b.contiguous().view(ints).long()).abs()


def compare_converted(weights, dirs: dict) -> dict:
    """Every converted tensor against the original: bit for bit, except
    the positional conv kernel, which went through the weight-norm pair
    (g·v/||v|| in fp32 is no identity) and is held to one ulp. Raises on
    a difference. -> {'tensors', 'bit_equal', 'pos_conv_off',
    'pos_conv_elems'}."""
    from wav2vec_contr_loss_torch.models.hf_convert import load_encoder_init
    from wav2vec_contr_loss_torch.train import checkpoint as ckpt

    got = {}
    for name in ("encoder_init", "stage1", "stage1_frozen"):
        cfg_name = "encoder" if name == "encoder_init" else "best"
        parts = ckpt.restore_parts(dirs[name], cfg_name,
                                   ("encoder",) if name == "encoder_init"
                                   else ("encoder", "compression"))
        for part, sd in parts.items():
            got[f"{name}.{part}"] = (weights[part], sd)
    got["stage2.head"] = (weights["head"],
                          ckpt.restore_checkpoint(dirs["stage2"],
                                                  "stage2_binary_head_best")[0])
    load_encoder_init(dirs["encoder_init"])   # the --encoder_init reader
    n = equal = off = elems = 0
    bad = []
    for where, (want, have) in got.items():
        if set(want) != set(have):
            bad.append(f"{where}: keys differ")
            continue
        for k, w in want.items():
            h = have[k]
            n += 1
            if h.dtype == w.dtype and torch.equal(h, w):
                equal += 1
            elif k == POS_CONV_KEY and h.dtype == w.dtype:
                d = ulps(h, w)
                off += int((d > 0).sum())
                elems += d.numel()
                if int(d.max()) > 1:
                    bad.append(f"{where}.{k}: {int(d.max())} ulps")
            else:
                bad.append(f"{where}.{k}")
    if bad:
        raise RuntimeError(f"converted weights differ: {bad[:8]}")
    return {"tensors": n, "bit_equal": equal, "pos_conv_off": off,
            "pos_conv_elems": elems}


def client_requests(paths: list, clients: int) -> list:
    """Each client's request lines: the paths dealt round-robin, every
    other line tagged `<id>\\t<path>`, the others bare."""
    out = [[] for _ in range(clients)]
    for i, p in enumerate(paths):
        out[i % clients].append(p if i % 2 == 0 else f"id{i:03d}\t{p}")
    return out


def run_clients(address, requests: list) -> tuple:
    """One thread and one connection a client; each sends a line, waits
    for its reply, then sends the next. -> ({line: reply logit}, request
    latencies in seconds, wall seconds). Raises unless every request is
    answered exactly once, in order, with its tag."""
    import socket
    import threading

    replies, latencies, errors = {}, [], []
    lock = threading.Lock()

    def client(lines):
        try:
            with socket.create_connection(address, timeout=120) as s:
                f = s.makefile("rw", encoding="utf-8", newline="\n")
                got = []
                for line in lines:
                    t0 = time.perf_counter()
                    f.write(line + "\n")
                    f.flush()
                    reply = f.readline()
                    dt = time.perf_counter() - t0
                    tag, _, value = reply.rstrip("\n").partition("\t")
                    want = line.partition("\t")[0]
                    if tag != want:
                        raise RuntimeError(f"reply {reply!r} to {line!r}")
                    got.append((line, float(value), dt))
                s.shutdown(socket.SHUT_WR)
                if f.readline():
                    raise RuntimeError("a reply beyond the requests")
            with lock:
                for line, value, dt in got:
                    replies[line] = value
                    latencies.append(dt)
        except Exception as e:  # reported after the join
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(lines,))
               for lines in requests]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    n = sum(len(r) for r in requests)
    if errors or any(t.is_alive() for t in threads) or len(replies) != n:
        raise RuntimeError(f"clients: {len(replies)} of {n} answered; "
                           f"{errors[:3]}")
    return replies, latencies, wall


def reference_logits(scorer, paths: list, batch: int) -> np.ndarray:
    """SpoofScorer.score_waveforms on each path's decoded and padded clip,
    in batches of `batch` zero-padded at the end."""
    from wav2vec_contr_loss_torch.data import AudioConfig, AudioLoader

    loader = AudioLoader(AudioConfig(16000, 5))
    waves = np.stack([loader.load(p) for p in paths])
    pad = -len(paths) % batch
    waves = np.concatenate([waves, np.zeros((pad, waves.shape[1]),
                                            np.float32)])
    return np.concatenate([scorer.score_waveforms(waves[i:i + batch])
                           for i in range(0, len(waves), batch)])[:len(paths)]


def run_clis(commands: dict, timeout: int = 300) -> dict:
    """`python -m wav2vec_contr_loss_torch <args>` for each named argument
    list, all started together from the repo's root. -> {name: stdout}.
    Raises if one exits non-zero; kills any still running on the way
    out."""
    root = os.path.dirname(os.path.abspath(__file__))
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "wav2vec_contr_loss_torch", *args], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, args in commands.items()}
    out, failed = {}, []
    try:
        for name, proc in procs.items():
            out[name], err = proc.communicate(timeout=timeout)
            if proc.returncode != 0:
                print(out[name][-3000:])
                print(err[-3000:], file=sys.stderr)
                failed.append(f"{name} exited {proc.returncode}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError(f"front-door processes failed: {failed}")
    return out


def front_door_phase(dev, results) -> dict:
    """Reference .pt files and an HF snapshot at XLS-R-300M width, written
    by the port's writers from the seed-0 weights, converted back by the
    CLIs and held to the originals; a 64-clip FLAC and WAV corpus plus a
    missing path served by ScoringServer (batch 8, max_wait 5 ms) to 16
    concurrent clients from the converted checkpoints, each reply against
    SpoofScorer.score_waveforms, with the launch counters reset just
    before the server starts and read after it stops; then `serve --list`
    and `serve --windowed mean` and `doctor` as subprocesses."""
    import shutil
    import tempfile
    import threading

    from wav2vec_contr_loss_torch import XLSR_300M, SpoofScorer
    from wav2vec_contr_loss_torch.data import AudioConfig, AudioLoader
    from wav2vec_contr_loss_torch.data.audio import native_decoder, write_wav
    from wav2vec_contr_loss_torch.data.pipeline import _finish_fetch
    from wav2vec_contr_loss_torch.eval.server import ScoringServer

    t_phase = time.perf_counter()
    native_decoder()   # built at set-up, not inside the first request
    tmp = tempfile.mkdtemp(prefix="chip_smoke_front_")
    try:
        t0 = time.perf_counter()
        files = write_reference_files(tmp, XLSR_300M, xlsr_weights(),
                                      "facebook/wav2vec2-xls-r-300m")
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        dirs = convert_front_door(tmp, files)
        convert_s = time.perf_counter() - t0
        cmp = compare_converted(xlsr_weights(), dirs)
        print(f"front door: wrote a finetuned and a frozen reference "
              f"stage-1 .pt, a stage-2 .pt and an HF snapshot in "
              f"{write_s:.1f} s; converted them with the CLIs in "
              f"{convert_s:.1f} s; {cmp['bit_equal']} of {cmp['tensors']} "
              f"tensors bit-equal to the originals, the rest the "
              f"positional conv kernel through g·v/||v||: "
              f"{cmp['pos_conv_off']} of {cmp['pos_conv_elems']} elements "
              f"one ulp off, none further")

        corpus = os.path.join(tmp, "corpus")
        os.makedirs(corpus)
        t0 = time.perf_counter()
        paths = write_front_door_corpus(corpus, FRONT_CLIPS, seed=31)
        corpus_s = time.perf_counter() - t0
        missing = os.path.join(corpus, "missing.flac")
        served = paths + [missing]

        scorer = SpoofScorer.from_checkpoints(dirs["stage1"], dirs["stage2"],
                                              device=dev)
        server = ScoringServer(scorer, "127.0.0.1", 0, batch=FRONT_BATCH,
                               max_wait_ms=FRONT_WAIT_MS,
                               log_fn=lambda m: None)
        # the collector's work for one batch makes no host sync
        probe = np.zeros((FRONT_BATCH, scorer.num_samples), np.float32)
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending = server.batcher.dispatch(probe)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        _finish_fetch(pending)
        serving = threading.Thread(target=server.serve_forever)
        serving.start()
        # one request first: the collector thread's first batch creates
        # its own cuBLAS and cuDNN handles
        _, first, _ = run_clients(server.address, [[paths[0]]])
        failed0 = AudioLoader.failed_count
        torch.cuda.synchronize()
        _reset_counters()
        batches0 = server.batcher.n_batches
        replies, lat, wall = run_clients(server.address, client_requests(
            served, FRONT_CLIENTS))
        stats = server.shutdown()
        serving.join(timeout=60)
        torch.cuda.synchronize()
        counts = _counters()
        n_failed = AudioLoader.failed_count - failed0
        nb = stats["batches"] - batches0
        occupancy = len(served) / (nb * FRONT_BATCH)
        if serving.is_alive():
            raise RuntimeError("the server's accept loop outlived shutdown")
        want = {"attention_fwd": XLSR_300M.num_layers * nb,
                "attention_bwd": 0, "ln_gelu_fwd": 7 * nb, "ln_gelu_bwd": 0,
                "supcon": 0}
        print(f"front door: server launches over {nb} batches {counts}, "
              f"expected {want}; failed decodes {n_failed} (expected 1, the "
              f"missing path)")
        if counts != want or n_failed != 1:
            raise RuntimeError("server launch counts or failed decodes "
                               "differ")
        by_path = {line.partition("\t")[2] or line: v
                   for line, v in replies.items()}
        got = np.array([by_path[p] for p in served])
        ref = reference_logits(scorer, served, FRONT_BATCH)
        gap = float(np.abs(got - ref).max())
        if not np.isfinite(got).all():
            raise RuntimeError("non-finite server logits")
        p50, p90 = (1e3 * float(x) for x in np.percentile(lat, [50, 90]))
        print(f"front door: {len(served)} requests ({FRONT_CLIPS // 2} "
              f"FLAC, {FRONT_CLIPS // 2} WAV of 3-7 s, 1 missing) from "
              f"{FRONT_CLIENTS} clients, one request in flight each: "
              f"{len(served) / wall:.1f} requests/s, latency p50 "
              f"{p50:.2f} ms p90 {p90:.2f} ms, {nb} batches, occupancy "
              f"{occupancy:.3f}; the first request after start "
              f"{1e3 * first[0]:.2f} ms; largest |server - score_waveforms| "
              f"{gap:.3e} (tol {FRONT_LOGIT_TOL}); corpus written in "
              f"{corpus_s:.1f} s [{CARD}]")
        if not gap <= FRONT_LOGIT_TOL:
            raise RuntimeError("server logits disagree with the scorer")

        # serve --list, serve --windowed and doctor, each in a process of
        # its own on the card, all three at once
        listing = os.path.join(tmp, "paths.txt")
        with open(listing, "w") as f:
            f.write("\n".join(served) + "\n")
        rng = np.random.default_rng(32)
        long_paths = []
        for i in range(2):
            p = os.path.join(tmp, f"long_{i}.wav")
            write_wav(p, (0.2 * rng.standard_normal(12 * 16000)
                          ).astype(np.float32))
            long_paths.append(p)
        long_listing = os.path.join(tmp, "long.txt")
        with open(long_listing, "w") as f:
            f.write("\n".join(long_paths) + "\n")
        ckpts = ["--stage1_dir", dirs["stage1"], "--stage2_dir",
                 dirs["stage2"]]
        t0 = time.perf_counter()
        outs = run_clis({
            "serve --list": ["serve", *ckpts, "--list", listing],
            "serve --windowed": ["serve", *ckpts, "--list", long_listing,
                                 "--windowed", "mean"],
            "doctor": ["doctor"]})
        cli_s = time.perf_counter() - t0
        lines = [ln.split("\t") for ln in outs["serve --list"].splitlines()]
        if [ln[0] for ln in lines] != served:
            raise RuntimeError("serve --list did not print one line a path "
                               "in order")
        cli_gap = float(np.abs(np.array([float(ln[1]) for ln in lines])
                               - got).max())
        print(f"front door: serve --list, serve --windowed and doctor as "
              f"three processes at once in {cli_s:.1f} s (start and "
              f"checkpoint loads included); serve --list: {len(lines)} "
              f"lines, largest |serve - server| {cli_gap:.3e} (tol "
              f"{FRONT_LOGIT_TOL})")
        if not cli_gap <= FRONT_LOGIT_TOL:
            raise RuntimeError("serve --list disagrees with the server")

        full = AudioLoader(AudioConfig(16000, None))
        want_win = scorer.score_long_waveforms(
            [full.load(p) for p in long_paths], agg="mean")
        win = np.array([float(ln.split("\t")[1])
                        for ln in outs["serve --windowed"].splitlines()])
        win_gap = float(np.abs(win - want_win).max())
        print(f"front door: serve --windowed mean on two 12 s clips "
              f"{win.tolist()} vs score_long_waveforms {want_win.tolist()}: "
              f"|d| {win_gap:.3e} (tol {WINDOWED_TOL})")
        if win.shape != (2,) or not win_gap <= WINDOWED_TOL:
            raise RuntimeError("serve --windowed disagrees with "
                               "score_long_waveforms")
        print("\n".join(f"front door: doctor: {ln}"
                        for ln in outs["doctor"].splitlines()))
        del scorer, server
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name, n in counts.items():
        results[name]["front_door_launches"] = n
    phase_s = time.perf_counter() - t_phase
    print(f"front door phase: {phase_s:.1f} s [{CARD}]")
    return {"requests_per_s": len(served) / wall, "p50_ms": p50,
            "p90_ms": p90, "occupancy": occupancy, "gap": gap}


# ------------------------------------------------- artifact and int8
# JAX's bounds on the quantization error of the encoder's layer mean
# (tests/test_quant.py:83-98), which it holds in fp32: here the fp32 CPU
# run of each mode against the fp32 CPU run unquantized, on the same
# weights and clips
QUANT_REL_TOL = {"w8": 0.02, "w8a8": 0.05}
# a loaded artifact against the live scorer it was exported from: the
# same kernels on the same weights and inputs
ARTIFACT_TOL = 1e-3
# `serve --artifact` against score_waveforms: 6 printed decimals + this
ARTIFACT_CLI_TOL = 1e-3


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def int8_bytes(scorer) -> int:
    """Bytes of the int8 weights of a quantized scorer's encoder."""
    return sum(b.numel() for b in scorer.encoder.buffers()
               if b.dtype == torch.int8)


def quant_cpu_reference(cfg, weights, waves) -> dict:
    """{mode: (layer_mean, z, logits)} of the fp32 scorer on the CPU for
    'none', 'w8' and 'w8a8' on the (n, T) clips `waves`."""
    from wav2vec_contr_loss_torch import SpoofScorer, Stage2Config

    out = {}
    x = torch.from_numpy(waves)
    for mode in ("none", "w8", "w8a8"):
        cpu = SpoofScorer(cfg.with_(dtype="float32"), weights, Stage2Config(),
                          device="cpu", quantize=mode)
        with torch.inference_mode():
            lm = cpu.encoder(x, x != 0.0)["layer_mean"]
        out[mode] = (lm, *cpu.run(x))
    return out


def _launches_over(fn, n_batches: int) -> dict:
    """Run fn() with the launch counters reset just before and read just
    after; raise unless it made exactly the serving launches of
    n_batches batches."""
    from wav2vec_contr_loss_torch import XLSR_300M

    torch.cuda.synchronize()
    _reset_counters()
    fn()
    torch.cuda.synchronize()
    counts = _counters()
    want = {"attention_fwd": XLSR_300M.num_layers * n_batches,
            "attention_bwd": 0, "ln_gelu_fwd": 7 * n_batches,
            "ln_gelu_bwd": 0, "supcon": 0}
    if counts != want:
        raise RuntimeError(f"launches {counts}, expected {want}")
    return counts


def artifact_phase(dev, results) -> dict:
    """int8 serving and the serving artifact at XLS-R-300M width from the
    seed-0 weights, on the serve phase's batches. First a `torch.export`
    artifact of the bf16 scorer and one of the w8a8 scorer at batch 8
    (export seconds, bytes), with `serve --artifact` on 8 clips as a
    process of its own beside the second export and the fp32 CPU
    references, waited for before anything is timed on the card, its
    scores against score_waveforms. Then the w8 and w8a8 scorers: exact
    launches over 4 batches (24 attention and 7 LN+GELU forwards a
    batch, nothing else), their layer mean against the bf16 scorer's, z
    and logits against the fp32 CPU run of the same mode, the
    quantization error of the fp32 CPU runs against JAX's bounds, ms a
    batch, device ms and operations, peak memory and int8 bytes. Then
    each artifact loaded back in this process and run over 4 batches
    with exact launches, against its live scorer, ms a batch, device ms
    and operations."""
    import shutil
    import tempfile
    import threading

    from wav2vec_contr_loss_torch import XLSR_300M, SpoofScorer, Stage2Config
    from wav2vec_contr_loss_torch.eval.artifact import load_exported

    t_phase = time.perf_counter()
    cfg = XLSR_300M
    weights = xlsr_weights()
    waves = serving_waves(np.random.default_rng(1), N_BATCHES)
    x0 = torch.from_numpy(waves[0])
    scorers, bind_s = {}, {}
    for mode in ("none", "w8", "w8a8"):
        t0 = time.perf_counter()
        scorers[mode] = SpoofScorer(cfg, weights, Stage2Config(), device=dev,
                                    quantize=mode)
        bind_s[mode] = time.perf_counter() - t0
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_artifact_")
    try:
        files, cli, cli_failed = {}, {}, []
        for mode in ("none", "w8a8"):
            t0 = time.perf_counter()
            blob = scorers[mode].export(BATCH)
            out[f"artifact_{mode}"] = {"export_s": time.perf_counter() - t0}
            files[mode] = os.path.join(tmp, f"scorer_{mode}.w2vexport")
            with open(files[mode], "wb") as f:
                f.write(blob)
            del blob
            if mode != "none":
                continue
            corpus = os.path.join(tmp, "clips")
            os.makedirs(corpus)
            paths = write_front_door_corpus(corpus, BATCH, seed=33)
            listing = os.path.join(tmp, "paths.txt")
            with open(listing, "w") as f:
                f.write("\n".join(paths) + "\n")

            def serve_artifact():
                try:
                    cli.update(run_clis({"serve --artifact": [
                        "serve", "--artifact", files["none"], "--list",
                        listing]}))
                except Exception as e:   # re-raised after the join
                    cli_failed.append(e)

            t_cli = time.perf_counter()
            serving = threading.Thread(target=serve_artifact)
            serving.start()
        t0 = time.perf_counter()
        cpu = quant_cpu_reference(cfg, weights, waves[0, :2])
        cpu_s = time.perf_counter() - t0
        serving.join()
        cli_s = time.perf_counter() - t_cli
        if cli_failed:
            raise cli_failed[0]
        lines = [ln.split("\t") for ln in
                 cli["serve --artifact"].splitlines()]
        if [ln[0] for ln in lines] != paths:
            raise RuntimeError("serve --artifact did not print one line a "
                               "path in order")
        want = reference_logits(scorers["none"], paths, BATCH)
        cli_gap = float(np.abs(np.array([float(ln[1]) for ln in lines])
                               - want).max())
        print(f"artifact: serve --artifact --list on {len(paths)} clips as "
              f"a process of its own in {cli_s:.1f} s (beside the second "
              f"export and the CPU references); largest |serve - "
              f"score_waveforms| {cli_gap:.3e} (tol 1e-6 + "
              f"{ARTIFACT_CLI_TOL}); fp32 CPU references of 2 clips in "
              f"{cpu_s:.1f} s")
        if not cli_gap <= 1e-6 + ARTIFACT_CLI_TOL:
            raise RuntimeError("serve --artifact disagrees with the scorer")
        out["serve_artifact_gap"] = cli_gap

        with torch.inference_mode():
            lm_bf16 = scorers["none"].encoder(
                x0.to(dev), x0.to(dev) != 0.0)["layer_mean"].float().cpu()
        for mode in ("w8", "w8a8"):
            q_err = _rel(cpu[mode][0], cpu["none"][0])
            print(f"int8 {mode}: fp32 CPU layer-mean relative error "
                  f"{q_err:.5f} (JAX bound {QUANT_REL_TOL[mode]})")
            if not q_err <= QUANT_REL_TOL[mode]:
                raise RuntimeError(f"{mode} quantization error above JAX's "
                                   f"bound")
            q = scorers[mode]
            counts = _launches_over(
                lambda: [q.score_waveforms(w) for w in waves], N_BATCHES)
            with torch.inference_mode():
                lm = q.encoder(x0.to(dev), x0.to(dev) != 0.0)["layer_mean"]
                z, lg = q.run(x0[:2])
            lm_err = _rel(lm.float().cpu(), lm_bf16)
            z_err = (z.cpu() - cpu[mode][1]).abs().max().item()
            l_err = (lg.cpu() - cpu[mode][2]).abs().max().item()
            ms, p90 = closed_loop_ms(q.score_waveforms, waves)
            peak = torch.cuda.max_memory_allocated() / 2**30
            prof = profile_serving(q.score_waveforms, waves, f"int8 {mode}",
                                   n=1)
            nbytes = int8_bytes(q)
            print(f"int8 {mode}: launches {counts} over {N_BATCHES} "
                  f"batches; layer mean vs the bf16 scorer relative "
                  f"{lm_err:.5f}; vs the fp32 CPU run of {mode}: z "
                  f"max_abs_err {z_err:.3e} (tol {Z_TOL}), logit "
                  f"{l_err:.3e} (tol {LOGIT_TOL}); {ms:.2f} ms a batch "
                  f"(median of 30, p90 {p90:.2f}); peak {peak:.2f} GiB; int8 "
                  f"weights {nbytes} bytes; bound in {bind_s[mode]:.1f} s "
                  f"[{CARD}]")
            if not (z_err <= Z_TOL and l_err <= LOGIT_TOL):
                raise RuntimeError(f"{mode} on the card disagrees with the "
                                   f"CPU")
            out[mode] = {"launches": counts, "layer_mean_rel": lm_err,
                         "quant_rel_fp32": q_err, "ms": ms, "p90_ms": p90,
                         "peak_gib": peak, "int8_bytes": nbytes, **prof}
            for name in ("attention_fwd", "ln_gelu_fwd"):
                results[name][f"{mode}_launches"] = counts[name]
        del cpu

        artifact_launches = {"attention_fwd": 0, "ln_gelu_fwd": 0}
        for mode in ("none", "w8a8"):
            live = scorers[mode]
            t0 = time.perf_counter()
            art, spec = load_exported(files[mode], with_spec=True)
            load_s = time.perf_counter() - t0
            logits = []
            counts = _launches_over(lambda: logits.extend(
                art(torch.from_numpy(w)) for w in waves), N_BATCHES)
            want = np.stack([live.score_waveforms(w) for w in waves])
            got = np.stack([lg.cpu().numpy() for lg in logits])
            gap = float(np.abs(got - want).max())
            art_ms, art_p90 = closed_loop_ms(
                lambda w: art(torch.from_numpy(w)).cpu(), waves)
            live_ms, _ = closed_loop_ms(live.score_waveforms, waves)
            prof = profile_serving(lambda w: art(torch.from_numpy(w)),
                                   waves, f"artifact {mode}", n=1)
            size = os.path.getsize(files[mode])
            calls = [str(n.target) for n in art._program.graph.nodes
                     if n.op == "call_function"]
            asserts = sum("_assert_tensor_metadata" in c for c in calls)
            export_s = out[f"artifact_{mode}"]["export_s"]
            print(f"artifact {mode}: {spec}; exported in {export_s:.1f} s, "
                  f"{size} bytes, loaded in {load_s:.1f} s; {len(calls)} "
                  f"op nodes, {asserts} of them metadata asserts; launches "
                  f"{counts} over {N_BATCHES} batches; largest |artifact - "
                  f"live| {gap:.3e} (tol {ARTIFACT_TOL}); {art_ms:.2f} ms a "
                  f"batch (p90 {art_p90:.2f}) against the live scorer's "
                  f"{live_ms:.2f} [{CARD}]")
            if not (np.isfinite(got).all() and gap <= ARTIFACT_TOL):
                raise RuntimeError(f"the {mode} artifact disagrees with "
                                   f"its live scorer")
            for name in artifact_launches:
                artifact_launches[name] += counts[name]
            out[f"artifact_{mode}"].update(
                bytes=size, load_s=load_s, gap=gap, ms=art_ms,
                live_ms=live_ms, op_nodes=len(calls), assert_nodes=asserts,
                **prof)
            del art
        for name, n in artifact_launches.items():
            results[name]["artifact_launches"] = n
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del scorers
    torch.cuda.empty_cache()
    print(f"artifact and int8 phase: {time.perf_counter() - t_phase:.1f} s "
          f"[{CARD}]")
    return out


PARALLEL_STEPS = 4               # leg A: steps of each layout
# leg B against one process at the global batch (bf16 on both sides; the
# gang splits the batch's matrix products and sums its partial products
# in another order): the loss and the first step's gradients, each
# parameter group's cosine, at the step_vs_cpu limits of PERF.md
# section 2; the 3-step AdamW update of each group at cosine 0.99,
# because Adam's step lr * m / sqrt(v) is near lr * sign(g) in its first
# steps, so a gradient element at rounding level takes a full step
# either way (tests/test_torch_train.py says the same of the CPU): the
# updates of dp and fsdp were measured at 0.9983-0.99999, of tp at
# 0.9945-0.9993, from losses 3e-6 apart (PERF.md, PR 10)
PARALLEL_LOSS_RTOL = STEP_LOSS_TOL
PARALLEL_GRAD_COS = STEP_GRAD_COS
PARALLEL_UPDATE_COS = 0.99
# the first step's gradient norms, of each group of UPDATE_GROUPS and of
# each optimizer group as its clip computes them over the shards, within
# this of one process's: Adam and the cosines are blind to a gradient's
# scale, which a missing or doubled average over 'data' moves by a
# factor of 2 and a shard's square summed twice by sqrt(2). A norm moves
# with the mean of its largest elements' bf16 rounding (first order)
# where a cosine moves with its square: measured 2.7e-4 (dp, fsdp) and
# 1.66e-3 (tp) on an H100 at gradient cosines >= 0.99977, and 1.45e-3
# for dp in bf16 on the CPU with no kernel (PERF.md, PR 10); fp32 on the
# CPU agrees to 1.2e-6 (tests/test_torch_multiprocess.py holds 1e-3)
PARALLEL_NORM_RTOL = 1e-2
# leg B's layouts: Gloo takes CUDA tensors in every collective the
# layouts use, reduce_scatter_tensor and all_gather_into_tensor (FSDP2)
# included (parallel/gloo_probe.py on the card, PERF.md); 'tp_sp'
# adds sequence parallelism to tp (the 99 frames of 2 s clips, padded to
# 100), and leg B4 runs 'fsdp_tp_sp' on (2, 2), four Gloo ranks
LEG_B = ["dp", "tp", "fsdp", "tp_sp"]
LEG_B4 = ["fsdp_tp_sp"]
# the pipeline leg: 'pp' at XLS-R-300M's full depth on two Gloo ranks
# (two stages of 12 layers, M = 4 microbatches), then gang extraction on
# the same ranks; Gloo refuses point-to-point transfers of CUDA tensors
# (parallel/gloo_probe.py, PERF.md), so the hand-offs ride host
# memory
LEG_PP = ["pp", "extract"]
# gang extraction against one process: both bf16, the same kernels on
# the same rows; measured 7.45e-8 on an H100 (PERF.md), so the
# limit is 1e-3, under the 5e-2 of bf16 against fp32: a row split that
# changed cuBLAS's choice of kernel could move bf16 outputs by ~1e-3
EXTRACT_TOL = 1e-3
# parameter groups of leg B's update cosine, by a word of the name
UPDATE_GROUPS = ("feature_extractor", "feature_projection", "pos_conv_embed",
                 "attention", "feed_forward", "layer_norm", "compression")

def _grouped(start, got: dict, want: dict, device) -> dict:
    """{group: (got's, want's flat float64 vectors on `device`)} of two
    runs' updates (end - start; with `start` None, of the tensors
    themselves) over the parameters whose names hold the group's word
    (UPDATE_GROUPS; a name goes to its first group)."""
    flat = {g: ([], []) for g in UPDATE_GROUPS}
    for name in want:
        group = next((g for g in UPDATE_GROUPS if g in name), None)
        if group is None:
            continue
        s0 = 0.0 if start is None else start[name].to(device).double()
        for out, run in zip(flat[group], (got, want)):
            out.append((run[name].to(device).double() - s0).reshape(-1))
    return {g: (torch.cat(a), torch.cat(b)) for g, (a, b) in flat.items()
            if a}


def update_cosines(start: dict, got: dict, want: dict,
                   device="cpu") -> dict:
    """{group: cosine of two runs' updates} (`_grouped`)."""
    return {g: float(a @ b / (a.norm() * b.norm()))
            for g, (a, b) in _grouped(start, got, want, device).items()}


def norm_ratios(got: dict, want: dict, device="cpu") -> dict:
    """{group: norm of got's tensors over want's} (`_grouped`)."""
    return {g: float(a.norm() / b.norm())
            for g, (a, b) in _grouped(None, got, want, device).items()}


def parallel_leg_a(dev) -> dict:
    """Leg A: a world of one NCCL rank at XLS-R-300M width, B = 32 x 5 s,
    the train phase's settings with device RawBoost ('fft'): 4 steps of
    the plain trainer, of 'replicated' (gradients averaged over 'data')
    and of 'fsdp' (FSDP2 per layer) on one fixed batch, deterministic
    algorithms on, the launch counters reset just before each and read
    just after."""
    from wav2vec_contr_loss_torch import XLSR_300M, Stage1Config, Stage1Trainer
    from wav2vec_contr_loss_torch.parallel import mp_smoke
    from wav2vec_contr_loss_torch.parallel.mesh import make_mesh
    from wav2vec_contr_loss_torch.utils import distributed

    os.environ.update(MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(mp_smoke.free_port()), RANK="0",
                      WORLD_SIZE="1", LOCAL_RANK="0")
    distributed.maybe_initialize(force=True, device="cuda")
    mesh = make_mesh(device_type="cuda")
    print(f"parallel leg A: process group up "
          f"{time.perf_counter() - T_START:.1f} s after start")
    print(f"parallel leg A: {torch.distributed.get_backend()}, world size "
          f"{torch.distributed.get_world_size()}, mesh "
          f"{tuple(mesh.shape)} {mesh.mesh_dim_names}")
    cfg = XLSR_300M
    scfg = Stage1Config(finetune_encoder=True)
    t0 = time.perf_counter()
    weights = xlsr_weights()
    batch = train_batch(np.random.default_rng(2), scfg.batch_size)
    print(f"parallel leg A: weights and batch in "
          f"{time.perf_counter() - t0:.1f} s")
    want = {k: v * PARALLEL_STEPS
            for k, v in expected_train_launches(scfg, cfg).items()}
    runs = {}
    for name, on_mesh, sharding in (("plain", None, "replicated"),
                                    ("replicated", mesh, "replicated"),
                                    ("fsdp", mesh, "fsdp")):
        t0 = time.perf_counter()
        trainer = Stage1Trainer(scfg.replace(param_sharding=sharding), cfg,
                                weights, device=dev, mesh=on_mesh)
        torch.cuda.synchronize()
        built = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        _reset_counters()
        losses, times = [], []
        for _ in range(PARALLEL_STEPS):
            t0 = time.perf_counter()
            losses.append(trainer.train_step(batch, 1.0)["loss"].item())
            times.append(time.perf_counter() - t0)
        counts = _counters()
        runs[name] = dict(losses=losses, counts=counts,
                          ms=1e3 * float(np.median(times[1:])),
                          peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        print(f"parallel leg A {name}: losses {losses}, step "
              f"{runs[name]['ms']:.1f} ms (median of steps 2-"
              f"{PARALLEL_STEPS}; step 1 {1e3 * times[0]:.1f} ms; built in "
              f"{built:.1f} s), peak {runs[name]['peak_gib']:.2f} GiB, "
              f"launches {counts} [{CARD}]")
        if counts != want:
            raise RuntimeError(f"leg A {name}: launches {counts}, expected "
                               f"{want}")
        if not np.isfinite(losses).all():
            raise RuntimeError(f"leg A {name}: non-finite loss")
        del trainer
        torch.cuda.empty_cache()
    plain = runs["plain"]["losses"]
    if runs["replicated"]["losses"] != plain:
        raise RuntimeError("leg A: the replicated losses are not the plain "
                           "trainer's bits")
    fsdp_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(runs["fsdp"]["losses"], plain))
    print(f"parallel leg A: replicated losses bit-equal to the plain "
          f"trainer's; fsdp bit-equal: {runs['fsdp']['losses'] == plain}, "
          f"largest relative difference {fsdp_rel:.3e} (limit "
          f"{PARALLEL_LOSS_RTOL})")
    if fsdp_rel > PARALLEL_LOSS_RTOL:
        raise RuntimeError("leg A: fsdp losses off the plain trainer's")
    torch.distributed.destroy_process_group()
    launches = {k: runs["replicated"]["counts"][k] + runs["fsdp"]["counts"][k]
                for k in want}
    return {"leg_a": {k: {m: v[m] for m in ("losses", "ms", "peak_gib")}
                      for k, v in runs.items()},
            "leg_a_fsdp_bit_equal": runs["fsdp"]["losses"] == plain,
            "parallel_launches": launches}


def start_gang(dev, tmp: str, legs: list, n: int = 2, width: str = "wide",
               save=(), timeout: float = 300):
    """A gang of `n` ranks running `legs`, started in a thread: the ranks
    (Gloo: NCCL refuses two ranks on one card) join their group, make
    their weights, then wait for <tmp>/go before their first step; the
    gang must end within `timeout` s of its start, the wait included.
    -> (the future of launch_gang's results, the go file)."""
    from concurrent.futures import ThreadPoolExecutor

    from wav2vec_contr_loss_torch.parallel import mp_smoke

    os.makedirs(tmp, exist_ok=True)
    go = os.path.join(tmp, "go")
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(mp_smoke.launch_gang, tmp, legs, n=n,
                      device=dev.type,
                      backend="gloo" if dev.type == "cuda" else None,
                      width=width, timeout=timeout, save=list(save),
                      grads=True, go=go)
    pool.shutdown(wait=False)
    return fut, go


def _run_gang(started) -> tuple:
    """Release a started gang and wait for it. -> (its results, seconds)."""
    fut, go = started
    t0 = time.perf_counter()
    open(go, "w").close()
    return fut.result(), time.perf_counter() - t0


def hold_legs(dev, tmp: str, gang: dict, legs: list, job, refs: dict,
              want: dict, label: str, weights=None) -> dict:
    """Each leg of `gang` against one process at the global batch
    (`refs[leg]`, run_leg's result with grads): the loss within
    PARALLEL_LOSS_RTOL on every rank, the exact launches `want` a rank,
    the first-step gradient and 3-step update cosines by name group, and
    the gradient norms by name group and as each rank's clip computes
    them within PARALLEL_NORM_RTOL. `weights`: the legs' initial
    weights, when the caller has made them. -> {leg: its numbers};
    raises on a miss."""
    from wav2vec_contr_loss_torch.parallel import mp_smoke

    cfg = mp_smoke.encoder_config(True, job.width)
    scfg = mp_smoke.stage1_config(job, True, "replicated")
    start = {f"{part}.{k}": v for part, sd in (
        weights or mp_smoke.initial_weights(cfg, scfg.hidden_dim)).items()
        for k, v in sd.items()}
    out, low = {}, []
    for leg in legs:
        ref = refs[leg]
        state = torch.load(os.path.join(tmp, f"{leg}.pt"))
        for rank, r in enumerate(gang[leg]):
            rel = [abs(a - b) / abs(b) for a, b in
                   zip(r["losses"], ref["losses"])]
            print(f"parallel leg {label} {leg} rank {rank}: losses "
                  f"{r['losses']} (one process {ref['losses']}, relative "
                  f"{max(rel):.2e}), ms a step "
                  f"{[round(x, 1) for x in r['ms']]}, peak {r['peak_gib']} "
                  f"GiB, launches {r['launches']} [{CARD}]")
            if max(rel) > PARALLEL_LOSS_RTOL:
                raise RuntimeError(f"leg {label} {leg}: loss off the single "
                                   f"process's")
            if r["launches"] != want[leg]:
                raise RuntimeError(f"leg {label} {leg}: launches "
                                   f"{r['launches']}, expected {want[leg]}")
        grads = torch.load(os.path.join(tmp, f"{leg}.grad.pt"))
        grad = update_cosines(None, grads, ref["grads"], dev)
        cos = update_cosines(start, state, ref["state"], dev)
        ratio = norm_ratios(grads, ref["grads"], dev)
        ratio.update({f"clip {rank} {g}": r["grad_norms"][g] / n
                      for rank, r in enumerate(gang[leg])
                      for g, n in ref["grad_norms"].items()})
        print(f"parallel leg {label} {leg}: first-step gradient cosines "
              f"{ {g: round(c, 6) for g, c in grad.items()} }; norm ratios "
              f"{ {g: round(c, 6) for g, c in ratio.items()} }; "
              f"{len(ref['losses'])}-step update cosines "
              f"{ {g: round(c, 6) for g, c in cos.items()} }")
        low += [(leg, "gradient", g) for g, c in grad.items()
                if c < PARALLEL_GRAD_COS]
        low += [(leg, "update", g) for g, c in cos.items()
                if c < PARALLEL_UPDATE_COS]
        low += [(leg, "norm", g) for g, c in ratio.items()
                if not abs(c - 1) <= PARALLEL_NORM_RTOL]
        out[leg] = dict(losses=gang[leg][0]["losses"],
                        ms=float(np.median(gang[leg][0]["ms"][1:])),
                        peak_gib=gang[leg][0]["peak_gib"],
                        launches=gang[leg][0]["launches"],
                        min_grad_cos=min(grad.values()),
                        min_update_cos=min(cos.values()),
                        max_norm_dev=max(abs(c - 1)
                                         for c in ratio.values()))
    if low:
        raise RuntimeError(f"leg {label}: cosines or norms beyond their "
                           f"limits ({PARALLEL_GRAD_COS} gradient, "
                           f"{PARALLEL_UPDATE_COS} update, "
                           f"{PARALLEL_NORM_RTOL} norm): {low}")
    return out


def parallel_leg_b(dev, tmp: str, width: str = "wide", started=None,
                   legs=LEG_B, n: int = 2, label: str = "B") -> dict:
    """Leg B: two Gloo ranks on this one card, XLS-R-300M widths at 4
    layers, B = 16 x 2 s (99 frames), bf16, every dropout, SpecAugment
    and device RawBoost on: LEG_B's layouts, 3 steps each
    (parallel/mp_smoke.py), against one process at the global batch
    with the same seeds (`hold_legs`); the tensor-parallel gang's
    checkpoint restored into one process. With `legs` LEG_B4 and `n` 4,
    leg B4. `started`: start_gang's (future, go file), else it starts
    here. (`width` 'tiny' on the CPU rehearses it, where no kernel
    launches.)"""
    from wav2vec_contr_loss_torch import Stage1Trainer
    from wav2vec_contr_loss_torch.parallel import mp_smoke

    job = mp_smoke.Job.named(width)
    on_card = dev.type == "cuda"
    gang, t_gang = _run_gang(started or start_gang(
        dev, tmp, legs, n, width, save=["tp"] if "tp" in legs else ()))
    t0 = time.perf_counter()
    runs = {}   # one reference per job (a tiny sp leg's clips differ)
    for leg in legs:
        if job.for_leg(leg) not in runs:
            runs[job.for_leg(leg)] = mp_smoke.run_leg(
                "dp", None, dev, job.for_leg(leg), grads=True)
    refs = {leg: runs[job.for_leg(leg)] for leg in legs}
    print(f"parallel leg {label}: the gang's run {t_gang:.1f} s (legs "
          f"{ {leg: round(r[0]['seconds'], 1) for leg, r in gang.items()} } "
          f"s), one process {time.perf_counter() - t0:.1f} s")
    cfg = mp_smoke.encoder_config(True, width)
    scfg = mp_smoke.stage1_config(job, True, "replicated")
    want = {leg: {k: v * job.steps * on_card for k, v in
                  expected_train_launches(scfg, cfg).items()} for leg in legs}
    out = hold_legs(dev, tmp, gang, legs, job, refs, want, label)
    single_ms = float(np.median(refs[legs[0]]["ms"][1:]))
    if "tp" in legs:   # the tensor-parallel gang's checkpoint
        tp = torch.load(os.path.join(tmp, "tp.pt"))
        one = Stage1Trainer.from_checkpoint(os.path.join(tmp, "ckpt", "tp"),
                                            "latest", device=dev)
        back = mp_smoke.model_state(one)
        if set(back) != set(tp) or not all(torch.equal(back[k], tp[k])
                                           for k in tp):
            raise RuntimeError("leg B: the tensor-parallel checkpoint did "
                               "not restore bit for bit")
        print(f"parallel leg B: the tp gang's checkpoint restored into one "
              f"process bit for bit ({len(tp)} tensors)")
    print(f"parallel leg {label}: the gang's run {t_gang:.1f} s; one "
          f"process at B = {job.batch}: {single_ms:.1f} ms a step, peak "
          f"{refs[legs[0]]['peak_gib']} GiB [{CARD}]")
    key = "leg_b" if label == "B" else f"leg_{label.lower()}"
    return {key: out, f"{key}_single_ms": single_ms, f"{key}_gang_s": t_gang}


def pp_launches(scfg, cfg, stages: int) -> dict:
    """Kernel launches of one pipelined step on one stage's rank: its
    L / S layers on each of the M microbatches (twice with remat), the
    replicated conv tower once, SupCon once on the gathered batch."""
    per = cfg.num_layers // stages * scfg.pipeline_microbatches
    return dict(expected_train_launches(scfg, cfg),
                attention_fwd=per * (2 if scfg.remat_encoder else 1),
                attention_bwd=per)


def parallel_leg_pp(dev, tmp: str, width: str = "full",
                    started=None) -> dict:
    """The pipeline leg: two Gloo ranks on this one card, XLS-R-300M at
    24 layers ('full': B = 32 x 5 s, bf16, remat, every draw on), two
    stages, M = 4, 3 steps, held against one process with the same seeds
    (`hold_legs`: loss, first-step gradient cosines and norms by group,
    3-step updates) and the exact launches a rank (`pp_launches`); then
    gang extraction on the same two ranks (48 clips at batch 32, the last
    batch half padded) against one process's embeddings in corpus order
    within EXTRACT_TOL. (`width` 'tiny' on the CPU rehearses it.)"""
    from wav2vec_contr_loss_torch.parallel import mp_smoke

    job = mp_smoke.Job.named(width)
    on_card = dev.type == "cuda"
    gang, t_gang = _run_gang(started or start_gang(dev, tmp, LEG_PP, 2,
                                                   width, save=()))
    cfg = mp_smoke.encoder_config(True, width)
    scfg = mp_smoke.stage1_config(job, True, "pp", **mp_smoke.PP)
    t0 = time.perf_counter()
    weights = mp_smoke.initial_weights(cfg, scfg.hidden_dim)
    ref = mp_smoke.run_leg("pp", None, dev, job, weights, grads=True)
    if on_card:
        torch.cuda.empty_cache()
    ref_extract = mp_smoke.extract_leg(None, dev, job, weights)
    print(f"parallel leg pp: the gang's run {t_gang:.1f} s (legs "
          f"{ {leg: round(r[0]['seconds'], 1) for leg, r in gang.items()} } "
          f"s), one process {time.perf_counter() - t0:.1f} s")
    want = {"pp": {k: v * job.steps * on_card
                   for k, v in pp_launches(scfg, cfg, 2).items()}}
    out = hold_legs(dev, tmp, gang, ["pp"], job, {"pp": ref}, want, "pp",
                    weights)
    del weights
    single_ms = float(np.median(ref["ms"][1:]))
    print(f"parallel leg pp: 2 stages x M = {scfg.pipeline_microbatches}, "
          f"{cfg.num_layers} layers, B = {job.batch}: "
          f"{out['pp']['ms']:.1f} ms a step, peak {out['pp']['peak_gib']} "
          f"GiB a rank (rank 1 {np.median(gang['pp'][1]['ms'][1:]):.1f} "
          f"ms, {gang['pp'][1]['peak_gib']} GiB); one process "
          f"{single_ms:.1f} ms, {ref['peak_gib']} GiB [{CARD}]")
    n_clips, batch = mp_smoke.EXTRACT[width]
    want_ex = {k: v * on_card for k, v in expected_extract_launches(
        cfg, -(-n_clips // batch)).items()}
    want_z = np.asarray(ref_extract["embeddings"])
    worst = 0.0
    for rank, r in enumerate(gang["extract"]):
        z = np.asarray(r["embeddings"])
        if z.shape != want_z.shape or r["labels"] != ref_extract["labels"]:
            raise RuntimeError(f"gang extraction rank {rank}: {z.shape} "
                               f"rows, not one process's {want_z.shape} "
                               f"in corpus order")
        worst = max(worst, float(np.abs(z - want_z).max()))
        if r["launches"] != want_ex:
            raise RuntimeError(f"gang extraction rank {rank}: launches "
                               f"{r['launches']}, expected {want_ex}")
    print(f"parallel leg pp: gang extraction of {n_clips} clips at batch "
          f"{batch} on 2 ranks: {gang['extract'][0]['ms']:.1f} ms (one "
          f"process {ref_extract['ms']:.1f} ms), embeddings within "
          f"{worst:.3e} of one process's in corpus order (limit "
          f"{EXTRACT_TOL}), launches a rank {gang['extract'][0]['launches']}"
          f" [{CARD}]")
    if not worst <= EXTRACT_TOL:
        raise RuntimeError("gang extraction off one process's embeddings")
    return {"leg_pp": out, "leg_pp_single_ms": single_ms,
            "leg_pp_single_peak_gib": ref["peak_gib"],
            "leg_pp_gang_s": t_gang, "extract_max_abs_err": worst,
            "extract_ms": gang["extract"][0]["ms"],
            "extract_single_ms": ref_extract["ms"],
            "parallel_launches": {
                k: gang["pp"][0]["launches"][k]
                + gang["extract"][0]["launches"][k] for k in want_ex}}


def parallel_main() -> int:
    """The parallel phase in a process of its own (`--parallel`, with
    CUBLAS_WORKSPACE_CONFIG=:4096:8 for leg A's deterministic
    algorithms): leg A in this process; the gangs of leg B, leg B4 and
    the pipeline leg spawned at the start (their ranks start up during
    leg A) and released one after another."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    import shutil
    import tempfile

    global CARD
    CARD = read_card()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    dirs = {k: os.path.join(tmp, k) for k in ("b", "b4", "pp")}
    started = {}
    try:
        started = {"b": start_gang(dev, dirs["b"], LEG_B, 2, save=["tp"]),
                   "b4": start_gang(dev, dirs["b4"], LEG_B4, 4),
                   "pp": start_gang(dev, dirs["pp"], LEG_PP, 2, "full",
                                    timeout=500)}
        t0 = time.perf_counter()
        torch.use_deterministic_algorithms(True)
        res = parallel_leg_a(dev)
        torch.use_deterministic_algorithms(False)
        print(f"parallel leg A: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        res.update(parallel_leg_b(dev, dirs["b"], started=started["b"]))
        print(f"parallel leg B: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        res.update(parallel_leg_b(dev, dirs["b4"], started=started["b4"],
                                  legs=LEG_B4, n=4, label="B4"))
        print(f"parallel leg B4: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        pp = parallel_leg_pp(dev, dirs["pp"], started=started["pp"])
        print(f"parallel leg pp: {time.perf_counter() - t0:.1f} s")
        for k, v in pp.pop("parallel_launches").items():
            res["parallel_launches"][k] += v
        res.update(pp)
    finally:
        for fut, go in started.values():   # never leave a rank waiting
            open(go, "w").close()
            fut.exception()
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"parallel": res}))
    return 0


def run_parallel_child() -> dict:
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    child = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--parallel"], env=env, capture_output=True,
                           text=True, timeout=700)
    lines = child.stdout.splitlines()
    if child.returncode != 0:
        print("\n".join(lines))
        print(child.stderr[-6000:], file=sys.stderr)
        raise RuntimeError(f"the parallel phase exited {child.returncode}")
    print("\n".join(lines[:-1]))
    return json.loads(lines[-1])["parallel"]


# ------------------------------------------------------------ bench phase
# cli/bench_components.py as the bench phase runs it: (leg, "main" and
# the command's arguments besides --device, or a leg function and its
# keyword arguments besides the device); extract through its function,
# since the command has no flag for its 40 batches
BENCH_LEGS = (
    ("all", "main", ["--which", "all"]),
    ("serving", "main", ["--which", "serving"]),
    ("serving_w8a8", "main", ["--which", "serving", "--serving_quant",
                              "w8a8", "--serving_repeats", "10"]),
    ("extract", "bench_extract", dict(batch=PIPE_BATCH, seconds=5,
                                      n_batches=10, model="xlsr")),
    ("socket", "main", ["--which", "socket", "--socket_per_client", "5"]),
)
# the bench's JSON fields that are not measurements
BENCH_FIXED = ("serving_batch", "serving_quant", "extract_batch",
               "socket_batch", "socket_quant", "socket_wire",
               "socket_clients")


def run_bench_legs(dev, legs=BENCH_LEGS) -> tuple:
    """Each leg of bench_components on `dev`, in this process, with the
    launch counters set to 0 just before it and read just after. ->
    ({leg: its JSON}, {leg: launches}, {leg: seconds})."""
    import contextlib
    import io

    from wav2vec_contr_loss_torch.cli import bench_components as bench

    out, counts, secs = {}, {}, {}
    for leg, fn, args in legs:
        _reset_counters()
        t0 = time.perf_counter()
        if fn == "main":
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                bench.main(args + ["--device", str(dev)])
            lines = printed.getvalue().splitlines()
            if len(lines) != 1:
                raise RuntimeError(f"bench {leg}: the command printed "
                                   f"{len(lines)} lines, expected one")
            out[leg] = json.loads(lines[0])
        else:
            if fn != "bench_decode":     # the decode leg runs on the host
                args = dict(args, device=dev)
            out[leg] = getattr(bench, fn)(**args)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        counts[leg] = _counters()
        secs[leg] = time.perf_counter() - t0
    return out, counts, secs


def bench_expected(legs, cfg) -> dict:
    """{leg: exact launches} of the legs whose structure fixes them:
    serving, a warm-up call and `repeats` calls in each of its three legs;
    extract, a warm-up batch and `n_batches` in each of its three; each
    batch 24 attention and 7 LN+GELU forwards (cfg's layers and convs),
    nothing else; supcon (alone or in 'all'), its warm-up and `repeats`
    value-and-gradient steps of the kernel; decode and rawboost none. The
    socket leg's batches depend on how the batcher coalesces
    (check_bench)."""
    import inspect

    from wav2vec_contr_loss_torch.cli import bench_components as bench

    def defaults(fn) -> dict:
        return {k: p.default for k, p in inspect.signature(
            getattr(bench, fn)).parameters.items()}

    def launches(batches=0, supcon=0):
        return {"attention_fwd": cfg.num_layers * batches,
                "attention_bwd": 0,
                "ln_gelu_fwd": len(cfg.conv_dim) * batches,
                "ln_gelu_bwd": 0, "supcon": supcon}

    want = {}
    for leg, fn, args in legs:
        if fn == "main":
            parsed = bench.build_parser().parse_args(args)
            which = parsed.which
            sizes = {"repeats": parsed.serving_repeats}
        else:
            which = fn[len("bench_"):]
            sizes = dict(defaults(fn), **args)
        if which == "serving":
            want[leg] = launches(batches=3 * (sizes["repeats"] + 1))
        elif which == "extract":
            want[leg] = launches(batches=3 * (sizes["n_batches"] + 1))
        elif which in ("all", "supcon"):
            want[leg] = launches(
                supcon=defaults("bench_supcon")["repeats"] + 1)
        elif which != "socket":
            want[leg] = launches()
    return want


def check_bench(out: dict, counts: dict, want: dict, cfg) -> None:
    """Raise unless every leg launched exactly what `want` says (the
    socket leg: 24 attention and 7 LN+GELU forwards a batch for at least
    its three warm-up batches, nothing else) and every measurement is
    finite and above 0 (the kernel leg of supcon may read None only
    where no kernel ran)."""
    for leg, n in want.items():
        if counts[leg] != n:
            raise RuntimeError(f"bench {leg}: launches {counts[leg]}, "
                               f"expected {n}")
    if "socket" in counts:
        c = counts["socket"]
        batches = c["attention_fwd"] // cfg.num_layers
        exact = {"attention_fwd": cfg.num_layers * batches,
                 "attention_bwd": 0, "ln_gelu_fwd": len(cfg.conv_dim) * batches,
                 "ln_gelu_bwd": 0, "supcon": 0}
        if c != exact or batches < 3:
            raise RuntimeError(f"bench socket: launches {c}, expected "
                               f"whole batches of {cfg.num_layers} attention "
                               f"and {len(cfg.conv_dim)} LN+GELU forwards")
    for leg, fields in out.items():
        for key, value in fields.items():
            if key in BENCH_FIXED:
                continue
            if value is None and key == "supcon_cuda_steps_per_sec" \
                    and counts[leg]["supcon"] == 0:
                continue
            if not (isinstance(value, float) and np.isfinite(value)
                    and value > 0):
                raise RuntimeError(f"bench {leg} {key} = {value!r}")


def bench_phase(dev, results) -> dict:
    """cli/bench_components.py on the card (BENCH_LEGS), checked by
    check_bench, then the supcon leg's kernel against the plain loss on
    the leg's own inputs (B = 256). Adds each kernel's `bench_launches`
    to `results`, and the SupCon error to its `max_abs_err`. -> the
    bench's JSON, by leg."""
    from wav2vec_contr_loss_torch import XLSR_300M
    from wav2vec_contr_loss_torch.cli import bench_components as bench
    from wav2vec_contr_loss_torch.losses.supcon import supcon_binary_loss
    from wav2vec_contr_loss_torch.ops import supcon

    out, counts, secs = run_bench_legs(dev)
    for leg, n in counts.items():
        print(f"bench {leg}: {secs[leg]:.1f} s, launches "
              + ", ".join(f"{k} {v}" for k, v in n.items()))
    check_bench(out, counts, bench_expected(BENCH_LEGS, XLSR_300M),
                XLSR_300M)
    for name in _counters():
        results[name]["bench_launches"] = sum(c[name]
                                              for c in counts.values())

    z, labels, cfg = bench.supcon_inputs()
    lt = torch.from_numpy(labels).to(dev)
    grads = []
    for fn in (supcon.supcon_binary_loss_fused, supcon_binary_loss):
        zk = torch.from_numpy(z).to(dev).requires_grad_()
        loss = fn(zk, lt, bench.SUPCON_ALPHA, cfg)
        grads.append((loss.detach(), torch.autograd.grad(loss, zk)[0]))
    (loss, gz), (loss_p, gzp) = grads
    err = max(abs(loss.item() - loss_p.item()),
              (gz - gzp).abs().max().item())
    print(f"bench supcon B=256 D=256 alpha {bench.SUPCON_ALPHA}: kernel "
          f"loss {loss.item():.6f} vs plain {loss_p.item():.6f}, max abs "
          f"err {err:.3e} (tolerances: loss {SUPCON_LOSS_TOL}, dz "
          f"{SUPCON_GRAD_TOL})")
    torch.testing.assert_close(loss, loss_p, **SUPCON_LOSS_TOL)
    torch.testing.assert_close(gz, gzp, **SUPCON_GRAD_TOL)
    results["supcon"]["max_abs_err"] = max(
        results["supcon"].get("max_abs_err", 0.0), err)
    print(json.dumps({"bench_components": out}))
    return out


def read_card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def bench_main() -> int:
    """The bench phase alone (`--bench`), the kernels built on demand,
    with TF32 off as in `main`. Its kernels line holds what this run
    measured: each kernel's bench launches and the B = 256 SupCon
    error."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    global CARD
    CARD = read_card()
    print(CARD)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    results = {name: {"name": name} for name in _counters()}
    bench_phase(torch.device("cuda", 0), results)
    print(f"bench phase: {time.perf_counter() - t0:.1f} s [{CARD}]")
    print(json.dumps({"kernels": list(results.values())}))
    return 0


def fp32_main() -> int:
    """The fp32 phase alone (`--fp32`), the kernels built on demand, at
    PyTorch's default TF32 settings as in `main`."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    global CARD
    CARD = read_card()
    print(CARD)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    results = {}
    fp32_phase(torch.device("cuda", 0), results)
    print(json.dumps({"kernels": list(results.values())}))
    return 0


def fit_main() -> int:
    """The fit phase, then the pipeline phase from its checkpoint, in a
    process of its own (`--fit`): the fit phase needs
    CUBLAS_WORKSPACE_CONFIG set before CUDA starts, which the other
    phases' timings should not carry."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    import shutil
    import tempfile

    global CARD
    CARD = read_card()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fit_")
    try:
        fit = fit_phase(dev, tmp)
        fit.update(pipeline_phase(dev, tmp))
        fit.update(baseline_cli_phase(dev, tmp))
        fit.update(features_phase(dev, tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"fit": fit}))
    return 0


def run_fit_child() -> dict:
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    child = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--fit"], env=env, capture_output=True,
                           text=True, timeout=700)
    lines = child.stdout.splitlines()
    print("\n".join(lines[:-1]))
    if child.returncode != 0:
        print(child.stderr[-4000:], file=sys.stderr)
        raise RuntimeError(f"the fit phase exited {child.returncode}")
    return json.loads(lines[-1])["fit"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    from wav2vec_contr_loss_torch.data.audio import native_decoder
    from wav2vec_contr_loss_torch.ops import _build

    global CARD
    CARD = read_card()
    print(CARD)                        # card name, power limit
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    names = sorted(p.stem for p in _build.SRC_DIR.glob("*.cu"))
    _build.build(names)
    print(f"build: {names} with nvcc in {time.perf_counter() - t0:.1f} s "
          f"into {_build.BUILD_DIR}")
    t0 = time.perf_counter()
    lib = native_decoder()
    print(f"build: the native audio decoder {lib._name} with g++ in "
          f"{time.perf_counter() - t0:.1f} s")

    dev = torch.device("cuda", 0)
    # the fp32 path under PyTorch's default TF32 settings, as a user's
    # process has them
    fp32_results = {}
    fp32_phase(dev, fp32_results)
    # then fp32 without TF32 for the fp32 parts of the other phases (their
    # CPU references, RawBoost, SupCon)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    results = kernel_phase(dev)
    train_kernel_phase(dev, results)
    dropout_phase(dev, results)
    adamw_phase(dev, results)
    head_dim_phase(dev, results)
    print(f"kernel phase: {time.perf_counter() - t0:.1f} s (Triton JIT "
          f"included)")
    t0 = time.perf_counter()
    serve_phase(dev, results)
    print(f"serve phase: {time.perf_counter() - t0:.1f} s")
    front_door_phase(dev, results)
    artifact_phase(dev, results)
    t0 = time.perf_counter()
    off_profile = train_phase(dev, results)
    step_vs_cpu(dev)
    print(f"train phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rawboost_phase(dev)
    rawboost_step_phase(dev, off_profile)
    torch.cuda.empty_cache()
    print(f"rawboost phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    baseline_phase(dev, results)
    print(f"baseline phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fit = run_fit_child()
    for key in ("fit_launches", "pipeline_launches",
                "baseline_cli_launches", "features_launches",
                "fit_from_features_binary_launches",
                "fit_from_features_multiclass_launches"):
        for name, n in fit[key].items():
            results[name][key] = n
    print(f"fit and pipeline phases (own process): "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    par = run_parallel_child()
    for name, n in par.pop("parallel_launches").items():
        results[name]["parallel_launches"] = n
    results["attention_fwd"]["parallel"] = par
    print(f"parallel phase (own process): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bench_phase(dev, results)
    print(f"bench phase: {time.perf_counter() - t0:.1f} s [{CARD}]")

    results.update(fp32_results)
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit({"--fit": fit_main, "--parallel": parallel_main,
              "--bench": bench_main, "--fp32": fp32_main,
              "--kernels": kernels_main}.get(
        sys.argv[1] if len(sys.argv) == 2 else None, main)())
