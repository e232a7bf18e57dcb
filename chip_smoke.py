#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. Prints the card's name and power limit, and builds the port's CUDA
   kernels from csrc/ (one nvcc per source, all started together).
2. Kernel phase: holds each hand-written kernel against its plain
   PyTorch version on the card, at the shapes the serving path gives it,
   and times kernel, plain version and the nearest single PyTorch call
   (timed only; the port never calls it).
3. Serve phase: builds XLS-R-300M (24 layers, 1024 wide, 'layer' norm)
   with a linear head from seeded random numpy weights in the JAX tree
   layout, passed through the port's weight bridge; scores 4 batches of
   8 x 5 s clips and one windowed long-clip call, with the launch
   counters reset just before and read just after; compares 2 clips with
   the same model run in fp32 on the CPU; times serving, then breaks 3
   batches down by device kernel with torch.profiler.
4. Prints one JSON line with every kernel's numbers, then the result
   line. Any failure exits non-zero before the result line.

Needs torch with CUDA, triton and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (dense): HBM bytes/s, bf16 tensor-core FLOP/s,
# fp32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12

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


def bound(nbytes: float, flops: float, flop_rate: float):
    """(least time in ms, what bounds it) on an H100 SXM."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def random_jax_trees(cfg, comp_dim: int = 256, head_type: str = "linear",
                     head_hidden: int = 128, seed: int = 0):
    """Seeded numpy (encoder, compression, head) trees in the JAX
    package's layout: flax names, Dense kernels (in, out), conv kernels
    (k, in/groups, out), transformer leaves stacked on a leading layer
    axis. Kernels have std 1/sqrt(fan_in) (flax's lecun scale); the head
    has unit scale so logits are O(1)."""
    rng = np.random.default_rng(seed)

    def normal(shape, std):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(std))

    def dense(n_in, n_out, lead=(), std=None):
        return {"kernel": normal(lead + (n_in, n_out),
                                 std or n_in ** -0.5),
                "bias": normal(lead + (n_out,), 0.02)}

    def norm(n, lead=()):
        return {"scale": 1.0 + normal(lead + (n,), 0.02),
                "bias": normal(lead + (n,), 0.02)}

    fe = {}
    cin = 1
    for i, (dim, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        fe[f"conv{i}"] = {"kernel": normal((k, cin, dim), (k * cin) ** -0.5)}
        if cfg.conv_bias:
            fe[f"conv{i}"]["bias"] = normal((dim,), 0.02)
        if cfg.feat_extract_norm == "layer":
            fe[f"norm{i}"] = {"LayerNorm_0": norm(dim)}
        cin = dim
    if cfg.feat_extract_norm == "group":
        fe["group_norm"] = norm(cfg.conv_dim[0])

    d, L = cfg.hidden_size, (cfg.num_layers,)
    k, g = cfg.num_conv_pos_embeddings, cfg.num_conv_pos_embedding_groups
    enc = {
        "feature_extractor": fe,
        "feature_projection": {"layer_norm": norm(cfg.conv_dim[-1]),
                               "projection": dense(cfg.conv_dim[-1], d)},
        "pos_conv_embed": {"conv": {
            "kernel": normal((k, d // g, d), (k * d // g) ** -0.5),
            "bias": normal((d,), 0.02)}},
        "encoder_layer_norm": norm(d),
        "layers": {"layer": {
            "attention": {n: dense(d, d, L) for n in
                          ("q_proj", "k_proj", "v_proj", "out_proj")},
            "feed_forward": {
                "intermediate_dense": dense(d, cfg.intermediate_size, L),
                "output_dense": dense(cfg.intermediate_size, d, L)},
            "layer_norm": norm(d, L),
            "final_layer_norm": norm(d, L),
        }},
    }
    if cfg.apply_spec_augment:
        enc["masked_spec_embed"] = rng.uniform(
            0, 1, (d,)).astype(np.float32)
    comp = {"proj": dense(d, comp_dim)}
    if head_type == "linear":
        head = {"fc": dense(comp_dim, 1, std=1.0)}
    else:
        head = {"fc1": dense(comp_dim, head_hidden),
                "fc2": dense(head_hidden, 1, std=1.0)}
    return enc, comp, head


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
    got = attention.fused_attention(q, k, v, bias, 0, 0.0, h)
    want = attention.fused_attention_plain(q, k, v, bias)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    print(f"attention_fwd (8,16,249,64) max_abs_err={err:.3e} (tolerance "
          f"|d| <= 2e-3 + 2e-2 |plain|)")
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3, rtol=2e-2)
    # ragged edges off the main path: T below one tile and below the head
    # dim, and the longest T the kernel keeps in shared memory
    for eb, eh, et in ((2, 3, 37), (1, 2, 400)):
        eq, ek, ev = (torch.randn(eb, eh, et, d, generator=gen, device=dev
                                  ).to(torch.bfloat16) for _ in range(3))
        ebias = torch.zeros(eb, et, device=dev)
        ebias[-1, et // 2:] = -1e30
        eg = attention.fused_attention(eq, ek, ev, ebias, 0, 0.0, eh).float()
        ew = attention.fused_attention_plain(eq, ek, ev, ebias).float()
        print(f"attention_fwd ({eb},{eh},{et},{d}) max_abs_err="
              f"{(eg - ew).abs().max().item():.3e}")
        torch.testing.assert_close(eg, ew, atol=2e-3, rtol=2e-2)
    mask16 = bias[:, None, None, :].to(torch.bfloat16)
    ms = cuda_ms(lambda: attention.fused_attention(q, k, v, bias, 0, 0.0, h))
    plain_ms = cuda_ms(lambda: attention.fused_attention_plain(q, k, v, bias))
    lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask16, scale=1.0))
    nbytes = 4 * b * h * t * d * 2 + b * t * 4
    bound_ms, bound_by = bound(nbytes, 4 * b * h * t * t * d, BF16_FLOP_PER_S)
    results["attention_fwd"] = dict(
        name="attention_fwd", route="cuda",
        source="wav2vec_contr_loss_torch/csrc/attention_fwd.cu",
        replaces="wav2vec_contr_loss_tpu/ops/attention_pallas.py:83",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=lib_ms)
    print(f"attention_fwd (8,16,249,64) bf16: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by})")

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
                  f"(tolerance |d| <= 2e-2 + 2e-2 |plain|)")
            torch.testing.assert_close(got.float(), want.float(),
                                       atol=2e-2, rtol=2e-2)
            err = max(err, e)
    x = (2.0 * torch.randn(BATCH * 15999, c, generator=gen, device=dev)
         ).to(torch.bfloat16)
    s16, b16 = scale.to(torch.bfloat16), shift.to(torch.bfloat16)
    ms = cuda_ms(lambda: conv_ln.fused_ln_gelu(x, scale, shift, 1e-5, True))
    plain_ms = cuda_ms(
        lambda: conv_ln.fused_ln_gelu_plain(x, scale, shift, 1e-5, True))
    lib_ms = cuda_ms(lambda: torch.nn.functional.gelu(
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


def serve_phase(dev, results) -> None:
    from wav2vec_contr_loss_torch import (XLSR_300M, SpoofScorer,
                                          Stage2Config, jax_params_to_torch)
    from wav2vec_contr_loss_torch.ops import attention, conv_ln

    cfg = XLSR_300M
    t0 = time.perf_counter()
    weights = jax_params_to_torch(cfg, *random_jax_trees(cfg, seed=0))
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

    scorer.score_waveforms(waves[0])               # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(30):
        t0 = time.perf_counter()
        scorer.score_waveforms(waves[i % N_BATCHES])
        times.append(time.perf_counter() - t0)
    ms, p90 = (1e3 * float(x) for x in np.percentile(times, [50, 90]))
    print(f"serve: {ms:.2f} ms per batch of {BATCH} x 5 s (closed loop, "
          f"median of 30, p90 {p90:.2f}, min {1e3 * min(times):.2f}, max "
          f"{1e3 * max(times):.2f}), {1e3 * BATCH / ms:.1f} clips/s, peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_serving(scorer, waves)


def profile_serving(scorer, waves) -> None:
    """Device time by kernel over 3 batches under torch.profiler, against
    the wall time of the same window (the profiler's own host cost is in
    that wall time, so the busy share it gives is a lower bound)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for w in waves[:3]:
            scorer.score_waveforms(w)
        wall_ms = 1e3 * (time.perf_counter() - t0) / 3
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms_n = by_name.setdefault(e.name, [0.0, 0])
            ms_n[0] += e.time_range.elapsed_us() / 3e3
            ms_n[1] += 1
    if not by_name:
        print("profile: the profiler recorded no device activity")
        return
    busy = sum(v[0] for v in by_name.values())
    print(f"profile: per batch, wall {wall_ms:.2f} ms (profiler on), device "
          f"busy {busy:.2f} ms ({100 * busy / wall_ms:.1f} %), "
          f"{sum(v[1] for v in by_name.values()) // 3} device ops")
    for name, (ms_b, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"profile:   {ms_b:8.3f} ms  x{n // 3:<4d} {name[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    from wav2vec_contr_loss_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip())          # card name, power limit
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    # fp32 on the card without TF32, for the fp32 parts of the path
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    names = sorted(p.stem for p in _build.SRC_DIR.glob("*.cu"))
    _build.build(names)
    print(f"build: {names} with nvcc in {time.perf_counter() - t0:.1f} s "
          f"into {_build.BUILD_DIR}")

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    results = kernel_phase(dev)
    print(f"kernel phase: {time.perf_counter() - t0:.1f} s (Triton JIT "
          f"included)")
    t0 = time.perf_counter()
    serve_phase(dev, results)
    print(f"serve phase: {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
