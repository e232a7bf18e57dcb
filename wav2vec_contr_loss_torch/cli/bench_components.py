"""Component micro-benchmarks of the port: the host-side costs around the
train step and the serving paths.

The port of wav2vec_contr_loss_tpu/cli/bench_components.py, with its
flags but `--serving_unroll` (it chooses the unroll of the JAX
encoder's layer scan, an XLA program; the port's encoder has no scan),
its `--which` choices and JSON keys (the two SupCon keys mapped:
`supcon_plain_steps_per_sec` is JAX's `supcon_xla_steps_per_sec`, the
plain loss differentiated by autograd; `supcon_cuda_steps_per_sec` is
its `supcon_pallas_steps_per_sec`, the CUDA kernel of csrc/supcon.cu),
plus `--device` ('cuda' by default; 'cpu' runs every leg on the CPU and
reads the kernel leg as null, since the wrapper would run the plain
version there). Every timed window ends on a host read or a device
synchronisation; the kernels' builds and the Triton JIT happen in a
warm-up call outside it. There is no compile cache. Weights are seeded
random numbers in the JAX tree layout (`bridge.random_jax_trees`);
waveforms and files are made from a seed.

  python -m wav2vec_contr_loss_torch bench_components --which decode
  python -m wav2vec_contr_loss_torch bench_components --which rawboost
  python -m wav2vec_contr_loss_torch bench_components --which supcon
  python -m wav2vec_contr_loss_torch bench_components --which serving
  python -m wav2vec_contr_loss_torch bench_components --which extract
  python -m wav2vec_contr_loss_torch bench_components --which socket
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from ..bridge import jax_params_to_torch, random_jax_trees
from ..config import (XLSR_300M, Stage1Config, Stage2Config, SupConConfig,
                      Wav2Vec2Config)
from ..device import resolve_device

__all__ = ["bench_decode", "bench_rawboost", "bench_supcon",
           "bench_extract", "bench_serving", "bench_socket", "make_scorer",
           "supcon_inputs", "TINY", "SUPCON_ALPHA", "main"]

SR = 16000

# the JAX command's tiny encoder (CI and CPU smoke), field for field
TINY = Wav2Vec2Config(
    hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
    conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2),
    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
    apply_spec_augment=False)

SUPCON_ALPHA = 0.3


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work (before a clock read)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _encoder(model: str):
    """(encoder config, compression input width) of 'xlsr' or 'tiny'."""
    if model == "xlsr":
        return XLSR_300M, 1024
    if model == "tiny":
        return TINY, 32
    raise ValueError(f"model must be 'xlsr' or 'tiny'; got {model!r}")


def bench_decode(n_files: int = 64, seconds: int = 5,
                 repeats: int = 3) -> dict:
    """Per-file `AudioLoader.load` against the native threaded batch
    decode (8 threads) of the same WAV files."""
    from ..data.audio import AudioConfig, AudioLoader, decode_batch, write_wav

    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as d:
        paths = []
        for i in range(n_files):
            p = f"{d}/clip_{i}.wav"
            write_wav(p, rng.normal(0, 0.2, SR * seconds).astype(np.float32),
                      SR)
            paths.append(p)

        loader = AudioLoader(AudioConfig(SR, seconds))
        loader.load(paths[0])  # builds the native decoder at first use
        t0 = time.perf_counter()
        for _ in range(repeats):
            for p in paths:
                loader.load(p)
        per_file = (time.perf_counter() - t0) / (repeats * n_files)

        t0 = time.perf_counter()
        for _ in range(repeats):
            _, _, lens = decode_batch(paths, SR * seconds, threads=8)
        batch_rate = repeats * n_files / (time.perf_counter() - t0)
        if (lens <= 0).any():
            raise RuntimeError(f"the batch decode failed on "
                               f"{int((lens <= 0).sum())} of {n_files} files")
    return {
        "decode_clips_per_sec_serial": round(1.0 / per_file, 1),
        "decode_clips_per_sec_native_batch8": round(batch_rate, 1),
    }


def bench_rawboost(batch: int = 32, seconds: int = 5, repeats: int = 3,
                   device="cuda") -> dict:
    """Host RawBoost (numpy/scipy, data/rawboost.py) against device
    RawBoost (ops/rawboost.py: the draws on a device generator, then the
    batch) at prob 1. A failure of the device leg raises."""
    from ..data.rawboost import RawBoostParams, apply_rawboost_batch
    from ..ops.rawboost import rawboost_batch, rawboost_draws

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    t = SR * seconds
    waves = rng.normal(0, 0.2, (batch, t)).astype(np.float32)
    params = RawBoostParams()

    t0 = time.perf_counter()
    for _ in range(repeats):
        apply_rawboost_batch(waves, np.random.default_rng(1), params,
                             prob=1.0)
    host = repeats * batch / (time.perf_counter() - t0)

    dw = torch.from_numpy(waves).to(dev)
    gen = torch.Generator(device=dev)

    def run(seed: int) -> torch.Tensor:
        gen.manual_seed(seed)
        return rawboost_batch(dw, rawboost_draws(gen, batch, t, params), 1.0,
                              params)

    run(0)
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(repeats):
        run(i)
    _sync(dev)
    device_rate = repeats * batch / (time.perf_counter() - t0)
    return {
        "rawboost_clips_per_sec_host": round(host, 1),
        "rawboost_clips_per_sec_device": round(device_rate, 1),
    }


def supcon_inputs(batch: int = 256, dim: int = 256):
    """(z (B, D) float32 unit rows, labels (B,) int32 alternating 1/0,
    SupConConfig) of the SupCon bench, from seed 0."""
    rng = np.random.default_rng(0)
    z = rng.normal(size=(batch, dim)).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    labels = np.array([1, 0] * (batch // 2), np.int32)
    return z, labels, SupConConfig(temperature=0.07, topk_neg=15,
                                   uniformity_weight=0.05)


def bench_supcon(batch: int = 256, dim: int = 256, repeats: int = 50,
                 device="cuda") -> dict:
    """Value-and-gradient steps/s of the binary SupCon loss at alpha 0.3:
    the plain loss differentiated by autograd (losses/supcon.py; JAX's
    'xla' leg) and the CUDA kernel (ops/supcon.py; JAX's 'pallas' leg).
    On the CPU the kernel leg is not timed and reads null."""
    from ..losses.supcon import supcon_binary_loss
    from ..ops.supcon import supcon_binary_loss_fused

    dev = resolve_device(device)
    z, labels, cfg = supcon_inputs(batch, dim)
    zt = torch.from_numpy(z).to(dev)
    lt = torch.from_numpy(labels).to(dev)
    out = {}
    for name, fn in (("plain", supcon_binary_loss),
                     ("cuda", supcon_binary_loss_fused)):
        if name == "cuda" and dev.type != "cuda":
            out["supcon_cuda_steps_per_sec"] = None
            continue

        def step():
            x = zt.detach().requires_grad_()
            loss = fn(x, lt, SUPCON_ALPHA, cfg)
            return loss, torch.autograd.grad(loss, x)[0]

        loss, _ = step()        # the kernels' build, outside the window
        float(loss.detach())
        t0 = time.perf_counter()
        for _ in range(repeats):
            loss, _ = step()
        _sync(dev)
        float(loss.detach())
        out[f"supcon_{name}_steps_per_sec"] = round(
            repeats / (time.perf_counter() - t0), 1)
    return out


def make_scorer(model: str, seconds: int, quantize: str = "none",
                device="cuda", compute_dtype: str = "bfloat16"):
    """The serving benches' `SpoofScorer` for `seconds`-long clips:
    'xlsr' (XLS-R-300M) or 'tiny' with the default stage-2 head, on
    `random_jax_trees(seed=0)` through the weight bridge; `quantize` as in
    SpoofScorer."""
    enc_cfg, _ = _encoder(model)
    enc_cfg = enc_cfg.with_(dtype=compute_dtype)
    cfg2 = Stage2Config()
    trees = random_jax_trees(enc_cfg, comp_dim=cfg2.in_dim,
                             head_type=cfg2.head_type,
                             head_hidden=cfg2.hidden_dim, seed=0)
    from ..eval.serving import SpoofScorer

    return SpoofScorer(enc_cfg, jax_params_to_torch(enc_cfg, *trees), cfg2,
                       sample_rate=SR, max_duration_seconds=seconds,
                       device=device, quantize=quantize)


def _ms_stats(lat: list):
    lat = np.sort(np.asarray(lat))
    return lat, float(lat[len(lat) // 2]), float(lat[int(len(lat) * 0.95)])


def bench_serving(batch: int = 8, seconds: int = 5, repeats: int = 30,
                  model: str = "xlsr", quantize: str = "none",
                  device="cuda") -> dict:
    """Serving latency of one batch, waveforms -> logits through
    `SpoofScorer`, in three legs of `repeats` after one warm-up call
    each: `score_waveforms` from host numpy (the copy to the device and
    back included), the scorer on a device-resident batch with a host
    read of its logits (compute and the copy back only), and
    `score_waveforms(wire='int16')` (half the bytes to the device)."""
    scorer = make_scorer(model, seconds, quantize, device)
    rng = np.random.default_rng(0)
    waves = rng.normal(0, 0.2, (batch, seconds * SR)).astype(np.float32)

    def timed(fn):
        fn()
        lat = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()          # ends on the logits' host read
            lat.append((time.perf_counter() - t0) * 1e3)
        return _ms_stats(lat)

    lat, p50, p95 = timed(lambda: scorer.score_waveforms(waves))
    waves_dev = torch.from_numpy(waves).to(scorer.device)
    lat_r, p50_r, p95_r = timed(lambda: scorer.run(waves_dev)[1].cpu())
    lat_w, p50_w, _ = timed(
        lambda: scorer.score_waveforms(waves, wire="int16"))
    return {
        "serving_batch": batch,
        "serving_quant": quantize,
        "serving_p50_ms": round(p50, 2),
        "serving_p95_ms": round(p95, 2),
        "serving_clips_per_sec": round(float(batch / (lat.mean() / 1e3)), 1),
        "serving_resident_p50_ms": round(p50_r, 2),
        "serving_resident_p95_ms": round(p95_r, 2),
        "serving_resident_clips_per_sec": round(
            float(batch / (lat_r.mean() / 1e3)), 1),
        "serving_wire16_p50_ms": round(p50_w, 2),
        "serving_wire16_clips_per_sec": round(
            float(batch / (lat_w.mean() / 1e3)), 1),
    }


def bench_extract(batch: int = 32, seconds: int = 5, n_batches: int = 40,
                  model: str = "xlsr", quantize: str = "none",
                  device="cuda") -> dict:
    """Embedding-extraction throughput at a production batch: eval-mode
    `Stage1Trainer.embed_step` (frozen encoder, no remat) over
    `stream_through_device` (pinning in the prefetch thread, compute
    queued, the copy back overlapped); a device-resident leg (compute and
    the copy back only); an int16-wire leg (ops/wire.py). `quantize`
    ('w8a8' | 'w8') embeds through the serving path's int8 encoder
    (ops/quant.py `quantize_encoder_state_dict`) with the same
    compression weights."""
    from ..data.pipeline import Batch, stream_through_device
    from ..ops.wire import quantize_wire
    from ..train import Stage1Trainer
    from .serve import _put_fn

    enc_cfg, input_dim = _encoder(model)
    cfg = Stage1Config(batch_size=batch, finetune_encoder=False,
                       use_rawboost=False, input_dim=input_dim,
                       max_duration_seconds=seconds, remat_encoder=False)
    weights = jax_params_to_torch(enc_cfg, *random_jax_trees(
        enc_cfg, comp_dim=cfg.hidden_dim, seed=0))
    if quantize == "none":
        runner = Stage1Trainer(cfg, enc_cfg, weights, device=device)

        def embed(w):
            return runner.embed_step({"waveforms": w})
    else:
        from ..eval.serving import SpoofScorer

        runner = SpoofScorer(
            enc_cfg.with_(dtype=cfg.compute_dtype), weights,
            Stage2Config(in_dim=cfg.hidden_dim),
            sample_rate=cfg.target_sample_rate, max_duration_seconds=seconds,
            device=device, quantize=quantize)

        def embed(w):
            return runner.run(w)[0]
    dev = runner.device

    rng = np.random.default_rng(0)
    wave = rng.normal(0, 0.2, (batch, seconds * cfg.target_sample_rate)
                      ).astype(np.float32)
    labels = np.array([1, 0] * (batch // 2), np.int32)

    def batches():
        for _ in range(n_batches):
            yield Batch(waveforms=wave, labels=labels, multi_labels=labels,
                        valid=np.ones(batch, bool))

    def run_stream(wire: str) -> int:
        # the host batch in the wire dtype, pinned on the card, as the
        # server puts it
        put = _put_fn(wire, runner)
        n = 0
        for z, _ in stream_through_device(
                batches(), lambda b: put((None, b.waveforms)), embed):
            n += z.shape[0]      # z is on the host: each batch was read
        return n

    embed(torch.from_numpy(wave).to(dev)).cpu()   # kernels built, JIT run
    t0 = time.perf_counter()
    n = run_stream("float32")
    dt = time.perf_counter() - t0

    wave_dev = torch.from_numpy(wave).to(dev)
    embed(wave_dev).cpu()
    t0 = time.perf_counter()
    for _ in range(n_batches):
        embed(wave_dev).cpu()
    dt_r = time.perf_counter() - t0

    embed(torch.from_numpy(quantize_wire(wave)).to(dev)).cpu()
    t0 = time.perf_counter()
    n16 = run_stream("int16")
    dt_w = time.perf_counter() - t0
    return {
        "extract_batch": batch,
        "extract_clips_per_sec": round(n / dt, 1),
        "extract_ms_per_batch": round(dt / n_batches * 1e3, 2),
        "extract_resident_clips_per_sec": round(n / dt_r, 1),
        "extract_resident_ms_per_batch": round(dt_r / n_batches * 1e3, 2),
        "extract_wire16_clips_per_sec": round(n16 / dt_w, 1),
        "extract_wire16_ms_per_batch": round(dt_w / n_batches * 1e3, 2),
    }


def bench_socket(batch: int = 8, seconds: int = 5, clients: int = 8,
                 per_client: int = 25, model: str = "xlsr",
                 quantize: str = "none", max_wait_ms: float = 5.0,
                 wire: str = "float32", device="cuda") -> dict:
    """Multi-client socket serving under closed-loop load
    (eval/server.py `ScoringServer` on 127.0.0.1): `clients` TCP clients
    each send a request and wait for its reply before the next, over 16
    WAV files on disk (decode, the copy to the device, compute, the copy
    back and the socket hop included); then one client alone, the
    latency floor without coalescing. Each leg starts and stops its own
    server, with one warm-up request outside the timed window; occupancy
    comes from the batcher's counters over the window. A client error or
    a missing reply raises."""
    import socket as socketlib
    import threading

    from ..data.audio import AudioConfig, write_wav
    from ..eval.server import ScoringServer

    scorer = make_scorer(model, seconds, quantize, device)
    rng = np.random.default_rng(0)
    # the kernels' build and the Triton JIT, outside any socket timeout
    scorer.score_waveforms(np.zeros((batch, seconds * SR), np.float32),
                           wire=wire)

    def run_leg(paths, n_clients: int, n_reqs: int) -> dict:
        server = ScoringServer(
            scorer, port=0, batch=batch, audio_config=AudioConfig(SR, seconds),
            workers=max(8, n_clients), max_wait_ms=max_wait_ms, wire=wire,
            log_fn=lambda m: None)
        st = threading.Thread(target=server.serve_forever, daemon=True)
        st.start()
        lats: list = []
        errors: list = []
        lock = threading.Lock()

        def client(cid: int, reqs: int) -> None:
            try:
                with socketlib.create_connection(server.address,
                                                 timeout=600) as s:
                    f = s.makefile("rw", encoding="utf-8", newline="\n")
                    mine = []
                    for k in range(reqs):
                        t0 = time.perf_counter()
                        f.write(f"{cid}-{k}\t"
                                f"{paths[(cid + k) % len(paths)]}\n")
                        f.flush()
                        reply = f.readline()
                        mine.append((time.perf_counter() - t0) * 1e3)
                        if (not reply.startswith(f"{cid}-{k}\t")
                                or "\tERROR" in reply):
                            raise RuntimeError(f"bad reply: {reply!r}")
                with lock:
                    lats.extend(mine)
            except Exception as e:  # surfaced below, never under-counted
                with lock:
                    errors.append(e)

        stats = None
        try:
            client(999, 1)
            if errors:
                raise RuntimeError(
                    "socket bench warm-up failed") from errors[0]
            lats.clear()
            base_clips = server.batcher.n_clips
            base_batches = server.batcher.n_batches
            t0 = time.perf_counter()
            ths = [threading.Thread(target=client, args=(c, n_reqs))
                   for c in range(n_clients)]
            for t in ths:
                t.start()
            for t in ths:
                t.join()
            wall = time.perf_counter() - t0
            stats = server.shutdown()
        finally:
            if stats is None:     # failed before shutdown: stop the threads
                server.shutdown()
            st.join(timeout=30)
        if st.is_alive():
            raise RuntimeError("the server's accept loop did not stop")
        if errors:
            raise RuntimeError(
                f"{len(errors)} bench client(s) failed") from errors[0]
        n_done = len(lats)
        if n_done != n_clients * n_reqs:
            raise RuntimeError(f"expected {n_clients * n_reqs} replies, "
                               f"got {n_done}")
        timed_clips = stats["clips"] - base_clips
        timed_batches = max(1, stats["batches"] - base_batches)
        _, p50, p95 = _ms_stats(lats)
        return {
            "p50_ms": round(p50, 2),
            "p95_ms": round(p95, 2),
            "clips_per_sec": round(n_done / wall, 1),
            "occupancy": round(timed_clips / (timed_batches * batch), 3),
        }

    with tempfile.TemporaryDirectory(prefix="socket_bench_") as tmp:
        paths = []
        for i in range(16):
            pth = os.path.join(tmp, f"clip_{i:02d}.wav")
            write_wav(pth, rng.normal(0, 0.2, seconds * SR).astype(
                np.float32), SR)
            paths.append(pth)
        multi = run_leg(paths, clients, per_client)
        single = run_leg(paths, 1, per_client)
    return {
        "socket_batch": batch,
        "socket_quant": quantize,
        "socket_wire": wire,
        "socket_clients": clients,
        "socket_p50_ms": multi["p50_ms"],
        "socket_p95_ms": multi["p95_ms"],
        "socket_clips_per_sec": multi["clips_per_sec"],
        "socket_occupancy": multi["occupancy"],
        "socket_1client_p50_ms": single["p50_ms"],
        "socket_1client_clips_per_sec": single["clips_per_sec"],
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--which", type=str, default="all",
                   choices=["all", "decode", "rawboost", "supcon", "serving",
                            "extract", "socket"],
                   help="'all' is decode, rawboost and supcon; serving, "
                        "extract and socket build a full encoder and run "
                        "only when named")
    p.add_argument("--extract_batch", type=int, default=32)
    p.add_argument("--extract_seconds", type=int, default=5)
    p.add_argument("--serving_model", type=str, default="xlsr",
                   choices=["xlsr", "tiny"])
    p.add_argument("--serving_batch", type=int, default=8)
    p.add_argument("--serving_seconds", type=int, default=5)
    p.add_argument("--serving_repeats", type=int, default=30)
    p.add_argument("--serving_quant", type=str, default="none",
                   choices=["none", "w8a8", "w8"],
                   help="int8 serving quantization (ops/quant.py)")
    p.add_argument("--socket_clients", type=int, default=8,
                   help="--which socket: concurrent closed-loop clients")
    p.add_argument("--socket_per_client", type=int, default=25,
                   help="--which socket: requests per client")
    p.add_argument("--socket_wire", type=str, default="float32",
                   choices=["float32", "int16"],
                   help="--which socket: host->device waveform format "
                        "(int16 halves the bytes to the device)")
    p.add_argument("--socket_max_wait_ms", type=float, default=5.0,
                   help="--which socket: batcher dispatch wait bound, the "
                        "latency/occupancy trade-off knob")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    results = {}
    if args.which in ("all", "decode"):
        results.update(bench_decode())
    if args.which in ("all", "rawboost"):
        results.update(bench_rawboost(device=device))
    if args.which in ("all", "supcon"):
        results.update(bench_supcon(device=device))
    if args.which == "serving":
        results.update(bench_serving(batch=args.serving_batch,
                                     seconds=args.serving_seconds,
                                     repeats=args.serving_repeats,
                                     model=args.serving_model,
                                     quantize=args.serving_quant,
                                     device=device))
    if args.which == "socket":
        results.update(bench_socket(batch=args.serving_batch,
                                    seconds=args.serving_seconds,
                                    clients=args.socket_clients,
                                    per_client=args.socket_per_client,
                                    model=args.serving_model,
                                    quantize=args.serving_quant,
                                    max_wait_ms=args.socket_max_wait_ms,
                                    wire=args.socket_wire, device=device))
    if args.which == "extract":
        results.update(bench_extract(batch=args.extract_batch,
                                     seconds=args.extract_seconds,
                                     model=args.serving_model,
                                     quantize=args.serving_quant,
                                     device=device))
    print(json.dumps(results))


if __name__ == "__main__":
    main()
