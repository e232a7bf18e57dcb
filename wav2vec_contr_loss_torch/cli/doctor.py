"""Environment check: `python -m wav2vec_contr_loss_torch doctor`.

Answers "will training and serving run on this host?" before a long job
starts: the card (name and power limit, CUDA, nvcc, triton), the builds
of the port's CUDA sources and of the native audio decoder with a decode
round trip, an eval forward of a tiny encoder on the card that must
launch exactly one attention kernel a layer and one LN+GELU kernel a
conv, torch.distributed's backends (and the gang, under torchrun), a
checkpoint round trip and a decode-once waveform cache round trip. One `[ ok ]` or `[FAIL]` line a check;
the exit code is 1 if any check fails. `--device cpu` runs the forward on
the CPU and reports the card's checks as absent, which fails them.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import tempfile
import traceback
from typing import Callable, List, Tuple

import numpy as np
import torch

# (name, needs the card, check(device) -> detail)
_CHECKS: List[Tuple[str, bool, Callable]] = []


def check(name: str, card: bool = False):
    def reg(fn):
        _CHECKS.append((name, card, fn))
        return fn
    return reg


@check("card", card=True)
def _card(dev) -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("torch sees no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = (smi.stdout.strip() if smi.returncode == 0
            else f"{torch.cuda.get_device_name(0)} (nvidia-smi failed)")
    return (f"{card}, {torch.cuda.device_count()} device(s), torch "
            f"{torch.__version__}, CUDA {torch.version.cuda}")


@check("nvcc", card=True)
def _nvcc(dev) -> str:
    from ..ops._build import _nvcc

    path = _nvcc()
    out = subprocess.run([path, "--version"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    return f"{path}: {out[-1] if out else '?'}"


@check("triton", card=True)
def _triton(dev) -> str:
    import triton

    return f"triton {triton.__version__}"


@check("CUDA kernel builds", card=True)
def _cuda_builds(dev) -> str:
    from ..ops import _build

    names = sorted(p.stem for p in _build.SRC_DIR.glob("*.cu"))
    built = _build.build(names)
    return f"{', '.join(names)} -> {_build.BUILD_DIR} ({len(built)} libraries)"


@check("native audio decoder")
def _native(dev) -> str:
    from ..data.audio import (AudioConfig, AudioLoader, _decode_native,
                              _native_target, native_decoder, write_wav)

    native_decoder()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "probe.wav")
        x = (0.25 * np.sin(2 * np.pi * 440 * np.arange(16000) / 16000)
             ).astype(np.float32)
        write_wav(path, x, 16000)
        y, sr = _decode_native(path)
        w = AudioLoader(AudioConfig(16000, 1)).load(path)
        if sr != 16000 or y.shape != (16000,) or not np.array_equal(y, w):
            raise RuntimeError(f"decode round trip failed: {y.shape} @ {sr}")
    return f"{_native_target()}: WAV decode round trip ok"


@check("eval forward (tiny encoder)")
def _forward(dev) -> str:
    from ..config import Wav2Vec2Config
    from ..models.wav2vec2 import Wav2Vec2Encoder
    from ..ops import attention, conv_ln

    # head dim 64, as the attention kernels take
    on_card = dev.type == "cuda"
    cfg = Wav2Vec2Config(
        hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256,
        conv_dim=(64, 64), conv_kernel=(10, 3), conv_stride=(5, 2),
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        apply_spec_augment=False,
        dtype="bfloat16" if on_card else "float32")
    torch.manual_seed(0)
    enc = Wav2Vec2Encoder(cfg).to(dev).eval()
    wave = torch.zeros(2, 4000, device=dev)
    wave[:, :3000] = 0.1 * torch.randn(2, 3000, device=dev)
    attention.launches = conv_ln.launches = 0
    with torch.inference_mode():
        out = enc(wave, wave != 0.0)["layer_mean"]
    got = float(out.float().sum())   # waits for the device
    if not torch.isfinite(out).all() or out.shape[0] != 2:
        raise RuntimeError(f"bad output {tuple(out.shape)}")
    # the wrappers count launches of their kernels; on the CPU they run
    # the plain versions
    counts = (attention.launches, conv_ln.launches)
    want = (cfg.num_layers, len(cfg.conv_dim)) if on_card else (0, 0)
    if counts != want:
        raise RuntimeError(f"kernel launches (attention, LN+GELU) {counts}, "
                           f"expected {want}")
    return (f"{dev}: layer_mean{tuple(out.shape)} sum={got:.3f}, launches "
            f"attention {counts[0]}, LN+GELU {counts[1]}")


@check("torch.distributed")
def _distributed(dev) -> str:
    """The backends a gang needs (NCCL on the card, Gloo on the CPU), and
    the gang this process is in under torchrun (the JAX doctor's
    "N device(s), P process(es)")."""
    import torch.distributed as dist

    from ..utils import distributed

    if not dist.is_available():
        raise RuntimeError("this torch build has no torch.distributed")
    nccl, gloo = dist.is_nccl_available(), dist.is_gloo_available()
    need = "NCCL" if dev.type == "cuda" else "Gloo"
    if not (nccl if dev.type == "cuda" else gloo):
        raise RuntimeError(f"{need} is not available: a gang on {dev.type} "
                           f"needs it")
    if distributed.launched():
        gang = (f"launched under torchrun: world size "
                f"{os.environ['WORLD_SIZE']}, rank {os.environ['RANK']}, "
                f"local rank {os.environ.get('LOCAL_RANK', '?')}")
    else:
        gang = "not launched under torchrun (one process)"
    return (f"NCCL {'available' if nccl else 'absent'}, Gloo "
            f"{'available' if gloo else 'absent'}; {gang}")


@check("checkpoint write/restore")
def _ckpt(dev) -> str:
    from ..train import checkpoint as ckpt

    with tempfile.TemporaryDirectory() as d:
        state = {"w": torch.arange(8, dtype=torch.float32)}
        ckpt.save_checkpoint(d, "probe", state, config={"OK": 1},
                             metrics={"epoch": 1})
        back, sidecar = ckpt.restore_checkpoint(d, "probe")
        if not torch.equal(back["w"], state["w"]):
            raise RuntimeError("restore mismatch")
        if sidecar["config"] != {"OK": 1}:
            raise RuntimeError("sidecar mismatch")
    return "save/restore round trip ok"


@check("waveform cache")
def _cache(dev) -> str:
    from ..data import AudioConfig, parse_asvspoof2019
    from ..data.audio import write_wav
    from ..data.cache import attach_cache

    with tempfile.TemporaryDirectory() as d:
        lines = []
        for i in range(2):
            x = (0.25 * np.sin(2 * np.pi * (300 + 100 * i)
                               * np.arange(16000) / 16000)).astype(np.float32)
            write_wav(os.path.join(d, f"c{i}.wav"), x, 16000)
            lines.append(f"x/c{i}.wav - bonafide - SPK{i}")
        proto = os.path.join(d, "protocol.txt")
        with open(proto, "w") as f:
            f.write("\n".join(lines) + "\n")

        def dataset():
            return parse_asvspoof2019(proto, d, audio=AudioConfig(16000, 1))

        plain, cached = dataset(), dataset()
        quiet = dict(num_workers=2, log=lambda m: None)
        built = attach_cache(cached, os.path.join(d, "cache"), **quiet)
        if not built or attach_cache(dataset(), os.path.join(d, "cache"),
                                     **quiet):
            raise RuntimeError("the cache was not built once, then reused")
        for u in plain.utterances:
            if not np.array_equal(cached.loader.load(u.path),
                                  plain.loader.load(u.path)):
                raise RuntimeError(f"cached row of {u.name} differs from "
                                   f"its decode")
    return "2-clip int16 cache built, reused and read back bit for bit"


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu': where the forward runs")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    failed = 0
    for name, card, fn in _CHECKS:
        if card and dev.type != "cuda":
            failed += 1
            print(f"[FAIL] {name}: absent (--device {args.device})")
            continue
        try:
            print(f"[ ok ] {name}: {fn(dev)}")
        except Exception as e:  # each check reports its own failure
            failed += 1
            print(f"[FAIL] {name}: {type(e).__name__}: {e}")
            if os.environ.get("DOCTOR_TRACE"):
                traceback.print_exc()
    print(f"==> doctor: {len(_CHECKS) - failed}/{len(_CHECKS)} checks passed")
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
