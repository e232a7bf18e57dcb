"""Scoring daemon: audio paths in, spoof scores out.

    find corpus/ -name '*.flac' | python -m wav2vec_contr_loss_torch serve \\
        --stage1_dir ckpt/stage1 --stage2_dir ckpt/stage2
    python -m wav2vec_contr_loss_torch serve --stage1_dir ... \\
        --stage2_dir ... --socket 127.0.0.1:9000

The port of wav2vec_contr_loss_tpu/cli/serve.py over the port's
`SpoofScorer` on the card (`--device cpu` for the CPU). Stream mode reads
newline-separated paths from stdin (or `--list`) and prints one
`path<TAB>logit` line per clip, flushed as it goes, with `--threshold`
adding a bonafide/spoof column. `--socket HOST:PORT` serves the line
protocol of eval/server.py to concurrent clients, whose clips share
device batches; SIGTERM and SIGINT stop it after the replies in flight.
Decoding runs in a thread pool ahead of the device; a missing or corrupt
file scores as silence and is counted. Higher logit == more
bonafide-like. `--windowed` scores each clip's whole length as
overlapping windows. `--quantize w8a8|w8` serves the encoder's
transformer linears in int8 (ops/quant.py). `--artifact FILE` serves an
`export_serving` artifact instead of checkpoints: its batch, clip
length, wire and sample rate are baked in (a conflicting flag exits 2),
it runs on the device type it was traced for, and no model code is
imported.
"""

from __future__ import annotations

import argparse
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Tuple

import numpy as np
import torch

from ..data.audio import AudioConfig, AudioLoader
from ..ops.wire import quantize_wire

__all__ = ["score_paths", "score_paths_windowed", "main"]

_WIRES = ("float32", "int16")


def _log(m: str) -> None:
    """Best-effort stderr log: a daemon whose stderr reader died keeps
    serving."""
    try:
        print(m, file=sys.stderr)
    except OSError:
        pass


def _decoded(paths: Iterable[str], loader: AudioLoader, workers: int,
             lookahead: int) -> Iterator[Tuple[str, np.ndarray]]:
    """(path, waveform) in input order, decoded on a private pool up to
    `lookahead` clips ahead."""
    from ..eval.server import decoded_tagged

    with ThreadPoolExecutor(max_workers=workers) as pool:
        yield from decoded_tagged(((p, p) for p in paths), loader, pool,
                                  lookahead)


def _put_fn(wire: str, scorer):
    """(meta, (B, T) float32 waves) -> a host tensor in the wire dtype,
    pinned when the scorer is on the card (its copy to the device is
    non-blocking)."""
    if wire not in _WIRES:
        raise ValueError(f"wire must be one of {_WIRES}; got {wire!r}")
    pin = scorer.device.type == "cuda"

    def put(chunk_waves):
        _, waves = chunk_waves
        host = torch.from_numpy(quantize_wire(waves) if wire == "int16"
                                else np.asarray(waves, np.float32))
        return host.pin_memory() if pin else host

    return put


def _batched_waves(paths: Iterable[str], loader: AudioLoader, batch: int,
                   workers: int) -> Iterator[Tuple[list, np.ndarray]]:
    """Decode `paths` two batches ahead and group them into (paths,
    (batch, T) float32) batches, the last one zero-padded."""
    t = loader.config.num_samples
    done_paths, done_waves = [], []
    for p, w in _decoded(paths, loader, workers, 2 * batch):
        done_paths.append(p)
        done_waves.append(w)
        if len(done_paths) == batch:
            yield done_paths, np.stack(done_waves)
            done_paths, done_waves = [], []
    if done_paths:
        waves = np.zeros((batch, t), np.float32)
        waves[:len(done_paths)] = np.stack(done_waves)
        yield done_paths, waves


def score_paths(scorer, paths: Iterable[str], batch: int = 8,
                audio_config: AudioConfig = AudioConfig(),
                workers: int = 8,
                wire: str = "float32") -> Iterator[Tuple[str, float]]:
    """Yield (path, logit) in input order, in static batches with the
    tail padded. Decode and pinning run ahead of the device, and batch
    N+1's compute is queued before batch N's logits are read
    (stream_through_device)."""
    from ..data.pipeline import stream_through_device

    loader = AudioLoader(audio_config)
    for logits, (chunk, _) in stream_through_device(
            _batched_waves(paths, loader, batch, workers),
            _put_fn(wire, scorer), lambda w: scorer.run(w)[1]):
        for p, lg in zip(chunk, logits[:len(chunk)]):
            yield p, float(lg)


def score_paths_windowed(scorer, paths: Iterable[str], batch: int = 8,
                         audio_config: AudioConfig = AudioConfig(),
                         workers: int = 8, wire: str = "float32",
                         hop_seconds: float = 2.5, agg: str = "mean",
                         max_clip_seconds: float = 600.0,
                         ) -> Iterator[Tuple[str, float]]:
    """Yield (path, logit) in input order, each clip's whole length (up to
    `max_clip_seconds`) scored as overlapping windows of the clip length
    and aggregated (SpoofScorer.score_long_waveforms). Windows of
    consecutive clips share batches of the static shape."""
    from ..data.pipeline import stream_through_device
    from ..eval.serving import _WINDOW_AGG, window_waveform

    t = audio_config.num_samples
    hop = max(1, int(hop_seconds * audio_config.target_sample_rate))
    cap = max(t, int(max_clip_seconds * audio_config.target_sample_rate))
    full_loader = AudioLoader(AudioConfig(audio_config.target_sample_rate,
                                          None))
    aggf = _WINDOW_AGG[agg]
    clips: dict = {}  # pid -> [path, n_windows, logits so far]

    def batches():
        # a few clips of lookahead: each clip may be long and gives
        # several windows
        buf_ids, buf_rows = [], []
        for pid, (p, wave) in enumerate(
                _decoded(paths, full_loader, workers, max(2, workers))):
            wins = window_waveform(wave[:cap], t, hop)
            clips[pid] = [p, wins.shape[0], []]
            buf_ids.extend([pid] * wins.shape[0])
            buf_rows.extend(wins)
            while len(buf_ids) >= batch:
                yield buf_ids[:batch], np.stack(buf_rows[:batch])
                buf_ids, buf_rows = buf_ids[batch:], buf_rows[batch:]
        if buf_ids:
            waves = np.zeros((batch, t), np.float32)
            waves[:len(buf_rows)] = np.stack(buf_rows)
            yield buf_ids, waves

    emit_next = 0
    for logits, (ids, _) in stream_through_device(
            batches(), _put_fn(wire, scorer), lambda w: scorer.run(w)[1]):
        for pid, lg in zip(ids, logits[:len(ids)]):
            clips[pid][2].append(float(lg))
        while emit_next in clips and (
                len(clips[emit_next][2]) == clips[emit_next][1]):
            path, _, ls = clips.pop(emit_next)
            yield path, float(aggf(ls))
            emit_next += 1


def _stdin_paths() -> Iterator[str]:
    for line in sys.stdin:
        line = line.strip()
        if line:
            yield line


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--artifact", type=str, default=None,
                   help="serve from an export_serving artifact instead of "
                        "checkpoints: batch, clip length, wire and sample "
                        "rate come from the artifact, which needs no model "
                        "code or checkpoint files")
    p.add_argument("--stage1_dir", type=str, default=None)
    p.add_argument("--stage1_name", type=str, default="best")
    p.add_argument("--stage2_dir", type=str, default=None)
    p.add_argument("--stage2_name", type=str,
                   default="stage2_binary_head_best")
    p.add_argument("--list", dest="list_file", type=str, default=None,
                   help="file with one audio path per line (default: stdin)")
    p.add_argument("--batch", type=int, default=None,
                   help="static serving batch (default 8; baked into an "
                        "artifact)")
    p.add_argument("--max_duration_seconds", type=int, default=None,
                   help="(default 5; baked into an artifact)")
    p.add_argument("--target_sample_rate", type=int, default=None,
                   help="(default 16000; recorded in an artifact's header)")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--wire", type=str, default=None, choices=_WIRES,
                   help="host->device waveform format; int16 halves the "
                        "bytes (exact for unresampled PCM); default float32 "
                        "(baked into an artifact)")
    p.add_argument("--quantize", type=str, default="none",
                   choices=["none", "w8a8", "w8"],
                   help="int8 transformer linears (ops/quant.py): 'w8a8' "
                        "int8 activations and weights, int8 products; 'w8' "
                        "int8 weights, bf16 products")
    p.add_argument("--threshold", type=float, default=None,
                   help="decision threshold: adds a bonafide/spoof column "
                        "(e.g. the dev-EER threshold of eval_scores)")
    p.add_argument("--socket", type=str, default=None, metavar="HOST:PORT",
                   help="serve the TCP line protocol of eval/server.py "
                        "(port 0 = ephemeral, printed on stderr): clients "
                        "send '<path>' or '<id>\\t<path>' lines")
    p.add_argument("--max_wait_ms", type=float, default=5.0,
                   help="--socket: longest wait of an under-full batch "
                        "before it is dispatched padded")
    p.add_argument("--windowed", type=str, default="none",
                   choices=["none", "mean", "min", "max", "median"],
                   help="score each clip's whole length as overlapping "
                        "windows aggregated with this statistic; default "
                        "scores the first max_duration_seconds")
    p.add_argument("--hop_seconds", type=float, default=2.5,
                   help="window hop for --windowed")
    p.add_argument("--max_clip_seconds", type=float, default=600.0,
                   help="--windowed: the longest length of one clip that "
                        "is scored")
    p.add_argument("--device", type=str, default=None,
                   help="'cuda' (default) or 'cpu'; an artifact runs on the "
                        "device type it was traced for")
    return p


def _artifact_scorer(p: argparse.ArgumentParser, args):
    """-> (ExportedScorer, batch, wire, AudioConfig) from --artifact; a
    flag that conflicts with what the artifact bakes in exits 2."""
    # the serving signature is baked into the artifact: a conflicting flag
    # is refused, not silently overridden
    if args.quantize != "none":
        p.error("--quantize is baked into the artifact at export time; "
                "it cannot be changed at serve time")
    from ..eval.artifact import load_exported

    try:
        scorer, spec = load_exported(args.artifact, with_spec=True,
                                     device=args.device)
    except ValueError as e:
        p.error(str(e))
    for flag, given, baked in (("--batch", args.batch, spec.batch),
                               ("--wire", args.wire, spec.wire)):
        if given is not None and given != baked:
            p.error(f"{flag}={given} conflicts with the artifact's "
                    f"baked {flag.lstrip('-')}={baked}")
    sr = spec.sample_rate
    if args.target_sample_rate is not None and args.target_sample_rate != sr:
        p.error(f"--target_sample_rate={args.target_sample_rate} "
                f"conflicts with the artifact's recorded {sr} Hz")
    if spec.num_samples % sr:
        p.error(f"artifact expects {spec.num_samples} samples/clip, not a "
                f"whole number of seconds at {sr} Hz")
    dur = spec.num_samples // sr
    if (args.max_duration_seconds is not None
            and args.max_duration_seconds != dur):
        p.error(f"--max_duration_seconds={args.max_duration_seconds} "
                f"conflicts with the artifact's {dur} s clips")
    _log(f"[serve] artifact {args.artifact}: batch={spec.batch}, "
         f"{spec.num_samples} samples/clip @ {sr} Hz, wire={spec.wire}, "
         f"device={spec.device}"
         + (f", quantize={spec.quantize}"
            if spec.quantize not in (None, "none") else ""))
    return (scorer, spec.batch, spec.wire,
            AudioConfig(target_sample_rate=sr, max_duration_seconds=dur))


def main(argv=None) -> None:
    p = build_parser()
    args = p.parse_args(argv)
    socket_addr = None
    if args.socket is not None:
        # checked before the scorer is built
        if args.threshold is not None:
            p.error("--threshold applies to the stream mode; socket clients "
                    "receive raw logits")
        if args.list_file is not None:
            p.error("--list applies to the stream mode; socket clients "
                    "send their own path lists over the connection")
        host, _, port = args.socket.rpartition(":")
        try:
            socket_addr = (host or "127.0.0.1", int(port))
        except ValueError:
            p.error(f"--socket expects HOST:PORT, got {args.socket!r}")
    if args.artifact is not None:
        scorer, batch, wire, audio_cfg = _artifact_scorer(p, args)
    else:
        if args.stage1_dir is None or args.stage2_dir is None:
            p.error("either --artifact or both --stage1_dir and "
                    "--stage2_dir are required")
        from ..eval.serving import SpoofScorer

        batch = 8 if args.batch is None else args.batch
        wire = args.wire or "float32"
        audio_cfg = AudioConfig(
            target_sample_rate=args.target_sample_rate or 16000,
            max_duration_seconds=5 if args.max_duration_seconds is None
            else args.max_duration_seconds)
        scorer = SpoofScorer.from_checkpoints(
            args.stage1_dir, args.stage2_dir, stage1_name=args.stage1_name,
            stage2_name=args.stage2_name, device=args.device or "cuda",
            quantize=args.quantize)

    if socket_addr is not None:
        import signal

        from ..eval.server import ScoringServer

        server = ScoringServer(
            scorer, socket_addr[0], socket_addr[1], batch=batch,
            audio_config=audio_cfg, workers=args.num_workers,
            wire=wire, max_wait_ms=args.max_wait_ms,
            windowed=args.windowed, hop_seconds=args.hop_seconds,
            max_clip_seconds=args.max_clip_seconds, log_fn=_log)
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda *_: server.request_stop())
        server.serve_forever()
        server.shutdown()
        return

    if args.list_file is None:
        paths = _stdin_paths()
    else:
        with open(args.list_file) as f:
            paths = [line.strip() for line in f if line.strip()]
    if args.windowed != "none":
        scored = score_paths_windowed(
            scorer, paths, batch=batch, audio_config=audio_cfg,
            workers=args.num_workers, wire=wire,
            hop_seconds=args.hop_seconds, agg=args.windowed,
            max_clip_seconds=args.max_clip_seconds)
    else:
        scored = score_paths(scorer, paths, batch=batch,
                             audio_config=audio_cfg,
                             workers=args.num_workers, wire=wire)
    n = 0
    try:
        for path, logit in scored:
            if args.threshold is None:
                print(f"{path}\t{logit:.6f}", flush=True)
            else:
                label = "bonafide" if logit >= args.threshold else "spoof"
                print(f"{path}\t{logit:.6f}\t{label}", flush=True)
            n += 1
    except BrokenPipeError:
        # the reader closed the pipe (`| head`): stop cleanly, with stdout
        # on devnull so the interpreter's last flush does not raise again
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        _log(f"[serve] downstream pipe closed after {n} clips")
        return
    _log(f"[serve] scored {n} clips "
         f"(decode ok={AudioLoader.loaded_count} "
         f"failed={AudioLoader.failed_count})")


if __name__ == "__main__":
    main()
