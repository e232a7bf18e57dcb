"""Multi-client scoring server: dynamic micro-batching over one scorer.

The port of wav2vec_contr_loss_tpu/eval/server.py. N concurrent clients
submit single clips; a `DynamicBatcher` coalesces them into the scorer's
static (batch, T) shape, zero-padding an under-full batch, so throughput
comes from batch occupancy while a clip waits at most `max_wait_ms` for
company.

  * One collector thread owns dispatch order. It runs on the scorer's
    device (`torch.cuda.device`), queues the batch's compute, then the
    copy of its logits into pinned host memory (non_blocking) behind a
    CUDA event, and hands the pending copy to the resolver through a
    depth-2 queue. It never waits for the device: the compute of batch
    N+1 is queued while batch N's logits are on their way back.
  * The resolver thread waits on each batch's event, not on the device,
    so it never waits for a batch queued after its own, and resolves the
    clients' futures. This is the discipline of
    data/pipeline.stream_through_device.
  * Clients share no state: each connection has a reader, a submitter
    and a writer thread over a line protocol, and every request resolves
    through a concurrent.futures result.

Line protocol (newline-delimited UTF-8, one request per line):
    <path>            -> response "<path>\\t<logit>"
    <id>\\t<path>      -> response "<id>\\t<logit>"
Only the first tab splits the id from the path. Higher logit == more
bonafide-like. A missing or corrupt file scores as silence (the zero-clip
contract of data/audio.py) and the stream stays alive.
"""

from __future__ import annotations

import queue
import socket
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from contextlib import nullcontext
from typing import Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..data.audio import AudioConfig, AudioLoader
from ..data.pipeline import _finish_fetch, _start_fetch

__all__ = ["DynamicBatcher", "ScoringServer", "decoded_tagged"]

_STOP = object()

# Per-request line cap in bytes. A line that reaches it without a newline
# is a protocol violation: the connection is dropped rather than buffered
# without bound.
_MAX_LINE = 64 * 1024


class DynamicBatcher:
    """Coalesce concurrent single-clip requests into static batches.

    `submit(wave)` returns a Future of the clip's float logit. The
    collector blocks for the first pending request, takes up to
    `batch - 1` more for at most `max_wait_ms`, zero-pads the rest and
    dispatches `score_fn(put_fn(waves))`, which queues the compute and
    returns the (batch,) logits without waiting. `device` is the device
    the collector thread runs on (the scorer's)."""

    def __init__(self, score_fn: Callable, batch: int, num_samples: int,
                 max_wait_ms: float = 5.0,
                 put_fn: Optional[Callable] = None,
                 device: Optional[torch.device] = None):
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self._score = score_fn
        self._put = put_fn if put_fn is not None else torch.from_numpy
        self._device = device
        self.batch = batch
        self.num_samples = num_samples
        self.max_wait = max_wait_ms / 1000.0
        # bounded: submit() blocks when decoding outruns the device
        self._q: queue.Queue = queue.Queue(maxsize=max(4 * batch, 16))
        self._resolve_q: queue.Queue = queue.Queue(maxsize=2)
        self.n_clips = 0
        self.n_batches = 0
        self._closed = False
        self._submit_lock = threading.Lock()
        self._collector = threading.Thread(target=self._collect,
                                           name="batcher-collect",
                                           daemon=True)
        self._resolver = threading.Thread(target=self._resolve,
                                          name="batcher-resolve",
                                          daemon=True)
        self._collector.start()
        self._resolver.start()

    # -- client side ------------------------------------------------------
    def submit(self, wave: np.ndarray) -> Future:
        """Queue one (T,) float32 clip; -> Future[float] logit. Blocks
        while the request queue is full."""
        fut: Future = Future()
        # check and enqueue under one lock, so that no request lands
        # behind close()'s _STOP with its future never resolved
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("DynamicBatcher is closed")
            self._q.put((np.asarray(wave, np.float32), fut))
        return fut

    def close(self) -> Dict[str, float]:
        """Drain pending requests, stop the threads, return the stats."""
        with self._submit_lock:
            already = self._closed
            self._closed = True
        if not already:
            self._q.put(_STOP)
            self._collector.join()
            self._resolver.join()
        occ = self.n_clips / max(1, self.n_batches * self.batch)
        return {"clips": self.n_clips, "batches": self.n_batches,
                "occupancy": round(occ, 3)}

    # -- worker side ------------------------------------------------------
    def dispatch(self, waves: np.ndarray):
        """(batch, T) float32 -> the pending copy of its logits to the
        host: queues the compute and the copy, and waits for neither."""
        return _start_fetch(self._score(self._put(waves)))

    def _collect(self) -> None:
        on_card = self._device is not None and self._device.type == "cuda"
        with torch.cuda.device(self._device) if on_card else nullcontext():
            self._collect_loop()

    def _collect_loop(self) -> None:
        while True:
            item = self._q.get()
            if item is _STOP:
                self._resolve_q.put(_STOP)
                return
            entries = [item]
            deadline = time.monotonic() + self.max_wait
            stop_after = False
            while len(entries) < self.batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stop_after = True
                    break
                entries.append(nxt)
            waves = np.zeros((self.batch, self.num_samples), np.float32)
            for i, (w, _) in enumerate(entries):
                n = min(w.shape[-1], self.num_samples)
                waves[i, :n] = w[..., :n]
            futs = [f for _, f in entries]
            try:
                pending = self.dispatch(waves)
            except Exception as e:  # a failed launch fails its requests
                for f in futs:
                    f.set_exception(e)
            else:
                # counters before the hand-off: the resolver can wake a
                # client the moment this put lands
                self.n_batches += 1
                self.n_clips += len(futs)
                self._resolve_q.put((pending, futs))
            if stop_after:
                self._resolve_q.put(_STOP)
                return

    def _resolve(self) -> None:
        while True:
            item = self._resolve_q.get()
            if item is _STOP:
                return
            pending, futs = item
            try:
                host = _finish_fetch(pending)   # waits on this batch's event
            except Exception as e:
                for f in futs:
                    f.set_exception(e)
                continue
            for i, f in enumerate(futs):
                f.set_result(float(host[i]))


def decoded_tagged(items: Iterable[Tuple[str, str]], loader: AudioLoader,
                   pool: ThreadPoolExecutor,
                   lookahead: int) -> Iterator[Tuple[str, np.ndarray]]:
    """(tag, path) stream -> (tag, waveform) in order, decoding up to
    `lookahead` items ahead on the caller's pool. It pulls: the first
    wave is yielded once `lookahead` items (or the end) arrived, right
    for a piped file list; ScoringServer's connections push instead."""
    pending: deque = deque()
    it = iter(items)
    exhausted = False
    while True:
        while not exhausted and len(pending) < lookahead:
            try:
                tag, path = next(it)
            except StopIteration:
                exhausted = True
                break
            pending.append((tag, pool.submit(loader.load, path)))
        if not pending:
            return
        tag, fut = pending.popleft()
        yield tag, fut.result()


class ScoringServer:
    """A threaded TCP front end over one shared DynamicBatcher.

    `scorer` is a `SpoofScorer`. Each connection gets a reader (parse
    lines, start the decode), a submitter (in request order: wait for the
    decode, submit) and a writer (in request order: wait for the logit,
    write the reply), so replies on one connection keep its order while
    clips from all connections share device batches.

    windowed: 'none' scores the first max_duration seconds (pad or trim);
    'mean' | 'min' | 'max' | 'median' scores each request's whole clip as
    overlapping windows of the clip length, each window one more submit,
    aggregated per request (SpoofScorer.score_long_waveforms).
    `max_clip_seconds` caps the windowed length of one request."""

    def __init__(self, scorer, host: str = "127.0.0.1", port: int = 0,
                 batch: int = 8,
                 audio_config: AudioConfig = AudioConfig(),
                 workers: int = 8, wire: str = "float32",
                 max_wait_ms: float = 5.0,
                 windowed: str = "none", hop_seconds: float = 2.5,
                 max_clip_seconds: float = 600.0,
                 log_fn: Callable[[str], None] = print):
        from ..cli.serve import _put_fn
        from .serving import _WINDOW_AGG

        if windowed == "none":
            self.loader = AudioLoader(audio_config)
            self._agg = None
        else:
            # decode at full length; each window has the scorer's length
            self.loader = AudioLoader(AudioConfig(
                audio_config.target_sample_rate, None))
            self._agg = _WINDOW_AGG[windowed]
        self._win_samples = audio_config.num_samples
        self._hop = max(1, int(hop_seconds
                               * audio_config.target_sample_rate))
        self._cap_samples = max(
            self._win_samples,
            int(max_clip_seconds * audio_config.target_sample_rate))
        put = _put_fn(wire, scorer)
        self.batcher = DynamicBatcher(
            lambda w: scorer.run(w)[1], batch, audio_config.num_samples,
            max_wait_ms=max_wait_ms, put_fn=lambda w: put((None, w)),
            device=scorer.device)
        self.pool = ThreadPoolExecutor(max_workers=workers,
                                       thread_name_prefix="decode")
        self.log = log_fn
        self._lookahead = max(2, workers)
        self._sock = socket.create_server((host, port))
        self.address: Tuple[str, int] = self._sock.getsockname()[:2]
        self._shutdown = threading.Event()
        self._conn_lock = threading.Lock()
        self._conns: dict = {}  # thread -> socket, live connections only

    # -- lifecycle --------------------------------------------------------
    def serve_forever(self) -> None:
        """Accept loop; returns after request_stop() or shutdown()."""
        self.log(f"[serve] listening on {self.address[0]}:{self.address[1]}")
        while not self._shutdown.is_set():
            try:
                conn, peer = self._sock.accept()
            except OSError:  # socket closed by request_stop()
                break
            t = threading.Thread(target=self._handle, args=(conn, peer),
                                 daemon=True)
            with self._conn_lock:
                # a connection accepted while shutdown() runs is refused,
                # so no handler starts against the closing batcher
                if self._shutdown.is_set():
                    try:
                        conn.close()
                    except OSError:
                        pass
                    continue
                self._conns[t] = conn  # _handle removes itself when done
            t.start()

    def request_stop(self) -> None:
        """Safe in a signal handler: stop the accept loop, join nothing;
        the caller then runs `shutdown()`."""
        self._shutdown.set()
        try:
            # wakes an accept() blocked in another thread (close alone
            # does not, on Linux)
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    def shutdown(self) -> Dict[str, float]:
        """Stop accepting, drain the live connections, close the batcher.

        Each live connection's read side is shut down, so its reader sees
        the end and stops submitting, while its writer still delivers
        every reply already submitted. The batcher closes only after all
        connection threads have ended."""
        self.request_stop()
        with self._conn_lock:
            live = dict(self._conns)
        for conn in live.values():
            try:
                conn.shutdown(socket.SHUT_RD)
            except OSError:
                pass  # already closed or reset
        for t in live:
            try:
                t.join(timeout=60)
            except RuntimeError:
                pass  # registered but not yet started
        stats = self.batcher.close()
        self.pool.shutdown(wait=False)
        self.log(f"[serve] done: {stats['clips']} clips in "
                 f"{stats['batches']} batches "
                 f"(occupancy {stats['occupancy']:.0%})")
        return stats

    # -- per connection ---------------------------------------------------
    def _handle(self, conn: socket.socket, peer) -> None:
        """Reader, submitter and writer of one connection. The reader
        never waits for a decode or a score, so an interactive client
        (one request, its reply, the next) is answered at once while a
        streaming client overlaps decode, scoring and replies. mid_q
        bounds the decodes ahead; out_q bounds the replies a client that
        never reads can pile up."""
        from .serving import window_waveform

        mid_q: queue.Queue = queue.Queue(maxsize=self._lookahead)
        out_q: queue.Queue = queue.Queue(maxsize=max(16, 4 * self._lookahead))

        def submitter():
            while True:
                entry = mid_q.get()
                if entry is _STOP:
                    out_q.put(_STOP)
                    return
                tag, dec_fut = entry
                try:
                    wave = dec_fut.result()
                    if self._agg is None:
                        futs = [self.batcher.submit(wave)]
                    else:
                        wins = window_waveform(
                            np.asarray(wave[: self._cap_samples],
                                       np.float32),
                            self._win_samples, self._hop)
                        futs = [self.batcher.submit(w) for w in wins]
                except Exception as e:  # batcher closed, pool torn down
                    f = Future()
                    f.set_exception(e)
                    futs = [f]
                out_q.put((tag, futs))

        def writer():
            wfile = conn.makefile("w", encoding="utf-8", newline="\n")
            # after the client goes away the writer keeps draining out_q
            # until _STOP: leaving early would block the submitter on a
            # full out_q and the reader on a full mid_q for good
            broken = False
            while True:
                entry = out_q.get()
                if entry is _STOP:
                    break
                tag, futs = entry
                try:
                    vals = [f.result() for f in futs]
                    logit = (vals[0] if self._agg is None
                             else float(self._agg(vals)))
                    line = f"{tag}\t{logit:.6f}\n"
                except Exception as e:
                    line = f"{tag}\tERROR {type(e).__name__}\n"
                if broken:
                    continue
                try:
                    wfile.write(line)
                    wfile.flush()
                except OSError:
                    broken = True  # the client went away: drain silently
            try:
                wfile.close()
            except OSError:
                pass

        st = threading.Thread(target=submitter, daemon=True)
        wt = threading.Thread(target=writer, daemon=True)
        st.start()
        wt.start()
        n = 0
        try:
            # bytes, so the cap counts bytes; undecodable bytes become a
            # path that fails to load (a zero clip), not a dead reader
            rfile = conn.makefile("rb")
            while True:
                raw = rfile.readline(_MAX_LINE)
                if not raw:
                    break
                if len(raw) >= _MAX_LINE and not raw.endswith(b"\n"):
                    self.log(f"[serve] {peer[0]}:{peer[1]}: request line "
                             f"exceeds {_MAX_LINE} bytes; closing")
                    break
                line = raw.decode("utf-8", errors="replace")
                line = line.rstrip("\n").rstrip("\r")
                if not line:
                    continue
                tag, _, path = line.partition("\t")
                if not path:
                    tag = path = line
                mid_q.put((tag, self.pool.submit(self.loader.load, path)))
                n += 1
        except OSError:
            pass  # the connection was reset
        except RuntimeError:
            pass  # the decode pool was torn down mid-read
        finally:
            mid_q.put(_STOP)
            st.join()
            wt.join()
            try:
                conn.close()
            except OSError:
                pass
            with self._conn_lock:
                self._conns.pop(threading.current_thread(), None)
            self.log(f"[serve] {peer[0]}:{peer[1]} disconnected "
                     f"after {n} clips")
