"""Host input pipeline: threaded decode, fixed-shape batch assembly and a
prefetching producer thread.

The port's copy of `Batch`, `BatchPipeline`, `prefetch_to_device` and
`stream_through_device` of wav2vec_contr_loss_tpu/data/pipeline.py. A
thread pool decodes and pads clips into numpy batches of static shape
(B, samples), with an optional host RawBoost pass (rawboost_mode='host');
`prefetch_to_device` runs the caller's put function `depth` batches
ahead in a background thread. The trainer's put pins the host arrays
there; its train step makes the non-blocking copy to the card from the
main thread, on the stream that consumes the batch, so no copy races the
step that reads it.

Eval iterates sequentially and pads the final partial batch with zero
clips plus a `valid` mask, keeping every shape identical.
`stream_through_device` maps a device function over such batches with
the host decode, the device compute and the copy of results back
overlapped (extraction and dataset scoring).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from .protocols import SpoofDataset
from .rawboost import RawBoostParams, apply_rawboost_batch
from .sampler import BalancedBatchSampler
from ..utils.timing import span

__all__ = ["Batch", "BatchPipeline", "prefetch_to_device",
           "stream_through_device"]


@dataclass
class Batch:
    waveforms: np.ndarray     # (B, T) float32
    labels: np.ndarray        # (B,) int32, 1 = bonafide
    multi_labels: np.ndarray  # (B,) int32 attack-id classes
    valid: np.ndarray         # (B,) bool, False on eval-tail padding
    # host-side metadata; never shipped to the device
    speakers: tuple = ()
    sources: tuple = ()
    names: tuple = ()

    @property
    def size(self) -> int:
        return int(self.valid.sum())


class BatchPipeline:
    """Assembles fixed-shape batches from a SpoofDataset.

    train mode: balanced epoch-seeded batches (BalancedBatchSampler).
    sequential mode: dataset order, final batch zero-padded + masked.
    """

    def __init__(
        self,
        dataset: SpoofDataset,
        batch_size: int,
        seed: int = 1337,
        num_workers: int = 8,
        rawboost: Optional[RawBoostParams] = None,  # host-side RawBoost
        rawboost_prob: float = 0.7,
        rank: int = 0,
        world_size: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.rawboost = rawboost
        self.rawboost_prob = rawboost_prob
        self.rank = rank
        self.world_size = world_size
        self._sampler: Optional[BalancedBatchSampler] = None
        self._labels = dataset.labels
        self._multi = dataset.multi_labels

    @property
    def sampler(self) -> BalancedBatchSampler:
        # lazy: sequential-only pipelines may use batch sizes the balanced
        # sampler would reject (odd sizes)
        if self._sampler is None:
            self._sampler = BalancedBatchSampler(
                self._labels, self.batch_size, seed=self.seed,
                rank=self.rank, world_size=self.world_size,
            )
        return self._sampler

    @property
    def batches_per_epoch(self) -> int:
        return self.sampler.num_batches

    def _assemble(self, indices: np.ndarray, pool: ThreadPoolExecutor,
                  rng: Optional[np.random.Generator]) -> Batch:
        t = self.dataset.audio_config.num_samples
        b = len(indices)
        waves = np.zeros((b, t), dtype=np.float32)
        labels = np.zeros(b, dtype=np.int32)
        multi = np.zeros(b, dtype=np.int32)
        valid = np.zeros(b, dtype=bool)

        real = indices[indices >= 0]
        loaded = list(pool.map(
            lambda i: self.dataset.loader.load(self.dataset.utterances[i].path),
            real,
        ))
        speakers, sources, names = [], [], []
        for slot, (i, w) in enumerate(zip(real, loaded)):
            waves[slot, : w.shape[0]] = w[:t]
            labels[slot] = self._labels[i]
            multi[slot] = self._multi[i]
            valid[slot] = True
            utt = self.dataset.utterances[i]
            speakers.append(utt.speaker)
            sources.append(utt.source)
            names.append(utt.name)

        if self.rawboost is not None and rng is not None:
            waves = apply_rawboost_batch(
                waves, rng, self.rawboost, prob=self.rawboost_prob
            )
        return Batch(waves, labels, multi, valid,
                     tuple(speakers), tuple(sources), tuple(names))

    def train_epoch(self, epoch: int, skip: int = 0) -> Iterator[Batch]:
        """Balanced batches for one epoch. Host RawBoost (if configured) is
        seeded per (seed, epoch, batch), so a mid-epoch resume (`skip` > 0)
        replays the remaining batches with the draws an uninterrupted epoch
        would have used; skipped batches are never decoded."""
        with ThreadPoolExecutor(self.num_workers) as pool:
            for i, idx in enumerate(self.sampler.epoch_batches(epoch)):
                if i < skip:
                    continue
                rng = np.random.default_rng([self.seed, epoch, i])
                yield self._assemble(idx, pool, rng)

    def sequential(self, indices: Optional[np.ndarray] = None,
                   part: Optional[Tuple[int, int]] = None) -> Iterator[Batch]:
        """Dataset-order batches (eval / embedding extraction); the last
        partial batch is padded with invalid zero clips. `part` (i, n):
        only rows [i*B/n, (i+1)*B/n) of each padded batch are decoded and
        yielded (a gang's data rank i of n)."""
        n = len(self.dataset) if indices is None else len(indices)
        order = np.arange(n) if indices is None else np.asarray(indices)
        rows = slice(None)
        if part is not None:
            i, parts = part
            if self.batch_size % parts:
                raise ValueError(f"batch {self.batch_size} not divisible by "
                                 f"{parts} parts")
            per = self.batch_size // parts
            rows = slice(i * per, (i + 1) * per)
        with ThreadPoolExecutor(self.num_workers) as pool:
            for start in range(0, n, self.batch_size):
                chunk = order[start : start + self.batch_size]
                if chunk.size < self.batch_size:
                    pad = np.full(self.batch_size - chunk.size, -1, dtype=np.int64)
                    chunk = np.concatenate([chunk, pad])
                yield self._assemble(chunk[rows], pool, None)


def prefetch_to_device(
    iterator: Iterator,
    put_fn,
    depth: int = 2,
) -> Iterator:
    """A background thread runs `put_fn` on the items of `iterator`,
    `depth` items ahead of the consumer. Under a profiler the consumer's
    wait is a `w2v.feed_wait` range and each `put_fn` a `w2v.feed_put`
    range (recorded where the profiler traces every thread)."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    err: list = []
    stop = threading.Event()

    def producer():
        try:
            for item in iterator:
                if stop.is_set():  # consumer abandoned the generator
                    return
                with span("w2v.feed_put"):
                    out = put_fn(item)
                if stop.is_set():
                    return
                q.put(out)
        except BaseException as e:  # surfaced to the consumer below
            err.append(e)
        finally:
            close = getattr(iterator, "close", None)
            if close is not None:   # a generator: shut its decode pool now
                close()
            q.put(sentinel)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            with span("w2v.feed_wait"):
                item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        # Runs on exhaustion AND when the consumer abandons the generator
        # (the preemption break in fit): signal the producer and drain the
        # queue so its blocked put can complete, else the thread, its
        # decode pool and `depth` pinned batches leak for the life of the
        # process.
        stop.set()
        while thread.is_alive():
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass


def _start_fetch(out):
    """Queue the copy of a result (a tensor or a tuple/list of them) to
    the host. On the card: a non-blocking copy into pinned memory (from
    PyTorch's caching host allocator) and an event behind it."""
    parts = list(out) if isinstance(out, (tuple, list)) else [out]
    if all(p.device.type == "cpu" for p in parts):
        return out, parts, None
    host = [p.to("cpu", non_blocking=True) for p in parts]
    event = torch.cuda.Event()
    event.record()
    return out, host, event


def _finish_fetch(pending):
    """Wait for a queued copy; -> numpy arrays in the result's shape."""
    out, host, event = pending
    if event is not None:
        event.synchronize()
    arrays = [h.numpy() for h in host]
    if isinstance(out, (tuple, list)):
        return type(out)(arrays)
    return arrays[0]


def stream_through_device(batches: Iterator, put_fn, apply_fn,
                          depth: int = 2) -> Iterator:
    """Map `apply_fn` over `batches` with three stages overlapped:

      * `put_fn(batch)` runs in a background thread `depth` batches ahead
        (prefetch_to_device): decoding, the int16 wire, pinning;
      * `apply_fn(put_result)` queues the compute on the device and
        returns a tensor, or a tuple/list of tensors, without waiting;
      * each result's copy to the host is queued right behind its compute
        and waited for only after the next batch's compute is queued, so
        the copy of batch i-1 overlaps the compute of batch i.

    Yields `(host_result, batch)` pairs in order, the result as numpy."""
    from collections import deque

    pending: "deque" = deque()
    for dev, batch in prefetch_to_device(
            batches, lambda b: (put_fn(b), b), depth=depth):
        pending.append((_start_fetch(apply_fn(dev)), batch))
        if len(pending) >= max(depth, 1):
            fetch, b = pending.popleft()
            yield _finish_fetch(fetch), b
    while pending:
        fetch, b = pending.popleft()
        yield _finish_fetch(fetch), b
