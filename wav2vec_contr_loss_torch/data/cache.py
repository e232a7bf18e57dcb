"""Decode-once waveform cache.

The port of wav2vec_contr_loss_tpu/data/cache.py. Training decodes every
clip once an epoch; the cache decodes the corpus once, through the
dataset's own `AudioLoader` (so a corrupted file is a zero row, counted
failed once at build time), into a fixed-shape memmap, and every later
epoch reads rows instead of decoding.

Storage is int16 by default, through the int16 wire format (ops/wire.py):
exact for unresampled 16-bit PCM, otherwise at most 1 LSB off with the
`wave != 0` set kept; `dtype='float32'` stores the decoder's output bit
for bit. The cache is valid while its manifest holds the fingerprint of
the utterance paths and the audio config; the manifest is the same JSON
as the JAX package writes, so a cache either package built attaches in
the other without a rebuild. A stale or missing manifest rebuilds.
Writes are crash-safe: the rows go to a temporary sibling, the old
manifest is removed before the data file is swapped in, and the new
manifest is renamed into place last.

Single process: the multi-host build-then-barrier of the JAX module
comes with the port's parallel training.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import numpy as np
from numpy.lib.format import open_memmap

from ..ops.wire import WIRE_SCALE, quantize_wire
from .audio import AudioLoader

__all__ = ["attach_cache", "build_cache", "CachedLoader"]

_MANIFEST = "cache_manifest.json"
_DATA = "waveforms.npy"


def _fingerprint(dataset, dtype: str) -> Dict:
    paths = "\n".join(str(u.path) for u in dataset.utterances)
    cfg = dataset.audio_config
    return {
        "version": 1,
        "n": len(dataset.utterances),
        "num_samples": int(cfg.num_samples),
        "sample_rate": int(cfg.target_sample_rate),
        "dtype": dtype,
        "paths_sha256": hashlib.sha256(paths.encode()).hexdigest(),
    }


class CachedLoader:
    """`AudioLoader.load(path)` by memmap row reads instead of decodes; a
    path the cache does not hold is decoded by the loader it replaced.
    A row read counts as a successful load (AudioLoader.loaded_count),
    as the JAX loader's does, and in `CachedLoader.rows_read`."""

    rows_read = 0
    _count_lock = threading.Lock()

    def __init__(self, memmap: np.ndarray, path_to_row: Dict[str, int],
                 fallback):
        self._mm = memmap
        self._rows = path_to_row
        self._fallback = fallback
        self.config = fallback.config

    def load(self, path) -> np.ndarray:
        i = self._rows.get(str(path))
        if i is None:
            return self._fallback.load(path)
        with AudioLoader._count_lock:
            AudioLoader.loaded_count += 1
        with CachedLoader._count_lock:
            CachedLoader.rows_read += 1
        row = self._mm[i]
        if row.dtype == np.int16:
            return row.astype(np.float32) * np.float32(1.0 / WIRE_SCALE)
        return np.array(row, dtype=np.float32)   # a copy: rows are reused


def build_cache(dataset, cache_dir: str, dtype: str = "int16",
                num_workers: int = 8, log=print) -> str:
    """Decode the whole dataset once into <cache_dir>/waveforms.npy and
    write its manifest. -> the data path."""
    if dtype not in ("int16", "float32"):
        raise ValueError(f"cache dtype must be int16|float32, got {dtype}")
    if dataset.audio_config.max_duration_seconds is None:
        raise ValueError("waveform cache needs fixed-length clips "
                         "(audio_config.max_duration_seconds is None)")
    os.makedirs(cache_dir, exist_ok=True)
    n = len(dataset.utterances)
    t = dataset.audio_config.num_samples
    data_path = os.path.join(cache_dir, _DATA)
    tmp = data_path + ".building"
    mm = open_memmap(tmp, mode="w+", dtype=np.dtype(dtype), shape=(n, t))
    log(f"[CACHE] decoding {n} clips -> {data_path} ({dtype}, "
        f"{mm.nbytes / 1e9:.2f} GB)")

    def decode_row(i: int) -> None:
        w = dataset.loader.load(dataset.utterances[i].path)
        mm[i] = quantize_wire(w) if dtype == "int16" else w

    with ThreadPoolExecutor(max(1, num_workers)) as pool:
        list(pool.map(decode_row, range(n)))
    mm.flush()
    del mm
    # no manifest may survive the data swap: an old manifest beside new
    # rows would serve the wrong audio for every clip after a crash here
    manifest_path = os.path.join(cache_dir, _MANIFEST)
    if os.path.exists(manifest_path):
        os.remove(manifest_path)
    os.replace(tmp, data_path)
    manifest_tmp = manifest_path + ".building"
    with open(manifest_tmp, "w") as f:
        json.dump(_fingerprint(dataset, dtype), f)
    os.replace(manifest_tmp, manifest_path)
    log(f"[CACHE] built ({n} rows)")
    return data_path


def _valid(dataset, cache_dir: str, dtype: str) -> bool:
    try:
        with open(os.path.join(cache_dir, _MANIFEST)) as f:
            return json.load(f) == _fingerprint(dataset, dtype)
    except (OSError, json.JSONDecodeError):
        return False


def attach_cache(dataset, cache_dir: str, dtype: str = "int16",
                 num_workers: int = 8, log=print) -> bool:
    """Point `dataset.loader` at the cache in `cache_dir`, building it
    first when it is absent or stale. -> True if a build ran."""
    built = not _valid(dataset, cache_dir, dtype)
    if built:
        build_cache(dataset, cache_dir, dtype=dtype,
                    num_workers=num_workers, log=log)
    mm = np.load(os.path.join(cache_dir, _DATA), mmap_mode="r")
    rows = {str(u.path): i for i, u in enumerate(dataset.utterances)}
    dataset.loader = CachedLoader(mm, rows, dataset.loader)
    if not built:
        log(f"[CACHE] reusing {cache_dir} ({len(rows)} rows)")
    return built
