"""Embedding extraction to .npy, the filesystem contract between the
pipeline's stages.

The port of wav2vec_contr_loss_tpu/eval/extract.py:

  * `extract_embeddings`: a stage-1 backbone's (N, D) L2-normalized clip
    embeddings and (N,) labels per split, skipped when both files exist;
  * `extract_encoder_features`: the encoder's raw layer-mean features,
    padded or cropped to FIXED_TIME_DIM frames, streamed into an
    (N, F, 250) fp32 memmap flushed after every batch (so a cut run
    leaves valid rows), with optional host RawBoost on the train split.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data.pipeline import BatchPipeline, stream_through_device
from ..data.rawboost import RawBoostParams, apply_rawboost_batch
from ..device import resolve_device
from ..utils import distributed

__all__ = ["extract_embeddings", "extract_encoder_features",
           "load_embeddings", "FIXED_TIME_DIM"]

FIXED_TIME_DIM = 250   # frames a clip's features are padded or cropped to


def _paths(out_dir: str, split_name: str) -> Tuple[str, str]:
    return (
        os.path.join(out_dir, f"{split_name}_embeddings.npy"),
        os.path.join(out_dir, f"{split_name}_labels.npy"),
    )


def extract_embeddings(
    embed_dataset: Callable[[BatchPipeline], Tuple[np.ndarray, np.ndarray]],
    pipe: BatchPipeline,
    out_dir: str,
    split_name: str,
    overwrite: bool = False,
    log_fn=print,
) -> Tuple[str, str]:
    """`embed_dataset`: a pipeline -> ((N, D) embeddings, (N,) labels) of
    its valid rows in dataset order, such as `Stage1Trainer.embed_dataset`.
    Writes <split>_embeddings.npy (float32), _labels.npy (int64),
    _multi_labels.npy (int64 attack ids) and _attack_map.json; skips when
    the first two already exist and `overwrite` is false. In a gang
    (`embed_dataset` collective, its result on every rank) rank 0 writes
    and every rank returns once the files are there."""
    os.makedirs(out_dir, exist_ok=True)
    emb_path, lab_path = _paths(out_dir, split_name)
    if not overwrite and os.path.exists(emb_path) and os.path.exists(lab_path):
        log_fn(f"[SKIP] existing {split_name} embeddings: {emb_path}")
        return emb_path, lab_path

    embs, labels = embed_dataset(pipe)
    if not distributed.is_primary():
        distributed.barrier()
        return emb_path, lab_path
    embs = np.asarray(embs, np.float32)
    np.save(emb_path, embs)
    np.save(lab_path, np.asarray(labels).astype(np.int64))
    # the valid rows of a sequential pass are the dataset in order: the
    # attack-id classes enable per-attack UMAP coloring
    np.save(os.path.join(out_dir, f"{split_name}_multi_labels.npy"),
            pipe.dataset.multi_labels[:len(embs)].astype(np.int64))
    with open(os.path.join(out_dir, f"{split_name}_attack_map.json"), "w") as f:
        json.dump(pipe.dataset.attack_to_idx, f)
    log_fn(f"[OK] {split_name}: {embs.shape} -> {emb_path}")
    distributed.barrier()
    return emb_path, lab_path


def extract_encoder_features(
    layer_mean_fn: Callable[[torch.Tensor], torch.Tensor],
    pipe: BatchPipeline,
    out_dir: str,
    split_name: str,
    rawboost: Optional[RawBoostParams] = None,
    rawboost_prob: float = 0.9,
    seed: int = 1337,
    overwrite: bool = False,
    log_fn=print,
    device="cuda",
) -> Tuple[str, str]:
    """`layer_mean_fn`: (B, T_samples) float32 waveforms on `device` ->
    (B, T_frames, F) K-averaged encoder features, queued without a host
    sync. Writes <split>_features.npy, an (N, F, 250) float32 memmap, and
    <split>_feature_labels.npy (int64); skips when both exist and
    `overwrite` is false.

    With `rawboost`, every batch is augmented on the host from one
    np.random.default_rng(seed), drawn in the single prefetch thread in
    batch order, as the JAX function draws it. The transpose to (F, T)
    and the pad or crop to 250 frames run on the device; the copy back
    overlaps the next batch (stream_through_device)."""
    os.makedirs(out_dir, exist_ok=True)
    emb_path = os.path.join(out_dir, f"{split_name}_features.npy")
    lab_path = os.path.join(out_dir, f"{split_name}_feature_labels.npy")
    if not overwrite and os.path.exists(emb_path) and os.path.exists(lab_path):
        log_fn(f"[SKIP] existing {split_name} features: {emb_path}")
        return emb_path, lab_path

    dev = resolve_device(device)
    n = len(pipe.dataset)
    labels = np.zeros(n, np.int64)
    rng = np.random.default_rng(seed)

    def put(batch) -> torch.Tensor:
        waves = batch.waveforms
        if rawboost is not None:
            waves = apply_rawboost_batch(waves, rng, rawboost,
                                         prob=rawboost_prob)
        x = torch.from_numpy(np.ascontiguousarray(waves, np.float32))
        return x.pin_memory() if dev.type == "cuda" else x

    def apply(x: torch.Tensor) -> torch.Tensor:
        feats = layer_mean_fn(x.to(dev, non_blocking=True)).float()
        t = feats.shape[1]
        feats = feats.transpose(1, 2)                      # (B, F, T')
        if t >= FIXED_TIME_DIM:
            feats = feats[:, :, :FIXED_TIME_DIM]
        else:
            feats = F.pad(feats, (0, FIXED_TIME_DIM - t))
        return feats.contiguous()

    out, row, feat_dim = None, 0, None
    for feats, batch in stream_through_device(pipe.sequential(), put, apply):
        if out is None:
            feat_dim = feats.shape[1]
            out = np.lib.format.open_memmap(
                emb_path, mode="w+", dtype=np.float32,
                shape=(n, feat_dim, FIXED_TIME_DIM))
        k = int(batch.valid.sum())
        out[row:row + k] = feats[batch.valid]
        labels[row:row + k] = batch.labels[batch.valid]
        row += k
        out.flush()
    np.save(lab_path, labels[:row])
    log_fn(f"[OK] {split_name}: ({row}, {feat_dim}, {FIXED_TIME_DIM}) -> "
           f"{emb_path}")
    return emb_path, lab_path


def load_embeddings(out_dir: str, split_name: str, mmap: bool = False
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (embeddings, labels) of a split; `mmap` maps the embeddings."""
    emb_path, lab_path = _paths(out_dir, split_name)
    embs = np.load(emb_path, mmap_mode="r" if mmap else None)
    labels = np.load(lab_path)
    return embs, labels
