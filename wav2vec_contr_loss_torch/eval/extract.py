"""Embedding extraction to .npy, the filesystem contract between the
pipeline's stages.

The port of `extract_embeddings` and `load_embeddings` of
wav2vec_contr_loss_tpu/eval/extract.py: a stage-1 backbone's (N, D)
L2-normalized clip embeddings and (N,) labels per split, skipped when
both files exist. `extract_encoder_features` (the (N, F, 250) layer-mean
memmap) is not ported yet.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Tuple

import numpy as np

from ..data.pipeline import BatchPipeline

__all__ = ["extract_embeddings", "load_embeddings"]


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
    the first two already exist and `overwrite` is false."""
    os.makedirs(out_dir, exist_ok=True)
    emb_path, lab_path = _paths(out_dir, split_name)
    if not overwrite and os.path.exists(emb_path) and os.path.exists(lab_path):
        log_fn(f"[SKIP] existing {split_name} embeddings: {emb_path}")
        return emb_path, lab_path

    embs, labels = embed_dataset(pipe)
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
    return emb_path, lab_path


def load_embeddings(out_dir: str, split_name: str, mmap: bool = False
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (embeddings, labels) of a split; `mmap` maps the embeddings."""
    emb_path, lab_path = _paths(out_dir, split_name)
    embs = np.load(emb_path, mmap_mode="r" if mmap else None)
    labels = np.load(lab_path)
    return embs, labels
