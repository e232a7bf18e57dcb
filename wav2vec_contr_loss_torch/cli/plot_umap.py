"""Embedding visualization CLI of the port: 2-D UMAP/PCA plots of
stage-1 embeddings colored by attack type (ASV) or real-vs-spoof (ITW).

    python -m wav2vec_contr_loss_torch.cli.plot_umap --emb_dir DIR \\
        [--split eval] [--by_attack] [--out_dir plots]

The port of wav2vec_contr_loss_tpu/cli/plot_umap.py, on the host only.
It needs matplotlib and raises an ImportError naming --skip_plots
without it. `--subspace` plots the pre-compression encoder features that
extract_encoder_features wrote: the time-mean of each (F, 250) row, L2
normalized.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..eval.extract import load_embeddings
from ..viz import plot_embeddings_2d


def subspace_embeddings(emb_dir: str, split: str):
    """-> ((N, F) time-mean, L2-normalized features, (N,) labels) of
    <split>_features.npy."""
    feats = np.load(os.path.join(emb_dir, f"{split}_features.npy"),
                    mmap_mode="r")
    labels = np.load(os.path.join(emb_dir, f"{split}_feature_labels.npy"))
    embs = np.asarray(feats).mean(axis=2)
    embs /= np.maximum(np.linalg.norm(embs, axis=1, keepdims=True), 1e-12)
    return embs, labels


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--emb_dir", type=str, required=True)
    p.add_argument("--split", type=str, default="eval")
    p.add_argument("--out_dir", type=str, default="plots")
    p.add_argument("--multi_labels", type=str, default=None,
                   help=".npy of attack-id classes for per-attack coloring "
                        "(extract_embeddings writes <split>_multi_labels.npy)")
    p.add_argument("--by_attack", action="store_true",
                   help="color by attack type using the multi-labels and "
                        "attack map saved at extraction time")
    p.add_argument("--subspace", action="store_true",
                   help="plot pre-compression encoder features instead: "
                        "(N, F, 250) layer-mean features -> time-mean -> L2")
    p.add_argument("--seed", type=int, default=1337)
    args = p.parse_args(argv)

    if args.subspace:
        embs, labels = subspace_embeddings(args.emb_dir, args.split)
    else:
        embs, labels = load_embeddings(args.emb_dir, args.split)
    names = {1: "Real", 0: "Spoof"}
    if args.by_attack and not args.multi_labels:
        args.multi_labels = os.path.join(args.emb_dir,
                                         f"{args.split}_multi_labels.npy")
    if args.multi_labels:
        labels = np.load(args.multi_labels)
        names = None
        attack_map_path = os.path.join(args.emb_dir,
                                       f"{args.split}_attack_map.json")
        if os.path.exists(attack_map_path):
            with open(attack_map_path) as f:
                attack_to_idx = json.load(f)
            names = {v: ("Real" if k == "bonafide" else k)
                     for k, v in attack_to_idx.items()}
    out_png = os.path.join(args.out_dir, f"umap_{args.split}.png")
    out_html = os.path.join(args.out_dir, f"umap_{args.split}.html")
    plot_embeddings_2d(
        embs, labels, out_png,
        title=f"Stage-1 embeddings ({args.split})",
        label_names=names, out_html=out_html, seed=args.seed,
    )
    print(f"Wrote {out_png}")


if __name__ == "__main__":
    main()
