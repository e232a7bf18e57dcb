"""Score-file generation CLI of the port: a stage-2 head over saved
embeddings -> ASVspoof CM score files with synthetic utt ids,
skip-if-exists.

    python -m wav2vec_contr_loss_torch.cli.generate_scores --emb_dir DIR \\
        --stage2_dir DIR --scores_dir DIR [--splits eval itw] [--device cpu]

The port of wav2vec_contr_loss_tpu/cli/generate_scores.py; its
`load_stage2_head` reads the port's stage-2 checkpoint.
"""

from __future__ import annotations

import argparse
import os

from ..eval.extract import load_embeddings
from ..eval.score import write_cm_scores
from ..train.stage2 import STAGE2_BEST, load_stage2_head, stage2_scores

__all__ = ["load_stage2_head", "main"]

# score-file names and utt prefixes per split (the reference's)
NAME_MAP = {"eval": ("score_cm_eval.txt", "asv_eval"),
            "itw": ("score_cm_itw.txt", "itw")}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--emb_dir", type=str, required=True)
    p.add_argument("--stage2_dir", type=str, required=True)
    p.add_argument("--stage2_name", type=str, default=STAGE2_BEST)
    p.add_argument("--scores_dir", type=str, required=True)
    p.add_argument("--splits", type=str, nargs="+", default=["eval", "itw"],
                   help="embedding splits to score")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    cfg, state = load_stage2_head(args.stage2_dir, args.stage2_name)
    for split in args.splits:
        fname, prefix = NAME_MAP.get(split, (f"score_cm_{split}.txt", split))
        out_path = os.path.join(args.scores_dir, fname)
        if os.path.exists(out_path) and not args.overwrite:
            print(f"[SKIP] existing score file: {out_path}")
            continue
        embs, labels = load_embeddings(args.emb_dir, split)
        logits = stage2_scores(cfg, state, embs, device=args.device)
        write_cm_scores(out_path, labels, logits, utt_prefix=prefix)
        print(f"Done writing scores: {out_path}")


if __name__ == "__main__":
    main()
