"""Baseline scorer CLI of the port: the end-to-end BCE model scores ASV
eval and In-The-Wild straight from audio, the utt ids being the audio
file names.

    python -m wav2vec_contr_loss_torch.cli.score_baseline --ckpt_dir DIR \\
        --scores_dir DIR [--eval_root DIR --eval_protocol FILE] \\
        [--itw_root DIR --itw_protocol FILE] [--device cpu]

The port of wav2vec_contr_loss_tpu/cli/score_baseline.py: writes
score_cm_eval.txt and score_cm_itw.txt, skipping a file that exists
unless --overwrite.
"""

from __future__ import annotations

import argparse
import os

from ..data import BatchPipeline
from ..eval.score import write_cm_scores
from ..train import BaselineTrainer
from .common import add_asv_paths, asv_dataset, itw_dataset


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_asv_paths(p, dev=False, eval_=True, itw=True)
    p.add_argument("--ckpt_dir", type=str, required=True)
    p.add_argument("--ckpt_name", type=str, default="baseline_best")
    p.add_argument("--scores_dir", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    trainer = BaselineTrainer.from_checkpoint(args.ckpt_dir, args.ckpt_name,
                                              device=args.device)
    seconds = trainer.cfg.max_duration_seconds
    sr = trainer.cfg.target_sample_rate
    targets = []
    if args.eval_protocol:
        targets.append(("score_cm_eval.txt",
                        asv_dataset(args.eval_root, args.eval_protocol,
                                    seconds=seconds, sr=sr)))
    if args.itw_protocol:
        targets.append(("score_cm_itw.txt",
                        itw_dataset(args.itw_root, args.itw_protocol,
                                    seconds=seconds, sr=sr)))
    for fname, ds in targets:
        out_path = os.path.join(args.scores_dir, fname)
        if os.path.exists(out_path) and not args.overwrite:
            print(f"[SKIP] existing score file: {out_path}")
            continue
        pipe = BatchPipeline(ds, args.batch_size, num_workers=args.num_workers)
        logits, labels = trainer.score_dataset(pipe)
        write_cm_scores(out_path, labels, logits,
                        utt_ids=[u.name for u in ds.utterances])
        print(f"Done writing scores: {out_path}")


if __name__ == "__main__":
    main()
