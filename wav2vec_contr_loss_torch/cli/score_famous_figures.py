"""FamousFigures scorer CLI of the port: a stage-1 backbone, then a
stage-2 head, over a celebrity-deepfake protocol, with an optional EER.

    python -m wav2vec_contr_loss_torch.cli.score_famous_figures \\
        --protocol FILE --root_dir DIR --stage1_dir DIR --stage2_dir DIR \\
        --scores_dir DIR [--include_speakers A B] [--print_eer] \\
        [--device cpu]

The port of wav2vec_contr_loss_tpu/cli/score_famous_figures.py: writes
score_cm_famous_figures.txt with the protocol's audio names as utt ids.
"""

from __future__ import annotations

import argparse
import os

from ..data import AudioConfig, BatchPipeline, parse_famous_figures
from ..eval.metrics import compute_eer
from ..eval.score import write_cm_scores
from ..train import Stage1Trainer, stage2_scores
from ..train.stage2 import STAGE2_BEST, load_stage2_head


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--protocol", type=str, required=True)
    p.add_argument("--root_dir", type=str, default="")
    p.add_argument("--stage1_dir", type=str, required=True)
    p.add_argument("--stage1_name", type=str, default="best")
    p.add_argument("--stage2_dir", type=str, required=True)
    p.add_argument("--stage2_name", type=str, default=STAGE2_BEST)
    p.add_argument("--scores_dir", type=str, required=True)
    p.add_argument("--subset", type=str, default="all",
                   choices=["all", "bonafide", "spoof"])
    p.add_argument("--include_speakers", type=str, nargs="*", default=None)
    p.add_argument("--include_sources", type=str, nargs="*", default=None)
    p.add_argument("--num_samples", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--print_eer", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    trainer = Stage1Trainer.from_checkpoint(args.stage1_dir, args.stage1_name,
                                            device=args.device)
    cfg2, head = load_stage2_head(args.stage2_dir, args.stage2_name)
    ds = parse_famous_figures(
        args.protocol, args.root_dir, subset=args.subset,
        include_speakers=args.include_speakers,
        include_sources=args.include_sources,
        num_samples=args.num_samples,
        audio=AudioConfig(trainer.cfg.target_sample_rate,
                          trainer.cfg.max_duration_seconds))
    pipe = BatchPipeline(ds, args.batch_size, num_workers=args.num_workers)
    embs, labels = trainer.embed_dataset(pipe)
    logits = stage2_scores(cfg2, head, embs, device=args.device)

    out_path = os.path.join(args.scores_dir, "score_cm_famous_figures.txt")
    write_cm_scores(out_path, labels, logits,
                    utt_ids=[u.name for u in ds.utterances])
    print(f"Done writing scores: {out_path}")
    if args.print_eer:
        eer, _ = compute_eer(logits[labels == 1], logits[labels == 0])
        print(f"EER: {eer * 100:.2f}%")


if __name__ == "__main__":
    main()
