"""The port's checkpoints -> the reference's `.pt` formats.

    python -m wav2vec_contr_loss_torch export_reference_checkpoint \\
        --src checkpoints_stage1/run --out stage1_head_best.pt

The inverse of convert_reference_checkpoint, for stage 1, the stage-2
head and the baseline: the reference reloads the stage-1 .pt in
extract_stage1_embeddings.py, the head in generate_eval_score_file.py and
the baseline in eval_baseline_score_file.py.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--src", type=str, required=True,
                   help="port checkpoint directory (stage-1 / stage-2 / "
                        "baseline; auto-detected)")
    p.add_argument("--out", type=str, required=True,
                   help="output .pt path (reference format)")
    p.add_argument("--kind", type=str, default="auto",
                   choices=["auto", "stage1", "stage2", "baseline"])
    p.add_argument("--name", type=str, default=None,
                   help="checkpoint name inside --src (defaults: best / "
                        "stage2_binary_head_best / baseline_best; requires "
                        "--kind)")
    args = p.parse_args(argv)

    from ..models.ref_convert import export_reference_checkpoint

    kind, path = export_reference_checkpoint(args.src, args.out,
                                             kind=args.kind, name=args.name)
    print(f"Exported {args.src} ({kind}) -> {path}")
    loader = {"stage1": "extract_stage1_embeddings.py",
              "stage2": "generate_eval_score_file.py",
              "baseline": "eval_baseline_score_file.py"}[kind]
    print(f"  loads in the reference via: {loader}")


if __name__ == "__main__":
    main()
