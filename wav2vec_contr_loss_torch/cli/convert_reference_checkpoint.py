"""The reference's trained `.pt` files -> the port's checkpoints.

    # finetuned stage 1 (the .pt embeds the encoder):
    python -m wav2vec_contr_loss_torch convert_reference_checkpoint \\
        --src runs/..._stage1_head_best.pt --out ckpt/stage1
    # frozen stage 1 (no encoder in the .pt; supply the pretrained one):
    python -m wav2vec_contr_loss_torch convert_reference_checkpoint \\
        --src ..._stage1_head_best.pt --out ckpt/stage1 \\
        --encoder_init ckpt/xlsr300m     # from convert_hf_checkpoint
    # stage-2 head:
    python -m wav2vec_contr_loss_torch convert_reference_checkpoint \\
        --src stage2_binary_head_best.pt --out ckpt/stage2
    # the end-to-end baseline (the .pt embeds the encoder):
    python -m wav2vec_contr_loss_torch convert_reference_checkpoint \\
        --src baseline_best.pt --out ckpt/baseline

The outputs are what `serve --stage1_dir/--stage2_dir`,
`extract_embeddings --ckpt_dir`, `run_pipeline --stage1_ckpt` and
`score_baseline --ckpt_dir` read. The conversion runs on the CPU.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--src", type=str, required=True,
                   help="reference .pt checkpoint (stage-1 / stage-2 head "
                        "/ baseline; format auto-detected)")
    p.add_argument("--out", type=str, required=True,
                   help="output checkpoint directory")
    p.add_argument("--kind", type=str, default="auto",
                   choices=["auto", "stage1", "stage2", "baseline"])
    p.add_argument("--encoder_init", type=str, default=None,
                   help="directory from convert_hf_checkpoint: the "
                        "encoder's architecture and pretrained weights "
                        "(required for frozen stage-1 .pt files)")
    p.add_argument("--hf_config", type=str, default=None,
                   help="HF config.json giving the encoder architecture "
                        "only (for .pt files that embed encoder weights)")
    p.add_argument("--name", type=str, default=None,
                   help="checkpoint name inside --out (defaults: best / "
                        "stage2_binary_head_best / baseline_best)")
    args = p.parse_args(argv)

    from ..models.ref_convert import convert_reference_checkpoint

    kind, path = convert_reference_checkpoint(
        args.src, args.out, kind=args.kind, encoder_init=args.encoder_init,
        hf_config=args.hf_config, name=args.name)
    print(f"Converted {args.src} ({kind}) -> {path}.pt")
    follow = {"stage1": f"extract_embeddings --ckpt_dir {args.out} ...",
              "stage2": f"serve --stage2_dir {args.out} ...",
              "baseline": f"score_baseline --ckpt_dir {args.out} ..."}[kind]
    print(f"  use with: python -m wav2vec_contr_loss_torch {follow}")


if __name__ == "__main__":
    main()
