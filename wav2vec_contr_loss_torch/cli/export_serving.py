"""Export the whole scoring graph as one self-contained serving artifact.

    python -m wav2vec_contr_loss_torch.cli.export_serving \\
        --stage1_dir ckpt/stage1 --stage2_dir ckpt/stage2 \\
        --out scorer.w2vexport [--batch 8] [--quantize w8a8] \\
        [--wire int16] [--device cuda]

    # the consumer needs torch and this package's ops, no checkpoint:
    from wav2vec_contr_loss_torch.eval.artifact import load_exported
    logits = load_exported("scorer.w2vexport")(waves)   # (B, T) -> (B,)

The port of wav2vec_contr_loss_tpu/cli/export_serving.py: `torch.export`
of `SpoofScorer` (eval/serving.py `export`) with the weights baked in
(fp32, or int8 with --quantize) and the two Hopper kernels as custom
ops. A torch program is traced for one device type and runs only there,
so --device takes the place of the JAX --platforms: an artifact for the
card runs on the card, one for 'cpu' on the CPU. Prints the size on
stderr.
"""

from __future__ import annotations

import argparse
import sys

__all__ = ["main"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--stage1_dir", type=str, required=True)
    p.add_argument("--stage1_name", type=str, default="best")
    p.add_argument("--stage2_dir", type=str, required=True)
    p.add_argument("--stage2_name", type=str,
                   default="stage2_binary_head_best")
    p.add_argument("--out", type=str, required=True,
                   help="output artifact path")
    p.add_argument("--batch", type=int, default=8,
                   help="static serving batch baked into the artifact")
    p.add_argument("--quantize", type=str, default="none",
                   choices=["none", "w8a8", "w8"],
                   help="int8 transformer linears (ops/quant.py); also "
                        "shrinks the baked weights")
    p.add_argument("--wire", type=str, default="float32",
                   choices=["float32", "int16"],
                   help="input signature: int16 PCM halves the input bytes")
    p.add_argument("--device", type=str, default="cuda",
                   help="the device type the program is traced for and "
                        "will run on: 'cuda' (default) or 'cpu'; a torch "
                        "program is traced for one device type")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from ..eval.serving import SpoofScorer

    scorer = SpoofScorer.from_checkpoints(
        args.stage1_dir, args.stage2_dir, stage1_name=args.stage1_name,
        stage2_name=args.stage2_name, device=args.device,
        quantize=args.quantize)
    blob = scorer.export(args.batch, wire=args.wire)
    with open(args.out, "wb") as f:
        f.write(blob)
    print(f"[export_serving] wrote {args.out}: {len(blob) / 1e6:.1f} MB "
          f"(batch={args.batch}, quantize={args.quantize}, "
          f"wire={args.wire}, device={scorer.device.type})", file=sys.stderr)


if __name__ == "__main__":
    main()
