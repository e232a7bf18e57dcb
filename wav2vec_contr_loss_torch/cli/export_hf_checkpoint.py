"""The port's encoder -> a HuggingFace Wav2Vec2 snapshot directory.

    python -m wav2vec_contr_loss_torch export_hf_checkpoint \\
        --src checkpoints_stage1/run --name best --out hf_export

`--src` is a port stage-1 checkpoint directory (with `--name`) or a
directory written by convert_hf_checkpoint. The output (config.json +
model.safetensors) loads with `transformers.Wav2Vec2Model.from_pretrained`.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--src", type=str, required=True,
                   help="port stage-1 or encoder-init checkpoint directory")
    p.add_argument("--name", type=str, default="best",
                   help="checkpoint name inside --src (ignored for an "
                        "encoder-init directory)")
    p.add_argument("--out", type=str, required=True,
                   help="output HF snapshot directory")
    args = p.parse_args(argv)

    from ..models.export_hf import save_hf_checkpoint
    from ..models.hf_convert import load_encoder_init
    from ..train import checkpoint as ckpt

    src = (args.src if ckpt.checkpoint_exists(args.src, "encoder")
           else os.path.join(args.src, args.name))
    cfg, sd = load_encoder_init(src)
    out = save_hf_checkpoint(args.out, cfg, sd)
    print(f"==> HF checkpoint written to {out} "
          f"(load with transformers.Wav2Vec2Model.from_pretrained)")


if __name__ == "__main__":
    main()
