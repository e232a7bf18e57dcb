"""A local HuggingFace Wav2Vec2 snapshot -> the port's encoder weights.

    python -m wav2vec_contr_loss_torch convert_hf_checkpoint \\
        --src /drops/wav2vec2-xls-r-300m --out ckpt/xlsr_init
    python -m wav2vec_contr_loss_torch train_stage1 ... \\
        --encoder_init ckpt/xlsr_init

`--src` is a snapshot directory (config.json + model.safetensors or
pytorch_model.bin, sharded `*.index.json` too) or one weights file with
config.json beside it. Nothing is downloaded; the conversion runs on the
CPU and needs neither transformers nor safetensors.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--src", type=str, required=True,
                   help="HF snapshot dir (config.json + model.safetensors /"
                        " pytorch_model.bin, sharded index supported) or a"
                        " single weights file with config.json beside it")
    p.add_argument("--out", type=str, required=True,
                   help="output directory: encoder.pt beside "
                        "encoder.config.json")
    args = p.parse_args(argv)

    from ..models.hf_convert import load_local_hf_checkpoint, save_encoder_init

    cfg, sd = load_local_hf_checkpoint(args.src)
    path = save_encoder_init(args.out, cfg, sd, source=args.src)
    n_params = sum(t.numel() for t in sd.values())
    print(f"Converted {args.src} -> {path}.pt")
    print(f"  encoder: hidden={cfg.hidden_size} layers={cfg.num_layers} "
          f"heads={cfg.num_heads} params={n_params / 1e6:.1f}M")
    print(f"  use with: --encoder_init {args.out}")


if __name__ == "__main__":
    main()
