"""Raw encoder-feature extraction CLI of the port: the encoder's
layer-mean features -> an (N, F, 250) memmap per split, host RawBoost
(p = 0.9) on the train split only.

    python -m wav2vec_contr_loss_torch.cli.extract_encoder_features \\
        --train_root DIR --train_protocol FILE [--dev_root DIR \\
        --dev_protocol FILE] --encoder_init random --out_dir DIR \\
        [--device cpu]

The port of wav2vec_contr_loss_tpu/cli/extract_encoder_features.py: the
eval-mode encoder (bf16 by default, as the JAX CLI) from seeded random
weights or a port encoder init; `train_stage1 --features_dir` reads what
it writes. A split whose files exist is skipped unless --overwrite.
"""

from __future__ import annotations

import argparse

import torch

from ..bridge import jax_params_to_torch, random_jax_trees
from ..data import BatchPipeline, RawBoostParams
from ..device import resolve_device
from ..eval.extract import extract_encoder_features
from ..models.wav2vec2 import Wav2Vec2Encoder
from .common import (add_asv_paths, add_encoder_args, asv_dataset,
                     load_encoder_init)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_encoder_args(p)
    add_asv_paths(p, dev=True)
    p.add_argument("--out_dir", type=str, default="features/run")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--rawboost_prob", type=float, default=0.9)
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    enc_config, sd = load_encoder_init(args.encoder_init, args.model_name)
    enc_config = enc_config.with_(dtype=args.compute_dtype)
    if not sd:
        sd = jax_params_to_torch(enc_config, *random_jax_trees(
            enc_config, seed=args.seed))["encoder"]
    with torch.device("meta"):
        encoder = Wav2Vec2Encoder(enc_config)
    encoder.load_state_dict({k: v.to(dev, torch.float32)
                             for k, v in sd.items()},
                            strict=True, assign=True)
    encoder.eval()

    @torch.no_grad()
    def layer_mean_fn(waves: torch.Tensor) -> torch.Tensor:
        return encoder(waves, waves != 0.0)["layer_mean"]

    rb = RawBoostParams(prob=args.rawboost_prob)
    for name, boost in (("train", rb), ("dev", None)):   # aug on train only
        protocol = getattr(args, f"{name}_protocol")
        if not protocol:
            continue
        ds = asv_dataset(getattr(args, f"{name}_root"), protocol)
        pipe = BatchPipeline(ds, args.batch_size, num_workers=args.num_workers)
        extract_encoder_features(
            layer_mean_fn, pipe, args.out_dir, name, rawboost=boost,
            rawboost_prob=args.rawboost_prob, seed=args.seed,
            overwrite=args.overwrite, device=dev)


if __name__ == "__main__":
    main()
