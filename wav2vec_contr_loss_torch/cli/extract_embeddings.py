"""Stage-1 embedding extraction CLI of the port: a stage-1 checkpoint's
frozen backbone -> (N, D) .npy per split for ASV train/dev/eval and
In-The-Wild.

    python -m wav2vec_contr_loss_torch.cli.extract_embeddings \\
        --ckpt_dir DIR [--ckpt_name best] --out_dir DIR \\
        [--train_root DIR --train_protocol FILE] [--dev_...] [--eval_...] \\
        [--itw_...] [--device cpu]

The port of wav2vec_contr_loss_tpu/cli/extract_embeddings.py over the
port's `<ckpt_dir>/<ckpt_name>.pt` checkpoints (`Stage1Trainer.fit`
writes them); the clip length and the wire dtype come from the
checkpoint's config. Under torchrun (or `--multihost 1`) the ranks
extract together, data-parallel whatever layout trained the checkpoint:
each decodes and embeds its rows of every batch (`--batch_size` must
divide by the ranks), and rank 0 writes the files in corpus order.
"""

from __future__ import annotations

import argparse

from ..data import BatchPipeline
from ..eval.extract import extract_embeddings
from ..train import Stage1Trainer
from ..utils.distributed import add_multihost_arg
from .common import (add_asv_paths, asv_dataset, itw_dataset, join_gang,
                     parse_num_samples)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_asv_paths(p, dev=True, eval_=True, itw=True)
    p.add_argument("--ckpt_dir", type=str, required=True)
    p.add_argument("--ckpt_name", type=str, default="best")
    p.add_argument("--out_dir", type=str, default="embeddings/run")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--num_samples", type=str, default=None,
                   help="seeded per-split subsample ('None' = all); "
                        "run_pipeline forwards its smoke-run subsetting "
                        "here so extraction matches the training subset")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    add_multihost_arg(p)
    return p


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    num_samples = parse_num_samples(args.num_samples)
    device, mesh = join_gang(args, parser)
    trainer = Stage1Trainer.from_checkpoint(
        args.ckpt_dir, args.ckpt_name, device=device, mesh=mesh,
        param_sharding=None if mesh is None else "replicated")
    seconds = trainer.cfg.max_duration_seconds
    sr = trainer.cfg.target_sample_rate

    splits = []
    for name, build in (("train", asv_dataset), ("dev", asv_dataset),
                        ("eval", asv_dataset), ("itw", itw_dataset)):
        protocol = getattr(args, f"{name}_protocol")
        if protocol:
            splits.append((name, build(getattr(args, f"{name}_root"),
                                       protocol, num_samples,
                                       seconds=seconds, sr=sr)))
    for name, ds in splits:
        pipe = BatchPipeline(ds, args.batch_size, num_workers=args.num_workers)
        extract_embeddings(trainer.embed_dataset, pipe, args.out_dir, name,
                           overwrite=args.overwrite)


if __name__ == "__main__":
    main()
