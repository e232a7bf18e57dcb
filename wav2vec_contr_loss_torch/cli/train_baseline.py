"""End-to-end BCE baseline training CLI of the port.

    python -m wav2vec_contr_loss_torch.cli.train_baseline \\
        --train_root DIR --train_protocol FILE --dev_root DIR \\
        --dev_protocol FILE --encoder_init random [--device cpu] \\
        [--cache_waveforms DIR] [--resume]

The port of wav2vec_contr_loss_tpu/cli/train_baseline.py: balanced train
batches, a natural-distribution dev set scored by EER every epoch, early
stop after --patience epochs without a better EER, checkpoints
`baseline_best` and `baseline_latest` under <save_dir>/<run_tag>.
SIGTERM saves the full state mid-epoch and exits 75 (EX_TEMPFAIL);
rerunning with --resume continues from `baseline_latest` past its batch
cursor, with its best EER and patience count. The encoder starts from
seeded random weights or from a port checkpoint; nothing is downloaded.
A gang trains one run as train_stage1's does (`torchrun --nproc_per_node
N -m wav2vec_contr_loss_torch.cli.train_baseline ... [--param_sharding
fsdp]`, `--multihost`); `--param_sharding pp` exits 2, since the JAX
`BaselineTrainer` has no pipeline layout.
"""

from __future__ import annotations

import argparse
import os

from ..bridge import (dense_state_dict, jax_params_to_torch,
                      random_dense, random_jax_trees)
from ..config import BaselineConfig
from ..data import BatchPipeline
from ..data.cache import attach_cache
from ..losses import pos_weight_from_labels
from ..train import BaselineTrainer
from ..train.baseline import BASELINE_NO_PP
from ..train.checkpoint import checkpoint_exists, resume_cursor
from ..utils.preemption import PreemptionGuard
from .common import (add_asv_paths, add_cache_args, add_encoder_args,
                     add_layout_args, asv_dataset, join_gang,
                     load_encoder_init, rank_log, save_dir_for)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_encoder_args(p)
    add_asv_paths(p)
    p.add_argument("--save_dir", type=str, default="checkpoints_baseline/run")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--num_samples", type=int, default=None)
    p.add_argument("--head_lr", type=float, default=5e-3)
    p.add_argument("--enc_lr", type=float, default=1e-5)
    p.add_argument("--weight_decay", type=float, default=3e-3)
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--use_rawboost", type=int, default=1, choices=[0, 1])
    p.add_argument("--rawboost_prob", type=float, default=0.7)
    p.add_argument("--rawboost_mode", type=str, default="device",
                   choices=["device", "host", "off"])
    p.add_argument("--finetune_encoder", type=int, default=1, choices=[0, 1])
    p.add_argument("--remat_encoder", type=int, default=1, choices=[0, 1])
    p.add_argument("--use_pos_weight", type=int, default=1, choices=[0, 1])
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--hidden_dim", type=int, default=256)
    p.add_argument("--max_duration_seconds", type=int, default=5)
    p.add_argument("--wire_dtype", type=str, default="float32",
                   choices=["float32", "int16"])
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--resume", action="store_true",
                   help="continue from <save_dir>/baseline_latest (also a "
                        "mid-epoch preemption save)")
    add_cache_args(p)
    add_layout_args(p, model=False)
    return p


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.param_sharding == "pp":
        parser.error(BASELINE_NO_PP)
    device, mesh = join_gang(args, parser)
    enc_config, encoder = load_encoder_init(args.encoder_init,
                                            args.model_name)
    cfg = BaselineConfig(
        # the compression input follows the encoder width
        input_dim=enc_config.hidden_size, hidden_dim=args.hidden_dim,
        max_duration_seconds=args.max_duration_seconds,
        model_name=args.model_name, epochs=args.epochs,
        batch_size=args.batch_size, num_samples=args.num_samples,
        head_lr=args.head_lr, enc_lr=args.enc_lr,
        weight_decay=args.weight_decay, seed=args.seed,
        patience=args.patience, use_rawboost=bool(args.use_rawboost),
        rawboost_prob=args.rawboost_prob, rawboost_mode=args.rawboost_mode,
        finetune_encoder=bool(args.finetune_encoder),
        remat_encoder=bool(args.remat_encoder),
        use_pos_weight=bool(args.use_pos_weight),
        wire_dtype=args.wire_dtype, compute_dtype=args.compute_dtype,
        param_sharding=args.param_sharding or "replicated")
    save_dir = save_dir_for(args.save_dir, cfg.model_name)

    datasets = {"train": asv_dataset(args.train_root, args.train_protocol,
                                     cfg.num_samples,
                                     seconds=cfg.max_duration_seconds,
                                     sr=cfg.target_sample_rate),
                "dev": asv_dataset(args.dev_root, args.dev_protocol,
                                   cfg.num_samples,
                                   seconds=cfg.max_duration_seconds,
                                   sr=cfg.target_sample_rate)}
    if args.cache_waveforms:
        for split, ds in datasets.items():
            attach_cache(ds, os.path.join(args.cache_waveforms, split),
                         dtype=args.cache_dtype,
                         num_workers=args.num_workers)
    pos_weight = pos_weight_from_labels(datasets["train"].labels)
    rank_log(f"pos_weight (neg/pos) = {pos_weight:.4f}")

    weights = jax_params_to_torch(enc_config, *random_jax_trees(
        enc_config, comp_dim=cfg.hidden_dim, seed=cfg.seed))
    weights["classifier"] = dense_state_dict(
        random_dense(cfg.hidden_dim, 1, seed=cfg.seed))
    if encoder:
        weights["encoder"] = encoder
    trainer = BaselineTrainer(cfg, enc_config, weights, device=device,
                              pos_weight=pos_weight, mesh=mesh)
    start_epoch, skip_steps = 1, 0
    best_eer, epochs_no_improve = float("inf"), 0
    if args.resume:
        if checkpoint_exists(save_dir, "baseline_latest"):
            m = trainer.restore(save_dir, "baseline_latest")["metrics"]
            best_eer = float(m.get("best_eer", float("inf")))
            epochs_no_improve = int(m.get("epochs_no_improve", 0))
            start_epoch, skip_steps = resume_cursor(m)
            rank_log(f"[RESUME] continuing from epoch {start_epoch}"
                     + (f" batch {skip_steps}" if skip_steps else ""))
        else:
            rank_log("[RESUME] no 'baseline_latest' checkpoint found; "
                     "starting fresh")

    rawboost = (cfg.rawboost_params()
                if cfg.use_rawboost and cfg.rawboost_mode == "host" else None)
    # balanced train batches, the natural distribution on dev
    train_pipe = BatchPipeline(
        datasets["train"], cfg.batch_size, seed=cfg.seed,
        num_workers=args.num_workers, rawboost=rawboost,
        rawboost_prob=cfg.rawboost_prob)
    dev_pipe = BatchPipeline(datasets["dev"], cfg.batch_size,
                             num_workers=args.num_workers)
    with PreemptionGuard() as guard:
        history = trainer.fit(train_pipe, dev_pipe, save_dir=save_dir,
                              preemption=guard, start_epoch=start_epoch,
                              skip_steps=skip_steps, best_eer=best_eer,
                              epochs_no_improve=epochs_no_improve,
                              log_fn=rank_log)
    if history.get("preempted"):
        rank_log(f"==> Baseline training PREEMPTED; state saved in "
                 f"{save_dir} (rerun with --resume)")
        # EX_TEMPFAIL: callers must not go on as if training had finished
        raise SystemExit(75)
    rank_log(f"==> Baseline training complete. Checkpoints in {save_dir}")


if __name__ == "__main__":
    main()
