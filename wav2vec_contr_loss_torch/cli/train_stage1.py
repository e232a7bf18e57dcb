"""Stage-1 SupCon training CLI of the port.

    python -m wav2vec_contr_loss_torch.cli.train_stage1 \\
        --train_root DIR --train_protocol FILE [--dev_root DIR \\
        --dev_protocol FILE] --encoder_init random [--device cpu]

The JAX CLI's (wav2vec_contr_loss_tpu/cli/train_stage1.py) flags for the
config (with `--preset`, one of the published sweep's EXPERIMENT_PRESETS,
under the other flags), the data, `--loss_mode`, the decode-once
waveform cache, `--resume`, `--num_workers` and `--debug_nans` (autograd's
anomaly mode), plus `--device` and `--compute_dtype`. SIGTERM saves the full state mid-epoch and exits 75
(EX_TEMPFAIL); rerunning with `--resume` continues past the saved batch
cursor. The encoder starts from seeded random weights or from a port
checkpoint; nothing is downloaded.

A gang of N processes trains one run: `torchrun --nproc_per_node N -m
wav2vec_contr_loss_torch.cli.train_stage1 ... [--param_sharding fsdp]
[--mesh_model M]` (each rank on `cuda:LOCAL_RANK`, NCCL; `--device cpu`
runs Gloo). `--multihost 1` / `0` forces / suppresses joining the
process group. `--param_sharding pp --mesh_model S
[--pipeline_microbatches M]` trains the encoder as an S-stage GPipe
pipeline, and `--mesh_model M --sequence_parallel 1` adds Megatron
sequence parallelism to tensor parallelism; a layout the JAX package
refuses (pp with sequence parallelism, a batch that M does not divide)
exits 2. `--features_dir DIR` trains the compression head alone on the
(N, F, 250) features that extract_encoder_features wrote there
(train_features.npy and, when present, dev_features.npy), with no audio
and no encoder; in a gang, data-parallel over the ranks.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np

from ..bridge import (dense_state_dict, jax_params_to_torch, random_dense,
                      random_jax_trees)
from ..config import XLSR_300M, EXPERIMENT_PRESETS, Stage1Config, preset
from ..data import BatchPipeline
from ..data.cache import attach_cache
from ..parallel.mesh import check_layout
from ..train import Stage1Trainer
from ..train.checkpoint import checkpoint_exists, resume_cursor
from ..utils.preemption import PreemptionGuard
from .common import (KNOWN_ARCHS, add_asv_paths, add_cache_args,
                     add_encoder_args, add_layout_args, asv_dataset,
                     join_gang, load_encoder_init, parse_num_samples,
                     rank_log, save_dir_for)

# config fields taken as they are, and those given as 0/1
_VALUE_FIELDS = ("supcon_similarity", "temperature", "uniformity_weight",
                 "uniformity_t", "epochs", "batch_size", "head_lr", "enc_lr",
                 "weight_decay", "seed", "topk_neg", "warmup_epochs",
                 "alpha_end", "alpha_ramp_epochs", "rawboost_prob",
                 "rawboost_mode", "rawboost_fir_impl", "rawboost_isd_mode",
                 "max_duration_seconds", "hidden_dim", "input_dim",
                 "wire_dtype", "grad_dtype", "compute_dtype",
                 "param_sharding", "pipeline_microbatches")
_FLAG_FIELDS = ("use_rawboost", "finetune_encoder", "remat_encoder",
                "freeze_feature_extractor", "sequence_parallel")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_encoder_args(p)
    add_asv_paths(p)
    p.add_argument("--save_dir", type=str, default="checkpoints_stage1/run")
    p.add_argument("--preset", type=str, default=None,
                   choices=sorted(EXPERIMENT_PRESETS))
    p.add_argument("--supcon_similarity", type=str, default=None,
                   choices=["cosine", "geodesic"])
    for f in ("temperature", "uniformity_weight", "uniformity_t", "head_lr",
              "enc_lr", "weight_decay", "alpha_end", "rawboost_prob"):
        p.add_argument(f"--{f}", type=float, default=None)
    for f in ("epochs", "batch_size", "seed", "topk_neg", "warmup_epochs",
              "alpha_ramp_epochs", "max_duration_seconds", "hidden_dim",
              "input_dim"):
        p.add_argument(f"--{f}", type=int, default=None)
    p.add_argument("--num_samples", type=str, default=None)
    for f in _FLAG_FIELDS[:-1]:
        p.add_argument(f"--{f}", type=int, default=None, choices=[0, 1])
    add_layout_args(p)
    p.add_argument("--rawboost_mode", type=str, default=None,
                   choices=["device", "host", "off"])
    p.add_argument("--rawboost_fir_impl", type=str, default=None,
                   choices=["direct", "fft"])
    p.add_argument("--rawboost_isd_mode", type=str, default=None,
                   choices=["exact", "bernoulli"])
    p.add_argument("--wire_dtype", type=str, default=None,
                   choices=["float32", "int16"])
    p.add_argument("--grad_dtype", type=str, default=None,
                   choices=["auto", "float32", "bfloat16"])
    p.add_argument("--compute_dtype", type=str, default=None,
                   choices=["bfloat16", "float32"])
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--loss_mode", type=str, default="binary",
                   choices=["binary", "multiclass"])
    p.add_argument("--features_dir", type=str, default=None,
                   help="train on precomputed features instead of audio")
    add_cache_args(p)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--resume", action="store_true",
                   help="continue from the 'latest' checkpoint in save_dir "
                        "(full train state incl. optimizer and generator)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of train steps 2-5 "
                        "into this directory")
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly(True, "
                        "check_nan=True) for the run, the counterpart of "
                        "JAX's jax_debug_nans: a NaN in a step's backward "
                        "raises, naming the op whose forward it traces")
    return p


def config_from_args(args) -> Stage1Config:
    cfg = preset(args.preset) if args.preset else Stage1Config()
    overrides = {f: getattr(args, f) for f in _VALUE_FIELDS
                 if getattr(args, f) is not None}
    overrides.update({f: bool(getattr(args, f)) for f in _FLAG_FIELDS
                      if getattr(args, f) is not None})
    if args.num_samples is not None:
        overrides["num_samples"] = parse_num_samples(args.num_samples)
    overrides["model_name"] = args.model_name
    return cfg.replace(**overrides)


def _banner(cfg: Stage1Config) -> None:
    rank_log("=== CONFIG ===")
    for k, v in dataclasses.asdict(cfg).items():
        rank_log(f"{k.upper()}={v}")


def train_from_features(args, cfg: Stage1Config, save_dir: str,
                        device, mesh) -> None:
    """The head alone on <features_dir>/{train,dev}_features.npy (memmapped);
    the compression starts from seeded random weights. On `mesh`,
    data-parallel over the gang."""
    _banner(cfg)
    fdir = args.features_dir
    feats = np.load(os.path.join(fdir, "train_features.npy"), mmap_mode="r")
    labels = np.load(os.path.join(fdir, "train_feature_labels.npy"))
    dev_feats = dev_labels = None
    if os.path.exists(os.path.join(fdir, "dev_features.npy")):
        dev_feats = np.load(os.path.join(fdir, "dev_features.npy"),
                            mmap_mode="r")
        dev_labels = np.load(os.path.join(fdir, "dev_feature_labels.npy"))
    proj = dense_state_dict(random_dense(cfg.input_dim, cfg.hidden_dim,
                                         seed=cfg.seed))
    trainer = Stage1Trainer(
        cfg, KNOWN_ARCHS.get(cfg.model_name, XLSR_300M),
        {"compression": {f"proj.{k}": v for k, v in proj.items()}},
        device=device, loss_mode=args.loss_mode, from_features=True,
        mesh=mesh)
    trainer.fit_from_features(feats, labels, dev_feats, dev_labels,
                              save_dir=save_dir, log_fn=rank_log)
    rank_log(f"==> Stage-1 (from features) complete. Checkpoints in "
             f"{save_dir}")


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.debug_nans:
        train(args, parser)
        return
    import torch

    with torch.autograd.set_detect_anomaly(True, check_nan=True):
        train(args, parser)


def train(args, parser: argparse.ArgumentParser) -> None:
    cfg = config_from_args(args)
    try:   # the JAX package's refusals, before any process joins a gang
        check_layout(pipeline=cfg.param_sharding == "pp",
                     sequence_parallel=cfg.sequence_parallel,
                     microbatches=cfg.pipeline_microbatches,
                     batch=cfg.batch_size)
    except ValueError as e:
        parser.error(str(e))
    device, mesh = join_gang(args, parser)
    save_dir = save_dir_for(args.save_dir, cfg.model_name)
    if args.features_dir is not None:
        train_from_features(args, cfg, save_dir, device, mesh)
        return
    enc_config, encoder = load_encoder_init(args.encoder_init,
                                            cfg.model_name)
    if args.input_dim is None and cfg.input_dim != enc_config.hidden_size:
        # the compression input follows the encoder width
        cfg = cfg.replace(input_dim=enc_config.hidden_size)
    _banner(cfg)

    weights = jax_params_to_torch(enc_config, *random_jax_trees(
        enc_config, comp_dim=cfg.hidden_dim, seed=cfg.seed))
    if encoder:
        weights["encoder"] = encoder
    trainer = Stage1Trainer(cfg, enc_config, weights, device=device,
                            loss_mode=args.loss_mode, mesh=mesh)
    start_epoch, skip_steps, best_dev = 1, 0, float("inf")
    if args.resume:
        if checkpoint_exists(save_dir, "latest"):
            m = trainer.restore(save_dir, "latest")["metrics"]
            best_dev = float(m.get("best_dev", float("inf")))
            start_epoch, skip_steps = resume_cursor(m)
            rank_log(f"[RESUME] continuing from epoch {start_epoch}"
                     + (f" batch {skip_steps}" if skip_steps else ""))
        else:
            rank_log("[RESUME] no 'latest' checkpoint found; starting "
                     "fresh")

    rawboost = (cfg.rawboost_params()
                if cfg.use_rawboost and cfg.rawboost_mode == "host" else None)
    train_ds = asv_dataset(args.train_root, args.train_protocol,
                           cfg.num_samples, seconds=cfg.max_duration_seconds,
                           sr=cfg.target_sample_rate)
    if args.cache_waveforms:
        attach_cache(train_ds, os.path.join(args.cache_waveforms, "train"),
                     dtype=args.cache_dtype, num_workers=args.num_workers)
    train_pipe = BatchPipeline(
        train_ds, cfg.batch_size, seed=cfg.seed, num_workers=args.num_workers,
        rawboost=rawboost, rawboost_prob=cfg.rawboost_prob)
    dev_pipe = None
    if args.dev_protocol:
        dev_ds = asv_dataset(args.dev_root, args.dev_protocol,
                             cfg.num_samples, seconds=cfg.max_duration_seconds,
                             sr=cfg.target_sample_rate)
        if args.cache_waveforms:
            attach_cache(dev_ds, os.path.join(args.cache_waveforms, "dev"),
                         dtype=args.cache_dtype,
                         num_workers=args.num_workers)
        # the dev sampler is seeded seed + 1, as the reference's
        dev_pipe = BatchPipeline(dev_ds, cfg.batch_size, seed=cfg.seed + 1,
                                 num_workers=args.num_workers)

    # SIGTERM (a scheduler's preemption) saves mid-epoch instead of losing
    # the run since the last epoch boundary
    with PreemptionGuard() as guard:
        history = trainer.fit(train_pipe, dev_pipe, save_dir=save_dir,
                              start_epoch=start_epoch, skip_steps=skip_steps,
                              best_dev=best_dev, preemption=guard,
                              profile_dir=args.profile_dir, log_fn=rank_log)
    if history.get("preempted"):
        rank_log(f"==> Stage-1 training PREEMPTED; state saved in "
                 f"{save_dir} (rerun with --resume)")
        # EX_TEMPFAIL: callers must not go on as if training had finished
        raise SystemExit(75)
    rank_log(f"==> Stage-1 training complete. Checkpoints in {save_dir}")


if __name__ == "__main__":
    main()
