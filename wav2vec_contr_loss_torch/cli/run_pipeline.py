"""The full experiment pipeline of the port: the reference's
train_stage1.sbatch as one in-process command. State flows through the
filesystem: checkpoints -> .npy embeddings -> score .txt -> EER.

    python -m wav2vec_contr_loss_torch.cli.run_pipeline \\
        --exp_name supcon_temp_0.07 --work_dir DIR \\
        --train_root DIR --train_protocol FILE --dev_root DIR \\
        --dev_protocol FILE --eval_root DIR --eval_protocol FILE \\
        [--stage1_ckpt DIR] [--cache_waveforms DIR] [--skip_plots] \\
        [--device cpu]

  1. stage-1 SupCon training (the preset, then flags), or an existing
     stage-1 checkpoint directory with --stage1_ckpt
  2. embedding extraction for ASV train/dev/eval + ITW
  3. UMAP/PCA plots of the eval/ITW embeddings, unless --skip_plots
     (they need matplotlib)
  4. stage-2 classifier training
  5. score-file generation
  6. EER report

The port of wav2vec_contr_loss_tpu/cli/run_pipeline.py over the port's
CLIs. --device goes to every leg that touches the card. The stage-1
checkpoint is the port's <work_dir>/<exp>/checkpoints_stage1/<run_tag>/
best.pt pair. --cache_waveforms and --cache_dtype go to the training
leg. Under torchrun (or --multihost 1) every rank joins the stage-1
training gang and the extraction, each rank embedding its rows of every
batch; stage 2, the scores and the EER run on rank 0, the other ranks
stop after the extraction.
"""

from __future__ import annotations

import argparse
import os

import torch.distributed

from ..config import EXPERIMENT_PRESETS
from ..utils import distributed
from . import (eval_scores, extract_embeddings, generate_scores, plot_umap,
               train_stage1, train_stage2)
from .common import save_dir_for

# flags that configure only the stage-1 training leg: those forwarded as
# they are, then --encoder_init
_STAGE1_FLAGS = ("epochs", "batch_size", "max_duration_seconds", "input_dim",
                 "hidden_dim", "cache_waveforms")
_TRAINING_FLAGS = _STAGE1_FLAGS + ("encoder_init",)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--exp_name", type=str, required=True,
                   choices=sorted(EXPERIMENT_PRESETS))
    p.add_argument("--model_name", type=str,
                   default="facebook/wav2vec2-xls-r-300m")
    p.add_argument("--encoder_init", type=str, default=None,
                   help="the stage-1 leg's --encoder_init ('pretrained', "
                        "the default: --model_name from the local HF cache, "
                        "refused when it is not there, since the port "
                        "downloads nothing; 'random'; an HF snapshot "
                        "directory or a port .pt)")
    p.add_argument("--work_dir", type=str, default="experiments")
    for split in ("train", "dev", "eval", "itw"):
        p.add_argument(f"--{split}_root", type=str, default="")
        p.add_argument(f"--{split}_protocol", type=str, default="")
    p.add_argument("--num_samples", type=str, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--max_duration_seconds", type=int, default=None)
    p.add_argument("--input_dim", type=int, default=None)
    p.add_argument("--hidden_dim", type=int, default=None)
    p.add_argument("--cache_waveforms", type=str, default=None,
                   help="decode-once waveform cache directory of the "
                        "stage-1 training leg (data/cache.py)")
    p.add_argument("--cache_dtype", type=str, default="int16",
                   choices=["int16", "float32"])
    # stage-2 overrides (the reference's sbatch varies the classifier
    # flags independently of stage-1)
    p.add_argument("--stage2_lr", type=float, default=None)
    p.add_argument("--stage2_epochs", type=int, default=None)
    p.add_argument("--stage2_patience", type=int, default=None)
    p.add_argument("--stage2_head_type", type=str, default=None,
                   choices=["linear", "mlp"])
    p.add_argument("--stage1_ckpt", type=str, default=None,
                   help="use an EXISTING port stage-1 checkpoint directory "
                        "(holding best.pt and best.config.json) and skip "
                        "the training leg; extraction, stage-2, scoring "
                        "and the EER still run")
    p.add_argument("--skip_plots", action="store_true",
                   help="skip the embedding plots (needed where matplotlib "
                        "is not installed)")
    p.add_argument("--resume", action="store_true",
                   help="resume stage-1 from its latest checkpoint (incl. "
                        "mid-epoch preemption saves); later stages are "
                        "already idempotent (skip-if-exists)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu', for every leg that "
                        "touches the card")
    distributed.add_multihost_arg(p)
    return p


def main(argv=None) -> None:
    p = build_parser()
    args = p.parse_args(argv)

    if args.stage1_ckpt:
        # fail loudly instead of silently dropping training-leg flags
        ignored = [f"--{f}" for f in _TRAINING_FLAGS
                   if getattr(args, f) is not None]
        if args.resume:
            ignored.append("--resume")
        if ignored:
            p.error(f"{' '.join(ignored)} configure the stage-1 TRAINING "
                    "leg, which --stage1_ckpt skips — drop them (the "
                    "checkpoint carries its own config)")

    exp_dir = os.path.join(args.work_dir, args.exp_name)
    ckpt_base = os.path.join(exp_dir, "checkpoints_stage1")
    ckpt_dir = save_dir_for(ckpt_base, args.model_name)
    emb_dir = os.path.join(exp_dir, "embeddings")
    stage2_dir = os.path.join(exp_dir, "checkpoints_stage2")
    scores_dir = save_dir_for(os.path.join(exp_dir, "scores", args.exp_name),
                              args.model_name)
    device = ["--device", args.device]

    def paths(*splits):
        out = []
        for s in splits:
            out += [f"--{s}_root", getattr(args, f"{s}_root"),
                    f"--{s}_protocol", getattr(args, f"{s}_protocol")]
        return out

    # 1) stage-1, skipped when an existing checkpoint is supplied
    if args.stage1_ckpt:
        ckpt_dir = args.stage1_ckpt
    else:
        s1 = ["--preset", args.exp_name, "--model_name", args.model_name,
              "--encoder_init", args.encoder_init or "pretrained",
              "--save_dir", ckpt_base] + paths("train", "dev") + device
        if args.num_samples is not None:
            s1 += ["--num_samples", args.num_samples]
        for flag in _STAGE1_FLAGS:
            v = getattr(args, flag)
            if v is not None:
                s1 += [f"--{flag}", str(v)]
        if args.cache_waveforms is not None:
            s1 += ["--cache_dtype", args.cache_dtype]
        if args.resume:
            s1 += ["--resume"]
        if args.multihost is not None:
            s1 += ["--multihost", str(args.multihost)]
        train_stage1.main(s1)

    # 2) extraction (train/dev/eval/itw as provided), on every rank of a
    # gang; --num_samples subsets every leg, not just training
    ex = ["--ckpt_dir", ckpt_dir, "--out_dir", emb_dir] + device
    if args.num_samples is not None:
        ex += ["--num_samples", args.num_samples]
    if args.multihost is not None:
        ex += ["--multihost", str(args.multihost)]
    ex += paths("train", "dev")
    ex += paths(*(s for s in ("eval", "itw")
                  if getattr(args, f"{s}_protocol")))
    extract_embeddings.main(ex)
    if distributed.world_size() > 1:
        # stage 2 onwards runs on rank 0 alone, out of the gang (its
        # checkpoints are then no collective)
        primary = distributed.is_primary()
        torch.distributed.destroy_process_group()
        if not primary:
            return

    # 3) plots
    if not args.skip_plots:
        for split in ("eval", "itw"):
            if os.path.exists(os.path.join(emb_dir, f"{split}_embeddings.npy")):
                plot_umap.main(["--emb_dir", emb_dir, "--split", split,
                                "--out_dir", os.path.join(exp_dir, "plots")])

    # 4) stage-2
    s2 = ["--emb_dir", emb_dir, "--save_dir", stage2_dir] + device
    for flag, name in (("lr", "stage2_lr"), ("epochs", "stage2_epochs"),
                       ("patience", "stage2_patience"),
                       ("head_type", "stage2_head_type")):
        v = getattr(args, name)
        if v is not None:
            s2 += [f"--{flag}", str(v)]
    train_stage2.main(s2)

    # 5) scores, 6) EER report
    splits = [s for s in ("eval", "itw")
              if os.path.exists(os.path.join(emb_dir, f"{s}_embeddings.npy"))]
    if splits:
        generate_scores.main(["--emb_dir", emb_dir, "--stage2_dir", stage2_dir,
                              "--scores_dir", scores_dir, "--splits"]
                             + splits + device)
        eval_scores.main([os.path.join(scores_dir, f"score_cm_{s}.txt")
                          for s in splits])


if __name__ == "__main__":
    main()
