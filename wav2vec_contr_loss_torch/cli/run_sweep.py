"""The published experiment sweep: `run_pipeline` over the presets, one
after the other.

    python -m wav2vec_contr_loss_torch.cli.run_sweep --work_dir DIR \\
        --train_root DIR --train_protocol FILE ... [--experiments a b] \\
        [--keep_going] [--device cpu] [more run_pipeline flags]

The port of wav2vec_contr_loss_tpu/cli/run_sweep.py over the port's
`EXPERIMENT_PRESETS` and `run_pipeline`: every preset (or the named
ones) in sorted order with the JAX pass-through flags, and any other
flag (`--device cpu`, `--batch_size 8`, ...) handed to each run_pipeline
as it is. Each experiment
resumes through run_pipeline's skip-if-exists legs. `--keep_going` goes
on past a failed experiment; the run ends with a `[SWEEP]` line.
"""

from __future__ import annotations

import argparse
import traceback

from ..config import EXPERIMENT_PRESETS
from . import run_pipeline

__all__ = ["main"]

# flags forwarded to every run_pipeline as they are (the JAX list)
_PASSTHROUGH = ("model_name", "encoder_init", "work_dir", "train_root",
                "train_protocol", "dev_root", "dev_protocol", "eval_root",
                "eval_protocol", "itw_root", "itw_protocol", "num_samples")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--experiments", type=str, nargs="*", default=None,
                   help=f"presets to run (default: all "
                        f"{len(EXPERIMENT_PRESETS)})")
    p.add_argument("--keep_going", action="store_true",
                   help="go on with the sweep when one experiment fails")
    for flag in _PASSTHROUGH:
        p.add_argument(f"--{flag}", type=str, default=None)
    p.add_argument("--epochs", type=int, default=None)
    return p


def main(argv=None) -> None:
    args, extra = build_parser().parse_known_args(argv)
    names = args.experiments or sorted(EXPERIMENT_PRESETS)
    unknown = set(names) - set(EXPERIMENT_PRESETS)
    if unknown:
        raise SystemExit(f"unknown presets: {sorted(unknown)}")

    passthrough = []
    for flag in _PASSTHROUGH:
        v = getattr(args, flag)
        if v is not None:
            passthrough += [f"--{flag}", v]
    if args.epochs is not None:
        passthrough += ["--epochs", str(args.epochs)]
    passthrough += extra

    failures = []
    for i, name in enumerate(names, 1):
        print(f"\n===== [{i}/{len(names)}] experiment: {name} =====")
        try:
            run_pipeline.main(["--exp_name", name] + passthrough)
        except Exception:
            traceback.print_exc()
            failures.append(name)
            if not args.keep_going:
                raise
    if failures:
        print(f"\n[SWEEP] failed experiments: {failures}")
    else:
        print(f"\n[SWEEP] all {len(names)} experiments complete")


if __name__ == "__main__":
    main()
