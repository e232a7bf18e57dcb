"""The score-parity check: EERs of an experiment's score files against
the reference's committed results.

    python -m wav2vec_contr_loss_torch.cli.verify_parity --exp_name supcon \\
        --scores_dir DIR [--tolerance 0.2] [--itw_tolerance 2.0]
    python -m wav2vec_contr_loss_torch.cli.verify_parity --exp_name supcon \\
        [run_pipeline flags]      # runs the pipeline first

The port of wav2vec_contr_loss_tpu/cli/verify_parity.py with its own
copy of `REFERENCE_EER` (percent, recomputed from the reference's
committed score files: ASVspoof 2019 LA eval, In-The-Wild). Without
--scores_dir it runs `run_pipeline` with the other flags and reads
<work_dir>/<exp>/scores/<exp>/<run tag>/. Exits 0 when the eval EER is
within --tolerance (and the ITW EER, where its file exists, within
--itw_tolerance), 1 otherwise or when the eval file is missing. Real
corpora and checkpoints are needed for a real check.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..config import run_tag
from ..eval.metrics import calculate_eer_from_file

__all__ = ["REFERENCE_EER", "main"]

# reference EERs in % (ASV19 LA eval, ITW), the JAX package's table
REFERENCE_EER = {
    "supcon": (0.299, 13.694),
    "supcon_temp_0.05": (0.370, 18.270),
    "supcon_temp_0.07": (0.326, 12.102),
    "supcon_temp_0.07_batch_64": (2.884, 40.548),
    "supcon_temp_0.1": (0.299, 15.885),
    "supcon_temp_0.6": (1.213, 9.097),
    "supcon_geodesic": (0.297, 14.853),
    "supcon_geodesic_temp_0.05": (0.204, 9.623),
    "supcon_geodesic_temp_0.07": (0.191, 12.671),
    "supcon_geodesic_temp_0.1": (0.370, 10.299),
    "supcon_geodesic_temp_0.6": (0.528, 10.478),
    "supcon_uniformity": (1.444, 15.139),
    "supcon_uniformity_weight_0.01": (0.392, 11.627),
    "supcon_uniformity_weight_0.05": (0.218, 13.481),
    "supcon_uniformity_weight_0.1": (0.231, 18.509),
    "supcon_uniformity_weight_0.6": (0.938, 18.053),
}


def _flag(argv, name: str, default: str) -> str:
    """The value of `--name` in a run_pipeline argument list."""
    for i, a in enumerate(argv[:-1]):
        if a == f"--{name}":
            return argv[i + 1]
    return default


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--exp_name", type=str, required=True,
                   choices=sorted(REFERENCE_EER))
    p.add_argument("--scores_dir", type=str, default=None,
                   help="existing score-file directory; otherwise the "
                        "pipeline runs first (pass run_pipeline's flags)")
    p.add_argument("--tolerance", type=float, default=0.2,
                   help="largest |EER - reference| in absolute percent "
                        "(ASV19 LA eval)")
    p.add_argument("--itw_tolerance", type=float, default=2.0,
                   help="the In-The-Wild tolerance")
    return p


def main(argv=None) -> None:
    args, passthrough = build_parser().parse_known_args(argv)
    if args.scores_dir is None:
        from . import run_pipeline

        run_pipeline.main(["--exp_name", args.exp_name] + passthrough)
        args.scores_dir = os.path.join(
            _flag(passthrough, "work_dir", "experiments"), args.exp_name,
            "scores", args.exp_name,
            run_tag(_flag(passthrough, "model_name",
                          "facebook/wav2vec2-xls-r-300m")))

    ref_eval, ref_itw = REFERENCE_EER[args.exp_name]
    ok = True
    eval_path = os.path.join(args.scores_dir, "score_cm_eval.txt")
    if os.path.exists(eval_path):
        eer = calculate_eer_from_file(eval_path)
        passed = abs(eer - ref_eval) <= args.tolerance
        ok &= passed
        print(f"ASV19 LA eval: EER={eer:.3f}% ref={ref_eval:.3f}% "
              f"tol={args.tolerance} -> {'PASS' if passed else 'FAIL'}")
    else:
        ok = False
        print(f"FAIL: missing {eval_path}")

    itw_path = os.path.join(args.scores_dir, "score_cm_itw.txt")
    if os.path.exists(itw_path):
        eer = calculate_eer_from_file(itw_path)
        passed = abs(eer - ref_itw) <= args.itw_tolerance
        ok &= passed
        print(f"In-The-Wild:   EER={eer:.3f}% ref={ref_itw:.3f}% "
              f"tol={args.itw_tolerance} -> {'PASS' if passed else 'FAIL'}")

    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
