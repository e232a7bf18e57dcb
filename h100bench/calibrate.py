"""Readings that the limits of `correct` are set from, on the card, at a
cell's own size, many seeds in one process.

    python3 h100bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 3] [--program 1] [--control 1]

For each seed it prints one JSON line:
  program  the numbers a run compares (its driver with a short window at
           the cell's load, then the reference), as the run computes them;
  control  the same numbers with the reference put in the program's
           place at the precision below the configuration's, against
           the fp32 reference: float8 (e4m3) operands under bf16 compute;
           under fp32 compute (TF32 off) TF32; and the planted fault
           'half_batch' (the loss of half the batch) in the reference.
The limits (limits/<cell>.json) lie above the program's readings and
below the control's; PERF.md gives both.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from h100bench import run as harness  # noqa: E402  (sets the cache paths)


# the control of a configuration's compute dtype: the reference.model
# Precision of the nearest precision below it
CONTROLS = {"bfloat16": "fp8", "float32": "tf32"}


def _train_control(cell, seed: int, device, control=None) -> dict:
    """{control: gaps} for `control` (the configuration's CONTROLS entry by
    default) and for the 'half_batch' fault."""
    import torch

    from h100bench import traffic as gen, weights
    from h100bench.drivers import train as drv

    t, cfg = cell.traffic, cell.config
    _, recipe = drv._stage1_config(cell, seed)
    samples = t["clip_seconds"] * gen.SAMPLE_RATE
    pool, labels = gen.train_pool(t, seed, samples)
    first = drv.first_batches(labels, t["batch_size"], seed,
                              t["check_steps"])
    batches = [(torch.from_numpy(pool[i]).to(device),
                torch.from_numpy(labels[i]).to(device)) for i in first]

    def ref(**kw):
        p = {k: v for k, v in weights.make(cfg, seed, device).items()
             if not k.startswith("head.")}
        out = drv.ref_train.run_steps(p, cfg, recipe, seed, batches,
                                      t["check_steps"], **kw)
        del p
        torch.cuda.empty_cache()
        return out

    base = ref()
    control = control or CONTROLS[cfg["compute_dtype"]]
    out = {control: drv.gaps(ref(precision=control), base),
           "half_batch": drv.gaps(ref(fault="half_batch"), base)}
    for v in out.values():
        v.pop("_worst")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--program", type=int, default=1)
    ap.add_argument("--control", type=int, default=1)
    args = ap.parse_args()
    from h100bench import spec

    import torch

    if not torch.cuda.is_available():
        print("calibrate needs the card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        row = {"workload": cell.name, "seed": seed}
        if args.program:
            res, _, checks, _ = harness.measure(
                cell, seed, args.seconds, False, "cuda", time.perf_counter())
            row["program"] = {k: c["value"] for k, c in checks.items()}
            row["e2e"] = res["e2e"]
            torch.cuda.reset_peak_memory_stats()
        if args.control:
            row["control"] = _train_control(cell, seed, "cuda")
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
