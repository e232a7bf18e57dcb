"""Run one cell of the benchmark once and print its result line.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Loads and warms up the cell (set-up, timed
as setup_s), measures for --seconds, checks what the timed path produced
against the plain reference, and prints one JSON object as the last line
of standard output: with --trace 0 the cell's end-to-end metrics, with
--trace 1 its per-layer metrics (the same traffic untraced for most of
the window, then two profiled stretches at its end: the device's
activity alone, whose busy and window seconds the line gives, then the
host's operators with it, for attribution and the breakdown). Each compared number is printed
beside its limit on the last lines of standard error and under "checks",
the line's last key. Exits non-zero, with no result, when there is no
card (or fewer than the cell asks for), or when JAX or the JAX package
was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every cache at a fixed path inside the checkout, before anything loads
# the libraries that read these; nothing loads JAX through transformers
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, ".cache",
                                                  "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(HERE, ".cache", "nv")
os.environ["USE_FLAX"] = "0"

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "wav2vec_contr_loss_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that the port must never load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_state() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read: {e}"


def measure(cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, fault=None):
    """Run the cell's driver and assemble the result line's fields (all
    but 'device'). `fault`, for tests, breaks the program underneath."""
    from h100bench import spec

    res = cell.driver().run(cell, seed, seconds, trace, device, t_start,
                            fault=fault)
    if trace:
        traced, dev = res["traced"], res["dev_traced"]
        ctx = dict(res["ctx"], trace=traced.trace if traced else None,
                   traced=traced, window_s=traced.window_s if traced else None,
                   dev_trace=dev.trace if dev else None,
                   dev_window_s=dev.window_s if dev else None)
        metrics = spec.read_metrics(cell, ctx)
    else:
        # an end-to-end metric '<quantity>.<suffix>' reports the driver's
        # <quantity>: cells that need a bound of their own get a metric of
        # their own in BENCHMARK.json alone
        metrics = {}
        for m in cell.end_to_end:
            q = m["name"].split(".")[0]
            value = res["setup_s"] if q == "setup_s" else res["e2e"][q]
            if value is not None:   # a device metric in a run on the CPU
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {k: {"value": v, "limit": cell.limits.get(k)}
              for k, v in res["checks"].items()}
    correct = all(c["limit"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    return res, metrics, checks, correct


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from h100bench import spec, trace as tr

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"[h100bench] {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    name = torch.cuda.get_device_name(0)
    print(f"[h100bench] {cell.name} seed {args.seed} on {name}; torch "
          f"{torch.__version__} CUDA {torch.version.cuda}; torch imported "
          f"{time.perf_counter() - T_START:.2f} s after the start", flush=True)
    res, metrics, checks, correct = measure(
        cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    # read after the window, so that set-up does not wait for it
    print(f"[h100bench] nvidia-smi after the window: {card_state()}",
          flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"[h100bench] loaded modules that the port must not load: "
              f"{bad}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": name, "count": cell.chips,
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device}
    traced, dev = res["traced"], res["dev_traced"]
    if args.trace and traced is not None:
        # busy and window seconds of the stretch traced with the device's
        # activity alone; the breakdown names host ranges, so it comes
        # from the stretch traced with the host's operators
        device["busy_s"] = tr.busy_seconds(dev.trace)
        device["window_s"] = dev.window_s
        line["breakdown"] = tr.breakdown(traced.trace)
        print(f"[h100bench] traced stretch: {len(traced.trace.device_ops)} "
              f"device operations, launches {traced.counters}", flush=True)
    line["checks"] = checks
    print(json.dumps(line), flush=True)
    for k, c in checks.items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
