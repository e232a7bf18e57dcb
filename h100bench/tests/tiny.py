"""A tiny copy of the benchmark's files for the CPU tests: the same
drivers, readers and reference, a configuration 32 wide and 2 layers
deep, clips of 1 s, and cells that name them. Everything lands in a
temporary checkout root beside a BENCHMARK.json of its own."""

from __future__ import annotations

import copy
import json
import os
import shutil

from h100bench import spec

TINY = {
    "hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4,
    "intermediate_size": 64, "conv_dim": [32] * 7,
    "num_conv_pos_embeddings": 16, "num_conv_pos_embedding_groups": 4,
    "compute_dtype": "float32",
}


def _read(*parts):
    with open(os.path.join(spec.HERE, *parts)) as f:
        return json.load(f)


def _write(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_root(root: str, limits=None) -> str:
    """A checkout at `root` holding a copy of h100bench with tiny cells
    'tiny.train' and 'tiny.train_group' (a 'group' extractor); -> root."""
    bench_dir = os.path.join(root, "h100bench")
    shutil.copytree(spec.HERE, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    for name in ("xlsr300m", "large960h"):
        cfg = dict(_read("configs", f"{name}.json"), **TINY)
        _write(os.path.join(bench_dir, "configs", f"tiny_{name}.json"), cfg)
    train = dict(_read("traffic", "train_b32.json"), batch_size=8,
                 clip_seconds=1, pool_clips=32, trace_reserve_s=0.5,
                 trace_steps=1,
                 lengths={"median_s": 0.7, "sigma": 0.5, "min_s": 0.3,
                          "max_s": 2.0})
    _write(os.path.join(bench_dir, "traffic", "tiny_train.json"), train)
    bench = copy.deepcopy(spec.benchmark())
    bench["configs"] += [
        {"name": f"tiny_{n}", "source": "tests", "reduced": [], "why": "tests",
         "file": f"h100bench/configs/tiny_{n}.json"}
        for n in ("xlsr300m", "large960h")]
    cells = {"tiny.train": ("tiny_xlsr300m", "tiny_train"),
             "tiny.train_group": ("tiny_large960h", "tiny_train")}
    bench["workloads"] += [{"name": k, "config": c, "traffic": t, "chips": 1,
                            "why": "tests"} for k, (c, t) in cells.items()]
    kinds = {"tiny.train": "xlsr300m.train_b32",
             "tiny.train_group": "large960h.train_b32"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [k for k, v in kinds.items()
                               if v in m["workloads"]]
    _write(os.path.join(root, "BENCHMARK.json"), bench)
    for cell, lim in (limits or {}).items():
        _write(os.path.join(bench_dir, "limits", f"{cell}.json"), lim)
    return root
