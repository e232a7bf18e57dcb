"""Prebuild the decode-once waveform cache (data/cache.py) of a train and
a dev protocol, on the host.

    python -m wav2vec_contr_loss_torch.cli.cache_waveforms \\
        --train_root DIR --train_protocol FILE [--dev_root DIR \\
        --dev_protocol FILE] --cache_waveforms DIR [--cache_dtype int16]

The port of wav2vec_contr_loss_tpu/cli/cache_waveforms.py: `<dir>/train`
and `<dir>/dev` hold one cache each, the layout the training CLIs'
--cache_waveforms read. It takes no device.
"""

from __future__ import annotations

import argparse
import os

from ..data.cache import attach_cache
from .common import add_asv_paths, add_cache_args, asv_dataset


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_asv_paths(p)
    add_cache_args(p, required=True)
    p.add_argument("--num_samples", type=int, default=None)
    p.add_argument("--max_duration_seconds", type=int, default=5)
    p.add_argument("--num_workers", type=int, default=8)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    for split in ("train", "dev"):
        protocol = getattr(args, f"{split}_protocol")
        if split == "dev" and not protocol:
            continue
        ds = asv_dataset(getattr(args, f"{split}_root"), protocol,
                         args.num_samples,
                         seconds=args.max_duration_seconds)
        attach_cache(ds, os.path.join(args.cache_waveforms, split),
                     dtype=args.cache_dtype, num_workers=args.num_workers)
    print(f"==> waveform cache ready in {args.cache_waveforms}")


if __name__ == "__main__":
    main()
