"""The process group of a multi-process run.

The port of wav2vec_contr_loss_tpu/utils/distributed.py
(`maybe_initialize`, `add_multihost_arg`, `init_from_args`). A gang is
launched by torchrun (`torchrun --nproc_per_node N -m
wav2vec_contr_loss_torch.cli.train_stage1 ...`), which exports `RANK`,
`WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR` and `MASTER_PORT`: those play
the part of the JAX coordinator markers. `maybe_initialize` joins the
group when they name a world of more than one process, or when the
caller forces it (`--multihost 1`); `--multihost 0` keeps a
single-process run. A failed init on a genuine launch raises: going on
alone would let every rank train on the whole global batch and race the
others' checkpoint writes.

The backend is NCCL for a `cuda` run and Gloo for a `cpu` one. The
`backend` argument overrides that for callers that know better (two
ranks on one card, which NCCL refuses, run Gloo with CUDA tensors); it
is never chosen because NCCL failed. On the card each rank takes
`cuda:LOCAL_RANK` as its device before anything touches CUDA.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["launched", "maybe_initialize", "add_multihost_arg",
           "init_from_args", "world_size", "rank", "is_primary", "barrier",
           "gang_device"]

# what torchrun exports to every rank
_LAUNCH_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def launched() -> bool:
    """True when the environment names a gang of more than one process."""
    return (all(os.environ.get(k) for k in _LAUNCH_VARS)
            and int(os.environ["WORLD_SIZE"]) > 1)


def gang_device(device) -> torch.device:
    """The device of this rank: `cuda:LOCAL_RANK` for a cuda run (the
    card torchrun gave this rank), else `device`."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def maybe_initialize(force: bool = False, device="cuda",
                     backend: Optional[str] = None,
                     timeout_s: float = 600.0) -> bool:
    """Join the process group when this is (or is forced to be) a
    multi-process launch; idempotent. -> True when the group is up.
    `force` needs torchrun's variables (a world of one is allowed)."""
    if dist.is_initialized():
        return True
    if not force and not launched():
        return False
    missing = [k for k in _LAUNCH_VARS if not os.environ.get(k)]
    if missing:
        raise RuntimeError(
            f"--multihost 1 needs a launcher's environment "
            f"({', '.join(missing)} unset): start the run with torchrun "
            f"--nproc_per_node N")
    dev = gang_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    try:
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method="env://",
            timeout=datetime.timedelta(seconds=timeout_s))
    except Exception as e:
        raise RuntimeError(
            "torch.distributed.init_process_group failed on what looks like "
            "a multi-process launch (torchrun's RANK/WORLD_SIZE are set). "
            "Failing fast: going on as a single process would let every "
            "rank train on the full global batch and race the checkpoint "
            "writes on the shared save_dir. Pass --multihost 0 to force a "
            "single-process run.") from e
    return True


def add_multihost_arg(parser) -> None:
    """The shared --multihost CLI flag (one definition for every CLI)."""
    parser.add_argument(
        "--multihost", type=int, default=None, choices=[0, 1],
        help="force (1) / suppress (0) joining the torch.distributed "
             "process group; default: join when torchrun launched more "
             "than one process (utils/distributed.py)")


def init_from_args(args, device="cuda") -> bool:
    """Apply the --multihost decision; call before any device use."""
    flag = getattr(args, "multihost", None)
    if flag == 0:
        return False
    return maybe_initialize(force=flag == 1, device=device)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (a no-op in one process)."""
    if world_size() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
