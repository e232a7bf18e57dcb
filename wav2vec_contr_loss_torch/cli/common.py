"""Shared CLI plumbing: path flags, encoder bootstrapping, dataset
builders. The port's copy of the parts of wav2vec_contr_loss_tpu/cli/
common.py that stage-1 training, extraction and run_pipeline need."""

from __future__ import annotations

import argparse
import os
from typing import Dict, Tuple

import torch

from ..config import LARGE_960H, XLSR_2B, XLSR_300M, Wav2Vec2Config, run_tag
from ..data import AudioConfig, parse_asvspoof2019, parse_in_the_wild

__all__ = ["TINY_TEST", "KNOWN_ARCHS", "add_asv_paths", "add_encoder_args",
           "add_cache_args", "add_layout_args", "join_gang", "rank_log",
           "load_encoder_init", "save_dir_for", "asv_dataset", "itw_dataset",
           "parse_num_samples"]

# tiny architecture for smoke tests (random init only)
TINY_TEST = Wav2Vec2Config(
    hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
    conv_dim=(16, 16, 16, 16, 16), conv_kernel=(10, 3, 3, 3, 3),
    conv_stride=(5, 2, 2, 2, 2), num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, dtype="float32",
    apply_spec_augment=False,
)

KNOWN_ARCHS = {
    "facebook/wav2vec2-xls-r-300m": XLSR_300M,
    "facebook/wav2vec2-large-960h": LARGE_960H,
    "facebook/wav2vec2-xls-r-2b": XLSR_2B,
    "test/tiny-wav2vec2": TINY_TEST,
}


def add_asv_paths(p: argparse.ArgumentParser, dev: bool = True,
                  eval_: bool = False, itw: bool = False) -> None:
    p.add_argument("--train_root", type=str, default="")
    p.add_argument("--train_protocol", type=str, default="")
    if dev:
        p.add_argument("--dev_root", type=str, default="")
        p.add_argument("--dev_protocol", type=str, default="")
    if eval_:
        p.add_argument("--eval_root", type=str, default="")
        p.add_argument("--eval_protocol", type=str, default="")
    if itw:
        p.add_argument("--itw_root", type=str, default="")
        p.add_argument("--itw_protocol", type=str, default="")


def add_encoder_args(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--model_name", type=str, default="facebook/wav2vec2-xls-r-300m",
        help="the encoder architecture (an HF id of KNOWN_ARCHS)")
    p.add_argument(
        "--encoder_init", type=str, default="pretrained",
        help="'pretrained' = the --model_name snapshot in the local "
             "HuggingFace cache ($HF_HUB_CACHE, else $HF_HOME/hub, else "
             "~/.cache/huggingface/hub; refused when it is not there: the "
             "port downloads nothing); 'random' = seeded random weights; "
             "a path = an HF snapshot directory (config.json and its "
             "weights), a directory written by convert_hf_checkpoint, or "
             "the encoder of a port stage-1 checkpoint (<dir>/<name>.pt "
             "beside its <name>.config.json)")


def add_cache_args(p: argparse.ArgumentParser,
                   required: bool = False) -> None:
    """--cache_waveforms DIR (its train/ and dev/ hold one decode-once
    cache each, data/cache.py) and --cache_dtype."""
    p.add_argument("--cache_waveforms", type=str, default=None,
                   required=required,
                   help="decode-once waveform cache directory: the first "
                        "run decodes the corpus into a memmap, later "
                        "epochs and runs read rows (data/cache.py)")
    p.add_argument("--cache_dtype", type=str, default="int16",
                   choices=["int16", "float32"],
                   help="cache storage (int16: exact for PCM sources, "
                        "half the disk; float32: bit-exact)")


def add_layout_args(p: argparse.ArgumentParser, model: bool = True) -> None:
    """--multihost and --param_sharding, and with `model` the flags of
    tensor, pipeline and sequence parallelism (stage 1; the baseline
    refuses 'pp')."""
    from ..utils.distributed import add_multihost_arg

    add_multihost_arg(p)
    p.add_argument("--param_sharding", type=str, default=None,
                   choices=["replicated", "fsdp", "pp"],
                   help="a gang's parameter layout (parallel/mesh.py): "
                        "'replicated' (data parallel), 'fsdp' (ZeRO-3 "
                        "over the encoder layers) or 'pp' (GPipe stages "
                        "over the 'model' axis, stage 1 only)")
    if not model:
        return
    p.add_argument("--mesh_model", type=int, default=1,
                   help="the mesh 'model' axis: > 1 splits each layer's "
                        "attention and FFN over that many ranks (tensor "
                        "parallelism), or the layer stack into that many "
                        "pipeline stages under --param_sharding pp; the "
                        "other ranks form 'data'")
    p.add_argument("--pipeline_microbatches", type=int, default=None,
                   help="GPipe microbatches a step under "
                        "--param_sharding pp (each rank's batch must "
                        "divide; more shrink the (S-1)/(M+S-1) bubble)")
    p.add_argument("--sequence_parallel", type=int, default=None,
                   choices=[0, 1],
                   help="frame-shard the residual stream over 'model' "
                        "(Megatron sequence parallelism: composes with "
                        "tensor parallelism and fsdp, excludes pp; a no-op "
                        "at --mesh_model 1)")


def join_gang(args, parser: argparse.ArgumentParser):
    """Apply --multihost and the layout flags before any device use.
    -> (this rank's device, the ('data', 'model') mesh or None for a
    single process). A 'model' axis without a gang to hold it exits 2."""
    from ..parallel.mesh import make_mesh
    from ..utils import distributed

    n_model = getattr(args, "mesh_model", 1)
    if not distributed.init_from_args(args, device=args.device):
        if n_model > 1:
            parser.error(f"--mesh_model {n_model} needs a gang of processes: "
                         f"launch with torchrun --nproc_per_node N")
        return args.device, None
    device = distributed.gang_device(args.device)
    try:
        mesh = make_mesh(n_model=n_model, device_type=device.type)
    except ValueError as e:
        parser.error(str(e))
    return device, mesh


def rank_log(*args, **kw) -> None:
    """print on rank 0 of a gang (every rank computes the same lines)."""
    from ..utils import distributed

    if distributed.is_primary():
        print(*args, **kw)


def load_encoder_init(encoder_init: str, model_name: str
                      ) -> Tuple[Wav2Vec2Config, Dict[str, torch.Tensor]]:
    """-> (architecture, encoder state dict or {} for a random init).
    'pretrained' reads the local HF cache's snapshot of `model_name`
    and, where there is none, is refused (the JAX package falls back to
    random weights with a warning)."""
    from ..models import hf_convert

    if encoder_init == "pretrained":
        snap = hf_convert.hf_cache_snapshot(model_name)
        if snap is None:
            raise ValueError(
                f"--encoder_init pretrained needs the HuggingFace checkpoint "
                f"of {model_name} (no snapshot under "
                f"{hf_convert.hf_hub_cache()}), and the port downloads "
                f"nothing: convert a local snapshot with `python -m "
                f"wav2vec_contr_loss_torch convert_hf_checkpoint --src "
                f"<snapshot dir> --out <dir>` and pass --encoder_init <dir>, "
                f"or pass --encoder_init random, or the .pt of a port "
                f"stage-1 checkpoint")
        encoder_init = snap
    if encoder_init == "random":
        if model_name not in KNOWN_ARCHS:
            raise ValueError(
                f"--encoder_init random builds a known architecture; "
                f"{model_name!r} is none of {sorted(KNOWN_ARCHS)}")
        return KNOWN_ARCHS[model_name], {}
    if hf_convert.is_hf_snapshot(encoder_init):
        return hf_convert.load_local_hf_checkpoint(encoder_init)
    # a missing path is an error
    return hf_convert.load_encoder_init(encoder_init)


def save_dir_for(base: str, model_name: str) -> str:
    """<save_dir>/<run_tag> subdirectory convention."""
    return os.path.join(base, run_tag(model_name))


def asv_dataset(root: str, protocol: str, num_samples=None, subset="all",
                seconds: int = 5, sr: int = 16000):
    return parse_asvspoof2019(
        protocol, root, subset=subset, num_samples=num_samples,
        audio=AudioConfig(sr, seconds),
    )


def itw_dataset(root: str, protocol: str, num_samples=None,
                seconds: int = 5, sr: int = 16000):
    return parse_in_the_wild(
        protocol, root, num_samples=num_samples,
        audio=AudioConfig(sr, seconds),
    )


def parse_num_samples(value):
    """--num_samples: an int, or None for the literal 'None'/'null' (the
    reference's convention) or an absent flag."""
    if value is None:
        return None
    ns = value.strip().lower()
    return None if ns in ("none", "null") else int(ns)
