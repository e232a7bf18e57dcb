"""A local HuggingFace Wav2Vec2 snapshot -> the port's encoder weights.

The port's copy of wav2vec_contr_loss_tpu/models/hf_convert.py, with no
`transformers` and no `safetensors`. The port's encoder already uses HF
parameter names (bridge.py), so the conversion is key selection plus one
fold:

  * a `wav2vec2.` prefix (ForCTC / ForPreTraining snapshots) is stripped;
  * keys the encoder does not hold (`quantizer.*`, `project_q.*`,
    `project_hid.*`, `lm_head.*`) are dropped by name, and any other key
    the encoder does not expect raises, as does a missing one;
  * the positional conv's weight norm (dim=2) is folded into the plain
    kernel w = g * v / max(||v||, 1e-12), the norm over dims 0 and 1,
    with the JAX module's numpy expression and in the stored dtype, so
    the result is the JAX package's to the bit. Three layouts are read:
    `weight_g`/`weight_v`, `parametrizations.weight.original0/1` and a
    plain `weight`.

Weights come from `model.safetensors` (read by the port's own reader: an
8-byte little-endian header length, a JSON header, raw little-endian
tensors; F32, F16 and BF16), `pytorch_model.bin` / `.pt`
(`torch.load(weights_only=True)`), or the shards a `*.index.json` names.
The architecture comes from `config.json` with transformers'
`Wav2Vec2Config` defaults for absent fields. `save_encoder_init` writes the
result as a port checkpoint pair (`<name>.pt` with {"encoder": state dict}
beside `<name>.config.json`, train/checkpoint.py) that `--encoder_init`
and `load_encoder_init` read.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import Wav2Vec2Config, config_from_dict

__all__ = ["config_from_hf", "fold_weight_norm", "convert_hf_state_dict",
           "read_safetensors", "load_local_hf_checkpoint", "hf_hub_cache",
           "hf_cache_snapshot", "is_hf_snapshot",
           "save_encoder_init", "load_encoder_init", "encoder_keys"]

POS_CONV = "encoder.pos_conv_embed.conv"
# heads and pretraining parts of HF checkpoints that the encoder has no
# place for
_DROPPED = ("quantizer.", "project_q.", "project_hid.", "lm_head.")

# transformers.Wav2Vec2Config's defaults for the fields the JAX
# config_from_hf reads
_HF_DEFAULTS = dict(
    hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
    intermediate_size=3072, conv_dim=(512,) * 7,
    conv_kernel=(10, 3, 3, 3, 3, 2, 2), conv_stride=(5, 2, 2, 2, 2, 2, 2),
    conv_bias=False, feat_extract_norm="group", do_stable_layer_norm=False,
    num_conv_pos_embeddings=128, num_conv_pos_embedding_groups=16,
    layer_norm_eps=1e-5, hidden_dropout=0.1, attention_dropout=0.1,
    activation_dropout=0.1, feat_proj_dropout=0.0, apply_spec_augment=True,
    mask_time_prob=0.05, mask_time_length=10, mask_time_min_masks=2)


def config_from_hf(hf: Mapping) -> Wav2Vec2Config:
    """An HF `config.json` dict -> the port's config (the fields and
    defaults of the JAX config_from_hf)."""
    c = {**_HF_DEFAULTS, **{k: v for k, v in hf.items()
                            if k in _HF_DEFAULTS}}
    return Wav2Vec2Config(
        hidden_size=int(c["hidden_size"]),
        num_layers=int(c["num_hidden_layers"]),
        num_heads=int(c["num_attention_heads"]),
        intermediate_size=int(c["intermediate_size"]),
        conv_dim=tuple(c["conv_dim"]), conv_kernel=tuple(c["conv_kernel"]),
        conv_stride=tuple(c["conv_stride"]), conv_bias=bool(c["conv_bias"]),
        feat_extract_norm=c["feat_extract_norm"],
        do_stable_layer_norm=bool(c["do_stable_layer_norm"]),
        num_conv_pos_embeddings=int(c["num_conv_pos_embeddings"]),
        num_conv_pos_embedding_groups=int(c["num_conv_pos_embedding_groups"]),
        layer_norm_eps=float(c["layer_norm_eps"]),
        hidden_dropout=float(c["hidden_dropout"]),
        attention_dropout=float(c["attention_dropout"]),
        activation_dropout=float(c["activation_dropout"]),
        feat_proj_dropout=float(c["feat_proj_dropout"]),
        apply_spec_augment=bool(c["apply_spec_augment"]),
        mask_time_prob=float(c["mask_time_prob"]),
        mask_time_length=int(c["mask_time_length"]),
        mask_time_min_masks=int(c["mask_time_min_masks"]),
    )


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:   # numpy has no bf16; widen exactly
            t = t.float()
        return t.numpy()
    return np.asarray(t)


def fold_weight_norm(sd: Mapping, prefix: str = POS_CONV) -> np.ndarray:
    """The positional conv's effective (out, in/groups, k) kernel from any
    of the three key layouts, folded as the JAX module folds it."""
    if f"{prefix}.weight_v" in sd:
        v, g = _np(sd[f"{prefix}.weight_v"]), _np(sd[f"{prefix}.weight_g"])
    elif f"{prefix}.parametrizations.weight.original1" in sd:
        g = _np(sd[f"{prefix}.parametrizations.weight.original0"])
        v = _np(sd[f"{prefix}.parametrizations.weight.original1"])
    elif f"{prefix}.weight" in sd:      # already materialized
        return _np(sd[f"{prefix}.weight"])
    else:
        raise KeyError(f"no positional-conv weight under {prefix}")
    norm = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def encoder_keys(cfg: Wav2Vec2Config) -> list:
    """The state-dict keys of the port's encoder for `cfg`."""
    from .wav2vec2 import Wav2Vec2Encoder

    with torch.device("meta"):
        return list(Wav2Vec2Encoder(cfg).state_dict())


def convert_hf_state_dict(state_dict: Mapping, cfg: Wav2Vec2Config
                          ) -> Dict[str, torch.Tensor]:
    """An HF `Wav2Vec2Model` state dict (tensors or numpy arrays) -> the
    port encoder's state dict, fp32 on the CPU."""
    sd = {k.removeprefix("wav2vec2."): v for k, v in state_dict.items()}
    sd = {k: v for k, v in sd.items() if not k.startswith(_DROPPED)}
    want = encoder_keys(cfg)
    pos = {f"{POS_CONV}.{s}" for s in (
        "weight", "weight_g", "weight_v", "parametrizations.weight.original0",
        "parametrizations.weight.original1")}
    # masked_spec_embed is SpecAugment's; without it the encoder has none
    unexpected = sorted(set(sd) - set(want) - pos - {"masked_spec_embed"})
    missing = sorted(k for k in want if k not in sd
                     and k != f"{POS_CONV}.weight")
    if unexpected or missing:
        raise KeyError(f"not a Wav2Vec2 encoder of this config: missing "
                       f"{missing[:8]}, unexpected {unexpected[:8]}")
    out = {}
    for k in want:
        x = fold_weight_norm(sd) if k == f"{POS_CONV}.weight" else _np(sd[k])
        out[k] = torch.from_numpy(np.array(x, dtype=np.float32))
    return out


# ------------------------------------------------------------ safetensors
_ST_DTYPES = {"F32": np.dtype("<f4"), "F16": np.dtype("<f2"),
              "BF16": np.dtype("<u2")}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A `.safetensors` file -> {name: numpy array}: F32 and F16 as
    stored, BF16 widened to float32 (exact; numpy has no bf16)."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    base = 8 + n
    size = os.path.getsize(path)
    data = np.memmap(path, dtype=np.uint8, mode="r")
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dt = meta["dtype"]
        if dt not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {dt}; the "
                             f"reader takes {sorted(_ST_DTYPES)}")
        lo, hi = meta["data_offsets"]
        shape = tuple(meta["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if (hi - lo != count * _ST_DTYPES[dt].itemsize or lo < 0
                or base + hi > size):
            raise ValueError(f"{path}: tensor {name!r} has a bad extent")
        raw = np.array(data[base + lo:base + hi]).view(_ST_DTYPES[dt])
        if dt == "BF16":
            raw = (raw.astype(np.uint32) << 16).view(np.float32)
        out[name] = raw.reshape(shape)
    return out


def _read_weight_file(path: str) -> Dict:
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def load_local_hf_checkpoint(src: str
                             ) -> Tuple[Wav2Vec2Config, Dict[str, torch.Tensor]]:
    """(config, encoder state dict) from a local HF checkpoint, no
    network: a snapshot directory (config.json with model.safetensors,
    pytorch_model.bin or pytorch_model.pt, or the shards of a
    `*.index.json`), or one weights file with config.json beside it."""
    if os.path.isdir(src):
        d = src
        weight_files: list = []
        for index in ("model.safetensors.index.json",
                      "pytorch_model.bin.index.json"):
            ip = os.path.join(d, index)
            if os.path.exists(ip):
                with open(ip) as f:
                    shards = sorted(set(json.load(f)["weight_map"].values()))
                weight_files = [os.path.join(d, s) for s in shards]
                break
        if not weight_files:
            for cand in ("model.safetensors", "pytorch_model.bin",
                         "pytorch_model.pt"):
                if os.path.exists(os.path.join(d, cand)):
                    weight_files = [os.path.join(d, cand)]
                    break
        if not weight_files:
            raise FileNotFoundError(
                f"no weights (model.safetensors / pytorch_model.bin / "
                f"*.index.json) under {d}")
    else:
        d = os.path.dirname(os.path.abspath(src))
        weight_files = [src]
    config_path = os.path.join(d, "config.json")
    if not os.path.exists(config_path):
        raise FileNotFoundError(f"no config.json beside weights: "
                                f"{config_path}")
    with open(config_path) as f:
        cfg = config_from_hf(json.load(f))
    sd: Dict = {}
    for wf in weight_files:
        sd.update(_read_weight_file(wf))
    return cfg, convert_hf_state_dict(sd, cfg)


def hf_hub_cache() -> str:
    """The local HuggingFace hub cache: $HF_HUB_CACHE, else $HF_HOME/hub,
    else ~/.cache/huggingface/hub."""
    if os.environ.get("HF_HUB_CACHE"):
        return os.environ["HF_HUB_CACHE"]
    if os.environ.get("HF_HOME"):
        return os.path.join(os.environ["HF_HOME"], "hub")
    return os.path.join(os.path.expanduser("~"), ".cache", "huggingface",
                        "hub")


def hf_cache_snapshot(model_name: str) -> Optional[str]:
    """The snapshot directory of `model_name` ('org/name') in the local
    hub cache, the revision `refs/main` names
    (models--org--name/snapshots/<rev>), or None when the cache holds
    none. Reads files only: no network."""
    repo = os.path.join(hf_hub_cache(),
                        "models--" + model_name.replace("/", "--"))
    ref = os.path.join(repo, "refs", "main")
    if not os.path.isfile(ref):
        return None
    with open(ref) as f:
        snap = os.path.join(repo, "snapshots", f.read().strip())
    return snap if is_hf_snapshot(snap) else None


def is_hf_snapshot(path: str) -> bool:
    """A directory holding an HF config.json (a snapshot; a port
    checkpoint directory holds <name>.config.json instead)."""
    return os.path.isfile(os.path.join(path, "config.json"))


# ----------------------------------------------------------- encoder init
def save_encoder_init(out_dir: str, config: Wav2Vec2Config,
                      state_dict: Mapping[str, torch.Tensor],
                      name: str = "encoder", source: str = "") -> str:
    """Write converted encoder weights as `<out_dir>/<name>.pt` beside its
    sidecar, which `--encoder_init <out_dir>` reads. -> the base path."""
    from ..train import checkpoint as ckpt

    return ckpt.save_checkpoint(
        out_dir, name, {"encoder": dict(state_dict)},
        extra={"enc_config": dataclasses.asdict(config), "source": source})


def load_encoder_init(path: str
                      ) -> Tuple[Wav2Vec2Config, Dict[str, torch.Tensor]]:
    """(config, encoder state dict) from a directory written by
    `save_encoder_init`, or from a `<dir>/<name>` checkpoint path (a
    port stage-1 checkpoint too: its encoder part is read)."""
    from ..train import checkpoint as ckpt

    path = os.path.abspath(path)
    if path.endswith(".pt"):
        path = path[:-3]
    if ckpt.checkpoint_exists(path, "encoder"):
        directory, name = path, "encoder"
    else:
        directory, name = os.path.dirname(path), os.path.basename(path)
        if not ckpt.checkpoint_exists(directory, name):
            raise FileNotFoundError(f"no encoder checkpoint at {path}")
    extra = ckpt.load_sidecar(directory, name)["extra"]
    enc = ckpt.restore_parts(directory, name, ("encoder",))["encoder"]
    return config_from_dict(extra["enc_config"]), dict(enc)
