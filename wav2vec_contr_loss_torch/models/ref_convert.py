"""The reference's trained torch `.pt` files <-> the port's checkpoints.

The port's copy of wav2vec_contr_loss_tpu/models/ref_convert.py. The
reference writes:

  * stage 1: {epoch, compression_state_dict, train_loss, dev_loss, config,
    [encoder_state_dict when the encoder was finetuned]}, the encoder as
    the reference's wrapper (HF `Wav2Vec2Model` under `model.`), keys
    possibly under DataParallel's `module.`;
  * the stage-2 head: {epoch, model_state_dict, ..., config}, a linear
    head `fc.*` or an MLP `net.0.*`/`net.3.*`;
  * the baseline: {epoch, model_state_dict (the whole End2EndBCEModel:
    encoder.model.*, compression.mlp3.*, classifier.*), best_eer, ...,
    config}.

`convert_reference_checkpoint` turns them into the checkpoints that
`Stage1Trainer.from_checkpoint`, `SpoofScorer.from_checkpoints`,
`extract_embeddings`, `run_pipeline --stage1_ckpt`,
`BaselineTrainer.from_checkpoint` and `score_baseline` read: a stage-1 or
baseline state is a whole train state (the converted weights, a fresh
optimizer, step 0). The `export_*` functions go the other way.

The encoder's architecture, which a `.pt` does not carry, comes from
`encoder_init` (a directory of `convert_hf_checkpoint`, which also gives
the weights a frozen stage-1 `.pt` lacks), from `hf_config` (an HF
config.json, read as plain JSON) or from a known MODEL_NAME.

A `.pt` is unpickled with `weights_only=False`, as the JAX module does:
the reference pickles plain config dicts and may pickle numpy scalars
beside the tensors. Convert only files you trust.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional, Tuple

import torch

from ..config import (LARGE_960H, XLSR_300M, BaselineConfig, Stage1Config,
                      Stage2Config, Wav2Vec2Config, config_from_dict)
from ..train import checkpoint as ckpt_mod
from ..train.stage2 import STAGE2_BEST
from .hf_convert import config_from_hf, convert_hf_state_dict, load_encoder_init

__all__ = ["detect_kind", "convert_reference_checkpoint",
           "convert_stage1_checkpoint", "convert_stage2_checkpoint",
           "convert_baseline_checkpoint", "stage1_config_from_ckpt_dict",
           "baseline_config_from_ckpt_dict", "export_reference_checkpoint",
           "export_stage1_checkpoint", "export_stage2_checkpoint",
           "export_baseline_checkpoint", "reference_encoder_state_dict"]

# MODEL_NAME values of the published runs -> built-in architectures
_KNOWN_MODELS = {
    "facebook/wav2vec2-xls-r-300m": XLSR_300M,
    "facebook/wav2vec2-large-960h": LARGE_960H,
}


def _load_pt(path: str) -> Dict:
    return torch.load(path, map_location="cpu", weights_only=False)


def _strip_module_prefix(sd: Mapping) -> Dict:
    """DataParallel's 'module.' prefixes."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def detect_kind(ckpt: Mapping) -> str:
    """'stage1' | 'stage2' | 'baseline' from a loaded .pt dict's keys."""
    if "compression_state_dict" in ckpt:
        return "stage1"
    sd = ckpt.get("model_state_dict")
    if sd is None:
        raise ValueError(
            "unrecognized reference checkpoint: neither "
            "compression_state_dict (stage-1) nor model_state_dict "
            "(stage-2 head / baseline) present")
    if any(k.startswith(("encoder.", "module.encoder.")) for k in sd):
        return "baseline"
    return "stage2"


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float32).clone()


def convert_compression_state_dict(sd: Mapping) -> Dict[str, torch.Tensor]:
    """The reference CompressionModule (its one Linear is `mlp3`) -> the
    port's (`proj`)."""
    sd = _strip_module_prefix(sd)
    return {"proj.weight": _f32(sd["mlp3.weight"]),
            "proj.bias": _f32(sd["mlp3.bias"])}


def convert_head_state_dict(sd: Mapping
                            ) -> Tuple[str, Dict[str, torch.Tensor]]:
    """The reference head (`fc.*`, or `net.0.*`/`net.3.*`) -> (head_type,
    the port head's state dict)."""
    sd = _strip_module_prefix(sd)
    if "fc.weight" in sd:
        return "linear", {"fc.weight": _f32(sd["fc.weight"]),
                          "fc.bias": _f32(sd["fc.bias"])}
    if "net.0.weight" in sd:
        return "mlp", {"fc1.weight": _f32(sd["net.0.weight"]),
                       "fc1.bias": _f32(sd["net.0.bias"]),
                       "fc2.weight": _f32(sd["net.3.weight"]),
                       "fc2.bias": _f32(sd["net.3.bias"])}
    raise ValueError(
        f"unrecognized stage-2 head state dict (keys: {sorted(sd)[:6]}...)")


def convert_encoder_state_dict(sd: Mapping, enc_config: Wav2Vec2Config
                               ) -> Dict[str, torch.Tensor]:
    """The reference encoder wrapper's state dict ('model.<hf key>',
    maybe under 'module.') -> the port encoder's."""
    sd = _strip_module_prefix(sd)
    sd = {(k[len("model."):] if k.startswith("model.") else k): v
          for k, v in sd.items()}
    return convert_hf_state_dict(sd, enc_config)


def _resolve_encoder(encoder_init: Optional[str], hf_config: Optional[str],
                     model_name: Optional[str], need_weights: bool
                     ) -> Tuple[Wav2Vec2Config, Optional[Dict]]:
    """-> (architecture, pretrained encoder state dict or None)."""
    if encoder_init is not None:
        return load_encoder_init(encoder_init)
    if need_weights:
        raise ValueError(
            "this checkpoint embeds no encoder weights (frozen-encoder "
            "run: the reference reloads the pretrained encoder by "
            "MODEL_NAME at extraction time); pass --encoder_init "
            "<dir from convert_hf_checkpoint> to supply them")
    if hf_config is not None:
        with open(hf_config) as f:
            return config_from_hf(json.load(f)), None
    if model_name in _KNOWN_MODELS:
        return _KNOWN_MODELS[model_name], None
    raise ValueError(
        f"cannot resolve the encoder architecture for MODEL_NAME="
        f"{model_name!r}: pass --encoder_init or --hf_config (known "
        f"names: {sorted(_KNOWN_MODELS)})")


def stage1_config_from_ckpt_dict(c: Mapping) -> Stage1Config:
    """The reference's UPPERCASE stage-1 config dict -> Stage1Config;
    absent keys keep the defaults."""
    field_map = {
        "MODEL_NAME": "model_name", "INPUT_DIM": "input_dim",
        "HIDDEN_DIM": "hidden_dim", "DROPOUT": "dropout",
        "BATCH_SIZE": "batch_size", "HEAD_LR": "head_lr",
        "ENC_LR": "enc_lr", "WEIGHT_DECAY": "weight_decay",
        "TEMPERATURE": "temperature", "TOPK_NEG": "topk_neg",
        "WARMUP_EPOCHS": "warmup_epochs", "ALPHA_END": "alpha_end",
        "ALPHA_RAMP_EPOCHS": "alpha_ramp_epochs",
        "USE_RAWBOOST": "use_rawboost", "RAWBOOST_PROB": "rawboost_prob",
        "UNIFORMITY_WEIGHT": "uniformity_weight",
        "UNIFORMITY_T": "uniformity_t",
        "SUPCON_SIMILARITY": "supcon_similarity",
        "FINETUNE_ENCODER": "finetune_encoder",
    }
    return Stage1Config(**{field_map[k]: v for k, v in c.items()
                           if k in field_map})


def baseline_config_from_ckpt_dict(c: Mapping) -> BaselineConfig:
    """The reference baseline's config dict (note its lowercase enc_lr,
    head_lr and train_batch_size keys) -> BaselineConfig; absent keys
    keep the defaults."""
    field_map = {
        "MODEL_NAME": "model_name", "INPUT_DIM": "input_dim",
        "HIDDEN_DIM": "hidden_dim", "DROPOUT": "dropout",
        "enc_lr": "enc_lr", "head_lr": "head_lr",
        "WEIGHT_DECAY": "weight_decay", "train_batch_size": "batch_size",
        "USE_RAWBOOST": "use_rawboost", "RAWBOOST_PROB": "rawboost_prob",
        "PATIENCE": "patience", "FINETUNE_ENCODER": "finetune_encoder",
    }
    return BaselineConfig(**{field_map[k]: v for k, v in c.items()
                             if k in field_map})


# ------------------------------------------------------------ converters
def convert_stage1_checkpoint(src: str, out_dir: str,
                              encoder_init: Optional[str] = None,
                              hf_config: Optional[str] = None,
                              name: str = "best",
                              config_overrides: Optional[Dict] = None,
                              ckpt: Optional[Dict] = None) -> str:
    """A reference stage-1 .pt -> a port stage-1 checkpoint that
    `Stage1Trainer.from_checkpoint(out_dir, name)` restores: the converted
    compression (and encoder, when the .pt embeds a finetuned one), a
    fresh optimizer state (the reference saves none), step 0. Built on
    the CPU. -> the checkpoint's base path."""
    from ..train.stage1 import Stage1Trainer

    ckpt = _load_pt(src) if ckpt is None else ckpt
    if "compression_state_dict" not in ckpt:
        raise ValueError(f"{src} is not a reference stage-1 checkpoint")
    cfg = stage1_config_from_ckpt_dict(ckpt.get("config", {}))
    if config_overrides:
        cfg = cfg.replace(**config_overrides)
    finetuned = "encoder_state_dict" in ckpt
    enc_cfg, enc_sd = _resolve_encoder(encoder_init, hf_config,
                                       cfg.model_name,
                                       need_weights=not finetuned)
    if finetuned:
        enc_sd = convert_encoder_state_dict(ckpt["encoder_state_dict"],
                                            enc_cfg)
    comp = convert_compression_state_dict(ckpt["compression_state_dict"])
    trainer = Stage1Trainer(cfg, enc_cfg,
                            {"encoder": enc_sd, "compression": comp},
                            device="cpu")
    metrics = {k: ckpt[k] for k in ("epoch", "train_loss", "dev_loss")
               if k in ckpt}
    metrics["converted_from"] = os.path.abspath(src)
    return ckpt_mod.save_checkpoint(out_dir, name, trainer.state_dict(),
                                    cfg.ckpt_config(), metrics,
                                    trainer._sidecar_extra())


def convert_stage2_checkpoint(src: str, out_dir: str,
                              name: str = STAGE2_BEST,
                              ckpt: Optional[Dict] = None) -> str:
    """A reference stage-2 head .pt -> the checkpoint `load_stage2_head`
    reads. -> the checkpoint's base path."""
    ckpt = _load_pt(src) if ckpt is None else ckpt
    head_type, sd = convert_head_state_dict(ckpt["model_state_dict"])
    c = ckpt.get("config", {})
    first = sd["fc.weight" if head_type == "linear" else "fc1.weight"]
    cfg = Stage2Config(
        head_type=c.get("HEAD_TYPE", head_type),
        in_dim=int(c.get("IN_DIM", first.shape[1])),
        hidden_dim=int(c.get("HIDDEN_DIM", 128)),
        dropout=float(c.get("DROPOUT", 0.2)))
    if cfg.head_type != head_type:
        raise ValueError(f"checkpoint config says HEAD_TYPE={cfg.head_type} "
                         f"but the state dict is a {head_type} head")
    metrics = {k: ckpt[k] for k in ("epoch", "train_loss", "dev_loss",
                                    "dev_acc", "dev_auc", "dev_eer")
               if ckpt.get(k) is not None}
    metrics["converted_from"] = os.path.abspath(src)
    return ckpt_mod.save_checkpoint(out_dir, name, sd, cfg.ckpt_config(),
                                    metrics)


def convert_baseline_checkpoint(src: str, out_dir: str,
                                encoder_init: Optional[str] = None,
                                hf_config: Optional[str] = None,
                                name: str = "baseline_best",
                                config_overrides: Optional[Dict] = None,
                                ckpt: Optional[Dict] = None) -> str:
    """A reference baseline .pt (the whole End2EndBCEModel state dict) ->
    a port checkpoint that `BaselineTrainer.from_checkpoint(out_dir,
    name)` restores: the converted encoder, compression and classifier, a
    fresh optimizer, step 0. The .pt always embeds the encoder, so only
    its architecture is resolved. Built on the CPU. -> the checkpoint's
    base path."""
    from ..train.baseline import BaselineTrainer

    ckpt = _load_pt(src) if ckpt is None else ckpt
    sd = _strip_module_prefix(ckpt["model_state_dict"])
    cfg = baseline_config_from_ckpt_dict(ckpt.get("config", {}))
    if config_overrides:
        cfg = cfg.replace(**config_overrides)
    enc_sd = {k[len("encoder."):]: v for k, v in sd.items()
              if k.startswith("encoder.")}
    comp_sd = {k[len("compression."):]: v for k, v in sd.items()
               if k.startswith("compression.")}
    if not enc_sd or not comp_sd or "classifier.weight" not in sd:
        raise ValueError(
            f"{src} is not a reference baseline checkpoint "
            "(need encoder.* / compression.* / classifier.*)")
    enc_cfg, _ = _resolve_encoder(encoder_init, hf_config, cfg.model_name,
                                  need_weights=False)
    weights = {"encoder": convert_encoder_state_dict(enc_sd, enc_cfg),
               "compression": convert_compression_state_dict(comp_sd),
               "classifier": {"weight": _f32(sd["classifier.weight"]),
                              "bias": _f32(sd["classifier.bias"])}}
    trainer = BaselineTrainer(cfg, enc_cfg, weights, device="cpu")
    metrics = {k: ckpt[k] for k in ("epoch", "best_eer", "train_loss",
                                    "dev_loss") if k in ckpt}
    metrics["converted_from"] = os.path.abspath(src)
    return ckpt_mod.save_checkpoint(out_dir, name, trainer.state_dict(),
                                    cfg.ckpt_config(), metrics,
                                    trainer._sidecar_extra())


def convert_reference_checkpoint(src: str, out_dir: str, kind: str = "auto",
                                 encoder_init: Optional[str] = None,
                                 hf_config: Optional[str] = None,
                                 name: Optional[str] = None
                                 ) -> Tuple[str, str]:
    """-> (kind, checkpoint base path): detect the .pt's format and
    convert it."""
    ckpt = _load_pt(src)
    if kind == "auto":
        kind = detect_kind(ckpt)
    if kind == "stage1":
        path = convert_stage1_checkpoint(src, out_dir, encoder_init,
                                         hf_config, name=name or "best",
                                         ckpt=ckpt)
    elif kind == "stage2":
        path = convert_stage2_checkpoint(src, out_dir,
                                         name=name or STAGE2_BEST, ckpt=ckpt)
    elif kind == "baseline":
        path = convert_baseline_checkpoint(src, out_dir, encoder_init,
                                           hf_config,
                                           name=name or "baseline_best",
                                           ckpt=ckpt)
    else:
        raise ValueError(f"unknown kind {kind!r}")
    return kind, path


# ----------------------------------------------- export (the inverse leg)
def reference_encoder_state_dict(enc_config: Wav2Vec2Config,
                                 state_dict: Mapping[str, torch.Tensor],
                                 prefix: str = "model."
                                 ) -> Dict[str, torch.Tensor]:
    """The port encoder's state dict -> the reference wrapper's: HF keys
    under `prefix`, the positional conv as weight_g/weight_v, fp32."""
    from .export_hf import export_hf_state_dict

    return {prefix + k: torch.from_numpy(v)
            for k, v in export_hf_state_dict(enc_config, state_dict).items()}


def export_stage1_checkpoint(src_dir: str, out_pt: str,
                             name: str = "best") -> str:
    """A port stage-1 checkpoint -> the reference's stage-1 .pt (with
    `encoder_state_dict` when the encoder was finetuned)."""
    sidecar = ckpt_mod.load_sidecar(src_dir, name)
    extra, metrics = sidecar["extra"], sidecar.get("metrics") or {}
    parts = ckpt_mod.restore_parts(src_dir, name, ("encoder", "compression"))
    comp = parts["compression"]
    out = {
        "epoch": metrics.get("epoch", 0),
        "compression_state_dict": {
            "mlp3.weight": comp["proj.weight"].float().contiguous(),
            "mlp3.bias": comp["proj.bias"].float().contiguous()},
        "train_loss": metrics.get("train_loss"),
        "dev_loss": metrics.get("dev_loss"),
        "config": sidecar.get("config") or {},
    }
    if extra["stage1_config"]["finetune_encoder"]:
        out["encoder_state_dict"] = reference_encoder_state_dict(
            config_from_dict(extra["enc_config"]), parts["encoder"])
    os.makedirs(os.path.dirname(os.path.abspath(out_pt)), exist_ok=True)
    torch.save(out, out_pt)
    return out_pt


def export_stage2_checkpoint(src_dir: str, out_pt: str,
                             name: str = STAGE2_BEST) -> str:
    """A port stage-2 head checkpoint -> the reference's head .pt."""
    params, sidecar = ckpt_mod.restore_checkpoint(src_dir, name)
    metrics = sidecar.get("metrics") or {}

    def t(x):
        return x.float().contiguous()

    if "fc.weight" in params:
        sd = {"fc.weight": t(params["fc.weight"]),
              "fc.bias": t(params["fc.bias"])}
    elif "fc1.weight" in params:
        sd = {"net.0.weight": t(params["fc1.weight"]),
              "net.0.bias": t(params["fc1.bias"]),
              "net.3.weight": t(params["fc2.weight"]),
              "net.3.bias": t(params["fc2.bias"])}
    else:
        raise ValueError(f"unrecognized stage-2 head params: {sorted(params)}")
    out = {"epoch": metrics.get("epoch", 0), "model_state_dict": sd,
           **{k: metrics.get(k) for k in ("train_loss", "dev_loss",
                                          "dev_acc", "dev_auc", "dev_eer")},
           "config": sidecar.get("config") or {}}
    os.makedirs(os.path.dirname(os.path.abspath(out_pt)), exist_ok=True)
    torch.save(out, out_pt)
    return out_pt


def export_baseline_checkpoint(src_dir: str, out_pt: str,
                               name: str = "baseline_best") -> str:
    """A port baseline checkpoint -> the reference's whole-model .pt,
    which its End2EndBCEModel loads."""
    sidecar = ckpt_mod.load_sidecar(src_dir, name)
    extra, metrics = sidecar["extra"], sidecar.get("metrics") or {}
    parts = ckpt_mod.restore_parts(src_dir, name,
                                   ("encoder", "compression", "classifier"))
    sd = reference_encoder_state_dict(config_from_dict(extra["enc_config"]),
                                      parts["encoder"],
                                      prefix="encoder.model.")
    comp, cls = parts["compression"], parts["classifier"]
    sd["compression.mlp3.weight"] = comp["proj.weight"].float().contiguous()
    sd["compression.mlp3.bias"] = comp["proj.bias"].float().contiguous()
    sd["classifier.weight"] = cls["weight"].float().contiguous()
    sd["classifier.bias"] = cls["bias"].float().contiguous()
    out = {"epoch": metrics.get("epoch", 0), "model_state_dict": sd,
           **{k: metrics.get(k) for k in ("best_eer", "train_loss",
                                          "dev_loss")},
           "config": sidecar.get("config") or {}}
    os.makedirs(os.path.dirname(os.path.abspath(out_pt)), exist_ok=True)
    torch.save(out, out_pt)
    return out_pt


def export_reference_checkpoint(src_dir: str, out_pt: str,
                                kind: str = "auto",
                                name: Optional[str] = None
                                ) -> Tuple[str, str]:
    """-> (kind, .pt path): the inverse of convert_reference_checkpoint."""
    defaults = {"stage1": "best", "stage2": STAGE2_BEST,
                "baseline": "baseline_best"}
    if kind == "auto":
        if name is not None:
            raise ValueError("--name requires an explicit --kind")
        for k, default in defaults.items():
            if ckpt_mod.checkpoint_exists(src_dir, default):
                kind = k
                break
        else:
            raise FileNotFoundError(
                f"no best/stage2_binary_head_best/baseline_best checkpoint "
                f"under {src_dir}")
    fn = {"stage1": export_stage1_checkpoint,
          "stage2": export_stage2_checkpoint,
          "baseline": export_baseline_checkpoint}.get(kind)
    if fn is None:
        raise ValueError(f"unknown kind {kind!r}")
    return kind, fn(src_dir, out_pt, name=name or defaults[kind])
