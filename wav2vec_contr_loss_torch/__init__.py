"""PyTorch / CUDA port of wav2vec_contr_loss_tpu for an NVIDIA H100.

It serves (`SpoofScorer`, also from a stage-1 and a stage-2
checkpoint), runs the stage-1 SupCon recipe (`Stage1Trainer`: the train
step with device RawBoost, `fit` with checkpoints and resume, fed by the
host data pipeline in `data/`) and the inference half of the main path
(`Stage1Trainer.embed_dataset` and `eval/extract.py`, the stage-2 head
trainer in `train/stage2.py`, score files and EER in `eval/`), the
end-to-end BCE baseline (`BaselineTrainer`) and stage 1 from
precomputed encoder features (`Stage1Trainer.fit_from_features`), with the
CLIs under `cli/` up to `python -m
wav2vec_contr_loss_torch.cli.run_pipeline`, and serves int8
(`quantize=`) and from a self-contained `torch.export` artifact
(`SpoofScorer.export`, `eval.artifact.load_exported`). It imports
torch, numpy and scipy (and triton, inside the Triton kernels' launch
functions), never JAX or the JAX package. Entry points run on the GPU
unless the caller passes device="cpu"; on CPU tensors every kernel
wrapper takes its plain PyTorch version.
"""

import importlib

# name -> the submodule that defines it; imported at first use, so that
# loading a serving artifact (eval/artifact.py) imports no model code
_EXPORTS = {
    "jax_params_to_torch": "bridge",
    **{name: "config" for name in (
        "LARGE_960H", "XLSR_300M", "BaselineConfig", "Stage1Config",
        "Stage2Config", "SupConConfig", "Wav2Vec2Config", "config_from_dict",
        "feature_frame_length")},
    "SpoofScorer": "eval.serving",
    "window_waveform": "eval.serving",
    "BaselineTrainer": "train",
    "Stage1Trainer": "train",
    "alpha_for_epoch": "train",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                   name)
