"""One entry point: `python -m wav2vec_contr_loss_torch <command> ...`.

`python -m wav2vec_contr_loss_torch serve ...` is
`python -m wav2vec_contr_loss_torch.cli.serve ...`: the dispatch of the
JAX package's __main__.py, listing the commands the port has. Commands
are imported when run, so the listing loads no model code.
"""

from __future__ import annotations

import importlib
import sys

# command -> one-line help, in the order of the help
COMMANDS = {
    "train_stage1": "stage-1 SupCon finetune or frozen training",
    "train_stage2": "stage-2 head training on extracted embeddings",
    "train_baseline": "end-to-end BCE baseline training",
    "extract_embeddings": "stage-1 clip embeddings -> .npy",
    "extract_encoder_features": "raw encoder layer-mean features -> memmap .npy",
    "generate_scores": "stage-2 scores over saved embeddings -> CM score file",
    "score_baseline": "baseline model scores from audio -> CM score file",
    "score_famous_figures": "FamousFigures end-to-end scoring",
    "eval_scores": "EER / min-tDCF from score files",
    "plot_umap": "UMAP plots of stage-1 / subspace embeddings",
    "run_pipeline": "train -> extract -> stage 2 -> score -> EER",
    "run_sweep": "run_pipeline over the experiment presets",
    "serve": "scoring daemon (paths on stdin or a TCP socket -> scores)",
    "export_serving": "self-contained serving artifact via torch.export",
    "convert_hf_checkpoint": "local HF wav2vec2 snapshot -> port encoder weights",
    "convert_reference_checkpoint": "reference .pt (stage-1 / stage-2 / baseline) -> port checkpoints",
    "export_reference_checkpoint": "port checkpoint -> reference .pt (stage-1 / stage-2 / baseline)",
    "export_hf_checkpoint": "port encoder -> HF snapshot directory",
    "verify_parity": "score-file EERs against the reference's committed results",
    "bench_components": "component micro-benchmarks (decode, RawBoost, SupCon, serving, extraction, socket)",
    "cache_waveforms": "prebuild the decode-once waveform cache for a protocol",
    "doctor": "environment check (card, kernel builds, decoder, forward, checkpoints, cache)",
}


def _usage() -> str:
    width = max(len(c) for c in COMMANDS)
    lines = [f"  {c:<{width}}  {h}" for c, h in COMMANDS.items()]
    return ("usage: python -m wav2vec_contr_loss_torch <command> [args...]\n\n"
            "commands:\n" + "\n".join(lines) + "\n\n"
            "`<command> --help` shows that command's flags. Each command is "
            "also\n`python -m wav2vec_contr_loss_torch.cli.<command>`.")


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "--list"):
        print(_usage())
        return
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command: {cmd!r}\n\n{_usage()}", file=sys.stderr)
        raise SystemExit(2)
    importlib.import_module(f"{__package__}.cli.{cmd}").main(argv[1:])


if __name__ == "__main__":
    main()
