"""EER / min-tDCF evaluation CLI over CM score files — replaces the
reference's notebook + empty eer_from_scores.py
(reference: eval_eer_score_file.ipynb, evaluation.py).

    python -m wav2vec_contr_loss_torch.cli.eval_scores SCORE_FILE_OR_DIR ...

The port's copy of wav2vec_contr_loss_tpu/cli/eval_scores.py, on the
host only (numpy; --det also needs matplotlib and scipy and raises an
ImportError without them)."""

from __future__ import annotations

import argparse

import numpy as np

from ..eval.metrics import (
    ASVSPOOF2019_COST_MODEL,
    asv_operating_point_from_scores,
    bootstrap_eer_ci,
    calculate_eer_from_file,
    compute_eer,
    compute_tdcf,
    read_asv_score_file,
    threshold_at_far,
)
from ..eval.score import read_score_file


def _expand_trees(paths):
    """Directories expand to every score_cm_*.txt underneath (the whole
    scores/<exp>/<model>/ tree in one report, like the reference's
    eval_eer_score_file.ipynb table)."""
    import glob
    import os

    out = []
    for p in paths:
        if os.path.isdir(p):
            out += sorted(glob.glob(os.path.join(p, "**", "score_cm_*.txt"),
                                    recursive=True))
        else:
            out.append(p)
    return out


def _attack_breakdown(rec, protocol: str) -> list:
    """Per-attack EER rows for a score file whose lines are in protocol
    order (the contract of cli.generate_scores: utt ids are synthetic
    `<prefix>_%06d` in dataset order, which IS protocol line order —
    reference: generate_eval_score_file.py:149-166). Each spoof attack is
    scored against ALL bonafide trials, the standard ASVspoof per-attack
    pooling."""
    from ..data.protocols import parse_asvspoof2019

    ds = parse_asvspoof2019(protocol)
    if len(ds.utterances) != len(rec):
        raise SystemExit(
            f"--by_attack: protocol has {len(ds.utterances)} trials but the "
            f"score file has {len(rec)} lines — per-attack pairing is "
            "positional and needs the full, unsubsampled split")
    idx_to_attack = {v: k for k, v in ds.attack_to_idx.items()}
    multi = ds.multi_labels
    keys_match = (multi == 0) == (rec.keys == "bonafide")
    if not keys_match.all():
        bad = int(np.argmin(keys_match))
        raise SystemExit(
            f"--by_attack: bonafide/spoof keys disagree between protocol and "
            f"score file at line {bad} — wrong protocol for this score file?")
    bona = rec.bonafide_scores
    rows = []
    for a in sorted(idx_to_attack):
        if a == 0:
            continue
        scores_a = rec.scores[multi == a]
        eer = compute_eer(bona, scores_a)[0] * 100.0
        rows.append((idx_to_attack[a], int(scores_a.size), eer))
    return rows


# Validated categorical palette (fixed assignment order, never cycled):
# adjacent-pair CVD dE >= 9.1 and normal-vision dE >= 19.6 on a light
# surface. More curves than slots fold into one report per chart instead.
_DET_SERIES = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100",
               "#e87ba4", "#008300", "#4a3aa7", "#e34948"]
_INK, _INK_2, _GRID = "#0b0b0b", "#52514e", "#e4e3e0"


def _det_labels(paths) -> list:
    """Compact per-curve labels: the path with the common prefix and the
    score_cm_/.txt boilerplate stripped (reference layout:
    scores/<exp>/<model>/score_cm_<split>.txt -> '<exp>/<model> <split>')."""
    import os

    common = os.path.commonpath(paths) if len(paths) > 1 else ""
    out = []
    for p in paths:
        rel = os.path.relpath(p, common) if common else os.path.basename(p)
        rel = rel.replace("score_cm_", "").replace(".txt", "")
        out.append(rel.replace(os.sep + "eval", " eval")
                      .replace(os.sep + "itw", " itw"))
    return out


def _plot_det(curves, out_path: str) -> None:
    """One DET plot (probit axes, the ASVspoof convention) over every
    scored file; EER points marked on the miss==fa diagonal. The stdout
    EER table is the accessible companion to the figure."""
    from ..viz import import_pyplot

    plt = import_pyplot("--det plots")
    try:
        from scipy.stats import norm
    except ImportError as e:
        raise ImportError("--det needs scipy for its probit axes, which is "
                          "not installed; drop --det") from e

    if len(curves) > len(_DET_SERIES):
        raise SystemExit(
            f"--det: {len(curves)} score files but at most "
            f"{len(_DET_SERIES)} distinguishable curves per plot — split "
            "the input into multiple --det invocations")
    lo, hi = 0.05e-2, 0.6  # plotted rate range: 0.05% .. 60%
    ticks = np.array([0.1, 0.2, 0.5, 1, 2, 5, 10, 20, 40]) / 100.0
    fig, ax = plt.subplots(figsize=(6.0, 5.6), dpi=150)
    for (label, frr, far, eer), color in zip(curves, _DET_SERIES):
        keep = (far > 0) & (frr > 0)
        x = norm.ppf(np.clip(far[keep], lo, hi))
        y = norm.ppf(np.clip(frr[keep], lo, hi))
        ax.plot(x, y, color=color, linewidth=2, label=label)
        e = norm.ppf(np.clip(eer, lo, hi))
        ax.plot(e, e, "o", color=color, markersize=5,
                markeredgecolor="white", markeredgewidth=1)
    diag = norm.ppf(np.array([lo, hi]))
    ax.plot(diag, diag, color=_GRID, linewidth=1, zorder=0)
    tickpos = norm.ppf(ticks)
    for a, setter in ((ax.set_xticks, ax.set_xticklabels),
                      (ax.set_yticks, ax.set_yticklabels)):
        a(tickpos)
        setter([f"{t * 100:g}" for t in ticks])
    ax.set_xlim(norm.ppf(lo), norm.ppf(hi))
    ax.set_ylim(norm.ppf(lo), norm.ppf(hi))
    ax.set_xlabel("False acceptance rate (%)", color=_INK)
    ax.set_ylabel("False rejection rate (%)", color=_INK)
    ax.set_title("DET — countermeasure scores", color=_INK, loc="left")
    ax.grid(True, color=_GRID, linewidth=0.5)
    ax.tick_params(colors=_INK_2, labelsize=8)
    for s in ax.spines.values():
        s.set_color(_GRID)
    if len(curves) > 1:
        ax.legend(fontsize=8, frameon=False, labelcolor=_INK)
    fig.tight_layout()
    fig.savefig(out_path, facecolor="#fcfcfb")
    plt.close(fig)
    print(f"DET plot -> {out_path}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("score_files", nargs="+",
                   help="CM score files, or directories to scan recursively")
    p.add_argument("--tdcf", action="store_true",
                   help="also report min-tDCF; needs the ASV operating "
                        "point from --asv_scores (official usage) or "
                        "--asv_operating_point (explicit escape hatch)")
    p.add_argument("--asv_scores", metavar="FILE", default=None,
                   help="ASV score file (official ASVspoof format: key "
                        "target/nontarget/spoof in the second-to-last "
                        "column, score last); fixes the ASV operating "
                        "point at the ASV system's EER threshold, the "
                        "official t-DCF methodology — min-tDCF values are "
                        "then comparable to published ASVspoof numbers")
    p.add_argument("--asv_operating_point", metavar=("PFA", "PMISS",
                                                     "PMISS_SPOOF"),
                   type=float, nargs=3, default=None,
                   help="explicit (pfa_asv, pmiss_asv, pmiss_spoof_asv) "
                        "fractions when no ASV score file is available; "
                        "min-tDCF at an invented operating point is NOT "
                        "comparable to published numbers")
    p.add_argument("--bootstrap", type=int, default=0, metavar="N",
                   help="also report a seeded N-replicate bootstrap 95%% CI")
    p.add_argument("--seed", type=int, default=1337,
                   help="bootstrap resampling seed")
    p.add_argument("--by_attack", metavar="PROTOCOL", default=None,
                   help="ASVspoof2019 protocol file paired positionally with "
                        "the score lines: adds a per-attack EER table")
    p.add_argument("--det", metavar="OUT.png", default=None,
                   help="save one DET plot (probit axes) over all score files")
    p.add_argument("--operating_point", metavar="FAR%", type=float,
                   action="append", default=None,
                   help="report the deployment threshold (for e.g. "
                        "serve --threshold) and its FRR at this FAR budget "
                        "(percent; repeatable). The EER threshold is always "
                        "included")
    args = p.parse_args(argv)

    asv_point = None
    if not args.tdcf and (args.asv_scores is not None
                          or args.asv_operating_point is not None):
        p.error("--asv_scores/--asv_operating_point only make sense with "
                "--tdcf (did you forget it?)")
    if args.tdcf:
        if (args.asv_scores is None) == (args.asv_operating_point is None):
            p.error("--tdcf needs exactly one of --asv_scores (official "
                    "ASV-EER operating point) or --asv_operating_point "
                    "PFA PMISS PMISS_SPOOF")
        if args.asv_scores is not None:
            tar, non, spoof = read_asv_score_file(args.asv_scores)
            pfa, pmiss, pmiss_spoof, eer_asv, thr = (
                asv_operating_point_from_scores(tar, non, spoof))
            print(f"{args.asv_scores}: ASV EER = {eer_asv * 100:.3f}% "
                  f"(threshold {thr:.6f}) -> operating point "
                  f"pfa={pfa:.6f} pmiss={pmiss:.6f} "
                  f"pmiss_spoof={pmiss_spoof:.6f}")
            asv_point = (pfa, pmiss, pmiss_spoof)
        else:
            asv_point = tuple(args.asv_operating_point)

    det_curves, det_paths = [], []
    for path in _expand_trees(args.score_files):
        eer = calculate_eer_from_file(path)
        line = f"{path}: EER = {eer:.3f}%"
        rec = None
        if (args.tdcf or args.bootstrap or args.by_attack or args.det
                or args.operating_point):
            rec = read_score_file(path)
        if args.det:
            from ..eval.metrics import compute_det_curve

            frr, far, _ = compute_det_curve(rec.bonafide_scores,
                                            rec.spoof_scores)
            det_curves.append((frr, far, eer / 100.0))
            det_paths.append(path)
        if args.bootstrap:
            lo, hi = bootstrap_eer_ci(rec.bonafide_scores, rec.spoof_scores,
                                      n_boot=args.bootstrap, seed=args.seed)
            line += f" | 95% CI [{lo * 100:.3f}, {hi * 100:.3f}]%"
        if args.tdcf:
            tdcf, _ = compute_tdcf(
                rec.bonafide_scores, rec.spoof_scores, *asv_point,
                ASVSPOOF2019_COST_MODEL,
            )
            line += f" | min-tDCF = {float(tdcf.min()):.5f}"
        print(line)
        if args.operating_point is not None:
            _, eer_thr = compute_eer(rec.bonafide_scores, rec.spoof_scores)
            print(f"  threshold @ EER: {eer_thr:.6f}")
            for far_pct in args.operating_point:
                thr, frr, far = threshold_at_far(
                    rec.bonafide_scores, rec.spoof_scores, far_pct / 100.0)
                print(f"  threshold @ FAR<={far_pct:g}%: {thr:.6f}  "
                      f"(FRR = {frr * 100:.3f}%, FAR = {far * 100:.3f}%)")
        if args.by_attack:
            for attack, n, a_eer in _attack_breakdown(rec, args.by_attack):
                print(f"  {attack}: EER = {a_eer:.3f}%  (n={n})")
    if args.det and det_curves:
        labels = _det_labels(det_paths)
        _plot_det([(lab,) + c for lab, c in zip(labels, det_curves)],
                  args.det)


if __name__ == "__main__":
    main()
