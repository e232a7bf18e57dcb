"""2-D embedding visualization (UMAP with PCA fallback).

The port's copy of wav2vec_contr_loss_tpu/viz/umap_plots.py. matplotlib
is imported inside the plotting function; where it is missing (the GPU
machine has none) the call raises an ImportError that names
`--skip_plots`, so a pipeline never drops its plots silently.

Parity with the reference's plotting stack
(reference: plot_stage1_umap_asv.py:128-321, plot_stage1_umap_itw.py,
plot_subspace_umap_*.py): embeddings -> 2-D projection (umap-learn,
n_neighbors 15, min_dist 0.1, fixed seed) -> matplotlib PNG colored by
attack type or real-vs-spoof, with 'Real' forced to blue; plotly HTML is
written too when plotly is importable.

umap-learn/plotly are not in this image, so the projection falls back to a
seeded PCA when umap is unavailable — same API, runnable anywhere.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["project_2d", "plot_embeddings_2d", "import_pyplot"]

REAL_COLOR = "#1f77b4"  # 'Real' forced blue (reference: plot_stage1_umap_asv.py)


def import_pyplot(what: str):
    """matplotlib.pyplot on the Agg backend, or an ImportError that says
    how to run without `what`."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            f"{what} need matplotlib, which is not installed; install it, "
            f"or pass --skip_plots to run_pipeline (or drop --det from "
            f"eval_scores) to run without them") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def project_2d(
    embeddings: np.ndarray,
    n_neighbors: int = 15,
    min_dist: float = 0.1,
    seed: int = 1337,
) -> np.ndarray:
    """(N, D) -> (N, 2): UMAP when available, else seeded PCA."""
    try:
        import umap  # optional

        reducer = umap.UMAP(
            n_neighbors=n_neighbors, min_dist=min_dist, n_components=2,
            random_state=seed,
        )
        return np.asarray(reducer.fit_transform(embeddings))
    except ImportError:
        x = np.asarray(embeddings, np.float64)
        x = x - x.mean(axis=0)
        # deterministic PCA via SVD (seeded sign convention)
        _, _, vt = np.linalg.svd(x, full_matrices=False)
        comps = vt[:2]
        signs = np.sign(comps[np.arange(2), np.abs(comps).argmax(axis=1)])
        return x @ (comps * signs[:, None]).T


def plot_embeddings_2d(
    embeddings: np.ndarray,
    labels: Sequence,
    out_png: str,
    title: str = "Stage-1 embeddings",
    label_names: Optional[Dict] = None,
    out_html: Optional[str] = None,
    seed: int = 1337,
) -> str:
    """Scatter the 2-D projection colored per label; writes PNG (+ optional
    plotly HTML). `labels` may be ints (attack ids) or strings."""
    plt = import_pyplot("the embedding plots")

    pts = project_2d(embeddings, seed=seed)
    labels = np.asarray(labels)
    names = {k: (label_names or {}).get(k, str(k)) for k in np.unique(labels)}

    fig, ax = plt.subplots(figsize=(9, 7))
    cmap = plt.get_cmap("tab20")
    for i, key in enumerate(sorted(names, key=str)):
        m = labels == key
        name = names[key]
        color = REAL_COLOR if name.lower() in ("real", "bonafide") else cmap(i % 20)
        ax.scatter(pts[m, 0], pts[m, 1], s=4, alpha=0.6, label=name, color=color)
    ax.set_title(title)
    ax.legend(markerscale=3, fontsize=8, loc="best")
    os.makedirs(os.path.dirname(os.path.abspath(out_png)), exist_ok=True)
    fig.savefig(out_png, dpi=150, bbox_inches="tight")
    plt.close(fig)

    if out_html:
        try:
            import plotly.express as px  # optional

            fig2 = px.scatter(
                x=pts[:, 0], y=pts[:, 1],
                color=[names[k] for k in labels], title=title,
            )
            fig2.write_html(out_html)
        except ImportError:
            pass
    return out_png
