"""2-D plots of clip embeddings."""

from .umap_plots import import_pyplot, plot_embeddings_2d, project_2d

__all__ = ["import_pyplot", "plot_embeddings_2d", "project_2d"]
