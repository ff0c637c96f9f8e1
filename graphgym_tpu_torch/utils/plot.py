"""Embedding visualization utilities (the port's copy of
graphgym_tpu/utils/plot.py; reference utils/plot.py:13-36): project node
embeddings to 2-D (PCA, numpy-native) and save a scatter plot colored by
label.  Gated by cfg.view_emb in the reference."""

from __future__ import annotations

import os

import numpy as np


def pca_project(x: np.ndarray, dim: int = 2) -> np.ndarray:
    x = np.asarray(x, np.float64)
    x = x - x.mean(0)
    # SVD-based PCA
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    return x @ vt[:dim].T


def tsne_project(x: np.ndarray, dim: int = 2) -> np.ndarray:
    """t-SNE projection (reference utils/plot.py:5 imports
    sklearn.manifold.TSNE); falls back to PCA when sklearn is absent."""
    try:
        from sklearn.manifold import TSNE
    except ImportError:
        return pca_project(x, dim)
    n = np.asarray(x).shape[0]
    perplexity = min(30.0, max(2.0, (n - 1) / 3.0))
    return TSNE(n_components=dim, perplexity=perplexity,
                init="pca", random_state=0).fit_transform(
                    np.asarray(x, np.float64))


def view_emb(emb: np.ndarray, labels: np.ndarray, out_dir: str,
             name: str = "emb", method: str = "pca") -> str:
    """Save a 2-D PCA/t-SNE scatter of embeddings; falls back to a .npz
    dump when matplotlib is unavailable."""
    proj = (tsne_project(emb, 2) if method == "tsne"
            else pca_project(emb, 2))
    os.makedirs(out_dir, exist_ok=True)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 6))
        ax.scatter(proj[:, 0], proj[:, 1], c=np.asarray(labels), s=4,
                   cmap="tab10")
        ax.set_title(name)
        path = os.path.join(out_dir, f"{name}.png")
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path
    except Exception:
        path = os.path.join(out_dir, f"{name}.npz")
        np.savez(path, proj=proj, labels=labels)
        return path
