"""Embedding and model-output analysis and plots.

Port of `evstore_tpu/tools/visualize.py`.  Reference: tools/visualize.py
(1030 LoC): UMAP/t-SNE projections of embedding tables
(visualize_embeddings_umap:82), categorical count analysis, HDBSCAN
clustering of model outputs, and the combined analyze_model_data(:856)
report.  sklearn gives t-SNE, HDBSCAN and the kNN, UMAP is used when it
imports, and everything falls back to NumPy (PCA, Lloyd's k-means, a
brute-force kNN over 512 rows).  A CLI (`python -m
evstore_tpu_torch.tools.visualize`) runs the analyses over EV-table .bin
exports and traced workloads and writes the plots; without matplotlib it
writes the report alone and says so, as it says which fallbacks ran.
"""

from __future__ import annotations

import importlib
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np


# ---------------------------------------------------------- projections

def pca_project(rows: np.ndarray, n_components: int = 2,
                center: bool = True) -> np.ndarray:
    """[N, D] -> [N, n_components] principal-component projection."""
    x = np.asarray(rows, np.float64)
    if center:
        x = x - x.mean(axis=0, keepdims=True)
    # SVD on the covariance-free thin form
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    return (x @ vt[:n_components].T).astype(np.float32)


def project_embeddings(rows: np.ndarray, method: str = "auto",
                       n_components: int = 2, seed: int = 0) -> np.ndarray:
    """umap | tsne | pca | auto (best available) — visualize.py's
    visualize_embeddings_umap equivalent."""
    if method in ("umap", "auto"):
        try:
            import umap
            return umap.UMAP(n_components=n_components,
                             random_state=seed).fit_transform(rows)
        except ImportError:
            if method == "umap":
                raise
    if method in ("tsne", "auto"):
        try:
            from sklearn.manifold import TSNE
            perp = min(30.0, max(2.0, len(rows) / 4))
            return TSNE(n_components=n_components, random_state=seed,
                        perplexity=perp, init="pca").fit_transform(
                np.asarray(rows, np.float32))
        except ImportError:
            if method == "tsne":
                raise
    return pca_project(rows, n_components)


# ------------------------------------------------- categorical analysis

def categorical_counts(idx: np.ndarray, table_sizes: Sequence[int]
                       ) -> List[Dict[str, float]]:
    """Per-table access statistics over a [N, T] index log
    (visualize.py's analyze-categorical-counts)."""
    out = []
    for t, n in enumerate(table_sizes):
        col = idx[:, t]
        uniq, counts = np.unique(col, return_counts=True)
        sorted_counts = np.sort(counts)[::-1]
        csum = np.cumsum(sorted_counts) / max(col.size, 1)
        out.append({
            "table": t,
            "rows": int(n),
            "distinct_accessed": int(len(uniq)),
            "coverage": len(uniq) / max(n, 1),
            "top1_share": float(sorted_counts[0] / col.size) if col.size else 0,
            "rows_for_50pct": int(np.searchsorted(csum, 0.5) + 1),
            "rows_for_90pct": int(np.searchsorted(csum, 0.9) + 1),
            "zipf_alpha": zipf_fit(sorted_counts),
        })
    return out


def zipf_fit(sorted_counts: np.ndarray) -> float:
    """Power-law exponent estimate from a descending count vector: the
    OLS slope of log(count) on log(rank) (the tail heaviness the cache
    tiers exploit; matches the reference's frequency-rank plots)."""
    c = np.asarray(sorted_counts, np.float64)
    c = c[c > 0]
    if len(c) < 3:
        return float("nan")
    r = np.arange(1, len(c) + 1, dtype=np.float64)
    lx, ly = np.log(r), np.log(c)
    lx = lx - lx.mean()
    return float(-np.dot(lx, ly - ly.mean()) / np.dot(lx, lx))


# ----------------------------------------------------------- clustering

def kmeans(x: np.ndarray, k: int, n_iter: int = 50, seed: int = 0
           ) -> np.ndarray:
    """Plain Lloyd's k-means labels (dependency-free fallback)."""
    rng = np.random.default_rng(seed)
    x = np.asarray(x, np.float64)
    centers = x[rng.choice(len(x), size=min(k, len(x)), replace=False)]
    labels = np.zeros(len(x), np.int32)
    for _ in range(n_iter):
        d = ((x[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        new_labels = d.argmin(axis=1).astype(np.int32)
        if np.array_equal(new_labels, labels):
            break
        labels = new_labels
        for c in range(len(centers)):
            m = labels == c
            if m.any():
                centers[c] = x[m].mean(axis=0)
    return labels


def density_cluster(x: np.ndarray, min_cluster_size: int = 16,
                    method: str = "auto") -> np.ndarray:
    """Density clustering of embeddings/model outputs (the reference runs
    HDBSCAN over model outputs, visualize.py).  hdbscan | sklearn-HDBSCAN |
    k-means fallback; noise points get label -1."""
    if method in ("hdbscan", "auto"):
        try:
            import hdbscan
            return hdbscan.HDBSCAN(
                min_cluster_size=min_cluster_size).fit_predict(x)
        except ImportError:
            pass
        try:
            from sklearn.cluster import HDBSCAN
            return HDBSCAN(min_cluster_size=min_cluster_size).fit_predict(
                np.asarray(x, np.float64))
        except ImportError:
            if method == "hdbscan":
                raise
    k = max(2, len(x) // max(min_cluster_size, 1))
    return kmeans(x, min(k, 64))


def cluster_summary(labels: np.ndarray, y: Optional[np.ndarray] = None
                    ) -> Dict:
    """Cluster census (+ per-cluster positive rate when labels given)."""
    labels = np.asarray(labels)
    uniq, counts = np.unique(labels, return_counts=True)
    out = {"n_clusters": int((uniq >= 0).sum()),
           "noise_frac": float((labels < 0).mean()),
           "sizes": {int(u): int(c) for u, c in zip(uniq, counts)}}
    if y is not None:
        y = np.asarray(y).ravel()
        out["positive_rate"] = {
            int(u): float(y[labels == u].mean()) for u in uniq}
    return out


# --------------------------------------------- embedding-space analysis

def embedding_norm_stats(table: np.ndarray) -> Dict:
    """Row-norm distribution of one EV table (trained rows grow norms with
    access frequency — the effect the reference's projections show)."""
    n = np.linalg.norm(np.asarray(table, np.float32), axis=1)
    return {"mean": float(n.mean()), "std": float(n.std()),
            "p50": float(np.percentile(n, 50)),
            "p99": float(np.percentile(n, 99)),
            "max": float(n.max()), "min": float(n.min())}


def neighbor_similarity(table: np.ndarray, sample: int = 1024,
                        n_neighbors: int = 10, seed: int = 0) -> Dict:
    """Nearest-neighbor distance profile of an EV table — the quantity the
    C3 alt-key pipeline exploits (script/approximate_embedding
    get_neighbors_GPU.ipynb: kNN k=11 euclidean).  Reports how close the
    1st/k-th neighbors are relative to the table's row-distance scale: a
    low ratio means alt-key substitution is low-error."""
    rng = np.random.default_rng(seed)
    x = np.asarray(table, np.float32)
    pick = rng.choice(len(x), size=min(sample, len(x)), replace=False)
    try:
        from sklearn.neighbors import NearestNeighbors
        nn = NearestNeighbors(n_neighbors=min(n_neighbors + 1, len(x)),
                              metric="euclidean").fit(x)
        d, _ = nn.kneighbors(x[pick])
        d1, dk = d[:, 1], d[:, -1]
    except ImportError:
        d = np.sqrt(((x[pick][:, None, :] - x[None, :512, :]) ** 2).sum(-1))
        d.sort(axis=1)
        d1, dk = d[:, 1], d[:, min(n_neighbors, d.shape[1] - 1)]
    scale = float(np.linalg.norm(x.std(axis=0)) * np.sqrt(2))
    return {"nn1_mean": float(d1.mean()), "nnk_mean": float(dk.mean()),
            "row_distance_scale": scale,
            "nn1_to_scale": float(d1.mean() / max(scale, 1e-12))}


# ------------------------------------------------- model-output analysis

def analyze_model_outputs(scores: np.ndarray, labels: np.ndarray,
                          n_bins: int = 20) -> Dict:
    """Score-distribution/calibration analysis: per-bin positive rate vs
    mean score + expected calibration error."""
    scores = np.asarray(scores).ravel()
    labels = np.asarray(labels).ravel()
    edges = np.linspace(0, 1, n_bins + 1)
    binid = np.clip(np.digitize(scores, edges) - 1, 0, n_bins - 1)
    rows = []
    for b in range(n_bins):
        m = binid == b
        if m.sum() == 0:
            continue
        rows.append({"bin": b, "n": int(m.sum()),
                     "mean_score": float(scores[m].mean()),
                     "positive_rate": float(labels[m].mean())})
    ece = sum(r["n"] * abs(r["mean_score"] - r["positive_rate"])
              for r in rows) / max(len(scores), 1)
    return {"bins": rows, "ece": float(ece)}


def analyze_model_data(scores: np.ndarray, labels: np.ndarray,
                       features: Optional[np.ndarray] = None,
                       min_cluster_size: int = 32) -> Dict:
    """The combined report (≙ visualize.py analyze_model_data:856):
    calibration + score-distribution stats + density clusters of the
    feature space with per-cluster positive rates."""
    scores = np.asarray(scores).ravel()
    labels = np.asarray(labels).ravel()
    rep = {"calibration": analyze_model_outputs(scores, labels),
           "score_stats": {
               "mean": float(scores.mean()), "std": float(scores.std()),
               "pos_mean": float(scores[labels > 0.5].mean())
               if (labels > 0.5).any() else float("nan"),
               "neg_mean": float(scores[labels <= 0.5].mean())
               if (labels <= 0.5).any() else float("nan")}}
    if features is not None:
        cl = density_cluster(np.asarray(features, np.float32),
                             min_cluster_size=min_cluster_size)
        rep["clusters"] = cluster_summary(cl, labels)
    return rep


# ----------------------------------------------------------------- plots

def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None without it."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def have(module: str) -> bool:
    """Whether `module` imports."""
    try:
        importlib.import_module(module)
    except ImportError:
        return False
    return True


def plot_projection(points: np.ndarray, out_png: str,
                    color: Optional[np.ndarray] = None,
                    title: str = "embedding projection") -> Optional[str]:
    """The PNG's path, or None without matplotlib (as the other plots)."""
    plt = _pyplot()
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(6, 5))
    sc = ax.scatter(points[:, 0], points[:, 1], s=4,
                    c=None if color is None else np.asarray(color),
                    cmap="viridis", alpha=0.7)
    if color is not None:
        fig.colorbar(sc, ax=ax)
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out_png


def plot_count_ranks(idx: np.ndarray, out_png: str,
                     tables: Optional[Sequence[int]] = None
                     ) -> Optional[str]:
    """log-log frequency-vs-rank per table (the zipf plot)."""
    plt = _pyplot()
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(6, 5))
    T = idx.shape[1]
    for t in (tables if tables is not None else range(min(T, 8))):
        _, counts = np.unique(idx[:, t], return_counts=True)
        c = np.sort(counts)[::-1]
        ax.loglog(np.arange(1, len(c) + 1), c, label=f"table {t}", lw=1)
    ax.set_xlabel("rank")
    ax.set_ylabel("access count")
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out_png


def plot_calibration(report: Dict, out_png: str) -> Optional[str]:
    plt = _pyplot()
    if plt is None:
        return None
    bins = report["bins"]
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.plot([0, 1], [0, 1], "k--", lw=1)
    ax.plot([b["mean_score"] for b in bins],
            [b["positive_rate"] for b in bins], "o-")
    ax.set_xlabel("mean predicted score")
    ax.set_ylabel("positive rate")
    ax.set_title(f"calibration (ECE {report['ece']:.4f})")
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out_png


# ------------------------------------------------------------------- CLI

def main(argv=None) -> int:
    """Analyze EV-table exports and/or traced workloads.

    python -m evstore_tpu_torch.tools.visualize --ev-table-path DIR \
        --dim 36 --table-sizes 100-200 --out-dir out/ [--project tsne] \
        [--sample 2000]
    python -m evstore_tpu_torch.tools.visualize --trace-npz trace.npz \
        --out-dir out/
    """
    import argparse
    from evstore_tpu_torch.cache.storage import FileStore
    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--ev-table-path", type=str, default="")
    p.add_argument("--dim", type=int, default=36)
    p.add_argument("--table-sizes", type=str, default="")
    p.add_argument("--trace-npz", type=str, default="",
                   help="npz with idx [N, T] (and optional scores/labels)")
    p.add_argument("--project", type=str, default="auto",
                   choices=["auto", "umap", "tsne", "pca"])
    p.add_argument("--sample", type=int, default=2000)
    p.add_argument("--table", type=int, default=0)
    p.add_argument("--out-dir", type=str, default="viz_out")
    args = p.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    report = {}
    if not have("matplotlib"):
        print("matplotlib is not installed: no plots, the report only")

    if args.ev_table_path:
        sizes = [int(x) for x in args.table_sizes.split("-")]
        fs = FileStore(args.ev_table_path, sizes, args.dim)
        t = args.table
        n = min(args.sample, sizes[t])
        rows = fs.get_batch([(t, r) for r in range(n)])
        fs.close()
        report["norms"] = embedding_norm_stats(rows)
        if not have("sklearn"):
            print("sklearn is not installed: the neighbours among the "
                  "first 512 rows (the NumPy fallback)")
        report["neighbors"] = neighbor_similarity(rows)
        if args.project == "auto" and not have("umap") \
                and not have("sklearn"):
            print("umap and sklearn are not installed: the PCA projection "
                  "(the NumPy fallback)")
        pts = project_embeddings(rows, method=args.project)
        plot_projection(pts, os.path.join(args.out_dir,
                                          f"table{t}_projection.png"),
                        title=f"table {t} ({args.project})")

    if args.trace_npz:
        z = np.load(args.trace_npz)
        idx = z["idx"]
        sizes = [int(idx[:, t].max()) + 1 for t in range(idx.shape[1])]
        report["categorical"] = categorical_counts(idx, sizes)
        plot_count_ranks(idx, os.path.join(args.out_dir, "count_ranks.png"))
        if "scores" in z and "labels" in z:
            rep = analyze_model_data(z["scores"], z["labels"])
            report["model"] = rep
            plot_calibration(rep["calibration"],
                             os.path.join(args.out_dir, "calibration.png"))

    out = os.path.join(args.out_dir, "report.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=1, default=float)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
