"""Feature clustering toolkit (port of expecto_tpu/analysis/cluster.py;
reference C24):

- hierarchical clustering of the 20,020 feature columns / 2,002 marks
  (interpret_features.py:99-134, interpret_features_grouped.py:73-162);
- TF-IDF + TruncatedSVD embedding of per-mark spatial tracks
  (svd.py:58-87, svd_transform.py:49-81);
- KMeans (+ optional t-SNE viz coordinates) (cluster_and_viz.py:53-103);
- Louvain community detection over a kNN graph (cluster_and_viz_louvain.py;
  the reference uses Orange3, whose default kNN metric is Euclidean — here a
  self-contained modularity-greedy implementation over a Euclidean
  Gaussian-kernel kNN graph).

scikit-learn is imported inside the functions that use it.
"""

from __future__ import annotations

import numpy as np
import pandas as pd


def hierarchical_feature_clusters(X: np.ndarray, n_clusters: int = 10, n_basis: int = 10) -> np.ndarray:
    """Cluster feature *columns* of (n_genes, n_basis*n_marks) training data;
    returns (n_marks, n_basis) labels (interpret_features.py:116-121)."""
    from sklearn.cluster import AgglomerativeClustering

    labels = AgglomerativeClustering(n_clusters=n_clusters).fit(X.T).labels_
    return labels.reshape(n_basis, -1).transpose(1, 0)


def fit_feature_clustering(X: np.ndarray, *, with_distances: bool = False, cache_dir: str | None = None):
    """Fit the hierarchical-clustering estimator over feature *columns* so it
    can be joblib-dumped and re-cut at different n_clusters
    (interpret_features.py:99-110: full tree cached, or distance_threshold=0
    when dendrogram distances are wanted)."""
    from sklearn.cluster import AgglomerativeClustering

    if with_distances:
        # memory=cache_dir so the mandatory re-cut (cut_feature_clustering)
        # reuses the tree instead of recomputing the full linkage
        est = AgglomerativeClustering(distance_threshold=0, n_clusters=None, memory=cache_dir)
    else:
        est = AgglomerativeClustering(compute_full_tree=True, memory=cache_dir)
    return est.fit(X.T)


def cut_feature_clustering(est, X: np.ndarray, n_clusters: int, n_basis: int = 10) -> np.ndarray:
    """Re-cut a fitted clustering at ``n_clusters``
    (interpret_features.py:119-121); returns (n_marks, n_basis) labels."""
    est.set_params(n_clusters=n_clusters, distance_threshold=None)
    labels = est.fit(X.T).labels_
    return labels.reshape(n_basis, -1).transpose(1, 0)


def _grouped_mark_matrix(X: np.ndarray, n_basis: int = 10) -> np.ndarray:
    """(n_genes, n_basis*n_marks) -> (n_marks, n_genes*n_basis): each mark
    represented by its concatenated basis feature columns
    (interpret_features_grouped.py:72,144-147)."""
    n_marks = X.shape[1] // n_basis
    return X.T.reshape(n_basis, n_marks, -1).transpose(1, 2, 0).reshape(n_marks, -1)


def hierarchical_mark_clusters(X: np.ndarray, n_clusters: int = 110, n_basis: int = 10) -> np.ndarray:
    """Cluster the 2,002 *marks* by concatenating their basis feature columns
    (interpret_features_grouped.py:72,144-147): X (n_genes, n_basis*n_marks)
    -> (n_marks,) labels."""
    from sklearn.cluster import AgglomerativeClustering

    return AgglomerativeClustering(n_clusters=n_clusters).fit(_grouped_mark_matrix(X, n_basis)).labels_


def fit_mark_clustering(X: np.ndarray, n_basis: int = 10, *, with_distances: bool = False, cache_dir: str | None = None):
    """Fit the grouped-mark clustering estimator for joblib reuse
    (interpret_features_grouped.py's --clustering_joblib workflow)."""
    from sklearn.cluster import AgglomerativeClustering

    if with_distances:
        est = AgglomerativeClustering(distance_threshold=0, n_clusters=None, memory=cache_dir)
    else:
        est = AgglomerativeClustering(compute_full_tree=True, memory=cache_dir)
    return est.fit(_grouped_mark_matrix(X, n_basis))


def cut_mark_clustering(est, X: np.ndarray, n_clusters: int, n_basis: int = 10) -> np.ndarray:
    """Re-cut a fitted grouped-mark clustering at ``n_clusters``."""
    est.set_params(n_clusters=n_clusters, distance_threshold=None)
    return est.fit(_grouped_mark_matrix(X, n_basis)).labels_


def mark_clusters_table(beluga_features_df: pd.DataFrame, clusters: np.ndarray) -> pd.DataFrame:
    """Per-mark cluster table (interpret_features_grouped.py:149-162); the
    sizes come from :func:`cluster_sizes`."""
    df = beluga_features_df.copy()
    df["cluster"] = np.asarray(clusters).ravel()
    return df


def cluster_sizes(table: pd.DataFrame) -> pd.DataFrame:
    sizes = table.groupby("cluster").size().rename("size").to_frame()
    sizes.index = [f"cluster_{i}" for i in sizes.index]
    return sizes.sort_values(by="size", ascending=False)


def feature_clusters_table(beluga_features_df: pd.DataFrame, clusters: np.ndarray, n_basis: int = 10) -> pd.DataFrame:
    """The all_feature_clusters.tsv layout (interpret_features.py:124-129):
    mark metadata repeated per basis coefficient + cluster label."""
    df = pd.DataFrame(np.repeat(beluga_features_df.values, n_basis, axis=0))
    df.columns = beluga_features_df.columns
    df["coeff_idx"] = np.tile(np.arange(n_basis), beluga_features_df.shape[0])
    df["cluster"] = clusters.ravel()
    return df


def tfidf_transform(tracks: np.ndarray) -> np.ndarray:
    """TF-IDF over (n_marks, n_positions) non-negative track matrices
    (svd.py:76-82; idf modified for continuous values)."""
    tf = tracks / tracks.sum(axis=-1, keepdims=True)
    idf = np.log(tracks.shape[0] / (1 + tracks.sum(axis=0)))
    return tf * idf


def tfidf_svd(tracks: np.ndarray, n_components: int = 100, random_state: int = 1):
    """Fit TruncatedSVD on the TF-IDF matrix (svd.py:84-87); returns the
    fitted transformer (use .transform for svd_transform.py behavior)."""
    from sklearn.decomposition import TruncatedSVD

    svd = TruncatedSVD(n_components=n_components, random_state=random_state)
    svd.fit(tfidf_transform(tracks))
    return svd


def kmeans_clusters(X: np.ndarray, k: int = 30, random_state: int = 0, with_tsne: bool = False):
    """KMeans labels (+ optional t-SNE 2-D coordinates for plotting)
    (cluster_and_viz.py:53-103)."""
    from sklearn.cluster import KMeans

    labels = KMeans(n_clusters=k, random_state=random_state, n_init=10).fit_predict(X)
    if not with_tsne:
        return labels
    from sklearn.manifold import TSNE

    emb = TSNE(n_components=2, random_state=random_state, init="pca").fit_transform(X)
    return labels, emb


def _knn_graph(X: np.ndarray, k: int) -> dict[int, dict[int, float]]:
    """Symmetric Gaussian-kernel kNN adjacency over Euclidean distances;
    the bandwidth is the median kNN distance."""
    d2 = np.sum((X[:, None, :] - X[None, :, :]) ** 2, axis=-1)
    np.fill_diagonal(d2, np.inf)
    n = X.shape[0]
    k = min(k, n - 1)
    knn_d2 = np.sort(d2, axis=1)[:, :k]
    sigma2 = float(np.median(knn_d2)) + 1e-12
    adj: dict[int, dict[int, float]] = {i: {} for i in range(n)}
    for i in range(n):
        for j in np.argpartition(d2[i], k)[:k]:
            w = float(np.exp(-d2[i, j] / sigma2))
            if w > 1e-8:
                adj[i][int(j)] = max(adj[i].get(int(j), 0.0), w)
                adj[int(j)][i] = adj[i][int(j)]
    return adj


def louvain_clusters(X: np.ndarray, k_neighbors: int = 15, max_passes: int = 10, seed: int = 0) -> np.ndarray:
    """Louvain community detection on a Euclidean Gaussian-kernel kNN graph
    (Orange3's default kNN metric): one-level local moving + graph
    aggregation repeated until modularity stops improving. Self-contained
    replacement for the reference's Orange dependency; the visiting order
    is drawn from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    adj = _knn_graph(np.asarray(X, dtype=np.float64), k_neighbors)
    n = len(adj)
    node_map = [list(range(n))]  # original nodes per current supernode

    while True:
        m2 = sum(sum(nb.values()) for nb in adj.values())  # 2m
        if m2 == 0:
            break
        degree = {i: sum(nb.values()) for i, nb in adj.items()}
        comm = {i: i for i in adj}
        comm_tot = dict(degree)

        improved_any = False
        for _ in range(max_passes):
            moved = False
            order = list(adj)
            rng.shuffle(order)
            for i in order:
                ci = comm[i]
                links = {}
                for j, w in adj[i].items():
                    links[comm[j]] = links.get(comm[j], 0.0) + w
                comm_tot[ci] -= degree[i]
                best_c, best_gain = ci, 0.0
                for c, w_ic in links.items():
                    gain = w_ic - comm_tot[c] * degree[i] / m2
                    if gain > best_gain + 1e-12:
                        best_c, best_gain = c, gain
                comm_tot[best_c] += degree[i]
                if best_c != ci:
                    comm[i] = best_c
                    moved = improved_any = True
            if not moved:
                break

        if not improved_any:
            break
        # aggregate graph
        labels = {c: idx for idx, c in enumerate(sorted(set(comm.values())))}
        new_adj: dict[int, dict[int, float]] = {v: {} for v in labels.values()}
        for i, nb in adj.items():
            ci = labels[comm[i]]
            for j, w in nb.items():
                cj = labels[comm[j]]
                if ci != cj:
                    new_adj[ci][cj] = new_adj[ci].get(cj, 0.0) + w
        groups: dict[int, list[int]] = {v: [] for v in labels.values()}
        for i in adj:
            groups[labels[comm[i]]].extend(
                node_map[-1][i] if isinstance(node_map[-1][i], list) else [node_map[-1][i]]
            )
        node_map.append([groups[v] for v in sorted(groups)])
        adj = new_adj
        if len(adj) <= 1:
            break

    final = node_map[-1]
    out = np.zeros(n, dtype=np.int64)
    if final and isinstance(final[0], list):
        for label, members in enumerate(final):
            for node in members:
                out[node] = label
    else:
        # no improving move on the first level: every node is its own
        # community (not one giant cluster 0)
        out = np.arange(n, dtype=np.int64)
    return out
