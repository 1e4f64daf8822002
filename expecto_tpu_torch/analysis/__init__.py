from .interpret import interpret_model, interpret_model_with_clusters, model_coefficients
from .rank_int import rank_INT, rank_to_normal
from .bootstrap import bootstrap_coefficient_stats
from .cluster import hierarchical_feature_clusters, tfidf_transform, tfidf_svd, kmeans_clusters, louvain_clusters
from .atac import get_atac_peak_bins, intersect_intervals

__all__ = [
    "interpret_model",
    "interpret_model_with_clusters",
    "model_coefficients",
    "rank_INT",
    "rank_to_normal",
    "bootstrap_coefficient_stats",
    "hierarchical_feature_clusters",
    "tfidf_transform",
    "tfidf_svd",
    "kmeans_clusters",
    "louvain_clusters",
    "get_atac_peak_bins",
    "intersect_intervals",
]
