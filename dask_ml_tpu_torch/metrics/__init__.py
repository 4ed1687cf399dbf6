"""Metrics and scorers. Counterpart of ``dask_ml_tpu/metrics``: the
classification, regression and pairwise metrics and the scorer table,
reducing with torch ops on the data's device and returning host values.
"""
from .classification import (UndefinedMetricWarning, accuracy_score,
                             average_precision_score,
                             balanced_accuracy_score, confusion_matrix,
                             f1_score, log_loss, precision_recall_curve,
                             precision_score, recall_score, roc_auc_score,
                             roc_curve)
from .pairwise import (cosine_distances, euclidean_distances,
                       linear_kernel, manhattan_distances,
                       pairwise_distances, pairwise_distances_argmin,
                       pairwise_distances_argmin_min, pairwise_kernels,
                       polynomial_kernel, rbf_kernel, sigmoid_kernel)
from .regression import (explained_variance_score, max_error,
                         mean_absolute_error, mean_squared_error,
                         mean_squared_log_error, median_absolute_error,
                         r2_score)
from .scorer import SCORERS, check_scoring, get_scorer

__all__ = [
    "SCORERS", "UndefinedMetricWarning", "accuracy_score",
    "average_precision_score", "balanced_accuracy_score", "check_scoring",
    "confusion_matrix", "cosine_distances", "euclidean_distances",
    "explained_variance_score", "f1_score", "get_scorer", "linear_kernel",
    "log_loss", "manhattan_distances", "max_error", "mean_absolute_error",
    "mean_squared_error", "mean_squared_log_error", "median_absolute_error",
    "pairwise_distances", "pairwise_distances_argmin",
    "pairwise_distances_argmin_min", "pairwise_kernels",
    "polynomial_kernel", "precision_recall_curve", "precision_score",
    "r2_score", "rbf_kernel", "recall_score", "roc_auc_score", "roc_curve",
    "sigmoid_kernel",
]
