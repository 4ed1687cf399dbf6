"""SpectralClustering by the Nyström approximation.

Counterpart of ``dask_ml_tpu/models/spectral.py``: the same parameters,
the same refusals and the same fitted attributes. With an inducing set Z
of c rows (a uniform sample) and B = affinity(X, Z) (n × c), the
normalized Nyström affinity is G Gᵀ for G = D^{-1/2} B A^{-1/2}, so the
embedding is the top ``n_clusters`` left singular vectors of the tall G
(``ops/linalg.py::svd_tall``), rows normalized; no n × n affinity is
formed. The (c, c) ``eigh`` with jitter runs on the device. The
assignment is the port's KMeans on the (n, ``n_clusters``) embedding, so
its Lloyd passes run the fused kernels (``fused_lloyd_stats``,
``fused_assign_update``) at that narrow width, ``n_init`` times.

Known differences from the JAX package: the inducing sample is drawn by
Gumbel top-l from a ``torch.Generator`` (``_inducing_rows``), and QR
signs differ between cuSOLVER, LAPACK and JAX's TSQR, so the embedding's
columns may carry other signs; ``eigenvalues_`` and the partition do not
depend on them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import BaseEstimator, ClusterMixin, to_host
from ..ops import linalg, pairwise
from ..parallel.sharded import ShardedArray
from ..utils.validation import check_array
from .kmeans import KMeans, _generator, _gumbel_top_l


def _affinity(name, x, z, gamma, degree, coef0, kernel_params=None):
    if callable(name):  # user kernel(X, Z, **kernel_params), ref contract
        return name(x, z, **(kernel_params or {}))
    if name == "rbf":
        return pairwise.rbf_kernel(x, z, gamma=gamma)
    if name == "polynomial":
        return pairwise.polynomial_kernel(x, z, degree=degree, gamma=gamma,
                                          coef0=coef0)
    if name == "sigmoid":
        return pairwise.sigmoid_kernel(x, z, gamma=gamma, coef0=coef0)
    if name == "linear":
        return pairwise.linear_kernel(x, z)
    raise ValueError(f"Unknown affinity {name!r}")


def _inducing_rows(mask, random_state, c):
    """Indices of the c inducing rows: a uniform sample without
    replacement, Gumbel top-l of the row mask from a torch.Generator
    seeded by ``random_state`` (0 when None)."""
    return _gumbel_top_l(mask, _generator(mask.device, random_state, 0), c)


class SpectralClustering(ClusterMixin, BaseEstimator):
    """Ref: dask_ml/cluster/spectral.py::SpectralClustering."""

    def __init__(self, n_clusters=8, eigen_solver=None, random_state=None,
                 n_init=10, gamma=1.0, affinity="rbf", n_neighbors=10,
                 eigen_tol=0.0, assign_labels="kmeans", degree=3, coef0=1,
                 kernel_params=None, n_jobs=1, n_components=100,
                 persist_embedding=False, kmeans_params=None):
        self.n_clusters = n_clusters
        self.eigen_solver = eigen_solver
        self.random_state = random_state
        self.n_init = n_init
        self.gamma = gamma
        self.affinity = affinity
        self.n_neighbors = n_neighbors
        self.eigen_tol = eigen_tol
        self.assign_labels = assign_labels
        self.degree = degree
        self.coef0 = coef0
        self.kernel_params = kernel_params
        self.n_jobs = n_jobs
        self.n_components = n_components
        self.persist_embedding = persist_embedding
        self.kmeans_params = kmeans_params

    def fit(self, X, y=None):
        X = check_array(X, dtype=np.float32)
        n, d = X.shape
        c = min(self.n_components, n)
        if self.assign_labels != "kmeans":
            raise ValueError("only assign_labels='kmeans' is supported")
        if self.eigen_solver not in (None, "tsqr"):
            raise ValueError(
                f"eigen_solver={self.eigen_solver!r} is not supported: the "
                "embedding is computed by an exact distributed TSQR SVD "
                "(pass None or 'tsqr')"
            )
        if self.eigen_tol not in (0.0, 0, "auto"):
            raise ValueError(
                "eigen_tol is not supported: the TSQR SVD is exact, not "
                "iterative (pass 0.0 or 'auto')"
            )
        if self.affinity == "nearest_neighbors":
            raise ValueError(
                "affinity='nearest_neighbors' (and hence n_neighbors) is "
                "not supported; use 'rbf', 'polynomial', 'sigmoid', "
                "'linear', or a callable"
            )
        mask = X.row_mask(X.dtype)
        Z = X.data[_inducing_rows(mask, self.random_state, c)]
        B = _affinity(self.affinity, X.data, Z, self.gamma, self.degree,
                      self.coef0, self.kernel_params) * mask[:, None]
        A = _affinity(self.affinity, Z, Z, self.gamma, self.degree,
                      self.coef0, self.kernel_params)

        # A^{-1/2} and A⁺ by eigh with jitter (A is a PSD Gram matrix)
        eye = torch.eye(c, dtype=A.dtype, device=A.device)
        w, V = torch.linalg.eigh(A + 1e-6 * eye)
        w = w.clamp_min(1e-6)
        inv_sqrt = (V / w.sqrt()[None, :]) @ V.T
        a_pinv = (V / w[None, :]) @ V.T

        # approximate degrees: B A⁺ (Bᵀ 1)
        deg = B @ (a_pinv @ (B.T @ mask))
        deg = torch.where(deg > 1e-12, deg, 1.0)
        G = (B / deg.sqrt()[:, None]) @ inv_sqrt

        u, s, _ = linalg.svd_tall(G)
        emb = u[:, : self.n_clusters]
        norms = emb.norm(dim=1, keepdim=True)
        emb = emb / torch.where(norms > 1e-12, norms, 1.0) * mask[:, None]
        embedding = ShardedArray(emb, X.n_rows)

        # n_init restarts of the assignment KMeans, the lowest inertia
        # kept; restart seeds count up from the resolved first seed
        km_params = dict(self.kmeans_params or {})
        km_params.setdefault("random_state", 0 if self.random_state is None
                             else int(self.random_state))
        seed0 = km_params["random_state"]
        seed0 = 0 if seed0 is None else int(seed0)
        best = None
        for r in range(max(int(self.n_init), 1)):
            params_r = dict(km_params)
            if r > 0:
                params_r["random_state"] = seed0 + r
            km = KMeans(n_clusters=self.n_clusters, **params_r).fit(embedding)
            if best is None or km.inertia_ < best.inertia_:
                best = km
        self.assign_labels_ = best
        self.labels_ = best.labels_
        self.eigenvalues_ = to_host(s[: self.n_clusters]).astype(np.float64)
        if self.persist_embedding:
            self.embedding_ = embedding
        self.n_features_in_ = d
        return self

    def fit_predict(self, X, y=None):
        return self.fit(X).labels_
