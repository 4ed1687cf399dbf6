"""KMeans (Lloyd) with k-means|| initialization — in memory.

Counterpart of ``dask_ml_tpu/models/kmeans.py``: the same parameters and
fitted attributes. Each Lloyd iteration is one pass over X by a
statistics function: the fused kernel ``ops.fused.fused_lloyd_stats``
(the counterpart of ``_lloyd_run_pallas``) or its plain version
``ops.fused.lloyd_stats_plain``. One loop (``_lloyd_run``) takes either:
``new = where(counts > 0, sums / counts, centers)`` until
``it == max_iter`` or the squared center shift is at most
``tol * mean(per-feature variance)``. ``labels_``, ``inertia_``,
``predict`` and ``score`` come from ``ops.fused.fused_assign_update`` or
its plain version the same way.

The inits draw with an explicit ``torch.Generator`` seeded from
``random_state`` (weighted sampling without replacement by Gumbel top-l),
so they give other draws than the JAX package for the same seed. The
last step of k-means|| (cluster the weighted candidates) and k-means++
run the port's own weighted k-means++ and Lloyd on the host, where the
JAX package calls scikit-learn.

Not ported yet (``NotImplementedError`` naming the ROADMAP item): the
streamed fit and ``checkpoint_path``.
"""

from __future__ import annotations

import math
import warnings
from functools import partial

import numpy as np
import torch

from ..base import BaseEstimator, ClusterMixin, TransformerMixin, to_host
from ..config import fit_dtype_info, mxu_dtype as _mxu_dtype
from ..ops.fused import (
    assign_update_plain, fused_assign_update, fused_lloyd_stats,
    lloyd_stats_plain,
)
from ..ops.pairwise import euclidean_distances, euclidean_distances_sq
from ..ops.reductions import masked_mean_var
from ..parallel.sharded import ShardedArray
from ..utils.validation import check_array, check_is_fitted


def _lloyd_run(X, n_valid, centers0, max_iter, tol2, stats):
    """Lloyd loop over the rows < ``n_valid``; ``stats(X, n_valid,
    centers)`` gives (sums, counts, inertia) of one pass. Returns
    (centers, n_iter, final shift2)."""
    centers, it, shift2 = centers0, 0, math.inf
    while it < max_iter and shift2 > tol2:
        sums, counts, _ = stats(X, n_valid, centers)
        c = counts.to(centers.dtype)[:, None]
        new = torch.where(c > 0, sums / c, centers)
        centers, shift2 = new, float(((new - centers) ** 2).sum())
        it += 1
    return centers, it, shift2


def _labels_inertia(X, mask, centers, use_kernel):
    assign = fused_assign_update if use_kernel else assign_update_plain
    labels, _, _, _, inertia = assign(X, mask, centers)
    return labels, inertia


def _gumbel_top_l(weights, gen, l):
    """Indices of l draws without replacement with P ∝ weights: the top
    l of Gumbel-perturbed log-weights."""
    u = torch.rand(weights.shape, generator=gen, device=weights.device,
                   dtype=torch.float32)
    g = -torch.log(-torch.log(u))
    keys = torch.where(weights > 0, torch.log(weights) + g, -torch.inf)
    return torch.topk(keys, l).indices


def _generator(device, random_state, default):
    seed = default if random_state is None else int(random_state)
    return torch.Generator(device=device).manual_seed(seed)


def _masked_d2(X, mask, cands, cand_valid):
    d2 = euclidean_distances_sq(X, cands)
    return torch.where(cand_valid[None, :] > 0, d2, torch.inf)


def _sqdist(a, b):
    return ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)


def _kmeans_plusplus(X, n_clusters, rng, sample_weight=None):
    """Greedy k-means++ seeding (scikit-learn's ``_kmeans_plusplus``):
    each new center is the best of 2 + log(k) candidates drawn with
    P ∝ weight · d², best meaning the least weighted potential."""
    n = X.shape[0]
    w = np.ones(n) if sample_weight is None else np.asarray(sample_weight,
                                                            np.float64)
    trials = 2 + int(np.log(n_clusters))
    centers = np.empty((n_clusters, X.shape[1]), X.dtype)
    first = rng.choice(n, p=w / w.sum())
    centers[0] = X[first]
    closest = _sqdist(centers[:1], X)[0]
    pot = (closest * w).sum()
    for c in range(1, n_clusters):
        draws = rng.uniform(size=trials) * pot
        cand = np.searchsorted(np.cumsum(w * closest), draws)
        cand = np.clip(cand, None, n - 1)
        dist = np.minimum(closest, _sqdist(X[cand], X))
        pots = (dist * w).sum(1)
        best = int(np.argmin(pots))
        closest, pot = dist[best], pots[best]
        centers[c] = X[cand[best]]
    return centers


def _weighted_kmeans(X, w, n_clusters, rng, max_iter=300, tol=1e-4):
    """k-means++ then weighted Lloyd on a small host set — the local
    solve k-means|| ends with (scikit-learn's KMeans with sample_weight
    in the JAX package). Stops on the same rule: squared center shift
    at most tol · mean weighted per-feature variance."""
    centers = _kmeans_plusplus(X, n_clusters, rng, w)
    mean = (X * w[:, None]).sum(0) / w.sum()
    tol2 = tol * float(((X - mean) ** 2 * w[:, None]).sum(0).mean()
                       / w.sum())
    for _ in range(max_iter):
        labels = _sqdist(X, centers).argmin(1)
        sums = np.zeros_like(centers)
        np.add.at(sums, labels, X * w[:, None])
        wsum = np.bincount(labels, weights=w, minlength=n_clusters)
        new = np.where(wsum[:, None] > 0,
                       sums / np.maximum(wsum, 1e-300)[:, None], centers)
        shift2 = ((new - centers) ** 2).sum()
        centers = new
        if shift2 <= tol2:
            break
    return centers


def init_scalable(X: ShardedArray, n_clusters, random_state, max_iter=None,
                  oversampling_factor=2):
    """k-means|| candidate harvesting (Bahmani et al. 2012): a fixed
    ``l = oversampling_factor * k`` rows per round drawn with P ∝ d²
    to the candidates so far, then a weighted k-means of the
    candidates. ref dask_ml/cluster/k_means.py::init_scalable."""
    data, mask = X.data, X.row_mask(X.dtype)
    d = X.shape[1]
    l = min(max(int(oversampling_factor * n_clusters), 1), data.shape[0])
    gen = _generator(data.device, random_state, 0)
    rounds = 5 if max_iter is None else max(int(max_iter), 1)
    c_max = 1 + rounds * l
    cands = torch.zeros((c_max, d), dtype=data.dtype, device=data.device)
    cand_valid = torch.zeros(c_max, dtype=torch.float32, device=data.device)
    cands[0] = data[_gumbel_top_l(mask, gen, 1)[0]]
    cand_valid[0] = 1.0
    for r in range(rounds):
        dmin = _masked_d2(data, mask, cands, cand_valid).min(1).values * mask
        if float(dmin.sum()) <= 0.0:
            break
        start = 1 + r * l
        cands[start:start + l] = data[_gumbel_top_l(dmin, gen, l)]
        cand_valid[start:start + l] = 1.0
    labels = _masked_d2(data, mask, cands, cand_valid).argmin(1)
    weights = torch.zeros(c_max, dtype=torch.float32, device=data.device) \
        .index_add_(0, labels, mask)
    valid = to_host(cand_valid) > 0
    pts = to_host(cands)[valid].astype(np.float64)
    w = to_host(weights)[valid].astype(np.float64)
    w = np.where(w > 0, w, 1e-6)
    centers = _weighted_kmeans(pts, w, n_clusters,
                               np.random.RandomState(random_state))
    return torch.as_tensor(centers, dtype=data.dtype, device=data.device)


def init_pp(X: ShardedArray, n_clusters, random_state):
    """k-means++ on a uniform device-drawn sample (ref ::init_pp)."""
    data, mask = X.data, X.row_mask(X.dtype)
    m = min(X.n_rows, max(10 * n_clusters, 500), data.shape[0])
    idx = _gumbel_top_l(mask, _generator(data.device, random_state, 1), m)
    sample = to_host(data[idx]).astype(np.float64)
    centers = _kmeans_plusplus(sample, n_clusters,
                               np.random.RandomState(random_state))
    return torch.as_tensor(centers, dtype=data.dtype, device=data.device)


def init_random(X: ShardedArray, n_clusters, random_state):
    data, mask = X.data, X.row_mask(X.dtype)
    gen = _generator(data.device, random_state, 2)
    return data[_gumbel_top_l(mask, gen, n_clusters)]


def k_means(X, n_clusters, init="k-means||", max_iter=300, tol=1e-4,
            random_state=None, oversampling_factor=2, init_max_iter=None,
            return_n_iter=False):
    """Functional API (ref: dask_ml/cluster/k_means.py::k_means):
    returns (centroids, labels, inertia[, n_iter])."""
    est = KMeans(
        n_clusters=n_clusters, init=init, max_iter=max_iter, tol=tol,
        random_state=random_state, oversampling_factor=oversampling_factor,
        init_max_iter=init_max_iter,
    ).fit(X)
    if return_n_iter:
        return est.cluster_centers_, est.labels_, est.inertia_, est.n_iter_
    return est.cluster_centers_, est.labels_, est.inertia_


class KMeans(TransformerMixin, ClusterMixin, BaseEstimator):
    """Ref: dask_ml/cluster/k_means.py::KMeans.

    ``use_kernel`` is the counterpart of the JAX ``use_pallas``: None
    takes the fused kernels (on the CPU their plain versions run) unless
    the fit dtype is an explicit bfloat16, False the plain torch loop,
    True insists. The choice and its reason land in ``kernel_info_``."""

    def __init__(self, n_clusters=8, init="k-means||", oversampling_factor=2,
                 max_iter=300, tol=1e-4, precompute_distances="auto",
                 random_state=None, copy_x=True, n_jobs=1, algorithm="full",
                 init_max_iter=None, use_kernel=None, checkpoint_path=None,
                 checkpoint_every=0, fit_dtype=None):
        self.n_clusters = n_clusters
        self.init = init
        self.oversampling_factor = oversampling_factor
        self.max_iter = max_iter
        self.tol = tol
        self.precompute_distances = precompute_distances
        self.random_state = random_state
        self.copy_x = copy_x
        self.n_jobs = n_jobs
        self.algorithm = algorithm
        self.init_max_iter = init_max_iter
        self.use_kernel = use_kernel
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self.fit_dtype = fit_dtype

    def _init_centers(self, X: ShardedArray):
        if isinstance(self.init, (np.ndarray, torch.Tensor)):
            centers = torch.as_tensor(self.init).to(dtype=X.dtype,
                                                     device=X.device)
            if tuple(centers.shape) != (self.n_clusters, X.shape[1]):
                raise ValueError(
                    f"init array has shape {tuple(centers.shape)}, expected "
                    f"{(self.n_clusters, X.shape[1])}"
                )
            return centers
        if self.init == "k-means||":
            return init_scalable(X, self.n_clusters, self.random_state,
                                 self.init_max_iter, self.oversampling_factor)
        if self.init == "k-means++":
            return init_pp(X, self.n_clusters, self.random_state)
        if self.init == "random":
            return init_random(X, self.n_clusters, self.random_state)
        raise ValueError(f"Unknown init {self.init!r}")

    def _resolve_kernel(self, mxu):
        """(use the fused kernels?, why not): they take every (d, k); an
        explicit bf16 request keeps the plain loop, whose cross term
        takes bf16 operands (the kernels are f32), as the JAX package's
        explicit bf16 keeps its XLA loop."""
        if self.use_kernel is False:
            return False, "use_kernel=False"
        if self.use_kernel is None and mxu is not None:
            return False, "fit_dtype bfloat16 runs the plain loop"
        if self.use_kernel and mxu is not None:
            warnings.warn("KMeans(use_kernel=True) runs the f32 kernel; "
                          "the bfloat16 fit dtype is ignored on this path",
                          RuntimeWarning)
        return True, None

    def fit(self, X, y=None):
        if isinstance(X, np.memmap):
            raise NotImplementedError(
                "the streamed (out-of-core) KMeans fit is not ported yet: "
                "ROADMAP queue 1 item 6"
            )
        if self.checkpoint_path and self.checkpoint_every:
            raise NotImplementedError(
                "checkpoint_path is not ported yet: ROADMAP queue 1 "
                "item 13 (utils/checkpoint.py)"
            )
        X = check_array(X, dtype=np.float32)
        if self.n_clusters > X.n_rows:
            raise ValueError(
                f"n_clusters={self.n_clusters} > n_samples={X.n_rows}"
            )
        mask = X.row_mask(X.dtype)
        centers0 = self._init_centers(X)
        _, var = masked_mean_var(X.data, mask, X.n_rows)
        tol2 = float(self.tol * var.mean())
        dt_info = fit_dtype_info(self.fit_dtype)
        mxu = _mxu_dtype(self.fit_dtype)
        use_kernel, reason = self._resolve_kernel(mxu)
        if use_kernel and mxu is not None:
            mxu = None
            dt_info = {"fit_dtype": "float32",
                       "fit_dtype_source": "kernel-resident"}
        self.fit_dtype_ = dt_info["fit_dtype"]
        self.kernel_info_ = {
            "kernel": "fused_lloyd_stats" if use_kernel else None,
            "kernel_reason": reason, **dt_info,
        }
        stats = (fused_lloyd_stats if use_kernel
                 else partial(lloyd_stats_plain, mxu_dtype=mxu))
        centers, n_iter, _ = _lloyd_run(X.data, X.n_rows, centers0,
                                        self.max_iter, tol2, stats)
        labels, inertia = _labels_inertia(X.data, mask, centers, use_kernel)
        inertia = float(inertia)
        if not math.isfinite(inertia) or not bool(
                torch.isfinite(centers).all()):
            raise FloatingPointError(
                "KMeans produced non-finite centers/inertia: the input "
                "contains NaN/Inf"
            )
        self.cluster_centers_ = to_host(centers)
        self.labels_ = ShardedArray(labels, X.n_rows)
        self.inertia_ = inertia
        self.n_iter_ = int(n_iter)
        self.n_features_in_ = X.shape[1]
        return self

    def _use_kernel_after_fit(self):
        info = getattr(self, "kernel_info_", None)
        if info is not None:
            return info["kernel"] is not None
        return self.use_kernel is not False

    def _labels_inertia_of(self, X):
        X = check_array(X, dtype=np.float32)
        centers = torch.as_tensor(self.cluster_centers_, dtype=X.dtype,
                                  device=X.device)
        labels, inertia = _labels_inertia(
            X.data, X.row_mask(X.dtype), centers,
            self._use_kernel_after_fit())
        return X, labels, inertia

    def predict(self, X):
        check_is_fitted(self, "cluster_centers_")
        X, labels, _ = self._labels_inertia_of(X)
        return ShardedArray(labels, X.n_rows)

    def fit_predict(self, X, y=None):
        return self.fit(X).labels_

    def transform(self, X):
        check_is_fitted(self, "cluster_centers_")
        X = check_array(X, dtype=np.float32)
        centers = torch.as_tensor(self.cluster_centers_, dtype=X.dtype,
                                  device=X.device)
        return ShardedArray(euclidean_distances(X.data, centers), X.n_rows)

    def score(self, X, y=None):
        check_is_fitted(self, "cluster_centers_")
        _, _, inertia = self._labels_inertia_of(X)
        return -float(inertia)
