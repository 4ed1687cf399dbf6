"""KMeans (Lloyd) with k-means|| initialization — in memory and out of
core.

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

Out of core (``_fit_streamed``): a host ``np.memmap``, or a numpy array
taller than a positive ``config.stream_block_rows``, streams through the
device in blocks (``parallel/streaming.py``). One Lloyd iteration is one
pass, one ``ops.fused.fused_kmeans_block_stats`` launch per block adding
into device accumulators (the counterpart of ``_sb_assign_stats_pallas``;
``use_kernel=False`` takes the plain ``_block_assign_stats``); ``tol``
scales by the variance from one moments pass; k-means|| and the other
inits draw block by block (Gumbel top-l keys merge exactly across
blocks). ``labels_`` is then a host int32 array, and ``predict``,
``transform`` and ``score`` stream such inputs the same way.

A sparse X streams. On the stream's nnz route a Lloyd pass runs
``_sparse_block_assign_stats`` on each block's ``SparseSlab`` (the JAX
function: distances by the expanded form with ``X·Cᵀ`` and ``‖x‖²``
from the nonzeros, the per-label sums by one ordered reduction, nnz·k
work, no dense block; ``‖x‖²`` sums a row's duplicate columns first,
where the JAX function squares each entry), and so do the labels and
the inference paths;
the moments pass sums the nonzeros. The inits take each block scattered
dense on the device, as the JAX inits take the per-block densified
path. ``kernel_info_`` records ``sparse_stream`` and its reason.

Checkpoints (the JAX ``_LloydCheckpoint`` contract): with
``checkpoint_path`` and ``checkpoint_every`` the resident Lloyd loop runs
in ``checkpoint_every``-iteration chunks and the streamed one saves after
every ``checkpoint_every``-th pass; without them a streamed fit saves
under ``config.stream_checkpoint_path`` (kind ``"kmeans"``, every
``stream_checkpoint_every`` passes). A save holds the centers (k x d, to
the host), the iteration count and, resident, the last squared shift;
its token covers the init, the budget, the kernel choice and a
fingerprint of X, so a checkpoint of another fit is ignored. A resumed
fit skips the init and ends bit-equal to an uninterrupted one; a
completed fit clears its checkpoint. A streamed fit carries
``training_profile_``. Its labels pass keeps X's rows, so there
``stream_nonfinite="quarantine"`` raises.

Several processes (``parallel/distributed.py``): a streamed fit streams
each process's own rows; the moments, every Lloyd pass's sums and counts
(kernel 9's accumulators) and the inertia merge by ``psum_host``, and
k-means|| draws from a generator per rank (seeded from ``random_state``
and the rank), its top-l merged by one all-gather of each process's top
l, its cost and candidate weights by ``psum_host``, so every process
holds the identical centers. A resident fit over a process-local
``ShardedArray`` merges kernel 2's sums the same way
(``_fit_process_local``). ``labels_`` then holds this process's rows.
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
    assign_update_plain, fused_assign_update, fused_kmeans_block_stats,
    fused_lloyd_stats, kmeans_stream_acc, lloyd_stats_plain,
)
from ..ops.pairwise import euclidean_distances, euclidean_distances_sq
from ..ops.reductions import masked_mean_var
from ..ops.sparse_kernels import (sparse_center_dots, sparse_label_sums,
                                  sparse_row_sq_norms, sparse_xt_r)
from ..parallel.sharded import ShardedArray
from ..parallel.sparse_stream import SparseSlab
from ..parallel.streaming import (BlockStream, block_dense, stream_plan,
                                  streamed_map)
from ..utils.validation import check_array, check_is_fitted


def _lloyd_run(X, n_valid, centers0, max_iter, tol2, stats, it=0,
               shift2=math.inf):
    """Lloyd loop over the rows < ``n_valid`` from iteration ``it`` with
    the last squared shift ``shift2``; ``stats(X, n_valid, centers)``
    gives (sums, counts, inertia) of one pass. Returns (centers, n_iter,
    final shift2)."""
    centers = centers0
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


def _block_labels_inertia(blk, centers, use_kernel):
    """(labels, inertia) of a streamed block's valid rows, dense or
    sparse."""
    x, n = blk.arrays[0], blk.n_rows
    if isinstance(x, SparseSlab):
        return _sparse_labels_inertia(x, n, centers)
    return _labels_inertia(x[:n], _ones(blk), centers, use_kernel)


def _block_distances(blk, centers):
    x, n = blk.arrays[0], blk.n_rows
    if isinstance(x, SparseSlab):
        return _sparse_d2(x, n, centers).sqrt()
    return euclidean_distances(x[:n], centers)


def _ones(blk):
    """The all-valid mask of a block's valid rows."""
    return torch.ones(blk.n_rows, dtype=torch.float32,
                      device=blk.arrays[0].device)


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


def _rank_generator(device, random_state, default):
    """The init's generator of THIS process: seeded from ``random_state``
    and the rank (rank 0 keeps the single-process seed), so the Gumbel
    keys of different processes' rows are independent draws (the JAX
    ``_proc_key``)."""
    from ..parallel.distributed import process_index

    seed = default if random_state is None else int(random_state)
    pid = process_index()
    return torch.Generator(device=device).manual_seed(
        seed if pid == 0 else seed + 1_000_000 + pid)


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


# -- streamed (out-of-core) Lloyd -------------------------------------------
# Each function takes one block's valid rows X[:n]; a pass adds the
# blocks' statistics on the device and the host reads them once.

def _block_assign_stats(X, n, centers, mxu_dtype=None):
    """(Σ x per label (k, d), count per label (k,) int32, Σ min-d²) of a
    block's rows < n, in plain torch: the plain flavour of a streamed
    Lloyd pass (the JAX ``_block_assign_stats``). The sums are a product
    with the one-hot assignment, which adds in the same order on every
    run."""
    Xv = X[:n]
    d2 = euclidean_distances_sq(Xv, centers, mxu_dtype=mxu_dtype)
    mind, labels = d2.min(1)
    onehot = torch.nn.functional.one_hot(labels, centers.shape[0]).to(
        Xv.dtype)
    counts = torch.bincount(labels, minlength=centers.shape[0])
    return onehot.T @ Xv, counts.to(torch.int32), mind.sum()


def _sparse_d2(x, n, centers):
    """(n, k) squared distances of a sparse block's rows < n to the
    centers: max(‖x‖² + ‖c‖² − 2 x·c, 0) from the nonzeros, ‖x‖² with a
    row's duplicate columns summed first (the dense row's norm)."""
    xx = sparse_row_sq_norms(x.data, x.cols, x.rows, x.n_rows,
                             x.n_features)[:n]
    cc = (centers * centers).sum(1)[None, :]
    dots = sparse_center_dots(x.data, x.cols, x.rows, centers, x.n_rows,
                              x.indptr)[:n]
    return (xx[:, None] + cc - 2.0 * dots).clamp_min(0.0)


def _sparse_block_assign_stats(x, n, centers):
    """(Σ x per label (k, d), count per label (k,) int32, Σ min-d²) of a
    sparse block's rows < n: the JAX ``_sparse_block_assign_stats``, at
    nnz·k cost."""
    k = centers.shape[0]
    mind, labels = _sparse_d2(x, n, centers).min(1)
    full = torch.zeros(x.n_rows, dtype=torch.int64, device=centers.device)
    full[:n] = labels
    sums = sparse_label_sums(x.data, x.cols, x.rows, full, k, x.n_features)
    counts = torch.bincount(labels, minlength=k)
    return sums, counts.to(torch.int32), mind.sum()


def _sparse_labels_inertia(x, n, centers):
    mind, labels = _sparse_d2(x, n, centers).min(1)
    return labels.to(torch.int32), mind.sum()


# rows per step of the moments pass: a step's x * x and the reductions'
# scratch stay a small share of a block (whole-block reductions of a
# 256 MB block measured 388 MiB of scratch on an H100)
_MOMENT_ROWS = 1 << 16


def _block_moments(X, n):
    """(Σ x, Σ x²) per feature of a block's rows < n; a sparse block's
    from its nonzeros (the rows past n hold none)."""
    if isinstance(X, SparseSlab):
        ones = torch.ones(X.n_rows, dtype=torch.float32, device=X.device)
        by_col = X.by_col()
        return (sparse_xt_r(X.data, X.cols, X.rows, ones, X.n_features,
                            by_col),
                sparse_xt_r(X.data * X.data, X.cols, X.rows, ones,
                            X.n_features, by_col))
    s = ss = 0.0
    for lo in range(0, n, _MOMENT_ROWS):
        Xc = X[lo:min(lo + _MOMENT_ROWS, n)]
        s = s + Xc.sum(0)
        ss = ss + (Xc * Xc).sum(0)
    return s, ss


def _merge(sums):
    """A pass's (sums, counts[, inertia]) -> global across processes
    (``solvers.merge_sums``: float64 in rank order, back as float32);
    the identity for one process."""
    from ..parallel.distributed import host_reduce
    from .solvers.solvers import merge_sums

    return merge_sums(host_reduce(), sums)


def _streamed_lloyd(stream, centers0, max_iter, tol2, fit_dtype=None,
                    use_kernel=True, ckpt=None, start_it=0):
    """Host-loop Lloyd over the stream: per iteration one pass, one
    ``fused_kmeans_block_stats`` launch per block (or the plain
    ``_block_assign_stats``) adding into device accumulators, then the
    update ``where(counts > 0, sums / counts, centers)`` and one read of
    the squared shift. From iteration ``start_it`` (a resumed fit); with
    ``ckpt`` the centers and the count are saved after each due pass
    that did not converge. Returns (centers, n_iter)."""
    mxu = _mxu_dtype(fit_dtype)
    centers = centers0
    k, d = centers.shape
    n_iter = start_it
    for it in range(int(start_it), int(max_iter)):
        if stream.nnz_route:
            sums = counts = None
            for blk in stream:
                s, c, _ = _sparse_block_assign_stats(blk.arrays[0],
                                                     blk.n_rows, centers)
                sums = s if sums is None else sums + s
                counts = c if counts is None else counts + c
        elif use_kernel:
            acc = kmeans_stream_acc(k, d, stream.device)
            for blk in stream:
                fused_kmeans_block_stats(blk.arrays[0], blk.n_rows, centers,
                                         mxu=mxu, acc=acc)
            sums, counts = acc[0], acc[1]
        else:
            sums = counts = None
            for blk in stream:
                s, c, _ = _block_assign_stats(blk.arrays[0], blk.n_rows,
                                              centers, mxu_dtype=mxu)
                sums = s if sums is None else sums + s
                counts = c if counts is None else counts + c
        # several processes: every process's pass sums merge, so the
        # centers never diverge across processes
        sums, counts = _merge((sums, counts))
        c = counts.to(centers.dtype)[:, None]
        new = torch.where(c > 0, sums / c, centers)
        shift2 = float(((new - centers) ** 2).sum())
        centers = new
        n_iter = it + 1
        if shift2 <= tol2:
            break
        if ckpt is not None and ckpt.due(n_iter):
            ckpt.save(centers=to_host(centers), it=n_iter)
    return centers, n_iter


def _block_weighted_topl(X, weights, gen, l):
    """Per-block Gumbel top-l: (keys, rows). The weighted sample without
    replacement of the whole stream is the top l of every block's top l
    keys (the keys are independent across blocks), so blocks merge
    exactly."""
    u = torch.rand(weights.shape, generator=gen, device=weights.device,
                   dtype=torch.float32)
    keys = torch.where(weights > 0, torch.log(weights) - torch.log(
        -torch.log(u)), -torch.inf)
    kv, idx = torch.topk(keys, l)
    return kv, X[idx]


def _global_topl(kvs, rows, l):
    """The top l rows by Gumbel key across the blocks' candidates, and,
    under several processes, across every process's: the local top l,
    padded to l with -inf keys, all-gathered, and the top l again (the
    merge is exact and identical on every process)."""
    from ..parallel import distributed as dist

    top = np.argsort(-kvs, kind="stable")[:l]
    top = top[np.isfinite(kvs[top])]
    if dist.process_count() == 1:
        return rows[top]
    d = rows.shape[1]
    kv_p = np.full(l, -np.inf, np.float32)
    kv_p[: top.size] = kvs[top]
    rw_p = np.zeros((l, d), np.float32)
    rw_p[: top.size] = rows[top]
    kv_all = dist.allgather_host(kv_p).ravel()
    rw_all = dist.allgather_host(rw_p).reshape(-1, d)
    t = np.argsort(-kv_all, kind="stable")[:l]
    t = t[np.isfinite(kv_all[t])]
    return rw_all[t]


def _streamed_sample(stream, weights_fn, gen, l):
    """l rows drawn without replacement with P ∝ ``weights_fn(block)``
    across the stream; (≤ l, d) host rows."""
    kvs, rows = [], []
    for blk in stream:
        Xv = block_dense(blk.arrays[0])[: blk.n_rows]
        kv, r = _block_weighted_topl(Xv, weights_fn(Xv), gen,
                                     min(l, blk.n_rows))
        kvs.append(kv.cpu().numpy())
        rows.append(r.cpu().numpy())
    return _global_topl(np.concatenate(kvs), np.concatenate(rows, 0), l)


def _uniform(Xv):
    return torch.ones(Xv.shape[0], dtype=torch.float32, device=Xv.device)


def init_scalable_streamed(stream, n_clusters, random_state, max_iter=None,
                           oversampling_factor=2):
    """k-means|| over the stream: the fixed-budget Gumbel top-l rounds of
    ``init_scalable``, each round's cost and sampling pass running block
    by block and merging exactly, then the port's weighted k-means++ and
    Lloyd of the candidates (seeded with 0 when ``random_state`` is None,
    as the JAX package does)."""
    from ..parallel import distributed as dist

    l = max(int(oversampling_factor * n_clusters), 1)
    gen = _rank_generator(stream.device, random_state, 0)
    cands_list = [_streamed_sample(stream, _uniform, gen, 1)]
    rounds = 5 if max_iter is None else max(int(max_iter), 1)
    for _ in range(rounds):
        cands = torch.as_tensor(np.concatenate(cands_list, 0),
                                device=stream.device)
        phi = 0.0
        kvs, rows = [], []
        for blk in stream:
            Xv = block_dense(blk.arrays[0])[: blk.n_rows]
            dmin = euclidean_distances_sq(Xv, cands).min(1).values
            phi += float(dmin.sum())
            kv, rw = _block_weighted_topl(Xv, dmin, gen, min(l, blk.n_rows))
            kvs.append(kv.cpu().numpy())
            rows.append(rw.cpu().numpy())
        phi = float(dist.psum_host(np.asarray(phi)))  # the global cost
        if phi <= 0.0:
            break
        picked = _global_topl(np.concatenate(kvs), np.concatenate(rows, 0),
                              l)
        if len(picked):
            cands_list.append(picked)
    cands_h = np.concatenate(cands_list, 0)
    cands = torch.as_tensor(cands_h, device=stream.device)
    weights = torch.zeros(len(cands_h), dtype=torch.float32,
                          device=stream.device)
    for blk in stream:
        Xv = block_dense(blk.arrays[0])[: blk.n_rows]
        labels = euclidean_distances_sq(Xv, cands).argmin(1)
        weights += torch.bincount(labels, minlength=len(cands_h)).to(
            torch.float32)
    w = np.asarray(dist.psum_host(weights.cpu().numpy().astype(np.float64)))
    w = np.where(w > 0, w, 1e-6)
    centers = _weighted_kmeans(
        cands_h.astype(np.float64), w, n_clusters,
        np.random.RandomState(0 if random_state is None
                              else int(random_state)))
    return torch.as_tensor(centers, dtype=torch.float32,
                           device=stream.device)


class _OneBlock:
    """A process-local array's rows as a one-block stream, for the
    streamed inits' merges."""

    nnz_route = False

    def __init__(self, X):
        from ..parallel.streaming import Block

        self.device = X.device
        self.n_rows = X.n_rows
        self._blk = Block((X.data,), X.n_rows)

    def __iter__(self):
        yield self._blk


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

    def _ckpt_token_parts(self, n, d):
        """The identity of a fit a checkpoint may resume: the init
        (its configuration, or the bytes of an init array: a resumed fit
        skips the init), the budget, the kernel choice and the shape."""
        import hashlib

        if isinstance(self.init, (np.ndarray, torch.Tensor)):
            init = hashlib.sha1(np.ascontiguousarray(
                to_host(self.init).astype(np.float32)).tobytes()).hexdigest()
        else:
            init = (self.init, self.random_state, self.oversampling_factor,
                    self.init_max_iter)
        return ("KMeans", init, self.n_clusters, n, d, self.max_iter,
                self.tol, self.use_kernel, self.fit_dtype)

    def _make_ckpt(self, X, n, d, streamed):
        """The fit's checkpoint slot: ``checkpoint_path`` every
        ``checkpoint_every`` iterations when both are set; else, for a
        streamed fit, ``config.stream_checkpoint_path``; else None."""
        from ..reliability.stream_ckpt import (StreamCheckpoint, fit_token,
                                               stream_checkpoint)

        parts = self._ckpt_token_parts(n, d)
        if self.checkpoint_path and self.checkpoint_every:
            return StreamCheckpoint(
                self.checkpoint_path, fit_token("kmeans", parts, (X,)),
                every=self.checkpoint_every)
        if streamed:
            return stream_checkpoint("kmeans", parts, arrays=(X,))
        return None

    def _init_centers_streamed(self, stream, n_features, n_rows):
        if isinstance(self.init, (np.ndarray, torch.Tensor)):
            centers = torch.as_tensor(self.init).to(dtype=torch.float32,
                                                     device=stream.device)
            if tuple(centers.shape) != (self.n_clusters, n_features):
                raise ValueError(
                    f"init array has shape {tuple(centers.shape)}, expected "
                    f"{(self.n_clusters, n_features)}"
                )
            return centers
        if self.init == "k-means||":
            return init_scalable_streamed(
                stream, self.n_clusters, self.random_state,
                self.init_max_iter, self.oversampling_factor)
        seeds = {"k-means++": 1, "random": 2}
        if self.init not in seeds:
            raise ValueError(f"Unknown init {self.init!r}")
        gen = _rank_generator(stream.device, self.random_state,
                              seeds[self.init])
        if self.init == "random":
            rows = _streamed_sample(stream, _uniform, gen, self.n_clusters)
            return torch.as_tensor(rows, device=stream.device)
        m = min(n_rows, max(10 * self.n_clusters, 500))
        sample = _streamed_sample(stream, _uniform, gen, m)
        centers = _kmeans_plusplus(
            sample.astype(np.float64), self.n_clusters,
            np.random.RandomState(0 if self.random_state is None
                                  else int(self.random_state)))
        return torch.as_tensor(centers, dtype=torch.float32,
                               device=stream.device)

    def _fit_streamed(self, X, block_rows):
        """Out-of-core Lloyd: X stays on the host (np.memmap or a large
        ndarray); every pass streams its blocks through the device and
        adds their statistics there. ``labels_`` is a host int32
        array."""
        from ..parallel import distributed as dist

        n, d = X.shape
        # several processes: X is this process's rows, n the global count
        n = int(dist.psum_host(np.asarray(float(n))))
        if self.n_clusters > n:
            raise ValueError(f"n_clusters={self.n_clusters} > n_samples={n}")
        dt_info = fit_dtype_info(self.fit_dtype)
        self.fit_dtype_ = dt_info["fit_dtype"]
        use_kernel = self.use_kernel is not False
        stream = BlockStream((X,), block_rows=block_rows)
        from .solvers.streamed import sparse_stream_info

        kernel, reason = "fused_kmeans_block_stats", None
        if stream.nnz_route:
            kernel, reason = None, "sparse-stream"
        elif not use_kernel:
            kernel, reason = None, "use_kernel=False"
        self.kernel_info_ = {"kernel": kernel, "kernel_reason": reason,
                             **dt_info, **sparse_stream_info(stream)}
        # sklearn's tol scaling needs the per-feature variance: one pass
        s = ss = None
        for blk in stream:
            bs, bss = _block_moments(blk.arrays[0], blk.n_rows)
            s = bs if s is None else s + bs
            ss = bss if ss is None else ss + bss
        s, ss = _merge((s, ss))
        mean = s / n
        tol2 = float(self.tol * (ss / n - mean * mean).mean())
        ckpt = self._make_ckpt(X, n, d, streamed=True)
        from ..reliability.stream_ckpt import restore_counted

        st = restore_counted(ckpt)
        if st is not None and st["centers"].shape == (self.n_clusters, d):
            # a resumed fit skips the init (k-means|| alone is several
            # passes over the data)
            centers0 = torch.as_tensor(st["centers"], dtype=torch.float32,
                                       device=stream.device)
            start_it = int(st["it"])
        else:
            centers0, start_it = self._init_centers_streamed(stream, d, n), 0
        centers, n_iter = _streamed_lloyd(stream, centers0, self.max_iter,
                                          tol2, self.fit_dtype, use_kernel,
                                          ckpt=ckpt, start_it=start_it)
        if ckpt is not None:
            ckpt.clear()
        self.training_profile_ = stream.profile_snapshot()
        # the labels keep X's rows: a non-finite block raises here
        if stream._nonfinite == "quarantine":
            stream._nonfinite = "raise"
        labels = np.empty(stream.n_rows, np.int32)
        inertia, cursor = 0.0, 0
        for blk in stream:
            m = blk.n_rows
            if stream.nnz_route:
                lb, ib = _sparse_labels_inertia(blk.arrays[0], m, centers)
            else:
                lb, ib = _labels_inertia(blk.arrays[0][:m], _ones(blk),
                                         centers, use_kernel)
            labels[cursor:cursor + m] = lb.cpu().numpy()
            inertia += float(ib)
            cursor += m
        inertia = float(dist.psum_host(np.asarray(inertia)))
        if not math.isfinite(inertia) or not bool(
                torch.isfinite(centers).all()):
            raise FloatingPointError(
                "KMeans produced non-finite centers/inertia: the input "
                "contains NaN/Inf"
            )
        self.cluster_centers_ = to_host(centers)
        self.labels_ = labels
        self.inertia_ = inertia
        self.n_iter_ = int(n_iter)
        self.n_features_in_ = d
        self.stream_stats_ = stream.totals
        return self

    def fit(self, X, y=None):
        block_rows = stream_plan(X)
        if block_rows is not None:
            return self._fit_streamed(X, block_rows)
        X = check_array(X, dtype=np.float32)
        from ..parallel.distributed import process_count

        if X.process_local and process_count() > 1:
            return self._fit_process_local(X)
        if self.n_clusters > X.n_rows:
            raise ValueError(
                f"n_clusters={self.n_clusters} > n_samples={X.n_rows}"
            )
        mask = X.row_mask(X.dtype)
        centers0 = self._init_centers(X)
        _, var = masked_mean_var(X.data, mask, X.n_rows)
        tol2 = float(self.tol * var.mean())
        stats, use_kernel = self._resident_stats()
        ckpt = self._make_ckpt(X, X.n_rows, X.shape[1], streamed=False)
        if ckpt is None:
            centers, n_iter, _ = _lloyd_run(X.data, X.n_rows, centers0,
                                            self.max_iter, tol2, stats)
        else:
            centers, n_iter = self._lloyd_chunks(X, centers0, tol2, stats,
                                                 ckpt)
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

    def _resident_stats(self):
        """(the statistics function of a resident Lloyd pass, use the
        kernels?), with ``fit_dtype_`` and ``kernel_info_`` set: the
        kernel runs f32 whatever the fit dtype asks."""
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
        return stats, use_kernel

    def _fit_process_local(self, X):
        """The resident Lloyd over a process-local array under several
        processes: each iteration's kernel-2 sums and counts merge
        across processes (``_merge``), the init runs the streamed inits
        over this process's rows as one block (their top-l, cost and
        weights merge alike), ``tol`` scales by the global variance, and
        ``labels_`` holds this process's rows (``inertia_`` is global).
        No checkpoint: a multi-process resume must be collective."""
        n = X.global_rows
        if self.n_clusters > n:
            raise ValueError(f"n_clusters={self.n_clusters} > n_samples={n}")
        d = X.shape[1]
        centers0 = self._init_centers_streamed(_OneBlock(X), d, n)
        s, ss = _merge(_block_moments(X.data, X.n_rows))
        mean = s / n
        tol2 = float(self.tol * (ss / n - mean * mean).mean())
        stats, use_kernel = self._resident_stats()

        def merged(Xd, n_valid, centers):
            sums, counts = _merge(stats(Xd, n_valid, centers)[:2])
            return sums, counts, None

        centers, n_iter, _ = _lloyd_run(X.data, X.n_rows, centers0,
                                        self.max_iter, tol2, merged)
        labels, inertia = _labels_inertia(X.data, X.row_mask(X.dtype),
                                          centers, use_kernel)
        (inertia,) = _merge((inertia.reshape(1),))
        inertia = float(inertia[0])
        if not math.isfinite(inertia) or not bool(
                torch.isfinite(centers).all()):
            raise FloatingPointError(
                "KMeans produced non-finite centers/inertia: the input "
                "contains NaN/Inf")
        self.cluster_centers_ = to_host(centers)
        self.labels_ = ShardedArray(labels, X.n_rows)
        self.inertia_ = inertia
        self.n_iter_ = int(n_iter)
        self.n_features_in_ = d
        return self

    def _lloyd_chunks(self, X, centers0, tol2, stats, ckpt):
        """The resident Lloyd loop in ``checkpoint_every``-iteration
        chunks, (centers, iteration, squared shift) saved after each, so
        a chunked fit takes the unchunked fit's iterations exactly."""
        from ..reliability.stream_ckpt import restore_counted

        st = restore_counted(ckpt)
        k, d = self.n_clusters, X.shape[1]
        centers, it, shift2 = centers0, 0, math.inf
        if st is not None and st["centers"].shape == (k, d):
            centers = torch.as_tensor(st["centers"], dtype=X.dtype,
                                      device=X.device)
            it, shift2 = int(st["it"]), float(st["shift2"])
        while it < self.max_iter and shift2 > tol2:
            stop = min(it + int(self.checkpoint_every), self.max_iter)
            centers, it, shift2 = _lloyd_run(X.data, X.n_rows, centers, stop,
                                             tol2, stats, it=it,
                                             shift2=shift2)
            ckpt.save(centers=to_host(centers), it=it,
                      shift2=np.float64(shift2))
        ckpt.clear()
        return centers, it

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

    def _streamed(self, X, fn):
        """``fn(valid rows, centers)`` mapped over X's blocks when X
        streams (a host array), else None."""
        block_rows = stream_plan(X)
        if block_rows is None:
            return None
        use_kernel = self._use_kernel_after_fit()

        def one(blk):
            c = torch.as_tensor(self.cluster_centers_, dtype=torch.float32,
                                device=blk.arrays[0].device)
            return fn(blk, c, use_kernel)

        return streamed_map(X, block_rows, one)

    def predict(self, X):
        check_is_fitted(self, "cluster_centers_")
        out = self._streamed(X, lambda blk, c, k: _block_labels_inertia(
            blk, c, k)[0])
        if out is not None:
            return out
        X, labels, _ = self._labels_inertia_of(X)
        return ShardedArray(labels, X.n_rows)

    def fit_predict(self, X, y=None):
        return self.fit(X).labels_

    def transform(self, X):
        check_is_fitted(self, "cluster_centers_")
        out = self._streamed(X, lambda blk, c, _: _block_distances(blk, c))
        if out is not None:
            return out
        X = check_array(X, dtype=np.float32)
        centers = torch.as_tensor(self.cluster_centers_, dtype=X.dtype,
                                  device=X.device)
        return ShardedArray(euclidean_distances(X.data, centers), X.n_rows)

    def score(self, X, y=None):
        check_is_fitted(self, "cluster_centers_")
        out = self._streamed(X, lambda blk, c, k: _block_labels_inertia(
            blk, c, k)[1][None])
        if out is not None:
            return -float(out.astype(np.float64).sum())
        _, _, inertia = self._labels_inertia_of(X)
        return -float(inertia)
