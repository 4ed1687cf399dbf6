"""Streamed randomized SVD: the out-of-core range finder.

Counterpart of ``dask_ml_tpu/models/streamed_svd.py`` on one device. X
stays on the host (an ``np.memmap`` or a tall ndarray) and flows
through the card in ``BlockStream`` blocks; the tall factor never
exists whole. Each pass adds, block by block, into carries on the
device:

- ``"moments"``: the shift-centered (Σc, Σc²) per feature, for the mean
  and the per-feature variance (the explained-variance ratios);
- ``"range"``: ``Z = Σ_b Xc_bᵀ (Xc_b Ω)`` (d, k'), the next subspace,
  and the R factor (k', k') of the tall ``Y = Xc Ω`` by the blocked-QR
  chain ``R ← qr([R; Y_b]).R``.

Between range passes the host re-orthonormalizes ``Ω ← qr(Z R⁻¹).Q``
(Halko's power step); the last pass doubles as the extraction:
``svd(R) = U_r S V_rᵀ`` and ``components = (Ω V_r)ᵀ``. A fit takes
``n_iter + 2`` passes.

The JAX package runs each pass as super-block scans of K blocks per XLA
dispatch, sharded over a mesh; here a pass launches per block (no
dispatch cost to amortise) on one device, and only the valid rows of a
block enter its products (the JAX scans mask the ragged tail to zero
rows, which leave Z and R unchanged). Ω is drawn by
``ops.linalg.draw_omega`` from ``random_state``; the JAX package draws
another Ω from the same seed.

Several processes (``parallel/distributed.py``): each process streams
its own rows; the row count, the shift (the global head mean), the
moments and Z merge by ``psum_host``, and the R chains by
``allgather_object`` and a host TSQR combine (``qr`` of the stacked R
factors), so every process holds the identical decomposition (JAX
``streamed_svd.py:322-403``). The merges run over the "data" collective:
under a ``"DxM"`` mesh the M ranks of a row group hold the same rows (a
TSQR over the world would stack each row group's R M times).

Feature-sharded (a ``"DxM"`` mesh whose stream tiles X, JAX's
``_pca_reducer_sharded``, ``dask_ml_tpu/models/streamed_svd.py:137-200``):
each rank streams its column tile; the moments and ``Z = Σ Xc_jᵀ Y_b``
are per-feature, merged over "data" then gathered over "model"; the
block's ``Y_b = Σ_j Xc_j Ω_j`` is the "model" collective of each
chunk's partial, so the R chain is the same on every rank of a row
group.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla
import torch

from ..ops import linalg
from ..parallel.model_axis import gather_features, model_sum
from ..parallel.streaming import BlockStream, _slice_dense

# why a sparse X streams densified in the decompositions: their blocks
# feed dense products (the JAX reason of a stream that the per-block
# path consumes)
DENSE_BLOCKS = "per-block-path"

# d at which the streamed Gram path's d x d covariance stops being the
# cheap one-pass answer and the O(d k') randomized path takes over for
# svd_solver="auto" fits
STREAM_GRAM_MAX_D = 4096
# rows of X's head whose mean shifts the streamed sums
_SHIFT_ROWS = 4096
# rows of a block centered and multiplied at a time: a block's products
# then hold chunk-sized temporaries (64 MB at d = 512), not a centered
# copy of the block and the GEMM's workspace for a 131,072-row sum,
# which took the streamed Gram past (prefetch + 2) blocks on the H100
CHUNK_ROWS = 1 << 15


def head_shift(X, d):
    """The mean of X's first rows in float64: any shift near the mean
    keeps the f32 block sums O(n·std²) instead of O(n·mean²). Under
    several processes the mean of every row group's head, so the shift
    is identical everywhere (sums under different shifts cannot merge)."""
    from ..parallel import distributed as dist

    head = _slice_dense(X, 0, min(_SHIFT_ROWS, X.shape[0]), np.float64)
    if dist.process_count() > 1:
        hs, hn = dist.psum_host(head.sum(axis=0) if len(head)
                                else np.zeros(d),
                                np.asarray(float(len(head))), group="data")
        return hs / max(float(hn), 1.0)
    return head.mean(axis=0) if len(head) else np.zeros(d)


def global_rows(n_local):
    """The row count over every row group (``n_local`` for one
    process)."""
    from ..parallel import distributed as dist

    return int(dist.psum_host(np.asarray(float(n_local)), group="data"))


def tsqr_combine(R):
    """The R factor of the rows of every row group: the stacked R chains
    of the "data" collective, one QR."""
    from ..parallel import distributed as dist

    if dist.process_count() == 1:
        return R
    return np.linalg.qr(np.concatenate(dist.allgather_object(R, "data"),
                                       0))[1]


def _moments_block(acc, x, shift):
    for i in range(0, x.shape[0], CHUNK_ROWS):
        c = x[i:i + CHUNK_ROWS] - shift
        acc[0] += c.sum(0)
        acc[1] += c.square_().sum(0)


def _range_block(acc, x, mean, omega, tiled=False):
    """One block into the range pass's (Z, R); ``tiled``: x, mean and
    omega are this rank's tile, and each chunk's ``Y`` is the "model"
    collective of the tiles' partials."""
    ys = []
    for i in range(0, x.shape[0], CHUNK_ROWS):
        cb = x[i:i + CHUNK_ROWS] - mean
        y = cb @ omega
        if tiled:
            y = model_sum(y)
        ys.append(y)
        acc[0] += cb.T @ ys[-1]
    acc[1] = torch.linalg.qr(torch.cat([acc[1]] + ys), mode="r")[1]


def _orth_next(Z, R):
    """Host half-iteration: ``Ω_next = qr(Z R⁻¹).Q``, the
    re-orthonormalized power step (span(Z R⁻¹) = span(Xᵀ Q_y)). Takes
    the pseudo-inverse when the chain's R is rank-deficient (degenerate
    spectra); qr still returns a full orthonormal basis."""
    try:
        w = sla.solve_triangular(R.T, Z.T, lower=True).T
    except (np.linalg.LinAlgError, ValueError):
        w = None
    if w is None or not np.all(np.isfinite(w)):
        w = Z @ np.linalg.pinv(R)
    return np.linalg.qr(w)[0]


def streamed_randomized_svd(X, block_rows, size, n_iter, random_state, *,
                            center=True):
    """The streamed randomized SVD passes over ``X`` (module docstring).

    Returns a dict: ``s`` (size,) singular values (descending), ``vt``
    (size, d) right singular vectors, ``mean`` (d,) float64 data mean,
    ``var0``/``var1`` (d,) float64 per-feature variance (ddof 0 / 1),
    ``n`` rows, ``passes`` data passes, ``stream`` (its ``totals`` are
    the fit's stream statistics). ``center=False`` (TruncatedSVD) keeps
    the SVD uncentered and still returns the moments."""
    from ..parallel import distributed as dist

    reduce = dist.host_reduce("data")
    d = int(X.shape[1])
    n = global_rows(int(X.shape[0]))
    size = int(size)
    stream = BlockStream((X,), block_rows=block_rows,
                         densify_reason=DENSE_BLOCKS, feature_tiles=True)
    tiled = stream.model_tiled
    lo, hi = stream.tile if tiled else (0, d)
    dev = stream.device
    shift = head_shift(X, d)

    acc = [torch.zeros(hi - lo, device=dev), torch.zeros(hi - lo, device=dev)]
    shift_dev = torch.as_tensor(shift[lo:hi], dtype=torch.float32,
                                device=dev)
    for blk in stream:
        _moments_block(acc, blk.arrays[0][: blk.n_rows], shift_dev)
    s1 = acc[0].double().cpu().numpy()
    s2 = acc[1].double().cpu().numpy()
    if reduce is not None:
        s1, s2 = reduce(s1, s2)
    if tiled:
        s1, s2 = gather_features(s1), gather_features(s2)
    mean_c = s1 / n
    mean = shift + mean_c
    var0 = np.maximum(s2 / n - mean_c * mean_c, 0.0)
    var1 = np.maximum((s2 - s1 * s1 / n) / max(n - 1, 1), 0.0)

    mean_dev = torch.as_tensor((mean if center else np.zeros(d))[lo:hi],
                               dtype=torch.float32, device=dev)
    omega = linalg.draw_omega(d, size, random_state, dev).cpu().numpy()
    n_range = max(int(n_iter), 1) + 1
    Z = R = None
    for p in range(n_range):
        acc = [torch.zeros((hi - lo, size), device=dev),
               torch.zeros((size, size), device=dev)]
        omega_dev = torch.as_tensor(omega[lo:hi], dtype=torch.float32,
                                    device=dev)
        for blk in stream:
            _range_block(acc, blk.arrays[0][: blk.n_rows], mean_dev,
                         omega_dev, tiled)
        Z = acc[0].double().cpu().numpy()
        R = acc[1].double().cpu().numpy()
        if reduce is not None:
            Z = reduce(Z)
            R = tsqr_combine(R)
        if tiled:
            Z = gather_features(Z, axis=0)
        if p < n_range - 1:
            omega = _orth_next(Z, R).astype(np.float32)

    # extraction: Y = Xc Ω (Ω orthonormal) = Q R and svd(R) = U_r S V_rᵀ,
    # so X ≈ (Q U_r) S (Ω V_r)ᵀ; the small factors are host-sized
    _, s, vt_r = np.linalg.svd(R)
    vt = (omega.astype(np.float64) @ vt_r.T).T
    return {"s": s, "vt": vt, "mean": mean, "var0": var0, "var1": var1,
            "n": n, "passes": 1 + n_range, "stream": stream}


def flip_signs_vt(vt):
    """Deterministic component signs, V-based (the ``linalg.svd_flip``
    convention on host float64): each row's largest-|.| entry
    positive."""
    max_abs = np.argmax(np.abs(vt), axis=1)
    signs = np.sign(vt[np.arange(vt.shape[0]), max_abs])
    return vt * np.where(signs == 0, 1.0, signs)[:, None]
