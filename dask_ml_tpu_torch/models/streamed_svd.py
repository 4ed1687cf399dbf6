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
rows, which leave Z and R unchanged). The multi-process merge of the
carries (``dist.psum_host``) is not ported (ROADMAP.md queue 1,
Multi-GPU). Ω is drawn by ``ops.linalg.draw_omega`` from
``random_state``; the JAX package draws another Ω from the same seed.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla
import torch

from ..ops import linalg
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
    keeps the f32 block sums O(n·std²) instead of O(n·mean²)."""
    head = _slice_dense(X, 0, min(_SHIFT_ROWS, X.shape[0]), np.float64)
    return head.mean(axis=0) if len(head) else np.zeros(d)


def _moments_block(acc, x, shift):
    for i in range(0, x.shape[0], CHUNK_ROWS):
        c = x[i:i + CHUNK_ROWS] - shift
        acc[0] += c.sum(0)
        acc[1] += c.square_().sum(0)


def _range_block(acc, x, mean, omega):
    ys = []
    for i in range(0, x.shape[0], CHUNK_ROWS):
        cb = x[i:i + CHUNK_ROWS] - mean
        ys.append(cb @ omega)
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
    n, d = int(X.shape[0]), int(X.shape[1])
    size = int(size)
    stream = BlockStream((X,), block_rows=block_rows,
                         densify_reason=DENSE_BLOCKS)
    dev = stream.device
    shift = head_shift(X, d)

    acc = [torch.zeros(d, device=dev), torch.zeros(d, device=dev)]
    shift_dev = torch.as_tensor(shift, dtype=torch.float32, device=dev)
    for blk in stream:
        _moments_block(acc, blk.arrays[0][: blk.n_rows], shift_dev)
    s1 = acc[0].double().cpu().numpy()
    s2 = acc[1].double().cpu().numpy()
    mean_c = s1 / n
    mean = shift + mean_c
    var0 = np.maximum(s2 / n - mean_c * mean_c, 0.0)
    var1 = np.maximum((s2 - s1 * s1 / n) / max(n - 1, 1), 0.0)

    mean_dev = torch.as_tensor(mean if center else np.zeros(d),
                               dtype=torch.float32, device=dev)
    omega = linalg.draw_omega(d, size, random_state, dev).cpu().numpy()
    n_range = max(int(n_iter), 1) + 1
    Z = R = None
    for p in range(n_range):
        acc = [torch.zeros((d, size), device=dev),
               torch.zeros((size, size), device=dev)]
        omega_dev = torch.as_tensor(omega, dtype=torch.float32, device=dev)
        for blk in stream:
            _range_block(acc, blk.arrays[0][: blk.n_rows], mean_dev,
                         omega_dev)
        Z = acc[0].double().cpu().numpy()
        R = acc[1].double().cpu().numpy()
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
