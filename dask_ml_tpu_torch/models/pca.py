"""PCA, TruncatedSVD and IncrementalPCA, in memory and out of core.

Counterpart of ``dask_ml_tpu/models/pca.py``: the same parameters,
solver rules and fitted attributes. In memory, the exact solver is the
SVD of R from one QR of the centered X (``ops.linalg.svd_tall``; a fit
that needs no scores computes R alone), and the randomized solver is
Halko's range finder (``ops.linalg.randomized_svd``). Padding rows of a
caller's ``ShardedArray`` are zeroed after centering, so they leave R
and the range unchanged.

Out of core (an ``np.memmap``, or an ndarray taller than a positive
``config.stream_block_rows``), ``PCA`` takes one streamed moments pass
(Σ(x − shift) and the Gram Σ(x − shift)(x − shift)ᵀ per block, added in
float64 on the device) and an ``eigh`` of the d x d covariance on the
host; with ``svd_solver="randomized"``, or d past ``STREAM_GRAM_MAX_D``
under ``"auto"``, it and ``TruncatedSVD(algorithm="randomized")`` take
the streamed range finder of ``models/streamed_svd.py``. ``transform``
and ``score_samples`` stream such inputs block by block. The fits keep
the stream's statistics in ``stream_stats_`` (the route of its reader
per pass in ``reader_passes``).

``IncrementalPCA`` updates an SVD block by block (Ross et al. 2008, as
sklearn does): the SVD of the stacked [S·Vt; Xb − mean_b; correction]
is taken through the QR of the stack (the SVD of its R factor gives the
same s and Vt).

A sparse X (scipy sparse or ``SparseBlocks``) streams densified: every
block is scattered into the stream's pinned buffer on the host (the
densify route, ``"per-block-path"``), as the JAX fits densify a block at
a time; IncrementalPCA densifies each of its batches. TruncatedSVD's
``transform`` of a sparse X takes the nnz route (its product is
``X Vᵀ``).

A streamed PCA fit carries ``training_profile_``, the per-feature
sketch of its first pass (``BlockStream.profile_snapshot``), as the JAX
PCA does; an in-memory fit has none.

Several processes (``parallel/distributed.py``): the streamed PCA (Gram
and randomized) and TruncatedSVD fits stream each process's own rows and
merge the row count, the shift and the sums by ``psum_host`` (the
randomized range passes' R chains by a host TSQR combine,
``models/streamed_svd.py``); IncrementalPCA refuses, its update being
sequential, as in the JAX package. A fit agrees on its route first
(``fit_stream_plan``): a process shorter than a block streams its one
block, an empty one none, adding zero sums. Under a ``"DxM"`` mesh the
merges run over the "data" collective; the randomized range passes
stream each rank's column tile (``models/streamed_svd.py``), the Gram
pass runs model-replicated (whole rows on every rank of a row group).

The exact resident fit (``svd_solver`` "full"/"tsqr", or "auto" when it
resolves to the exact solver) over a process-local or feature-sharded
``ShardedArray`` merges too (``_fit_merged``): the mean over the row
groups, the R factor of the centered rows chained a chunk at a time
(a feature-sharded array's chunks gathered whole over "model", as
JAX's GSPMD gathers them for its QR) and combined over "data" by one
QR of the stacked factors. Its randomized solver over such an array
raises, naming ROADMAP.md queue 1, Multi-GPU, part 3.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import BaseEstimator, TransformerMixin, to_host
from ..config import fit_dtype_info, mxu_dtype, resolve_device
from ..ops import linalg
from ..ops.reductions import masked_mean_var
from ..parallel.sharded import ShardedArray
from ..ops.sparse_kernels import block_matmul
from ..parallel.streaming import (BlockStream, _is_sparse_source,
                                  _slice_dense, fit_stream_plan, stream_plan,
                                  streamed_map)
from ..utils.validation import check_array, check_is_fitted
from .streamed_svd import (CHUNK_ROWS, DENSE_BLOCKS, STREAM_GRAM_MAX_D,
                           flip_signs_vt, global_rows, head_shift,
                           streamed_randomized_svd, tsqr_combine)


def _resolve_n_components(n_components, n, d):
    if n_components is None:
        return min(n, d)
    if isinstance(n_components, float) and not n_components.is_integer():
        raise ValueError(
            "float n_components means a variance fraction and requires "
            "svd_solver='full'"
        )
    n_components = int(n_components)
    if not 0 < n_components <= min(n, d):
        raise ValueError(
            f"n_components={n_components} must be in (0, {min(n, d)}]"
        )
    return n_components


def _block_pca_moments(x, shift, mxu=None):
    """(Σ(x − shift), Σ(x − shift)(x − shift)ᵀ) of one block's valid rows,
    in float32, ``CHUNK_ROWS`` rows at a time. ``shift`` near the mean
    keeps the sums O(n_b·std²).

    ``mxu=torch.bfloat16`` (``fit_dtype="bfloat16"``): the Gram's
    operands are rounded to bf16 and multiplied as f32 (TF32 off), which
    gives the f32 sums of exact bf16 products, as the JAX package's bf16
    einsum with ``preferred_element_type=f32`` does; the mean sums stay
    f32."""
    d = x.shape[1]
    s = torch.zeros(d, device=x.device)
    g = torch.zeros((d, d), device=x.device)
    for i in range(0, x.shape[0], CHUNK_ROWS):
        xc = x[i:i + CHUNK_ROWS] - shift
        s += xc.sum(0)
        if mxu is not None:
            xc = xc.to(mxu).float()
        g += xc.T @ xc
    return s, g


def _merges(X):
    """A resident fit of ``X`` merges across processes: a feature-sharded
    array, or a process-local one under several processes."""
    from ..parallel.distributed import process_count

    return X.model_sharded or (X.process_local and process_count() > 1)


def _fraction_k(ev, total_var, frac):
    """sklearn's variance-fraction rule: the fewest leading components
    whose explained-variance ratios add up past ``frac``."""
    return int(np.searchsorted(np.cumsum(ev / total_var), frac) + 1)


def _noise_variance(total_var, ev, k, n, d):
    if k < min(n, d):
        return max((total_var - ev[:k].sum()) / (min(n, d) - k), 0.0)
    return 0.0


class PCA(TransformerMixin, BaseEstimator):
    """Ref: dask_ml/decomposition/pca.py::PCA."""

    def __init__(self, n_components=None, copy=True, whiten=False,
                 svd_solver="auto", tol=0.0, iterated_power=0,
                 random_state=None, fit_dtype=None):
        self.n_components = n_components
        self.copy = copy
        self.whiten = whiten
        self.svd_solver = svd_solver
        self.tol = tol
        self.iterated_power = iterated_power
        self.random_state = random_state
        # precision of the streamed Gram (None = config.dtype); the
        # resolved choice lands on fit_dtype_
        self.fit_dtype = fit_dtype

    def _solver(self, k, n, d):
        if self.svd_solver == "auto":
            # randomized when asking for a small fraction of a wide
            # matrix (sklearn's heuristic); exact otherwise
            return "randomized" if k < 0.8 * min(n, d) and min(n, d) > 200 \
                else "full"
        if self.svd_solver in ("full", "tsqr"):
            return "full"
        if self.svd_solver == "randomized":
            return "randomized"
        raise ValueError(f"Unknown svd_solver {self.svd_solver!r}")

    def _components_request(self, n, d):
        """(variance fraction or None, k) of ``n_components``."""
        if isinstance(self.n_components, float) \
                and 0.0 < self.n_components < 1.0:
            return self.n_components, min(n, d)
        return None, _resolve_n_components(self.n_components, n, d)

    def fit(self, X, y=None):
        block_rows = fit_stream_plan(X)
        if block_rows is not None:
            return self._fit_streamed(X, block_rows)
        self._fit(X)
        return self

    def _fit_streamed(self, X, block_rows):
        """Out-of-core fit by one streamed moments pass: (Σx, Σxxᵀ) per
        block, then ``eigh`` of the d x d covariance on the host. For
        the tall-skinny shapes this estimator serves, the Gram gives the
        whole spectrum in one pass, where Halko needs ``n_iter + 2``.
        Under several processes X is this process's rows: the row count,
        shift and sums merge by ``psum_host``."""
        from ..parallel import distributed as dist

        d = int(X.shape[1])
        n = global_rows(int(X.shape[0]))
        if n < d:
            raise ValueError(
                "PCA requires tall data (n_samples >= n_features); got "
                f"{n} x {d}"
            )
        frac, k = self._components_request(n, d)
        if frac is None and self._solver(k, n, d) == "randomized" and (
                self.svd_solver == "randomized" or d > STREAM_GRAM_MAX_D):
            return self._fit_streamed_randomized(X, block_rows, k, n, d)
        stream = BlockStream((X,), block_rows=block_rows,
                             densify_reason=DENSE_BLOCKS)
        dev = stream.device
        shift = head_shift(X, d)
        shift_dev = torch.as_tensor(shift, dtype=torch.float32, device=dev)
        mxu = mxu_dtype(self.fit_dtype)
        self.fit_dtype_ = fit_dtype_info(self.fit_dtype)["fit_dtype"]
        s = torch.zeros(d, dtype=torch.float64, device=dev)
        g = torch.zeros((d, d), dtype=torch.float64, device=dev)
        for blk in stream:
            bs, bg = _block_pca_moments(blk.arrays[0][: blk.n_rows],
                                        shift_dev, mxu)
            s += bs.double()
            g += bg.double()
        s, g = s.cpu().numpy(), g.cpu().numpy()
        if dist.process_count() > 1:
            s, g = dist.psum_host(s, g, group="data")
        mean_c = s / n  # mean of the shifted data
        cov = (g - n * np.outer(mean_c, mean_c)) / (n - 1)
        evals, evecs = np.linalg.eigh(cov)
        order = np.argsort(evals)[::-1]
        ev = np.maximum(evals[order], 0.0)
        vt = flip_signs_vt(evecs[:, order].T)
        total_var = float(ev.sum())
        if frac is not None:
            k = _fraction_k(ev, total_var, frac)
        self.n_components_ = k
        self.components_ = vt[:k]
        self.explained_variance_ = ev[:k]
        self.explained_variance_ratio_ = ev[:k] / total_var
        self.singular_values_ = np.sqrt(ev[:k] * (n - 1))
        self.mean_ = shift + mean_c
        self.noise_variance_ = _noise_variance(total_var, ev, k, n, d)
        self.n_features_in_ = d
        self.n_samples_ = n
        self.stream_stats_ = stream.totals
        self.training_profile_ = stream.profile_snapshot()
        return self

    def _fit_streamed_randomized(self, X, block_rows, k, n, d):
        """Out-of-core randomized fit: the streamed range finder of
        ``models/streamed_svd.py``, O(d·k') on the device where the Gram
        holds d x d."""
        # the range passes accumulate f32: the QR chain has no bf16 form
        self.fit_dtype_ = "float32"
        out = streamed_randomized_svd(
            X, block_rows, min(k + 10, min(n, d)),
            max(int(self.iterated_power), 2), self.random_state,
            center=True,
        )
        vt = flip_signs_vt(out["vt"])
        s = out["s"]
        ev = s.astype(np.float64) ** 2 / (n - 1)
        total_var = float(out["var1"].sum())
        self.n_components_ = k
        self.components_ = vt[:k]
        self.explained_variance_ = ev[:k]
        self.explained_variance_ratio_ = ev[:k] / total_var
        self.singular_values_ = s[:k].astype(np.float64)
        self.mean_ = out["mean"]
        self.noise_variance_ = _noise_variance(total_var, ev, k, n, d)
        self.n_features_in_ = d
        self.n_samples_ = n
        self.stream_stats_ = out["stream"].totals
        self.training_profile_ = out["stream"].profile_snapshot()
        return self

    def _fit(self, X, compute_u=False):
        """The in-memory fit; returns (X, U or None, s, Vt, mask)."""
        X = check_array(X, dtype=np.float32)
        if _merges(X):
            if compute_u:
                raise NotImplementedError(
                    "fit_transform over a process-local or feature-sharded "
                    "array: fit, then transform (ROADMAP.md queue 1, "
                    "Multi-GPU, part 3)")
            return self._fit_merged(X)
        n, d = X.shape
        if n < d:
            raise ValueError(
                "PCA requires tall data (n_samples >= n_features); got "
                f"{n} x {d}"
            )
        frac, k = self._components_request(n, d)
        if frac is not None and self._solver(min(n, d), n, d) != "full" \
                and self.svd_solver not in ("auto", "full", "tsqr"):
            raise ValueError(
                "n_components as a variance fraction requires "
                "svd_solver in ('auto', 'full', 'tsqr')"
            )
        mask = X.row_mask(X.dtype)
        mean, var = masked_mean_var(X.data, mask, n, ddof=1)
        xc = (X.data - mean) * mask[:, None]
        solver = "full" if frac is not None else self._solver(k, n, d)
        if solver == "full":
            u, s, vt = linalg.svd_tall(xc, compute_u=compute_u)
        else:
            u, s, vt = linalg.randomized_svd(
                xc, k, self.random_state,
                n_iter=max(int(self.iterated_power), 2))
            u = u if compute_u else None
        del xc
        u, vt = linalg.svd_flip(u, vt)
        total_var = float(var.sum())
        s_h = to_host(s).astype(np.float64)
        ev = s_h ** 2 / (n - 1)
        if frac is not None:
            k = _fraction_k(ev, total_var, frac)
        self.n_components_ = k
        self.components_ = to_host(vt)[:k].astype(np.float64)
        self.explained_variance_ = ev[:k]
        self.explained_variance_ratio_ = ev[:k] / total_var
        self.singular_values_ = s_h[:k]
        self.mean_ = to_host(mean).astype(np.float64)
        self.noise_variance_ = _noise_variance(total_var, ev, k, n, d)
        self.n_features_in_ = d
        self.n_samples_ = n
        return X, u, s, vt, mask

    def _fit_merged(self, X):
        """The exact resident fit over a process-local or feature-sharded
        array (module docstring); returns (X, None, s, Vt, mask) on the
        host's float64 R."""
        from ..parallel import distributed as dist
        from ..parallel.model_axis import gather_features

        n, d = X.global_rows, X.shape[1]
        if n < d:
            raise ValueError(
                "PCA requires tall data (n_samples >= n_features); got "
                f"{n} x {d}")
        frac, k = self._components_request(n, d)
        if frac is None and self._solver(k, n, d) != "full":
            raise NotImplementedError(
                "the randomized resident PCA over a process-local or "
                "feature-sharded array is not ported (ROADMAP.md queue 1, "
                "Multi-GPU, part 3); use svd_solver='full', or stream X")
        reduce = dist.host_reduce("data") if X.process_local else None
        data = X.data[: X.n_rows].to(torch.float64)
        s1 = data.sum(0).cpu().numpy()
        if reduce is not None:
            s1 = reduce(s1)
        if X.model_sharded:
            s1 = gather_features(s1)
        mean = s1 / n
        lo = X.col_offset
        xc = data - torch.as_tensor(mean[lo:lo + data.shape[1]],
                                    device=data.device)
        ss = (xc * xc).sum(0).cpu().numpy()
        if reduce is not None:
            ss = reduce(ss)
        if X.model_sharded:
            ss = gather_features(ss)
        total_var = float(ss.sum()) / (n - 1)
        R = torch.zeros((0, d), dtype=torch.float64, device=data.device)
        for i in range(0, max(X.n_rows, 1), CHUNK_ROWS):
            c = xc[i:i + CHUNK_ROWS]
            if X.model_sharded:
                c = gather_features(c, axis=1)
            R = torch.linalg.qr(torch.cat([R, c]), mode="r")[1]
        R = tsqr_combine(R.cpu().numpy())
        _, s_h, vt = np.linalg.svd(R, full_matrices=False)
        vt = flip_signs_vt(vt)
        ev = s_h ** 2 / (n - 1)
        if frac is not None:
            k = _fraction_k(ev, total_var, frac)
        self.n_components_ = k
        self.components_ = vt[:k]
        self.explained_variance_ = ev[:k]
        self.explained_variance_ratio_ = ev[:k] / total_var
        self.singular_values_ = s_h[:k]
        self.mean_ = mean
        self.noise_variance_ = _noise_variance(total_var, ev, k, n, d)
        self.n_features_in_ = d
        self.n_samples_ = n
        return X, None, s_h, vt, X.row_mask(X.dtype)

    def fit_transform(self, X, y=None):
        block_rows = fit_stream_plan(X)
        if block_rows is not None:
            # streamed fit, then the block-wise transform: X never
            # exists whole on the device
            return self._fit_streamed(X, block_rows).transform(X)
        X, u, s, _, mask = self._fit(X, compute_u=True)
        k = self.n_components_
        scores = u[:, :k] * s[None, :k]
        if self.whiten:
            scores = scores * (self.n_samples_ - 1) ** 0.5 / s[None, :k]
        return ShardedArray(scores * mask[:, None], X.n_rows)

    def _device_params(self, device):
        comp = torch.as_tensor(self.components_, dtype=torch.float32,
                               device=device)
        mean = torch.as_tensor(self.mean_, dtype=torch.float32,
                               device=device)
        scale = (torch.as_tensor(self.explained_variance_,
                                 dtype=torch.float32, device=device).sqrt()
                 if self.whiten else None)
        return comp, mean, scale

    def transform(self, X):
        check_is_fitted(self, "components_")
        block_rows = stream_plan(X)
        if block_rows is not None:
            comp, mean, scale = self._device_params(resolve_device())

            def block_scores(blk):
                sc = (blk.arrays[0] - mean) @ comp.T
                return sc / scale if scale is not None else sc

            return streamed_map(X, block_rows, block_scores,
                                densify_reason=DENSE_BLOCKS)
        X = check_array(X, dtype=np.float32)
        comp, mean, scale = self._device_params(X.device)
        mask = X.row_mask(X.dtype)
        if X.model_sharded:
            # the tile's partial scores, summed over the "model" collective
            from ..parallel.model_axis import tile_matmul

            lo, hi = X.col_offset, X.col_offset + X.data.shape[1]
            scores = tile_matmul((X.data - mean[lo:hi]) * mask[:, None],
                                 comp.T, lo)
        else:
            scores = ((X.data - mean) * mask[:, None]) @ comp.T
        if scale is not None:
            scores = scores / scale
        return ShardedArray(scores, X.n_rows)

    def inverse_transform(self, X):
        check_is_fitted(self, "components_")
        X = check_array(X, dtype=np.float32)
        comp, mean, scale = self._device_params(X.device)
        scores = X.data if scale is None else X.data * scale
        out = (scores @ comp + mean) * X.row_mask(X.dtype)[:, None]
        return ShardedArray(out, X.n_rows)

    # -- probabilistic PCA scoring (sklearn parity) ------------------------
    def _scoring_components(self):
        """(components, explained_variance) with sklearn's whiten
        adjustment: whitened components_ are unit-scaled, so the model
        covariance needs them rescaled by sqrt(ev)."""
        comp = np.asarray(self.components_, np.float64)
        ev = np.asarray(self.explained_variance_, np.float64)
        if getattr(self, "whiten", False):
            comp = comp * np.sqrt(ev)[:, None]
        return comp, ev

    def get_covariance(self):
        """components_ᵀ diag(ev − σ²) components_ + σ² I, on the host
        (d x d)."""
        check_is_fitted(self, "components_")
        comp, ev = self._scoring_components()
        sigma2 = float(self.noise_variance_)
        cov = (comp.T * np.maximum(ev - sigma2, 0.0)) @ comp
        cov[np.diag_indices_from(cov)] += max(sigma2, 0.0)
        return cov

    def get_precision(self):
        check_is_fitted(self, "components_")
        d = self.components_.shape[1]
        sigma2 = float(self.noise_variance_)
        if sigma2 <= 0.0:  # also roundoff-negative: Woodbury would flip
            return np.linalg.pinv(self.get_covariance())
        # Woodbury (sklearn's formula): no inverse of the full covariance
        comp, ev = self._scoring_components()
        scaled = comp * np.sqrt(np.maximum(ev - sigma2, 0.0))[:, None]
        k = comp.shape[0]
        inner = scaled @ scaled.T / sigma2 + np.eye(k)
        return (np.eye(d) - scaled.T @ np.linalg.solve(inner, scaled)
                / sigma2) / sigma2

    def score_samples(self, X):
        """Per-sample log-likelihood under the probabilistic PCA model
        (host numpy). The d x d precision is host math; the (n, d)
        quadratic form runs on the device, block by block out of
        core."""
        check_is_fitted(self, "components_")
        precision = self.get_precision()
        d = np.shape(X)[1]
        sign, logdet = np.linalg.slogdet(precision)
        const = -0.5 * (d * np.log(2.0 * np.pi) - sign * logdet)
        block_rows = stream_plan(X)
        if block_rows is not None:
            dev = resolve_device()
            mean = torch.as_tensor(self.mean_, dtype=torch.float32,
                                   device=dev)
            prec = torch.as_tensor(precision, dtype=torch.float32,
                                   device=dev)

            def block_ll(blk):
                xc = blk.arrays[0] - mean
                return -0.5 * ((xc @ prec) * xc).sum(1) + const

            return streamed_map(X, block_rows, block_ll,
                                densify_reason=DENSE_BLOCKS)
        X = check_array(X, dtype=np.float32)
        mean = torch.as_tensor(self.mean_, dtype=torch.float32,
                               device=X.device)
        prec = torch.as_tensor(precision, dtype=torch.float32,
                               device=X.device)
        xc = (X.data - mean) * X.row_mask(X.dtype)[:, None]
        quad = ((xc @ prec) * xc).sum(1)
        return to_host(-0.5 * quad + const)[: X.n_rows]

    def score(self, X, y=None):
        """Mean per-sample log-likelihood (sklearn parity)."""
        return float(np.mean(self.score_samples(X)))


class TruncatedSVD(TransformerMixin, BaseEstimator):
    """Ref: dask_ml/decomposition/truncated_svd.py::TruncatedSVD: PCA's
    SVD solvers without centering."""

    def __init__(self, n_components=2, algorithm="tsqr", n_iter=5,
                 random_state=None, tol=0.0, compute=True):
        self.n_components = n_components
        self.algorithm = algorithm
        self.n_iter = n_iter
        self.random_state = random_state
        self.tol = tol
        self.compute = compute

    def fit(self, X, y=None):
        block_rows = fit_stream_plan(X)
        if block_rows is not None:
            return self._fit_streamed(X, block_rows)
        self.fit_transform(X)
        return self

    def _fit_streamed(self, X, block_rows):
        """Out-of-core fit by the streamed randomized SVD, uncentered."""
        n, d = global_rows(int(X.shape[0])), int(X.shape[1])
        k = self.n_components
        if not 0 < k < d:
            raise ValueError(f"n_components={k} must be in (0, {d})")
        if self.algorithm != "randomized":
            raise ValueError(
                "streamed TruncatedSVD requires algorithm='randomized' "
                "(the exact TSQR factorization needs the resident "
                f"matrix); got algorithm={self.algorithm!r}"
            )
        out = streamed_randomized_svd(
            X, block_rows, min(k + 10, min(n, d)), max(int(self.n_iter), 1),
            self.random_state, center=False,
        )
        vt = flip_signs_vt(out["vt"])[:k]
        s = out["s"][:k].astype(np.float64)
        # the scores' variance without a scores pass: the scores are XV,
        # so E[(xv_j)²] = s_j²/n, and their means come from the data mean
        sc_mean = out["mean"] @ vt.T
        ev = np.maximum(s ** 2 / n - sc_mean ** 2, 0.0)
        self.components_ = vt
        self.explained_variance_ = ev
        self.explained_variance_ratio_ = ev / float(out["var0"].sum())
        self.singular_values_ = s
        self.n_features_in_ = d
        self.stream_stats_ = out["stream"].totals
        return self

    def fit_transform(self, X, y=None):
        block_rows = fit_stream_plan(X)
        if block_rows is not None:
            return self._fit_streamed(X, block_rows).transform(X)
        X = check_array(X, dtype=np.float32)
        if _merges(X):
            raise NotImplementedError(
                "the resident TruncatedSVD over a process-local or "
                "feature-sharded array is not ported (ROADMAP.md queue 1, "
                "Multi-GPU, part 3); stream X")
        n, d = X.shape
        k = self.n_components
        if not 0 < k < d:
            raise ValueError(f"n_components={k} must be in (0, {d})")
        mask = X.row_mask(X.dtype)
        data = X.data * mask[:, None]
        if self.algorithm == "tsqr":
            if n < d:
                raise ValueError(
                    "tsqr algorithm requires n_samples >= n_features")
            u, s, vt = linalg.svd_tall(data)
        elif self.algorithm == "randomized":
            u, s, vt = linalg.randomized_svd(data, k, self.random_state,
                                             n_iter=self.n_iter)
        else:
            raise ValueError(f"Unknown algorithm {self.algorithm!r}")
        u, vt = linalg.svd_flip(u, vt)
        u, s, vt = u[:, :k], s[:k], vt[:k]
        scores = u * s[None, :]
        del u
        # explained variance of the scores (sklearn semantics)
        sc_mean = (scores * mask[:, None]).sum(0) / n
        ev = (((scores - sc_mean) ** 2) * mask[:, None]).sum(0) / n
        _, full_var = masked_mean_var(X.data, mask, n, ddof=0)
        self.components_ = to_host(vt).astype(np.float64)
        self.explained_variance_ = to_host(ev).astype(np.float64)
        self.explained_variance_ratio_ = self.explained_variance_ / float(
            full_var.sum())
        self.singular_values_ = to_host(s).astype(np.float64)
        self.n_features_in_ = d
        return ShardedArray(scores, X.n_rows)

    def transform(self, X):
        check_is_fitted(self, "components_")
        block_rows = stream_plan(X)
        if block_rows is not None:
            comp = torch.as_tensor(self.components_, dtype=torch.float32,
                                   device=resolve_device())
            return streamed_map(X, block_rows, lambda blk: block_matmul(
                blk.arrays[0], comp.T))
        X = check_array(X, dtype=np.float32)
        comp = torch.as_tensor(self.components_, dtype=torch.float32,
                               device=X.device)
        return ShardedArray(X.data @ comp.T, X.n_rows)

    def inverse_transform(self, X):
        check_is_fitted(self, "components_")
        X = check_array(X, dtype=np.float32)
        comp = torch.as_tensor(self.components_, dtype=torch.float32,
                               device=X.device)
        return ShardedArray(X.data @ comp, X.n_rows)


def _ipca_update(components, singular, mean, n_seen, xb):
    """One incremental-PCA block update: the SVD of [S·Vt; Xb − mean_b;
    mean correction], through the QR of the stack when it is tall."""
    m = xb.shape[0]
    col_mean = xb.mean(0)
    n_total = n_seen + m
    new_mean = (n_seen * mean + m * col_mean) / n_total
    corr = (n_seen * m / n_total) ** 0.5 * (mean - col_mean)
    stack = torch.cat([singular[:, None] * components, xb - col_mean,
                       corr[None, :]])
    if stack.shape[0] >= stack.shape[1]:
        _, s, vt = linalg.svd_tall(stack, compute_u=False)
    else:
        s, vt = torch.linalg.svd(stack, full_matrices=False)[1:]
    return vt, s, new_mean, n_total


def _block_sums(xb, shift):
    """(Σ(x − s), Σ(x − s)²) of one device block, shifted by s ≈ the
    mean (the first block's) against the E[x²] − E[x]² cancellation."""
    c = xb - shift
    return c.sum(0), (c * c).sum(0)


class IncrementalPCA(PCA):
    """Ref: dask_ml/decomposition/incremental_pca.py::IncrementalPCA:
    ``partial_fit`` block by block; ``fit`` walks X in ``batch_size``
    blocks (default max(n // 10, 5 d)), device slices of a tensor or a
    ``ShardedArray``, host slices of an ndarray or a memmap."""

    def __init__(self, n_components=None, whiten=False, copy=True,
                 batch_size=None, svd_solver="auto", iterated_power=0,
                 random_state=None):
        self.n_components = n_components
        self.whiten = whiten
        self.copy = copy
        self.batch_size = batch_size
        self.svd_solver = svd_solver
        self.iterated_power = iterated_power
        self.random_state = random_state

    def _blocks(self, X):
        n, d = int(X.shape[0]), int(X.shape[1])
        bs = self.batch_size or max(n // 10, 5 * d)
        if isinstance(X, (ShardedArray, torch.Tensor)):
            data = X.data if isinstance(X, ShardedArray) else X
            for i in range(0, n, bs):
                yield data[i:min(i + bs, n)]
            return
        for i in range(0, n, bs):
            yield _slice_dense(X, i, min(i + bs, n), np.float32)

    def partial_fit(self, X, y=None, check_input=True):
        self._reject_multi_process()
        if _is_sparse_source(X):
            X = _slice_dense(X, 0, int(X.shape[0]), np.float32)
        if not getattr(self, "n_samples_seen_", 0) \
                or not hasattr(self, "_device"):
            self._device = resolve_device()
        if isinstance(X, ShardedArray):
            X = X.data[: X.n_rows]
        if not isinstance(X, torch.Tensor):
            X = torch.from_numpy(np.ascontiguousarray(X, np.float32))
        xb = X.to(device=self._device, dtype=torch.float32)
        if not bool(torch.isfinite(xb).all()):
            # torch's SVD refuses non-finite input (JAX's returns NaN)
            raise ValueError("X contains NaN or infinity")
        d = int(xb.shape[1])
        k = self.n_components or d
        if not hasattr(self, "n_samples_seen_") or self.n_samples_seen_ == 0:
            self._components = torch.zeros((k, d), device=self._device)
            self._singular = torch.zeros(k, device=self._device)
            self._mean = torch.zeros(d, device=self._device)
            self.n_samples_seen_ = 0
        elif not hasattr(self, "_components"):
            # fitted elsewhere (convert): the state is its host attributes
            self._components, self._singular, self._mean = (
                torch.as_tensor(a, dtype=torch.float32, device=self._device)
                for a in (self.components_, self.singular_values_,
                          self.mean_))
        vt, s, mean, n_total = _ipca_update(
            self._components, self._singular, self._mean,
            float(self.n_samples_seen_), xb)
        self._components, self._singular, self._mean = vt[:k], s[:k], mean
        self.n_samples_seen_ = int(n_total)
        self._finalize(d, k)
        return self

    def _finalize(self, d, k):
        n = self.n_samples_seen_
        self.components_ = to_host(self._components).astype(np.float64)
        self.singular_values_ = to_host(self._singular).astype(np.float64)
        self.mean_ = to_host(self._mean).astype(np.float64)
        self.explained_variance_ = self.singular_values_ ** 2 / max(n - 1, 1)
        self.n_components_ = k
        self.n_features_in_ = d
        # partial_fit never sees the total variance; fit() sets it from
        # the whole pass
        if not hasattr(self, "noise_variance_"):
            self.noise_variance_ = 0.0

    def fit_transform(self, X, y=None):
        # PCA.fit_transform would take the batch SVD; the incremental
        # fit runs block by block, then transforms
        return self.fit(X, y).transform(X)

    @staticmethod
    def _reject_multi_process():
        """The incremental SVD update is sequential and order-dependent:
        it cannot merge across processes' rows (PCA's streamed moments
        can), as in the JAX package."""
        from ..parallel.distributed import process_count

        if process_count() > 1:
            raise NotImplementedError(
                "IncrementalPCA is single-process; use PCA (its streamed "
                "moments merge across processes) under several processes "
                "(ROADMAP.md queue 1, Multi-GPU)")

    def fit(self, X, y=None):
        self._reject_multi_process()
        if hasattr(self, "n_samples_seen_"):
            del self.n_samples_seen_
        if not hasattr(X, "shape"):  # sklearn-style array-likes (lists)
            X = np.asarray(X, dtype=np.float32)
        if int(X.shape[0]) == 0:
            raise ValueError(
                "Found array with 0 sample(s) while a minimum of 1 is "
                "required by IncrementalPCA"
            )
        # the ratio needs the per-feature variance: (n, Σ(x−s), Σ(x−s)²)
        # from the blocks the updates consume, shifted by the first
        # block's mean against f32 cancellation
        s1 = s2 = shift = None
        n = 0
        for block in self._blocks(X):
            self.partial_fit(block)
            if isinstance(block, torch.Tensor):
                block = block.float()
                if shift is None:
                    shift = block.mean(0)
                b1, b2 = (to_host(t).astype(np.float64)
                          for t in _block_sums(block, shift))
            else:
                if shift is None:
                    shift = block.mean(axis=0, dtype=np.float64)
                c = block.astype(np.float64) - shift
                b1, b2 = c.sum(axis=0), np.square(c).sum(axis=0)
            s1 = b1 if s1 is None else s1 + b1
            s2 = b2 if s2 is None else s2 + b2
            n += int(block.shape[0])
        var = (s2 - s1 * s1 / n) / max(n - 1, 1)
        if not np.all(np.isfinite(var)):
            # the variance sums see every value: the streamed form of
            # check_array's finiteness gate
            raise ValueError("X contains NaN or infinity")
        total_var = float(np.sum(np.maximum(var, 0.0)))
        self.explained_variance_ratio_ = self.explained_variance_ / total_var
        k, d = self.n_components_, self.n_features_in_
        denom = min(n, d) - k
        self.noise_variance_ = (
            max(total_var - self.explained_variance_.sum(), 0.0) / denom
            if denom > 0 else 0.0
        )
        self.n_samples_ = n
        return self
