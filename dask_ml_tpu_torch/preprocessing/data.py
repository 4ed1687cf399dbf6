"""Scalers and transforms on the device.

Counterpart of ``dask_ml_tpu/preprocessing/data.py``: StandardScaler,
MinMaxScaler, RobustScaler, QuantileTransformer and PolynomialFeatures
with the same parameters and fitted attributes. Fit statistics are masked
reductions on the device, pulled to the host once; every transform and
inverse is one torch expression over the data (``_affine``).

Quantiles (RobustScaler, QuantileTransformer, SimpleImputer's median):
- exact, up to ``_SKETCH_THRESHOLD`` rows: ``nan_quantiles``, a sort down
  the rows (NaN last), a count of the valid rows of each column and
  numpy's ``linear`` rule, as ``jnp.nanquantile`` computes it.
  ``torch.nanquantile`` refuses a reduced slice of more than 2^24
  elements, so it is not used;
- past it: ``_sketch_quantiles``, the JAX package's histogram sketch of
  4096 bins a column, with its counts taken in integers (``bincount``,
  in row chunks of about 256 MB of indices): exact, and the same on
  every run, where a float scatter-add on CUDA adds in another order on
  every run. The interpolation inside the hit bin is JAX's, in f32. A
  NaN entry counts in no bin, where the JAX sketch returns NaN for its
  column.

QuantileTransformer draws its subsample by Gumbel top-l from a
``torch.Generator`` (``_subsample_rows``), not JAX's key, so the two
packages subsample other rows for one seed. Its map is JAX's
``jnp.interp`` rule (``_interp``: ``searchsorted`` on the (d, n_q)
quantiles, JAX's clamping, its treatment of equal ``xp`` and of NaN),
with the normal output's ``ndtr``/``ndtri`` on the device in float64.

pandas DataFrames and PartitionedFrames (``parallel/frames.py``) go in
and come out as frames of the same type, with the input's index and
partition boundaries (``_frame_aware``), pandas imported only on that
branch. Under several processes a PartitionedFrame's statistics would
have to merge across processes, which the scalers do not do yet: they
raise naming ROADMAP.md queue 1, Multi-GPU.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from ..base import BaseEstimator, TransformerMixin, to_host
from ..models.kmeans import _generator, _gumbel_top_l
from ..ops import reductions
from ..parallel.sharded import ShardedArray, as_sharded
from ..parallel.frames import is_partitioned
from ..utils.validation import check_array, check_is_fitted, is_pandas


def _handle_zeros_in_scale(scale):
    """Ref: dask_ml/utils.py::handle_zeros_in_scale."""
    return np.where(scale == 0.0, 1.0, scale)


def _affine(data, mask, a, b, lo=0.0, hi=1.0, shift_first=True,
            do_clip=False):
    """Every scaler transform and inverse. ``shift_first`` computes
    ``(data + b) * a`` (subtract, then scale: keeps the benign
    cancellation of features with |mean| >> std), else ``data * a + b``;
    ``do_clip`` clips to [lo, hi]; ``mask=None`` leaves padding rows as
    they are (valid only when the shift is zero)."""
    a = torch.as_tensor(np.asarray(a), dtype=data.dtype, device=data.device)
    b = torch.as_tensor(np.asarray(b), dtype=data.dtype, device=data.device)
    out = (data + b) * a if shift_first else data * a + b
    if do_clip:
        out = out.clamp(lo, hi)
    if mask is not None:
        out = out * mask[:, None].to(data.dtype)
    return out


# -- pandas frames -----------------------------------------------------------

def _frame_parts(X):
    """(partitions, kind) of a frame input ("pandas" or "partitioned");
    (None, None) for anything else."""
    if is_pandas(X):
        return [X], "pandas"
    if is_partitioned(X):
        return list(X.partitions), "partitioned"
    return None, None


def _frame_device(parts, cols):
    """The partitions' numeric columns as one float32 ShardedArray;
    unencoded columns raise."""
    from pandas.api import types

    first = parts[0]
    bad = [c for c in cols
           if not (types.is_numeric_dtype(first.dtypes[c])
                   or types.is_bool_dtype(first.dtypes[c]))]
    if bad:
        raise ValueError(
            f"non-numeric columns {bad}: encode them first "
            "(Categorizer + DummyEncoder/OrdinalEncoder)"
        )
    return as_sharded(np.concatenate(
        [p[cols].to_numpy(dtype=np.float32) for p in parts], axis=0))


def _reject_multi_process_frame(kind):
    from ..parallel.distributed import process_count

    if kind == "partitioned" and process_count() > 1:
        raise NotImplementedError(
            "the scalers' statistics over a PartitionedFrame under several "
            "processes would merge across processes, which is not ported "
            "(ROADMAP.md queue 1, Multi-GPU)")


def _frame_check_fitted_names(self, cols):
    fitted = getattr(self, "feature_names_in_", None)
    if fitted is not None and list(fitted) != list(cols):
        raise ValueError(
            f"feature names {list(cols)} do not match the names seen at "
            f"fit time {list(fitted)}"
        )


def _frame_rebuild(self, parts, kind, cols, out):
    """The method's result as the input's frame type, with its index and
    partition boundaries."""
    import pandas as pd

    if not isinstance(out, ShardedArray):
        return out
    if out.shape[1] != len(cols):
        # width-changing transform (PolynomialFeatures): the reference's
        # preserve_dataframe switch
        if not getattr(self, "preserve_dataframe", True):
            return out
        names = list(self.get_feature_names_out(cols))
    else:
        names = cols
    arr = out.to_numpy()
    rebuilt, off = [], 0
    for p in parts:
        rebuilt.append(pd.DataFrame(arr[off:off + len(p)], index=p.index,
                                    columns=names))
        off += len(p)
    if kind == "pandas":
        return rebuilt[0]
    from ..parallel.frames import PartitionedFrame

    return PartitionedFrame(rebuilt)


def _frame_aware(method, name):
    """Frame adapter of an array method: a pandas DataFrame is placed on
    the device (its columns must be numeric already), the method runs on
    the array, and the result comes back as a frame with the input's
    index. Any other input goes straight to the method."""

    @functools.wraps(method)
    def wrapper(self, X, *args, **kwargs):
        parts, kind = _frame_parts(X)
        if kind is None:
            return method(self, X, *args, **kwargs)
        _reject_multi_process_frame(kind)
        cols = list(parts[0].columns)
        if name != "fit":
            _frame_check_fitted_names(self, cols)
        out = method(self, _frame_device(parts, cols), *args, **kwargs)
        if out is self:  # fit
            self.feature_names_in_ = np.asarray(cols, dtype=object)
            return self
        return _frame_rebuild(self, parts, kind, cols, out)

    return wrapper


class _DeviceTransformer(TransformerMixin, BaseEstimator):
    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        for name in ("fit", "transform", "inverse_transform"):
            if name in cls.__dict__:
                setattr(cls, name, _frame_aware(cls.__dict__[name], name))

    def fit_transform(self, X, y=None, **kw):
        parts, kind = _frame_parts(X)
        if kind is None:
            return self.fit(X, y, **kw).transform(X)
        _reject_multi_process_frame(kind)
        cols = list(parts[0].columns)
        Xs = _frame_device(parts, cols)
        out = self.fit(Xs, y, **kw).transform(Xs)
        self.feature_names_in_ = np.asarray(cols, dtype=object)
        return _frame_rebuild(self, parts, kind, cols, out)

    # the quantile-based transformers skip NaN (sklearn's 'allow-nan');
    # the moment-based scalers reject it
    _allow_nan = False

    def _sharded(self, X) -> ShardedArray:
        return check_array(X, dtype=np.float32, allow_nan=self._allow_nan)


class StandardScaler(_DeviceTransformer):
    """Ref: dask_ml/preprocessing/data.py::StandardScaler."""

    def __init__(self, copy=True, with_mean=True, with_std=True):
        self.copy = copy
        self.with_mean = with_mean
        self.with_std = with_std

    def fit(self, X, y=None):
        X = self._sharded(X)
        mean, var = reductions.masked_mean_var(X.data, X.row_mask(), X.n_rows)
        self.mean_ = to_host(mean) if self.with_mean else None
        if self.with_std:
            self.var_ = to_host(var)
            self.scale_ = _handle_zeros_in_scale(np.sqrt(self.var_))
        else:
            self.var_ = self.scale_ = None
        self.n_samples_seen_ = X.n_rows
        self.n_features_in_ = X.shape[1]
        return self

    def transform(self, X):
        check_is_fitted(self, "n_samples_seen_")
        X = self._sharded(X)
        a = 1.0 / self.scale_ if self.with_std else np.float32(1.0)
        b = -self.mean_ if self.with_mean else np.float32(0.0)
        mask = X.row_mask() if self.with_mean else None
        return ShardedArray(_affine(X.data, mask, a, b), X.n_rows)

    def inverse_transform(self, X):
        check_is_fitted(self, "n_samples_seen_")
        X = self._sharded(X)
        a = self.scale_ if self.with_std else np.float32(1.0)
        b = self.mean_ if self.with_mean else np.float32(0.0)
        mask = X.row_mask() if self.with_mean else None
        return ShardedArray(_affine(X.data, mask, a, b, shift_first=False),
                            X.n_rows)


class MinMaxScaler(_DeviceTransformer):
    """Ref: dask_ml/preprocessing/data.py::MinMaxScaler."""

    def __init__(self, feature_range=(0, 1), copy=True, clip=False):
        self.feature_range = feature_range
        self.copy = copy
        self.clip = clip

    def fit(self, X, y=None):
        X = self._sharded(X)
        mask = X.row_mask()
        dmin = to_host(reductions.masked_min(X.data, mask))
        dmax = to_host(reductions.masked_max(X.data, mask))
        lo, hi = self.feature_range
        self.data_min_, self.data_max_ = dmin, dmax
        self.data_range_ = dmax - dmin
        self.scale_ = (hi - lo) / _handle_zeros_in_scale(self.data_range_)
        self.min_ = lo - dmin * self.scale_
        self.n_features_in_ = X.shape[1]
        return self

    def transform(self, X):
        check_is_fitted(self, "scale_")
        X = self._sharded(X)
        out = _affine(X.data, X.row_mask(), self.scale_, self.min_,
                      self.feature_range[0], self.feature_range[1],
                      shift_first=False, do_clip=bool(self.clip))
        return ShardedArray(out, X.n_rows)

    def inverse_transform(self, X):
        check_is_fitted(self, "scale_")
        X = self._sharded(X)
        out = _affine(X.data, X.row_mask(), 1.0 / self.scale_, -self.min_)
        return ShardedArray(out, X.n_rows)


# -- quantiles ---------------------------------------------------------------

# elements of one sort of nan_quantiles (a column slice of X)
_SORT_ELEMS = 1 << 26
# bytes of bin indices of one chunk of rows of the sketch
_SKETCH_CHUNK_BYTES = 256 << 20
# rows above which the scaling statistics switch to the sketch
_SKETCH_THRESHOLD = 1_000_000


def nan_quantiles(data, qs):
    """(n_q, d) float32 quantiles of each column of ``data`` at ``qs``,
    skipping NaN: a sort down the rows (NaN last), the count of valid
    rows, and numpy's ``linear`` rule in f32 as ``jnp.nanquantile``
    computes it (an all-NaN column gives NaN). Sorts a slice of columns
    at a time."""
    n, d = data.shape
    q = torch.as_tensor(np.asarray(qs, np.float32).reshape(-1),
                        device=data.device)
    step = max(1, _SORT_ELEMS // max(n, 1))
    out = []
    for lo in range(0, d, step):
        cols = data[:, lo:lo + step].to(torch.float32)
        srt = torch.sort(cols, dim=0).values
        counts = (~torch.isnan(cols)).sum(0).to(torch.float32)
        pos = q[:, None] * (counts[None, :] - 1.0)
        low, high = pos.floor(), pos.ceil()
        hw = pos - low
        lw = 1.0 - hw
        top = counts[None, :] - 1.0
        low = torch.maximum(torch.minimum(low, top), torch.zeros_like(low))
        high = torch.maximum(torch.minimum(high, top), torch.zeros_like(high))
        out.append(srt.gather(0, low.long()) * lw
                   + srt.gather(0, high.long()) * hw)
    return torch.cat(out, dim=1)


def _sketch_quantiles(data, mask, qs, n_bins=4096):
    """Histogram-sketch quantiles of each column, (n_q, d) float32: the
    JAX package's sketch (one min/max pass, one pass of bin counts, then
    interpolation inside the hit bin; error at most one bin width,
    (max - min) / n_bins), with integer counts taken in row chunks."""
    n, d = data.shape
    dev = data.device
    rows = max(1, _SKETCH_CHUNK_BYTES // (8 * d))
    mn = torch.full((d,), torch.inf, device=dev)
    mx = torch.full((d,), -torch.inf, device=dev)
    for lo in range(0, n, rows):
        x = data[lo:lo + rows].to(torch.float32)
        ok = (mask[lo:lo + rows, None] > 0) & ~torch.isnan(x)
        mn = torch.minimum(mn, torch.where(ok, x, torch.inf).amin(0))
        mx = torch.maximum(mx, torch.where(ok, x, -torch.inf).amax(0))
    span = torch.clamp(mx - mn, min=1e-12)
    offsets = torch.arange(d, device=dev, dtype=torch.int64) * n_bins
    hist = torch.zeros(d * n_bins + 1, dtype=torch.int64, device=dev)
    for lo in range(0, n, rows):
        x = data[lo:lo + rows].to(torch.float32)
        ok = (mask[lo:lo + rows, None] > 0) & ~torch.isnan(x)
        idx = ((x - mn) / span * n_bins).nan_to_num(0.0).to(torch.int32)
        flat = idx.clamp(0, n_bins - 1).to(torch.int64) + offsets
        flat = torch.where(ok, flat, d * n_bins)   # the dump bin
        hist += torch.bincount(flat.reshape(-1), minlength=d * n_bins + 1)
    cum = hist[:-1].reshape(d, n_bins).cumsum(1).to(torch.float32)
    q = torch.as_tensor(np.asarray(qs, np.float32).reshape(-1), device=dev)
    t = q[None, :] * cum[:, -1:]                                # (d, n_q)
    b = torch.searchsorted(cum, t.contiguous()).clamp(0, n_bins - 1)
    prev = torch.where(b > 0, cum.gather(1, (b - 1).clamp_min(0)),
                       torch.zeros_like(t))
    in_bin = cum.gather(1, b) - prev
    frac = torch.where(in_bin > 0, (t - prev) / in_bin,
                       torch.full_like(t, 0.5))
    return (mn[:, None] + (b.to(torch.float32) + frac) * span[:, None]
            / n_bins).T


def _masked_quantiles(X: ShardedArray, qs, sketch=None, n_bins=4096):
    """Per-column quantiles of X's rows: exact up to _SKETCH_THRESHOLD
    rows (or with ``sketch=False``), the sketch past it (or with
    ``sketch=True``)."""
    if sketch is None:
        sketch = X.n_rows > _SKETCH_THRESHOLD
    if sketch:
        return _sketch_quantiles(X.data, X.row_mask(), qs, n_bins=n_bins)
    return nan_quantiles(X.data[: X.n_rows], qs)


class RobustScaler(_DeviceTransformer):
    """Ref: dask_ml/preprocessing/data.py::RobustScaler (approximate
    quantiles there; exact here up to 1M rows, the sketch past it)."""

    _allow_nan = True

    def __init__(self, with_centering=True, with_scaling=True,
                 quantile_range=(25.0, 75.0), copy=True):
        self.with_centering = with_centering
        self.with_scaling = with_scaling
        self.quantile_range = quantile_range
        self.copy = copy

    def fit(self, X, y=None):
        X = self._sharded(X)
        q_lo, q_hi = self.quantile_range
        qs = to_host(_masked_quantiles(X, [q_lo / 100.0, 0.5, q_hi / 100.0]))
        self.center_ = qs[1] if self.with_centering else None
        if self.with_scaling:
            self.scale_ = _handle_zeros_in_scale(qs[2] - qs[0])
        else:
            self.scale_ = None
        self.n_features_in_ = X.shape[1]
        return self

    def transform(self, X):
        check_is_fitted(self, "n_features_in_")
        X = self._sharded(X)
        a = 1.0 / self.scale_ if self.with_scaling else np.float32(1.0)
        b = -self.center_ if self.with_centering else np.float32(0.0)
        return ShardedArray(_affine(X.data, X.row_mask(), a, b), X.n_rows)

    def inverse_transform(self, X):
        check_is_fitted(self, "n_features_in_")
        X = self._sharded(X)
        a = self.scale_ if self.with_scaling else np.float32(1.0)
        b = self.center_ if self.with_centering else np.float32(0.0)
        return ShardedArray(
            _affine(X.data, X.row_mask(), a, b, shift_first=False), X.n_rows)


def _subsample_rows(X: ShardedArray, size, random_state):
    """Indices of ``size`` of X's rows drawn uniformly without
    replacement: Gumbel top-l of the row mask, from a torch.Generator
    seeded by ``random_state`` (0 when None)."""
    gen = _generator(X.device, random_state, 0)
    return _gumbel_top_l(X.row_mask(), gen, size)


# elements of one step of QuantileTransformer's map (a row chunk)
_MAP_ELEMS = 1 << 24


def _interp(x, xp, fp):
    """``jnp.interp`` row by row: x (d, m), xp and fp (d, n_q). Clamps to
    fp's ends outside xp, takes fp at the left point where two xp are
    within the f32 spacing of eps, and sorts NaN last, as JAX does."""
    n_q = xp.shape[1]
    i = torch.searchsorted(xp, x, right=True)
    i = torch.where(torch.isnan(x), n_q, i).clamp(1, n_q - 1)
    fp_lo, fp_hi = fp.gather(1, i - 1), fp.gather(1, i)
    xp_lo = xp.gather(1, i - 1)
    dx = xp.gather(1, i) - xp_lo
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, fp_lo, fp_lo + ((x - xp_lo)
                                         / torch.where(dx0, 1.0, dx))
                    * (fp_hi - fp_lo))
    f = torch.where(x < xp[:, :1], fp[:, :1], f)
    return torch.where(x > xp[:, -1:], fp[:, -1:], f)


class QuantileTransformer(_DeviceTransformer):
    """Ref: dask_ml/preprocessing/data.py::QuantileTransformer — maps each
    feature through its empirical CDF by interpolation."""

    _allow_nan = True

    def __init__(self, n_quantiles=1000, output_distribution="uniform",
                 ignore_implicit_zeros=False, subsample=int(1e5),
                 random_state=None, copy=True):
        self.n_quantiles = n_quantiles
        self.output_distribution = output_distribution
        self.ignore_implicit_zeros = ignore_implicit_zeros
        self.subsample = subsample
        self.random_state = random_state
        self.copy = copy

    def fit(self, X, y=None):
        if self.ignore_implicit_zeros:
            raise ValueError(
                "ignore_implicit_zeros applies to sparse matrices only; "
                "dense input does not support it"
            )
        X = self._sharded(X)
        sub_limit = int(self.subsample) if self.subsample else None
        if sub_limit is not None and self.n_quantiles > sub_limit:
            raise ValueError(
                f"The number of quantiles ({self.n_quantiles}) cannot be "
                f"greater than subsample ({sub_limit})"
            )
        n_q = min(self.n_quantiles, X.n_rows)
        self.n_quantiles_ = n_q
        self.references_ = np.linspace(0, 1, n_q)
        sub = sub_limit if sub_limit is not None else X.n_rows
        src = X
        if X.n_rows > sub:
            idx = _subsample_rows(X, sub, self.random_state)
            src = ShardedArray(X.data[idx], sub)
        self.quantiles_ = to_host(_masked_quantiles(src, self.references_))
        self.n_features_in_ = X.shape[1]
        return self

    def transform(self, X):
        check_is_fitted(self, "quantiles_")
        return self._map(X, inverse=False)

    def inverse_transform(self, X):
        check_is_fitted(self, "quantiles_")
        return self._map(X, inverse=True)

    def _map_rows(self, data, qt, refs, inverse, normal):
        """One row chunk (m, d) through the map; qt (d, n_q)."""
        v = data.to(torch.float32).T.contiguous()                # (d, m)
        d = v.shape[0]
        if inverse:
            if normal:
                v = torch.special.ndtr(v.double()).float()
            return _interp(v, refs.expand(d, -1).contiguous(), qt).T
        r = refs.expand(d, -1).contiguous()
        fwd = _interp(v, qt, r)
        # the average of forward and reverse interpolation: sklearn's tie
        # rule (a run of equal values maps to the middle of the run)
        rev = -_interp(-v, -qt.flip(1), -r.flip(1))
        out = 0.5 * (fwd + rev)
        # sklearn's boundaries: at or above the fitted max, refs[-1]; then
        # at or below the fitted min, refs[0] (a constant column: refs[0])
        out = torch.where(v >= qt[:, -1:], refs[0, -1], out)
        out = torch.where(v <= qt[:, :1], refs[0, 0], out)
        if normal:
            out = torch.special.ndtri(
                out.clamp(1e-7, 1 - 1e-7).double()).float()
        return out.T

    def _map(self, X, inverse):
        X = self._sharded(X)
        dev = X.device
        qt = torch.as_tensor(np.asarray(self.quantiles_, np.float32).T,
                             device=dev).contiguous()
        refs = torch.as_tensor(np.asarray(self.references_, np.float32),
                               device=dev)[None, :]
        normal = self.output_distribution == "normal"
        rows = max(1, _MAP_ELEMS // max(X.shape[1], 1))
        out = torch.cat([
            self._map_rows(X.data[lo:lo + rows], qt, refs, inverse, normal)
            for lo in range(0, X.data.shape[0], rows)], dim=0)
        out = out * X.row_mask(out.dtype)[:, None]
        return ShardedArray(out, X.n_rows)


class PolynomialFeatures(_DeviceTransformer):
    """Ref: dask_ml/preprocessing/data.py::PolynomialFeatures: the
    monomials of each degree are one gather of their index combinations
    and one product per factor, in the JAX package's column order."""

    def __init__(self, degree=2, interaction_only=False, include_bias=True,
                 preserve_dataframe=False):
        self.degree = degree
        self.interaction_only = interaction_only
        self.include_bias = include_bias
        self.preserve_dataframe = preserve_dataframe

    def _combinations(self, d):
        comb = (itertools.combinations if self.interaction_only
                else itertools.combinations_with_replacement)
        start = 0 if self.include_bias else 1
        return [c for deg in range(start, self.degree + 1)
                for c in comb(range(d), deg)]

    def fit(self, X, y=None):
        X = self._sharded(X)
        self.n_features_in_ = d = X.shape[1]
        self._combos = self._combinations(d)
        self.n_output_features_ = len(self._combos)
        return self

    def transform(self, X):
        check_is_fitted(self, "n_output_features_")
        X = self._sharded(X)
        data = X.data
        blocks = []
        for deg, group in itertools.groupby(self._combos, key=len):
            if deg == 0:
                blocks.append(X.row_mask(data.dtype)[:, None])
                continue
            idx = torch.as_tensor(list(group), device=data.device)
            out = data[:, idx[:, 0]]
            for j in range(1, deg):
                out = out * data[:, idx[:, j]]
            blocks.append(out)
        return ShardedArray(torch.cat(blocks, dim=1), X.n_rows)

    def get_feature_names_out(self, input_features=None):
        if input_features is None:
            input_features = [f"x{i}" for i in range(self.n_features_in_)]
        names = []
        for combo in self._combos:
            if not combo:
                names.append("1")
            else:
                counts = {}
                for j in combo:
                    counts[j] = counts.get(j, 0) + 1
                names.append(" ".join(
                    f"{input_features[j]}^{c}" if c > 1 else input_features[j]
                    for j, c in sorted(counts.items())
                ))
        return np.asarray(names, dtype=object)

    def _restore_fitted(self):
        self._combos = self._combinations(self.n_features_in_)
