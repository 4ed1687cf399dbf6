"""Synthetic datasets, drawn on the host with numpy.

Counterpart of ``dask_ml_tpu/datasets.py``: make_classification,
make_regression, make_blobs, make_counts and make_classification_df with
the same parameters. The JAX package draws one seed per data shard of
its mesh, and each shard's rows from its own generator, so its data
depends on the shard count; the port has one device and draws one
shard, bit-equal to the JAX package on a one-device mesh. ``mesh`` and
``chunks`` are accepted for the JAX signature and change nothing.

The JAX package calls scikit-learn; the card's machine has none, so
``make_blobs`` is scikit-learn 1.9's sequence of draws redone in numpy
(``_blobs``) and the class vertices come from the port's copy of
``sample_without_replacement``. make_classification draws X in row
chunks and casts each into one float32 host buffer: a RandomState's
normal stream goes on across calls, so the bits are those of the
one-shot float64 draw at half its memory. The arrays end as float32
ShardedArrays on ``config.device``; make_classification_df returns host
pandas objects and raises an ``ImportError`` naming pandas without it.
"""

from __future__ import annotations

import numpy as np

from .model_selection._params import sample_without_replacement
from .parallel.sharded import ShardedArray
from .utils.validation import require_pandas

__all__ = ["make_classification", "make_regression", "make_blobs",
           "make_counts", "make_classification_df"]

# float64 elements of one chunk of make_classification's normal draw
_DRAW_ELEMS = 1 << 24


def _assemble(X, y):
    return (ShardedArray.from_array(X, dtype=np.float32),
            ShardedArray.from_array(y, dtype=np.float32))


def _shard_seed(rs):
    """The one shard's seed, drawn as the JAX package draws each of its
    shards' seeds."""
    return int(rs.randint(0, 2**31 - 1, size=1)[0])


def _classification_draw(n_samples, n_features, n_informative, n_classes,
                         class_sep, flip_y, random_state, class_weights=None,
                         dtype=np.float32):
    """(X (n, d) of ``dtype``, y float64 (n,)) of the classification problem:
    class centers (hypercube vertices of the informative subspace) and
    the feature permutation from ``random_state``, the rows from the
    shard's own generator."""
    rs = np.random.RandomState(random_state)
    n_informative = min(n_informative, n_features)
    if n_informative == 0:
        centers = np.zeros((n_classes, 0))
    else:
        if n_classes > 2 ** n_informative:
            raise ValueError(
                f"n_classes={n_classes} > 2**n_informative={2**n_informative} "
                "distinct hypercube vertices"
            )
        # distinct vertices, drawn without materializing the 2**k pool
        chosen = np.asarray(
            sample_without_replacement(
                2 ** min(n_informative, 62), n_classes, random_state=rs
            ),
            dtype=np.int64,
        )
        bits = ((chosen[:, None] >> np.arange(min(n_informative, 62))) & 1)
        if n_informative > 62:  # pad extra dims with fixed signs
            bits = np.concatenate(
                [bits, np.ones((n_classes, n_informative - 62), int)], axis=1
            )
        centers = class_sep * (2.0 * bits - 1.0)
    perm = rs.permutation(n_features)
    r = np.random.RandomState(_shard_seed(rs))
    X = np.empty((n_samples, n_features), dtype)
    if n_samples <= 0:
        return X, np.empty((0,))
    if class_weights is None:
        y = r.randint(0, n_classes, size=n_samples)
    else:
        y = r.choice(n_classes, size=n_samples, p=class_weights)
    rows = max(1, _DRAW_ELEMS // max(n_features, 1))
    for lo in range(0, n_samples, rows):
        hi = min(lo + rows, n_samples)
        chunk = r.normal(size=(hi - lo, n_features))
        chunk[:, :n_informative] += centers[y[lo:hi]]
        # cast, then permute: the cast is elementwise, so the bits are the
        # same, and the gather moves half the bytes
        np.take(chunk.astype(dtype, copy=False), perm, axis=1, out=X[lo:hi])
    flip = r.uniform(size=n_samples) < flip_y
    y = np.where(flip, r.randint(0, n_classes, size=n_samples), y)
    return X, y.astype(np.float64)


def make_classification(n_samples=100, n_features=20, n_informative=5,
                        n_classes=2, class_sep=1.0, flip_y=0.01,
                        random_state=None, chunks=None, mesh=None):
    """One global problem: the class centers (hypercube vertices of the
    informative subspace) and the feature permutation are drawn once
    from ``random_state``, then the rows."""
    return _assemble(*_classification_draw(
        n_samples, n_features, n_informative, n_classes, class_sep, flip_y,
        random_state))


def make_regression(n_samples=100, n_features=100, n_informative=10,
                    noise=0.0, bias=0.0, random_state=None, chunks=None,
                    mesh=None):
    """Ground-truth coefficients from ``random_state``, then the rows."""
    rs = np.random.RandomState(random_state)
    n_informative = min(n_informative, n_features)
    coef = np.zeros(n_features)
    coef[rs.permutation(n_features)[:n_informative]] = 100.0 * rs.uniform(
        size=n_informative
    )
    r = np.random.RandomState(_shard_seed(rs))
    X = r.normal(size=(n_samples, n_features))
    y = X @ coef + bias
    if noise > 0:
        y = y + r.normal(scale=noise, size=n_samples)
    return _assemble(X, y)


def _blobs(n_samples, centers, cluster_std=1.0, center_box=(-10.0, 10.0),
           shuffle=True, random_state=None):
    """scikit-learn 1.9's ``make_blobs`` for an int ``n_samples`` and an
    array of centers, draw for draw: each center's rows in turn, then one
    shuffle of the row order (``center_box`` places only drawn centers,
    so it changes nothing here)."""
    generator = np.random.RandomState(random_state)
    centers = np.asarray(centers, np.float64)
    n_centers, n_features = centers.shape
    if np.ndim(cluster_std) == 0:
        cluster_std = np.full(n_centers, cluster_std)
    elif len(cluster_std) != n_centers:
        raise ValueError(
            "Length of `clusters_std` not consistent with number of "
            f"centers. Got centers = {centers} and cluster_std = "
            f"{cluster_std}")
    per_center = [n_samples // n_centers] * n_centers
    for i in range(n_samples % n_centers):
        per_center[i] += 1
    X = np.empty((n_samples, n_features), np.float64)
    y = np.empty((n_samples,), int)
    start = 0
    for i, (n, std) in enumerate(zip(per_center, cluster_std)):
        X[start:start + n] = generator.normal(loc=centers[i], scale=std,
                                              size=(n, n_features))
        y[start:start + n] = i
        start += n
    if shuffle:
        order = np.arange(n_samples)
        generator.shuffle(order)
        X, y = X[order], y[order]
    return X, y


def make_blobs(n_samples=100, n_features=2, centers=None, random_state=None,
               chunks=None, mesh=None, **kwargs):
    rs = np.random.RandomState(random_state)
    if centers is None:
        centers = 3
    if np.isscalar(centers):
        centers = rs.uniform(-10, 10, size=(centers, n_features))
    seed = _shard_seed(rs)
    if n_samples <= 0:
        return _assemble(np.empty((0, np.shape(centers)[1])), np.empty((0,)))
    return _assemble(*_blobs(n_samples, centers, random_state=seed,
                             **kwargs))


def make_classification_df(n_samples=100, n_features=20, predictability=0.1,
                           response_rate=0.5, random_state=None, chunks=None,
                           mesh=None, dates=None, **kwargs):
    """Classification data as (DataFrame, Series) with named feature
    columns (ref: ``dask_ml/datasets.py::make_classification_df``):
    ``predictability`` is the fraction of informative features and
    ``response_rate`` the positive-class share; ``dates`` (start, end)
    adds a uniformly drawn ``date`` column."""
    pd = require_pandas("make_classification_df")
    n_classes = kwargs.pop("n_classes", 2)
    if not 0.0 <= predictability <= 1.0:
        raise ValueError(f"predictability must be in [0, 1], got {predictability}")
    if not 0.0 < response_rate <= 1.0:
        raise ValueError(f"response_rate must be in (0, 1], got {response_rate}")
    if n_classes == 1:
        weights = [1.0]
    elif n_classes == 2:
        weights = [1.0 - response_rate, response_rate]
    else:
        rest = (1.0 - response_rate) / (n_classes - 1)
        weights = [rest] * (n_classes - 1) + [response_rate]
    n_informative = kwargs.pop("n_informative",
                               int(predictability * n_features))
    class_sep = kwargs.pop("class_sep", 1.0)
    flip_y = kwargs.pop("flip_y", 0.01)
    if kwargs:
        raise TypeError(f"unsupported arguments: {sorted(kwargs)}")
    X, y = _classification_draw(n_samples, n_features, n_informative,
                                n_classes, class_sep, flip_y, random_state,
                                class_weights=weights, dtype=np.float64)
    df = pd.DataFrame(X,
                      columns=[f"feature_{i}" for i in range(n_features)])
    if dates is not None:
        start, end = pd.Timestamp(dates[0]), pd.Timestamp(dates[1])
        r = np.random.RandomState(random_state)
        offs = r.uniform(size=len(df)) * (end - start).value
        df.insert(0, "date", start + pd.to_timedelta(offs.astype(np.int64)))
    return df, pd.Series(y.astype(np.int64), name="target")


def make_counts(n_samples=100, n_features=20, random_state=None, scale=1.0,
                chunks=None, mesh=None):
    """Poisson-target regression data (ref: dask_ml/datasets.py::make_counts)."""
    rs = np.random.RandomState(random_state)
    beta = rs.normal(0, 1, size=n_features) * scale / np.sqrt(n_features)
    r = np.random.RandomState(_shard_seed(rs))
    X = r.normal(0, 1, size=(n_samples, n_features))
    y = r.poisson(np.exp(X @ beta))
    return _assemble(X, y.astype(np.float64))
