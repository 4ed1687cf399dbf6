"""The products of a staged sparse block, at a cost in proportion to its
nonzeros.

Counterpart of ``dask_ml_tpu/ops/sparse_kernels.py``. A block is a COO
triple ``data (nnz,) f32``, ``cols (nnz,) int32``, ``rows (nnz,) int32``
with its rows ascending (CSR order; ``parallel/sparse_stream.py``
stages it so), and optionally ``indptr``, the (n_rows + 1,) offsets of
each row's entries. The JAX package builds these from ``jnp.take`` and
``jax.ops.segment_sum`` in XLA (no Pallas kernel), and gets the
transposed products (``Xᵀr``, ``XᵀR``) from the autodiff of ``take``;
here they are plain PyTorch, with the transposed products written out.

Every sum runs in a fixed order, so two runs are bit-equal, and none is
a float atomic (``index_add_``, ``scatter_add_`` and
``index_put_(accumulate=True)`` are atomics on CUDA): a row's sum is a
segment reduction over its run of entries (``torch.segment_reduce``,
one thread, or one block of threads, per segment); a column's sum (the
transposed products, the per-label sums, the densify) first orders the
entries by column with a stable sort, once per staged block, then
reduces the runs. Duplicate columns in a row sum, as ``segment_sum``
does.
"""

from __future__ import annotations

import torch

__all__ = [
    "sparse_eta", "sparse_eta_multi", "sparse_densify", "sparse_sq_norms",
    "sparse_center_dots", "sparse_label_sums", "sparse_xt_r",
    "sparse_row_sq_norms",
    "sparse_xt_R", "segment_sum", "col_order", "row_offsets",
]


def row_offsets(rows, n_rows, indptr=None):
    """The (n_rows + 1,) offsets of each row's run of entries: ``indptr``
    when given, else found in the ascending ``rows``."""
    if indptr is not None:
        return indptr
    return torch.searchsorted(rows, torch.arange(
        int(n_rows) + 1, dtype=rows.dtype, device=rows.device))


def segment_sum(values, offsets):
    """Σ values[offsets[i]:offsets[i + 1]] along dim 0 for each i, each
    segment summed in its own fixed order; an empty segment is 0."""
    n_seg = offsets.shape[0] - 1
    if values.shape[0] == 0:
        return values.new_zeros((n_seg,) + tuple(values.shape[1:]))
    return torch.segment_reduce(values, "sum", offsets=offsets, axis=0,
                                unsafe=True)


def col_order(cols, n_features):
    """(perm, offsets): the entries in column order (a stable sort) and
    the (n_features + 1,) offsets of each column's run."""
    scols, perm = torch.sort(cols, stable=True)
    offsets = torch.searchsorted(scols, torch.arange(
        int(n_features) + 1, dtype=scols.dtype, device=scols.device))
    return perm, offsets


def sparse_eta(data, cols, rows, w_feat, n_rows, indptr=None):
    """``X @ w_feat`` of one sparse block: (n_rows,) row sums of
    ``data * w_feat[cols]``."""
    contrib = data * w_feat.index_select(0, cols)
    return segment_sum(contrib, row_offsets(rows, n_rows, indptr))


def sparse_eta_multi(data, cols, rows, W_feat, n_rows, indptr=None):
    """``X @ W_feat.T`` of one sparse block: (n_rows, C), one gather of
    the C weights of each nonzero's column."""
    contrib = data[:, None] * W_feat.T.index_select(0, cols)
    return segment_sum(contrib, row_offsets(rows, n_rows, indptr))


def sparse_sq_norms(data, rows, n_rows, indptr=None):
    """Per-row ||x||² of one sparse block."""
    return segment_sum(data * data, row_offsets(rows, n_rows, indptr))


def sparse_center_dots(data, cols, rows, centers, n_rows, indptr=None):
    """``X @ centers.T`` of one sparse block: (n_rows, k)."""
    return sparse_eta_multi(data, cols, rows, centers, n_rows, indptr)


def sparse_xt_r(data, cols, rows, r, n_features, by_col=None):
    """``Xᵀ r`` of one sparse block: (n_features,) column sums of
    ``data * r[rows]``; ``by_col`` is the block's ``col_order``."""
    perm, offsets = by_col if by_col is not None else col_order(
        cols, n_features)
    contrib = data * r.index_select(0, rows)
    return segment_sum(contrib.index_select(0, perm), offsets)


def sparse_xt_R(data, cols, rows, R, n_features, by_col=None):
    """``Xᵀ R`` of one sparse block for R (n_rows, C): (n_features, C),
    the one-vs-rest gradient of all C classes in one walk of the
    nonzeros."""
    perm, offsets = by_col if by_col is not None else col_order(
        cols, n_features)
    contrib = data[:, None] * R.index_select(0, rows)
    return segment_sum(contrib.index_select(0, perm), offsets)


def sparse_label_sums(data, cols, rows, labels, k, n_features):
    """Per-label feature sums of one sparse block: (k, n_features) with
    ``out[labels[r]] += X[r]``, the entries ordered by ``label * d +
    col`` (a stable sort) and each run reduced."""
    d = int(n_features)
    seg = labels.to(torch.int64).index_select(0, rows) * d + cols
    skeys, perm = torch.sort(seg, stable=True)
    offsets = torch.searchsorted(skeys, torch.arange(
        int(k) * d + 1, dtype=skeys.dtype, device=skeys.device))
    return segment_sum(data.index_select(0, perm), offsets).reshape(k, d)


def _cell_runs(data, cols, rows, n_features):
    """The entries ordered by cell (``row * d + col``, a stable sort):
    (keys, the first position of each cell's run, the run sums at those
    positions and 0 elsewhere). Each run sums in a fixed order, into
    segments [nxt[j], nxt[j + 1]) where nxt[j] is the first run start at
    or after j: a run's first position spans its run, every other
    position is empty. No host sync."""
    nnz = data.shape[0]
    key = rows.to(torch.int64) * int(n_features) + cols
    skeys, perm = torch.sort(key, stable=True)
    first = torch.ones(nnz, dtype=torch.bool, device=data.device)
    first[1:] = skeys[1:] != skeys[:-1]
    pos = torch.arange(nnz, dtype=torch.int64, device=data.device)
    nxt = torch.where(first, pos, torch.full_like(pos, nnz))
    nxt = torch.flip(torch.cummin(torch.flip(nxt, (0,)), 0).values, (0,))
    offsets = torch.cat([nxt, nxt.new_full((1,), nnz)])
    return skeys, first, segment_sum(data.index_select(0, perm), offsets)


def sparse_row_sq_norms(data, cols, rows, n_rows, n_features):
    """Per-row ||x||² of one sparse block with duplicate columns summed
    first, as the dense row's: ``sparse_sq_norms`` squares each entry on
    its own (the JAX function's sum), which differs on a row holding a
    column twice."""
    if data.shape[0] == 0:
        return data.new_zeros(int(n_rows))
    skeys, _, cells = _cell_runs(data, cols, rows, n_features)
    srows = skeys // int(n_features)
    return segment_sum(cells * cells, row_offsets(srows, n_rows))


def sparse_densify(data, cols, rows, n_rows, n_features,
                   dtype=torch.float32):
    """Scatter the block dense on the device: one (n_rows, n_features)
    buffer, duplicates summed (``_cell_runs``). Every position writes its
    cell, the ones past a run's first into a spare cell past the end,
    all with zeros: no two writes to one cell differ, so the result is
    the same on every run. No host sync."""
    d = int(n_features)
    n_cells = int(n_rows) * d
    out = torch.zeros(n_cells + 1, dtype=dtype, device=data.device)
    if data.shape[0]:
        skeys, first, vals = _cell_runs(data.to(dtype), cols, rows, d)
        out[torch.where(first, skeys, torch.full_like(skeys, n_cells))] = vals
    return out[:n_cells].view(int(n_rows), d)


def block_matmul(x, w):
    """``x @ w`` of a block's X, a dense tensor or a ``SparseSlab``: w
    (d,) gives (n_rows,), w (d, C) gives (n_rows, C)."""
    if not hasattr(x, "indptr"):
        return x @ w
    if w.ndim == 1:
        return sparse_eta(x.data, x.cols, x.rows, w, x.n_rows, x.indptr)
    return sparse_eta_multi(x.data, x.cols, x.rows, w.T, x.n_rows, x.indptr)
