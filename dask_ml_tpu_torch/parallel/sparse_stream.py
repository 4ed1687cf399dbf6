"""Sparse sources on the device: the staging plan and the packed block.

Counterpart of ``dask_ml_tpu/parallel/sparse_stream.py`` at one shard. A
sparse X (a scipy CSR matrix, or the ``SparseBlocks`` view of a list of
CSR blocks) streams through ``BlockStream`` as its nonzeros, block by
block, when the plan engages (the nnz route): each block is packed on
the host into the slot's pinned ``data``/``cols``/``rows``/``indptr``
buffers, copied to the device and handed to the consumers as a
``SparseSlab``, whose products (``ops/sparse_kernels.py``) cost time in
proportion to its nonzeros, never to ``block_rows x d``.

The plan (``plan_sparse_stream``) is the JAX package's, decided from
``indptr`` alone: a geometric nnz ladder (``_nnz_rung``: from 128,
growth 2, never clamped to an observed count) gives each block its rung
and the stream its capacity ``cap``, and a corpus, or a single block,
denser than ``config.stream_sparse_max_density`` refuses with a reason
string that ``solver_info_["sparse_stream_reason"]`` carries (the stream
then densifies each block on the host). The ladder bounds the JAX
package's XLA compiles; the port compiles nothing, and stages each
block's exact nonzeros in buffers of ``cap`` entries, so the rung
sequence is the plan's record and the capacity its bound.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

__all__ = ["SparseSlab", "SparseStreamPlan", "plan_sparse_stream",
           "sparse_row_nnz", "coo_rows", "pack_block", "csr_pieces"]

# the staging nnz ladder (plans/ladders.py::NnzLadder): rungs grow
# geometrically from _NNZ_MIN, never clamped to an observed nnz
_NNZ_MIN = 128
_NNZ_GROWTH = 2.0

from ..plans.ladders import NnzLadder as _NnzLadder  # noqa: E402

_NNZ_LADDER = _NnzLadder(min_nnz=_NNZ_MIN, growth=_NNZ_GROWTH)


class SparseSlab:
    """One staged sparse block on the device. ``data`` (nnz,) f32,
    ``cols`` (nnz,) int32, ``rows`` (nnz,) int32, the row of each entry,
    0-based in the block and ascending (CSR order), ``indptr`` (n_rows +
    1,) int64, the offsets of each row's entries; ``n_rows`` is the
    block's height (rows past the valid count hold no entries),
    ``n_features`` its width, ``shards`` 1 and ``cap`` the plan's
    capacity, the size of the slot's buffers. Duplicate columns in a row
    are kept, and every product sums them."""

    __slots__ = ("data", "cols", "rows", "indptr", "n_rows", "n_features",
                 "shards", "cap", "_by_col")

    def __init__(self, data, cols, rows, n_rows, n_features, shards=1,
                 cap=None, indptr=None):
        self.data = data
        self.cols = cols
        self.rows = rows
        self.n_rows = int(n_rows)
        self.n_features = int(n_features)
        self.shards = int(shards)
        self.cap = int(cap if cap is not None else data.shape[0])
        if indptr is None:
            indptr = torch.searchsorted(
                rows, torch.arange(self.n_rows + 1, dtype=rows.dtype,
                                   device=rows.device))
        self.indptr = indptr
        self._by_col = None

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def shape(self):
        return (self.n_rows, self.n_features)

    @property
    def device(self):
        return self.data.device

    def by_col(self):
        """(perm, offsets): the entries' order by column (a stable sort)
        and the (n_features + 1,) offsets of each column's run, made once
        per staged block for the transposed products."""
        if self._by_col is None:
            from ..ops.sparse_kernels import col_order

            self._by_col = col_order(self.cols, self.n_features)
        return self._by_col


def csr_pieces(a, lo, hi):
    """(csr, lo_i, hi_i) pieces that cover rows [lo, hi) of a CSR matrix
    or a ``SparseBlocks`` view, in row order."""
    from .streaming import SparseBlocks

    if isinstance(a, SparseBlocks):
        i = int(np.searchsorted(a.offsets, lo, side="right") - 1)
        while lo < hi and i < len(a.blocks):
            b_lo, b_hi = int(a.offsets[i]), int(a.offsets[i + 1])
            take = min(hi, b_hi) - lo
            if take > 0:
                yield a.blocks[i], lo - b_lo, lo - b_lo + take
                lo += take
            i += 1
        return
    if not sp.isspmatrix_csr(a):
        a = a.tocsr()
    yield a, lo, hi


def sparse_row_nnz(a) -> np.ndarray:
    """Per-row nonzero counts of a CSR-like source straight off
    ``indptr``."""
    from .streaming import SparseBlocks

    if isinstance(a, SparseBlocks):
        return np.concatenate([np.diff(b.indptr) for b in a.blocks])
    if sp.isspmatrix_csr(a):
        return np.diff(a.indptr)
    return np.diff(a.tocsr().indptr)


def coo_rows(a, lo, hi):
    """(data float32, cols int32, rows int32) of rows [lo, hi), rows
    0-based at ``lo``: index arithmetic on the CSR arrays, no densify."""
    parts_d, parts_c, parts_r = [], [], []
    off = 0
    for b, l, h in csr_pieces(a, lo, hi):
        s0, s1 = int(b.indptr[l]), int(b.indptr[h])
        parts_d.append(np.asarray(b.data[s0:s1], np.float32))
        parts_c.append(np.asarray(b.indices[s0:s1], np.int32))
        parts_r.append(np.repeat(np.arange(off, off + h - l, dtype=np.int32),
                                 np.diff(b.indptr[l:h + 1])))
        off += h - l
    if not parts_d:
        z = np.zeros(0, np.int32)
        return np.zeros(0, np.float32), z, z.copy()
    return (np.concatenate(parts_d), np.concatenate(parts_c),
            np.concatenate(parts_r))


def _nnz_rung(nnz: int, top: int) -> int:
    """Smallest ladder rung >= nnz, clipped to ``top`` (the largest rung
    any block needs) when ``top`` is given: the plans' NnzLadder,
    geometric from _NNZ_MIN and never clamped to an observed count."""
    return _NNZ_LADDER.rung_for(int(nnz), top=int(top))


class SparseStreamPlan:
    """The per-stream staging decision: per-block nnz rungs (the bucket
    sequence of a corpus), the capacity every block's buffers hold, the
    corpus density, and ``reason``, None when the nnz route engages,
    else why the stream densifies (recorded in ``solver_info_``)."""

    __slots__ = ("n_rows", "n_features", "block_rows", "shards", "cap",
                 "cap1", "block_buckets", "density", "reason", "total_nnz")

    def __init__(self, n_rows, n_features, block_rows, shards, cap, cap1,
                 block_buckets, density, total_nnz, reason=None):
        self.n_rows = n_rows
        self.n_features = n_features
        self.block_rows = block_rows
        self.shards = shards
        self.cap = cap
        self.cap1 = cap1
        self.block_buckets = block_buckets
        self.density = density
        self.total_nnz = total_nnz
        self.reason = reason

    @property
    def engaged(self) -> bool:
        return self.reason is None

    def block_bytes(self) -> int:
        """Bytes one staged block's buffers hold: data f32, cols and rows
        int32 (the offsets besides)."""
        return 12 * self.cap * self.shards


def plan_sparse_stream(a, block_rows: int, shards: int,
                       max_density: float) -> SparseStreamPlan:
    """The staging plan of sparse source ``a`` at the stream's
    ``block_rows``, one pass over ``indptr``; the port streams on one
    device, ``shards`` 1."""
    n, d = int(a.shape[0]), int(a.shape[1])
    row_nnz = sparse_row_nnz(a).astype(np.int64)
    total = int(row_nnz.sum())
    density = total / max(n * d, 1)
    n_blocks = max(-(-n // block_rows), 1)
    sd = max(block_rows // max(shards, 1), 1)
    pad = n_blocks * block_rows - n
    padded = np.concatenate([row_nnz, np.zeros(pad, np.int64)])
    per_shard = padded.reshape(n_blocks, max(shards, 1), sd).sum(axis=2)
    per_block = per_shard.sum(axis=1)
    top_shard = int(per_shard.max()) if per_shard.size else 0
    top_block = int(per_block.max()) if per_block.size else 0
    buckets = tuple(_nnz_rung(int(b), _nnz_rung(top_block, 0))
                    for b in per_block)
    cap = _nnz_rung(top_shard, 0)
    cap1 = _nnz_rung(top_block, 0)
    reason = None
    if density > max_density:
        reason = (f"density {density:.4f} > stream_sparse_max_density "
                  f"{max_density}")
    else:
        blk_density = top_block / max(block_rows * d, 1)
        if blk_density > max_density:
            reason = (f"block density {blk_density:.4f} > "
                      f"stream_sparse_max_density {max_density} "
                      "(over-bucket spill)")
    return SparseStreamPlan(n, d, block_rows, max(shards, 1), cap, cap1,
                            buckets, density, total, reason=reason)


def pack_block(a, lo, hi, cap, data_out, cols_out, rows_out,
               indptr_out) -> int:
    """Pack rows [lo, hi) of ``a`` into one slot's host buffers (numpy
    views): the block's exact nonzeros at the head of ``data_out``,
    ``cols_out`` and ``rows_out`` (rows 0-based at ``lo``), and
    ``indptr_out`` (block_rows + 1,) with every row past ``hi - lo``
    empty. Returns the block's nnz. Raises when the block holds more than
    the planned capacity (a source changed under the stream: the plan
    covered every block)."""
    pieces = list(csr_pieces(a, lo, hi))
    nnz = sum(int(b.indptr[h]) - int(b.indptr[l]) for b, l, h in pieces)
    if nnz > cap:
        raise ValueError(
            f"sparse block rows [{lo}, {hi}) holds {nnz} nnz > planned "
            f"capacity {cap}; source changed under the stream")
    pos, row = 0, 0
    indptr_out[0] = 0
    for b, l, h in pieces:
        s0, s1 = int(b.indptr[l]), int(b.indptr[h])
        k = s1 - s0
        data_out[pos:pos + k] = b.data[s0:s1]
        cols_out[pos:pos + k] = b.indices[s0:s1]
        counts = np.diff(b.indptr[l:h + 1])
        rows_out[pos:pos + k] = np.repeat(
            np.arange(row, row + h - l, dtype=np.int32), counts)
        indptr_out[row + 1:row + h - l + 1] = b.indptr[l + 1:h + 1] - s0 + pos
        pos += k
        row += h - l
    indptr_out[row + 1:] = pos
    return nnz


def to_slab(a, device) -> SparseSlab:
    """All rows of a CSR-like source staged on ``device`` as one
    ``SparseSlab`` (a search's sparse holdout, scored every round)."""
    n = int(a.shape[0])
    nnz = int(sparse_row_nnz(a).sum())
    data = np.empty(nnz, np.float32)
    cols = np.empty(nnz, np.int32)
    rows = np.empty(nnz, np.int32)
    indptr = np.empty(n + 1, np.int64)
    pack_block(a, 0, n, nnz, data, cols, rows, indptr)
    return SparseSlab(*(torch.from_numpy(v).to(device)
                        for v in (data, cols, rows)),
                      n, a.shape[1], indptr=torch.from_numpy(indptr).to(device))
