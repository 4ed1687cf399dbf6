"""Host-to-device block streaming for data larger than the card.

Counterpart of the dense single-device part of
``dask_ml_tpu/parallel/streaming.py``: the data stays on the host (a
numpy array or an ``np.memmap``) and flows through the device in
fixed-height blocks, one pass of the blocks per objective evaluation or
Lloyd iteration. ``auto_block_rows`` and ``stream_plan`` keep the JAX
rules, so both packages cut the same blocks: 256 MB of X per block by
default (``config.stream_block_rows`` overrides it), a memmap always
streams, an ndarray streams when ``stream_block_rows`` is below its
height, and a tensor never streams.

Epoch-style fits (the SGD estimators) cut their blocks with
``grid_partition``/``fit_block_rows`` (at least 8 blocks, capped by the
byte budget for a memmap) and walk them in an ``order``: a
``BlockStream(..., shuffle=True, seed=s)`` keeps one
``np.random.RandomState(s)`` and shuffles the block order once per pass
as the JAX stream does, so both packages train the same minibatches in
the same sequence; ``blocks(order)`` takes an explicit order (the
Incremental wrapper's pass) and ``epochs(n)`` runs n passes.

Staging (``BlockStream.blocks``). A ring of ``stream_prefetch + 1``
slots, each a pinned host buffer and a device buffer per array:

- the host fills the slot's pinned buffer with ``source[lo:hi]``: on a
  sequential pass over a C-contiguous float32 ``np.memmap`` the native
  block reader (``io/native.py``, ``csrc/block_reader.cpp``) copies the
  block from its own mapping of the file into the pinned buffer on C++
  threads, and the pass's other arrays (labels) are copied on the
  calling thread by ``np.copyto``; any other source or pass is copied
  by ``torch.from_numpy(...)`` and ``.copy_``; both copies cast to f32;
- a side CUDA stream issues the non-blocking copy to the slot's device
  buffer and records an event behind it;
- the consumer's stream waits on that event (the host does not);
- a pinned buffer is refilled only after the event of its last copy
  has completed (the host waits there, and ``wait_s`` counts it);
- a device buffer is refilled only after an event recorded on the
  consumer's stream behind its last launches on the block (the side
  stream waits on it).

So the host copy of the block ``prefetch`` steps ahead, the device copy
of the blocks in between and the kernel on the current block overlap;
blocks are staged in the order's sequence. Only rows
``< n_rows`` of a block are copied: the ragged last block keeps stale
rows past ``n_rows`` (NaN until a slot is first filled), and every
consumer reads only the rows below its count (the kernels take it as
``n_valid``). On the CPU a slot is one buffer and nothing is
asynchronous.

The reader's route is a decision per stream and array, made at the
first sequential pass as the JAX package makes it: the reader's block 0
is compared with the numpy slice, which catches a sliced memmap whose
``offset`` no longer describes it (that array takes the copy). A
copy-on-write memmap (``mode="c"``) copies too: its edits are not in
the file the reader maps. Each
pass records X's route (the first array's) in ``stats["reader"]``,
``"native"`` or ``"copy"``. A reader that fails to
build, open or read raises; nothing falls back. The readers (a mapping
and helper threads each) live as long as the stream; each sequential
pass rewinds them, so a pass cut short leaves nothing in flight.

Sparse sources (``SparseBlocks`` or a scipy sparse X) always stream
(``stream_plan``), by one of two routes that the stream decides once,
at construction, as the JAX package does (``sparse_route``,
``sparse_reason``):

- the nnz route, when ``config.stream_sparse`` is on, only X is sparse
  and the plan of ``parallel/sparse_stream.py`` engages: a slot holds
  pinned ``data`` (f32), ``cols`` and ``rows`` (int32) buffers of the
  plan's capacity and the block's row offsets; the host packs the
  block's exact nonzeros into them, the device copy moves those, and
  the ``Block`` carries a ``SparseSlab`` in X's place;
- the densify route otherwise (or when the consumer asks for dense
  blocks, ``densify_reason``): each block is scattered from the CSR
  arrays straight into the slot's pinned buffer (no dense copy between)
  and flows through the ring as a dense block does.

A block holding more nonzeros than planned raises, as ``pack_block``
does. ``stats`` counts a sparse pass's ``nnz`` and, on the nnz route,
its ``packed_bytes``.

Reliability (the JAX package's hardening, at the same fault sites of
``reliability/faults.py``):

- every host array read of a block passes the ``staging_read`` site and
  is retried with bounded exponential backoff (``config.stream_io_retries``,
  ``stream_retries`` counts) on an ``OSError``, then raises the typed
  ``StreamIORetriesExhausted``; an ``InjectedCrash`` is never retried.
  A reader whose read failed is closed, and its array is read by the
  positional copy from then on; a file cut short under the reader raises
  at once (a positional read past the end of the file's mapping would
  fault);
- the device-copy issue of a block passes ``stream_put`` (retried alike)
  and the yield of each block ``superblock_dispatch``: the port has no
  super-blocks, so that site counts blocks;
- ``config.stream_nonfinite``: ``"raise"`` raises ``NonFiniteBlock`` for
  a block with a non-finite value among its valid rows (any array; the
  packed values on the nnz route), ``"quarantine"`` zeroes the block's
  device buffers and yields it with ``n_rows`` 0, so no consumer reads
  it and no shape changes. The check runs on the device, on the side
  stream behind the block's copy (``torch.isfinite(...).all()``), and
  the host reads its flag, copied to a pinned byte behind it, before it
  yields the block; ``streamed_map`` hardens ``"quarantine"`` to
  ``"raise"``, as an inference stream must keep its rows;
- a pass that ends in an exception drains the side stream, closes the
  readers (their mappings and helper threads) and drops the ring, so
  nothing a crashed pass queued can write into buffers a later stream
  is given;
- the training profile (``profile_snapshot``, ``config.obs_drift``):
  the first pass folds a strided sample of X's host rows into an
  ``observability.sketch.FeatureSketch``, under the JAX budgets
  (``_PROFILE_VALUE_BUDGET`` values, ``_PROFILE_MAX_FEATURES`` features;
  a wider sparse X opts out, ``profile_reason``): a fixed cost once per
  fit, about 30 % of the first pass of a 4.1 GB memmap on the H100's
  host. Folding never raises into the stream;
- ``epochs(n, autotune=)`` (``config.stream_autotune``, off by default)
  doubles the block at an epoch boundary when the pass's host staging
  outlasted its consumer, at most twice and never below 16 blocks.

Several processes (``parallel/distributed.py``): each process streams
its OWN rows (its memmap, or its share), the consumer merges a pass's
sums across processes (``psum_host``), and every completed pass ends in
``distributed.sync_stream_pass`` (the ``pass_barrier`` fault site and the
``config.stream_sync_timeout_s`` deadline; JAX ``streaming.py:1637``).
A stream made inside ``distributed.local_section`` (a search's trial)
is a one-process stream. ``config.stream_mesh`` above 1 raises
(``parallel/mesh.py``). A fit that merges picks its route with
``fit_stream_plan``: if any rank streams, every rank streams, at one
block height, so a rank shorter than a block (or empty) streams its one
block (or none) and still joins every collective.

Under a ``"DxM"`` mesh (``parallel/mesh.py``) the M ranks of a row group
stream the same rows. A consumer with a feature-sharded flavour asks
for ``feature_tiles=True``: X's blocks then stage as this rank's (rows,
d/M) column tile (``model_tiled``; read by the positional copy, never
the native reader, whose blocks are whole rows), and the
``stream_put_sharded`` fault site fires at each block's device copy.
X stays whole width, the stream data-only, when it is sparse
(``model_tile_reason`` ``"sparse-source"``), not 2-D (``"x-not-2d"``),
its width does not divide (``"d-not-divisible(d%M)"``, JAX's strings),
or the consumer has no feature-sharded flavour
(``"consumer-data-only"``): its ranks then compute the same sums, and
merge over the "data" collective only. ``config.stream_device_byte_budget``
bounds the ring's device bytes per process (``StreamBudgetExceeded``).

Not ported, and why: ``superblocks()`` and ``SuperBlock`` stack K blocks
into one jitted scan to amortise XLA's per-dispatch cost and donate the
accumulator buffers (``dask_ml_tpu/parallel/streaming.py:1318``). Here a
pass is one kernel launch per block, adding into device accumulators in
block order, and has neither cost; the super-block count autotune goes
with them.
"""

from __future__ import annotations

import os
import time
import warnings
from collections import deque

import numpy as np
import torch

import scipy.sparse as sp

from ..config import check_nonfinite, get_config, resolve_device
from ..observability._counters import record_transfer
from ..observability._spans import span
from .sparse_stream import csr_pieces

# bytes of ONE block's X: fixed bytes, so any memmap streams in bounded
# blocks; the device then holds about (prefetch + 1) blocks
_AUTO_BLOCK_BYTES = 256 << 20
# rows of block 0 the reader's route test compares with the numpy slice
_VERIFY_ROWS = 4096
# the training profile's budgets (the JAX package's): values folded per
# fit, whatever the width, and the widest X profiled
_PROFILE_VALUE_BUDGET = 1 << 20
_PROFILE_MAX_FEATURES = 1024


class SparseBlocks:
    """Row-concatenated view over a list of scipy sparse (CSR) blocks,
    the shape a blocked vectorizer produces, without the ``sp.vstack``
    copy: ``shape``, ``dtype``, ``tocsr()`` and densifying a contiguous
    row range, which is what streaming needs. Counterpart of
    ``dask_ml_tpu/parallel/streaming.py::SparseBlocks``."""

    def __init__(self, blocks):
        blocks = [b if sp.isspmatrix_csr(b) else sp.csr_matrix(b)
                  for b in blocks]
        if not blocks:
            raise ValueError("SparseBlocks needs at least one block")
        d = blocks[0].shape[1]
        if any(b.shape[1] != d for b in blocks):
            raise ValueError("blocks have inconsistent widths")
        self.blocks = blocks
        self.offsets = np.cumsum([0] + [b.shape[0] for b in blocks])
        self.shape = (int(self.offsets[-1]), d)
        self.dtype = blocks[0].dtype
        self.ndim = 2

    @property
    def nnz(self) -> int:
        return int(sum(b.nnz for b in self.blocks))

    def tocsr(self):
        """The blocks as one CSR matrix (O(nnz)), for host consumers that
        index rows arbitrarily."""
        return sp.vstack(self.blocks).tocsr()

    def slice_dense(self, lo, hi, dtype=np.float32):
        """Rows [lo, hi) dense; touches only the blocks they span."""
        out = np.zeros((max(hi - lo, 0), self.shape[1]), dtype)
        _csr_into(out, self, lo, hi)
        return out


def _is_sparse_source(a) -> bool:
    return sp.issparse(a) or isinstance(a, SparseBlocks)


def _n_rows_of(a) -> int:
    # len() raises on scipy sparse ("length is ambiguous")
    return int(a.shape[0]) if _is_sparse_source(a) else len(a)


def _csr_into(out, a, lo, hi):
    """Scatter rows [lo, hi) of a CSR-like source into ``out`` (a
    (hi - lo, d) numpy array): scipy's ``toarray(out=)`` zeroes it and
    adds each row's nonzeros in place, duplicates summed. Nothing dense
    is made between."""
    row = 0
    for b, l, h in csr_pieces(a, lo, hi):
        piece = b[l:h]
        if piece.dtype != out.dtype:
            piece = piece.astype(out.dtype)
        piece.toarray(out=out[row:row + h - l])
        row += h - l


def _csr_dense(a, lo, hi, dtype):
    """CSR rows [lo, hi) dense in ``dtype``: the nonzeros are cast first,
    so the transient is one dense block."""
    out = np.empty((max(hi - lo, 0), a.shape[1]), dtype)
    _csr_into(out, a, lo, hi)
    return out


def as_row_sliceable(a):
    """A sparse source in a row-sliceable form (CSR), once: ``tocsr()``
    is the identity for CSR, O(nnz) for COO/CSC/BSR."""
    return a.tocsr() if sp.issparse(a) and not sp.isspmatrix_csr(a) else a


def as_row_indexable(a):
    """A sparse source that supports fancy row indexing (``a[idx]``):
    scipy sparse as CSR, ``SparseBlocks`` as one CSR. The one
    normalization point of the split and search fold paths: sparse folds
    stay sparse, never densified."""
    a = as_row_sliceable(a)
    return a.tocsr() if isinstance(a, SparseBlocks) else a


def _slice_dense(a, lo, hi, dtype):
    """One host block of ``a`` as a dense array: the one densify point of
    sparse sources (O(block) host memory)."""
    if _is_sparse_source(a):
        return _csr_dense(as_row_sliceable(a), lo, hi, dtype)
    return np.asarray(a[lo:hi], dtype=dtype)


def block_dense(x):
    """A block's X as a dense (S, d) tensor: a ``SparseSlab`` scattered
    dense on its device (``ops/sparse_kernels.py::sparse_densify``), a
    dense block as it is. For consumers whose work is O(d) per row
    anyway (an init pass, a Hessian)."""
    from .sparse_stream import SparseSlab

    if isinstance(x, SparseSlab):
        from ..ops.sparse_kernels import sparse_densify

        return sparse_densify(x.data, x.cols, x.rows, x.n_rows,
                              x.n_features)
    return x


def _row_bytes(a) -> int:
    """Bytes of one f32 row of ``a`` (blocks stream as float32)."""
    return 4 * int(np.prod(a.shape[1:], dtype=np.int64) or 1)


def grid_partition(n_rows: int) -> tuple[int, int]:
    """(n_blocks B, rows per block S) for ``n_rows`` rows: at least 8
    blocks, so an epoch is several minibatch steps. The JAX package's one
    partition formula (on its one-device data axis), behind the SGD fits
    on host and device data and the Incremental wrapper's blocks."""
    n_rows = max(n_rows, 1)
    S = -(-n_rows // 8)
    return -(-n_rows // S), S


def fit_block_rows(X) -> int:
    """Rows per block of an epoch-style fit over host data: the
    ``grid_partition`` height, capped by ``stream_plan``'s byte budget
    when X must stream in bounded blocks (a memmap, or configured block
    rows)."""
    S = grid_partition(int(X.shape[0]))[1]
    budget = stream_plan(X)
    return S if budget is None else max(min(S, budget), 1)


def auto_block_rows(n_rows: int, row_bytes: int = 4) -> int:
    """Block height: ``config.stream_block_rows`` if set, else 256 MB
    divided by the bytes of a row."""
    br = get_config().stream_block_rows
    if br and br > 0:
        return int(br)
    return max(_AUTO_BLOCK_BYTES // max(int(row_bytes), 1), 1)


def stream_plan(X) -> int | None:
    """Rows per block when ``X`` is fitted out of core, else None.

    A host ``np.memmap`` always streams (its file may exceed host and
    device memory); any other ndarray streams when it is taller than a
    positive ``config.stream_block_rows``. Tensors and ``ShardedArray``s
    take the resident path. A sparse source always streams, in blocks
    of the dense rows' byte budget: its device form is a block, never
    the corpus."""
    if _is_sparse_source(X):
        n = int(X.shape[0])
        if n == 0:
            return None
        return min(auto_block_rows(n, _row_bytes(X)), n)
    if not isinstance(X, np.ndarray):
        return None
    n = X.shape[0] if X.ndim else 0
    if n == 0:
        return None
    if isinstance(X, np.memmap):
        return min(auto_block_rows(n, _row_bytes(X)), n)
    br = get_config().stream_block_rows
    if br and 0 < br < n:
        return int(br)
    return None


def fit_stream_plan(X) -> int | None:
    """``stream_plan`` of a fit whose ranks merge: under several
    processes one ``allgather_object`` of every rank's plan, and if any
    rank streams, every rank streams at the tallest block height any
    rank planned (a rank no taller than a block streams its one block,
    an empty rank none, and each joins every collective of the fit).
    A rank whose X cannot stream (a tensor or ``ShardedArray``) beside
    one that streams raises ``ValueError`` on every rank. Inference
    paths and a search's trials call ``stream_plan``: they run outside
    any collective."""
    from .distributed import allgather_object, process_count

    plan = stream_plan(X)
    if process_count() == 1:
        return plan
    streamable = _is_sparse_source(X) or isinstance(X, np.ndarray)
    plans = allgather_object((streamable, plan))
    heights = [p for _, p in plans if p is not None]
    if not heights:
        return None
    if not all(ok for ok, _ in plans):
        raise ValueError(
            "a fit across processes streams on every rank once one rank "
            "streams; every rank must pass a host array or a sparse "
            f"source (got streamable, block rows by rank: {plans})")
    return int(max(heights))


class StreamBudgetExceeded(ValueError):
    """A streamed fit's per-process staging ring exceeds
    ``config.stream_device_byte_budget``: the typed refusal (sibling of
    ``DenseBudgetExceeded``) that stands in for a device out of memory.
    The fix is a mesh with a model axis: a wide-d fit that a 1-D mesh
    refuses fits once ``config.mesh_shape`` is "DxM" (X's blocks then
    stage as (rows, d/M) tiles, the bytes per process flat in d).
    Counterpart of the JAX package's ``StreamBudgetExceeded``
    (``dask_ml_tpu/parallel/streaming.py``)."""


def _close(readers):
    for r in readers:
        if r is not None:
            r.close()


class Block:
    """One streamed block: the device arrays (each ``block_rows`` tall)
    and ``n_rows``, the count of valid rows at its head. Rows past
    ``n_rows`` are stale and are never read."""

    __slots__ = ("arrays", "n_rows")

    def __init__(self, arrays, n_rows):
        self.arrays = arrays
        self.n_rows = n_rows


class BlockStream:
    """Prefetched passes over host arrays, one ``Block`` at a time.

    Parameters
    ----------
    arrays : tuple of host arrays (numpy or ``np.memmap``), equal length.
        Every block is float32 on the device.
    block_rows : rows per block; None is ``auto_block_rows`` of the
        arrays' f32 bytes per row.
    shuffle : shuffle the block order of each pass (``blocks()`` without
        an order, ``epochs``), drawing from one
        ``np.random.RandomState(seed)`` kept by the stream.

    Blocks land on ``config.device``; ``config.stream_prefetch`` blocks
    are staged ahead of the one consumed (1 = double buffering).

    ``stats`` holds the last pass's split (seconds on the host clock
    unless noted): ``host_s`` copying source rows into the staging
    buffers, ``put_s`` issuing the device copies, ``wait_s`` waiting for
    a staging buffer's previous copy (and, under a non-finite policy,
    for a block's check), ``consume_s`` the consumer's own
    host time per block, ``h2d_s`` the device copies' time by CUDA
    events (None on the CPU), ``pass_s`` the pass, ``bytes`` copied,
    ``reader`` the route that filled X's staging buffers (``"native"``:
    the block reader, whose open and ``br_next`` calls ``host_s`` then
    counts; ``"copy"``).
    ``totals`` sums them over every pass so far, with ``passes`` and
    ``reader_passes``, the passes of each route of X.

    ``nonfinite`` overrides ``config.stream_nonfinite`` for this stream;
    ``profile=False`` opts it out of the training profile (an inference
    stream's rows are not training data). ``collective`` (default: more
    than one process) ends each pass in the processes' pass barrier; an
    inference stream (``streamed_map``) is never collective.

    ``feature_tiles=True`` (a consumer with a feature-sharded flavour)
    stages X as this rank's column tile under a ``"DxM"`` mesh with M >
    1 (``model_tiled``, ``tile`` = (lo, hi), ``model_tile_reason`` when
    it cannot; the module docstring). ``sb_data_shards``,
    ``sb_model_shards`` and ``sb_sharded`` keep the JAX names: the row
    groups, the tiles X really stages over (1 when it does not tile),
    and whether either exceeds 1. The port has no super-blocks: the
    byte budget (``ring_bytes``) counts the ring's ``stream_prefetch +
    1`` blocks, not K super-blocks.

    A sparse X (``SparseBlocks`` or scipy sparse) takes the nnz route or
    the densify route (``sparse_route``), decided here: the nnz route
    when ``config.stream_sparse`` is on, X is the only sparse array and
    ``plan_sparse_stream`` engages, unless the consumer needs dense
    blocks and says why (``densify_reason``, e.g. ADMM's block-local
    Newton); ``sparse_reason`` is None on the nnz route, else the
    reason (``"stream-sparse-off"``, ``"sparse-operand-layout"``, the
    plan's density reason or ``densify_reason``). A sparse pass also
    counts ``nnz``, and on the nnz route ``packed_bytes``, the bytes of
    the packed blocks (``bytes`` then counts what was copied).
    """

    def __init__(self, arrays, block_rows=None, shuffle=False, seed=None,
                 densify_reason=None, nonfinite=None, profile=True,
                 collective=None, feature_tiles=False):
        self.arrays = tuple(as_row_sliceable(a) for a in arrays)
        for a in self.arrays:
            if not (_is_sparse_source(a) or isinstance(a, np.ndarray)):
                raise TypeError("BlockStream streams host numpy arrays "
                                "and sparse sources only, got "
                                f"{type(a).__name__}")
        n = _n_rows_of(self.arrays[0])
        if any(_n_rows_of(a) != n for a in self.arrays):
            raise ValueError("arrays have inconsistent lengths")
        self.n_rows = n
        if block_rows is None:
            block_rows = min(auto_block_rows(
                n, sum(_row_bytes(a) for a in self.arrays)), n)
        self.block_rows = max(int(block_rows), 1)
        self.n_blocks = -(-n // self.block_rows)
        self.shuffle = bool(shuffle)
        self.rng = np.random.RandomState(seed)
        self.prefetch = max(int(get_config().stream_prefetch), 1)
        self.device = resolve_device()
        # the process plane: one device per process (stream_mesh and
        # mesh_shape checked), and under several processes each pass of
        # a process-local stream ends in the pass barrier
        from .distributed import process_count
        from .mesh import feature_tile, process_mesh

        self.mesh_shape = process_mesh()
        self.collective = process_count() > 1 if collective is None \
            else bool(collective)
        # the 2-D mesh: X's column tile, or why it stays whole
        m_shards = self.mesh_shape[1]
        self.model_tiled, self.model_tile_reason, self.tile = \
            False, None, None
        if m_shards > 1:
            a0 = self.arrays[0]
            d0 = int(a0.shape[1]) if a0.ndim >= 2 else 0
            if _is_sparse_source(a0):
                self.model_tile_reason = "sparse-source"
            elif a0.ndim != 2:
                self.model_tile_reason = "x-not-2d"
            elif d0 % m_shards:
                self.model_tile_reason = f"d-not-divisible({d0}%{m_shards})"
            elif not feature_tiles:
                self.model_tile_reason = "consumer-data-only"
            else:
                self.model_tiled = True
                self.tile = feature_tile(d0, m_shards)
        self.stats = None
        self.totals = {"passes": 0, "reader_passes": {}}
        self._ring = None
        self._native = None
        self.sparse_plan = None
        self.sparse_reason = None
        self.sparse_route = None
        sparse_src = any(_is_sparse_source(a) for a in self.arrays)
        if sparse_src:
            self._decide_sparse_route(densify_reason)
        # the reliability knobs, captured once, as the JAX stream does
        cfg = get_config()
        self._io_retries = max(int(cfg.stream_io_retries), 0)
        self._nonfinite = check_nonfinite(
            cfg.stream_nonfinite if nonfinite is None else nonfinite)
        self._fault_spec = cfg.fault_plan
        # the training profile: a strided row sample of the first pass,
        # the stride set by the value budget; a wide sparse X opts out
        self.profile = None
        d_prof = int(np.prod(self.arrays[0].shape[1:], dtype=np.int64)
                     or 1)
        self.profile_reason = (f"sparse-wide(d={d_prof})" if sparse_src
                               and d_prof > _PROFILE_MAX_FEATURES else None)
        self._profile_enabled = bool(profile and cfg.obs_drift
                                     and self.profile_reason is None)
        budget_rows = max(_PROFILE_VALUE_BUDGET // d_prof, 1024)
        self._profile_stride = max(-(-n // budget_rows), 1)
        self._check_device_budget()
        self._epochs_total = None
        # the long-running work the live exporter exists for: arm
        # /metrics and /status (one config read when obs_http_port is 0)
        from ..observability.live import ensure_telemetry

        ensure_telemetry()

    def _widths(self):
        """Per array, the f32 values of one row of its device buffer (X's
        tile width when it tiles)."""
        out = []
        for i, a in enumerate(self.arrays):
            w = int(np.prod(a.shape[1:], dtype=np.int64) or 1)
            if i == 0 and self.model_tiled:
                w = self.tile[1] - self.tile[0]
            out.append(w)
        return out

    def ring_bytes(self) -> int:
        """The device bytes of the staging ring at its full size,
        ``stream_prefetch + 1`` slots (what ``_slots`` allocates once the
        stream has that many blocks): block_rows x width x 4 per array,
        the nnz route's packed X at the plan's capacity."""
        per_slot = 0
        for i, w in enumerate(self._widths()):
            if i == 0 and self.nnz_route:
                per_slot += 12 * self.sparse_plan.cap + \
                    8 * (self.block_rows + 1)
            else:
                per_slot += 4 * self.block_rows * w
        return (self.prefetch + 1) * per_slot

    def _check_device_budget(self):
        """``config.stream_device_byte_budget`` (0 = off) against
        ``ring_bytes``: the same on every rank of a fit (one block height,
        one width per tile), so the refusal is every rank's."""
        budget = int(get_config().stream_device_byte_budget)
        if budget <= 0:
            return
        need = self.ring_bytes()
        if need > budget:
            d, m = self.mesh_shape
            raise StreamBudgetExceeded(
                f"the staging ring needs {need} bytes per process "
                f"({self.prefetch + 1} slots, block_rows={self.block_rows}, "
                f"mesh {d}x{m}{', X tiled' if self.model_tiled else ''}), "
                f"over stream_device_byte_budget={budget}. Shard the "
                "features: set config.mesh_shape to a 2-D 'DxM' so X "
                "stages as (rows, d/M) tiles (bytes per process flat in "
                "d), or lower stream_block_rows / stream_prefetch.")

    def sb_data_shards(self) -> int:
        """Row groups of the mesh this stream's fit merges over."""
        return self.mesh_shape[0]

    def sb_model_shards(self) -> int:
        """Feature tiles X really stages over: M when it tiles, else 1
        (sparse, not 2-D, d not divisible, or a data-only consumer: see
        ``model_tile_reason``), so consumers branch on this number."""
        return self.mesh_shape[1] if self.model_tiled else 1

    def sb_sharded(self) -> bool:
        """True when the fit spans row groups or X's feature tiles."""
        return self.sb_data_shards() > 1 or self.sb_model_shards() > 1

    def _decide_sparse_route(self, densify_reason):
        """The sparse route of this stream, once: the JAX package's rule
        (``dask_ml_tpu/parallel/streaming.py:526-550``) at one shard."""
        from .sparse_stream import plan_sparse_stream

        cfg = get_config()
        self.sparse_route = "densify"
        if not cfg.stream_sparse:
            self.sparse_reason = "stream-sparse-off"
        elif not _is_sparse_source(self.arrays[0]) or any(
                _is_sparse_source(a) for a in self.arrays[1:]):
            self.sparse_reason = "sparse-operand-layout"
        else:
            plan = plan_sparse_stream(self.arrays[0], self.block_rows, 1,
                                      float(cfg.stream_sparse_max_density))
            self.sparse_plan = plan
            self.sparse_reason = plan.reason
            if plan.engaged:
                if densify_reason is not None:
                    self.sparse_reason = densify_reason
                else:
                    self.sparse_route = "nnz"

    @property
    def nnz_route(self) -> bool:
        """X's blocks arrive as ``SparseSlab``s."""
        return self.sparse_route == "nnz"

    def __len__(self):
        return self.n_blocks

    def _slots(self):
        """The staging ring, made at the first pass: per slot a tuple of
        host buffers and a tuple of device buffers (the same tensors on
        the CPU), NaN until first filled."""
        if self._ring is None:
            cuda = self.device.type == "cuda"
            n_slots = min(self.prefetch + 1, self.n_blocks)
            ring = []
            for _ in range(n_slots):
                # X's dense buffer is never made on the nnz route
                shapes = [(self.block_rows,) + tuple(a.shape[1:])
                          if i or not self.nnz_route else (0,)
                          for i, a in enumerate(self.arrays)]
                if self.model_tiled:
                    shapes[0] = (self.block_rows,
                                 self.tile[1] - self.tile[0])
                host = [torch.empty(s, dtype=torch.float32,
                                    pin_memory=cuda) for s in shapes]
                dev = [torch.full(s, torch.nan, dtype=torch.float32,
                                  device=self.device)
                       for s in shapes] if cuda else host
                if not cuda:
                    for h in host:
                        h.fill_(torch.nan)
                if self.nnz_route:
                    # X's slot: the packed block, data f32, cols and rows
                    # int32 at the plan's capacity, the row offsets
                    cap = self.sparse_plan.cap
                    spec = ((cap, torch.float32), (cap, torch.int32),
                            (cap, torch.int32),
                            (self.block_rows + 1, torch.int64))
                    host[0] = tuple(torch.zeros(n, dtype=t, pin_memory=cuda)
                                    for n, t in spec)
                    dev[0] = tuple(torch.zeros(n, dtype=t,
                                               device=self.device)
                                   for n, t in spec) if cuda else host[0]
                ring.append((tuple(host), tuple(dev)))
            self._ring = ring
            self._h2d = [None] * n_slots       # event behind a slot's copy
            self._consumed = [None] * n_slots  # event behind its consumer
            self._side = torch.cuda.Stream(self.device) if cuda else None
            # per slot, the pinned byte the non-finite check's flag lands in
            self._flags = [torch.ones(1, dtype=torch.uint8, pin_memory=True)
                           if cuda else None for _ in range(n_slots)]
            if cuda:
                # the buffers' fills above run on the current stream; the
                # side stream's first copies into them wait for those (an
                # earlier fit's launches still queued there would delay a
                # fill past the copy, which the fill then overwrites)
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(self.device))
                self._consumed = [ev] * n_slots
        return self._ring

    def _native_readers(self):
        """Per array, its native reader, or None where the array is
        copied. The reader serves a C-contiguous float32 ``np.memmap``
        with a file that it shares (not copy-on-write, whose edits the
        file lacks), whose block 0 read by a reader equals the numpy
        slice (a sliced memmap keeps its parent's ``offset``, and the
        reader would read other rows). Decided and opened once per
        stream: a reader holds its file's mapping and its copy's helper
        threads, no buffer, and closes with the stream. A failed build
        or open raises."""
        if self._native is None:
            from ..io.native import NativeBlockReader

            readers = []
            try:
                for i, a in enumerate(self.arrays):
                    # the reader copies whole rows: a feature tile of X
                    # takes the positional copy
                    ok = (not (i == 0 and self.model_tiled)
                          and isinstance(a, np.memmap)
                          and a.dtype == np.float32
                          and a.flags["C_CONTIGUOUS"]
                          and getattr(a, "mode", None) in ("r", "r+", "w+")
                          and getattr(a, "filename", None) is not None)
                    if ok:
                        m = min(self.block_rows, self.n_rows, _VERIFY_ROWS)
                        head = torch.empty((m,) + a.shape[1:])
                        with NativeBlockReader(a, m) as r:
                            got = r.next(head)
                        ok = got == m and np.array_equal(
                            head.numpy(), np.asarray(a[:m]), equal_nan=True)
                    readers.append(NativeBlockReader(a, self.block_rows)
                                   if ok else None)
            except BaseException:
                _close(readers)
                raise
            self._native = tuple(readers)
        return self._native

    def _readers(self, order):
        """The pass's readers, one per array, None where the array is
        copied: only a sequential pass takes the reader, from block 0."""
        if not self.n_blocks or not np.array_equal(
                order, np.arange(self.n_blocks)):
            return [None] * len(self.arrays)
        readers = self._native_readers()
        for r in readers:
            if r is not None:
                r.rewind()
        return list(readers)

    def _close_readers(self):
        if self._native is not None:
            _close(self._native)
            self._native = None

    def _drop_reader(self, readers, i):
        """A reader whose read failed has an untrustworthy cursor: it is
        closed, and array ``i`` is copied positionally from then on, in
        this pass and the later ones."""
        readers[i].close()
        readers[i] = None
        self._native = tuple(None if j == i else r
                             for j, r in enumerate(self._native))

    def _copy_rows(self, dst, a, lo, hi, beside_reader=False, tile=None):
        src = np.asarray(a[lo:hi] if tile is None
                         else a[lo:hi, tile[0]:tile[1]])
        if beside_reader:
            # on this thread: torch's copy would wake its OpenMP pool,
            # whose threads then spin against the reader's threads as
            # they copy the next block (on the H100 host a streamed lbfgs
            # pass took 20-30 % longer so)
            np.copyto(dst[: hi - lo].numpy(), src, casting="unsafe")
            return
        with warnings.catch_warnings():
            # a read-only memmap: torch only reads the view
            warnings.simplefilter("ignore", UserWarning)
            dst[: hi - lo].copy_(torch.from_numpy(src))

    def _retry_io(self, fn, what):
        """``fn()`` (an idempotent staging step) with bounded exponential
        backoff: an ``OSError`` (a real one or an injected ``io`` fault)
        is retried up to ``stream_io_retries`` times, then raises the
        typed ``StreamIORetriesExhausted``; an ``InjectedCrash`` raises at
        once."""
        from ..observability._counters import record_stream_retry
        from ..reliability.faults import (InjectedCrash,
                                          StreamIORetriesExhausted)

        attempt = 0
        while True:
            try:
                return fn()
            except InjectedCrash:
                raise
            except OSError as exc:
                if attempt >= self._io_retries:
                    err = StreamIORetriesExhausted(
                        f"{what} still failing after {attempt + 1} "
                        f"attempt(s): {exc}")
                    try:
                        # the alert engine's typed-error hook (one
                        # module-global check when nothing is armed)
                        from ..observability import alerts as _alerts

                        _alerts.note_error(err, "stream_io")
                    except Exception:
                        pass
                    raise err from exc
                record_stream_retry()
                time.sleep(min(0.02 * (2 ** attempt), 1.0))
                attempt += 1

    def _site(self, site, view=None):
        """The fault site ``site``; a ``nan`` arm's poisoned copy of
        ``view`` (a staging buffer, never the source) is written back
        into it."""
        from ..reliability.faults import fire_plan

        out = fire_plan(self._fault_spec, site, view)
        if view is not None and out is not view:
            np.copyto(view, out)

    def _read_array(self, i, a, dst, lo, hi, readers, beside_reader):
        """Rows [lo, hi) of array ``i`` into its staging buffer ``dst``
        through the ``staging_read`` site, retried on an ``OSError``.
        Returns the nonzeros packed (the nnz route's X), else None."""
        from ..observability._counters import record_stream_retry
        from ..reliability.faults import InjectedCrash

        m = hi - lo
        spec = self._fault_spec
        if readers[i] is not None:
            try:
                got = readers[i].next(dst)
                if got != m:
                    raise IOError(f"the block reader gave {got} rows of "
                                  f"block {lo // self.block_rows}, not {m}")
                if spec:
                    self._site("staging_read", dst[:m].numpy())
                return None
            except InjectedCrash:
                raise
            except OSError:
                if not _file_holds(a):
                    raise  # cut short: a positional read would fault
                record_stream_retry()
                self._drop_reader(readers, i)

        def read():
            if i == 0 and self.nnz_route:
                from .sparse_stream import pack_block

                k = pack_block(a, lo, hi, self.sparse_plan.cap,
                               *(t.numpy() for t in dst))
                if spec:
                    self._site("staging_read")
                return k
            if _is_sparse_source(a):
                # the densify route: straight into the pinned buffer
                _csr_into(dst[:m].numpy(), a, lo, hi)
            else:
                self._copy_rows(dst, a, lo, hi, beside_reader,
                                self.tile if i == 0 else None)
            if spec:
                self._site("staging_read", dst[:m].numpy())
            return None

        return self._retry_io(read, f"staging read of rows [{lo}, {hi})")

    # -- the training profile ---------------------------------------------
    def _profile_fold(self, blk):
        """Fold one block's sample rows (X's valid rows, strided to the
        value budget) into the training profile; never raises into the
        stream."""
        if not self._profile_enabled:
            return
        try:
            if blk.ndim != 2 or blk.shape[0] == 0 \
                    or blk.shape[1] > _PROFILE_MAX_FEATURES:
                self._profile_enabled = (
                    blk.ndim == 2 and blk.shape[1] <= _PROFILE_MAX_FEATURES)
                return
            if self.profile is None:
                from ..observability.sketch import FeatureSketch

                self.profile = FeatureSketch(blk.shape[1])
            self.profile.fold(blk)
        except Exception:
            self._profile_enabled = False  # diagnostics never kill a fit

    def _profile_fold_sparse(self, a, lo, hi):
        """The nnz route's fold: only the strided sample rows of [lo, hi)
        densified (the JAX ``_profile_fold_sparse``)."""
        if not self._profile_enabled:
            return
        try:
            step = self._profile_stride
            if sp.isspmatrix_csr(a):
                blk = np.asarray(a[lo:hi:step].toarray(), np.float32)
            else:
                from .sparse_stream import coo_rows

                data, cols, rows = coo_rows(a, lo, hi)
                sel = (rows % step) == 0
                blk = np.zeros((-(-(hi - lo) // step), a.shape[1]),
                               np.float32)
                np.add.at(blk, (rows[sel] // step, cols[sel]), data[sel])
            self._profile_fold(blk)
        except Exception:
            self._profile_enabled = False

    def profile_snapshot(self):
        """The training profile as a JSON-safe dict, None when profiling
        is off or nothing was folded: what fits attach as
        ``training_profile_``."""
        prof = self.profile
        return prof.to_dict() if prof is not None and prof.rows else None

    def __iter__(self):
        return self.blocks()

    # -- block autotune ----------------------------------------------------
    def _maybe_grow_blocks(self):
        """Double the block at an epoch boundary when the last pass spent
        more host time staging blocks (``host_s + put_s``) than the
        consumer held them (``consume_s``): the per-block fixed costs
        dominate. At most twice (after the first two passes), to no fewer
        than 16 blocks, never past the byte budget, never with a sparse
        plan (it is keyed to the partition). The ring and readers are
        rebuilt at the new height at the next pass."""
        st = self.stats
        if st is None or self.totals["passes"] > 2 or self.n_blocks < 16:
            return
        if self.sparse_plan is not None:
            return
        if not st["host_s"] + st["put_s"] > st["consume_s"]:
            return
        row_bytes = sum(_row_bytes(a) for a in self.arrays)
        budget_rows = max(_AUTO_BLOCK_BYTES // max(row_bytes, 1), 1)
        cap = min(self.n_rows, max(budget_rows, self.block_rows))
        new_rows = min(self.block_rows * 2, cap)
        if new_rows <= self.block_rows or -(-self.n_rows // new_rows) < 16:
            return
        self.block_rows = new_rows
        self.n_blocks = -(-self.n_rows // self.block_rows)
        self._ring = None
        self._close_readers()

    def epochs(self, n_epochs, autotune=None):
        """``n_epochs`` passes, each in a fresh order when the stream
        shuffles; ``autotune`` (default ``config.stream_autotune``) may
        grow the blocks between passes (``_maybe_grow_blocks``)."""
        if autotune is None:
            autotune = get_config().stream_autotune
        n_epochs = int(n_epochs)
        self._epochs_total = self.totals["passes"] + n_epochs
        try:
            for e in range(n_epochs):
                yield from self.blocks()
                if autotune and e < n_epochs - 1:
                    self._maybe_grow_blocks()
        finally:
            self._epochs_total = None

    def blocks(self, order=None):
        """One pass: block ``order[j]`` is the j-th ``Block`` yielded.
        ``order`` defaults to every block once, in sequence, shuffled by
        the stream's generator when it shuffles; an explicit order may
        be any sequence of block indices."""
        if order is None:
            order = np.arange(self.n_blocks)
            if self.shuffle:
                self.rng.shuffle(order)
        order = [int(b) for b in order]
        if any(not 0 <= b < self.n_blocks for b in order):
            raise ValueError(f"order indexes blocks 0..{self.n_blocks - 1}")
        ring = self._slots()
        t_pass = time.perf_counter()
        readers = self._readers(order)  # host time of the pass
        route = "copy" if readers[0] is None else "native"
        beside_reader = any(r is not None for r in readers)
        n_slots = len(ring)
        cuda = self.device.type == "cuda"
        consumer = torch.cuda.current_stream(self.device) if cuda else None
        stats = {"host_s": time.perf_counter() - t_pass, "put_s": 0.0,
                 "wait_s": 0.0, "consume_s": 0.0, "h2d_s": None, "bytes": 0,
                 "n_blocks": len(order), "block_rows": self.block_rows,
                 "reader": route}
        if self.sparse_route is not None:
            stats.update(sparse_route=self.sparse_route, nnz=0)
            if self.nnz_route:
                stats["packed_bytes"] = 0
        sparse_x = self.sparse_route is not None and _is_sparse_source(
            self.arrays[0])
        spec = self._fault_spec
        check = self._nonfinite != "off"
        fold = self._profile_enabled and self.totals["passes"] == 0
        nnz_of = [0] * n_slots
        finite = [None] * n_slots  # the non-finite check's flag per slot
        timing = []

        def stage(j):
            slot = j % n_slots
            lo = order[j] * self.block_rows
            hi = min(lo + self.block_rows, self.n_rows)
            host, dev = ring[slot]
            if cuda and self._h2d[slot] is not None:
                t0 = time.perf_counter()
                self._h2d[slot].synchronize()
                stats["wait_s"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            m = hi - lo
            for i, (dst, a) in enumerate(zip(host, self.arrays)):
                k = self._read_array(i, a, dst, lo, hi, readers,
                                     beside_reader)
                if k is not None:
                    nnz_of[slot] = k
                if i == 0 and fold:
                    if self.nnz_route:
                        self._profile_fold_sparse(a, lo, hi)
                    elif self.model_tiled:
                        # the profile covers every feature: the sample
                        # rows from the source, whole (every rank of the
                        # row group folds the same rows)
                        self._profile_fold(np.asarray(
                            a[lo:hi:self._profile_stride], np.float32))
                    else:
                        self._profile_fold(
                            dst[:m].numpy()[:: self._profile_stride])
            t1 = time.perf_counter()
            stats["host_s"] += t1 - t0
            if sparse_x:
                stats["nnz"] += _nnz_rows(self.arrays[0], lo, hi)
            copies = [(d_buf[:m], h_buf[:m]) for d_buf, h_buf in
                      zip(dev, host)]
            if self.nnz_route:
                k = nnz_of[slot]
                copies[0:1] = [(d[:k], h[:k]) for d, h in
                               zip(dev[0][:3], host[0][:3])]
                copies.append((dev[0][3], host[0][3]))
                stats["packed_bytes"] += 12 * k + 8 * (self.block_rows + 1)
            if spec:
                self._retry_io(lambda: self._site("stream_put"),
                               "the device copy's issue")
                if self.model_tiled:
                    self._retry_io(lambda: self._site("stream_put_sharded"),
                                   "the feature tile's device copy")
            # the values the non-finite check reads: every array's valid
            # rows, the packed values on the nnz route
            checked = [d for d, _ in copies if d.dtype == torch.float32] \
                if check else ()
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                done = torch.cuda.Event(enable_timing=True)
                with torch.cuda.stream(self._side):
                    if self._consumed[slot] is not None:
                        self._side.wait_event(self._consumed[slot])
                    start.record(self._side)
                    for d_buf, h_buf in copies:
                        d_buf.copy_(h_buf, non_blocking=True)
                    if check:
                        finite[slot] = _finite_flag(checked, self._flags[slot])
                    done.record(self._side)
                self._h2d[slot] = done
                timing.append((start, done))
                stats["put_s"] += time.perf_counter() - t1
            elif check:
                finite[slot] = _finite_flag(checked, None)
            nbytes = sum(h.numel() * h.element_size() for _, h in copies)
            stats["bytes"] += nbytes
            record_transfer(nbytes)
            return slot, m

        def emit(slot, m):
            if cuda:
                consumer.wait_event(self._h2d[slot])
            t0 = time.perf_counter()
            arrays = ring[slot][1]
            if check and m:
                if cuda:
                    # the flag's copy is behind the block's on the side
                    # stream; the host reads it once that is done
                    t1 = time.perf_counter()
                    self._h2d[slot].synchronize()
                    stats["wait_s"] += time.perf_counter() - t1
                ok = bool(finite[slot][0])
                if self.model_tiled:
                    # the row group decides together: a tile's non-finite
                    # value is its whole row group's
                    from .distributed import allgather_object

                    ok = all(allgather_object(ok, "model"))
                if not ok:
                    m = self._nonfinite_block(arrays, m)
                    if not m:
                        nnz_of[slot] = 0
            if spec:
                self._site("superblock_dispatch")
            if self.nnz_route:
                from .sparse_stream import SparseSlab

                data, cols, rows, indptr = arrays[0]
                k = nnz_of[slot]
                arrays = (SparseSlab(data[:k], cols[:k], rows[:k],
                                     self.block_rows, self.arrays[0].shape[1],
                                     cap=self.sparse_plan.cap,
                                     indptr=indptr),) + tuple(arrays[1:])
            yield Block(arrays, m)
            stats["consume_s"] += time.perf_counter() - t0
            if cuda:
                ev = torch.cuda.Event()
                ev.record(consumer)
                self._consumed[slot] = ev

        pending = deque()
        crashed = False
        # one span per pass: it nests under the enclosing fit span and
        # carries the pass's split and its counter deltas at close (the
        # consumer's launches run while the generator is suspended in it)
        with span("stream.pass") as pass_span:
            try:
                for j in range(len(order)):
                    pending.append(stage(j))
                    if len(pending) > self.prefetch:
                        yield from emit(*pending.popleft())
                while pending:
                    yield from emit(*pending.popleft())
                if self.collective:
                    # every process streams the same pass sequence over
                    # its own rows: the pass barrier (fault site
                    # pass_barrier, deadline config.stream_sync_timeout_s)
                    from .distributed import sync_stream_pass

                    sync_stream_pass("stream_pass")
            except GeneratorExit:
                # the consumer left the pass: the stream stays usable
                raise
            except BaseException:
                crashed = True
                raise
            finally:
                if cuda:
                    # behind every launch the consumer made on any block
                    # of this pass, also one cut short
                    ev = torch.cuda.Event()
                    ev.record(consumer)
                    self._consumed = [ev] * n_slots
                if cuda and timing:
                    timing[-1][1].synchronize()
                    stats["h2d_s"] = sum(s.elapsed_time(e)
                                         for s, e in timing) / 1e3
                if crashed:
                    self._abandon(cuda)
                stats["pass_s"] = time.perf_counter() - t_pass
                self.stats = stats
                tot = self.totals
                tot["passes"] += 1
                by_route = tot["reader_passes"]
                by_route[route] = by_route.get(route, 0) + 1
                for key in ("host_s", "put_s", "wait_s", "consume_s",
                            "h2d_s", "pass_s", "bytes", "nnz",
                            "packed_bytes"):
                    if stats.get(key) is not None:
                        tot[key] = tot.get(key, 0) + stats[key]
                tot_passes = self._epochs_total
                if tot_passes:
                    pass_span.add(passes_total=int(tot_passes))
                pass_span.add(
                    stream_pass=tot["passes"], n_rows=int(self.n_rows),
                    **{k: (round(v, 6) if isinstance(v, float) else v)
                       for k, v in stats.items()})

    def _nonfinite_block(self, arrays, m):
        """The policy for a block with a non-finite value: raise, or
        quarantine (its device buffers zeroed on the consumer's stream,
        its valid-row count 0)."""
        from ..reliability.faults import NonFiniteBlock

        if self._nonfinite == "raise":
            raise NonFiniteBlock(
                f"non-finite values in a streamed block of {m} rows "
                "(config.stream_nonfinite='raise')")
        from ..observability._counters import record_stream_quarantine

        for a in arrays:
            for t in (a if isinstance(a, tuple) else (a,)):
                t.zero_()
        record_stream_quarantine()
        return 0

    def _abandon(self, cuda):
        """After a pass ended in an exception: drain the side stream
        (every copy the pass queued lands before its buffers can be
        handed out again), close the readers and drop the ring."""
        if cuda and getattr(self, "_side", None) is not None:
            self._side.synchronize()
        self._close_readers()
        self._ring = None


def _file_holds(a) -> bool:
    """The memmap's file still holds every row the memmap maps (a file
    cut short under it would fault on a positional read)."""
    try:
        return os.stat(a.filename).st_size >= int(a.offset) + a.nbytes
    except (OSError, AttributeError, TypeError):
        return False


def _finite_flag(tensors, out):
    """Whether every value of ``tensors`` is finite, as a 1-element uint8
    tensor computed on their device; on the card it is copied into the
    pinned byte ``out`` on the current stream and ``out`` returned."""
    ok = None
    for t in tensors:
        f = torch.isfinite(t).all()
        ok = f if ok is None else ok & f
    flag = (torch.ones(1, dtype=torch.uint8) if ok is None
            else ok.to(torch.uint8).reshape(1))
    if out is None:
        return flag
    out.copy_(flag, non_blocking=True)
    return out


def _nnz_rows(a, lo, hi) -> int:
    """Nonzeros of rows [lo, hi) of a sparse source, off ``indptr``."""
    return sum(int(b.indptr[h]) - int(b.indptr[l])
               for b, l, h in csr_pieces(a, lo, hi))


def streamed_map(X, block_rows, fn, densify_reason=None):
    """Map ``fn(block) -> tensor (block_rows, ...)`` over X's blocks and
    concatenate the valid rows on the host: the one stream, compute,
    host pattern of every streamed inference path (GLM decision values,
    KMeans labels and distances). A sparse X's blocks are ``SparseSlab``s
    on the nnz route, unless ``densify_reason`` asks for dense ones. The
    output must keep X's rows, so ``stream_nonfinite="quarantine"``
    raises here, and the stream folds no training profile."""
    nf = get_config().stream_nonfinite
    outs = []
    for blk in BlockStream((X,), block_rows=block_rows,
                           densify_reason=densify_reason, profile=False,
                           nonfinite="raise" if nf != "off" else "off",
                           collective=False):
        outs.append(fn(blk)[: blk.n_rows].cpu().numpy())
    return np.concatenate(outs, axis=0)
