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

Not ported, and why: ``superblocks()`` and ``SuperBlock`` stack K blocks
into one jitted scan to amortise XLA's per-dispatch cost and donate the
accumulator buffers (``dask_ml_tpu/parallel/streaming.py:1318``). Here a
pass is one kernel launch per block, adding into device accumulators in
block order, and has neither cost. Sparse sources (ROADMAP.md queue 1,
Sparse), autotune, the non-finite block policy, I/O retries and the
training profile (queue 1, Checkpoints and reliability) are left out as
well; a sparse source raises.
"""

from __future__ import annotations

import time
import warnings
from collections import deque

import numpy as np
import torch

from ..config import get_config, resolve_device

# bytes of ONE block's X: fixed bytes, so any memmap streams in bounded
# blocks; the device then holds about (prefetch + 1) blocks
_AUTO_BLOCK_BYTES = 256 << 20
# rows of block 0 the reader's route test compares with the numpy slice
_VERIFY_ROWS = 4096


def _is_sparse(a) -> bool:
    import scipy.sparse as sp

    return sp.issparse(a)


def reject_sparse(X):
    """Sparse sources are not ported (ROADMAP.md queue 1, Sparse): raise
    for one."""
    if _is_sparse(X):
        raise NotImplementedError(
            "sparse sources are not ported yet: ROADMAP.md queue 1, Sparse "
            "(the streamed sparse fits); densify the rows first"
        )


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
    take the resident path. A scipy sparse matrix raises: sparse streams
    are ROADMAP.md queue 1, Sparse."""
    reject_sparse(X)
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
    a staging buffer's previous copy, ``consume_s`` the consumer's own
    host time per block, ``h2d_s`` the device copies' time by CUDA
    events (None on the CPU), ``pass_s`` the pass, ``bytes`` copied,
    ``reader`` the route that filled X's staging buffers (``"native"``:
    the block reader, whose open and ``br_next`` calls ``host_s`` then
    counts; ``"copy"``).
    ``totals`` sums them over every pass so far, with ``passes`` and
    ``reader_passes``, the passes of each route of X.
    """

    def __init__(self, arrays, block_rows=None, shuffle=False, seed=None):
        self.arrays = tuple(arrays)
        for a in self.arrays:
            if _is_sparse(a) or not isinstance(a, np.ndarray):
                raise TypeError("BlockStream streams host numpy arrays "
                                f"only, got {type(a).__name__}")
        n = len(self.arrays[0])
        if any(len(a) != n for a in self.arrays):
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
        self.stats = None
        self.totals = {"passes": 0, "reader_passes": {}}
        self._ring = None
        self._native = None

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
                shapes = [(self.block_rows,) + tuple(a.shape[1:])
                          for a in self.arrays]
                host = tuple(torch.empty(s, dtype=torch.float32,
                                         pin_memory=cuda) for s in shapes)
                dev = tuple(torch.full(s, torch.nan, dtype=torch.float32,
                                       device=self.device)
                            for s in shapes) if cuda else host
                if not cuda:
                    for h in host:
                        h.fill_(torch.nan)
                ring.append((host, dev))
            self._ring = ring
            self._h2d = [None] * n_slots       # event behind a slot's copy
            self._consumed = [None] * n_slots  # event behind its consumer
            self._side = torch.cuda.Stream(self.device) if cuda else None
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
                for a in self.arrays:
                    ok = (isinstance(a, np.memmap) and a.dtype == np.float32
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
            return (None,) * len(self.arrays)
        readers = self._native_readers()
        for r in readers:
            if r is not None:
                r.rewind()
        return readers

    def _copy_rows(self, dst, a, lo, hi, beside_reader=False):
        src = np.asarray(a[lo:hi])
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

    def __iter__(self):
        return self.blocks()

    def epochs(self, n_epochs):
        """``n_epochs`` passes, each in a fresh order when the stream
        shuffles."""
        for _ in range(int(n_epochs)):
            yield from self.blocks()

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
            for i, (dst, a) in enumerate(zip(host, self.arrays)):
                if readers[i] is not None:
                    got = readers[i].next(dst)
                    if got != hi - lo:
                        raise IOError(f"the block reader gave {got} rows of "
                                      f"block {order[j]}, not {hi - lo}")
                else:
                    self._copy_rows(dst, a, lo, hi, beside_reader)
            t1 = time.perf_counter()
            stats["host_s"] += t1 - t0
            m = hi - lo
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                done = torch.cuda.Event(enable_timing=True)
                with torch.cuda.stream(self._side):
                    if self._consumed[slot] is not None:
                        self._side.wait_event(self._consumed[slot])
                    start.record(self._side)
                    for d_buf, h_buf in zip(dev, host):
                        d_buf[:m].copy_(h_buf[:m], non_blocking=True)
                    done.record(self._side)
                self._h2d[slot] = done
                timing.append((start, done))
                stats["put_s"] += time.perf_counter() - t1
            stats["bytes"] += sum(h[:m].numel() * 4 for h in host)
            return slot, m

        def emit(slot, m):
            if cuda:
                consumer.wait_event(self._h2d[slot])
            t0 = time.perf_counter()
            yield Block(ring[slot][1], m)
            stats["consume_s"] += time.perf_counter() - t0
            if cuda:
                ev = torch.cuda.Event()
                ev.record(consumer)
                self._consumed[slot] = ev

        pending = deque()
        try:
            for j in range(len(order)):
                pending.append(stage(j))
                if len(pending) > self.prefetch:
                    yield from emit(*pending.popleft())
            while pending:
                yield from emit(*pending.popleft())
        finally:
            if cuda:
                # behind every launch the consumer made on any block of
                # this pass, also one cut short
                ev = torch.cuda.Event()
                ev.record(consumer)
                self._consumed = [ev] * n_slots
            if cuda and timing:
                timing[-1][1].synchronize()
                stats["h2d_s"] = sum(s.elapsed_time(e)
                                     for s, e in timing) / 1e3
            stats["pass_s"] = time.perf_counter() - t_pass
            self.stats = stats
            tot = self.totals
            tot["passes"] += 1
            by_route = tot["reader_passes"]
            by_route[route] = by_route.get(route, 0) + 1
            for key in ("host_s", "put_s", "wait_s", "consume_s", "h2d_s",
                        "pass_s", "bytes"):
                if stats[key] is not None:
                    tot[key] = tot.get(key, 0) + stats[key]


def streamed_map(X, block_rows, fn):
    """Map ``fn(block) -> tensor (block_rows, ...)`` over X's blocks and
    concatenate the valid rows on the host: the one stream, compute,
    host pattern of every streamed inference path (GLM decision values,
    KMeans labels and distances)."""
    outs = []
    for blk in BlockStream((X,), block_rows=block_rows):
        outs.append(fn(blk)[: blk.n_rows].cpu().numpy())
    return np.concatenate(outs, axis=0)
