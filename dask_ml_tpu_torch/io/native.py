"""ctypes bindings of the port's host libraries: the CSV loader
(``csrc/fast_loader.cpp``) and the native block reader
(``csrc/block_reader.cpp``).

Counterpart of ``dask_ml_tpu/io/native.py``. Both libraries are built
by ``ops/_build.py`` with the host C++ compiler into the git-ignored
``_build/`` at first use; a failed build raises with the compiler's
output, and nothing falls back to numpy.

``NativeBlockReader`` serves ``parallel/streaming.py::BlockStream``:
``next(out)`` copies the next fixed-height block of a memmap's rows
from the library's own read-only mapping of the file straight into the
caller's buffer, the stream's pinned staging slot, on up to
``threads`` threads; ``rewind()`` starts the next pass.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from ..ops import _build

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _configure_fast_loader(lib):
    lib.csv_dims.restype = ctypes.c_int64
    lib.csv_dims.argtypes = [ctypes.c_char_p,
                             ctypes.POINTER(ctypes.c_int64)]
    lib.csv_parse_f32.restype = ctypes.c_int64
    lib.csv_parse_f32.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
    ]


def _configure_block_reader(lib):
    lib.br_open.restype = ctypes.c_void_p
    lib.br_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
    ]
    lib.br_next.restype = ctypes.c_int64
    lib.br_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.br_rewind.restype = None
    lib.br_rewind.argtypes = [ctypes.c_void_p]
    lib.br_close.restype = None
    lib.br_close.argtypes = [ctypes.c_void_p]


_CONFIGURE = {"fast_loader": _configure_fast_loader,
              "block_reader": _configure_block_reader}


def load_library(name="fast_loader") -> ctypes.CDLL:
    """The loaded, configured host library ``csrc/<name>.cpp``, built
    if missing; a failed build raises."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _build.load(name)
            _CONFIGURE[name](lib)
            _libs[name] = lib
        return lib


def read_csv_f32(path, n_threads=None) -> np.ndarray:
    """Parse a numeric CSV (comma, space or tab separated, no header)
    into a float32 array with the native multithreaded parser."""
    path = os.path.abspath(path)
    lib = load_library()
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    n_cols = ctypes.c_int64(0)
    n_rows = lib.csv_dims(path.encode(), ctypes.byref(n_cols))
    if n_rows < 0:
        raise IOError(f"cannot read {path!r} (code {n_rows})")
    out = np.empty((n_rows, n_cols.value), np.float32)
    got = lib.csv_parse_f32(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_rows, n_cols.value, n_threads,
    )
    if got < 0:
        raise ValueError(
            f"malformed CSV {path!r} (code {got}); expected "
            f"{n_cols.value} numeric columns per row"
        )
    return out[:got]


def read_csv_sharded(path, n_threads=None, device=None):
    """A CSV parsed natively, as a ``ShardedArray`` on ``config.device``
    (or ``device``)."""
    from ..parallel.sharded import as_sharded

    return as_sharded(read_csv_f32(path, n_threads=n_threads),
                      device=device)


class NativeBlockReader:
    """Sequential fixed-height row blocks of a memmap's file.

    ``next(out)`` copies the next block's rows into the head of ``out``
    (a contiguous host tensor of ``block_rows`` rows of the memmap's row
    bytes) on up to ``threads`` threads (the caller's and ``threads - 1``
    helpers) and returns the row count, 0 at the end of the file's rows;
    ``rewind()`` goes back to block 0. The file stays mapped and the
    helpers stay up until ``close()``, so the later passes of a reader
    copy through page tables filled by the first. A file cut short under
    the reader raises ``IOError`` at the next block; so does a failed
    open. The reader is also a context manager.

    ``threads`` defaults to ``torch.get_num_threads()``, the threads of
    the copy the reader replaces (torch's ``copy_`` out of the memmap):
    on an H100 machine's 8-core host the reader copied 24-35 GB/s on 8
    threads and 15-19 GB/s on 4 (``scripts/host_copy_rates.py``)."""

    def __init__(self, mm: np.memmap, block_rows: int, threads=None):
        if threads is None:
            threads = torch.get_num_threads()
        self._lib = load_library("block_reader")
        row_items = int(np.prod(mm.shape[1:], dtype=np.int64) or 1)
        self.row_bytes = int(mm.dtype.itemsize) * row_items
        self.block_rows = int(block_rows)
        self.n_rows = int(mm.shape[0])
        self._h = self._lib.br_open(
            str(mm.filename).encode(), int(mm.offset), self.row_bytes,
            self.n_rows, self.block_rows, int(threads),
        )
        if not self._h:
            raise IOError(f"br_open failed for {mm.filename!r} (rows "
                          f"{self.n_rows}, block rows {self.block_rows})")

    def next(self, out: torch.Tensor) -> int:
        nbytes = out.numel() * out.element_size()
        if not (out.is_contiguous() and out.device.type == "cpu") \
                or nbytes < self.block_rows * self.row_bytes:
            raise ValueError("the block reader copies into a contiguous "
                             f"host buffer of at least {self.block_rows} "
                             f"rows of {self.row_bytes} bytes")
        if not self._h:
            raise ValueError("the block reader is closed")
        rows = self._lib.br_next(self._h, out.data_ptr())
        if rows < 0:
            raise IOError("native block reader failed mid-stream (the "
                          "file is shorter than its rows)")
        return int(rows)

    def rewind(self):
        if not self._h:
            raise ValueError("the block reader is closed")
        self._lib.br_rewind(self._h)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.br_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover - GC path
        self.close()
