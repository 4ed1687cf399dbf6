"""The port's native host I/O on the CPU: the block reader
(``csrc/block_reader.cpp``, built into ``dask_ml_tpu_torch/_build/`` with
the host compiler) under ``BlockStream``, and the CSV loader
(``csrc/fast_loader.cpp``). Both are held to numpy, not to the JAX
package's loader, which builds its libraries inside ``native/``."""

import gc
import os

import numpy as np
import pytest
import torch

from dask_ml_tpu_torch import config
from dask_ml_tpu_torch.io import (NativeBlockReader, read_csv_f32,
                                  read_csv_sharded)
from dask_ml_tpu_torch.ops import _build
from dask_ml_tpu_torch.parallel.streaming import BlockStream


@pytest.fixture(autouse=True)
def _cpu():
    with config.set(device="cpu"):
        yield


def _memmap(tmp_path, X, name="X.bin", offset=0):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(b"\x7f" * offset)
        f.write(np.ascontiguousarray(X).tobytes())
    return np.memmap(path, dtype=X.dtype, mode="r", shape=X.shape,
                     offset=offset)


def _pass(stream):
    """One pass's valid rows of every array, as numpy."""
    out = [[] for _ in stream.arrays]
    for blk in stream.blocks():
        for i, a in enumerate(blk.arrays):
            out[i].append(a[: blk.n_rows].numpy().copy())
    return [np.concatenate(o) for o in out]


def _threads():
    return len(os.listdir("/proc/self/task"))


def test_reader_builds_into_the_port_build_dir():
    lib = _build.build(("block_reader", "fast_loader"))
    for path in lib.values():
        assert os.path.dirname(path) == _build.BUILD_DIR
        assert os.path.exists(path)
    native = os.path.join(os.path.dirname(_build.PKG_DIR), "native")
    assert not any(p.startswith(native) for p in lib.values())


@pytest.mark.parametrize("n,block", [(1000, 128), (1024, 128), (77, 100),
                                     (500, 1)])
def test_blocks_equal_memmap_slices(tmp_path, n, block):
    """Every block of a sequential pass, the ragged last one included, is
    bit-equal to the memmap's slice, NaN rows too, and the float64
    labels beside X (an in-memory ndarray, copied on the calling thread)
    equal their f32 cast, as torch's copy casts them."""
    rng = np.random.RandomState(n)
    X = rng.randn(n, 7).astype(np.float32)
    X[3, 2] = np.nan
    y = rng.randn(n)
    mm = _memmap(tmp_path, X)
    stream = BlockStream((mm, y), block_rows=block)
    gx, gy = _pass(stream)
    np.testing.assert_array_equal(gx, X)
    np.testing.assert_array_equal(gy, torch.from_numpy(y).float().numpy())
    assert stream.stats["reader"] == "native"
    assert stream.stats["bytes"] == X.nbytes + y.nbytes // 2
    # a second pass rewinds the stream's reader
    np.testing.assert_array_equal(_pass(stream)[0], X)
    assert stream.totals["reader_passes"] == {"native": 2}


@pytest.mark.parametrize("offset", [16, 4096 + 12])
def test_memmap_with_offset(tmp_path, offset):
    X = np.arange(600 * 5, dtype=np.float32).reshape(600, 5)
    mm = _memmap(tmp_path, X, offset=offset)
    stream = BlockStream((mm,), block_rows=64)
    np.testing.assert_array_equal(_pass(stream)[0], X)
    assert stream.stats["reader"] == "native"


def test_sliced_view_and_float64_take_the_copy(tmp_path):
    """A memmap sliced past its head keeps its parent's ``offset``, and
    the reader's block 0 differs from the slice: that stream copies. A
    float64 memmap copies too (the ring is f32). Each route is on
    record, and the blocks are right either way."""
    rng = np.random.RandomState(1)
    X = rng.randn(900, 4).astype(np.float32)
    mm = _memmap(tmp_path, X)
    view = mm[100:]
    stream = BlockStream((view,), block_rows=128)
    np.testing.assert_array_equal(_pass(stream)[0], X[100:])
    assert stream.stats["reader"] == "copy"
    assert stream.totals["reader_passes"] == {"copy": 1}
    cols = mm[:, 1:3]
    stream = BlockStream((cols,), block_rows=128)
    np.testing.assert_array_equal(_pass(stream)[0], X[:, 1:3])
    assert stream.stats["reader"] == "copy"
    X64 = X.astype(np.float64)
    mm64 = _memmap(tmp_path, X64, name="X64.bin")
    stream = BlockStream((mm64,), block_rows=128)
    np.testing.assert_array_equal(_pass(stream)[0], X)
    assert stream.stats["reader"] == "copy"


def test_out_of_order_passes_copy(tmp_path):
    """Shuffled passes and explicit orders other than the sequence copy;
    an explicit order that is the sequence reads ahead."""
    X = np.random.RandomState(2).randn(640, 3).astype(np.float32)
    mm = _memmap(tmp_path, X)
    stream = BlockStream((mm,), block_rows=64, shuffle=True, seed=0)
    list(stream.blocks())
    assert stream.stats["reader"] == "copy"
    stream = BlockStream((mm,), block_rows=64)
    got = [blk.arrays[0][: blk.n_rows].numpy().copy()
           for blk in stream.blocks(order=[3, 1, 2])]
    np.testing.assert_array_equal(np.concatenate(got),
                                  np.concatenate([X[192:256], X[64:192]]))
    assert stream.stats["reader"] == "copy"
    list(stream.blocks(order=range(10)))
    assert stream.stats["reader"] == "native"


def test_truncated_file_raises(tmp_path):
    """A file cut short under the reader raises IOError mid-pass; nothing
    falls back to the copy (which would read past the mapping's end)."""
    X = np.random.RandomState(3).randn(4000, 8).astype(np.float32)
    mm = _memmap(tmp_path, X)
    stream = BlockStream((mm,), block_rows=500)
    np.testing.assert_array_equal(_pass(stream)[0], X)
    os.truncate(mm.filename, X.nbytes // 2)
    with pytest.raises(IOError, match="mid-stream|rows of block"):
        _pass(stream)
    r = NativeBlockReader(mm, 3000)
    buf = torch.empty((3000, 8))
    with pytest.raises(IOError):
        r.next(buf)
    r.close()


def test_missing_file_raises(tmp_path):
    X = np.zeros((10, 2), np.float32)
    mm = _memmap(tmp_path, X)
    os.remove(mm.filename)
    with pytest.raises(IOError, match="br_open"):
        NativeBlockReader(mm, 4)


def _maps(path):
    with open("/proc/self/maps") as f:
        return sum(line.rstrip().endswith(path) for line in f)


def test_broken_pass_leaves_no_thread(tmp_path):
    """The stream's reader maps the file and starts its copy helpers
    (one fewer than torch's threads) once, at its first sequential pass,
    and ends both with the stream. A consumer that leaves a pass early
    leaves no thread or mapping beyond them, and the next pass starts
    from block 0."""
    X = np.random.RandomState(4).randn(3000, 6).astype(np.float32)
    mm = _memmap(tmp_path, X)
    path = os.path.realpath(mm.filename)
    torch.zeros(4).sum()
    before, maps = _threads(), _maps(path)
    helpers = torch.get_num_threads() - 1
    stream = BlockStream((mm,), block_rows=200)
    _pass(stream)
    assert (_threads(), _maps(path)) == (before + helpers, maps + 1)
    for j, blk in enumerate(stream.blocks()):
        if j == 2:
            break
    del blk
    gc.collect()
    assert (_threads(), _maps(path)) == (before + helpers, maps + 1)
    gen = stream.blocks()
    next(gen)
    gen.close()
    np.testing.assert_array_equal(_pass(stream)[0], X)
    assert stream.totals["reader_passes"] == {"native": 4}
    del stream
    gc.collect()
    assert (_threads(), _maps(path)) == (before, maps)


@pytest.mark.parametrize("threads", [1, 2, 3])
def test_reader_threads(tmp_path, threads):
    """The reader itself on 1-3 threads (blocks of 4 MiB, split in 1 MiB
    shares at least): blocks in sequence into a torch buffer, the
    ragged tail, then 0 at the end; rewound, the same blocks again."""
    X = np.random.RandomState(threads).randn(3001, 1024).astype(np.float32)
    mm = _memmap(tmp_path, X)
    buf = torch.empty((1024, 1024))
    with NativeBlockReader(mm, 1024, threads=threads) as r:
        for _ in range(2):
            got = []
            r.rewind()
            while True:
                rows = r.next(buf)
                if rows == 0:
                    break
                got.append(buf[:rows].numpy().copy())
            assert [len(g) for g in got] == [1024, 1024, 953]
            np.testing.assert_array_equal(np.concatenate(got), X)
    with pytest.raises(ValueError, match="closed"):
        r.rewind()


def test_copy_on_write_memmap_takes_the_copy(tmp_path):
    """A ``mode="c"`` memmap edited past the rows the route test reads
    differs from its file there: the stream copies it, and its blocks
    equal the edited array."""
    from dask_ml_tpu_torch.parallel.streaming import _VERIFY_ROWS

    n = _VERIFY_ROWS + 1000
    X = np.random.RandomState(5).randn(n, 3).astype(np.float32)
    _memmap(tmp_path, X)
    cow = np.memmap(str(tmp_path / "X.bin"), dtype=np.float32, mode="c",
                    shape=X.shape)
    cow[_VERIFY_ROWS + 10] = 7.0
    X[_VERIFY_ROWS + 10] = 7.0
    stream = BlockStream((cow,), block_rows=1024)
    np.testing.assert_array_equal(_pass(stream)[0], X)
    assert stream.stats["reader"] == "copy"
    assert stream.totals["reader_passes"] == {"copy": 1}


def test_reader_refuses_a_short_buffer(tmp_path):
    mm = _memmap(tmp_path, np.zeros((50, 4), np.float32))
    with NativeBlockReader(mm, 16) as r:
        with pytest.raises(ValueError, match="contiguous host buffer"):
            r.next(torch.empty((8, 4)))
        with pytest.raises(ValueError, match="contiguous host buffer"):
            r.next(torch.empty((16, 8))[:, :4])


def test_csv_matches_loadtxt(tmp_path):
    rng = np.random.RandomState(0)
    X = rng.randn(1000, 7).astype(np.float32)
    p = tmp_path / "data.csv"
    np.savetxt(p, X, delimiter=",", fmt="%.6f")
    ref = np.loadtxt(p, delimiter=",", dtype=np.float32, ndmin=2)
    got = read_csv_f32(str(p))
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(read_csv_f32(str(p), n_threads=1),
                                  read_csv_f32(str(p), n_threads=8))
    sx = read_csv_sharded(str(p))
    assert sx.device.type == "cpu"
    np.testing.assert_array_equal(sx.to_numpy(), ref)


def test_csv_errors(tmp_path):
    p = tmp_path / "bad.csv"
    p.write_text("1.0,2.0\n3.0\n")
    with pytest.raises(ValueError, match="malformed"):
        read_csv_f32(str(p))
    with pytest.raises(IOError):
        read_csv_f32(str(tmp_path / "missing.csv"))


def test_decomposition_and_reader_load_no_jax(tmp_path):
    """The decomposition fits (resident and from a memmap through the
    reader) and the CSV loader, in a fresh interpreter, leave jax,
    scikit-learn and the JAX package out of sys.modules."""
    import subprocess
    import sys

    root = os.path.dirname(_build.PKG_DIR)
    code = f"""
import sys
sys.path.insert(0, {root!r})
import numpy as np
from dask_ml_tpu_torch import config
from dask_ml_tpu_torch.decomposition import PCA, IncrementalPCA, TruncatedSVD
from dask_ml_tpu_torch.io import read_csv_f32
rng = np.random.RandomState(0)
X = np.memmap({str(tmp_path / "X.f32")!r}, dtype=np.float32, mode="w+",
              shape=(400, 6))
X[:] = rng.randn(400, 6)
np.savetxt({str(tmp_path / "X.csv")!r}, X[:10], delimiter=",")
with config.set(device="cpu", stream_block_rows=128):
    p = PCA(n_components=2).fit(X)
    assert p.stream_stats_["reader_passes"] == {{"native": 1}}
    p.transform(X)
    TruncatedSVD(2, algorithm="randomized").fit(X)
    PCA(n_components=2).fit(np.asarray(X)).score(np.asarray(X))
    IncrementalPCA(n_components=2, batch_size=100).fit(X)
read_csv_f32({str(tmp_path / "X.csv")!r})
bad = ("jax", "jaxlib", "optax", "sklearn", "dask_ml_tpu")
print(sorted(m for m in sys.modules if m.split(".")[0] in bad))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout
