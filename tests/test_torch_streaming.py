"""The port's block streaming (dask_ml_tpu_torch/parallel/streaming.py)
against dask_ml_tpu's on the same host arrays, on the CPU: the same
block plan (``auto_block_rows``, ``stream_plan``), the same blocks (their
count, height, valid rows and contents), and the staging ring's contract
that rows past a block's count are stale and never zeroed."""

import numpy as np
import pytest
import torch

from dask_ml_tpu import config as jconfig
from dask_ml_tpu.parallel import streaming as J
from dask_ml_tpu_torch import config
from dask_ml_tpu_torch.parallel import streaming as T


@pytest.fixture(autouse=True)
def _fresh_staging(monkeypatch):
    """dask_ml_tpu's host streams stage every superblock in fresh buffers,
    the reference's own switch for backends whose ``device_put`` aliases
    host memory: jax's CPU backend aliases a 64-byte-aligned numpy array,
    and a reused staging slab could then be rewritten under a read that
    is still queued. Its one-time probe (an 8-float array, copied) does
    not see that."""
    monkeypatch.setattr(J, "_PUT_ALIASES", True)


@pytest.fixture(autouse=True)
def _cpu():
    with config.set(device="cpu"):
        yield


def _memmap(tmp_path, X, dtype=np.float32):
    path = str(tmp_path / "X.bin")
    mm = np.memmap(path, dtype=dtype, mode="w+", shape=X.shape)
    mm[:] = X
    mm.flush()
    return np.memmap(path, dtype=dtype, mode="r", shape=X.shape)


def _jax_blocks(arrays, block_rows):
    with jconfig.set(stream_mesh=1):
        stream = J.BlockStream(arrays, block_rows=block_rows, profile=False)
        blocks = [(blk.n_rows, [np.asarray(a)[: blk.n_rows]
                                for a in blk.arrays]) for blk in stream]
    return stream, blocks


@pytest.mark.parametrize("n,block_rows", [(1000, 300), (1000, 1000),
                                          (999, 250), (7, 2)])
def test_blocks_match_jax(tmp_path, n, block_rows):
    rng = np.random.RandomState(n)
    X = rng.randn(n, 5)
    y = rng.randn(n).astype(np.float32)
    mm = _memmap(tmp_path, X, np.float64)
    js, jb = _jax_blocks((mm, y), block_rows)
    ts = T.BlockStream((mm, y), block_rows=block_rows)
    assert (ts.n_blocks, ts.block_rows) == (js.n_blocks, js.block_rows)
    tb = [(blk.n_rows, [a[: blk.n_rows].numpy().copy()
                        for a in blk.arrays]) for blk in ts]
    assert [m for m, _ in tb] == [m for m, _ in jb]
    for (_, ta), (_, ja) in zip(tb, jb):
        for a, b in zip(ta, ja):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_auto_rule_and_plan_match_jax(tmp_path):
    """256 MB of f32 X per block; a memmap always streams; an ndarray
    streams only above a positive stream_block_rows; tensors never."""
    for n, row_bytes in [(10 ** 9, 1024), (10 ** 9, 512), (5, 4),
                         (10 ** 7, 1 << 30)]:
        assert T.auto_block_rows(n, row_bytes) == \
            J.auto_block_rows(n, row_bytes)
    assert T.auto_block_rows(10 ** 9, 1024) == 262_144
    assert T.auto_block_rows(10 ** 9, 512) == 524_288
    X = np.zeros((500, 3), np.float32)
    mm = _memmap(tmp_path, X)
    with jconfig.set(stream_mesh=1):
        for knob in (0, 100, 499, 500, 800):
            with config.set(stream_block_rows=knob), \
                    jconfig.set(stream_block_rows=knob):
                for src in (mm, X):
                    assert T.stream_plan(src) == J.stream_plan(src)
                assert T.stream_plan(torch.from_numpy(X)) is None
    assert T.stream_plan(mm) == 500
    assert T.stream_plan(X) is None
    with config.set(stream_block_rows=100):
        assert T.stream_plan(X) == 100
        assert T.stream_plan(np.zeros((0, 3))) is None
        s = T.BlockStream((X,))
        assert (s.block_rows, s.n_blocks) == (100, 5)


def test_stale_tail_rows_are_not_zeroed():
    """The ragged last block is copied up to its count only: in a ring
    that has not held a longer block there, its tail stays NaN."""
    X = np.arange(50, dtype=np.float32).reshape(25, 2)
    s = T.BlockStream((X,), block_rows=15)
    assert s.n_blocks == 2
    for _ in range(2):
        blocks = [(blk.n_rows, blk.arrays[0].clone()) for blk in s]
        (m0, b0), (m1, b1) = blocks
        assert (m0, m1) == (15, 10)
        torch.testing.assert_close(b0, torch.from_numpy(X[:15]))
        torch.testing.assert_close(b1[:10], torch.from_numpy(X[15:]))
        assert torch.isnan(b1[10:]).all()
    # three blocks in a ring of two: the tail holds the first block's rows
    s = T.BlockStream((X,), block_rows=10)
    last = [blk.arrays[0].clone() for blk in s][-1]
    torch.testing.assert_close(last[5:], torch.from_numpy(X[5:10]))


def test_prefetch_ring_and_stats():
    X = np.random.RandomState(0).randn(1000, 4).astype(np.float32)
    with config.set(stream_prefetch=2):
        s = T.BlockStream((X,), block_rows=100)
    assert s.prefetch == 2
    # a block lives in its ring slot until the next one is asked for
    got = np.concatenate([blk.arrays[0][: blk.n_rows].numpy().copy()
                          for blk in s])
    np.testing.assert_array_equal(got, X)
    assert len(s._ring) == 3
    st = s.stats
    assert st["n_blocks"] == 10 and st["bytes"] == X.nbytes
    assert st["h2d_s"] is None and st["host_s"] >= 0 and st["pass_s"] > 0
    list(s)
    assert s.totals["passes"] == 2 and s.totals["bytes"] == 2 * X.nbytes


def test_streamed_map_keeps_row_order():
    X = np.random.RandomState(1).randn(1003, 3).astype(np.float32)
    out = T.streamed_map(X, 100, lambda blk: blk.arrays[0].sum(1))
    np.testing.assert_allclose(out, X.sum(1), rtol=1e-6)
    with pytest.raises(TypeError, match="numpy"):
        T.BlockStream((torch.zeros(3, 2),))
    with pytest.raises(ValueError, match="inconsistent"):
        T.BlockStream((X, X[:5]))
