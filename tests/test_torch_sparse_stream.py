"""The port's sparse staging and sparse products against dask_ml_tpu's,
on the CPU.

- ``ops/sparse_kernels.py``: the six functions of the JAX module on the
  same seeded COO triples (rows ascending, duplicate columns in a row
  kept), within 1e-6 of JAX and of scipy's float64 products; the
  transposed products (``Xᵀr``, ``XᵀR``) against the JAX gradient of
  ``sparse_eta`` / ``sparse_eta_multi``; two runs bit-equal.
- ``parallel/sparse_stream.py``: ``plan_sparse_stream`` at one shard
  equal to JAX's (bucket sequence, ``cap``, ``cap1``, reason strings,
  over-density and over-bucket spill included), ``pack_block`` and
  ``coo_rows`` against JAX's.
- ``BlockStream``'s two routes: the nnz route's slabs and the densify
  route's blocks hold X's rows, the route and reason decided as JAX
  decides them.
- The port's sparse modules import no jax, dask_ml_tpu or sklearn.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp
from dask_ml_tpu.ops import sparse_kernels as JK
from dask_ml_tpu.parallel import sparse_stream as JSS
from dask_ml_tpu.parallel.streaming import SparseBlocks as JSparseBlocks
from dask_ml_tpu_torch import config
from dask_ml_tpu_torch.ops import sparse_kernels as TK
from dask_ml_tpu_torch.parallel import sparse_stream as TSS
from dask_ml_tpu_torch.parallel.streaming import (BlockStream, SparseBlocks,
                                                  as_row_indexable,
                                                  block_dense, stream_plan)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu():
    with config.set(device="cpu"):
        yield


def _csr(seed=0, n=300, d=50, density=0.05, dups=True):
    """A seeded CSR matrix whose rows carry duplicate column hits (left
    unsummed, as bench.py's corpus keeps them) and a few empty rows."""
    rng = np.random.RandomState(seed)
    A = sp.random(n, d, density=density, format="csr", random_state=rng,
                  dtype=np.float32)
    if not dups:
        return A
    extra = rng.randint(0, n, 40)
    rows = np.concatenate([np.repeat(np.arange(n), np.diff(A.indptr)),
                           extra])
    cols = np.concatenate([A.indices, A.indices[rng.randint(0, A.nnz, 40)]])
    vals = np.concatenate([A.data, rng.rand(40).astype(np.float32)])
    order = np.argsort(rows, kind="stable")
    indptr = np.searchsorted(rows[order], np.arange(n + 1))
    return sp.csr_matrix((vals[order], cols[order], indptr), shape=(n, d))


def _triples(A):
    data = A.data.astype(np.float32)
    cols = A.indices.astype(np.int32)
    rows = np.repeat(np.arange(A.shape[0], dtype=np.int32),
                     np.diff(A.indptr))
    return data, cols, rows


def _both(A):
    data, cols, rows = _triples(A)
    t = tuple(torch.from_numpy(v) for v in (data, cols, rows))
    j = tuple(jnp.asarray(v) for v in (data, cols, rows))
    return t, j


def test_row_products_match_jax_and_scipy():
    A = _csr()
    n, d = A.shape
    (td, tc, tr), (jd, jc, jr) = _both(A)
    rng = np.random.RandomState(1)
    w = rng.randn(d).astype(np.float32)
    W = rng.randn(4, d).astype(np.float32)
    D64 = A.toarray().astype(np.float64)
    cases = [
        (TK.sparse_eta(td, tc, tr, torch.from_numpy(w), n),
         JK.sparse_eta(jd, jc, jr, jnp.asarray(w), n), D64 @ w),
        (TK.sparse_eta_multi(td, tc, tr, torch.from_numpy(W), n),
         JK.sparse_eta_multi(jd, jc, jr, jnp.asarray(W), n), D64 @ W.T),
        (TK.sparse_center_dots(td, tc, tr, torch.from_numpy(W), n),
         JK.sparse_center_dots(jd, jc, jr, jnp.asarray(W), n), D64 @ W.T),
        # per entry, duplicates squared one by one (as segment_sum does)
        (TK.sparse_sq_norms(td, tr, n), JK.sparse_sq_norms(jd, jr, n),
         np.bincount(_triples(A)[2], weights=A.data.astype(np.float64) ** 2,
                     minlength=n)),
    ]
    for t, j, ref in cases:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)
        np.testing.assert_allclose(t.numpy(), ref, atol=1e-6)


def test_densify_and_label_sums_match_jax_and_scipy():
    A = _csr(seed=2)
    n, d = A.shape
    (td, tc, tr), (jd, jc, jr) = _both(A)
    D64 = A.toarray().astype(np.float64)
    dense = TK.sparse_densify(td, tc, tr, n, d)
    np.testing.assert_allclose(dense.numpy(),
                               np.asarray(JK.sparse_densify(jd, jc, jr, n, d)),
                               atol=1e-6)
    np.testing.assert_allclose(dense.numpy(), D64, atol=1e-6)
    labels = np.random.RandomState(3).randint(0, 5, n)
    ref = np.zeros((5, d))
    np.add.at(ref, labels, D64)
    t = TK.sparse_label_sums(td, tc, tr, torch.from_numpy(labels), 5, d)
    j = JK.sparse_label_sums(jd, jc, jr, jnp.asarray(labels), 5, d)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)
    np.testing.assert_allclose(t.numpy(), ref, atol=1e-6)
    # two runs bit-equal (the densify's run trick, the sorted sums)
    assert torch.equal(dense, TK.sparse_densify(td, tc, tr, n, d))
    assert torch.equal(t, TK.sparse_label_sums(
        td, tc, tr, torch.from_numpy(labels), 5, d))


def test_transposed_products_match_jax_gradients():
    """Xᵀr and XᵀR, which JAX gets from the autodiff of ``take``."""
    A = _csr(seed=4)
    n, d = A.shape
    (td, tc, tr), (jd, jc, jr) = _both(A)
    rng = np.random.RandomState(5)
    r = rng.randn(n).astype(np.float32)
    R = rng.randn(n, 3).astype(np.float32)
    jg = jax.grad(lambda w: jnp.sum(
        JK.sparse_eta(jd, jc, jr, w, n) * jnp.asarray(r)))(jnp.zeros(d))
    jG = jax.grad(lambda W: jnp.sum(
        JK.sparse_eta_multi(jd, jc, jr, W, n) * jnp.asarray(R)))(
        jnp.zeros((3, d)))
    t = TK.sparse_xt_r(td, tc, tr, torch.from_numpy(r), d)
    T = TK.sparse_xt_R(td, tc, tr, torch.from_numpy(R), d)
    D64 = A.toarray().astype(np.float64)
    np.testing.assert_allclose(t.numpy(), np.asarray(jg), atol=1e-6)
    np.testing.assert_allclose(t.numpy(), D64.T @ r, atol=1e-6)
    np.testing.assert_allclose(T.numpy().T, np.asarray(jG), atol=1e-6)
    np.testing.assert_allclose(T.numpy(), D64.T @ R, atol=1e-6)
    assert torch.equal(T, TK.sparse_xt_R(td, tc, tr, torch.from_numpy(R), d))


def _plan_fields(p):
    return (p.n_rows, p.n_features, p.block_rows, p.shards, p.cap, p.cap1,
            tuple(p.block_buckets), p.total_nnz, p.reason)


@pytest.mark.parametrize("case", ["corpus", "blocks", "over-density",
                                  "over-bucket", "tiny"])
def test_plan_matches_jax(case):
    A = _csr(seed=6, n=2000, d=200, density=0.01)
    br, dens = 256, 0.25
    if case == "over-density":
        A = _csr(seed=7, n=300, d=20, density=0.4, dups=False)
    elif case == "over-bucket":
        # one dense block in a sparse corpus
        B = sp.lil_matrix(A)
        B[256:300, :] = 1.0
        A, dens = B.tocsr(), 0.15
    elif case == "tiny":
        A, br = _csr(seed=8, n=10, d=5, density=0.2, dups=False), 64
    t_src, j_src = A, A
    if case == "blocks":
        t_src = SparseBlocks([A[:700], A[700:1500], A[1500:]])
        j_src = JSparseBlocks([A[:700], A[700:1500], A[1500:]])
    t = TSS.plan_sparse_stream(t_src, br, 1, dens)
    j = JSS.plan_sparse_stream(j_src, br, 1, dens)
    assert _plan_fields(t) == _plan_fields(j)
    assert t.density == j.density and t.engaged == j.engaged
    assert t.block_bytes() == j.block_bytes()
    if case in ("over-density", "over-bucket"):
        assert not t.engaged and ("spill" in t.reason) == (
            case == "over-bucket")


def test_pack_block_and_coo_rows_match_jax():
    A = _csr(seed=9)
    src = SparseBlocks([A[:100], A[100:250], A[250:]])
    jsrc = JSparseBlocks([A[:100], A[100:250], A[250:]])
    lo, hi = 80, 270
    t = TSS.coo_rows(src, lo, hi)
    j = JSS.coo_rows(jsrc, lo, hi)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
    cap = 4096
    bufs = [np.empty(cap, np.float32), np.empty(cap, np.int32),
            np.empty(cap, np.int32), np.empty(hi - lo + 11, np.int64)]
    nnz = TSS.pack_block(src, lo, hi, cap, *bufs)
    jbufs = [np.empty(cap, np.float32), np.empty(cap, np.int32),
             np.empty(cap, np.int32)]
    jnnz = JSS.pack_block(jsrc, lo, hi, 1, hi - lo, cap, *jbufs)
    assert nnz == jnnz
    for a, b in zip(bufs[:3], jbufs):
        np.testing.assert_array_equal(a[:nnz], b[:nnz])
    np.testing.assert_array_equal(
        bufs[3], np.r_[A.indptr[lo:hi + 1] - A.indptr[lo],
                       np.full(10, nnz)])
    with pytest.raises(ValueError, match="planned capacity"):
        TSS.pack_block(src, lo, hi, nnz - 1, *bufs)


@pytest.mark.parametrize("src", ["csr", "blocks", "coo"])
def test_block_stream_routes(src):
    A = _csr(seed=10, n=700, d=30)
    if src == "coo":
        A = A.tocoo().tocsr()   # scipy's conversion sums the duplicates
    X = {"csr": A, "coo": A.tocoo(),
         "blocks": SparseBlocks([A[:123], A[123:600], A[600:]])}[src]
    y = np.arange(700, dtype=np.float32)
    D = A.toarray()
    assert stream_plan(X) == 700        # a sparse source always streams
    s = BlockStream((X, y), block_rows=200)
    assert s.nnz_route and s.sparse_reason is None
    for _ in range(2):                  # the ring is reused
        for b, blk in enumerate(s.blocks()):
            x = blk.arrays[0]
            assert isinstance(x, TSS.SparseSlab) and x.cap == \
                s.sparse_plan.cap
            lo = 200 * b
            np.testing.assert_allclose(
                block_dense(x)[:blk.n_rows].numpy(), D[lo:lo + blk.n_rows],
                atol=0)
            np.testing.assert_array_equal(blk.arrays[1][:blk.n_rows].numpy(),
                                          y[lo:lo + blk.n_rows])
    assert s.stats["nnz"] == A.nnz and s.totals["nnz"] == 2 * A.nnz
    # the ring holds X's packed buffers at the plan's capacity, and no
    # dense buffer of X's block
    for host, _ in s._ring:
        assert isinstance(host[0], tuple) and host[0][0].numel() == \
            s.sparse_plan.cap and host[1].shape == (200,)
    assert s.stats["packed_bytes"] == 12 * A.nnz + 8 * 201 * 4
    for cfg, reason in ((dict(stream_sparse=False), "stream-sparse-off"),
                        (dict(stream_sparse_max_density=1e-3),
                         "density 0.0519 > stream_sparse_max_density "
                         "0.001")):
        with config.set(**cfg):
            r = BlockStream((X, y), block_rows=200)
        assert r.sparse_route == "densify" and r.sparse_reason == reason
        for b, blk in enumerate(r):
            np.testing.assert_array_equal(
                blk.arrays[0][:blk.n_rows].numpy(),
                D[200 * b:200 * b + blk.n_rows])
        assert r.stats["nnz"] == A.nnz
    r = BlockStream((X, sp.csr_matrix(y[:, None])), block_rows=200)
    assert r.sparse_reason == "sparse-operand-layout"
    r = BlockStream((X, y), block_rows=200, densify_reason="per-block-path")
    assert r.sparse_route == "densify" and r.sparse_reason == \
        "per-block-path"
    assert BlockStream((D, y), block_rows=200).sparse_route is None


def test_sparse_blocks_view():
    A = _csr(seed=11, n=90, d=12)
    A = A.tocoo().tocsr()       # scipy's conversion sums the duplicates
    v = SparseBlocks([A[:10], A[10:50].tocoo(), A[50:]])
    assert v.shape == A.shape and v.nnz == A.nnz
    np.testing.assert_array_equal(v.slice_dense(5, 70), A[5:70].toarray())
    np.testing.assert_array_equal(as_row_indexable(v).toarray(), A.toarray())
    np.testing.assert_array_equal(as_row_indexable(A.tocsc())[[3, 1]]
                                  .toarray(), A.toarray()[[3, 1]])
    with pytest.raises(ValueError, match="widths"):
        SparseBlocks([A, A[:, :5]])


def test_sparse_modules_load_no_jax_sklearn():
    """The port's sparse modules and a tiny sparse fit, in a fresh
    interpreter, leave jax, dask_ml_tpu and sklearn out of sys.modules."""
    code = f"""
import sys
sys.path.insert(0, {ROOT!r})
import numpy as np, scipy.sparse as sp
from dask_ml_tpu_torch import config, feature_extraction
from dask_ml_tpu_torch.parallel import sparse_stream
from dask_ml_tpu_torch.ops import sparse_kernels
from dask_ml_tpu_torch.linear_model import LogisticRegression
X = feature_extraction.HashingVectorizer(n_features=64).transform(
    ["a sparse fit", "of hashed text", "on the cpu", "sparse text"] * 5)
y = np.arange(20) % 2
with config.set(device="cpu"):
    LogisticRegression(solver="lbfgs", max_iter=3).fit(X, y).predict(X)
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "dask_ml_tpu", "sklearn")))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout
