"""Tall-skinny QR and randomized SVD on one device.

Counterpart of ``dask_ml_tpu/ops/linalg.py``, the backbone of PCA and
TruncatedSVD. The JAX package runs TSQR across the shards of its mesh
(a QR per shard, an all-gather of the R factors, one QR of the stack);
on one card that is one QR. The products are ``torch.matmul`` (TF32
off, as everywhere in the port) and the factorizations
``torch.linalg``: the JAX package computes them in XLA, outside any
Pallas kernel, so no kernel of the port sits behind this module.

Inputs may carry padding rows that are exactly zero (callers zero them,
for example after centering): zero rows leave R and the spanned range
unchanged, and their rows of Q are zero, so no mask is needed here.

The random test matrix Ω of ``randomized_range_finder`` is drawn from a
``torch.Generator`` seeded by ``random_state``, not from JAX's PRNG, so
the two packages draw different Ω from one seed; the private ``omega=``
argument takes a given Ω instead, which lets the tests hold the range
finder to JAX's step for step.
"""

from __future__ import annotations

import torch


def tsqr(x: torch.Tensor, mode: str = "reduced"):
    """QR of a tall-skinny (n, d) ``x``: (Q (n, r), R (r, d)) with
    r = min(n, d); ``mode="r"`` computes R alone and returns (None, R)."""
    if mode == "r":
        return None, torch.linalg.qr(x, mode="r")[1]
    return torch.linalg.qr(x)


def svd_tall(x: torch.Tensor, compute_u: bool = True):
    """Exact SVD of a tall-skinny (n, d) ``x`` through its QR: the SVD of
    R gives s and Vt, and U = Q U_r. Returns (U (n, r) or None when
    ``compute_u`` is False, s (r,), Vt (r, d))."""
    q, r = tsqr(x, mode="reduced" if compute_u else "r")
    u_r, s, vt = torch.linalg.svd(r, full_matrices=False)
    return (q @ u_r if compute_u else None), s, vt


def draw_omega(d: int, size: int, random_state, device, dtype=torch.float32):
    """The (d, size) standard normal test matrix of the range finder,
    from a ``torch.Generator`` on ``device`` seeded by ``random_state``
    (None draws from seed 0, as the JAX estimators do)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0 if random_state is None else int(random_state))
    return torch.randn((d, size), generator=gen, device=device, dtype=dtype)


def randomized_range_finder(x, size, n_iter, random_state=None, omega=None):
    """Orthonormal Q (n, size) that approximately spans range(x): Halko
    et al. 2011 with ``n_iter`` power iterations and a QR after each
    half-iteration, as ``da.linalg.svd_compressed`` does."""
    if omega is None:
        omega = draw_omega(x.shape[1], size, random_state, x.device,
                           x.dtype)
    q, _ = tsqr(x @ omega.to(device=x.device, dtype=x.dtype))
    for _ in range(n_iter):
        qz, _ = torch.linalg.qr(x.T @ q)
        q, _ = tsqr(x @ qz)
    return q


def randomized_svd(x, n_components, random_state=None, n_oversamples=10,
                   n_iter=4, omega=None):
    """Halko randomized SVD of (n, d) ``x``: (U (n, k), s (k,), Vt (k, d))
    with k = ``n_components``, from a range of ``n_components +
    n_oversamples`` columns (at most min(n, d))."""
    size = min(n_components + n_oversamples, min(x.shape))
    q = randomized_range_finder(x, size, n_iter, random_state, omega)
    u_b, s, vt = torch.linalg.svd(q.T @ x, full_matrices=False)
    u = q @ u_b
    k = n_components
    return u[:, :k], s[:k], vt[:k]


def svd_flip(u, vt):
    """Deterministic SVD signs, V-based (sklearn's
    ``svd_flip(u_based_decision=False)``): each row of Vt gets its
    largest-|.| entry positive, and the columns of U (None passes
    through) follow."""
    max_abs = torch.argmax(vt.abs(), dim=1)
    signs = torch.sign(vt[torch.arange(vt.shape[0], device=vt.device),
                          max_abs])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return (None if u is None else u * signs[None, :]), vt * signs[:, None]
