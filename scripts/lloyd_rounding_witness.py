"""Single-process Lloyd on one card, kernel 2 against its plain version,
on the rows where phase 29's feature-sharded KMeans first missed its
gate: the Gaussian rows of phase 29's GLM (no cluster structure), and
blobs drawn as phase 29 draws its own, for comparison. Both fits
start from the same centers and run the same iterations; the script
prints the centers' largest gap, the inertia's relative gap and the
share of rows whose labels differ, each beside the card's name and
power limit.

    python3 scripts/lloyd_rounding_witness.py

A gap of the same size as the tiled fit's (centers 1.2e-2) between two
single-process paths shows that the Gaussian rows' labels follow the
rounding of near-equidistant rows, whichever path computes them.
"""

import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _fit(X, init, it, use_kernel):
    from dask_ml_tpu_torch.cluster import KMeans

    est = KMeans(init.shape[0], init=init, max_iter=it, tol=0.0,
                 use_kernel=use_kernel).fit(X)
    return est, est.predict(X).to_numpy()


def main():
    from dask_ml_tpu_torch import config
    from dask_ml_tpu_torch.parallel.sharded import ShardedArray

    chip_smoke.phase_device()
    chip_smoke.phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    n_km, k, it = chip_smoke.FS_KM
    n, d = chip_smoke.FS_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(29)
    # phase 29's first draw: the GLM's rows (its first n_km of them)
    gauss = torch.randn(n, d, generator=gen, device="cuda")[:n_km].clone()
    torch.cuda.empty_cache()
    pick = torch.randperm(n_km, generator=torch.Generator().manual_seed(0))
    cases = {"gaussian": (gauss, gauss[pick[:k].cuda()].cpu().numpy())}
    C = torch.randn(k, d, generator=gen, device="cuda") * 4.0
    lab = torch.randint(0, k, (n_km,), generator=gen, device="cuda")
    blobs = C[lab] + torch.randn(n_km, d, generator=gen, device="cuda")
    init = C + 0.5 * torch.randn(k, d, generator=gen, device="cuda")
    cases["blobs"] = (blobs, init.cpu().numpy())
    with config.set(device="cuda"):
        for name, (rows, init) in cases.items():
            X = ShardedArray.from_array(rows)
            t0 = time.perf_counter()
            kern, lk = _fit(X, init, it, None)
            plain, lp = _fit(X, init, it, False)
            centers = float(np.abs(kern.cluster_centers_
                                   - plain.cluster_centers_).max())
            inertia = abs(kern.inertia_ - plain.inertia_) / plain.inertia_
            chip_smoke.log(
                f"lloyd witness {name} {n_km:,} x {d}, k = {k}, {it} "
                f"iterations: kernel 2 against the plain Lloyd: centers "
                f"{centers:.3e}, inertia {inertia:.3e}, labels differ on "
                f"{float((lk != lp).mean()):.4%} of rows, n_iter "
                f"{kern.n_iter_} / {plain.n_iter_} "
                f"({time.perf_counter() - t0:.1f} s); {chip_smoke.SMI}")


if __name__ == "__main__":
    main()
