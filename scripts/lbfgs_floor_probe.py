#!/usr/bin/env python3
"""Where the streamed lbfgs fit meets float32's noise floor, in one
process and as two ranks, on one card.

    python3 scripts/lbfgs_floor_probe.py [ROOT]

Imports ``dask_ml_tpu_torch`` from the checkout at ROOT (default: this
one), draws chip_smoke.py's phase 28 GLM data (2 x 1M x 256 from seed
28, on the card) into a memmap in a temporary directory, and fits the
streamed LogisticRegression (lbfgs, tol=0, 10 iterations) on it at three
block sizes: in one process, and as two virtual ranks
(``distributed.run_virtual_processes``: each rank streams its half, and
the ranks' pass sums merge by ``psum_host``). Each line gives the card,
the fit, its passes and wall, each iteration's |g| at its start and
Armijo trials, and the error of every loss value the line search saw
against the same loss in float64 at the same (float32) coefficients, in
float32 ulps of the loss: mean, spread and range. The block size changes
only the order of the float32 sums: where the trial counts part between
block sizes, the line search is deciding on rounding. About two
minutes.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

N, D, WORLD = 1_000_000, 256, 2
BLOCKS = (125_000, 250_000, 500_000)
ITER = 10


def main():
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
    sys.path.insert(0, root)
    from dask_ml_tpu_torch import config
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.models.solvers import streamed
    from dask_ml_tpu_torch.parallel import distributed as dist

    # every (coefficients, loss) a fit's passes evaluate, by thread
    seen = {}
    value_and_grad = streamed.StreamedObjective.value_and_grad

    def recorded(self, beta):
        val, grad = value_and_grad(self, beta)
        seen.setdefault(threading.current_thread().name, []).append(
            (np.asarray(beta, np.float32), val))
        return val, grad

    streamed.StreamedObjective.value_and_grad = recorded

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}; root {root}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(28)
    X = torch.randn(WORLD * N, D, generator=gen, device="cuda")
    w = torch.randn(D, generator=gen, device="cuda") / D ** 0.5
    y = (torch.sigmoid(X @ w) > torch.rand(WORLD * N, generator=gen,
                                           device="cuda")).float()
    X64 = X.double()
    y64 = y.double()
    lam = 1.0 / (WORLD * N)     # C = 1, sklearn's 1 / (C n)

    def loss64(beta):
        b = torch.as_tensor(beta, device="cuda").double()
        eta = X64 @ b[:-1] + b[-1]
        nll = (torch.nn.functional.softplus(eta) - y64 * eta).mean()
        return float(nll + 0.5 * lam * torch.sum(b[:-1] ** 2))

    y = y.cpu().numpy()

    def fit(X_, y_):
        return LogisticRegression(solver="lbfgs", max_iter=ITER,
                                  tol=0.0).fit(X_, y_)

    def report(tag, est, wall, thread):
        info = est.solver_info_
        evals = seen.pop(thread)
        ulp = float(np.spacing(np.float32(evals[-1][1])))
        err = np.array([(v - loss64(b)) / ulp for b, v in evals])
        print(f"{tag}: {info['data_passes']} passes in {wall:.3f} s; |g| "
              + " ".join(f"{g:.2e}" for g in info["grad_norms"])
              + "; trials " + " ".join(map(str, info["armijo_trials"]))
              + f"; loss error in ulps ({ulp:.2e}) mean {err.mean():.2f} "
              f"std {err.std():.2f} range {err.min():.2f} to "
              f"{err.max():.2f}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "glm.f32")
        mm = np.memmap(path, np.float32, "w+", shape=(WORLD * N, D))
        step = 250_000
        for lo in range(0, WORLD * N, step):
            mm[lo:lo + step] = X[lo:lo + step].cpu().numpy()
        mm.flush()
        del mm, X
        full = np.memmap(path, np.float32, "r", shape=(WORLD * N, D))
        halves = [np.memmap(path, np.float32, "r", offset=r * N * D * 4,
                            shape=(N, D)) for r in range(WORLD)]
        with config.set(device="cuda", stream_block_rows=BLOCKS[0]):
            fit(halves[0][:BLOCKS[0]], y[:BLOCKS[0]])   # builds the kernels
        seen.clear()
        for rows in BLOCKS:
            with config.set(device="cuda", stream_block_rows=rows):
                t0 = time.perf_counter()
                est = fit(full, y)
                torch.cuda.synchronize()
                report(f"one process, blocks of {rows}", est,
                       time.perf_counter() - t0, "MainThread")
                t0 = time.perf_counter()
                got = dist.run_virtual_processes(
                    lambda r: fit(halves[r], y[r * N:(r + 1) * N]), WORLD,
                    timeout=600)
                torch.cuda.synchronize()
                report(f"two virtual ranks, blocks of {rows}", got[0],
                       time.perf_counter() - t0, "virtual-rank-0")
                seen.clear()
                gap = float(np.abs(got[0].coef_ - est.coef_).max())
                print(f"  max|dcoef| two ranks against one process "
                      f"{gap:.3e}", flush=True)


if __name__ == "__main__":
    main()
