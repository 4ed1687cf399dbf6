#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dask_ml_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each raising on failure (nothing is caught):

1. device: the card's name and power limit; TF32 off;
2. build: every kernel of the port from ``dask_ml_tpu_torch/csrc`` with
   nvcc for sm_90a, timed, with what ``-Xptxas -v`` reports;
3. kernels against their plain PyTorch versions at the main path's
   shapes (GLM 4M x 257 in f32 and bf16, normal and poisson at 1M rows;
   Lloyd 8M x 128 with k = 64), and at wider shapes off the main path
   (GLM d = 4097 and 10000; Lloyd k = 256, and d = 768): the largest
   deviation against its stated tolerance, two runs bit-equal, kernel
   and plain times from CUDA events and the bound of the work on an
   H100;
4. the GLM main path, bench.py's protocol: LogisticRegression(lbfgs,
   max_iter=50, tol=0) on 4M x 256, timed over several fits (median,
   least and most), with the device's busy time in one fit from
   torch.profiler, against the plain loss's fit;
5. the KMeans main path: KMeans(k=64, init=X[:64], max_iter=10, tol=0)
   on 8M x 128, timed and profiled the same way, against the plain
   loop, then the same fit on 64 blobs of
   that shape held to the plain loop center by center, plus one k-means||
   fit on 1M of the blob rows.

The launch counts are set to 0 just before each main path and read just
after it. The line before the last is a JSON object with one entry per
kernel; the last line is ``{"ok": true, "device": {...}}``. Without a
CUDA device, or without the package beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

GLM_N, GLM_D = 4_000_000, 256
KM_N, KM_D, KM_K = 8_000_000, 128, 64
FITS = 5                          # timed fits of each main path
# off the main path: (rows, d) of the GLM kernel (a row's share in
# registers, then rows streamed by column); (rows, d, k) of Lloyd
GLM_WIDE = [(500_000, 4097), (200_000, 10_000)]
LLOYD_WIDE = [(1_000_000, 128, 256), (1_000_000, 768, 64)]

# tolerances of kernel against plain version (see check_glm/check_lloyd)
GLM_LOSS_RTOL = 1e-5
GLM_GRAD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
LLOYD_INERTIA_RTOL = 1e-4
# min-d2 to this share of the row's ||x||^2 + ||c||^2, the terms the f32
# expansion cancels (about 256 on the main path's rows: 1e-3 there)
LLOYD_MIND_RTOL = 4e-6
LLOYD_SUMS_RTOL = 1e-5


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps, warmup=3):
    """Mean time of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, flops, dtype):
    """(least time in ms, what bounds it) on an H100 for the work."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_busy_ms(fn):
    """(wall ms, device-busy ms or None, top spans) of one call of
    ``fn``: the sum of the kernel, copy and fill spans torch.profiler saw
    on the card (None when it saw none), and the five names that took
    most of it with their ms."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    by_name = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            name = e.get("name", "?")[:60]
            by_name[name] = by_name.get(name, 0.0) + e.get("dur", 0) / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return wall, (busy if busy else None), top


def busy_line(what, wall, busy, top):
    if busy is None:
        return f"{what}: torch.profiler saw no device activity"
    spans = "; ".join(f"{name} {ms:.1f} ms" for name, ms in top)
    return (f"{what}: the device was busy {busy:.1f} ms of {wall:.1f} ms "
            f"({busy / wall:.1%}, torch.profiler); most: {spans}")


def check_glm(kernel_out, plain_out, dtype):
    """Kernel against plain version: the loss to GLM_LOSS_RTOL (both sum
    the same f32 terms in another order), the gradient to GLM_GRAD_RTOL
    of its largest entry (bf16: the residual rounds to 8 bits, and an
    f32-ulp difference can round a row's residual apart). Returns the
    largest absolute deviation."""
    (v, g), (v0, g0) = kernel_out, plain_out
    dv = abs(float(v) - float(v0))
    dg = float((g - g0).abs().max())
    scale = float(g0.abs().max())
    if not (dv <= GLM_LOSS_RTOL * abs(float(v0))
            and dg <= GLM_GRAD_RTOL[dtype] * scale):
        raise AssertionError(
            f"GLM kernel disagrees with its plain version: |dloss| {dv} "
            f"(loss {float(v0)}), |dgrad| {dg} (max |grad| {scale})")
    return max(dv, dg)


def check_lloyd(x, centers, labels, mind, sums, counts, inertia, plain):
    """Kernel against plain version. Labels equal except on f32
    near-ties: where they differ, the two centers' distances (in f64)
    are within 1e-5 relative of each other. Counts differ by at most
    the number of such rows; sums equal the f64 sums of the rows by the
    kernel's own labels to LLOYD_SUMS_RTOL of their scale; min-d2 to
    LLOYD_MIND_RTOL of the row's ||x||^2 + ||c||^2; inertia to
    LLOYD_INERTIA_RTOL. Returns the largest absolute deviation of
    min-d2 and sums."""
    lab_p, mind_p, _, counts_p, inertia_p = plain
    lab_k = labels.long()
    diff = torch.nonzero(lab_k != lab_p.long()).flatten()
    if diff.numel():
        xd = x[diff].double()
        cd = centers.double()
        d_k = ((xd - cd[lab_k[diff]]) ** 2).sum(1)
        d_p = ((xd - cd[lab_p[diff].long()]) ** 2).sum(1)
        gap = ((d_k - d_p).abs() / d_p.clamp_min(1e-30)).max()
        if float(gap) > 1e-5:
            raise AssertionError(f"labels differ off near-ties: rel gap "
                                 f"{float(gap)} on {diff.numel()} rows")
    dcount = int((counts.long() - counts_p.long()).abs().sum())
    if dcount > 2 * diff.numel():
        raise AssertionError(f"counts differ by {dcount} with "
                             f"{diff.numel()} label mismatches")
    ref_sums = torch.zeros(sums.shape, dtype=torch.float64,
                           device=x.device).index_add_(0, lab_k, x.double())
    scale = torch.zeros(sums.shape[0], dtype=torch.float64,
                        device=x.device).index_add_(
        0, lab_k, x.double().abs().sum(1))[:, None]
    d_sums = float((sums.double() - ref_sums).abs().max())
    rel_sums = float(((sums.double() - ref_sums).abs()
                      / scale.clamp_min(1.0)).max())
    d_mind = float((mind - mind_p).abs().max())
    terms = (x * x).sum(1) + (centers * centers).sum(1)[lab_k]
    rel_mind = float(((mind - mind_p).abs() / terms.clamp_min(1e-30)).max())
    d_in = abs(float(inertia) - float(inertia_p))
    if rel_sums > LLOYD_SUMS_RTOL or rel_mind > LLOYD_MIND_RTOL or \
            d_in > LLOYD_INERTIA_RTOL * abs(float(inertia_p)):
        raise AssertionError(
            f"Lloyd kernel disagrees: sums rel {rel_sums}, |dmind| "
            f"{d_mind} (rel {rel_mind}), |dinertia| {d_in} (inertia "
            f"{float(inertia_p)})")
    if int(counts.sum()) != x.shape[0]:
        raise AssertionError("counts do not add up to the rows")
    return max(d_mind, d_sums), diff.numel()


def same_bits(a, b):
    return all(torch.equal(p, q) for p, q in zip(a, b))


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {name} x{torch.cuda.device_count()}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    log(smi)
    return name


def phase_build():
    from dask_ml_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build()
    log(f"build: {len(libs)} libraries in "
        f"{time.perf_counter() - t0:.2f} s ({_build.nvcc_path()})")
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "ptxas info" in line and ("Used" in line or "Compiling" in
                                         line or "spill" in line):
                log(f"  {name}: {line.strip()}")


def phase_glm_kernel(gen, results):
    from dask_ml_tpu_torch.ops import fused

    dev = torch.device("cuda")
    cases = [("logistic", torch.float32, GLM_N),
             ("logistic", torch.bfloat16, GLM_N),
             ("normal", torch.float32, GLM_N // 4),
             ("poisson", torch.float32, GLM_N // 4)]
    x32 = torch.randn((GLM_N, GLM_D + 1), generator=gen, device=dev)
    x32[:, -1] = 1.0
    beta = torch.randn(GLM_D + 1, generator=gen, device=dev) / 16.0
    ys = {
        "logistic": (torch.rand(GLM_N, generator=gen, device=dev)
                     < 0.5).float(),
        "normal": torch.randn(GLM_N, generator=gen, device=dev),
        "poisson": torch.poisson(torch.ones(GLM_N, device=dev),
                                 generator=gen),
    }
    for family, dtype, n in cases:
        x = x32[:n] if dtype == torch.float32 else x32.to(dtype)
        y = ys[family][:n].contiguous()
        n_valid = n - 37          # a ragged tail the kernel must mask
        args = (x, n_valid, y, beta, family)
        k1 = fused.fused_glm_value_grad(*args)
        k2 = fused.fused_glm_value_grad(*args)
        torch.cuda.synchronize()
        if not same_bits(k1, k2):
            raise AssertionError(f"GLM kernel {family} {dtype}: two runs "
                                 "differ")
        plain = fused.glm_value_grad_plain(*args)
        err = check_glm(k1, plain, dtype)
        ms = time_ms(lambda: fused.fused_glm_value_grad(*args), 20)
        plain_ms = time_ms(lambda: fused.glm_value_grad_plain(*args), 5, 1)
        d = x.shape[1]
        nbytes = n_valid * (d * x.element_size() + 4) + d * 4 + (d + 1) * 4
        flops = 4.0 * n_valid * d + 12.0 * n_valid
        b_ms, b_by = bound(nbytes, flops, dtype)
        log(f"glm kernel {family:8s} {str(dtype):14s} {n}x{d}: max|err| "
            f"{err:.3e}, bit-equal reruns, kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}), "
            f"{b_ms / ms:.1%} of bound; library: none (no single torch "
            "call computes the NLL sum and its gradient)")
        if family == "logistic" and dtype == torch.float32:
            results["fused_glm_value_grad"].update(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)
        del x, plain, k1, k2
    del x32, ys
    torch.cuda.empty_cache()

    for (n, d), dtype in itertools.product(GLM_WIDE, (torch.float32,
                                                      torch.bfloat16)):
        x = torch.randn((n, d), generator=gen, device=dev)
        y = (torch.rand(n, generator=gen, device=dev) < 0.5).float()
        beta = torch.randn(d, generator=gen, device=dev) / d ** 0.5
        xd = x.to(dtype)
        args = (xd, n - 3, y, beta, "logistic")
        k1 = fused.fused_glm_value_grad(*args)
        k2 = fused.fused_glm_value_grad(*args)
        torch.cuda.synchronize()
        if not same_bits(k1, k2):
            raise AssertionError(f"GLM kernel d={d} {dtype}: two runs "
                                 "differ")
        err = check_glm(k1, fused.glm_value_grad_plain(*args), dtype)
        ms = time_ms(lambda: fused.fused_glm_value_grad(*args), 10)
        plain_ms = time_ms(lambda: fused.glm_value_grad_plain(*args), 3, 1)
        b_ms, b_by = bound(n * (d * xd.element_size() + 4),
                           4.0 * n * d, dtype)
        log(f"glm kernel (off the main path) logistic {str(dtype):14s} "
            f"{n}x{d}: max|err| {err:.3e}, bit-equal reruns, kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms "
            f"({b_by}), {b_ms / ms:.1%} of bound")
        del x, xd, k1, k2
    torch.cuda.empty_cache()


def phase_lloyd_kernels(gen, results):
    from dask_ml_tpu_torch.ops import fused

    dev = torch.device("cuda")
    x = torch.randn((KM_N, KM_D), generator=gen, device=dev)
    c = x[torch.randperm(KM_N, generator=gen, device=dev)[:KM_K]].clone()
    ones = torch.ones(KM_N, device=dev)
    n, d, k = KM_N, KM_D, KM_K

    s1 = fused.fused_lloyd_stats(x, n, c)
    s2 = fused.fused_lloyd_stats(x, n, c)
    a1 = fused.fused_assign_update(x, ones, c)
    a2 = fused.fused_assign_update(x, ones, c)
    torch.cuda.synchronize()
    if not (same_bits(s1, s2) and same_bits(a1, a2)):
        raise AssertionError("Lloyd kernels: two runs differ")
    if not same_bits(s1, a1[2:]):
        raise AssertionError("fused_lloyd_stats and fused_assign_update "
                             "disagree on the same rows")
    plain = fused.assign_update_plain(x, ones, c)
    err, n_ties = check_lloyd(x, c, *a1, plain)
    log(f"lloyd kernels {n}x{d} k={k}: max|err| {err:.3e}, {n_ties} "
        "near-tie label flips, bit-equal reruns, stats == assign stats")

    flops = 2.0 * n * k * d + 2.0 * n * d + 3.0 * n * k + n * d
    io = d * k * 4 + (k * d + k + 1) * 4
    for name, fn, pfn, nbytes in [
        ("fused_lloyd_stats",
         lambda: fused.fused_lloyd_stats(x, n, c),
         lambda: fused.lloyd_stats_plain(x, n, c), n * d * 4 + io),
        ("fused_assign_update",
         lambda: fused.fused_assign_update(x, ones, c),
         lambda: fused.assign_update_plain(x, ones, c),
         n * d * 4 + n * 4 + io + n * 8),
    ]:
        ms = time_ms(fn, 10)
        plain_ms = time_ms(pfn, 3, 1)
        b_ms, b_by = bound(nbytes, flops, torch.float32)
        log(f"{name} {n}x{d} k={k}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}), "
            f"{b_ms / ms:.1%} of bound; library: none (no single torch "
            "call computes assignment and per-cluster sums)")
        results[name].update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=None)
    del x, plain, s1, s2, a1, a2
    torch.cuda.empty_cache()

    for n, d, k in LLOYD_WIDE:
        x = torch.randn((n, d), generator=gen, device=dev)
        c = x[torch.randperm(n, generator=gen, device=dev)[:k]].clone()
        ones = torch.ones(n, device=dev)
        a1 = fused.fused_assign_update(x, ones, c)
        a2 = fused.fused_assign_update(x, ones, c)
        s1 = fused.fused_lloyd_stats(x, n, c)
        torch.cuda.synchronize()
        if not (same_bits(a1, a2) and same_bits(s1, a1[2:])):
            raise AssertionError(f"Lloyd kernels {n}x{d} k={k}: two runs "
                                 "differ")
        err, n_ties = check_lloyd(x, c, *a1,
                                  fused.assign_update_plain(x, ones, c))
        ms = time_ms(lambda: fused.fused_lloyd_stats(x, n, c), 10)
        plain_ms = time_ms(lambda: fused.lloyd_stats_plain(x, n, c), 3, 1)
        b_ms, b_by = bound(n * d * 4, 2.0 * n * k * d, torch.float32)
        log(f"lloyd kernels (off the main path) {n}x{d} k={k} "
            f"{fused.lloyd_geometry(d, k)}: max|err| {err:.3e}, {n_ties} "
            f"near-tie label flips, bit-equal reruns; fused_lloyd_stats "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms "
            f"({b_by}), {b_ms / ms:.1%} of bound")
        del x, a1, a2, s1
    torch.cuda.empty_cache()


def phase_glm_fit(gen, results):
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.ops import fused

    dev = torch.device("cuda")
    X = torch.randn((GLM_N, GLM_D), generator=gen, device=dev)
    beta_true = torch.randn(GLM_D, generator=gen, device=dev) / GLM_D ** 0.5
    y = (torch.rand(GLM_N, generator=gen, device=dev)
         < torch.sigmoid(X @ beta_true)).float()
    LogisticRegression(solver="lbfgs", max_iter=1, tol=0.0).fit(X, y)
    torch.cuda.synchronize()

    fused.reset_launches()
    clf = LogisticRegression(solver="lbfgs", max_iter=50, tol=0.0).fit(X, y)
    torch.cuda.synchronize()
    launches = fused.launches()
    results["fused_glm_value_grad"]["launches"] = \
        launches["fused_glm_value_grad"]
    if launches["fused_glm_value_grad"] < clf.n_iter_ or clf.n_iter_ < 1:
        raise AssertionError(f"GLM fit ran {clf.n_iter_} iterations with "
                             f"{launches} kernel launches")
    times = []
    for _ in range(FITS):
        t0 = time.perf_counter()
        LogisticRegression(solver="lbfgs", max_iter=50, tol=0.0).fit(X, y)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    acc = clf.score(X, y)
    # the labels are Bernoulli draws, so no classifier beats the rule of
    # the model that drew them (about 0.67 here): that rule is the yardstick
    oracle_acc = float(((X @ beta_true > 0).float() == y).float().mean())
    log(f"glm fit {GLM_N}x{GLM_D} lbfgs: {clf.n_iter_} iterations; over "
        f"{FITS} fits median {med:.4f} s (least {min(times):.4f}, most "
        f"{max(times):.4f}), {GLM_N * clf.n_iter_ / med:.4g} samples/s at "
        f"the median; kernel launches {launches['fused_glm_value_grad']}, "
        f"training accuracy {acc:.4f} (the generating model's: "
        f"{oracle_acc:.4f})")
    log(busy_line("glm fit", *device_busy_ms(
        lambda: LogisticRegression(solver="lbfgs", max_iter=50,
                                   tol=0.0).fit(X, y))))

    t0 = time.perf_counter()
    ref = LogisticRegression(solver="lbfgs", max_iter=50, tol=0.0,
                             solver_kwargs={"use_kernel": False}).fit(X, y)
    torch.cuda.synchronize()
    elapsed_ref = time.perf_counter() - t0
    d_coef = float(np.abs(clf.coef_ - ref.coef_).max())
    d_b = float(np.abs(clf.intercept_ - ref.intercept_).max())
    log(f"glm plain-loss fit: {ref.n_iter_} iterations in {elapsed_ref:.3f}"
        f" s; max|dcoef| {d_coef:.3e}, |dintercept| {d_b:.3e}")
    # 5e-4: the fused-loss parity tolerance of tests/test_pallas_glm.py;
    # with 4M rows for 257 parameters the fit's accuracy is within 0.005
    # of the generating model's
    if not (np.isfinite(clf.coef_).all() and d_coef <= 5e-4
            and d_b <= 5e-4 and acc >= oracle_acc - 0.005):
        raise AssertionError("GLM fit disagrees with the plain-loss fit")
    del X, y
    torch.cuda.empty_cache()


def phase_kmeans_fit(gen, results):
    from dask_ml_tpu_torch.cluster import KMeans
    from dask_ml_tpu_torch.ops import fused

    dev = torch.device("cuda")
    X = torch.randn((KM_N, KM_D), generator=gen, device=dev)
    init = X[:KM_K].cpu().numpy()
    KMeans(n_clusters=KM_K, init=init, max_iter=2, tol=0.0).fit(X)
    torch.cuda.synchronize()

    fused.reset_launches()
    km = KMeans(n_clusters=KM_K, init=init, max_iter=10, tol=0.0).fit(X)
    torch.cuda.synchronize()
    launches = fused.launches()
    results["fused_lloyd_stats"]["launches"] = launches["fused_lloyd_stats"]
    results["fused_assign_update"]["launches"] = \
        launches["fused_assign_update"]
    if launches["fused_lloyd_stats"] != km.n_iter_ or \
            launches["fused_assign_update"] != 1:
        raise AssertionError(f"KMeans ran {km.n_iter_} iterations with "
                             f"{launches}")
    times = []
    for _ in range(FITS):
        t0 = time.perf_counter()
        KMeans(n_clusters=KM_K, init=init, max_iter=10, tol=0.0).fit(X)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    log(f"kmeans fit {KM_N}x{KM_D} k={KM_K}: {km.n_iter_} iterations; over "
        f"{FITS} fits median {med:.4f} s (least {min(times):.4f}, most "
        f"{max(times):.4f}), {km.n_iter_ / med:.4g} iterations/s at the "
        f"median; launches {launches}")
    log(busy_line("kmeans fit", *device_busy_ms(
        lambda: KMeans(n_clusters=KM_K, init=init, max_iter=10,
                       tol=0.0).fit(X))))

    t0 = time.perf_counter()
    ref = KMeans(n_clusters=KM_K, init=init, max_iter=10, tol=0.0,
                 use_kernel=False).fit(X)
    torch.cuda.synchronize()
    elapsed_ref = time.perf_counter() - t0
    d_c, agree, d_in = _kmeans_gaps(km, ref)
    log(f"kmeans plain-loop fit: {ref.n_iter_} iterations in "
        f"{elapsed_ref:.3f} s; max|dcenter| {d_c:.3e}, label agreement "
        f"{agree:.7f}, inertia rel diff {d_in:.3e}")
    # Gaussian rows have no cluster structure: f32 near-ties flip a few
    # labels in the first pass (phase 3), and ten passes spread the flips,
    # so centers and labels are held to the plain loop on blobs below;
    # here the inertia (rel 1e-4, tests/test_kmeans.py:82-85) and n_iter_
    if not (d_in <= 1e-4 and ref.n_iter_ == km.n_iter_):
        raise AssertionError("KMeans fit disagrees with the plain loop")
    del X, km, ref
    torch.cuda.empty_cache()

    # 64 blobs at the same shape, row i in blob i % 64, so X[:64] seeds one
    # center per blob: centers 1e-3, inertia rel 1e-4 and equal labels and
    # n_iter_, the rule of tests/test_kmeans.py:82-88
    blob_centers = 8.0 * torch.randn((KM_K, KM_D), generator=gen, device=dev)
    X = blob_centers[torch.arange(KM_N, device=dev) % KM_K]
    X += torch.randn((KM_N, KM_D), generator=gen, device=dev)
    init = X[:KM_K].cpu().numpy()
    km = KMeans(n_clusters=KM_K, init=init, max_iter=10, tol=0.0).fit(X)
    ref = KMeans(n_clusters=KM_K, init=init, max_iter=10, tol=0.0,
                 use_kernel=False).fit(X)
    d_c, agree, d_in = _kmeans_gaps(km, ref)
    log(f"kmeans blobs fit {KM_N}x{KM_D} k={KM_K}: kernel against plain "
        f"loop max|dcenter| {d_c:.3e}, label agreement {agree:.7f}, inertia "
        f"rel diff {d_in:.3e}, n_iter {km.n_iter_} and {ref.n_iter_}")
    if not (d_c <= 1e-3 and d_in <= 1e-4 and agree == 1.0
            and ref.n_iter_ == km.n_iter_):
        raise AssertionError("KMeans blobs fit disagrees with the plain loop")

    # k-means|| on 1M blob rows must find every blob: a blob left out
    # would add about 128 * 128 per row of it to the inertia, against
    # about 128 per row inside a blob
    sub = X[:1_000_000]
    t0 = time.perf_counter()
    kp = KMeans(n_clusters=KM_K, init="k-means||", random_state=0,
                max_iter=10, tol=0.0).fit(sub)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    seeded = KMeans(n_clusters=KM_K, init=init, max_iter=10,
                    tol=0.0).fit(sub)
    log(f"kmeans k-means|| fit 1000000x{KM_D}: {kp.n_iter_} iterations "
        f"in {elapsed:.3f} s, inertia {kp.inertia_:.6g} (one seed per "
        f"blob: {seeded.inertia_:.6g})")
    if not (np.isfinite(kp.cluster_centers_).all()
            and kp.inertia_ <= 1.01 * seeded.inertia_):
        raise AssertionError("k-means|| missed blobs")
    del X, sub
    torch.cuda.empty_cache()


def _kmeans_gaps(km, ref):
    """(max |center gap|, share of equal labels, inertia rel gap)."""
    d_c = float(np.abs(km.cluster_centers_ - ref.cluster_centers_).max())
    agree = float((km.labels_.data.long() == ref.labels_.data.long())
                  .float().mean())
    return d_c, agree, abs(km.inertia_ - ref.inertia_) / ref.inertia_


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from dask_ml_tpu_torch.ops import fused

    name = phase_device()
    phase_build()
    results = {
        k: {"name": k, "route": "cuda", "source": src, "replaces": rep}
        for k, (_, src, rep) in fused.KERNELS.items()
    }
    gen = torch.Generator(device="cuda").manual_seed(0)
    phase_glm_kernel(gen, results)
    phase_lloyd_kernels(gen, results)
    phase_glm_fit(gen, results)
    phase_kmeans_fit(gen, results)
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
