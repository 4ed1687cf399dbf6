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
   H100 (Lloyd's at the 3xTF32 peak, its share of the CUDA-core bound
   beside it);
4. the GLM main path, bench.py's protocol: LogisticRegression(lbfgs,
   max_iter=50, tol=0) on 4M x 256, timed over several fits (median,
   least and most), with the device's busy time in one fit from
   torch.profiler, against the plain loss's fit;
5. the KMeans main path: KMeans(k=64, init=X[:64], max_iter=10, tol=0)
   on 8M x 128, timed and profiled the same way, against the plain
   loop, then the same fit on 64 blobs of
   that shape held to the plain loop center by center, plus one k-means||
   fit on 1M of the blob rows;
6. the Newton kernel (fused_glm_value_grad_hess) against its plain
   version at 4M x 257 logistic and 1M x 257 normal and poisson, and off
   the main path at d = 1000 and 2049, with one cuBLAS (X * w)^T X (TF32
   off) beside it as the library's time for the Hessian; its bound at the
   3xTF32 peak, with its share of the CUDA-core f32 bound beside it;
7. the one-vs-rest kernel (fused_glm_multi_value_grad) against its plain
   version at 4M x 257 with C = 10 in f32 and bf16, and off the main path
   at C = 3, C = 300 and d = 4097, both shares as in phase 6;
8. the Newton path: LogisticRegression(newton, max_iter=10) on the data of
   phase 4, timed, its launches of both GLM kernels, held to phase 4's
   lbfgs fit;
9. the one-vs-rest path: LogisticRegression(lbfgs, max_iter=50, tol=0) on
   4M x 256 with 10 classes drawn from a softmax of X W, timed and
   profiled, against its use_kernel=False fit;
10. the ADMM path: LogisticRegression() (admm, the default; max_iter=20)
   on 1M x 256, timed and profiled, its objective held to the Newton
   optimum;
11. the streamed kernels (fused_glm_stream in its kinds val, vg, vg with
   bf16 operands and vgh, three families; fused_glm_multi_stream with
   C = 10; fused_kmeans_block_stats in f32 and with the bf16 cross term,
   and off the main path at k = 256 and d = 768) against their plain
   versions (vgh and the f32 one-vs-rest kinds with
   both shares of phase 6) at the
   streams' own block shapes (the
   auto block: 262,144 x 256 for the GLMs, 524,288 x 128 for KMeans) and
   on a ragged block whose rows past its count are NaN;
12. the streamed GLM paths from an np.memmap of phase 4's data (4.1 GB
   in a temporary directory): LogisticRegression lbfgs and newton, timed,
   profiled (busy share, and the per-pass split of host copy, device
   copy, waits and kernels from the stream's own counters), their peak
   device memory against (stream_prefetch + 2) blocks, held to phase 8's
   resident Newton fit and to their use_kernel=False twins; the 10-class
   one-vs-rest lbfgs fit held to its twin;
13. the streamed KMeans path from an np.memmap of phase 5's blobs
   (4.1 GB): KMeans(k=64, init=X[:64], max_iter=10, tol=0), timed and
   profiled, held to phase 5's resident fit on the same blobs;
14. the SGD step kernels against their plain versions: fused_sgd_block_grad
   at the Incremental block (250,000 x 128) and phase 4's block (500,000 x
   256) for log_loss, hinge and squared_error in f32 and with bf16
   operands; fused_sgd_many_block_grad with class codes at 500,000 x 256,
   C = 10, and for a cohort of 16 models at 250,000 x 128 (128 off the
   main path, and C = 10 and N = 16 at d = 13 on a row view that starts
   off a 16-byte boundary); each on a ragged block whose tail is NaN and
   on a block of count 0, two runs bit-equal, kernel and plain times and
   the bound;
15. the in-memory SGD paths: bench.py's Incremental(SGDClassifier(
   max_iter=1), shuffle_blocks=False) on a device-resident 2M x 128
   (incremental_sgd_samples_per_sec_per_chip), SGDClassifier(max_iter=5)
   on phase 4's 4M x 256 and on phase 9's ten classes: timed, profiled,
   one launch per block per epoch, each held to its use_kernel=False twin;
16. the batched-trial step: SGDClassifier._batched_fused_calls over 16
   models with their own alpha, eta0 and penalty through one epoch of
   phase 15's 2M x 128 blocks, held to 16 solo partial_fit chains, both
   timed;
17. the streamed SGD path: SGDClassifier(max_iter=3) from phase 12's
   memmap while it is still on disk (streamed_sgd_samples_per_sec_per_chip),
   timed, its per-pass split and peak device memory against
   (stream_prefetch + 2) blocks, held to its use_kernel=False twin;
18. the GLM main path's bf16 flavour, bench.py's _bench_logreg_bf16:
   phase 4's fit with fit_dtype="bfloat16" (bf16 X through kernel 1's
   staged walk), timed over several fits as
   logreg_fit_samples_per_sec_per_chip_bf16, its launches (at least one
   an iteration) and the device's busy share of one profiled fit, its
   coef_ held to its plain-loss twin within BF16_COEF_RTOL of the
   largest coefficient.

Phases 3 and 14 name the walk of csrc/glm_value_grad.cu
(ops/fused.py::glm_value_walk) that each GLM value and SGD step line
took. The phases run in the order 1-3, 6, 7, 11, 14, 4, 18, 8, 10, 9,
15, 16, 12, 17, 5, 13. The launch counts are set to 0 just before each main path
and read just after it. The line before the last is a JSON object with one entry per
kernel; the last line is ``{"ok": true, "device": {...}}``. Without a
CUDA device, or without the package beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet). TF32X3:
# f32-accurate products on the tensor cores by the 3xTF32 split
# (csrc/tf32x3.cuh), three TF32 products at 495 TFLOP/s each, the peak of
# the kernels redesigned on the tensor cores (Newton, one-vs-rest resident
# and streamed, Lloyd) and the bound of the f32 SGD and streamed KMeans
# kernels, whose products could run there too; float32 is the CUDA cores'
# FMA rate, the peak of the other f32 kernels (all bound by bytes)
HBM_BYTES_PER_S = 3.35e12
TF32X3 = "tf32x3"
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12,
              TF32X3: 495e12 / 3}

GLM_N, GLM_D = 4_000_000, 256
KM_N, KM_D, KM_K = 8_000_000, 128, 64
FITS = 5                          # timed fits of each main path
OVR_CLASSES = 10
ADMM_N = 1_000_000
# off the main path: (rows, d) of the GLM kernel (a row's share in
# registers, then rows streamed by column); (rows, d, k) of Lloyd
GLM_WIDE = [(500_000, 4097), (200_000, 10_000)]
LLOYD_WIDE = [(1_000_000, 128, 256), (1_000_000, 768, 64)]
# off the main path: (rows, d) of the Newton kernel (d = 2049 is past the
# Pallas kernel's VMEM gate); (rows, d, C) of the one-vs-rest kernel
VGH_WIDE = [(200_000, 1000), (100_000, 2049)]
MULTI_WIDE = [(1_000_000, 257, 3), (200_000, 257, 300), (200_000, 4097, 10)]
# off the main path: (d, k) of the streamed KMeans kernel at its block
# height (more centers than a chunk of 64; rows wider than a 128-feature
# slice)
KM_BLOCK_WIDE = [(128, 256), (768, 64)]
# off the main path: (d, N, codes, loss, bf16) of the SGD many-rows kernel
# on a block that is a row view starting off a 16-byte boundary
SGD_VIEW = [(13, 10, True, "log_loss", False), (13, 16, False, "hinge",
                                                True)]

# tolerances of kernel against plain version (see check_glm/check_lloyd)
GLM_LOSS_RTOL = 1e-5
GLM_GRAD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
LLOYD_INERTIA_RTOL = 1e-4
# min-d2 to this share of the row's ||x||^2 + ||c||^2, the terms the f32
# expansion cancels (about 256 on the main path's rows: 1e-3 there)
LLOYD_MIND_RTOL = 4e-6
LLOYD_SUMS_RTOL = 1e-5
# the Hessian to this share of its largest entry, against the f64 sums:
# f32 sums of n_valid products (rows in order within a split of about
# 30k rows, the splits in order)
HESS_RTOL = 1e-4
# a fit against its twin on the same data: the parity tolerance of
# tests/test_pallas_glm.py:30, float32 solves of one objective
COEF_ATOL = 5e-4
# the bf16 fit against its twin, relative to the largest coefficient: the
# bf16 tolerance of tests/test_torch_glm.py::test_bf16_design_matches_jax
# (the residual rounds to bf16 at other iterates in another summation
# order)
BF16_COEF_RTOL = 5e-3
# ADMM's objective to this share of the Newton optimum's: ADMM stops on
# residuals of 1e-4, which leave the objective within about 1e-6 of the
# optimum on this data
ADMM_OBJ_RTOL = 1e-5

# the streamed paths: the auto block (256 MB of f32 X) at the main widths,
# a ragged block's valid rows, timed fits and iteration budgets (the
# streamed solvers pay one pass of the 4.1 GB memmap per evaluation)
STREAM_GLM_ROWS = 262_144
STREAM_KM_ROWS = 524_288
STREAM_RAGGED = 100_003
STREAM_FITS = 3
STREAM_LBFGS_ITER = 10
STREAM_NEWTON_ITER = 10
STREAM_DEVICE = "cuda"

# the SGD paths: bench.py's Incremental protocol (2M x 128 on the card,
# blocks of 250,000), phase 4's data in blocks of 500,000, cohorts of 16
# models (and 128 off the main path)
SGD_N, SGD_D = 2_000_000, 128
SGD_LOSSES = ("log_loss", "hinge", "squared_error")
SGD_EPOCHS = 5
SGD_COHORT = 16
SGD_COHORT_WIDE = 128
STREAM_SGD_EPOCHS = 3
# an SGD fit against its use_kernel=False twin: the same steps on the
# same blocks, each block's sums added in another order (f32 noise over
# at most 48 steps of a learning rate of 0.01 or less)
SGD_COEF_ATOL = 1e-5
# hinge's residual jumps at a margin of 1: a row whose margin lies within
# this of 1 (relative to |eta|) may land on the other side in another
# summation order, moving the gradient by its largest |x| entry
HINGE_TIE_RTOL = 1e-5


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
    """(least time in ms, what bounds it) on an H100 for the work; dtype
    names the peak the operations run at (a torch dtype or TF32X3)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tc_bound(nbytes, flops, ms):
    """A redesigned kernel's f32 work on the tensor cores: (bound ms, what
    bounds it, a text with both shares): its bound at the 3xTF32 peak and,
    for comparison with the earlier rows, the share of its bound at the
    CUDA cores' f32 FMA rate, which the text alone carries."""
    b_ms, b_by = bound(nbytes, flops, TF32X3)
    c_ms, c_by = bound(nbytes, flops, torch.float32)
    return b_ms, b_by, (
        f"bound {b_ms:.3f} ms ({b_by}, 3xTF32 peak), {b_ms / ms:.1%} of "
        f"bound; CUDA-core f32 bound {c_ms:.3f} ms ({c_by}), "
        f"{c_ms / ms:.1%} of it")


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
            # ptxas puts a kernel's spills on a line of their own
            if ("ptxas info" in line and ("Used" in line or "Compiling"
                                          in line)) or "spill" in line:
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
    kinds = {}
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
        walk = fused.glm_value_walk(d, dtype).walk
        log(f"glm kernel {family:8s} {str(dtype):14s} {n}x{d} ({walk} "
            f"walk): max|err| {err:.3e}, bit-equal reruns, kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms "
            f"({b_by}), {b_ms / ms:.1%} of bound; library: none (no single "
            "torch call computes the NLL sum and its gradient)")
        entry = _kind_entry(err, ms, plain_ms, b_ms, b_by, None)
        kinds[f"{family}_{str(dtype)[6:]}_{n}x{d}"] = entry
        if family == "logistic" and dtype == torch.float32:
            results["fused_glm_value_grad"].update(entry)
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
        walk = fused.glm_value_walk(d, dtype).walk
        log(f"glm kernel (off the main path) logistic {str(dtype):14s} "
            f"{n}x{d} ({walk} walk): max|err| {err:.3e}, bit-equal reruns, "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{b_ms:.3f} ms ({b_by}), {b_ms / ms:.1%} of bound")
        kinds[f"logistic_{str(dtype)[6:]}_{n}x{d}"] = _kind_entry(
            err, ms, plain_ms, b_ms, b_by, None)
        del x, xd, k1, k2
    results["fused_glm_value_grad"]["kinds"] = kinds
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
        b_ms, b_by, shares = tc_bound(nbytes, flops, ms)
        log(f"{name} {n}x{d} k={k} {fused.lloyd_mma_geometry(d, k)}: "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, {shares}; "
            "library: none (no single torch call computes assignment and "
            "per-cluster sums)")
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
        shares = tc_bound(n * d * 4, 2.0 * n * k * d, ms)[2]
        log(f"lloyd kernels (off the main path) {n}x{d} k={k} "
            f"{fused.lloyd_mma_geometry(d, k)}: max|err| {err:.3e}, "
            f"{n_ties} near-tie label flips, bit-equal reruns; "
            f"fused_lloyd_stats {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"{shares}")
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
    if not (np.isfinite(clf.coef_).all() and d_coef <= COEF_ATOL
            and d_b <= COEF_ATOL and acc >= oracle_acc - 0.005):
        raise AssertionError("GLM fit disagrees with the plain-loss fit")
    return X, y, clf


def phase_glm_fit_bf16(X, y, results):
    """Phase 18: bench.py's _bench_logreg_bf16 on the port: phase 4's fit
    with fit_dtype="bfloat16" (bf16 X, kernel 1's staged walk), timed over
    FITS fits, one profiled, against its plain-loss twin."""
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.ops import fused

    def fit(**kw):
        return LogisticRegression(solver="lbfgs", max_iter=50, tol=0.0,
                                  fit_dtype="bfloat16", **kw).fit(X, y)

    LogisticRegression(solver="lbfgs", max_iter=1, tol=0.0,
                       fit_dtype="bfloat16").fit(X, y)
    torch.cuda.synchronize()
    fused.reset_launches()
    clf = fit()
    torch.cuda.synchronize()
    launches = fused.launches()["fused_glm_value_grad"]
    results["fused_glm_value_grad"]["launches_bf16_fit"] = launches
    if clf.fit_dtype_ != "bfloat16" or launches < clf.n_iter_ or \
            clf.n_iter_ < 1:
        raise AssertionError(f"bf16 GLM fit ({clf.fit_dtype_}) ran "
                             f"{clf.n_iter_} iterations with {launches} "
                             "kernel launches")
    times = []
    for _ in range(FITS):
        t0 = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    rate = GLM_N * clf.n_iter_ / med
    log(f"glm fit bf16 {GLM_N}x{GLM_D} lbfgs (fit_dtype=bfloat16, "
        f"{fused.glm_value_walk(GLM_D + 1, torch.bfloat16).walk} walk): "
        f"{clf.n_iter_} iterations; over {FITS} fits median {med:.4f} s "
        f"(least {min(times):.4f}, most {max(times):.4f}); "
        f"logreg_fit_samples_per_sec_per_chip_bf16 {rate:.4g} samples/s at "
        f"the median ({GLM_N * clf.n_iter_ / min(times):.4g} at the least, "
        f"{GLM_N * clf.n_iter_ / max(times):.4g} at the most); kernel "
        f"launches {launches}")
    log(busy_line("glm fit bf16", *device_busy_ms(fit)))
    t0 = time.perf_counter()
    ref = fit(solver_kwargs={"use_kernel": False})
    torch.cuda.synchronize()
    elapsed_ref = time.perf_counter() - t0
    d_coef = float(np.abs(clf.coef_ - ref.coef_).max())
    scale = float(np.abs(ref.coef_).max())
    d_b = float(np.abs(clf.intercept_ - ref.intercept_).max())
    log(f"glm plain-loss fit bf16: {ref.n_iter_} iterations in "
        f"{elapsed_ref:.3f} s; max|dcoef| {d_coef:.3e} (max|coef| "
        f"{scale:.3e}, {d_coef / scale:.3e} of it), |dintercept| {d_b:.3e}")
    # BF16_COEF_RTOL: tests/test_torch_glm.py's bf16 tolerance, taken
    # relative to the coefficients' size
    if not (np.isfinite(clf.coef_).all()
            and d_coef <= BF16_COEF_RTOL * scale
            and d_b <= BF16_COEF_RTOL * max(scale, abs(float(
                ref.intercept_.max())))):
        raise AssertionError("bf16 GLM fit disagrees with its plain-loss "
                             "twin")


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
    blobs_fit = km

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
    del sub
    torch.cuda.empty_cache()
    return X, blobs_fit


def check_vgh(kernel_out, ref_out):
    """Newton kernel against its plain version evaluated in float64 (the
    Hessian's entries are sums of n_valid products; an f32 sum over 4M
    rows, the kernel's or cuBLAS's, carries its own rounding, so both are
    held to the f64 sums): the loss to GLM_LOSS_RTOL, the gradient to
    GLM_GRAD_RTOL and the Hessian to HESS_RTOL of their largest entries,
    the Hessian exactly symmetric. Returns the largest absolute
    deviation."""
    (v, g, h), (v0, g0, h0) = kernel_out, ref_out
    if not torch.equal(h, h.T):
        raise AssertionError("Newton kernel: the Hessian is not symmetric")
    dv = abs(float(v) - float(v0))
    dg = float((g.double() - g0).abs().max())
    dh = float((h.double() - h0).abs().max())
    gs, hs = float(g0.abs().max()), float(h0.abs().max())
    if not (dv <= GLM_LOSS_RTOL * abs(float(v0))
            and dg <= GLM_GRAD_RTOL[torch.float32] * gs
            and dh <= HESS_RTOL * hs):
        raise AssertionError(
            f"Newton kernel disagrees with its plain version: |dloss| {dv} "
            f"(loss {float(v0)}), |dgrad| {dg} (max {gs}), |dhess| {dh} "
            f"(max {hs})")
    return max(dv, dg, dh)


def phase_newton_kernel(gen, results):
    from dask_ml_tpu_torch.models.solvers.families import get_family
    from dask_ml_tpu_torch.ops import fused

    dev = torch.device("cuda")
    cases = [("logistic", GLM_N, GLM_D + 1), ("normal", GLM_N // 4, GLM_D + 1),
             ("poisson", GLM_N // 4, GLM_D + 1)] + \
        [("logistic", n, d) for n, d in VGH_WIDE]
    for family, n, d in cases:
        x = torch.randn((n, d), generator=gen, device=dev)
        x[:, -1] = 1.0
        beta = torch.randn(d, generator=gen, device=dev) / (4.0 * d ** 0.5)
        if family == "logistic":
            y = (torch.rand(n, generator=gen, device=dev) < 0.5).float()
        elif family == "poisson":
            y = torch.poisson(torch.ones(n, device=dev), generator=gen)
        else:
            y = torch.randn(n, generator=gen, device=dev)
        n_valid = n - 37
        args = (x, n_valid, y, beta, family)
        k1 = fused.fused_glm_value_grad_hess(*args)
        k2 = fused.fused_glm_value_grad_hess(*args)
        torch.cuda.synchronize()
        if not same_bits(k1, k2):
            raise AssertionError(f"Newton kernel {family} {n}x{d}: two runs "
                                 "differ")
        ref = fused.glm_value_grad_hess_plain(x.double(), n_valid,
                                              y.double(), beta.double(),
                                              family)
        err = check_vgh(k1, ref)
        plain = fused.glm_value_grad_hess_plain(*args)
        err_plain = float((plain[2].double() - ref[2]).abs().max())
        del ref, plain
        torch.cuda.empty_cache()
        ms = time_ms(lambda: fused.fused_glm_value_grad_hess(*args), 5, 1)
        plain_ms = time_ms(lambda: fused.glm_value_grad_hess_plain(*args),
                           3, 1)
        xv = x[:n_valid]
        w = get_family(family).hess_weight(xv @ beta, y[:n_valid])
        lib_ms = time_ms(lambda: (xv * w[:, None]).T @ xv, 3, 1)
        # operations: the Hessian's upper half (with the diagonal), eta
        # and the gradient, an FMA counted as two
        flops = 2.0 * n_valid * (d * (d + 1) / 2 + 2 * d)
        nbytes = n_valid * (d + 1) * 4 + d * 4 + (1 + d + d * d) * 4
        b_ms, b_by, shares = tc_bound(nbytes, flops, ms)
        where = "" if n >= GLM_N // 4 else " (off the main path)"
        log(f"newton kernel{where} {family:8s} {n}x{d}: max|err| {err:.3e} "
            f"against the f64 sums (the f32 plain version's Hessian: "
            f"{err_plain:.3e}), bit-equal reruns, symmetric; kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, {shares}; library "
            f"(cuBLAS (X*w)^T X, TF32 off) {lib_ms:.3f} ms, the kernel "
            f"{lib_ms / ms:.2f}x its speed")
        if family == "logistic" and n == GLM_N:
            results["fused_glm_value_grad_hess"].update(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)
        del x, xv, w, k1, k2
        torch.cuda.empty_cache()


def phase_multi_kernel(gen, results):
    from dask_ml_tpu_torch.ops import fused

    dev = torch.device("cuda")
    cases = [(GLM_N, GLM_D + 1, OVR_CLASSES, torch.float32),
             (GLM_N, GLM_D + 1, OVR_CLASSES, torch.bfloat16)] + \
        [(n, d, c, torch.float32) for n, d, c in MULTI_WIDE]
    for n, d, c, dtype in cases:
        x = torch.randn((n, d), generator=gen, device=dev).to(dtype)
        codes = torch.randint(0, c, (n,), generator=gen, device=dev,
                              dtype=torch.int32)
        B = torch.randn((c, d), generator=gen, device=dev) / (4.0 * d ** 0.5)
        n_valid = n - 29
        args = (x, n_valid, codes, B, "logistic")
        k1 = fused.fused_glm_multi_value_grad(*args)
        k2 = fused.fused_glm_multi_value_grad(*args)
        torch.cuda.synchronize()
        if not same_bits(k1, k2):
            raise AssertionError(f"one-vs-rest kernel {n}x{d} C={c} {dtype}: "
                                 "two runs differ")
        err = check_glm(k1, fused.glm_multi_value_grad_plain(*args), dtype)
        ms = time_ms(lambda: fused.fused_glm_multi_value_grad(*args), 10)
        plain_ms = time_ms(lambda: fused.glm_multi_value_grad_plain(*args),
                           3, 1)
        nbytes = n_valid * (d * x.element_size() + 4) + c * d * 4 \
            + (1 + c * d) * 4
        flops = 4.0 * n_valid * d * c + 12.0 * n_valid * c
        if dtype == torch.float32:
            b_ms, b_by, shares = tc_bound(nbytes, flops, ms)
        else:
            b_ms, b_by = bound(nbytes, flops, dtype)
            shares = f"bound {b_ms:.3f} ms ({b_by}), {b_ms / ms:.1%} of bound"
        main = n == GLM_N
        log(f"one-vs-rest kernel{'' if main else ' (off the main path)'} "
            f"{str(dtype):14s} {n}x{d} C={c} "
            f"{fused.multi_mma_geometry(d, x.element_size())}: max|err| "
            f"{err:.3e}, bit-equal reruns, kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, {shares}; library: none (no single torch "
            "call computes the C losses and gradients)")
        if main and dtype == torch.float32:
            results["fused_glm_multi_value_grad"].update(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)
        del x, k1, k2
        torch.cuda.empty_cache()


def _objective(est, X, y):
    """Mean logistic NLL + l2 penalty of a fitted binary estimator, in
    float64 on the card (sklearn's scaling, intercept unpenalized)."""
    coef = torch.as_tensor(est.coef_[0], dtype=torch.float64,
                           device=X.device)
    eta = X.double() @ coef + float(est.intercept_[0])
    nll = (torch.nn.functional.softplus(eta) - y.double() * eta).mean()
    return float(nll) + 0.5 / (est.C * X.shape[0]) * float(coef @ coef)


def phase_newton_fit(X, y, lbfgs_fit, results):
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.ops import fused

    LogisticRegression(solver="newton", max_iter=1).fit(X, y)
    torch.cuda.synchronize()
    fused.reset_launches()
    clf = LogisticRegression(solver="newton", max_iter=10).fit(X, y)
    torch.cuda.synchronize()
    launches = fused.launches()
    results["fused_glm_value_grad_hess"]["launches"] = \
        launches["fused_glm_value_grad_hess"]
    if launches["fused_glm_value_grad_hess"] != clf.n_iter_ or \
            launches["fused_glm_value_grad"] < clf.n_iter_ or \
            clf.n_iter_ < 1:
        raise AssertionError(f"Newton fit ran {clf.n_iter_} iterations with "
                             f"{launches}")
    times = []
    for _ in range(FITS):
        t0 = time.perf_counter()
        LogisticRegression(solver="newton", max_iter=10).fit(X, y)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    d_coef = float(np.abs(clf.coef_ - lbfgs_fit.coef_).max())
    d_b = float(np.abs(clf.intercept_ - lbfgs_fit.intercept_).max())
    log(f"newton fit {GLM_N}x{GLM_D}: {clf.n_iter_} iterations (grad norm "
        f"{clf.solver_info_['grad_norm']:.3e}); over {FITS} fits median "
        f"{med:.4f} s (least {min(times):.4f}, most {max(times):.4f}), "
        f"{GLM_N * clf.n_iter_ / med:.4g} samples/s at the median; launches "
        f"fused_glm_value_grad_hess {launches['fused_glm_value_grad_hess']}, "
        f"fused_glm_value_grad {launches['fused_glm_value_grad']}; against "
        f"phase 4's lbfgs fit max|dcoef| {d_coef:.3e}, |dintercept| "
        f"{d_b:.3e}")
    log(busy_line("newton fit", *device_busy_ms(
        lambda: LogisticRegression(solver="newton", max_iter=10).fit(X, y))))
    if not (np.isfinite(clf.coef_).all() and d_coef <= COEF_ATOL
            and d_b <= COEF_ATOL):
        raise AssertionError("Newton fit disagrees with the lbfgs fit")
    return clf


def phase_ovr_fit(gen, X, results):
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.ops import fused

    dev = X.device
    W = torch.randn((GLM_D, OVR_CLASSES), generator=gen, device=dev) \
        / GLM_D ** 0.5
    y = torch.multinomial(torch.softmax(X @ W, dim=1), 1, generator=gen)[:, 0]
    y = y.float()
    LogisticRegression(solver="lbfgs", max_iter=1, tol=0.0).fit(X, y)
    torch.cuda.synchronize()

    def fit(**kw):
        return LogisticRegression(solver="lbfgs", max_iter=50, tol=0.0,
                                  **kw).fit(X, y)

    fused.reset_launches()
    clf = fit()
    torch.cuda.synchronize()
    launches = fused.launches()
    results["fused_glm_multi_value_grad"]["launches"] = \
        launches["fused_glm_multi_value_grad"]
    if launches["fused_glm_multi_value_grad"] < clf.n_iter_ or \
            clf.n_iter_ < 1 or not clf.solver_info_.get("fused_multi"):
        raise AssertionError(f"one-vs-rest fit ran {clf.n_iter_} iterations "
                             f"with {launches}")
    times = []
    for _ in range(FITS):
        t0 = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    acc = clf.score(X, y)
    log(f"one-vs-rest fit {GLM_N}x{GLM_D} C={OVR_CLASSES} lbfgs: "
        f"{clf.n_iter_} iterations; over {FITS} fits median {med:.4f} s "
        f"(least {min(times):.4f}, most {max(times):.4f}), "
        f"{GLM_N * clf.n_iter_ / med:.4g} samples/s at the median; kernel "
        f"launches {launches['fused_glm_multi_value_grad']}, training "
        f"accuracy {acc:.4f}")
    log(busy_line("one-vs-rest fit", *device_busy_ms(fit)))
    t0 = time.perf_counter()
    ref = fit(solver_kwargs={"use_kernel": False})
    torch.cuda.synchronize()
    elapsed_ref = time.perf_counter() - t0
    d_coef = float(np.abs(clf.coef_ - ref.coef_).max())
    d_b = float(np.abs(clf.intercept_ - ref.intercept_).max())
    log(f"one-vs-rest plain-loss fit: {ref.n_iter_} iterations in "
        f"{elapsed_ref:.3f} s; max|dcoef| {d_coef:.3e}, |dintercept| "
        f"{d_b:.3e}")
    if not (clf.coef_.shape == (OVR_CLASSES, GLM_D)
            and np.isfinite(clf.coef_).all() and d_coef <= COEF_ATOL
            and d_b <= COEF_ATOL):
        raise AssertionError("one-vs-rest fit disagrees with the plain-loss "
                             "fit")
    return y


def phase_admm_fit(X, y):
    from dask_ml_tpu_torch.linear_model import LogisticRegression

    X, y = X[:ADMM_N], y[:ADMM_N]
    t0 = time.perf_counter()
    clf = LogisticRegression(max_iter=20).fit(X, y)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    opt = LogisticRegression(solver="newton", tol=1e-6).fit(X, y)
    f_admm, f_opt = _objective(clf, X, y), _objective(opt, X, y)
    gap = (f_admm - f_opt) / abs(f_opt)
    info = clf.solver_info_
    log(f"admm fit {ADMM_N}x{GLM_D} (the default solver): {clf.n_iter_} "
        f"iterations in {elapsed:.3f} s, primal residual "
        f"{info['primal_residual']:.3e}, dual {info['dual_residual']:.3e}; "
        f"objective {f_admm:.9f} against the Newton optimum's {f_opt:.9f} "
        f"({opt.n_iter_} iterations): rel gap {gap:.3e}")
    log(busy_line("admm fit", *device_busy_ms(
        lambda: LogisticRegression(max_iter=20).fit(X, y))))
    if not (clf.solver == "admm" and np.isfinite(clf.coef_).all()
            and abs(gap) <= ADMM_OBJ_RTOL):
        raise AssertionError("ADMM fit misses the Newton optimum")


def check_glm_stream(kind, out, ref, mxu):
    """A streamed GLM kernel against its plain version: the loss to
    GLM_LOSS_RTOL, the gradient to GLM_GRAD_RTOL of its largest entry
    (bf16 operands: the bf16 tolerance), and for "vgh" the Hessian to
    HESS_RTOL of its largest entry against the f64 sums (``ref`` is then
    the plain version in float64), exactly symmetric. Returns the
    largest absolute deviation."""
    dtype = torch.bfloat16 if mxu is not None else torch.float32
    if kind == "vgh":
        return check_vgh(out, ref)
    dv = abs(float(out[0]) - float(ref[0]))
    err = dv
    ok = dv <= GLM_LOSS_RTOL * abs(float(ref[0]))
    if kind != "val":
        dg = float((out[1].double() - ref[1].double()).abs().max())
        ok = ok and dg <= GLM_GRAD_RTOL[dtype] * float(ref[1].abs().max())
        err = max(err, dg)
    if not ok:
        raise AssertionError(f"streamed GLM kernel {kind} disagrees with its "
                             f"plain version: max|err| {err}")
    return err


def check_block_stats(x, n_valid, centers, mxu, out, plain):
    """fused_kmeans_block_stats against its plain version. Labels may
    part only on f32 near-ties: rows whose two nearest centers (by the
    plain version's distances) lie within LLOYD_MIND_RTOL of the row's
    ||x||^2 + max ||c||^2. Counts differ by at most two per such row,
    the sums by LLOYD_SUMS_RTOL of their scale plus two such rows, the
    inertia by LLOYD_INERTIA_RTOL; the counts add up to n_valid. Returns
    (largest absolute deviation of the sums, near-tie rows)."""
    from dask_ml_tpu_torch.ops.pairwise import euclidean_distances_sq

    sums, counts, inertia = out
    p_sums, p_counts, p_inertia = plain
    xv = x[:n_valid]
    top2 = euclidean_distances_sq(xv, centers, mxu_dtype=mxu).topk(
        2, dim=1, largest=False).values
    terms = (xv * xv).sum(1) + float((centers * centers).sum(1).max())
    tie = (top2[:, 1] - top2[:, 0]) <= LLOYD_MIND_RTOL * terms
    n_ties = int(tie.sum())
    x_tie = float(xv[tie].abs().max()) if n_ties else 0.0
    dcount = int((counts.long() - p_counts.long()).abs().sum())
    d_sums = float((sums - p_sums).abs().max())
    scale = float(p_sums.abs().max())
    d_in = abs(float(inertia) - float(p_inertia))
    if not (int(counts.sum()) == n_valid and dcount <= 2 * n_ties
            and d_sums <= LLOYD_SUMS_RTOL * scale + 2 * x_tie
            and d_in <= LLOYD_INERTIA_RTOL * abs(float(p_inertia))):
        raise AssertionError(
            f"fused_kmeans_block_stats disagrees: counts off by {dcount} "
            f"with {n_ties} near-ties, |dsums| {d_sums} (scale {scale}), "
            f"|dinertia| {d_in}")
    return d_sums, n_ties


def _kind_entry(err, ms, plain_ms, b_ms, b_by, lib_ms):
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def phase_stream_kernels(gen, results):
    from dask_ml_tpu_torch.models.solvers.families import get_family
    from dask_ml_tpu_torch.ops import fused

    dev = torch.device(STREAM_DEVICE)
    S, d, R = STREAM_GLM_ROWS, GLM_D, STREAM_RAGGED
    x = torch.randn((S, d), generator=gen, device=dev)
    beta = torch.randn(d + 1, generator=gen, device=dev) / (4.0 * d ** 0.5)
    ys = {
        "logistic": (torch.rand(S, generator=gen, device=dev) < 0.5).float(),
        "normal": torch.randn(S, generator=gen, device=dev),
        "poisson": torch.poisson(torch.ones(S, device=dev), generator=gen),
    }
    x_nan = x.clone()
    x_nan[R:] = torch.nan
    bf16 = torch.bfloat16
    kinds = [("val", None), ("vg", None), ("vg", bf16), ("vgh", None)]
    entries = {}
    for family, (kind, mxu) in itertools.product(ys, kinds):
        if mxu is not None and family != "logistic":
            continue
        y = ys[family]
        args = (kind, x, S, y, beta, family, True)
        k1 = tuple(t.clone() for t in fused.fused_glm_stream(*args, mxu=mxu))
        k2 = fused.fused_glm_stream(*args, mxu=mxu)
        torch.cuda.synchronize()
        if not same_bits(k1, k2):
            raise AssertionError(f"fused_glm_stream {kind} {family}: two runs "
                                 "differ")
        if kind == "vgh":
            ref = fused.glm_stream_plain(kind, x.double(), S, y.double(),
                                         beta.double(), family, True)
        else:
            ref = fused.glm_stream_plain(*args, mxu=mxu)
        err = check_glm_stream(kind, k1, ref, mxu)
        del ref
        # the ragged block: rows past its count are NaN, never read
        y_nan = y.clone()
        y_nan[R:] = torch.nan
        kr = fused.fused_glm_stream(kind, x_nan, R, y_nan, beta, family,
                                    True, mxu=mxu)
        rr = fused.glm_stream_plain(kind, x[:R], R, y[:R], beta, family,
                                    True, mxu=mxu)
        if not all(bool(torch.isfinite(t).all()) for t in kr):
            raise AssertionError("fused_glm_stream read a NaN tail row")
        if kind != "vgh":
            check_glm_stream(kind, kr, rr, mxu)
        else:
            check_vgh(kr, tuple(t.double() for t in rr))
        del kr, rr, y_nan
        ms = time_ms(lambda: fused.fused_glm_stream(*args, mxu=mxu), 20)
        plain_ms = time_ms(lambda: fused.glm_stream_plain(*args, mxu=mxu),
                           3, 1)
        # bytes: X, y and beta read once, the sums written once; ops: eta
        # (an FMA a value, two flops), the family's per-row terms, the
        # gradient (two flops a value) and for vgh the Hessian's upper
        # half with its X^T w border
        nbytes = S * (d + 1) * 4 + (d + 1) * 4
        flops = 2.0 * S * d + 12.0 * S
        lib_ms = None
        if kind != "val":
            flops += 2.0 * S * d
            nbytes += (d + 2) * 4
        if kind == "vgh":
            flops += 2.0 * S * (d * (d + 1) / 2 + d)
            nbytes += (d + 1) ** 2 * 4
            xv = x
            w = get_family(family).hess_weight(xv @ beta[:-1] + beta[-1], y)
            lib_ms = time_ms(lambda: (xv * w[:, None]).T @ xv, 3, 1)
            del w
        if kind == "vgh":
            b_ms, b_by, shares = tc_bound(nbytes, flops, ms)
        else:
            b_ms, b_by = bound(nbytes, flops, bf16 if mxu is not None
                               else torch.float32)
            shares = f"bound {b_ms:.3f} ms ({b_by}), {b_ms / ms:.1%} of bound"
        tag = kind + ("_bf16" if mxu is not None else "")
        lib = (f"library (cuBLAS (X*w)^T X, TF32 off) {lib_ms:.3f} ms, the "
               f"kernel {lib_ms / ms:.2f}x its speed"
               if lib_ms is not None else "library: none (no single torch "
               "call computes these sums)")
        log(f"streamed glm kernel {tag:8s} {family:8s} {S}x{d}: max|err| "
            f"{err:.3e}, bit-equal reruns, NaN tail past {R} rows unread; "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, {shares}; {lib}")
        if family == "logistic":
            entries[tag] = _kind_entry(err, ms, plain_ms, b_ms, b_by, lib_ms)
        del k1, k2
    results["fused_glm_stream"].update(
        {k: v for k, v in entries["vg"].items()},
        sources=["dask_ml_tpu_torch/csrc/glm_value_grad.cu",
                 "dask_ml_tpu_torch/csrc/glm_value_grad_hess.cu"],
        kinds=entries)
    del x_nan, ys
    torch.cuda.empty_cache()

    # one-vs-rest, C = 10, the streamed f32 class codes
    C = OVR_CLASSES
    codes = torch.randint(0, C, (S,), generator=gen, device=dev).float()
    B = torch.randn((C, d + 1), generator=gen, device=dev) / (4.0 * d ** 0.5)
    x_nan = x.clone()
    x_nan[R:] = torch.nan
    codes_nan = codes.clone()
    codes_nan[R:] = torch.nan
    entries = {}
    for kind, mxu in [("val", None), ("vg", None), ("vg", bf16)]:
        args = (kind, x, S, codes, B, "logistic", True)
        k1 = tuple(t.clone() for t in fused.fused_glm_multi_stream(
            *args, mxu=mxu))
        k2 = fused.fused_glm_multi_stream(*args, mxu=mxu)
        torch.cuda.synchronize()
        if not same_bits(k1, k2):
            raise AssertionError(f"fused_glm_multi_stream {kind}: two runs "
                                 "differ")
        err = check_glm_stream(kind, k1, fused.glm_multi_stream_plain(
            *args, mxu=mxu), mxu)
        kr = fused.fused_glm_multi_stream(kind, x_nan, R, codes_nan, B,
                                          "logistic", True, mxu=mxu)
        if not all(bool(torch.isfinite(t).all()) for t in kr):
            raise AssertionError("fused_glm_multi_stream read a NaN tail "
                                 "row")
        check_glm_stream(kind, kr, fused.glm_multi_stream_plain(
            kind, x[:R], R, codes[:R], B, "logistic", True, mxu=mxu), mxu)
        ms = time_ms(lambda: fused.fused_glm_multi_stream(*args, mxu=mxu),
                     20)
        plain_ms = time_ms(
            lambda: fused.glm_multi_stream_plain(*args, mxu=mxu), 3, 1)
        nbytes = S * (d + 1) * 4 + C * (d + 1) * 4
        flops = 2.0 * S * d * C + 12.0 * S * C
        if kind == "vg":
            flops += 2.0 * S * d * C
            nbytes += (1 + C * (d + 1)) * 4
        if mxu is None:
            b_ms, b_by, shares = tc_bound(nbytes, flops, ms)
        else:
            b_ms, b_by = bound(nbytes, flops, bf16)
            shares = f"bound {b_ms:.3f} ms ({b_by}), {b_ms / ms:.1%} of bound"
        tag = kind + ("_bf16" if mxu is not None else "")
        log(f"streamed one-vs-rest kernel {tag:8s} {S}x{d} C={C} "
            f"{fused.multi_stream_geometry(d, mxu is not None)}: max|err| "
            f"{err:.3e}, bit-equal reruns, NaN tail unread; kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, {shares}; library: "
            "none")
        entries[tag] = _kind_entry(err, ms, plain_ms, b_ms, b_by, None)
        del k1, k2, kr
    results["fused_glm_multi_stream"].update(
        {k: v for k, v in entries["vg"].items()}, kinds=entries)
    del x, x_nan, codes, codes_nan
    torch.cuda.empty_cache()

    # KMeans, the auto block at d = 128, k = 64, then off the main path
    # the wider shapes, from their own generator (the shared one feeds the
    # later phases)
    S, d, k = STREAM_KM_ROWS, KM_D, KM_K
    x = torch.randn((S, d), generator=gen, device=dev)
    c = x[torch.randperm(S, generator=gen, device=dev)[:k]].clone()
    entries = {}
    for mxu in (None, bf16):
        tag = "f32" if mxu is None else "bf16_cross"
        entries[tag] = _kmeans_block_case(x, c, mxu, "")
    del x, c
    torch.cuda.empty_cache()
    wide_gen = torch.Generator(device=dev).manual_seed(9)
    for d, k in KM_BLOCK_WIDE:
        x = torch.randn((S, d), generator=wide_gen, device=dev)
        c = x[torch.randperm(S, generator=wide_gen, device=dev)[:k]].clone()
        for mxu in (None, bf16):
            tag = f"d{d}_k{k}_" + ("f32" if mxu is None else "bf16_cross")
            entries[tag] = _kmeans_block_case(x, c, mxu,
                                              " (off the main path)")
        del x, c
        torch.cuda.empty_cache()
    results["fused_kmeans_block_stats"].update(
        {k: v for k, v in entries["f32"].items()}, kinds=entries)


def _kmeans_block_case(x, c, mxu, note):
    """fused_kmeans_block_stats on the block x (S, d) with centers c: two
    runs bit-equal, against the plain version on the block and on a
    ragged block whose rows past STREAM_RAGGED are NaN, kernel and plain
    times and the bound."""
    from dask_ml_tpu_torch.ops import fused

    S, d = x.shape
    k = c.shape[0]
    R = STREAM_RAGGED
    k1 = tuple(t.clone() for t in fused.fused_kmeans_block_stats(
        x, S, c, mxu=mxu))
    k2 = fused.fused_kmeans_block_stats(x, S, c, mxu=mxu)
    torch.cuda.synchronize()
    if not same_bits(k1, k2):
        raise AssertionError("fused_kmeans_block_stats: two runs differ")
    err, n_ties = check_block_stats(
        x, S, c, mxu, k1, fused.kmeans_block_stats_plain(x, S, c, mxu))
    x_nan = x.clone()
    x_nan[R:] = torch.nan
    kr = tuple(t.clone() for t in fused.fused_kmeans_block_stats(
        x_nan, R, c, mxu=mxu))
    kr2 = fused.fused_kmeans_block_stats(x_nan, R, c, mxu=mxu)
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(t.float()).all()) for t in kr):
        raise AssertionError("fused_kmeans_block_stats read a NaN tail")
    if not same_bits(kr, kr2):
        raise AssertionError("fused_kmeans_block_stats: two runs of the "
                             "ragged block differ")
    check_block_stats(x, R, c, mxu, kr,
                      fused.kmeans_block_stats_plain(x, R, c, mxu))
    del x_nan, kr, kr2
    ms = time_ms(lambda: fused.fused_kmeans_block_stats(x, S, c, mxu=mxu), 20)
    plain_ms = time_ms(
        lambda: fused.kmeans_block_stats_plain(x, S, c, mxu), 3, 1)
    nbytes = S * d * 4 + k * d * 4 + (k * d + k + 1) * 4
    cross = 2.0 * S * k * d
    other = 2.0 * S * d + 3.0 * S * k + S * d
    if mxu is None:
        b_ms, b_by, shares = tc_bound(nbytes, cross + other, ms)
    else:
        # the cross term at the bf16 rate, the rest at the f32 rate
        t_ops = (cross / PEAK_FLOPS[torch.bfloat16]
                 + other / PEAK_FLOPS[torch.float32]) * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        b_ms, b_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                      else (t_ops, "operations"))
        shares = f"bound {b_ms:.3f} ms ({b_by}), {b_ms / ms:.1%} of bound"
    tag = "f32" if mxu is None else "bf16_cross"
    log(f"streamed kmeans kernel {tag:10s} {S}x{d} k={k}{note}: max|dsums| "
        f"{err:.3e} ({n_ties} near-tie rows), bit-equal reruns, NaN tail "
        f"past {R} rows unread; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"{shares}; library: none")
    del k1, k2
    return _kind_entry(err, ms, plain_ms, b_ms, b_by, None)


def _sgd_targets(gen, S, loss, codes=0):
    dev = torch.device("cuda")
    if codes:
        return torch.randint(0, codes, (S,), generator=gen,
                             device=dev).float()
    if loss == "squared_error":
        return torch.randn(S, generator=gen, device=dev)
    return (torch.rand(S, generator=gen, device=dev) < 0.5).float()


def hinge_slack(x, n_valid, y, W, iflags, codes, mxu):
    """The gradient deviation hinge's near-ties allow: for each weight
    row, the sum over rows whose margin (from f64 sums of the operands
    the kernel rounds to) lies within HINGE_TIE_RTOL of 1 of their
    largest |x| entry (at least 1, the intercept's)."""
    xv = x[:n_valid]
    W = W.reshape(-1, W.shape[-1]).float()
    Wm = W[:, :-1]
    if mxu is not None:
        xv, Wm = xv.to(mxu), Wm.to(mxu)
    eta = xv.double() @ Wm.double().T + (W[:, -1] * iflags).double()[None, :]
    yv = y[:n_valid].double()
    Y = (yv[:, None] == torch.arange(W.shape[0], device=x.device)[None, :]
         ).double() if codes else yv[:, None]
    margin = (2.0 * Y - 1.0) * eta
    tie = (margin - 1.0).abs() <= HINGE_TIE_RTOL * eta.abs().clamp_min(1.0)
    rowmax = x[:n_valid].abs().amax(1).double().clamp_min(1.0)
    return float((tie.double() * rowmax[:, None]).sum(0).max()), \
        int(tie.sum())


def check_sgd(kernel_out, plain_out, dtype, slack=0.0):
    """An SGD kernel against its plain version: the loss (each row's,
    for the many-rows kernel) to GLM_LOSS_RTOL of its largest entry, the
    gradient to GLM_GRAD_RTOL of its largest entry plus ``slack``
    (hinge_slack). Returns the largest absolute deviation."""
    (v, g), (v0, g0) = kernel_out, plain_out
    dv = float((v.double() - v0.double()).abs().max())
    dg = float((g.double() - g0.double()).abs().max())
    vs, gs = float(v0.abs().max()), float(g0.abs().max())
    if not (dv <= GLM_LOSS_RTOL * vs and dg <= GLM_GRAD_RTOL[dtype] * gs
            + slack):
        raise AssertionError(
            f"SGD kernel disagrees with its plain version: |dloss| {dv} "
            f"(max {vs}), |dgrad| {dg} (max {gs}, slack {slack})")
    return max(dv, dg)


def _sgd_kernel_case(gen, what, S, d, loss, mxu, n_rows=None, codes=False,
                     view=False):
    """One SGD kernel case at (S, d): two runs bit-equal, against the
    plain version on the full block, on a ragged block whose tail is NaN
    and on a block with a count of 0; kernel and plain times and the
    bound. ``n_rows``: None for fused_sgd_block_grad, else the N weight
    rows of fused_sgd_many_block_grad (class codes when ``codes``).
    ``view``: the block is rows 1.. of a larger X, so at d % 4 != 0 it
    starts off a 16-byte boundary, as SGD's resident blocks do."""
    from dask_ml_tpu_torch.ops import fused

    dev = torch.device("cuda")
    if view:
        x = torch.randn((S + 1, d), generator=gen, device=dev)[1:]
        if d % 4 and x.data_ptr() % 16 == 0:
            raise AssertionError("the view starts on a 16-byte boundary")
    else:
        x = torch.randn((S, d), generator=gen, device=dev)
    y = _sgd_targets(gen, S, loss, n_rows if codes else 0)
    N = 1 if n_rows is None else n_rows
    W = torch.randn((N, d + 1), generator=gen, device=dev) / (4.0 * d ** 0.5)
    if n_rows is None:
        W, iflags = W[0], 1.0
        kern, plain = fused.fused_sgd_block_grad, fused.sgd_block_grad_plain

        def call(fn, xx, nv, yy):
            return fn(xx, nv, yy, W, iflags, loss, mxu)
    else:
        # a cohort's own intercept flags; one flag for the C class rows
        iflags = (torch.arange(N, device=dev) % 3 != 2).float() \
            if not codes else 1.0
        kern = fused.fused_sgd_many_block_grad
        plain = fused.sgd_many_block_grad_plain

        def call(fn, xx, nv, yy):
            return fn(xx, nv, yy, W, iflags, loss, codes, mxu)
    dtype = torch.bfloat16 if mxu is not None else torch.float32
    k1 = tuple(t.clone() for t in call(kern, x, S, y))
    k2 = call(kern, x, S, y)
    torch.cuda.synchronize()
    if not same_bits(k1, k2):
        raise AssertionError(f"{what}: two runs differ")
    slack, ties = (hinge_slack(x, S, y, W, iflags, codes, mxu)
                   if loss == "hinge" else (0.0, 0))
    err = check_sgd(k1, call(plain, x, S, y), dtype, slack)
    # the ragged block: rows past its count are NaN, never read
    R = STREAM_RAGGED
    x_nan, y_nan = x.clone(), y.clone()
    if view:
        x_nan = torch.empty((S + 1, d), device=dev)[1:]
        x_nan.copy_(x)
    x_nan[R:] = torch.nan
    y_nan[R:] = torch.nan
    kr = call(kern, x_nan, R, y_nan)
    if not all(bool(torch.isfinite(t).all()) for t in kr):
        raise AssertionError(f"{what} read a NaN tail row")
    slack_r = (hinge_slack(x, R, y, W, iflags, codes, mxu)[0]
               if loss == "hinge" else 0.0)
    check_sgd(kr, call(plain, x[:R], R, y[:R]), dtype, slack_r)
    k0 = call(kern, x_nan, 0, y_nan)
    if any(bool(t.any()) for t in k0):
        raise AssertionError(f"{what}: a block of count 0 gave nonzero sums")
    del x_nan, y_nan, kr, k0
    ms = time_ms(lambda: call(kern, x, S, y), 20)
    plain_ms = time_ms(lambda: call(plain, x, S, y), 3, 1)
    # bytes: X and y read once, W read and the sums written once; ops:
    # eta and the gradient (two flops a multiply-add each) per weight row,
    # and the loss's per-row terms
    nbytes = S * (d + 1) * 4 + 2 * N * (d + 2) * 4
    flops = 4.0 * S * d * N + 12.0 * S * N
    # f32 products could run on the tensor cores at f32 accuracy: the
    # bound is at the 3xTF32 peak, the CUDA-core share beside it
    if dtype == torch.float32:
        b_ms, b_by, shares = tc_bound(nbytes, flops, ms)
    else:
        b_ms, b_by = bound(nbytes, flops, dtype)
        shares = f"bound {b_ms:.3f} ms ({b_by}), {b_ms / ms:.1%} of bound"
    tie_note = f", {ties} near-tie margins" if loss == "hinge" else ""
    walk_note = "" if n_rows is not None else " ({} walk)".format(
        fused.glm_value_walk(d, torch.float32,
                             "vg" if mxu is None else "vg_bf16").walk)
    log(f"{what} {loss:13s} {str(dtype):14s} {S}x{d}{walk_note}"
        f"{'' if n_rows is None else f' N={N}'}"
        f"{' (a view off 16 bytes)' if view else ''}: max|err| {err:.3e}"
        f"{tie_note}, bit-equal reruns, NaN tail past {R} rows unread, "
        f"count 0 gives zeros; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"{shares}; library: none (no single torch call computes the loss "
        "sums and gradients)")
    del x, y, k1, k2
    torch.cuda.empty_cache()
    return _kind_entry(err, ms, plain_ms, b_ms, b_by, None)


def phase_sgd_kernels(gen, results):
    """Phase 14: fused_sgd_block_grad at the Incremental block
    (250,000 x 128) and phase 4's block (500,000 x 256), the three losses,
    f32 and bf16 operands; fused_sgd_many_block_grad with class codes at
    500,000 x 256, C = 10, and for a cohort of 16 at 250,000 x 128 (128
    off the main path, and at d = 13 on a block that is a row view
    starting off a 16-byte boundary)."""
    bf16 = torch.bfloat16
    inc_rows = SGD_N // 8
    glm_rows = GLM_N // 8
    entries = {}
    for (S, d), loss, mxu in itertools.product(
            [(inc_rows, SGD_D), (glm_rows, GLM_D)], SGD_LOSSES, (None, bf16)):
        tag = f"{loss}_{S}x{d}" + ("_bf16" if mxu is not None else "")
        entries[tag] = _sgd_kernel_case(gen, "fused_sgd_block_grad", S, d,
                                        loss, mxu)
    results["fused_sgd_block_grad"].update(
        entries[f"log_loss_{inc_rows}x{SGD_D}"], kinds=entries)
    entries = {}
    cases = [(glm_rows, GLM_D, OVR_CLASSES, True, loss, None)
             for loss in SGD_LOSSES] + \
        [(glm_rows, GLM_D, OVR_CLASSES, True, "log_loss", bf16)] + \
        [(inc_rows, SGD_D, SGD_COHORT, False, loss, None)
         for loss in SGD_LOSSES] + \
        [(inc_rows, SGD_D, SGD_COHORT, False, "log_loss", bf16),
         (inc_rows, SGD_D, SGD_COHORT_WIDE, False, "log_loss", None)]
    for S, d, N, codes, loss, mxu in cases:
        what = ("fused_sgd_many_block_grad codes" if codes else
                "fused_sgd_many_block_grad cohort") + \
            ("" if N <= SGD_COHORT else " (off the main path)")
        tag = f"{'codes' if codes else 'cohort'}_{loss}_{S}x{d}_N{N}" + \
            ("_bf16" if mxu is not None else "")
        entries[tag] = _sgd_kernel_case(gen, what, S, d, loss, mxu,
                                        n_rows=N, codes=codes)
    # a row view off 16 bytes, from its own generator (the shared one
    # feeds phases 15-17)
    view_gen = torch.Generator(device="cuda").manual_seed(14)
    for d, N, codes, loss, b in SGD_VIEW:
        mxu = bf16 if b else None
        tag = f"{'codes' if codes else 'cohort'}_{loss}_{inc_rows}x{d}" \
            f"_N{N}_view" + ("_bf16" if b else "")
        entries[tag] = _sgd_kernel_case(
            view_gen, "fused_sgd_many_block_grad (off the main path)",
            inc_rows, d, loss, mxu, n_rows=N, codes=codes, view=True)
    results["fused_sgd_many_block_grad"].update(
        entries[f"codes_log_loss_{glm_rows}x{GLM_D}_N{OVR_CLASSES}"],
        kinds=entries)


def device_timeline(fn):
    """(wall ms, union of the device's busy spans in ms, kernel ms, H2D
    copy ms, top kernels) of one call of ``fn`` under torch.profiler.
    The union counts a copy that overlaps a kernel once."""
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
    spans, kern, copy, by_name = [], 0.0, 0.0, {}
    for e in events:
        cat = e.get("cat")
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        t, dur = float(e.get("ts", 0)), float(e.get("dur", 0))
        spans.append((t, t + dur))
        if cat == "kernel":
            kern += dur / 1e3
            name = e.get("name", "?")[:50]
            by_name[name] = by_name.get(name, 0.0) + dur / 1e3
        elif "HtoD" in e.get("name", "") or "Pinned -> Device" in \
                e.get("name", ""):
            copy += dur / 1e3
    busy, end = 0.0, -1.0
    for a, b in sorted(spans):
        if b > end:
            busy += (b - max(a, end)) / 1e3
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return wall, busy, kern, copy, top


def stream_split(est):
    """The stream's own per-pass split of a fit, in ms per pass."""
    tot = est.stream_stats_
    p = tot["passes"]
    return p, {k: 1e3 * tot.get(k, 0.0) / p
               for k in ("host_s", "put_s", "wait_s", "consume_s", "h2d_s",
                         "pass_s")}


def _timeline_line(what, est, timeline):
    wall, busy, kern, copy, top = timeline
    p, split = stream_split(est)
    spans = "; ".join(f"{n} {ms:.1f} ms" for n, ms in top)
    return (f"{what}: wall {wall:.1f} ms, the device busy {busy:.1f} ms "
            f"({busy / wall:.1%}, union of spans), kernels {kern:.1f} ms, "
            f"H2D copies {copy:.1f} ms (torch.profiler); per pass of {p}: "
            f"host copy {split['host_s']:.1f} ms, issuing copies "
            f"{split['put_s']:.2f} ms, waiting for a staging buffer "
            f"{split['wait_s']:.1f} ms, consumer {split['consume_s']:.1f} "
            f"ms, H2D {split['h2d_s']:.1f} ms (CUDA events), pass "
            f"{split['pass_s']:.1f} ms; top kernels: {spans}")


def _write_memmap(tmp, name, X):
    """X (a tensor on the card) into an f32 np.memmap under ``tmp``,
    1M rows at a time; the free space is checked first."""
    nbytes = X.numel() * 4
    free = shutil.disk_usage(tmp).free
    if free < nbytes + (1 << 30):
        raise RuntimeError(f"{tmp} has {free / 1e9:.2f} GB free; the "
                           f"streamed phases need {nbytes / 1e9:.2f} GB")
    path = os.path.join(tmp, name)
    t0 = time.perf_counter()
    mm = np.memmap(path, dtype=np.float32, mode="w+", shape=tuple(X.shape))
    for i in range(0, X.shape[0], 1 << 20):
        mm[i:i + (1 << 20)] = X[i:i + (1 << 20)].cpu().numpy()
    mm.flush()
    del mm
    log(f"memmap {path}: {nbytes / 1e9:.2f} GB written in "
        f"{time.perf_counter() - t0:.2f} s")
    return np.memmap(path, dtype=np.float32, mode="r", shape=tuple(X.shape))


def _timed(fit, n):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def _spread(times):
    return (f"median {statistics.median(times):.3f} s (least "
            f"{min(times):.3f}, most {max(times):.3f}) over {len(times)} fits")


def _peak_check(what, peak, block_bytes, prefetch, extra):
    bound_b = (prefetch + 2) * block_bytes + extra
    log(f"{what}: peak device memory during the fit {peak / 2**20:.1f} MiB, "
        f"bound (stream_prefetch + 2) blocks + accumulators "
        f"{bound_b / 2**20:.1f} MiB (a block {block_bytes / 2**20:.1f} MiB)")
    if peak > bound_b:
        raise AssertionError(f"{what} held more than (prefetch + 2) blocks")


def phase_stream_glm(tmp, X, y, y10, newton_fit, results):
    from dask_ml_tpu_torch import config
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.ops import fused

    mm = _write_memmap(tmp, "glm_X.f32", X)
    y_h, y10_h = y.cpu().numpy(), y10.cpu().numpy()
    prefetch = config.get_config().stream_prefetch
    block_bytes = STREAM_GLM_ROWS * (GLM_D + 1) * 4

    def fit_on(yh, **kw):
        est = LogisticRegression(**kw).fit(mm, yh)
        torch.cuda.synchronize()
        return est

    for solver, kw in [
            ("lbfgs", dict(solver="lbfgs", max_iter=STREAM_LBFGS_ITER,
                           tol=0.0)),
            ("newton", dict(solver="newton", max_iter=STREAM_NEWTON_ITER))]:
        fused.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        est = fit_on(y_h, **kw)
        first = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        launches = fused.launches()
        kinds = dict(fused.fused_glm_stream.kind_launches)
        info = est.solver_info_
        n_blocks = info["n_blocks"]
        if not (info["streamed"] and info["fused_stream"]
                and n_blocks == -(-GLM_N // STREAM_GLM_ROWS)
                and launches["fused_glm_stream"]
                == info["data_passes"] * n_blocks
                and (solver != "newton"
                     or kinds["vgh"] >= est.n_iter_ * n_blocks)):
            raise AssertionError(f"streamed {solver} fit: {info}, launches "
                                 f"{launches}, by kind {kinds}")
        if solver == "lbfgs":
            results["fused_glm_stream"]["launches"] = \
                launches["fused_glm_stream"]
            results["fused_glm_stream"]["launches_by_kind"] = kinds
        else:
            results["fused_glm_stream"]["launches_newton_by_kind"] = kinds
        _peak_check(f"streamed {solver} fit", peak, block_bytes, prefetch,
                    1 << 20)
        times = _timed(lambda: fit_on(y_h, **kw), STREAM_FITS)
        med = statistics.median(times)
        log(f"streamed {solver} fit {GLM_N}x{GLM_D} from a memmap: "
            f"{est.n_iter_} iterations, {info['data_passes']} passes of "
            f"{n_blocks} blocks; first fit {first:.3f} s, {_spread(times)}, "
            f"{GLM_N * est.n_iter_ / med:.4g} samples/s at the median; "
            f"launches {launches['fused_glm_stream']} (by kind {kinds})")
        log(_timeline_line(f"streamed {solver} fit", est,
                           device_timeline(lambda: fit_on(y_h, **kw))))
        twin = fit_on(y_h, solver_kwargs={"use_kernel": False}, **kw)
        d_twin = float(np.abs(est.coef_ - twin.coef_).max())
        d_res = float(np.abs(est.coef_ - newton_fit.coef_).max())
        log(f"streamed {solver} fit: against its use_kernel=False twin "
            f"max|dcoef| {d_twin:.3e} ({twin.n_iter_} iterations); against "
            f"phase 8's resident newton fit {d_res:.3e}")
        if not (np.isfinite(est.coef_).all() and d_twin <= COEF_ATOL
                and (solver != "newton" or d_res <= COEF_ATOL)):
            raise AssertionError(f"streamed {solver} fit disagrees")

    kw = dict(solver="lbfgs", max_iter=STREAM_LBFGS_ITER, tol=0.0)
    fused.reset_launches()
    t0 = time.perf_counter()
    ovr = fit_on(y10_h, **kw)
    elapsed = time.perf_counter() - t0
    launches = fused.launches()
    info = ovr.solver_info_
    results["fused_glm_multi_stream"]["launches"] = \
        launches["fused_glm_multi_stream"]
    if not (info["n_classes"] == OVR_CLASSES and info["fused_stream"]
            and launches["fused_glm_multi_stream"]
            == info["data_passes"] * info["n_blocks"]):
        raise AssertionError(f"streamed one-vs-rest fit: {info}, {launches}")
    twin = fit_on(y10_h, solver_kwargs={"use_kernel": False}, **kw)
    d_twin = float(np.abs(ovr.coef_ - twin.coef_).max())
    log(f"streamed one-vs-rest fit {GLM_N}x{GLM_D} C={OVR_CLASSES} lbfgs: "
        f"{ovr.n_iter_} iterations, {info['data_passes']} passes in "
        f"{elapsed:.3f} s, {GLM_N * ovr.n_iter_ / elapsed:.4g} samples/s; "
        f"launches {launches['fused_glm_multi_stream']}; against its "
        f"use_kernel=False twin ({twin.n_iter_} iterations, "
        f"{twin.solver_info_['data_passes']} passes) max|dcoef| "
        f"{d_twin:.3e}")
    if not (ovr.coef_.shape == (OVR_CLASSES, GLM_D) and d_twin <= COEF_ATOL):
        raise AssertionError("streamed one-vs-rest fit disagrees")
    return mm


def phase_stream_kmeans(tmp, X, blobs_fit, results):
    from dask_ml_tpu_torch import config
    from dask_ml_tpu_torch.cluster import KMeans
    from dask_ml_tpu_torch.ops import fused

    mm = _write_memmap(tmp, "kmeans_X.f32", X)
    init = X[:KM_K].cpu().numpy()
    prefetch = config.get_config().stream_prefetch

    def fit():
        km = KMeans(n_clusters=KM_K, init=init, max_iter=10,
                    tol=0.0).fit(mm)
        torch.cuda.synchronize()
        return km

    fused.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    km = fit()
    first = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    launches = fused.launches()
    n_blocks = -(-KM_N // STREAM_KM_ROWS)
    results["fused_kmeans_block_stats"]["launches"] = \
        launches["fused_kmeans_block_stats"]
    if launches["fused_kmeans_block_stats"] != km.n_iter_ * n_blocks or \
            launches["fused_assign_update"] != n_blocks:
        raise AssertionError(f"streamed KMeans ran {km.n_iter_} iterations "
                             f"with {launches}")
    _peak_check("streamed kmeans fit", peak, STREAM_KM_ROWS * KM_D * 4,
                prefetch, 1 << 20)
    times = _timed(fit, STREAM_FITS)
    med = statistics.median(times)
    log(f"streamed kmeans fit {KM_N}x{KM_D} k={KM_K} from a memmap: "
        f"{km.n_iter_} iterations, {km.stream_stats_['passes']} passes of "
        f"{n_blocks} blocks; first fit {first:.3f} s, {_spread(times)}, "
        f"{km.n_iter_ / med:.4g} iterations/s at the median; launches "
        f"{launches}")
    log(_timeline_line("streamed kmeans fit", km, device_timeline(fit)))
    d_c = float(np.abs(km.cluster_centers_
                       - blobs_fit.cluster_centers_).max())
    agree = float((km.labels_ == blobs_fit.labels_.to_numpy()).mean())
    d_in = abs(km.inertia_ - blobs_fit.inertia_) / blobs_fit.inertia_
    log(f"streamed kmeans fit against phase 5's resident fit on the same "
        f"blobs: max|dcenter| {d_c:.3e}, label agreement {agree:.7f}, "
        f"inertia rel diff {d_in:.3e}, n_iter {km.n_iter_} and "
        f"{blobs_fit.n_iter_}")
    if not (d_c <= 1e-3 and d_in <= 1e-4 and agree == 1.0
            and km.n_iter_ == blobs_fit.n_iter_):
        raise AssertionError("streamed KMeans disagrees with the resident "
                             "fit")
    path = mm.filename
    del mm
    os.remove(path)


def _sgd_twin_check(what, est, twin):
    """An SGD fit against its use_kernel=False twin (SGD_COEF_ATOL)."""
    d_coef = float(np.abs(est.coef_ - twin.coef_).max())
    d_b = float(np.abs(np.asarray(est.intercept_)
                       - np.asarray(twin.intercept_)).max())
    log(f"{what}: against its use_kernel=False twin max|dcoef| {d_coef:.3e}, "
        f"|dintercept| {d_b:.3e}")
    if not (np.isfinite(est.coef_).all() and d_coef <= SGD_COEF_ATOL
            and d_b <= SGD_COEF_ATOL and est._t == twin._t):
        raise AssertionError(f"{what} disagrees with its use_kernel=False "
                             "twin")


def _sgd_launches(what, expect):
    """The counts since the last reset: exactly ``expect`` launches of
    the SGD kernels named there, none of any other kernel."""
    from dask_ml_tpu_torch.ops import fused

    launches = fused.launches()
    want = dict.fromkeys(launches, 0)
    want.update(expect)
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want}")
    return launches


def phase_sgd_fits(gen, X, y, y10, results):
    """Phase 15: bench.py's Incremental protocol on a device-resident
    2M x 128 (one epoch, blocks of 250,000 unshuffled), then
    SGDClassifier(max_iter=5) on phase 4's 4M x 256 and on phase 9's ten
    classes (blocks of 500,000): one kernel launch per block per epoch,
    timed, profiled, each held to its use_kernel=False twin. Returns the
    Incremental data for phase 16."""
    from dask_ml_tpu_torch import config
    from dask_ml_tpu_torch.linear_model import SGDClassifier
    from dask_ml_tpu_torch.ops import fused
    from dask_ml_tpu_torch.parallel import ShardedArray
    from dask_ml_tpu_torch.wrappers import Incremental

    dev = torch.device("cuda")
    Xi = torch.randn((SGD_N, SGD_D), generator=gen, device=dev)
    yi = (Xi[:, 0] + 0.3 * torch.randn(SGD_N, generator=gen, device=dev)
          > 0).float()
    Xs, ys = ShardedArray.from_array(Xi), ShardedArray.from_array(yi)

    def inc_fit():
        inc = Incremental(SGDClassifier(max_iter=1, random_state=0),
                          shuffle_blocks=False).fit(Xs, ys)
        torch.cuda.synchronize()
        return inc

    inc_fit()
    inc_fit()
    fused.reset_launches()
    inc = inc_fit()
    n_blocks = 8                  # grid_partition: at least 8 blocks
    launches = _sgd_launches("Incremental fit",
                             {"fused_sgd_block_grad": n_blocks})
    by_path = {"incremental": launches["fused_sgd_block_grad"]}
    times = _timed(inc_fit, FITS)
    med = statistics.median(times)
    acc = inc.score(Xs, ys)
    oracle = float(((Xi[:, 0] > 0).float() == yi).float().mean())
    log(f"incremental_sgd_samples_per_sec_per_chip {SGD_N / med:.6g} "
        f"(Incremental(SGDClassifier(max_iter=1)), {SGD_N}x{SGD_D} on the "
        f"card, one epoch of {n_blocks} blocks, {_spread(times)}); kernel "
        f"launches {n_blocks}; training accuracy {acc:.4f} (the rule "
        f"x0 > 0: {oracle:.4f})")
    log(busy_line("Incremental fit", *device_busy_ms(inc_fit)))
    with config.set(use_kernel=False):
        twin = inc_fit()
    _sgd_twin_check("Incremental fit", inc.estimator_, twin.estimator_)

    for what, yy, key, kernel in [
            ("SGDClassifier binary", y, "fit_4M", "fused_sgd_block_grad"),
            (f"SGDClassifier {OVR_CLASSES} classes", y10, "multiclass_4M",
             "fused_sgd_many_block_grad")]:
        def fit():
            est = SGDClassifier(max_iter=SGD_EPOCHS, random_state=0).fit(X, yy)
            torch.cuda.synchronize()
            return est

        fit()
        fused.reset_launches()
        est = fit()
        launches = _sgd_launches(what, {kernel: n_blocks * SGD_EPOCHS})
        by_path[key] = launches[kernel]
        times = _timed(fit, FITS)
        med = statistics.median(times)
        log(f"{what} fit {GLM_N}x{GLM_D}, {SGD_EPOCHS} epochs of {n_blocks} "
            f"blocks of {GLM_N // n_blocks} rows: {_spread(times)}, "
            f"{GLM_N * SGD_EPOCHS / med:.4g} samples/s at the median; "
            f"{kernel} launches {launches[kernel]}; training accuracy "
            f"{est.score(X, yy):.4f}; coef_ {est.coef_.shape}")
        log(busy_line(f"{what} fit", *device_busy_ms(fit)))
        with config.set(use_kernel=False):
            twin = fit()
        _sgd_twin_check(f"{what} fit", est, twin)
    results["fused_sgd_block_grad"]["launches"] = by_path["incremental"]
    results["fused_sgd_block_grad"]["launches_by_path"] = {
        k: by_path[k] for k in ("incremental", "fit_4M")}
    results["fused_sgd_many_block_grad"]["launches"] = by_path["multiclass_4M"]
    results["fused_sgd_many_block_grad"]["launches_by_path"] = {
        "multiclass_4M": by_path["multiclass_4M"]}
    return Xi, yi


def phase_sgd_cohort(Xi, yi, results):
    """Phase 16: the batched-trial step, SGDClassifier.
    _batched_fused_calls over 16 models with their own alpha, eta0 and
    penalty through one epoch of the Incremental blocks (250,000 x 128):
    one fused_sgd_many_block_grad launch a block, held to 16 solo
    partial_fit chains over the same blocks, both timed."""
    from dask_ml_tpu_torch.linear_model import SGDClassifier
    from dask_ml_tpu_torch.parallel import ShardedArray

    S = SGD_N // 8
    blocks = [(ShardedArray(Xi[lo:lo + S], S), ShardedArray(yi[lo:lo + S], S))
              for lo in range(0, SGD_N, S)]
    settings = [dict(alpha=a, eta0=e, penalty=p)
                for a in (1e-5, 1e-4, 1e-3, 1e-2) for e in (0.01, 0.05)
                for p in ("l2", "elasticnet")]
    classes = np.array([0.0, 1.0])

    def models():
        ms = [SGDClassifier(**kw) for kw in settings]
        for m in ms:
            m._batch_prepare({"classes": classes})
        return ms

    def cohort():
        ms = models()
        SGDClassifier._batched_fused_calls(ms, blocks)
        torch.cuda.synchronize()
        return ms

    def solo():
        ms = models()
        for m in ms:
            for Xb, yb in blocks:
                m.partial_fit(Xb, yb)
        torch.cuda.synchronize()
        return ms

    from dask_ml_tpu_torch.ops import fused

    cohort()
    fused.reset_launches()
    ms = cohort()
    launches = _sgd_launches("batched-trial step",
                             {"fused_sgd_many_block_grad": len(blocks)})
    results["fused_sgd_many_block_grad"]["launches_by_path"]["cohort"] = \
        launches["fused_sgd_many_block_grad"]
    ref = solo()
    d_w = max(float((a._w - b._w).abs().max()) for a, b in zip(ms, ref))
    times_c = _timed(cohort, FITS)
    times_s = _timed(solo, 3)
    log(f"batched-trial step, {len(settings)} models through one epoch of "
        f"{len(blocks)} blocks of {S}x{SGD_D}: {_spread(times_c)}, "
        f"{len(blocks)} launches of fused_sgd_many_block_grad; 16 solo "
        f"partial_fit chains {_spread(times_s)} ({len(blocks) * 16} launches "
        f"of fused_sgd_block_grad); max|dW| against the chains {d_w:.3e}")
    if not (d_w <= SGD_COEF_ATOL and all(a._t == b._t == len(blocks)
                                         for a, b in zip(ms, ref))):
        raise AssertionError("the batched-trial step disagrees with the solo "
                             "partial_fit chains")


def phase_stream_sgd(mm, y_h, results):
    """Phase 17: SGDClassifier(max_iter=3) streamed from phase 12's
    memmap (fit_block_rows: 16 blocks of 262,144 rows): one launch per
    block per epoch, timed, the per-pass split, the peak device memory
    against (stream_prefetch + 2) blocks, held to its use_kernel=False
    twin."""
    from dask_ml_tpu_torch import config
    from dask_ml_tpu_torch.linear_model import SGDClassifier
    from dask_ml_tpu_torch.ops import fused

    prefetch = config.get_config().stream_prefetch

    def fit():
        est = SGDClassifier(max_iter=STREAM_SGD_EPOCHS, random_state=0,
                            shuffle=False).fit(mm, y_h)
        torch.cuda.synchronize()
        return est

    fused.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    est = fit()
    first = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    n_blocks = est.solver_info_["n_blocks"]
    if not (est.solver_info_["streamed"] and est.solver_info_["fused_stream"]
            and n_blocks == -(-GLM_N // STREAM_GLM_ROWS)):
        raise AssertionError(f"streamed SGD fit: {est.solver_info_}")
    launches = _sgd_launches("streamed SGD fit", {
        "fused_sgd_block_grad": n_blocks * STREAM_SGD_EPOCHS})
    results["fused_sgd_block_grad"]["launches_by_path"]["streamed"] = \
        launches["fused_sgd_block_grad"]
    _peak_check("streamed SGD fit", peak, STREAM_GLM_ROWS * (GLM_D + 1) * 4,
                prefetch, 1 << 20)
    times = _timed(fit, STREAM_FITS)
    med = statistics.median(times)
    log(f"streamed_sgd_samples_per_sec_per_chip "
        f"{GLM_N * STREAM_SGD_EPOCHS / med:.6g} (SGDClassifier(max_iter="
        f"{STREAM_SGD_EPOCHS}) from the {GLM_N}x{GLM_D} memmap, "
        f"{n_blocks} blocks a pass; first fit {first:.3f} s, "
        f"{_spread(times)}); launches {launches['fused_sgd_block_grad']}")
    log(_timeline_line("streamed SGD fit", est, device_timeline(fit)))
    with config.set(use_kernel=False):
        twin = fit()
    _sgd_twin_check("streamed SGD fit", est, twin)


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

    t_start = time.perf_counter()
    name = phase_device()
    phase_build()
    results = {
        k: {"name": k, "route": "cuda", "source": src, "replaces": rep}
        for k, (_, src, rep) in fused.KERNELS.items()
    }
    gen = torch.Generator(device="cuda").manual_seed(0)
    # the SGD phases draw from their own generator, so the earlier phases
    # see the same data as before they were added
    sgd_gen = torch.Generator(device="cuda").manual_seed(4)
    phase_glm_kernel(gen, results)
    phase_lloyd_kernels(gen, results)
    phase_newton_kernel(gen, results)
    phase_multi_kernel(gen, results)
    phase_stream_kernels(gen, results)
    phase_sgd_kernels(sgd_gen, results)
    X, y, lbfgs_fit = phase_glm_fit(gen, results)
    phase_glm_fit_bf16(X, y, results)
    newton_fit = phase_newton_fit(X, y, lbfgs_fit, results)
    phase_admm_fit(X, y)
    y10 = phase_ovr_fit(gen, X, results)
    Xi, yi = phase_sgd_fits(sgd_gen, X, y, y10, results)
    phase_sgd_cohort(Xi, yi, results)
    del Xi, yi
    with tempfile.TemporaryDirectory() as tmp:
        mm = phase_stream_glm(tmp, X, y, y10, newton_fit, results)
        phase_stream_sgd(mm, y.cpu().numpy(), results)
        path = mm.filename
        del mm
        os.remove(path)
        del X, y, y10
        torch.cuda.empty_cache()
        X, blobs_fit = phase_kmeans_fit(gen, results)
        phase_stream_kmeans(tmp, X, blobs_fit, results)
        del X
        torch.cuda.empty_cache()
    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
