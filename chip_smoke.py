#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dask_ml_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each raising on failure (nothing is caught):

1. device: the card's name and power limit; TF32 off;
2. build: every kernel of the port from ``dask_ml_tpu_torch/csrc`` with
   nvcc for sm_90a, timed, with what ``-Xptxas -v`` reports, and the
   host libraries (the native block reader, the CSV loader) with the
   host compiler;
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
   largest coefficient;
19. the decomposition path in device memory: bench.py's _bench_rsvd
   protocol on the port (TruncatedSVD(n_components=32,
   algorithm="randomized", n_iter=4, random_state=0) on 1M x 512 N(0, 1)
   f32, one cold fit, then the median of DECOMP_FITS warm fits, printed
   as randomized_svd_seconds) with the device's busy share; then on a
   1M x 512 matrix of 32 decaying directions plus noise, TruncatedSVD
   tsqr and PCA(svd_solver="full") held to the card's float64 QR + SVD,
   TruncatedSVD randomized and PCA(n_components=32,
   svd_solver="randomized") to those, on the top 32 singular values and
   |components|; IncrementalPCA(n_components=32) against PCA at
   tests/test_pca.py's tolerances, and a transform/inverse_transform
   round trip; each fit timed;
20. the streamed decomposition path from an np.memmap of phase 19's
   matrix (2.05 GB, stream_plan's blocks): PCA() by the Gram pass,
   PCA(n_components=32, svd_solver="randomized") and TruncatedSVD(32,
   algorithm="randomized"), each timed, its passes and per-pass split,
   its peak device memory against (stream_prefetch + 2) blocks and its
   carries, held to phase 19's resident fit;
21. the search paths: bench.py's HyperbandSearchCV(SGDClassifier) on
   400,000 x 128 host rows (36 grid points, max_iter=27,
   aggressiveness=3) on the streamed cohort plane, one
   fused_sgd_many_block_grad launch a block step and no other kernel,
   held to the device-resident plane (search_stream=False: equal
   best_params_, best_score_ within 1e-6) and to its use_kernel=False
   twin (the same candidates, calls and winner, test scores within 2 /
   n_test), printed as hyperband_seconds and hyperband_rows_per_sec
   (warm, median of 3, both planes); bench.py's GridSearchCV over
   LogisticRegression(lbfgs, max_iter=20, tol=0) on 1M x 64 on the card
   with eight Cs and cv=2: the C-grid fast path
   (c_grid_search_seconds) held to the general path (one kernel-1 fit a
   candidate and fold; mean_test_score within 2e-3, the same best C);
22. the Lloyd kernels at SpectralClustering's embedding width:
   fused_lloyd_stats and fused_assign_update on 1M unit rows at d = k = 8
   and d = k = 10, and at d = 10 on a row view that starts off a 16-byte
   boundary (LLOYD_NARROW), against their plain versions by phase 3's
   rules, two runs bit-equal, kernel, plain and bound times;
23. the rest of the estimator surface: make_classification(4M, 256)
   timed; 1 % of its entries NaN, then SimpleImputer(mean) ->
   StandardScaler -> LogisticRegression(lbfgs, max_iter=50, tol=0), its
   kernel-1 launches (at least one an iteration), the device's busy share,
   coef_ against its plain-loss twin within COEF_ATOL, statistics_,
   mean_ and var_ against float64 numpy; RobustScaler's sketch within a
   bin width of the exact quantiles; QuantileTransformer (uniform and
   normal) against a float64 np.interp replay of its quantiles_;
   GaussianNB's fit against its partial_fit in 500,000-row blocks;
   ColumnTransformer (StandardScaler, and OneHotEncoder on four columns
   of 50 codes, equal to numpy's one-hot) into LogisticRegression (kernel
   1); PolynomialFeatures(degree=2) on 1M x 16 against float64;
   BlockwiseVotingClassifier(LogisticRegression(lbfgs, max_iter=20)) on
   the host matrix (eight members, kernel 1), its votes against a host
   recompute from the members' coef_; SpectralClustering(n_clusters=8) on
   make_blobs(1M, 64, centers=8), the blobs recovered on 99.9 % of the
   rows and kernels 2 and 10 launched; each step timed, and whether
   pandas is importable logged (no pandas path runs);
24. sparse streams, bench.py's _bench_sparse_stream at its on-chip height:
   a 120,000 x 16,384 CSR corpus of 163 nonzeros a row (seed 11,
   duplicates kept) in blocks of 1,024 rows; SGDClassifier(max_iter=2),
   LogisticRegression(gradient_descent, max_iter=3), a 10-class
   one-vs-rest lbfgs fit (max_iter=3) and KMeans(k=16, 5 iterations) on
   the nnz route (no kernel launches: the sparse products of
   ops/sparse_kernels.py), each run twice and bit-equal, each held to its
   densify-route twin (kernels 5, 6, 7 and 9 on 16,384-wide blocks),
   printed as streamed_sparse_sgd_rows_per_sec and
   streamed_sparse_glm_rows_per_sec (per pass, as bench.py) beside the
   densify route's rows/s, with the per-pass split and the device's busy
   share; Newton on 500,000 x 512 at 10 nonzeros a row, kernel 6 vgh on
   blocks scattered dense on the card, held to its densify twin; every
   nnz-route fit must report solver_info_["sparse_stream"];
25. hashed text: 200,000 documents of 100 Zipf tokens through the port's
   HashingVectorizer (2^20 columns; docs/s printed) into
   SGDClassifier(max_iter=2) and LogisticRegression(lbfgs, max_iter=10)
   on the nnz route, timed, the peak device memory far below one dense
   block, the decision values held to scipy's float64 product;
26. checkpoints and reliability, in four parts beside the phases whose
   fits are its controls, every checkpoint under the temporary directory
   of the memmaps (its filesystem printed): after phase 4, the resident
   lbfgs fit in chunks of 10 iterations, killed after its second save
   and resumed at iteration 20, bit-equal to phase 4's fit; after phase
   16, Incremental(SGDClassifier) on phase 15's 2M x 128 from host
   memory, two checkpointed passes and a fresh wrapper's resumed third,
   bit-equal to three plain passes; after phase 17, phase 12's streamed
   lbfgs fit with and without pass checkpoints, in turns (each bit-equal
   to phase 12's, timed), killed by
   superblock_dispatch:crash in pass 12 and resumed (bit-equal, the
   passes saved and run adding up to the control's), phase 17's SGD
   shuffled over 3 epochs killed in epoch 2 and resumed (bit-equal),
   staging_read:io@3 retried once to a bit-equal fit, staging_read:nan@3
   raising NonFiniteBlock under stream_nonfinite="raise" and
   quarantining one block under "quarantine" (a finite fit, the memmap
   untouched), and the first pass's host fill with the training profile
   off and on and a pass under "raise" against "off", in turns; after
   phase 13, its streamed KMeans killed in its last Lloyd pass and
   resumed, and phase 5's blobs fit saving every iteration, killed after
   its first save and resumed, centers, inertia_ and n_iter_ bit-equal;
   the checkpoint saves' median and largest ms;
27. serving, in four parts, every entry point replaying one CUDA graph
   per bucket: after phase 26's Incremental part, (c) a 2-replica
   FleetServer over a ModelRegistry serving (a)'s request mix from 4
   client threads while serve_while_training runs 3 Incremental(
   SGDClassifier) passes on phase 15's 2M x 128 (kernel 5, 8 launches a
   pass, printed), each answer equal to the prediction of a version live
   while it was served, no capture across the publishes, then a
   replica_worker:crash plan under serving_supervise (every request
   answered or failed typed, the replica rebuilt); after phase 5, (d)
   its blobs KMeans served, labels equal to predict; after phase 25,
   (a) bench.py's _bench_serving on the card (LogisticRegression(lbfgs,
   max_iter=20) on 200,000 x 128, 400 requests of log-uniform 1-256 rows
   from RandomState(11), 8 client threads, BucketLadder(8, 512, 2.0), a
   1 ms window): serving_throughput_rows_per_sec, p50 and p99, batches,
   the naive per-request predict loop's rows/s and the device's busy
   share, every answer equal to predict (rows with |margin| <= 1e-5
   left out and counted), no capture after warmup(), and the sparse
   entry point on 512 CSR rows; then (b) bench.py's _bench_int8_serving
   (400,000 x 64, batches of 4096, 30 repeats, best of 3): f32 and int8
   rows/s and the agreement, at least 0.995;
28. processes: two real processes on the one card (this script with
   ``--process-rank R SPEC``), a gloo group over a file store in the
   phase's temporary directory, each loading the kernels the parent
   built into dask_ml_tpu_torch/_build/ and streaming its own half of
   each memmap (full widths, depth cut: 2 x 1M x 256 for the GLM, 2 x 1M
   x 128 for KMeans, 2 x 500,000 x 128 for SGD, 2 x 250,000 x 512 for
   PCA): streamed lbfgs (phase 12's max_iter=10, tol=0) and Newton,
   the resident lbfgs over array_from_process_local, streamed and
   resident KMeans (k = 64, an init array), the grad-accum SGD
   (stream_grad_accum=2), the streamed Gram PCA and a GridSearchCV
   striped over the two ranks, each held to
   the parent's single-process fit of the concatenated data (coef_
   5e-4; centers 1e-3, inertia 1e-4, n_iter_ equal; the SGD fit of the
   same group order 1e-5; PCA 1e-4 of the largest singular value; the
   search's scores equal); in each process the launches (kernel 6:
   passes x local blocks), two psum_host runs bit-equal on both ranks,
   and a pass_barrier:hang plan on rank 1 under stream_sync_timeout_s=5
   ending rank 0 with StreamSyncTimeout; the two-process walls against
   the single-process walls, psum_host ms and the barrier's wait per
   pass; kernels 1, 2, 5, 6, 9 and 10 must launch in each process.
   Uneven and empty ranks: a streamed lbfgs (tol 1e-4) and a streamed
   KMeans where rank 1 holds 100,000 rows against rank 0's 1,000,000,
   ndarrays under stream_block_rows=261,123 (rank 1 alone would not
   stream: the fits agree on the route), kernels 6 and 9 launching on
   both ranks; a resident lbfgs and KMeans over array_from_process_local
   with 1,000,000 and 0 rows; each held to the single-process fit of
   the same rows at the gates above, n_iter_ equal;
29. feature sharding: two processes on the card under mesh_shape="1x2",
   both opening one memmap of 1,000,000 x 512 f32 (2.05 GB; bench.py's
   _mesh2d_measure width), each staging its 256-column tile: the
   single-process streamed lbfgs refused by stream_device_byte_budget
   (StreamBudgetExceeded) that the 1x2 fit runs under; the streamed
   lbfgs (max_iter=10, tol=1e-4, passes equal), one-vs-rest lbfgs (C =
   10), Newton on 250,000 rows (max_iter=3), randomized PCA (k = 16),
   the resident lbfgs over ShardedArray.from_array(shard_features=True)
   and the resident KMeans on 250,000 x 512 blobs (k = 16, 10
   iterations, an init array; phase 28's data scale), each
   held to the parent's single-process fit at full width at phase 28's
   gates; per fit the walls, the model and data collectives' calls,
   bytes and ms per pass, each rank's peak device memory against the
   twin's, with the card's name and power limit. No kernel launches on
   these paths (JAX keeps its kernels off this layout);
30. observability, in three parts: (a) after phase 26's streamed part,
   phase 4's lbfgs fit and phase 12's streamed lbfgs fit from its memmap
   with every observability knob on (metrics_path, obs_programs,
   obs_http_port on a free port, watchdog_timeout_s), a second thread
   scraping /metrics (each line Prometheus text), /status and /healthz
   while each runs; (b) after phase 26's KMeans part, phase 5's KMeans
   on the blobs alike; each fit bit-equal to its plain twin (coef_,
   intercept_, n_iter_; cluster_centers_, inertia_, n_iter_), every
   launch of kernels 1, 6, 2 and 10 timed by the kernel registry; (c) a
   span held open past watchdog_timeout_s=0.5 giving exactly one stall
   record with stacks, then the gates over the JSONL (one step record a
   lbfgs or Lloyd iteration, one stream.pass span a pass, a fit span a
   fit, a counters record), every registry row within 1.05 of its bound,
   kernel 1's median time in the fit within 25 % of phase 3's, /status
   having shown an open fit span and the device memory gauges, the
   report CLI and its --json (kernels 1 and 2 with bound and share) and
   the Chrome trace holding the fit spans; the instrumented walls over
   the plain ones, with obs_programs on and off, printed.

Phases 12, 13, 17 and 20 fail unless the native block reader read X
on every pass of every streamed fit (``stats["reader"] == "native"``);
phase 12's streamed lbfgs fit must take its 25 passes.

Phases 3 and 14 name the walk of csrc/glm_value_grad.cu
(ops/fused.py::glm_value_walk) that each GLM value and SGD step line
took. The phases run in the order 1-3, 22, 6, 7, 11, 14, 4, 26, 18, 8, 10,
9, 15, 16, 26, 27, 12, 17, 26, 30, 5, 27, 13, 26, 30, 19, 20, 21, 23,
24, 25, 27, 28, 29. The launch
counts are set to 0 just before each main path and read just after it.
The line before the last is a JSON object with one entry per kernel;
the last line is ``{"ok": true, "device": {...}}``. Without a CUDA
device, or without the package beside it, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import itertools
import json
import os
import re
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
# the decomposition paths (phases 19 and 20): bench.py's _bench_rsvd shape
# (1M x 512, k = 32, n_iter = 4), warm fits timed after a cold one; the
# gated matrix's signal has DECOMP_K directions with singular values
# 20 * DECOMP_DECAY**i * sqrt(n) over noise of DECOMP_NOISE (singular
# values about DECOMP_NOISE * (sqrt(n) + sqrt(d)), 5 % of the smallest)
DECOMP_N, DECOMP_D, DECOMP_K = 1_000_000, 512, 32
DECOMP_FITS = 3
DECOMP_DECAY = 0.93
DECOMP_NOISE = 0.1
STREAM_DECOMP_FITS = 2
# a decomposition against the card's float64 QR + SVD of the same matrix,
# and a randomized or streamed fit against its exact twin, on the top
# DECOMP_K directions: singular values to 1e-4 of the largest (an f32 QR
# of 1M rows errs by about 1e-5 of the matrix's norm, whatever the
# value), |components| to 1e-3 (well separated values: about 1e-5);
# IncrementalPCA against PCA at tests/test_pca.py's tolerances
DECOMP_S_RTOL = 1e-4
DECOMP_COMP_ATOL = 1e-3
IPCA_MEAN_ATOL = 1e-3
IPCA_S_RTOL = 5e-2
IPCA_COMP_ATOL = 0.05
# an inverse_transform of all d components against X, to this share of
# the largest |X|: f32 components are orthonormal to about 1e-6 per
# entry, and a row's 512-term f32 sums carry its norm's rounding
DECOMP_ROUND_TRIP_RTOL = 1e-3
# the streamed lbfgs fit's passes: the reader hands the kernels the bytes
# the copy did, so the fit takes the parent's passes
STREAM_LBFGS_PASSES = 25
# the search paths (phase 21): bench.py's _bench_hyperband shape (400,000
# x 128 host rows, a 6 x 6 grid, max_iter 27, aggressiveness 3) and its
# _bench_c_grid_search shape (1M x 64 on the card, eight Cs, cv=2); warm
# searches timed after one untimed
HB_N, HB_D = 400_000, 128
HB_PARAMS = {"alpha": [1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 1e-2],
             "eta0": [0.01, 0.03, 0.05, 0.1, 0.3, 0.5]}
HB_MAX_ITER = 27
CG_N, CG_D = 1_000_000, 64
CG_CS = [10.0 ** e for e in range(-4, 4)]
SEARCH_RUNS = 3
# the two planes' best score (bench.py:1588-1592); the C-grid fast path
# against the general path (tests/model_selection/test_search.py:299-303)
HB_BEST_ATOL = 1e-6
CG_SCORE_ATOL = 2e-3
# an SGD fit against its use_kernel=False twin: the same steps on the
# same blocks, each block's sums added in another order (f32 noise over
# at most 48 steps of a learning rate of 0.01 or less)
SGD_COEF_ATOL = 1e-5
# hinge's residual jumps at a margin of 1: a row whose margin lies within
# this of 1 (relative to |eta|) may land on the other side in another
# summation order, moving the gradient by its largest |x| entry
HINGE_TIE_RTOL = 1e-5
# phase 22: the Lloyd kernels at SpectralClustering's embedding width
# (rows, d = k = n_clusters, row offset of the view: 1 starts the first
# row 40 bytes into an aligned buffer, off a 16-byte boundary)
LLOYD_NARROW = [(1_000_000, 8, 8, 0), (1_000_000, 10, 10, 0),
                (1_000_000, 10, 10, 1)]
# phase 23: the estimator surface at bench.py's width (4M x 256 from
# make_classification), NaN_SHARE of its entries missing; the fitted
# statistics against float64 numpy reductions of the host matrix, to
# STAT_RTOL of each column's scale (|mean| + std); the sketch quantiles
# within SKETCH_BINS of one bin width, (max - min) / 4096, of the exact
# ones; QuantileTransformer against a float64 np.interp replay of its own
# quantiles_ on QT_ROWS rows, to QT_ATOL: the normal output through the
# normal CDF, against the replay's uniform output clipped at the f32
# bounds the transformer clips at (ppf's slope near 1 turns the 6e-8 ulp
# of the f32 uniform value into more than 1e-5);
# GaussianNB's fit against its partial_fit in NB_BLOCK-row blocks, theta_
# and var_ to NB_RTOL of the class's sqrt(E[x^2]) and E[x^2] (the f32
# E[x^2] - mean^2 of both), predictions equal on all but NB_PRED_SHARE
# of the rows; the one-hot of CT_CODES integer-coded columns of CT_LEVELS
# codes; PolynomialFeatures(degree=2) on POLY_N x POLY_D against float64
# (POLY_RTOL); SpectralClustering on make_blobs(SPEC_N, SPEC_D, centers=
# SPEC_K) with gamma = 1 / (2 SPEC_D) (within-blob affinities about
# exp(-1)), its labels matching the blobs on SPEC_AGREE of the rows
NAN_SHARE = 0.01
STAT_RTOL = 1e-5
SKETCH_BINS = 1.0
QT_ROWS = 100_000
QT_ATOL = 1e-6
NB_BLOCK = 500_000
NB_RTOL = 1e-5
NB_PRED_SHARE = 1e-4
CT_CODES, CT_LEVELS = 4, 50
POLY_N, POLY_D = 1_000_000, 16
POLY_RTOL = 1e-6
BLOCKWISE_ITER = 20
SPEC_N, SPEC_D, SPEC_K = 1_000_000, 64, 8
SPEC_AGREE = 0.999
# phase 24: bench.py's _bench_sparse_stream at its on-chip height (n =
# 120,000, d = 2^14, d // 100 column draws a row, blocks of 1,024 rows),
# the fits' sizes, the 10-class one-vs-rest and KMeans sizes, and the
# Newton corpus; an nnz-route fit against its densify-route twin within
# SPARSE_ROUTE_ATOL (coef_, intercept_, cluster_centers_: the same steps,
# their sums in another order), Newton within NEWTON_ROUTE_ATOL
SPARSE_N, SPARSE_D = 120_000, 2 ** 14
SPARSE_NPR = SPARSE_D // 100
SPARSE_BLOCK = 1024
SPARSE_EPOCHS, SPARSE_GLM_ITER, SPARSE_OVR_ITER = 2, 3, 3
SPARSE_KM_K, SPARSE_KM_ITER = 16, 5
SPARSE_NEWTON_N, SPARSE_NEWTON_D, SPARSE_NEWTON_NPR = 500_000, 512, 10
SPARSE_ROUTE_ATOL = 1e-4
NEWTON_ROUTE_ATOL = 1e-4
# KMeans: the centers as phase 13's gate, the inertia within
# SPARSE_KM_INERTIA_RTOL. On this corpus (uniform random rows, no
# clusters) a row's nearest centers often tie within the cross term's
# rounding, so the two routes' labels part on about 1.5 % of the rows
# (measured) and a center moves by about 1/count; the share is logged
SPARSE_KM_ATOL = 1e-3
SPARSE_KM_INERTIA_RTOL = 1e-5
# phase 25: hashed text at HashingVectorizer's default 2^20 columns
TEXT_DOCS, TEXT_TOKENS, TEXT_VOCAB = 200_000, 100, 50_000
TEXT_BLOCK = 4096


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


SMI = ""    # the card's name and power limit, as nvidia-smi prints them


def phase_device():
    global SMI
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    SMI = smi
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {name} x{torch.cuda.device_count()}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    log(smi)
    return name


def phase_build():
    from dask_ml_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build(_build.SOURCES + _build.HOST_SOURCES)
    log(f"build: {len(libs)} libraries in "
        f"{time.perf_counter() - t0:.2f} s ({_build.nvcc_path()}; "
        f"{_build.cxx_path()} for {', '.join(_build.HOST_SOURCES)})")
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


def _reader_check(what, est):
    """Every pass of the fit read X through the native block reader
    (``stats["reader"] == "native"``): raises otherwise."""
    tot = est.stream_stats_
    if tot["reader_passes"] != {"native": tot["passes"]}:
        raise AssertionError(f"{what}: X's route per pass "
                             f"{tot['reader_passes']}, not the native reader "
                             f"on all {tot['passes']} passes")
    log(f"{what}: X read by the native block reader on all "
        f"{tot['passes']} passes")


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
        _reader_check(f"streamed {solver} fit", est)
        if solver == "lbfgs":
            if info["data_passes"] != STREAM_LBFGS_PASSES:
                raise AssertionError(
                    f"streamed lbfgs fit took {info['data_passes']} passes, "
                    f"not {STREAM_LBFGS_PASSES}")
            results["fused_glm_stream"]["launches"] = \
                launches["fused_glm_stream"]
            results["fused_glm_stream"]["launches_by_kind"] = kinds
        else:
            results["fused_glm_stream"]["launches_newton_by_kind"] = kinds
        _peak_check(f"streamed {solver} fit", peak, block_bytes, prefetch,
                    1 << 20)
        times = _timed(lambda: fit_on(y_h, **kw), STREAM_FITS)
        med = statistics.median(times)
        if solver == "lbfgs":
            # phase 26's control
            lbfgs = {"fit": est, "median_s": med,
                     "launches": sum(launches.values())}
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
    _reader_check("streamed one-vs-rest fit", ovr)
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
    return mm, lbfgs


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
    _reader_check("streamed kmeans fit", km)
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
    return mm, km


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
    _reader_check("streamed SGD fit", est)
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


def _decomp_gaps(est, s_ref, comp_ref):
    """(largest gap of the top DECOMP_K singular values relative to the
    largest, largest gap of their |components|) of ``est`` against a
    reference."""
    k = DECOMP_K
    s = np.asarray(est.singular_values_[:k], np.float64)
    d_s = float(np.max(np.abs(s - s_ref[:k])) / s_ref[0])
    d_c = float(np.max(np.abs(np.abs(est.components_[:k])
                              - np.abs(comp_ref[:k]))))
    return d_s, d_c


def _decomp_gate(what, est, s_ref, comp_ref, ref_name):
    d_s, d_c = _decomp_gaps(est, s_ref, comp_ref)
    log(f"{what} against {ref_name}: top {DECOMP_K} singular values "
        f"{d_s:.3e} of the largest (tolerance {DECOMP_S_RTOL}), "
        f"|components| {d_c:.3e} "
        f"({DECOMP_COMP_ATOL})")
    if not (np.isfinite(est.components_).all() and d_s <= DECOMP_S_RTOL
            and d_c <= DECOMP_COMP_ATOL):
        raise AssertionError(f"{what} disagrees with {ref_name}")


def _decomp_matrix(gen):
    """DECOMP_N x DECOMP_D on the card: DECOMP_K directions of a decaying
    spectrum, noise and a mean offset."""
    dev = gen.device
    n, d, k = DECOMP_N, DECOMP_D, DECOMP_K
    basis = torch.linalg.qr(torch.randn((d, k), generator=gen,
                                        device=dev))[0].T
    scale = 20.0 * DECOMP_DECAY ** torch.arange(k, device=dev)
    X = (torch.randn((n, k), generator=gen, device=dev) * scale) @ basis
    X += DECOMP_NOISE * torch.randn((n, d), generator=gen, device=dev)
    X += torch.randn(d, generator=gen, device=dev)
    return X


def _f64_svd(X, center):
    """The card's float64 QR + SVD of X (centered when ``center``): (s,
    Vt) as host float64."""
    x = X.double()
    if center:
        x -= x.mean(0)
    r = torch.linalg.qr(x, mode="r")[1]
    del x
    _, s, vt = torch.linalg.svd(r)
    return s.cpu().numpy(), vt.cpu().numpy()


def phase_decomposition(gen):
    """Phase 19: bench.py's _bench_rsvd protocol (randomized_svd_seconds)
    on 1M x 512 N(0, 1), then the gated fits on a matrix of that size
    with a decaying spectrum, held to the card's float64 QR + SVD:
    TruncatedSVD tsqr, PCA full and PCA randomized (and TruncatedSVD
    randomized) on the top 32 directions, IncrementalPCA against PCA,
    and a transform/inverse_transform round trip. Returns the gated
    matrix and its exact fits."""
    from dask_ml_tpu_torch.decomposition import (PCA, IncrementalPCA,
                                                 TruncatedSVD)

    n, d, k = DECOMP_N, DECOMP_D, DECOMP_K
    X = torch.randn((n, d), generator=gen, device=gen.device)

    def rsvd():
        return TruncatedSVD(n_components=k, algorithm="randomized",
                            n_iter=4, random_state=0)

    t0 = time.perf_counter()
    rsvd().fit(X)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    ests = []
    times = _timed(lambda: ests.append(rsvd().fit(X)), DECOMP_FITS)
    est = ests[-1]
    if not np.isfinite(est.singular_values_).all():
        raise AssertionError("randomized SVD gave non-finite values")
    med = statistics.median(times)
    flops = 2.0 * n * d * (k + 10) * (2 * 4 + 2)
    log(f"randomized_svd_seconds {med:.6g} (bench.py's _bench_rsvd: "
        f"TruncatedSVD(n_components={k}, algorithm='randomized', n_iter=4, "
        f"random_state=0) on {n}x{d} N(0, 1) f32; cold fit {cold:.3f} s, "
        f"{_spread(times)}; {flops / med / 1e12:.3f} TFLOP/s by bench.py's "
        f"flop model)")
    log(busy_line("randomized svd fit", *device_busy_ms(
        lambda: rsvd().fit(X))))
    del X, est
    torch.cuda.empty_cache()

    X = _decomp_matrix(gen)
    t0 = time.perf_counter()
    s_u, vt_u = _f64_svd(X, center=False)
    s_c, vt_c = _f64_svd(X, center=True)
    torch.cuda.synchronize()
    log(f"float64 QR + SVD of the gated {n}x{d} matrix, uncentered and "
        f"centered: {time.perf_counter() - t0:.3f} s; top singular values "
        f"{s_c[0]:.1f} ... {s_c[k - 1]:.1f}, then {s_c[k]:.1f}")
    fits = {}
    for name, make in [
            ("TruncatedSVD tsqr", lambda: TruncatedSVD(n_components=k,
                                                       algorithm="tsqr")),
            ("TruncatedSVD randomized", lambda: TruncatedSVD(
                n_components=k, algorithm="randomized", n_iter=4,
                random_state=0)),
            ("PCA full", lambda: PCA(svd_solver="full")),
            ("PCA randomized", lambda: PCA(n_components=k,
                                           svd_solver="randomized",
                                           random_state=0)),
            ("IncrementalPCA", lambda: IncrementalPCA(n_components=k))]:
        make().fit(X)
        torch.cuda.synchronize()
        ests = []
        times = _timed(lambda: ests.append(make().fit(X)), DECOMP_FITS)
        fits[name] = ests[-1]
        log(f"{name} fit {n}x{d}: {_spread(times)}")
    _decomp_gate("TruncatedSVD tsqr", fits["TruncatedSVD tsqr"], s_u, vt_u,
                 "the float64 QR + SVD")
    _decomp_gate("PCA full", fits["PCA full"], s_c, vt_c,
                 "the float64 QR + SVD of the centered matrix")
    exact = fits["TruncatedSVD tsqr"]
    _decomp_gate("TruncatedSVD randomized", fits["TruncatedSVD randomized"],
                 exact.singular_values_, exact.components_,
                 "TruncatedSVD tsqr")
    exact = fits["PCA full"]
    _decomp_gate("PCA randomized", fits["PCA randomized"],
                 exact.singular_values_, exact.components_, "PCA full")
    ipca = fits["IncrementalPCA"]
    d_mean = float(np.abs(ipca.mean_ - exact.mean_).max())
    d_s = float(np.max(np.abs(ipca.singular_values_ - exact.singular_values_
                              [:k]) / exact.singular_values_[:k]))
    d_c = float(np.abs(np.abs(ipca.components_ @ exact.components_[:k].T)
                       - np.eye(k)).max())
    log(f"IncrementalPCA against PCA full: |dmean| {d_mean:.3e} (tolerance "
        f"{IPCA_MEAN_ATOL}), singular values rel {d_s:.3e} ({IPCA_S_RTOL}), "
        f"|components . ref| off the identity {d_c:.3e} ({IPCA_COMP_ATOL})")
    if not (d_mean <= IPCA_MEAN_ATOL and d_s <= IPCA_S_RTOL
            and d_c <= IPCA_COMP_ATOL):
        raise AssertionError("IncrementalPCA disagrees with PCA")
    scores = exact.transform(X)
    back = exact.inverse_transform(scores).data
    d_back = float((back - X).abs().max() / X.abs().max())
    log(f"PCA full transform/inverse_transform round trip: max|dX| "
        f"{d_back:.3e} of max|X| (tolerance {DECOMP_ROUND_TRIP_RTOL}); "
        f"scores {tuple(scores.shape)}")
    if not d_back <= DECOMP_ROUND_TRIP_RTOL:
        raise AssertionError("PCA round trip does not return X")
    del scores, back
    log(busy_line("PCA randomized fit", *device_busy_ms(
        lambda: PCA(n_components=k, svd_solver="randomized",
                    random_state=0).fit(X))))
    return X, fits


def phase_stream_decomposition(tmp, X, fits):
    """Phase 20: the streamed decomposition fits from a memmap of phase
    19's gated matrix (2.05 GB, stream_plan's blocks): PCA() by the Gram
    pass, PCA(32, randomized) and TruncatedSVD(32, randomized), each
    timed, read by the native reader on every pass, its per-pass split
    and peak device memory against (stream_prefetch + 2) blocks and its
    carries, held to phase 19's resident fit."""
    from dask_ml_tpu_torch import config
    from dask_ml_tpu_torch.decomposition import PCA, TruncatedSVD
    from dask_ml_tpu_torch.parallel.streaming import stream_plan

    mm = _write_memmap(tmp, "decomp_X.f32", X)
    del X
    torch.cuda.empty_cache()
    n, d, k = DECOMP_N, DECOMP_D, DECOMP_K
    prefetch = config.get_config().stream_prefetch
    rows = stream_plan(mm)
    block_bytes = rows * d * 4
    kp = k + 10
    for name, make, passes, extra, ref in [
            ("PCA gram", lambda: PCA(), 1, 4 * d * d * 8, "PCA full"),
            ("PCA randomized", lambda: PCA(n_components=k,
                                           svd_solver="randomized",
                                           random_state=0),
             1 + 2 + 1, 4 * (rows + kp) * kp * 4 + 2 * d * kp * 4,
             "PCA full"),
            ("TruncatedSVD randomized", lambda: TruncatedSVD(
                n_components=k, algorithm="randomized", random_state=0),
             1 + 5 + 1, 4 * (rows + kp) * kp * 4 + 2 * d * kp * 4,
             "TruncatedSVD tsqr")]:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        est = make().fit(mm)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        what = f"streamed {name} fit"
        if est.stream_stats_["passes"] != passes:
            raise AssertionError(f"{what} took "
                                 f"{est.stream_stats_['passes']} passes")
        _reader_check(what, est)
        _peak_check(what, peak, block_bytes, prefetch, extra)
        ests = []
        times = _timed(lambda: ests.append(make().fit(mm)),
                       STREAM_DECOMP_FITS)
        est = ests[-1]
        log(f"{what} {n}x{d} from a memmap: {passes} passes of "
            f"{-(-n // rows)} blocks; first fit {first:.3f} s, "
            f"{_spread(times)}")
        log(_timeline_line(what, est, device_timeline(
            lambda: make().fit(mm))))
        r = fits[ref]
        _decomp_gate(what, est, r.singular_values_, r.components_,
                     f"phase 19's resident {ref}")
    path = mm.filename
    del mm
    os.remove(path)


def _search_times(run):
    run()                         # untimed: allocations, the first pass
    return _timed(run, SEARCH_RUNS)


def phase_search(results):
    """Phase 21: the search paths. (a) bench.py's Hyperband search over
    SGDClassifier on 400,000 x 128 host rows, on the streamed cohort
    plane (one fused_sgd_many_block_grad launch a block step, no other
    kernel) and on the device-resident plane (search_stream=False): equal
    best_params_, best_score_ within HB_BEST_ATOL; then with
    use_kernel=False: the same candidates, partial_fit calls and winner,
    every test score within 2 / n_test. (b) bench.py's GridSearchCV over
    LogisticRegression(lbfgs, max_iter=20, tol=0) on 1M x 64 on the
    card, eight Cs, cv=2: the C-grid fast path (one stacked solve a fold)
    against the general path (one fit a candidate and fold, kernel 1 at
    every evaluation)."""
    from dask_ml_tpu_torch import config
    from dask_ml_tpu_torch.linear_model import (LogisticRegression,
                                                SGDClassifier)
    from dask_ml_tpu_torch.model_selection import (GridSearchCV,
                                                   HyperbandSearchCV)
    from dask_ml_tpu_torch.ops import fused
    from dask_ml_tpu_torch.parallel import ShardedArray

    rng = np.random.RandomState(4)
    X = rng.randn(HB_N, HB_D).astype(np.float32)
    y = (X[:, 0] + 0.5 * rng.randn(HB_N) > 0).astype(np.float32)

    def hyperband(**cfg):
        with config.set(**cfg):
            s = HyperbandSearchCV(
                SGDClassifier(tol=1e-3, random_state=0), HB_PARAMS,
                max_iter=HB_MAX_ITER, aggressiveness=3, random_state=0,
            ).fit(X, y, classes=[0.0, 1.0])
        torch.cuda.synchronize()
        return s

    times = {"streamed": _search_times(hyperband),
             "device": _search_times(lambda: hyperband(search_stream=False))}
    fused.reset_launches()
    streamed = hyperband()
    meta = streamed.metadata_["stream"]
    if not (meta["streamed"] and meta["fused"]
            and meta["fused_reason"] is None):
        raise AssertionError(f"Hyperband search: stream record {meta}")
    launches = _sgd_launches("streamed Hyperband search", {
        "fused_sgd_many_block_grad": meta["dispatches"]})
    results["fused_sgd_many_block_grad"]["launches_by_path"]["search"] = \
        launches["fused_sgd_many_block_grad"]
    fused.reset_launches()
    device = hyperband(search_stream=False)
    dev_launches = {k: v for k, v in fused.launches().items() if v}
    plain = hyperband(use_kernel=False)
    n_test = int(np.ceil(HB_N * 0.15))
    calls = streamed.cv_results_["partial_fit_calls"]
    rows = int(calls.sum()) * meta["block_rows"]
    d_best = abs(streamed.best_score_ - device.best_score_)
    d_plain = float(np.abs(streamed.cv_results_["test_score"]
                           - plain.cv_results_["test_score"]).max())
    med = statistics.median(times["streamed"])
    log(f"hyperband_seconds {med:.4f} (HyperbandSearchCV(SGDClassifier), "
        f"{HB_N}x{HB_D} host rows, {len(calls)} candidates, max_iter "
        f"{HB_MAX_ITER}: streamed plane {_spread(times['streamed'])}; "
        f"device plane {_spread(times['device'])})")
    log(f"hyperband_rows_per_sec {rows / med:.6g} ({int(calls.sum())} "
        f"partial_fit calls of {meta['block_rows']}-row blocks, "
        f"{meta['n_blocks']} blocks, {meta['rounds']} rounds); "
        f"fused_sgd_many_block_grad launches {meta['dispatches']} (the "
        f"device plane: {dev_launches}); best {streamed.best_params_} "
        f"score {streamed.best_score_:.6f}, device plane "
        f"{device.best_params_} |dscore| {d_best:.3e}; use_kernel=False "
        f"max|dscore| {d_plain:.3e} (2 / n_test {2.0 / n_test:.3e})")
    if not (streamed.best_params_ == device.best_params_
            and d_best <= HB_BEST_ATOL):
        raise AssertionError("the streamed Hyperband search disagrees with "
                             "the device-resident plane")
    if not (streamed.cv_results_["params"] == plain.cv_results_["params"]
            and np.array_equal(calls, plain.cv_results_["partial_fit_calls"])
            and streamed.best_params_ == plain.best_params_
            and d_plain <= 2.0 / n_test):
        raise AssertionError("the Hyperband search disagrees with its "
                             "use_kernel=False twin")
    del X, y

    gen = torch.Generator(device="cuda").manual_seed(5)
    Xg = torch.randn((CG_N, CG_D), generator=gen, device="cuda")
    yg = (Xg[:, 0] + 0.5 * torch.randn(CG_N, generator=gen, device="cuda")
          > 0).float()
    Xs, ys = ShardedArray.from_array(Xg), ShardedArray.from_array(yg)

    def grid(params):
        s = GridSearchCV(
            LogisticRegression(solver="lbfgs", max_iter=20, tol=0.0),
            params, cv=2, refit=False, scheduler="synchronous").fit(Xs, ys)
        torch.cuda.synchronize()
        return s

    fast_params = {"C": CG_CS}
    general_params = {"C": CG_CS, "intercept_scaling": [1.0]}
    t_fast = _search_times(lambda: grid(fast_params))
    fused.reset_launches()
    fast = grid(fast_params)
    fast_launches = {k: v for k, v in fused.launches().items() if v}
    if getattr(fast, "_c_grid_vmapped_", None) != len(CG_CS):
        raise AssertionError("C-grid fast path not taken: "
                             f"{getattr(fast, '_c_grid_fallback_', 'ineligible')}")
    t_general = _search_times(lambda: grid(general_params))
    fused.reset_launches()
    general = grid(general_params)
    k1 = fused.launches()["fused_glm_value_grad"]
    results["fused_glm_value_grad"]["launches_by_path"] = {
        "lbfgs_fit": results["fused_glm_value_grad"]["launches"],
        "search_general": k1}
    d_mean = float(np.abs(fast.cv_results_["mean_test_score"]
                          - general.cv_results_["mean_test_score"]).max())
    c_fast = CG_CS[int(np.argmax(fast.cv_results_["mean_test_score"]))]
    c_gen = CG_CS[int(np.argmax(general.cv_results_["mean_test_score"]))]
    log(f"c_grid_search_seconds {statistics.median(t_fast):.4f} "
        f"(GridSearchCV(LogisticRegression(lbfgs, max_iter=20, tol=0)), "
        f"{CG_N}x{CG_D} on the card, {len(CG_CS)} Cs, cv=2: the stacked "
        f"fast path {_spread(t_fast)}, kernel launches {fast_launches}; "
        f"the general path {_spread(t_general)}, fused_glm_value_grad "
        f"launches {k1}); best C {c_fast} (general {c_gen}), "
        f"max|dmean_test_score| {d_mean:.3e}")
    if not (d_mean <= CG_SCORE_ATOL and c_fast == c_gen and k1 > 0
            and general.cv_results_["params"][0] == {"C": CG_CS[0],
                                                     "intercept_scaling": 1.0}):
        raise AssertionError("the C-grid fast path disagrees with the "
                             "general path")


def phase_lloyd_narrow(gen, results):
    """Phase 22: fused_lloyd_stats and fused_assign_update at
    SpectralClustering's embedding width (LLOYD_NARROW: d = k = 8 and 10,
    and d = 10 on a row view off a 16-byte boundary) on unit rows, as the
    embedding's are: against their plain versions by phase 3's rules
    (check_lloyd), two runs bit-equal, kernel, plain and bound times."""
    from dask_ml_tpu_torch.ops import fused

    dev = torch.device("cuda")
    rows = []
    for n, d, k, off in LLOYD_NARROW:
        base = torch.randn((n + off, d), generator=gen, device=dev)
        base /= base.norm(dim=1, keepdim=True)
        x = base[off:]
        c = x[torch.randperm(n, generator=gen, device=dev)[:k]].clone()
        ones = torch.ones(n, device=dev)
        a1 = fused.fused_assign_update(x, ones, c)
        a2 = fused.fused_assign_update(x, ones, c)
        s1 = fused.fused_lloyd_stats(x, n, c)
        s2 = fused.fused_lloyd_stats(x, n, c)
        torch.cuda.synchronize()
        what = f"lloyd kernels {n}x{d} k={k} (row offset {off})"
        if not (same_bits(a1, a2) and same_bits(s1, s2)
                and same_bits(s1, a1[2:])):
            raise AssertionError(f"{what}: two runs differ")
        plain = fused.assign_update_plain(x, ones, c)
        err, n_ties = check_lloyd(x, c, *a1, plain)
        flops = 2.0 * n * k * d + 2.0 * n * d + 3.0 * n * k + n * d
        io = (k * d + k + 1) * 4 + d * k * 4
        row = {"d": d, "k": k, "row_offset_bytes": 4 * d * off,
               "max_abs_err": err, "near_tie_label_flips": n_ties}
        for name, fn, pfn, nbytes in [
            ("fused_lloyd_stats", lambda: fused.fused_lloyd_stats(x, n, c),
             lambda: fused.lloyd_stats_plain(x, n, c), n * d * 4 + io),
            ("fused_assign_update",
             lambda: fused.fused_assign_update(x, ones, c),
             lambda: fused.assign_update_plain(x, ones, c),
             n * d * 4 + n * 4 + io + n * 8),
        ]:
            ms = time_ms(fn, 10)
            plain_ms = time_ms(pfn, 3, 1)
            b_ms, b_by, shares = tc_bound(nbytes, flops, ms)
            row[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                         "bound_by": b_by}
            log(f"{what} {fused.lloyd_mma_geometry(d, k)}: {name} kernel "
                f"{ms:.3f} ms, plain {plain_ms:.3f} ms, {shares}")
        log(f"{what}: max|err| {err:.3e}, {n_ties} near-tie label flips, "
            "bit-equal reruns, stats == assign stats")
        rows.append(row)
        del base, x, a1, a2, s1, s2, plain
    for name in ("fused_lloyd_stats", "fused_assign_update"):
        results[name]["embedding_widths"] = [
            {**{k: v for k, v in r.items() if not k.startswith("fused_")},
             **r[name]} for r in rows]
    torch.cuda.empty_cache()


def _col_scale_close(what, got, ref, scale, rtol):
    """|got - ref| <= rtol * scale, column by column; returns the largest
    |got - ref| / scale."""
    rel = float(np.max(np.abs(np.asarray(got, np.float64) - ref) / scale))
    if not rel <= rtol:
        raise AssertionError(f"{what}: {rel:.3e} of the column's scale "
                             f"(tolerance {rtol})")
    return rel


def _host_moments(Xh, fill=None, rows=1 << 18):
    """float64 (mean, variance, count) per column of host f32 rows,
    skipping NaN, or with NaN replaced by ``fill``; two passes in row
    chunks."""
    s = np.zeros(Xh.shape[1])
    cnt = np.zeros(Xh.shape[1])
    for lo in range(0, Xh.shape[0], rows):
        c = Xh[lo:lo + rows].astype(np.float64)
        nan = np.isnan(c)
        c[nan] = 0.0 if fill is None else np.broadcast_to(fill, c.shape)[nan]
        s += c.sum(0)
        cnt += (~nan).sum(0) if fill is None else len(c)
    mean = s / cnt
    ss = np.zeros(Xh.shape[1])
    for lo in range(0, Xh.shape[0], rows):
        c = Xh[lo:lo + rows].astype(np.float64)
        nan = np.isnan(c)
        if fill is not None:
            c[nan] = np.broadcast_to(fill, c.shape)[nan]
        c = np.where(np.isnan(c), mean, c) - mean
        ss += (c * c).sum(0)
    return mean, ss / cnt, cnt


def _qt_replay(x, q, refs):
    """QuantileTransformer's uniform map in float64 numpy, column by
    column."""
    out = np.empty(x.shape)
    for j in range(x.shape[1]):
        v, qc = x[:, j], q[:, j]
        o = 0.5 * (np.interp(v, qc, refs)
                   - np.interp(-v, -qc[::-1], -refs[::-1]))
        o = np.where(v >= qc[-1], refs[-1], o)
        out[:, j] = np.where(v <= qc[0], refs[0], o)
    return out


def _label_agreement(a, b):
    """Share of rows on which two labelings agree under the best
    one-to-one relabeling (greedy on the contingency table)."""
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    table = np.zeros((a.max() + 1, b.max() + 1), np.int64)
    np.add.at(table, (a, b), 1)
    hit = 0
    while table.size and table.max() > 0:
        i, j = np.unravel_index(np.argmax(table), table.shape)
        hit += table[i, j]
        table[i, :] = 0
        table[:, j] = 0
    return hit / len(a)


def phase_surface(results):
    """Phase 23: the rest of the estimator surface on the card, at
    bench.py's width: the dataset draw, SimpleImputer -> StandardScaler ->
    LogisticRegression(lbfgs) on 4M x 256 with 1 % NaN (kernel 1),
    RobustScaler's sketch, QuantileTransformer, GaussianNB fit against
    partial_fit, ColumnTransformer with a one-hot branch into
    LogisticRegression (kernel 1), PolynomialFeatures, the blockwise
    voting ensemble (kernel 1 in each member) and SpectralClustering
    (kernels 2 and 10 at d = 8); each step timed and held to its
    reference."""
    import importlib.util
    import itertools as it

    from dask_ml_tpu_torch import datasets
    from dask_ml_tpu_torch.cluster import SpectralClustering
    from dask_ml_tpu_torch.compose import ColumnTransformer
    from dask_ml_tpu_torch.ensemble import BlockwiseVotingClassifier
    from dask_ml_tpu_torch.impute import SimpleImputer
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.naive_bayes import GaussianNB
    from dask_ml_tpu_torch.ops import fused
    from dask_ml_tpu_torch.parallel import ShardedArray
    from dask_ml_tpu_torch.preprocessing import (OneHotEncoder,
                                                 PolynomialFeatures,
                                                 QuantileTransformer,
                                                 RobustScaler, StandardScaler)
    from dask_ml_tpu_torch.preprocessing.data import nan_quantiles

    log(f"pandas importable on this machine: "
        f"{importlib.util.find_spec('pandas') is not None} (no pandas path "
        "runs here)")
    times = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    n, d = GLM_N, GLM_D
    X, y = timed("make_classification", lambda: datasets.make_classification(
        n, d, random_state=0))
    log(f"make_classification({n}, {d}): {times['make_classification']:.3f} "
        f"s to draw and place on the card")
    Xh, yh = X.to_numpy(), y.to_numpy()

    # -- SimpleImputer -> StandardScaler -> LogisticRegression ------------
    rng = np.random.default_rng(23)
    flat = np.unique(rng.integers(0, n * d, size=int(NAN_SHARE * n * d)))
    Xnan_h = Xh.copy()
    Xnan_h.reshape(-1)[flat] = np.nan
    Xnan = ShardedArray(X.data.clone(), n)
    Xnan.data.view(-1)[torch.as_tensor(flat, device="cuda")] = torch.nan
    del flat

    def pipeline():
        imp = SimpleImputer(strategy="mean").fit(Xnan)
        Xi = imp.transform(Xnan)
        sc = StandardScaler().fit(Xi)
        Xs = sc.transform(Xi)
        clf = LogisticRegression(solver="lbfgs", max_iter=50,
                                 tol=0.0).fit(Xs, y)
        return imp, sc, clf, Xs

    pipeline()                      # untimed: allocations, first launches
    fused.reset_launches()
    imp, sc, clf, Xs = timed("pipeline", pipeline)
    k1 = fused.launches()["fused_glm_value_grad"]
    if k1 < clf.n_iter_ or clf.n_iter_ < 1:
        raise AssertionError(f"pipeline fit: {clf.n_iter_} iterations, "
                             f"{k1} launches of fused_glm_value_grad")
    wall, busy, top = device_busy_ms(lambda: pipeline())
    log(f"pipeline SimpleImputer(mean) -> StandardScaler -> "
        f"LogisticRegression(lbfgs, max_iter=50, tol=0) on {n}x{d} with "
        f"{NAN_SHARE:.0%} NaN: {times['pipeline']:.3f} s, {clf.n_iter_} "
        f"iterations, fused_glm_value_grad launches {k1}")
    log(busy_line("pipeline fit", wall, busy, top))
    twin = LogisticRegression(solver="lbfgs", max_iter=50, tol=0.0,
                              solver_kwargs={"use_kernel": False}).fit(Xs, y)
    d_coef = float(np.abs(clf.coef_ - twin.coef_).max())
    d_b = float(np.abs(clf.intercept_ - twin.intercept_).max())
    mean_h, var_h, _ = _host_moments(Xnan_h)
    r_stat = _col_scale_close("SimpleImputer.statistics_", imp.statistics_,
                              mean_h, np.abs(mean_h) + np.sqrt(var_h),
                              STAT_RTOL)
    fill = imp.statistics_.astype(np.float32)
    mean_i, var_i, _ = _host_moments(Xnan_h, fill=fill)
    scale_i = np.abs(mean_i) + np.sqrt(var_i)
    r_mean = _col_scale_close("StandardScaler.mean_", sc.mean_, mean_i,
                              scale_i, STAT_RTOL)
    r_var = _col_scale_close("StandardScaler.var_", sc.var_, var_i,
                             scale_i ** 2, STAT_RTOL)
    log(f"pipeline against float64 numpy: statistics_ {r_stat:.3e}, mean_ "
        f"{r_mean:.3e}, var_ {r_var:.3e} of the column's scale; against "
        f"the plain-loss twin max|dcoef| {d_coef:.3e}, |dintercept| "
        f"{d_b:.3e}")
    if not (d_coef <= COEF_ATOL and d_b <= COEF_ATOL):
        raise AssertionError("pipeline fit disagrees with its plain-loss twin")
    results["fused_glm_value_grad"].setdefault("launches_by_path", {})
    results["fused_glm_value_grad"]["launches_by_path"]["pipeline"] = k1
    del Xnan, Xnan_h, Xs, imp, sc, clf, twin
    torch.cuda.empty_cache()

    # -- RobustScaler's sketch against the exact quantiles ---------------
    rs = timed("robust_scaler", lambda: RobustScaler().fit(X))
    exact = timed("exact_quantiles", lambda: nan_quantiles(
        X.data, [0.25, 0.5, 0.75]).cpu().numpy())
    width = (Xh.max(0).astype(np.float64) - Xh.min(0)) / 4096
    e_center = float(np.max(np.abs(rs.center_ - exact[1]) / width))
    e_scale = float(np.max(np.abs(rs.scale_ - (exact[2] - exact[0]))
                           / width))
    log(f"RobustScaler on {n}x{d} (the sketch): {times['robust_scaler']:.3f}"
        f" s; the exact quantiles {times['exact_quantiles']:.3f} s; center_ "
        f"within {e_center:.3f} bin widths, scale_ within {e_scale:.3f}")
    if not (e_center <= SKETCH_BINS and e_scale <= 2 * SKETCH_BINS):
        raise AssertionError("RobustScaler's sketch is off the exact "
                             "quantiles by more than one bin width")

    # -- QuantileTransformer ---------------------------------------------
    from scipy import stats

    xq = ShardedArray(X.data[:QT_ROWS], QT_ROWS)
    for dist in ("uniform", "normal"):
        qt = timed(f"quantile_{dist}", lambda: QuantileTransformer(
            n_quantiles=1000, subsample=100_000, random_state=0,
            output_distribution=dist).fit(X))
        # the first normal map compiles torch's ndtr/ndtri (jiterator):
        # a cold and a warm transform
        timed(f"quantile_{dist}_transform_cold", lambda: qt.transform(xq))
        out = timed(f"quantile_{dist}_transform",
                    lambda: qt.transform(xq)).to_numpy()
        ref = _qt_replay(Xh[:QT_ROWS].astype(np.float64),
                         qt.quantiles_.astype(np.float64), qt.references_)
        if dist == "normal":
            if not np.isfinite(out).all():
                raise AssertionError("QuantileTransformer(normal): "
                                     "non-finite output")
            out = stats.norm.cdf(out.astype(np.float64))
            ref = np.clip(ref, np.float32(1e-7), np.float32(1 - 1e-7))
        err = float(np.max(np.abs(out - ref)))
        log(f"QuantileTransformer({dist}) fit on {n}x{d} "
            f"{times[f'quantile_{dist}']:.3f} s, transform of {QT_ROWS} rows "
            f"{times[f'quantile_{dist}_transform']:.3f} s (cold "
            f"{times[f'quantile_{dist}_transform_cold']:.3f}); max|err| against "
            f"the float64 replay {err:.3e}"
            + (" (through the normal CDF)" if dist == "normal" else ""))
        if not err <= QT_ATOL:
            raise AssertionError(f"QuantileTransformer({dist}) disagrees "
                                 "with its float64 replay")
    del xq

    # -- GaussianNB: fit against partial_fit -------------------------------
    nb = timed("gaussian_nb_fit", lambda: GaussianNB().fit(X, y))

    def blocks():
        m = GaussianNB()
        for lo in range(0, n, NB_BLOCK):
            m.partial_fit(X.data[lo:lo + NB_BLOCK], y.data[lo:lo + NB_BLOCK],
                          classes=[0.0, 1.0])
        m.theta_
        return m

    nbp = timed("gaussian_nb_partial_fit", blocks)
    second = nb.var_ + nb.theta_ ** 2
    r_theta = float(np.max(np.abs(nbp.theta_ - nb.theta_) / np.sqrt(second)))
    r_var = float(np.max(np.abs(nbp.var_ - nb.var_) / second))
    differ = float(np.mean(nb.predict(X) != nbp.predict(X)))
    log(f"GaussianNB fit {times['gaussian_nb_fit']:.3f} s, partial_fit in "
        f"{NB_BLOCK}-row blocks {times['gaussian_nb_partial_fit']:.3f} s: "
        f"theta_ {r_theta:.3e} of sqrt(E[x^2]), var_ {r_var:.3e} of E[x^2], "
        f"predictions differ on {differ:.2e} of the rows; training accuracy "
        f"{nb.score(X, y):.4f}")
    if not (r_theta <= NB_RTOL and r_var <= NB_RTOL
            and differ <= NB_PRED_SHARE):
        raise AssertionError("GaussianNB's partial_fit disagrees with fit")
    del nb, nbp

    # -- ColumnTransformer: scaler + one-hot into LogisticRegression ------
    cgen = torch.Generator(device="cuda").manual_seed(23)
    codes = torch.randint(0, CT_LEVELS, (n, CT_CODES), generator=cgen,
                          device="cuda").float()
    Xc = ShardedArray(torch.cat([X.data, codes], dim=1), n)
    ct = ColumnTransformer(
        [("num", StandardScaler(), list(range(d))),
         ("cat", OneHotEncoder(), list(range(d, d + CT_CODES)))])
    Xt = timed("column_transformer", lambda: ct.fit_transform(Xc))
    codes_h = codes.cpu().numpy()
    levels = np.arange(CT_LEVELS, dtype=np.float32)
    for lo in range(0, n, 1 << 20):
        hot = Xt.data[lo:lo + (1 << 20), d:].cpu().numpy()
        ref = np.concatenate([(codes_h[lo:lo + (1 << 20), j, None]
                               == levels[None, :]).astype(np.float32)
                              for j in range(CT_CODES)], axis=1)
        if not np.array_equal(hot, ref):
            raise AssertionError("ColumnTransformer's one-hot differs from "
                                 "numpy's")
    del codes, codes_h, Xc
    fused.reset_launches()
    clf = timed("column_transformer_fit", lambda: LogisticRegression(
        solver="lbfgs", max_iter=BLOCKWISE_ITER, tol=0.0).fit(Xt, y))
    k1 = fused.launches()["fused_glm_value_grad"]
    if k1 < clf.n_iter_:
        raise AssertionError(f"ColumnTransformer fit: {k1} launches")
    results["fused_glm_value_grad"]["launches_by_path"]["column_transformer"] \
        = k1
    log(f"ColumnTransformer(StandardScaler on {d} columns, OneHotEncoder on "
        f"{CT_CODES} columns of {CT_LEVELS} codes) on {n} rows: "
        f"{times['column_transformer']:.3f} s to {tuple(Xt.shape)}, the "
        f"one-hot equal to numpy's; LogisticRegression(lbfgs, max_iter="
        f"{BLOCKWISE_ITER}) on it {times['column_transformer_fit']:.3f} s, "
        f"fused_glm_value_grad launches {k1}")
    del Xt, ct, clf
    torch.cuda.empty_cache()

    # -- PolynomialFeatures -------------------------------------------------
    xp = ShardedArray(X.data[:POLY_N, :POLY_D].contiguous(), POLY_N)
    pf = PolynomialFeatures(degree=2).fit(xp)
    out = timed("polynomial_features", lambda: pf.transform(xp)).to_numpy()
    xh = xp.to_numpy().astype(np.float64)
    ref = np.stack([np.prod(xh[:, list(c)], axis=1) if c else
                    np.ones(POLY_N) for c in pf._combos], axis=1)
    r_poly = float(np.max(np.abs(out - ref) / np.maximum(np.abs(ref),
                                                          1e-30)))
    log(f"PolynomialFeatures(degree=2) on {POLY_N}x{POLY_D}: "
        f"{times['polynomial_features']:.3f} s to {out.shape}; max rel err "
        f"against float64 {r_poly:.3e}")
    if not r_poly <= POLY_RTOL:
        raise AssertionError("PolynomialFeatures disagrees with float64")
    del xp, out, xh, ref

    # -- BlockwiseVotingClassifier on the host matrix ---------------------
    fused.reset_launches()
    bv = timed("blockwise_fit", lambda: BlockwiseVotingClassifier(
        LogisticRegression(solver="lbfgs", max_iter=BLOCKWISE_ITER,
                           tol=0.0)).fit(Xh, yh))
    k1 = fused.launches()["fused_glm_value_grad"]
    iters = sum(m.n_iter_ for m in bv.estimators_)
    if len(bv.estimators_) != 8 or k1 < iters:
        raise AssertionError(f"blockwise fit: {len(bv.estimators_)} members, "
                             f"{k1} launches for {iters} iterations")
    results["fused_glm_value_grad"]["launches_by_path"]["blockwise"] = k1
    pred = timed("blockwise_predict", lambda: bv.predict(Xh))
    votes = np.zeros((n, 2), np.int64)
    near = np.zeros(n, bool)
    for m in bv.estimators_:
        eta = Xh @ m.coef_.ravel().astype(np.float32) + m.intercept_[0]
        near |= np.abs(eta) < 1e-4
        votes[np.arange(n), (eta > 0).astype(np.int64)] += 1
    ref = bv.classes_[np.argmax(votes, axis=1)]
    off = (pred != ref) & ~near
    log(f"BlockwiseVotingClassifier(LogisticRegression(lbfgs, max_iter="
        f"{BLOCKWISE_ITER})) on the host {n}x{d}: fit {times['blockwise_fit']:.3f}"
        f" s (8 members, {iters} iterations, fused_glm_value_grad launches "
        f"{k1}), predict {times['blockwise_predict']:.3f} s; votes differ "
        f"from the host recompute on {int((pred != ref).sum())} rows, "
        f"{int(off.sum())} of them off a member's |eta| < 1e-4")
    if off.any():
        raise AssertionError("the blockwise votes differ from the host "
                             "recompute")
    del bv, pred, votes, near, X, y, Xh, yh
    torch.cuda.empty_cache()

    # -- SpectralClustering at the embedding's narrow width --------------
    Xb, yb = timed("make_blobs", lambda: datasets.make_blobs(
        SPEC_N, SPEC_D, centers=SPEC_K, random_state=0))
    fused.reset_launches()
    spec = timed("spectral", lambda: SpectralClustering(
        n_clusters=SPEC_K, random_state=0,
        gamma=1.0 / (2 * SPEC_D)).fit(Xb))
    launches = fused.launches()
    agree = _label_agreement(spec.labels_.to_numpy(), yb.to_numpy())
    km = spec.assign_labels_
    log(f"SpectralClustering(n_clusters={SPEC_K}, gamma=1/{2 * SPEC_D}) on "
        f"make_blobs({SPEC_N}, {SPEC_D}, centers={SPEC_K}) (drawn in "
        f"{times['make_blobs']:.3f} s): {times['spectral']:.3f} s, labels "
        f"match the blobs on {agree:.6f} of the rows; eigenvalues_ "
        f"{np.round(spec.eigenvalues_, 4).tolist()}; the kept KMeans "
        f"{km.n_iter_} iterations; launches fused_lloyd_stats "
        f"{launches['fused_lloyd_stats']}, fused_assign_update "
        f"{launches['fused_assign_update']} (n_init {spec.n_init})")
    if not (agree >= SPEC_AGREE
            and launches["fused_lloyd_stats"] >= spec.n_init
            and launches["fused_assign_update"] == spec.n_init):
        raise AssertionError("SpectralClustering: the blobs were not "
                             "recovered, or the Lloyd kernels did not run")
    for name in ("fused_lloyd_stats", "fused_assign_update"):
        byp = results[name].setdefault("launches_by_path", {})
        byp["kmeans_fit"] = results[name].get("launches")
        byp["spectral"] = launches[name]
    log("estimator surface step times (s): " + json.dumps(
        {k: round(v, 4) for k, v in times.items()}))
    del Xb, yb, spec
    torch.cuda.empty_cache()


# -- phases 24 and 25: sparse sources --------------------------------------

def _sparse_corpus(n, d, npr, seed):
    """bench.py's _bench_sparse_stream corpus (bench.py:1382-1396): npr
    column draws a row with duplicates kept (they sum), values U[0, 1),
    targets the sign of X w against its median."""
    import scipy.sparse as sp

    rng = np.random.RandomState(seed)
    indices = rng.randint(0, d, size=n * npr).astype(np.int32)
    data = rng.rand(n * npr).astype(np.float32)
    indptr = np.arange(0, n * npr + 1, npr, dtype=np.int64)
    X = sp.csr_matrix((data, indices, indptr), shape=(n, d))
    w = rng.randn(d).astype(np.float32)
    eta = X @ w
    return X, (eta > np.median(eta)).astype(np.float64), eta


def _require_sparse(what, est, info=None):
    info = info if info is not None else est.solver_info_
    if not info.get("sparse_stream"):
        raise RuntimeError(
            f"{what} fell back to densify (reason="
            f"{info.get('sparse_stream_reason')})")


def _bit_equal(what, a, b, attrs):
    """Each attribute of ``a`` bit-equal to ``b``'s; raises otherwise."""
    for attr in attrs:
        x, y = np.asarray(getattr(a, attr)), np.asarray(getattr(b, attr))
        if x.shape != y.shape or x.tobytes() != y.tobytes():
            gap = (f"{np.abs(x.astype(np.float64) - y).max():.3e}"
                   if x.shape == y.shape else f"shape, {x.shape} {y.shape}")
            raise AssertionError(f"{what}: {attr} differs by {gap}")
    log(f"{what}: bit-equal ({', '.join(attrs)})")


def _route_gap(what, nnz, dense, attrs, atol):
    """The nnz route's fit against the densify route's, attribute by
    attribute within ``atol``."""
    gaps = {a: float(np.abs(np.asarray(getattr(nnz, a), np.float64)
                            - np.asarray(getattr(dense, a), np.float64)
                            ).max()) for a in attrs}
    log(f"{what}: nnz route against the densify route "
        + ", ".join(f"max|d{a}| {g:.3e}" for a, g in gaps.items())
        + f" (tolerance {atol:g})")
    if not all(np.isfinite(g) and g <= atol for g in gaps.values()):
        raise AssertionError(f"{what}: the routes disagree: {gaps}")


def _by_path(results, name, path, count):
    results[name].setdefault("launches_by_path", {})[path] = int(count)


def phase_sparse_stream(results):
    """Phase 24: bench.py's _bench_sparse_stream at its on-chip height
    (120,000 x 16,384, 163 nonzeros a row, 19.6 M in all; blocks of 1,024
    rows): SGDClassifier(max_iter=2) and LogisticRegression(
    gradient_descent, max_iter=3) on the nnz route, each run twice
    (bit-equal) and held to its densify route twin (kernels 5 and 6 on
    16,384-wide blocks), rows/s per pass as bench.py normalizes them;
    then a 10-class one-vs-rest lbfgs fit (densify twin: kernel 7) and
    KMeans(k=16, 5 iterations from 16 of the rows; densify twin: kernel
    9) the same way, and Newton on a 500,000 x 512 corpus at 10 nonzeros
    a row, whose Hessian passes scatter each block dense on the card and
    launch kernel 6 vgh, held to its densify twin within 1e-4. Every
    nnz-route fit must report solver_info_["sparse_stream"]."""
    from dask_ml_tpu_torch import config
    from dask_ml_tpu_torch.cluster import KMeans
    from dask_ml_tpu_torch.linear_model import (LogisticRegression,
                                                SGDClassifier)
    from dask_ml_tpu_torch.ops import fused

    t_phase = time.perf_counter()
    X, y, eta = _sparse_corpus(SPARSE_N, SPARSE_D, SPARSE_NPR, 11)
    n, nnz = SPARSE_N, X.nnz
    log(f"sparse corpus: {n} x {SPARSE_D}, {nnz} nonzeros "
        f"({SPARSE_NPR} a row, density {nnz / n / SPARSE_D:.4f}); a pass "
        f"stages {(12 * nnz + 8 * (n + 1)) / 1e6:.1f} MB packed against "
        f"{4 * n * SPARSE_D / 1e9:.2f} GB densified; drawn in "
        f"{time.perf_counter() - t_phase:.2f} s")

    def fit(make, Xs=X, ys=y, block=SPARSE_BLOCK, **cfg):
        with config.set(stream_block_rows=block, **cfg):
            t0 = time.perf_counter()
            est = make().fit(Xs, ys)
            torch.cuda.synchronize()
            return est, time.perf_counter() - t0

    def counted(make, **kw):
        fused.reset_launches()
        est, s = fit(make, **kw)
        return est, s, fused.launches()

    def sgd():
        return SGDClassifier(max_iter=SPARSE_EPOCHS, random_state=0,
                             shuffle=False)

    def glm():
        return LogisticRegression(solver="gradient_descent",
                                  max_iter=SPARSE_GLM_ITER)

    # warm runs, as bench.py's (the allocator and the libraries' handles)
    fit(lambda: SGDClassifier(max_iter=1, random_state=0, shuffle=False))
    fit(lambda: LogisticRegression(solver="gradient_descent", max_iter=1))

    # SGD
    a, s_nnz, la = counted(sgd)
    _require_sparse("sparse SGD", a)
    blocks = a.solver_info_["n_blocks"]
    if blocks != -(-n // SPARSE_BLOCK) or any(la.values()):
        raise AssertionError(f"sparse SGD: {blocks} blocks, launches {la}")
    b, _ = fit(sgd)
    _bit_equal("sparse SGD, two runs", a, b, ("coef_", "intercept_"))
    d_est, s_dense, ld = counted(sgd, stream_sparse=False)
    if ld["fused_sgd_block_grad"] != blocks * SPARSE_EPOCHS:
        raise AssertionError(f"densified SGD launches {ld}")
    _by_path(results, "fused_sgd_block_grad", "sparse_densify",
             ld["fused_sgd_block_grad"])
    _route_gap("sparse SGD", a, d_est, ("coef_", "intercept_"),
               SPARSE_ROUTE_ATOL)
    log(f"streamed_sparse_sgd_rows_per_sec {n * SPARSE_EPOCHS / s_nnz:.6g} "
        f"(SGDClassifier(max_iter={SPARSE_EPOCHS}) on the nnz route, "
        f"{blocks} blocks a pass, {s_nnz:.3f} s); the densify route "
        f"{n * SPARSE_EPOCHS / s_dense:.6g} rows/s ({s_dense:.3f} s, "
        f"kernel 5 on {SPARSE_BLOCK} x {SPARSE_D} blocks)")
    log(_timeline_line("sparse SGD (nnz route)", a,
                       device_timeline(lambda: fit(sgd))))

    # GLM, gradient descent
    g, g_s, lg = counted(glm)
    _require_sparse("sparse GLM", g)
    if any(lg.values()):
        raise AssertionError(f"sparse GLM (val/vg on the nnz route): "
                             f"launches {lg}")
    g2, _ = fit(glm)
    _bit_equal("sparse GLM, two runs", g, g2, ("coef_", "intercept_"))
    gd, gd_s, lgd = counted(glm, stream_sparse=False)
    if lgd["fused_glm_stream"] < gd.solver_info_["data_passes"] * blocks:
        raise AssertionError(f"densified GLM launches {lgd}")
    _by_path(results, "fused_glm_stream", "sparse_densify_gd",
             lgd["fused_glm_stream"])
    _route_gap("sparse GLM", g, gd, ("coef_", "intercept_"),
               SPARSE_ROUTE_ATOL)
    p, pd = g.solver_info_["data_passes"], gd.solver_info_["data_passes"]
    log(f"streamed_sparse_glm_rows_per_sec {n * p / g_s:.6g} "
        f"(LogisticRegression(gradient_descent, max_iter={SPARSE_GLM_ITER}) "
        f"on the nnz route, {p} passes in {g_s:.3f} s); the densify route "
        f"{n * pd / gd_s:.6g} rows/s ({pd} passes in {gd_s:.3f} s, kernel 6 "
        f"on {SPARSE_BLOCK} x {SPARSE_D} blocks)")
    log(_timeline_line("sparse GLM (nnz route)", g,
                       device_timeline(lambda: fit(glm))))

    # one-vs-rest lbfgs, 10 classes
    y10 = np.searchsorted(np.quantile(eta, np.linspace(0.1, 0.9, 9)),
                          eta).astype(np.float64)

    def ovr():
        return LogisticRegression(solver="lbfgs", max_iter=SPARSE_OVR_ITER)

    o, o_s, lo = counted(ovr, ys=y10)
    _require_sparse("sparse one-vs-rest", o)
    o2, _ = fit(ovr, ys=y10)
    _bit_equal("sparse one-vs-rest, two runs", o, o2, ("coef_", "intercept_"))
    od, od_s, lod = counted(ovr, ys=y10, stream_sparse=False)
    _by_path(results, "fused_glm_multi_stream", "sparse_densify_ovr",
             lod["fused_glm_multi_stream"])
    if not lod["fused_glm_multi_stream"] or any(lo.values()):
        raise AssertionError(f"one-vs-rest launches: nnz {lo}, densify "
                             f"{lod}")
    _route_gap("sparse one-vs-rest", o, od, ("coef_", "intercept_"),
               SPARSE_ROUTE_ATOL)
    log(f"sparse one-vs-rest lbfgs (10 classes, max_iter="
        f"{SPARSE_OVR_ITER}): nnz route {o.solver_info_['data_passes']} "
        f"passes in {o_s:.3f} s, densify route "
        f"{od.solver_info_['data_passes']} passes in {od_s:.3f} s")

    # KMeans from 16 of the rows
    init = X[:SPARSE_KM_K].toarray().astype(np.float32)

    def km():
        return KMeans(n_clusters=SPARSE_KM_K, init=init,
                      max_iter=SPARSE_KM_ITER, tol=0.0)

    k, k_s, lk = counted(km, ys=None)
    _require_sparse("sparse KMeans", k, k.kernel_info_)
    k2, _ = fit(km, ys=None)
    _bit_equal("sparse KMeans, two runs", k, k2,
               ("cluster_centers_", "labels_"))
    kd, kd_s, lkd = counted(km, ys=None, stream_sparse=False)
    _by_path(results, "fused_kmeans_block_stats", "sparse_densify",
             lkd["fused_kmeans_block_stats"])
    if lkd["fused_kmeans_block_stats"] != SPARSE_KM_ITER * blocks \
            or any(lk.values()):
        raise AssertionError(f"KMeans launches: nnz {lk}, densify {lkd}")
    _route_gap("sparse KMeans", k, kd, ("cluster_centers_",),
               SPARSE_KM_ATOL)
    agree = float((np.asarray(k.labels_) == np.asarray(kd.labels_)).mean())
    log(f"sparse KMeans (k={SPARSE_KM_K}, {SPARSE_KM_ITER} iterations): "
        f"nnz route {k_s:.3f} s, densify route {kd_s:.3f} s; labels agree "
        f"on {agree:.6f} of the rows, inertia {k.inertia_:.6g} against "
        f"{kd.inertia_:.6g}")
    if not abs(k.inertia_ - kd.inertia_) <= SPARSE_KM_INERTIA_RTOL * \
            kd.inertia_:
        raise AssertionError("sparse KMeans inertia parts from the "
                             "densify route's")

    # Newton on 500,000 x 512 at 10 nonzeros a row: kernel 6 vgh on blocks
    # scattered dense on the card
    Xn, yn, _ = _sparse_corpus(SPARSE_NEWTON_N, SPARSE_NEWTON_D,
                               SPARSE_NEWTON_NPR, 12)

    def newton():
        return LogisticRegression(solver="newton", max_iter=8, tol=1e-6)

    nw, nw_s, lnw = counted(newton, Xs=Xn, ys=yn, block=None)
    _require_sparse("sparse Newton", nw)
    vgh = fused.fused_glm_stream.kind_launches["vgh"]
    if vgh < nw.solver_info_["n_blocks"]:
        raise AssertionError(f"sparse Newton: vgh launches {vgh}")
    _by_path(results, "fused_glm_stream", "sparse_newton_vgh", vgh)
    nw2, _ = fit(newton, Xs=Xn, ys=yn, block=None)
    _bit_equal("sparse Newton, two runs", nw, nw2, ("coef_", "intercept_"))
    nd, nd_s, _ = counted(newton, Xs=Xn, ys=yn, block=None,
                          stream_sparse=False)
    _route_gap("sparse Newton", nw, nd, ("coef_", "intercept_"),
               NEWTON_ROUTE_ATOL)
    log(f"sparse Newton ({SPARSE_NEWTON_N} x {SPARSE_NEWTON_D}, "
        f"{Xn.nnz} nonzeros, {nw.solver_info_['n_blocks']} blocks): nnz "
        f"route {nw.n_iter_} iterations in {nw_s:.3f} s ({vgh} vgh launches "
        f"on blocks densified on the card), densify route {nd_s:.3f} s")
    log(f"phase 24 (sparse streams) {time.perf_counter() - t_phase:.1f} s")


def phase_hashed_text(results):
    """Phase 25: hashed text at HashingVectorizer's default width, 2^20:
    200,000 documents of 100 tokens drawn from a Zipf vocabulary of
    50,000 words, hashed by the port's HashingVectorizer into
    transform_sparse's SparseBlocks, then SGDClassifier(max_iter=2) and
    LogisticRegression(lbfgs, max_iter=10) on the nnz route (blocks of
    4,096 rows), timed, with the peak device memory: no dense block of
    2^20 columns (16 GiB at this height) may appear. The fitted decision
    values held to scipy's float64 product on 10,000 documents."""
    from dask_ml_tpu_torch import config
    from dask_ml_tpu_torch.feature_extraction import HashingVectorizer
    from dask_ml_tpu_torch.linear_model import (LogisticRegression,
                                                SGDClassifier)
    from dask_ml_tpu_torch.ops import fused

    t_phase = time.perf_counter()
    rng = np.random.RandomState(25)
    p = 1.0 / np.arange(1, TEXT_VOCAB + 1)
    ids = rng.choice(TEXT_VOCAB, size=(TEXT_DOCS, TEXT_TOKENS), p=p / p.sum())
    words = [f"w{i}" for i in range(TEXT_VOCAB)]
    docs = [" ".join([words[i] for i in row]) for row in ids.tolist()]
    w = rng.randn(TEXT_VOCAB)
    score = w[ids].sum(1)
    y = (score > np.median(score)).astype(np.float64)
    log(f"text corpus: {TEXT_DOCS} documents of {TEXT_TOKENS} tokens "
        f"(Zipf over {TEXT_VOCAB} words) drawn in "
        f"{time.perf_counter() - t_phase:.2f} s")
    hv = HashingVectorizer()
    t0 = time.perf_counter()
    Xs = hv.transform_sparse(docs, block_size=10_000)
    t_hash = time.perf_counter() - t0
    log(f"hashing: {TEXT_DOCS / t_hash:.6g} docs/s ({t_hash:.2f} s, "
        f"{Xs.nnz} nonzeros, {Xs.shape[1]} columns, "
        f"{len(Xs.blocks)} blocks)")
    dense_block = TEXT_BLOCK * Xs.shape[1] * 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fused.reset_launches()
    with config.set(stream_block_rows=TEXT_BLOCK):
        t0 = time.perf_counter()
        sgd = SGDClassifier(max_iter=2, random_state=0, shuffle=False).fit(
            Xs, y)
        torch.cuda.synchronize()
        t_sgd = time.perf_counter() - t0
        t0 = time.perf_counter()
        lr = LogisticRegression(solver="lbfgs", max_iter=10).fit(Xs, y)
        torch.cuda.synchronize()
        t_lr = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    _require_sparse("hashed-text SGD", sgd)
    _require_sparse("hashed-text LogisticRegression", lr)
    launches = fused.launches()
    if any(launches.values()):
        raise AssertionError(f"hashed text: launches {launches}")
    log(f"hashed text: SGDClassifier(max_iter=2) {t_sgd:.3f} s "
        f"({TEXT_DOCS * 2 / t_sgd:.6g} rows/s, "
        f"{sgd.solver_info_['n_blocks']} blocks a pass), "
        f"LogisticRegression(lbfgs, max_iter=10) {t_lr:.3f} s "
        f"({lr.solver_info_['data_passes']} passes, "
        f"{TEXT_DOCS * lr.solver_info_['data_passes'] / t_lr:.6g} rows/s); "
        f"peak device memory {peak / 2**20:.1f} MiB against "
        f"{dense_block / 2**30:.1f} GiB for one dense block")
    if peak >= dense_block / 16:
        raise AssertionError("hashed text: the fits held a dense block's "
                             "worth of device memory")
    head = Xs.tocsr()[:10_000]
    ref = head.astype(np.float64) @ lr.coef_.ravel() + lr.intercept_[0]
    with config.set(stream_block_rows=TEXT_BLOCK):
        got = lr.decision_function(head)
    gap = float(np.abs(got - ref).max())
    acc = float((lr.predict(head) == y[:10_000]).mean())
    log(f"hashed text: decision values against scipy float64 max|d| "
        f"{gap:.3e}; train accuracy on 10,000 documents {acc:.4f}")
    if not (np.isfinite(lr.coef_).all() and gap <= 1e-4 and acc > 0.6):
        raise AssertionError("hashed text: the fit is wrong")
    log(f"phase 25 (hashed text) {time.perf_counter() - t_phase:.1f} s")


def _kmeans_gaps(km, ref):
    """(max |center gap|, share of equal labels, inertia rel gap)."""
    d_c = float(np.abs(km.cluster_centers_ - ref.cluster_centers_).max())
    agree = float((km.labels_.data.long() == ref.labels_.data.long())
                  .float().mean())
    return d_c, agree, abs(km.inertia_ - ref.inertia_) / ref.inertia_


# ---------------------------------------------------------------------------
# phase 26: checkpoints and reliability on the card
# ---------------------------------------------------------------------------

class _Killed(Exception):
    """The kill of a resident fit or a pass loop (raised after a save)."""


class _SaveClock:
    """Wraps ``utils.checkpoint.save_pytree``, which every checkpoint of
    the port saves through: each save's ms, and with ``kill_after`` a
    ``_Killed`` raised after that many saves (the save itself lands)."""

    def __init__(self, kill_after=None):
        from dask_ml_tpu_torch.utils import checkpoint

        self.mod, self.real = checkpoint, checkpoint.save_pytree
        self.kill_after, self.ms = kill_after, []

    def __call__(self, path, tree):
        t0 = time.perf_counter()
        self.real(path, tree)
        self.ms.append(1e3 * (time.perf_counter() - t0))
        if self.kill_after is not None and len(self.ms) == self.kill_after:
            raise _Killed(f"killed after save {len(self.ms)}")

    def __enter__(self):
        self.mod.save_pytree = self
        return self

    def __exit__(self, *exc):
        self.mod.save_pytree = self.real


def _filesystem(path):
    """'<type> at <mount point>' of the mount that holds ``path``."""
    path = os.path.realpath(path)
    best = ("?", "")
    with open("/proc/mounts") as f:
        for line in f:
            parts = line.split()
            mnt, fstype = parts[1], parts[2]
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) >= len(best[1]):
                best = (fstype, mnt)
    return f"{best[0]} at {best[1]}"


def _launch_total():
    from dask_ml_tpu_torch.ops import fused

    return sum(fused.launches().values())


def _resume(what, make, crash_at, ckdir, kind, ctl, attrs):
    """Kill the streamed fit ``make`` at block ``crash_at`` with pass
    checkpoints under ``ckdir``, rerun it and hold it to ``ctl``: bit-equal
    ``attrs``, one resume, the checkpoint gone. Returns (the resumed fit,
    passes saved, resumed fit's launches, its wall s)."""
    from dask_ml_tpu_torch import config
    from dask_ml_tpu_torch.observability import (counters_reset,
                                                 counters_snapshot)
    from dask_ml_tpu_torch.ops import fused
    from dask_ml_tpu_torch.reliability import InjectedCrash, reset_plans
    from dask_ml_tpu_torch.utils import checkpoint

    reset_plans()
    counters_reset()
    with config.set(stream_checkpoint_path=ckdir,
                    fault_plan=f"superblock_dispatch:crash@{crash_at}"):
        try:
            make()
        except InjectedCrash:
            pass
        else:
            raise AssertionError(f"{what}: the crash at block {crash_at} "
                                 "did not fire")
    reset_plans()
    saved = checkpoint.restore_pytree(os.path.join(ckdir, kind))
    if saved is None:
        raise AssertionError(f"{what}: no checkpoint after the kill")
    fused.reset_launches()
    t0 = time.perf_counter()
    with config.set(stream_checkpoint_path=ckdir):
        res = make()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_total()
    if counters_snapshot().get("stream_resumes") != 1 or os.listdir(ckdir):
        raise AssertionError(f"{what}: resumes {counters_snapshot()}, left "
                             f"{os.listdir(ckdir)}")
    _bit_equal(what, res, ctl, attrs)
    return res, saved, launches, wall


def phase_ckpt_resident(tmp, X, y, lbfgs_fit, report):
    """Phase 26 (resident lbfgs): LogisticRegression(lbfgs, max_iter=50,
    tol=0) on phase 4's 4M x 256 in chunks of 10 iterations, killed after
    its second save and rerun: resumed at iteration 20 and bit-equal to
    phase 4's fit."""
    from dask_ml_tpu_torch.linear_model import LogisticRegression

    path = os.path.join(tmp, "ckpt", "lbfgs")
    kw = dict(solver="lbfgs", max_iter=50, tol=0.0,
              solver_kwargs={"checkpoint_path": path,
                             "checkpoint_every": 10})
    with _SaveClock(kill_after=2) as clock:
        try:
            LogisticRegression(**kw).fit(X, y)
        except _Killed:
            pass
    with _SaveClock() as clock2:
        t0 = time.perf_counter()
        res = LogisticRegression(**kw).fit(X, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if res.solver_info_["resumed_from"] != 20 or os.path.exists(path):
        raise AssertionError(f"resident lbfgs resume: {res.solver_info_}")
    _bit_equal("resident lbfgs resume", res, lbfgs_fit,
          ("coef_", "intercept_", "n_iter_"))
    report["saves_ms"] += clock.ms + clock2.ms
    log(f"phase 26, resident lbfgs 4M x 256 in chunks of 10: killed after "
        f"save 2, resumed at iteration {res.solver_info_['resumed_from']}, "
        f"{res.n_iter_} iterations, bit-equal to phase 4's fit; the "
        f"resumed fit {wall:.3f} s, its {len(clock2.ms)} saves "
        f"{', '.join(f'{m:.2f}' for m in clock2.ms)} ms")


def phase_ckpt_incremental(tmp, Xi, yi, report):
    """Phase 26 (Incremental): phase 15's 2M x 128 from host memory,
    three partial_fit passes of Incremental(SGDClassifier); with pass
    checkpoints, two passes, then a fresh wrapper resumes and runs the
    third: bit-equal to the three uncheckpointed passes."""
    from dask_ml_tpu_torch import config
    from dask_ml_tpu_torch.linear_model import SGDClassifier
    from dask_ml_tpu_torch.wrappers import Incremental

    Xh, yh = Xi.cpu().numpy(), yi.cpu().numpy()
    ckdir = os.path.join(tmp, "ckpt", "incremental")

    def make():
        return Incremental(SGDClassifier(random_state=0),
                           shuffle_blocks=True, random_state=0)

    ctl = make()
    for _ in range(3):
        ctl.partial_fit(Xh, yh, classes=[0.0, 1.0])
    with config.set(stream_checkpoint_path=ckdir), _SaveClock() as clock:
        a = make()
        for _ in range(2):
            a.partial_fit(Xh, yh, classes=[0.0, 1.0])
        b = make()
        done = b.resume_from_checkpoint(Xh, yh, classes=[0.0, 1.0])
        b.partial_fit(Xh, yh, classes=[0.0, 1.0])
        b._clear_pass_checkpoint()
    torch.cuda.synchronize()
    if done != 2 or b.completed_passes_ != 3 or os.listdir(ckdir):
        raise AssertionError(f"Incremental resume: {done}, "
                             f"{b.completed_passes_}, {os.listdir(ckdir)}")
    _bit_equal("Incremental resume", b.estimator_, ctl.estimator_,
          ("coef_", "intercept_", "_t"))
    report["saves_ms"] += clock.ms
    log(f"phase 26, Incremental(SGDClassifier) {SGD_N}x{SGD_D} from host "
        f"memory: 2 checkpointed passes, a fresh wrapper resumed at pass "
        f"{done} and ran pass 3, bit-equal to 3 uncheckpointed passes; "
        f"saves {', '.join(f'{m:.2f}' for m in clock.ms)} ms")


def _stream_pass_ms(mm, y_h, **cfg):
    """(host fill, wait, pass) ms of one first pass of a fresh BlockStream
    over (mm, y) in phase 12's blocks, feeding fused_glm_stream("vg") per
    block, under ``cfg``."""
    from dask_ml_tpu_torch import config
    from dask_ml_tpu_torch.ops.fused import fused_glm_stream, glm_stream_acc
    from dask_ml_tpu_torch.parallel.streaming import BlockStream

    with config.set(**cfg):
        stream = BlockStream((mm, y_h), block_rows=STREAM_GLM_ROWS)
        beta = torch.zeros(GLM_D + 1, device=stream.device)
        acc = glm_stream_acc("vg", GLM_D, True, stream.device)
        for blk in stream:
            fused_glm_stream("vg", blk.arrays[0], blk.n_rows, blk.arrays[1],
                             beta, "logistic", True, acc=acc)
        torch.cuda.synchronize()
    st = stream.stats
    return 1e3 * st["host_s"], 1e3 * st["wait_s"], 1e3 * st["pass_s"]


def phase_ckpt_stream(tmp, mm, y_h, lbfgs, report):
    """Phase 26 (streamed): phase 12's lbfgs fit with and without pass
    checkpoints, in turns (bit-equal to phase 12's), killed in pass 12
    and resumed; SGD
    (phase 17's, shuffled, 3 epochs) killed in epoch 2 and resumed; an io
    fault retried to a bit-equal fit; a NaN injected into a staging copy
    raised under stream_nonfinite="raise" and quarantined under
    "quarantine"; the card's numbers of each."""
    from dask_ml_tpu_torch import config
    from dask_ml_tpu_torch.linear_model import (LogisticRegression,
                                                SGDClassifier)
    from dask_ml_tpu_torch.observability import (counters_reset,
                                                 counters_snapshot)
    from dask_ml_tpu_torch.ops import fused
    from dask_ml_tpu_torch.reliability import NonFiniteBlock, reset_plans

    ctl, ctl_s, ctl_launches = lbfgs["fit"], lbfgs["median_s"], \
        lbfgs["launches"]
    ckdir = os.path.join(tmp, "ckpt", "stream")
    os.makedirs(ckdir, exist_ok=True)
    log(f"phase 26: checkpoints under {ckdir} ({_filesystem(ckdir)})")
    n_blocks = ctl.solver_info_["n_blocks"]
    passes = ctl.solver_info_["data_passes"]
    glm_attrs = ("coef_", "intercept_", "n_iter_")

    def lbfgs_fit(**kw):
        est = LogisticRegression(solver="lbfgs", max_iter=STREAM_LBFGS_ITER,
                                 tol=0.0, **kw).fit(mm, y_h)
        torch.cuda.synchronize()
        return est

    # 1. checkpointed, never killed: the control's bits and passes; the
    # fit's wall against the plain fit's, in turns
    walls = {"plain": [], "checkpoints": []}
    n_saves = []
    for turn in ("plain", "checkpoints", "checkpoints", "plain"):
        path = ckdir if turn == "checkpoints" else ""
        with config.set(stream_checkpoint_path=path), _SaveClock() as clock:
            t0 = time.perf_counter()
            chk = lbfgs_fit()
            walls[turn].append(time.perf_counter() - t0)
        n_saves.append(len(clock.ms))
        _bit_equal(f"streamed lbfgs, {turn}", chk, ctl, glm_attrs)
        if chk.solver_info_["data_passes"] != passes or os.listdir(ckdir):
            raise AssertionError(f"streamed lbfgs, {turn}: passes "
                                 f"{chk.solver_info_}, {os.listdir(ckdir)}")
        report["saves_ms"] += clock.ms
    report["pass_ms"] = {k: [1e3 * w / passes for w in v]
                         for k, v in walls.items()}
    log(f"phase 26, streamed lbfgs with pass checkpoints: bit-equal to "
        f"phase 12's fit, {passes} passes, {max(n_saves)} saves a fit; "
        f"fits in turns (plain, checkpoints, checkpoints, plain): "
        f"checkpoints {', '.join(f'{w:.3f}' for w in walls['checkpoints'])}"
        f" s, plain {', '.join(f'{w:.3f}' for w in walls['plain'])} s "
        f"(phase 12's median {ctl_s:.3f} s)")

    # kill in pass 12, resume
    crash = 12 * n_blocks + n_blocks // 3
    res, saved, launches, wall = _resume(
        "streamed lbfgs resume", lbfgs_fit, crash, ckdir, "glm", ctl,
        glm_attrs)
    if int(saved["passes"]) + res.stream_stats_["passes"] != passes or \
            res.solver_info_["data_passes"] != passes:
        raise AssertionError(f"streamed lbfgs resume: {int(saved['passes'])}"
                             f" saved + {res.stream_stats_['passes']} run, "
                             f"not {passes}")
    log(f"phase 26, streamed lbfgs killed at block {crash} (pass 12) and "
        f"resumed after pass {int(saved['passes'])}: bit-equal, "
        f"{res.stream_stats_['passes']} passes run ({wall:.3f} s), "
        f"launches {launches} against the control's {ctl_launches}")

    # 2. SGD, shuffled, 3 epochs: killed in epoch 2
    def sgd_fit():
        est = SGDClassifier(max_iter=STREAM_SGD_EPOCHS, random_state=0,
                            shuffle=True).fit(mm, y_h)
        torch.cuda.synchronize()
        return est

    fused.reset_launches()
    sgd_ctl = sgd_fit()
    sgd_launches = _launch_total()
    sb = sgd_ctl.solver_info_["n_blocks"]
    res, saved, launches, wall = _resume(
        "streamed SGD resume", sgd_fit, sb + sb // 2, ckdir, "sgd", sgd_ctl,
        ("coef_", "intercept_", "_t"))
    log(f"phase 26, streamed SGD (shuffled, {STREAM_SGD_EPOCHS} epochs) "
        f"killed in epoch 2 and resumed after epoch {int(saved['epoch'])}: "
        f"bit-equal ({wall:.3f} s), launches {launches} against "
        f"{sgd_launches}")

    # 6. an io fault on a host read, retried
    counters_reset()
    reset_plans()
    with config.set(fault_plan="staging_read:io@3"):
        retried = lbfgs_fit()
    reset_plans()
    retries = counters_snapshot().get("stream_retries")
    _bit_equal("retried streamed lbfgs", retried, ctl, glm_attrs)
    if retries != 1:
        raise AssertionError(f"retried streamed lbfgs: {retries} retries")
    log(f"phase 26, staging_read:io@3: 1 retry, the fit bit-equal to "
        f"phase 12's")

    # 7. a NaN in a staging copy: raise, then quarantine
    with config.set(fault_plan="staging_read:nan@3", stream_nonfinite="raise"):
        try:
            lbfgs_fit()
        except NonFiniteBlock as e:
            log(f"phase 26, staging_read:nan@3 under 'raise': {e}")
        else:
            raise AssertionError("stream_nonfinite='raise' did not raise")
    reset_plans()
    counters_reset()
    with config.set(fault_plan="staging_read:nan@3",
                    stream_nonfinite="quarantine"):
        q = LogisticRegression(solver="lbfgs", max_iter=3,
                               tol=0.0).fit(mm, y_h)
    reset_plans()
    n_q = counters_snapshot().get("stream_quarantined_blocks")
    if n_q != 1 or not np.isfinite(q.coef_).all():
        raise AssertionError(f"quarantine: {n_q} blocks, coef_ finite "
                             f"{np.isfinite(q.coef_).all()}")
    if not np.all(np.isfinite(np.asarray(mm[:1000]))):
        raise AssertionError("the nan fault wrote into the memmap")
    log(f"phase 26, staging_read:nan@3 under 'quarantine': 1 block "
        f"quarantined, lbfgs (max_iter=3) finite, the memmap untouched")

    # 8. the card's numbers: first-pass host fill with the training
    # profile off and on, a pass under 'raise' against 'off' (in turns)
    rows = {}
    pairs = [("profile off", dict(obs_drift=False)),
             ("profile on", dict(obs_drift=True)),
             ("nonfinite off", dict(stream_nonfinite="off", obs_drift=False)),
             ("nonfinite raise", dict(stream_nonfinite="raise",
                                      obs_drift=False))]
    for a, b in (pairs[:2], pairs[2:]):
        for key, cfg in (a, b, b, a, a, b):
            rows.setdefault(key, []).append(_stream_pass_ms(mm, y_h, **cfg))
    report["passes"] = rows
    for key, vals in rows.items():
        h, w, p = (statistics.median(v) for v in zip(*vals))
        log(f"phase 26, one first pass of the 4.1 GB memmap, {key}: "
            f"median host fill {h:.1f} ms, wait {w:.1f} ms, pass {p:.1f} ms "
            f"(passes {', '.join(f'{v[2]:.1f}' for v in vals)} ms)")


def phase_ckpt_kmeans(tmp, mm, X, km_stream, km_resident, report):
    """Phase 26 (KMeans): phase 13's streamed fit killed in its last
    Lloyd pass and resumed, phase 5's resident fit (blobs) saving every
    iteration, killed after its first save and resumed: centers,
    inertia_ and n_iter_ bit-equal to the controls."""
    from dask_ml_tpu_torch.cluster import KMeans
    from dask_ml_tpu_torch.ops import fused

    ckdir = os.path.join(tmp, "ckpt", "kmeans")
    os.makedirs(ckdir, exist_ok=True)
    init = X[:KM_K].cpu().numpy()
    attrs = ("cluster_centers_", "inertia_", "n_iter_")

    def fit():
        km = KMeans(n_clusters=KM_K, init=init, max_iter=10,
                    tol=0.0).fit(mm)
        torch.cuda.synchronize()
        return km

    nb = -(-KM_N // STREAM_KM_ROWS)
    n_iter = km_stream.n_iter_
    if n_iter < 2:
        raise AssertionError(f"streamed KMeans took {n_iter} iterations: "
                             "no pass to kill after a save")
    # the moments pass, then Lloyd: killed mid-way through the last one
    res, saved, launches, wall = _resume(
        "streamed KMeans resume", fit, n_iter * nb + nb // 2, ckdir,
        "kmeans", km_stream, attrs + ("labels_",))
    k9 = fused.launches()["fused_kmeans_block_stats"]
    want = (n_iter - int(saved["it"])) * nb
    if k9 != want:
        raise AssertionError(f"streamed KMeans resume: {k9} kernel-9 "
                             f"launches, not {want}")
    log(f"phase 26, streamed KMeans killed in Lloyd pass {n_iter} and "
        f"resumed after iteration {int(saved['it'])}: centers, labels_, "
        f"inertia_ and n_iter_ bit-equal ({wall:.3f} s); kernel-9 launches "
        f"{k9} (the control's {n_iter * nb}), {launches} in all")

    path = os.path.join(ckdir, "resident")
    kw = dict(n_clusters=KM_K, init=init, max_iter=10, tol=0.0,
              checkpoint_path=path, checkpoint_every=1)
    # one seed per blob: the fit settles in a few iterations, so it saves
    # every iteration and is killed after the first save
    with _SaveClock(kill_after=1) as clock:
        try:
            KMeans(**kw).fit(X)
        except _Killed:
            pass
    fused.reset_launches()
    with _SaveClock() as clock2:
        res = KMeans(**kw).fit(X)
        torch.cuda.synchronize()
    launches = fused.launches()
    _bit_equal("resident KMeans resume", res, km_resident, attrs)
    if os.path.exists(path):
        raise AssertionError("resident KMeans left its checkpoint")
    report["saves_ms"] += clock.ms + clock2.ms
    log(f"phase 26, resident KMeans {KM_N}x{KM_D} in chunks of 1: killed "
        f"after save 1, resumed, bit-equal to phase 5's blobs fit; "
        f"launches {launches['fused_lloyd_stats']} (kernel 2) against the "
        f"control's {km_resident.n_iter_}")
    ms = report["saves_ms"]
    pm = report["pass_ms"]
    log(f"phase 26: {len(ms)} checkpoint saves, median "
        f"{statistics.median(ms):.2f} ms, most {max(ms):.2f} ms "
        f"({_filesystem(tmp)}); a streamed lbfgs pass (fit wall / passes) "
        f"with checkpoints {', '.join(f'{v:.1f}' for v in pm['checkpoints'])}"
        f" ms, without {', '.join(f'{v:.1f}' for v in pm['plain'])} ms")


SERVE_N, SERVE_D = 200_000, 128
SERVE_REQUESTS = 400
SERVE_CLIENTS = 8
SERVE_LADDER = (8, 512, 2.0)
SERVE_TIE = 1e-5                  # |margin| at or under it: a tie, not held
INT8_N, INT8_D, INT8_BATCH, INT8_REPS = 400_000, 64, 4096, 30
INT8_AGREE = 0.995
FLEET_PASSES = 3
FLEET_CLIENTS = 4
FLEET_RESULT_S = 60.0             # every wait of phase 27 has its limit


def _serve_mix(n_pool):
    """bench.py's _bench_serving request mix: 400 sizes log-uniform in
    [1, 256] (RandomState(11)) and their offsets into a pool of rows."""
    rng = np.random.RandomState(11)
    sizes = np.maximum(np.exp(rng.uniform(
        0, np.log(256), size=SERVE_REQUESTS)).astype(int), 1)
    offs = [int(rng.randint(0, n_pool - s)) for s in sizes]
    return [(i, int(n)) for n, i in zip(sizes, offs)]


def _captures():
    from dask_ml_tpu_torch.observability import counters_snapshot

    return counters_snapshot().get("graph_captures", 0)


def _run_clients(n_clients, work, what):
    """Run ``work(c)`` on ``n_clients`` threads, each joined within
    FLEET_RESULT_S; any error or straggler fails the phase."""
    import threading

    errs = []

    def run(c):
        try:
            work(c)
        except BaseException as exc:  # noqa: BLE001 - reported below
            errs.append(f"client {c}: {exc!r}")

    threads = [threading.Thread(target=run, args=(c,))
               for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(FLEET_RESULT_S)
    if any(t.is_alive() for t in threads) or errs:
        raise AssertionError(f"{what}: {errs[:3] or 'a client hung'}")


def _held_labels(what, got, want, margin):
    """Served labels against direct ones, rows with |margin| <= SERVE_TIE
    (a float tie the two products may break apart) left out; returns
    their count."""
    keep = np.abs(margin) > SERVE_TIE
    if not np.array_equal(np.asarray(got)[keep], np.asarray(want)[keep]):
        raise AssertionError(f"{what}: served labels differ from predict")
    return int((~keep).sum())


def phase_serving(results):
    """Phase 27 (a), bench.py's _bench_serving on the card, and the sparse
    entry point."""
    import scipy.sparse as sp

    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.ops import fused
    from dask_ml_tpu_torch.serving import BucketLadder, ModelServer
    from dask_ml_tpu_torch.wrappers import sparse_batch_fn

    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    X = torch.randn((SERVE_N, SERVE_D), generator=gen, device=dev)
    y = (X[:, 0] + 0.3 * torch.randn(SERVE_N, generator=gen, device=dev)
         > 0).float()
    fused.reset_launches()
    clf = LogisticRegression(solver="lbfgs", max_iter=20).fit(X, y)
    torch.cuda.synchronize()
    fit_launches = fused.launches()["fused_glm_value_grad"]
    results["fused_glm_value_grad"].setdefault(
        "launches_by_path", {})["serving_fit"] = fit_launches
    Xh = X.cpu().numpy()
    del X, y
    mix = _serve_mix(SERVE_N)
    total_rows = sum(n for _, n in mix)
    want = clf.predict(Xh)
    margin = clf.decision_function(Xh)

    t0 = time.perf_counter()
    for i, n in mix:
        clf.predict(Xh[i:i + n])
    naive_s = time.perf_counter() - t0

    srv = ModelServer(clf, methods=("predict",),
                      ladder=BucketLadder(*SERVE_LADDER),
                      batch_window_ms=1.0, timeout_ms=0)
    c0 = _captures()
    t0 = time.perf_counter()
    srv.warmup()
    warm_s = time.perf_counter() - t0
    warm_captures = _captures() - c0
    if warm_captures != len(srv.ladder):
        raise AssertionError(f"warmup captured {warm_captures} graphs for "
                             f"{len(srv.ladder)} buckets")
    shares = [mix[c::SERVE_CLIENTS] for c in range(SERVE_CLIENTS)]
    answers = {}

    def serve_all():
        def work(c):
            for i, n in shares[c]:
                answers[(i, n)] = srv.submit(Xh[i:i + n]).result(
                    FLEET_RESULT_S)

        _run_clients(SERVE_CLIENTS, work, "served mix")

    with srv:
        c1 = _captures()
        t0 = time.perf_counter()
        serve_all()
        served_s = time.perf_counter() - t0
        stats = srv.stats()
        wall, busy, top = device_busy_ms(serve_all)
        after = _captures() - c1
    if after:
        raise AssertionError(f"{after} graph captures after warmup()")
    ties = sum(_held_labels("served mix", answers[(i, n)], want[i:i + n],
                            margin[i:i + n]) for i, n in mix)
    lat = stats["latency_s"]
    log(f"serving_throughput_rows_per_sec {total_rows / served_s:.6g} "
        f"({SERVE_REQUESTS} requests, {total_rows} rows of {SERVE_N}x"
        f"{SERVE_D}, {SERVE_CLIENTS} clients, BucketLadder"
        f"{SERVE_LADDER}, window 1 ms; {stats['batches']} batches); "
        f"latency p50 {lat['p50'] * 1e3:.3f} ms, p99 "
        f"{lat['p99'] * 1e3:.3f} ms; naive per-request predict loop "
        f"{total_rows / naive_s:.6g} rows/s ({naive_s:.3f} s); warmup "
        f"{warm_s:.3f} s for {warm_captures} graphs; 0 captures after "
        f"warmup; every answer equal to predict ({ties} tie rows); "
        f"LogisticRegression fit launches of kernel 1: {fit_launches}")
    log(busy_line("served mix", wall, busy, top))
    # the worker's execute wall per bucket (pack to read-back, queue wait
    # out): what of a request's latency the card's path takes
    log("served mix execute ms by bucket (count, p50, p90): " + "; ".join(
        f"{k.split(':')[1]}: {v['count']}, {v['p50_s'] * 1e3:.3f}, "
        f"{v['p90_s'] * 1e3:.3f}" for k, v in stats["exec_s"].items()))

    # the sparse entry point: a CSR sample of the same rows, one graph per
    # (rows, nnz) cell, labels against predict of the dense rows
    rng = np.random.RandomState(12)
    rows = Xh[:512] * (rng.rand(512, SERVE_D) < 0.1)
    sfn = sparse_batch_fn(clf, "predict")
    c2 = _captures()
    got = sfn(sp.csr_matrix(rows), n_rows=512)
    got_again = sfn(sp.csr_matrix(rows), n_rows=512)
    _held_labels("sparse entry point", got, clf.predict(rows),
                 clf.decision_function(rows))
    if not np.array_equal(got, got_again) or _captures() - c2 != 1:
        raise AssertionError("sparse entry point: not one graph replayed")
    log(f"sparse entry point: 512 CSR rows, {sp.csr_matrix(rows).nnz} "
        f"nonzeros, labels equal to predict, one graph captured and "
        f"replayed")


def phase_serving_int8():
    """Phase 27 (b), bench.py's _bench_int8_serving on the card."""
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.wrappers import compiled_batch_fn

    rng = np.random.RandomState(9)
    X = rng.randn(INT8_N, INT8_D).astype(np.float32)
    w = rng.randn(INT8_D).astype(np.float32)
    y = (X @ w + 0.5 * rng.randn(INT8_N) > 0).astype(np.float32)
    clf = LogisticRegression(solver="lbfgs", max_iter=30).fit(
        X[:50_000], y[:50_000])
    f32 = compiled_batch_fn(clf, "predict")
    q8 = compiled_batch_fn(clf, "predict", quantize="int8")
    batch = X[:INT8_BATCH]
    f32(batch)
    q8(batch)

    def best_of(fn):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(INT8_REPS):
                fn(batch)
            best = min(best, time.perf_counter() - t0)
        return INT8_BATCH * INT8_REPS / best

    r32 = best_of(f32)
    r8 = best_of(q8)
    agree = float(np.mean(f32(X[:100_000]) == q8(X[:100_000])))
    log(f"serving_predict_int8_rows_per_sec_per_chip {r8:.6g} (f32 "
        f"{r32:.6g} rows/s, ratio {r8 / r32:.3f}; {INT8_N}x{INT8_D}, "
        f"batches of {INT8_BATCH}, {INT8_REPS} repeats, best of 3); "
        f"agreement with f32 {agree:.5f}")
    if agree < INT8_AGREE:
        raise AssertionError(f"int8 agreement {agree} < {INT8_AGREE}")


def phase_serving_fleet(Xi, yi, results):
    """Phase 27 (c): serve_while_training of Incremental(SGDClassifier) on
    phase 15's 2M x 128 through a 2-replica FleetServer under 4 clients,
    then a replica_worker crash under serving_supervise."""
    from dask_ml_tpu_torch import config
    from dask_ml_tpu_torch.linear_model import SGDClassifier
    from dask_ml_tpu_torch.observability import counters_snapshot
    from dask_ml_tpu_torch.ops import fused
    from dask_ml_tpu_torch.parallel import ShardedArray
    from dask_ml_tpu_torch.serving import (BucketLadder, FleetServer,
                                           ServingError,
                                           serve_while_training)
    from dask_ml_tpu_torch.wrappers import Incremental

    Xs, ys = ShardedArray.from_array(Xi), ShardedArray.from_array(yi)
    pool = Xi[:SERVE_N].cpu().numpy()
    mix = _serve_mix(SERVE_N)
    inc = Incremental(SGDClassifier(max_iter=1, random_state=0),
                      shuffle_blocks=False)
    inc.partial_fit(Xs, ys, classes=np.array([0.0, 1.0]))
    fleet = FleetServer(inc.estimator_, name="online", replicas=2,
                        ladder=BucketLadder(*SERVE_LADDER),
                        batch_window_ms=1.0, timeout_ms=0).warmup()
    import threading

    stop = threading.Event()
    log_ = []
    flips = []

    def work(c):
        k = c
        while not stop.is_set():
            i, n = mix[k % len(mix)]
            k += FLEET_CLIENTS
            # served by a version between the fleet's (set once every
            # replica swapped) and the registry's current one (set before
            # the swaps)
            v0 = fleet.version
            out = fleet.submit(pool[i:i + n]).result(FLEET_RESULT_S)
            log_.append((i, n, v0,
                         fleet.registry.current_version("online"), out))

    client_errs = []

    def clients_main():
        try:
            _run_clients(FLEET_CLIENTS, work, "fleet mix")
        except BaseException as exc:  # noqa: BLE001 - raised below
            client_errs.append(exc)

    with fleet:
        c0 = _captures()
        clients = threading.Thread(target=clients_main)
        clients.start()
        time.sleep(0.2)
        fused.reset_launches()
        t0 = time.perf_counter()
        serve_while_training(
            fleet, inc, Xs, ys, passes=FLEET_PASSES,
            classes=np.array([0.0, 1.0]),
            on_pass=lambda p, v: (flips.append(v), time.sleep(0.2)))
        train_s = time.perf_counter() - t0
        launches = fused.launches()["fused_sgd_block_grad"]
        time.sleep(0.2)
        stop.set()
        clients.join(FLEET_RESULT_S + 5)
        captures = _captures() - c0
    if clients.is_alive():
        raise AssertionError("fleet clients did not finish")
    if client_errs:
        raise client_errs[0]
    results["fused_sgd_block_grad"].setdefault(
        "launches_by_path", {})["serve_while_training"] = launches
    if launches != 8 * FLEET_PASSES or captures:
        raise AssertionError(f"serve_while_training: {launches} kernel-5 "
                             f"launches, {captures} graph captures")
    preds, margins = {}, {}
    for v in fleet.registry.versions("online"):
        est = fleet.registry.get("online", v).estimator
        preds[v], margins[v] = est.predict(pool), est.decision_function(pool)
    served_by = {}
    for i, n, v0, v1, out in log_:
        ok = [v for v in range(v0, v1 + 1) if v in preds and np.array_equal(
            out[np.abs(margins[v][i:i + n]) > SERVE_TIE],
            preds[v][i:i + n][np.abs(margins[v][i:i + n]) > SERVE_TIE])]
        if not ok:
            raise AssertionError(f"fleet answer at {i}+{n} matches no "
                                 f"version in {v0}..{v1}")
        served_by[ok[-1]] = served_by.get(ok[-1], 0) + 1
    log(f"serve_while_training: {FLEET_PASSES} passes of Incremental("
        f"SGDClassifier) on {SGD_N}x{SGD_D} in {train_s:.3f} s (with "
        f"0.2 s of traffic after each publish), versions {flips}; "
        f"fused_sgd_block_grad launches {launches}; {len(log_)} answers "
        f"from {FLEET_CLIENTS} clients through 2 replicas, each equal to "
        f"the prediction of a version live while it was served "
        f"({served_by}); 0 graph captures across the publishes")

    # a replica worker crash under supervision: every request is answered
    # or fails typed, and the slot is rebuilt
    with config.set(fault_plan="replica_worker:crash@10",
                    serving_supervise=True,
                    serving_supervise_interval_s=0.05):
        crash = FleetServer(inc.estimator_, name="crash", replicas=2,
                            ladder=BucketLadder(*SERVE_LADDER),
                            batch_window_ms=1.0, timeout_ms=0).warmup()
    restarts0 = counters_snapshot().get("serving_replica_restarts", 0)
    outcomes = {"ok": 0, "typed": 0}
    want = inc.estimator_.predict(pool)

    def crash_work(c):
        for i, n in mix[c::FLEET_CLIENTS]:
            try:
                out = crash.submit(pool[i:i + n]).result(FLEET_RESULT_S)
                outcomes["ok"] += 1
                if not np.array_equal(out, want[i:i + n]):
                    raise AssertionError("crash run: wrong answer")
            except ServingError:
                outcomes["typed"] += 1
            time.sleep(0.002)

    with crash:
        _run_clients(FLEET_CLIENTS, crash_work, "crash mix")
        t_end = time.perf_counter() + FLEET_RESULT_S
        while time.perf_counter() < t_end and counters_snapshot().get(
                "serving_replica_restarts", 0) == restarts0:
            time.sleep(0.05)
        restarts = counters_snapshot().get(
            "serving_replica_restarts", 0) - restarts0
    log(f"replica_worker:crash under serving_supervise: {outcomes['ok']} "
        f"answered, {outcomes['typed']} failed typed of {len(mix)}; "
        f"replica restarts {restarts}")
    if outcomes["ok"] + outcomes["typed"] != len(mix) or restarts < 1:
        raise AssertionError("crash run: lost requests or no restart")


def phase_serving_kmeans(X, blobs_fit):
    """Phase 27 (d): phase 5's blobs KMeans served, labels equal to
    predict."""
    from dask_ml_tpu_torch.base import to_host
    from dask_ml_tpu_torch.serving import BucketLadder, ModelServer

    pool = X[:SERVE_N].cpu().numpy()
    want = to_host(blobs_fit.predict(pool))
    mix = _serve_mix(SERVE_N)
    srv = ModelServer(blobs_fit, methods=("predict",),
                      ladder=BucketLadder(*SERVE_LADDER),
                      batch_window_ms=1.0, timeout_ms=0).warmup()
    c0 = _captures()
    answers = {}

    def work(c):
        for i, n in mix[c::SERVE_CLIENTS]:
            answers[(i, n)] = srv.submit(pool[i:i + n]).result(
                FLEET_RESULT_S)

    with srv:
        _run_clients(SERVE_CLIENTS, work, "served KMeans")
    for (i, n), got in answers.items():
        if not np.array_equal(got, want[i:i + n]):
            raise AssertionError("served KMeans labels differ from predict")
    if _captures() - c0:
        raise AssertionError("served KMeans captured after warmup()")
    log(f"served KMeans k={KM_K}: {len(answers)} requests, labels equal to "
        f"predict, 0 captures after warmup")


# -- phase 28: processes ------------------------------------------------------

PROC_WORLD = 2
PROC_DEVICE = "cuda"
# rows per process at the full widths of phases 4, 5, 15 and 19 (depth
# cut to keep the phase near a minute); the search's data is cut from
# the C-grid phase's 1M x 64 to 100,000 x 64, each process holding a copy
PROC_GLM = (1_000_000, 256)
PROC_KM = (1_000_000, 128, 64)
PROC_PCA = (250_000, 512)
PROC_SGD = (500_000, 128)
PROC_SGD_BLOCK = 62_500             # 8 blocks per process, groups of 2
PROC_SGD_ACCUM = 2
PROC_SEARCH = (100_000, 64)         # each process's copy of the search data
PROC_SEARCH_CS = [0.01, 0.1, 1.0, 10.0]
PROC_LBFGS_ITER = STREAM_LBFGS_ITER
# a stop above float32's noise floor of the lbfgs loss: there the merged
# fit and its twin take the same passes (at tol=0 both reach the floor,
# where the Armijo trials part on one-ulp differences of the loss)
PROC_LBFGS_TOL = 1e-4
PROC_NEWTON_ITER = 5
PROC_RESIDENT_ITER = 50
PROC_KM_ITER = 30
PROC_PCA_K = 16
PROC_DEADLINE_S = 400               # both processes, start to exit
PROC_SYNC_TIMEOUT_S = 5.0
PROC_HANG_S = 60.0
PROC_KM_CENTERS_ATOL = 1e-3
PROC_KM_INERTIA_RTOL = 1e-4
PROC_PCA_RTOL = 1e-4
# uneven ranks: rank 1 shorter than one block of the GLM memmap's width
# (256 MB / (257 x 4 bytes) = 261,123 rows), ndarrays so that rank 1
# alone would take the resident route
PROC_UNEVEN = (1_000_000, 100_000)
PROC_UNEVEN_BLOCK = 261_123
# phase 29: feature sharding at bench.py's _mesh2d_measure width
FS_SHAPE = (1_000_000, 512)
FS_CLASSES = 10
FS_NEWTON_ROWS = 250_000
FS_NEWTON_ITER = 3
FS_KM = (250_000, 16, 10)            # rows, k, Lloyd iterations
FS_PCA_K = 16
FS_RESIDENT_ITER = 50
# between the 1-D ring (2 slots x 131,072 rows x (512 + 1) x 4 bytes =
# 537.9 MB) and the 1x2 tiles' (2 x 131,072 x (256 + 1) x 4 = 269.5 MB)
FS_BUDGET = 400_000_000
FS_COMP_ATOL = 1e-3


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _proc_half(entry, rank):
    """This rank's rows of a memmap of the spec: the file opened at the
    byte offset of its half."""
    n_local, d = entry["n_local"], entry["d"]
    return np.memmap(entry["path"], dtype=np.float32, mode="r",
                     offset=rank * n_local * d * 4, shape=(n_local, d))


def _search_data():
    """The search's data, drawn alike in every process from one seed."""
    rng = np.random.RandomState(28)
    n, d = PROC_SEARCH
    X = rng.randn(n, d).astype(np.float32)
    w = rng.randn(d) / np.sqrt(d)
    y = (X @ w + 0.5 * rng.randn(n) > 0).astype(np.float32)
    return X, y


def process_worker(rank, spec_path):
    """One process of phase 28: join the gloo group over the file store,
    run every fit on this process's half of the data, write the results
    and exit (``os._exit``: the pass-barrier probe leaves a helper
    thread in a collective that would hold the interpreter)."""
    import hashlib

    with open(spec_path) as f:
        spec = json.load(f)
    status = 1
    out = {"rank": rank, "fits": {}}
    arrays = {}
    try:
        if spec.get("phase") == 29:
            _feature_fits(rank, spec, out, arrays)
        else:
            _process_fits(rank, spec, out, arrays, hashlib)
        status = 0
    except BaseException as exc:  # noqa: BLE001 - reported to the parent
        import traceback

        out["error"] = "".join(traceback.format_exception(exc))
    finally:
        base = os.path.join(spec["tmp"], f"rank{rank}")
        np.savez(base + ".npz", **arrays)
        with open(base + ".json", "w") as f:
            json.dump(out, f)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(status)


def _process_fits(rank, spec, out, arrays, hashlib):
    from dask_ml_tpu_torch import config
    from dask_ml_tpu_torch.cluster import KMeans
    from dask_ml_tpu_torch.decomposition import PCA
    from dask_ml_tpu_torch.linear_model import (LogisticRegression,
                                                SGDClassifier)
    from dask_ml_tpu_torch.model_selection import GridSearchCV
    from dask_ml_tpu_torch.ops import fused
    from dask_ml_tpu_torch.parallel import distributed as dist
    from dask_ml_tpu_torch.reliability import reset_plans

    torch.backends.cuda.matmul.allow_tf32 = False
    mm = spec["memmaps"]
    with config.set(device=spec["device"]):
        t0 = time.perf_counter()
        dist.initialize(init_method="file://" + spec["store"],
                        world_size=PROC_WORLD, rank=rank,
                        timeout_s=PROC_DEADLINE_S)
        out["init_s"] = time.perf_counter() - t0
        if dist.process_count() != PROC_WORLD or dist.process_index() != rank:
            raise AssertionError("the process group did not form")

        def run(tag, fit):
            dist.barrier()
            _sync()
            fused.reset_launches()
            dist.reset_plane_stats()
            t0 = time.perf_counter()
            est = fit()
            _sync()
            out["fits"][tag] = {"wall_s": time.perf_counter() - t0,
                                "launches": fused.launches(),
                                "plane": dict(dist.plane_stats)}
            return est

        # two psum_host runs bit-equal, and equal on both ranks
        v = np.random.RandomState(rank).randn(1 << 14)
        a, b = dist.psum_host(v), dist.psum_host(v)
        digs = dist.allgather_object(
            (hashlib.sha1(a.tobytes()).hexdigest(),
             hashlib.sha1(b.tobytes()).hexdigest()))
        if len({d for pair in digs for d in pair}) != 1:
            raise AssertionError(f"psum_host is not bit-equal: {digs}")
        out["psum_digest"] = digs[0][0]

        Xg = _proc_half(mm["glm"], rank)
        yg = np.load(mm["glm"]["y"], mmap_mode="r")[
            rank * mm["glm"]["n_local"]:(rank + 1) * mm["glm"]["n_local"]]
        yg = np.ascontiguousarray(yg)
        for tag, kw in [
                ("stream_lbfgs", dict(solver="lbfgs",
                                      max_iter=PROC_LBFGS_ITER, tol=0.0)),
                ("stream_lbfgs_tol", dict(solver="lbfgs",
                                          max_iter=PROC_LBFGS_ITER,
                                          tol=PROC_LBFGS_TOL)),
                ("stream_newton", dict(solver="newton",
                                       max_iter=PROC_NEWTON_ITER))]:
            est = run(tag, lambda: LogisticRegression(**kw).fit(Xg, yg))
            info = est.solver_info_
            rec = out["fits"][tag]
            rec.update(passes=info["data_passes"], n_blocks=info["n_blocks"],
                       n_iter=int(est.n_iter_),
                       grad_norms=info.get("grad_norms"),
                       armijo_trials=info.get("armijo_trials"))
            if spec["kernels"] and rec["launches"]["fused_glm_stream"] != \
                    info["data_passes"] * info["n_blocks"]:
                raise AssertionError(f"{tag}: launches {rec['launches']}, "
                                     f"{info}")
            arrays[tag] = est.coef_

        Xr = dist.array_from_process_local(np.asarray(Xg))
        if Xr.global_rows != PROC_WORLD * mm["glm"]["n_local"]:
            raise AssertionError(f"global rows {Xr.global_rows}")
        est = run("resident_lbfgs", lambda: LogisticRegression(
            solver="lbfgs", max_iter=PROC_RESIDENT_ITER, tol=0.0).fit(Xr, yg))
        arrays["resident_lbfgs"] = est.coef_
        out["fits"]["resident_lbfgs"]["n_iter"] = int(est.n_iter_)
        del Xr

        Xk = _proc_half(mm["km"], rank)
        init = np.load(mm["km"]["init"])
        est = run("stream_kmeans", lambda: KMeans(
            PROC_KM[2], init=init, max_iter=PROC_KM_ITER).fit(Xk))
        arrays["stream_kmeans"] = est.cluster_centers_
        out["fits"]["stream_kmeans"].update(inertia=est.inertia_,
                                            n_iter=int(est.n_iter_))
        Xkr = dist.array_from_process_local(np.asarray(Xk))
        est = run("resident_kmeans", lambda: KMeans(
            PROC_KM[2], init=init, max_iter=PROC_KM_ITER).fit(Xkr))
        arrays["resident_kmeans"] = est.cluster_centers_
        out["fits"]["resident_kmeans"].update(inertia=est.inertia_,
                                              n_iter=int(est.n_iter_))
        del Xkr

        Xs = _proc_half(mm["sgd"], rank)
        ys = np.load(mm["sgd"]["y"], mmap_mode="r")[
            rank * mm["sgd"]["n_local"]:(rank + 1) * mm["sgd"]["n_local"]]
        ys = np.ascontiguousarray(ys)
        with config.set(stream_grad_accum=PROC_SGD_ACCUM,
                        stream_block_rows=PROC_SGD_BLOCK):
            est = run("grad_accum_sgd", lambda: SGDClassifier(
                max_iter=2, shuffle=False, random_state=0).fit(Xs, ys))
        arrays["grad_accum_sgd"] = est.coef_
        out["fits"]["grad_accum_sgd"]["steps"] = int(est._t)

        Xp = _proc_half(mm["pca"], rank)
        est = run("stream_pca", lambda: PCA(
            PROC_PCA_K, svd_solver="full").fit(Xp))
        arrays["stream_pca"] = est.singular_values_

        Xq, yq = _search_data()
        grid = {"C": PROC_SEARCH_CS, "tol": [1e-6]}
        est = run("search", lambda: GridSearchCV(
            LogisticRegression(solver="lbfgs", max_iter=30), grid, cv=2,
            refit=False).fit(Xq, yq))
        arrays["search"] = np.asarray(est.cv_results_["mean_test_score"])
        out["fits"]["search"]["tasks"] = list(est._dist_stats)

        _uneven_fits(rank, spec, run, out, arrays)

        # the pass barrier's deadline: rank 1 hangs in its barrier, rank
        # 0 must end with the typed StreamSyncTimeout
        reset_plans()
        plan = f"pass_barrier:hang@0/{PROC_HANG_S:g}" if rank == 1 else ""
        dist.barrier()
        t0 = time.perf_counter()
        try:
            with config.set(fault_plan=plan,
                            stream_sync_timeout_s=PROC_SYNC_TIMEOUT_S):
                LogisticRegression(solver="lbfgs", max_iter=1).fit(Xg, yg)
            out["hang"] = {"raised": None}
        except dist.StreamSyncTimeout as exc:
            out["hang"] = {"raised": "StreamSyncTimeout", "message": str(exc),
                           "after_s": time.perf_counter() - t0}
        if rank == 0 and out["hang"]["raised"] != "StreamSyncTimeout":
            raise AssertionError(f"pass barrier hang: {out['hang']}")


def _uneven_fits(rank, spec, run, out, arrays):
    """Phase 28's uneven and empty ranks: rank 1 shorter than a block
    (ndarrays under ``PROC_UNEVEN_BLOCK``: the fits agree on the route, so
    rank 1 streams its one block), then rank 1 empty beside rank 0's
    half (resident fits over ``array_from_process_local``)."""
    from dask_ml_tpu_torch import config
    from dask_ml_tpu_torch.cluster import KMeans
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.parallel import distributed as dist

    mm = spec["memmaps"]
    lo = 0 if rank == 0 else PROC_UNEVEN[0]
    hi = lo + PROC_UNEVEN[rank]

    def rows(entry, a, b):
        full = np.memmap(entry["path"], dtype=np.float32, mode="r",
                         shape=(PROC_WORLD * entry["n_local"], entry["d"]))
        return np.ascontiguousarray(full[a:b])

    y_all = np.load(mm["glm"]["y"])
    Xu, yu = rows(mm["glm"], lo, hi), np.ascontiguousarray(y_all[lo:hi])
    init = np.load(mm["km"]["init"])
    with config.set(stream_block_rows=PROC_UNEVEN_BLOCK):
        est = run("uneven_stream_lbfgs", lambda: LogisticRegression(
            solver="lbfgs", max_iter=PROC_LBFGS_ITER,
            tol=PROC_LBFGS_TOL).fit(Xu, yu))
        info = est.solver_info_
        out["fits"]["uneven_stream_lbfgs"].update(
            passes=info["data_passes"], n_blocks=info["n_blocks"],
            n_iter=int(est.n_iter_), rows=int(hi - lo))
        arrays["uneven_stream_lbfgs"] = est.coef_
        del Xu
        Xk = rows(mm["km"], lo, hi)
        est = run("uneven_stream_kmeans", lambda: KMeans(
            PROC_KM[2], init=init, max_iter=PROC_KM_ITER).fit(Xk))
        out["fits"]["uneven_stream_kmeans"].update(
            inertia=est.inertia_, n_iter=int(est.n_iter_),
            rows=int(hi - lo))
        arrays["uneven_stream_kmeans"] = est.cluster_centers_
        del Xk
    n = PROC_UNEVEN[0] if rank == 0 else 0
    d = mm["glm"]["d"]
    Xe = dist.array_from_process_local(rows(mm["glm"], 0, n))
    est = run("empty_resident_lbfgs", lambda: LogisticRegression(
        solver="lbfgs", max_iter=PROC_RESIDENT_ITER, tol=0.0).fit(
        Xe, np.ascontiguousarray(y_all[:n])))
    out["fits"]["empty_resident_lbfgs"].update(n_iter=int(est.n_iter_),
                                               rows=n, d=d)
    arrays["empty_resident_lbfgs"] = est.coef_
    del Xe
    Xke = dist.array_from_process_local(rows(mm["km"], 0, n))
    est = run("empty_resident_kmeans", lambda: KMeans(
        PROC_KM[2], init=init, max_iter=PROC_KM_ITER).fit(Xke))
    out["fits"]["empty_resident_kmeans"].update(inertia=est.inertia_,
                                                n_iter=int(est.n_iter_),
                                                rows=n)
    arrays["empty_resident_kmeans"] = est.cluster_centers_
    del Xke


def _feature_fits(rank, spec, out, arrays):
    """Phase 29 in one process of the ``"1x2"`` mesh: both ranks open
    the same memmap, each stages (or holds) its 256-column tile."""
    from dask_ml_tpu_torch import config
    from dask_ml_tpu_torch.cluster import KMeans
    from dask_ml_tpu_torch.decomposition import PCA
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.ops import fused
    from dask_ml_tpu_torch.parallel import distributed as dist
    from dask_ml_tpu_torch.parallel.sharded import ShardedArray

    torch.backends.cuda.matmul.allow_tf32 = False
    fs = spec["fs"]
    with config.set(device=spec["device"], mesh_shape="1x2"):
        t0 = time.perf_counter()
        dist.initialize(init_method="file://" + spec["store"],
                        world_size=PROC_WORLD, rank=rank,
                        timeout_s=PROC_DEADLINE_S)
        out["init_s"] = time.perf_counter() - t0
        X = np.memmap(fs["path"], dtype=np.float32, mode="r",
                      shape=tuple(fs["shape"]))
        y, y10 = np.load(fs["y"]), np.load(fs["y10"])
        init = np.load(fs["init"])

        def run(tag, fit, **cfg):
            dist.barrier()
            _sync()
            fused.reset_launches()
            dist.reset_plane_stats()
            if torch.cuda.is_available():
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with config.set(**cfg):
                est = fit()
            _sync()
            info = (getattr(est, "solver_info_", None)
                    or getattr(est, "kernel_info_", None) or {})
            out["fits"][tag] = {
                "wall_s": time.perf_counter() - t0,
                "launches": fused.launches(),
                "plane": dict(dist.plane_stats),
                "peak": torch.cuda.max_memory_allocated()
                if torch.cuda.is_available() else 0,
                "passes": info.get("data_passes"),
                "n_iter": int(np.max(est.n_iter_))
                if getattr(est, "n_iter_", None) is not None else None,
                "reason": info.get("fused_stream_reason",
                                   info.get("kernel_reason")),
                "model_shards": info.get("model_shards")}
            return est

        est = run("fs_stream_lbfgs", lambda: LogisticRegression(
            solver="lbfgs", max_iter=PROC_LBFGS_ITER,
            tol=PROC_LBFGS_TOL).fit(X, y),
            stream_device_byte_budget=FS_BUDGET)
        arrays["fs_stream_lbfgs"] = est.coef_
        est = run("fs_stream_ovr", lambda: LogisticRegression(
            solver="lbfgs", max_iter=PROC_LBFGS_ITER, tol=PROC_LBFGS_TOL,
            C=10.0).fit(X, y10))
        arrays["fs_stream_ovr"] = est.coef_
        Xn = X[:FS_NEWTON_ROWS]
        est = run("fs_stream_newton", lambda: LogisticRegression(
            solver="newton", max_iter=FS_NEWTON_ITER).fit(
            Xn, y[:FS_NEWTON_ROWS]))
        arrays["fs_stream_newton"] = est.coef_
        est = run("fs_stream_pca", lambda: PCA(
            FS_PCA_K, svd_solver="randomized", random_state=0).fit(X))
        arrays["fs_stream_pca_s"] = est.singular_values_
        arrays["fs_stream_pca_c"] = est.components_
        Xs = ShardedArray.from_array(np.asarray(X), shard_features=True)
        out["tile"] = [Xs.col_offset, Xs.col_offset + Xs.data.shape[1]]
        est = run("fs_resident_lbfgs", lambda: LogisticRegression(
            solver="lbfgs", max_iter=FS_RESIDENT_ITER,
            tol=PROC_LBFGS_TOL).fit(Xs, y))
        arrays["fs_resident_lbfgs"] = est.coef_
        del Xs
        n_km, k, it = FS_KM
        Xk = ShardedArray.from_array(np.asarray(np.memmap(
            fs["km"], dtype=np.float32, mode="r",
            shape=(n_km, fs["shape"][1]))), shard_features=True)
        est = run("fs_resident_kmeans", lambda: KMeans(
            k, init=init, max_iter=it, tol=0.0).fit(Xk))
        arrays["fs_resident_kmeans"] = est.cluster_centers_
        out["fits"]["fs_resident_kmeans"]["inertia"] = est.inertia_
        del Xk


def _proc_data(tmp, gen):
    """The phase's data as memmaps under ``tmp`` (both halves in one
    file), with their targets and the KMeans init; returns the spec
    entries."""
    dev = gen.device
    W = PROC_WORLD
    n, d = PROC_GLM
    X = torch.randn(W * n, d, generator=gen, device=dev)
    w = torch.randn(d, generator=gen, device=dev) / d ** 0.5
    y = (torch.sigmoid(X @ w) > torch.rand(W * n, generator=gen,
                                           device=dev)).float()
    glm = {"path": _write_memmap(tmp, "proc_glm.f32", X).filename,
           "n_local": n, "d": d, "y": os.path.join(tmp, "proc_glm_y.npy")}
    np.save(glm["y"], y.cpu().numpy())
    del X, y
    n, d, k = PROC_KM
    C = torch.randn(k, d, generator=gen, device=dev) * 4.0
    lab = torch.randint(0, k, (W * n,), generator=gen, device=dev)
    X = C[lab] + torch.randn(W * n, d, generator=gen, device=dev)
    km = {"path": _write_memmap(tmp, "proc_km.f32", X).filename,
          "n_local": n, "d": d, "init": os.path.join(tmp, "proc_km_init.npy")}
    init = C + 0.5 * torch.randn(k, d, generator=gen, device=dev)
    np.save(km["init"], init.cpu().numpy())
    del X, lab
    n, d = PROC_SGD
    X = torch.randn(W * n, d, generator=gen, device=dev)
    w = torch.randn(d, generator=gen, device=dev)
    y = (X @ w > 0).float()
    sgd = {"path": _write_memmap(tmp, "proc_sgd.f32", X).filename,
           "n_local": n, "d": d, "y": os.path.join(tmp, "proc_sgd_y.npy")}
    np.save(sgd["y"], y.cpu().numpy())
    del X, y
    n, d = PROC_PCA
    decay = DECOMP_DECAY ** torch.arange(d, device=dev, dtype=torch.float32)
    X = torch.randn(W * n, d, generator=gen, device=dev) * decay + 1.0
    pca = {"path": _write_memmap(tmp, "proc_pca.f32", X).filename,
           "n_local": n, "d": d}
    del X
    return {"glm": glm, "km": km, "sgd": sgd, "pca": pca}


def _proc_sgd_twin_data(entry):
    """The single-process data of the grad-accum fit's group order: the
    ranks' groups of PROC_SGD_ACCUM blocks interleaved group by group, so
    a single process at PROC_WORLD x PROC_SGD_ACCUM takes the same blocks
    in each update."""
    n = entry["n_local"]
    full = np.memmap(entry["path"], dtype=np.float32, mode="r",
                     shape=(PROC_WORLD * n, entry["d"]))
    y = np.load(entry["y"])
    g = PROC_SGD_BLOCK * PROC_SGD_ACCUM
    xs, ys = [], []
    for lo in range(0, n, g):
        for r in range(PROC_WORLD):
            a, b = r * n + lo, r * n + min(lo + g, n)
            xs.append(full[a:b])
            ys.append(y[a:b])
    return np.concatenate(xs), np.concatenate(ys)


def phase_processes(results, tmp_root=None):
    """Phase 28: the process plane on the card, two real processes.

    Full widths, depth cut (``PROC_*``): 1M rows a process for the GLM
    and KMeans fits, 500k for SGD, 250k for PCA, and the search's data
    100,000 x 64 in each process against the C-grid phase's 1M x 64."""
    from dask_ml_tpu_torch import config
    from dask_ml_tpu_torch.cluster import KMeans
    from dask_ml_tpu_torch.decomposition import PCA
    from dask_ml_tpu_torch.linear_model import (LogisticRegression,
                                                SGDClassifier)
    from dask_ml_tpu_torch.model_selection import GridSearchCV
    from dask_ml_tpu_torch.ops import fused
    from dask_ml_tpu_torch.parallel.sharded import ShardedArray

    kernels = PROC_DEVICE == "cuda"
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=tmp_root) as tmp, \
            config.set(device=PROC_DEVICE):
        gen = torch.Generator(device=PROC_DEVICE).manual_seed(28)
        mm = _proc_data(tmp, gen)
        _sync()
        if kernels:
            torch.cuda.empty_cache()
        spec = {"tmp": tmp, "store": os.path.join(tmp, "store"),
                "device": PROC_DEVICE, "kernels": kernels, "memmaps": mm}
        outs, arrs, wall2 = _spawn_ranks(spec, tmp, 28)
        log(f"processes: {PROC_WORLD} processes on one card, "
            f"{wall2:.1f} s from spawn to exit (group formed in "
            + ", ".join(f"{o['init_s']:.2f}" for o in outs) + " s); "
            f"psum_host bit-equal on both ranks ({outs[0]['psum_digest'][:12]})")

        # the single-process twins of the concatenated data, in this
        # process
        def full(entry):
            return np.memmap(entry["path"], dtype=np.float32, mode="r",
                             shape=(PROC_WORLD * entry["n_local"], entry["d"]))

        twins, walls = {}, {}

        def twin(tag, fit):
            _sync()
            t0 = time.perf_counter()
            est = fit()
            _sync()
            walls[tag] = time.perf_counter() - t0
            twins[tag] = est
            return est

        Xg, yg = full(mm["glm"]), np.load(mm["glm"]["y"])
        twin("stream_lbfgs", lambda: LogisticRegression(
            solver="lbfgs", max_iter=PROC_LBFGS_ITER, tol=0.0).fit(Xg, yg))
        twin("stream_lbfgs_tol", lambda: LogisticRegression(
            solver="lbfgs", max_iter=PROC_LBFGS_ITER,
            tol=PROC_LBFGS_TOL).fit(Xg, yg))
        twin("stream_newton", lambda: LogisticRegression(
            solver="newton", max_iter=PROC_NEWTON_ITER).fit(Xg, yg))
        Xr = ShardedArray.from_array(np.asarray(Xg))
        twin("resident_lbfgs", lambda: LogisticRegression(
            solver="lbfgs", max_iter=PROC_RESIDENT_ITER, tol=0.0).fit(Xr, yg))
        del Xr
        Xk, init = full(mm["km"]), np.load(mm["km"]["init"])
        twin("stream_kmeans", lambda: KMeans(
            PROC_KM[2], init=init, max_iter=PROC_KM_ITER).fit(Xk))
        Xkr = ShardedArray.from_array(np.asarray(Xk))
        twin("resident_kmeans", lambda: KMeans(
            PROC_KM[2], init=init, max_iter=PROC_KM_ITER).fit(Xkr))
        del Xkr
        Xs, ys = _proc_sgd_twin_data(mm["sgd"])
        with config.set(stream_grad_accum=PROC_WORLD * PROC_SGD_ACCUM,
                        stream_block_rows=PROC_SGD_BLOCK):
            twin("grad_accum_sgd", lambda: SGDClassifier(
                max_iter=2, shuffle=False, random_state=0).fit(Xs, ys))
        twin("stream_pca", lambda: PCA(PROC_PCA_K,
                                       svd_solver="full").fit(full(mm["pca"])))
        Xq, yq = _search_data()
        twin("search", lambda: GridSearchCV(
            LogisticRegression(solver="lbfgs", max_iter=30),
            {"C": PROC_SEARCH_CS, "tol": [1e-6]}, cv=2,
            refit=False).fit(Xq, yq))
        # the uneven ranks' rows [0, 1.1M) and the empty rank's [0, 1M)
        n_un = sum(PROC_UNEVEN)
        with config.set(stream_block_rows=PROC_UNEVEN_BLOCK):
            Xu = np.ascontiguousarray(Xg[:n_un])
            twin("uneven_stream_lbfgs", lambda: LogisticRegression(
                solver="lbfgs", max_iter=PROC_LBFGS_ITER,
                tol=PROC_LBFGS_TOL).fit(Xu, yg[:n_un]))
            del Xu
            Xu = np.ascontiguousarray(Xk[:n_un])
            twin("uneven_stream_kmeans", lambda: KMeans(
                PROC_KM[2], init=init, max_iter=PROC_KM_ITER).fit(Xu))
            del Xu
        n0 = PROC_UNEVEN[0]
        Xr = ShardedArray.from_array(np.asarray(Xg[:n0]))
        twin("empty_resident_lbfgs", lambda: LogisticRegression(
            solver="lbfgs", max_iter=PROC_RESIDENT_ITER, tol=0.0).fit(
            Xr, yg[:n0]))
        del Xr
        Xr = ShardedArray.from_array(np.asarray(Xk[:n0]))
        twin("empty_resident_kmeans", lambda: KMeans(
            PROC_KM[2], init=init, max_iter=PROC_KM_ITER).fit(Xr))
        del Xr

        # each lbfgs iteration's |g| at its start and its Armijo passes,
        # rank 0's merged fit beside the twin's, logged before the gates
        for tag in ("stream_lbfgs", "stream_lbfgs_tol"):
            f, info = outs[0]["fits"][tag], twins[tag].solver_info_
            log(f"processes: {tag} iterations, merged |g| "
                + " ".join(f"{g:.2e}" for g in f["grad_norms"])
                + " trials " + " ".join(map(str, f["armijo_trials"]))
                + "; twin |g| "
                + " ".join(f"{g:.2e}" for g in info["grad_norms"])
                + " trials " + " ".join(map(str, info["armijo_trials"])))

        # the gates: every rank against the twin, and the ranks alike
        gaps = {}
        passes = {o["fits"]["stream_lbfgs_tol"]["passes"] for o in outs}
        if passes != {twins["stream_lbfgs_tol"].solver_info_["data_passes"]}:
            raise AssertionError(
                f"phase 28 stream_lbfgs_tol: passes {passes} against the "
                f"twin's {twins['stream_lbfgs_tol'].solver_info_}")
        for tag in ("stream_lbfgs", "stream_lbfgs_tol", "stream_newton",
                    "resident_lbfgs", "uneven_stream_lbfgs",
                    "empty_resident_lbfgs"):
            gaps[tag] = max(float(np.abs(a[tag] - twins[tag].coef_).max())
                            for a in arrs)
            if not gaps[tag] <= COEF_ATOL:
                raise AssertionError(f"phase 28 {tag}: max|dcoef| "
                                     f"{gaps[tag]:.3e} > {COEF_ATOL}")
        for tag in ("uneven_stream_lbfgs", "empty_resident_lbfgs"):
            iters = {o["fits"][tag]["n_iter"] for o in outs}
            if iters != {int(twins[tag].n_iter_)}:
                raise AssertionError(f"phase 28 {tag}: n_iter {iters} "
                                     f"against {twins[tag].n_iter_}")
        # uneven ranks: both streamed, the short rank its one block, and
        # kernels 6 and 9 launched on each
        for tag, kernel in (("uneven_stream_lbfgs", "fused_glm_stream"),
                            ("uneven_stream_kmeans",
                             "fused_kmeans_block_stats")):
            per_rank = [o["fits"][tag]["launches"][kernel] for o in outs]
            if kernels and min(per_rank) == 0:
                raise AssertionError(f"phase 28 {tag}: {kernel} launches "
                                     f"{per_rank}")
        f1 = outs[1]["fits"]["uneven_stream_lbfgs"]
        if f1["n_blocks"] != 1 or (kernels and f1["launches"][
                "fused_glm_stream"] != f1["passes"]):
            raise AssertionError(f"phase 28 uneven: rank 1 {f1}")
        # the empty rank: rank 0, which holds the rows, launches kernels
        # 1 and 2; rank 1 adds its zero sums without a launch
        for tag, kernel in (("empty_resident_lbfgs",
                             "fused_glm_value_grad"),
                            ("empty_resident_kmeans", "fused_lloyd_stats")):
            n_l = outs[0]["fits"][tag]["launches"][kernel]
            if kernels and n_l == 0:
                raise AssertionError(f"phase 28 {tag}: rank 0 launched no "
                                     f"{kernel}")
        log(f"processes: uneven ranks {PROC_UNEVEN[0]:,} and "
            f"{PROC_UNEVEN[1]:,} rows at {PROC_UNEVEN_BLOCK:,}-row blocks: "
            "both streamed (blocks "
            + ", ".join(str(o["fits"]["uneven_stream_lbfgs"]["n_blocks"])
                        for o in outs)
            + "), kernel 6 launches "
            + ", ".join(str(o["fits"]["uneven_stream_lbfgs"]["launches"][
                "fused_glm_stream"]) for o in outs)
            + ", kernel 9 launches "
            + ", ".join(str(o["fits"]["uneven_stream_kmeans"]["launches"][
                "fused_kmeans_block_stats"]) for o in outs)
            + "; empty rank: kernel 1 launches "
            + ", ".join(str(o["fits"]["empty_resident_lbfgs"]["launches"][
                "fused_glm_value_grad"]) for o in outs)
            + ", kernel 2 launches "
            + ", ".join(str(o["fits"]["empty_resident_kmeans"]["launches"][
                "fused_lloyd_stats"]) for o in outs))
        for tag in ("stream_kmeans", "resident_kmeans", "uneven_stream_kmeans",
                    "empty_resident_kmeans"):
            t = twins[tag]
            gaps[tag] = max(float(np.abs(a[tag] - t.cluster_centers_).max())
                            for a in arrs)
            rel = max(abs(o["fits"][tag]["inertia"] - t.inertia_)
                      / abs(t.inertia_) for o in outs)
            iters = {o["fits"][tag]["n_iter"] for o in outs}
            if not (gaps[tag] <= PROC_KM_CENTERS_ATOL
                    and rel <= PROC_KM_INERTIA_RTOL
                    and iters == {int(t.n_iter_)}):
                raise AssertionError(
                    f"phase 28 {tag}: centers {gaps[tag]:.3e}, inertia "
                    f"{rel:.3e}, n_iter {iters} against {t.n_iter_}")
        gaps["grad_accum_sgd"] = max(float(np.abs(
            a["grad_accum_sgd"] - twins["grad_accum_sgd"].coef_).max())
            for a in arrs)
        if not gaps["grad_accum_sgd"] <= SGD_COEF_ATOL:
            raise AssertionError(f"phase 28 grad_accum_sgd: "
                                 f"{gaps['grad_accum_sgd']:.3e}")
        s_ref = twins["stream_pca"].singular_values_
        gaps["stream_pca"] = max(float(np.abs(a["stream_pca"] - s_ref).max())
                                 for a in arrs) / float(s_ref[0])
        if not gaps["stream_pca"] <= PROC_PCA_RTOL:
            raise AssertionError(f"phase 28 stream_pca: "
                                 f"{gaps['stream_pca']:.3e}")
        ref = np.asarray(twins["search"].cv_results_["mean_test_score"])
        gaps["search"] = max(float(np.abs(a["search"] - ref).max())
                             for a in arrs)
        if gaps["search"] != 0.0:
            raise AssertionError(f"phase 28 search: scores part by "
                                 f"{gaps['search']:.3e}")
        hang = [o["hang"] for o in outs]
        log(f"processes: pass_barrier:hang on rank 1 under "
            f"stream_sync_timeout_s={PROC_SYNC_TIMEOUT_S:g}: rank 0 "
            f"{hang[0]['raised']} after {hang[0].get('after_s', 0):.2f} s; "
            f"rank 1 {hang[1]['raised']}")

        by_kernel = {k: [0] * PROC_WORLD for k in fused.KERNELS}
        for tag in twins:
            fits = [o["fits"][tag] for o in outs]
            for r, f in enumerate(fits):
                for k, n_l in f["launches"].items():
                    by_kernel[k][r] += n_l
            line = (f"processes: {tag}: two-process wall "
                    + ", ".join(f"{f['wall_s']:.3f}" for f in fits)
                    + f" s against single-process {walls[tag]:.3f} s; gap "
                    f"{gaps[tag]:.3e}")
            info = getattr(twins[tag], "solver_info_", None) or {}
            if "passes" in fits[0] and "data_passes" in info:
                line += (f"; passes {fits[0]['passes']} against "
                         f"{info['data_passes']}: ms a pass "
                         f"{1e3 * fits[0]['wall_s'] / fits[0]['passes']:.1f}"
                         f" against "
                         f"{1e3 * walls[tag] / info['data_passes']:.1f}")
            for r, f in enumerate(fits):
                pl = f["plane"]
                passes = f.get("passes")
                line += (f"; rank {r}: psum_host {pl['psum_calls']} calls "
                         f"{1e3 * pl['psum_s']:.2f} ms "
                         f"({1e3 * pl['psum_s'] / max(pl['psum_calls'], 1):.2f}"
                         " ms a call)")
                if passes:
                    line += (f" ({1e3 * pl['psum_s'] / passes:.3f} ms a "
                             f"pass of {passes}), barrier wait "
                             f"{1e3 * pl['barrier_s'] / max(pl['barriers'], 1):.3f}"
                             f" ms a pass ({pl['barriers']} barriers)")
                line += ", launches " + (", ".join(
                    f"{k} {v}" for k, v in f["launches"].items() if v)
                    or "none")
            log(line)
        need = ("fused_glm_value_grad", "fused_lloyd_stats",
                "fused_sgd_block_grad", "fused_glm_stream",
                "fused_kmeans_block_stats", "fused_assign_update")
        if kernels and any(min(by_kernel[k]) == 0 for k in need):
            raise AssertionError(f"phase 28: a kernel launched in no "
                                 f"process: {by_kernel}")
        for k, per_rank in by_kernel.items():
            results[k].setdefault("launches_by_path", {})["processes"] = \
                per_rank
        log(f"processes: every fit held to its twin; phase 28 in "
            f"{time.perf_counter() - t_phase:.1f} s")


def _fs_data(tmp, gen):
    """Phase 29's data: X (FS_SHAPE) as a memmap, binary and ten-class
    targets of linear models, and the KMeans fit's blobs (k centers at
    phase 28's scale, FS_KM rows at the same width) with its init;
    returns the spec entry."""
    dev = gen.device
    n, d = FS_SHAPE
    X = torch.randn(n, d, generator=gen, device=dev)
    w = torch.randn(d, generator=gen, device=dev) / d ** 0.5
    y = (torch.sigmoid(X @ w) > torch.rand(n, generator=gen,
                                           device=dev)).float()
    W = torch.randn(d, FS_CLASSES, generator=gen, device=dev) / d ** 0.5
    y10 = (X @ W + 0.5 * torch.randn(n, FS_CLASSES, generator=gen,
                                     device=dev)).argmax(1).float()
    entry = {"path": _write_memmap(tmp, "fs_x.f32", X).filename,
             "shape": [n, d], "y": os.path.join(tmp, "fs_y.npy"),
             "y10": os.path.join(tmp, "fs_y10.npy"),
             "init": os.path.join(tmp, "fs_init.npy")}
    np.save(entry["y"], y.cpu().numpy())
    np.save(entry["y10"], y10.cpu().numpy())
    del X
    n_km, k, _ = FS_KM
    C = torch.randn(k, d, generator=gen, device=dev) * 4.0
    lab = torch.randint(0, k, (n_km,), generator=gen, device=dev)
    K = C[lab] + torch.randn(n_km, d, generator=gen, device=dev)
    entry["km"] = _write_memmap(tmp, "fs_km.f32", K).filename
    init = C + 0.5 * torch.randn(k, d, generator=gen, device=dev)
    np.save(entry["init"], init.cpu().numpy())
    return entry


def phase_feature_sharded(results, tmp_root=None):
    """Phase 29: the 2-D mesh on the card, ``mesh_shape="1x2"`` over two
    real processes at bench.py's ``_mesh2d_measure`` width (d = 512),
    each fit held to the parent's single-process twin at full width."""
    from dask_ml_tpu_torch import config
    from dask_ml_tpu_torch.cluster import KMeans
    from dask_ml_tpu_torch.decomposition import PCA
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.ops import fused
    from dask_ml_tpu_torch.parallel.sharded import ShardedArray
    from dask_ml_tpu_torch.parallel.streaming import StreamBudgetExceeded

    cuda = PROC_DEVICE == "cuda"
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=tmp_root) as tmp, \
            config.set(device=PROC_DEVICE):
        gen = torch.Generator(device=PROC_DEVICE).manual_seed(29)
        fs = _fs_data(tmp, gen)
        _sync()
        if cuda:
            torch.cuda.empty_cache()
        X = np.memmap(fs["path"], dtype=np.float32, mode="r",
                      shape=tuple(fs["shape"]))
        y, y10 = np.load(fs["y"]), np.load(fs["y10"])
        init = np.load(fs["init"])
        # the refusal: one process's 1-D ring is over the budget the 1x2
        # tiles fit under
        try:
            with config.set(stream_device_byte_budget=FS_BUDGET):
                LogisticRegression(solver="lbfgs", max_iter=1).fit(X, y)
            raise AssertionError("phase 29: the 1-D streamed fit was not "
                                 "refused under the byte budget")
        except StreamBudgetExceeded as exc:
            log(f"feature sharding: one process refused: {exc}")
        spec = {"tmp": tmp, "store": os.path.join(tmp, "store"),
                "device": PROC_DEVICE, "phase": 29, "fs": fs}
        outs, arrs, wall2 = _spawn_ranks(spec, tmp, 29)
        log(f"feature sharding: {PROC_WORLD} processes, mesh 1x2, tiles "
            + ", ".join(str(o["tile"]) for o in outs)
            + f", {wall2:.1f} s from spawn to exit; {SMI}")

        twins, walls, peaks = {}, {}, {}

        def twin(tag, fit):
            _sync()
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            est = fit()
            _sync()
            walls[tag] = time.perf_counter() - t0
            peaks[tag] = torch.cuda.max_memory_allocated() if cuda else 0
            twins[tag] = est
            return est

        twin("fs_stream_lbfgs", lambda: LogisticRegression(
            solver="lbfgs", max_iter=PROC_LBFGS_ITER,
            tol=PROC_LBFGS_TOL).fit(X, y))
        twin("fs_stream_ovr", lambda: LogisticRegression(
            solver="lbfgs", max_iter=PROC_LBFGS_ITER, tol=PROC_LBFGS_TOL,
            C=10.0).fit(X, y10))
        twin("fs_stream_newton", lambda: LogisticRegression(
            solver="newton", max_iter=FS_NEWTON_ITER).fit(
            X[:FS_NEWTON_ROWS], y[:FS_NEWTON_ROWS]))
        twin("fs_stream_pca", lambda: PCA(
            FS_PCA_K, svd_solver="randomized", random_state=0).fit(X))
        Xr = ShardedArray.from_array(np.asarray(X))
        twin("fs_resident_lbfgs", lambda: LogisticRegression(
            solver="lbfgs", max_iter=FS_RESIDENT_ITER,
            tol=PROC_LBFGS_TOL).fit(Xr, y))
        del Xr
        n_km, k, it = FS_KM
        Xr = ShardedArray.from_array(np.asarray(np.memmap(
            fs["km"], dtype=np.float32, mode="r",
            shape=(n_km, fs["shape"][1]))))
        twin("fs_resident_kmeans", lambda: KMeans(
            k, init=init, max_iter=it, tol=0.0).fit(Xr))
        del Xr

        gaps = {}
        for tag in ("fs_stream_lbfgs", "fs_stream_ovr", "fs_stream_newton",
                    "fs_resident_lbfgs"):
            t = twins[tag]
            gaps[tag] = max(float(np.abs(a[tag] - t.coef_).max())
                            for a in arrs)
            iters = {o["fits"][tag]["n_iter"] for o in outs}
            if not (gaps[tag] <= COEF_ATOL
                    and iters == {int(np.max(t.n_iter_))}):
                raise AssertionError(
                    f"phase 29 {tag}: max|dcoef| {gaps[tag]:.3e}, n_iter "
                    f"{iters} against {t.n_iter_}")
        passes = {o["fits"]["fs_stream_lbfgs"]["passes"] for o in outs}
        if passes != {twins["fs_stream_lbfgs"].solver_info_["data_passes"]}:
            raise AssertionError(f"phase 29 fs_stream_lbfgs: passes {passes}")
        t = twins["fs_stream_pca"]
        s_ref = t.singular_values_
        gaps["fs_stream_pca"] = max(float(np.abs(
            a["fs_stream_pca_s"] - s_ref).max()) for a in arrs) / s_ref[0]
        comp = max(float(np.abs(np.abs(a["fs_stream_pca_c"])
                                - np.abs(t.components_)).max())
                   for a in arrs)
        if not (gaps["fs_stream_pca"] <= PROC_PCA_RTOL
                and comp <= FS_COMP_ATOL):
            raise AssertionError(f"phase 29 fs_stream_pca: s "
                                 f"{gaps['fs_stream_pca']:.3e}, components "
                                 f"{comp:.3e}")
        t = twins["fs_resident_kmeans"]
        gaps["fs_resident_kmeans"] = max(float(np.abs(
            a["fs_resident_kmeans"] - t.cluster_centers_).max())
            for a in arrs)
        rel = max(abs(o["fits"]["fs_resident_kmeans"]["inertia"]
                      - t.inertia_) / abs(t.inertia_) for o in outs)
        iters = {o["fits"]["fs_resident_kmeans"]["n_iter"] for o in outs}
        if not (gaps["fs_resident_kmeans"] <= PROC_KM_CENTERS_ATOL
                and rel <= PROC_KM_INERTIA_RTOL
                and iters == {int(t.n_iter_)}):
            raise AssertionError(
                f"phase 29 fs_resident_kmeans: centers "
                f"{gaps['fs_resident_kmeans']:.3e}, inertia {rel:.3e}, "
                f"n_iter {iters} against {t.n_iter_}")
        by_kernel = {kk: [0] * PROC_WORLD for kk in fused.KERNELS}
        for tag in twins:
            fits = [o["fits"][tag] for o in outs]
            for r, f in enumerate(fits):
                for kk, n_l in f["launches"].items():
                    by_kernel[kk][r] += n_l
            line = (f"feature sharding: {tag}: two-process wall "
                    + ", ".join(f"{f['wall_s']:.3f}" for f in fits)
                    + f" s against single-process {walls[tag]:.3f} s; gap "
                    f"{gaps[tag]:.3e}; reason {fits[0]['reason']}")
            info = getattr(twins[tag], "solver_info_", None) or {}
            if fits[0]["passes"]:
                line += (f"; passes {fits[0]['passes']} against "
                         f"{info.get('data_passes')}")
            for r, f in enumerate(fits):
                pl = f["plane"]
                per = max(f["passes"] or f["n_iter"] or 1, 1)
                line += (f"; rank {r}: model {pl['model_calls']} calls "
                         f"{pl['model_bytes'] / 1e6:.2f} MB "
                         f"{1e3 * pl['model_s']:.1f} ms ("
                         f"{pl['model_calls'] / per:.1f} calls, "
                         f"{pl['model_bytes'] / per / 1e6:.2f} MB, "
                         f"{1e3 * pl['model_s'] / per:.2f} ms a pass of "
                         f"{per}), data {pl['data_calls']} calls "
                         f"{pl['data_bytes'] / 1e6:.2f} MB "
                         f"{1e3 * pl['data_s']:.1f} ms; peak "
                         f"{f['peak'] / 2 ** 20:.0f} MiB")
            line += f" against the twin's {peaks[tag] / 2 ** 20:.0f} MiB"
            log(line + f"; {SMI}")
        if any(sum(v) for v in by_kernel.values()):
            raise AssertionError(f"phase 29: a feature-sharded path "
                                 f"launched a kernel: {by_kernel}")
        # the tiles really ran: every fit met over the "model" collective
        # on each rank, and the streamed GLMs staged two tiles
        for tag in twins:
            fits = [o["fits"][tag] for o in outs]
            calls = [f["plane"]["model_calls"] for f in fits]
            shards = {f["model_shards"] for f in fits}
            if min(calls) == 0 or (tag.startswith("fs_stream_")
                                   and tag != "fs_stream_pca"
                                   and shards != {2}):
                raise AssertionError(
                    f"phase 29 {tag}: not feature-sharded: model calls "
                    f"{calls}, model_shards {shards}")
        for kk, per_rank in by_kernel.items():
            results[kk].setdefault("launches_by_path", {})[
                "feature_sharded"] = per_rank
        log(f"feature sharding: every fit held to its twin; phase 29 in "
            f"{time.perf_counter() - t_phase:.1f} s; {SMI}")


def _spawn_ranks(spec, tmp, phase):
    """Run this script as ``PROC_WORLD`` processes on ``spec`` (written
    to ``tmp``), each joined under the phase's deadline and killed past
    it; returns (each rank's JSON, each rank's arrays, the wall from
    spawn to the last exit)."""
    spec_path = os.path.join(tmp, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    here = os.path.abspath(__file__)
    procs, logs = [], []
    t0 = time.perf_counter()
    for r in range(PROC_WORLD):
        lf = open(os.path.join(tmp, f"rank{r}.log"), "w")
        logs.append(lf)
        procs.append(subprocess.Popen(
            [sys.executable, here, "--process-rank", str(r), spec_path],
            stdout=lf, stderr=subprocess.STDOUT,
            cwd=os.path.dirname(here)))
    deadline = time.monotonic() + PROC_DEADLINE_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.0))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        raise AssertionError(
            f"phase {phase}: a process did not exit within "
            f"{PROC_DEADLINE_S} s:\n" + _proc_logs(tmp))
    finally:
        for lf in logs:
            lf.close()
    wall = time.perf_counter() - t0
    outs, arrs = [], []
    for r, p in enumerate(procs):
        base = os.path.join(tmp, f"rank{r}")
        if p.returncode != 0 or not os.path.exists(base + ".json"):
            raise AssertionError(f"phase {phase}: rank {r} exited "
                                 f"{p.returncode}:\n" + _proc_logs(tmp))
        with open(base + ".json") as f:
            outs.append(json.load(f))
        arrs.append(dict(np.load(base + ".npz")))
    return outs, arrs, wall


def _proc_logs(tmp):
    out = []
    for r in range(PROC_WORLD):
        path = os.path.join(tmp, f"rank{r}.log")
        if os.path.exists(path):
            with open(path) as f:
                out.append(f"-- rank {r} --\n" + f.read()[-4000:])
        jpath = os.path.join(tmp, f"rank{r}.json")
        if os.path.exists(jpath):
            with open(jpath) as f:
                err = json.load(f).get("error")
            if err:
                out.append(f"-- rank {r} error --\n{err[-4000:]}")
    return "\n".join(out)



# -- phase 30: observability --------------------------------------------------

OBS_HELD_S = 1.5          # the span held open past the watchdog's deadline
OBS_WATCHDOG_S = 0.5
OBS_FIT_WATCHDOG_S = 120.0  # armed on every fit, past any fit's wall
OBS_SCRAPE_S = 0.05       # the scraper's pause between rounds
OBS_KERNEL_RTOL = 0.25    # kernel 1's in-fit median against phase 3's time
OBS_SHARE_MAX = 1.05      # no kernel beats its bound: above, the count is wrong
_PROM_SAMPLE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\})? '
    r'([-+]?[0-9.eE+-]+|[+-]Inf|NaN)$')
_PROM_TYPE = re.compile(r"^# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* "
                        r"(counter|gauge|histogram)$")


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class _Scraper:
    """A second thread scraping /metrics, /status and /healthz of the
    exporter every OBS_SCRAPE_S while a fit runs: each /metrics body
    must parse line by line as Prometheus text; it notes whether a
    /status showed an open "fit" span and the device memory gauges."""

    def __init__(self, url):
        import threading

        self.url = url
        self.rounds = 0
        self.saw_fit = self.saw_memory = False
        self.errors = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _get(self, path):
        import urllib.request

        with urllib.request.urlopen(self.url + path, timeout=30) as resp:
            return resp.status, resp.read().decode()

    def _run(self):
        while not self._stop.is_set():
            try:
                code, body = self._get("/metrics")
                bad = [ln for ln in body.splitlines() if not (
                    _PROM_TYPE.match(ln) or _PROM_SAMPLE.match(ln))]
                if code != 200 or bad:
                    self.errors.append(f"/metrics {code}: {bad[:3]}")
                code, body = self._get("/status")
                doc = json.loads(body)
                if code != 200:
                    self.errors.append(f"/status {code}")
                if any(sp["span"] == "fit" for sp in doc["open_spans"]):
                    self.saw_fit = True
                if doc["device_memory"]:
                    self.saw_memory = True
                if self._get("/healthz") != (200, "ok\n"):
                    self.errors.append("/healthz")
                self.rounds += 1
            except Exception as e:
                self.errors.append(repr(e))
            self._stop.wait(OBS_SCRAPE_S)

    def __enter__(self):
        self._thread.start()
        # one whole round before the fit starts: the first scrape's
        # imports do not eat the fit's window
        t0 = time.perf_counter()
        while self.rounds == 0 and not self.errors \
                and time.perf_counter() - t0 < 60:
            time.sleep(0.01)
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(60)
        if self._thread.is_alive():
            raise AssertionError("the scraper did not stop")
        return False


def _obs_rows():
    from dask_ml_tpu_torch import observability as obs

    return {r["program"]: r for r in obs.programs_snapshot()}


def _obs_fit(state, what, kernels, fit, twin, same, scrape=False):
    """One instrumented fit (every knob on, obs.jsonl) held bit-equal to
    its plain twin ``twin`` by ``same``; every kernel of ``kernels``
    launched, and each launch timed by the registry. Then the same fit
    with obs_programs on and off, for the walls (another file)."""
    from dask_ml_tpu_torch import config
    from dask_ml_tpu_torch.observability import live
    from dask_ml_tpu_torch.ops import fused

    knobs = dict(metrics_path=state["path"], obs_programs=True,
                 obs_http_port=state["port"],
                 watchdog_timeout_s=OBS_FIT_WATCHDOG_S)
    with config.set(**knobs):
        srv = live.ensure_telemetry()
    if srv is None:
        raise AssertionError("obs_http_port armed no exporter")
    l0, r0 = fused.launches(), _obs_rows()
    scraper = _Scraper(srv.url) if scrape else None
    with config.set(**knobs):
        t0 = time.perf_counter()
        if scraper is not None:
            with scraper:
                est = fit()
                torch.cuda.synchronize()
        else:
            est = fit()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    l1, r1 = fused.launches(), _obs_rows()
    for k in kernels:
        n = l1[k] - l0[k]
        timed = r1[k]["timed_calls"] - r0[k]["timed_calls"]
        if n < 1 or r1[k]["calls"] != l1[k] or timed != n:
            raise AssertionError(f"{what}: {k} launched {n} times, the "
                                 f"registry timed {timed} "
                                 f"(calls {r1[k]['calls']} of {l1[k]})")
    if not same(est, twin):
        raise AssertionError(f"{what}: the instrumented fit is not "
                             "bit-equal to its plain twin")
    walls = {"on": wall}
    for programs in (True, False):
        with config.set(**dict(knobs, obs_programs=programs,
                               metrics_path=state["walls_path"])):
            walls["programs" if programs else "no_programs"] = \
                _timed(fit, 1)[0]
    state["fits"][what] = dict(est=est, walls=walls, scraper=scraper,
                               launches={k: l1[k] - l0[k] for k in kernels})
    return est


def phase_obs_glm(state, X, y, lbfgs_fit, mm, y_h, stream_lbfgs):
    """Phase 30, part (a): phase 4's lbfgs fit and phase 12's streamed
    lbfgs fit with every observability knob on, each scraped while it
    runs, held to their plain twins; kernel 1's median time in the fit
    against phase 3's."""
    from dask_ml_tpu_torch import observability as obs
    from dask_ml_tpu_torch.linear_model import LogisticRegression

    t_phase = time.perf_counter()
    obs.programs_reset()
    state["port"] = _free_port()

    def same_glm(a, b):
        return (np.array_equal(a.coef_, b.coef_)
                and np.array_equal(a.intercept_, b.intercept_)
                and a.n_iter_ == b.n_iter_)

    t0 = time.perf_counter()
    LogisticRegression(solver="lbfgs", max_iter=50, tol=0.0).fit(X, y)
    torch.cuda.synchronize()
    state["plain"]["lbfgs"] = time.perf_counter() - t0
    _obs_fit(state, "lbfgs", ["fused_glm_value_grad"],
             lambda: LogisticRegression(solver="lbfgs", max_iter=50,
                                        tol=0.0).fit(X, y),
             lbfgs_fit, same_glm, scrape=True)
    # kernel 1's times inside the fit (the wall fits after it time it too)
    state["k1_fit_ms"] = _obs_rows()["fused_glm_value_grad"][
        "device_ms_median"]
    state["plain"]["stream_lbfgs"] = stream_lbfgs["median_s"]
    _obs_fit(state, "stream_lbfgs", ["fused_glm_stream"],
             lambda: LogisticRegression(solver="lbfgs",
                                        max_iter=STREAM_LBFGS_ITER,
                                        tol=0.0).fit(mm, y_h),
             stream_lbfgs["fit"], same_glm, scrape=True)
    state["t"] += time.perf_counter() - t_phase


def phase_obs_kmeans(state, X, blobs_fit):
    """Phase 30, part (b): phase 5's KMeans on the blobs with every knob
    on, held to phase 5's fit."""
    from dask_ml_tpu_torch.cluster import KMeans

    t_phase = time.perf_counter()
    init = X[:KM_K].cpu().numpy()

    def fit():
        return KMeans(n_clusters=KM_K, init=init, max_iter=10,
                      tol=0.0).fit(X)

    state["plain"]["kmeans"] = _timed(fit, 1)[0]
    _obs_fit(state, "kmeans", ["fused_lloyd_stats", "fused_assign_update"],
             fit, blobs_fit,
             lambda a, b: (np.array_equal(a.cluster_centers_,
                                          b.cluster_centers_)
                           and a.inertia_ == b.inertia_
                           and a.n_iter_ == b.n_iter_))
    state["t"] += time.perf_counter() - t_phase


def phase_obs_records(state, results):
    """Phase 30, part (c): the watchdog (a sleep inside a span past
    watchdog_timeout_s), the final counters and registry records, then
    the gates over the JSONL: one step record per iteration, one
    stream.pass span per pass, a fit span per fit; the registry's rows
    within their bounds and kernel 1's in-fit median within 25 % of
    phase 3's; the report CLI and its --json on the file; the Chrome
    trace. Prints the instrumented walls over the plain ones."""
    from dask_ml_tpu_torch import config
    from dask_ml_tpu_torch import observability as obs
    from dask_ml_tpu_torch.observability import export, live, report

    t_phase = time.perf_counter()
    path = state["path"]
    with config.set(metrics_path=path, watchdog_timeout_s=OBS_WATCHDOG_S):
        with obs.watchdog():
            with obs.span("obs.held"):
                time.sleep(OBS_HELD_S)
    rows = _obs_rows()
    lg = obs.MetricsLogger(path, extra={"component": "chip_smoke"})
    obs.log_counters(lg)
    obs.log_programs(lg)
    lg.close()
    live.stop_telemetry()
    recs = report.load_records(path)

    def count(pred):
        return sum(1 for r in recs if pred(r))

    fits = state["fits"]
    checks = {
        "lbfgs steps": (count(lambda r: "step" in r and r.get("solver")
                              == "lbfgs" and not r.get("streamed")),
                        fits["lbfgs"]["est"].n_iter_),
        "streamed lbfgs steps": (
            count(lambda r: "step" in r and r.get("streamed")
                  and r.get("component") == "LogisticRegression"),
            fits["stream_lbfgs"]["est"].n_iter_),
        "stream.pass spans": (
            count(lambda r: r.get("span") == "stream.pass"),
            fits["stream_lbfgs"]["est"].solver_info_["data_passes"]),
        "kmeans steps": (count(lambda r: "step" in r and r.get(
            "component") == "KMeans"), fits["kmeans"]["est"].n_iter_),
        "fit spans": (count(lambda r: r.get("span") == "fit"), 3),
        "stall records": (count(lambda r: r.get("watchdog")
                                and r.get("span") == "obs.held"
                                and r.get("stacks")), 1),
        "counters records": (count(lambda r: r.get("counters")), 1),
    }
    for what, (got, want) in checks.items():
        log(f"observability records: {what} {got} (expected {want})")
    bad = {k: v for k, v in checks.items() if v[0] != v[1]}
    if bad:
        raise AssertionError(f"observability records: {bad}")

    for name, r in rows.items():
        if not r["timed_calls"]:
            continue
        share = r["share_of_bound"]
        log(f"registry {name}: calls {r['calls']}, timed "
            f"{r['timed_calls']}, dropped {r['dropped_events']}, median "
            f"{r['device_ms_median']:.4f} ms, bound "
            f"{r['bound_s'] * 1e3:.4f} ms a call ({r['bound_by']}), share "
            f"of bound {share:.1%} over {r['exec_s'] * 1e3:.3f} ms "
            f"({r['peak']})")
        if share is None or share > OBS_SHARE_MAX or r["share_flag"]:
            raise AssertionError(f"registry {name}: share of bound {share}")
    k1_alone = results["fused_glm_value_grad"]["ms"]
    k1_fit = state["k1_fit_ms"]
    log(f"kernel 1 inside the lbfgs fit: median {k1_fit:.4f} ms; alone "
        f"(phase 3, 4M x 257 f32) {k1_alone:.4f} ms; ratio "
        f"{k1_fit / k1_alone:.3f}")
    if abs(k1_fit / k1_alone - 1.0) > OBS_KERNEL_RTOL:
        raise AssertionError("kernel 1's time in the fit is not within "
                             f"{OBS_KERNEL_RTOL:.0%} of phase 3's")

    for what in ("lbfgs", "stream_lbfgs"):
        sc = fits[what]["scraper"]
        log(f"scrapes during the {what} fit: {sc.rounds} rounds, open fit "
            f"span seen {sc.saw_fit}, device memory seen {sc.saw_memory}, "
            f"errors {sc.errors[:3]}")
        if sc.errors or not sc.rounds or not sc.saw_memory:
            raise AssertionError(f"the scrapes during the {what} fit")
    if not any(fits[w]["scraper"].saw_fit for w in ("lbfgs",
                                                     "stream_lbfgs")):
        raise AssertionError("/status never showed an open fit span")

    cli = [sys.executable, "-m", "dask_ml_tpu_torch.observability.report",
           path]
    root = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run(cli, capture_output=True, text=True, timeout=300,
                         cwd=root)
    if out.returncode != 0 or "kernels (" not in out.stdout:
        raise AssertionError(f"report CLI: rc {out.returncode}, "
                             f"{out.stderr[-2000:]}")
    out_j = subprocess.run(cli + ["--json"], capture_output=True, text=True,
                           timeout=300, cwd=root)
    data = json.loads(out_j.stdout)
    progs = {r["program"]: r for r in data["programs"]}
    for k in ("fused_glm_value_grad", "fused_lloyd_stats"):
        if progs[k]["bound_s"] is None or progs[k]["share_of_bound"] is None:
            raise AssertionError(f"report --json: {k} has no bound/share")
    for ln in out.stdout.splitlines():
        if ln.startswith("kernels (") or ln.startswith("fused_"):
            log(f"  report: {ln.rstrip()}")
    trace_path = os.path.join(os.path.dirname(path), "obs_trace.json")
    export.write_chrome_trace(recs, trace_path)
    with open(trace_path) as fh:
        names = {e["name"] for e in json.load(fh)["traceEvents"]}
    if not {"LogisticRegression.fit", "KMeans.fit"} <= names:
        raise AssertionError(f"Chrome trace lacks the fit spans: "
                             f"{sorted(names)[:20]}")
    for what, f in fits.items():
        plain = state["plain"][what]
        w = f["walls"]
        log(f"observability walls {what}: plain {plain:.4f} s; every knob "
            f"on, scraped {w['on']:.4f} s ({w['on'] / plain:.3f}x); "
            f"obs_programs on {w['programs']:.4f} s "
            f"({w['programs'] / plain:.3f}x), off {w['no_programs']:.4f} s "
            f"({w['no_programs'] / plain:.3f}x); launches {f['launches']}")
    state["t"] += time.perf_counter() - t_phase
    log(f"phase 30 (observability): {state['t']:.1f} s in all; "
        f"{len(recs)} records, report and --json exit 0, "
        f"{len(names)} trace event names; {SMI}")


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
    decomp_gen = torch.Generator(device="cuda").manual_seed(9)
    phase_glm_kernel(gen, results)
    phase_lloyd_kernels(gen, results)
    phase_lloyd_narrow(torch.Generator(device="cuda").manual_seed(22),
                       results)
    phase_newton_kernel(gen, results)
    phase_multi_kernel(gen, results)
    phase_stream_kernels(gen, results)
    phase_sgd_kernels(sgd_gen, results)
    # the memmaps and phase 26's checkpoints live in one temporary directory
    with tempfile.TemporaryDirectory() as tmp:
        ck_report = {"saves_ms": []}
        X, y, lbfgs_fit = phase_glm_fit(gen, results)
        phase_ckpt_resident(tmp, X, y, lbfgs_fit, ck_report)
        phase_glm_fit_bf16(X, y, results)
        newton_fit = phase_newton_fit(X, y, lbfgs_fit, results)
        phase_admm_fit(X, y)
        y10 = phase_ovr_fit(gen, X, results)
        Xi, yi = phase_sgd_fits(sgd_gen, X, y, y10, results)
        phase_sgd_cohort(Xi, yi, results)
        phase_ckpt_incremental(tmp, Xi, yi, ck_report)
        phase_serving_fleet(Xi, yi, results)
        del Xi, yi
        mm, stream_lbfgs = phase_stream_glm(tmp, X, y, y10, newton_fit,
                                            results)
        phase_stream_sgd(mm, y.cpu().numpy(), results)
        phase_ckpt_stream(tmp, mm, y.cpu().numpy(), stream_lbfgs, ck_report)
        obs_state = {"path": os.path.join(tmp, "obs.jsonl"),
                     "walls_path": os.path.join(tmp, "obs_walls.jsonl"),
                     "fits": {}, "plain": {}, "t": 0.0}
        phase_obs_glm(obs_state, X, y, lbfgs_fit, mm, y.cpu().numpy(),
                      stream_lbfgs)
        path = mm.filename
        del mm, stream_lbfgs
        os.remove(path)
        del X, y, y10
        torch.cuda.empty_cache()
        X, blobs_fit = phase_kmeans_fit(gen, results)
        phase_serving_kmeans(X, blobs_fit)
        mm, km_stream = phase_stream_kmeans(tmp, X, blobs_fit, results)
        phase_ckpt_kmeans(tmp, mm, X, km_stream, blobs_fit, ck_report)
        phase_obs_kmeans(obs_state, X, blobs_fit)
        phase_obs_records(obs_state, results)
        path = mm.filename
        del X, mm, km_stream
        os.remove(path)
        torch.cuda.empty_cache()
        X, fits = phase_decomposition(decomp_gen)
        phase_stream_decomposition(tmp, X, fits)
        del X, fits
        torch.cuda.empty_cache()
    phase_search(results)
    phase_surface(results)
    phase_sparse_stream(results)
    torch.cuda.empty_cache()
    phase_hashed_text(results)
    phase_serving(results)
    phase_serving_int8()
    torch.cuda.empty_cache()
    phase_processes(results)
    torch.cuda.empty_cache()
    phase_feature_sharded(results)
    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--process-rank":
        sys.exit(process_worker(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
