#!/usr/bin/env python3
"""Time one checkout's SGD many-rows and streamed KMeans kernels on a card.

    python3 scripts/torch_kernel_times.py ROOT

ROOT is a checkout of the repository (``.`` or a parent unpacked into a
git-ignored directory); its ``dask_ml_tpu_torch`` is imported and its
kernels built there at first use. The script times
``fused_sgd_many_block_grad`` and ``fused_kmeans_block_stats`` by CUDA
events (the mean of 20 calls after 3 warm-up calls) at chip_smoke.py's
shapes, on and off the main path, with inputs from a fixed seed, and
prints a line per case and one JSON object with the card's name and
power limit. To compare two builds, run it for each checkout in one
chip call (parent, change, change, parent); chip_smoke.py checks the
kernels' results.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

REPS = 20

# (kernel, label, rows, d, N or k, codes, loss, bf16)
CASES = [
    ("sgd_many", "codes C=10", 500_000, 256, 10, True, "log_loss", False),
    ("sgd_many", "codes C=10 bf16", 500_000, 256, 10, True, "log_loss",
     True),
    ("sgd_many", "cohort N=16", 250_000, 128, 16, False, "log_loss", False),
    ("sgd_many", "cohort N=128", 250_000, 128, 128, False, "log_loss",
     False),
    ("kmeans_block", "k=64", 524_288, 128, 64, None, None, False),
    ("kmeans_block", "k=64 bf16", 524_288, 128, 64, None, None, True),
    ("kmeans_block", "k=256", 524_288, 128, 256, None, None, False),
    ("kmeans_block", "k=256 bf16", 524_288, 128, 256, None, None, True),
    ("kmeans_block", "d=768", 524_288, 768, 64, None, None, False),
    ("kmeans_block", "d=768 bf16", 524_288, 768, 64, None, None, True),
]


def time_ms(fn):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def main():
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    from dask_ml_tpu_torch.ops import fused

    if not os.path.abspath(fused.__file__).startswith(root):
        raise RuntimeError(f"imported {fused.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    times = {}
    for kernel, label, n, d, m, codes, loss, bf16 in CASES:
        x = torch.randn((n, d), generator=g, device=dev)
        mxu = torch.bfloat16 if bf16 else None
        if kernel == "sgd_many":
            y = torch.randint(0, m, (n,), generator=g, device=dev).float() \
                if codes else (torch.rand(n, generator=g, device=dev)
                               < 0.5).float()
            W = torch.randn((m, d + 1), generator=g, device=dev) \
                / (4 * d ** 0.5)
            ms = time_ms(lambda: fused.fused_sgd_many_block_grad(
                x, n, y, W, 1.0, loss, codes, mxu))
        else:
            c = x[torch.randperm(n, generator=g, device=dev)[:m]].clone()
            ms = time_ms(lambda: fused.fused_kmeans_block_stats(
                x, n, c, mxu=mxu))
        times[f"{kernel} {label}"] = ms
        print(f"{kernel:12s} {label:16s} {n}x{d}: {ms:.4f} ms", flush=True)
        del x
        torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"root": root, "device": smi, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
