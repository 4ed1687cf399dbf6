#!/usr/bin/env python3
"""Time variants of csrc/lloyd.cu against a checkout's own, on one card.

    python3 scripts/lloyd_variant_times.py ROOT N,D,K [N,D,K ...] -- [FILE ...]

ROOT is a checkout of the repository; its ``dask_ml_tpu_torch`` is
imported. Each FILE is a whole ``lloyd.cu`` (a design to weigh, kept
outside the checkout's ``csrc/``). The checkout's own source and then each
FILE is built with ROOT's build rules into a temporary directory, and
``fused_kmeans_block_stats`` (the streamed Lloyd step, f32 and with the
bf16 cross term) is timed by CUDA events, the mean of 10 calls after 3
warm-up calls, on N rows of D features with K centers drawn from a fixed
seed, for each shape given. A variant is for timing only: chip_smoke.py
and tests/test_torch_cuda.py check the checkout's kernels. The script
prints a line per (source, shape, cross term) and one JSON object with
the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

import torch

REPS = 10


def _time_ms(fn):
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
    args = sys.argv[1:]
    if "--" not in args or len(args) < 3 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    cut = args.index("--")
    root = os.path.abspath(args[0])
    shapes = [tuple(int(v) for v in a.split(",")) for a in args[1:cut]]
    files = [os.path.abspath(f) for f in args[cut + 1:]]
    sys.path.insert(0, root)
    from dask_ml_tpu_torch.ops import _build, fused

    if not os.path.abspath(fused.__file__).startswith(root):
        raise RuntimeError(f"imported {fused.__file__}, not from {root}")
    csrc0 = _build.CSRC_DIR
    sources = {"checkout": os.path.join(csrc0, "lloyd.cu")}
    sources.update({os.path.basename(f): f for f in files})
    dev = torch.device("cuda")
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, path in sources.items():
            csrc = os.path.join(tmp, name, "csrc")
            shutil.copytree(csrc0, csrc)
            shutil.copyfile(path, os.path.join(csrc, "lloyd.cu"))
            _build.CSRC_DIR = csrc
            _build.BUILD_DIR = os.path.join(tmp, name, "build")
            _build._loaded.clear()
            for n, d, k in shapes:
                g = torch.Generator(device=dev).manual_seed(n + d + k)
                x = torch.randn((n, d), generator=g, device=dev)
                c = x[torch.randperm(n, generator=g, device=dev)[:k]].clone()
                for mxu in (None, torch.bfloat16):
                    tag = f"{name} {n}x{d} k={k} " + \
                        ("f32" if mxu is None else "bf16")
                    times[tag] = _time_ms(
                        lambda: fused.fused_kmeans_block_stats(x, n, c,
                                                               mxu=mxu))
                    print(f"{tag}: {times[tag]:.4f} ms", flush=True)
                del x, c
                torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"root": root, "device": smi, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
