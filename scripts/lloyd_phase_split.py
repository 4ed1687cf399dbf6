#!/usr/bin/env python3
"""Where a Lloyd pass's time goes: csrc/lloyd.cu built with one phase cut.

    python3 scripts/lloyd_phase_split.py ROOT [N D K [bf16]]

ROOT is a checkout of the repository (``.`` or a parent unpacked into a
git-ignored directory). The script reads ROOT's
``dask_ml_tpu_torch/csrc/lloyd.cu``, makes one variant of it per phase
to cut by replacing a line of the source (a variant is for timing only:
its statistics are wrong), builds each with ROOT's build rules into a
temporary directory and times ``fused_lloyd_stats`` by CUDA events on
chip_smoke.py's main shape (8M x 128, k = 64) or on N rows of D features
with K centers; with ``bf16``, ``fused_kmeans_block_stats`` with its bf16
cross term (the same step). A phase's share is the
full kernel's time less the variant's. The cuts depend on the design the
source holds; a cut whose line is missing raises.

Designs and their cuts:
- ``simt`` (the CUDA-core kernel, register-blocked FMAs): ``cross`` keeps
  4 of the features in the cross term (the labels stay spread out),
  ``argmin`` drops the half-warp shuffle (each lane keeps its own
  candidates), ``sums`` drops the per-cluster sums walk, and ``all``
  cuts the three, which leaves the copies of X;
- ``mma`` (the tensor-core kernel): ``cross`` drops the cross term's
  products (every row then takes the center of least norm), ``argmin``
  drops the quad shuffle, ``sums`` drops the sort and walk of the
  per-cluster sums, ``all`` the three.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

import torch

N, D, K = 8_000_000, 128, 64
REPS = 10

CUTS = {
    "simt": {
        "cross": [("for (int f = 0; f < fc; f += 4) {",
                   "for (int f = 0; f < 4; f += 4) {")],
        "argmin": [("for (int o = kTC / 2; o > 0; o >>= 1) {",
                    "for (int o = 0; o > 0; o >>= 1) {")],
        "sums": [("for (int f = tid; f < d; f += kThreads) {\n"
                  "      float* cf = csum + f;",
                  "for (int f = tid; f < 0; f += kThreads) {\n"
                  "      float* cf = csum + f;")],
    },
    "mma": {
        "cross": [("for (int ks0 = 0; ks0 < nks; ks0 += kRunKs) {",
                   "for (int ks0 = 0; ks0 < 0; ks0 += kRunKs) {")],
        "argmin": [("for (int o = 1; o < 4; o <<= 1) {",
                    "for (int o = 4; o < 4; o <<= 1) {")],
        "sums": [("for (int cs = 0; cs < n_cs; ++cs) {",
                  "for (int cs = 0; cs < 0; ++cs) {")],
    },
}


def _design(src):
    return "mma" if "mma_tf32" in src else "simt"


def _variant(src, cuts):
    for old, new in cuts:
        if old not in src:
            raise RuntimeError(f"cut not found in lloyd.cu: {old!r}")
        src = src.replace(old, new)
    return src


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
    if len(sys.argv) not in (2, 5, 6) or not torch.cuda.is_available() \
            or sys.argv[5:] not in ([], ["bf16"]):
        print(__doc__, file=sys.stderr)
        return 2
    root = os.path.abspath(sys.argv[1])
    n, d, k = (int(a) for a in sys.argv[2:5]) if len(sys.argv) >= 5 \
        else (N, D, K)
    bf16 = sys.argv[5:] == ["bf16"]
    sys.path.insert(0, root)
    from dask_ml_tpu_torch.ops import _build, fused

    if not os.path.abspath(fused.__file__).startswith(root):
        raise RuntimeError(f"imported {fused.__file__}, not from {root}")
    with open(os.path.join(_build.CSRC_DIR, "lloyd.cu")) as f:
        src = f.read()
    design = _design(src)
    variants = {"full": []}
    variants.update(CUTS[design])
    variants["all"] = [c for cuts in CUTS[design].values() for c in cuts]

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((n, d), generator=g, device=dev)
    c = x[torch.randperm(n, generator=g, device=dev)[:k]].clone()
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, cuts in variants.items():
            csrc = os.path.join(tmp, name, "csrc")
            shutil.copytree(_build.CSRC_DIR, csrc)
            with open(os.path.join(csrc, "lloyd.cu"), "w") as f:
                f.write(_variant(src, cuts))
            _build.CSRC_DIR = csrc
            _build.BUILD_DIR = os.path.join(tmp, name, "build")
            _build._loaded.clear()
            times[name] = _time_ms(
                (lambda: fused.fused_kmeans_block_stats(
                    x, n, c, mxu=torch.bfloat16)) if bf16 else
                (lambda: fused.fused_lloyd_stats(x, n, c)))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    full = times["full"]
    for name, ms in times.items():
        cut = "" if name == "full" else \
            f", the cut phase {full - ms:.3f} ms ({(full - ms) / full:.1%})"
        print(f"lloyd {design}{' bf16' if bf16 else ''} {n}x{d} k={k} "
              f"{name:7s}: {ms:.3f} ms{cut}")
    print(json.dumps({"root": root, "design": design, "device": smi,
                      "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
