#!/usr/bin/env python3
"""Time the walks of csrc/glm_value_grad.cu against each other on one card.

    python3 scripts/glm_walk_times.py [ROOT]

Imports ``dask_ml_tpu_torch`` from the checkout at ROOT (default: this
one) and times, by CUDA events, kernel 1 (``fused_glm_value_grad``) and
kernel 5 (``fused_sgd_block_grad``) on each walk that
csrc/glm_value_grad.cu builds for the shape (``ops/fused.py::glm_walk``,
launched through the wrappers' private launchers), the rule's walk
(``glm_value_walk``) first:

- kernel 1 f32 on the registers and the staged walk at widths from 1025
  to 4096, and on the staged walk from 4097 to 8192 (about 2 GB of X
  each): where the staged walk starts to win is ``GLM_STAGED_F32_MIN_D``;
- kernel 1 at chip_smoke.py's shapes (4M x 257, 500k x 4097, 200k x
  10000; f32 and bf16) on every walk that takes them, the staged walk
  also with tiles of twice and half ``GLM_STAGE_BYTES``;
- kernel 5 at the Incremental block (250,000 x 128), at d = 64 and at
  500,000 x 256 on the narrow and the registers walk.

Each line gives the card (nvidia-smi name and power limit), the shape,
the walk and its ms, and the byte bound at 3.35 TB/s. About a minute.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

HBM = 3.35e12


def time_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main():
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
    sys.path.insert(0, root)
    from dask_ml_tpu_torch.ops import fused

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}; root {root}", flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def k1(n, d, dtype, walks, note=""):
        x = torch.randn((n, d), generator=g, device=dev).to(dtype)
        y = (torch.rand(n, generator=g, device=dev) < 0.5).float()
        beta = torch.randn(d, generator=g, device=dev) / d ** 0.5
        b_ms = n * (d * x.element_size() + 4) / HBM * 1e3
        ref = None
        for name, w in walks:
            out = fused._glm_value_grad_cuda(x, n, y, beta, "logistic", w)
            if ref is None:
                ref = out
            dev_ = float((out[1] - ref[1]).abs().max() /
                         ref[1].abs().max())
            ms = time_ms(lambda: fused._glm_value_grad_cuda(
                x, n, y, beta, "logistic", w))
            print(f"kernel 1 {str(dtype):14s} {n}x{d}{note} {name:28s} "
                  f"{ms:.3f} ms (bound {b_ms:.3f}, {b_ms / ms:.1%}); grad "
                  f"rel dev from the first walk {dev_:.1e}", flush=True)
        del x

    f32, bf16 = torch.float32, torch.bfloat16

    def built(names, d, dtype, mode="resident"):
        """(name, walk) of each of ``names`` that takes the shape, the
        rule's walk first."""
        rule = fused.glm_value_walk(d, dtype, mode)
        out = [(rule.walk, rule)]
        for name in names:
            try:
                w = fused.glm_walk(name, d, dtype, mode)
            except ValueError:
                continue
            if name != rule.walk:
                out.append((name, w))
        return out

    for d in (1025, 1537, 2049, 3073, 4096, 4097, 6145, 8192):
        k1((1 << 29) // d, d, f32, built(("registers", "staged"), d, f32))

    def staged_variants(d, dtype):
        out = []
        base = fused.GLM_STAGE_BYTES
        for scale in (2, 0.5):
            fused.GLM_STAGE_BYTES = int(base * scale)
            try:
                w = fused.glm_walk("staged", d, dtype)
                out.append((f"staged rows={w.rows} per_sm={w.per_sm}", w))
            except ValueError:
                pass
            finally:
                fused.GLM_STAGE_BYTES = base
        return out

    for n, d in ((4_000_000, 257), (500_000, 4097), (200_000, 10_000)):
        for dtype in (f32, bf16):
            k1(n, d, dtype, built(("registers", "stream"), d, dtype)
               + staged_variants(d, dtype))

    for S, d in ((250_000, 128), (250_000, 64), (500_000, 256)):
        x = torch.randn((S, d), generator=g, device=dev)
        y = (torch.rand(S, generator=g, device=dev) < 0.5).float()
        w_ext = torch.randn(d + 1, generator=g, device=dev) / (4 * d ** 0.5)
        b_ms = S * (d + 1) * 4 / HBM * 1e3
        for mxu in (None, bf16):
            mode = "vg" if mxu is None else "vg_bf16"
            walks = built(("narrow", "registers"), d, f32, mode)
            for loss in ("log_loss", "hinge", "squared_error"):
                for name, w in walks:
                    ms = time_ms(lambda: fused._sgd_block_grad_cuda(
                        x, S, y, w_ext, 1.0, loss, mxu, w), reps=50)
                    print(f"kernel 5 {loss:13s} {mode:8s} {S}x{d} "
                          f"{name:28s} {ms:.4f} ms (bound {b_ms:.4f}, "
                          f"{b_ms / ms:.1%})", flush=True)
        del x


if __name__ == "__main__":
    main()
