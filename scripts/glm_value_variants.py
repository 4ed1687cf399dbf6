#!/usr/bin/env python3
"""Time variants of csrc/glm_value_grad.cu's staged walk on one card.

    python3 scripts/glm_value_variants.py [ROOT] [VARIANT ...]

ROOT (default: this checkout) is imported. Each VARIANT (default: all of
VARIANTS) is the checkout's ``csrc/glm_value_grad.cu`` with the text
edits listed below, built with ROOT's build rules into a temporary
directory; ``fused_glm_value_grad`` is then timed on the staged walk by
CUDA events (the mean of 20 calls after 3 warm-up calls) at the shapes of
SHAPES, X drawn from a fixed seed. The edits that cut work ("copy-only",
"no-grad") give wrong sums: a variant is for timing only, and
chip_smoke.py and tests/test_torch_cuda.py check the checkout's kernels.
Prints a line per (variant, shape, tile rows) and the card's name and
power limit.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

import torch

# name: (text edits of glm_value_grad.cu, overrides of ops/fused.py)
VARIANTS = {
    "checkout": ([], {}),
    # the ring and its barriers alone: no eta, family or gradient
    "copy-only": ([("    const int sh = flat_shift(x + row0 * d);\n",
                    "    const int sh = flat_shift(x + row0 * d);\n"
                    "    if (sh >= 0) continue;\n")], {}),
    # eta and the family, no gradient (rows of at most 1024 features)
    "no-grad": ([("      if constexpr (want_grad) {\n#pragma unroll\n"
                  "        for (int r = 0; r < kPassRows; ++r) {",
                  "      if constexpr (false) {\n#pragma unroll\n"
                  "        for (int r = 0; r < kPassRows; ++r) {")], {}),
    # the family's terms replaced by eta and eta - y
    "no-family": ([
        ("          family_terms(family, eta, ys[pass + tid], &per, "
         "&resid);",
         "          per = eta;\n          resid = eta - ys[pass + tid];"),
        ("      family_terms(family, eta_l, ys[lane], &per, &resid);",
         "      per = eta_l;\n      resid = eta_l - ys[lane];")], {}),
    # no barrier between the rows' sums and the family (wider rows)
    "no-mid-barrier": ([
        ("    __syncthreads();\n    float eta_l = 0.f;",
         "    float eta_l = 0.f;")], {}),
    # eta's loads cut (wider rows)
    "no-eta-loads": ([
        ("              s = fmaf(staged_x<T, kMode>(tile, p0 + kThreads * j), "
         "b[j],\n                       s);",
         "              s += b[j];")], {}),
    # no halving shuffles (rows of at most 1024 features)
    "no-halving": ([("      glm::warp_sum_halving<kPassRows>(p, lane);",
                     "")], {}),
    # a ring of 3 stages at every width
    "stages-3": ([], {"GLM_STAGED_STAGES": (3, 3)}),
    # a tile of 32 rows in one pass, 2 CTAs an SM (rows of <= 1024)
    "pass-32": ([("constexpr int kPassRows = 16;",
                  "constexpr int kPassRows = 32;"),
                 ("__global__ void __launch_bounds__(kThreads, 3)\n"
                  "glm_staged(",
                  "__global__ void __launch_bounds__(kThreads, 2)\n"
                  "glm_staged(")],
                {"GLM_STAGED_PER_SM": {1024: 2, 6144: 3, 12288: 2}}),
}
# (n, d, dtype, GLM_STAGE_BYTES)
SHAPES = [(4_000_000, 257, torch.bfloat16, 20480),
          (500_000, 4097, torch.float32, 16384),
          (500_000, 4097, torch.float32, 32768),
          (500_000, 4097, torch.bfloat16, 32768),
          (200_000, 10_000, torch.float32, 16384),
          (200_000, 10_000, torch.bfloat16, 16384)]


def time_ms(fn, reps=20):
    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main():
    args = sys.argv[1:]
    root = os.path.abspath(args.pop(0) if args and os.path.isdir(args[0])
                           else ".")
    names = args or list(VARIANTS)
    sys.path.insert(0, root)
    from dask_ml_tpu_torch.ops import _build, fused

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}; root {root}", flush=True)
    dev = torch.device("cuda")
    csrc0 = _build.CSRC_DIR
    base = open(os.path.join(csrc0, "glm_value_grad.cu")).read()
    saved = {k: getattr(fused, k) for k in (
        "GLM_MAX_STAGES", "GLM_STAGED_PER_SM", "GLM_STAGE_BYTES",
        "GLM_STAGED_STAGES")}
    g = torch.Generator(device=dev).manual_seed(0)
    data = {}
    for n, d, dtype, _ in SHAPES:
        if (n, d, dtype) not in data:
            x = torch.randn((n, d), generator=g, device=dev).to(dtype)
            y = (torch.rand(n, generator=g, device=dev) < 0.5).float()
            beta = torch.randn(d, generator=g, device=dev) / d ** 0.5
            data[(n, d, dtype)] = (x, y, beta)
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            edits, overrides = VARIANTS[name]
            src = base
            for old, new in edits:
                if old not in src:
                    raise RuntimeError(f"variant {name}: edit not found")
                src = src.replace(old, new)
            csrc = os.path.join(tmp, name, "csrc")
            shutil.copytree(csrc0, csrc)
            with open(os.path.join(csrc, "glm_value_grad.cu"), "w") as f:
                f.write(src)
            _build.CSRC_DIR = csrc
            _build.BUILD_DIR = os.path.join(tmp, name, "build")
            _build._loaded.clear()
            for k, v in overrides.items():
                setattr(fused, k, v)
            for n, d, dtype, stage_bytes in SHAPES:
                x, y, beta = data[(n, d, dtype)]
                fused.GLM_STAGE_BYTES = stage_bytes
                w = fused.glm_walk("staged", d, dtype)
                ms = time_ms(lambda: fused._glm_value_grad_cuda(
                    x, n, y, beta, "logistic", w))
                b_ms = n * (d * x.element_size() + 4) / 3.35e12 * 1e3
                print(f"{name:10s} {str(dtype):14s} {n}x{d} rows={w.rows} "
                      f"per_sm={w.per_sm} smem={w.smem}: {ms:.3f} ms "
                      f"({b_ms / ms:.1%} of the {b_ms:.3f} ms bound)",
                      flush=True)
            for k, v in saved.items():
                setattr(fused, k, v)
    _build.CSRC_DIR = csrc0
    return 0


if __name__ == "__main__":
    sys.exit(main())
