#!/usr/bin/env python3
"""Compare two checkouts' builds of the port's CUDA kernels on one card.

    python3 scripts/torch_build_compare.py dump ROOT OUT.pt
    python3 scripts/torch_build_compare.py compare A.pt B.pt

``dump`` imports ``dask_ml_tpu_torch`` from the checkout at ROOT (its
kernels are built there at first use), runs every kernel entry point on
inputs drawn from a fixed seed at chip_smoke.py's streamed shapes and
saves the outputs to OUT.pt (put it under "$TMPDIR" or a git-ignored
directory of the checkout). ``compare`` prints, kernel by kernel, whether
two dumps are bit-equal and otherwise their largest relative deviation.
Times come from chip_smoke.py: run each checkout's in the same call.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

C = 10
S = 262_144


def _inputs(dev):
    g = torch.Generator(device=dev).manual_seed(5)
    d = 256
    x = torch.randn((S, d), generator=g, device=dev)
    x[S - 7:] = torch.nan
    return {
        "x": x,
        "y": (torch.rand(S, generator=g, device=dev) < 0.5).float(),
        "beta": torch.randn(d + 1, generator=g, device=dev) / 64,
        "codes": torch.randint(0, C, (S,), generator=g, device=dev).float(),
        "B": torch.randn((C, d + 1), generator=g, device=dev) / 64,
        "W16": torch.randn((16, d + 1), generator=g, device=dev) / 64,
        "km": torch.randn((S, 128), generator=g, device=dev),
    }


def _outputs(fused, dev):
    """Every kernel on the same inputs; rows past S - 7 are NaN (unread)."""
    t = _inputs(dev)
    x, y, beta, codes, B = t["x"], t["y"], t["beta"], t["codes"], t["B"]
    n = S - 7
    bf16 = torch.bfloat16
    out = {}
    for kind, mxu in [("val", None), ("vg", None), ("vg", bf16),
                      ("vgh", None)]:
        out[f"glm_stream_{kind}_{mxu}"] = fused.fused_glm_stream(
            kind, x, n, y, beta, "logistic", True, mxu=mxu)
    for kind, mxu in [("val", None), ("vg", None), ("vg", bf16)]:
        out[f"glm_multi_stream_{kind}_{mxu}"] = fused.fused_glm_multi_stream(
            kind, x, n, codes, B, "logistic", True, mxu=mxu)
    for loss in ("log_loss", "hinge", "squared_error"):
        for mxu in (None, bf16):
            out[f"sgd_block_{loss}_{mxu}"] = fused.fused_sgd_block_grad(
                x, n, y, beta, 1.0, loss, mxu)
            out[f"sgd_many_codes_{loss}_{mxu}"] = \
                fused.fused_sgd_many_block_grad(x, n, codes, B, 1.0, loss,
                                                True, mxu)
            out[f"sgd_many_cohort_{loss}_{mxu}"] = \
                fused.fused_sgd_many_block_grad(
                    x, n, y, t["W16"], (torch.arange(16, device=dev) % 2)
                    .float(), loss, False, mxu)
    xr = torch.nan_to_num(x[:, :255]).contiguous()
    out["glm_value_grad"] = fused.fused_glm_value_grad(
        xr, n, y, beta[:255], "logistic")
    out["glm_value_grad_hess"] = fused.fused_glm_value_grad_hess(
        xr, n, y, beta[:255], "logistic")
    out["glm_multi_value_grad"] = fused.fused_glm_multi_value_grad(
        xr, n, codes.int(), B[:, :255], "logistic")
    km = t["km"]
    cent = km[:64].clone()
    out["lloyd_stats"] = fused.fused_lloyd_stats(km, n, cent)
    mask = (torch.arange(S, device=dev) < n).float()
    out["assign_update"] = fused.fused_assign_update(km, mask, cent)
    for mxu in (None, bf16):
        out[f"kmeans_block_stats_{mxu}"] = fused.fused_kmeans_block_stats(
            km, n, cent, mxu=mxu)
    torch.cuda.synchronize()
    return {k: [v.detach().clone().cpu() for v in vals]
            for k, vals in out.items()}


def dump(root, path):
    sys.path.insert(0, root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dask_ml_tpu_torch.ops import fused

    if not os.path.abspath(fused.__file__).startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {fused.__file__}, not from {root}")
    dev = torch.device("cuda")
    torch.save(_outputs(fused, dev), path)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"root": root, "device": smi}))


def compare(a_path, b_path):
    a, b = torch.load(a_path), torch.load(b_path)
    equal = []
    for k in a:
        same = all(torch.equal(p, q) for p, q in zip(a[k], b[k]))
        if same:
            equal.append(k)
            continue
        rel = max(float((p.double() - q.double()).abs().max()
                        / max(float(q.double().abs().max()), 1e-30))
                  for p, q in zip(a[k], b[k]))
        print(f"differ {k}: max relative deviation {rel:.3e}")
    print(f"bit-equal ({len(equal)} of {len(a)}): {', '.join(equal)}")


def main():
    if len(sys.argv) == 4 and sys.argv[1] == "dump":
        dump(sys.argv[2], sys.argv[3])
    elif len(sys.argv) == 4 and sys.argv[1] == "compare":
        compare(sys.argv[2], sys.argv[3])
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
