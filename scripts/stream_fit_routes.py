#!/usr/bin/env python3
"""Time the port's streamed lbfgs fit with X read by the native block
reader and by the numpy copy, in one process.

    python3 scripts/stream_fit_routes.py [ROUNDS]

Writes chip_smoke.py's 4,000,000 x 256 float32 memmap (4.1 GB, from a
seeded N(0, 1) draw on the card) into a temporary directory and fits
``LogisticRegression(solver="lbfgs", max_iter=10, tol=0.0)`` on it with
in-memory labels, ROUNDS times (default 3) in the order copy, reader,
reader, copy. The copy route is taken by giving each stream no reader.
Prints per fit its wall time, its passes and the median and mean of the
host fill per pass (the stream's own counter), and one JSON object with
the card's name and power limit. The first reader fit also builds the
host library.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    if not torch.cuda.is_available():
        print("stream_fit_routes: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.parallel.streaming import BlockStream

    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    fills = []
    blocks = BlockStream.blocks
    native = BlockStream._native_readers

    def counted(self, order=None):
        yield from blocks(self, order)
        fills.append(1e3 * self.stats["host_s"])

    def no_reader(self):
        self._native = (None,) * len(self.arrays)
        return self._native

    BlockStream.blocks = counted
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    out = {"card": smi, "fits": []}
    g = torch.Generator(device="cuda").manual_seed(0)
    X = torch.randn(4_000_000, 256, device="cuda", generator=g)
    w = torch.randn(256, device="cuda", generator=g)
    y = ((X @ w) > 0).float().cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        mm = chip_smoke._write_memmap(tmp, "X.f32", X)
        del X
        torch.cuda.empty_cache()
        for route in ["copy", "native", "native", "copy"] * rounds:
            BlockStream._native_readers = native if route == "native" \
                else no_reader
            fills.clear()
            t0 = time.perf_counter()
            est = LogisticRegression(solver="lbfgs", max_iter=10,
                                     tol=0.0).fit(mm, y)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if est.stream_stats_["reader_passes"] != {route: len(fills)}:
                raise AssertionError(f"{route} fit took "
                                     f"{est.stream_stats_['reader_passes']}")
            fit = {"route": route, "wall_s": wall, "passes": len(fills),
                   "fill_median_ms": statistics.median(fills),
                   "fill_mean_ms": statistics.mean(fills)}
            out["fits"].append(fit)
            print(f"{route:6s} wall {wall:.3f} s, {len(fills)} passes, host "
                  f"fill median {fit['fill_median_ms']:.1f} ms, mean "
                  f"{fit['fill_mean_ms']:.1f} ms", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
