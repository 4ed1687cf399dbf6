#!/usr/bin/env python3
"""Time the port's streamed passes over a memmap with and without the
native block reader.

    python3 scripts/stream_reader_times.py [ROWS D PASSES]

Writes a ROWS x D float32 ``np.memmap`` (default 4,000,000 x 256, the
streamed GLM phases' 4.1 GB) into a temporary directory and runs PASSES
(default 4) passes of one ``BlockStream`` over one memmap of it on
``config.device`` (the card), as a fit makes them, at ``stream_plan``'s
block height, with a consumer that only reduces each block on the
device, in the order copy, reader, reader, copy: X read by the reader
(``"native"``) or by the numpy copy (``"copy"``: the reader's route
switched off). The file was just written, so its pages are in the page
cache. Prints per case each pass's split by the stream's own counters
(host fill, waits for a staging buffer, device copies by CUDA events,
the pass) and one JSON object with the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _passes(path, shape, route, n_passes):
    """n_passes passes of one stream over one memmap, as a fit makes
    them; the split of each pass."""
    from dask_ml_tpu_torch.parallel.streaming import BlockStream, stream_plan

    split = {k: [] for k in ("host_s", "wait_s", "h2d_s", "pass_s")}
    mm = np.memmap(path, dtype=np.float32, mode="r", shape=shape)
    stream = BlockStream((mm,), block_rows=stream_plan(mm))
    if route == "copy":
        stream._native = (None,)
    for _ in range(n_passes):
        acc = torch.zeros((), device=stream.device)
        for blk in stream.blocks():
            acc += blk.arrays[0][: blk.n_rows].sum()
        float(acc)
        if stream.stats["reader"] != route:
            raise AssertionError(f"{route} pass took {stream.stats['reader']}")
        for k in split:
            split[k].append(1e3 * (stream.stats[k] or 0.0))
    return split


def main():
    if not torch.cuda.is_available():
        print("stream_reader_times: no CUDA device", file=sys.stderr)
        return 2
    args = [int(a) for a in sys.argv[1:]]
    rows, d, n_passes = (args + [4_000_000, 256, 4][len(args):])[:3]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    out = {"card": smi, "rows": rows, "d": d, "passes": n_passes,
           "cases": {}}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "X.f32")
        mm = np.memmap(path, dtype=np.float32, mode="w+", shape=(rows, d))
        rng = np.random.default_rng(0)
        for i in range(0, rows, 1 << 20):
            m = min(1 << 20, rows - i)
            mm[i:i + m] = rng.standard_normal((m, d), np.float32)
        mm.flush()
        del mm
        for route in ("copy", "native", "native", "copy"):
            split = _passes(path, (rows, d), route, n_passes)
            out["cases"].setdefault(route, []).append(split)
            print(f"{route:6s}: " + ", ".join(
                f"{k} " + " ".join(f"{x:.1f}" for x in v) + " ms"
                for k, v in split.items()), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
