"""Run chip_smoke.py's multi-process phases alone on a card: phase 28
(the process plane, uneven and empty ranks) and phase 29 (the 2-D
mesh, feature sharding), after the device line and the kernels' build.

    python3 scripts/process_phases.py [28|29|both]

Each phase spawns its two worker processes from ``chip_smoke.py`` and
fails on any gate, as in the full script (about 3 minutes for both with
the build on an H100).
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from dask_ml_tpu_torch.ops import fused  # noqa: E402


def main(which="both"):
    t0 = time.perf_counter()
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    results = {k: {"name": k} for k in fused.KERNELS}
    if which in ("28", "both"):
        chip_smoke.phase_processes(results)
    if which in ("29", "both"):
        chip_smoke.phase_feature_sharded(results)
    chip_smoke.log(f"process phases {which}: passed in "
                   f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "both")
