"""The peak table: the denominators of every bound and MFU the port
reports.

Counterpart of ``dask_ml_tpu/observability/_peak.py``. A card known by
its name (``torch.cuda.get_device_name``) gets its data-sheet rates: the
memory rate and the peak of each kind of operation the kernels run. The
H100 SXM row is the one ``PERF.md`` (section 3) and ``chip_smoke.py``
bound the kernels by. Beside it, the row records the card's power limit
as ``nvidia-smi`` reads it, since a card set below its maximum runs
slower under load; where ``nvidia-smi`` is not there, the limit is
recorded as unknown. A card the table does not know gets no bound, with
the reason, never a guess; the CPU gets a measured matmul peak, as the
JAX package's fallback does.
"""

from __future__ import annotations

import subprocess
import time

# peak rates of one card by a substring of its name: HBM bytes/s and
# operations/s by the kind of operation. "tf32x3" is f32-accurate
# products on the tensor cores by the 3xTF32 split (csrc/tf32x3.cuh):
# three TF32 products at 495 TFLOP/s each
DEVICE_PEAKS = {
    "H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "peaks": {"float32": 67e12, "tf32x3": 495e12 / 3, "tf32": 495e12,
                  "bfloat16": 989e12},
        "source": "datasheet (NVIDIA H100 SXM5 at 700 W)",
    },
}

_cached_peak = None


def peak_row(device_name):
    """The table's row for a card named ``device_name``, or None."""
    for sub, row in DEVICE_PEAKS.items():
        if sub in str(device_name):
            return row
    return None


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them
    (first card), or a text saying why it is unknown."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError) as e:
        return f"unknown (nvidia-smi: {type(e).__name__})"
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        return f"unknown (nvidia-smi exit {out.returncode})"
    return lines[0].strip()


def _measured_cpu_peak(m=1024, reps=3) -> float:
    import torch

    a = torch.ones((m, m), dtype=torch.float32)
    a @ a
    t0 = time.perf_counter()
    for _ in range(reps):
        a @ a
    return 2.0 * m ** 3 * reps / (time.perf_counter() - t0)


def resolve_peak(use_cache=True) -> dict:
    """The peak of this process's device: ``{"device_kind", "source",
    "flops", "hbm_bytes_per_s", "peaks", "power_limit", "reason"}``.
    ``flops`` is the peak the report's MFU divides by (the bf16 tensor
    core peak of a known card, the measured matmul rate on the CPU);
    ``hbm_bytes_per_s`` and ``peaks`` are None where no bound can be
    given, and ``reason`` says why. Cached per process."""
    global _cached_peak
    if use_cache and _cached_peak is not None:
        return dict(_cached_peak)
    import torch

    if not torch.cuda.is_available():
        out = {"device_kind": "cpu", "source": "measured",
               "flops": _measured_cpu_peak(), "hbm_bytes_per_s": None,
               "peaks": None, "power_limit": None,
               "reason": "no kernel bound on the CPU (the kernels run on "
                         "the card only)"}
    else:
        name = torch.cuda.get_device_name(0)
        row = peak_row(name)
        out = {"device_kind": name, "power_limit": power_limit()}
        if row is None:
            out.update(source="unknown", flops=None, hbm_bytes_per_s=None,
                       peaks=None,
                       reason=f"no peak table for {name!r}: no bound")
        else:
            out.update(source=row["source"],
                       flops=row["peaks"]["bfloat16"],
                       hbm_bytes_per_s=row["hbm_bytes_per_s"],
                       peaks=dict(row["peaks"]), reason=None)
    _cached_peak = dict(out)
    return out


def bound_seconds(nbytes, terms, row):
    """(least seconds, "bytes" or "operations") on the card of ``row``
    for work that moves ``nbytes`` and does ``terms``, a sequence of
    (operations, kind of peak); None without a row."""
    if row is None or not row.get("hbm_bytes_per_s"):
        return None
    t_bytes = nbytes / row["hbm_bytes_per_s"]
    t_ops = sum(f / row["peaks"][kind] for f, kind in terms)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

