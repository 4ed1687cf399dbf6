"""The port's hand-written CUDA kernels: wrappers, plain versions, counts.

Counterpart of ``dask_ml_tpu/ops/pallas_fused.py``. Each kernel here
replaces one Pallas kernel of that module; the CUDA sources live in
``csrc/`` and say what bounds them on an H100 and how their design meets
it. Beside every kernel:

- a **plain PyTorch version** of the same function. A wrapper uses it
  only for tensors on the CPU (the CPU tests run it against the Pallas
  kernel); on a CUDA tensor the wrapper launches the kernel or raises;
- a **launch count**, a plain int on the wrapper (``wrapper.launches``),
  raised by one where the kernel is launched and nowhere else;
- a **geometry rule** where the kernel has choices (``lloyd_geometry``):
  a pure function of the shapes. No shape is refused: the kernels take
  every width and every number of centers, and their wrappers raise only
  on inputs no kernel is meant for (another family or dtype).

Outputs are raw f32 sums over the valid rows; callers add the mean
scaling and penalties. The Pallas kernels' 128-row tiles, VMEM budgets
and zero-padded copies of X are limits of the TPU and are not carried
over: the kernels mask the ragged edge themselves.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..models.solvers.families import get_family
from . import _build
from .pairwise import euclidean_distances_sq

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

_SIGNATURES = {
    "glm_value_grad": [_P, _I, _P, _P, _LL, _I, _I, _P, _I, _P, _P],
    "lloyd_pass": [_P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _I, _I,
                   _P, _P, _P, _P, _P, _I, _P, _P, _P, _P],
}


def _entry(source: str, fn: str):
    lib = _build.load(source)
    f = getattr(lib, fn)
    f.argtypes = _SIGNATURES[fn]
    f.restype = ctypes.c_int
    return f


def _check_rc(rc: int, fn: str):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {fn} failed to launch: "
                           f"cudaGetLastError() = {rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# scratch of one launch's per-CTA partials stays within this many floats
PARTIAL_FLOATS = 1 << 26


def _n_part(units, per_sm, device, width) -> int:
    """CTAs of a launch: one per unit of work, at most ``per_sm`` per SM,
    and fewer (but at least one per SM) where ``width`` floats of partials
    per CTA would outgrow PARTIAL_FLOATS."""
    sms = _sm_count(device)
    return max(1, min(units, per_sm * sms,
                      max(sms, PARTIAL_FLOATS // max(width, 1))))


def _require_cuda(name, *tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors must lie on the CPU or on a "
                         f"CUDA device, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must share {dev}, "
                             f"got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


# ---------------------------------------------------------------------------
# fused_glm_value_grad — csrc/glm_value_grad.cu
# replaces dask_ml_tpu/ops/pallas_fused.py:249 fused_glm_value_grad
# ---------------------------------------------------------------------------

GLM_FAMILIES = {"normal": 0, "logistic": 1, "poisson": 2}
# csrc/glm_value_grad.cu keeps a thread's columns of f32 X in registers
# up to d = 256 * kMaxCols and streams bf16 X and wider rows
GLM_REGISTER_MAX_D = 256 * 32
GLM_BLOCK_ROWS = 16                # rows per block at d <= 1024


def glm_value_grad_plain(x, n_valid, y, beta, family):
    """(Σ pointwise NLL, Σ ∂NLL/∂β (d,)) over rows < n_valid, in plain
    torch. bf16 x: beta rounded to bf16 for eta and the residual rounded
    to bf16 before the gradient product, every sum in f32 (the Pallas
    kernel's contract). Reads X twice: once for eta, once for the
    gradient."""
    n_valid = int(n_valid)
    fam = get_family(family)
    xv = x[:n_valid]
    yv = y[:n_valid].to(torch.float32)
    beta = beta.to(torch.float32)
    if x.dtype == torch.bfloat16:
        xf = xv.to(torch.float32)
        eta = xf @ beta.to(torch.bfloat16).to(torch.float32)
        resid = (fam.mean(eta) - yv).to(torch.bfloat16).to(torch.float32)
        grad = resid @ xf
    else:
        eta = xv @ beta
        grad = (fam.mean(eta) - yv) @ xv
    return fam.pointwise(eta, yv).sum(), grad


def fused_glm_value_grad(x, n_valid, y, beta, family):
    """(Σ pointwise NLL, Σ ∂NLL/∂β (d,)) of the rows < ``n_valid`` in ONE
    read of X. x (n, d) f32 or bf16, y (n,) f32, beta (d,) f32. On a CPU
    tensor this is :func:`glm_value_grad_plain`."""
    if x.device.type == "cpu":
        return glm_value_grad_plain(x, n_valid, y, beta, family)
    n, d = x.shape
    if family not in GLM_FAMILIES or x.dtype not in (torch.float32,
                                                     torch.bfloat16):
        raise ValueError(f"fused_glm_value_grad: no kernel for family "
                         f"{family!r} on {x.dtype} (the families "
                         f"{sorted(GLM_FAMILIES)}, float32 or bfloat16)")
    y = y.to(torch.float32)
    beta = beta.to(torch.float32).contiguous()
    _require_cuda("fused_glm_value_grad", x, y, beta)
    n_valid = int(n_valid)
    if y.shape != (n,) or beta.shape != (d,) or not 0 <= n_valid <= n:
        raise ValueError(
            f"fused_glm_value_grad: x {tuple(x.shape)}, y "
            f"{tuple(y.shape)}, beta {tuple(beta.shape)}, n_valid {n_valid}"
        )
    registers = x.dtype == torch.float32 and d <= GLM_REGISTER_MAX_D
    n_part = _n_part(-(-n_valid // GLM_BLOCK_ROWS), 4 if registers else 16,
                     x.device, d + 1)
    partials = torch.empty((n_part, d + 1), dtype=torch.float32,
                           device=x.device)
    out = torch.empty(d + 1, dtype=torch.float32, device=x.device)
    fn = _entry("glm_value_grad", "glm_value_grad")
    rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), y.data_ptr(),
            beta.data_ptr(), n_valid, d, GLM_FAMILIES[family],
            partials.data_ptr(), n_part, out.data_ptr(), _stream(x))
    _check_rc(rc, "glm_value_grad")
    fused_glm_value_grad.launches += 1
    return out[0], out[1:]


fused_glm_value_grad.launches = 0


# ---------------------------------------------------------------------------
# fused_lloyd_stats / fused_assign_update — csrc/lloyd.cu
# replace dask_ml_tpu/ops/pallas_fused.py:150 fused_lloyd_stats and
#         dask_ml_tpu/ops/pallas_fused.py:1074 fused_assign_update
# ---------------------------------------------------------------------------

LLOYD_THREADS = 256                # kThreads in csrc/lloyd.cu
LLOYD_TILE = 128                   # kBM: rows per tile
LLOYD_CHUNK = 64                   # kChunk: centers per register block
LLOYD_FEATURE_CHUNKS = (512, 256, 128, 64, 32)
LLOYD_SMEM_MAX = 232448            # shared memory a block may opt into


class LloydGeometry(NamedTuple):
    fc: int          # features per step, a multiple of 4
    n_fc: int        # feature chunks of a row
    n_cc: int        # chunks of 64 centers
    sums_smem: bool  # the CTA's (k, d) sums live in shared memory
    smem: int        # bytes of shared memory a CTA takes


def lloyd_geometry(d, k) -> LloydGeometry:
    """How csrc/lloyd.cu's kernel cuts (d, k), a rule on the shapes:
    the CTA's (k, d) sums in shared memory rather than device memory
    where they fit, then the widest feature chunk (a whole row first)
    whose shared memory fits. Shared memory holds two (128, fc + 4)
    sub-tiles of X, one (resident) or two (streamed) (fc, 64) blocks of
    the transposed centers, per-row scratch and, if they fit, the sums
    and counts. Every (d, k) has a geometry: 32 features per step with
    the sums in device memory take 55 KB."""
    n_cc = -(-k // LLOYD_CHUNK)
    whole = -(-d // 4) * 4
    fcs = [whole] + [c for c in LLOYD_FEATURE_CHUNKS if c < whole]
    bm = LLOYD_TILE
    for sums_smem in (True, False):
        for fc in fcs:
            n_fc = -(-d // fc)
            c_bufs = 1 if n_cc == 1 and n_fc == 1 else 2
            floats = (2 * bm * (fc + 4) + c_bufs * fc * LLOYD_CHUNK
                      + 2 * bm + LLOYD_THREADS
                      + (k * d + k if sums_smem else 0))
            if 4 * floats <= LLOYD_SMEM_MAX:
                return LloydGeometry(fc, n_fc, n_cc, sums_smem, 4 * floats)
    raise AssertionError("unreachable: the smallest geometry fits")


def _lloyd_plain(x, mask, n_rows, centers, mxu_dtype=None):
    """labels, min-d2, sums, counts (int32), inertia over x[:n_rows],
    rows with mask > 0 (all when mask is None) counted. The sums are a
    product with the masked one-hot assignment, not a scatter-add:
    CUDA's scatter-add adds in another order on every run, and a
    converged loop at ``tol=0`` must see a zero shift.
    ``mxu_dtype=torch.bfloat16`` takes the distance cross term on bf16
    operands (the plain KMeans loop's bf16 fit dtype)."""
    xv = x[:n_rows].to(torch.float32)
    c = centers.to(torch.float32)
    d2 = euclidean_distances_sq(xv, c, mxu_dtype=mxu_dtype)
    labels = d2.argmin(1)          # first index of the minimum
    mind = d2.gather(1, labels[:, None])[:, 0]
    w = (torch.ones(n_rows, dtype=torch.float32, device=x.device)
         if mask is None else (mask[:n_rows] > 0).to(torch.float32))
    onehot = torch.zeros((n_rows, c.shape[0]), dtype=torch.float32,
                         device=x.device).scatter_(1, labels[:, None],
                                                   w[:, None])
    counts = torch.bincount(labels[w > 0], minlength=c.shape[0])
    return (labels.to(torch.int32), mind, onehot.T @ xv,
            counts.to(torch.int32), (mind * w).sum())


def lloyd_stats_plain(x, n_valid, centers, mxu_dtype=None):
    _, _, sums, counts, inertia = _lloyd_plain(x, None, int(n_valid),
                                               centers, mxu_dtype)
    return sums, counts, inertia


def assign_update_plain(x, mask, centers):
    labels, mind, sums, counts, inertia = _lloyd_plain(
        x, mask, x.shape[0], centers)
    return labels, mind * mask.to(torch.float32), sums, counts, inertia


def _lloyd_launch(name, x, mask, n_rows, centers, per_row):
    if x.dtype != torch.float32 or x.ndim != 2:
        raise ValueError(f"{name}: x must be a 2-D float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    centers = centers.to(torch.float32).contiguous()
    k, d = centers.shape
    if x.shape[1] != d or not 0 <= n_rows <= x.shape[0]:
        raise ValueError(f"{name}: x {tuple(x.shape)}, centers "
                         f"{tuple(centers.shape)}, n_rows {n_rows}")
    _require_cuda(name, *([x, centers] + ([mask] if mask is not None
                                          else [])))
    dev = x.device
    geo = lloyd_geometry(d, k)
    kp = geo.n_cc * LLOYD_CHUNK
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    # the transposed centers, zero past d and k; their norms, +inf past k
    ct = torch.zeros((geo.n_fc * geo.fc, kp), **f32)
    ct[:d, :k] = centers.T
    c2 = torch.full((kp,), torch.inf, **f32)
    c2[:k] = (centers * centers).sum(1)
    vec4 = int(d % 4 == 0 and x.data_ptr() % 16 == 0)
    per_sm = max(1, min(2048 // LLOYD_THREADS,
                        LLOYD_SMEM_MAX // (geo.smem + 1024)))
    n_tiles = -(-n_rows // LLOYD_TILE)
    n_part = _n_part(n_tiles, per_sm, dev, k * d)
    psums = torch.empty((n_part, k, d), **f32)
    pcounts = torch.empty((n_part, k), **i32)
    pinertia = torch.empty(n_part, **f32)
    sums = torch.empty((k, d), **f32)
    counts = torch.empty(k, **i32)
    inertia = torch.empty(1, **f32)
    labels = torch.empty(n_rows, **i32) if per_row else None
    mind = torch.empty(n_rows, **f32) if per_row else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = _entry("lloyd", "lloyd_pass")
    rc = fn(x.data_ptr(), ptr(mask), ct.data_ptr(), c2.data_ptr(), n_rows,
            d, k, geo.fc, geo.n_fc, geo.n_cc, vec4,
            int(geo.sums_smem), geo.smem, ptr(labels), ptr(mind),
            psums.data_ptr(), pcounts.data_ptr(), pinertia.data_ptr(),
            n_part, sums.data_ptr(), counts.data_ptr(), inertia.data_ptr(),
            _stream(x))
    _check_rc(rc, "lloyd_pass")
    return labels, mind, sums, counts, inertia[0]


def fused_lloyd_stats(x, n_valid, centers):
    """Lloyd statistics of the rows < ``n_valid`` in one read of X:
    (sums (k, d) f32, counts (k,) int32, inertia ()) — no per-row
    output. On a CPU tensor this is :func:`lloyd_stats_plain`."""
    if x.device.type == "cpu":
        return lloyd_stats_plain(x, n_valid, centers)
    _, _, sums, counts, inertia = _lloyd_launch(
        "fused_lloyd_stats", x, None, int(n_valid), centers, False)
    fused_lloyd_stats.launches += 1
    return sums, counts, inertia


fused_lloyd_stats.launches = 0


def fused_assign_update(x, mask, centers):
    """One Lloyd pass with per-row outputs: (labels (n,) int32, masked
    min-d2 (n,), sums (k, d), counts (k,) int32, inertia ()). ``mask``
    (n,) f32 holds 0/1; rows with mask 0 get a label but count nowhere.
    On a CPU tensor this is :func:`assign_update_plain`."""
    if x.device.type == "cpu":
        return assign_update_plain(x, mask, centers)
    mask = mask.to(torch.float32).contiguous()
    if mask.shape != (x.shape[0],):
        raise ValueError(f"fused_assign_update: mask {tuple(mask.shape)} "
                         f"for x {tuple(x.shape)}")
    out = _lloyd_launch("fused_assign_update", x, mask, x.shape[0],
                        centers, True)
    fused_assign_update.launches += 1
    return out


fused_assign_update.launches = 0


# name -> (wrapper, CUDA source, the Pallas kernel it replaces)
KERNELS = {
    "fused_glm_value_grad": (
        fused_glm_value_grad, "dask_ml_tpu_torch/csrc/glm_value_grad.cu",
        "dask_ml_tpu/ops/pallas_fused.py:249"),
    "fused_lloyd_stats": (
        fused_lloyd_stats, "dask_ml_tpu_torch/csrc/lloyd.cu",
        "dask_ml_tpu/ops/pallas_fused.py:150"),
    "fused_assign_update": (
        fused_assign_update, "dask_ml_tpu_torch/csrc/lloyd.cu",
        "dask_ml_tpu/ops/pallas_fused.py:1074"),
}


def reset_launches():
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0


def launches() -> dict:
    return {name: w.launches for name, (w, _, _) in KERNELS.items()}
