"""The port's hand-written CUDA kernels: wrappers, plain versions, counts.

Counterpart of ``dask_ml_tpu/ops/pallas_fused.py``. Each kernel here
replaces one Pallas kernel of that module; the CUDA sources live in
``csrc/`` and say what bounds them on an H100 and how their design meets
it. The streamed kernels (``fused_glm_stream``, ``fused_glm_multi_stream``,
``fused_kmeans_block_stats``) share the device code of their resident
twins and have launchers of their own: they take one streamed block and
its count of valid rows, and ADD the block's sums into accumulators
(``acc``) that a pass keeps on the device, so a pass is one launch per
block and its sums are added in block order. The SGD step kernels
(``fused_sgd_block_grad``, ``fused_sgd_many_block_grad``) share the
streamed GLM kernels' device code with the SGD losses and return one
block's sums. Beside every kernel:

- a **plain PyTorch version** of the same function. A wrapper uses it
  only for tensors on the CPU (the CPU tests run it against the Pallas
  kernel); on a CUDA tensor the wrapper launches the kernel or raises;
- a **launch count**, a plain int on the wrapper (``wrapper.launches``),
  raised by one where the kernel is launched and nowhere else;
- a **geometry rule** where the kernel has choices
  (``lloyd_mma_geometry``, ``vgh_geometry``, ``multi_mma_geometry``,
  ``multi_stream_geometry``): a pure function of the shapes. No shape is
  refused: the kernels take every width and every number of centers, and
  their wrappers raise only on inputs no kernel is meant for (another
  family or dtype).

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
_F = ctypes.c_float

_SIGNATURES = {
    "glm_value_grad": [_P, _I, _P, _P, _LL, _I, _I, _I, _I, _I, _P, _I, _P,
                       _P],
    "glm_stream": [_P, _I, _P, _P, _I, _LL, _I, _I, _I, _I, _I, _I, _P, _I,
                   _P, _P],
    "glm_stream_vgh": [_P, _P, _P, _I, _LL, _I, _I, _P, _P, _P, _P, _I, _P,
                       _P, _P, _I, _LL, _P, _P],
    "glm_multi_stream": [_P, _I, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I,
                         _I, _P, _P, _I, _P, _P],
    "kmeans_block_stats": [_P, _I, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _I,
                           _P, _P, _P, _P, _I, _P, _P, _P, _P],
    "lloyd_pass": [_P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _I,
                   _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P],
    "glm_value_grad_hess": [_P, _P, _P, _LL, _I, _I, _P, _P, _P, _I, _P, _P,
                            _I, _LL, _P, _P],
    "glm_multi_value_grad": [_P, _I, _P, _P, _LL, _I, _I, _I, _I, _I, _P, _P,
                             _I, _P, _P],
    "glm_multi_mma_tile_scratch": [_I],
    "glm_vgh_tile_ctas_per_sm": [],
    "sgd_block_grad": [_P, _I, _P, _P, _F, _LL, _I, _I, _I, _I, _I, _P, _I,
                       _P, _P],
    "sgd_many_block_grad": [_P, _I, _P, _I, _P, _P, _LL, _I, _I, _I, _I, _I,
                            _I, _I, _P, _P, _I, _P, _P],
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


def _n_part(units, per_sm, sms, width) -> int:
    """CTAs of a launch: one per unit of work, at most ``per_sm`` on each
    of ``sms`` SMs, and fewer (but at least one per SM) where ``width``
    floats of partials per CTA would outgrow PARTIAL_FLOATS."""
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

# The walks of csrc/glm_value_grad.cu (kernels 1, 5 and 6 "val"/"vg"), by
# their codes in the C entry points, and its modes (csrc Mode)
GLM_WALKS = {"registers": 0, "staged": 1, "narrow": 2, "stream": 3}
GLM_MODES = {"resident": 0, "val": 1, "vg": 2, "vg_bf16": 3}
GLM_WARPS = 8                      # kWarps: a CTA's warps in every walk
GLM_REGISTER_MAX_D = 256 * 16      # registers: 16 columns a thread at most
GLM_BLOCK_ROWS = 16                # registers and stream: rows of a unit
GLM_REGISTER_PER_SM = 4
GLM_STREAM_PER_SM = 16
# f32 rows from this width take the staged walk, not the registers walk
# (on an H100 the staged walk measured faster at d = 4097, 6145 and 8192
# and slower at 513-3073: PERF.md section 6)
GLM_STAGED_F32_MIN_D = GLM_REGISTER_MAX_D + 1
GLM_MANY_TILE_BYTES = 20480        # rows <= 1024: 32 rows a tile if
                                   # they fit in this, else 16
GLM_STAGE_BYTES = 40960            # bytes of X a wide-row tile aims at
GLM_STAGED_MAX_D = 256 * 48        # kWideMaxCols: a thread's columns
# CTAs an SM (__launch_bounds__): 3 up to 24 columns a thread (d <=
# 6144), else 2; fewer where their rings would not fit
GLM_STAGED_PER_SM = {6144: 3, GLM_STAGED_MAX_D: 2}
GLM_STAGED_STAGES = (4, 3)         # ring depth: rows <= 1024, wider
GLM_MAX_STAGES = 4                 # kMaxStages
GLM_NARROW_MAX_D = 128             # kNarrowMaxD: 32 lanes x 4 features
GLM_NARROW_ROWS = 8                # kNarrowRows: rows a lane group takes
GLM_NARROW_PER_SM = 3              # its __launch_bounds__
SMEM_PER_SM = 233_472              # an H100 SM's shared memory
SMEM_PER_CTA = 232_448             # a CTA's most (dynamic included)
SMEM_CTA_RESERVE = 1024 + 256      # the system's share and static arrays


class GlmWalk(NamedTuple):
    walk: str        # a key of GLM_WALKS
    rows: int        # staged: rows a tile; narrow: lanes a row takes
    smem: int        # staged: bytes of dynamic shared memory
    per_sm: int      # CTAs an SM holds
    unit_rows: int   # rows of a CTA's unit of work (the n_part rule)


def _staged_stage_bytes(rows, d, itemsize):
    """csrc Staged<T>::bytes: ``rows`` whole rows as one flat run from the
    16-byte boundary at or before the first, in 16-byte chunks, then
    their y in 16-byte chunks."""
    per = 16 // itemsize
    return ((rows * d + 2 * per - 2) // per * per * itemsize
            + (4 * rows + 15) // 16 * 16)


def narrow_lanes(d):
    """csrc narrow_lanes: lanes a row of the narrow walk takes, 4
    features a lane, a power of two."""
    lanes = 1
    while 4 * lanes < d:
        lanes *= 2
    return lanes


def glm_walk(name, d, dtype=torch.float32, mode="resident"):
    """The GlmWalk ``name`` at width d for X of ``dtype`` (f32 or bf16;
    bf16 X is kernel 1's, mode "resident") in ``mode`` (a key of
    GLM_MODES), or ValueError where csrc/glm_value_grad.cu builds no
    kernel of that walk for the shape. :func:`glm_value_walk` picks one;
    the others are for measuring the rule's cuts against them.

    - registers (f32, d <= GLM_REGISTER_MAX_D): a thread's columns and a
      block of rows in registers, CTA sums per row behind barriers;
    - staged (bf16 X, and f32 rows past 1024 features; d <=
      GLM_STAGED_MAX_D): tiles of whole rows copied into a ring of
      GLM_STAGED_STAGES tiles in shared memory by cp.async,
      GLM_STAGED_PER_SM CTAs an SM (fewer where their rings do not fit);
      a thread owns the columns t + 256 j and keeps their beta and
      gradient in registers. bf16 rows of at most 1024 features: tiles of
      16 or 32 rows, read 16 rows a pass into registers for eta and the
      gradient; wider rows: tiles of 1, 2 or 4 rows, the most within
      GLM_STAGE_BYTES of X that leave 2 CTAs an SM;
    - narrow (f32, d <= GLM_NARROW_MAX_D): a lane group per row, 16
      bytes a lane, GLM_NARROW_ROWS rows a group at once, no barrier in
      the row loop;
    - stream (rows too wide to stage): each block of rows read twice,
      the second time from L1 or L2."""
    if mode not in GLM_MODES:
        raise ValueError(f"glm_walk: mode {mode!r} is not one of "
                         f"{sorted(GLM_MODES)}")
    if dtype not in (torch.float32, torch.bfloat16) or (
            dtype == torch.bfloat16 and mode != "resident"):
        raise ValueError(f"glm_walk: no walk takes {dtype} X in mode "
                         f"{mode!r}")
    itemsize = 2 if dtype == torch.bfloat16 else 4
    f32 = dtype == torch.float32
    many = d <= 4 * 256
    if name == "registers" and f32 and d <= GLM_REGISTER_MAX_D:
        return GlmWalk(name, 0, 0, GLM_REGISTER_PER_SM, GLM_BLOCK_ROWS)
    if name == "narrow" and f32 and d <= GLM_NARROW_MAX_D:
        lanes = narrow_lanes(d)
        return GlmWalk(name, lanes, 0, GLM_NARROW_PER_SM,
                       GLM_WARPS * (32 // lanes) * GLM_NARROW_ROWS)
    if name == "staged" and d <= GLM_STAGED_MAX_D and not (f32 and many):
        row_bytes = d * itemsize
        stages = GLM_STAGED_STAGES[0 if many else 1]
        cap = next(v for k, v in sorted(GLM_STAGED_PER_SM.items())
                   if d <= k)

        def fit(rows):
            stage = _staged_stage_bytes(rows, d, itemsize)
            return stage, min(cap, SMEM_PER_SM // (stages * stage
                                                   + SMEM_CTA_RESERVE))

        if many:
            # a thread's columns of 16 rows a pass in registers
            rows = 32 if 32 * row_bytes <= GLM_MANY_TILE_BYTES else 16
        else:
            # the most rows within GLM_STAGE_BYTES that leave 2 CTAs an SM
            rows = 4
            while rows > 1 and (rows * row_bytes > GLM_STAGE_BYTES
                                or fit(rows)[1] < 2):
                rows //= 2
        stage, per_sm = fit(rows)
        while per_sm < 1 and stages > 2:
            stages -= 1
            stage, per_sm = fit(rows)
        if per_sm >= 1 and stages * stage <= SMEM_PER_CTA - SMEM_CTA_RESERVE:
            return GlmWalk(name, rows, stages * stage, per_sm, rows)
    if name == "stream":
        return GlmWalk(name, 0, 0, GLM_STREAM_PER_SM, GLM_BLOCK_ROWS)
    raise ValueError(f"glm_walk: the {name!r} walk does not take d = {d} "
                     f"on {dtype} X")


def glm_value_walk(d, dtype=torch.float32, mode="resident"):
    """The walk csrc/glm_value_grad.cu takes at width d, a rule on the
    shape: f32 rows of at most GLM_NARROW_MAX_D features the narrow walk;
    other f32 rows up to GLM_REGISTER_MAX_D the registers walk (the main
    paths: kernel 1 at d = 257, kernels 5 and 6 at d = 256) below
    GLM_STAGED_F32_MIN_D; bf16 X at every width and wider f32 rows the
    staged walk, and rows too wide for it the stream walk."""
    if dtype == torch.float32 and d <= GLM_NARROW_MAX_D:
        return glm_walk("narrow", d, dtype, mode)
    if dtype == torch.float32 and d < GLM_STAGED_F32_MIN_D:
        return glm_walk("registers", d, dtype, mode)
    try:
        return glm_walk("staged", d, dtype, mode)
    except ValueError:
        return glm_walk("stream", d, dtype, mode)


def glm_walk_n_part(walk, n_valid, width, sms):
    """CTAs of a launch of ``walk`` (:func:`_n_part`): one per unit of
    ``walk.unit_rows`` rows, at most ``walk.per_sm`` an SM."""
    return _n_part(-(-int(n_valid) // walk.unit_rows), walk.per_sm, sms,
                   width)


def _walk_args(walk):
    """The C entry points' (walk, rows, smem) of ``walk``."""
    return GLM_WALKS[walk.walk], walk.rows, walk.smem


def _walk_x(walk, x):
    """X as ``walk`` reads it: the staged walk copies each tile from the
    16-byte boundary at or before its first row, so a view whose storage
    is not itself 16-byte aligned is cloned (the bytes before a view's
    first row lie in its storage)."""
    if walk.walk == "staged" and x.untyped_storage().data_ptr() % 16:
        return x.clone()
    return x


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
    read of X, on :func:`glm_value_walk`'s walk. x (n, d) f32 or bf16, y
    (n,) f32, beta (d,) f32. On a CPU tensor this is
    :func:`glm_value_grad_plain`."""
    if x.device.type == "cpu":
        return glm_value_grad_plain(x, n_valid, y, beta, family)
    n, d = x.shape
    _check_glm_family("fused_glm_value_grad", family, x,
                      (torch.float32, torch.bfloat16))
    y = y.to(torch.float32)
    beta = beta.to(torch.float32).contiguous()
    _require_cuda("fused_glm_value_grad", x, y, beta)
    n_valid = int(n_valid)
    if y.shape != (n,) or beta.shape != (d,) or not 0 <= n_valid <= n:
        raise ValueError(
            f"fused_glm_value_grad: x {tuple(x.shape)}, y "
            f"{tuple(y.shape)}, beta {tuple(beta.shape)}, n_valid {n_valid}"
        )
    return _glm_value_grad_cuda(x, n_valid, y, beta, family,
                                glm_value_walk(d, x.dtype))


def _glm_value_grad_cuda(x, n_valid, y, beta, family, walk):
    """:func:`fused_glm_value_grad`'s launch on ``walk`` (a
    :func:`glm_walk`) for checked CUDA inputs; scripts/glm_walk_times.py
    measures the rule's cuts through it."""
    d = x.shape[1]
    x = _walk_x(walk, x)
    n_part = glm_walk_n_part(walk, n_valid, d + 1, _sm_count(x.device))
    partials = torch.empty((n_part, d + 1), dtype=torch.float32,
                           device=x.device)
    out = torch.empty(d + 1, dtype=torch.float32, device=x.device)
    fn = _entry("glm_value_grad", "glm_value_grad")
    rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), y.data_ptr(),
            beta.data_ptr(), n_valid, d, GLM_FAMILIES[family],
            *_walk_args(walk), partials.data_ptr(), n_part,
            out.data_ptr(), _stream(x))
    _check_rc(rc, "glm_value_grad")
    fused_glm_value_grad.launches += 1
    return out[0], out[1:]


fused_glm_value_grad.launches = 0


def _check_glm_family(name, family, x, dtypes):
    if family not in GLM_FAMILIES or x.dtype not in dtypes:
        raise ValueError(f"{name}: no kernel for family {family!r} on "
                         f"{x.dtype} (the families {sorted(GLM_FAMILIES)}, "
                         f"{' or '.join(str(t) for t in dtypes)})")


# ---------------------------------------------------------------------------
# fused_glm_value_grad_hess — csrc/glm_value_grad_hess.cu
# replaces dask_ml_tpu/ops/pallas_fused.py:331 fused_glm_value_grad_hess
# ---------------------------------------------------------------------------

VGH_TILE = 128                     # kBT: edge of a Hessian tile
VGH_TAIL = 16                      # kTail: a rest of d this narrow is folded
VGH_STEP_ROWS = 32                 # kKC: rows per stage of a tile
VGH_ROW_WARPS = 8                  # kRowWarps: warps of a row-pass CTA
VGH_ROWS_PER_WARP = 4              # kRowsPerWarp: rows a warp takes at once
VGH_WAVES = 2                      # waves of tile CTAs the splits aim at
VGH_MIN_SPLIT_ROWS = 512           # rows a split holds, at least


class VghGeometry(NamedTuple):
    nb: int              # 128-wide column blocks
    n_tiles: int         # upper-triangle tiles, nb (nb + 1) / 2
    n_split: int         # row ranges; 1: tiles write the output directly
    rows_per_split: int  # a multiple of VGH_STEP_ROWS


def vgh_geometry(n_valid, d, slots) -> VghGeometry:
    """How csrc/glm_value_grad_hess.cu cuts the work, a rule on the
    shapes and the card's ``slots``, the tile CTAs it holds at once: the
    upper triangle of the (d, d) Hessian in 128 x 128 tiles; a rest of d
    past the last full block that is at most VGH_TAIL wide is folded into
    the diagonal tiles (csrc blocks_of), a wider rest is a block of its
    own. The rows go in splits so that about VGH_WAVES waves of tile CTAs
    run, fewer
    where a split would hold fewer than VGH_MIN_SPLIT_ROWS rows or the
    per-split partials would outgrow PARTIAL_FLOATS. Every (n_valid, d)
    has one: a single split writes the output directly."""
    full, rest = divmod(d, VGH_TILE)
    nb = full if full >= 1 and 0 < rest <= VGH_TAIL else -(-d // VGH_TILE)
    n_tiles = nb * (nb + 1) // 2
    steps = -(-n_valid // VGH_STEP_ROWS)
    ctas = VGH_WAVES * slots
    n_split = max(1, min(-(-ctas // n_tiles),
                         -(-n_valid // VGH_MIN_SPLIT_ROWS),
                         PARTIAL_FLOATS // (n_tiles * VGH_TILE ** 2), 65535))
    per = -(-steps // n_split) * VGH_STEP_ROWS
    n_split = max(1, -(-n_valid // per)) if n_valid else 1
    return VghGeometry(nb, n_tiles, n_split, per)


def _vgh_slots(device) -> int:
    """Tile CTAs of csrc/glm_value_grad_hess.cu the card holds at once: its
    SMs times the CTAs an SM holds, which the library reads from its own
    launch bounds and shared memory."""
    if _VGH_PER_SM.get(device) is None:
        per_sm = _entry("glm_value_grad_hess", "glm_vgh_tile_ctas_per_sm")()
        if per_sm < 1:
            raise RuntimeError("glm_vgh_tile_ctas_per_sm: the tile kernel "
                               f"fits no SM ({per_sm})")
        _VGH_PER_SM[device] = per_sm
    return _sm_count(device) * _VGH_PER_SM[device]


_VGH_PER_SM: dict = {}


def _vgh_row_ctas(n_valid, sms):
    """CTAs of the row pass: one per VGH_ROW_WARPS * VGH_ROWS_PER_WARP rows,
    at most 8 per SM."""
    per = VGH_ROW_WARPS * VGH_ROWS_PER_WARP
    return max(1, min(-(-n_valid // per), 8 * sms))


def glm_value_grad_hess_plain(x, n_valid, y, beta, family):
    """(Σ NLL, Σ ∂NLL/∂β (d,), Σ w x xᵀ (d, d)) over rows < n_valid with
    w = hess_weight(η, y), in plain torch: the Pallas kernel's x * w,
    then the product with x, its upper triangle mirrored so that the
    result is exactly symmetric, as the kernel's is. Computes in x's
    dtype (float64 x gives a float64 reference). Reads X three times."""
    n_valid = int(n_valid)
    fam = get_family(family)
    xv = x[:n_valid]
    yv = y[:n_valid].to(x.dtype)
    eta = xv @ beta.to(x.dtype)
    w = fam.hess_weight(eta, yv)
    h = (xv * w[:, None]).T @ xv
    return (fam.pointwise(eta, yv).sum(), (fam.mean(eta) - yv) @ xv,
            torch.triu(h) + torch.triu(h, 1).T)


def fused_glm_value_grad_hess(x, n_valid, y, beta, family):
    """(Σ NLL, Σ ∂NLL/∂β (d,), Σ w x xᵀ (d, d)) of the rows < ``n_valid``,
    the Newton step's whole data touch. x (n, d) f32 (the Newton and ADMM
    fits keep an f32 design, as in the JAX package), y (n,), beta (d,).
    On a CPU tensor this is :func:`glm_value_grad_hess_plain`."""
    if x.device.type == "cpu":
        return glm_value_grad_hess_plain(x, n_valid, y, beta, family)
    _check_glm_family("fused_glm_value_grad_hess", family, x,
                      (torch.float32,))
    n, d = x.shape
    y = y.to(torch.float32)
    beta = beta.to(torch.float32).contiguous()
    _require_cuda("fused_glm_value_grad_hess", x, y, beta)
    n_valid = int(n_valid)
    if y.shape != (n,) or beta.shape != (d,) or not 0 <= n_valid <= n:
        raise ValueError(
            f"fused_glm_value_grad_hess: x {tuple(x.shape)}, y "
            f"{tuple(y.shape)}, beta {tuple(beta.shape)}, n_valid {n_valid}"
        )
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    geo = vgh_geometry(n_valid, d, _vgh_slots(dev))
    n_rows_ctas = _vgh_row_ctas(n_valid, _sm_count(dev))
    if x.data_ptr() % 16:
        # the tile kernel copies rows 16 bytes at a time from an aligned base
        x = x.clone()
    w = torch.empty(max(n_valid, 1), **f32)
    resid = torch.empty(max(n_valid, 1), **f32)
    loss_part = torch.empty(n_rows_ctas, **f32)
    many = geo.n_split > 1
    part_h = torch.empty((geo.n_split, geo.n_tiles, VGH_TILE, VGH_TILE)
                         if many else 1, **f32)
    part_g = torch.empty((geo.n_split, geo.nb * VGH_TILE + VGH_TAIL)
                         if many else 1,
                         **f32)
    out = torch.empty(1 + d + d * d, **f32)
    fn = _entry("glm_value_grad_hess", "glm_value_grad_hess")
    rc = fn(x.data_ptr(), y.data_ptr(), beta.data_ptr(), n_valid, d,
            GLM_FAMILIES[family], w.data_ptr(), resid.data_ptr(),
            loss_part.data_ptr(), n_rows_ctas, part_h.data_ptr(),
            part_g.data_ptr(), geo.n_split, geo.rows_per_split,
            out.data_ptr(), _stream(x))
    _check_rc(rc, "glm_value_grad_hess")
    fused_glm_value_grad_hess.launches += 1
    return out[0], out[1:1 + d], out[1 + d:].view(d, d)


fused_glm_value_grad_hess.launches = 0


# ---------------------------------------------------------------------------
# fused_glm_multi_value_grad — csrc/glm_multi_value_grad.cu
# replaces dask_ml_tpu/ops/pallas_fused.py:427 fused_glm_multi_value_grad
# ---------------------------------------------------------------------------

MULTI_MMA_ROWS = 64                # kMTR: rows per tile (kernel 4)
MULTI_MMA_ONE_CHUNK = 264          # rows up to this width: one chunk
MULTI_MMA_CHUNK = 256              # features per chunk of wider rows


class MultiMmaGeometry(NamedTuple):
    fch: int         # features per staged chunk (8 or 16 per k-step)
    n_fc: int        # chunks of a row
    stride: int      # elements per staged row


def multi_mma_geometry(d, itemsize=4) -> MultiMmaGeometry:
    """How the resident kernel of csrc/glm_multi_value_grad.cu
    (glm_multi_mma) cuts a row, a rule on the shapes: rows of up to
    MULTI_MMA_ONE_CHUNK features staged whole (f32 rounded up to 8
    features, bf16 to 16: one k-step), wider rows in chunks of
    MULTI_MMA_CHUNK. A staged row holds its features shifted by up to 16
    bytes (it is copied from its aligned start) and its stride keeps the
    fragment gathers free of bank conflicts: 8 mod 32 floats for f32, 8
    mod 16 halfs for bf16. The kernel lays out its shared memory from
    these (csrc mma_layout). Every d has one."""
    step = 8 if itemsize == 4 else 16
    if d <= MULTI_MMA_ONE_CHUNK:
        fch, n_fc = -(-d // step) * step, 1
    else:
        fch, n_fc = MULTI_MMA_CHUNK, -(-d // MULTI_MMA_CHUNK)
    stride = _mma_f32_stride(fch) if itemsize == 4 else fch + 8
    return MultiMmaGeometry(fch, n_fc, stride)


def _mma_f32_stride(fch):
    """Floats per staged f32 row of fch features: room for a row shifted
    by up to 16 bytes, 8 mod 32."""
    return fch + 8 + (8 - (fch + 8)) % 32


class MultiStreamGeometry(NamedTuple):
    fch: int         # features per staged chunk
    n_fc: int        # chunks of a row
    stride: int      # floats per staged f32 row
    round_stride: int  # bf16 products: halfs per rounded row, else 0
    ldg: int         # floats per weight row's gradient in the partials
    smem: int        # bytes of shared memory a CTA takes (csrc mma_layout)


MULTI_MMA_KPARTS = 8               # kKParts: eta's k-parts
MULTI_MMA_CLASSES = 16             # kMCls: classes per group
MULTI_MMA_WARPS = 16               # kMWarps: warps of a CTA


def multi_stream_geometry(d, bf16_ops=False, intercept=False,
                          loss_col=False) -> MultiStreamGeometry:
    """How the streamed one-vs-rest kernel and the SGD many-rows kernel
    (glm_multi_mma with their options, kernels 7 and 8) cut a row: kernel
    4's rule for f32 products; with bf16 products (the mxu policy) the
    chunk of bf16 X, staged as f32 (X is f32 in memory) and rounded into a
    bf16 tile of kernel 4's bf16 stride. A weight row's gradient in the
    partials holds d features, then the intercepts' column (``intercept``)
    and the SGD loss column (``loss_col``, which comes with the
    intercepts'). ``smem`` is csrc mma_layout's size of the CTA's shared
    memory: the staged ring of two f32 tiles, the rounded tile, the
    k-parts' eta partials, the residual tiles (one, or one per stage of a
    ring for rows of several chunks), the warps' losses and, for f32
    products, the split weight rows. Every d has one."""
    if not bf16_ops:
        g = multi_mma_geometry(d, 4)
        fch, n_fc, stride, rstride = g.fch, g.n_fc, g.stride, 0
    else:
        g = multi_mma_geometry(d, 2)
        fch, n_fc, stride, rstride = g.fch, g.n_fc, _mma_f32_stride(g.fch), \
            g.stride
    rows, cls = MULTI_MMA_ROWS, MULTI_MMA_CLASSES
    # a residual tile: bf16 (classes, 72), or f32 big and small (classes, 68)
    rt = cls * 72 * 2 if bf16_ops else 2 * cls * 68 * 4
    smem = (2 * rows * stride * 4 + rows * rstride * 2
            + MULTI_MMA_KPARTS * rows * cls * 4
            + (1 if n_fc == 1 else 2) * rt + MULTI_MMA_WARPS * 4
            + (0 if bf16_ops else cls * (fch + 4) * 8))
    ldg = d + (2 if loss_col else int(bool(intercept)))
    return MultiStreamGeometry(fch, n_fc, stride, rstride, ldg, smem)


def glm_multi_value_grad_plain(x, n_valid, codes, B, family):
    """(Σ over rows < n_valid and classes of NLL, Σ ∂/∂B (C, d)) in plain
    torch, the per-class 0/1 targets from the class codes. bf16 x: B
    rounded to bf16 for eta and the residual rounded to bf16 before the
    gradient product, every sum in f32 (the Pallas kernel's contract)."""
    n_valid = int(n_valid)
    fam = get_family(family)
    C = B.shape[0]
    xv = x[:n_valid]
    Y = (codes[:n_valid, None].to(torch.int64)
         == torch.arange(C, device=x.device)[None, :]).to(torch.float32)
    B = B.to(torch.float32)
    if x.dtype == torch.bfloat16:
        xf = xv.to(torch.float32)
        eta = xf @ B.to(torch.bfloat16).to(torch.float32).T
        resid = (fam.mean(eta) - Y).to(torch.bfloat16).to(torch.float32)
        return fam.pointwise(eta, Y).sum(), resid.T @ xf
    eta = xv @ B.T
    return fam.pointwise(eta, Y).sum(), (fam.mean(eta) - Y).T @ xv


def fused_glm_multi_value_grad(x, n_valid, codes, B, family):
    """(Σ over rows < ``n_valid`` and classes of NLL, Σ ∂/∂B (C, d)) of
    the C one-vs-rest problems in ONE read of X. x (n, d) f32 or bf16,
    codes (n,) integer class codes (0..C-1), B (C, d) f32. On a CPU
    tensor this is :func:`glm_multi_value_grad_plain`."""
    if x.device.type == "cpu":
        return glm_multi_value_grad_plain(x, n_valid, codes, B, family)
    _check_glm_family("fused_glm_multi_value_grad", family, x,
                      (torch.float32, torch.bfloat16))
    n, d = x.shape
    codes = codes.to(torch.int32).contiguous()
    B = B.to(torch.float32).contiguous()
    _require_cuda("fused_glm_multi_value_grad", x, codes, B)
    C = B.shape[0]
    n_valid = int(n_valid)
    if codes.shape != (n,) or B.ndim != 2 or B.shape[1] != d or C < 1 \
            or not 0 <= n_valid <= n:
        raise ValueError(
            f"fused_glm_multi_value_grad: x {tuple(x.shape)}, codes "
            f"{tuple(codes.shape)}, B {tuple(B.shape)}, n_valid {n_valid}"
        )
    if x.dtype == torch.bfloat16:
        # the kernel's eta takes B rounded to bf16 (the JAX contract)
        B = B.to(torch.bfloat16).to(torch.float32)
    if x.data_ptr() % 16:
        # the kernel copies rows 16 bytes at a time from an aligned base
        x = x.clone()
    geo = multi_mma_geometry(d, x.element_size())
    x_bf16 = int(x.dtype == torch.bfloat16)
    n_tiles = -(-n_valid // MULTI_MMA_ROWS)
    n_part = _n_part(n_tiles, 1, _sm_count(x.device), C * d + 1)
    partials = torch.empty((n_part, 1 + C * d), dtype=torch.float32,
                           device=x.device)
    # rows of several chunks park each tile's eta sums and residuals
    # between the eta and the gradient walks
    per_tile = _entry("glm_multi_value_grad",
                      "glm_multi_mma_tile_scratch")(x_bf16)
    rscr = torch.empty(max(16, n_tiles * per_tile if geo.n_fc > 1 else 0),
                       dtype=torch.uint8, device=x.device)
    out = torch.empty(1 + C * d, dtype=torch.float32, device=x.device)
    fn = _entry("glm_multi_value_grad", "glm_multi_value_grad")
    rc = fn(x.data_ptr(), x_bf16, codes.data_ptr(), B.data_ptr(), n_valid,
            d, C, GLM_FAMILIES[family], geo.fch, geo.stride, rscr.data_ptr(),
            partials.data_ptr(), n_part, out.data_ptr(), _stream(x))
    _check_rc(rc, "glm_multi_value_grad")
    fused_glm_multi_value_grad.launches += 1
    return out[0], out[1:].view(C, d)


fused_glm_multi_value_grad.launches = 0


# ---------------------------------------------------------------------------
# fused_lloyd_stats / fused_assign_update — csrc/lloyd.cu
# replace dask_ml_tpu/ops/pallas_fused.py:150 fused_lloyd_stats and
#         dask_ml_tpu/ops/pallas_fused.py:1074 fused_assign_update
# ---------------------------------------------------------------------------

LLOYD_CHUNK = 64                   # kMCenters: centers per chunk
LLOYD_SMEM_MAX = 232448            # shared memory a block may opt into


LLOYD_MMA_ROWS = 128               # kMRows: rows per tile (kernels 2, 10)
LLOYD_MMA_THREADS = 512            # kMThreads: 16 warps
LLOYD_MMA_SUM_FEATURES = 128       # kSumF: features of a slice of the sums


class LloydMmaGeometry(NamedTuple):
    fc: int          # features per step, a multiple of 8
    n_fc: int        # feature chunks of a row
    n_cc: int        # chunks of 64 centers
    stride: int      # floats per staged row
    smem: int        # bytes of shared memory a CTA takes


def lloyd_mma_geometry(d, k) -> LloydMmaGeometry:
    """How csrc/lloyd.cu's tensor-core pass (lloyd_mma_partials, behind
    fused_lloyd_stats, fused_assign_update and fused_kmeans_block_stats,
    in f32 and with the bf16 cross term alike) cuts (d, k), a rule on the
    shapes: whole rows of up to 128 features (rounded up to a k-step of
    8), wider rows in chunks of 128, the features of a slice of the
    per-cluster sums (whose walk copies each chunk of the tile again);
    centers in chunks of 64. Shared memory holds two (128, stride) tiles
    of X, with the stride 8 mod 32 floats and at least fc + 8 (rows are
    copied from their aligned start and their 16-byte groups swizzled),
    the (fc, 64) block of split centers as (big, small) pairs, the
    per-row labels, the second center half's per-row best, the
    per-thread inertia and the counting sort of the rows by label: at
    most 210,180 bytes. Every (d, k) has a geometry."""
    fc = min(-(-d // 8) * 8, LLOYD_MMA_SUM_FEATURES)
    stride = _mma_f32_stride(fc)
    smem = 4 * (2 * LLOYD_MMA_ROWS * stride + 2 * LLOYD_CHUNK * fc
                + 4 * LLOYD_MMA_ROWS + LLOYD_MMA_THREADS
                + (LLOYD_MMA_ROWS // 32 + 1) * LLOYD_CHUNK + 1)
    return LloydMmaGeometry(fc, -(-d // fc), -(-k // LLOYD_CHUNK), stride,
                            smem)


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


def _lloyd_launch(name, x, mask, n_rows, centers, per_row, mxu=None,
                  acc=None):
    """One pass of csrc/lloyd.cu's tensor-core step over x[:n_rows]:
    lloyd_pass, with the per-row labels and min-d2 when ``per_row``; or,
    with ``acc`` (sums, counts, inertia), kmeans_block_stats, which adds
    the statistics into acc, the cross term on bf16-rounded operands when
    ``mxu``. Returns (labels, mind, sums, counts, inertia ())."""
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
    geo = lloyd_mma_geometry(d, k)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    # the (f32) centers' norms, +inf past k
    c2 = torch.full((geo.n_cc * LLOYD_CHUNK,), torch.inf, **f32)
    c2[:k] = (centers * centers).sum(1)
    if x.data_ptr() % 16:
        # the kernel copies rows 16 bytes at a time from an aligned base
        x = x.clone()
    n_tiles = -(-n_rows // LLOYD_MMA_ROWS)
    n_part = _n_part(n_tiles, 1, _sm_count(dev), k * d)
    # the split centers of every step, when they are not resident
    steps = geo.n_cc * geo.n_fc
    csplit = torch.empty(steps * geo.fc * 128 if steps > 1 else 4, **f32)
    psums = torch.empty((n_part, k, d), **f32)
    pcounts = torch.empty((n_part, k), **i32)
    pinertia = torch.empty(n_part, **f32)
    labels = torch.empty(n_rows, **i32) if per_row else None
    mind = torch.empty(n_rows, **f32) if per_row else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    if acc is None:
        sums = torch.empty((k, d), **f32)
        counts = torch.empty(k, **i32)
        inertia = torch.empty(1, **f32)
        fn = _entry("lloyd", "lloyd_pass")
        rc = fn(x.data_ptr(), ptr(mask), centers.data_ptr(), c2.data_ptr(),
                n_rows, d, k, geo.fc, geo.n_fc, geo.n_cc, geo.stride,
                geo.smem, ptr(labels), ptr(mind), csplit.data_ptr(),
                psums.data_ptr(), pcounts.data_ptr(), pinertia.data_ptr(),
                n_part, sums.data_ptr(), counts.data_ptr(),
                inertia.data_ptr(), _stream(x))
        _check_rc(rc, "lloyd_pass")
    else:
        sums, counts, inertia = acc
        # the mxu cross term takes the centers rounded to bf16 values
        cen = centers if mxu is None else \
            centers.to(mxu).to(torch.float32).contiguous()
        fn = _entry("lloyd", "kmeans_block_stats")
        rc = fn(x.data_ptr(), int(mxu is not None), cen.data_ptr(),
                c2.data_ptr(), n_rows, d, k, geo.fc, geo.n_fc, geo.n_cc,
                geo.stride, geo.smem, csplit.data_ptr(), psums.data_ptr(),
                pcounts.data_ptr(),
                pinertia.data_ptr(), n_part, sums.data_ptr(),
                counts.data_ptr(), inertia.data_ptr(), _stream(x))
        _check_rc(rc, "kmeans_block_stats")
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


# ---------------------------------------------------------------------------
# fused_glm_stream — csrc/glm_value_grad.cu (kinds "val", "vg") and
#                    csrc/glm_value_grad_hess.cu (kind "vgh")
# replaces dask_ml_tpu/ops/pallas_fused.py:745 fused_glm_stream
# ---------------------------------------------------------------------------

STREAM_KINDS = ("val", "vg", "vgh")


def _check_stream_kind(name, kind, mxu, kinds=STREAM_KINDS):
    """The kinds of a streamed kernel, and bf16 operands for "vg" only:
    "val" and "vgh" stay f32, the streamed flavour's rule (a bf16 value
    beside an f32 Hessian's would reject Newton steps near the
    optimum)."""
    if kind not in kinds:
        raise ValueError(f"{name}: kind {kind!r} is not one of {kinds}")
    if mxu not in (None, torch.bfloat16):
        raise ValueError(f"{name}: mxu must be None or torch.bfloat16")
    if kind != "vg" and mxu is not None:
        raise ValueError(f"{name}: bf16 operands are for kind 'vg' only; "
                         f"{kind!r} stays f32")


def _glm_stream_size(kind, d, intercept):
    D = d + 1 if intercept else d
    return {"val": 1, "vg": d + 2, "vgh": d + 2 + D * D}[kind]


def glm_stream_acc(kind, d, intercept, device):
    """A zeroed flat f32 accumulator of ``fused_glm_stream``'s ``kind``
    sums for x of width d: [loss] ("val"); [loss, grad (d), Σ resid]
    ("vg"); the same then the (D, D) Hessian, D = d + 1 with an
    intercept (bordered by Xᵀw and Σ w) else d ("vgh")."""
    return torch.zeros(_glm_stream_size(kind, d, intercept),
                       dtype=torch.float32, device=device)


def glm_stream_views(kind, acc, d, intercept):
    """The sums in ``acc`` as ``fused_glm_stream`` returns them: views
    (loss,), (loss, grad (d[+1],)) or (loss, grad, hess (D, D))."""
    loss = acc[0]
    if kind == "val":
        return (loss,)
    grad = acc[1:d + 2] if intercept else acc[1:d + 1]
    if kind == "vg":
        return loss, grad
    D = d + 1 if intercept else d
    return loss, grad, acc[d + 2:].view(D, D)


def _add_into(views, outs):
    for v, o in zip(views, outs):
        v += o
    return views


def glm_stream_plain(kind, x, n_valid, y, beta, family, intercept,
                     mxu=None, acc=None):
    """One streamed block's ``kind`` sums over rows < n_valid in plain
    torch, the Pallas kernel's contract: eta = x · b + b0 with b0 =
    beta[-1] when ``intercept``; "val" Σ NLL; "vg" + Σ ∂/∂beta (the
    intercept's entry Σ resid); "vgh" + Σ w x xᵀ, bordered by Σ w x and
    Σ w with an intercept, exactly symmetric. ``mxu=torch.bfloat16``
    rounds x and b to bf16 for eta and the residual before the gradient
    product (Σ resid unrounded). Computes in x's dtype when it is
    float64 (a reference), else f32. With ``acc`` the sums are added
    into it and its views returned."""
    n_valid = int(n_valid)
    fam = get_family(family)
    dt = torch.float64 if x.dtype == torch.float64 else torch.float32
    xv = x[:n_valid].to(dt)
    yv = y[:n_valid].to(dt)
    beta = beta.to(dt)
    b = beta[:-1] if intercept else beta
    if mxu is not None:
        xv = xv.to(mxu).to(dt)
        b = b.to(mxu).to(dt)
    eta = xv @ b
    if intercept:
        eta = eta + beta[-1]
    outs = [fam.pointwise(eta, yv).sum()]
    if kind != "val":
        resid = fam.mean(eta) - yv
        rg = resid.to(mxu).to(dt) if mxu is not None else resid
        grad = rg @ xv
        if intercept:
            grad = torch.cat([grad, resid.sum()[None]])
        outs.append(grad)
    if kind == "vgh":
        w = fam.hess_weight(eta, yv)
        xw = xv * w[:, None]
        h = xw.T @ xv
        h = torch.triu(h) + torch.triu(h, 1).T
        if intercept:
            col = xw.sum(0)
            h = torch.cat([torch.cat([h, col[:, None]], 1),
                           torch.cat([col, w.sum()[None]])[None, :]], 0)
        outs.append(h)
    if acc is not None:
        return _add_into(glm_stream_views(kind, acc, x.shape[1], intercept),
                         outs)
    return tuple(outs)


def _check_acc(name, acc, size, device):
    if acc.shape != (size,) or acc.dtype != torch.float32 \
            or acc.device != device or not acc.is_contiguous():
        raise ValueError(f"{name}: acc must be a contiguous ({size},) f32 "
                         f"tensor on {device}, got {tuple(acc.shape)} "
                         f"{acc.dtype} on {acc.device}")


def fused_glm_stream(kind, x, n_valid, y, beta, family, intercept,
                     mxu=None, acc=None):
    """One streamed block's ``kind`` sums (see :func:`glm_stream_plain`)
    in ONE launch: x (S, d) f32 (the block, rows < n_valid valid), y
    (S,) f32, beta (d + 1,) with ``intercept`` else (d,). No column of
    ones is built. The sums are added into ``acc`` (a fresh
    :func:`glm_stream_acc` when None), whose views are returned. On a CPU
    tensor this is :func:`glm_stream_plain`."""
    name = "fused_glm_stream"
    _check_stream_kind(name, kind, mxu)
    if x.device.type == "cpu":
        return glm_stream_plain(kind, x, n_valid, y, beta, family,
                                intercept, mxu, acc)
    _check_glm_family(name, family, x, (torch.float32,))
    n, d = x.shape
    y = y.to(torch.float32)
    beta = beta.to(torch.float32).contiguous()
    _require_cuda(name, x, y, beta)
    n_valid = int(n_valid)
    if y.shape != (n,) or beta.shape != (d + int(bool(intercept)),) \
            or not 0 <= n_valid <= n:
        raise ValueError(f"{name}: x {tuple(x.shape)}, y {tuple(y.shape)}, "
                         f"beta {tuple(beta.shape)}, intercept {intercept}, "
                         f"n_valid {n_valid}")
    dev = x.device
    if acc is None:
        acc = glm_stream_acc(kind, d, intercept, dev)
    _check_acc(name, acc, _glm_stream_size(kind, d, intercept), dev)
    if kind == "vgh":
        _launch_glm_stream_vgh(x, n_valid, y, beta, family, intercept, acc)
    else:
        walk = glm_value_walk(d, torch.float32, kind if mxu is None
                              else "vg_bf16")
        x = _walk_x(walk, x)
        width = d + 2 if kind == "vg" else 1
        n_part = glm_walk_n_part(walk, n_valid, width, _sm_count(dev))
        partials = torch.empty((n_part, width), dtype=torch.float32,
                               device=dev)
        fn = _entry("glm_value_grad", "glm_stream")
        rc = fn(x.data_ptr(), int(mxu is not None), y.data_ptr(),
                beta.data_ptr(), int(bool(intercept)), n_valid, d,
                GLM_FAMILIES[family], int(kind == "vg"),
                *_walk_args(walk), partials.data_ptr(), n_part,
                acc.data_ptr(), _stream(x))
        _check_rc(rc, "glm_stream")
    fused_glm_stream.launches += 1
    fused_glm_stream.kind_launches[kind] += 1
    return glm_stream_views(kind, acc, d, intercept)


fused_glm_stream.launches = 0
fused_glm_stream.kind_launches = dict.fromkeys(STREAM_KINDS, 0)


def _launch_glm_stream_vgh(x, n_valid, y, beta, family, intercept, acc):
    d = x.shape[1]
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    geo = vgh_geometry(n_valid, d, _vgh_slots(dev))
    n_rows_ctas = _vgh_row_ctas(n_valid, _sm_count(dev))
    if x.data_ptr() % 16:
        # the tile kernel copies rows 16 bytes at a time from an aligned base
        x = x.clone()
    many = geo.n_split > 1
    w = torch.empty(max(n_valid, 1), **f32)
    resid = torch.empty(max(n_valid, 1), **f32)
    loss_part = torch.empty(n_rows_ctas, **f32)
    sums_part = torch.empty(2 * n_rows_ctas, **f32)
    part_h = torch.empty((geo.n_split, geo.n_tiles, VGH_TILE, VGH_TILE)
                         if many else 1, **f32)
    part_g = torch.empty((geo.n_split, geo.nb * VGH_TILE + VGH_TAIL)
                         if many else 1,
                         **f32)
    part_c = torch.empty((geo.n_split, geo.nb * VGH_TILE + VGH_TAIL)
                         if many and intercept else 1, **f32)
    fn = _entry("glm_value_grad_hess", "glm_stream_vgh")
    rc = fn(x.data_ptr(), y.data_ptr(), beta.data_ptr(), int(bool(intercept)),
            n_valid, d, GLM_FAMILIES[family], w.data_ptr(), resid.data_ptr(),
            loss_part.data_ptr(), sums_part.data_ptr(), n_rows_ctas,
            part_h.data_ptr(), part_g.data_ptr(), part_c.data_ptr(),
            geo.n_split, geo.rows_per_split, acc.data_ptr(), _stream(x))
    _check_rc(rc, "glm_stream_vgh")


# ---------------------------------------------------------------------------
# fused_glm_multi_stream — csrc/glm_multi_value_grad.cu
# replaces dask_ml_tpu/ops/pallas_fused.py:861 fused_glm_multi_stream
# ---------------------------------------------------------------------------

MULTI_STREAM_KINDS = ("val", "vg")


def _glm_multi_stream_size(kind, d, n_classes, intercept):
    return 1 if kind == "val" else 1 + n_classes * (d + int(bool(intercept)))


def glm_multi_stream_acc(kind, d, n_classes, intercept, device):
    """A zeroed flat f32 accumulator: [loss] ("val"), or [loss, grad (C,
    d + 1)] with the intercepts' gradient as the last column, (C, d)
    without ("vg")."""
    return torch.zeros(_glm_multi_stream_size(kind, d, n_classes, intercept),
                       dtype=torch.float32, device=device)


def glm_multi_stream_views(kind, acc, d, n_classes, intercept):
    if kind == "val":
        return (acc[0],)
    return acc[0], acc[1:].view(n_classes, d + int(bool(intercept)))


def glm_multi_stream_plain(kind, x, n_valid, y_codes, B, family, intercept,
                           mxu=None, acc=None):
    """One streamed block's C one-vs-rest ``kind`` sums over rows <
    n_valid in plain torch, the Pallas kernel's contract: targets
    (code == c) from the f32 class codes compared exactly; eta = x · B_c
    + b0_c with b0 = B[:, -1] when ``intercept``; "val" Σ NLL over rows
    and classes; "vg" + Σ ∂/∂B (C, d[+1]), the intercepts' column Σ
    resid. ``mxu=torch.bfloat16`` rounds x and B to bf16 for eta and the
    residual before the gradient product (Σ resid unrounded)."""
    n_valid = int(n_valid)
    fam = get_family(family)
    B = B.to(torch.float32)
    C = B.shape[0]
    Bm = B[:, :-1] if intercept else B
    xv = x[:n_valid].to(torch.float32)
    Y = (y_codes[:n_valid, None].to(torch.float32)
         == torch.arange(C, dtype=torch.float32, device=x.device)[None, :]
         ).to(torch.float32)
    if mxu is not None:
        xv = xv.to(mxu).float()
        Bm = Bm.to(mxu).float()
    eta = xv @ Bm.T
    if intercept:
        eta = eta + B[:, -1][None, :]
    outs = [fam.pointwise(eta, Y).sum()]
    if kind == "vg":
        resid = fam.mean(eta) - Y
        rg = resid.to(mxu).float() if mxu is not None else resid
        grad = rg.T @ xv
        if intercept:
            grad = torch.cat([grad, resid.sum(0)[:, None]], 1)
        outs.append(grad)
    if acc is not None:
        return _add_into(glm_multi_stream_views(kind, acc, x.shape[1], C,
                                                intercept), outs)
    return tuple(outs)


def fused_glm_multi_stream(kind, x, n_valid, y_codes, B, family, intercept,
                           mxu=None, acc=None):
    """One streamed block's C one-vs-rest ``kind`` sums (see
    :func:`glm_multi_stream_plain`) in ONE launch: x (S, d) f32, y_codes
    (S,) f32 class codes, B (C, d + 1) with ``intercept`` else (C, d).
    The sums are added into ``acc`` (a fresh
    :func:`glm_multi_stream_acc` when None), whose views are returned.
    On a CPU tensor this is :func:`glm_multi_stream_plain`."""
    name = "fused_glm_multi_stream"
    _check_stream_kind(name, kind, mxu, MULTI_STREAM_KINDS)
    if x.device.type == "cpu":
        return glm_multi_stream_plain(kind, x, n_valid, y_codes, B, family,
                                      intercept, mxu, acc)
    _check_glm_family(name, family, x, (torch.float32,))
    n, d = x.shape
    y_codes = y_codes.to(torch.float32)
    B = B.to(torch.float32)
    _require_cuda(name, x, y_codes)
    C = B.shape[0]
    n_valid = int(n_valid)
    ldg = d + int(bool(intercept))
    if y_codes.shape != (n,) or B.ndim != 2 or B.shape[1] != ldg or C < 1 \
            or B.device != x.device or not 0 <= n_valid <= n:
        raise ValueError(f"{name}: x {tuple(x.shape)}, y_codes "
                         f"{tuple(y_codes.shape)}, B {tuple(B.shape)}, "
                         f"intercept {intercept}, n_valid {n_valid}")
    dev = x.device
    Bk = B[:, :d]
    if mxu is not None:
        # the kernel's eta takes B rounded to bf16 (the JAX contract)
        Bk = Bk.to(mxu).to(torch.float32)
    Bk = Bk.contiguous()
    b0 = B[:, d].contiguous() if intercept else None
    if acc is None:
        acc = glm_multi_stream_acc(kind, d, C, intercept, dev)
    _check_acc(name, acc, _glm_multi_stream_size(kind, d, C, intercept), dev)
    if x.data_ptr() % 16:
        # the kernel copies rows 16 bytes at a time from an aligned base
        x = x.clone()
    grad = kind == "vg"
    rounded = int(mxu is not None)
    geo = multi_stream_geometry(d, bool(rounded), intercept)
    width = 1 + C * geo.ldg if grad else 1
    n_tiles = -(-n_valid // MULTI_MMA_ROWS)
    n_part = _n_part(n_tiles, 1, _sm_count(dev), width)
    partials = torch.empty((n_part, width), dtype=torch.float32, device=dev)
    # rows of several chunks park each tile's eta sums and residuals
    # between the eta and the gradient walks
    per_tile = _entry("glm_multi_value_grad",
                      "glm_multi_mma_tile_scratch")(rounded)
    rscr = torch.empty(max(16, n_tiles * per_tile if geo.n_fc > 1 else 0),
                       dtype=torch.uint8, device=dev)
    fn = _entry("glm_multi_value_grad", "glm_multi_stream")
    rc = fn(x.data_ptr(), rounded, y_codes.data_ptr(), Bk.data_ptr(),
            None if b0 is None else b0.data_ptr(), n_valid, d, C,
            GLM_FAMILIES[family], int(grad), geo.fch, geo.stride,
            geo.round_stride, rscr.data_ptr(), partials.data_ptr(), n_part,
            acc.data_ptr(), _stream(x))
    _check_rc(rc, "glm_multi_stream")
    fused_glm_multi_stream.launches += 1
    fused_glm_multi_stream.kind_launches[kind] += 1
    return glm_multi_stream_views(kind, acc, d, C, intercept)


fused_glm_multi_stream.launches = 0
fused_glm_multi_stream.kind_launches = dict.fromkeys(MULTI_STREAM_KINDS, 0)


# ---------------------------------------------------------------------------
# fused_kmeans_block_stats — csrc/lloyd.cu
# replaces dask_ml_tpu/ops/pallas_fused.py:1035 fused_kmeans_block_stats
# ---------------------------------------------------------------------------

def kmeans_stream_acc(k, d, device):
    """Zeroed accumulators of a streamed Lloyd pass: (sums (k, d) f32,
    counts (k,) int32, inertia (1,) f32)."""
    return (torch.zeros((k, d), dtype=torch.float32, device=device),
            torch.zeros(k, dtype=torch.int32, device=device),
            torch.zeros(1, dtype=torch.float32, device=device))


def kmeans_block_stats_plain(x, n_valid, centers, mxu=None, acc=None):
    """(sums (k, d), counts (k,) int32, inertia ()) of one streamed
    block's rows < n_valid in plain torch: labels by the first minimum
    of ``max(‖x‖² − 2 x·c + ‖c‖², 0)``, the cross term on bf16-rounded
    operands when ``mxu=torch.bfloat16`` (norms and sums f32). With
    ``acc`` the statistics are added into it and (sums, counts,
    inertia) views of it returned."""
    out = lloyd_stats_plain(x, n_valid, centers, mxu_dtype=mxu)
    if acc is None:
        return out
    acc[0].add_(out[0])
    acc[1].add_(out[1])
    acc[2].add_(out[2])
    return acc[0], acc[1], acc[2][0]


def fused_kmeans_block_stats(x, n_valid, centers, mxu=None, acc=None):
    """One streamed block's Lloyd statistics (see
    :func:`kmeans_block_stats_plain`) in ONE launch, added into ``acc``
    (fresh :func:`kmeans_stream_acc` when None): x (S, d) f32, rows <
    n_valid valid; centers (k, d). On a CPU tensor this is
    :func:`kmeans_block_stats_plain`."""
    if x.device.type == "cpu":
        return kmeans_block_stats_plain(x, n_valid, centers, mxu, acc)
    name = "fused_kmeans_block_stats"
    if mxu not in (None, torch.bfloat16):
        raise ValueError(f"{name}: mxu must be None or torch.bfloat16")
    if x.dtype != torch.float32 or x.ndim != 2:
        raise ValueError(f"{name}: x must be a 2-D float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    centers = centers.to(torch.float32).contiguous()
    k, d = centers.shape
    n_valid = int(n_valid)
    if x.shape[1] != d or not 0 <= n_valid <= x.shape[0]:
        raise ValueError(f"{name}: x {tuple(x.shape)}, centers "
                         f"{tuple(centers.shape)}, n_valid {n_valid}")
    _require_cuda(name, x, centers)
    dev = x.device
    if acc is None:
        acc = kmeans_stream_acc(k, d, dev)
    sums, counts, inertia = acc
    if sums.shape != (k, d) or counts.shape != (k,) or \
            counts.dtype != torch.int32 or inertia.shape != (1,):
        raise ValueError(f"{name}: acc must be kmeans_stream_acc({k}, {d})")
    _require_cuda(name, x, sums, counts, inertia)
    _lloyd_launch(name, x, None, n_valid, centers, False, mxu, acc)
    fused_kmeans_block_stats.launches += 1
    return sums, counts, inertia[0]


fused_kmeans_block_stats.launches = 0


# ---------------------------------------------------------------------------
# fused_sgd_block_grad — csrc/glm_value_grad.cu
# replaces dask_ml_tpu/ops/pallas_fused.py:651 fused_sgd_block_grad
# fused_sgd_many_block_grad — csrc/glm_multi_value_grad.cu
# replaces dask_ml_tpu/ops/pallas_fused.py:954 fused_sgd_many_block_grad
# ---------------------------------------------------------------------------

# the SGD losses as csrc/glm_family.cuh families: log_loss is the logistic
# family, squared_error the normal family, hinge a family of its own
SGD_LOSSES = {"squared_error": 0, "log_loss": 1, "hinge": 3}


def sgd_objective_terms(eta, y, loss):
    """(pointwise loss, d loss / d eta) of the SGD losses in plain torch,
    the terms of dask_ml_tpu/ops/pallas_fused.py::sgd_objective_terms and
    of the kernels: log_loss softplus(eta) - y eta (stable for any eta)
    and sigmoid(eta) - y; hinge max(0, 1 - m) and -sign where the margin
    m = sign eta (sign = 2 y - 1) is strictly below 1, so 0 at m == 1;
    squared_error (eta - y)^2 / 2 and eta - y."""
    if loss == "log_loss":
        fam = get_family("logistic")
        return fam.pointwise(eta, y), fam.mean(eta) - y
    if loss == "hinge":
        sign = 2.0 * y - 1.0
        margins = sign * eta
        return ((1.0 - margins).clamp_min(0.0),
                -sign * (margins < 1.0).to(eta.dtype))
    if loss == "squared_error":
        diff = eta - y
        return 0.5 * diff * diff, diff
    raise ValueError(f"unknown SGD loss {loss!r}; one of {sorted(SGD_LOSSES)}")


def _check_sgd(name, loss, mxu):
    if loss not in SGD_LOSSES:
        raise ValueError(f"{name}: no kernel for loss {loss!r} (the losses "
                         f"{sorted(SGD_LOSSES)})")
    if mxu not in (None, torch.bfloat16):
        raise ValueError(f"{name}: mxu must be None or torch.bfloat16")


def _sgd_operands(x, n_valid, y, W, mxu):
    """The plain versions' operands: rows < n_valid in f32 (float64 for a
    float64 reference), W's coefficient columns, both rounded to bf16
    values under ``mxu``."""
    dt = torch.float64 if x.dtype == torch.float64 else torch.float32
    xv = x[:n_valid].to(dt)
    W = W.to(dt)
    Wm = W[..., :-1]
    if mxu is not None:
        xv = xv.to(mxu).to(dt)
        Wm = Wm.to(mxu).to(dt)
    return xv, y[:n_valid].to(dt), W, Wm


def sgd_block_grad_plain(x, n_valid, y, w_ext, iflag, loss, mxu=None):
    """(Σ per-row loss, Σ ∂/∂w_ext (d + 1,)) of one block's rows <
    n_valid in plain torch, the Pallas kernel's contract: eta = x · w +
    w_ext[d] * iflag; the intercept's entry Σ resid. ``mxu=torch.bfloat16``
    rounds x and w to bf16 for eta and the residual before the gradient
    product (Σ resid unrounded)."""
    n_valid = int(n_valid)
    xv, yv, w, wm = _sgd_operands(x, n_valid, y, w_ext, mxu)
    eta = xv @ wm + w[-1] * iflag
    per, resid = sgd_objective_terms(eta, yv, loss)
    rg = resid.to(mxu).to(resid.dtype) if mxu is not None else resid
    return per.sum(), torch.cat([rg @ xv, resid.sum()[None]])


def fused_sgd_block_grad(x, n_valid, y, w_ext, iflag, loss, mxu=None):
    """(Σ per-row loss, Σ ∂/∂w_ext (d + 1,)) of one block (see
    :func:`sgd_block_grad_plain`) in ONE read of X and one launch: x (S,
    d) f32, rows < ``n_valid`` valid (the rest never read), y (S,) f32
    targets, w_ext (d + 1,) f32 with the intercept last, ``iflag`` a host
    float (0 or 1) scaling it. Raw sums: the caller divides by the count
    and adds the penalties. On a CPU tensor this is
    :func:`sgd_block_grad_plain`."""
    name = "fused_sgd_block_grad"
    _check_sgd(name, loss, mxu)
    if x.device.type == "cpu":
        return sgd_block_grad_plain(x, n_valid, y, w_ext, iflag, loss, mxu)
    if x.dtype != torch.float32 or x.ndim != 2:
        raise ValueError(f"{name}: x must be a 2-D float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    n, d = x.shape
    y = y.to(torch.float32)
    w_ext = w_ext.to(torch.float32).contiguous()
    _require_cuda(name, x, y, w_ext)
    n_valid = int(n_valid)
    if y.shape != (n,) or w_ext.shape != (d + 1,) or not 0 <= n_valid <= n:
        raise ValueError(f"{name}: x {tuple(x.shape)}, y {tuple(y.shape)}, "
                         f"w_ext {tuple(w_ext.shape)}, n_valid {n_valid}")
    return _sgd_block_grad_cuda(x, n_valid, y, w_ext, iflag, loss, mxu,
                                glm_value_walk(d, torch.float32,
                                               "vg" if mxu is None
                                               else "vg_bf16"))


def _sgd_block_grad_cuda(x, n_valid, y, w_ext, iflag, loss, mxu, walk):
    """:func:`fused_sgd_block_grad`'s launch on ``walk`` (a
    :func:`glm_walk`) for checked CUDA inputs; scripts/glm_walk_times.py
    measures the rule's cuts through it."""
    d, dev = x.shape[1], x.device
    x = _walk_x(walk, x)
    n_part = glm_walk_n_part(walk, n_valid, d + 2, _sm_count(dev))
    partials = torch.empty((n_part, d + 2), dtype=torch.float32, device=dev)
    out = torch.empty(d + 2, dtype=torch.float32, device=dev)
    fn = _entry("glm_value_grad", "sgd_block_grad")
    rc = fn(x.data_ptr(), int(mxu is not None), y.data_ptr(), w_ext.data_ptr(),
            float(iflag), n_valid, d, SGD_LOSSES[loss], *_walk_args(walk),
            partials.data_ptr(), n_part, out.data_ptr(), _stream(x))
    _check_rc(rc, "sgd_block_grad")
    fused_sgd_block_grad.launches += 1
    return out[0], out[1:]


fused_sgd_block_grad.launches = 0


def sgd_many_block_grad_plain(x, n_valid, y, W_ext, iflags, loss, codes,
                              mxu=None):
    """(Σ loss per row (N,), Σ ∂/∂W_ext (N, d + 1)) of one block's rows
    < n_valid for N stacked weight rows in plain torch, the Pallas
    kernel's contract: eta = x · W[:, :d]ᵀ + W[:, d] * iflags (a scalar or
    (N,)); ``codes=True``: y holds f32 class codes and row c's targets are
    (y == c), compared exactly; ``codes=False``: y is the target of every
    row. ``mxu`` rounds as :func:`sgd_block_grad_plain` does."""
    n_valid = int(n_valid)
    xv, yv, W, Wm = _sgd_operands(x, n_valid, y, W_ext, mxu)
    N = W.shape[0]
    eta = xv @ Wm.T + (W[:, -1] * iflags)[None, :]
    if codes:
        Y = (yv[:, None] == torch.arange(N, dtype=yv.dtype,
                                         device=yv.device)[None, :]
             ).to(yv.dtype)
    else:
        Y = yv[:, None].expand(-1, N)
    per, resid = sgd_objective_terms(eta, Y, loss)
    rg = resid.to(mxu).to(resid.dtype) if mxu is not None else resid
    return per.sum(0), torch.cat([rg.T @ xv, resid.sum(0)[:, None]], 1)


def fused_sgd_many_block_grad(x, n_valid, y, W_ext, iflags, loss, codes,
                              mxu=None):
    """(Σ loss per row (N,), Σ ∂/∂W_ext (N, d + 1)) of one block for N
    stacked weight rows (see :func:`sgd_many_block_grad_plain`) in ONE
    read of X and one launch: the C one-vs-rest rows of a multiclass
    model (``codes=True``) or a cohort of N models sharing y
    (``codes=False``). x (S, d) f32, rows < ``n_valid`` valid; y (S,) f32;
    W_ext (N, d + 1) f32; iflags a host float or an (N,) f32 tensor on
    x's device. The outputs are views of one buffer. On a CPU tensor this
    is :func:`sgd_many_block_grad_plain`."""
    name = "fused_sgd_many_block_grad"
    _check_sgd(name, loss, mxu)
    if x.device.type == "cpu":
        return sgd_many_block_grad_plain(x, n_valid, y, W_ext, iflags, loss,
                                         codes, mxu)
    if x.dtype != torch.float32 or x.ndim != 2:
        raise ValueError(f"{name}: x must be a 2-D float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    n, d = x.shape
    y = y.to(torch.float32)
    _require_cuda(name, x, y)
    n_valid = int(n_valid)
    if y.shape != (n,) or W_ext.ndim != 2 or W_ext.shape[1] != d + 1 \
            or W_ext.shape[0] < 1 or W_ext.device != x.device \
            or not 0 <= n_valid <= n:
        raise ValueError(f"{name}: x {tuple(x.shape)}, y {tuple(y.shape)}, "
                         f"W_ext {tuple(W_ext.shape)}, n_valid {n_valid}")
    N = W_ext.shape[0]
    dev = x.device
    W_ext = W_ext.to(torch.float32)
    Wm = W_ext[:, :d]
    if mxu is not None:
        # the kernel's eta takes W rounded to bf16 (the JAX contract)
        Wm = Wm.to(mxu).to(torch.float32)
    Wm = Wm.contiguous()
    b0 = (W_ext[:, d] * iflags).contiguous()
    if b0.shape != (N,) or b0.device != dev:
        raise ValueError(f"{name}: iflags must be a float or an ({N},) "
                         f"tensor on {dev}")
    if x.untyped_storage().data_ptr() % 16:
        # rows are copied from their 16-byte aligned starts, which for the
        # first row of a view lie in the view's storage
        x = x.clone()
    rounded = int(mxu is not None)
    geo = multi_stream_geometry(d, bool(rounded), loss_col=True)
    width = 1 + N * geo.ldg
    n_tiles = -(-n_valid // MULTI_MMA_ROWS)
    n_part = _n_part(n_tiles, 1, _sm_count(dev), width)
    partials = torch.empty((n_part, width), dtype=torch.float32, device=dev)
    # rows of several chunks park each tile's eta sums and residuals
    # between the eta and the gradient walks
    per_tile = _entry("glm_multi_value_grad",
                      "glm_multi_mma_tile_scratch")(rounded)
    rscr = torch.empty(max(16, n_tiles * per_tile if geo.n_fc > 1 else 0),
                       dtype=torch.uint8, device=dev)
    out = torch.empty(width, dtype=torch.float32, device=dev)
    fn = _entry("glm_multi_value_grad", "sgd_many_block_grad")
    rc = fn(x.data_ptr(), rounded, y.data_ptr(), int(bool(codes)),
            Wm.data_ptr(), b0.data_ptr(), n_valid, d, N, SGD_LOSSES[loss],
            geo.fch, geo.stride, geo.round_stride, geo.smem, rscr.data_ptr(),
            partials.data_ptr(), n_part, out.data_ptr(), _stream(x))
    _check_rc(rc, "sgd_many_block_grad")
    fused_sgd_many_block_grad.launches += 1
    G = out[1:].view(N, d + 2)
    return G[:, d + 1], G[:, :d + 1]


fused_sgd_many_block_grad.launches = 0


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
    "fused_glm_value_grad_hess": (
        fused_glm_value_grad_hess,
        "dask_ml_tpu_torch/csrc/glm_value_grad_hess.cu",
        "dask_ml_tpu/ops/pallas_fused.py:331"),
    "fused_glm_multi_value_grad": (
        fused_glm_multi_value_grad,
        "dask_ml_tpu_torch/csrc/glm_multi_value_grad.cu",
        "dask_ml_tpu/ops/pallas_fused.py:427"),
    # "val"/"vg" in glm_value_grad.cu, "vgh" in glm_value_grad_hess.cu
    "fused_glm_stream": (
        fused_glm_stream, "dask_ml_tpu_torch/csrc/glm_value_grad.cu",
        "dask_ml_tpu/ops/pallas_fused.py:745"),
    "fused_glm_multi_stream": (
        fused_glm_multi_stream,
        "dask_ml_tpu_torch/csrc/glm_multi_value_grad.cu",
        "dask_ml_tpu/ops/pallas_fused.py:861"),
    "fused_kmeans_block_stats": (
        fused_kmeans_block_stats, "dask_ml_tpu_torch/csrc/lloyd.cu",
        "dask_ml_tpu/ops/pallas_fused.py:1035"),
    "fused_sgd_block_grad": (
        fused_sgd_block_grad, "dask_ml_tpu_torch/csrc/glm_value_grad.cu",
        "dask_ml_tpu/ops/pallas_fused.py:651"),
    "fused_sgd_many_block_grad": (
        fused_sgd_many_block_grad,
        "dask_ml_tpu_torch/csrc/glm_multi_value_grad.cu",
        "dask_ml_tpu/ops/pallas_fused.py:954"),
}


def reset_launches():
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0
        kinds = getattr(wrapper, "kind_launches", None)
        if kinds is not None:
            for kind in kinds:
                kinds[kind] = 0


def launches() -> dict:
    return {name: w.launches for name, (w, _, _) in KERNELS.items()}
