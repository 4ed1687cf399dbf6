"""Runtime configuration of the PyTorch port.

Counterpart of ``dask_ml_tpu/config.py``, cut to the knobs this package
reads: the fit compute ``dtype``, the ``device`` every entry point
places its data on, the two knobs of the streamed (out-of-core)
fits, ``stream_block_rows`` and ``stream_prefetch``, with the JAX
defaults, ``use_kernel``, the SGD estimators' switch between their
step kernels and the kernels' plain versions (the JAX package's
``pallas_stream``, which gates its fused SGD steps the same way), and
``search_stream``, the adaptive searches' switch between the streamed
cohort plane and the device-resident one.
``device`` takes the place of the JAX package's ``parallel.use_mesh``: it is ``"cuda"`` unless the caller asks for the
CPU (``with config.set(device="cpu"): ...``). Asking for ``"cuda"`` on a
machine without a card raises; nothing carries on on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch


@dataclasses.dataclass
class Config:
    # fit compute dtype ("auto" | "float32" | "bfloat16"; "f32"/"fp32"/
    # "bf16" are aliases). "auto" resolves to float32: the bfloat16
    # default of the JAX package holds on a TPU only.
    dtype: str = "auto"
    # device of every array an estimator places ("cuda", "cuda:1", "cpu")
    device: str = "cuda"
    # rows per streamed block; 0 = auto (256 MB of X per block). A numpy
    # array taller than a positive value streams (parallel/streaming.py)
    stream_block_rows: int = 0
    # blocks staged ahead of the one being consumed (1 = double buffer)
    stream_prefetch: int = 1
    # SGD steps through fused_sgd_block_grad / fused_sgd_many_block_grad;
    # False takes their plain versions (solver_info_ records the reason)
    use_kernel: bool = True
    # adaptive searches over host X run each round's cohort through one
    # BlockStream pass (model_selection/_incremental.py); False runs the
    # rounds on the device-resident cohort path over the same blocks
    search_stream: bool = True


_DEFAULT = Config()
_state = threading.local()


def get_config() -> Config:
    stack = getattr(_state, "stack", None)
    if stack:
        return stack[-1]
    return _DEFAULT


@contextlib.contextmanager
def set(**overrides):
    """``with config.set(device="cpu"): ...`` — the dask.config.set
    analog, thread-local like the JAX package's."""
    new = dataclasses.replace(get_config(), **overrides)
    stack = getattr(_state, "stack", None)
    if stack is None:
        stack = _state.stack = []
    stack.append(new)
    try:
        yield new
    finally:
        stack.pop()


@contextlib.contextmanager
def use(cfg: Config):
    """Run under the Config ``cfg`` as it is: a worker thread enters the
    caller's ``get_config()`` so, since the configuration is
    thread-local, the thread places its data where the caller would."""
    stack = getattr(_state, "stack", None)
    if stack is None:
        stack = _state.stack = []
    stack.append(cfg)
    try:
        yield cfg
    finally:
        stack.pop()


def in_caller_config(fn):
    """``fn`` wrapped to run under the calling thread's configuration,
    for tasks handed to a thread pool."""
    cfg = get_config()

    def run(*args, **kwargs):
        with use(cfg):
            return fn(*args, **kwargs)

    return run


def resolve_device(device=None) -> torch.device:
    """The device to place data on: ``device`` if given, else
    ``config.device``. A CUDA device without a card raises."""
    dev = torch.device(device if device is not None
                       else get_config().device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for but torch sees no CUDA "
            "device; run on a machine with a card, or ask for the CPU "
            "explicitly: config.set(device='cpu')"
        )
    return dev


_DTYPE_ALIASES = {
    "auto": "auto",
    "float32": "float32", "f32": "float32", "fp32": "float32",
    "bfloat16": "bfloat16", "bf16": "bfloat16",
}


def normalize_dtype(dt: str) -> str:
    """Canonical dtype name; unknown spellings raise."""
    canon = _DTYPE_ALIASES.get(str(dt).strip().lower())
    if canon is None:
        raise ValueError(
            f"dtype={dt!r} is not supported; accepted spellings: "
            "'auto', 'float32' (aliases 'f32', 'fp32'), "
            "'bfloat16' (alias 'bf16')"
        )
    return canon


def resolve_dtype(override=None) -> tuple[str, str]:
    """(resolved canonical dtype, why): the estimator's ``override`` wins
    over ``config.dtype``; "auto" is float32 on every device the port
    runs on (the JAX package's rule for anything but a TPU)."""
    src = "estimator" if override is not None else "config"
    dt = normalize_dtype(override if override is not None
                         else get_config().dtype)
    if dt != "auto":
        return dt, src
    return "float32", f"auto:{resolve_device().type}-fallback"


def mxu_dtype(override=None):
    """``torch.bfloat16`` when the fit asks for bf16 operands, else None
    (plain f32) — the one mapping from ``config.dtype`` to the kernels'
    operand dtype."""
    dt, _ = resolve_dtype(override)
    return torch.bfloat16 if dt == "bfloat16" else None


def fit_dtype_info(override=None) -> dict:
    """The resolved fit dtype as fit-info fields."""
    dt, src = resolve_dtype(override)
    return {"fit_dtype": dt, "fit_dtype_source": src}
