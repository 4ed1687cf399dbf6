"""Runtime configuration of the PyTorch port.

Counterpart of ``dask_ml_tpu/config.py``, cut to the knobs this package
reads: the fit compute ``dtype``, the ``device`` every entry point
places its data on, the two knobs of the streamed (out-of-core)
fits, ``stream_block_rows`` and ``stream_prefetch``, with the JAX
defaults, ``use_kernel``, the SGD estimators' switch between their
step kernels and the kernels' plain versions (the JAX package's
``pallas_stream``, which gates its fused SGD steps the same way), and
``search_stream``, the adaptive searches' switch between the streamed
cohort plane and the device-resident one, and the three knobs of sparse
sources with the JAX defaults: ``stream_sparse`` (a sparse X streams
its nonzeros, ``parallel/sparse_stream.py``), ``stream_sparse_max_density``
(above it, blocks are densified on the host instead) and
``to_dense_byte_budget`` (the most a one-shot densify of a sparse corpus
may allocate). The reliability knobs keep the JAX defaults:
``fault_plan`` (``reliability/faults.py``), ``stream_io_retries`` and
``stream_nonfinite`` (``parallel/streaming.py``), ``stream_checkpoint_path``
and ``stream_checkpoint_every`` (``reliability/stream_ckpt.py``),
``checkpoint_dir`` (the adaptive searches' round checkpoints) and
``stream_autotune``; so do ``obs_counters`` (``observability/_counters.py``)
and ``obs_drift``, which here gates the streamed fits' training profile
only, and the observability knobs ``metrics_path``, ``trace_dir``,
``obs_programs`` (here the kernel registry's CUDA-event times),
``obs_http_port`` and ``watchdog_timeout_s``. The serving knobs
(``serving_*``), the plan knobs (``plan_cache``, ``plan_rewarm``) and
``obs_max_series`` keep the JAX names and defaults; the JAX package's ``compile_cache_dir`` has no
counterpart: a CUDA graph cannot outlive its process. The process
plane's knobs keep the JAX names and defaults: ``stream_mesh``,
``mesh_shape`` (one device per process: ``"DxM"`` lays the process
world out as D row groups of M column tiles, ``parallel/mesh.py``),
``stream_device_byte_budget``, ``stream_grad_accum`` and
``stream_sync_timeout_s``.
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
    # a sparse X (scipy sparse, SparseBlocks) streams its blocks' nonzeros
    # to the device (the nnz route of parallel/streaming.py); False, or a
    # corpus denser than stream_sparse_max_density, densifies each block
    # on the host instead, the reason on record in solver_info_
    stream_sparse: bool = True
    stream_sparse_max_density: float = 0.25
    # bytes a one-shot densify of a sparse corpus may take
    # (feature_extraction.to_sharded_dense, the C-grid search's fold);
    # over it, DenseBudgetExceeded. 0 = no limit
    to_dense_byte_budget: int = 1 << 30
    # epoch-boundary block growth of BlockStream.epochs: a pass whose host
    # staging outlasts the consumer doubles the block, at most twice and
    # to no fewer than 16 blocks. Off: a seeded fit's minibatches must
    # not depend on machine load
    stream_autotune: bool = False
    # -- reliability (reliability/) ---------------------------------------
    # deterministic fault-injection plan ("" = off: every site costs one
    # config read and a branch), e.g. "staging_read:io@2"; the grammar,
    # sites and kinds are reliability/faults.py's
    fault_plan: str = ""
    # bounded exponential-backoff retries of a failing host block read
    # (a real OSError or an injected "io" fault) before the typed
    # StreamIORetriesExhausted; 0 = fail on the first error
    stream_io_retries: int = 3
    # non-finite streamed-block policy: "off" (no check), "raise" (typed
    # NonFiniteBlock), "quarantine" (the block's valid-row count folds to
    # 0, so no consumer reads it; stream_quarantined_blocks counts).
    # Inference streams treat quarantine as raise
    stream_nonfinite: str = "off"
    # pass-granular checkpoints of the streamed GLM, SGD, KMeans and
    # Incremental fits ("" = off): the host state after each pass, under
    # a token over the fit's knobs and a fingerprint of its data; a
    # killed fit rerun alike resumes at the last saved pass, completion
    # clears it
    stream_checkpoint_path: str = ""
    # passes between saves when stream_checkpoint_path is set
    stream_checkpoint_every: int = 1
    # round checkpoints of the adaptive searches ("" = off)
    checkpoint_dir: str = ""
    # -- observability (observability/) -----------------------------------
    # the counter registry; False makes every recorder one config read
    obs_counters: bool = True
    # streamed fits fold a per-feature training profile of a strided
    # sample of their first pass on the host (training_profile_). The
    # servers fold no served rows whatever it says (drift scoring of
    # served traffic waits for ROADMAP.md queue 1, Observability, part 2)
    obs_drift: bool = True
    # labeled series one family of the in-process metric registry may
    # hold (observability/live.py); past it new series are dropped and
    # counted. 0 = no cap
    obs_max_series: int = 512
    # JSONL metrics path ("" = off): every fit appends its step records
    # and spans there (observability/_metrics.py::fit_logger)
    metrics_path: str = ""
    # span-trace directory: spans append to <trace_dir>/trace.jsonl even
    # outside a metrics_path fit ("" = spans fall back to metrics_path,
    # or are no-ops when both are unset)
    trace_dir: str = ""
    # the kernel registry's device times (observability/_programs.py): a
    # pair of CUDA events around every kernel launch, resolved when a
    # snapshot is taken. Off: a launch pays one config read (its launch
    # count is kept whatever this says)
    obs_programs: bool = False
    # live telemetry exporter (observability/live.py): port of the
    # background HTTP server on 127.0.0.1 serving /metrics, /healthz and
    # /status while a run goes on. 0 = off: no thread, no span observer
    obs_http_port: int = 0
    # slow-span watchdog (observability/_watchdog.py): a span open past
    # this many seconds dumps every thread's stack, the device memory
    # gauges and the open-span stack to the trace sink. 0 = off
    watchdog_timeout_s: float = 0.0
    # -- execution plans (plans/) -----------------------------------------
    # process-wide plan build cache: two ProgramPlan builds of an
    # identical spec return the same program (plan_cache_hits counts)
    plan_cache: bool = True
    # warm requests re-execute even for keys already warm
    plan_rewarm: bool = False
    # -- serving (serving/) -----------------------------------------------
    # the bucket ladder of padded batch heights: geometric from min to
    # max (the last rung clamped to max) with this growth; one CUDA graph
    # per (entry point, rung)
    serving_min_batch: int = 8
    serving_max_batch: int = 1024
    serving_bucket_growth: float = 2.0
    # requests a server queues before submit() sheds (ServerOverloaded)
    serving_max_queue: int = 1024
    # coalescing wait after the first dequeue (ms); 0 = dispatch at once
    serving_batch_window_ms: float = 2.0
    # per-request queue deadline from admission (ms; 0 = none)
    serving_timeout_ms: float = 1000.0
    # end-to-end latency SLO (ms): counts serving_slo_violations, arms
    # the deadline-aware batch release and the fleet's SLO admission.
    # 0 = no SLO
    serving_slo_ms: float = 0.0
    # FleetServer replicas; 0 = one per card when several exist, else 1
    serving_replicas: int = 0
    # a fleet sheds (SloShed) when every replica's predicted completion
    # misses serving_slo_ms
    serving_slo_shed: bool = True
    # a background supervisor rebuilds a dead fleet replica off the
    # serving path (reliability/supervisor.py), at most
    # serving_restart_budget times a slot, sweeping every interval
    serving_supervise: bool = False
    serving_restart_budget: int = 3
    serving_supervise_interval_s: float = 0.5
    # versions a ModelRegistry keeps per name (the current one always)
    serving_registry_keep: int = 8
    # flavors built and warmed beside float32 ("int8"), so a publish
    # flagged quantize="int8" and the rollback swap with no new graph
    serving_warm_flavors: str = ""
    # expected nonzeros per row of the sparse entry points' nnz ladder
    serving_sparse_nnz_per_row: int = 64
    # SLO-driven replica autoscaling (serving/autoscale.py)
    serving_autoscale: bool = False
    serving_autoscale_min: int = 1
    serving_autoscale_max: int = 4
    serving_autoscale_interval_s: float = 0.25
    # scale bands (ms) on the best replica's predicted completion; 0 =
    # 80 % / 20 % of serving_slo_ms
    serving_autoscale_up_ms: float = 0.0
    serving_autoscale_down_ms: float = 0.0
    serving_autoscale_patience: int = 2
    serving_autoscale_cooldown_s: float = 2.0
    # -- processes (parallel/distributed.py, parallel/mesh.py) ------------
    # devices a streamed fit spreads over in THIS process: 0 = auto and
    # 1 = the rank's one device (the port has one device per process);
    # N > 1 raises (ROADMAP.md queue 1, Multi-GPU (several devices in
    # one process))
    stream_mesh: int = 0
    # the mesh of the process plane: "auto", "D" and "Dx1" give the 1-D
    # "data" axis over the processes; "DxM" with M > 1 lays D * M
    # processes out as D row groups of M feature tiles (rank r at data
    # index r // M, model index r % M; parallel/mesh.py)
    mesh_shape: str = "auto"
    # per-process staging byte budget of a streamed fit: > 0 makes
    # BlockStream refuse (typed StreamBudgetExceeded) a stream whose ring
    # of device buffers (slots x block_rows x (d/M when X tiles, else d)
    # x 4 bytes, every array) exceeds it, pointing at mesh_shape; 0 = off
    stream_device_byte_budget: int = 0
    # A >= 1: the gradient-accumulation flavour of the host-streamed SGD
    # fit, A blocks a group, their raw sums merged across processes by
    # psum_host, one update a group (the flavour a multi-process SGD fit
    # needs); 0 = the sequential fit
    stream_grad_accum: int = 0
    # deadline (s) of the pass barrier of a multi-process streamed fit
    # (distributed.sync_stream_pass): a lost peer raises the typed
    # StreamSyncTimeout instead of wedging the fit. 0 = no deadline
    stream_sync_timeout_s: float = 600.0


_DEFAULT = Config()
_state = threading.local()


_NONFINITE = ("off", "raise", "quarantine")


def check_nonfinite(policy: str) -> str:
    """``policy`` when it is a ``stream_nonfinite`` value; else raises
    with the accepted values."""
    if policy not in _NONFINITE:
        raise ValueError(
            f"stream_nonfinite={policy!r} is not supported; accepted: "
            "'off', 'raise', 'quarantine'")
    return policy


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
