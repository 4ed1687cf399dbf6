"""The process plane: one process per device over ``torch.distributed``.

Counterpart of ``dask_ml_tpu/parallel/distributed.py``. The JAX package
brings up ``jax.distributed`` and merges host state through device
all-gathers; the port runs one process per card (the idiom of PyTorch
data parallelism) and merges host state over a **gloo** group, so host
arrays never go through a card:

- ``initialize`` is a no-op for one process; otherwise it calls
  ``torch.distributed.init_process_group`` from its arguments or from the
  ``torchrun`` environment (``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``/``MASTER_PORT``, ``LOCAL_RANK``). When the default
  group is not gloo (a user's NCCL job), the host plane takes a gloo
  subgroup (``new_group(backend="gloo")``);
- the host collectives keep the JAX contracts: ``allgather_object``
  (pickles, rank order), ``allgather_host`` (raw bytes, exact for any
  dtype; a ``ValueError`` on every rank when shapes or dtypes differ),
  ``psum_host`` (every argument packed into ONE float64 vector, one
  all-gather, then the sum in rank order, so every rank holds the
  bit-identical sum; never ``all_reduce``, whose summation order is not
  the gather order), ``broadcast_host`` and ``barrier``;
- the pass barrier of the streamed fits, ``sync_stream_pass``: it fires
  the ``pass_barrier`` fault site and, under
  ``config.stream_sync_timeout_s``, raises the typed
  :class:`StreamSyncTimeout` instead of waiting forever on a lost peer;
- ``rank_device`` takes the place of ``local_mesh``: ``config.device``
  if it names a card or the CPU, else ``cuda:{LOCAL_RANK % cards}``.
  Ranks that outnumber the cards share them;
- ``array_from_process_local``: a process-local row block becomes a
  ``ShardedArray`` that knows the global row count, which the resident
  GLM and KMeans fits merge across processes.

VIRTUAL PROCESSES, as in the JAX package: :func:`run_virtual_processes`
runs N ranks as threads of ONE process. Topology queries answer per
thread, the host collectives rendezvous in-process with the same order
and bit-exactness, and a rank that dies fails its peers' pending
collectives at once (the worker-death detection). Each rank, virtual or
real, launches on its own CUDA stream; virtual ranks share the card.

A thread inside :func:`local_section` sees a one-process world: the
searches run their trials, candidates and brackets there, so a fit a
trial runs never enters a collective its peers (busy with other trials)
would not join.

THE 2-D MESH (``config.mesh_shape="DxM"``, ``parallel/mesh.py``): rank r
sits at data index ``r // M`` and model index ``r % M``. The collectives
take ``group=``: ``"data"`` runs over the D ranks that share this rank's
model index (the row groups' merge), ``"model"`` over the M ranks that
share its data index (the feature tiles' merge); None is the world. A
group collective keeps the world's rules: raw bytes gathered in group
order and summed in that order, so every member holds bit-equal
results. Over gloo each group is a ``torch.distributed.new_group``, made
once, at the plane's bring-up, for every factorization of the world, in
the same order on every rank; in a virtual world each group is a
sub-exchange of the world's.
"""

from __future__ import annotations

import contextlib
import functools
import os
import pickle
import threading
import time as _time
import zlib

import numpy as np
import torch

_HOST_GROUP = None       # the gloo group of the host plane (None = WORLD)
_HOST_GROUP_SET = False
# the gloo groups of the 2-D mesh, by their members (ranks in group
# order); a group of one rank or of the whole world has no entry
_MESH_GROUPS = {}

GROUPS = ("data", "model")

# this process's time in the process plane, for its measurement: the
# psum_host calls that crossed processes, their seconds and the bytes
# this rank sent; per mesh group the collectives over it (calls, bytes
# sent, seconds); the pass barriers and their seconds (the wait for the
# slowest peer included)
plane_stats = {"psum_calls": 0, "psum_s": 0.0, "psum_bytes": 0,
               "data_calls": 0, "data_bytes": 0, "data_s": 0.0,
               "model_calls": 0, "model_bytes": 0, "model_s": 0.0,
               "barriers": 0, "barrier_s": 0.0}


def reset_plane_stats():
    for k in plane_stats:
        plane_stats[k] = 0 if isinstance(plane_stats[k], int) else 0.0

# -- virtual process plane ---------------------------------------------------

_vlocal = threading.local()     # .ctx = (rank, world, _VirtualExchange)
_local = threading.local()      # .depth > 0: inside local_section()


def _virtual():
    if in_local_section():
        return None
    return getattr(_vlocal, "ctx", None)


class _VirtualExchange:
    """In-process rendezvous all-gather shared by one virtual world's
    rank threads. Rounds are generation-counted so back-to-back
    collectives never mix; a failed rank poisons the exchange so peers
    raise instead of waiting out the timeout."""

    def __init__(self, world, timeout=120.0):
        self.world = int(world)
        self.timeout = float(timeout)
        self._cond = threading.Condition(threading.Lock())
        self._slots = {}
        self._result = None
        self._gen = 0
        self._failed = None     # (rank, repr(exc))
        self._subs = {}         # the mesh groups' exchanges, by key

    def fail(self, rank, exc):
        with self._cond:
            if self._failed is None:
                self._failed = (rank, repr(exc))
            subs = list(self._subs.values())
            self._cond.notify_all()
        for sub in subs:
            sub.fail(rank, exc)

    def sub(self, key, world):
        """The exchange of a group of this world's ranks (made by its
        first member to ask; failed with the world)."""
        with self._cond:
            ex = self._subs.get(key)
            if ex is None:
                ex = self._subs[key] = _VirtualExchange(world, self.timeout)
                ex._failed = self._failed
            return ex

    def _raise_failed(self):
        raise RuntimeError(f"virtual peer {self._failed[0]} failed: "
                           f"{self._failed[1]}")

    def allgather(self, rank, obj):
        with self._cond:
            if self._failed is not None:
                self._raise_failed()
            gen = self._gen
            self._slots[rank] = obj
            if len(self._slots) == self.world:
                self._result = [self._slots[r] for r in range(self.world)]
                self._slots = {}
                self._gen += 1
                self._cond.notify_all()
                return list(self._result)
            deadline = _time.monotonic() + self.timeout
            while self._gen == gen:
                if self._failed is not None:
                    self._raise_failed()
                left = deadline - _time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"virtual allgather timed out after {self.timeout}s "
                        f"(rank {rank} waiting)")
                self._cond.wait(min(left, 0.1))
            return list(self._result)


@contextlib.contextmanager
def virtual_process(rank, world, exchange):
    """Make THIS thread virtual rank ``rank`` of ``world``: every topology
    query and host collective of this module answers for it while the
    context is open."""
    prev = getattr(_vlocal, "ctx", None)
    _vlocal.ctx = (int(rank), int(world), exchange)
    try:
        yield
    finally:
        if prev is None:
            del _vlocal.ctx
        else:
            _vlocal.ctx = prev


@contextlib.contextmanager
def local_section():
    """A one-process world on this thread: ``process_count()`` is 1 and
    every collective is the identity while it is open. A search's
    trials, owned candidates and brackets run here."""
    _local.depth = getattr(_local, "depth", 0) + 1
    try:
        yield
    finally:
        _local.depth -= 1


def in_local_section() -> bool:
    """True on a thread inside :func:`local_section`."""
    return bool(getattr(_local, "depth", 0))


@contextlib.contextmanager
def _rank_placement(rank):
    """The rank's device as this thread's current card, and a CUDA
    stream of its own for its launches; nothing on the CPU."""
    dev = rank_device(rank)
    if dev.type != "cuda" or not torch.cuda.is_available():
        yield
        return
    torch.cuda.set_device(dev)
    with torch.cuda.stream(torch.cuda.Stream(dev)):
        yield
        torch.cuda.current_stream(dev).synchronize()


def run_virtual_processes(fn, world=2, timeout=120.0):
    """Run ``fn(rank)`` on ``world`` rank threads of this process with the
    virtual collective plane wired up; returns ``[fn(0), ...,
    fn(world-1)]``. Each rank runs under the caller's configuration
    (``config`` is thread-local) on its own CUDA stream. A rank that
    raises fails the others' pending collectives at once; the first
    raised exception (a peer's collateral ``RuntimeError`` last) reaches
    the caller, and a rank still running at the shared deadline raises
    naming it."""
    from ..config import get_config, use

    cfg = get_config()
    exchange = _VirtualExchange(world, timeout=timeout)
    results = [None] * world
    errors = [None] * world

    def body(rank):
        try:
            with use(cfg), virtual_process(rank, world, exchange), \
                    _rank_placement(rank):
                results[rank] = fn(rank)
        except BaseException as exc:  # noqa: BLE001 - reraised below
            errors[rank] = exc
            exchange.fail(rank, exc)

    threads = [threading.Thread(target=body, args=(r,),
                                name=f"virtual-rank-{r}", daemon=True)
               for r in range(world)]
    for t in threads:
        t.start()
    # one shared deadline, and a liveness check: a rank hung OUTSIDE a
    # collective never trips exchange.fail
    deadline = _time.monotonic() + timeout
    for t in threads:
        t.join(max(0.0, deadline - _time.monotonic()))
    for exc in errors:
        if exc is not None and not isinstance(exc, RuntimeError):
            raise exc
    for exc in errors:
        if exc is not None:
            raise exc
    hung = [t.name for t in threads if t.is_alive()]
    if hung:
        raise RuntimeError(f"virtual rank(s) still running after {timeout}s: "
                           + ", ".join(hung))
    return results


# -- bring-up and topology ---------------------------------------------------

def _td():
    """``torch.distributed`` when a process group is up, else None."""
    import torch.distributed as td

    return td if td.is_available() and td.is_initialized() else None


def initialize(init_method=None, world_size=None, rank=None, backend=None,
               timeout_s=None):
    """Bring up the process group of a multi-process run.

    A no-op for one process (no arguments and no ``WORLD_SIZE`` in the
    environment, or a world of 1), so one script runs alone or under
    ``torchrun --nproc-per-node=N``. ``init_method`` is a
    ``torch.distributed`` URL (``file:///path`` for a file store,
    ``tcp://host:port``); without it the ``torchrun`` environment
    (``env://``: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) is read. ``backend`` defaults to gloo; any other
    default group gets a gloo subgroup for the host plane. Under a
    ``"cuda"`` config the rank's card (``rank_device``) becomes the
    process's current device."""
    import datetime

    import torch.distributed as td

    if td.is_available() and td.is_initialized():
        _set_host_group(td)
        _adopt_rank_device()
        return
    env = os.environ
    if init_method is None and world_size is None \
            and "WORLD_SIZE" not in env:
        return      # single-process mode
    ws = int(world_size if world_size is not None
             else env.get("WORLD_SIZE", 1))
    if ws <= 1 and init_method is None:
        return
    rk = int(rank if rank is not None else env.get("RANK", 0))
    kwargs = {"backend": backend or "gloo",
              "init_method": init_method or "env://",
              "world_size": ws, "rank": rk}
    if timeout_s:
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout_s))
    td.init_process_group(**kwargs)
    _set_host_group(td)
    _adopt_rank_device()


def _set_host_group(td):
    global _HOST_GROUP, _HOST_GROUP_SET
    if _HOST_GROUP_SET:
        return
    _HOST_GROUP = None if td.get_backend() == "gloo" \
        else td.new_group(backend="gloo")
    # every group of every "DxM" layout of the world, in one order on
    # every rank (new_group is itself a collective of the world)
    world = td.get_world_size()
    for m in range(2, world):
        if world % m:
            continue
        for members in _layout_groups(world // m, m):
            _MESH_GROUPS[members] = td.new_group(list(members),
                                                 backend="gloo")
    _HOST_GROUP_SET = True


def _layout_groups(D, M):
    """The model groups, then the data groups, of a D x M layout."""
    model = [tuple(range(i * M, (i + 1) * M)) for i in range(D)]
    data = [tuple(j + k * M for k in range(D)) for j in range(M)]
    return model + data


def group_members(group):
    """(the ranks of ``group`` in group order, this rank's index in
    it): ``"data"`` the ranks sharing this rank's model index, in data
    order; ``"model"`` those sharing its data index, in model (column)
    order; None the world."""
    n, r = process_count(), process_index()
    if group is None:
        return tuple(range(n)), r
    if group not in GROUPS:
        raise ValueError(f"group must be one of {GROUPS} or None, got "
                         f"{group!r}")
    from .mesh import process_mesh

    D, M = process_mesh()
    if group == "data":
        return tuple(r % M + k * M for k in range(D)), r // M
    return tuple((r // M) * M + j for j in range(M)), r % M


def _plane(group):
    """Where a collective over ``group`` runs: (size, this rank's index,
    the virtual exchange or None, the gloo group or None). Size 1 is the
    identity."""
    if process_count() == 1:
        return 1, 0, None, None
    members, idx = group_members(group)
    n = len(members)
    if n == 1:
        return 1, 0, None, None
    v = _virtual()
    if v is not None:
        rank, world, exchange = v
        if n == world:
            return n, idx, exchange, None
        return n, idx, exchange.sub((group, members), n), None
    td = _td()
    host = _host_group(td)
    if n == td.get_world_size():
        return n, idx, None, host
    return n, idx, None, _MESH_GROUPS[members]


def _count_group(group, nbytes, seconds):
    if group is None:
        return
    plane_stats[f"{group}_calls"] += 1
    plane_stats[f"{group}_bytes"] += int(nbytes)
    plane_stats[f"{group}_s"] += seconds


def _host_group(td):
    """The gloo group of the host plane, made at the first collective
    when the caller brought the process group up without
    :func:`initialize`."""
    _set_host_group(td)
    return _HOST_GROUP


def _adopt_rank_device():
    dev = rank_device()
    if dev.type == "cuda" and torch.cuda.is_available():
        torch.cuda.set_device(dev)


def process_index() -> int:
    if in_local_section():
        return 0
    v = _virtual()
    if v is not None:
        return v[0]
    td = _td()
    return td.get_rank() if td is not None else 0


def process_count() -> int:
    if in_local_section():
        return 1
    v = _virtual()
    if v is not None:
        return v[1]
    td = _td()
    return td.get_world_size() if td is not None else 1


def in_virtual_world() -> bool:
    """True on a thread running as a virtual rank of a world of more than
    one rank, inside ``local_section`` too: the ranks still share one
    real process (and its checkpoint paths)."""
    v = getattr(_vlocal, "ctx", None)
    return v is not None and v[1] > 1


def is_coordinator() -> bool:
    """Rank 0: the process that runs a search's controller output."""
    return process_index() == 0


def local_rank() -> int:
    """This rank's index among the ranks of its host: ``LOCAL_RANK`` under
    torchrun, the virtual rank in a virtual world, else the rank."""
    v = getattr(_vlocal, "ctx", None)
    if v is not None:
        return v[0]
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return process_index()


def rank_device(rank=None) -> torch.device:
    """The device a rank places its data on (the port's ``local_mesh``):
    ``config.device`` when it names the CPU or a card by index, else
    ``cuda:{local rank % cards}``; ranks that outnumber the cards share
    them."""
    from ..config import get_config

    dev = torch.device(get_config().device)
    if dev.type != "cuda" or dev.index is not None \
            or not torch.cuda.is_available():
        return dev
    r = local_rank() if rank is None else int(rank)
    return torch.device("cuda", r % max(torch.cuda.device_count(), 1))


# -- host collectives --------------------------------------------------------

def allgather_object(obj, group=None):
    """One small picklable object per rank; every rank of ``group`` (the
    world, ``"data"`` or ``"model"``) receives the members' objects in
    group order (``[obj_from_rank_0, ..., obj_from_rank_{P-1}]`` for the
    world)."""
    n, idx, exchange, g = _plane(group)
    if n == 1:
        return [obj]
    t0 = _time.perf_counter()
    wire = pickle.dumps(obj)
    if exchange is not None:
        # a pickle round trip per rank: the isolation (and picklability
        # rule) of the wire path
        out = [pickle.loads(p) for p in exchange.allgather(idx, wire)]
    else:
        td = _td()
        out = [None] * n
        td.all_gather_object(out, obj, group=g)
    _count_group(group, len(wire), _time.perf_counter() - t0)
    return out


_HEADER = 16    # int64 slots: nbytes, ndim, 10 dims, 4 dtype chars


def _header(value):
    h = np.full(_HEADER, -1, np.int64)
    h[0], h[1] = value.nbytes, value.ndim
    dims = list(value.shape)
    if len(dims) > 10:
        dims = [zlib.crc32(repr(tuple(dims)).encode())]
    h[2:2 + len(dims)] = dims
    code = value.dtype.str.encode()[:4]
    h[12:12 + len(code)] = list(code)
    return h


def _describe(h):
    ndim = int(h[1])
    shape = tuple(int(x) for x in h[2:2 + min(ndim, 10)])
    dt = bytes(int(c) for c in h[12:16] if c >= 0).decode()
    return shape, dt


def allgather_host(value: np.ndarray, group=None) -> np.ndarray:
    """Gather a small host array from every rank of ``group`` (the
    world, ``"data"`` or ``"model"``); returns the ``(n_members,
    *shape)`` stack, in group order, on all of them. The payload travels
    as raw bytes, so float64 score merges stay bit-exact; shapes and
    dtypes must match across the members (a ``ValueError`` on every one
    otherwise)."""
    value = np.ascontiguousarray(value)
    n, idx, exchange, g = _plane(group)
    if n == 1:
        return value[None]
    t0 = _time.perf_counter()
    if exchange is not None:
        parts = exchange.allgather(idx, value.copy())
        if any(p.shape != value.shape or p.dtype != value.dtype
               for p in parts):
            raise ValueError(
                "allgather_host requires identical shape/dtype on "
                f"every rank; got {[(p.shape, str(p.dtype)) for p in parts]}")
        out = np.stack(parts)
    else:
        out = _gloo_allgather(value, n, g)
    _count_group(group, value.nbytes, _time.perf_counter() - t0)
    return out


def _gloo_allgather(value, n, group):
    td = _td()
    head = torch.from_numpy(_header(value))
    heads = [torch.empty_like(head) for _ in range(n)]
    td.all_gather(heads, head, group=group)
    if any(not torch.equal(h, head) for h in heads):
        raise ValueError(
            "allgather_host requires identical shape/dtype on every rank; "
            f"got {[_describe(h.numpy()) for h in heads]}")
    if value.nbytes == 0:
        return np.stack([value] * n)
    buf = torch.from_numpy(np.frombuffer(value.tobytes(), np.uint8).copy())
    parts = [torch.empty_like(buf) for _ in range(n)]
    td.all_gather(parts, buf, group=group)
    return np.stack([
        np.frombuffer(p.numpy().tobytes(), value.dtype).reshape(value.shape)
        for p in parts])


def psum_host(*arrays, group=None):
    """Sum each small host array across the ranks of ``group`` (the
    world, ``"data"`` or ``"model"``); every member gets the identical
    (bit-exact: the same gather order everywhere) sum. The merge plane
    of the streamed and process-local fits: their per-pass accumulators
    are additive. ONE packed float64 all-gather whatever the argument
    count. The identity for a group of one. Returns one array, or a
    tuple matching the inputs."""
    if _plane(group)[0] == 1:
        outs = tuple(np.asarray(a) for a in arrays)
        return outs[0] if len(outs) == 1 else outs
    t0 = _time.perf_counter()
    arrs = [np.asarray(a, np.float64) for a in arrays]
    flat = (np.concatenate([a.ravel() for a in arrs])
            if arrs else np.zeros(0))
    total = allgather_host(flat, group).sum(axis=0)
    plane_stats["psum_calls"] += 1
    plane_stats["psum_s"] += _time.perf_counter() - t0
    plane_stats["psum_bytes"] += flat.nbytes
    outs, off = [], 0
    for a in arrs:
        outs.append(total[off:off + a.size].reshape(a.shape))
        off += a.size
    return outs[0] if len(outs) == 1 else tuple(outs)


def host_reduce(group=None):
    """``psum_host`` over ``group`` when more than one rank takes part
    in it, else None: the ``reduce`` argument of the streamed solvers.
    A fit whose ranks hold copies of their row group's rows (the 2-D
    mesh's model-replicated paths) merges over ``"data"``: over the
    world it would count every row group M times."""
    if _plane(group)[0] == 1:
        return None
    if group is None:
        return psum_host
    return functools.partial(psum_host, group=group)


def broadcast_host(value, root: int = 0):
    """A small host array (or any picklable value) from rank ``root`` to
    every rank."""
    if process_count() == 1:
        return np.asarray(value)
    v = _virtual()
    if v is not None:
        rank, _, exchange = v
        parts = exchange.allgather(rank, np.asarray(value).copy())
        return parts[root]
    td = _td()
    box = [np.asarray(value) if td.get_rank() == root else None]
    td.broadcast_object_list(box, src=root, group=_host_group(td))
    return box[0]


def barrier(name="barrier"):
    """Cross-rank sync point; returns the world's device count (one card
    per process), as the JAX barrier returns its psum of ones."""
    n = process_count()
    if n == 1:
        return 1.0
    v = _virtual()
    if v is not None:
        rank, _, exchange = v
        exchange.allgather(rank, name)
        return float(n)
    td = _td()
    td.barrier(group=_host_group(td))
    return float(n)


def array_from_process_local(local, dtype=np.float32, device=None):
    """A ``ShardedArray`` of THIS rank's rows (a host array or a tensor)
    on the rank's device, flagged process-local and carrying the global
    row count (global order = rank order; ``row_offset`` is where this
    rank's rows start). The port holds one device per process, so no
    row moves between ranks: the resident GLM and KMeans fits merge
    their per-pass sums across ranks instead (``psum_host``). Feature
    shapes and dtypes must agree on every rank (a ``ValueError`` on all
    of them, after the gather, so no rank is left in a collective).
    Under a ``"DxM"`` mesh with M > 1 the ranks of a row group hold the
    same rows (their counts must agree) and the global row count is the
    row groups'."""
    from .sharded import ShardedArray, _place, torch_dtype

    if isinstance(local, torch.Tensor):
        feat, dt = tuple(local.shape[1:]), str(torch_dtype(dtype))
        n_local = int(local.shape[0])
    else:
        local = np.ascontiguousarray(np.asarray(local, dtype))
        feat, dt = tuple(local.shape[1:]), str(local.dtype)
        n_local = int(local.shape[0])
    shapes = allgather_object((feat, dt, n_local))
    if any(s[:2] != shapes[0][:2] for s in shapes):
        raise ValueError(
            "array_from_process_local requires identical feature shape "
            f"and dtype on every process; got {shapes}")
    counts = np.asarray([s[2] for s in shapes], np.int64)
    me = process_index()
    from .mesh import process_mesh

    _, M = process_mesh()
    if M > 1:
        # a "DxM" mesh: the M ranks of a row group hold the same rows,
        # and the global rows are the row groups'
        groups = counts.reshape(-1, M)
        if (groups != groups[:, :1]).any():
            raise ValueError(
                "array_from_process_local under a 'DxM' mesh: the ranks of "
                f"a row group must hold the same rows; got {counts.tolist()}")
        counts, me = groups[:, 0], me // M
    data = _place(local, dtype, device if device is not None
                  else rank_device())
    return ShardedArray(data, n_local, process_local=True,
                        global_rows=int(counts.sum()),
                        row_offset=int(counts[:me].sum()))


def multihost_capability():
    """(ok, reason): does this runtime hold a pass barrier across
    processes? One process and virtual worlds answer False (a virtual
    world has no second process to wait for); a process group of more
    than one process answers True. Nothing is probed: a group that
    fails raises in the barrier itself."""
    if process_count() == 1:
        return (False, "single-process")
    if _virtual() is not None:
        return (False, "virtual world (one real process)")
    return (True, "")


class StreamSyncTimeout(RuntimeError):
    """The pass barrier did not complete within
    ``config.stream_sync_timeout_s``: a peer process is likely gone, and
    without the deadline the survivors would wait in the collective
    forever. Typed, so a caller can restart the fit."""


def run_with_deadline(fn, timeout_s, tag="stream_pass"):
    """Run ``fn`` (a blocking collective) on a helper thread and raise
    :class:`StreamSyncTimeout` if it has not completed within
    ``timeout_s``. The collective cannot be interrupted: the helper
    thread is abandoned (a daemon), since the typed error means the
    process restarts. ``fn``'s own exception re-raises here."""
    done = threading.Event()
    err = []

    def runner():
        try:
            fn()
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            err.append(exc)
        finally:
            done.set()

    threading.Thread(target=runner, daemon=True,
                     name=f"stream-sync-{tag}").start()
    if not done.wait(timeout_s):
        raise StreamSyncTimeout(
            f"pass barrier {tag!r} did not complete within {timeout_s:g}s "
            "— a peer process is likely gone; restart the fit")
    if err:
        raise err[0]


def sync_stream_pass(tag="stream_pass", timeout_s=None) -> bool:
    """The sync point between the passes of a multi-process streamed fit:
    every process streams the same pass sequence over its own rows, and
    the barrier keeps a fast process from running ahead. Fires the
    ``pass_barrier`` fault site. ``timeout_s`` (default
    ``config.stream_sync_timeout_s``; 0 = wait forever) bounds it with
    :class:`StreamSyncTimeout`. A no-op (False) for one process and in
    virtual worlds."""
    ok, _ = multihost_capability()
    if not ok:
        return False
    from ..config import get_config

    cfg = get_config()
    if timeout_s is None:
        timeout_s = float(cfg.stream_sync_timeout_s)
    # the plan is read HERE, on the caller's thread: the body may run on
    # a helper thread, whose thread-local config would not carry a
    # config.set override
    spec = cfg.fault_plan

    def body():
        from ..reliability.faults import fire_plan

        fire_plan(spec, "pass_barrier")
        td = _td()
        td.barrier(group=_host_group(td))

    t0 = _time.perf_counter()
    try:
        if timeout_s and timeout_s > 0:
            run_with_deadline(body, timeout_s, tag)
        else:
            body()
    finally:
        plane_stats["barrier_s"] += _time.perf_counter() - t0
        plane_stats["barriers"] += 1
    return True
