"""ProgramPlan: the one build path for every served entry point.

Counterpart of ``dask_ml_tpu/plans/plan.py``. A :class:`ProgramPlan` is
the declarative spec of one program: its body (a PyTorch function of a
parameter dict and the batch operands), a cache key carrying what the
program's identity depends on beyond the body (the swap signature:
family, method, parameter shapes), a name and a ladder reference.
:meth:`ProgramPlan.build` is the one path that turns it into a
:class:`Program`:

1. the process-wide build cache is consulted (``config.plan_cache``):
   two builds of an identical spec return the SAME program
   (``plan_cache_hits``), capped at ``_BUILD_CACHE_MAX`` specs, the
   oldest evicted first;
2. on a miss the program is made (``plan_builds``) and its name, group
   and ladder join the attribution registry behind
   :func:`plans_snapshot`.

Where the JAX package's jit keeps an XLA executable per input shape, a
program here keeps a **CUDA graph per bucket** in a :class:`GraphSet`:
one set per entry point and device, holding that entry point's static
parameter buffers, its own CUDA stream, and for each key (the operand
shapes and dtypes, and any static arguments; the method, parameter
shapes, dtype and flavour are the set's own) a graph with static input
and output buffers. A graph is built in this order: a warm-up run of the
body on the set's side stream, then ``torch.cuda.CUDAGraph`` capture on
that stream (``graph_captures`` counts each). A capture that fails
raises: nothing falls back to eager execution on the card. On the CPU,
which a caller gets only by asking for it, the body runs eagerly and
each new key is counted the same way, so a test on the CPU sees the
captures the card would make.

Every call of a set holds its lock from the copy of the operands into
the static inputs to the end of the read-back of the output through a
pinned buffer, so a parameter swap (:meth:`GraphSet.swap`, which writes
the static parameter buffers in place, on the set's stream, under the
same lock) lands between batches: a batch already running finishes on
the old parameters, the next one reads the new, and a swap to
parameters of the same shapes captures nothing.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading

import numpy as np
import torch

__all__ = ["ProgramPlan", "Program", "GraphSet", "tracked",
           "register_attr", "note_rung", "plans_snapshot", "plans_reset"]

_lock = threading.Lock()
# insertion-ordered build cache with a hard cap: a process churning
# through many differently-shaped models must not pin every program
# forever; past the cap the oldest spec is evicted (an evicted program
# stays alive wherever an entry point holds it)
_BUILD_CACHE: dict = {}
_BUILD_CACHE_MAX = 256
_tokens = itertools.count(1)

# attribution registry: program name -> {group, ladder, rungs, mesh}
_ATTR: dict = {}


def register_attr(name: str, group: str = "plan",
                  ladder: str | None = None,
                  mesh: str | None = None) -> None:
    with _lock:
        e = _ATTR.get(name)
        if e is None:
            _ATTR[name] = {"group": group, "ladder": ladder,
                           "mesh": mesh, "rungs": set()}
        else:
            if group:
                e["group"] = group
            if ladder:
                e["ladder"] = ladder
            if mesh:
                e["mesh"] = mesh


def note_rung(name: str, rung) -> None:
    """Record that ``rung`` of ``name``'s ladder minted (or warmed) a
    specialization."""
    if name is None or rung is None:
        return
    with _lock:
        e = _ATTR.setdefault(name, {"group": "plan", "ladder": None,
                                    "rungs": set()})
        e["rungs"].add(int(rung))


def plans_snapshot() -> list:
    """One row per planned program: plan group, ladder, the rungs that
    minted specializations, and the warmup and warm-hit counts."""
    from .warmup import warmups

    stats = warmups.stats_by_program()
    with _lock:
        names = sorted(_ATTR)
        attr = {k: dict(_ATTR[k], rungs=sorted(_ATTR[k]["rungs"]))
                for k in names}
    rows = []
    for name in names:
        e = attr[name]
        st = stats.get(name, {})
        rows.append({
            "program": name,
            "plan": e["group"],
            "ladder": e.get("ladder") or "-",
            "rungs": ",".join(str(r) for r in e["rungs"]) or "-",
            "warmups": int(st.get("warmups", 0)),
            "warm_hits": int(st.get("hits", 0)),
        })
    return rows


def plans_reset() -> None:
    from .warmup import warmups

    with _lock:
        _ATTR.clear()
        _BUILD_CACHE.clear()
    warmups.reset()


class Program:
    """A plan-built program: its body, and the factory of the graph sets
    that capture it per bucket."""

    def __init__(self, name, body):
        self.body = body
        self.program_name = self.plan_name = name
        self.plan_token = next(_tokens)

    def graphs(self, params, device, state=None):
        """A fresh :class:`GraphSet` of this program over ``params``
        (host arrays, uploaded to ``device``)."""
        return GraphSet(self, params, device, state=state)


def _as_operand(a, device):
    """One batch operand as a tensor the static input can copy from: a
    tensor as it is (pinned staging stays pinned), an array as float32
    unless it carries integers."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.kind == "f" and a.dtype != np.float32:
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a))


class GraphSet:
    """The captured graphs of one program over one set of static
    parameter buffers on one device (see the module docstring).

    ``state`` is a host payload swapped together with the parameters
    (the class labels a classifier's labels map through), returned with
    every output so a caller never pairs new weights with old labels.
    """

    def __init__(self, program, params, device, state=None):
        self.program = program
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        # a copy: swaps write these buffers in place
        self.params = {k: torch.tensor(np.asarray(v), device=self.device)
                       for k, v in params.items()}
        self.state = state
        self.token = next(_tokens)
        self.lock = threading.Lock()
        self._graphs: dict = {}
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None

    def keys(self) -> tuple:
        """The keys of the graphs captured so far (on the CPU, the keys
        seen)."""
        with self.lock:
            return tuple(self._graphs)

    def swap(self, params, state) -> None:
        """Write ``params`` (host arrays of the same shapes and dtypes)
        into the static parameter buffers and install ``state``, between
        two batches."""
        with self.lock:
            # on the set's stream (None on the CPU: the current one)
            with torch.cuda.stream(self.stream):
                for k, v in params.items():
                    self.params[k].copy_(torch.from_numpy(
                        np.ascontiguousarray(v)))
            if self.cuda:
                self.stream.synchronize()
            self.state = state

    def run(self, operands, static=(), copied=None):
        """``(host output, state)`` of the program on ``operands`` (host
        arrays or tensors; a pinned tensor is copied asynchronously, and
        ``copied``, a CUDA event, is recorded once its copy is issued).
        A new key captures its graph first."""
        ops = tuple(_as_operand(a, self.device) for a in operands)
        key = tuple((tuple(a.shape), str(a.dtype)) for a in ops) \
            + tuple(static)
        with self.lock:
            if not self.cuda:
                if key not in self._graphs:
                    self._note_capture(key, None)
                out = self.program.body(self.params, *ops, *static)
                return _host(out), self.state
            entry = self._graphs.get(key)
            if entry is None:
                entry = self._capture(key, ops, static)
            static_in, graph, out_pin, static_out, done = entry
            s = self.stream
            with torch.cuda.stream(s):
                for dst, src in zip(static_in, ops):
                    dst.copy_(src, non_blocking=True)
                if copied is not None:
                    copied.record(s)
                graph.replay()
                out_pin.copy_(static_out, non_blocking=True)
                done.record(s)
            done.synchronize()
            return out_pin.numpy().copy(), self.state

    def _note_capture(self, key, entry):
        from ..observability._counters import record_graph_capture

        self._graphs[key] = entry
        record_graph_capture()

    def _capture(self, key, ops, static):
        """Warm-up run on the set's stream, then capture (see the module
        docstring); a failure raises."""
        s = self.stream
        static_in = [torch.zeros(tuple(a.shape), dtype=a.dtype,
                                 device=self.device) for a in ops]
        # the parameter upload and the zeros ran on this thread's stream
        s.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(s):
            self.program.body(self.params, *static_in, *static)
        s.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=s,
                              capture_error_mode="thread_local"):
            static_out = self.program.body(self.params, *static_in,
                                           *static)
        out_pin = torch.empty(tuple(static_out.shape),
                              dtype=static_out.dtype, pin_memory=True)
        entry = (static_in, graph, out_pin, static_out, torch.cuda.Event())
        self._note_capture(key, entry)
        return entry


def _host(out):
    return out.detach().cpu().numpy().copy() \
        if isinstance(out, torch.Tensor) else np.asarray(out)


@dataclasses.dataclass
class ProgramPlan:
    """Declarative spec of one program (see the module docstring).

    ``key`` must carry everything the program's identity depends on
    beyond the body, because the build cache treats two plans with equal
    (name, key, donate, statics) as the same program. With ``key=None``
    the body object itself keys the cache. ``donate`` and the static
    axes are kept for the JAX spec's shape; a graph reads its operands
    from static buffers, so nothing is donated.
    """

    name: str
    body: object
    donate: tuple = ()
    static_argnums: tuple = ()
    static_argnames: tuple = ()
    key: object = None
    ladder: str | None = None
    group: str = "plan"
    mesh: str | None = None

    def cache_key(self):
        key = self.key if self.key is not None else self.body
        spec = (self.name, key, tuple(self.donate),
                tuple(self.static_argnums), tuple(self.static_argnames))
        try:
            return hash(spec), spec
        except TypeError:
            return None

    def build(self) -> Program:
        """The program of this plan, from the build cache when an
        identical spec was built before."""
        from ..config import get_config
        from ..observability._counters import record_plan_build

        ck = self.cache_key()
        use_cache = bool(get_config().plan_cache) and ck is not None
        if use_cache:
            with _lock:
                hit = _BUILD_CACHE.get(ck[1])
            if hit is not None:
                record_plan_build(cached=True)
                return hit
        prog = Program(self.name, self.body)
        register_attr(self.name, group=self.group, ladder=self.ladder,
                      mesh=self.mesh)
        record_plan_build(cached=False)
        if use_cache:
            with _lock:
                prog = _BUILD_CACHE.setdefault(ck[1], prog)
                while len(_BUILD_CACHE) > _BUILD_CACHE_MAX:
                    _BUILD_CACHE.pop(next(iter(_BUILD_CACHE)))
        return prog


def tracked(name, fn=None, *, group="superblock", ladder=None,
            mesh=None):
    """Route a program built elsewhere through the plan layer: registers
    its attribution and stamps ``plan_token``/``plan_name`` on it.
    Usable as a decorator (``@tracked("name")``) or a call."""
    if fn is None:
        return lambda f: tracked(name, f, group=group, ladder=ladder,
                                 mesh=mesh)
    register_attr(name, group=group, ladder=ladder, mesh=mesh)
    fn.plan_token = next(_tokens)
    fn.plan_name = name
    return fn
