"""The mesh of the process plane.

Counterpart of ``dask_ml_tpu/parallel/mesh.py`` in a port that holds one
device per process: the mesh is the process world. ``parse_mesh_shape``
accepts and refuses the same strings as the JAX function, and
``config.mesh_shape`` lays the world out:

- ``"auto"``, ``"D"`` and ``"Dx1"`` give the 1-D data axis (``D`` must be
  the process count: a process cannot sit out); every rank streams and
  fits its own rows;
- ``"DxM"`` with ``D * M == process_count()`` gives the 2-D ("data",
  "model") mesh: rank r sits at data index ``r // M`` and model index
  ``r % M``. The M ranks of one row group (one data index) pass the same
  rows, and each keeps the column tile ``[j d/M, (j+1) d/M)`` of them
  (``ShardedArray.from_array(..., shard_features=True)``, a streamed X
  of ``BlockStream``); the global row count is the sum over row groups.
  The "data" collective runs over the D ranks of one model index, the
  "model" collective over the M ranks of one data index
  (``distributed.psum_host(..., group=...)``).

Inside ``distributed.local_section`` (a search's trial) the world is one
process and the mesh is 1 x 1. ``config.stream_mesh`` above 1 (several
devices in one process) raises ``NotImplementedError`` naming ROADMAP.md
queue 1, Multi-GPU (several devices in one process).
"""

from __future__ import annotations

_SEVERAL_DEVICES = ("ROADMAP.md queue 1, Multi-GPU (several devices in "
                    "one process)")


def parse_mesh_shape(s, n_devices: int):
    """Parse a ``config.mesh_shape`` string against ``n_devices``.

    Returns ``None`` for "auto"/""/"1d", else ``(D, M)``. A bare "D"
    normalizes to ``(D, 1)``. Either factor may be -1 (inferred from
    ``n_devices``); D*M may undershoot ``n_devices`` but never exceed
    it."""
    s = str(s or "auto").strip().lower()
    if s in ("auto", "", "1d"):
        return None
    parts = s.split("x")
    if len(parts) not in (1, 2):
        raise ValueError(f"mesh_shape {s!r}: expected 'auto', 'D', or 'DxM'")
    try:
        dims = [int(p) for p in parts]
    except ValueError:
        raise ValueError(
            f"mesh_shape {s!r}: expected 'auto', 'D', or 'DxM'") from None
    if len(parts) == 1:
        dims = dims + [1]
    d, m = dims
    if d == -1 and m == -1:
        raise ValueError(f"mesh_shape {s!r}: only one axis may be -1")
    if d == -1:
        if m < 1 or n_devices % m:
            raise ValueError(f"mesh_shape {s!r}: cannot infer data axis "
                             f"from {n_devices} devices")
        d = n_devices // m
    elif m == -1:
        if d < 1 or n_devices % d:
            raise ValueError(f"mesh_shape {s!r}: cannot infer model axis "
                             f"from {n_devices} devices")
        m = n_devices // d
    if d < 1 or m < 1:
        raise ValueError(f"mesh_shape {s!r}: axes must be >= 1 (or -1)")
    if d * m > n_devices:
        raise ValueError(
            f"mesh_shape {s!r} needs {d * m} devices, have {n_devices}")
    return (d, m)


def process_mesh():
    """(D, M) of ``config.mesh_shape`` over the process world: (1, 1) for
    one process and inside ``distributed.local_section`` (whatever the
    shape names: a search's trial sees a one-process world), (world, 1)
    for the 1-D forms. Raises ``NotImplementedError`` for
    ``config.stream_mesh`` above 1 and ``ValueError`` for a shape that
    is not the world."""
    from ..config import get_config
    from .distributed import in_local_section, process_count

    cfg = get_config()
    n_dev = int(cfg.stream_mesh)
    if n_dev > 1:
        raise NotImplementedError(
            f"stream_mesh={n_dev}: several devices in one process are not "
            f"ported; the port runs one device per process "
            f"({_SEVERAL_DEVICES})")
    if in_local_section():
        return (1, 1)
    world = process_count()
    shape = cfg.mesh_shape
    dm = parse_mesh_shape(shape, world)
    if dm is None:
        return (world, 1)
    d, m = dm
    if d * m != world:
        raise ValueError(
            f"mesh_shape={shape!r}: the mesh is the process world, "
            f"{world} process(es); D * M must equal it")
    return (d, m)


def check_stream_mesh() -> None:
    """Check ``config.stream_mesh`` and ``config.mesh_shape`` against the
    process world (``process_mesh``); raises for what the port does not
    run."""
    process_mesh()


def data_shards() -> int:
    """Row groups of the process mesh (its "data" axis)."""
    return process_mesh()[0]


def model_shards() -> int:
    """Feature tiles of the process mesh (its "model" axis); 1 on the
    1-D forms."""
    return process_mesh()[1]


def data_index() -> int:
    """This rank's row group."""
    from .distributed import process_index

    return process_index() // process_mesh()[1]


def model_index() -> int:
    """This rank's feature tile."""
    from .distributed import process_index

    return process_index() % process_mesh()[1]


def mesh_str() -> str:
    """The mesh as "DxM" (one process renders "1x1")."""
    d, m = process_mesh()
    return f"{d}x{m}"


def feature_tile(d: int, m: int):
    """(lo, hi) of this rank's column tile of a width-``d`` design over
    ``m`` tiles, or None when ``m`` is 1 or ``d`` does not divide over
    it (the model-replicated layout)."""
    if m <= 1 or d % m:
        return None
    j, w = model_index(), d // m
    return (j * w, (j + 1) * w)
