"""The mesh of the process plane.

Counterpart of ``dask_ml_tpu/parallel/mesh.py`` in a port that holds one
device per process: the "data" axis is the process world
(its size is ``process_count()``), and each rank streams and
fits its own rows on its own card. ``parse_mesh_shape`` accepts and
refuses the same strings as the JAX function. ``"auto"``, ``"D"`` and
``"Dx1"`` give the 1-D data axis (``D`` must be the process count: a
process cannot sit out); a model axis ``M > 1`` (the 2-D feature
sharding) and ``config.stream_mesh`` above 1 (several devices in one
process) raise ``NotImplementedError`` naming ROADMAP.md queue 1,
Multi-GPU (feature sharding).
"""

from __future__ import annotations

_LATER = ("ROADMAP.md queue 1, Multi-GPU (feature sharding)")


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


def check_stream_mesh() -> None:
    """Check ``config.stream_mesh`` and ``config.mesh_shape`` against the
    process world, the one data axis the port runs over; raises for what
    it does not run."""
    from ..config import get_config
    from .distributed import process_count

    cfg = get_config()
    n_dev = int(cfg.stream_mesh)
    if n_dev > 1:
        raise NotImplementedError(
            f"stream_mesh={n_dev}: several devices in one process are not "
            f"ported; the port runs one device per process ({_LATER})")
    world = process_count()
    shape = cfg.mesh_shape
    try:
        dm = parse_mesh_shape(shape, world)
    except ValueError:
        # a model axis is refused as not ported, whatever the world
        wide = parse_mesh_shape(shape, 1 << 20)
        if wide is None or wide[1] == 1 or "-1" in str(shape):
            raise
        dm = wide
    if dm is None:
        return
    d, m = dm
    if m > 1:
        raise NotImplementedError(
            f"mesh_shape={shape!r}: a model axis of {m} shards the "
            f"features, which is not ported ({_LATER})")
    if d != world:
        raise ValueError(f"mesh_shape={shape!r}: the data axis is the "
                         f"process world, {world} process(es)")
