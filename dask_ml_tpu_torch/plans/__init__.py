"""One execution plane for every served program.

Counterpart of ``dask_ml_tpu/plans``:

- :mod:`~dask_ml_tpu_torch.plans.ladders`: the shape policies
  (:class:`GeometricLadder`, :class:`NnzLadder`, :class:`SlotRungLadder`),
  with padding and mask construction beside the rung choice, the same
  rungs as the JAX package's for the same arguments;
- :mod:`~dask_ml_tpu_torch.plans.plan`: :class:`ProgramPlan`, the
  declarative spec whose :meth:`~ProgramPlan.build` is the one path to a
  program, and the :class:`GraphSet` that captures a CUDA graph per
  bucket of an entry point (in the place of the XLA compile cache);
- :mod:`~dask_ml_tpu_torch.plans.warmup`: the process-wide
  :data:`warmups` registry, idempotent and attributable.

Config knobs: ``plan_cache`` (reuse identical plan builds process-wide)
and ``plan_rewarm`` (force warm executions to re-run). A graph cannot
outlive its process, so nothing persists between processes (the JAX
package's ``compile_cache_dir`` has no counterpart).
"""

from .ladders import (GeometricLadder, NnzLadder, ShapeLadder,
                      SlotRungLadder)
from .plan import (GraphSet, Program, ProgramPlan, note_rung, plans_reset,
                   plans_snapshot, register_attr, tracked)
from .warmup import WarmupRegistry, warmups

__all__ = [
    "ShapeLadder", "GeometricLadder", "NnzLadder", "SlotRungLadder",
    "ProgramPlan", "Program", "GraphSet", "tracked", "register_attr",
    "note_rung", "plans_snapshot", "plans_reset",
    "WarmupRegistry", "warmups",
]
