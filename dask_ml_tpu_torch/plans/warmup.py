"""WarmupRegistry: process-wide, idempotent, attributable warmup.

Counterpart of ``dask_ml_tpu/plans/warmup.py``. Warming runs an entry
point once per shape rung so steady-state traffic captures no new CUDA
graph:

- **idempotent**: a warm key covers everything the captured graph's
  identity depends on (the entry point's graph set, the device, the
  rung, the operand geometry). A second request to warm a warm key
  skips the execution (``plan_cache_hits``);
- **attributable**: every warm records (program, ladder, rung), so the
  plans table (:func:`~dask_ml_tpu_torch.plans.plans_snapshot`) shows
  which ladder rung minted each specialization, and ``plan_warmups``
  counts the executions;
- **overridable**: ``config.plan_rewarm`` forces every warm to run again
  (the executions are semantic no-ops).

A graph holds the addresses of one entry point's static buffers, so the
serving keys name that entry point's own graph set, not a program shared
across servers: a second server over a same-shaped model warms its own
graphs (the JAX package's key, the plan token of a shared jit, lets it
skip them).
"""

from __future__ import annotations

import threading

__all__ = ["WarmupRegistry", "warmups"]


class WarmupRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._warmed: dict = {}

    def warmed(self, key) -> bool:
        """True when ``key`` is already warm (always False under
        ``config.plan_rewarm``)."""
        from ..config import get_config

        if get_config().plan_rewarm:
            return False
        with self._lock:
            return key in self._warmed

    def note(self, key, program=None, ladder=None, rung=None,
             ran=False) -> None:
        """Register ``key`` as warm WITHOUT executing anything — for
        call sites whose real dispatch just built the specialization.
        ``ran=True`` marks a warm execution this registry is accounting
        for."""
        from ..observability._counters import record_plan_warmup
        from .plan import note_rung

        with self._lock:
            rec = self._warmed.get(key)
            if rec is None:
                rec = self._warmed[key] = {
                    "program": program, "ladder": ladder, "rung": rung,
                    "ran": bool(ran), "hits": 0,
                }
                fresh = True
            else:
                fresh = False
        if fresh:
            note_rung(program, rung)
            if ran:
                record_plan_warmup()

    def warm(self, key, thunk, program=None, ladder=None,
             rung=None) -> bool:
        """Execute ``thunk`` once per key: returns True when it ran,
        False when the key was already warm (counted as a
        ``plan_cache_hits``: the graph it would have captured already
        exists)."""
        if self.warmed(key):
            from ..observability._counters import record_plan_warmup

            record_plan_warmup(hit=True)
            with self._lock:
                rec = self._warmed.get(key)
                if rec is not None:
                    rec["hits"] += 1
            return False
        thunk()
        self.note(key, program=program, ladder=ladder, rung=rung,
                  ran=True)
        return True

    def stats_by_program(self) -> dict:
        """{program: {"warmups": executed, "hits": skipped}} — the
        plans-table numbers."""
        out: dict = {}
        with self._lock:
            for rec in self._warmed.values():
                p = rec.get("program")
                if p is None:
                    continue
                e = out.setdefault(p, {"warmups": 0, "hits": 0})
                if rec.get("ran"):
                    e["warmups"] += 1
                e["hits"] += int(rec.get("hits", 0))
        return out

    def snapshot(self) -> list:
        """One row per warmed key family, aggregated by
        (program, ladder): the rungs warmed and the execution/skip
        counts."""
        groups: dict = {}
        with self._lock:
            for rec in self._warmed.values():
                gkey = (rec.get("program"), rec.get("ladder"))
                g = groups.setdefault(gkey, {"rungs": set(),
                                             "warmups": 0, "hits": 0})
                if rec.get("rung") is not None:
                    g["rungs"].add(rec["rung"])
                if rec.get("ran"):
                    g["warmups"] += 1
                g["hits"] += int(rec.get("hits", 0))
        rows = []
        for (program, ladder) in sorted(
                groups, key=lambda k: (str(k[0]), str(k[1]))):
            g = groups[(program, ladder)]
            rows.append({
                "program": program or "-",
                "ladder": ladder or "-",
                "rungs": ",".join(str(r) for r in sorted(g["rungs"]))
                         or "-",
                "warmups": g["warmups"],
                "warm_hits": g["hits"],
            })
        return rows

    def reset(self) -> None:
        with self._lock:
            self._warmed.clear()


# the process-wide registry: warming is a property of the process's
# graphs, so its bookkeeping is too
warmups = WarmupRegistry()
