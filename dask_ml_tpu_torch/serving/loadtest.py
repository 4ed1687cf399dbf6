"""Replay-driven load testing: recorded traffic in, SLO verdict out.

Counterpart of ``dask_ml_tpu/serving/loadtest.py``:

- :func:`replay_load_test` drives a recorded (method, rows, rate) mix
  against a live server or fleet, measures each request's end-to-end
  latency and outcome (ok / shed / timeout / error), and verdicts the
  run against ``serving_slo_ms`` at a chosen quantile;
- ``fault_plan=`` runs the mix under a fault plan, armed around SERVER
  CONSTRUCTION (workers capture their creator's config: pass ``target``
  as a zero-arg factory so they are born under the plan);
- ``canary_version=`` flips the target's registry to an ARCHIVED version
  for the run (a swap that captures nothing), replays the mix against it
  and flips back;
- :func:`synthesize_records` builds a deterministic capture-shaped mix.

The mix is a list of capture records (``t_unix``, ``method``,
``n_rows``, as the JAX package's request capture writes them);
recording one from this package's servers waits for ROADMAP.md queue 1,
Observability, part 2 (request traces).
"""

from __future__ import annotations

import json
import time

import numpy as np

from ._server import RequestTimeout, ServingError, SloShed

__all__ = ["replay_load_test", "synthesize_records", "load_capture",
           "replay"]


def load_capture(path) -> list:
    """The admitted-traffic records (``req_capture``) of a JSONL file,
    sorted by admit wall clock; corrupt lines are skipped."""
    records = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                r = json.loads(line)
            except ValueError:
                continue
            if isinstance(r, dict) and r.get("req_capture"):
                records.append(r)
    records.sort(key=lambda r: r.get("t_unix", 0.0))
    return records


def replay(records, submit, speed: float = 1.0) -> dict:
    """Re-issue a captured mix: ``submit(method, n_rows)`` for each
    record at the recorded inter-arrival spacing scaled by ``1/speed``.
    Returns the replayed mix's summary."""
    by_method: dict[str, int] = {}
    rows = 0
    if not records:
        return {"requests": 0, "rows": 0, "duration_s": 0.0,
                "rate_rps": 0.0, "by_method": by_method}
    t_first = records[0].get("t_unix", 0.0)
    start = time.perf_counter()
    for r in records:
        delay = (r.get("t_unix", t_first) - t_first) / max(speed, 1e-9) \
            - (time.perf_counter() - start)
        if delay > 0:
            time.sleep(delay)
        submit(r["method"], int(r["n_rows"]))
        by_method[r["method"]] = by_method.get(r["method"], 0) + 1
        rows += int(r["n_rows"])
    dur = time.perf_counter() - start
    return {
        "requests": len(records),
        "rows": rows,
        "duration_s": round(dur, 6),
        "rate_rps": round(len(records) / dur, 3) if dur > 0 else 0.0,
        "by_method": by_method,
    }


def synthesize_records(n_requests, methods=("predict",),
                       rows=(1, 64), rate_rps=200.0, seed=0) -> list:
    """A deterministic capture-shaped record list (the
    ``load_capture`` schema: t_unix / method / n_rows) for harness runs
    with no real recording: request sizes draw log-uniformly from
    ``rows=(lo, hi)``, methods round-robin, inter-arrivals are
    exponential at ``rate_rps`` (a Poisson burst, not a metronome)."""
    rng = np.random.default_rng(seed)
    lo, hi = int(rows[0]), int(rows[1])
    t = 0.0
    records = []
    for i in range(int(n_requests)):
        t += float(rng.exponential(1.0 / max(rate_rps, 1e-9)))
        n = int(round(np.exp(rng.uniform(np.log(max(lo, 1)),
                                         np.log(max(hi, 1))))))
        records.append({
            "req_capture": True,
            "t_unix": round(t, 6),
            "method": methods[i % len(methods)],
            "n_rows": max(min(n, hi), lo),
        })
    return records


def _quantile_ms(lats_s, q):
    if not lats_s:
        return None
    return float(np.percentile(np.asarray(lats_s, np.float64),
                               q)) * 1e3


def replay_load_test(target, X, records=None, capture_path=None,
                     speed=1.0, slo_ms=None, quantile=99.0,
                     canary_version=None, fault_plan=None,
                     result_timeout_s=60.0) -> dict:
    """Replay a recorded mix against ``target`` and verdict the SLO.

    Parameters
    ----------
    target : server-like or zero-arg callable
        Anything with ``submit(X, method=...) -> Future`` (ModelServer,
        FleetServer). Pass a CALLABLE returning a
        started+warmed server to run it under an armed ``fault_plan`` —
        serving workers capture config at construction, so a plan armed
        after the fact never fires on them; a factory target is
        constructed (and stopped) inside the armed scope.
    X : (n, d) array — the feature pool requests slice rows from
        (wrapping), so the replay exercises the data plane, not zeros.
    records / capture_path
        The mix: an explicit record list (``synthesize_records``) or a
        JSONL file of capture records (:func:`load_capture`). One of the
        two.
    speed : float — replay speedup (10 = 10x the recorded rate).
    slo_ms : float, default ``config.serving_slo_ms`` — verdict budget.
    quantile : float — the latency quantile the verdict holds against.
    canary_version : int — flip the target's registry to this ARCHIVED
        version for the run, flip back after (shadow canary test).
    fault_plan : str — chaos plan armed around the run (and around
        factory construction).

    Returns the report dict; ``report["passed"]`` is the verdict:
    latency quantile within ``slo_ms`` (when an SLO is set) AND zero
    errored admitted requests (sheds are deliberate backpressure and
    counted, not failed; a TIMED-OUT admitted request fails the run —
    it was lost to the client)."""
    from .. import config

    if records is None:
        if capture_path is None:
            raise ValueError("need records= or capture_path=")
        records = load_capture(capture_path)
    pool = np.asarray(X, np.float32)
    if pool.ndim == 1:
        pool = pool[None, :]
    pool_n = int(pool.shape[0])

    overrides = {}
    if fault_plan is not None:
        overrides["fault_plan"] = fault_plan
    if slo_ms is not None:
        overrides["serving_slo_ms"] = float(slo_ms)
    with config.set(**overrides):
        srv = target() if callable(target) else target
        own_server = callable(target)
        restored_version = None
        try:
            if canary_version is not None:
                cur = srv.registry.current_version(srv.name)
                if int(canary_version) != cur:
                    restored_version = cur
                    srv.rollback(int(canary_version))
            budget_ms = float(config.get_config().serving_slo_ms
                              if slo_ms is None else slo_ms)
            outcomes = {"ok": 0, "shed": 0, "timeout": 0, "error": 0}
            futures = []
            lats_s = []
            cursor = [0]

            def _submit(method, n_rows):
                i = cursor[0]
                cursor[0] = i + n_rows
                idx = np.arange(i, i + n_rows) % pool_n
                t0 = time.perf_counter()
                try:
                    fut = srv.submit(pool[idx], method=method)
                except SloShed:
                    outcomes["shed"] += 1
                    return
                except ServingError:
                    outcomes["error"] += 1
                    return
                futures.append((fut, t0))

            mix = replay(records, _submit, speed=speed)
            for fut, t0 in futures:
                try:
                    fut.result(result_timeout_s)
                    lats_s.append(time.perf_counter() - t0)
                    outcomes["ok"] += 1
                except SloShed:
                    outcomes["shed"] += 1
                except RequestTimeout:
                    outcomes["timeout"] += 1
                except Exception:
                    outcomes["error"] += 1
        finally:
            if restored_version is not None:
                try:
                    srv.rollback(restored_version)
                except Exception:
                    pass
            if own_server:
                try:
                    srv.stop()
                except Exception:
                    pass

    p_ms = _quantile_ms(lats_s, quantile)
    passed = outcomes["error"] == 0 and outcomes["timeout"] == 0
    if budget_ms > 0 and p_ms is not None:
        passed = passed and p_ms <= budget_ms
    return {
        **mix,
        **outcomes,
        "admitted": len(futures),
        "latency_ms": {
            "p50": _quantile_ms(lats_s, 50.0),
            f"p{quantile:g}": p_ms,
        },
        "slo_ms": budget_ms,
        "quantile": float(quantile),
        "canary_version": canary_version,
        "restored_version": restored_version,
        "passed": bool(passed),
    }
