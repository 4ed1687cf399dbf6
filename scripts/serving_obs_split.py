#!/usr/bin/env python3
"""Split the serving plane's cost on the port: the same traffic through
one ModelServer per knob set, in turn, and the host cost of each piece.

    python3 scripts/serving_obs_split.py [ROUNDS]        # on the card
    python3 scripts/serving_obs_split.py ROUNDS --cpu    # a small CPU run

The model is a streamed lbfgs fit (so it carries a training profile) on
a seeded N(0, 1) draw of 200,000 x 256 (20,000 x 256 with --cpu); the
traffic is chip_smoke.py phase 27's (400 requests of log-uniform 1-256
rows from RandomState(11), 8 clients, BucketLadder(8, 512, 2.0), a 1 ms
window). Knob sets:

- ``off``: obs_drift off, nothing else;
- ``traces``: obs_trace_sample=0.1;
- ``fold``: obs_drift with the shadow rows, no drift monitor;
- ``fold+monitor``: the same with obs_drift_interval_s=0.5;
- ``all``: chip_smoke.py phase 31's server (b) (traces, fold, monitor,
  a drift_score_max rule ticked every 0.2 s, an incident directory and
  the exporter).

Each round starts every server in turn, serves one pass, stops it and
clears the process-wide planes (monitor, engine, exporter), so a set's
threads never run beside another's pass. Prints each pass, then per set
the median and best rows/s, p50 and p99 over ROUNDS (default 5), the
host cost of one ``drift.compute()`` over the served sketch, of one
pending fold of 1,024 rows, and of a trace's life, and the card's name
and power limit. ROUNDS rounds take about ROUNDS x 2 s of traffic.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SETS = {
    "off": dict(obs_drift=False),
    "traces": dict(obs_drift=False, obs_trace_sample=0.1),
    "fold": dict(obs_drift_interval_s=0.0, obs_shadow_fraction=0.05),
    "fold+monitor": dict(obs_drift_interval_s=0.5,
                         obs_shadow_fraction=0.05),
    "all": dict(obs_trace_sample=0.1, obs_drift_interval_s=0.5,
                obs_shadow_fraction=0.05,
                obs_alert_rules="drift_score_max:gauge>0.2",
                obs_alert_interval_s=0.2),
}


def _reset():
    from dask_ml_tpu_torch.observability import (_requests, alerts, drift,
                                                 incidents, live)

    drift.reset()
    alerts.reset()
    incidents.reset()
    live.stop_telemetry()
    _requests.traces_reset()


def _ms(fn, reps):
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def main(argv):
    cpu = "--cpu" in argv
    args = [a for a in argv if a != "--cpu"]
    rounds = int(args[0]) if args else 5
    import torch

    if not cpu and not torch.cuda.is_available():
        print("serving_obs_split: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from dask_ml_tpu_torch import config
    from dask_ml_tpu_torch.linear_model import LogisticRegression
    from dask_ml_tpu_torch.observability import _requests, drift
    from dask_ml_tpu_torch.serving import BucketLadder, ModelServer

    smi = "cpu" if cpu else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    n, d = (20_000 if cpu else 200_000), 256
    rng = np.random.RandomState(0)
    X = rng.randn(n, d).astype(np.float32)
    y = (X @ (rng.randn(d) / 16) + 0.3 * rng.randn(n) > 0).astype(
        np.float32)
    base = dict(device="cpu") if cpu else {}
    tmp = tempfile.mkdtemp()
    with config.set(**base, stream_block_rows=n // 4):
        clf = LogisticRegression(solver="lbfgs", max_iter=10).fit(X, y)
    assert clf.training_profile_
    reqs = [X[i:i + k] for i, k in cs._serve_mix(n)]
    rows = sum(len(r) for r in reqs)
    servers = {}
    for name, knobs in SETS.items():
        extra = {}
        if name == "all":
            extra = dict(incident_dir=os.path.join(tmp, "incidents"),
                         obs_http_port=cs._free_port())
        with config.set(**base, **knobs, **extra):
            servers[name] = (ModelServer(
                clf, ladder=BucketLadder(*cs.SERVE_LADDER),
                batch_window_ms=1.0, timeout_ms=0,
                name=f"split_{name}").warmup(), dict(base, **knobs, **extra))
    got = {name: [] for name in SETS}
    for r in range(rounds):
        for name, (srv, knobs) in servers.items():
            with config.set(**knobs):
                srv.start()
            wall, lat = cs._sobs_pass(srv, reqs)
            srv.stop()
            _reset()
            got[name].append((rows / wall, lat["p50"] * 1e3,
                              lat["p99"] * 1e3))
            print(f"round {r} {name}: {rows / wall:.6g} rows/s, p50 "
                  f"{lat['p50'] * 1e3:.3f} ms, p99 {lat['p99'] * 1e3:.3f} ms",
                  flush=True)
    off = statistics.median(v[0] for v in got["off"])
    out = {}
    for name, vals in got.items():
        med = [statistics.median(v[i] for v in vals) for i in range(3)]
        out[name] = {"rows_per_s_median": med[0],
                     "rows_per_s_best": max(v[0] for v in vals),
                     "p50_ms_median": med[1], "p99_ms_median": med[2],
                     "rows_per_s_over_off": med[0] / off}
        print(f"{name}: rows/s median {med[0]:.6g} (best "
              f"{max(v[0] for v in vals):.6g}; {med[0] / off:.3f} of off), "
              f"p50 {med[1]:.3f} ms, p99 {med[2]:.3f} ms")

    # the pieces' host cost, on the fitted profile's bounds
    with config.set(**base):
        drift.note_training_profile("cost", 0, clf.training_profile_)
        block = X[:1024]
        drift.fold_serving("cost", 0, "predict", block, max_rows=1024)
        fold_ms = _ms(lambda: drift.fold_serving(
            "cost", 0, "predict", block, max_rows=1024), 20)
        drift.compute(publish=False)
        compute_ms = _ms(lambda: drift.compute(publish=False), 10)

        def trace_life():
            tr = _requests.new_trace("predict", 40)
            for s in ("queue_pop", "pack", "dispatch", "execute_done",
                      "demux", "complete"):
                tr.stamp(s)
            tr.finish("ok")

        with config.set(obs_trace_sample=0.1):
            trace_us = _ms(trace_life, 2000) * 1e3
    drift.reset()
    _requests.traces_reset()
    print(f"host cost: drift.compute over one {d}-feature sketch and its "
          f"profile {compute_ms:.3f} ms; one pending fold of 1,024 rows "
          f"{fold_ms:.3f} ms (the token bucket lets about 10,000 rows/s "
          f"through); a trace's life {trace_us:.2f} us")
    print(smi)
    print(json.dumps({"sets": out, "compute_ms": compute_ms,
                      "fold_1024_ms": fold_ms, "trace_us": trace_us,
                      "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
