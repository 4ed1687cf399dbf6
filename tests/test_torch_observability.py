"""The port's observability (dask_ml_tpu_torch.observability) against
dask_ml_tpu's on the CPU: the per-fit JSONL records of the same fits,
the report and the Chrome-trace export of the same record files, the
Prometheus text of registries filled alike, and the logger, spans,
counters, knobs and kernel registry of the port."""

import json
import os
import threading

import numpy as np
import pytest
import torch

import jax

import dask_ml_tpu.linear_model as J
from dask_ml_tpu import config as jconfig
from dask_ml_tpu.cluster import KMeans as JKMeans
from dask_ml_tpu.observability import export as jexport
from dask_ml_tpu.observability import live as jlive
from dask_ml_tpu.observability import report as jreport
from dask_ml_tpu.observability._counters import counter_add as jcounter_add
from dask_ml_tpu.observability._counters import \
    counters_reset as jcounters_reset
from dask_ml_tpu.parallel.mesh import device_mesh, use_mesh
from dask_ml_tpu.parallel.sharded import ShardedArray as JSharded
from dask_ml_tpu_torch import config
from dask_ml_tpu_torch import observability as obs
from dask_ml_tpu_torch.cluster import KMeans
from dask_ml_tpu_torch.linear_model import LogisticRegression
from dask_ml_tpu_torch.observability import _peak, _programs, export, live, \
    report
from dask_ml_tpu_torch.ops import fused


@pytest.fixture(autouse=True)
def _cpu():
    with config.set(device="cpu"):
        yield


def _logistic(seed=0, n=3000, d=12):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    beta = rng.randn(d) / np.sqrt(d)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-(X @ beta + 0.3)))
         ).astype(np.float32)
    return X, y


def _blobs(seed=0, n=2000, d=6):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    X[: n // 2] += 3.0
    return X


def _one_device(fit):
    """A dask_ml_tpu fit on a one-device mesh (its ADMM consensus depends
    on the number of shards; the port's is the one-shard arithmetic)."""
    mesh = device_mesh(devices=jax.devices()[:1])
    with use_mesh(mesh):
        return fit(lambda a: JSharded.from_array(a, mesh=mesh))


# the fits of the record comparison: each at a tolerance where the two
# packages take the same iterations (tests/test_torch_glm.py,
# tests/test_torch_kmeans.py)
FITS = {
    "lbfgs": lambda P, X, y: P.LogisticRegression(
        solver="lbfgs", max_iter=100, tol=1e-5).fit(X, y),
    "newton": lambda P, X, y: P.LogisticRegression(
        solver="newton", tol=1e-4).fit(X, y),
    "admm": lambda P, X, y: P.LogisticRegression(max_iter=30).fit(X, y),
}


def _write_jax(path, kind):
    X, y = _logistic()
    with jconfig.set(metrics_path=path):
        if kind == "kmeans":
            Xb = _blobs()
            return JKMeans(n_clusters=4, init=Xb[:4].copy(),
                           max_iter=50).fit(Xb)
        if kind == "admm":
            return _one_device(lambda s: FITS[kind](J, s(X), s(y)))
        return FITS[kind](J, X, y)


def _write_port(path, kind, **knobs):
    import dask_ml_tpu_torch.linear_model as T

    X, y = _logistic()
    with config.set(metrics_path=path, **knobs):
        if kind == "kmeans":
            Xb = _blobs()
            return KMeans(n_clusters=4, init=Xb[:4].copy(),
                          max_iter=50).fit(Xb)
        return FITS[kind](T, X, y)


def _keys(records):
    """Each record's keys in order, without the counter deltas (``ctr_*``:
    the JAX package's fits also count XLA compiles, which the port has
    no counterpart of)."""
    return [tuple(k for k in r if not k.startswith("ctr_"))
            for r in records]


@pytest.fixture(scope="module")
def record_files(tmp_path_factory):
    """{kind: (JAX-written records path, port-written path, jax est, port
    est)} for the fits of the comparison."""
    root = tmp_path_factory.mktemp("records")
    out = {}
    for kind in ("lbfgs", "newton", "admm", "kmeans"):
        jp, tp = str(root / f"jax_{kind}.jsonl"), str(root / f"t_{kind}.jsonl")
        j = _write_jax(jp, kind)
        with config.set(device="cpu"):
            t = _write_port(tp, kind)
        out[kind] = (jp, tp, j, t)
    return out


@pytest.mark.parametrize("kind", ["lbfgs", "newton", "admm", "kmeans"])
def test_fit_records_match_jax(record_files, kind):
    jp, tp, j, t = record_files[kind]
    assert t.n_iter_ == j.n_iter_
    jr, tr = report.load_records(jp), report.load_records(tp)
    assert _keys(tr) == _keys(jr)
    steps_j = sorted((r for r in jr if "step" in r), key=lambda r: r["step"])
    steps_t = [r for r in tr if "step" in r]
    assert len(steps_t) == len(steps_j) == t.n_iter_
    assert [r["step"] for r in steps_t] == list(range(t.n_iter_))
    metric = {"kmeans": "center_shift2", "admm": "primal_residual"}.get(
        kind, "loss")
    a = np.array([r[metric] for r in steps_t])
    b = np.array([r[metric] for r in steps_j])
    if kind == "admm":
        # ADMM's residuals are float32 noise of their sums near the end
        # (tests/test_torch_glm.py::test_admm_matches_jax: rel 1e-3)
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-7)
    elif kind == "kmeans":
        # the squared shift is a difference of centers that are means
        # summed in another order: rel 1e-5 while it is large, float32
        # noise of the centers (2.3e-8 measured) once it is small
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)
    fit_t = [r for r in tr if r.get("span") == "fit"]
    fit_j = [r for r in jr if r.get("span") == "fit"]
    assert len(fit_t) == len(fit_j) == 1
    assert fit_t[0]["n_iter"] == fit_j[0]["n_iter"] == t.n_iter_


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind", ["lbfgs", "kmeans"])
def test_report_and_export_match_jax(record_files, writer, kind):
    jp, tp, _, _ = record_files[kind]
    path = jp if writer == "jax" else tp
    recs = report.load_records(path)
    assert report.report_data(recs) == jreport.report_data(recs)
    assert report.build_report(recs, path=path) == \
        jreport.build_report(recs, path=path)
    assert export.to_chrome_trace(recs) == jexport.to_chrome_trace(recs)


def test_each_report_cli_reads_the_others_file(record_files, capsys):
    jp, tp, _, _ = record_files["lbfgs"]
    assert report.main([jp, "--json"]) == 0
    port_on_jax = json.loads(capsys.readouterr().out)
    assert jreport.main([tp, "--json"]) == 0
    jax_on_port = json.loads(capsys.readouterr().out)
    assert port_on_jax["components"][0]["steps"] == \
        jax_on_port["components"][0]["steps"]
    assert report.main([jp, tp, "--merge"]) == 0
    assert "LogisticRegression.fit" in capsys.readouterr().out


def test_prometheus_text_matches_jax():
    """Counters, gauges and histograms filled alike render the same
    exposition under the same family names, but for the uptime value."""
    obs.counters_reset()
    jcounters_reset()
    live.metrics_reset()
    jlive.metrics_reset()
    try:
        for add in (obs.counter_add, jcounter_add):
            add("h2d_bytes", 4096)
            add("serving_requests", 3)
        for mod in (live, jlive):
            mod.gauge_set("fit_loss", 0.25)
            mod.gauge_set("serving_queue_rows", 7,
                          labels=(("model", "m1"),))
            h = mod.histogram("fit_pass_seconds")
            for v in (0.01, 0.2, 3.0):
                h.observe(v)
        a = live.render_prometheus().splitlines()
        b = jlive.render_prometheus().splitlines()
    finally:
        obs.counters_reset()
        jcounters_reset()
        live.metrics_reset()
        jlive.metrics_reset()
    up = "dask_ml_tpu_uptime_seconds "
    assert [ln for ln in a if not ln.startswith(up)] == \
        [ln for ln in b if not ln.startswith(up)]
    assert sum(ln.startswith(up) for ln in a) == 1


def test_kernel1_bound_at_the_main_path_shape():
    """4,000,000 x 257 f32 on the H100 row: the bytes of X and y over
    3.35 TB/s, 1.232 ms (PERF.md section 6)."""
    row = _peak.peak_row("NVIDIA H100 80GB HBM3")
    b, by = _programs.kernel_bound("fused_glm_value_grad", 4_000_000, 257, 4,
                                   row=row)
    assert by == "bytes"
    assert b * 1e3 == pytest.approx(1.232, rel=0.01)
    # Lloyd at 8M x 128, k = 64 on the tensor cores' 3xTF32 peak
    b, by = _programs.kernel_bound("fused_lloyd_stats", 8_000_000, 128, 64,
                                   False, row=row)
    assert by == "bytes" and b * 1e3 == pytest.approx(1.2227, rel=1e-3)
    # an unknown card gets no bound
    assert _peak.peak_row("NVIDIA H100 PCIe") is None
    assert _programs.kernel_bound("fused_glm_value_grad", 10, 3, 4,
                                  row=None) is None


class _Ev:
    """A stand-in CUDA event pair member: its time in ms."""

    def __init__(self, ms, done=True):
        self.ms, self.done = ms, done

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, stop):
        return stop.ms - self.ms


def test_registry_rows_fold_times_against_bounds(monkeypatch):
    """Queued event pairs fold into their kernel's row at snapshot time:
    the median, the device seconds, the bound of the same work and its
    share; a share over 1.05 is flagged."""
    row = dict(_peak.peak_row("NVIDIA H100 80GB HBM3"), device_kind="H100",
               power_limit="700.00 W", reason=None)
    monkeypatch.setattr(_peak, "resolve_peak", lambda use_cache=True: row)
    _programs.programs_reset()
    try:
        name = "fused_glm_value_grad"
        nbytes, terms = _programs.KERNEL_COSTS[name](4_000_000, 257, 4)
        flops = sum(f for f, _ in terms)
        for ms in (1.5, 1.6, 1.4):
            _programs._pending.append((name, _Ev(0.0), _Ev(ms, done=False),
                                       nbytes, terms, flops))
        # the tiny kernel below is "faster than its bound": flagged
        sb, st = _programs.KERNEL_COSTS["fused_lloyd_stats"](1000, 8, 4,
                                                            False)
        _programs._pending.append(("fused_lloyd_stats", _Ev(0.0),
                                   _Ev(1e-6), sb, st, 1.0))
        rows = {r["program"]: r for r in _programs.programs_snapshot()}
    finally:
        _programs.programs_reset()
    assert set(rows) == set(fused.KERNELS)
    r = rows[name]
    assert r["calls"] == fused.launches()[name]
    assert r["timed_calls"] == 3 and r["device_ms_median"] == 1.5
    assert r["exec_s"] == pytest.approx(4.5e-3)
    assert r["bound_s"] * 1e3 == pytest.approx(1.2322, rel=1e-4)
    assert r["share_of_bound"] == pytest.approx(3 * r["bound_s"] / 4.5e-3)
    assert not r["share_flag"]
    assert rows["fused_lloyd_stats"]["share_flag"]
    idle = rows["fused_sgd_block_grad"]
    assert idle["timed_calls"] == 0 and idle["share_of_bound"] is None


def test_registry_on_the_cpu_has_no_bound():
    rows = obs.programs_snapshot()
    assert [r["program"] for r in rows] != [] and len(rows) == 10
    assert all(r["calls"] == fused.launches()[r["program"]] for r in rows)
    assert all(r["bound_s"] is None for r in rows)
    assert "CPU" in rows[0]["bound_reason"]
    # a launch of the CPU path records nothing: the plain version ran
    assert _programs.launch_begin(torch.device("cpu")) is None


def test_device_memory_gauges_empty_on_cpu():
    assert obs.device_memory_gauges() == {}


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_knobs_off_start_nothing_and_fits_are_bit_equal(tmp_path,
                                                        monkeypatch):
    """Every knob at its default: no thread, no file; every knob on: the
    same coefficients bit for bit, and the records were written."""
    monkeypatch.chdir(tmp_path)
    X, y = _logistic(seed=3, n=1500, d=8)
    threads = {t.ident for t in threading.enumerate()}
    plain = LogisticRegression(solver="lbfgs", max_iter=30).fit(X, y)
    km_plain = KMeans(n_clusters=3, init=X[:3].copy(), max_iter=10).fit(X)
    assert {t.ident for t in threading.enumerate()} == threads
    assert os.listdir(tmp_path) == []
    assert live.telemetry_server() is None and not live.live_publishing()
    path = str(tmp_path / "on.jsonl")
    try:
        with config.set(metrics_path=path, obs_programs=True,
                        obs_http_port=_free_port(), watchdog_timeout_s=30.0):
            on = LogisticRegression(solver="lbfgs", max_iter=30).fit(X, y)
            km_on = KMeans(n_clusters=3, init=X[:3].copy(),
                           max_iter=10).fit(X)
        assert live.telemetry_server() is not None
    finally:
        live.stop_telemetry()
    assert not obs.watchdog_active()
    np.testing.assert_array_equal(on.coef_, plain.coef_)
    np.testing.assert_array_equal(on.intercept_, plain.intercept_)
    assert on.n_iter_ == plain.n_iter_
    np.testing.assert_array_equal(km_on.cluster_centers_,
                                  km_plain.cluster_centers_)
    assert km_on.inertia_ == km_plain.inertia_
    recs = report.load_records(path)
    assert sum(r.get("span") == "fit" for r in recs) == 2
    assert sum("step" in r for r in recs) == on.n_iter_ + km_on.n_iter_


def test_streamed_fit_records_one_pass_span_each(tmp_path):
    X, y = _logistic(seed=4, n=2000, d=6)
    path = str(tmp_path / "s.jsonl")
    with config.set(metrics_path=path, stream_block_rows=512):
        est = LogisticRegression(solver="lbfgs", max_iter=6, tol=0.0).fit(
            X, y)
    recs = report.load_records(path)
    passes = [r for r in recs if r.get("span") == "stream.pass"]
    assert len(passes) == est.solver_info_["data_passes"]
    assert [r["stream_pass"] for r in passes] == \
        list(range(1, len(passes) + 1))
    assert all(r["ctr_h2d_bytes"] == r["bytes"] for r in passes)
    steps = [r for r in recs if "step" in r]
    assert len(steps) == est.n_iter_
    assert {"loss", "grad_norm", "passes"} <= set(steps[0])


def test_two_ranks_append_whole_lines_to_one_file(tmp_path):
    """Two virtual ranks fitting at once, one metrics_path: every line is
    one whole record."""
    from dask_ml_tpu_torch.parallel import distributed as dist

    X, y = _logistic(seed=5, n=1200, d=6)
    path = str(tmp_path / "ranks.jsonl")

    def body(rank):
        return LogisticRegression(solver="lbfgs", max_iter=15).fit(
            X, y).n_iter_

    with config.set(metrics_path=path):
        n_iters = dist.run_virtual_processes(body, 2)
    with open(path) as fh:
        lines = fh.read().splitlines()
    recs = [json.loads(ln) for ln in lines]
    assert sum("step" in r for r in recs) == sum(n_iters)
    assert sum(r.get("span") == "fit" for r in recs) == 2


def test_spans_nest_and_register_while_open(tmp_path):
    with config.set(trace_dir=str(tmp_path)):
        with obs.span("outer", tag=1) as outer:
            with obs.span("inner") as inner:
                names = [s["span"] for s in obs.open_spans_snapshot()]
                assert names[-2:] == ["outer", "inner"]
                assert obs.current_span_id() == inner.span_id
            outer.add(late=2)
    assert obs.open_spans_snapshot() == []
    recs = report.load_records(str(tmp_path / "trace.jsonl"))
    inner_r, outer_r = recs
    assert inner_r["parent_id"] == outer_r["span_id"]
    assert outer_r["tag"] == 1 and outer_r["late"] == 2
    # no sink, no tracker: the shared no-op
    with obs.span("nothing") as sp:
        assert sp is obs.NOOP_SPAN


def test_logger_sink_binding_and_counters(tmp_path):
    path = str(tmp_path / "m.jsonl")
    obs.counters_reset()
    lg = obs.MetricsLogger(path, extra={"component": "probe"})
    with obs.active_logger(lg):
        obs.emit_step(0, loss=1.5, grad_norm=0.5)
        with obs.span("inside"):
            obs.record_transfer(100)
    obs.emit_step(1, loss=9.0)  # unbound: nothing written
    obs.log_counters(lg, phase="end")
    lg.close()
    recs = report.load_records(path)
    assert [list(r)[:4] for r in recs[:1]] == [["time", "t_unix",
                                                "component", "step"]]
    assert list(recs[0])[4:] == ["grad_norm", "loss"]
    assert recs[1]["span"] == "inside" and recs[1]["ctr_h2d_bytes"] == 100
    assert recs[2]["counters"] and recs[2]["h2d_transfers"] == 1
    assert len(recs) == 3


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with obs.profile_trace(str(tmp_path)):
        torch.ones(8) @ torch.ones(8)
    with open(tmp_path / "trace.json") as fh:
        assert "traceEvents" in json.load(fh)


def test_hyperband_search_records_match_jax(tmp_path, monkeypatch):
    """The adaptive search's controller: one record per scored trial with
    its bracket, one "search.round" span per round and one "fit" span,
    as dask_ml_tpu writes them for the same search (one device, fresh
    staging buffers: tests/test_torch_adaptive_search.py)."""
    from dask_ml_tpu import model_selection as JMS
    from dask_ml_tpu.models import sgd as JSGD
    from dask_ml_tpu.parallel import streaming as jstreaming
    from dask_ml_tpu_torch import model_selection as TMS
    from dask_ml_tpu_torch.models import sgd as TSGD

    monkeypatch.setattr(jstreaming, "_PUT_ALIASES", True)
    rng = np.random.RandomState(4)
    X = rng.randn(1500, 8).astype(np.float32)
    y = (X[:, 0] + 0.5 * rng.randn(1500) > 0).astype(np.float32)
    params = {"alpha": [1e-5, 1e-4, 1e-3], "eta0": [0.01, 0.05, 0.1]}

    def search(ms, sgd):
        return ms.HyperbandSearchCV(
            sgd.SGDClassifier(tol=1e-3, random_state=0), params, max_iter=9,
            aggressiveness=3, random_state=0)

    jp, tp = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    with jconfig.set(stream_mesh=1, metrics_path=jp), \
            use_mesh(device_mesh(devices=jax.devices()[:1])):
        search(JMS, JSGD).fit(X, y, classes=[0.0, 1.0])
    with config.set(metrics_path=tp):
        search(TMS, TSGD).fit(X, y, classes=[0.0, 1.0])

    def summary(path):
        recs = report.load_records(path)
        trials = [r for r in recs if r.get("component") == "adaptive_search"
                  and "model_id" in r]
        return (sorted((r["model_id"], r["partial_fit_calls"],
                        r["bracket"]) for r in trials),
                sum(r.get("span") == "search.round" for r in recs),
                [r["n_models"] for r in recs if r.get("span") == "fit"
                 and r.get("component") == "adaptive_search"],
                [tuple(r) for r in trials[:1]])

    got, ref = summary(tp), summary(jp)
    assert got == ref
    assert got[0] and got[1] > 1


def test_plan_programs_join_the_registry():
    """A plan's entry point (a GraphSet's run) is a tracked program: with
    obs_programs on, its calls and wall land in a row of its own with the
    JAX row's keys (on the CPU no graph is captured: no compiles)."""
    from dask_ml_tpu_torch.plans import ProgramPlan

    prog = ProgramPlan(name="t.obs_double", body=lambda p, x: x * p["w"],
                       key="t.obs_double").build()
    gs = prog.graphs({"w": np.float32(2.0)}, "cpu")
    _programs.programs_reset()
    try:
        gs.run((np.ones((4, 2), np.float32),))   # obs_programs off
        with config.set(obs_programs=True):
            for _ in range(3):
                out, _ = gs.run((np.ones((4, 2), np.float32),))
        rows = {r["program"]: r for r in obs.programs_snapshot()}
    finally:
        _programs.programs_reset()
    np.testing.assert_array_equal(out, np.full((4, 2), 2.0, np.float32))
    r = rows["t.obs_double"]
    assert r["calls"] == 3 and r["exec_s"] > 0 and r["compiles"] == 0
    assert "bound_s" not in r
    assert set(jreport.final_programs([{"programs": [r]}])[0]) == set(r)
