"""The port's telemetry exporters and performance manager against the JAX
package's: equal registries built in each package render byte-equal
Prometheus text, equal snapshots and byte-equal JSON dumps, and an HTTP
scrape of either server equals the render; equal span lists export equal
trace events; equal round timings give equal performance answers; and the
port's profiler control (``torch.profiler``) keeps the JAX manager's error
behaviour."""

import json
import math
import os
import urllib.request

import pytest

import torch_threads  # noqa: F401
from olearning_sim_tpu_torch import telemetry as ttel
from olearning_sim_tpu_torch.performancemgr import PerformanceManager as TPerf
from olearning_sim_tpu_torch.performancemgr import RoundTiming as TTiming
from olearning_sim_tpu_torch.telemetry import exporters as texp
from olearning_sim_tpu_torch.telemetry.tracing import Span as TSpan
from olearning_sim_tpu_torch.telemetry.tracing import SpanTracer as TTracer


def _jax():
    from olearning_sim_tpu import telemetry as jtel
    from olearning_sim_tpu.telemetry import exporters as jexp

    return jtel, jexp


ODD_LABELS = ["plain", 'quo"te', "back\\slash", "new\nline", "", "utf-8 é"]
VALUES = [0.0, 1.0, -2.5, 1e15, 1e-9, 123456789.0, float("inf"), float("-inf"),
          float("nan"), 0.1 + 0.2]


def build_registry(tel):
    """The same instruments, label sets and updates in either package."""
    reg = tel.MetricsRegistry()
    c = reg.counter("t_requests_total", "Requests by route", labels=("route",))
    for i, lab in enumerate(ODD_LABELS):
        c.labels(route=lab).inc(i + 1)
    g = reg.gauge("t_level", "A gauge of odd values", labels=("k", "slot"))
    for i, v in enumerate(VALUES):
        g.labels(k=ODD_LABELS[i % len(ODD_LABELS)], slot=str(i)).set(v)
    reg.gauge("t_unlabelled", "").set(7)
    h = reg.histogram("t_latency_seconds", "Latency", labels=("op",),
                      buckets=(0.001, 0.01, 0.1, 1.0, 10.0))
    for i, v in enumerate([0.0005, 0.002, 0.05, 0.5, 5.0, 50.0, 0.01, 1.0]):
        h.labels(op=ODD_LABELS[i % 3]).observe(v)
    h.labels(op="inf").observe(float("inf"))
    reg.histogram("t_empty", "No observations", labels=("op",))
    for name in ("ols_taskmgr_queue_depth", "ols_taskmgr_task_wait_seconds",
                 "ols_taskmgr_state_transitions_total", "ols_supervisor_resumes_total",
                 "ols_supervisor_lease_age_seconds", "ols_engine_round_duration_seconds"):
        tel.instrument(name, reg)
    reg.get("ols_taskmgr_queue_depth").set(3)
    reg.get("ols_taskmgr_task_wait_seconds").observe(0.75)
    reg.get("ols_taskmgr_state_transitions_total").labels(status="QUEUED").inc()
    reg.get("ols_supervisor_resumes_total").labels(task_id='t"1').inc()
    reg.get("ols_supervisor_lease_age_seconds").labels(task_id="t\n2").observe(12.0)
    return reg


def _scrape(port, path="/metrics"):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.read().decode(), r.headers["Content-Type"]


def test_render_is_byte_equal_to_jax():
    jtel, jexp = _jax()
    treg, jreg = build_registry(ttel), build_registry(jtel)
    text = texp.render_prometheus(treg)
    assert text == jexp.render_prometheus(jreg)
    assert 'le="+Inf"' in text and 't_level{k="utf-8 é",slot="5"} 123456789' in text
    assert 't_level{k="back\\\\slash",slot="8"} nan' in text
    assert 'route="quo\\"te"' in text and 'route="new\\nline"' in text
    assert 'route="back\\\\slash"' in text
    assert "t_level{k=\"plain\",slot=\"6\"} +Inf" in text
    assert "t_level{k=\"quo\\\"te\",slot=\"7\"} -Inf" in text
    # The +Inf bucket equals the count.
    assert 't_latency_seconds_bucket{op="plain",le="+Inf"} 3' in text
    assert 't_latency_seconds_count{op="plain"} 3' in text
    # An empty registry renders nothing in both.
    assert texp.render_prometheus(ttel.MetricsRegistry()) == "" == \
        jexp.render_prometheus(jtel.MetricsRegistry())


def test_snapshot_and_dump_json_equal_jax(tmp_path):
    jtel, jexp = _jax()
    treg, jreg = build_registry(ttel), build_registry(jtel)
    tsnap, jsnap = texp.snapshot(treg), jexp.snapshot(jreg)
    assert json.dumps(tsnap, sort_keys=True) == json.dumps(jsnap, sort_keys=True)
    values = [x["value"] for x in tsnap["t_level"]["series"]]
    assert sum(math.isnan(v) for v in values) == 1 and float("inf") in values
    tp = texp.dump_json(str(tmp_path / "port" / "m.json"), treg)
    jp = jexp.dump_json(str(tmp_path / "jax" / "m.json"), jreg)
    assert open(tp, "rb").read() == open(jp, "rb").read()


@pytest.mark.parametrize("server", ["port", "jax"])
def test_http_scrape_equals_render(server):
    jtel, jexp = _jax()
    treg = build_registry(ttel)
    cls = texp.MetricsHTTPServer if server == "port" else jexp.MetricsHTTPServer
    reg = treg if server == "port" else build_registry(jtel)
    with cls(reg, host="127.0.0.1", port=0) as srv:
        body, ctype = _scrape(srv.port)
        assert ctype == "text/plain; version=0.0.4; charset=utf-8"
        assert body == texp.render_prometheus(treg)
        body, ctype = _scrape(srv.port, "/metrics.json")
        assert ctype == "application/json"
        assert body == json.dumps(texp.snapshot(treg))
        with pytest.raises(urllib.error.HTTPError):
            _scrape(srv.port, "/nope")


def test_default_registry_renders_and_names_are_exported():
    for name in ("MetricsHTTPServer", "dump_json", "render_prometheus", "snapshot"):
        assert name in ttel.__all__ and getattr(ttel, name) is getattr(texp, name)
    assert isinstance(ttel.render_prometheus(), str)


def test_span_trace_events_equal_jax(tmp_path):
    from olearning_sim_tpu.telemetry.tracing import Span as JSpan
    from olearning_sim_tpu.telemetry.tracing import SpanTracer as JTracer

    specs = [("round.train", 1, None, 0.5, 0.25, 7, {"round_idx": 0}),
             ("round.train.select", 2, 1, 0.5001, 0.01, 7, {"phase": "select"}),
             ("round.evaluate", 3, None, 1.0, 0.125, 9, {})]
    tracers = []
    for tracer_cls, span_cls in ((TTracer, TSpan), (JTracer, JSpan)):
        tracer = tracer_cls()
        for name, sid, parent, start, dur, tid, attrs in specs:
            tracer._finish(span_cls(name=name, span_id=sid, parent_id=parent, start_s=start,
                                    duration_s=dur, thread_id=tid, attrs=dict(attrs)))
        tracers.append(tracer)
    t, j = tracers
    assert t.to_trace_events() == j.to_trace_events()
    assert t.to_trace_events(since_s=0.75) == j.to_trace_events(since_s=0.75)
    assert len(t.to_trace_events(since_s=0.75)) == 1
    assert t.to_perfetto_json() == j.to_perfetto_json()
    path = t.export(str(tmp_path / "d" / "spans.json"))
    assert json.load(open(path))["traceEvents"] == j.to_trace_events()
    assert 0.0 <= t.now()


def _timings(timing_cls):
    rows = []
    for r in range(6):
        rows.append(timing_cls(task_id="perf1", round_idx=r, operator="train",
                               duration_s=0.1 * (r + 1), num_clients=8, local_steps=2,
                               total_client_steps=13 + r,
                               extra={"stragglers": r % 2, "clipped": 1}))
        rows.append(timing_cls(task_id="perf1", round_idx=r, operator="evaluate",
                               duration_s=0.01))
    rows.append(timing_cls(task_id="perf1", round_idx=5, operator="convergence_eval",
                           duration_s=0.02, extra={"eval_acc": 0.5, "reached": 0.0,
                                                   "sim_s": 1.0, "wall_s": 2.0}))
    return rows


def test_performance_answers_equal_jax():
    from olearning_sim_tpu.performancemgr import PerformanceManager as JPerf
    from olearning_sim_tpu.performancemgr import RoundTiming as JTiming
    from olearning_sim_tpu.resilience import ResilienceLog as JLog

    from olearning_sim_tpu_torch.resilience import ResilienceLog as TLog

    jtel, _ = _jax()
    tperf = TPerf(registry=ttel.MetricsRegistry(), resilience_log=TLog())
    jperf = JPerf(registry=jtel.MetricsRegistry(), resilience_log=JLog())
    for perf, cls in ((tperf, TTiming), (jperf, JTiming)):
        for row in _timings(cls):
            perf.record_round(row)
        with perf.time_round("perf2", 0, "train", num_clients=4, local_steps=1) as timer:
            timer.note(dropped=2)
    assert tperf.get_performance("perf1") == jperf.get_performance("perf1")
    assert tperf.get_performance("ghost") == jperf.get_performance("ghost")
    assert tperf.list_tasks() == jperf.list_tasks() == ["perf1", "perf2"]
    assert tperf.get_performance("perf2")["dropped_total"] == 2
    # The round histograms hold the same counts (perf2's wall time differs).
    ts, js = tperf.metrics_snapshot(), jperf.metrics_snapshot()
    key = "ols_engine_round_duration_seconds"
    assert ([(s["labels"], s["count"]) for s in ts[key]["series"]]
            == [(s["labels"], s["count"]) for s in js[key]["series"]])
    assert tperf.render_metrics() == texp.render_prometheus(tperf.registry)
    assert json.loads(tperf.render_metrics("json")) == json.loads(
        json.dumps(texp.snapshot(tperf.registry)))


def test_performance_rehydrates_from_a_sqlite_repo(tmp_path):
    from olearning_sim_tpu.performancemgr.performance_manager import PERF_COLUMNS as JCOLS
    from olearning_sim_tpu.performancemgr import PerformanceManager as JPerf
    from olearning_sim_tpu.performancemgr import RoundTiming as JTiming
    from olearning_sim_tpu.utils.repo import SqliteTableRepo as JSqlite

    from olearning_sim_tpu_torch.performancemgr.performance_manager import PERF_COLUMNS
    from olearning_sim_tpu_torch.utils.repo import SqliteTableRepo

    assert PERF_COLUMNS == JCOLS
    path = str(tmp_path / "perf.db")
    writer = JPerf(repo=JSqlite(path, "perf", JCOLS), registry=_jax()[0].MetricsRegistry())
    for row in _timings(JTiming):
        writer.record_round(row)
    reader = TPerf(repo=SqliteTableRepo(path, "perf", PERF_COLUMNS),
                   registry=ttel.MetricsRegistry())
    fresh = JPerf(repo=JSqlite(path, "perf", JCOLS), registry=_jax()[0].MetricsRegistry())
    got = reader.get_performance("perf1")
    assert got["rounds_recorded"] == 6
    got.pop("resilience")
    want = fresh.get_performance("perf1")
    want.pop("resilience")
    assert got == want


def test_profiler_trace_and_runner_spans(tmp_path):
    import torch

    tracer = TTracer()
    perf = TPerf(registry=ttel.MetricsRegistry(), tracer=tracer)
    with tracer.span("round.before"):
        pass
    assert perf.stop_trace() is None
    assert perf.start_trace(str(tmp_path / "tr"))
    assert not perf.start_trace(str(tmp_path / "other"))  # one trace at a time
    with tracer.span("round.train", round_idx=0):
        x = torch.ones(64, 64)
        (x @ x).sum()
    out = perf.stop_trace()
    assert out == str(tmp_path / "tr")
    trace = json.load(open(os.path.join(out, TPerf.TRACE_FILE)))
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    spans = json.load(open(os.path.join(out, TPerf.RUNNER_SPAN_FILE)))["traceEvents"]
    assert [e["name"] for e in spans] == ["round.train"]  # only the window's
    assert perf.stop_trace() is None


def test_runner_spans_share_the_profiler_clock(tmp_path):
    """The span file's ``ts`` is on the profiler file's time base: a
    ``record_function`` opened inside a span lies inside it in the two
    exported files, within 100 us."""
    import torch
    from torch.profiler import record_function

    tracer = TTracer()
    perf = TPerf(registry=ttel.MetricsRegistry(), tracer=tracer)
    assert perf.start_trace(str(tmp_path / "tr"))
    with tracer.span("round.probe_holder"):
        with record_function("probe"):
            x = torch.ones(64, 64)
            (x @ x).sum()
    out = perf.stop_trace()
    events = json.load(open(os.path.join(out, TPerf.TRACE_FILE)))["traceEvents"]
    (probe,) = [e for e in events if e.get("name") == "probe" and e.get("ph") == "X"]
    (span,) = json.load(open(os.path.join(out, TPerf.RUNNER_SPAN_FILE)))["traceEvents"]
    assert span["ts"] - 100 <= probe["ts"]
    assert probe["ts"] + probe["dur"] <= span["ts"] + span["dur"] + 100


def test_profiler_start_that_raises_leaves_the_manager_rearmable(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    perf = TPerf(registry=ttel.MetricsRegistry(), tracer=TTracer())
    with pytest.raises(OSError):
        perf.start_trace(str(blocker / "sub"))  # a logdir under a file
    assert perf.start_trace(str(tmp_path / "ok"))
    assert perf.stop_trace() == str(tmp_path / "ok")


def test_runner_convergence_rows_reach_the_performance_answer():
    """The port runner records a convergence_eval timing row per eval point,
    as the JAX runner does, so get_performance()["convergence"] answers."""
    import jax

    from test_torch_convergence import _convergence_task

    from olearning_sim_tpu.engine.task_bridge import build_runner_from_taskconfig as jbuild
    from olearning_sim_tpu.parallel.mesh import make_mesh_plan
    from olearning_sim_tpu.performancemgr import PerformanceManager as JPerf
    from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig

    jtel, _ = _jax()
    answers = {}
    for label in ("jax", "port"):
        task = _convergence_task(f"conv_perf_{label}", target_accuracy=0.05)
        if label == "jax":
            perf = JPerf(registry=jtel.MetricsRegistry())
            runner = jbuild(task, plan=make_mesh_plan(devices=jax.devices()[:1]), perf=perf,
                            registry=jtel.MetricsRegistry())
        else:
            perf = TPerf(registry=ttel.MetricsRegistry())
            runner = build_runner_from_taskconfig(task, perf=perf,
                                                  registry=ttel.MetricsRegistry(), device="cpu")
        runner.run()
        answers[label] = perf.get_performance(task["task_id"])
    t, j = answers["port"], answers["jax"]
    assert (t["rounds_recorded"], t["operator_executions"]) == \
        (j["rounds_recorded"], j["operator_executions"]) == (6, 12)
    tc, jc = t["convergence"], j["convergence"]
    assert sorted(tc) == sorted(jc)
    assert [p["round"] for p in tc["series"]] == [p["round"] for p in jc["series"]] == [1, 3, 5]
    for k in ("evals", "reached", "target_accuracy", "rounds_to_target"):
        assert tc[k] == jc[k], k
    assert tc["reached"] and tc["rounds_to_target"] == 2.0
