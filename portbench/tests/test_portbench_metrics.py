"""The benchmark's trace arithmetic and metric readers, on synthetic
event lists and counts (CPU only)."""

from __future__ import annotations

import json
import os

import pytest

from portbench import devtrace, harness, peaks
from portbench.devtrace import Trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TRACER = "void (anonymous namespace)::trace_kernel<false, false, false>(P)"
BLUR = "void (anonymous namespace)::dof_blur_tiles<64, 32>(F)"
COPY = "Memcpy DtoH (Device -> Pinned)"
GLUE = "void at::native::vectorized_elementwise_kernel<2, add>(int)"


def _trace():
    """Two steps: glue 0-20, tracer 30-130, blur 130-140, readback
    150-200; then glue 300-320, tracer 325-425, blur 425-435, readback
    440-490, with a glue kernel overlapping the first readback."""
    dev = []
    for t in (0.0, 300.0):
        g_end = t + 20.0
        tr0 = t + (30.0 if t == 0.0 else 25.0)
        dev += [(GLUE, t, g_end), (TRACER, tr0, tr0 + 100.0),
                (BLUR, tr0 + 100.0, tr0 + 110.0)]
        c0 = tr0 + (120.0 if t == 0.0 else 115.0)
        dev.append((COPY, c0, c0 + 50.0))
    dev.append((GLUE, 160.0, 170.0))
    host = [("portbench.issue", 0.0, 300.0),
            ("aten::copy_", 200.0, 260.0),
            ("portbench.inputs", 270.0, 300.0)]
    return Trace(device=dev, host=host, steps=2)


def _run(trace=None, counted=None):
    steps = [harness.Step(j=j, t_issue=0.01 * j, t_ret=0.01 * j + 0.002,
                          t_land=0.01 * j + 0.004 + 0.001 * (j % 5),
                          profiled=1 if j in (3, 4) else 0)
             for j in range(100)]
    return harness.Run(steps=steps, t0=0.0, t_end=1.05, setup_s=7.5,
                       width=1920, height=1080, trace=trace,
                       counted=counted)


def _read(name, run):
    return harness.metric_reader(name).read(run)


def test_kinds():
    assert [devtrace.kind(n) for n in (TRACER, BLUR, COPY, GLUE)] == [
        devtrace.TRACER, devtrace.BLUR, devtrace.READBACK, devtrace.GLUE]
    assert devtrace.kind("Memcpy HtoD (Pageable -> Device)") == devtrace.GLUE


def test_busy_union_and_gaps():
    spans = [(0, 10), (5, 20), (30, 40), (40, 45), (50, 60), (52, 55)]
    assert devtrace.busy_us(spans) == 20 + 15 + 10
    assert devtrace.idle_gaps(spans) == [(20, 30), (45, 50)]
    assert devtrace.busy_us([]) == 0.0


def test_device_readers():
    run = _run(_trace())
    assert _read("tracer_ms", run) == pytest.approx(0.1)
    assert _read("readback_ms", run) == pytest.approx(0.05)
    # glue: 20 + 20 + the 10 us kernel beside the readback, a step
    assert _read("glue_device_ms", run) == pytest.approx(0.025)
    # span 0-490; busy 0-20, 30-140, 150-200, 300-320, 325-435, 440-490
    busy = 20 + 110 + 50 + 20 + 110 + 50
    assert _read("idle_pct", run) == pytest.approx(100 * (1 - busy / 490))
    value, extra = _read("blur_roofline", run)
    bound = (12 * 1920 * 1080 + 64 * 1920) / 3.35e12 * 1e3
    assert value == pytest.approx(100 * 2 * bound / 0.020)
    assert extra == {"bound_by": "bytes"}


def test_tracer_roofline_reads_the_counted_frames():
    counts = {"steps": 50_000_000, "segments": 5_000_000,
              "sphere_tests": 50_000_000, "sphere_near": 50_000}
    ops = 26 * 50e6 + 140 * 5e6 + 27 * 50e6 + 21 * 50e3
    run = _run(_trace(), {"counts": counts, "parity": False, "frames": 1,
                          "rays": 1920 * 1080})
    value, extra = _read("tracer_roofline", run)
    # the first profiled step's tracer launch: 100 us
    assert value == pytest.approx(100 * (ops / 67e12 * 1e3) / 0.1)
    assert extra == {"bound_by": "operations"}


def test_trace_bound():
    ms, side, n_ops = peaks.trace_bound_ms(
        {"steps": 10, "segments": 2, "slot_tests": 4, "slot_hits": 1},
        True, 1000)
    assert n_ops == 10 * 15 + 2 * 200 + 4 * 15 + 29
    assert side == "bytes" and ms == pytest.approx(36 * 1000 / 3.35e12 * 1e3)
    ms, side, _ = peaks.trace_bound_ms({"steps": 10 ** 9}, False, 1000)
    assert side == "operations" and ms == pytest.approx(26e9 / 67e12 * 1e3)


def test_host_readers():
    run = _run()
    assert _read("step_ms", run) == pytest.approx(10.5)
    lat = sorted(4.0 + (j % 5) for j in range(100))
    assert _read("step_p95_ms", run) == pytest.approx(lat[94] + 0.05 *
                                                      (lat[95] - lat[94]))
    assert _read("host_issue_ms", run) == pytest.approx(2.0)
    assert _read("setup_s", run) == 7.5


def test_readers_without_a_trace_read_nothing():
    run = _run()
    for name in ("glue_device_ms", "tracer_ms", "tracer_roofline",
                 "blur_roofline", "idle_pct", "readback_ms"):
        assert _read(name, run) is None
    run = _run(Trace(device=[(GLUE, 0.0, 5.0)], host=[], steps=1))
    for name in ("tracer_ms", "tracer_roofline", "blur_roofline",
                 "readback_ms"):
        assert _read(name, run) is None


def test_top_ops_and_gaps():
    t = _trace()
    ops = t.top_ops()
    assert ops[0][0] == TRACER and ops[0][1] == pytest.approx(200e-6)
    gaps = t.top_gaps()
    # the longest gap, 200-300, has aten::copy_ at its midpoint 250
    assert gaps[0][0] == "aten::copy_"
    assert gaps[0][1] == pytest.approx(100e-6)
    assert len(gaps) == 5


def test_every_metric_has_a_reader():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.metric_reader(m["name"]).read)
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
