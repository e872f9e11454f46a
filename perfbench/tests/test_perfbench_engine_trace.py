"""``perfbench/engine_trace.py``: the harness's window with the engine's
observer traced, on the CPU at tiny sizes, and its readers on a record
built by hand that carries device spans and a profiler trace."""
import time

import pytest
import torch

from perfbench import engine_trace


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", ["dense.tiny", "moe.tiny"])
def test_traced_tiny_run_reads_the_engine(tiny, cell):
    """A traced run stays correct and reads the engine's spans: host self
    time a step and by span, the routing counts in the MoE cell; no
    device idle share on the CPU, which records no device span."""
    line, info, rec = engine_trace.run(
        tiny, cell, 1234567890123, 1.0, True, time.perf_counter(),
        device="cpu", chips_check=False)
    assert line["correct"], (line, info)
    suffix = "batch" if cell == "dense.tiny" else "rate"
    m = line["metrics"]
    assert f"engine_idle_pct.{suffix}" not in m
    assert engine_trace.engine_idle_pct(rec) is None
    assert 0 < m[f"host_self_ms.{suffix}"]["value"]
    by = info["host_self_ms_by_span"]
    assert {"step", "plan", "stage", "emit", "wait:sync",
            "replay:decode"} <= set(by)
    assert sum(by.values()) == pytest.approx(
        engine_trace.host_self_ms(rec)
        + by["wait:sync"] + by.get("wait:stage", 0.0), rel=1e-6)
    assert info["idle_gaps_program"]
    c = info["moe_choices"]
    if cell == "moe.tiny":
        assert c["kept"] + c["dropped"] == c["real"] > 0
        fill = m["expert_fill_pct.rate"]["value"]
        assert fill == pytest.approx(100 * c["kept"] / c["capacity_rows"])
        assert 0 < fill <= 100
    else:
        assert c is None and "expert_fill_pct.batch" not in m


def test_untraced_observer_adds_nothing(tiny):
    """``--observer null`` runs the engine as ``perfbench/run.py`` does:
    no engine record, no new metric."""
    line, info, rec = engine_trace.run(
        tiny, "moe.tiny", 987654321987, 1.0, True, time.perf_counter(),
        observer="null", judge=False, device="cpu", chips_check=False)
    assert "engine" not in rec and line["correct"] is None
    assert not {k for k in line["metrics"]
                if k.split(".")[0] in engine_trace.NEW_METRICS}
    assert info["host_self_ms_by_span"] is None


def _b(name, t, **args):
    return {"ph": "B", "name": name, "ts": t * 1e6, "tid": 0,
            "args": args}


def _e(name, t):
    return {"ph": "E", "name": name, "ts": t * 1e6, "tid": 0, "args": {}}


def _x(name, t, dur, step):
    return {"ph": "X", "name": name, "ts": t * 1e6, "dur": dur * 1e6,
            "tid": 1, "args": {"step": step}}


def _record():
    """Two unprofiled steps (90 ms holding a 30-ms wait and 60 ms of
    device time; 80 ms, 20 ms, 40 ms) and a profiled one whose decode
    replay's 50-ms event span holds 30 ms of kernels."""
    ev = [_b("step", 1.0001, step=1), _b("wait", 1.05, step=1, on="sync"),
          _e("wait", 1.08), _e("step", 1.0901),
          _x("decode", 1.01, 0.06, 1),
          _b("step", 1.2001, step=2), _b("wait", 1.25, step=2, on="sync"),
          _e("wait", 1.27), _e("step", 1.2801),
          _x("decode", 1.21, 0.04, 2),
          _b("step", 3.0001, step=3),
          _b("replay", 3.004, step=3, exec="decode"), _e("replay", 3.007),
          _e("step", 3.0999),
          _x("decode", 3.01, 0.05, 3)]
    trace = [("perfbench.step", False, 3.0e6, 3.1e6),
             ("cudaGraphLaunch", False, 3.005e6, 3.0051e6),
             ("k1", True, 3.01e6, 3.03e6), ("k2", True, 3.05e6, 3.06e6)]
    return {"loop": "backlog",
            "steps": [{"t0": 1.0, "t1": 1.1, "profiled": False},
                      {"t0": 1.2, "t1": 1.3, "profiled": False},
                      {"t0": 3.0, "t1": 3.1, "profiled": True}],
            "engine": {"events": ev, "t0": 0.0,
                       # the profiler's clock runs 1 us fast over 8 s
                       "anchors": [(0.0, 0), (2.0, 2_000_000_000),
                                   (10.0, 10_000_001_000)],
                       "trace": trace, "trace_start_ns": 0,
                       "moe": [dict(real=10, kept=8, dropped=2,
                                    capacity_rows=40),
                               dict(real=110, kept=98, dropped=12,
                                    capacity_rows=240)]}}


def test_readers_on_a_record_with_device_spans():
    rec = _record()
    assert engine_trace.engine_idle_pct(rec) == pytest.approx(
        100 * (1 - 0.1 / 0.17))
    assert engine_trace.host_self_ms(rec) == pytest.approx(60.0)
    assert engine_trace.moe_choices(rec) == dict(
        real=100, kept=90, dropped=10, capacity_rows=200)
    assert engine_trace.expert_fill_pct(rec) == pytest.approx(45.0)
    by = engine_trace.host_self_ms_by_span(rec)
    assert by == pytest.approx({"step": 60.0, "wait:sync": 25.0})
    gaps = engine_trace.idle_gaps_program(rec)
    assert [g[0] for g in gaps] == ["step", "step", "outside the engine"]
    assert [g[1] for g in gaps] == pytest.approx([0.04, 0.02, 0.01],
                                                 abs=1e-5)
    assert engine_trace.device_ms_by_exec(rec) == {"decode": {
        "unprofiled": pytest.approx(50.0), "profiled": pytest.approx(50.0),
        "calls": [2, 1]}}
    rv = engine_trace.replay_vs_kernels(rec)["decode"]
    assert rv["calls"] == 1
    assert rv["event_ms"] == pytest.approx(50.0, abs=1e-3)
    assert rv["kernel_union_ms"] == pytest.approx(30.0, abs=1e-3)
    assert rv["gap_pct"] == pytest.approx(40.0, abs=1e-2)
    assert rv["first_kernel_us_median"] == pytest.approx(0.0, abs=1.0)
    a = engine_trace.anchors(rec)
    assert (a["replay_spans"], a["holding_a_launch"],
            a["start_before_first_kernel"]) == (1, 1, 1)
    assert a["launch_offset_us_median"] == pytest.approx(1000.0, abs=1.0)
    assert a["drift_us"] == pytest.approx(1.0, abs=1e-3)


def test_readers_without_a_profile_or_engine_record():
    rec = _record()
    del rec["engine"]["trace"]
    assert engine_trace.idle_gaps_program(rec) is None
    assert engine_trace.replay_vs_kernels(rec) is None
    assert engine_trace.anchors(rec)["drift_us"] == pytest.approx(1.0,
                                                                  abs=1e-3)
    del rec["engine"]
    for read in (engine_trace.engine_idle_pct, engine_trace.host_self_ms,
                 engine_trace.expert_fill_pct, engine_trace.device_ms_by_exec,
                 engine_trace.host_self_ms_by_span):
        assert read(rec) is None
