"""PyTorch port, the observability seam (``repro_torch.obs``) and what the
serving engine reports through it: the ``step`` span and the spans inside
it, self times, the MoE routing counts, device spans from CUDA events
(here on a fake device clock), and the tracer's anchors onto
``torch.profiler``'s clock.  Tracing must not change what the engine
serves; without it the engine holds no event and no accumulator."""
import inspect

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, shrink
from repro_torch.core.famous import FamousConfig
from repro_torch.models import module, moe, transformer
from repro_torch.obs import trace
from repro_torch.obs.metrics import validate_prometheus_text
from repro_torch.obs.runtime import NULL_OBSERVER, NullObserver, Observer
from repro_torch.serve import graphs
from repro_torch.serve.engine import Request, ServingEngine

CFGS = {"dense": ("qwen2-7b", dict(num_heads=4, num_kv_heads=2,
                                    head_dim=8)),
        "moe": ("grok-1-314b", {})}
MODES = {"chunked": {}, "speculative": dict(speculative=True, draft_k=2),
         "paged": dict(cache_kind="paged", page_size=8, prefix_cache=True)}
STEP_CHILDREN = {"plan", "stage", "prefill_chunk", "decode", "verify",
                 "emit"}
PHASE_CHILDREN = {"stage", "replay", "wait"}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch):
    name, over = CFGS[arch]
    cfg = shrink(get_config(name), **over)
    gen = torch.Generator().manual_seed(0)
    return cfg, module.init_params(transformer.model_spec(cfg), gen,
                                   torch.float32, "cpu")


def _serve(arch, observer, mode="chunked", n_slots=3):
    cfg, params = _setup(arch)
    eng = ServingEngine(params, cfg, FamousConfig(impl="pallas"),
                        n_slots=n_slots, max_seq=64, chunk=8, device="cpu",
                        observer=observer, **MODES[mode])
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, tokens=[int(t) for t in
                                   rng.integers(0, cfg.vocab_size, n)],
                    max_new=6, **(dict(temperature=0.9, top_k=5, seed=7)
                                  if i % 2 else {}))
            for i, n in enumerate((5, 13, 20, 1))]
    # a repetitive prompt gives the drafter hits
    reqs.append(Request(rid=9, tokens=[3, 4, 5] * 4, max_new=6))
    done = eng.run(reqs)
    return eng, {r.rid: list(r.out) for r in done}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", list(CFGS))
def test_traced_engine_serves_the_same_tokens(arch, mode):
    """An engine whose observer traces serves token for token what one on
    ``NULL_OBSERVER`` serves (greedy and seeded requests)."""
    _, want = _serve(arch, NULL_OBSERVER, mode)
    _, got = _serve(arch, Observer(trace=True), mode)
    assert got == want


@pytest.mark.parametrize("mode", ["chunked", "speculative"])
def test_step_span_nests_its_children(mode):
    """Every ``step`` span holds ``plan``, then chunks, the decode or
    verify phase and ``emit``; each phase holds ``stage``, ``replay`` and
    (decode, verify) the step's one ``wait``; the trace stays balanced,
    and a span's self time is its duration less its children's."""
    obs = Observer(trace=True)
    eng, _ = _serve("dense", obs, mode)
    tr = obs.tracer
    assert tr.balanced and tr.dropped == 0
    sp = trace.spans(tr.events)
    own = trace.self_times(sp)
    steps = [i for i, s in enumerate(sp) if s["name"] == "step"]
    assert len(steps) == obs.step > 0
    kids = {i: [] for i in range(len(sp))}
    for i, s in enumerate(sp):
        if s["parent"] is not None:
            kids[s["parent"]].append(i)
    phase = "verify" if mode == "speculative" else "decode"
    for i in steps:
        assert sp[i]["parent"] is None
        names = [sp[k]["name"] for k in kids[i]]
        assert names[0] == "plan" and set(names) <= STEP_CHILDREN
        assert (phase in names) == ("emit" in names)
        for k in kids[i]:
            if sp[k]["name"] in ("prefill_chunk", phase):
                sub = [sp[j]["name"] for j in kids[k]]
                assert set(sub) <= PHASE_CHILDREN and "replay" in sub
                assert sub.count("wait") == (sp[k]["name"] == phase)
    for i, s in enumerate(sp):
        assert s["end"] >= s["ts"]
        want = (s["end"] - s["ts"]) - sum(sp[k]["end"] - sp[k]["ts"]
                                         for k in kids[i])
        assert own[i] == pytest.approx(want, abs=1e-6)
    replays = {s["args"]["exec"] for s in sp if s["name"] == "replay"}
    assert {"prefill", phase, "sample", "clear"} <= replays


def test_self_times_of_a_known_trace():
    ev = [{"ph": "B", "name": "step", "ts": 0.0, "args": {}},
          {"ph": "B", "name": "plan", "ts": 1.0, "args": {}},
          {"ph": "E", "name": "plan", "ts": 3.0, "args": {}},
          {"ph": "X", "name": "decode", "ts": 2.0, "dur": 50.0, "tid": 1,
           "args": {}},
          {"ph": "B", "name": "decode", "ts": 4.0, "args": {}},
          {"ph": "B", "name": "wait", "ts": 5.0, "args": {}},
          {"ph": "E", "name": "wait", "ts": 9.0, "args": {}},
          {"ph": "E", "name": "decode", "ts": 10.0, "args": {}},
          {"ph": "E", "name": "step", "ts": 12.0, "args": {}},
          {"ph": "B", "name": "step", "ts": 13.0, "args": {}}]
    sp = trace.spans(ev)
    assert [s["name"] for s in sp] == ["step", "plan", "decode", "wait"]
    assert [s["parent"] for s in sp] == [None, 0, 0, 2]
    assert trace.self_times(sp) == [12.0 - 2.0 - 6.0, 2.0, 6.0 - 4.0, 4.0]


def test_moe_counts_equal_a_plain_count_of_router_dispatch():
    """``count_routing`` inside ``apply_moe``: the real rows' choices,
    kept and dropped as ``router_dispatch`` routed them, idle rows left
    out, capacity rows G*E*C; the layer's output bit-equal without it."""
    cfg, params = _setup("moe")
    p = transformer.prepare_params(params, cfg)["layers"][0]["ffn"]
    K = cfg.experts_per_token
    gen = torch.Generator().manual_seed(3)
    # rows alike, so their choices crowd two experts past capacity
    x = (torch.randn(cfg.d_model, generator=gen)
         + 0.1 * torch.randn(2, 24, cfg.d_model, generator=gen))
    rows = torch.rand(48, generator=gen) < 0.6
    acc = torch.zeros(4, dtype=torch.int64)
    y = moe.apply_moe(p, x, cfg, counts=(acc, rows))
    assert torch.equal(y, moe.apply_moe(p, x, cfg))
    G, Sg = moe._group_shape(48)
    dispatch, _, _ = moe.router_dispatch(
        moe._router_logits(p, x.reshape(G, Sg, -1)), K,
        cfg.capacity_factor, cfg.logit_softcap)
    per_row = dispatch.reshape(48, -1).sum(-1).tolist()
    real = K * int(rows.sum())
    kept = int(sum(k for k, r in zip(per_row, rows.tolist()) if r))
    E, C = dispatch.shape[2:]
    assert acc.tolist() == [real, kept, real - kept, G * E * C]
    assert 0 < kept < real        # this draw drops choices of real rows
    everything = torch.zeros(4, dtype=torch.int64)
    moe.apply_moe(p, x, cfg, counts=(everything, torch.ones(48, dtype=bool)))
    assert everything[0] == K * 48 > acc[0]


def test_engine_routing_counts_follow_its_steps():
    """An MoE engine that traces counts every real row of each chunk
    (``n``) and decode step (the decoding slots, idle slots left out) in
    every layer; kept + dropped = real; pulled into the Prometheus
    counters."""
    obs = Observer(trace=True)
    eng, _ = _serve("moe", obs, n_slots=4)
    cfg = eng.cfg
    c = obs.routing()
    sp = trace.spans(obs.tracer.events)
    rows = sum(s["args"]["n"] for s in sp if s["name"] == "prefill_chunk")
    rows += sum(s["args"]["slots"] for s in sp if s["name"] == "decode")
    assert any(s["args"]["slots"] < eng.n_slots for s in sp
               if s["name"] == "decode")
    assert c["real"] == cfg.experts_per_token * cfg.num_layers * rows
    assert c["kept"] + c["dropped"] == c["real"] and c["dropped"] > 0
    text = obs.prometheus_text()
    validate_prometheus_text(text)
    assert f'repro_moe_choices_total{{outcome="kept"}} {c["kept"]}' in text
    assert f"repro_moe_capacity_rows_total {c['capacity_rows']}" in text


@pytest.mark.parametrize("observer", [None, NULL_OBSERVER,
                                      Observer(trace=False)])
def test_an_engine_that_does_not_trace_holds_no_event_or_count(observer):
    cfg, params = _setup("moe")
    eng = ServingEngine(params, cfg, FamousConfig(impl="pallas"),
                        n_slots=2, max_seq=64, chunk=8, device="cpu",
                        observer=observer)
    assert eng._timer is None and eng._moe_counts is None
    assert (observer or NULL_OBSERVER).routing() == {}


def test_null_observer_mirrors_every_hook():
    """``NullObserver`` has every public method of ``Observer``, with the
    same parameters, so an engine can call any hook on either."""
    for name, fn in inspect.getmembers(Observer, inspect.isfunction):
        if name.startswith("_") or name in ("snapshot", "prometheus_text",
                                            "trace_json", "write_trace"):
            continue
        null = getattr(NullObserver, name)
        want = list(inspect.signature(fn).parameters)
        got = list(inspect.signature(null).parameters)
        assert got == want, name


class _FakeEvent:
    """A CUDA event on a fake device clock (ms): recorded at the clock's
    value then."""
    clock = [0.0]
    made = [0]

    def __init__(self, **kw):
        self.t = None
        _FakeEvent.made[0] += 1

    def record(self, stream=None):
        self.t = _FakeEvent.clock[0]

    def elapsed_time(self, end):
        return end.t - self.t


def test_exec_timer_reads_pairs_after_the_sync(monkeypatch):
    """``ExecTimer``: each pair is handed over at the next ``synced`` and
    not before, with its duration and its start on the host clock (the
    anchor's host time plus the device time since the anchor); read
    events are reused."""
    monkeypatch.setattr(graphs.torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(graphs.torch.cuda, "current_stream",
                        lambda device=None: None)
    host = [100.0]
    monkeypatch.setattr(graphs, "now", lambda: host[0])
    obs = Observer(trace=True)
    got = []
    monkeypatch.setattr(obs, "device_span",
                        lambda name, t, s, **a: got.append((name, t, s, a)))
    timer = graphs.ExecTimer("cpu", obs)
    clock = _FakeEvent.clock
    clock[0] = 5.0                    # the first anchor: device 5 ms,
    start = timer.start()             # host 100 s
    clock[0] = 9.0
    timer.stop("prefill", 1, start)
    clock[0] = 10.0
    start = timer.start()
    clock[0] = 12.5
    timer.stop("decode", 1, start)
    assert got == []
    host[0] = 101.0
    clock[0] = 20.0
    timer.synced()                    # reads both, anchors at device 20
    assert got == [("prefill", 100.0, 0.004, {"step": 1}),
                   ("decode", 100.005, 0.0025, {"step": 1})]
    made = _FakeEvent.made[0]
    for step in (2, 3):
        clock[0] += 1.0
        start = timer.start()
        clock[0] += 3.0
        timer.stop("decode", step, start)
        timer.synced()
    assert got[2] == ("decode", pytest.approx(101.001), pytest.approx(0.003),
                      {"step": 2})
    assert _FakeEvent.made[0] == made


def test_device_spans_land_on_the_device_track():
    obs = Observer(trace=True)
    obs.on_step(0, 1)
    with obs.span("step"):
        obs.device_span("decode", obs.tracer.t0 + 0.5, 0.002, step=1)
    out = obs.trace_json()
    x = [e for e in out["traceEvents"] if e["ph"] == "X"]
    assert x == [{"name": "decode", "ph": "X", "ts": 5e5,
                  "dur": pytest.approx(2e3), "pid": 0, "tid": trace.DEVICE,
                  "args": {"step": 1}}]
    names = {e["tid"]: e["args"]["name"] for e in out["traceEvents"]
             if e["ph"] == "M"}
    assert set(names) == {trace.HOST, trace.DEVICE}
    assert len(out["otherData"]["anchors"]) == 1


def test_profiler_ns_takes_the_drift_out():
    """Between two anchors the mapping is linear: a clock that runs 1e-4
    fast against ``now`` maps both anchors exactly and the midpoint
    between them."""
    anchors = [(10.0, 1_000_000_000), (20.0, 11_000_001_000)]
    assert trace.profiler_ns(anchors, 10.0) == 1_000_000_000
    assert trace.profiler_ns(anchors, 20.0) == 11_000_001_000
    assert trace.profiler_ns(anchors, 15.0) == pytest.approx(6_000_000_500)
    assert trace.profiler_ns(anchors[:1], 11.0) == 2_000_000_000
    assert trace.profiler_ns(anchors, 25.0) == pytest.approx(16_000_001_500)


def test_tracer_span_and_profiler_mark_map_together():
    """A Tracer span and a ``torch.profiler.record_function`` mark opened
    back to back land within 100 us of each other on the profiler's
    timeline, through the tracer's anchors."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):   # the first mark's set-up
            pass
        tr = trace.Tracer()
        tr.anchor()
        for i in range(8):
            with tr.span(f"mark{i}"), record_function(f"mark{i}"):
                sum(range(1000))
        tr.anchor()
    marks = {e.name(): e.start_ns()
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("mark")}
    spans = {s["name"]: tr.profiler_ns(s["ts"])
             for s in trace.spans(tr.events)}
    assert set(marks) == set(spans) and len(marks) == 8
    # the median: one mark may lose the core to another process
    gaps = sorted(abs(ns - marks[name]) for name, ns in spans.items())
    assert gaps[len(gaps) // 2] < 100e3, gaps
