"""One run of one cell: set-up, the measured window, the traced
sub-window, the comparison with the reference, and the result line.

Everything a cell needs is found by name (``BENCHMARK.json`` at the
checkout's root names the cell's configuration and traffic mix):

- ``perfbench/configs/<config>.json``: the model's sizes and type (see
  ``model_config``), and, under the optional key ``"reference"``, the name
  of its model module;
- ``perfbench/reference/<reference>.py``: the model module, ``model.py``
  where the file names none: the layout of the weights drawn from the
  seed, the plain reference that decides ``correct``, the operations and
  bytes the per-layer readers count, and the configuration keys the port
  names otherwise or does not take (``perfbench/reference/__init__.py``
  lists what it defines);
- ``perfbench/traffic/<traffic>.json``: the mix (``perfbench/traffic.py``);
- ``perfbench/cells/<cell>.json``: the limits of the numbers compared,
  with the readings they were set from;
- ``perfbench/end_to_end/<metric>.py`` and ``perfbench/metrics/<metric>.py``:
  one reader a metric, ``read(record) -> float | None``.

The window drives ``ServingEngine.add_request`` and ``ServingEngine.step``
(on CUDA graphs, as served): the harness enqueues each request at its due
time through ``engine.sched``, admits what the free slots take, steps, and
waits for the next arrival when there is nothing to do.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from perfbench import devtrace, observe, readers, reference, traffic, weights
from perfbench.reference import check

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
DRAIN_S = 60.0
# the traced sub-window: the window's last seconds, at least this many
# engine steps
PROFILE_S = 4.0
PROFILE_STEPS = 10


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that no run may hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def find_cell(root: Path, workload: str) -> tuple[dict, dict, dict]:
    """(BENCHMARK.json, the cell's workload entry, its configs entry)."""
    bench = load_json(root / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return bench, cell, conf


def reader(root: Path, kind: str, name: str):
    """``read`` of ``perfbench/<kind>/<name>.py``."""
    path = root / "perfbench" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name}".replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def model_config(conf_file: dict, mod):
    """The port's ModelConfig of a configuration file: the registry's
    config of ``registry_id`` with the file's sizes, named as the model
    module ``mod`` maps them.  A size that differs from the registry's
    must be listed in ``reduced``."""
    from repro_torch.configs.base import get_config

    base = get_config(conf_file["registry_id"])
    names = getattr(mod, "PORT_NAMES", {})
    skip = getattr(mod, "NOT_PORT", ())
    over = {}
    for k, v in conf_file["model"].items():
        if k in skip:
            continue
        field = names.get(k, k)
        if getattr(base, field) != v:
            if k not in conf_file["reduced"]:
                raise ValueError(
                    f"{conf_file['name']}: {k} is {v} here and "
                    f"{getattr(base, field)} in the port's registry, and "
                    f"not listed in reduced")
            over[field] = v
    return dataclasses.replace(base, **over)


def check_layout(tree: dict, cfg) -> None:
    """The drawn tree has the port's spec-tree layout, leaf for leaf."""
    from repro_torch.models import module, transformer

    want = module.param_shapes(transformer.model_spec(cfg))
    got = module.tree_map(lambda t: tuple(t.shape), tree)
    flat_w = {k: tuple(v.shape) for k, v in weights.flat(want).items()}
    flat_g = weights.flat(got)
    if flat_w != flat_g:
        raise ValueError(f"weights layout differs from the port's spec tree: "
                         f"{sorted(set(flat_w.items()) ^ set(flat_g.items()))}")


@dataclasses.dataclass
class Cell:
    name: str
    conf: dict          # the configuration file
    mix: dict           # the traffic file
    limits: dict        # the cell file
    e2e: list           # end-to-end metric entries reported here
    per_layer: list     # per-layer metric entries reported here
    reference: str      # the name of the model module
    model: object       # the model module (perfbench/reference/)


def load_cell(root: Path, workload: str) -> Cell:
    bench, cell, conf = find_cell(root, workload)
    conf_file = load_json(root / conf["file"])
    name = conf_file.get("reference", reference.DEFAULT)
    mix = traffic.load(root / "perfbench" / "traffic"
                       / f"{cell['traffic']}.json")
    limits = load_json(root / "perfbench" / "cells" / f"{workload}.json")

    def here(ms):
        return [m for m in ms if workload in m.get("workloads", [workload])]

    return Cell(workload, conf_file, mix, limits,
                here(bench["end_to_end"]), here(bench["per_layer"]),
                name, reference.load(root, name))


class Window:
    """The serving loop of one run, and everything it records."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: torch.device):
        from repro_torch.core.famous import FamousConfig
        from repro_torch.obs.runtime import NULL_OBSERVER
        from repro_torch.serve.engine import Request, ServingEngine

        self.cell, self.seed, self.seconds, self.trace = (cell, seed,
                                                          seconds, trace)
        self.device = device
        self.Request = Request
        m = cell.conf["model"]
        self.m = m
        self.mix = mix = cell.mix
        eng = mix["engine"]
        self.cfg = model_config(cell.conf, cell.model)
        self.dtype = DTYPES[cell.conf["dtype"]]
        t = time.perf_counter()
        if device.type == "cuda":
            # the kernels' library, built in this checkout on its first
            # run, before any clock of the traffic starts
            from repro_torch.kernels import lib
            lib.load()
        self.tree = weights.make(cell.model.layout(m), self.dtype, seed,
                                 device)
        check_layout(self.tree, self.cfg)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.setup_parts = {"weights": time.perf_counter() - t}
        self.requests: dict = {}
        self.rec: dict = {}           # rid -> per-request record
        self.obs = observe.BenchObserver(
            NULL_OBSERVER, self.requests, events=device.type == "cuda")
        self.engine = ServingEngine(
            self.tree, self.cfg, FamousConfig(impl="pallas"),
            n_slots=eng["slots"], max_seq=eng["max_seq"], dtype=self.dtype,
            cache_kind=eng["cache_kind"], chunk=eng["chunk"],
            observer=self.obs, device=device)
        self.obs.attach(self.engine)
        self.setup_parts["engine"] = time.perf_counter() - t \
            - self.setup_parts["weights"]
        if trace:
            # the profiler's first start takes seconds (CUPTI's set-up):
            # pay it here, so that the sub-window's start is quick
            with self._profiler():
                torch.ones(1, device=device).add_(1)
                self._sync()
        self.specs = traffic.schedule(mix, seed, int(mix["pool"]))
        self.next = 0

    # -- requests ---------------------------------------------------------------
    def enqueue(self, now: float, due: float) -> None:
        spec = self.specs[self.next]
        self.next += 1
        toks = traffic.prompt_tokens(self.seed, spec.rid, spec.prompt_len,
                                     self.m["vocab_size"])
        req = self.Request(rid=spec.rid, tokens=toks, max_new=spec.max_new)
        self.requests[spec.rid] = req
        self.rec[spec.rid] = {"due": due, "enq": now, "admit": None,
                              "times": [], "done": None}
        self.engine.sched.enqueue(req)

    def admit(self) -> None:
        sched = self.engine.sched
        while sched.has_queued and sched.free_slot() is not None:
            req = sched.pop_queued()
            self.engine.add_request(req)
            self.rec[req.rid]["admit"] = time.perf_counter()

    def feed(self, now: float, t0: float, arrivals: bool) -> float | None:
        """Queue what is due; returns the next due time (poisson)."""
        if not arrivals:
            return None
        if self.mix["loop"] == "backlog":
            sched = self.engine.sched
            while len(sched.pending) < self.mix["backlog_depth"]:
                self.enqueue(now, now)
            return None
        while self.next < len(self.specs) and \
                t0 + self.specs[self.next].due <= now:
            self.enqueue(now, t0 + self.specs[self.next].due)
        if self.next >= len(self.specs):
            raise RuntimeError("the traffic pool ran out: raise its 'pool'")
        return t0 + self.specs[self.next].due

    def step(self) -> None:
        obs = self.obs
        obs.begin_step()
        finished = self.engine.step()
        st = obs.end_step()
        if st.decode_span is not None:
            t = st.decode_span[1]
            for _slot, rid, _j in st.emit:
                self.rec[rid]["times"].append(t)
        for req in finished:
            self.rec[req.rid]["done"] = st.t1
            if req.error:
                self.rec[req.rid]["error"] = req.error

    # -- the run ----------------------------------------------------------------
    def run(self, t_start: float) -> dict:
        mix, clock = self.mix, time.perf_counter
        sched = self.engine.sched
        t0 = clock()
        if mix["loop"] == "backlog":
            for _ in range(mix["engine"]["slots"]):
                self.enqueue(t0, t0)
        state, t_open = "warmup", None
        prof, n_prof = None, None
        while True:
            now = clock()
            nxt = self.feed(now, t0, state != "drain")
            with self._label("admit"):
                self.admit()
            if sched.busy:
                if n_prof is not None and state == "window":
                    with torch.profiler.record_function(devtrace.STEP):
                        self.step()
                    self.obs.steps[-1].profiled = True
                else:
                    self.step()
            elif nxt is not None:
                with self._label("wait"):
                    time.sleep(max(0.0, nxt - clock()))
            now = clock()
            if state == "warmup" and self._warm(now, t0):
                t_open, state = now, "window"
                self.setup_parts["warmup"] = now - t0
                self.i_open = len(self.obs.steps)
                self.forbidden_at_setup = forbidden_modules()
                self.setup_s = t_open - t_start
                self.census0 = dict(self.engine.compilations)
            elif state == "window":
                if (self.trace and prof is None
                        and now >= t_open + self.seconds - PROFILE_S):
                    prof = self._profiler()
                    prof.__enter__()
                    self.obs.label = self._label_for
                    n_prof = len(self.obs.steps)
                if now >= t_open + self.seconds and (
                        prof is None
                        or len(self.obs.steps) >= n_prof + PROFILE_STEPS):
                    t_close = now
                    self.i_close = len(self.obs.steps)
                    if prof is not None:
                        # stopped, and its trace read, once the window is
                        # over
                        self._sync()
                        prof.__exit__(None, None, None)
                        self.obs.label = None
                    if mix["loop"] != "poisson":
                        break
                    state = "drain"
            elif state == "drain":
                due = [r for r in self.rec.values()
                       if t_open <= r["due"] < t_close and not r["times"]
                       and "error" not in r]
                if not due or now > t_close + DRAIN_S or not sched.busy \
                        and not sched.has_queued:
                    break
        self._sync()
        self.t_open, self.t_close = t_open, t_close
        self.prof = prof
        return self.record()

    def _warm(self, now: float, t0: float) -> bool:
        warm = self.mix["warmup"]
        if warm["kind"] == "seconds":
            return now - t0 >= warm["seconds"]
        wave = [self.rec[i] for i in range(self.mix["engine"]["slots"])]
        return all(r["times"] for r in wave)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    @staticmethod
    def _label_for(name: str):
        return torch.profiler.record_function("host." + name)

    def _label(self, name: str):
        import contextlib
        return (self._label_for(name) if self.obs.label is not None
                else contextlib.nullcontext())

    # -- the record the metric readers read ---------------------------------------
    def record(self) -> dict:
        steps = []
        for st in self.obs.steps[self.i_open:self.i_close]:
            ev = [a.elapsed_time(b) for a, b in st.events] \
                if st.events else []
            steps.append({
                "t0": st.t0, "t1": st.t1, "profiled": st.profiled,
                "chunks": st.chunks,
                "decode_slots": st.decode_slots,
                "decode_ms": (None if st.decode_span is None else
                              1e3 * (st.decode_span[1] - st.decode_span[0])),
                "chunk_event_ms": ev,
                "cache_len": ([int(st.cache_len[s]) for s in st.decode_slots]
                              if st.cache_len is not None else []),
            })
        prof = {}
        if self.prof is not None:
            from repro_torch.kernels import lib
            prof = devtrace.reduce(devtrace.trace_events(self.prof),
                                   lib.KERNELS)
        return {"cell": self.cell.name, "model": self.m,
                "reference": self.cell.reference, "loop": self.mix["loop"],
                "t_open": self.t_open, "t_close": self.t_close,
                "setup_s": self.setup_s, "requests": self.rec,
                "steps": steps, "profile": prof}


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, t_start: float, device: str = "cuda",
             chips_check: bool = True,
             control: bool = False) -> tuple[dict, dict]:
    """One run.  Returns (the result line, what else it read).
    ``chips_check`` off (the tests) skips the look for a card;
    ``control`` also judges the control (``reference/check.py``)."""
    t_enter = time.perf_counter()
    cell = load_cell(root, workload)
    dev = torch.device(device)
    if chips_check:
        need = next(w["chips"] for w in find_cell(root, workload)[0]
                    ["workloads"] if w["name"] == workload)
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            raise SystemExit(
                f"{workload} needs {need} CUDA device(s); "
                f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
                f"{torch.cuda.device_count()} device(s)")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    # set-up before the window's own: the interpreter and its imports, and
    # the CUDA context
    parts = {"start": t_enter - t_start,
             "device": time.perf_counter() - t_enter}
    win = Window(cell, seed, seconds, trace, dev)
    rec = win.run(t_start)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    census1 = dict(win.engine.compilations)
    # the window's figures, then the program's state freed before the
    # reference runs
    metrics = {}
    wanted = cell.per_layer if trace else cell.e2e
    kind = "metrics" if trace else "end_to_end"
    for mt in wanted:
        v = reader(root, kind, mt["name"])(rec)
        if v is not None:
            metrics[mt["name"]] = {"value": v, "unit": mt["unit"]}
    log = win.obs.steps
    requests = win.requests
    win.obs.engine = win.engine = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    verdict = check.judge(cell, rec, requests, log, win.tree, seed, dev,
                          control=control)
    ref_s = time.perf_counter() - t_ref
    attempted, failed = attempted_failed(rec)
    checks = dict(verdict["checks"])
    checks["failed_requests"] = {"value": failed, "limit": 0}
    correct = check.passes(checks) and attempted > 0
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": attempted,
            "failed": failed, "metrics": metrics, "device": device_info}
    if trace and rec["profile"]:
        device_info["busy_s"] = rec["profile"]["busy_s"]
        device_info["window_s"] = rec["profile"]["window_s"]
        line["breakdown"] = {"device_ops": rec["profile"]["device_ops"],
                             "idle_gaps": rec["profile"]["idle_gaps"]}
    line["checks"] = checks
    late = [r["enq"] - r["due"] for r in rec["requests"].values()
            if rec["t_open"] <= r["due"] < rec["t_close"]]
    info = {"census_open": win.census0, "census_close": census1,
            "lateness_ms_max": 1e3 * max(late or [0.0]),
            "lateness_ms_p50": 1e3 * float(np.median(late or [0.0])),
            "steps_in_window": len(rec["steps"]),
            "requests_enqueued": len(win.rec),
            "forbidden_at_setup": win.forbidden_at_setup,
            "sample": verdict["sample"], "reference_s": ref_s,
            "setup_parts_s": dict(parts, **win.setup_parts)}
    if rec["loop"] == "poisson":
        # the first-token wait, read beside the bounded metrics
        info["ttft_ms"] = {"p50": readers.ttft_ms(rec, 50.0),
                           "p95": readers.ttft_ms(rec)}
        info["queue_wait_ms_p50"] = readers.queue_wait_ms(rec)
    if control:
        info["control"] = verdict["control"]
    return line, info


def attempted_failed(rec: dict) -> tuple[int, int]:
    """Requests of the window: due in it (poisson) or admitted in it
    (backlog), and those of them that failed or never got a token."""
    t0, t1 = rec["t_open"], rec["t_close"]
    key = "due" if rec["loop"] == "poisson" else "admit"
    mine = [r for r in rec["requests"].values()
            if r[key] is not None and t0 <= r[key] < t1]
    failed = sum(1 for r in mine if "error" in r
                 or (rec["loop"] == "poisson" and not r["times"]))
    return len(mine), failed
