"""PyTorch port, the serving engine's executables (``serve/graphs.py``) and
the retrace guard (``analysis/retrace_guard.py``) on the CPU:

* the retrace-guard cases of the JAX suite (growth, quiet, ``allow``, an
  int census, a cold and a warm engine), on the port's copy and the
  port's engine;
* the fixed-shape ``verify_writes`` against JAX's ``mode="drop"`` writes,
  with slots at ``max_seq - W .. max_seq - 1`` and a slot that holds no
  sequence, and ``verify_step``'s logits and caches equal to those of the
  earlier host-indexed writes (kept here as an oracle) on those edges;
* an :class:`Executable`'s keying and launch accounting with the capture
  stubbed (its bookkeeping is plain Python);
* the engine with the capture stubbed by a graph that replays by calling
  the step again: its tokens equal the eager engine's on greedy, seeded,
  speculative, paged and int8 KV, recurrent and token-budgeted runs, with
  the prefill chunk captured once beside the step.

A real capture needs a CUDA device; ``chip_smoke.py`` holds graphs against
eager runs there."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import random_jax_params, tokens
from repro.configs.base import get_config as jget_config
from repro.configs.base import shrink as jshrink
from repro.core.famous import FamousConfig as JFamousConfig
from repro.models import transformer as jtransformer
from repro_torch import convert
from repro_torch.analysis.retrace_guard import (RetraceError, census,
                                                retrace_guard)
from repro_torch.configs.base import get_config, shrink
from repro_torch.core.famous import FamousConfig
from repro_torch.kernels import lib
from repro_torch.models import attention, module, transformer
from repro_torch.obs.runtime import Observer
from repro_torch.serve import graphs
from repro_torch.serve.engine import Request, ServingEngine

CFG, JCFG = shrink(get_config("qwen2-7b")), jshrink(jget_config("qwen2-7b"))
MAX_SEQ = 32


# ---------------------------------------------------------------------------
# retrace guard (the JAX suite's cases, tests/test_analysis.py)
# ---------------------------------------------------------------------------

class _Fake:
    def __init__(self):
        self.compilations = {"prefill": 1, "decode": 1}


def test_retrace_guard_fails_on_growth():
    f = _Fake()
    with pytest.raises(RetraceError, match="decode: 1 -> 2"):
        with retrace_guard(f, label="fake"):
            f.compilations["decode"] += 1


def test_retrace_guard_passes_when_quiet():
    f = _Fake()
    with retrace_guard(f):
        f.compilations["decode"] += 0


def test_retrace_guard_allow_tolerates_known_compiles():
    f = _Fake()
    with retrace_guard(f, allow=1):
        f.compilations["decode"] += 1


def test_retrace_guard_int_census():
    class C:
        compilations = 0

    c = C()
    with pytest.raises(RetraceError):
        with retrace_guard(c):
            c.compilations = 2


def test_retrace_guard_reads_the_observer_and_its_snapshot():
    """The port's Observer exports the engine census as the
    ``repro_engine_compilations{exec=...}`` gauges the guard reads."""
    obs = Observer()
    state = {"decode": 1, "verify": 0}
    obs.register_census(lambda: dict(state))
    assert census(obs) == state
    snap = obs.snapshot()
    assert census(snap) == state
    with pytest.raises(RetraceError, match="verify: 0 -> 1"):
        with retrace_guard(obs):
            state["verify"] += 1


# the real switch, before a fixture patches it: on for "cuda" unless
# disable_capture() is in force
_ENABLED = graphs.capture_enabled


class _ReplayGraph:
    """A captured graph's stand-in on the CPU.  The stubbed capture ran
    the step once, as a real graph's first replay does; every later
    replay calls the step again and copies its result into the captured
    outputs, as a graph rewrites its static outputs in place."""

    def __init__(self, fn, out):
        self.fn, self.out, self.first = fn, out, True

    def replay(self):
        if self.first:
            self.first = False
            return
        new = self.fn()
        pairs = zip(self.out, new) if isinstance(self.out, tuple) \
            else [(self.out, new)]
        for o, n in pairs:
            o.copy_(n)


@pytest.fixture
def stub_graphs(monkeypatch):
    """Capture on the CPU as on a CUDA device (``disable_capture`` still
    switches it off), with :class:`_ReplayGraph` in place of a CUDA
    graph."""
    def capture(fn, pool):
        out = fn()
        return _ReplayGraph(fn, out), out

    monkeypatch.setattr(graphs, "capture_enabled",
                        lambda device: _ENABLED("cuda"))
    monkeypatch.setattr(graphs, "capture", capture)


def _params():
    gen = torch.Generator().manual_seed(0)
    return module.init_params(transformer.model_spec(CFG), gen,
                              torch.float32, "cpu")


def test_retrace_guard_engine_cold_vs_warm(stub_graphs):
    """The live invariant: a cold engine captures inside the guard and
    fails; the same engine, warmed, serves a fresh batch guarded clean."""
    eng = ServingEngine(_params(), CFG, FamousConfig(impl="xla"),
                        n_slots=2, max_seq=MAX_SEQ, chunk=8, device="cpu",
                        observer=Observer())

    def reqs(rid0):
        return [Request(rid=rid0 + i, max_new=3,
                        tokens=[1, 2, 3, 4, 5 + i]) for i in range(2)]

    with pytest.raises(RetraceError, match="decode: 0 -> 1"):
        with retrace_guard(eng, label="cold engine"):
            eng.run(reqs(0))
    with retrace_guard(eng, label="warm engine"):
        eng.run(reqs(10))
    assert eng.compilations == {"prefill": 1, "decode": 1, "verify": 0,
                                "clear": 0}
    with retrace_guard(eng.obs, label="through the observer"):
        eng.run(reqs(20))
    assert census(eng.obs.snapshot())["decode"] == 1


def test_cpu_engine_captures_nothing():
    """Without the stub, the CPU runs every step eagerly: no graph, no
    replay, the census all zeros."""
    eng = ServingEngine(_params(), CFG, FamousConfig(impl="xla"),
                        n_slots=2, max_seq=MAX_SEQ, chunk=8, device="cpu")
    eng.run([Request(rid=0, tokens=[1, 2, 3], max_new=4)])
    assert eng.compilations == {"prefill": 0, "decode": 0, "verify": 0,
                                "clear": 0}
    assert eng.graph_stats["replays"] == {"decode": 0, "verify": 0,
                                          "prefill": 0, "clear": 0}


def test_disable_capture_switches_capture_off_and_nests():
    assert graphs.capture_enabled("cuda")
    assert not graphs.capture_enabled("cpu")
    with graphs.disable_capture():
        assert not graphs.capture_enabled("cuda")
        with graphs.disable_capture():
            assert not graphs.capture_enabled("cuda")
        assert not graphs.capture_enabled("cuda")
    assert graphs.capture_enabled("cuda")


# ---------------------------------------------------------------------------
# the executable's bookkeeping, capture stubbed
# ---------------------------------------------------------------------------

class _CountingGraph:
    replays = 0

    def replay(self):
        _CountingGraph.replays += 1


@pytest.fixture
def counting_graphs(monkeypatch):
    _CountingGraph.replays = 0
    monkeypatch.setattr(graphs, "capture_enabled",
                        lambda device: _ENABLED("cuda"))
    monkeypatch.setattr(graphs, "capture",
                        lambda fn, pool: (_CountingGraph(), fn()))
    lib.STATS.reset()
    yield
    lib.STATS.reset()


def _counting_step(calls):
    """A step function that counts as a kernel wrapper does: two
    ``decode_attention`` launches and one plain ``matmul_tiled`` a call,
    three ``chunk_prefill`` launches for the key ``"b"``."""
    def fn(key):
        calls.append(key)
        lib.STATS.launches["decode_attention"] += 2
        lib.STATS.plain_on_cuda["matmul_tiled"] += 1
        if key == "b":
            lib.STATS.launches["chunk_prefill"] += 3
        return torch.tensor([len(calls)])
    return fn


def test_executable_warms_then_captures_then_replays(counting_graphs):
    calls = []
    ex = graphs.Executable(_counting_step(calls),
                           graphs.GraphPool("cpu"))
    launches = lib.STATS.launches
    first = ex("a")                      # eager: the warm-up is the step
    assert calls == ["a"] and ex.graph_keys == [] and ex.replays == 0
    assert launches["decode_attention"] == 2
    second = ex("a")                     # capture, then one replay
    assert calls == ["a", "a"] and ex.graph_keys == ["a"]
    assert _CountingGraph.replays == 1 and ex.replays == 1
    assert launches["decode_attention"] == 4
    third = ex("a")                      # replay only: no Python runs
    assert calls == ["a", "a"] and _CountingGraph.replays == 2
    assert third is second and first is not second
    assert ex.outputs["a"] is second
    assert launches["decode_attention"] == 6
    assert lib.STATS.plain_on_cuda["matmul_tiled"] == 3
    for _ in range(2):                   # a new key warms and captures
        ex("b")
    ex("b")
    assert ex.graph_keys == ["a", "b"] and calls.count("b") == 2
    assert launches["chunk_prefill"] == 9
    assert launches["decode_attention"] == 12
    with graphs.disable_capture():       # eager again: the Python counts
        ex("a")
    assert calls[-1] == "a" and ex.replays == 4
    assert launches["decode_attention"] == 14


def test_a_failed_capture_raises_and_takes_its_counts_back(monkeypatch,
                                                            counting_graphs):
    calls = []
    ex = graphs.Executable(_counting_step(calls),
                           graphs.GraphPool("cpu"))
    ex("a")

    def broken(fn, pool):
        fn()
        raise RuntimeError("capture failed")

    monkeypatch.setattr(graphs, "capture", broken)
    for _ in range(2):                   # no fallback: every call raises
        with pytest.raises(RuntimeError, match="capture failed"):
            ex("a")
    assert ex.graph_keys == [] and ex.replays == 0
    assert lib.STATS.launches["decode_attention"] == 2


def test_static_input_keeps_its_address():
    s = graphs.StaticInput((3,), torch.int64, "cpu")
    t = s.tensor
    assert s.put(np.array([1, 2, 3], np.int32)) is t
    s.put(np.array([7, 8, 9]))
    assert s.tensor is t and t.tolist() == [7, 8, 9]


# ---------------------------------------------------------------------------
# verify writes at the max_seq edge
# ---------------------------------------------------------------------------

def _edge_lens(W):
    """One slot at each of ``max_seq - W .. max_seq - 1`` and a slot that
    holds no sequence (length 0)."""
    return [MAX_SEQ - W + i for i in range(W)] + [0]


@pytest.mark.parametrize("W", [1, 2, 3, 5, 8])
def test_verify_writes_drop_past_max_seq(W):
    """Fixed-shape indices: every row inside the stripe, distinct per
    slot; exactly the tokens below ``max_seq`` are fresh, each written at
    its own position."""
    lens = _edge_lens(W)
    b_idx, pos, tok, fresh = attention.verify_writes(
        torch.tensor(lens, dtype=torch.int32), W, MAX_SEQ)
    assert pos.shape == tok.shape == fresh.shape == (len(lens), W)
    assert int(pos.min()) >= 0 and int(pos.max()) < MAX_SEQ
    for b, n in enumerate(lens):
        assert len(set(pos[b].tolist())) == W
        assert b_idx[b].tolist() == [b] * W
        got = {int(p): int(t) for p, t, f in zip(pos[b], tok[b], fresh[b])
               if f}
        assert got == {n + j: j for j in range(W) if n + j < MAX_SEQ}
        assert all(int(p) < n for p, f in zip(pos[b], fresh[b]) if not f)
    with pytest.raises(ValueError, match="verify width"):
        attention.verify_writes(torch.tensor(lens), MAX_SEQ + 1, MAX_SEQ)


def _old_verify_writes(cache_len, W, max_seq):
    """The earlier writes: a host copy of ``cache_len`` chose the kept
    tokens (one device->host sync)."""
    cl = cache_len.detach().to("cpu", torch.int64)
    pos = cl[:, None] + torch.arange(W)
    keep = (pos < max_seq).reshape(-1)
    rows = torch.arange(cl.shape[0] * W)[keep]
    return torch.div(rows, W, rounding_mode="floor"), \
        pos.reshape(-1)[keep], rows


def _old_apply_attn_verify(p, x, cache, cache_len, cfg, fcfg, writes):
    B, W = x.shape[:2]
    positions = cache_len[:, None] + torch.arange(W)
    q, k, v = attention._project(p, x, cfg, fcfg, positions)
    b_idx, pos, rows = writes
    kd = k.reshape(B * W, *k.shape[2:])
    vd = v.reshape(B * W, *v.shape[2:])
    cache["k"][b_idx, pos] = kd[rows].to(cache["k"].dtype)
    cache["v"][b_idx, pos] = vd[rows].to(cache["v"].dtype)
    out = attention.famous.verify_attention(q, cache["k"], cache["v"],
                                            cache_len, cfg=fcfg)
    return attention._out_proj(out, p["wo"]), cache


@functools.lru_cache(maxsize=None)
def _jparams():
    return random_jax_params(JCFG, seed=21)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("W", [1, 3, 5])
def test_verify_step_at_max_seq_edge(monkeypatch, W, impl):
    """``verify_step`` with slots at ``max_seq - W .. max_seq - 1`` and an
    empty slot: caches equal to JAX's drop semantics (rows before each
    slot's length unchanged, bit for bit), logits of the rows below
    ``max_seq`` equal to JAX's, and logits and caches bit-equal to the
    earlier host-indexed writes."""
    rng = np.random.default_rng(W)
    lens = _edge_lens(W)
    B = len(lens)
    jcaches = jtransformer.make_caches(JCFG, B, MAX_SEQ, jnp.float32)
    jcaches = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype),
        jcaches)
    vtok = rng.integers(0, CFG.vocab_size, size=(B, W))
    jlogits, jafter = jtransformer.verify_step(
        _jparams(), jnp.asarray(vtok, jnp.int32), jcaches,
        jnp.asarray(lens, jnp.int32), JCFG, JFamousConfig(impl="xla"))
    params = convert.params_from_jax(_jparams(), CFG, "cpu")
    before = convert.caches_from_jax(jcaches, CFG, "cpu")
    clen = torch.tensor(lens, dtype=torch.int32)
    fcfg = FamousConfig(impl=impl)

    def run():
        caches = [{k: v.clone() for k, v in c.items()} for c in before]
        return transformer.verify_step(params, torch.from_numpy(vtok), caches,
                                       clen, CFG, fcfg)

    logits, after = run()
    want = convert.caches_from_jax(jafter, CFG, "cpu")
    valid = np.array([[n + j < MAX_SEQ for j in range(W)] for n in lens])
    np.testing.assert_allclose(logits.numpy()[valid],
                               np.asarray(jlogits)[valid], atol=1e-4,
                               rtol=1e-4)
    for mine, theirs, old in zip(after, want, before):
        for name in ("k", "v"):
            np.testing.assert_allclose(mine[name].numpy(),
                                       theirs[name].numpy(), atol=1e-5,
                                       rtol=1e-5)
            for b, n in enumerate(lens):
                assert torch.equal(mine[name][b, :n], old[name][b, :n])
    monkeypatch.setattr(attention, "verify_writes", _old_verify_writes)
    monkeypatch.setattr(attention, "apply_attn_verify",
                        _old_apply_attn_verify)
    old_logits, old_after = run()
    assert torch.equal(logits, old_logits)
    for mine, theirs in zip(after, old_after):
        for name in ("k", "v"):
            assert torch.equal(mine[name], theirs[name])


# ---------------------------------------------------------------------------
# the engine through stubbed graphs: tokens equal to the eager engine's
# ---------------------------------------------------------------------------

_HOT = [dict(temperature=0.9, top_k=0, seed=7),
        dict(temperature=1.3, top_k=5, seed=2**32 + 9),
        dict(temperature=0.6, top_k=3)]

ENGINE_CASES = {
    "greedy": ("qwen2-7b", {}, False),
    "seeded": ("qwen2-7b", {}, True),
    "paged prefix int8": ("qwen2-7b", dict(cache_kind="paged", page_size=8,
                                           prefix_cache=True,
                                           kv_dtype="int8"), False),
    "speculative": ("qwen2-7b", dict(speculative=True, draft_k=3), True),
    "speculative paged": ("qwen2-7b", dict(speculative=True, draft_k=4,
                                           cache_kind="paged", page_size=8),
                          False),
    "recurrentgemma-2b": ("recurrentgemma-2b", {}, True),
    "rwkv6-1.6b": ("rwkv6-1.6b", {}, False),
    # several chunks a step, each staged after the previous one's replay
    "token budget": ("qwen2-7b", dict(token_budget=32), False),
}


@functools.lru_cache(maxsize=None)
def _arch_params(arch):
    cfg = shrink(get_config(arch))
    gen = torch.Generator().manual_seed(4)
    return cfg, module.init_params(transformer.model_spec(cfg), gen,
                                   torch.float32, "cpu")


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_stubbed_graphs_give_the_eager_engines_tokens(stub_graphs, case):
    arch, kw, hot = ENGINE_CASES[case]
    cfg, params = _arch_params(arch)
    rng = np.random.default_rng(len(case))
    # a repeated head makes the prompt-lookup drafter propose tokens
    head = tokens(rng, 256, 6)
    prompts = [head + tokens(rng, 256, n) + head for n in (9, 1, 14, 3, 20)]

    def serve():
        eng = ServingEngine(params, cfg, FamousConfig(impl="pallas"),
                            n_slots=2, max_seq=64, chunk=8, device="cpu",
                            **kw)
        reqs = [Request(rid=i, tokens=list(p), max_new=7,
                        **(_HOT[i % 3] if hot and i % 2 == 0 else {}))
                for i, p in enumerate(prompts)]
        lib.STATS.reset()
        done = sorted(eng.run(reqs), key=lambda r: r.rid)
        assert all(r.error is None and len(r.out) == 7 for r in done)
        return [r.out for r in done], eng, lib.STATS.snapshot()

    with graphs.disable_capture():
        eager, eng_e, counts_e = serve()
    graphed, eng_g, counts_g = serve()
    assert graphed == eager and counts_g == counts_e
    kind = "verify" if eng_g.speculative_active else "decode"
    assert not any(eng_e.compilations.values())
    census = eng_g.compilations
    assert census.pop("clear") <= 1
    assert census == {"prefill": 1, "decode": kind == "decode",
                      "verify": kind == "verify"}
    stats = eng_g.graph_stats
    assert stats["replays"][kind] > 0 and stats["replays"]["prefill"] > 0
    assert any(isinstance(k, str) and k.startswith(f"('{kind}'")
               for k in stats["keys"][kind]) == hot
    if kw.get("speculative"):
        assert eng_g.spec_accepted == eng_e.spec_accepted
