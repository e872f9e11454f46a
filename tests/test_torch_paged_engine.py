"""PyTorch port, paged serving: the port's ``ServingEngine`` with
``cache_kind="paged"``, the prefix cache and int8 KV against the JAX
engine (``impl="xla"``) on the same weights, on
``shrink(get_config("qwen2-7b"))`` at f32.  The port runs ``impl="xla"``
and ``impl="pallas"`` (the paged kernels' plain versions on the CPU).

Greedy tokens must be identical, and so must what the engines count: prefix
hit pages and tokens, failed requests' errors, the allocator's free pages.
Each JAX run is made once and shared by both port impls."""
import functools

import numpy as np
import pytest
import torch

from torch_port_helpers import random_jax_params, tokens
from repro.configs.base import get_config as jget_config
from repro.configs.base import shrink as jshrink
from repro.core.famous import FamousConfig as JFamousConfig
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JServingEngine
from repro.serve.paged import PagePoolExhausted as JPagePoolExhausted
from repro_torch import convert
from repro_torch.configs.base import get_config, shrink
from repro_torch.core.famous import FamousConfig
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.paged import PagePoolExhausted

CFG, JCFG = shrink(get_config("qwen2-7b")), jshrink(jget_config("qwen2-7b"))
V = CFG.vocab_size


@functools.lru_cache(maxsize=None)
def _jparams():
    return random_jax_params(JCFG, seed=8)


def _shared(seed, n_shared, suffixes):
    rng = np.random.default_rng(seed)
    shared = tokens(rng, V, n_shared)
    return [shared + tokens(rng, V, k) for k in suffixes]


# name -> (engine kwargs, prompts, request kwargs, passes through one engine)
CASES = {
    "mixed": (dict(max_seq=64, page_size=8),
              [tokens(np.random.default_rng(1), V, n)
               for n in (20, 1, 9, 17, 30)], dict(max_new=6), 1),
    "prefix_warm": (dict(max_seq=64, page_size=8, prefix_cache=True),
                    _shared(2, 19, (1, 5, 13)), dict(max_new=6), 2),
    "fully_cached": (dict(max_seq=64, page_size=8, prefix_cache=True),
                     _shared(3, 17, (0,)), dict(max_new=6), 2),
    "int8_prefix": (dict(max_seq=64, page_size=8, prefix_cache=True,
                         kv_dtype="int8"),
                    _shared(4, 19, (1, 5, 13)), dict(max_new=6), 2),
    "preempt_fp": (dict(max_seq=32, page_size=4, n_pages=6),
                   [tokens(np.random.default_rng(5), V, 7) for _ in range(2)],
                   dict(max_new=8), 1),
    "preempt_int8": (dict(max_seq=32, page_size=4, n_pages=6,
                          kv_dtype="int8"),
                     [tokens(np.random.default_rng(9), V, 7)
                      for _ in range(2)], dict(max_new=8), 1),
    "preempt_prefix": (dict(max_seq=32, page_size=4, n_pages=6,
                            prefix_cache=True),
                       _shared(6, 4, (3, 3)), dict(max_new=8), 2),
    "lru_reclaim": (dict(max_seq=64, page_size=8, n_pages=8,
                         prefix_cache=True),
                    [tokens(np.random.default_rng(7), V, n)
                     for n in (9, 17, 12, 21, 8, 15)], dict(max_new=6), 2),
    "impossible": (dict(max_seq=32, page_size=8, n_pages=4),
                   [tokens(np.random.default_rng(10), V, n) for n in (5, 30)],
                   dict(max_new=3), 1),
    "seeded": (dict(max_seq=64, page_size=8, prefix_cache=True),
               _shared(11, 17, (2, 9)),
               dict(max_new=6, temperature=0.8, top_k=5, seed=42), 2),
}


def _serve(eng, req_cls, prompts, req_kw, passes):
    outs = []
    for p in range(passes):
        done = eng.run([req_cls(rid=10 * p + i, tokens=list(t), **req_kw)
                        for i, t in enumerate(prompts)])
        outs += [(r.rid, r.out, r.error) for r in
                 sorted(done, key=lambda r: r.rid)]
    return outs, eng.prefix_hit_pages, eng.prefix_hit_tokens, \
        eng.alloc.free_pages


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    kw, prompts, req_kw, passes = CASES[case]
    eng = JServingEngine(_jparams(), JCFG, JFamousConfig(impl="xla"),
                         n_slots=2, chunk=8, cache_kind="paged", **kw)
    res = _serve(eng, JRequest, prompts, req_kw, passes)
    eng.alloc.assert_invariants()
    return res


def _port_engine(timpl, **kw):
    return ServingEngine(convert.params_from_jax(_jparams(), CFG, "cpu"),
                         CFG, FamousConfig(impl=timpl), n_slots=2, chunk=8,
                         cache_kind="paged", device="cpu", **kw)


@pytest.mark.parametrize("timpl", ["xla", "pallas"])
@pytest.mark.parametrize("case", list(CASES))
def test_paged_engine_matches_jax(case, timpl):
    kw, prompts, req_kw, passes = CASES[case]
    eng = _port_engine(timpl, **kw)
    got = _serve(eng, Request, prompts, req_kw, passes)
    eng.alloc.assert_invariants()
    assert got == _jax_run(case)
    outs, hit_pages, hit_tokens, _ = got
    if case.startswith(("prefix", "int8", "seeded")):
        assert hit_pages >= 3 * 2 or (case == "seeded" and hit_pages > 0)
    if case == "fully_cached":
        assert hit_tokens == 16
        assert eng.sched.fairness(10)["cached_tokens"] == 16
    if case == "impossible":
        assert outs[0][2] is None and len(outs[0][1]) == 3
        assert "pages" in outs[1][2]
    else:
        assert all(err is None for _, _, err in outs)
    if case.startswith("preempt"):
        assert sum(eng.sched.fairness(r).get("preemptions", 0)
                   for r, _, _ in outs) >= 1
    if kw.get("kv_dtype") == "int8":
        assert eng.caches[0]["k"].dtype == torch.int8
        assert set(eng.caches[0]) == {"k", "v", "k_scale", "v_scale"}


@pytest.mark.parametrize("timpl", ["xla", "pallas"])
def test_admission_control_matches_jax(timpl):
    """A 3-page pool: a 20-token prompt takes it all, the next admission
    raises with the engine untouched, and the first request then decodes
    to the JAX engine's tokens and returns every page."""
    kw = dict(max_seq=32, page_size=8, n_pages=4)
    jeng = JServingEngine(_jparams(), JCFG, JFamousConfig(impl="xla"),
                          n_slots=2, chunk=8, cache_kind="paged", **kw)
    eng = _port_engine(timpl, **kw)
    first, second = list(range(1, 21)), list(range(1, 10))
    jeng.add_request(JRequest(rid=0, tokens=first, max_new=2))
    eng.add_request(Request(rid=0, tokens=first, max_new=2))
    with pytest.raises(JPagePoolExhausted) as jerr:
        jeng.add_request(JRequest(rid=1, tokens=second, max_new=2))
    with pytest.raises(PagePoolExhausted) as err:
        eng.add_request(Request(rid=1, tokens=second, max_new=2))
    assert str(err.value) == str(jerr.value)
    assert eng.sched.free_slot() == 1
    jdone, done = jeng.run([]), eng.run([])
    assert [r.out for r in done] == [r.out for r in jdone]
    assert len(done) == 1 and len(done[0].out) == 2
    assert eng.alloc.free_pages == jeng.alloc.free_pages == 3


def test_paged_pool_bytes_and_options():
    """The pool sizes of the JAX engine (default pool: 1 + slots·pages)
    and int8 pools at (dh + 4) / (4·dh) of the f32 bytes."""
    eng = _port_engine("xla", max_seq=64, page_size=8)
    assert eng.pcfg.n_pages == 1 + 2 * 8
    kv, dh, L = CFG.num_kv_heads, CFG.head_dim, CFG.num_layers
    fp = eng.cache_bytes_per_device()
    assert fp == L * 2 * 17 * 8 * kv * dh * 4
    i8 = _port_engine("xla", max_seq=64, page_size=8, kv_dtype="int8")
    assert i8.cache_bytes_per_device() == L * 2 * 17 * 8 * kv * (dh + 4)
