"""PyTorch port, monolithic prefill: ``transformer.prefill`` (last-position
logits and every cache leaf) and ``transformer.write_prefill_to_slot``
(contiguous, paged and paged int8 pools, NULL-padded page ids, into
dirty caches) against the JAX package; ports of ``tests/test_serve.py``'s
chunked-against-monolithic and bucketing tests; the monolithic engine
token for token against JAX's on contiguous, paged and paged int8 KV,
greedy and seeded; and the engine through a stubbed capture, token-equal
to eager, with one ``prefill`` graph per bucket used twice.  Shrunk
configs, f32, weights and inputs from numpy seeds.  Tolerance 1e-5 on
logits and cache leaves (int8 pools exact), tokens identical."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_graphs import stub_graphs  # noqa: F401  (a fixture)
from torch_port_helpers import random_jax_params, tokens
from repro.configs.base import get_config as jget_config
from repro.configs.base import shrink as jshrink
from repro.core.famous import FamousConfig as JFamousConfig
from repro.models import transformer as jtransformer
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JServingEngine
from repro_torch import convert
from repro_torch.configs.base import get_config, shrink
from repro_torch.core.famous import FamousConfig
from repro_torch.kernels import lib
from repro_torch.serve import graphs
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.models import transformer

TOL = 1e-5
ARCHS = ("qwen2-7b", "recurrentgemma-2b", "rwkv6-1.6b")
IMPLS = ("xla", "pallas")


def _cfgs(arch):
    return shrink(get_config(arch)), jshrink(jget_config(arch))


@functools.lru_cache(maxsize=None)
def _weights(arch, seed=3):
    cfg, jcfg = _cfgs(arch)
    jp = random_jax_params(jcfg, seed=seed)
    return cfg, jcfg, jp, convert.params_from_jax(jp, cfg, "cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               atol=tol, rtol=tol)


def _dirty(tree, seed):
    """Every cache leaf filled from numpy (int8 pools with int8 values), so
    a leaf the port forgets to write cannot pass as zeros."""
    rng = np.random.default_rng(seed)

    def fill(a):
        if a.dtype == jnp.int8:
            return jnp.asarray(rng.integers(-127, 128, a.shape), jnp.int8)
        return jnp.asarray(rng.standard_normal(a.shape), a.dtype)
    return jax.tree_util.tree_map(fill, tree)


def _compare_caches(got: list, want: dict, cfg):
    ref = convert.caches_from_jax(want, cfg, "cpu")
    assert len(got) == len(ref)
    for g, w in zip(got, ref):
        assert set(g) == set(w)
        for name in g:
            if g[name].dtype == torch.int8:
                assert torch.equal(g[name], w[name]), name
            else:
                _close(g[name], w[name])


# (arch, prompt length, max_seq): recurrentgemma's prompt is past its
# 16-token ring; rwkv6's is two 64-token chunks
PREFILL_CASES = (("qwen2-7b", 20, 64), ("recurrentgemma-2b", 40, 64),
                 ("rwkv6-1.6b", 128, 128))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch,S,max_seq", PREFILL_CASES)
def test_prefill_matches_jax(arch, S, max_seq, impl):
    cfg, jcfg, jp, params = _weights(arch)
    toks = np.random.default_rng(S).integers(0, cfg.vocab_size, (1, S))
    jcaches = jtransformer.make_caches(jcfg, 1, max_seq, jnp.float32)
    want, wcaches = jtransformer.prefill(jp, jnp.asarray(toks, jnp.int32),
                                         jcaches, jcfg,
                                         JFamousConfig(impl="xla"))
    caches = transformer.make_caches(cfg, 1, max_seq, torch.float32, "cpu")
    got, out = transformer.prefill(params, torch.from_numpy(toks), caches,
                                   cfg, FamousConfig(impl=impl))
    assert out is caches and got.shape == (1, cfg.vocab_size)
    _close(got, want)
    _compare_caches(caches, wcaches, cfg)


WRITE_CASES = {"contiguous": {}, "paged": dict(cache_kind="paged"),
               "paged int8": dict(cache_kind="paged", kv_dtype="int8")}


@pytest.mark.parametrize("arch", ["qwen2-7b", "recurrentgemma-2b"])
@pytest.mark.parametrize("case", list(WRITE_CASES))
def test_write_prefill_to_slot_matches_jax(arch, case):
    """A prefilled batch-1 cache written into slot 2 of 3 dirty slots;
    paged, the slot's table row holds 3 live pages, then the null page
    (ids NULL-padded past them), and the pool is 8-token pages."""
    kw = WRITE_CASES[case]
    cfg, jcfg, jp, params = _weights(arch)
    max_seq, ps, n_pages = 64, 8, 30
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 21))
    one = jtransformer.make_caches(jcfg, 1, max_seq, jnp.float32)
    _, one = jtransformer.prefill(jp, jnp.asarray(toks, jnp.int32), one,
                                  jcfg, JFamousConfig(impl="xla"))
    paged = {"page_size": ps, "n_pages": n_pages} if kw else {}
    jcaches = _dirty(jtransformer.make_caches(jcfg, 3, max_seq, jnp.float32,
                                              **kw, **paged), 7)
    page_ids = None
    if kw:
        page_ids = np.zeros((max_seq // ps,), np.int32)
        page_ids[:3] = (17, 4, 9)
    want = jtransformer.write_prefill_to_slot(
        jcaches, one, 2, jcfg,
        page_ids=None if page_ids is None else jnp.asarray(page_ids))
    caches = convert.caches_from_jax(jcaches, cfg, "cpu")
    got = transformer.write_prefill_to_slot(
        caches, convert.caches_from_jax(one, cfg, "cpu"),
        torch.tensor([2], dtype=torch.int32), cfg,
        page_ids=None if page_ids is None else torch.from_numpy(page_ids))
    assert got is caches
    _compare_caches(caches, want, cfg)


def _serve(params, cfg, prompts, max_new, fcfg=None, **kw):
    eng = ServingEngine(params, cfg, fcfg or FamousConfig(impl="pallas"),
                        device="cpu", **kw)
    done = sorted(eng.run([Request(rid=i, tokens=list(p), max_new=max_new)
                           for i, p in enumerate(prompts)]),
                  key=lambda r: r.rid)
    assert all(r.error is None for r in done)
    return [r.out for r in done], eng


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_matches_monolithic(arch):
    """Token-identical output whether the prompt is prefilled in one
    monolithic call or in chunks between decode steps, on global-attention,
    hybrid and pure-recurrent stacks, prompts partial, exact, multi-chunk
    and of length 1 (``tests/test_serve.py``'s test, through the
    kernels' plain versions)."""
    cfg, _, _, params = _weights(arch)
    rng = np.random.default_rng(1)
    prompts = [tokens(rng, cfg.vocab_size, n) for n in (3, 9, 17, 33, 1)]
    mono, _ = _serve(params, cfg, prompts, 5, n_slots=2, max_seq=64,
                     prefill_mode="monolithic")
    chunked, eng = _serve(params, cfg, prompts, 5, n_slots=2, max_seq=64,
                          prefill_mode="chunked", chunk=8)
    assert mono == chunked, arch
    assert eng.prefill_keys == ["prefill"]


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_chunked_matches_monolithic_paged(kv_dtype):
    cfg, _, _, params = _weights("qwen2-7b")
    rng = np.random.default_rng(2)
    prompts = [tokens(rng, cfg.vocab_size, n) for n in (5, 21, 12)]
    kw = dict(n_slots=2, max_seq=64, cache_kind="paged", page_size=8,
              kv_dtype=kv_dtype)
    mono, _ = _serve(params, cfg, prompts, 4, prefill_mode="monolithic", **kw)
    chunked, _ = _serve(params, cfg, prompts, 4, prefill_mode="chunked",
                        chunk=16, **kw)
    assert mono == chunked


def test_long_prompt_spans_many_chunks():
    cfg, _, _, params = _weights("qwen2-7b")
    prompts = [tokens(np.random.default_rng(4), cfg.vocab_size, 100)]
    mono, eng_m = _serve(params, cfg, prompts, 4, n_slots=2, max_seq=128,
                         prefill_mode="monolithic")
    chunked, eng = _serve(params, cfg, prompts, 4, n_slots=2, max_seq=128,
                          prefill_mode="chunked", chunk=16)
    assert mono == chunked
    assert eng.prefill_keys == ["prefill"]     # 7 chunk calls, one key
    assert eng_m.prefill_keys == [128]          # 99 tokens -> bucket 128


def test_monolithic_bucketing_reuses_executables():
    cfg, _, _, params = _weights("qwen2-7b")
    lens = [3, 5, 7, 9, 12, 15, 17, 30]  # -> buckets {2, 4, 8, 16, 32}
    rng = np.random.default_rng(1)
    _, eng = _serve(params, cfg, [tokens(rng, cfg.vocab_size, n)
                                  for n in lens], 2, n_slots=4, max_seq=64,
                    prefill_mode="monolithic")
    assert eng.bucketed
    assert len(eng.prefill_keys) <= 5
    assert sorted(eng.prefill_keys) == [2, 4, 8, 16, 32]
    assert eng.prefill_compilations == 0    # nothing is captured on the CPU


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-1.6b"])
def test_monolithic_recurrent_uses_exact_length(arch):
    cfg, _, _, params = _weights(arch)
    rng = np.random.default_rng(3)
    _, eng = _serve(params, cfg, [tokens(rng, cfg.vocab_size, n)
                                  for n in (4, 9, 18)], 2, n_slots=2,
                    max_seq=64, prefill_mode="monolithic")
    assert not eng.bucketed
    assert sorted(eng.prefill_keys) == [3, 8, 17]


def test_monolithic_rwkv6_refuses_lengths_off_the_chunk_grid():
    """JAX's wkv6 asserts ``S % min(64, S) == 0``: a 66-token prompt (65
    prefilled) raises ValueError at admission, before the slot, the caches
    or any kernel is touched; 65 tokens (64 prefilled) are served."""
    cfg, _, _, params = _weights("rwkv6-1.6b")
    eng = ServingEngine(params, cfg, FamousConfig(impl="pallas"), n_slots=2,
                        max_seq=192, prefill_mode="monolithic", device="cpu")
    rng = np.random.default_rng(5)
    lib.STATS.reset()
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        eng.add_request(Request(rid=0, tokens=tokens(rng, 256, 66)))
    assert eng.sched.free_slot() == 0 and not eng.prefill_keys
    assert not any(lib.STATS.launches.values())
    done = eng.run([Request(rid=1, tokens=tokens(rng, 256, 65), max_new=2)])
    assert done[0].error is None and eng.prefill_keys == [64]


def test_monolithic_refuses_the_prefix_cache():
    cfg, _, _, params = _weights("qwen2-7b")
    with pytest.raises(ValueError, match="chunked prefill"):
        ServingEngine(params, cfg, FamousConfig(), cache_kind="paged",
                      prefix_cache=True, prefill_mode="monolithic",
                      device="cpu")


_HOT = [dict(temperature=0.9, top_k=0, seed=7),
        dict(temperature=1.3, top_k=5, seed=2**32 + 9)]
ENGINE_CASES = {"contiguous": {},
                "paged": dict(cache_kind="paged", page_size=8),
                "paged int8": dict(cache_kind="paged", page_size=8,
                                   kv_dtype="int8")}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_monolithic_tokens_match_jax_engine(case):
    """Greedy and seeded requests (alternating) through both monolithic
    engines on the same weights: prompts of 1-33 tokens over 2 slots (slot
    reuse, buckets 2-32)."""
    kw = ENGINE_CASES[case]
    cfg, jcfg, jp, params = _weights("qwen2-7b")
    rng = np.random.default_rng(len(case))
    prompts = [tokens(rng, cfg.vocab_size, n) for n in (20, 1, 9, 33, 5)]

    def reqs(cls):
        return [cls(rid=i, tokens=list(p), max_new=5,
                    **(_HOT[i // 2 % 2] if i % 2 else {}))
                for i, p in enumerate(prompts)]

    jeng = JServingEngine(jp, jcfg, JFamousConfig(impl="xla"), n_slots=2,
                          max_seq=64, prefill_mode="monolithic", **kw)
    want = [r.out for r in sorted(jeng.run(reqs(JRequest)),
                                  key=lambda r: r.rid)]
    eng = ServingEngine(params, cfg, FamousConfig(impl="pallas"), n_slots=2,
                        max_seq=64, prefill_mode="monolithic", device="cpu",
                        **kw)
    got = [r.out for r in sorted(eng.run(reqs(Request)),
                                 key=lambda r: r.rid)]
    assert got == want
    assert sorted(eng.prefill_keys) == sorted(jeng._prefill_exec)


@pytest.mark.parametrize("arch,kw", [
    ("qwen2-7b", {}),
    ("qwen2-7b", dict(cache_kind="paged", page_size=8, kv_dtype="int8")),
    ("recurrentgemma-2b", {}),
])
def test_stubbed_graphs_give_the_eager_engines_tokens(stub_graphs, arch, kw):
    """The monolithic engine with capture on (stubbed): tokens and launch
    counts equal to eager; each prefill length is captured on its second
    use, so the ``prefill`` census equals the number of lengths used twice
    or more (buckets 16 and 32 here; a recurrent stack's exact lengths
    17 twice)."""
    cfg, _, _, params = _weights(arch)
    rng = np.random.default_rng(9)
    lens = (3, 12, 17, 18, 18, 30, 31)
    prompts = [tokens(rng, cfg.vocab_size, n) for n in lens]

    def serve():
        eng = ServingEngine(params, cfg, FamousConfig(impl="pallas"),
                            n_slots=2, max_seq=64, prefill_mode="monolithic",
                            device="cpu", **kw)
        lib.STATS.reset()
        done = sorted(eng.run([Request(rid=i, tokens=list(p), max_new=4)
                               for i, p in enumerate(prompts)]),
                      key=lambda r: r.rid)
        assert all(r.error is None and len(r.out) == 4 for r in done)
        return [r.out for r in done], eng, lib.STATS.snapshot()

    with graphs.disable_capture():
        eager, eng_e, counts_e = serve()
    graphed, eng_g, counts_g = serve()
    assert graphed == eager and counts_g == counts_e
    assert not any(eng_e.compilations.values())
    keys = [len(p) - 1 for p in prompts]
    if eng_g.bucketed:
        keys = [min(1 << (m - 1).bit_length(), 64) for m in keys]
    twice = {k for k in keys if keys.count(k) >= 2}
    assert eng_g.compilations["prefill"] == len(twice) == \
        eng_g.prefill_compilations
    assert sorted(eng_g.graph_stats["keys"]["prefill"]) == \
        sorted(str(k) for k in twice)
    assert eng_g.graph_stats["replays"]["prefill"] == \
        sum(keys.count(k) - 1 for k in twice)


@pytest.mark.parametrize("ids", [[3, 1, 0, 0, 0, 0], [2, 0, 2, 0, 5, 0],
                                 [4, 4, 4, 1, 0, 4]])
def test_scatter_pages_takes_the_last_writer(ids):
    """``transformer._scatter_pages`` with repeated page ids (null and
    not): every named page holds the last stretch that names it, as the
    sequential write leaves it; on the null-padded table it is JAX's
    ``_scatter_pages``."""
    rng = np.random.default_rng(11)
    n_p, ps, kv, dh = len(ids), 4, 2, 8
    pool = rng.standard_normal((8, ps, kv, dh)).astype(np.float32)
    seq = rng.standard_normal((n_p * ps, kv, dh)).astype(np.float32)
    got = transformer._scatter_pages(torch.from_numpy(pool.copy()),
                                     torch.from_numpy(seq),
                                     torch.tensor(ids))
    want = pool.copy()
    for i, pid in enumerate(ids):
        want[pid] = seq[i * ps:(i + 1) * ps]
    np.testing.assert_array_equal(got.numpy(), want)
    if ids[0] != 0 and ids[ids.index(0):] == [0] * (n_p - ids.index(0)):
        theirs = jtransformer._scatter_pages(
            jnp.asarray(pool), jnp.asarray(seq),
            jnp.asarray(ids, jnp.int32))
        np.testing.assert_array_equal(got.numpy(), np.asarray(theirs))
