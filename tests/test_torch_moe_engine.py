"""PyTorch port, the serving engine on the MoE and vlm configs against the
JAX engine on the same weights: shrunk grok-1-314b (top-2 of 4 experts,
softcap 30), kimi-k2-1t-a32b (shrunk with 32 experts and top-8, its
fine-grained shape) and llava-next-34b's backbone (served tokens, as
JAX's engine serves it).  Greedy and seeded requests, token for token:

* chunked prefill on contiguous KV (8-token chunks whose pad rows are
  routed too: at least one chunk drops tokens at capacity, checked);
* monolithic prefill;
* paged KV with the prefix cache (later requests hit the shared head);
* speculative decoding, ``draft_k=2``.

Also a MoE ``prefill_chunk`` with its slot, offset and n_valid in
tensors whose host reads raise (``tests/test_torch_prefill_graph.py``'s
harness), on contiguous and paged caches, equal to the same chunks on int
scalars; and the paged pools' duplicate writes (pad rows and free slots
on the null page, which an MoE chunk's pad rows read) carrying the last
row's values, as a sequential write leaves them."""
import functools

import numpy as np
import pytest
import torch

from test_torch_prefill_graph import NoHostRead
from torch_port_helpers import random_jax_params, tokens
from repro.configs.base import get_config as jget_config
from repro.configs.base import shrink as jshrink
from repro.core.famous import FamousConfig as JFamousConfig
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JServingEngine
from repro_torch import convert
from repro_torch.configs.base import get_config, shrink
from repro_torch.core.famous import FamousConfig
from repro_torch.models import attention, moe, transformer
from repro_torch.serve.engine import Request, ServingEngine

SHRINK = {"grok-1-314b": {},
          "kimi-k2-1t-a32b": dict(num_experts=32, experts_per_token=8),
          "llava-next-34b": {}}
MODES = {"chunked": dict(chunk=8),
         "monolithic": dict(chunk=8, prefill_mode="monolithic"),
         "paged prefix": dict(chunk=8, cache_kind="paged", page_size=8,
                              prefix_cache=True),
         "speculative": dict(chunk=8, speculative=True, draft_k=2)}


@functools.lru_cache(maxsize=None)
def _weights(arch, seed=6):
    cfg = shrink(get_config(arch), **SHRINK[arch])
    jcfg = jshrink(jget_config(arch), **SHRINK[arch])
    return cfg, jcfg, random_jax_params(jcfg, seed=seed)


def _prompts(vocab):
    rng = np.random.default_rng(9)
    head = tokens(rng, vocab, 16)
    prompts = [head + tokens(rng, vocab, n) for n in (5, 11, 1)]
    # a repetitive prompt gives the prompt-lookup drafter hits
    prompts.append(tokens(rng, vocab, 3) * 4)
    prompts.append(tokens(rng, vocab, 1))
    return prompts


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", list(SHRINK))
def test_engine_tokens_match_jax(arch, mode, monkeypatch):
    cfg, jcfg, jp = _weights(arch)
    kw = MODES[mode]
    prompts = _prompts(cfg.vocab_size)

    def reqs(cls):
        return [cls(rid=i, tokens=list(p), max_new=6,
                    **(dict(temperature=0.8, top_k=4, seed=3) if i % 2
                       else {}))
                for i, p in enumerate(prompts)]

    jeng = JServingEngine(jp, jcfg, JFamousConfig(impl="xla"), n_slots=2,
                          max_seq=64, **kw)
    want = [r.out for r in sorted(jeng.run(reqs(JRequest)),
                                  key=lambda r: r.rid)]
    drops = []
    dispatch = moe.router_dispatch

    def counting(logits, K, *a, **k):
        d, c, aux = dispatch(logits, K, *a, **k)
        drops.append(float(d.float().sum()) < logits.shape[0]
                     * logits.shape[1] * K)
        return d, c, aux

    monkeypatch.setattr(moe, "router_dispatch", counting)
    eng = ServingEngine(convert.params_from_jax(jp, cfg, "cpu"), cfg,
                        FamousConfig(impl="pallas"), n_slots=2, max_seq=64,
                        device="cpu", **kw)
    done = sorted(eng.run(reqs(Request)), key=lambda r: r.rid)
    assert all(r.error is None for r in done)
    assert [r.out for r in done] == want
    if kw.get("prefix_cache"):
        assert eng.prefix_hit_tokens == jeng.prefix_hit_tokens > 0
    if kw.get("speculative"):
        assert eng.speculative_active and eng.spec_steps > 0
        assert eng.spec_accepted == jeng.spec_accepted
    if cfg.num_experts:
        assert drops and (mode != "chunked" or any(drops))
    else:
        assert not drops


@pytest.mark.parametrize("paged", [False, True])
def test_moe_prefill_chunk_reads_no_scalar_on_the_host(paged):
    cfg, _, jp = _weights("grok-1-314b")
    params = convert.params_from_jax(jp, cfg, "cpu")
    n_slots, max_seq, C, ps = 2, 32, 8, 4
    kw = dict(cache_kind="paged", page_size=ps, n_pages=1 + 2 * max_seq // ps
              ) if paged else {}
    tkw = {"page_table": torch.arange(1, 1 + 2 * max_seq // ps,
                                      dtype=torch.int32).reshape(2, -1)
           } if paged else {}
    rng = np.random.default_rng(4)
    toks = [torch.tensor([tokens(rng, cfg.vocab_size, C)]) for _ in range(3)]
    triples = [(1, 0, 8), (1, 8, 5), (0, 0, 3)]
    out = []
    for guard in (False, True):
        caches = transformer.make_caches(cfg, n_slots, max_seq,
                                         torch.float32, "cpu", **kw)
        for t, (slot, offset, n) in zip(toks, triples):
            sc = torch.tensor([slot, offset, n], dtype=torch.int32)
            scalars = [sc[0:1], sc[1:2], sc[2:3]]
            if guard:
                scalars = [NoHostRead(s) for s in scalars]
            transformer.prefill_chunk(params, t, caches, *scalars, cfg,
                                      FamousConfig(impl="pallas"), **tkw)
        out.append([{k: v.as_subclass(torch.Tensor) for k, v in c.items()}
                    for c in caches])
    for a, b in zip(*out):
        for k in a:
            assert torch.equal(a[k], b[k])


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_duplicate_paged_writes_carry_the_last_rows_values(kv_dtype):
    """Rows naming the same pool row (the null page) all write the last
    such row's values, so the pool equals a sequential write whatever
    order the device applies them in."""
    cfg = shrink(get_config("grok-1-314b"))
    cache = attention.make_paged_attn_cache(cfg, 5, 4, torch.float32,
                                            kv_dtype, "cpu")
    rng = np.random.default_rng(0)
    pids = torch.tensor([2, 0, 0, 3, 0, 0, 1])
    offs = torch.tensor([1, 3, 1, 1, 3, 1, 0])
    k = torch.from_numpy(rng.standard_normal((7, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((7, 2, 16)).astype(np.float32))
    last = attention._last_writer(pids, offs, 4)
    assert last.tolist() == [0, 4, 5, 3, 4, 5, 6]
    attention._paged_write(cache, pids, offs, k, v)
    want = {n: t.clone().zero_() for n, t in cache.items()}
    for i in range(7):   # sequential: the last write wins
        if kv_dtype == "int8":
            kq, ks = attention._kv_quantize(k[i])
            vq, vs = attention._kv_quantize(v[i])
            vals = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        else:
            vals = {"k": k[i], "v": v[i]}
        for n, val in vals.items():
            want[n][pids[i], offs[i]] = val
    for n in cache:
        assert torch.equal(cache[n], want[n]), n
