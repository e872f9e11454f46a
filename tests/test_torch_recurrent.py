"""PyTorch port, recurrent families: recurrentgemma-2b (RG-LRU + sliding-
window attention) and rwkv6-1.6b (RWKV-6), shrunk, against the JAX package
on the same weights (``convert.params_from_jax``; every leaf drawn from
numpy).

Each ported block (the RG-LRU chunk and decode, the RWKV-6 time mix chunk
and decode and the channel mix, the ring-buffer branch of chunked prefill
and decode) on a prompt that wraps the 16-token window and ends in a pad
tail; ``prefill_chunk`` + ``decode_step`` logits and state; and engine
token identity with the JAX engine, greedy and seeded, on prompts that are
partial, exact, multi-chunk, past the window and of length 1, with slot
reuse and a slot mid-prefill while others decode.  Tolerance 1e-5 at f32
(logits: 1e-5 absolute and relative)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import config_as_jax, random_jax_params, tokens
from repro.configs.base import get_config as jget_config
from repro.configs.base import shrink as jshrink
from repro.core import famous as jfamous
from repro.core.famous import FamousConfig as JFamousConfig
from repro.models import attention as jattention
from repro.models import rglru as jrglru
from repro.models import rwkv6 as jrwkv6
from repro.models import transformer as jtransformer
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JServingEngine
from repro_torch import convert
from repro_torch.configs.base import get_config, shrink
from repro_torch.core import famous
from repro_torch.core.famous import FamousConfig
from repro_torch.models import attention, module, rglru, rwkv6, transformer
from repro_torch.serve.engine import Request, ServingEngine

TOL = 1e-5
ARCHS = ("recurrentgemma-2b", "rwkv6-1.6b")
IMPLS = ("xla", "pallas")
C, MAX_SEQ = 8, 64


def _cfgs(arch):
    return shrink(get_config(arch)), jshrink(jget_config(arch))


def _t(a):
    return convert.to_torch(np.asarray(a), "cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               atol=tol, rtol=tol)


def _weights(arch, seed=3):
    cfg, jcfg = _cfgs(arch)
    jp = random_jax_params(jcfg, seed=seed)
    return cfg, jcfg, jp, convert.params_from_jax(jp, cfg, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_spec_trees_are_copies(arch):
    from repro.models import module as jmodule
    cfg, jcfg = _cfgs(arch)
    assert config_as_jax(cfg, jcfg) == dataclasses.asdict(jcfg)
    assert config_as_jax(get_config(arch), jget_config(arch)) == \
        dataclasses.asdict(jget_config(arch))
    tleaves = module.tree_leaves(transformer.model_spec(cfg))
    jleaves = jmodule._leaves_with_path(jtransformer.model_spec(jcfg))[0]
    assert [(s.shape, s.init, s.scale) for s in tleaves] == \
        [(s.shape, s.init, s.scale) for _, s in jleaves]
    assert transformer.layer_kinds(cfg) == \
        tuple(cfg.pattern_unit) * cfg.num_units + tuple(cfg.tail_layers)


def test_uniform_init_keeps_the_jax_range():
    cfg, _ = _cfgs("rwkv6-1.6b")
    p = module.init_params(transformer.model_spec(cfg),
                           torch.Generator().manual_seed(0), torch.float32,
                           "cpu")
    mu = p["blocks"]["pos0"]["tm"]["mu"]             # uniform, scale 0.5
    assert float(mu.abs().max()) <= 0.5 and float(mu.std()) > 0.2


def _chunks(prompt):
    """(start, n_valid, padded tokens) of each C-token chunk."""
    out = []
    for start in range(0, len(prompt), C):
        n = min(C, len(prompt) - start)
        toks = np.zeros((1, C), np.int32)
        toks[0, :n] = prompt[start:start + n]
        out.append((start, n, toks))
    return out


def _x(rng, cfg, shape):
    return rng.standard_normal(shape + (cfg.d_model,)).astype(np.float32)


@pytest.mark.parametrize("impl", IMPLS)
def test_rglru_chunk_and_decode_match_jax(impl):
    cfg, jcfg, jp, params = _weights("recurrentgemma-2b")
    jrec = {n: a[0] for n, a in jp["blocks"]["pos0"]["rec"].items()}
    rec = params["layers"][0]["rec"]
    rng = np.random.default_rng(1)
    R = cfg.lru_width
    state = {"h": rng.standard_normal((1, R)).astype(np.float32),
             "conv": rng.standard_normal((1, 3, R)).astype(np.float32)}
    for n_valid in (C, 5, 1):
        x = _x(rng, cfg, (1, C))
        want, wstate = jrglru.apply_rglru_chunk(
            jrec, jnp.asarray(x), jcfg, {k: jnp.asarray(v) for k, v in
                                         state.items()}, jnp.int32(n_valid))
        got, gstate = rglru.apply_rglru_chunk(
            rec, _t(x), cfg, {k: _t(v) for k, v in state.items()}, n_valid,
            FamousConfig(impl=impl))
        _close(got[:, :n_valid], want[:, :n_valid])
        for k in ("h", "conv"):
            _close(gstate[k], wstate[k])
        state = {k: np.asarray(v) for k, v in wstate.items()}
    cache = {"h": rng.standard_normal((3, R)).astype(np.float32),
             "conv": rng.standard_normal((3, 3, R)).astype(np.float32)}
    x = _x(rng, cfg, (3, 1))
    want, wnew = jrglru.apply_rglru_decode(
        jrec, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache.items()},
        jcfg)
    got, gnew = rglru.apply_rglru_decode(
        rec, _t(x), {k: _t(v) for k, v in cache.items()}, cfg)
    _close(got, want)
    for k in ("h", "conv"):
        _close(gnew[k], wnew[k])


@pytest.mark.parametrize("impl", IMPLS)
def test_rwkv_time_mix_and_channel_mix_match_jax(impl):
    cfg, jcfg, jp, params = _weights("rwkv6-1.6b")
    jtm = {n: a[0] for n, a in jp["blocks"]["pos0"]["tm"].items()}
    jcm = {n: a[0] for n, a in jp["blocks"]["pos0"]["cm"].items()}
    tm, cm = params["layers"][0]["tm"], params["layers"][0]["cm"]
    rng = np.random.default_rng(2)
    H, dh = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    state = {"s": rng.standard_normal((1, H, dh, dh)).astype(np.float32),
             "x_tm": _x(rng, cfg, (1,))}
    for n_valid in (C, 6, 1):
        x = _x(rng, cfg, (1, C))
        want, wst = jrwkv6.apply_rwkv_time_mix_chunk(
            jtm, jnp.asarray(x), {k: jnp.asarray(v) for k, v in state.items()},
            jcfg, jnp.int32(n_valid))
        got, gst = rwkv6.apply_rwkv_time_mix_chunk(
            tm, _t(x), {k: _t(v) for k, v in state.items()}, cfg, n_valid,
            fcfg=FamousConfig(impl=impl))
        _close(got[:, :n_valid], want[:, :n_valid])
        for k in ("s", "x_tm"):
            _close(gst[k], wst[k])
        state = {k: np.asarray(v) for k, v in wst.items()}
        prev = _x(rng, cfg, (1,))
        wy, wlast = jrwkv6.apply_channel_mix(jcm, jnp.asarray(x), jcfg,
                                             cache_x=jnp.asarray(prev))
        gy, glast = rwkv6.apply_channel_mix(cm, _t(x), cfg, cache_x=_t(prev))
        _close(gy, wy)
        _close(glast, wlast)
    cache = {"s": rng.standard_normal((3, H, dh, dh)).astype(np.float32),
             "x_tm": _x(rng, cfg, (3,))}
    x = _x(rng, cfg, (3, 1))
    want, wnew = jrwkv6.apply_rwkv_time_mix_decode(
        jtm, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache.items()},
        jcfg)
    got, gnew = rwkv6.apply_rwkv_time_mix_decode(
        tm, _t(x), {k: _t(v) for k, v in cache.items()}, cfg)
    _close(got, want)
    for k in ("s", "x_tm"):
        _close(gnew[k], wnew[k])


def test_attention_at_positions_matches_jax():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 8, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 24, 1, 16)).astype(np.float32)
    v = rng.standard_normal((1, 24, 1, 16)).astype(np.float32)
    # a gathered 16-row ring before the chunk: positions 4..19, of which
    # the first four were never written (negative), then the chunk itself
    q_pos = np.arange(20, 28)
    ring = np.arange(4, 20)
    ring[:4] = -1 - np.arange(4)
    k_pos = np.concatenate([ring, q_pos])
    for window in (0, 16):
        want = jfamous.attention_at_positions(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(q_pos), jnp.asarray(k_pos), window=window)
        got = famous.attention_at_positions(
            _t(q), _t(k), _t(v), torch.from_numpy(q_pos),
            torch.from_numpy(k_pos), window=window)
        _close(got, want)


@pytest.mark.parametrize("impl", IMPLS)
def test_ring_chunk_and_decode_match_jax(impl):
    """The local-attention layer (pattern position 2) of recurrentgemma on
    its 16-row ring: a 37-token prompt in 8-token chunks (the ring wraps
    twice, the last chunk has a pad tail), then a decode step of every slot
    (slot 0 empty, slot 2 mid-sequence)."""
    cfg, jcfg, jp, params = _weights("recurrentgemma-2b")
    jattn = {n: a[0] for n, a in jp["blocks"]["pos2"]["attn"].items()}
    p = params["layers"][2]["attn"]
    fcfg, jfcfg = FamousConfig(impl=impl), JFamousConfig(impl="xla")
    W = cfg.window
    jcache = jattention.make_attn_cache(jcfg, 3, MAX_SEQ, W, jnp.float32)
    cache = attention.make_attn_cache(cfg, 3, MAX_SEQ, torch.float32, "cpu",
                                      window=W)
    assert cache["k"].shape == (3, W, cfg.num_kv_heads, cfg.head_dim)
    rng = np.random.default_rng(6)
    for slot, length in ((1, 37), (2, 11)):
        for start in range(0, length, C):
            n = min(C, length - start)
            x = _x(rng, cfg, (1, C))
            want, jcache = jattention.apply_attn_chunk(
                jattn, jnp.asarray(x), jcache, jnp.int32(slot),
                jnp.int32(start), jnp.int32(n), jcfg, jfcfg, window=W)
            got, _ = attention.apply_attn_chunk(p, _t(x), cache, slot, start,
                                                n, cfg, fcfg, window=W)
            _close(got[:, :n], want[:, :n])
            for name in ("k", "v"):
                _close(cache[name], jcache[name])
    clen = np.array([0, 37, 11], np.int32)
    x = _x(rng, cfg, (3, 1))
    want, jcache = jattention.apply_attn_decode(
        jattn, jnp.asarray(x), jcache, jnp.asarray(clen), jcfg, jfcfg,
        window=W)
    got, _ = attention.apply_attn_decode(p, _t(x), cache,
                                         torch.from_numpy(clen), cfg, fcfg,
                                         window=W)
    _close(got, want)
    for name in ("k", "v"):
        _close(cache[name], jcache[name])


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_then_decode_matches_jax(arch, impl):
    """Slot 1 prefills a 21-token prompt (past the 16-token window, three
    chunks, a pad tail) on a slot that held another sequence (offset 0
    zeroes its state); slot 0 sits mid-prefill during the decode step and
    must keep its recurrent state (the ``active`` mask)."""
    cfg, jcfg, jp, params = _weights(arch)
    fcfg, jfcfg = FamousConfig(impl=impl), JFamousConfig(impl="xla")
    jcaches = jtransformer.make_caches(jcfg, 2, MAX_SEQ, jnp.float32)
    caches = transformer.make_caches(cfg, 2, MAX_SEQ, torch.float32, "cpu")
    rng = np.random.default_rng(7)
    old, prompt, half = (tokens(rng, cfg.vocab_size, n) for n in (12, 21, 8))
    for slot, seq in ((1, old), (0, half), (1, prompt)):
        for start, n, toks in _chunks(seq):
            jcaches = jtransformer.prefill_chunk(
                jp, jnp.asarray(toks), jcaches, jnp.int32(slot),
                jnp.int32(start), jnp.int32(n), jcfg, jfcfg)
            transformer.prefill_chunk(params, torch.from_numpy(toks).long(),
                                      caches, slot, start, n, cfg, fcfg)
    last = np.array([half[-1], prompt[-1]], np.int32)
    clen = np.array([len(half), len(prompt) - 1], np.int32)
    active = np.array([False, True])
    for _ in range(2):
        jlogits, jcaches = jtransformer.decode_step(
            jp, jnp.asarray(last), jcaches, jnp.asarray(clen), jcfg, jfcfg,
            active=jnp.asarray(active))
        logits, _ = transformer.decode_step(
            params, torch.from_numpy(last).long(), caches,
            torch.from_numpy(clen), cfg, fcfg,
            active=torch.from_numpy(active))
        assert logits.shape == (2, cfg.vocab_size)
        _close(logits[1], jlogits[1])
        last[1] = int(np.argmax(np.asarray(jlogits[1])))
        clen[1] += 1
    back = convert.caches_from_jax(jcaches, cfg, device="cpu")
    for kind, mine, theirs in zip(transformer.layer_kinds(cfg), caches, back):
        for name, buf in mine.items():
            if kind in ("rglru", "rwkv6") or name in ("k", "v"):
                _close(buf, theirs[name])


def _serve_both(arch, prompts, hot=None, n_slots=2, jkw=None, **kw):
    cfg, jcfg, jp, params = _weights(arch, seed=5)
    hot = hot or [{}] * len(prompts)

    def reqs(cls):
        return [cls(rid=i, tokens=list(p), max_new=5, **hot[i])
                for i, p in enumerate(prompts)]

    jeng = JServingEngine(jp, jcfg, JFamousConfig(impl="xla"),
                          n_slots=n_slots, max_seq=MAX_SEQ, chunk=C,
                          **(jkw or kw))
    jdone = sorted(jeng.run(reqs(JRequest)), key=lambda r: r.rid)
    outs = {}
    for impl in IMPLS:
        eng = ServingEngine(params, cfg, FamousConfig(impl=impl),
                            n_slots=n_slots, max_seq=MAX_SEQ, chunk=C,
                            device="cpu", **kw)
        done = sorted(eng.run(reqs(Request)), key=lambda r: r.rid)
        assert all(r.error is None for r in done)
        outs[impl] = [r.out for r in done]
    return [r.out for r in jdone], outs, jeng, eng


def _prompts(arch):
    """Partial, exact, multi-chunk, past the 16-token window, length 1, and
    more requests than slots (slots are reused); the 40-token prompt
    prefills over several steps while the other slot decodes."""
    rng = np.random.default_rng(8 if arch == ARCHS[0] else 9)
    return [tokens(rng, 256, n) for n in (5, 8, 40, 1, 17, 26)]


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_jax_engine(arch):
    want, outs, jeng, eng = _serve_both(arch, _prompts(arch))
    assert outs == {"xla": want, "pallas": want}
    # the engines' final cache state, every leaf of every layer (rings,
    # RG-LRU h/conv, RWKV s/x_tm/x_cm), carried over from JAX's engine
    cfg = eng.cfg
    back = convert.caches_from_jax(jeng.caches, cfg, device="cpu")
    assert len(back) == len(eng.caches) == cfg.num_layers
    for mine, theirs in zip(eng.caches, back):
        assert set(mine) == set(theirs)
        for name, buf in mine.items():
            assert buf.dtype == theirs[name].dtype
            _close(buf, theirs[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_seeded_tokens_match_jax_engine(arch):
    prompts = _prompts(arch)
    hot = [dict(temperature=0.9, seed=7), dict(temperature=1.3, top_k=5,
                                               seed=11),
           dict(temperature=0.6, top_k=3)] * 2
    want, outs, _, _ = _serve_both(arch, prompts, hot)
    assert outs == {"xla": want, "pallas": want}


@pytest.mark.parametrize("arch", ARCHS)
def test_fallbacks_match_jax_engine(arch):
    """Speculation and the prefix cache need position-addressed, pooled
    state: both engines fall back to plain decode and cold prefill on
    these stacks, and serve the same tokens as without the options."""
    prompts = _prompts(arch)[:4]
    kw = dict(cache_kind="paged", page_size=8, prefix_cache=True,
              speculative=True, draft_k=3)
    want, outs, jeng, eng = _serve_both(arch, prompts, **kw)
    assert outs == {"xla": want, "pallas": want}
    assert (eng.speculative_active, eng.prefix_cache_active) == \
        (jeng.speculative_active, jeng.prefix_cache_active) == (False, False)
    plain, _, _, _ = _serve_both(arch, prompts)
    assert want == plain
