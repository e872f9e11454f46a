"""PyTorch port, the full-sequence blocks: ``layers.rms_head_norm``, the
RG-LRU's associative scan and ``apply_rglru``, RWKV-6's ``wkv6_chunked``
and ``apply_rwkv_time_mix`` (each with and without a cache or carried
state), against the JAX package on numpy-seeded inputs; then
``transformer.forward`` logits and one ``make_train_step`` gradient on
shrunk recurrentgemma-2b and rwkv6-1.6b against JAX's forward and
``jax.grad`` of its loss.  Tolerance at f32: 1e-5 on the functions, 1e-4
on logits, the loss, the global gradient norm and every gradient leaf
(relative to the leaf's largest entry), as in ``test_torch_train.py``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import random_jax_params
from repro.configs.base import SMOKE_SHAPES as JSMOKE_SHAPES
from repro.configs.base import get_config as jget_config
from repro.configs.base import shrink as jshrink
from repro.core.famous import FamousConfig as JFamousConfig
from repro.data import pipeline as jpipeline
from repro.models import layers as jlayers
from repro.models import rglru as jrglru
from repro.models import rwkv6 as jrwkv6
from repro.models import transformer as jtransformer
from repro.train import losses as jlosses
from repro_torch import convert
from repro_torch.configs.base import SMOKE_SHAPES, get_config, shrink
from repro_torch.core.famous import FamousConfig
from repro_torch.data import pipeline
from repro_torch.models import layers, module, rglru, rwkv6, transformer
from repro_torch.optim import adamw
from repro_torch.train import step as step_lib

TOL = 1e-5
MODEL_TOL = 1e-4
IMPLS = ("xla", "pallas")


def _cfgs(arch):
    return shrink(get_config(arch)), jshrink(jget_config(arch))


def _t(a):
    return convert.to_torch(np.asarray(a), "cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               atol=tol, rtol=tol)


@functools.lru_cache(maxsize=None)
def _block(arch, name):
    """The first unit's first block's ``name`` params of a shrunk arch, as
    (JAX tree, torch tree)."""
    _, jcfg = _cfgs(arch)
    jp = random_jax_params(jcfg, seed=6)
    jb = jax.tree_util.tree_map(lambda a: a[0],
                                jp["blocks"]["pos0"][name])
    return jb, convert.tree_from_jax(jb, "cpu")


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_rms_head_norm_matches_jax():
    x = _x((2, 5, 4, 80), 1)
    scale = 1.0 + 0.1 * _x((80,), 2)
    _close(layers.rms_head_norm(_t(x), _t(scale)),
           jlayers.rms_head_norm(jnp.asarray(x), jnp.asarray(scale)))
    got = layers.rms_head_norm(_t(x).to(torch.bfloat16), _t(scale))
    assert got.dtype == torch.bfloat16


@pytest.mark.parametrize("S", [1, 2, 7, 16, 37])
def test_associative_scan_matches_jax(S):
    """The scan element by element, odd and even lengths, against
    ``jax.lax.associative_scan`` with JAX's combine."""
    a = np.random.default_rng(S).uniform(0.5, 1.0, (2, S, 8)).astype(
        np.float32)
    b = _x((2, S, 8), S)

    def combine(left, right):
        return left[0] * right[0], right[0] * left[1] + right[1]

    wa, wb = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                jnp.asarray(b)), axis=1)
    ga, gb = rglru.associative_scan(_t(a), _t(b), axis=1)
    _close(ga, wa)
    _close(gb, wb)


def test_rglru_full_scan_matches_jax():
    cfg, _ = _cfgs("recurrentgemma-2b")
    jp, tp = _block("recurrentgemma-2b", "rec")
    xc = _x((2, 40, cfg.lru_width), 3)
    _close(rglru.rglru_scan_full(tp, _t(xc)),
           jrglru.rglru_scan(jp, jnp.asarray(xc)))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("with_cache", [False, True])
def test_apply_rglru_matches_jax(impl, with_cache):
    cfg, jcfg = _cfgs("recurrentgemma-2b")
    jp, tp = _block("recurrentgemma-2b", "rec")
    x = _x((2, 24, cfg.d_model), 4)
    fcfg = FamousConfig(impl=impl)
    if not with_cache:
        _close(rglru.apply_rglru(tp, _t(x), cfg, fcfg=fcfg),
               jrglru.apply_rglru(jp, jnp.asarray(x), jcfg))
        return
    cache = {"h": _x((2, cfg.lru_width), 5),
             "conv": _x((2, cfg.conv_width - 1, cfg.lru_width), 6)}
    want, wcache = jrglru.apply_rglru(
        jp, jnp.asarray(x), jcfg, {k: jnp.asarray(v) for k, v in
                                   cache.items()})
    got, gcache = rglru.apply_rglru(
        tp, _t(x), cfg, {k: _t(v) for k, v in cache.items()}, fcfg=fcfg)
    _close(got, want)
    for k in ("h", "conv"):
        _close(gcache[k], wcache[k])


def _wkv_inputs(S, seed=0, B=2, H=3, dh=16):
    r, k, v = (_x((B, H, S, dh), seed + i) for i in range(3))
    logw = -np.exp(np.clip(_x((B, H, S, dh), seed + 3), -20.0, 0.0))
    u = 0.5 * _x((H, dh), seed + 4)
    s0 = 0.3 * _x((B, H, dh, dh), seed + 5)
    return r, k, v, logw.astype(np.float32), u, s0


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("S", [16, 48])
def test_wkv6_chunked_matches_jax(S, with_s0):
    """At S = chunk and S = 3 x chunk (chunk 16), from zero or a carried
    state: the output and the final state."""
    r, k, v, logw, u, s0 = _wkv_inputs(S, S)
    s0 = s0 if with_s0 else None
    wo, ws = jrwkv6.wkv6_chunked(
        *(jnp.asarray(a) for a in (r, k, v, logw, u)),
        s0=None if s0 is None else jnp.asarray(s0), chunk=16)
    go, gs = rwkv6.wkv6_chunked(*(_t(a) for a in (r, k, v, logw, u)),
                                s0=None if s0 is None else _t(s0), chunk=16)
    _close(go, wo)
    _close(gs, ws)


@pytest.mark.parametrize("S,chunk", [(24, 16), (65, 64), (100, 64)])
def test_wkv6_chunked_raises_off_the_chunk_grid(S, chunk):
    """JAX asserts ``S % min(chunk, S) == 0``; the port raises ValueError
    (the monolithic engine's case is in ``test_torch_monolithic.py``)."""
    r, k, v, logw, u, _ = _wkv_inputs(S, B=1, H=1, dh=4)
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        rwkv6.wkv6_chunked(*(_t(a) for a in (r, k, v, logw, u)),
                           chunk=chunk)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("with_cache", [False, True])
def test_apply_rwkv_time_mix_matches_jax(impl, with_cache):
    cfg, jcfg = _cfgs("rwkv6-1.6b")
    jp, tp = _block("rwkv6-1.6b", "tm")
    x = _x((2, 32, cfg.d_model), 7)
    fcfg = FamousConfig(impl=impl)
    if not with_cache:
        _close(rwkv6.apply_rwkv_time_mix(tp, _t(x), cfg, chunk=16,
                                         fcfg=fcfg),
               jrwkv6.apply_rwkv_time_mix(jp, jnp.asarray(x), jcfg,
                                          chunk=16))
        return
    H, dh = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    cache = {"s": 0.3 * _x((2, H, dh, dh), 8), "x_tm": _x((2, cfg.d_model),
                                                          9)}
    want, wc = jrwkv6.apply_rwkv_time_mix(
        jp, jnp.asarray(x), jcfg, {k: jnp.asarray(v) for k, v in
                                   cache.items()}, chunk=16)
    got, gc = rwkv6.apply_rwkv_time_mix(
        tp, _t(x), cfg, {k: _t(v) for k, v in cache.items()}, chunk=16,
        fcfg=fcfg)
    _close(got, want)
    for k in ("s", "x_tm"):
        _close(gc[k], wc[k])


ARCHS = ("recurrentgemma-2b", "rwkv6-1.6b")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch, impl):
    """``transformer.forward`` on the spec tree (remat on) over 32 tokens:
    past recurrentgemma's 16-token window, two rwkv6 chunks of 16."""
    cfg, jcfg = _cfgs(arch)
    jparams = random_jax_params(jcfg, seed=2)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 32))
    want = jtransformer.forward(jparams, jnp.asarray(toks, jnp.int32), jcfg,
                                JFamousConfig(impl="xla"))
    got = transformer.forward(convert.tree_from_jax(jparams, "cpu"),
                              torch.from_numpy(toks), cfg,
                              FamousConfig(impl=impl))
    assert got.shape == (2, 32, cfg.vocab_size)
    _close(got, want, MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_gradient_matches_jax(arch):
    """One ``make_train_step`` step from JAX's state: the gradient of every
    leaf against ``jax.grad`` of JAX's loss, then the step's loss and
    global gradient norm against JAX's train step."""
    from repro.optim import adamw as jadamw
    from repro.train import step as jstep
    cfg, jcfg = _cfgs(arch)
    jtcfg = jstep.TrainConfig(compute_dtype=jnp.float32, loss_chunk=16,
                              optimizer=jadamw.AdamWConfig(lr=1e-2),
                              schedule_warmup=2, schedule_total=100)
    fcfg = JFamousConfig(impl="xla")
    state = jstep.init_state(jcfg, jtcfg, jax.random.PRNGKey(1))
    state = dict(state, params=random_jax_params(jcfg, seed=4))
    batch = {k: jnp.asarray(v) for k, v in jpipeline.host_batch(
        jcfg, JSMOKE_SHAPES["smoke_train"], 0, 0).items()}
    jgrads = jax.grad(lambda p: jlosses.lm_loss(
        p, batch, jcfg, fcfg, chunk=16, compute_dtype=jnp.float32))(
            state["params"])
    init = jax.tree_util.tree_map(np.asarray, state)
    _, jm = jax.jit(jstep.make_train_step(jcfg, fcfg, jtcfg))(state, batch)

    tstate = convert.train_state_from_jax(init, "cpu")
    tcfg = step_lib.TrainConfig(compute_dtype=torch.float32, loss_chunk=16,
                                optimizer=adamw.AdamWConfig(lr=1e-2),
                                schedule_warmup=2, schedule_total=100)
    ts = step_lib.make_train_step(cfg, FamousConfig(impl="pallas"), tcfg)
    tbatch = pipeline.device_batch(cfg, SMOKE_SHAPES["smoke_train"], 0, 0,
                                   "cpu")
    _, grads = ts.grads_of(tstate["params"], tbatch)
    leaves = module.tree_leaves(grads)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b,
                                   atol=MODEL_TOL * np.abs(b).max(),
                                   rtol=MODEL_TOL)
    _, m = ts(tstate, tbatch)
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[name]), float(jm[name]),
                                   rtol=MODEL_TOL, err_msg=name)
