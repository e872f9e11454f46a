"""PyTorch port, whole serving slice: ``prefill_chunk`` then ``decode_step``
of the port against the JAX package's, with the same weights carried over
by ``repro_torch.convert``, on ``shrink(get_config("qwen2-7b"))``.  Every
weight leaf is drawn from numpy.  Tolerance: 1e-4 at f32."""
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
from repro_torch.configs.base import get_config, shrink
from repro_torch.core.famous import FamousConfig
from repro_torch.models import module, transformer

TOL = 1e-4
MAX_SEQ, CHUNK = 64, 8


def _configs():
    return shrink(get_config("qwen2-7b")), jshrink(jget_config("qwen2-7b"))


def test_configs_are_copies():
    import dataclasses
    t, j = _configs()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert get_config("qwen2-7b").num_layers == 28


def test_spec_tree_matches_jax():
    """Same tree, same leaf shapes, same initializers and scales."""
    from repro.models import module as jmodule
    cfg, jcfg = _configs()
    tleaves = module.tree_leaves(transformer.model_spec(cfg))
    jleaves = [s for s in jmodule._leaves_with_path(
        jtransformer.model_spec(jcfg))[0]]
    assert [(s.shape, s.init, s.scale) for s in tleaves] == \
        [(s.shape, s.init, s.scale) for _, s in jleaves]
    assert module.count_params(transformer.model_spec(cfg)) == \
        jcfg.param_count()


def test_init_params_keeps_the_jax_scales():
    """fan-in includes the stacking axis, as in ``repro.models.module``."""
    cfg, _ = _configs()
    gen = torch.Generator().manual_seed(0)
    p = module.init_params(transformer.model_spec(cfg), gen, torch.float32,
                           "cpu")
    wq = p["blocks"]["pos0"]["attn"]["wq"]                 # (2, 64, 4, 16)
    want = 1 / np.sqrt(2 * 64 * 4)
    assert abs(float(wq.std()) - want) / want < 0.1
    assert torch.all(p["blocks"]["pos0"]["attn"]["bq"] == 0)
    assert torch.all(p["final_norm"]["scale"] == 1)


@pytest.mark.parametrize("timpl", ["xla", "pallas"])
def test_prefill_chunk_then_decode_matches_jax(timpl):
    cfg, jcfg = _configs()
    jparams = random_jax_params(jcfg, seed=3)
    params = convert.params_from_jax(jparams, cfg, device="cpu")
    fcfg, jfcfg = FamousConfig(impl=timpl), JFamousConfig(impl="xla")
    rng = np.random.default_rng(4)
    prompt = tokens(rng, cfg.vocab_size, 13)

    jcaches = jtransformer.make_caches(jcfg, 2, MAX_SEQ, jnp.float32)
    caches = transformer.make_caches(cfg, 2, MAX_SEQ, torch.float32, "cpu")
    slot = 1
    for start in (0, CHUNK):
        n = min(CHUNK, len(prompt) - start)
        toks = np.zeros((1, CHUNK), np.int32)
        toks[0, :n] = prompt[start:start + n]
        jcaches = jtransformer.prefill_chunk(
            jparams, jnp.asarray(toks), jcaches, jnp.int32(slot),
            jnp.int32(start), jnp.int32(n), jcfg, jfcfg)
        transformer.prefill_chunk(params, torch.from_numpy(toks).long(),
                                  caches, slot, start, n, cfg, fcfg)
    # slot 0 is inactive (length 0): it decodes junk, as in JAX
    last = np.array([7, prompt[-1]], np.int32)
    clen = np.array([0, len(prompt)], np.int32)
    jlogits, jcaches = jtransformer.decode_step(
        jparams, jnp.asarray(last), jcaches, jnp.asarray(clen), jcfg, jfcfg)
    logits, caches = transformer.decode_step(
        params, torch.from_numpy(last).long(), caches,
        torch.from_numpy(clen), cfg, fcfg)
    assert logits.dtype == torch.float32 and logits.shape == (2, 256)
    np.testing.assert_allclose(logits[1].numpy(), np.asarray(jlogits[1]),
                               atol=TOL, rtol=TOL)
    # the written K/V of the live slot agree too (cache trees carried over)
    back = convert.caches_from_jax(jcaches, cfg, device="cpu")
    for mine, theirs in zip(caches, back):
        for n in ("k", "v"):
            np.testing.assert_allclose(
                mine[n][slot, :len(prompt) + 1].numpy(),
                theirs[n][slot, :len(prompt) + 1].numpy(), atol=TOL,
                rtol=TOL)


def test_bf16_leaves_cross_as_uint16_views():
    a = jnp.asarray(np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4),
                    jnp.bfloat16)
    t = convert.to_torch(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(convert.to_numpy(t),
                                  np.asarray(a.astype(jnp.float32)))


def test_qkv_is_fused_once_at_load():
    cfg, jcfg = _configs()
    params = convert.params_from_jax(random_jax_params(jcfg), cfg, "cpu")
    attn = params["layers"][0]["attn"]
    w = attn["w_qkv"]
    assert w.shape == (64, 4 * 16 + 2 * 2 * 16) and w.is_contiguous()
    # the separate leaves are views into the fused matrix
    for name in ("wq", "wk", "wv"):
        assert attn[name].untyped_storage().data_ptr() == \
            w.untyped_storage().data_ptr()
