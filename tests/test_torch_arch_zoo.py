"""PyTorch port over every architecture of the JAX package: a port of
``tests/test_arch_smoke.py`` on the same shrunk configs, each held to the
JAX package on the same weights instead of to finiteness alone.

* ``transformer.forward`` logits against JAX within 1e-5 (f32; rtol, and
  atol relative to the largest logit), the stub frontends (hubert-xlarge, llava-next-34b) fed the same
  numpy embeddings;
* one train step: its loss and gradient norm against JAX's jitted step
  from the same state and batch (1e-5), the step counted and the
  parameters finite;
* prefill of 8 tokens + 4 decode steps against the full forward at JAX's
  tolerances (5e-2 for MoE, whose capacity drops depend on the group,
  5e-4 otherwise), every decoder (llava-next-34b on tokens, as the engine
  serves it);
* ``param_count`` and ``active_param_count`` equal to JAX's, and the
  full configs in their advertised parameter classes;
* the frontends: the data pipeline's frontend batches bit-equal to JAX's
  numpy ones, and the stub module's shapes, dtypes and documentation.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import config_as_jax, random_jax_params
from repro.configs import base as jbase
from repro.configs.base import get_config as jget_config
from repro.configs.base import shrink as jshrink
from repro.core.famous import FamousConfig as JFamousConfig
from repro.data import pipeline as jpipeline
from repro.models import frontends as jfrontends
from repro.models import module as jax_module
from repro.models import transformer as jtransformer
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.configs.base import get_config, shrink
from repro_torch.core.famous import FamousConfig
from repro_torch.data import pipeline
from repro_torch.models import frontends, module, transformer
from repro_torch.train import step as step_lib

TOL = 1e-5
ARCHS = jbase.list_configs()
DECODERS = [a for a in ARCHS if not jget_config(a).is_encoder_only]


@functools.lru_cache(maxsize=None)
def _weights(arch, seed=4):
    cfg, jcfg = shrink(get_config(arch)), jshrink(jget_config(arch))
    return cfg, jcfg, random_jax_params(jcfg, seed=seed)


def _inputs(cfg, B=2, S=32, seed=1):
    rng = np.random.default_rng(seed)
    if cfg.frontend:
        return (0.02 * rng.standard_normal((B, S, cfg.d_model))).astype(
            np.float32)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _torch_inputs(x):
    t = torch.from_numpy(x)
    return t if t.is_floating_point() else t.long()


def test_registry_equals_jax_field_for_field():
    """Every JAX config is the port's, on the JAX dataclass's fields; the
    port's own fields (latent attention, DeepSeek-V3's routing, leading
    dense layers) stay off in them.  The port-only configs
    (``base.PORT_ONLY``) have no JAX twin to compare."""
    assert [n for n in base.list_configs()
            if n not in base.PORT_ONLY] == ARCHS
    for name in ARCHS:
        assert config_as_jax(get_config(name), jget_config(name)) == \
            dataclasses.asdict(jget_config(name))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch):
    cfg, jcfg, jp = _weights(arch)
    x = _inputs(cfg)
    want = np.asarray(jtransformer.forward(jp, jnp.asarray(x), jcfg,
                                           JFamousConfig(impl="xla"),
                                           remat=False))
    got = transformer.forward(convert.tree_from_jax(jp, "cpu"),
                              _torch_inputs(x), cfg,
                              FamousConfig(impl="pallas"),
                              remat=False).numpy()
    assert got.shape == (2, 32, cfg.vocab_size)
    assert np.isfinite(got).all(), arch
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(),
                               rtol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_jax(arch):
    cfg, jcfg, _ = _weights(arch)
    jtcfg = jstep.TrainConfig(compute_dtype=jnp.float32, loss_chunk=16)
    jstate = jstep.init_state(jcfg, jtcfg, jax.random.PRNGKey(0))
    state = convert.train_state_from_jax(jstate, "cpu")
    x = _inputs(cfg)
    tgt = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 32))
    jts = jstep.make_train_step(jcfg, JFamousConfig(impl="xla"), jtcfg)
    _, jm = jax.jit(jts)(jstate, {"inputs": jnp.asarray(x),
                                  "targets": jnp.asarray(tgt, jnp.int32)})
    ts = step_lib.make_train_step(cfg, FamousConfig(impl="pallas"),
                                  step_lib.TrainConfig(
                                      compute_dtype=torch.float32,
                                      loss_chunk=16))
    state, m = ts(state, {"inputs": _torch_inputs(x),
                          "targets": torch.from_numpy(tgt)})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=TOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=TOL)
    assert int(state["step"]) == 1
    assert all(bool(torch.isfinite(p).all())
               for p in module.tree_leaves(state["params"])), arch


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_consistency(arch):
    """prefill(first half) + decode(second half) == full forward logits,
    on the JAX test's weights (``init_params`` from ``PRNGKey(0)``); each
    step's logits also equal to JAX's prefill + decode within 1e-5."""
    cfg, jcfg = shrink(get_config(arch)), jshrink(jget_config(arch))
    jp = jax_module.init_params(jtransformer.model_spec(jcfg),
                                jax.random.PRNGKey(0), jnp.float32)
    tree = convert.tree_from_jax(jp, "cpu")
    B, S = 2, 16
    rng = np.random.default_rng(1)
    toks_np = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    toks = torch.from_numpy(toks_np).long()
    fcfg = FamousConfig(impl="pallas")
    full = transformer.forward(tree, toks, cfg, fcfg, remat=False)
    params = transformer.prepare_params(tree, cfg)
    caches = transformer.make_caches(cfg, B, S, torch.float32, "cpu")
    jcaches = jtransformer.make_caches(jcfg, B, S, jnp.float32)
    lg, caches = transformer.prefill(params, toks[:, :8], caches, cfg, fcfg)
    jlg, jcaches = jtransformer.prefill(jp, jnp.asarray(toks_np[:, :8]),
                                        jcaches, jcfg)
    errs = [float((lg - full[:, 7]).abs().max())]
    jax_errs = [float(np.abs(lg.numpy() - np.asarray(jlg)).max())]
    clen = torch.full((B,), 8, dtype=torch.int32)
    for t in range(8, 12):
        lg, caches = transformer.decode_step(params, toks[:, t], caches,
                                             clen, cfg, fcfg)
        jlg, jcaches = jtransformer.decode_step(
            jp, jnp.asarray(toks_np[:, t]), jcaches,
            jnp.full((B,), t, jnp.int32), jcfg)
        clen = clen + 1
        errs.append(float((lg - full[:, t]).abs().max()))
        jax_errs.append(float(np.abs(lg.numpy() - np.asarray(jlg)).max()))
    tol = 5e-2 if cfg.num_experts else 5e-4  # MoE capacity-drop variance
    assert max(errs) < tol, (arch, errs)
    assert max(jax_errs) < TOL * max(1.0, float(full.abs().max())), (
        arch, jax_errs)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    n = cfg.param_count()
    assert n == jcfg.param_count() > 0
    assert cfg.active_param_count() == jcfg.active_param_count()
    if cfg.num_experts:
        assert cfg.active_param_count() < n
    else:
        assert cfg.active_param_count() == n


def test_full_param_counts_roughly_match_names():
    """Sanity: the full configs land in the advertised parameter class."""
    expect = {
        "qwen2-7b": (6e9, 9e9),
        "qwen3-32b": (28e9, 40e9),
        "deepseek-7b": (6e9, 8.5e9),
        "command-r-plus-104b": (90e9, 120e9),
        "grok-1-314b": (250e9, 340e9),
        "kimi-k2-1t-a32b": (0.9e12, 1.2e12),
        "rwkv6-1.6b": (1.2e9, 2.2e9),
        "hubert-xlarge": (0.8e9, 1.3e9),
        "recurrentgemma-2b": (2e9, 3.5e9),
        "llava-next-34b": (30e9, 40e9),
    }
    for arch, (lo, hi) in expect.items():
        n = get_config(arch).param_count()
        assert lo <= n <= hi, f"{arch}: {n/1e9:.2f}B not in [{lo/1e9}, {hi/1e9}]"


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if jget_config(a).frontend])
def test_frontend_batches_bit_equal_to_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    shape = base.ShapeConfig("frontend", 24, 3, "train")
    jshape = jbase.ShapeConfig("frontend", 24, 3, "train")
    for step in (0, 5):
        got = pipeline.host_batch(cfg, shape, 7, step, lo=1, hi=3)
        want = jpipeline.host_batch(jcfg, jshape, 7, step, lo=1, hi=3)
        assert set(got) == set(want) == {"inputs", "targets"}
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    assert got["inputs"].shape == (2, 24, cfg.d_model)
    dev = pipeline.device_batch(cfg, shape, 7, 0, "cpu")
    assert dev["inputs"].dtype == torch.float32
    assert dev["targets"].dtype == torch.int64


def test_frontend_stubs():
    assert frontends.FRONTEND_DOC == jfrontends.FRONTEND_DOC
    for arch in ("hubert-xlarge", "llava-next-34b"):
        cfg = get_config(arch)
        assert frontends.embed_shape(cfg, 2, 9) == jfrontends.embed_shape(
            jget_config(arch), 2, 9)
        s = frontends.input_struct(cfg, 2, 9)
        assert (s.shape, s.dtype, s.device.type) == (
            (2, 9, cfg.d_model), torch.bfloat16, "meta")
        x = frontends.synthetic_embeddings(
            cfg, 2, 9, torch.Generator().manual_seed(3), device="cpu")
        y = frontends.synthetic_embeddings(
            cfg, 2, 9, torch.Generator().manual_seed(3), device="cpu")
        assert x.dtype == torch.float32 and torch.equal(x, y)
        assert 0.015 < float(x.std()) < 0.025
