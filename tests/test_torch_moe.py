"""PyTorch port, the token-choice MoE FFN (``repro_torch.models.moe``)
against the JAX package's ``repro.models.moe`` on the same numpy inputs.

* ``router_dispatch`` over seeds, (E, K) in {(8, 2), (4, 1), (16, 4),
  (384, 8)}, capacity factors 0.5 / 1.25 / 2.0 and softcap 0 / 30:
  ``dispatch`` exactly equal (dropped tokens included), ``combine`` and
  the aux loss within 1e-6;
* the JAX suite's MoE invariants (``tests/test_properties.py``): one
  token per (expert, slot), at most K slots a token, combine weights in
  [0, 1], aux > 0.5, and capacity drops monotone in the capacity factor;
* ``_group_shape`` equal for T = 1..600;
* ``apply_moe`` (with ``return_aux``) and ``aux_load_balance_loss``
  against JAX at f32 within 1e-5, token counts on and off the 256-token
  group size, and the spec's shapes and dtypes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs.base import get_config as jget_config
from repro.configs.base import shrink as jshrink
from repro.models import moe as jmoe
from repro_torch.configs.base import get_config, shrink
from repro_torch.models import module, moe

torch.set_num_threads(1)
SETTINGS = dict(max_examples=6, deadline=None)


def _logits(seed, G, S, E, scale=4.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((G, S, E))).astype(np.float32)


def _dispatch_both(logits, K, cf, softcap):
    jd, jc, ja = jmoe.router_dispatch(jnp.asarray(logits), K, cf, softcap)
    d, c, a = moe.router_dispatch(torch.from_numpy(logits), K, cf, softcap)
    assert d.dtype == torch.bfloat16 and c.dtype == torch.float32
    return ((np.asarray(jd, np.float32), np.asarray(jc), float(ja)),
            (d.float().numpy(), c.numpy(), float(a)))


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("cf", [0.5, 1.25, 2.0])
@pytest.mark.parametrize("ek", [(8, 2), (4, 1), (16, 4), (384, 8)])
def test_router_dispatch_matches_jax(ek, cf, softcap):
    E, K = ek
    for seed in range(2):
        logits = _logits(seed * 31 + E, 2, 32, E)
        (jd, jc, ja), (d, c, a) = _dispatch_both(logits, K, cf, softcap)
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_allclose(c, jc, atol=1e-6, rtol=0)
        assert abs(a - ja) <= 1e-6 * max(1.0, abs(ja))


def test_router_dispatch_drops_tokens_as_jax():
    """At capacity factor 0.5 the capacity (4 slots an expert for 32
    tokens over 4 experts) drops tokens, the same ones as JAX."""
    logits = _logits(3, 2, 32, 4)
    (jd, _, _), (d, _, _) = _dispatch_both(logits, 1, 0.5, 0.0)
    assert d.sum() < 2 * 32 * 1
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(d.sum(axis=(2, 3)), jd.sum(axis=(2, 3)))


@settings(**SETTINGS)
@given(st.integers(0, 5), st.sampled_from([(8, 2), (4, 1), (16, 4)]),
       st.floats(1.0, 2.0))
def test_router_dispatch_invariants(seed, ek, cf):
    E, K = ek
    G, S = 2, 32
    logits = torch.from_numpy(_logits(seed, G, S, E, scale=1.0))
    dispatch, combine, aux = moe.router_dispatch(logits, K, cf)
    d = dispatch.float().numpy()
    c = combine.numpy()
    # each (expert, slot) pair holds at most one token
    assert d.sum(axis=1).max() <= 1.0 + 1e-6
    # each token occupies at most K slots, combine weights sum to <= 1
    assert d.sum(axis=(2, 3)).max() <= K + 1e-6
    assert c.sum(axis=(2, 3)).max() <= 1.0 + 1e-5
    assert c.min() >= 0.0
    # aux loss is >= 1 (perfect balance) up to estimator noise
    assert float(aux) > 0.5


@settings(**SETTINGS)
@given(st.integers(0, 3))
def test_moe_capacity_drop_monotone(seed):
    """Higher capacity factor can only reduce dropped tokens."""
    E, K, G, S = 8, 2, 2, 64
    logits = torch.from_numpy(_logits(seed, G, S, E, scale=1.0))
    kept = []
    for cf in (0.5, 1.0, 2.0):
        d, _, _ = moe.router_dispatch(logits, K, cf)
        kept.append(float(d.float().sum()))
    assert kept[0] <= kept[1] <= kept[2]


def test_group_shape_matches_jax():
    for T in range(1, 601):
        assert moe._group_shape(T) == jmoe._group_shape(T), T


# shrunk MoE configs: grok-1's softcapped GELU top-2 of 8 and kimi-k2's
# fine-grained SiLU top-8 of 32
MOE = {"grok-1-314b": dict(num_experts=8, experts_per_token=2),
       "kimi-k2-1t-a32b": dict(num_experts=32, experts_per_token=8)}


def _moe_params(arch, seed=0):
    cfg = shrink(get_config(arch), **MOE[arch])
    jcfg = jshrink(jget_config(arch), **MOE[arch])
    rng = np.random.default_rng(seed)
    spec = moe.moe_spec(cfg)
    p = {}
    for name, s in spec.items():
        fan_in = s.shape[0] if name == "router" else s.shape[1]
        p[name] = (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
            np.float32)
    return cfg, jcfg, p


def test_moe_spec_matches_jax():
    for arch in MOE:
        cfg, jcfg, _ = _moe_params(arch)
        spec, jspec = moe.moe_spec(cfg), jmoe.moe_spec(jcfg)
        assert set(spec) == set(jspec)
        for name in spec:
            assert spec[name].shape == jspec[name].shape
            assert spec[name].axes == jspec[name].axes
            assert spec[name].scale == jspec[name].scale
        assert spec["router"].dtype == torch.float32
        assert module.count_params(spec) == sum(
            int(np.prod(s.shape)) for s in jspec.values())


@pytest.mark.parametrize("BS", [(2, 16), (2, 300), (1, 5)])
@pytest.mark.parametrize("arch", list(MOE))
def test_apply_moe_and_aux_match_jax(arch, BS):
    cfg, jcfg, p = _moe_params(arch)
    x = np.random.default_rng(1).standard_normal(
        BS + (cfg.d_model,)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jy, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg, return_aux=True)
    y, aux = moe.apply_moe(tp, torch.from_numpy(x), cfg, return_aux=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    y2 = moe.apply_moe(tp, torch.from_numpy(x), cfg)
    assert torch.equal(y2, y)
    la = moe.aux_load_balance_loss(tp, torch.from_numpy(x), cfg)
    jla = jmoe.aux_load_balance_loss(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(float(la), float(jla), rtol=1e-5)
