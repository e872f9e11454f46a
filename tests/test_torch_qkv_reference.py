"""PyTorch port: ``kernels/qkv/ref.qkv_reference`` against JAX's (f32 and
bf16, with and without biases) and ``models/module.is_spec_tree_leaf``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.qkv import ref as jref
from repro.models import module as jmodule
from repro_torch.kernels.qkv import ref
from repro_torch.models import module

torch.set_num_threads(1)
TOL = {"float32": 1e-6, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
def test_qkv_reference_matches_jax(dtype, bias):
    rng = np.random.default_rng(0)
    B, S, D, H, KV, dh = 2, 7, 48, 4, 2, 12
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    ws = [rng.standard_normal((D, h, dh)).astype(np.float32) / np.sqrt(D)
          for h in (H, KV, KV)]
    bs = ([rng.standard_normal((h, dh)).astype(np.float32) * 0.1
           for h in (H, KV, KV)] if bias else [None] * 3)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jref.qkv_reference(
        jnp.asarray(x, jdt), *(jnp.asarray(w, jdt) for w in ws),
        *(None if b is None else jnp.asarray(b, jdt) for b in bs))
    got = ref.qkv_reference(
        torch.from_numpy(x).to(tdt), *(torch.from_numpy(w).to(tdt)
                                       for w in ws),
        *(None if b is None else torch.from_numpy(b).to(tdt) for b in bs))
    for g, w, h in zip(got, want, (H, KV, KV)):
        assert g.dtype == tdt and tuple(g.shape) == (B, S, h, dh)
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), w, atol=TOL[dtype],
                                   rtol=TOL[dtype])


def test_is_spec_tree_leaf():
    spec = module.ParamSpec((2, 3), ("embed", None))
    jspec = jmodule.ParamSpec((2, 3), ("embed", None))
    for x in (spec, {"w": spec}, (2, 3), torch.zeros(2), None):
        assert module.is_spec_tree_leaf(x) == jmodule.is_spec_tree_leaf(
            jspec if x is spec else x)
    assert module.is_spec_tree_leaf(spec)
    assert not module.is_spec_tree_leaf({"w": spec})
