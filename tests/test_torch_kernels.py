"""PyTorch port, kernel modules: the port's ``famous.qkv_projection``,
``chunked_prefill_attention`` and ``decode_attention`` against the JAX
package's, on the same numpy inputs, at f32 and bf16.

The port runs every impl on the CPU: ``impl="pallas"`` there is the plain
PyTorch version beside each Hopper kernel.  The JAX side runs ``impl="xla"``
and ``impl="pallas"`` (its Pallas kernels in interpret mode, as the JAX
suite runs them on the CPU).  Tolerance: 1e-5 at f32, 2e-2 at bf16."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (sets the torch thread count)
from repro.core import famous as jfamous
from repro_torch import convert
from repro_torch.core import famous as tfamous
from repro_torch.kernels.decode import ref as dec_ref
from repro_torch.kernels.qkv import ref as qkv_ref

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(rng, shape, dt, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    j = jnp.asarray(a, DTYPES[dt][0])
    return j, convert.to_torch(np.asarray(j), "cpu")


def _close(t, j, tol, rows=None):
    t = convert.to_numpy(t)
    j = np.asarray(jnp.asarray(j, jnp.float32))
    if rows is not None:
        t, j = t[rows], j[rows]
    np.testing.assert_allclose(t, j, atol=tol, rtol=tol)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("jimpl", ["xla", "pallas"])
@pytest.mark.parametrize("timpl", ["reference", "xla", "pallas"])
@pytest.mark.parametrize("bias", [True, False])
def test_qkv_projection_matches_jax(dt, jimpl, timpl, bias):
    rng = np.random.default_rng(0)
    D, H, KV, dh = 64, 4, 2, 16
    x = _pair(rng, (2, 8, D), dt)
    ws = [_pair(rng, (D, n, dh), dt, 1 / np.sqrt(D)) for n in (H, KV, KV)]
    bs = ([_pair(rng, (n, dh), dt, 0.1) for n in (H, KV, KV)] if bias
          else [(None, None)] * 3)
    jcfg = jfamous.FamousConfig(impl=jimpl, tile_d=32)
    tcfg = tfamous.FamousConfig(impl=timpl, tile_d=32)
    jout = jfamous.qkv_projection(x[0], *[w[0] for w in ws],
                                  *[b[0] for b in bs], cfg=jcfg)
    tout = tfamous.qkv_projection(x[1], *[w[1] for w in ws],
                                  *[b[1] for b in bs], cfg=tcfg)
    for t, j in zip(tout, jout):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t, j, DTYPES[dt][2])


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("jimpl", ["xla", "pallas"])
@pytest.mark.parametrize("timpl", ["xla", "pallas"])
@pytest.mark.parametrize("offset", [0, 24, 56])
def test_chunked_prefill_attention_matches_jax(dt, jimpl, timpl, offset):
    rng = np.random.default_rng(1)
    C, H, KV, dh, Skv = 8, 4, 2, 16, 64
    q = _pair(rng, (1, C, H, dh), dt)
    k = _pair(rng, (1, Skv, KV, dh), dt)
    v = _pair(rng, (1, Skv, KV, dh), dt)
    jout = jfamous.chunked_prefill_attention(
        q[0], k[0], v[0], jnp.int32(offset),
        cfg=jfamous.FamousConfig(impl=jimpl))
    tout = tfamous.chunked_prefill_attention(
        q[1], k[1], v[1], offset, cfg=tfamous.FamousConfig(impl=timpl))
    _close(tout, jout, DTYPES[dt][2])


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("jimpl", ["xla", "pallas"])
@pytest.mark.parametrize("timpl", ["xla", "pallas"])
def test_decode_attention_matches_jax(dt, jimpl, timpl):
    """Slot 0 is empty: the dense oracles give NaN there and the kernels
    0, so the comparison covers the non-empty rows only."""
    rng = np.random.default_rng(2)
    B, H, KV, dh, Skv = 4, 4, 2, 16, 128
    lens = np.array([0, 1, 37, Skv], np.int32)
    q = _pair(rng, (B, 1, H, dh), dt)
    k = _pair(rng, (B, Skv, KV, dh), dt)
    v = _pair(rng, (B, Skv, KV, dh), dt)
    jout = jfamous.decode_attention(q[0], k[0], v[0], jnp.asarray(lens),
                                    cfg=jfamous.FamousConfig(impl=jimpl))
    tout = tfamous.decode_attention(q[1], k[1], v[1], torch.from_numpy(lens),
                                    cfg=tfamous.FamousConfig(impl=timpl))
    _close(tout, jout, DTYPES[dt][2], rows=lens > 0)


def test_plain_decode_gives_zero_for_an_empty_slot():
    """The kernels' softmax clamp: a row with no visible key is 0."""
    q = torch.randn(2, 4, 16)
    k = torch.randn(2, 32, 2, 16)
    out = dec_ref.decode_reference(q, k, k, torch.tensor([0, 5]),
                                   scale=0.25)
    assert torch.all(out[0] == 0) and torch.isfinite(out).all()


@pytest.mark.parametrize("shape", [(4, 64, 96), (37, 80, 50), (1, 16, 3)])
def test_plain_matmul_handles_ragged_shapes(shape):
    """The kernel masks ragged edges instead of asserting divisibility;
    its plain version takes any shape too."""
    T, D, F = shape
    x, w = torch.randn(T, D), torch.randn(D, F)
    out = qkv_ref.matmul_reference(x.to(torch.bfloat16), w.to(torch.bfloat16))
    assert out.dtype == torch.bfloat16 and out.shape == (T, F)
    ref = x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), rtol=1e-2,
                               atol=1e-2)
