"""PyTorch port, the FAMOUS attention core: the port's flat ``mha`` kernels
(their plain versions on the CPU) against the JAX package's Pallas kernels
in interpret mode, forward and gradients; ``famous.attention`` for the
three impls; ``attention_xla``'s flash autograd function against
``jax.grad``; the ``matmul_tiled`` VJP; and the paper's Table I topology.
Inputs come from numpy seeds.  Tolerance at f32: 2e-5 forward, 1e-4
gradients (sums taken in another order); 2e-2 at bf16."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (sets the torch thread count)
from repro.core import famous as jfamous
from repro.kernels.attention import ops as jattn_ops
from repro.kernels.qkv import qkv_proj as jqkv_proj
from repro_torch import convert
from repro_torch.core import famous as tfamous
from repro_torch.kernels.attention import mha as tmha
from repro_torch.kernels.attention import ops as tattn_ops
from repro_torch.kernels.attention import ref as tref
from repro_torch.kernels.qkv import qkv_proj as tqkv_proj

F32, GRAD = 2e-5, 1e-4


def _arr(rng, shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _np(t):
    return convert.to_numpy(t)


# B, Sq, Skv, H, KV, dh, causal, window, q_offset
MHA_CASES = {
    "causal-mha": (2, 32, 32, 4, 4, 16, True, 0, 0),
    "bidirectional-gqa2": (2, 32, 32, 4, 2, 16, False, 0, 0),
    "window-gqa2": (1, 32, 32, 4, 2, 16, True, 8, 0),
    "q_offset": (1, 16, 32, 2, 1, 16, True, 0, 16),
    # rows 0..3 sit before every key: fully masked, expect 0
    "masked-rows": (1, 16, 16, 2, 2, 16, True, 0, -4),
}


@pytest.mark.parametrize("case", list(MHA_CASES))
def test_mha_matches_jax_pallas(case):
    """Forward, LSE and q/k/v gradients of the port's ``mha`` (plain
    versions) against ``repro.kernels.attention.ops.mha`` in interpret
    mode, with blocks of 16 so the JAX grid has several tiles."""
    B, Sq, Skv, H, KV, dh, causal, window, q_offset = MHA_CASES[case]
    rng = np.random.default_rng(7)
    q, k, v = (_arr(rng, (B, Sq, H, dh)), _arr(rng, (B, Skv, KV, dh)),
               _arr(rng, (B, Skv, KV, dh)))
    w = _arr(rng, (B, Sq, H, dh), 1.0)
    kw = dict(causal=causal, window=window, q_offset=q_offset)

    def jloss(q, k, v):
        out = jattn_ops.mha(q, k, v, block_q=16, block_k=16, interpret=True,
                            **kw)
        return jnp.sum(out * w), out

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(q, k, v)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    tout = tattn_ops.mha(tq, tk, tv, block_q=16, block_k=16, **kw)
    (tout * _t(w)).sum().backward()
    np.testing.assert_allclose(_np(tout), np.asarray(jout), atol=F32,
                               rtol=F32)
    for name, t, j in zip("qkv", (tq, tk, tv), jg):
        np.testing.assert_allclose(_np(t.grad), np.asarray(j), atol=GRAD,
                                   rtol=GRAD, err_msg=f"d{name}")
    if q_offset < 0:
        dead = slice(0, -q_offset)
        assert torch.all(tout[:, dead] == 0)
        assert torch.all(tq.grad[:, dead] == 0)


@pytest.mark.parametrize("case", ["window-gqa2", "masked-rows"])
def test_mha_lse_is_the_logsumexp_of_the_visible_scores(case):
    B, Sq, Skv, H, KV, dh, causal, window, q_offset = MHA_CASES[case]
    rng = np.random.default_rng(8)
    q = _t(_arr(rng, (B * H, Sq, dh)))
    k = _t(_arr(rng, (B * KV, Skv, dh)))
    scale = dh ** -0.5
    out, lse = tmha.mha_forward(q, k, k, causal=causal, window=window,
                                q_offset=q_offset, return_lse=True)
    s = q @ k.repeat_interleave(H // KV, 0).transpose(1, 2) * scale
    ok = tref.visible(Sq, Skv, causal=causal, window=window,
                      q_offset=q_offset, device="cpu")
    want = torch.logsumexp(s.masked_fill(~ok, float("-inf")), -1)
    rows = ok.any(-1)
    np.testing.assert_allclose(lse[:, rows].numpy(), want[:, rows].numpy(),
                               atol=F32, rtol=F32)
    assert torch.all(lse[:, ~rows] < -1e29) and torch.all(out[:, ~rows] == 0)
    ref = tref.mha_reference(q, k, k, causal=causal, window=window,
                             q_offset=q_offset)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=F32, rtol=F32)


def test_mha_bf16_matches_jax_pallas():
    B, Sq, Skv, H, KV, dh, causal, window, q_offset = MHA_CASES["window-gqa2"]
    rng = np.random.default_rng(9)
    q, k, v = (jnp.asarray(_arr(rng, s), jnp.bfloat16)
               for s in ((B, Sq, H, dh), (B, Skv, KV, dh), (B, Skv, KV, dh)))
    jout = jattn_ops.mha(q, k, v, causal=causal, window=window, block_q=16,
                         block_k=16, interpret=True)
    tout = tattn_ops.mha(*(convert.to_torch(np.asarray(a), "cpu")
                           for a in (q, k, v)), causal=causal, window=window)
    assert tout.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(tout), np.asarray(jout, np.float32),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("impl", ["reference", "xla", "pallas"])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 8)])
def test_attention_matches_jax(impl, causal, window):
    """``famous.attention`` per impl against JAX's same impl; tile_k=16 so
    the xla impl takes its flash path (Skv = 32)."""
    rng = np.random.default_rng(3)
    q, k, v = (_arr(rng, (2, 32, 4, 16)), _arr(rng, (2, 32, 2, 16)),
               _arr(rng, (2, 32, 2, 16)))
    jcfg = jfamous.FamousConfig(impl=impl, tile_q=16, tile_k=16)
    tcfg = tfamous.FamousConfig(impl=impl, tile_q=16, tile_k=16)
    jout = jfamous.attention(q, k, v, causal=causal, window=window, cfg=jcfg)
    tout = tfamous.attention(_t(q), _t(k), _t(v), causal=causal,
                             window=window, cfg=tcfg)
    np.testing.assert_allclose(_np(tout), np.asarray(jout), atol=F32,
                               rtol=F32)


@pytest.mark.parametrize("tile_k", [16, 64])
def test_attention_xla_autograd_matches_jax_grad(tile_k):
    """The flash autograd function (tile_k=16: four key tiles) and the
    reference fallback (tile_k=64 > Skv) against ``jax.grad`` through
    JAX's ``attention_xla``."""
    rng = np.random.default_rng(4)
    q, k, v = (_arr(rng, (2, 64, 4, 16)), _arr(rng, (2, 64, 2, 16)),
               _arr(rng, (2, 64, 2, 16)))
    w = _arr(rng, (2, 64, 4, 16), 1.0)

    def jloss(q, k, v):
        return jnp.sum(jfamous.attention_xla(q, k, v, causal=True, window=24,
                                             block_k=tile_k) * w)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = tfamous.attention_xla(tq, tk, tv, causal=True, window=24,
                                block_k=tile_k)
    (out * _t(w)).sum().backward()
    for name, t, j in zip("qkv", (tq, tk, tv), jg):
        np.testing.assert_allclose(_np(t.grad), np.asarray(j), atol=GRAD,
                                   rtol=GRAD, err_msg=f"d{name}")


def test_matmul_tiled_vjp_matches_jax():
    """dX = g·Wᵀ and dW = Xᵀ·g through the port's kernel wrapper against
    JAX's custom VJP of the Pallas kernel (interpret mode)."""
    rng = np.random.default_rng(5)
    x, w, g = _arr(rng, (32, 64)), _arr(rng, (64, 48)), _arr(rng, (32, 48))
    jout, vjp = jax.vjp(
        lambda x, w: jqkv_proj.matmul_tiled(x, w, block_t=16, block_f=16,
                                            block_d=32, interpret=True), x, w)
    jdx, jdw = vjp(g)
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    tout = tqkv_proj.matmul_tiled(tx, tw)
    tout.backward(_t(g))
    for t, j in ((tout, jout), (tx.grad, jdx), (tw.grad, jdw)):
        np.testing.assert_allclose(_np(t), np.asarray(j), atol=GRAD,
                                   rtol=GRAD)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_mha_block_matches_jax(impl):
    rng = np.random.default_rng(6)
    D, H, KV, dh = 64, 4, 2, 16
    x = _arr(rng, (2, 32, D), 1.0)
    p = {"wq": _arr(rng, (D, H, dh), D ** -0.5),
         "wk": _arr(rng, (D, KV, dh), D ** -0.5),
         "wv": _arr(rng, (D, KV, dh), D ** -0.5),
         "bq": _arr(rng, (H, dh), 0.1), "bk": _arr(rng, (KV, dh), 0.1),
         "bv": _arr(rng, (KV, dh), 0.1),
         "wo": _arr(rng, (H, dh, D), (H * dh) ** -0.5)}
    kw = dict(num_heads=H, num_kv_heads=KV, causal=True)
    jout = jfamous.mha_block(x, p, cfg=jfamous.FamousConfig(
        impl=impl, tile_d=32, tile_q=16, tile_k=16), **kw)
    tout = tfamous.mha_block(_t(x), {n: _t(a) for n, a in p.items()},
                             cfg=tfamous.FamousConfig(impl=impl), **kw)
    np.testing.assert_allclose(_np(tout), np.asarray(jout), atol=GRAD,
                               rtol=GRAD)


def test_table_one_impls_agree():
    """examples/quickstart.py on the port: the paper's Table I topology
    (SL=64, d_model=768, h=8), the three impls agree with each other and
    with JAX's reference."""
    B, SL, D, H = 1, 64, 768, 8
    dh = D // H
    rng = np.random.default_rng(0)
    x = _arr(rng, (B, SL, D), 1.0)
    ws = [_arr(rng, (D, H, dh), 0.05) for _ in range(3)]
    jcfg = jfamous.FamousConfig(impl="reference", tile_d=64)
    jq, jk, jv = jfamous.qkv_projection(x, *ws, cfg=jcfg)
    want = np.asarray(jfamous.attention(jq, jk, jv, causal=False, cfg=jcfg))
    for impl in ("reference", "xla", "pallas"):
        cfg = tfamous.FamousConfig(impl=impl, tile_d=64, tile_q=64, tile_k=64)
        q, k, v = tfamous.qkv_projection(_t(x), *map(_t, ws), cfg=cfg)
        out = tfamous.attention(q, k, v, causal=False, cfg=cfg)
        np.testing.assert_allclose(_np(out), want, atol=1e-4, rtol=1e-4,
                                   err_msg=impl)


@pytest.mark.parametrize("B,S,H", [(1, 8, 4), (2, 8, 4), (3, 1, 2)])
def test_flat_layout_is_contiguous_for_the_kernels(B, S, H):
    """The kernels read flat rows; a batch of one must not leave a strided
    view behind."""
    x = torch.randn(B, S, H, 16)
    flat = tattn_ops._to_flat(x)
    assert flat.is_contiguous() and flat.shape == (B * H, S, 16)
    assert torch.equal(tattn_ops._from_flat(flat, B, H), x)


@pytest.mark.parametrize("call", [
    lambda t: tmha.mha_forward(t((4, 8, 16)), t((2, 8, 16)), t((2, 8, 16))),
    lambda t: tmha.mha_backward(t((4, 8, 16)), t((2, 8, 16)), t((2, 8, 16)),
                                t((4, 8, 16)), t((4, 8)), t((4, 8, 16))),
])
def test_mha_wrappers_never_fall_back_off_the_cpu(call):
    """A tensor that is not on the CPU goes to the kernel launch, which
    refuses it here; the plain version is never returned instead."""
    from repro_torch.kernels import lib

    def t(shape):
        return torch.empty(shape, device="meta")
    before = dict(lib.STATS.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        call(t)
    assert lib.STATS.launches == before
