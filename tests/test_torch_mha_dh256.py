"""PyTorch port, the MHA kernels above head dim 128 (recurrentgemma-2b's
local attention has 10 query heads over one kv head of 256 in a
2048-token window).

The plain versions of ``mha_forward``, ``mha_bwd_dq`` and ``mha_bwd_dkv``
(what the wrappers run for CPU tensors, and what ``chip_smoke.py`` holds
the CUDA kernels to) against the JAX package's ``mha_forward`` /
``mha_backward`` in Pallas interpret mode at dh 256 and 200 (not a
multiple of 16), 2 query heads over 1 kv head, causal with a window;
``ref.mha_forward_tc_reference`` with the 64-row blocks the bf16 forward
runs above dh 128 (``mha.forward_block_rows``) against the same; and the
launch check's head-dim bound (256 accepted, 257 refused) on tensors off
the CPU.  Tolerances: f32 1e-5 (atol and rtol); the bf16 mirror 2e-2,
the forward's bf16 gate."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (sets the torch thread count)
from repro.kernels.attention import mha as jmha
from repro_torch.kernels.attention import mha as tmha
from repro_torch.kernels.attention import ref as tref

F32_TOL = 1e-5
BF16_TOL = 2e-2
H, KV = 2, 1


def _inputs(S, dh, window, seed):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((H, S, dh)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((KV, S, dh)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=True, window=window, scale=dh ** -0.5, q_offset=0)
    return (q, k, v, do), kw


def _jax(q, k, v, do, kw, dtype=jnp.float32):
    jq, jk, jv, jdo = (jnp.asarray(a, dtype) for a in (q, k, v, do))
    S = q.shape[1]
    out, lse = jmha.mha_forward(jq, jk, jv, block_q=S, block_k=S,
                                interpret=True, return_lse=True, **kw)
    grads = jmha.mha_backward(jq, jk, jv, out, lse, jdo, block_q=S,
                              block_k=S, interpret=True, **kw)
    return out, lse, grads


@pytest.mark.parametrize("part", ["forward", "dq", "dkv"])
@pytest.mark.parametrize("dh", [256, 200])
def test_plain_versions_match_jax_above_dh128(part, dh):
    (q, k, v, do), kw = _inputs(64, dh, 32, seed=dh)
    jout, jlse, (jdq, jdk, jdv) = _jax(q, k, v, do, kw)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = tmha.mha_forward(tq, tk, tv, return_lse=True, **kw)
    delta = (tdo * out).sum(-1)
    if part == "forward":
        got, want = (out, lse), (jout, jlse)
    elif part == "dq":
        got = (tmha.mha_bwd_dq(tq, tk, tv, tdo, lse, delta, **kw),)
        want = (jdq,)
    else:
        got = tmha.mha_bwd_dkv(tq, tk, tv, tdo, lse, delta, **kw)
        want = (jdk, jdv)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=F32_TOL,
                                   rtol=F32_TOL)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_forward_mirror_with_dh256_blocks_matches_jax(dt):
    """The bf16 forward's algebra at dh 256: 64-row blocks, here three of
    them and a ragged fourth, each starting its keys at its first row's
    window tile; 2 key-range splits."""
    tdtype, jdtype = {"f32": (torch.float32, jnp.float32),
                      "bf16": (torch.bfloat16, jnp.bfloat16)}[dt]
    (q, k, v, do), kw = _inputs(150, 256, 70, seed=7)
    jout, jlse, _ = _jax(q, k, v, do, kw, jdtype)
    rows = tmha.forward_block_rows(256)
    assert rows == 64
    out, lse = tref.mha_forward_tc_reference(
        *(torch.from_numpy(a).to(tdtype) for a in (q, k, v)), splits=2,
        block_rows=rows, tile_keys=64, **kw)
    tol = F32_TOL if dt == "f32" else BF16_TOL
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dh,rows", [(64, 128), (96, 128), (128, 128),
                                     (129, 64), (256, 64)])
def test_forward_block_rows_follow_the_tensor_core_geometry(dh, rows):
    assert tmha.forward_block_rows(dh) == rows


@pytest.mark.parametrize("dh,error", [(256, "CUDA tensors"),
                                      (257, "head dim at most 256")])
def test_launch_check_takes_dh256_and_refuses_257(dh, error):
    """Off the CPU the launch path checks shapes first: dh 256 passes to
    the device check (which refuses the meta tensors here), dh 257 is
    refused for its head dim."""
    def t(shape):
        return torch.empty(shape, device="meta")
    for call in (
            lambda: tmha.mha_forward(t((2, 8, dh)), t((1, 8, dh)),
                                     t((1, 8, dh))),
            lambda: tmha.mha_bwd_dq(t((2, 8, dh)), t((1, 8, dh)),
                                    t((1, 8, dh)), t((2, 8, dh)), t((2, 8)),
                                    t((2, 8))),
            lambda: tmha.mha_bwd_dkv(t((2, 8, dh)), t((1, 8, dh)),
                                     t((1, 8, dh)), t((2, 8, dh)),
                                     t((2, 8)), t((2, 8)))):
        with pytest.raises(ValueError, match=error):
            call()
