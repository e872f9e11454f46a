"""PyTorch port, linear-recurrence kernels: the plain versions of
``rglru_scan`` and ``wkv6_scan`` (what the wrappers run for CPU tensors)
against the JAX Pallas kernels in interpret mode, the sequential oracles
against JAX's, the carried-state wkv6 (``s0`` in, ``s_final`` out) against
``repro.models.rwkv6.wkv6_chunked``, the model-level ``rglru_scan`` (h0
fold and pad mask) against JAX's, and the no-fallback rule for tensors that
are not on the CPU.

Inputs are drawn from numpy seeds and handed to both sides.  Tolerances:
1e-5 (atol and rtol) at f32 for the RG-LRU scan and for the carried-state
wkv6 (the same chunked algorithm on both sides); 1e-4 / rtol 1e-3 for the
chunked wkv6 against the sequential or the Pallas kernel, JAX's own
tolerance for chunked against sequential (tests/test_kernels.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import random_jax_params
from repro.configs.base import get_config as jget_config
from repro.configs.base import shrink as jshrink
from repro.kernels.scan import ops as jscan_ops
from repro.kernels.scan import ref as jscan_ref
from repro.models import rglru as jrglru
from repro.models import rwkv6 as jrwkv6
from repro_torch import convert
from repro_torch.configs.base import get_config, shrink
from repro_torch.core.famous import FamousConfig
from repro_torch.kernels import lib
from repro_torch.kernels.scan import linear_scan, ops, ref
from repro_torch.models import rglru

F32_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _ab(seed, B, S, R):
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, R))))
    b = 0.1 * rng.standard_normal((B, S, R))
    return a.astype(np.float32), b.astype(np.float32)


def _rkvwu(seed, B, H, S, dh):
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, H, S, dh)) for _ in range(3))
    logw = -np.exp(np.clip(rng.standard_normal((B, H, S, dh)), -20, 0))
    u = 0.5 * rng.standard_normal((H, dh))
    return [x.astype(np.float32) for x in (r, k, v, logw, u)]


@pytest.mark.parametrize("B,S,R,br,bs", [
    (2, 128, 96, 32, 32),
    (1, 64, 256, 128, 64),
    (3, 96, 32, 32, 32),
])
def test_rglru_plain_matches_pallas_interpret(B, S, R, br, bs):
    a, b = _ab(B * S + R, B, S, R)
    want = jscan_ops.rglru(jnp.asarray(a), jnp.asarray(b), block_r=br,
                           block_s=bs, interpret=True)
    got = ops.rglru(_t(a), _t(b))
    assert got.dtype == torch.float32 and got.shape == (B, S, R)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)
    np.testing.assert_allclose(
        ref.rglru_reference(_t(a), _t(b)).numpy(),
        np.asarray(jscan_ref.rglru_reference(jnp.asarray(a), jnp.asarray(b))),
        atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("B,H,S,dh,chunk", [
    (2, 3, 128, 16, 32),
    (1, 2, 64, 32, 64),
    (2, 1, 96, 16, 32),
])
def test_wkv6_plain_matches_pallas_interpret(B, H, S, dh, chunk):
    r, k, v, logw, u = _rkvwu(B * H + S, B, H, S, dh)
    want = jscan_ops.wkv6(*(jnp.asarray(x) for x in (r, k, v, logw, u)),
                          chunk=chunk, interpret=True)
    got, s_final = ops.wkv6(*(_t(x) for x in (r, k, v, logw, u)), chunk=chunk)
    assert got.shape == (B, H, S, dh) and s_final.shape == (B, H, dh, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-3)
    # the sequential oracles agree with each other, and with the chunks
    flat = [x.reshape(B * H, S, dh) for x in (r, k, v, logw)]
    uu = np.broadcast_to(u[None], (B, H, dh)).reshape(B * H, dh)
    seq = ref.wkv6_reference(*(_t(x) for x in flat), _t(uu))
    jseq = jscan_ref.wkv6_reference(*(jnp.asarray(x) for x in flat),
                                    jnp.asarray(uu))
    np.testing.assert_allclose(seq.numpy(), np.asarray(jseq), atol=F32_TOL,
                               rtol=F32_TOL)
    np.testing.assert_allclose(got.reshape(B * H, S, dh).numpy(),
                               seq.numpy(), atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("B,H,S,dh,chunk", [(2, 3, 64, 16, 16),
                                            (1, 2, 64, 8, 64)])
def test_wkv6_carried_state_matches_wkv6_chunked(B, H, S, dh, chunk):
    r, k, v, logw, u = _rkvwu(7 + S, B, H, S, dh)
    s0 = np.random.default_rng(S).standard_normal(
        (B, H, dh, dh)).astype(np.float32)
    want, want_s = jrwkv6.wkv6_chunked(
        *(jnp.asarray(x) for x in (r, k, v, logw, u)), s0=jnp.asarray(s0),
        chunk=chunk)
    got, got_s = ops.wkv6(*(_t(x) for x in (r, k, v, logw, u)), s0=_t(s0),
                          chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               atol=F32_TOL, rtol=F32_TOL)
    # two halves carried through s_final equal one pass over the whole
    half = S // 2
    first, s_mid = ops.wkv6(*(_t(x[:, :, :half]) for x in (r, k, v, logw)),
                            _t(u), s0=_t(s0), chunk=min(chunk, half))
    second, s_end = ops.wkv6(*(_t(x[:, :, half:]) for x in (r, k, v, logw)),
                             _t(u), s0=s_mid, chunk=min(chunk, half))
    np.testing.assert_allclose(torch.cat([first, second], 2).numpy(),
                               got.numpy(), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(s_end.numpy(), got_s.numpy(), atol=1e-4,
                               rtol=1e-3)


@pytest.mark.parametrize("BH,S,dh,chunk,elems", [
    (32, 256, 64, 64, 1056768),      # rwkv6-1.6b's 256-token chunk
    (32, 2048, 64, 64, 8454144),     # a 2048-token prompt
    (3, 60, 40, 20, 21960),
])
def test_wkv6_workspace_formula(BH, S, dh, chunk, elems):
    """The kernel's first pass writes, per (batch·head, chunk), the chunk's
    state increment (dh x dh), its decay exp(cw_C) (dh) and qexp (chunk x
    dh) for the second pass; the wrapper sizes its f32 workspace by the C
    plan, which ``chip_smoke.py`` holds to this formula on the card."""
    n_chunks = S // chunk
    assert linear_scan.wkv6_workspace_elems(BH, S, dh, chunk) == elems
    assert elems == BH * n_chunks * (dh * dh + dh + chunk * dh)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("S,n_valid,carry", [(8, 8, True), (8, 5, True),
                                             (16, 3, False)])
def test_model_rglru_scan_matches_jax(impl, S, n_valid, carry):
    """``models.rglru.rglru_scan`` — the gates, the decay, the h0 fold and
    the pad mask around the kernel — against JAX's on the same weights."""
    jcfg = jshrink(jget_config("recurrentgemma-2b"))
    cfg = shrink(get_config("recurrentgemma-2b"))
    jp = random_jax_params(jcfg, seed=3)
    jrec = {n: a[0] for n, a in jp["blocks"]["pos0"]["rec"].items()}
    rec = convert.params_from_jax(jp, cfg, "cpu")["layers"][0]["rec"]
    R = cfg.lru_width
    rng = np.random.default_rng(S + n_valid)
    xc = rng.standard_normal((2, S, R)).astype(np.float32)
    h0 = rng.standard_normal((2, R)).astype(np.float32) if carry else None
    want = jrglru.rglru_scan(jrec, jnp.asarray(xc),
                             None if h0 is None else jnp.asarray(h0),
                             jnp.int32(n_valid))
    got = rglru.rglru_scan(rec, _t(xc), None if h0 is None else _t(h0),
                           n_valid, FamousConfig(impl=impl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("call", [
    lambda t: linear_scan.rglru_scan(t((1, 8, 32)), t((1, 8, 32))),
    lambda t: linear_scan.wkv6_scan(t((2, 8, 16)), t((2, 8, 16)),
                                    t((2, 8, 16)), t((2, 8, 16)), t((2, 16))),
    lambda t: linear_scan.wkv6_scan(t((2, 8, 16)), t((2, 8, 16)),
                                    t((2, 8, 16)), t((2, 8, 16)), t((2, 16)),
                                    t((2, 16, 16)), chunk=8),
])
def test_scan_wrappers_never_fall_back_off_the_cpu(call):
    """A tensor that is not on the CPU goes to the kernel launch, which
    refuses it here; the plain version is never returned instead."""
    def t(shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")
    before = dict(lib.STATS.launches), dict(lib.STATS.plain_on_cuda)
    with pytest.raises(ValueError, match="CUDA tensors"):
        call(t)
    assert (lib.STATS.launches, lib.STATS.plain_on_cuda) == before
