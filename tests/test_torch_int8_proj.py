"""PyTorch port, the paper's 8-bit QKV_PM (``FamousConfig(quant="int8")``):
``int8_einsum``, the int8 kernel's plain version, the int8 projection of
the xla and pallas impls and ``mha_block`` against the JAX package on the
same numpy inputs, load-time against per-call weight quantization, and
the int8 serving engine token for token against the JAX engine with the
same config (JAX's Pallas kernels in interpret mode).

Tolerance: the int8 projection is exact (integer products and sums, then
the same two f32 multiplies in the same order), so it is compared bit for
bit with the JAX functions run eagerly; attention after it 1e-5 at f32
(sums in another order).  Under ``jax.jit`` XLA turns quantize's division
of the scale by 127 into a multiply by the rounded reciprocal, which moves
a few scales by one ulp: the jitted JAX engine is held to the port's
tokens, not its bits."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import random_jax_params, tokens
from repro.configs.base import get_config as jget_config
from repro.configs.base import shrink as jshrink
from repro.core import famous as jfamous
from repro.core import quant as jquant
from repro.kernels.qkv import qkv_proj as jqkv_proj
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JServingEngine
from repro_torch import convert
from repro_torch.configs.base import get_config, shrink
from repro_torch.core import famous as tfamous
from repro_torch.core import quant as tquant
from repro_torch.kernels.qkv import ops as qkv_ops
from repro_torch.kernels.qkv import qkv_proj
from repro_torch.kernels.qkv import ref as qkv_ref
from repro_torch.models import attention, transformer
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.train import step as step_lib

CFG, JCFG = shrink(get_config("qwen2-7b")), jshrink(jget_config("qwen2-7b"))
TOL = 1e-5


def _t(a):
    return convert.to_torch(np.asarray(a), "cpu")


def _same_bits(a, b):
    """Exact equality of a torch tensor and a JAX array, compared in f32
    (bf16 widens to f32 exactly)."""
    x = a.detach().to(torch.float32).numpy()
    y = np.asarray(jnp.asarray(b, jnp.float32))
    assert x.shape == y.shape
    np.testing.assert_array_equal(x.view(np.int32), y.view(np.int32))


DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("spec,xs,ws", [
    ("...sd,dhe->...she", (2, 5, 32), (32, 4, 8)),
    ("td,df->tf", (7, 48), (48, 24)),
    ("bsd,df->bsf", (3, 4, 64), (64, 40)),
])
def test_int8_einsum_matches_jax(spec, xs, ws, dt):
    rng = np.random.default_rng(len(spec) + xs[0])
    x = rng.standard_normal(xs).astype(np.float32)
    w = (rng.standard_normal(ws) / np.sqrt(ws[0])).astype(np.float32)
    jdt, tdt = DTYPES[dt]
    want = jquant.int8_einsum(spec, jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    got = tquant.int8_einsum(spec, torch.from_numpy(x).to(tdt),
                             torch.from_numpy(w).to(tdt))
    assert got.dtype == tdt
    _same_bits(got, want)
    f32 = tquant.int8_einsum(spec, torch.from_numpy(x).to(tdt),
                             torch.from_numpy(w).to(tdt),
                             out_dtype=torch.float32)
    _same_bits(f32, jquant.int8_einsum(spec, jnp.asarray(x, jdt),
                                       jnp.asarray(w, jdt),
                                       out_dtype=jnp.float32))


def test_int8_einsum_rejects_other_contractions():
    with pytest.raises(ValueError, match="unsupported"):
        tquant.int8_einsum("td,fd->tf", torch.ones(2, 3), torch.ones(4, 3))


def _int8_operands(rng, T, D, F):
    x = rng.standard_normal((T, D)).astype(np.float32)
    w = (rng.standard_normal((D, F)) / np.sqrt(D)).astype(np.float32)
    xq, sx = jquant.quantize(jnp.asarray(x), axis=1)
    wq, sw = jquant.quantize(jnp.asarray(w), axis=0)
    return xq, wq, sx, sw


@pytest.mark.parametrize("T,D,F", [(4, 64, 96), (20, 128, 48), (7, 48, 24),
                                   (33, 512, 256), (1, 16, 8)])
def test_int8_matmul_plain_version_matches_jax_kernel(T, D, F):
    """The plain version against the Pallas kernel in interpret mode, bit
    for bit; T = 20, 7, 33 and 1 are divided by none of the CUDA kernel's
    row tiles (16, 32, 64).  The wrapper on CPU tensors takes W transposed
    and returns the same."""
    xq, wq, sx, sw = _int8_operands(np.random.default_rng(T * D), T, D, F)
    want = jqkv_proj.matmul_tiled_int8(xq, wq, sx, sw, interpret=True)
    _same_bits(qkv_ref.matmul_int8_reference(_t(xq), _t(wq), _t(sx),
                                             _t(sw)), want)
    got = qkv_proj.matmul_tiled_int8(_t(xq), _t(wq).t().contiguous(),
                                     _t(sx), _t(sw))
    assert got.dtype == torch.float32
    _same_bits(got, want)


@pytest.mark.parametrize("splits", [1, 2, 3, 5])
@pytest.mark.parametrize("T,D,F,block_k", [(4, 200, 24, 32), (20, 256, 40, 64),
                                           (7, 77, 16, 16), (33, 512, 24, 128)])
def test_int8_split_mirror_matches_jax_kernel(T, D, F, block_k, splits):
    """The split-K algebra of the CUDA kernel (int32 partials over D
    ranges of whole ``block_k`` steps, added in split order, then the two
    f32 multiplies) equals the plain version and the Pallas kernel in
    interpret mode bit for bit, at any split count, with a last split
    shorter than the others or empty, and at a D off every tile (200, 77)."""
    xq, wq, sx, sw = _int8_operands(np.random.default_rng(T + D + splits),
                                    T, D, F)
    want = jqkv_proj.matmul_tiled_int8(xq, wq, sx, sw, interpret=True)
    got = qkv_ref.matmul_int8_split_reference(
        _t(xq), _t(wq), _t(sx), _t(sw), splits=splits, block_k=block_k)
    assert got.dtype == torch.float32
    _same_bits(got, want)
    assert torch.equal(got, qkv_ref.matmul_int8_reference(
        _t(xq), _t(wq), _t(sx), _t(sw)))


def _proj_inputs(seed, dtype=np.float32, D=64, H=4, KV=2, dh=16, S=5, B=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(dtype)
    ws = [(rng.standard_normal((D, h, dh)) / np.sqrt(D)).astype(dtype)
          for h in (H, KV, KV)]
    bs = [(0.1 * rng.standard_normal((h, dh))).astype(dtype)
          for h in (H, KV, KV)]
    return x, ws, bs


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_qkv_projection_int8_matches_jax(impl, dt):
    x, ws, bs = _proj_inputs(3)
    jdt, tdt = DTYPES[dt]
    jcfg = jfamous.FamousConfig(impl=impl, quant="int8", tile_d=32)
    # eagerly: under jit XLA rewrites quantize's ``amax / 127`` into a
    # multiply by the rounded reciprocal, which moves ~3% of the scales by
    # one ulp; the port divides, as the JAX function is written
    with jax.disable_jit():
        want = jfamous.qkv_projection(jnp.asarray(x, jdt),
                                      *[jnp.asarray(a, jdt) for a in ws + bs],
                                      cfg=jcfg)
    tcfg = tfamous.FamousConfig(impl=impl, quant="int8")
    got = tfamous.qkv_projection(torch.from_numpy(x).to(tdt),
                                 *[torch.from_numpy(a).to(tdt)
                                   for a in ws + bs], cfg=tcfg)
    for g, w in zip(got, want):
        assert g.dtype == tdt
        _same_bits(g, w)


def test_reference_impl_ignores_quant():
    """JAX's reference branch never reads ``quant``; neither does the
    port's, so quant="int8" gives the fp reference projection."""
    x, ws, bs = _proj_inputs(4)
    jargs = [jnp.asarray(a) for a in ws + bs]
    targs = [torch.from_numpy(a) for a in ws + bs]
    tx = torch.from_numpy(x)
    fp = tfamous.qkv_projection(tx, *targs, cfg=tfamous.FamousConfig(
        impl="reference", tile_d=16))
    i8 = tfamous.qkv_projection(tx, *targs, cfg=tfamous.FamousConfig(
        impl="reference", tile_d=16, quant="int8"))
    want = jfamous.qkv_projection(jnp.asarray(x), *jargs,
                                  cfg=jfamous.FamousConfig(
                                      impl="reference", tile_d=16,
                                      quant="int8"))
    for a, b, w in zip(fp, i8, want):
        assert torch.equal(a, b)
        np.testing.assert_allclose(b.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)
    xla = tfamous.qkv_projection(tx, *targs, cfg=tfamous.FamousConfig(
        impl="xla", quant="int8"))
    assert not torch.equal(xla[0], i8[0])   # the xla impl does quantize


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_mha_block_int8_table_one(impl):
    """The paper's Table I topology (SL=64, d_model=768, h=8), non-causal,
    with the int8 projection, against JAX's xla impl (its projection is
    bit-identical to its Pallas kernel's)."""
    rng = np.random.default_rng(5)
    D, H, SL = 768, 8, 64
    dh = D // H
    x = rng.standard_normal((1, SL, D)).astype(np.float32)
    p = {n: (0.05 * rng.standard_normal((D, H, dh))).astype(np.float32)
         for n in ("wq", "wk", "wv")}
    p["wo"] = (0.05 * rng.standard_normal((H, dh, D))).astype(np.float32)
    kw = dict(num_heads=H, num_kv_heads=H, causal=False)
    want = jfamous.mha_block(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
        cfg=jfamous.FamousConfig(impl="xla", quant="int8"), **kw)
    got = tfamous.mha_block(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
        cfg=tfamous.FamousConfig(impl=impl, quant="int8", tile_q=64,
                                 tile_k=64), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    fp = tfamous.mha_block(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
        cfg=tfamous.FamousConfig(impl=impl), **kw)
    # 8-bit fixed point moves the output, but not far
    assert 0 < float((got - fp).abs().max()) < 0.05 * float(fp.abs().max())


@pytest.mark.parametrize("w_dtype,x_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
def test_load_time_quantization_equals_per_call(w_dtype, x_dtype):
    """``attention.quantize_qkv`` quantizes the fused W once, from its own
    dtype; the projection through it equals the one that quantizes W on
    every call, bit for bit, also when x is in another dtype."""
    x, ws, bs = _proj_inputs(6)
    p = attention.fuse_qkv({n: torch.from_numpy(a).to(w_dtype)
                            for n, a in zip(("wq", "wk", "wv"), ws)})
    p.update({n: torch.from_numpy(a).to(w_dtype)
              for n, a in zip(("bq", "bk", "bv"), bs)})
    pq = attention.quantize_qkv(p)
    assert pq["w_qkv_q"].dtype == torch.int8
    assert pq["w_qkv_q"].shape == p["w_qkv"].shape[::-1]
    assert pq["w_qkv_s"].shape == (1, p["w_qkv"].shape[1])
    assert attention.quantize_qkv(pq) is pq
    fcfg = tfamous.FamousConfig(impl="pallas", quant="int8")
    xt = torch.from_numpy(x).to(x_dtype)
    args = (xt, p["wq"], p["wk"], p["wv"], p["bq"], p["bk"], p["bv"])
    once = tfamous.qkv_projection(*args, cfg=fcfg, w_qkv=p["w_qkv"],
                                  w_int8=(pq["w_qkv_q"], pq["w_qkv_s"]))
    per_call = tfamous.qkv_projection(*args, cfg=fcfg)
    for a, b in zip(once, per_call):
        assert a.dtype == x_dtype
        assert torch.equal(a, b)
    wq, sw = qkv_ops.quantize_weight(p["w_qkv"])
    assert torch.equal(wq, pq["w_qkv_q"]) and torch.equal(sw, pq["w_qkv_s"])


# ---------------------------------------------------------------------------
# the int8 serving engine against the JAX engine
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jparams():
    return random_jax_params(JCFG, seed=12)


def _prompts():
    rng = np.random.default_rng(13)
    return [tokens(rng, CFG.vocab_size, n) for n in (20, 1, 9, 17)]


SAMPLING = {"greedy": [{}],
            "seeded": [dict(temperature=0.9, top_k=0, seed=7),
                       dict(temperature=1.3, top_k=5, seed=2**32 + 9)]}
CACHES = {"contiguous": {},
          "paged": dict(cache_kind="paged", page_size=8)}


def _serve(eng_cls, req_cls, params, cfg, fcfg, cache, sampling):
    eng = eng_cls(params, cfg, fcfg, n_slots=2, max_seq=64, chunk=8,
                  **CACHES[cache])
    hot = SAMPLING[sampling]
    done = eng.run([req_cls(rid=i, tokens=list(p), max_new=5,
                            **hot[i % len(hot)])
                    for i, p in enumerate(_prompts())])
    return [(r.rid, r.out, r.error) for r in sorted(done, key=lambda r: r.rid)]


@functools.lru_cache(maxsize=None)
def _jax_run(cache, sampling):
    return _serve(JServingEngine, JRequest, _jparams(), JCFG,
                  jfamous.FamousConfig(impl="pallas", quant="int8"), cache,
                  sampling)


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("cache", list(CACHES))
def test_int8_engine_matches_jax_engine(cache, sampling):
    fcfg = tfamous.FamousConfig(impl="pallas", quant="int8")
    got = _serve(lambda *a, **k: ServingEngine(*a, device="cpu", **k),
                 Request, convert.params_from_jax(_jparams(), CFG, "cpu"),
                 CFG, fcfg, cache, sampling)
    assert all(err is None for _, _, err in got)
    assert got == _jax_run(cache, sampling)


def test_int8_engine_quantizes_weights_once():
    """The engine holds each layer's int8 W beside the fp one for the
    kernels; the xla impl quantizes per call and holds none."""
    params = convert.params_from_jax(_jparams(), CFG, "cpu")
    eng = ServingEngine(params, CFG, tfamous.FamousConfig(
        impl="pallas", quant="int8"), n_slots=2, max_seq=64, chunk=8,
        device="cpu")
    attn = eng.params["layers"][0]["attn"]
    D, F = attn["w_qkv"].shape
    assert attn["w_qkv_q"].shape == (F, D) and attn["w_qkv_q"].is_contiguous()
    xla = ServingEngine(params, CFG, tfamous.FamousConfig(
        impl="xla", quant="int8"), n_slots=2, max_seq=64, chunk=8,
        device="cpu")
    assert "w_qkv_q" not in xla.params["layers"][0]["attn"]
    with pytest.raises(ValueError, match="quant 'int4'"):
        ServingEngine(params, CFG, tfamous.FamousConfig(quant="int4"),
                      device="cpu")


def test_make_train_step_raises_for_int8():
    with pytest.raises(ValueError, match="no gradient"):
        step_lib.make_train_step(CFG, tfamous.FamousConfig(quant="int8"),
                                 step_lib.TrainConfig())
    # and the fp config still builds
    assert callable(step_lib.make_train_step(
        CFG, tfamous.FamousConfig(), step_lib.TrainConfig()))
