"""PyTorch port, paged KV: the plain versions of the four paged kernels
against the JAX Pallas kernels (interpret mode), the paged ``famous``
functions against the JAX package's, ``quantize`` and ``block_hashes``
bit for bit, the page allocator against the JAX allocator op for op, and
one paged ``decode_step`` on a pool state carried over from JAX.

Inputs are drawn from numpy seeds: page ids shuffled, page sizes 4 and 8,
lengths that include 0 and a full table, and a prefix page shared by two
slots.  Tolerance: 1e-5 at f32 for the kernels (int8 pools are quantized
once and handed to both sides), 1e-4 for logits."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import random_jax_params, tokens
from repro.configs.base import get_config as jget_config
from repro.configs.base import shrink as jshrink
from repro.core import famous as jfamous
from repro.core import quant as jquant
from repro.kernels.decode import chunk_prefill as jchunk
from repro.kernels.decode import decode_attn as jdecode
from repro.models import transformer as jtransformer
from repro.serve import paged as jpaged
from repro_torch import convert
from repro_torch.configs.base import get_config, shrink
from repro_torch.core import famous as tfamous
from repro_torch.core import quant as tquant
from repro_torch.kernels.decode import ref as dec_ref
from repro_torch.models import transformer
from repro_torch.serve import paged as tpaged

TOL = 1e-5
KV, GROUP, DH, MAX_SEQ = 2, 2, 16, 32


def _t(a):
    return convert.to_torch(np.asarray(a), "cpu")


def _pools(rng, ps, n_pages, kind):
    """K/V pools as (jax, torch) pairs; int8 pools come with scale pools
    quantized once by the JAX function."""
    shape = (n_pages, ps, KV, DH)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    if kind == "fp":
        return [(jnp.asarray(a), _t(a)) for a in (k, v)], {}, {}
    (kq, ks), (vq, vs) = (jquant.quantize(jnp.asarray(a), axis=-1)
                          for a in (k, v))
    ks, vs = ks[..., 0], vs[..., 0]
    pools = [(kq, _t(kq)), (vq, _t(vq))]
    return pools, (ks, vs), (_t(ks), _t(vs))


def _page_table(rng, ps, n_slots):
    """Shuffled page ids; slot 0 holds nothing (all null), slots 1 and 2
    share their first page, the last slot fills its whole table."""
    n_p = MAX_SEQ // ps
    n_pages = 1 + n_slots * n_p
    ids = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    pt = ids[:n_slots * n_p].reshape(n_slots, n_p).copy()
    pt[0] = 0
    pt[2, 0] = pt[1, 0]
    return pt, n_pages


@pytest.mark.parametrize("kind", ["fp", "int8"])
@pytest.mark.parametrize("ps", [4, 8])
def test_paged_decode_plain_matches_pallas(ps, kind):
    rng = np.random.default_rng(ps)
    B, H = 4, KV * GROUP
    pt, n_pages = _page_table(rng, ps, B)
    lens = np.array([0, 5, ps + 3, MAX_SEQ], np.int32)
    (k, v), jsc, tsc = _pools(rng, ps, n_pages, kind)
    q = rng.standard_normal((B, H, DH)).astype(np.float32)
    scale = DH ** -0.5
    jq = jnp.asarray(q).reshape(B, KV, GROUP, DH)
    if kind == "fp":
        jout = jdecode.paged_decode_attention(
            jq, k[0], v[0], jnp.asarray(pt), jnp.asarray(lens), scale=scale,
            interpret=True)
        tout = dec_ref.paged_decode_reference(
            _t(q), k[1], v[1], torch.from_numpy(pt), torch.from_numpy(lens),
            scale=scale)
    else:
        jout = jdecode.paged_decode_attention_int8(
            jq, k[0], v[0], *jsc, jnp.asarray(pt), jnp.asarray(lens),
            scale=scale, interpret=True)
        tout = dec_ref.paged_decode_reference_int8(
            _t(q), k[1], v[1], *tsc, torch.from_numpy(pt),
            torch.from_numpy(lens), scale=scale)
    jout = np.asarray(jout).reshape(B, H, DH)
    assert np.all(jout[0] == 0) and torch.all(tout[0] == 0)
    np.testing.assert_allclose(tout.numpy(), jout, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kind", ["fp", "int8"])
@pytest.mark.parametrize("ps", [4, 8])
@pytest.mark.parametrize("offset", [0, 16])
def test_paged_chunk_prefill_plain_matches_pallas(offset, ps, kind):
    """Two slots that share their first page, one chunk of C rows at a
    runtime offset, q in the model's (B, C, H, dh) layout on the port and
    in the kernel's (B, KV, group·C, dh) on JAX."""
    rng = np.random.default_rng(10 + ps + offset)
    B, C, H = 2, 8, KV * GROUP
    pt, n_pages = _page_table(rng, ps, 3)
    pt = pt[1:]
    (k, v), jsc, tsc = _pools(rng, ps, n_pages, kind)
    q = rng.standard_normal((B, C, H, DH)).astype(np.float32)
    scale = DH ** -0.5
    jq = (jnp.asarray(q).reshape(B, C, KV, GROUP, DH)
          .transpose(0, 2, 3, 1, 4).reshape(B, KV, GROUP * C, DH))
    if kind == "fp":
        jout = jchunk.paged_chunk_prefill(
            jq, k[0], v[0], jnp.asarray(pt), offset, chunk=C, scale=scale,
            interpret=True)
        tout = dec_ref.paged_chunk_prefill_reference(
            _t(q), k[1], v[1], torch.from_numpy(pt), offset, scale=scale)
    else:
        jout = jchunk.paged_chunk_prefill_int8(
            jq, k[0], v[0], *jsc, jnp.asarray(pt), offset, chunk=C,
            scale=scale, interpret=True)
        tout = dec_ref.paged_chunk_prefill_reference_int8(
            _t(q), k[1], v[1], *tsc, torch.from_numpy(pt), offset,
            scale=scale)
    jout = (np.asarray(jout).reshape(B, KV, GROUP, C, DH)
            .transpose(0, 3, 1, 2, 4).reshape(B, C, H, DH))
    np.testing.assert_allclose(tout.numpy(), jout, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kind", ["fp", "int8"])
@pytest.mark.parametrize("timpl", ["xla", "pallas"])
@pytest.mark.parametrize("fn", ["decode", "chunk"])
def test_paged_famous_matches_jax(fn, timpl, kind):
    """``famous.paged_decode_attention`` / ``paged_chunked_prefill_attention``
    in the model layout: the port's impls against JAX's Pallas path."""
    rng = np.random.default_rng(20)
    ps, H = 8, KV * GROUP
    pt, n_pages = _page_table(rng, ps, 3)
    (k, v), jsc, tsc = _pools(rng, ps, n_pages, kind)
    jkw = dict(zip(("k_scale", "v_scale"), jsc))
    tkw = dict(zip(("k_scale", "v_scale"), tsc))
    jcfg = jfamous.FamousConfig(impl="pallas")
    tcfg = tfamous.FamousConfig(impl=timpl)
    if fn == "decode":
        lens = np.array([1, 9, MAX_SEQ], np.int32)
        pt[0, 0] = pt[1, 1]
        q = rng.standard_normal((3, 1, H, DH)).astype(np.float32)
        jout = jfamous.paged_decode_attention(
            jnp.asarray(q), k[0], v[0], jnp.asarray(pt), jnp.asarray(lens),
            cfg=jcfg, **jkw)
        tout = tfamous.paged_decode_attention(
            _t(q), k[1], v[1], torch.from_numpy(pt), torch.from_numpy(lens),
            cfg=tcfg, **tkw)
    else:
        q = rng.standard_normal((1, 8, H, DH)).astype(np.float32)
        jout = jfamous.paged_chunked_prefill_attention(
            jnp.asarray(q), k[0], v[0], jnp.asarray(pt[1:2]), jnp.int32(8),
            cfg=jcfg, **jkw)
        tout = tfamous.paged_chunked_prefill_attention(
            _t(q), k[1], v[1], torch.from_numpy(pt[1:2]), 8, cfg=tcfg, **tkw)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("axis", [-1, 0])
def test_quantize_bit_identical(dt, axis):
    rng = np.random.default_rng(3)
    a = (rng.standard_normal((6, 3, 16)) * 7).astype(np.float32)
    a[1] = 0.0                               # all-zero rows: the 1e-8 floor
    a[2, 0, :] = 1e-12
    j = jnp.asarray(a, jnp.float32 if dt == "f32" else jnp.bfloat16)
    jq, js = jquant.quantize(j, axis=axis)
    tq, ts = tquant.quantize(convert.to_torch(np.asarray(j), "cpu"), axis)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    np.testing.assert_array_equal(
        tquant.dequantize(tq, ts).numpy(),
        np.asarray(jquant.dequantize(jq, js)))


@pytest.mark.parametrize("ps", [1, 4, 16])
def test_block_hashes_equal(ps):
    rng = np.random.default_rng(ps)
    for n in (0, ps - 1, ps, 3 * ps + 2, 50):
        toks = tokens(rng, 152064, max(n, 0))
        assert tpaged.block_hashes(toks, ps) == jpaged.block_hashes(toks, ps)


def _alloc_state(a):
    return (a.page_table.tolist(), a._ref.tolist(), a.free_pages,
            a.cached_free_pages, a.version, a._n_shared.tolist(),
            sorted(a._index.values()))


def _apply(a, op, slot, prompt, n, ps):
    """One engine-shaped operation on allocator ``a`` (the JAX engine's
    call pattern: admissions look up and map the prompt's cached head then
    grow, retirements publish the slot's own prompt blocks then free)."""
    hashes = jpaged.block_hashes(prompt, ps)
    cap = (len(prompt) - 1) // ps
    if op == "admit":
        if a.pages_held(slot):
            return "busy"
        hits = a.lookup(hashes[:cap])
        if hits:
            a.map_prefix(slot, hits)
        try:
            a.grow(slot, len(prompt))
        except Exception:
            a.free(slot)
            raise
        return hits
    if op == "grow":
        return a.grow(slot, n)
    if op == "shrink":
        return a.shrink(slot, n)
    if op == "retire":
        a.publish(slot, hashes)
        return a.free(slot)
    if op == "preempt":
        return a.free(slot)
    return a.can_admit(len(prompt), hits=a.lookup(hashes[:cap]))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_allocator_matches_jax_op_for_op(seed):
    """One seeded random sequence of admit (lookup + map_prefix + grow) /
    grow / shrink / retire (publish + free) / preempt (free) / can_admit
    through both allocators: the same results, the same exceptions, the
    same tables, refcounts and free counts after every operation, and
    both invariant checks pass."""
    rng = np.random.default_rng(seed)
    ps, n_slots, max_seq = 4, 3, 32
    n_pages = int(rng.integers(6, 20))
    ja = jpaged.PageAllocator(jpaged.PagedCacheConfig(ps, n_pages), n_slots,
                              max_seq)
    ta = tpaged.PageAllocator(tpaged.PagedCacheConfig(ps, n_pages), n_slots,
                              max_seq)
    base = tokens(rng, 50, 24)
    prompts = [base[:int(rng.integers(4, 24))] + tokens(rng, 50, k)
               for k in rng.integers(0, 12, size=6)]
    ops = ["admit", "admit", "grow", "shrink", "retire", "preempt", "check"]
    slot_prompt = [None] * n_slots
    for _ in range(300):
        op = ops[int(rng.integers(len(ops)))]
        slot = int(rng.integers(n_slots))
        if op == "admit" and slot_prompt[slot] is None:
            slot_prompt[slot] = prompts[int(rng.integers(len(prompts)))]
        prompt = slot_prompt[slot] or prompts[0]
        n = int(rng.integers(1, max_seq + 6))
        res = []
        for a in (ja, ta):
            try:
                res.append(("ok", _apply(a, op, slot, prompt, n, ps)))
            except Exception as e:                  # noqa: BLE001
                res.append((type(e).__name__, str(e)))
        assert res[0] == res[1], (op, res)
        if op in ("retire", "preempt") or (op == "admit"
                                           and res[0][0] != "ok"):
            slot_prompt[slot] = None
        assert _alloc_state(ja) == _alloc_state(ta), op
        ja.assert_invariants()
        ta.assert_invariants()


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
@pytest.mark.parametrize("timpl", ["xla", "pallas"])
def test_decode_step_on_a_jax_pool_state(timpl, kv_dtype):
    """JAX prefills two slots into a page pool (slot 1 aliasing slot 0's
    first two pages and prefilling from offset 8, as a prefix-cache hit
    does); the pools cross through ``convert.caches_from_jax``, and one
    paged ``decode_step`` on each side gives the same logits and pools."""
    cfg = shrink(get_config("qwen2-7b"))
    jcfg = jshrink(jget_config("qwen2-7b"))
    jparams = random_jax_params(jcfg, seed=3)
    params = convert.params_from_jax(jparams, cfg, "cpu")
    rng = np.random.default_rng(4)
    ps, n_pages, C = 4, 20, 8
    pt = np.zeros((3, MAX_SEQ // ps), np.int32)
    ids = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    pt[0, :4], pt[1, :2], pt[1, 2:5] = ids[:4], ids[:2], ids[4:7]
    jcaches = jtransformer.make_caches(jcfg, 3, MAX_SEQ, jnp.float32,
                                       cache_kind="paged", page_size=ps,
                                       n_pages=n_pages, kv_dtype=kv_dtype)
    prompt = tokens(rng, cfg.vocab_size, 20)
    fcfg_j = jfamous.FamousConfig(impl="xla")
    for slot, start, n in ((0, 0, 8), (0, 8, 5), (1, 8, 8)):
        toks = np.zeros((1, C), np.int32)
        toks[0, :n] = prompt[start:start + n]
        jcaches = jtransformer.prefill_chunk(
            jparams, jnp.asarray(toks), jcaches, jnp.int32(slot),
            jnp.int32(start), jnp.int32(n), jcfg, fcfg_j,
            page_table=jnp.asarray(pt))
    caches = convert.caches_from_jax(jcaches, cfg, "cpu")
    assert set(caches[0]) == ({"k", "v", "k_scale", "v_scale"}
                              if kv_dtype == "int8" else {"k", "v"})
    last = np.array([prompt[12], prompt[15], 7], np.int32)
    lens = np.array([12, 15, 0], np.int32)
    jlogits, jcaches = jtransformer.decode_step(
        jparams, jnp.asarray(last), jcaches, jnp.asarray(lens), jcfg, fcfg_j,
        page_table=jnp.asarray(pt))
    logits, caches = transformer.decode_step(
        params, torch.from_numpy(last).long(), caches,
        torch.from_numpy(lens), cfg, tfamous.FamousConfig(impl=timpl),
        page_table=torch.from_numpy(pt))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)
    back = convert.caches_from_jax(jcaches, cfg, "cpu")
    live = np.unique(pt[pt > 0])
    for got, want in zip(caches, back):
        for name in want:
            np.testing.assert_allclose(
                got[name][live].float().numpy(),
                want[name][live].float().numpy(), atol=1e-4, rtol=0,
                err_msg=name)
