"""PyTorch port, the paged decode kernels' split-key algebra.

``kernels/decode/ref.paged_decode_split_reference`` mirrors what
``kernels/csrc/paged_decode_attention.cu`` computes (the split kernel of
``csrc/decode_split.cuh`` on a paged pool): partials (m, l, acc) over ranges
of L keys read through the page table, fp pools or int8 pools dequantized
row by row, combined in order.  Here it is held against the JAX package's
``paged_decode_attention`` and ``paged_verify_attention`` (fp and int8
pools; ``impl="xla"``, and ``impl="pallas"`` in interpret mode, as the JAX
suite runs it on the CPU) at lengths {0, 1, L-1, L, L+1, full} and one on
a page boundary, at group 7 and at group 10 with dh 256, and as verify rows
that read each slot's page-table row in place (``rows_per_slot``).  f32,
tolerance 1e-5; the empty row (JAX: NaN on the xla path) must come out
exactly 0.  Also: the mirror against the port's plain paged version at
other range lengths, the null page for ids outside the pool, and
``ops.paged_verify_attention`` handing the kernel the (B, n_p) table
itself rather than a copy expanded per verify row."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (sets the torch thread count)
from repro.core import famous as jfamous
from repro.core import quant as jquant
from repro_torch.kernels.decode import decode_attn
from repro_torch.kernels.decode import ops as dec_ops
from repro_torch.kernels.decode import ref as dec_ref

TOL = 1e-5
PS, N_P, L = 8, 8, 16           # page size, pages a slot, keys per range
CAP = PS * N_P
# {0, 1, L-1, L, L+1, full} and a length on a page boundary (3 pages)
LENS = np.array([0, 1, L - 1, L, L + 1, CAP, 3 * PS], np.int32)
# (H, KV, dh): group 7 (qwen2-7b's 28 / 4), group 10 at dh 256
# (recurrentgemma-2b's 10 / 1)
LAYOUTS = {"group7": (14, 2, 32), "group10-dh256": (10, 1, 256)}


def _page_table(rng, B):
    """Shuffled page ids, one private run of N_P pages a slot (page 0 is
    the null page)."""
    n_pages = 1 + B * N_P
    ids = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    return ids.reshape(B, N_P).copy(), n_pages


def _pools(rng, n_pages, KV, dh, kind):
    """(jax, torch) K and V pools; int8 pools quantized once by the JAX
    function, with their (jax, torch) scale pools."""
    shape = (n_pages, PS, KV, dh)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    if kind == "fp":
        return (jnp.asarray(k), jnp.asarray(v)), (torch.from_numpy(k),
                                                  torch.from_numpy(v)), {}, {}
    (kq, ks), (vq, vs) = (jquant.quantize(jnp.asarray(a), axis=-1)
                          for a in (k, v))
    ks, vs = ks[..., 0], vs[..., 0]

    def t(a):
        return torch.from_numpy(np.array(a))
    return ((kq, vq), (t(kq), t(vq)), dict(k_scale=ks, v_scale=vs),
            dict(k_scale=t(ks), v_scale=t(vs)))


@pytest.mark.parametrize("jimpl", ["xla", "pallas"])
@pytest.mark.parametrize("kind", ["fp", "int8"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_paged_split_decode_matches_jax(layout, kind, jimpl):
    H, KV, dh = LAYOUTS[layout]
    rng = np.random.default_rng(0)
    B = len(LENS)
    pt, n_pages = _page_table(rng, B)
    (jk, jv), (tk, tv), jsc, tsc = _pools(rng, n_pages, KV, dh, kind)
    q = rng.standard_normal((B, 1, H, dh)).astype(np.float32)
    want = np.asarray(jfamous.paged_decode_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(pt), jnp.asarray(LENS),
        cfg=jfamous.FamousConfig(impl=jimpl), **jsc))[:, 0]
    got = dec_ref.paged_decode_split_reference(
        torch.from_numpy(q[:, 0]), tk, tv, torch.from_numpy(pt),
        torch.from_numpy(LENS), scale=dh ** -0.5, keys_per_split=L, **tsc)
    live = LENS > 0
    np.testing.assert_allclose(got.numpy()[live], want[live], atol=TOL,
                               rtol=TOL)
    assert torch.all(got[~torch.from_numpy(live)] == 0)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("jimpl", ["xla", "pallas"])
@pytest.mark.parametrize("kind", ["fp", "int8"])
def test_paged_split_verify_rows_match_jax(kind, jimpl):
    """Verify rows: W = 3 rows a slot read the slot's page-table row in
    place (``rows_per_slot``), row j of slot b with ``cache_len[b] + j + 1``
    keys; slot lengths put rows on both sides of each range boundary."""
    H, KV, dh = LAYOUTS["group7"]
    W = 3
    rng = np.random.default_rng(1)
    clen = np.array([0, L - 2, L, 2 * L - 1, CAP - W], np.int32)
    B = len(clen)
    pt, n_pages = _page_table(rng, B)
    (jk, jv), (tk, tv), jsc, tsc = _pools(rng, n_pages, KV, dh, kind)
    q = rng.standard_normal((B, W, H, dh)).astype(np.float32)
    want = jfamous.paged_verify_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(pt), jnp.asarray(clen),
        cfg=jfamous.FamousConfig(impl=jimpl), **jsc)
    rows = np.minimum(clen[:, None] + np.arange(1, W + 1), CAP).reshape(-1)
    got = dec_ref.paged_decode_split_reference(
        torch.from_numpy(q.reshape(B * W, H, dh)), tk, tv,
        torch.from_numpy(pt), torch.from_numpy(rows.astype(np.int32)),
        scale=dh ** -0.5, keys_per_split=L, rows_per_slot=W, **tsc)
    np.testing.assert_allclose(got.numpy().reshape(B, W, H, dh),
                               np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kind", ["fp", "int8"])
@pytest.mark.parametrize("keys", [1, 7, 48, CAP, 2 * CAP])
def test_paged_split_matches_single_range_plain(keys, kind):
    """Any range length gives the port's plain paged version's output,
    including one range (L >= n_p * page_size) and ranges that do not
    divide it or straddle pages."""
    H, KV, dh = LAYOUTS["group7"]
    rng = np.random.default_rng(2)
    B = len(LENS)
    pt, n_pages = _page_table(rng, B)
    _, (tk, tv), _, tsc = _pools(rng, n_pages, KV, dh, kind)
    q = torch.from_numpy(rng.standard_normal((B, H, dh)).astype(np.float32))
    pt, lens = torch.from_numpy(pt), torch.from_numpy(LENS)
    got = dec_ref.paged_decode_split_reference(
        q, tk, tv, pt, lens, scale=dh ** -0.5, keys_per_split=keys, **tsc)
    if kind == "fp":
        want = dec_ref.paged_decode_reference(q, tk, tv, pt, lens,
                                              scale=dh ** -0.5)
    else:
        want = dec_ref.paged_decode_reference_int8(
            q, tk, tv, tsc["k_scale"], tsc["v_scale"], pt, lens,
            scale=dh ** -0.5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)
    assert torch.all(got[0] == 0)


def test_paged_split_reads_the_null_page_outside_the_pool():
    """A page id outside [0, n_pages) reads the null page 0, as the
    kernels' pool_row does: the same output as a table holding 0 there."""
    H, KV, dh = LAYOUTS["group7"]
    rng = np.random.default_rng(3)
    B = len(LENS)
    pt, n_pages = _page_table(rng, B)
    _, (tk, tv), _, _ = _pools(rng, n_pages, KV, dh, "fp")
    q = torch.from_numpy(rng.standard_normal((B, H, dh)).astype(np.float32))
    bad = pt.copy()
    bad[5, 1], bad[6, 0], bad[3, 1] = n_pages + 7, -3, n_pages
    null = pt.copy()
    null[5, 1] = null[6, 0] = null[3, 1] = 0
    args = dict(scale=dh ** -0.5, keys_per_split=L)
    lens = torch.from_numpy(LENS)
    got = dec_ref.paged_decode_split_reference(
        q, tk, tv, torch.from_numpy(bad), lens, **args)
    want = dec_ref.paged_decode_split_reference(
        q, tk, tv, torch.from_numpy(null), lens, **args)
    assert torch.equal(got, want)
    want = dec_ref.paged_decode_reference(q, tk, tv, torch.from_numpy(null),
                                          lens, scale=dh ** -0.5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kind", ["fp", "int8"])
def test_paged_verify_reads_the_page_table_in_place(kind, monkeypatch):
    """``ops.paged_verify_attention`` hands the paged kernel the slots'
    (B, n_p) page table and ``rows_per_slot=W``, not a (B * W, n_p) copy;
    its output equals the plain version on the expanded table."""
    H, KV, dh = LAYOUTS["group7"]
    W = 4
    rng = np.random.default_rng(4)
    clen = np.array([0, 5, L, CAP - W], np.int32)
    B = len(clen)
    pt, n_pages = _page_table(rng, B)
    _, (tk, tv), _, tsc = _pools(rng, n_pages, KV, dh, kind)
    q = torch.from_numpy(rng.standard_normal((B, W, H, dh))
                         .astype(np.float32))
    name = "paged_decode_attention" + ("" if kind == "fp" else "_int8")
    seen = {}
    real = getattr(decode_attn, name)

    def spy(qf, *args, **kw):
        table = args[-2]
        seen.update(shape=tuple(table.shape), rps=kw.get("rows_per_slot"))
        return real(qf, *args, **kw)

    monkeypatch.setattr(decode_attn, name, spy)
    got = dec_ops.paged_verify_attention(q, tk, tv, torch.from_numpy(pt),
                                         torch.from_numpy(clen), **tsc)
    assert seen == {"shape": (B, N_P), "rps": W}
    rows = np.minimum(clen[:, None] + np.arange(1, W + 1), CAP).reshape(-1)
    want = dec_ref.paged_decode_split_reference(
        q.reshape(B * W, H, dh), tk, tv,
        torch.from_numpy(np.repeat(pt, W, axis=0)),
        torch.from_numpy(rows.astype(np.int32)), scale=dh ** -0.5,
        keys_per_split=L, **tsc)
    np.testing.assert_allclose(got.reshape(B * W, H, dh).numpy(),
                               want.numpy(), atol=TOL, rtol=TOL)
