"""PyTorch port, the bf16 paged chunk kernels' tensor-core algebra.

``kernels/decode/ref.paged_chunk_prefill_tc_reference`` and its int8 twin
mirror what ``kernels/csrc/paged_chunk_prefill.cu`` computes in bf16: the
body of the contiguous tensor-core chunk kernel (``csrc/chunk_tc.cuh``:
blocks of chunk rows, key tiles with per-tile online updates, the scale
after Q K^T, an f32 running sum, P rounded to bf16 before P V, a block's
key range split over several blocks and combined in order) over keys read
through the slot's page table; int8 pools enter the products as exact
integers, each key's K scale multiplying its score column and its V scale
P's column.  Here the mirrors are held against the JAX package's Pallas
kernels ``paged_chunk_prefill`` and ``paged_chunk_prefill_int8`` in
interpret mode, as the JAX suite runs them on the CPU, at offsets 0, a
key-tile boundary and either side of it, and one inside a tile; page sizes
that divide the tile, one that does not and one larger than a tile; split
counts 1-4; shuffled page tables padded with the null page: f32 at 1e-5,
bf16 at 2e-2.  Also: on an identity page table the fp mirror is the
contiguous mirror bit for bit, every tiling gives the port's plain paged
version in f32, and a page id outside the pool reads the null page."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (sets the torch thread count)
from repro.core import quant as jquant
from repro.kernels.decode import chunk_prefill as jchunk
from repro_torch.kernels.decode import ref as dec_ref

TOL = {"f32": 1e-5, "bf16": 2e-2}
C, TILE, ROWS = 24, 16, 8            # chunk, keys a tile, rows a block
H, KV, DH = 14, 2, 32                # group 7 (qwen2-7b's 28 / 4)
KEYS = 64                            # keys of the slot's live pages
NULL_PAD = 2                         # null-page entries past them
# (offset, splits): 0, a tile boundary and either side of it, and inside
# a tile, each at one of the split counts 1-4
CASES = [(0, 1), (TILE - 1, 2), (TILE, 3), (TILE + 1, 4), (2 * TILE + 5, 2)]
# divides the tile, does not divide it, larger than a tile
PAGE_SIZES = [4, 6, 32]
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _page_table(rng, ps, B=2):
    """Each slot's pages, shuffled over a pool whose page 0 is the null
    page, then NULL_PAD entries of the null page."""
    live = -(-KEYS // ps)
    n_pages = 1 + B * live
    ids = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    pt = np.zeros((B, live + NULL_PAD), np.int32)
    pt[:, :live] = ids.reshape(B, live)
    return pt, n_pages


def _inputs(seed, ps, kind, B=2, dh=DH):
    """q (B, C, H, dh), the pools and the page table as numpy arrays;
    int8 pools are quantized once by the JAX function, with their f32
    (n_pages, ps, KV) scale pools."""
    rng = np.random.default_rng(seed)
    pt, n_pages = _page_table(rng, ps, B)
    q = rng.standard_normal((B, C, H, dh)).astype(np.float32)
    k = rng.standard_normal((n_pages, ps, KV, dh)).astype(np.float32)
    v = rng.standard_normal((n_pages, ps, KV, dh)).astype(np.float32)
    if kind == "fp":
        return q, (k, v), pt
    (kq, ks), (vq, vs) = (jquant.quantize(jnp.asarray(a), axis=-1)
                          for a in (k, v))
    return q, tuple(np.asarray(a) for a in (kq, vq, ks[..., 0],
                                            vs[..., 0])), pt


def _mirror(q, pools, pt, off, **kw):
    """The paged mirror (int8 when ``pools`` holds scales too) on numpy
    or torch pools."""
    t = [a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
         for a in pools]
    fn = (dec_ref.paged_chunk_prefill_tc_reference if len(t) == 2 else
          dec_ref.paged_chunk_prefill_tc_reference_int8)
    return fn(q, *t, torch.from_numpy(pt), off, scale=q.shape[-1] ** -0.5,
              **kw)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("kind", ["fp", "int8"])
@pytest.mark.parametrize("ps", PAGE_SIZES)
@pytest.mark.parametrize("off,splits", CASES)
def test_paged_tc_mirror_matches_pallas(off, splits, ps, kind, dt):
    tdtype, jdtype = DTYPES[dt]
    q, pools, pt = _inputs(100 + off + ps, ps, kind)
    B = q.shape[0]
    g = H // KV
    # the bf16 inputs both sides see: the f32 draws rounded once
    jq = (jnp.asarray(q, jdtype).reshape(B, C, KV, g, DH)
          .transpose(0, 2, 3, 1, 4).reshape(B, KV, g * C, DH))
    if kind == "fp":
        want = jchunk.paged_chunk_prefill(
            jq, *(jnp.asarray(a, jdtype) for a in pools), jnp.asarray(pt),
            off, chunk=C, scale=DH ** -0.5, interpret=True)
        # the same rounded pools on the port's side
        pools = [torch.from_numpy(a).to(tdtype) for a in pools]
    else:
        want = jchunk.paged_chunk_prefill_int8(
            jq, *(jnp.asarray(a) for a in pools), jnp.asarray(pt), off,
            chunk=C, scale=DH ** -0.5, interpret=True)
    want = (np.asarray(want.astype(jnp.float32)).reshape(B, KV, g, C, DH)
            .transpose(0, 3, 1, 2, 4).reshape(B, C, H, DH))
    got = _mirror(torch.from_numpy(q).to(tdtype), pools, pt, off,
                  splits=splits, block_rows=ROWS, tile_keys=TILE)
    assert got.dtype == tdtype
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dt],
                               rtol=TOL[dt])


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("off,splits", CASES + [(KEYS - C, 4)])
def test_paged_tc_mirror_on_identity_pages_is_contiguous(off, splits, dt):
    """A pool that holds a contiguous cache page by page, read through an
    identity page table, gives the contiguous mirror's output exactly (as
    the kernels must give chunk_prefill's bits)."""
    tdtype = DTYPES[dt][0]
    rng = np.random.default_rng(off)
    ps = 8
    q = torch.from_numpy(rng.standard_normal((1, C, H, DH))
                         .astype(np.float32)).to(tdtype)
    k, v = (torch.from_numpy(rng.standard_normal((1, KEYS, KV, DH))
                             .astype(np.float32)).to(tdtype)
            for _ in range(2))
    pt = torch.arange(KEYS // ps, dtype=torch.int32)[None]
    kp, vp = (x.reshape(KEYS // ps, ps, KV, DH) for x in (k, v))
    args = dict(scale=DH ** -0.5, splits=splits, block_rows=ROWS,
                tile_keys=TILE)
    got = dec_ref.paged_chunk_prefill_tc_reference(q, kp, vp, pt, off,
                                                   **args)
    want = dec_ref.chunk_prefill_tc_reference(q, k, v, off, **args)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["fp", "int8"])
@pytest.mark.parametrize("ps", [1, 6, 16, 100])
@pytest.mark.parametrize("splits,rows,tile", [(1, 8, 16), (3, 8, 16),
                                              (4, 16, 8), (2, 128, 64)])
def test_paged_tc_mirror_matches_plain_at_any_tiling(splits, rows, tile, ps,
                                                     kind):
    """In f32 the blocking, tiling, split count and page size change only
    the order of the sums: the plain paged version's output at 1e-5, at
    every offset, a head dim that is not a multiple of 16 included."""
    dh = 24
    q, pools, pt = _inputs(7 + ps, ps, kind, dh=dh)
    tq = torch.from_numpy(q)
    tp = [torch.from_numpy(np.array(a)) for a in pools]
    plain = (dec_ref.paged_chunk_prefill_reference if kind == "fp" else
             dec_ref.paged_chunk_prefill_reference_int8)
    for off, _ in CASES + [(KEYS - C, 1)]:
        got = _mirror(tq, pools, pt, off, splits=splits, block_rows=rows,
                      tile_keys=tile)
        want = plain(tq, *tp, torch.from_numpy(pt), off, scale=dh ** -0.5)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("kind", ["fp", "int8"])
def test_paged_tc_mirror_reads_null_page_for_ids_outside_the_pool(kind):
    """An id below 0 or at or past n_pages reads the null page 0, as the
    kernels' addressing does."""
    ps = 8
    q, pools, pt = _inputs(3, ps, kind)
    n_pages = pools[0].shape[0]
    bad, null = pt.copy(), pt.copy()
    bad[0, 2], bad[1, 5] = -3, n_pages + 4
    null[0, 2], null[1, 5] = 0, 0
    tq = torch.from_numpy(q).bfloat16()
    args = dict(splits=2, block_rows=ROWS, tile_keys=TILE)
    got = _mirror(tq, pools, bad, KEYS - C, **args)
    want = _mirror(tq, pools, null, KEYS - C, **args)
    assert torch.equal(got, want)
