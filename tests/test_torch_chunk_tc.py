"""PyTorch port, the bf16 tensor-core chunk kernel's algebra.

``kernels/decode/ref.chunk_prefill_tc_reference`` mirrors what
``kernels/csrc/chunk_prefill.cu`` computes in bf16: blocks of chunk rows
whose keys end at their last row's diagonal, key tiles with per-tile online
updates, the scale applied after Q K^T, an f32 running sum, P rounded to
bf16 before P V (bf16 inputs only), and a block's key range split over
several blocks whose partials combine in order.  Here it is held against
the JAX package's ``chunked_prefill_attention`` (``impl="xla"``, and
``impl="pallas"`` in interpret mode, as the JAX suite runs it on the CPU)
at offsets 0, a key-tile boundary and either side of it, and one inside a
tile, with small blocks and tiles so that every chunk crosses several of
each: f32 (no rounding) at 1e-5, bf16 at 2e-2.  Also: any split count and
tiling gives the port's plain version in f32, a head dim that is not a
multiple of 16 included."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (sets the torch thread count)
from repro.core import famous as jfamous
from repro_torch.kernels.decode import ref as dec_ref

TOL = {"f32": 1e-5, "bf16": 2e-2}
C, SKV, TILE, ROWS = 24, 64, 16, 8   # chunk, cache, keys a tile, rows a block
H, KV, DH = 14, 2, 32                # group 7 (qwen2-7b's 28 / 4)
# 0, a tile boundary and either side of it, and inside a tile
OFFSETS = [0, TILE - 1, TILE, TILE + 1, 2 * TILE + 5]
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(seed, dh=DH):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, C, H, dh)).astype(np.float32)
    k = rng.standard_normal((1, SKV, KV, dh)).astype(np.float32)
    v = rng.standard_normal((1, SKV, KV, dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("jimpl", ["xla", "pallas"])
@pytest.mark.parametrize("off", OFFSETS)
def test_tc_mirror_matches_jax(off, jimpl, dt):
    tdtype, jdtype = DTYPES[dt]
    q, k, v = _inputs(off)
    # the bf16 inputs both sides see: the f32 draws rounded once
    tq, tk, tv = (torch.from_numpy(a).to(tdtype) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, jdtype) for a in (q, k, v))
    want = jfamous.chunked_prefill_attention(
        jq, jk, jv, off, cfg=jfamous.FamousConfig(impl=jimpl))
    got = dec_ref.chunk_prefill_tc_reference(
        tq, tk, tv, off, scale=DH ** -0.5, splits=2, block_rows=ROWS,
        tile_keys=TILE)
    assert got.dtype == tdtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=TOL[dt], rtol=TOL[dt])


@pytest.mark.parametrize("splits,rows,tile", [(1, 8, 16), (3, 8, 16),
                                              (4, 16, 8), (2, 128, 64)])
@pytest.mark.parametrize("dh", [DH, 24])
def test_tc_mirror_matches_plain_at_any_tiling(splits, rows, tile, dh):
    """In f32 the blocking, tiling and split count change only the order
    of the sums: the plain version's output at 1e-5, at every offset."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(7, dh))
    for off in OFFSETS + [SKV - C]:
        got = dec_ref.chunk_prefill_tc_reference(
            q, k, v, off, scale=dh ** -0.5, splits=splits, block_rows=rows,
            tile_keys=tile)
        want = dec_ref.chunk_prefill_reference(q, k, v, off,
                                               scale=dh ** -0.5)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_tc_mirror_keeps_bf16_io():
    """bf16 in, bf16 out (f32 inside, P rounded to bf16 for P V), within
    bf16 rounding of the f32 mirror on the same (bf16-exact) inputs."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _inputs(11))
    args = dict(scale=DH ** -0.5, splits=2, block_rows=ROWS,
                tile_keys=TILE)
    b = dec_ref.chunk_prefill_tc_reference(q, k, v, TILE, **args)
    f = dec_ref.chunk_prefill_tc_reference(q.float(), k.float(), v.float(),
                                           TILE, **args)
    assert b.dtype == torch.bfloat16
    np.testing.assert_allclose(b.float().numpy(), f.numpy(), atol=2e-2,
                               rtol=2e-2)
