"""PyTorch port, the contiguous decode kernel's flash-decoding algebra.

``kernels/decode/ref.decode_split_reference`` mirrors what
``kernels/csrc/decode_attention.cu`` computes: partials (m, l, acc) over
ranges of L keys, combined in order; with ``stream_tiles`` the stream
design's partials (tiles of TK keys dealt to W warps, an online softmax a
warp, the warps merged in order).  Here it is held against the JAX
package's ``decode_attention`` and ``verify_attention`` (``impl="xla"``,
and ``impl="pallas"`` in interpret mode, as the JAX suite runs it on the
CPU) on lengths at the range boundaries {0, 1, L-1, L, L+1, Skv} (and, for
the stream design, at its tile boundaries), at group 7, at group 10 with
dh 256 (recurrentgemma-2b's layout) and at group 1 with dh 128
(deepseek-7b's multi-head layout) and at group 6 with dh 128 (grok-1's),
the two that take the stream design, and
against the port's single-range plain version.  f32, tolerance 1e-5; the
empty row (JAX: NaN) must come out exactly 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (sets the torch thread count)
from repro.core import famous as jfamous
from repro_torch.kernels.decode import decode_attn
from repro_torch.kernels.decode import ref as dec_ref

TOL = 1e-5
SKV, L = 64, 16
LENS = np.array([0, 1, L - 1, L, L + 1, SKV], np.int32)
# (H, KV, dh): group 7 (qwen2-7b's 28 / 4), group 10 at dh 256
# (recurrentgemma-2b's 10 / 1), group 1 at dh 128 (deepseek-7b's 32 / 32)
LAYOUTS = {"group7": (14, 2, 32), "group10-dh256": (10, 1, 256),
           "group1-dh128": (4, 4, 128), "group6-dh128": (12, 2, 128)}
# the layouts that take the stream design (group 1, and grok-1's group 6),
# at its own (W, TK); a range of 48 keys gives warps 0 and 1 two tiles each
# (the online rescale) and warps 2 and 3 one, the second range of 16 keys
# leaves warps 2 and 3 none
STREAM = {"group1-dh128": decode_attn.STREAM_TILES,
          "group6-dh128": decode_attn.STREAM_TILES}
STREAM_L = 48


def _geometry(layout):
    """(L, stream tiles or None, decode lengths, verify cache lengths) of a
    layout: lengths on both sides of every range boundary, and for the
    stream design of every tile boundary too."""
    tiles = STREAM.get(layout)
    if tiles is None:
        return L, None, LENS, np.array([0, L - 2, L, 2 * L - 1, SKV - 3],
                                       np.int32)
    tk = tiles[1]
    lens = sorted({0, 1, tk - 1, tk, tk + 1, 4 * tk - 1, 4 * tk, 4 * tk + 1,
                   STREAM_L - 1, STREAM_L, STREAM_L + 1, SKV})
    return (STREAM_L, tiles, np.array(lens, np.int32),
            np.array([0, tk - 2, STREAM_L - 2, STREAM_L, SKV - 3], np.int32))


def _inputs(seed, B, H, KV, dh, W=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, W, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, SKV, KV, dh)).astype(np.float32)
    v = rng.standard_normal((B, SKV, KV, dh)).astype(np.float32)
    return q, k, v


def _close(got, want, rows):
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows],
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("jimpl", ["xla", "pallas"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_split_decode_matches_jax(layout, jimpl):
    H, KV, dh = LAYOUTS[layout]
    keys, tiles, lens, _ = _geometry(layout)
    B = len(lens)
    q, k, v = _inputs(0, B, H, KV, dh)
    want = jfamous.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        cfg=jfamous.FamousConfig(impl=jimpl))[:, 0]
    got = dec_ref.decode_split_reference(
        torch.from_numpy(q[:, 0]), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens), scale=dh ** -0.5, keys_per_split=keys,
        stream_tiles=tiles)
    _close(got, want, lens > 0)
    assert torch.all(got[lens == 0] == 0)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("jimpl", ["xla", "pallas"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_split_verify_rows_match_jax(layout, jimpl):
    """Verify rows: W = 3 rows a slot read the slot's cache in place
    (``rows_per_slot``), row j of slot b with ``cache_len[b] + j + 1``
    keys; slot lengths put rows on both sides of each range boundary."""
    H, KV, dh = LAYOUTS[layout]
    W = 3
    keys, tiles, _, clen = _geometry(layout)
    B = len(clen)
    q, k, v = _inputs(1, B, H, KV, dh, W)
    want = jfamous.verify_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(clen),
        cfg=jfamous.FamousConfig(impl=jimpl))
    rows = np.minimum(clen[:, None] + np.arange(1, W + 1), SKV).reshape(-1)
    got = dec_ref.decode_split_reference(
        torch.from_numpy(q.reshape(B * W, H, dh)), torch.from_numpy(k),
        torch.from_numpy(v), torch.from_numpy(rows.astype(np.int32)),
        scale=dh ** -0.5, keys_per_split=keys, rows_per_slot=W,
        stream_tiles=tiles)
    np.testing.assert_allclose(got.numpy().reshape(B, W, H, dh),
                               np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("keys", [1, 7, L, 48, SKV, 2 * SKV])
def test_split_matches_single_range_plain(keys):
    """Any range length gives the single-range plain version's output,
    including one range (L >= Skv) and ranges that do not divide Skv."""
    H, KV, dh = LAYOUTS["group7"]
    q, k, v = _inputs(2, len(LENS), H, KV, dh)
    args = (torch.from_numpy(q[:, 0]), torch.from_numpy(k),
            torch.from_numpy(v), torch.from_numpy(LENS))
    got = dec_ref.decode_split_reference(*args, scale=dh ** -0.5,
                                         keys_per_split=keys)
    want = dec_ref.decode_reference(*args, scale=dh ** -0.5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)
    assert torch.all(got[0] == 0)


def test_split_keeps_bf16_io():
    """bf16 in, bf16 out (f32 inside), within bf16 rounding of f32."""
    H, KV, dh = LAYOUTS["group10-dh256"]
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, len(LENS), H, KV, dh))
    lens = torch.from_numpy(LENS)
    got = dec_ref.decode_split_reference(
        q[:, 0].bfloat16(), k.bfloat16(), v.bfloat16(), lens,
        scale=dh ** -0.5, keys_per_split=L)
    want = dec_ref.decode_reference(q[:, 0].bfloat16().float(),
                                    k.bfloat16().float(), v.bfloat16().float(),
                                    lens, scale=dh ** -0.5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("tiles", [decode_attn.STREAM_TILES, (2, 16), (1, 8)])
@pytest.mark.parametrize("keys", [1, 7, 32, STREAM_L, SKV, 2 * SKV])
def test_stream_matches_single_range_plain(keys, tiles):
    """The stream design's algebra at any range length and tiling (one
    warp, ranges shorter than a tile, warps left without a tile) gives the
    single-range plain version's output at deepseek-7b's layout."""
    H, KV, dh = LAYOUTS["group1-dh128"]
    _, _, lens, _ = _geometry("group1-dh128")
    q, k, v = _inputs(4, len(lens), H, KV, dh)
    args = (torch.from_numpy(q[:, 0]), torch.from_numpy(k),
            torch.from_numpy(v), torch.from_numpy(lens))
    got = dec_ref.decode_split_reference(*args, scale=dh ** -0.5,
                                         keys_per_split=keys,
                                         stream_tiles=tiles)
    want = dec_ref.decode_reference(*args, scale=dh ** -0.5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)
    assert torch.all(got[lens == 0] == 0)


def test_stream_keeps_bf16_io():
    """The stream algebra: bf16 in, bf16 out (f32 inside), within bf16
    rounding of f32."""
    H, KV, dh = LAYOUTS["group1-dh128"]
    keys, tiles, lens_np, _ = _geometry("group1-dh128")
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, len(lens_np), H, KV,
                                                     dh))
    lens = torch.from_numpy(lens_np)
    got = dec_ref.decode_split_reference(
        q[:, 0].bfloat16(), k.bfloat16(), v.bfloat16(), lens,
        scale=dh ** -0.5, keys_per_split=keys, stream_tiles=tiles)
    want = dec_ref.decode_reference(q[:, 0].bfloat16().float(),
                                    k.bfloat16().float(), v.bfloat16().float(),
                                    lens, scale=dh ** -0.5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=2e-2,
                               rtol=2e-2)
