"""PyTorch port, the bf16 tensor-core MHA kernels' algebra.

``kernels/attention/ref.mha_forward_tc_reference`` mirrors what
``kernels/csrc/mha_forward.cu`` computes in bf16 (``chunk_tc.cuh`` on the
flat layout: row blocks, key tiles from the window's edge to the causal
one, per-tile online updates with the scale after Q K^T, an f32 running
sum, P rounded to bf16 before P V, split key ranges combined in order, the
row LSE), ``ref.mha_bwd_dkv_tc_reference`` what
``kernels/csrc/mha_bwd_dkv.cu`` computes (key blocks, the group's
(head, query tile) items split into runs summed in order, P^T and dS^T as
hi + lo bf16 pairs), and ``ref.mha_bwd_dq_tc_reference`` what
``kernels/csrc/mha_bwd_dq.cu`` computes (row blocks, their key tiles
split into runs summed in order, dS as a hi + lo bf16 pair).  Here all
three are held against the JAX package's ``mha_forward`` /
``mha_backward`` in Pallas interpret mode, as the JAX suite runs them on
the CPU: group 1 and 7, head dims 32, 96 and ones that are not multiples
of 16, full, causal, windowed and ``q_offset > 0`` attention, lengths on
either side of the mirrors' (small) tile and block boundaries, and rows
that see no key.  Tolerances: forward f32 1e-5, bf16 2e-2; dq and dk/dv
1e-4 on bf16 inputs against JAX's f32 math; in f32 every split count and
tiling gives the plain version's result at 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (sets the torch thread count)
from repro.kernels.attention import mha as jmha
from repro_torch.kernels.attention import mha as tmha
from repro_torch.kernels.attention import ref as tref

FWD_TOL = {"f32": 1e-5, "bf16": 2e-2}
DKV_TOL = 1e-4
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
# small blocks and tiles, so every case crosses several of each
ROWS, TILE, SPLITS = 8, 16, 2          # forward: rows a block, keys a tile
KEYS, QROWS = 16, 8                    # dk/dv: keys a block, rows an item
DQROWS, DQKEYS = 8, 16                 # dq: rows a block, keys a tile
# name: (BKV, group, Sq, Skv, dh, causal, window, q_offset)
CASES = {
    "full-g1-dh32": (2, 1, 17, 17, 32, False, 0, 0),
    "causal-g7-dh32": (1, 7, 16, 16, 32, True, 0, 0),
    "causal-g7-dh24-offset": (1, 7, 9, 33, 24, True, 0, 24),
    "window-g1-dh96": (1, 1, 33, 33, 96, True, 10, 0),
    "window-full-g7-dh40": (1, 7, 15, 15, 40, False, 5, 0),
    "empty-rows-g2-dh16": (1, 2, 8, 8, 16, True, 4, 9),
}


def _inputs(case, seed=0):
    BKV, g, Sq, Skv, dh, causal, window, off = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((BKV * g, Sq, dh)).astype(np.float32)
    k = rng.standard_normal((BKV, Skv, dh)).astype(np.float32)
    v = rng.standard_normal((BKV, Skv, dh)).astype(np.float32)
    do = rng.standard_normal((BKV * g, Sq, dh)).astype(np.float32)
    kw = dict(causal=causal, window=window, scale=dh ** -0.5, q_offset=off)
    return (q, k, v, do), kw


def _jax_forward(jq, jk, jv, kw):
    return jmha.mha_forward(jq, jk, jv, block_q=jq.shape[1],
                            block_k=jk.shape[1], interpret=True,
                            return_lse=True, **kw)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_forward_mirror_matches_jax(case, dt):
    tdtype, jdtype = DTYPES[dt]
    (q, k, v, _), kw = _inputs(case)
    # the bf16 inputs both sides see: the f32 draws rounded once
    jout, jlse = _jax_forward(*(jnp.asarray(a, jdtype) for a in (q, k, v)),
                              kw)
    out, lse = tref.mha_forward_tc_reference(
        *(torch.from_numpy(a).to(tdtype) for a in (q, k, v)), splits=SPLITS,
        block_rows=ROWS, tile_keys=TILE, **kw)
    assert out.dtype == tdtype and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               atol=FWD_TOL[dt], rtol=FWD_TOL[dt])
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse),
                               atol=FWD_TOL[dt], rtol=FWD_TOL[dt])


@pytest.mark.parametrize("case", list(CASES))
def test_dkv_mirror_matches_jax_on_bf16_inputs(case):
    """The hi + lo algebra on bf16 inputs against JAX's f32 math on the
    same inputs and the same forward residuals, at the gate's 1e-4."""
    (q, k, v, do), kw = _inputs(case, seed=1)
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do))
    jout, jlse = _jax_forward(jq, jk, jv, kw)
    _, jdk, jdv = jmha.mha_backward(jq, jk, jv, jout, jlse, jdo,
                                    block_q=q.shape[1], block_k=k.shape[1],
                                    interpret=True, **kw)
    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    out = torch.from_numpy(np.array(jout.astype(jnp.float32))).bfloat16()
    lse = torch.from_numpy(np.array(jlse))
    delta = (tdo.float() * out.float()).sum(-1)
    dk, dv = tref.mha_bwd_dkv_tc_reference(
        tq, tk, tv, tdo, lse, delta, splits=3, block_keys=KEYS,
        block_q=QROWS, **kw)
    for got, want in ((dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=DKV_TOL, rtol=DKV_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_dq_mirror_matches_jax_on_bf16_inputs(case):
    """The dq kernel's hi + lo algebra on bf16 inputs, its rows' keys in 3
    runs, against JAX's f32 math on the same inputs and the same forward
    residuals, at the gate's 1e-4."""
    (q, k, v, do), kw = _inputs(case, seed=5)
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do))
    jout, jlse = _jax_forward(jq, jk, jv, kw)
    jdq, _, _ = jmha.mha_backward(jq, jk, jv, jout, jlse, jdo,
                                  block_q=q.shape[1], block_k=k.shape[1],
                                  interpret=True, **kw)
    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    out = torch.from_numpy(np.array(jout.astype(jnp.float32))).bfloat16()
    lse = torch.from_numpy(np.array(jlse))
    delta = (tdo.float() * out.float()).sum(-1)
    dq = tref.mha_bwd_dq_tc_reference(tq, tk, tv, tdo, lse, delta, splits=3,
                                      block_q=DQROWS, tile_keys=DQKEYS, **kw)
    assert dq.dtype == torch.float32 and dq.shape == tq.shape
    np.testing.assert_allclose(dq.numpy(), np.asarray(jdq), atol=DKV_TOL,
                               rtol=DKV_TOL)


@pytest.mark.parametrize("splits,rows,keys", [(1, 64, 64), (2, 5, 7),
                                              (3, 3, 16)])
@pytest.mark.parametrize("case", list(CASES))
def test_dq_mirror_matches_plain_at_any_tiling(case, splits, rows, keys):
    """f32 inputs (no hi/lo split): every split count and row and key tile,
    odd ones included, gives the plain version's dq at 1e-5; and the runs
    partition each row block's visible keys."""
    (q, k, v, do), kw = _inputs(case, seed=6)
    q, k, v, do = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = tref.mha_forward_reference(q, k, v, **kw)
    delta = (do * out).sum(-1)
    got = tref.mha_bwd_dq_tc_reference(q, k, v, do, lse, delta,
                                       splits=splits, block_q=rows,
                                       tile_keys=keys, **kw)
    want = tref.mha_bwd_dq_reference(q, k, v, do, lse, delta, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    Sq, Skv = q.shape[1], k.shape[1]
    ok = tref.visible(Sq, Skv, causal=kw["causal"], window=kw["window"],
                      q_offset=kw["q_offset"], device="cpu")
    blocks = tref.dq_runs(Sq, Skv, causal=kw["causal"], window=kw["window"],
                          q_offset=kw["q_offset"], splits=splits,
                          block_q=rows, tile_keys=keys)
    for q0, q1, runs in blocks:
        assert len(runs) == splits
        covered = torch.zeros(Skv, dtype=torch.bool)
        for k0, k1 in runs:
            assert not covered[k0:k1].any()   # runs are disjoint
            covered[k0:k1] = True
        assert torch.all(covered[ok[q0:q1].any(0)])


@pytest.mark.parametrize("splits,rows,tile", [(1, 128, 64), (3, 8, 16),
                                              (4, 16, 8)])
@pytest.mark.parametrize("case", list(CASES))
def test_forward_mirror_matches_plain_at_any_tiling(case, splits, rows, tile):
    """In f32 the blocking, tiling and split count change only the order
    of the sums: the plain version's output and LSE at 1e-5."""
    (q, k, v, _), kw = _inputs(case, seed=2)
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    got = tref.mha_forward_tc_reference(q, k, v, splits=splits,
                                        block_rows=rows, tile_keys=tile, **kw)
    want = tref.mha_forward_reference(q, k, v, **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("splits,keys,qrows", [(1, 64, 64), (2, 16, 8),
                                               (7, 8, 16)])
@pytest.mark.parametrize("case", list(CASES))
def test_dkv_mirror_matches_plain_at_any_tiling(case, splits, keys, qrows):
    """f32 inputs (no hi/lo split): every split count and block size gives
    the plain version's dk and dv at 1e-5."""
    (q, k, v, do), kw = _inputs(case, seed=3)
    q, k, v, do = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = tref.mha_forward_reference(q, k, v, **kw)
    delta = (do * out).sum(-1)
    got = tref.mha_bwd_dkv_tc_reference(q, k, v, do, lse, delta,
                                        splits=splits, block_keys=keys,
                                        block_q=qrows, **kw)
    want = tref.mha_bwd_dkv_reference(q, k, v, do, lse, delta, **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_a_row_that_sees_no_key_gives_zero_and_a_finite_lse(dt):
    """The TPU's convention, kept by the wrapper's plain version and the
    tensor-core mirror: output exactly 0, LSE finite near -1e30 (the
    backward's exp(s - lse) then meets only masked keys)."""
    tdtype, jdtype = DTYPES[dt]
    (q, k, v, _), kw = _inputs("empty-rows-g2-dh16")
    empty = ~tref.visible(q.shape[1], k.shape[1], causal=kw["causal"],
                          window=kw["window"], q_offset=kw["q_offset"],
                          device="cpu").any(-1)
    assert 0 < int(empty.sum()) < q.shape[1]
    tq, tk, tv = (torch.from_numpy(a).to(tdtype) for a in (q, k, v))
    _, jlse = _jax_forward(*(jnp.asarray(a, jdtype) for a in (q, k, v)), kw)
    for out, lse in (tmha.mha_forward(tq, tk, tv, return_lse=True, **kw),
                     tref.mha_forward_tc_reference(tq, tk, tv, splits=SPLITS,
                                                   block_rows=ROWS,
                                                   tile_keys=TILE, **kw)):
        assert torch.all(out[:, empty] == 0)
        assert torch.isfinite(lse).all()
        assert torch.all(lse[:, empty] <= -1e29)
        assert torch.all(lse[:, ~empty] > -1e3)
        np.testing.assert_allclose(lse[:, empty].numpy(),
                                   np.asarray(jlse)[:, empty.numpy()])
    # dq: such a row's probabilities are all 0, so its gradient is exactly
    # 0 in the wrapper's plain version and in the tensor-core mirror
    out, lse = tmha.mha_forward(tq, tk, tv, return_lse=True, **kw)
    tdo = torch.from_numpy(_inputs("empty-rows-g2-dh16")[0][3]).to(tdtype)
    delta = (tdo.float() * out.float()).sum(-1)
    for dq in (tmha.mha_bwd_dq(tq, tk, tv, tdo, lse, delta, **kw),
               tref.mha_bwd_dq_tc_reference(tq, tk, tv, tdo, lse, delta,
                                            splits=2, block_q=DQROWS,
                                            tile_keys=DQKEYS, **kw)):
        assert torch.all(dq[:, empty] == 0)
        assert torch.isfinite(dq).all()
        assert torch.any(dq[:, ~empty] != 0)


def test_bf16_mirrors_round_where_the_kernels_do():
    """bf16 in: the forward mirror rounds P for P V and the dk/dv mirror
    splits P^T and dS^T into hi + lo, so each sits within bf16 rounding of
    its f32 run on the same (bf16-exact) inputs, and the hi + lo sum much
    closer than one rounding would allow."""
    (q, k, v, do), kw = _inputs("causal-g7-dh32", seed=4)
    b = [torch.from_numpy(a).bfloat16() for a in (q, k, v, do)]
    f = [t.float() for t in b]
    ob, lb = tref.mha_forward_tc_reference(*b[:3], **kw)
    of, lf = tref.mha_forward_tc_reference(*f[:3], **kw)
    assert ob.dtype == torch.bfloat16
    # without round_out: the f32 value that the bf16 output rounds once
    o32, _ = tref.mha_forward_tc_reference(*b[:3], round_out=False, **kw)
    assert o32.dtype == torch.float32 and torch.equal(o32.bfloat16(), ob)
    np.testing.assert_allclose(ob.float().numpy(), of.numpy(), atol=2e-2,
                               rtol=2e-2)
    np.testing.assert_allclose(lb.numpy(), lf.numpy(), atol=1e-5, rtol=1e-5)
    delta = (f[3] * of).sum(-1)
    dkb, dvb = tref.mha_bwd_dkv_tc_reference(*b, lf, delta, **kw)
    dkf, dvf = tref.mha_bwd_dkv_tc_reference(*f, lf, delta, **kw)
    for x, y in ((dkb, dkf), (dvb, dvf)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=2e-5,
                                   rtol=2e-5)
