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


# the wide backward geometries' cases: (S, dh, window, q_offset); the
# third's rows from 36 on see no key
WIDE_CASES = {"dh256-window": (150, 256, 70, 0),
              "dh200-window": (150, 200, 70, 0),
              "dh256-empty-rows": (100, 256, 64, 100)}


def _wide_inputs(case, seed):
    S, dh, window, off = WIDE_CASES[case]
    (q, k, v, do), kw = _inputs(S, dh, window, seed)
    kw["q_offset"] = off
    return (q, k, v, do), kw


def _bf16_residuals(q, k, v, do, kw):
    """bf16 inputs, JAX's forward residuals on them, and JAX's gradients
    in f32 math on the same inputs."""
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do))
    S = q.shape[1]
    jout, jlse = jmha.mha_forward(jq, jk, jv, block_q=S, block_k=S,
                                  interpret=True, return_lse=True, **kw)
    grads = jmha.mha_backward(jq, jk, jv, jout, jlse, jdo, block_q=S,
                              block_k=S, interpret=True, **kw)
    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    out = torch.from_numpy(np.array(jout.astype(jnp.float32))).bfloat16()
    lse = torch.from_numpy(np.array(jlse))
    delta = (tdo.float() * out.float()).sum(-1)
    return (tq, tk, tv, tdo, lse, delta), grads


@pytest.mark.parametrize("part", ["dq", "dkv"])
@pytest.mark.parametrize("case", list(WIDE_CASES))
def test_backward_mirrors_at_the_wide_geometry_match_jax(case, part):
    """The bf16 dq and dk/dv kernels' algebra above dh 128 (hi + lo dS, P^T
    and dS^T; runs summed in order) at their own geometry
    (``mha.dq_tiles`` / ``mha.dkv_tiles``: 64-row blocks over 32-key
    tiles, 64-key blocks over 64-row items) and 2 splits, on bf16 inputs,
    against JAX's f32 math on the same inputs and residuals."""
    (q, k, v, do), kw = _wide_inputs(case, seed=11)
    S, dh = q.shape[1], q.shape[2]
    args, (jdq, jdk, jdv) = _bf16_residuals(q, k, v, do, kw)
    if part == "dq":
        bq, bk = tmha.dq_tiles(dh)
        got = (tref.mha_bwd_dq_tc_reference(*args, splits=2, block_q=bq,
                                            tile_keys=bk, **kw),)
        want = (jdq,)
    else:
        bk, bq = tmha.dkv_tiles(dh)
        got = tref.mha_bwd_dkv_tc_reference(*args, splits=2, block_keys=bk,
                                            block_q=bq, **kw)
        want = (jdk, jdv)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=F32_TOL,
                                   rtol=F32_TOL)
    if case == "dh256-empty-rows":
        empty = ~tref.visible(S, S, causal=True, window=kw["window"],
                              q_offset=kw["q_offset"], device="cpu").any(-1)
        assert 0 < int(empty.sum()) < S
        if part == "dq":
            assert torch.all(got[0][:, empty] == 0)


@pytest.mark.parametrize("splits,tiles", [(1, (64, 64)), (3, (64, 32)),
                                          (5, (32, 16)), (2, (48, 40))])
@pytest.mark.parametrize("part", ["dq", "dkv"])
@pytest.mark.parametrize("case", list(WIDE_CASES))
def test_backward_mirrors_above_dh128_match_plain_at_any_tiling(case, part,
                                                                splits,
                                                                tiles):
    """f32 inputs (no hi/lo split): at dh 256 and 200 every split count
    and tiling, the wide kernels' own among them, gives the plain
    version's dq, dk and dv at 1e-5; and the runs cover every visible
    (query, key) pair once."""
    (q, k, v, do), kw = _wide_inputs(case, seed=12)
    q, k, v, do = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = tref.mha_forward_reference(q, k, v, **kw)
    delta = (do * out).sum(-1)
    S = q.shape[1]
    mask = dict(causal=True, window=kw["window"], q_offset=kw["q_offset"])
    ok = tref.visible(S, S, device="cpu", **mask)
    seen = torch.zeros((S, S), dtype=torch.int32)
    if part == "dq":
        got = (tref.mha_bwd_dq_tc_reference(
            q, k, v, do, lse, delta, splits=splits, block_q=tiles[0],
            tile_keys=tiles[1], **kw),)
        want = (tref.mha_bwd_dq_reference(q, k, v, do, lse, delta, **kw),)
        for q0, q1, runs in tref.dq_runs(S, S, splits=splits,
                                         block_q=tiles[0],
                                         tile_keys=tiles[1], **mask):
            for k0, k1 in runs:
                seen[q0:q1, k0:k1] += 1
    else:
        got = tref.mha_bwd_dkv_tc_reference(
            q, k, v, do, lse, delta, splits=splits, block_keys=tiles[0],
            block_q=tiles[1], **kw)
        want = tref.mha_bwd_dkv_reference(q, k, v, do, lse, delta, **kw)
        group = q.shape[0] // k.shape[0]
        for kb0, kb1, qt_lo, nqt, runs in tref.dkv_runs(
                S, S, group, splits=splits, block_keys=tiles[0],
                block_q=tiles[1], **mask):
            for i_lo, i_hi in runs:
                for it in range(i_lo, i_hi):
                    if it // nqt == 0:      # the first head's items
                        q0 = (qt_lo + it % nqt) * tiles[1]
                        seen[q0:q0 + tiles[1], kb0:kb1] += 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=F32_TOL,
                                   rtol=F32_TOL)
    assert torch.all(seen[ok] == 1)


@pytest.mark.parametrize("dh,dq_tiles,dkv_tiles",
                         [(64, (64, 64), (64, 64)), (128, (64, 64), (64, 64)),
                          (129, (64, 32), (64, 64)),
                          (256, (64, 32), (64, 64))])
def test_backward_tiles_follow_the_geometry(dh, dq_tiles, dkv_tiles):
    assert tmha.dq_tiles(dh) == dq_tiles
    assert tmha.dkv_tiles(dh) == dkv_tiles


# (BH, BKV, Sq, Skv, dh, dq splits, dk/dv splits) on 132 SMs: qwen2-7b's
# rows whose plans the card printed at dh 128 (q_offset 3968's 128 rows,
# one kv head's 7 heads over 8192 tokens), and recurrentgemma-2b's local
# attention above it (its 4096-token max_seq, the ragged 1292-token
# prompt, a model=2 training rank)
SPLIT_CASES = [(28, 4, 128, 4096, 128, 4, 2), (7, 1, 8192, 8192, 128, 2, 14),
               (10, 1, 4096, 4096, 256, 1, 10),
               (10, 1, 1292, 1292, 256, 2, 12),
               (5, 1, 2048, 2048, 256, 3, 8)]


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_rules_cap_runs_and_fill_the_card(case):
    """The restated plans (``mha.dq_split_rule``, ``mha.dkv_split_rule``,
    which ``chip_smoke.py`` holds to the C plans): the expected split
    counts; more than one split wherever the blocks alone fill less than
    the rule's blocks an SM, as for recurrentgemma-2b's one kv head at
    1292 tokens; and no run past its cap."""
    BH, BKV, Sq, Skv, dh, want_q, want_kv = case
    sms = 132
    n_q = tmha.dq_split_rule(BH, Sq, Skv, dh, sms)
    n_kv = tmha.dkv_split_rule(BH, BKV, Sq, Skv, dh, sms)
    assert (n_q, n_kv) == (want_q, want_kv)
    bk, bq = tmha.dkv_tiles(dh)
    per_sm, _ = tmha.DKV_FILL[dh > tmha.TC_MAX_HEAD_DIM]
    if BKV * -(-Skv // bk) < per_sm * sms:
        assert n_kv > 1
    rows, keys = tmha.dq_tiles(dh)
    per_sm, _ = tmha.DQ_FILL[dh > tmha.TC_MAX_HEAD_DIM]
    if BH * -(-Sq // rows) * 2 <= per_sm * sms:
        assert n_q > 1
    mask = dict(causal=True, window=0, q_offset=Skv - Sq)
    longest_kv = max(hi - lo for *_, runs in tref.dkv_runs(
        Sq, Skv, BH // BKV, splits=n_kv, block_keys=bk, block_q=bq, **mask)
        for lo, hi in runs)
    assert longest_kv <= tref.dkv_run_items(bq)
    longest_q = max(hi - lo for *_, runs in tref.dq_runs(
        Sq, Skv, splits=n_q, block_q=rows, tile_keys=keys, **mask)
        for lo, hi in runs)
    assert longest_q <= tref.DQ_RUN_KEYS
