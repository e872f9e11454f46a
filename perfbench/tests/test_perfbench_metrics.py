"""The metric arithmetic against hand-worked cases."""
import math

import pytest

from perfbench import costs, devtrace, readers
from perfbench.reference import model


def rec_of(requests, t_open=10.0, t_close=20.0, **kw):
    return dict({"t_open": t_open, "t_close": t_close, "loop": "poisson",
                 "requests": requests, "steps": [], "profile": {},
                 "setup_s": 1.5}, **kw)


def test_itl_every_gap_that_ends_in_the_window():
    r = {0: {"due": 9.0, "admit": 9.1, "times": [9.5, 10.5, 11.0, 21.0]},
         1: {"due": 10.0, "admit": 10.0, "times": [10.2, 10.4]}}
    # gaps ending in [10, 20): 1.0, 0.5 (request 0), 0.2 (request 1)
    assert readers.itl_ms(rec_of(r), 50.0) == pytest.approx(500.0)
    assert readers.itl_ms(rec_of(r), 100.0) == pytest.approx(1000.0)
    assert readers.itl_ms(rec_of(r), 95.0) == pytest.approx(950.0)


def test_out_tok_s_over_the_window():
    r = {0: {"due": 0, "times": [9.9, 10.0, 12.0, 19.99, 20.0]},
         1: {"due": 0, "times": [15.0]}}
    assert readers.out_tok_s(rec_of(r)) == pytest.approx(4 / 10.0)


def test_ttft_counts_failures_as_misses():
    r = {i: {"due": 10.0 + i, "admit": 10.0 + i, "times": [10.1 + i]}
         for i in range(19)}
    assert readers.ttft_ms(rec_of(r)) == pytest.approx(100.0)
    r[19] = {"due": 19.5, "admit": None, "times": [], "error": "x"}
    assert readers.ttft_ms(rec_of(r)) == math.inf
    assert readers.ttft_ms(rec_of(r), 50.0) == pytest.approx(100.0)


def test_queue_wait_and_decode_batch():
    r = {0: {"due": 10.0, "admit": 10.2, "times": []},
         1: {"due": 11.0, "admit": 11.4, "times": []},
         2: {"due": 25.0, "admit": 25.0, "times": []}}
    steps = [{"decode_slots": [0, 1, 2], "chunks": []},
             {"decode_slots": [], "chunks": [(0, 0, 5)]},
             {"decode_slots": [4], "chunks": []}]
    rec = rec_of(r, steps=steps)
    assert readers.queue_wait_ms(rec) == pytest.approx(300.0)
    assert readers.decode_batch(rec) == pytest.approx(2.0)


def test_idle_share_on_a_synthetic_timeline():
    ev = [(devtrace.STEP, False, 0.0, 100.0),
          (devtrace.STEP, False, 200.0, 300.0),
          ("host.decode", False, 50.0, 100.0),
          ("host.decode", True, 0.0, 100.0),   # an annotation, not work
          ("k1", True, 10.0, 40.0), ("k2", True, 30.0, 60.0),
          ("ContigRows k", True, 220.0, 280.0),
          ("nvjet gemm", True, 150.0, 160.0)]
    p = devtrace.reduce(ev, ["decode_attention"])
    # steps 200 us; covered 50 + 60; the gemm lies between them
    assert p["step_idle_pct"] == pytest.approx(100.0 * (1 - 110 / 200))
    assert p["window_s"] == pytest.approx(300e-6)
    assert p["busy_s"] == pytest.approx(120e-6)
    assert p["groups_ms"] == pytest.approx(
        {"other": 0.06, "decode_attention": 0.06, "library GEMM": 0.01})
    # the gaps: 90 us from 60 (inside host.decode), 60 from 160, 20, 10
    assert p["idle_gaps"][:2] == [["decode", pytest.approx(90e-6)],
                                  ["between phases", pytest.approx(60e-6)]]


M = {"num_layers": 2, "d_model": 8, "num_heads": 4, "num_kv_heads": 2,
     "head_dim": 2, "d_ff": 16, "vocab_size": 10, "num_experts": 0,
     "experts_per_token": 0}


def test_decode_attention_bytes_from_cache_len():
    # per layer: q and out 2 * 2 slots * 4 heads * 2 dims; K and V over
    # (3 + 1) + (0 + 1) rows * 2 kv heads * 2 dims, each twice; 2 bytes
    want = 2 * 2 * (2 * 2 * 4 * 2 + 2 * 5 * 2 * 2)
    assert model.decode_attention_bytes(M, [3, 0]) == want


def test_model_flops():
    attn = 8 * (4 + 4) * 2 + 4 * 2 * 8
    per_layer = attn + 3 * 8 * 16
    # one decode token at cache_len 3: weights, head, 4 keys of attention
    assert model.decode_flops(M, [3]) == \
        2 * (2 * per_layer + 8 * 10) + 4 * 4 * 4 * 2 * 2
    # a chunk of 3 tokens from position 5: 6 + 7 + 8 keys, no head
    assert model.chunk_flops(M, 5, 3) == \
        3 * 2 * 2 * per_layer + 4 * 21 * 4 * 2 * 2
    moe = dict(M, num_experts=4, experts_per_token=2)
    assert model.block_params(moe) == attn + 2 * 3 * 8 * 16 + 8 * 4


def test_roofline_and_mfu_readers():
    steps = [{"profiled": True, "cache_len": [3, 0], "chunks": [(0, 5, 3)],
              "decode_slots": [0, 1], "t0": 0.0, "t1": 1.0},
             {"profiled": False, "cache_len": [9], "chunks": [(1, 2, 4)],
              "decode_slots": [0], "t0": 1.0, "t1": 1.002}]
    nbytes = model.decode_attention_bytes(M, [3, 0])
    t = nbytes / costs.HBM_BYTES_PER_S          # seconds at the bound
    prof = {"steps": 1, "step_s": 1e-3, "step_idle_pct": 5.0,
            "groups_ms": {"decode_attention": 2e3 * t, "other": 1.0}}
    rec = rec_of({}, steps=steps, profile=prof, model=M)
    # the roofline reads the profiled steps; MFU the others, by host spans
    assert readers.decode_attention_roofline_pct(rec) == pytest.approx(50.0)
    flops = model.decode_flops(M, [9]) + model.chunk_flops(M, 2, 4)
    assert readers.mfu_pct(rec) == pytest.approx(
        100 * flops / (2e-3 * costs.PEAK_BF16_FLOPS))
    assert readers.group_ms_per_step(rec, "other") == 1.0
    assert readers.group_ms_per_step(rec, "library GEMM") is None
    assert readers.mfu_pct(rec_of({})) is None
