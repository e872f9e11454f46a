"""The traffic generator: the same requests for a seed, a trace of its
own for every seed, stratified blocks, Poisson arrivals, clipped as the
mix states."""
import json
from pathlib import Path

import numpy as np
import pytest

from perfbench import traffic

MIXES = Path(__file__).resolve().parents[1] / "traffic"


@pytest.mark.parametrize("name", ["longctx-batch", "chat-rate"])
def test_same_per_seed_and_clipped(name):
    mix = traffic.load(MIXES / f"{name}.json")
    seed = 3_000_000_000_123
    a, b = traffic.schedule(mix, seed, 256), traffic.schedule(mix, seed, 256)
    assert a == b
    assert traffic.prompt_tokens(seed, 5, 40, 1000) == \
        traffic.prompt_tokens(seed, 5, 40, 1000)
    p, o = mix["prompt"], mix["output"]
    first = mix["engine"]["slots"] if mix["warmup"]["kind"] == "first_wave" \
        else 0
    for s in a:
        assert p["min"] <= s.prompt_len <= p["max"]
        assert 1 <= s.max_new <= o["max"]
        assert s.prompt_len + s.max_new <= mix["engine"]["max_seq"]
        if s.rid >= first:
            assert s.max_new >= min(o["min"],
                                    mix["engine"]["max_seq"] - s.prompt_len)


@pytest.mark.parametrize("name", ["longctx-batch", "chat-rate"])
def test_every_seed_draws_a_trace_of_its_own(name):
    mix = traffic.load(MIXES / f"{name}.json")
    a = traffic.schedule(mix, 1, 256)
    b = traffic.schedule(mix, -(2 ** 40) - 7, 256)
    for key in ("prompt_len", "max_new"):
        xa = [getattr(s, key) for s in a]
        xb = [getattr(s, key) for s in b]
        assert xa != xb and sorted(xa) != sorted(xb)
    if mix["loop"] == "poisson":
        assert [s.due for s in a] != [s.due for s in b]


@pytest.mark.parametrize("period", [1, 8, 64])
def test_levels_stratified_in_blocks(period):
    lv = traffic.levels(3_000_000_000_123, 1, 4 * period + 3, period)
    assert len(lv) == 4 * period + 3
    assert np.all((lv >= 0) & (lv < 1))
    for b in range(4):
        block = lv[b * period:(b + 1) * period]
        # one draw in every stratum [i / period, (i + 1) / period)
        assert sorted(np.floor(block * period).astype(int)) == \
            list(range(period))
    assert list(lv) == list(traffic.levels(3_000_000_000_123, 1,
                                           4 * period + 3, period))
    assert list(lv) != list(traffic.levels(3_000_000_000_124, 1,
                                           4 * period + 3, period))


def test_poisson_gaps_are_exponential():
    """Period 1: independent exponential gaps at the mix's rate, so the
    arrivals are a Poisson process (coefficient of variation 1, counts in
    a second with variance equal to their mean)."""
    mix = traffic.load(MIXES / "chat-rate.json")
    assert mix["period"] == 1
    specs = traffic.schedule(mix, 77_000_000_001, 4000)
    due = np.array([s.due for s in specs])
    gaps = np.diff(np.concatenate([[0.0], due]))
    rate = mix["rate_per_s"]
    assert gaps.mean() == pytest.approx(1 / rate, rel=0.05)
    assert gaps.std() / gaps.mean() == pytest.approx(1.0, rel=0.08)
    counts = np.bincount(due.astype(int))[:-1]
    assert counts.var() / counts.mean() == pytest.approx(1.0, rel=0.15)


@pytest.mark.parametrize("name", ["longctx-batch", "chat-rate"])
def test_seeds_share_sizes_in_another_order(name):
    """Every block of ``period`` requests draws one prompt and one output
    from each of the period's strata, whatever the seed; the seed draws
    their order and values."""
    mix = traffic.load(MIXES / f"{name}.json")
    P = mix["period"]
    for seed in (5, 2 ** 33 + 1):
        specs = traffic.schedule(mix, seed, 10 * P)
        for stream, key, dist in ((1, "prompt_len", "prompt"),
                                  (2, "max_new", "output")):
            lv = traffic.levels(seed, stream, 10 * P, P)
            x = traffic.quantiles(mix[dist], lv)
            if key == "max_new":
                x = np.minimum(x, mix["engine"]["max_seq"]
                               - np.array([s.prompt_len for s in specs]))
                if mix["warmup"]["kind"] == "first_wave":
                    x = x[mix["engine"]["slots"]:]
                    specs_k = specs[mix["engine"]["slots"]:]
                else:
                    specs_k = specs
            else:
                specs_k = specs
            assert [getattr(s, key) for s in specs_k] == list(x)
            for b in range(10):
                assert sorted(np.floor(lv[b * P:(b + 1) * P] * P)) == \
                    list(range(P))


def test_levels_and_quantiles():
    dist = {"dist": "lognormal", "median": 512, "sigma": 0.8, "min": 64,
            "max": 3072}
    x = traffic.quantiles(dist, np.array([0.5, 0.0, 1e-9, 1 - 1e-9]))
    assert list(x) == [512, 64, 64, 3072]


def test_mix_files_valid():
    for path in MIXES.glob("*.json"):
        mix = traffic.load(path)
        assert mix["warmup"]["kind"] in ("first_wave", "seconds")
        assert json.loads(path.read_text())["check"]["served_tokens"] > 0
