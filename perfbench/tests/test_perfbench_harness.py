"""The harness end to end on the CPU at tiny sizes: the reference
against the port's CPU path (a dense and an expert model, whose decode
steps route every slot row in one group and drop past capacity), the
faults of the timed path that ``correct`` must catch, the control, and
discovery of a new cell by name."""
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench import bench

CELLS = ("dense.tiny", "moe.tiny")
# the two kinds of number a cell may hold to a limit: the widest gap (as
# deepseek-7b's cell) and the share of served tokens not the reference's
# best, at grok-1's limit
LIMITS = {"widest": {"widest_logit_gap": 1e-3},
          "share": {"not_best_share": 0.14}}


# the control at this size: its share of tokens not the reference's best
# reads 0.074-0.117 over three seeds in both cells, the program's 0 (float32
# both sides), so a share limit here lies between them
CONTROL_LIMITS = {"widest": {"widest_logit_gap": 1e-3},
                  "share": {"not_best_share": 0.03}}


def hold_to(root, cell, limits):
    (root / "perfbench" / "cells" / f"{cell}.json").write_text(json.dumps(
        {"limits": limits, "readings": {}}))


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny engines on one thread: the suite's workers share the cores,
    and a run's window is wall-clock time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(root, cell, trace=False, control=False, seed=1234567890123,
        seconds=1.0):
    return bench.run_cell(root, cell, seed, seconds, trace,
                          time.perf_counter(),
                          device="cpu", chips_check=False, control=control)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_follows_the_port(tiny, cell):
    line, info = run(tiny, cell)
    assert line["correct"], (line, info)
    assert line["checks"]["widest_logit_gap"]["value"] < 1e-4
    assert info["sample"]["served_tokens"] >= 16
    assert set(line["metrics"]) >= {"itl_p95_ms", "setup_s"}
    if cell == "moe.tiny":
        # slot rows share a routing group: tokens past capacity dropped
        assert info["sample"]["reference_drops"] > 0
        assert info["ttft_ms"]["p95"] > 0
    else:
        assert "out_tok_s" in line["metrics"]


def _token_altered(orig):
    calls = [0]

    def step(*a, **kw):
        logits, caches = orig(*a, **kw)
        calls[0] += 1
        if calls[0] % 3 == 0:
            logits = logits.clone()
            logits[:, 7] += 1e3
        return logits, caches
    return step


def _state_unchanged(orig):
    def step(params, tokens, caches, *a, **kw):
        saved = [{n: b.clone() for n, b in c.items()} for c in caches]
        logits, _ = orig(params, tokens, caches, *a, **kw)
        for c, s in zip(caches, saved):
            for n, b in c.items():
                b.copy_(s[n])
        return logits, caches
    return step


def _half_batch(orig):
    """Each step leaves out one half of its slot rows, in turn, and gives
    them the other half's logits."""
    calls = [0]

    def step(*a, **kw):
        logits, caches = orig(*a, **kw)
        calls[0] += 1
        h = logits.shape[0] // 2
        kept = logits[:h] if calls[0] % 2 else logits[h:2 * h]
        return torch.cat([kept, kept]), caches
    return step


FAULTS = [_token_altered, _state_unchanged, _half_batch]


def _faulty_run(tiny, cell, fault, limits, monkeypatch):
    from repro_torch.models import transformer
    hold_to(tiny, cell, limits)
    monkeypatch.setattr(transformer, "decode_step",
                        fault(transformer.decode_step))
    line, _ = run(tiny, cell)
    assert set(line["checks"]) == set(limits) | {"failed_requests"}
    return line


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", FAULTS)
def test_faults_come_out_not_correct(tiny, cell, fault, monkeypatch):
    line = _faulty_run(tiny, cell, fault, LIMITS["widest"], monkeypatch)
    assert line["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", FAULTS)
def test_faults_fail_the_share_limit(tiny, cell, fault, monkeypatch):
    """The same faults held to grok-1's committed check: the share of
    served tokens not the reference's best, at 0.14."""
    line = _faulty_run(tiny, cell, fault, LIMITS["share"], monkeypatch)
    assert line["correct"] is False


def _control(tiny, cell, limits):
    """The control (the reference in fp8 in the program's place) goes
    through the same checks as the program and fails them, while the
    program passes."""
    hold_to(tiny, cell, limits)
    line, info = run(tiny, cell, control=True, seconds=2.0)
    assert line["correct"]
    ctl = info["control"]
    assert ctl["correct"] is False
    assert set(ctl["checks"]) == set(limits)
    for c in ctl["checks"].values():
        assert c["value"] > c["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(tiny, cell):
    _control(tiny, cell, CONTROL_LIMITS["widest"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_share_limit(tiny, cell):
    _control(tiny, cell, CONTROL_LIMITS["share"])


def test_sample_holds_enough_requests():
    from perfbench.reference import check

    class R:
        def __init__(self, n_prompt, n_out):
            self.tokens, self.out = [0] * n_prompt, [1] * n_out
    requests = {i: R(10 + i, 50 if i == 3 else 2) for i in range(12)}
    rec = {"t_open": 0.0, "t_close": 10.0,
           "requests": {i: {"done": 1.0 + i / 2} for i in range(12)}}
    # the longest alone holds the tokens: the count of requests decides
    got = check.sample(rec, requests, 99, served=40, n_requests=6)
    assert got[0] == 3 and len(got) == 6 and len(set(got)) == 6
    assert check.sample(rec, requests, 99, served=40) == [3]
    # too few requests finished: every one of them
    assert sorted(check.sample(rec, requests, 99, 40, 50)) == list(range(12))


def test_a_cell_added_as_new_files(tiny):
    pb = tiny / "perfbench"
    conf = json.loads((pb / "configs" / "dense.json").read_text())
    (pb / "configs" / "dense2.json").write_text(json.dumps(
        dict(conf, name="dense2")))
    mix = json.loads((pb / "traffic" / "tiny-batch.json").read_text())
    mix["engine"]["slots"] = 3
    (pb / "traffic" / "tiny-batch3.json").write_text(json.dumps(mix))
    (pb / "metrics" / "twice_batch.new.py").write_text(
        "from perfbench.readers import decode_batch\n\n\n"
        "def read(rec):\n    v = decode_batch(rec)\n"
        "    return None if v is None else 2 * v\n")
    (pb / "cells" / "dense2.batch3.json").write_text(json.dumps(
        {"limits": {"widest_logit_gap": 1e-3}, "readings": {}}))
    b = json.loads((tiny / "BENCHMARK.json").read_text())
    b["configs"].append(dict(b["configs"][0], name="dense2",
                             file="perfbench/configs/dense2.json"))
    b["workloads"].append(dict(b["workloads"][0], name="dense2.batch3",
                               config="dense2", traffic="tiny-batch3"))
    b["per_layer"].append({"name": "twice_batch.new", "unit": "slots",
                           "better": "higher", "source": "program_counter",
                           "layer": "engine and scheduler",
                           "moves": "out_tok_s",
                           "workloads": ["dense2.batch3"]})
    (tiny / "BENCHMARK.json").write_text(json.dumps(b))
    line, _ = run(tiny, "dense2.batch3", trace=True, seconds=0.4)
    assert line["correct"]
    assert set(line["metrics"]) == {"twice_batch.new"}
    assert 0 < line["metrics"]["twice_batch.new"]["value"] <= 6


def _run_py(root, env_extra=None):
    import os
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "dense.tiny",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=root, env=env, capture_output=True, text=True, timeout=120)


def test_no_card_no_result(tiny):
    # the tiny checkout has no src/: link the port in, then look for a card
    (tiny / "src").symlink_to(Path(__file__).resolve().parents[2] / "src")
    p = _run_py(tiny)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_benchmark_files_alone_no_result(tiny):
    p = _run_py(tiny)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.card
def test_cells_on_the_card(card):
    root = Path(__file__).resolve().parents[2]
    for cell in json.loads((root / "BENCHMARK.json").read_text())[
            "workloads"]:
        p = subprocess.run(
            [sys.executable, "perfbench/run.py", "--workload", cell["name"],
             "--seed", "77", "--seconds", "5", "--trace", "0"],
            cwd=root, capture_output=True, text=True, timeout=600)
        assert p.returncode == 0, p.stderr[-3000:]
        line = json.loads(p.stdout.strip().splitlines()[-1])
        assert list(line)[-1] == "checks"
        assert line["device"]["platform"] == "gpu"
