"""The harness end to end on the CPU at tiny sizes: the reference
against the port's CPU path (a dense and an expert model, whose decode
steps route every slot row in one group and drop past capacity), the
faults of the timed path that ``correct`` must catch, the control,
discovery of a new cell by name, a configuration with a model module of
its own, and the default module's weights and layouts held to fixed
hashes."""
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench import bench, weights
from perfbench.reference import model

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


# qwen2's block, a layout the default model module cannot draw (q, k and v
# biases, as the port's attention_bias adds them before the rotary
# positions), as a later configuration brings it: a module of its own
QWEN2 = '''"""qwen2's block: the default model with q, k and v biases added
before the rotary positions.  Its operation counts are the default's
doubled, a count of its own that a reading from the default's misses."""
from perfbench.reference import model
from perfbench.reference.model import (  # noqa: F401
    NOT_PORT, PORT_NAMES, decode_attention_bytes, logits_for)
from perfbench.weights import leaf

BIASES = ("bq", "bk", "bv")


def layout(m):
    L, D = m["num_layers"], m["d_model"]
    H, KV, dh = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    out = model.layout(m)
    for n, heads in zip(BIASES, (H, KV, KV)):
        out[model.BLOCK + "attn/" + n] = ((L, heads, dh), D, "w")
    return out


class Reference(model.Reference):
    def layer(self, i):
        w = super().layer(i)
        for n in BIASES:
            w[n] = leaf(self.t, model.BLOCK + "attn/" + n)[i].float()
            w[n] = w[n].reshape(-1)
        return w

    def qkv(self, w, x, pos):
        h = self.rms(x, w["ln1/scale"])
        sh = h.shape[:-1]
        q, k, v = ((self.mm(h, w["w" + c]) + w["b" + c])
                   .reshape(*sh, n, self.dh)
                   for c, n in (("q", self.H), ("k", self.KV),
                                ("v", self.KV)))
        return self.rope(q, pos), self.rope(k, pos), v


def token_flops(m, context, head):
    return 2 * model.token_flops(m, context, head)


def chunk_flops(m, start, n):
    return 2 * model.chunk_flops(m, start, n)


def decode_flops(m, cache_lens):
    return sum(token_flops(m, int(c) + 1, True) for c in cache_lens)
'''


def test_a_configuration_with_its_own_reference(tiny, monkeypatch):
    """A configuration whose layout, reference and operation counts are
    its own, added as new files and entries only."""
    pb = tiny / "perfbench"
    conf = json.loads((pb / "configs" / "dense.json").read_text())
    conf["model"].update(num_kv_heads=2, attention_bias=True,
                         rope_theta=1e6)
    conf.update(name="qwen2", registry_id="qwen2-7b", reference="qwen2")
    # the default module's layout lacks the biases of the port's spec tree
    with pytest.raises(ValueError, match="layout differs"):
        bench.check_layout(
            weights.make(model.layout(conf["model"]), torch.float32, 3,
                         "cpu"), bench.model_config(conf, model))
    (pb / "configs" / "qwen2.json").write_text(json.dumps(conf))
    (pb / "reference" / "qwen2.py").write_text(QWEN2)
    mix = json.loads((pb / "traffic" / "tiny-batch.json").read_text())
    (pb / "traffic" / "tiny-bias.json").write_text(json.dumps(mix))
    hold_to(tiny, "qwen2.bias", {"widest_logit_gap": 1e-3})
    # mfu_pct read through the record's module, and through the default
    # module on the same record
    (pb / "metrics" / "mfu_pct.bias.py").write_text(
        "from perfbench.readers import mfu_pct as read  # noqa: F401\n")
    (pb / "metrics" / "mfu_default.bias.py").write_text(
        "from perfbench.readers import mfu_pct\n\n\n"
        "def read(rec):\n    return mfu_pct(dict(rec, reference='model'))\n")
    b = json.loads((tiny / "BENCHMARK.json").read_text())
    b["configs"].append(dict(b["configs"][0], name="qwen2",
                             file="perfbench/configs/qwen2.json"))
    b["workloads"].append(dict(b["workloads"][0], name="qwen2.bias",
                               config="qwen2", traffic="tiny-bias"))
    for name in ("mfu_pct.bias", "mfu_default.bias"):
        b["per_layer"].append({"name": name, "unit": "%",
                               "better": "higher", "source": "host_clock",
                               "layer": "whole step", "moves": "out_tok_s",
                               "workloads": ["qwen2.bias"]})
    (tiny / "BENCHMARK.json").write_text(json.dumps(b))
    # a short traced sub-window, so that unprofiled steps count
    monkeypatch.setattr(bench, "PROFILE_S", 0.3)
    line, info = run(tiny, "qwen2.bias", trace=True, seconds=1.0)
    assert line["correct"], (line, info)
    assert line["checks"]["widest_logit_gap"]["value"] < 1e-4
    assert info["sample"]["served_tokens"] >= 16
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(got) == {"mfu_pct.bias", "mfu_default.bias"}
    assert got["mfu_pct.bias"] == pytest.approx(2 * got["mfu_default.bias"])


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


# sha256 (first 16 hex digits) of every leaf the default model module
# draws for the tiny cells in float32 on the CPU at seed 1234567890123,
# and of the layout (paths, shapes, widths, kinds, in draw order) at the
# committed configurations' full sizes; taken before the layout moved out
# of perfbench/weights.py, so the same seed draws the same weights
DRAWN = {
    "dense": {
        "embed/embedding": "813f807c152c1cc8",
        "blocks/pos0/ln1/scale": "2d2d882f8fa4d609",
        "blocks/pos0/attn/wq": "828370eeff71ad27",
        "blocks/pos0/attn/wk": "582ef733084c7784",
        "blocks/pos0/attn/wv": "c466a020fbe8996f",
        "blocks/pos0/attn/wo": "2960f3bb39d1766b",
        "blocks/pos0/ln2/scale": "30d0c979b9e4c724",
        "blocks/pos0/ffn/w_in": "3ef5eb55e29a444f",
        "blocks/pos0/ffn/w_gate": "55f2b08bbb8a9f7b",
        "blocks/pos0/ffn/w_out": "c12c648a46ed0585",
        "final_norm/scale": "99db1d6f6278561f",
        "lm_head/w": "1fafc8de1f2ac9fd"},
    "moe": {
        "embed/embedding": "813f807c152c1cc8",
        "blocks/pos0/ln1/scale": "2d2d882f8fa4d609",
        "blocks/pos0/attn/wq": "828370eeff71ad27",
        "blocks/pos0/attn/wk": "87f3cba1354a9059",
        "blocks/pos0/attn/wv": "352a995e84adafa9",
        "blocks/pos0/attn/wo": "c466a020fbe8996f",
        "blocks/pos0/ln2/scale": "898f8035f16c6923",
        "blocks/pos0/ffn/router": "002ff95f6bb92c08",
        "blocks/pos0/ffn/w_in": "b95b67192fc1dfc7",
        "blocks/pos0/ffn/w_gate": "1cb77e45fb0ffd88",
        "blocks/pos0/ffn/w_out": "ff337a756a584f36",
        "final_norm/scale": "3bc7842b5314da92",
        "lm_head/w": "b92f4a05ff3a439e"}}
LAYOUT = {"deepseek-7b": "bd8a5d4a8fb6c532",
          "grok-1-314b-4L": "7cfd97d8cef41008"}


@pytest.mark.parametrize("config", sorted(DRAWN))
def test_default_module_draws_the_same_weights(tiny, config):
    m = json.loads((tiny / "perfbench" / "configs" / f"{config}.json")
                   .read_text())["model"]
    tree = weights.make(model.layout(m), torch.float32, 1234567890123,
                        "cpu")
    got = {k: _sha(v.contiguous().view(torch.uint8).numpy().tobytes())
           for k, v in weights.flat(tree).items()}
    assert got == DRAWN[config]


@pytest.mark.parametrize("config", sorted(LAYOUT))
def test_default_layout_at_full_size(config):
    root = Path(__file__).resolve().parents[2]
    m = json.loads((root / "perfbench" / "configs" / f"{config}.json")
                   .read_text())["model"]
    lay = [[k, list(shape), width, kind]
           for k, (shape, width, kind) in model.layout(m).items()]
    assert _sha(json.dumps(lay).encode()) == LAYOUT[config]


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
