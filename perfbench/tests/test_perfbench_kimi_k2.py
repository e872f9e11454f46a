"""Kimi-K2-Instruct's cell through the harness on the CPU at a tiny size,
from a configuration, traffic and cell file of its own: the model module
``perfbench/reference/kimi_k2.py`` draws a layout the port takes, its
reference follows the port (latent attention, sigmoid routing over an
expert share, a shared expert, a dense first layer), and the readers of
``mfu_pct.agent`` and ``mla_decode_roofline.agent`` count through it, held
to counts worked by hand."""
import json
import time
from pathlib import Path

import pytest
import torch

from perfbench import bench
from perfbench.reference import kimi_k2

CELL = "kimi.tiny"
# the catalog's keys at a tiny size: 3 layers (1 dense, 2 MoE), 32
# experts top-8 of which 8 are held, one shared; YaRN as released
TINY = {"num_hidden_layers": 3, "hidden_size": 256, "num_attention_heads": 4,
        "num_key_value_heads": 4, "q_lora_rank": 64, "kv_lora_rank": 32,
        "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
        "intermediate_size": 384, "moe_intermediate_size": 64,
        "n_routed_experts": 8, "router_experts": 32, "vocab_size": 512}


def tiny_model() -> dict:
    conf = json.loads((Path(__file__).resolve().parents[1] / "configs"
                       / "kimi-k2-instruct-8L.json").read_text())
    return dict(conf["model"], **TINY)


def add_kimi_cell(root):
    pb = root / "perfbench"
    conf = json.loads((pb / "configs" / "kimi-k2-instruct-8L.json")
                      .read_text())
    m = tiny_model()
    conf.update(name="kimi", dtype="float32", model=m,
                reduced=sorted(k for k in m if k not in kimi_k2.NOT_PORT))
    (pb / "configs" / "kimi.json").write_text(json.dumps(conf))
    mix = json.loads((pb / "traffic" / "tiny-batch.json").read_text())
    (pb / "traffic" / "tiny-agent.json").write_text(json.dumps(mix))
    (pb / "cells" / f"{CELL}.json").write_text(json.dumps(
        {"limits": {"widest_logit_gap": 1e-3}, "readings": {}}))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append(dict(b["configs"][0], name="kimi",
                             file="perfbench/configs/kimi.json",
                             reduced=conf["reduced"]))
    b["workloads"].append(dict(b["workloads"][0], name=CELL, config="kimi",
                               traffic="tiny-agent"))
    for name in ("mfu_pct.agent", "mla_decode_roofline.agent",
                 "decode_step_ms.agent"):
        b["per_layer"].append({"name": name, "unit": "%", "better": "higher",
                               "source": "host_clock", "layer": "whole step",
                               "moves": "itl_p95_ms", "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_tiny_cell_is_correct(tiny, monkeypatch):
    """Drawn in the port's layout, served through the engine's chunks and
    absorbed decode, held to the reference's full forward pass: float32
    on both sides, so the widest gap is rounding (< 1e-4)."""
    add_kimi_cell(tiny)
    monkeypatch.setattr(bench, "PROFILE_S", 0.3)
    line, info = bench.run_cell(tiny, CELL, 2305843009213, 1.0, True,
                                time.perf_counter(), device="cpu",
                                chips_check=False)
    assert line["correct"], (line, info)
    assert line["checks"]["widest_logit_gap"]["value"] < 1e-4
    assert info["sample"]["reference_drops"] == 0
    assert info["sample"]["served_tokens"] >= 16
    # the CPU profile has no device ops: the roofline reads nothing
    assert set(line["metrics"]) == {"mfu_pct.agent", "decode_step_ms.agent"}
    assert line["metrics"]["mfu_pct.agent"]["value"] > 0


def test_the_control_is_not_correct(tiny):
    add_kimi_cell(tiny)
    (tiny / "perfbench" / "cells" / f"{CELL}.json").write_text(json.dumps(
        {"limits": {"not_best_share": 0.03}, "readings": {}}))
    line, info = bench.run_cell(tiny, CELL, 77, 1.0, False,
                                time.perf_counter(), device="cpu",
                                chips_check=False, control=True)
    assert line["correct"], (line, info)
    assert info["control"]["correct"] is False


# the tiny sizes' counts worked by hand: attention weights a layer
# 256*64 (q_a) + 64*4*24 (q_b) + 256*40 (kv_a) + 32*4*32 (kv_b) + 4*16*256
# (o) = 16384 + 6144 + 10240 + 4096 + 16384 = 53248; the dense layer's FFN
# 3*256*384 = 294912; an MoE layer's router 256*32 = 8192, shared expert
# 3*256*64 = 49152, routed 8 choices x 8 held / 32 = 2 experts of 49152
ATTN_W = 53248
TOKEN_W = 3 * ATTN_W + 294912 + 2 * (8192 + 49152 + 2 * 49152)
# a key: 2 FLOP x 4 heads x (16 + 8 + 16) x 3 layers
KEY_FLOPS = 2 * 4 * 40 * 3
HEAD_W = 256 * 512


def test_counts_by_hand():
    m = tiny_model()
    assert kimi_k2.attn_params(m) == ATTN_W
    assert kimi_k2.token_weights(m) == TOKEN_W
    assert kimi_k2.token_flops(m, 10, True) == 2 * (TOKEN_W + HEAD_W) \
        + 10 * KEY_FLOPS
    # a chunk of 3 tokens at 5: 6 + 7 + 8 keys
    assert kimi_k2.chunk_flops(m, 5, 3) == 3 * 2 * TOKEN_W + 21 * KEY_FLOPS
    assert kimi_k2.decode_flops(m, [4, 9]) == 2 * 2 * (TOKEN_W + HEAD_W) \
        + 15 * KEY_FLOPS
    # 40-value latent rows: (5 + 10) rows, and 2 slots' q (4 x 40) and
    # out (4 x 32), bf16, 3 layers
    assert kimi_k2.decode_attention_bytes(m, [4, 9]) == \
        3 * 2 * (15 * 40 + 2 * 4 * 72)


def test_readers_count_through_the_module():
    from perfbench import reference
    from perfbench.bench import reader

    root = Path(__file__).resolve().parents[2]
    reference.load(root, "kimi_k2")
    m = tiny_model()
    steps = [{"t0": 0.0, "t1": 0.5, "profiled": False, "chunks":
              [(0, 5, 3)], "decode_slots": [0, 1], "cache_len": [4, 9],
              "decode_ms": 1.0, "chunk_event_ms": []},
             {"t0": 0.5, "t1": 1.0, "profiled": True, "chunks": [],
              "decode_slots": [0, 1], "cache_len": [4, 9], "decode_ms": 1.0,
              "chunk_event_ms": []}]
    rec = {"model": m, "reference": "kimi_k2", "steps": steps,
           "profile": {"steps": 1, "groups_ms": {"mla_decode": 2e-3},
                       "step_idle_pct": 12.5}}
    flops = 3 * 2 * TOKEN_W + 21 * KEY_FLOPS \
        + 2 * 2 * (TOKEN_W + HEAD_W) + 15 * KEY_FLOPS
    mfu = reader(root, "metrics", "mfu_pct.agent")(rec)
    assert mfu == pytest.approx(100 * flops / (0.5 * 989e12))
    roof = reader(root, "metrics", "mla_decode_roofline.agent")(rec)
    nbytes = 3 * 2 * (15 * 40 + 2 * 4 * 72)
    assert roof == pytest.approx(100 * nbytes / 3.35e12 / 2e-6)
    assert reader(root, "metrics", "step_idle_pct.agent")(rec) == 12.5
    rec["profile"]["groups_ms"] = {"decode_attention": 1.0}
    assert reader(root, "metrics", "mla_decode_roofline.agent")(rec) is None


def test_the_share_of_the_layout():
    """The drawn layout holds the held experts, not the router's width."""
    lay = kimi_k2.layout(tiny_model())
    assert lay["blocks/pos0/ffn/w_in"][0] == (2, 8, 256, 64)
    assert lay["blocks/pos0/ffn/router"][0] == (2, 256, 32)
    assert lay["lead0/ffn/w_in"][0] == (256, 384)
