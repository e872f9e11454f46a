"""pytest settings of the benchmark's tests: the ``card`` marker (tests
that need an NVIDIA card skip here, deciding inside a fixture) and a
tiny checkout for the CPU tests."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
        "head_dim": 16, "d_ff": 96, "vocab_size": 256}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")


def tiny_checkout(dst: Path, dtype: str = "float32") -> Path:
    """A checkout holding this ``perfbench/`` and a ``BENCHMARK.json`` of
    two tiny cells: ``dense.tiny`` (deepseek-7b's layout shrunk) and
    ``moe.tiny`` (grok-1's: 4 experts top-2, 8 slots, so decode steps
    route 8 rows a group and drop past capacity)."""
    shutil.copytree(ROOT / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__",
                                                  "tests"))
    pb = dst / "perfbench"
    for name, reg, extra in (
            ("dense", "deepseek-7b", {"num_kv_heads": 4}),
            ("moe", "grok-1-314b", {"num_experts": 4})):
        conf = json.loads((pb / "configs" / (
            "deepseek-7b.json" if name == "dense"
            else "grok-1-314b-4L.json")).read_text())
        model = {**conf["model"], **TINY, **extra}
        conf.update(name=name, registry_id=reg, dtype=dtype, model=model,
                    reduced=sorted(set(TINY) | set(extra)))
        (pb / "configs" / f"{name}.json").write_text(json.dumps(conf))
    mix = {"pool": 512, "period": 16,
           "engine": {"slots": 4, "max_seq": 128, "chunk": 16,
                      "cache_kind": "contiguous"},
           "prompt": {"dist": "lognormal", "median": 40, "sigma": 0.5,
                      "min": 16, "max": 96},
           "output": {"dist": "lognormal", "median": 8, "sigma": 0.5,
                      "min": 4, "max": 24},
           # more than a tiny run serves: every finished request is checked
           "check": {"served_tokens": 100000}}
    (pb / "traffic" / "tiny-batch.json").write_text(json.dumps(dict(
        mix, loop="backlog", backlog_depth=2,
        warmup={"kind": "first_wave"})))
    (pb / "traffic" / "tiny-rate.json").write_text(json.dumps(dict(
        mix, loop="poisson", rate_per_s=40.0,
        engine=dict(mix["engine"], slots=8),
        warmup={"kind": "seconds", "seconds": 0.3})))
    for cell in ("dense.tiny", "moe.tiny"):
        (pb / "cells" / f"{cell}.json").write_text(json.dumps(
            {"limits": {"widest_logit_gap": 1e-3}, "readings": {}}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [
        dict(bench["configs"][0], name="dense",
             file="perfbench/configs/dense.json"),
        dict(bench["configs"][1], name="moe",
             file="perfbench/configs/moe.json")]
    bench["workloads"] = [
        dict(bench["workloads"][0], name="dense.tiny", config="dense",
             traffic="tiny-batch"),
        dict(bench["workloads"][1], name="moe.tiny", config="moe",
             traffic="tiny-rate")]
    rename = {"deepseek-7b.longctx-batch": "dense.tiny",
              "grok-1-314b-4L.chat-rate": "moe.tiny"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [rename[w] for w in m["workloads"]]
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


@pytest.fixture
def tiny(tmp_path):
    return tiny_checkout(tmp_path)
