"""The ``tiny`` checkout for the benchmark's tests, over a
``BENCHMARK.json`` cut to what the tiny checkout renames.

``perfbench/conftest.py``'s ``tiny_checkout`` renames the two first
cells in every metric's ``workloads`` list and has no name for a cell
added after them; a metric that lists only such cells says nothing about
the tiny cells.  This fixture hands ``tiny_checkout`` a root whose
``BENCHMARK.json`` keeps, of each metric's list, the cells it renames,
and drops a metric that keeps none; ``perfbench/`` is the same.
"""
import json

import pytest

from perfbench import conftest as base

RENAMED = ("deepseek-7b.longctx-batch", "grok-1-314b-4L.chat-rate")


def known_cells_only(bench: dict) -> dict:
    out = dict(bench)
    for key in ("end_to_end", "per_layer"):
        kept = []
        for m in bench[key]:
            if "workloads" in m:
                w = [c for c in m["workloads"] if c in RENAMED]
                if not w:
                    continue
                m = dict(m, workloads=w)
            kept.append(m)
        out[key] = kept
    return out


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    root = tmp_path / "root"
    root.mkdir()
    (root / "perfbench").symlink_to(base.ROOT / "perfbench")
    bench = json.loads((base.ROOT / "BENCHMARK.json").read_text())
    (root / "BENCHMARK.json").write_text(json.dumps(known_cells_only(bench)))
    monkeypatch.setattr(base, "ROOT", root)
    dst = tmp_path / "tiny"
    dst.mkdir()
    return base.tiny_checkout(dst)
