"""What the benchmark may import, and BENCHMARK.json against the
contract's shape: names, units, keys, and a file for everything it
names."""
import ast
import json
import re
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def imports(path: Path) -> set:
    """Top-level names of every module a file imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def sources():
    return sorted(p for p in PB.rglob("*.py") if "out" not in p.parts)


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(p.relative_to(PB)))
def test_no_jax(path):
    assert not imports(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    paths = sorted((PB / "reference").glob("*.py"))
    # the default model module among them
    assert PB / "reference" / "model.py" in paths
    for path in paths:
        assert "repro_torch" not in imports(path), path


def bound_names(path: Path) -> set:
    """Names a module binds at its top level."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.ImportFrom):
            out |= {a.asname or a.name for a in node.names}
    return out


@pytest.mark.parametrize(
    "conf", sorted((PB / "configs").glob("*.json")), ids=lambda p: p.stem)
def test_configurations_name_a_model_module(conf):
    """A configuration's ``reference`` (``model`` where it names none) is a
    module under perfbench/reference/ that defines what the harness
    calls, and imports nothing of the program."""
    from perfbench import reference
    name = json.loads(conf.read_text()).get("reference", reference.DEFAULT)
    assert NAME.match(name) and "." not in name
    path = PB / "reference" / f"{name}.py"
    assert path.is_file(), path
    assert set(reference.REQUIRED) <= bound_names(path)
    assert not imports(path) & (FORBIDDEN | {"repro_torch"})


def test_forbidden_names_compared_whole():
    from perfbench import bench
    assert "repro_torch" not in bench.FORBIDDEN
    assert set(bench.FORBIDDEN) == FORBIDDEN


def test_benchmark_json_shape():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert list(b) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert b["paths"] == ["perfbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]]
    assert len(set(names)) == len(names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert c["file"].startswith("perfbench/")
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert w["config"] in names and len(w["why"]) <= 200
        assert (PB / "traffic" / f"{w['traffic']}.json").exists()
        assert (PB / "cells" / f"{w['name']}.json").exists()
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert (PB / "end_to_end" / f"{m['name']}.py").exists()
    layers = {}
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert (PB / "metrics" / f"{m['name']}.py").exists()
        layers.setdefault(m["layer"], set()).add(m["name"])
    for m in b["end_to_end"] + b["per_layer"] + b["configs"]:
        assert NAME.match(m["name"])
        if "unit" in m:
            assert UNIT.match(m["unit"])
    assert len(json.dumps(b)) < 64 * 1024
