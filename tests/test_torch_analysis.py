"""PyTorch port, ``repro_torch.analysis`` on the CPU (a port of
``tests/test_analysis.py``): the lint rules restated for torch, the CUDA
launch-contract checker on recorded-launch fixtures, the sources' launch
discipline, the ``python -m repro_torch.analysis`` passes and the
launcher's ``--metrics-out``.

* RA001 / RA002 / RA004, each with positive and negative fixtures (the
  ``repro_torch.obs`` import RA004 must not flag); RA003 has no port
  (no site of its kind can be written): the case here shows why, a
  ``CapturedFunction`` refusing a call-time ``bool`` when it would
  capture; the baseline round trip; ``src/repro_torch`` lints clean
  against the port's baseline;
* ``check_launch`` on fixtures (an uncovered grid dimension, a block
  wholly past its extent, threads not a multiple of 32, shared memory
  over the budget, above 48 KB without ``allow_smem``, a workspace short
  of what the grid writes, every violation in one error), the
  ``checking`` toggle, ``kernels/lib.check`` handing a wrapper's records
  and workspace to the checker, the record's ctypes mirror against
  ``common.cuh``;
* over the real ``csrc/``: every launch with dynamic shared memory is
  preceded in its function by ``allow_smem`` of the same kernel, and every
  launch by ``record_launch`` (plus a fixture that breaks each);
* the CLI's kernel-check launch list well formed (its calls run the
  plain versions on the CPU); ``main(["--device", "cpu",
  "--no-kernel-check"])`` exits 0, and without ``--no-kernel-check``
  exits non-zero naming the missing card;
* ``launch/serve.py --metrics-out`` on a CPU run, the file passing
  ``validate_prometheus_text``.

The JAX cases with no counterpart: index-map arity and bounds, block
divisibility, the VMEM estimate and a traced page table under ``jit``
(CUDA launches have no ``BlockSpec`` or index map: each launcher records
the grid it computed, checked here), and the ``pallas_compat`` shim (TPU
only).  The checker against live launches needs a card: the CLI's
kernel-check pass and ``chip_smoke.py`` run it there.
"""
import ctypes
import re
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import kernel_check, lint
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis.kernel_check import (KernelContractError, Launch,
                                               check_launch, checking)
from repro_torch.kernels import lib

torch.set_num_threads(2)
CSRC = Path(lib.__file__).resolve().parent / "csrc"


def _rules(src, path="x.py"):
    return [f.rule for f in lint.lint_source(textwrap.dedent(src), path)]


# --------------------------------------------------------------------------
# RA001: host sync in a loop
# --------------------------------------------------------------------------

@pytest.mark.parametrize("expr", ("int(vals[i])", "float(vals[i])",
                                  "bool(vals[i])", "vals[i].item()",
                                  "vals[i].tolist()", "vals[i].cpu()",
                                  "np.asarray(vals[i])"))
def test_ra001_sync_of_device_value_in_loop(expr):
    src = f"""
    import numpy as np
    import torch

    def f():
        vals = torch.arange(8, device="cuda")
        out = []
        for i in range(8):
            out.append({expr})
        return out
    """
    assert _rules(src) == ["RA001"]


def test_ra001_comprehension_and_one_report_per_pull():
    src = """
    import torch

    def f(xs):
        d = torch.cumsum(xs, 0)
        return [d[i].cpu().numpy() for i in range(4)]
    """
    assert _rules(src) == ["RA001"]


def test_ra001_device_class_attr_and_alias():
    src = """
    import torch
    import torch.nn.functional as F

    class C:
        def __init__(self, x):
            self.state = F.softmax(x, dim=-1)

        def pull(self):
            return [self.state[i].item() for i in range(4)]
    """
    assert _rules(src) == ["RA001"]


def test_ra001_negative_hoisted_pull_metadata_and_host_values():
    src = """
    import numpy as np
    import torch

    def f(param):
        vals = torch.arange(8, device="cuda")
        host = vals.cpu().numpy()    # the one blessed sync
        n = [int(host[i]) for i in range(8)]
        m = [int(vals.shape[0]) + vals.size(0) + vals.numel() for _ in n]
        h = [np.asarray(i) for i in np.arange(4)]
        p = [param[i].item() for i in range(2)]   # a parameter: untainted
        flags = tuple(bool(x) for x in torch.ones(2).tolist())
        return n, m, h, p, flags, vals.device.type
    """
    assert _rules(src) == []


def test_ra001_engine_single_syncs_outside_loops_not_flagged():
    """The serving engine's designed one sync a step is outside any loop."""
    src = (Path(lib.__file__).resolve().parents[1] / "serve" / "engine.py"
           ).read_text()
    lines = [ln for ln in src.splitlines() if ".cpu().numpy()" in ln]
    assert lines, "the engine's step syncs moved"
    found = [f for f in lint.lint_source(src, "serve/engine.py")
             if f.rule == "RA001"]
    assert found == []


# --------------------------------------------------------------------------
# RA002: eager scatter in a loop
# --------------------------------------------------------------------------

@pytest.mark.parametrize("stmt", ("x[i] = i", "x[i] += 1",
                                  "x.index_put_((idx,), v)",
                                  "x.index_copy_(0, idx, v)",
                                  "x.scatter_(0, idx, v)", "x[i].copy_(v)"))
def test_ra002_indexed_write_in_loop(stmt):
    src = f"""
    import torch

    def f(v, idx):
        x = torch.zeros(4, device="cuda")
        for i in range(4):
            {stmt}
        return x
    """
    assert _rules(src) == ["RA002"]


def test_ra002_negative_outside_loop_and_host_state():
    src = """
    import numpy as np
    import torch

    def f(v, i, param):
        x = torch.zeros(4)
        x[i] = 0
        x.index_put_((v,), v)
        table = np.zeros(4)
        for j in range(4):
            table[j] = j
            param[j] = v    # a parameter: untainted
            x.copy_(v)      # a whole-tensor copy, not an indexed view
        return x
    """
    assert _rules(src) == []


# --------------------------------------------------------------------------
# RA003 has no port: a call-time str / bool cannot be captured
# --------------------------------------------------------------------------

def test_ra003_not_applicable_captured_function_refuses_a_bool(monkeypatch):
    """``CapturedFunction`` keys on each argument's shape and dtype, so
    where it would capture a ``bool`` argument raises at the call instead
    of being baked into a replay (JAX's ``jit`` would retrace per value)."""
    from repro_torch.core.flexible import CapturedFunction
    from repro_torch.serve import graphs

    calls = []

    def f(x, flag):
        calls.append(flag)
        return x * 2 if flag else x

    monkeypatch.setattr(graphs, "capture_enabled", lambda dev: True)
    with pytest.raises(AttributeError):
        CapturedFunction(f)(torch.ones(2), True)
    assert calls == []
    assert "RA003" not in lint.RULES


# --------------------------------------------------------------------------
# RA004: host-pure modules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("src", ("import torch\n", "import torch.nn as nn\n",
                                 "from torch import Tensor\n",
                                 "import jax.numpy as jnp\n"))
@pytest.mark.parametrize("path", lint.PURE_MODULES)
def test_ra004_pure_module_must_not_import_torch_or_jax(src, path):
    assert _rules(src, path=path) == ["RA004"]
    # the identical source is fine anywhere else
    assert _rules(src, path="serve/engine.py") == []


def test_ra004_does_not_flag_the_port_packages_own_obs():
    src = ("from repro_torch.obs.runtime import NULL_OBSERVER\n"
           "import repro_torch.obs.trace\nfrom . import metrics\n")
    assert _rules(src, path="serve/scheduler.py") == []


def test_ra004_is_never_baselined():
    findings = lint.lint_source("import torch\n", "serve/scheduler.py")
    baseline = {f.fingerprint for f in findings}
    new, _stale = lint.compare_to_baseline(findings, baseline)
    assert [f.rule for f in new] == ["RA004"]


# --------------------------------------------------------------------------
# baseline mechanics + the repo-is-clean gate
# --------------------------------------------------------------------------

def test_baseline_roundtrip(tmp_path):
    findings = lint.lint_source(textwrap.dedent("""
    import torch

    def f(v):
        x = torch.zeros(4)
        for i in range(4):
            x[i] = v
        return x
    """), "m.py")
    path = str(tmp_path / "baseline.txt")
    lint.write_baseline(findings, path)
    baseline = lint.load_baseline(path)
    new, stale = lint.compare_to_baseline(findings, baseline)
    assert not new and not stale
    # fixing the finding turns the entry stale
    new, stale = lint.compare_to_baseline([], baseline)
    assert not new and len(stale) == 1


def test_repo_lints_clean():
    root = Path(lint.__file__).resolve().parents[1]
    findings = lint.lint_paths(str(root))
    new, stale = lint.compare_to_baseline(findings, lint.load_baseline())
    assert not new, "new lint findings:\n" + "\n".join(str(f) for f in new)
    assert not stale, f"stale baseline entries: {stale}"
    assert not any(f.rule == "RA004" for f in findings)


# --------------------------------------------------------------------------
# check_launch on recorded-launch fixtures
# --------------------------------------------------------------------------

def _launch(**over):
    kw = dict(name="k", grid=(4, 2, 1), block=(128, 1, 1), dyn_smem=0,
              smem_cap=49152, static_smem=0, regs=32, max_threads=1024,
              smem_optin=232448, extent=(256, 2, 1), tile=(64, 1, 1),
              grid_stride=(False, False, False), ws_written=0)
    kw.update(over)
    return Launch(**kw)


def test_check_launch_accepts_a_good_launch():
    check_launch(_launch())
    check_launch(_launch(dyn_smem=100000, smem_cap=100000), budget=232448)
    # a grid-stride dimension covers any extent by its loop
    check_launch(_launch(grid=(4, 1, 1), extent=(10 ** 6, 1, 1),
                         tile=(256, 1, 1), grid_stride=(True, False, False)))
    check_launch(_launch(ws_written=100), workspace_elems=100)


@pytest.mark.parametrize("over,match", (
    (dict(grid=(3, 2, 1)), "cover 192 of its extent 256"),
    (dict(grid=(5, 2, 1)), "block 4 starts at 256, wholly past"),
    (dict(grid=(40, 1, 1), extent=(10 ** 6, 1, 1), tile=(256, 1, 1),
          grid_stride=(True, False, False)), None),
    (dict(block=(100, 1, 1)), "not a positive multiple of 32"),
    (dict(block=(2048, 1, 1)), "not a positive multiple of 32"),
    (dict(max_threads=64), "the compiled kernel allows 64"),
    (dict(grid=(4, 70000, 1), extent=(256, 70000, 1)), "grid.y = 70000"),
    (dict(dyn_smem=65536), "above 48 KB needs allow_smem"),
    (dict(dyn_smem=200000, smem_cap=200000, static_smem=40000),
     "exceeds the budget of 232448"),
    (dict(ws_written=101), "writes 101 workspace elements, the wrapper "
                           "allocated 100"),
))
def test_check_launch_violations(over, match):
    launch = _launch(**over)
    if match is None:
        check_launch(launch)
        return
    with pytest.raises(KernelContractError, match=match):
        check_launch(launch, workspace_elems=100)


def test_smem_budget_env_override(monkeypatch):
    launch = _launch(dyn_smem=40000)
    check_launch(launch)
    monkeypatch.setenv("REPRO_SMEM_BUDGET_BYTES", "32768")
    assert kernel_check.smem_budget(232448) == 32768
    with pytest.raises(KernelContractError, match="budget of 32768"):
        check_launch(launch)


def test_check_launch_aggregates_all_violations():
    with pytest.raises(KernelContractError) as ei:
        check_launch(_launch(grid=(3, 3, 1), block=(100, 1, 1),
                             dyn_smem=65536, ws_written=8),
                     workspace_elems=4)
    msg = str(ei.value)
    for part in ("cover 192", "wholly past", "multiple of 32",
                 "allow_smem", "workspace"):
        assert part in msg


def test_checking_toggle_restores_state():
    before = kernel_check.kernel_check_enabled()
    with checking(not before):
        assert kernel_check.kernel_check_enabled() is (not before)
    assert kernel_check.kernel_check_enabled() is before


def test_env_switch(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_CHECK", "1")
    assert kernel_check.kernel_check_enabled()
    with checking(False):
        assert not kernel_check.kernel_check_enabled()
    monkeypatch.setenv("REPRO_KERNEL_CHECK", "0")
    assert not kernel_check.kernel_check_enabled()


def test_lib_check_hands_the_records_and_workspace_to_the_checker(
        monkeypatch):
    """``lib.check`` after a wrapper's launch: the records it took are
    checked against the wrapper's workspace, all of them, and collected."""
    main = _launch(name="main", ws_written=16)
    combine = _launch(name="combine", grid=(1, 1, 1), extent=(8, 1, 1),
                      tile=(8, 1, 1))
    monkeypatch.setattr(lib, "_LOG_ON", True)
    monkeypatch.setattr(lib, "take_launches", lambda: ([main, combine], 0))
    with kernel_check.collecting() as seen:
        lib.check("w", 0, torch.empty(16))
    assert [x.name for _, x in seen] == ["main", "combine"]
    with pytest.raises(KernelContractError, match="(?s)w: .*allocated 8"):
        lib.check("w", 0, torch.empty(8))
    with pytest.raises(KernelContractError, match="allocated 0"):
        lib.check("w", 0, None)
    monkeypatch.setattr(lib, "take_launches", lambda: ([combine], 2))
    with pytest.raises(KernelContractError, match="2 launch record"):
        lib.check("w", 0)
    monkeypatch.setattr(lib, "_LOG_ON", False)
    lib.check("w", 0, None)   # checking off: nothing is read


def test_launch_record_mirrors_common_cuh():
    src = (CSRC / "common.cuh").read_text()
    body = re.search(r"struct LaunchRecord \{(.*?)\};", src, re.S).group(1)
    names = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = re.sub(r"^(char|int|long long)\s+", "", decl.strip())
        names += [re.match(r"\w+", d.strip()).group(0)
                  for d in decl.split(",") if decl]
    assert names == [f for f, _ in lib._LaunchRecord._fields_]
    rec = lib._LaunchRecord(name=b"k", dyn_smem=5, grid_stride=0b101)
    rec.grid[:] = [1, 2, 3]
    rec.extent[:] = [9, 8, 7]
    launch = rec.launch()
    assert (launch.name, launch.grid, launch.dyn_smem) == ("k", (1, 2, 3), 5)
    assert launch.extent == (9, 8, 7)
    assert launch.grid_stride == (True, False, True)
    assert ctypes.sizeof(lib._LaunchRecord) == 48 + 24 + 24 + 16 + 56


# --------------------------------------------------------------------------
# the CUDA sources' launch discipline
# --------------------------------------------------------------------------

def _launch_sites(text):
    """(kernel expression, dynamic shared-memory argument, the text of its
    function before the launch) for every ``<<<...>>>`` in ``text``."""
    sites = []
    text = re.sub(r"//[^\n]*", "", text)
    for m in re.finditer(r"<<<", text):
        head = text[:m.start()].rstrip()
        # the kernel expression: an identifier with balanced <...> args
        i, depth = len(head), 0
        while i > 0:
            c = head[i - 1]
            if c == ">":
                depth += 1
            elif c == "<":
                depth -= 1
            elif depth == 0 and not (c.isalnum() or c == "_"):
                break
            i -= 1
        kernel = re.sub(r"\s+", " ", head[i:])
        args = text[m.end():text.index(">>>", m.end())]
        parts, depth, cur = [], 0, ""
        for c in args:
            depth += c in "(<" and 1 or (c in ")>" and -1 or 0)
            if c == "," and depth == 0:
                parts.append(cur.strip())
                cur = ""
            else:
                cur += c
        parts.append(cur.strip())
        func = head[head.rfind("\n}") + 2:] if "\n}" in head else head
        sites.append((kernel, parts[2] if len(parts) > 2 else "0",
                      re.sub(r"\s+", " ", func)))
    return sites


def _discipline_errors(text, path="x.cu"):
    errors = []
    for kernel, smem, func in _launch_sites(text):
        if smem != "0" and f"allow_smem({kernel}," not in func:
            errors.append(f"{path}: {kernel} launched with {smem} bytes of "
                          f"dynamic shared memory, no allow_smem({kernel}, ...)")
        if f"record_launch({kernel}," not in func:
            errors.append(f"{path}: {kernel} launched unrecorded")
    return errors


def test_every_launch_raises_its_smem_cap_and_is_recorded():
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    n = 0
    errors = []
    for p in sources:
        text = p.read_text()
        n += len(_launch_sites(text))
        errors += _discipline_errors(text, p.name)
    assert not errors, "\n".join(errors)
    assert n >= 21   # every launcher's main, combine and second passes


def test_discipline_check_catches_a_broken_launcher():
    good = textwrap.dedent("""
    static cudaError_t launch(float* x, int n, cudaStream_t s) {
      auto kernel = my_kernel<float, 4>;
      cudaError_t e = allow_smem(kernel, 65536);
      record_launch(kernel, "my_kernel", dim3(n), 128, 65536, {n, 1});
      kernel<<<dim3(n), 128, 65536, s>>>(x, n);
      record_launch(other_kernel<float>, "other", dim3(1), 32, 0, {1, 1});
      other_kernel<float>
          <<<1, 32, 0, s>>>(x);
      return cudaGetLastError();
    }
    """)
    assert _discipline_errors(good) == []
    no_cap = good.replace("cudaError_t e = allow_smem(kernel, 65536);", "")
    assert any("no allow_smem(kernel" in e for e in _discipline_errors(no_cap))
    no_record = good.replace(
        'record_launch(other_kernel<float>, "other", dim3(1), 32, 0, '
        '{1, 1});', "")
    assert any("other_kernel<float> launched unrecorded" in e
               for e in _discipline_errors(no_record))
    # a cap raised in another function does not count
    split = good.replace("  kernel<<<", "}\nstatic void g() {\n  kernel<<<")
    assert _discipline_errors(split)


# --------------------------------------------------------------------------
# python -m repro_torch.analysis
# --------------------------------------------------------------------------

def test_kernel_check_launch_list_is_well_formed():
    """Every family, int8 and paged twins included, in f32 and bf16; on
    the CPU each call runs the kernel's plain version."""
    launches = cli.kernel_launches(torch, torch.device("cpu"),
                                   torch.Generator().manual_seed(0))
    families = {label.split()[0] for label, _ in launches}
    assert {f.split("/")[1] for f in families} == set(lib.KERNELS)
    for label, launch in launches:
        out = launch()
        outs = out if isinstance(out, tuple) else (out,)
        assert all(torch.isfinite(o.float()).all() or "mha_bwd" in label
                   for o in outs), label


def test_cli_clean_on_cpu_without_kernel_check(capsys):
    assert cli.main(["--device", "cpu", "--no-kernel-check"]) == 0
    out = capsys.readouterr().out
    assert "0 new," in out
    assert "retrace: ok: warm int8 paged engine" in out
    assert "shows only that the engines run" in out
    assert "repro_torch.analysis: clean" in out


def test_cli_kernel_check_fails_without_a_card(capsys):
    assert cli.main(["--device", "cpu", "--no-retrace"]) != 0
    out = capsys.readouterr().out
    assert "kernel-check: FAIL no CUDA device" in out
    assert "repro_torch.analysis: FAILED" in out


# --------------------------------------------------------------------------
# launch/serve.py --metrics-out
# --------------------------------------------------------------------------

def test_serve_metrics_out(tmp_path, capsys):
    from repro_torch.launch import serve
    from repro_torch.obs.metrics import validate_prometheus_text

    path = tmp_path / "metrics.prom"
    done = serve.main(["--smoke", "--device", "cpu", "--requests", "2",
                       "--max-new", "3", "--max-seq", "32", "--chunk", "8",
                       "--metrics-out", str(path)])
    assert len(done) == 2
    text = path.read_text()
    assert validate_prometheus_text(text) > 100
    out = capsys.readouterr().out
    assert f"metrics: exposition -> {path}" in out
    assert "# TYPE repro_tokens_generated_total counter" in out  # --metrics
