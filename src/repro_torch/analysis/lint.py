"""AST linter for the port's host-side anti-patterns (the counterpart of
``repro.analysis.lint``, restated for PyTorch).

The serving hot loop keeps one device->host sync a step and a fixed set of
CUDA graphs only while a few disciplines hold that nothing else enforces:
device values are not pulled to the host one element at a time, device
tensors are not written element by element from Python loops (one kernel
launch each), and the host-pure modules stay free of ``torch`` (so device
state cannot leak into policy code).  Each discipline is a rule:

``RA001 host-sync-in-loop``
    ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` on a
    device-tainted tensor, or ``int()`` / ``float()`` / ``bool()`` /
    ``np.asarray()`` / ``np.array()`` of one, inside a Python loop (or
    comprehension).  Each is one blocking device->host copy; hoist a single
    ``.cpu().numpy()`` pull above the loop.
``RA002 eager-scatter-in-loop``
    indexed assignment (``x[i] = v``, ``x[i] += v``), ``index_put_`` /
    ``index_copy_`` / ``index_add_`` / ``scatter_`` / ``scatter_add_``, or
    ``copy_`` into an indexed view (``x[i].copy_(v)``) of a device-tainted
    tensor inside a Python loop: one launch per iteration; batch the writes
    into one indexed write or keep the state in host numpy.
``RA004 impure-module``
    a ``torch`` / ``jax`` / ``jaxlib`` import in a module declared host-pure
    (:data:`PURE_MODULES`: the scheduler, the drafter and the ``obs/``
    stack).  Matched on the top-level module name, so ``repro_torch.obs``
    is not ``torch``.  No baseline entry is admitted.

JAX's ``RA003 jit-missing-static`` has no counterpart: no site of the kind
it guards can be written in the port.  ``core.flexible.CapturedFunction``
keys its graphs on each argument's ``shape`` and ``dtype``, so a ``str`` or
``bool`` argument raises ``AttributeError`` when the key is built instead
of being baked into a replay; a ``graphs.Executable`` hands its key to the
body, so a ``str`` / ``bool`` in the key captures one graph per value (what
``static_argnames`` gives in JAX).

Device taint is a simple per-function analysis: expressions rooted at
``torch.*`` (or an alias of a ``torch`` module, such as ``F`` for
``torch.nn.functional``) are device, except the host-only corners
(dtypes, ``torch.cuda`` / ``torch.distributed`` calls, ``torch.device``
...); ``self.X`` is device when any assignment in the class binds it to a
device expression; a local takes the taint of what it was last assigned,
a loop variable that of what it iterates.  Tensor metadata (``.shape``,
``.dtype``, ``.device``, ``.size()``, ``.numel()`` ...) is host, and a sync
call's result (``.cpu()``, ``.numpy()``, ``.item()``, ``.tolist()``,
``int()``, ``np.asarray()`` ...) launders back to host: that one call *is*
the blessed hoisted sync.  Precision over recall: only what is seen to be
device-backed is reported, so host numpy bookkeeping never
false-positives, and a tensor handed in as a parameter is not tainted.

Findings are compared against a checked-in baseline
(``analysis/lint_baseline.txt``), ``path::rule::normalised source line``
fingerprints relative to ``src/repro_torch``, stable across unrelated
edits.  New findings fail; entries that no longer match are stale.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re

RULES = {
    "RA001": "host-sync-in-loop: per-iteration device->host sync "
             "(.item()/.tolist()/.cpu()/.numpy() or int()/float()/bool()/"
             "np.asarray() of a device tensor inside a Python loop); hoist "
             "one .cpu().numpy() pull above the loop",
    "RA002": "eager-scatter-in-loop: indexed write into a device tensor "
             "inside a Python loop launches once per iteration; batch the "
             "writes or keep this state in host numpy",
    "RA004": "impure-module: host-pure module must not import torch or jax",
}

# modules (relative to src/repro_torch) contractually free of torch and jax
# -- RA004 admits no baseline entries for these
PURE_MODULES = ("serve/scheduler.py", "serve/draft.py",
                "obs/metrics.py", "obs/trace.py", "obs/runtime.py")
_IMPURE_ROOTS = ("torch", "jax", "jaxlib")

# dotted prefixes under torch that are host values or host-side calls
_TORCH_HOST = (
    "torch.cuda", "torch.distributed", "torch.backends", "torch.autograd",
    "torch.utils", "torch.multiprocessing", "torch.profiler",
    "torch.finfo", "torch.iinfo", "torch.device", "torch.Size",
    "torch.dtype", "torch.Tensor", "torch.Generator", "torch.no_grad",
    "torch.inference_mode", "torch.enable_grad", "torch.set_grad_enabled",
    "torch.is_tensor", "torch.is_grad_enabled", "torch.get_default_dtype",
    "torch.manual_seed", "torch.float32", "torch.float", "torch.float16",
    "torch.half", "torch.bfloat16", "torch.float64", "torch.double",
    "torch.int8", "torch.uint8", "torch.int16", "torch.int32", "torch.int",
    "torch.int64", "torch.long", "torch.bool", "torch.nn.Module",
    "torch.nn.Parameter")
# tensor metadata: reading it never syncs
_META = ("shape", "dtype", "device", "ndim", "is_cuda", "requires_grad",
         "size", "dim", "numel", "nelement", "stride", "element_size",
         "is_contiguous", "data_ptr", "storage_offset", "get_device",
         "is_floating_point", "layout")
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
_SYNC_CALLS = ("int", "float", "bool", "np.asarray", "np.array",
               "numpy.asarray", "numpy.array")
_HOST_CALLS = _SYNC_CALLS + ("len", "range", "str", "repr", "isinstance")
_SCATTER_METHODS = ("index_put_", "index_copy_", "index_add_", "scatter_",
                    "scatter_add_")


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str       # relative to src/repro_torch, e.g. "serve/engine.py"
    line: int
    rule: str
    detail: str
    snippet: str    # whitespace-normalised source line (the fingerprint key)

    @property
    def fingerprint(self) -> str:
        return f"{self.path}::{self.rule}::{self.snippet}"

    def __str__(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule} {self.detail}\n"
                f"    {self.snippet}")


def _dotted(node) -> str | None:
    """``a.b.c`` attribute/name chain as a string, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _normalise(line: str) -> str:
    return re.sub(r"\s+", " ", line.strip())


def _is_sync_method(call) -> bool:
    return (isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute)
            and call.func.attr in _SYNC_METHODS)


class _Taint:
    """What is device in one scope: the module's torch aliases, the tainted
    locals and the class's device attributes."""

    def __init__(self, aliases: dict, device_attrs: set):
        self.aliases = aliases
        self.device_attrs = device_attrs
        self.locals: set = set()

    def _name_device(self, dotted: str) -> bool:
        root, _, rest = dotted.partition(".")
        if any(p in _META for p in rest.split(".")):
            return False
        if root in self.aliases:
            dotted = self.aliases[root] + ("." + rest if rest else "")
            root = "torch"
        if root == "torch":
            return dotted != "torch" and not any(
                dotted == h or dotted.startswith(h + ".") for h in _TORCH_HOST)
        if root in self.locals:
            return True
        return (root == "self" and rest != ""
                and rest.split(".")[0] in self.device_attrs)

    def device(self, node) -> bool:
        """Does this expression reference anything device-backed?"""
        if isinstance(node, ast.Call):
            fn = _dotted(node.func)
            if fn in _HOST_CALLS or _is_sync_method(node) or (
                    fn or "").split(".")[0] in ("np", "numpy", "math"):
                return False
        if isinstance(node, ast.Attribute) and node.attr in _META:
            return False
        if isinstance(node, (ast.Attribute, ast.Name)):
            d = _dotted(node)
            if d is not None:
                return self._name_device(d)
        if isinstance(node, (ast.Lambda, ast.FunctionDef)):
            return False
        return any(self.device(c) for c in ast.iter_child_nodes(node))


class _FunctionLinter(ast.NodeVisitor):
    """Per-function walk tracking loop depth and local device taint."""

    def __init__(self, module: "_ModuleLinter", device_attrs: set):
        self.m = module
        self.taint = _Taint(module.aliases, device_attrs)
        self.loop_depth = 0

    # -- taint bookkeeping --------------------------------------------------
    def _bind(self, target, device: bool):
        if isinstance(target, ast.Name):
            if device:
                self.taint.locals.add(target.id)
            else:
                self.taint.locals.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind(elt, device)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, device)

    def visit_Assign(self, node):
        self.generic_visit(node)
        for tgt in node.targets:
            self._check_write(tgt)
        dev = self.taint.device(node.value)
        for tgt in node.targets:
            self._bind(tgt, dev)

    def visit_AnnAssign(self, node):
        self.generic_visit(node)
        if node.value is not None:
            self._check_write(node.target)
            self._bind(node.target, self.taint.device(node.value))

    def visit_AugAssign(self, node):
        self.generic_visit(node)
        self._check_write(node.target)
        if self.taint.device(node.value):
            self._bind(node.target, True)

    # -- loops ---------------------------------------------------------------
    def _loop(self, node):
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    def visit_For(self, node):
        self.visit(node.iter)
        self._bind(node.target, self.taint.device(node.iter))
        self.loop_depth += 1
        for stmt in node.body + node.orelse:
            self.visit(stmt)
        self.loop_depth -= 1

    visit_AsyncFor = visit_For
    visit_While = _loop

    def _comprehension(self, node):
        # the first iterable is evaluated once, before the loop
        self.visit(node.generators[0].iter)
        self.loop_depth += 1
        for i, gen in enumerate(node.generators):
            if i:
                self.visit(gen.iter)
            self._bind(gen.target, self.taint.device(gen.iter))
            for cond in gen.ifs:
                self.visit(cond)
        for part in ("elt", "key", "value"):
            if hasattr(node, part):
                self.visit(getattr(node, part))
        self.loop_depth -= 1

    visit_ListComp = visit_SetComp = visit_DictComp = _comprehension
    visit_GeneratorExp = _comprehension

    # -- nested defs start a fresh scope outside any loop --------------------
    def _nested(self, node):
        inner = _FunctionLinter(self.m, self.taint.device_attrs)
        for stmt in node.body if not isinstance(node, ast.Lambda) \
                else [node.body]:
            inner.visit(stmt)

    visit_FunctionDef = visit_AsyncFunctionDef = visit_Lambda = _nested

    # -- the rules -----------------------------------------------------------
    def _check_write(self, target):
        """RA002: ``x[i] = v`` / ``x[i] += v`` into a device tensor."""
        if (self.loop_depth and isinstance(target, ast.Subscript)
                and self.taint.device(target.value)):
            self.m.report(target, "RA002", "indexed assignment into a "
                          "device tensor inside a Python loop")

    def visit_Call(self, node):
        self.generic_visit(node)
        if not self.loop_depth:
            return
        fn = _dotted(node.func)
        meth = node.func.attr if isinstance(node.func, ast.Attribute) \
            else None
        recv = node.func.value if meth else None
        # RA001: per-iteration host sync
        if meth in _SYNC_METHODS and self.taint.device(recv):
            self.m.report(node, "RA001",
                          f"`.{meth}()` syncs a device value every iteration")
        elif (fn in _SYNC_CALLS and node.args
                and self.taint.device(node.args[0])):
            self.m.report(node, "RA001",
                          f"`{fn}()` syncs a device value every iteration")
        # RA002: scatter methods, and copy_ into an indexed view
        if meth in _SCATTER_METHODS and self.taint.device(recv):
            self.m.report(node, "RA002", f"`.{meth}()` inside a Python loop")
        elif (meth == "copy_" and isinstance(recv, ast.Subscript)
                and self.taint.device(recv.value)):
            self.m.report(node, "RA002", "`copy_` into an indexed view "
                          "inside a Python loop")


class _ClassAttrs(ast.NodeVisitor):
    """First pass over a ClassDef: which ``self.X`` attrs are ever bound
    to a device expression anywhere in the class."""

    def __init__(self, aliases: dict):
        self.taint = _Taint(aliases, set())
        self.device_attrs: set = set()

    def _visit_assign(self, targets, value):
        if value is None or not self.taint.device(value):
            return
        for tgt in targets:
            if (isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"):
                self.device_attrs.add(tgt.attr)

    def visit_Assign(self, node):
        self._visit_assign(node.targets, node.value)
        self.generic_visit(node)

    def visit_AnnAssign(self, node):
        self._visit_assign([node.target], node.value)
        self.generic_visit(node)


class _ModuleLinter:
    def __init__(self, path: str, src: str):
        self.path = path
        self.lines = src.splitlines()
        self.findings: list = []
        self.tree = ast.parse(src, filename=path)
        # local names bound to torch modules (``import torch.nn.functional
        # as F``, ``from torch.nn import functional as F``)
        self.aliases: dict = {}
        for n in ast.walk(self.tree):
            if isinstance(n, ast.Import):
                for a in n.names:
                    if a.asname and a.name.split(".")[0] == "torch":
                        self.aliases[a.asname] = a.name
            elif isinstance(n, ast.ImportFrom) and (
                    n.module or "").split(".")[0] == "torch":
                for a in n.names:
                    self.aliases[a.asname or a.name] = f"{n.module}.{a.name}"

    def report(self, node, rule: str, detail: str):
        line = getattr(node, "lineno", 0)
        snippet = _normalise(self.lines[line - 1]) if \
            0 < line <= len(self.lines) else ""
        self.findings.append(Finding(self.path, line, rule, detail, snippet))

    def run(self) -> list:
        self._check_purity()
        for node in self.tree.body:
            self._lint_scope(node, device_attrs=set())
        return self.findings

    def _check_purity(self):
        if not any(self.path == p or self.path.endswith("/" + p)
                   for p in PURE_MODULES):
            return
        for n in ast.walk(self.tree):
            mods = []
            if isinstance(n, ast.Import):
                mods = [a.name for a in n.names]
            elif isinstance(n, ast.ImportFrom) and not n.level:
                mods = [n.module or ""]
            for mod in mods:
                if mod.split(".")[0] in _IMPURE_ROOTS:
                    self.report(n, "RA004",
                                f"host-pure module imports `{mod}`")

    def _lint_scope(self, node, device_attrs: set):
        if isinstance(node, ast.ClassDef):
            collector = _ClassAttrs(self.aliases)
            collector.visit(node)
            for stmt in node.body:
                self._lint_scope(stmt, collector.device_attrs)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            linter = _FunctionLinter(self, device_attrs)
            for stmt in node.body:
                linter.visit(stmt)
        elif isinstance(node, (ast.If, ast.Try, ast.With)):
            for stmt in ast.iter_child_nodes(node):
                self._lint_scope(stmt, device_attrs)


def lint_source(src: str, path: str = "<string>") -> list:
    """Lint one module's source; ``path`` is used for reporting and for
    the purity contract (match against :data:`PURE_MODULES`)."""
    return _ModuleLinter(path, src).run()


def lint_paths(root: str) -> list:
    """Lint every ``*.py`` under ``root`` (the ``src/repro_torch`` package
    directory); finding paths are reported relative to ``root``."""
    findings = []
    for dirpath, _dirnames, filenames in sorted(os.walk(root)):
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            full = os.path.join(dirpath, fn)
            rel = os.path.relpath(full, root).replace(os.sep, "/")
            with open(full, encoding="utf-8") as f:
                findings.extend(lint_source(f.read(), rel))
    return findings


# --------------------------------------------------------------------------
# baseline / allowlist
# --------------------------------------------------------------------------

BASELINE_FILE = os.path.join(os.path.dirname(__file__), "lint_baseline.txt")


def load_baseline(path: str = BASELINE_FILE) -> set:
    if not os.path.exists(path):
        return set()
    with open(path, encoding="utf-8") as f:
        return {ln.strip() for ln in f
                if ln.strip() and not ln.lstrip().startswith("#")}


def write_baseline(findings, path: str = BASELINE_FILE) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write("# repro_torch.analysis lint baseline: accepted findings.\n"
                "# One `path::rule::normalised source line` per line;\n"
                "# regenerate with `python -m repro_torch.analysis "
                "--update-baseline`.\n")
        for fp in sorted({x.fingerprint for x in findings}):
            f.write(fp + "\n")


def compare_to_baseline(findings, baseline: set):
    """(new findings, stale baseline entries).  RA004 findings in
    :data:`PURE_MODULES` are never baselined away: purity admits no
    allowlist."""
    fps = {x.fingerprint for x in findings}
    new = [x for x in findings
           if x.fingerprint not in baseline or x.rule == "RA004"]
    stale = sorted(baseline - fps)
    return new, stale
