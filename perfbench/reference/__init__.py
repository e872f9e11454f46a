"""The plain float32 references and the comparison that decides
``correct``; nothing here imports the program.

A configuration file (``perfbench/configs/<config>.json``) may name, under
the optional key ``"reference"``, the module ``perfbench/reference/
<reference>.py`` that defines its model for the benchmark; a file that
names none takes :data:`DEFAULT`, ``model.py``.  Such a module defines:

- ``layout(m)``: ``{path: (shape, contracting width or None, kind)}`` of
  the leaves ``weights.make`` draws for the file's sizes ``m``, in draw
  order (kinds as ``model.layout`` has them);
- ``Reference(tree, m, quant)``: the plain float32 model over the drawn
  tree, ``quant="fp8"`` the control, with a count ``drops`` of the token
  choices it dropped;
- ``logits_for(ref, engine, log, requests, rids, device)``: the
  reference's logits at each served position of the sampled requests and
  the served tokens there (``check.sequences`` and ``check.steps_to``
  read the program's requests and steps);
- ``token_flops``, ``chunk_flops``, ``decode_flops`` and
  ``decode_attention_bytes``, with ``model.py``'s signatures: what
  ``readers.mfu_pct`` and ``readers.decode_attention_roofline_pct`` count;
- optionally ``PORT_NAMES`` (configuration keys the port's ModelConfig
  names otherwise) and ``NOT_PORT`` (keys it does not take).
"""
from __future__ import annotations

import importlib
import importlib.util
from pathlib import Path

DEFAULT = "model"
# what the harness calls (perfbench/tests/test_perfbench_static.py holds
# every configuration's module to it)
REQUIRED = ("layout", "Reference", "logits_for", "token_flops",
            "chunk_flops", "decode_flops", "decode_attention_bytes")
_loaded: dict = {}


def load(root: Path, name: str):
    """The module ``perfbench/reference/<name>.py`` of the checkout at
    ``root``, loaded from its file; :func:`named` finds it after."""
    path = Path(root) / "perfbench" / "reference" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_reference_{name}".replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _loaded[name] = mod
    return mod


def named(name: str):
    """The model module of that name: the one :func:`load` loaded last,
    or this package's own."""
    return _loaded.get(name) or importlib.import_module(
        f"perfbench.reference.{name}")
