"""Run one cell of the port's benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``perfbench/``
and the port (``src/repro_torch``).  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics, read from a
``torch.profiler`` trace of a steady sub-window and from the harness's
host spans.  Both compare what the window served with the reference and
print ``correct``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown``
with ``--trace 1``), and last ``checks``, each number compared with its
limit; the same comparisons are the last lines of standard error.  The
run exits non-zero, printing no result, without enough CUDA devices or
when ``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` is loaded
at the end of set-up or once the window has closed.

Build and kernel caches stay inside the checkout: the kernels' library
under ``build/`` (the port's own, keyed by a hash of its sources), and
``TORCH_EXTENSIONS_DIR`` / ``TRITON_CACHE_DIR`` under ``perfbench/out/``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _paths() -> None:
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    out = ROOT / "perfbench" / "out"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(out / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(out / "triton")
    os.environ.setdefault("USE_FLAX", "0")


def finite(x):
    """JSON has no infinity: a number that is not finite is printed as
    null."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    import torch

    from perfbench import bench

    torch.set_num_threads(4)
    line, info = bench.run_cell(ROOT, args.workload, args.seed, args.seconds,
                                bool(args.trace), T_START)
    found = sorted(set(info["forbidden_at_setup"])
                   | set(bench.forbidden_modules()))
    if found:
        print(f"forbidden modules loaded in the benchmark's process: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(finite(info)), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite(line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
