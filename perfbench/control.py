"""Readings for the limits of ``correct``, on the card at a cell's own
size: each seed's run as the benchmark runs it, the numbers it compares
(the program's readings), and with ``--control 1`` the control's, the
reference in fp8 put in the program's place at the same positions, held
to the same limits with a ``correct`` of its own, which has to come out
false (``reference/check.py``).  The seeds share one process: the kernels
load once.

    python3 perfbench/control.py --workload <name> --seconds <s> \
        --control <0|1> --seeds <n> [<n> ...]

One JSON line a seed on standard output.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from run import ROOT, _paths, finite


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    _paths()
    import torch

    from perfbench import bench

    for seed in args.seeds:
        t = time.perf_counter()
        line, info = bench.run_cell(ROOT, args.workload, seed, args.seconds,
                                    False, t, control=bool(args.control))
        ctl = info.get("control")
        if ctl is not None:
            for name, c in ctl["checks"].items():
                print(f"control check {name}: {c['value']!r} "
                      f"(limit {c['limit']!r})", file=sys.stderr)
            print(f"control correct: {str(ctl['correct']).lower()}",
                  file=sys.stderr, flush=True)
        print(json.dumps(finite({
            "seed": seed, "correct": line["correct"],
            "checks": line["checks"], "metrics": line["metrics"],
            "memory_peak_bytes": line["device"]["memory_peak_bytes"],
            "control": ctl, "sample": info["sample"],
            "reference_s": info["reference_s"],
            "setup_parts_s": info["setup_parts_s"],
            "run_s": time.perf_counter() - t})), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
