"""The knee sweep of a Poisson cell: one engine, set up once, served at
each rate in turn, each for a warm-up and a window, drained between
rates.  The knee is the highest rate at which the queue does not grow
across the window: the requests due in its last third wait for a slot no
longer than those due in its first third.

    python3 perfbench/sweep.py --workload <name> --seed <n> \
        --seconds <s> --rates <r> [<r> ...]

One JSON line a rate on standard output: the queue wait (due to
``add_request``) of the first and last thirds, TTFT and inter-token
percentiles, output tokens a second and requests finished a second.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from run import ROOT, _paths, finite


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    _paths()
    import numpy as np
    import torch

    from perfbench import bench, readers, traffic

    cell = bench.load_cell(ROOT, args.workload)
    if cell.mix["loop"] != "poisson":
        raise SystemExit(f"{args.workload} is not a Poisson cell")
    win = bench.Window(cell, args.seed, args.seconds, False,
                       torch.device("cuda"))
    for i, rate in enumerate(args.rates):
        win.mix = dict(cell.mix, rate_per_s=rate)
        win.specs = [dataclass_shift(s, 100000 * (i + 1))
                     for s in traffic.schedule(win.mix, args.seed + i,
                                               int(cell.mix["pool"]))]
        win.next = 0
        win.rec.clear()
        win.requests.clear()
        win.obs.steps.clear()
        t = time.perf_counter()
        rec = win.run(t)
        while win.engine.sched.busy or win.engine.sched.has_queued:
            win.admit()
            win.step()
        t0, t1 = rec["t_open"], rec["t_close"]
        third = (t1 - t0) / 3
        waits = {k: [r["admit"] - r["due"] for r in rec["requests"].values()
                     if lo <= r["due"] < lo + third and r["admit"]]
                 for k, lo in (("first", t0), ("last", t1 - third))}
        done = sum(1 for r in rec["requests"].values()
                   if r["done"] is not None and t0 <= r["done"] < t1)
        print(json.dumps(finite({
            "rate_per_s": rate,
            "wait_ms_first_third_p50": 1e3 * float(np.median(waits["first"]))
            if waits["first"] else None,
            "wait_ms_last_third_p50": 1e3 * float(np.median(waits["last"]))
            if waits["last"] else None,
            "wait_ms_last_third_max": 1e3 * max(waits["last"])
            if waits["last"] else None,
            "ttft_p50_ms": readers.ttft_ms(rec, 50.0),
            "ttft_p95_ms": readers.ttft_ms(rec),
            "itl_p50_ms": readers.itl_ms(rec, 50.0),
            "itl_p95_ms": readers.itl_ms(rec),
            "out_tok_s": readers.out_tok_s(rec),
            "finished_per_s": done / (t1 - t0),
            "decode_batch": readers.decode_batch(rec),
            "lateness_max_ms": 1e3 * max(
                [r["enq"] - r["due"] for r in rec["requests"].values()
                 if t0 <= r["due"] < t1] or [0.0]),
            "nvidia": torch.cuda.get_device_name(0)})), flush=True)
    return 0


def dataclass_shift(spec, by: int):
    """``spec`` with its request id moved past the earlier rates'."""
    import dataclasses
    return dataclasses.replace(spec, rid=spec.rid + by)


if __name__ == "__main__":
    sys.exit(main())
