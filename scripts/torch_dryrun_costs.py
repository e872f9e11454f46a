"""What the dry run costs, and what its collectives are, on one cell.

    PYTHONPATH=src python scripts/torch_dryrun_costs.py [--arch qwen2-7b] [--shape train_4k] [--mesh pod1] [--rounds 2]

Runs the cell's step (``repro_torch.launch.dryrun``) on ``meta`` tensors
over the fake process group, ``--rounds`` times each way in turns: bare,
under ``FlopCounterMode`` alone, and under ``op_cost.analyse_ops`` (both
dispatch modes), and prints each run's seconds on the host.  Then it
counts once which of the step's all-reduces are ``MeshComm``'s gathers
(a zero-filled whole leaf summed, moving twice an all-gather's bytes)
and what they move.  Needs no card.
"""
import argparse
import time
import warnings

from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.parallel import sharding as shd
from repro_torch.roofline import op_cost


def lowered(args):
    return dryrun.lower(get_config(args.arch), SHAPES[args.shape],
                        dryrun.production_mesh(args.mesh == "pod2"))


def timed(args, how: str) -> float:
    chips = 512 if args.mesh == "pod2" else 256
    with dryrun.fake_world(chips):
        low = lowered(args)
        t0 = time.perf_counter()
        if how == "bare":
            low.fn(*low.args)
        elif how == "FlopCounterMode":
            with FlopCounterMode(display=False):
                low.fn(*low.args)
        else:
            op_cost.analyse_ops(low.fn, *low.args)
        return time.perf_counter() - t0


class _GatherCounter(op_cost._Counter):
    """The counter, also tallying the collectives issued inside
    ``MeshComm.gather``."""

    inside = 0
    gathers = [0, 0.0]

    def _collective(self, name, func, args):
        before = sum(self.coll.values())
        super()._collective(name, func, args)
        if _GatherCounter.inside:
            self.gathers[0] += 1
            self.gathers[1] += sum(self.coll.values()) - before


def gather_share(args):
    gather = shd.MeshComm.gather

    def counted(self, t, spec):
        _GatherCounter.inside += 1
        try:
            return gather(self, t, spec)
        finally:
            _GatherCounter.inside -= 1

    shd.MeshComm.gather, op_cost._Counter = counted, _GatherCounter
    try:
        chips = 512 if args.mesh == "pod2" else 256
        with dryrun.fake_world(chips):
            low = lowered(args)
            cost = op_cost.analyse_ops(low.fn, *low.args)
    finally:
        shd.MeshComm.gather = gather
        op_cost._Counter = _GatherCounter.__bases__[0]
    return cost, _GatherCounter.gathers


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", choices=["pod1", "pod2"], default="pod1")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    warnings.simplefilter("ignore", RuntimeWarning)   # replicate fallbacks

    print(f"{args.arch} {args.shape} {args.mesh}, host seconds of one "
          f"step on meta tensors:")
    for r in range(args.rounds):
        for how in ("bare", "FlopCounterMode", "analyse_ops"):
            print(f"  round {r}: {how:16s} {timed(args, how):.2f} s",
                  flush=True)
    cost, (n, moved) = gather_share(args)
    print(f"collectives: {cost.coll_counts}, {cost.coll_moved:.6e} B moved; "
          f"MeshComm gathers: {n} of them, {moved:.6e} B moved "
          f"(as all-gathers {moved / 2:.6e} B)")


if __name__ == "__main__":
    main()
