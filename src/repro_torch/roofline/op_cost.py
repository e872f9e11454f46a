"""What a step costs, counted from the operators it runs (the port's
counterpart of ``repro.roofline.hlo_cost``, which reads XLA's HLO text:
the port never has HLO).

:func:`analyse_ops` runs a function once, eagerly, under two dispatch
modes, usually on ``meta`` tensors, so that nothing is allocated and no
card is needed:

* ``torch.utils.flop_counter.FlopCounterMode`` counts the FLOPs of every
  matrix product (``mm``, ``bmm``, ``addmm``, convolutions and the
  attention ops), forward and backward, as XLA's count covers its dots;
* :class:`_Counter` counts the rest.  **bytes**: the input and output
  bytes of every aten operator but views and metadata operators
  (``numel * element_size`` of each tensor argument and result).  This is
  the eager, unfused count: every operator reads its inputs from memory
  and writes its outputs back, which is what the port runs (a CUDA graph
  replays the same kernels), where XLA's count is of its fused program.
  An in-place operator's result is counted as written beside its input
  as read.  **collectives**: every ``c10d`` operator, its kind from its
  name, its group size from the process group it carries, its moved bytes
  by :func:`~repro_torch.roofline.analysis.moved_bytes` of its result's
  bytes (the in-place tensor of an all-reduce, the output of the others).
  **peak_bytes**: the most bytes that storages made inside the function
  held at once.  A storage is made by an operator whose result shares
  storage with none of its inputs; it is live until its last tensor dies
  (a weak reference to it expires).  Storages the function was given are
  not counted.

An eager step runs every trip of its loops, so there is nothing like
``HloCost.while_trips`` to report.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.roofline.analysis import moved_bytes

# c10d operator -> collective kind (the operators ``torch.distributed``'s
# calls dispatch to)
_COLL_KIND = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
}
# c10d operators that move no tensor data
_COLL_NONE = {"barrier", "monitored_barrier_"}

# aten operators that read or write no tensor data (views are found by
# their schema)
_METADATA = {
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "lift_fresh", "_local_scalar_dense", "set_",
    "resize_", "is_same_size", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "_has_compatible_shallow_copy_type",
}


@dataclasses.dataclass
class OpCost:
    """:class:`repro.roofline.hlo_cost.HloCost`'s fields and names, but
    ``while_trips``, plus ``peak_bytes``."""

    flops: float
    bytes_accessed: float
    coll_moved: float
    coll_by_type: dict
    coll_counts: dict
    peak_bytes: int


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.coll = defaultdict(float)
        self.counts = defaultdict(int)
        self.live = {}          # storage key -> (weak ref, nbytes)
        self.live_bytes = 0     # an upper bound: expired storages linger
        self.peak = 0

    def _made(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = s._cdata
        if key in self.live:
            return
        n = s.nbytes()
        if self.live_bytes + n > self.peak:
            # only here can the peak move: drop what has died first
            for k in [k for k, (ref, _) in self.live.items()
                      if ref.expired()]:
                self.live_bytes -= self.live.pop(k)[1]
        self.live[key] = (StorageWeakRef(s), n)
        self.live_bytes += n
        self.peak = max(self.peak, self.live_bytes)

    def _collective(self, name: str, func, args) -> None:
        if name in _COLL_NONE:
            return
        if name not in _COLL_KIND:
            raise ValueError(f"op_cost: no cost model for collective "
                             f"{func}")
        kind = _COLL_KIND[name]
        groups = [a for a in tree_flatten(args)[0]
                  if isinstance(a, torch.ScriptObject)
                  and "ProcessGroup" in str(a._type())]
        n = torch.distributed.ProcessGroup.unbox(groups[0]).size()
        b = sum(_nbytes(t) for t in _tensors(args[0]))
        self.coll[kind] += moved_bytes(kind, b, n)
        self.counts[kind] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name.split("::")[1]
        if func.namespace == "c10d":
            self._collective(name, func, args)
            return out
        if func.namespace != "aten" or func.is_view or \
                torch.Tag.inplace_view in func.tags or name in _METADATA:
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        self.bytes += sum(_nbytes(t) for t in ins) + \
            sum(_nbytes(t) for t in outs)
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            if t.untyped_storage()._cdata not in seen:
                self._made(t)
        return out


def analyse_ops(fn, *args, **kwargs) -> OpCost:
    """Run ``fn(*args, **kwargs)`` once and count what it ran (see the
    module docstring)."""
    counter = _Counter()
    with FlopCounterMode(display=False) as flops, counter:
        fn(*args, **kwargs)
    return OpCost(flops=float(flops.get_total_flops()),
                  bytes_accessed=float(counter.bytes),
                  coll_moved=float(sum(counter.coll.values())),
                  coll_by_type=dict(counter.coll),
                  coll_counts=dict(counter.counts),
                  peak_bytes=counter.peak)


def argument_bytes(*trees) -> int:
    """The bytes of the distinct storages of the tensors in ``trees``
    (nested dicts, lists and tuples; other leaves skipped) that lie off
    the host: what a step's arguments hold on its device, a storage that
    several leaves view counted once."""
    def walk(tree):
        if isinstance(tree, dict):
            tree = list(tree.values())
        if isinstance(tree, (list, tuple)):
            for x in tree:
                yield from walk(x)
        elif isinstance(tree, torch.Tensor):
            yield tree

    seen = {}
    for t in walk(trees):
        if t.device.type != "cpu":
            s = t.untyped_storage()
            seen[s._cdata] = s.nbytes()
    return sum(seen.values())
