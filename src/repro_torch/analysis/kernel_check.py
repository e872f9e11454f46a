"""CUDA launch-contract checker: FAMOUS's synthesis-time resource and
tiling validation (§IV-B) applied to every launch of the port's kernels
(the counterpart of ``repro.analysis.kernel_check``).

The FPGA design guarantees at synthesis that its tiles cover the matrices
it serves and that the on-chip banks they occupy fit the part.  On the
card the same promises are made by each launcher in
``kernels/csrc/*.cu``: its grid covers the rows, heads and keys of the
call, its blocks ask for threads and shared memory the card can give, and
the split partials it writes fit the workspace the Python wrapper
allocated from the kernel's plan.  A broken promise shows as a refused
launch at best and as memory written past a workspace at worst.

Every launcher records what it launched (``famous::record_launch`` in
``csrc/common.cuh``): the kernel's name, grid and block, its dynamic
shared memory, the cap ``allow_smem`` left on the function, the static
shared memory, registers and largest block the compiler gave it
(``cudaFuncGetAttributes``), the device's opt-in shared memory a block,
for each grid dimension the extent it must cover and what one block
covers of it, and the workspace elements the launched grid writes.
``kernels/lib.py`` reads the records after each launch while checking is
on, and :func:`check_launch` holds each one to the contract.  Nothing
here works a geometry out again: it checks what was launched.

* each grid dimension covers its extent, and no block lies wholly past it
  (a grid-stride dimension covers any extent by its loop);
* grid dimensions within the card's limits (x < 2^31, y and z < 65536);
* threads a block a multiple of 32, at most 1024 and at most what the
  compiled kernel allows;
* dynamic plus static shared memory within :func:`smem_budget` (the
  device's opt-in limit a block, or ``REPRO_SMEM_BUDGET_BYTES``);
* dynamic shared memory within the function's cap: above 48 KB only where
  ``allow_smem`` raised it at least that far;
* the workspace the wrapper allocated holds what the grid writes.

Enablement: off by default (the launchers then record nothing), on via
``REPRO_KERNEL_CHECK=1``, :func:`enable`, or the :func:`checking` context
manager.  All violations of one launch are raised together as one
:class:`KernelContractError`.  :func:`check_launch` is a pure function of
one record and a budget, so the CPU tests run it on fixtures.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os

DEFAULT_SMEM = 48 * 1024      # dynamic shared memory without allow_smem
MAX_THREADS = 1024            # threads a block on every CUDA device
GRID_MAX = (2 ** 31 - 1, 65535, 65535)

_FORCED: bool | None = None    # tri-state override of the env switch
_SINKS: list = []              # lists collecting checked launches


class KernelContractError(ValueError):
    """A CUDA launch violated its grid, block, shared-memory or workspace
    contract."""


def kernel_check_enabled() -> bool:
    if _FORCED is not None:
        return _FORCED
    return os.environ.get("REPRO_KERNEL_CHECK", "0").lower() \
        not in ("", "0", "false")


def enable() -> None:
    global _FORCED
    _FORCED = True


def disable() -> None:
    global _FORCED
    _FORCED = False


@contextlib.contextmanager
def checking(on: bool = True):
    """Scoped enable/disable, restoring the previous state on exit."""
    global _FORCED
    prev = _FORCED
    _FORCED = on
    try:
        yield
    finally:
        _FORCED = prev


def smem_budget(device_limit: int | None = None) -> int:
    """Shared memory a block may take: ``REPRO_SMEM_BUDGET_BYTES`` when
    set, else ``device_limit`` (a record's), else the current CUDA
    device's opt-in limit a block
    (``cudaDevAttrMaxSharedMemoryPerBlockOptin``)."""
    env = os.environ.get("REPRO_SMEM_BUDGET_BYTES")
    if env:
        return int(env)
    if device_limit is not None:
        return int(device_limit)
    import torch
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    return int(props.shared_memory_per_block_optin)


@dataclasses.dataclass(frozen=True)
class Launch:
    """One launch as its launcher recorded it."""

    name: str
    grid: tuple          # (x, y, z) blocks
    block: tuple         # (x, y, z) threads
    dyn_smem: int        # dynamic shared memory bytes asked at the launch
    smem_cap: int        # the function's dynamic shared-memory cap then
    static_smem: int     # the compiled kernel's static shared memory
    regs: int            # registers a thread
    max_threads: int     # the largest block the compiled kernel allows
    smem_optin: int      # the device's opt-in shared memory a block
    extent: tuple        # per grid dim: what the grid must cover
    tile: tuple          # per grid dim: what one block covers of it
    grid_stride: tuple   # per grid dim: the blocks loop over it by the grid
    ws_written: int      # workspace elements the launched grid writes

    @property
    def threads(self) -> int:
        return self.block[0] * self.block[1] * self.block[2]

    @property
    def smem(self) -> int:
        return self.dyn_smem + self.static_smem

    def text(self, budget: int | None = None) -> str:
        """One line for a report: grid, threads, shared memory against
        the budget, registers, workspace."""
        b = smem_budget(self.smem_optin) if budget is None else budget
        return (f"{self.name}: grid {self.grid} threads {self.threads} "
                f"smem {self.dyn_smem} + {self.static_smem} = {self.smem} "
                f"of {b} B (cap {self.smem_cap}) regs {self.regs} "
                f"workspace {self.ws_written}")


def check_launch(launch: Launch, *, workspace_elems: int = 0,
                 budget: int | None = None) -> None:
    """Validate one recorded launch against the contract; raises
    :class:`KernelContractError` listing every violation.
    ``workspace_elems``: what the wrapper allocated for it (0: none)."""
    errors = []
    for d, axis in enumerate("xyz"):
        g, n, t = launch.grid[d], launch.extent[d], launch.tile[d]
        if g < 1 or g > GRID_MAX[d]:
            errors.append(f"grid.{axis} = {g} outside [1, {GRID_MAX[d]}]")
            continue
        if t < 1:
            errors.append(f"grid.{axis}: a block covers {t} of {n}")
            continue
        if not launch.grid_stride[d] and g * t < n:
            errors.append(f"grid.{axis} = {g} blocks of {t} cover "
                          f"{g * t} of its extent {n}")
        if (g - 1) * t >= max(n, 1):
            errors.append(f"grid.{axis} = {g} blocks of {t}: block {g - 1} "
                          f"starts at {(g - 1) * t}, wholly past its "
                          f"extent {n}")
    threads = launch.threads
    if threads % 32 or not 0 < threads <= MAX_THREADS:
        errors.append(f"{threads} threads a block: not a positive multiple "
                      f"of 32 up to {MAX_THREADS}")
    if 0 < launch.max_threads < threads:
        errors.append(f"{threads} threads a block, the compiled kernel "
                      f"allows {launch.max_threads} ({launch.regs} "
                      f"registers a thread)")
    b = smem_budget(launch.smem_optin) if budget is None else budget
    if launch.smem > b:
        errors.append(f"shared memory {launch.dyn_smem} dynamic + "
                      f"{launch.static_smem} static = {launch.smem} B "
                      f"exceeds the budget of {b} B "
                      f"(REPRO_SMEM_BUDGET_BYTES or the device's opt-in "
                      f"limit a block)")
    if launch.dyn_smem > launch.smem_cap:
        errors.append(f"dynamic shared memory {launch.dyn_smem} B above "
                      f"the function's cap {launch.smem_cap} B"
                      + (" (above 48 KB needs allow_smem)"
                         if launch.dyn_smem > DEFAULT_SMEM else ""))
    if launch.ws_written > workspace_elems:
        errors.append(f"the grid writes {launch.ws_written} workspace "
                      f"elements, the wrapper allocated {workspace_elems}")
    if errors:
        raise KernelContractError(
            f"kernel contract violation(s) in `{launch.name}` (grid "
            f"{launch.grid}, block {launch.block}):\n  - "
            + "\n  - ".join(errors))


def check_wrapper(wrapper: str, launches, workspace_elems: int = 0,
                  dropped: int = 0) -> None:
    """Check every launch one wrapper call made (``kernels/lib.check``):
    each against the workspace it allocated.  Every violation of the call
    is raised in one :class:`KernelContractError`."""
    for sink in _SINKS:
        sink.extend((wrapper, launch) for launch in launches)
    errors = []
    if dropped:
        errors.append(f"{dropped} launch record(s) lost")
    for launch in launches:
        try:
            check_launch(launch, workspace_elems=workspace_elems)
        except KernelContractError as e:
            errors.append(str(e))
    if errors:
        raise KernelContractError(f"{wrapper}: " + "\n".join(errors))


@contextlib.contextmanager
def collecting():
    """Collect ``(wrapper, Launch)`` for every launch checked inside the
    block (checking must be on for any to be checked)."""
    seen: list = []
    _SINKS.append(seen)
    try:
        yield seen
    finally:
        _SINKS.remove(seen)
