"""Build, load and count the port's hand-written Hopper kernels.

Every CUDA source under ``kernels/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  The library is
built at first use into ``build/`` at the root of the checkout, under a
name keyed by a hash of the sources, so an edited source never loads a
stale binary.  The sources compile in parallel, one ``nvcc`` each.

There is no fallback: a missing ``nvcc``, a failed build or a failed launch
raises.  The plain PyTorch versions beside each kernel run only for tensors
that lie on the CPU.

:data:`STATS` holds the launch counters: each kernel wrapper adds one to
``STATS.launches[name]`` where it launches its kernel, and each plain
version adds one to ``STATS.plain_on_cuda[name]`` when it is handed CUDA
tensors (which the serving and training paths never do);
``STATS.designs`` counts a wrapper's launches by the design its static
shapes picked (:data:`DESIGNS`).  A CUDA graph
replay runs none of that Python: ``serve/graphs.py`` takes the counts a
capture made out of :data:`STATS` (:meth:`KernelStats.take_since`) and
adds them back on every replay (:meth:`KernelStats.add`).

While the launch-contract checker is on
(:mod:`repro_torch.analysis.kernel_check`), :func:`load` turns the
library's launch log on, every launcher records what it launches, and
:func:`check` takes the records after each wrapper call and checks them
against the workspace the wrapper allocated.  Off, a launch records
nothing.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import operator
import os
import shutil
import subprocess
from pathlib import Path

import torch

from repro_torch.analysis import kernel_check

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo"]
KERNELS = ("matmul_tiled", "matmul_tiled_int8", "decode_attention",
           "chunk_prefill",
           "mha_forward", "mha_bwd_dq", "mha_bwd_dkv",
           "paged_decode_attention", "paged_decode_attention_int8",
           "paged_chunk_prefill", "paged_chunk_prefill_int8",
           "rglru_scan", "wkv6_scan", "mla_decode")

# dtype codes of the C interface
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the designs a wrapper chooses between by its static shapes, each counted
# apart in STATS.designs (``<kernel>.<design>``)
DESIGNS = ("decode_attention.split", "decode_attention.stream",
           "mla_decode.tc")


class KernelStats:
    """Launch counters of the kernel wrappers (see module docstring)."""

    def __init__(self):
        self.launches = {k: 0 for k in KERNELS}
        self.plain_on_cuda = {k: 0 for k in KERNELS}
        self.designs = {k: 0 for k in DESIGNS}

    def _counters(self):
        return (("launches", self.launches),
                ("plain_on_cuda", self.plain_on_cuda),
                ("designs", self.designs))

    def reset(self) -> None:
        for _, d in self._counters():
            for k in d:
                d[k] = 0

    def snapshot(self) -> dict:
        """A copy of the counters."""
        return {name: dict(d) for name, d in self._counters()}

    def take_since(self, snap: dict) -> dict:
        """Remove the counts added since ``snap`` and return them (in
        :meth:`snapshot`'s layout): what a graph capture counted, which
        launched nothing yet."""
        taken = {}
        for name, counts in self._counters():
            taken[name] = {k: counts[k] - snap[name].get(k, 0)
                           for k in counts}
            counts.update(snap[name])
        return taken

    def add(self, counts: dict) -> None:
        """Add counts in :meth:`snapshot`'s layout (one graph replay)."""
        for name, d in self._counters():
            for k, n in counts[name].items():
                d[k] += n


STATS = KernelStats()

_LIB = None
BUILD_LOG = ""


NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else :data:`NVCC_DEFAULT`.  Raises when none exists."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", NVCC_DEFAULT]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the Hopper kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source (in parallel) and link the shared library.
    Returns its path; a library already built from the same sources is
    reused."""
    global BUILD_LOG
    nvcc = nvcc_path()
    out_dir = BUILD_DIR / f"kernels-{_source_hash()}"
    lib_path = out_dir / "libfamous_kernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in _sources():
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC), "-c",
               str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {src.name} (rc {p.returncode})\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    BUILD_LOG = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{BUILD_LOG}")
    tmp = out_dir / f".libfamous_kernels.{os.getpid()}.so"
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    return lib_path


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_PLL = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    # dtype, x, w, out, split-K workspace (or null), splits, T, D, F, stream
    "famous_matmul_tiled": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # dtype, T, D, F, SM count, [out] workspace elements -> splits
    "famous_matmul_tiled_plan": [_I, _I, _I, _I, _I, _PLL],
    # xq, wqt, sx, sw, out, int32 split-K workspace (or null), splits, T,
    # D, F, stream
    "famous_matmul_tiled_int8": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # T, D, F, SM count, [out] int32 workspace elements -> splits
    "famous_matmul_tiled_int8_plan": [_I, _I, _I, _I, _PLL],
    # dtype, q, k, v, lens, out, workspace, rows, H, KV, dh, Skv,
    # rows_per_slot, keys per range, k strides (slot, pos, head), v
    # strides, scale, stream
    "famous_decode_attention": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _I, _I, _LL, _LL, _LL, _LL, _LL, _LL, _F,
                                _P],
    # dtype, rows, H, KV, dh, Skv, SM count, [out] workspace elements ->
    # keys per range
    "famous_decode_attention_plan": [_I, _I, _I, _I, _I, _I, _I, _PLL],
    # dtype, H, KV, dh -> design (0 split, 1 stream)
    "famous_decode_attention_design": [_I, _I, _I, _I],
    # dtype, q, k, v, out, split workspace (or null), splits, B, C, H, KV,
    # dh, Skv, slot (int32 on the device, or null), q_offset (int32 on the
    # device), k strides (slot, pos, head), v strides, scale, stream
    "famous_chunk_prefill": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _F,
                             _P],
    # dtype, B, C, H, KV, dh, Skv, SM count, [out] workspace elements ->
    # key-range splits
    "famous_chunk_prefill_plan": [_I, _I, _I, _I, _I, _I, _I, _I, _PLL],
    # dtype, q, k, v, out, lse, split workspace (or null), splits, BH, BKV,
    # Sq, Skv, dh, causal, window, q_offset, scale, stream
    "famous_mha_forward": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _F, _P],
    # dtype, BH, BKV, Sq, Skv, dh, SM count, [out] workspace elements ->
    # splits of the key range (mha_forward, or a row block's key tiles in
    # mha_bwd_dq) or of a key block's work (mha_bwd_dkv)
    "famous_mha_forward_plan": [_I, _I, _I, _I, _I, _I, _I, _PLL],
    "famous_mha_bwd_dq_plan": [_I, _I, _I, _I, _I, _I, _I, _PLL],
    "famous_mha_bwd_dkv_plan": [_I, _I, _I, _I, _I, _I, _I, _PLL],
    # dtype, q, k, v, dout, lse, delta, dq, split workspace (or null),
    # splits, BH, BKV, Sq, Skv, dh, causal, window, q_offset, scale, stream
    "famous_mha_bwd_dq": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _I, _I, _I, _I, _I, _F, _P],
    # dtype, q, k, v, dout, lse, delta, dk, dv, split workspace (or null),
    # splits, BH, BKV, Sq, Skv, dh, causal, window, q_offset, scale, stream
    "famous_mha_bwd_dkv": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           _I, _I, _I, _I, _I, _I, _F, _P],
    # dtype, q, k, v, [k_scale, v_scale,] page_table, lens, out,
    # workspace, rows, H, KV, dh, page_size, n_p, n_pages, rows_per_slot,
    # keys per range, scale, stream
    "famous_paged_decode_attention": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                      _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "famous_paged_decode_attention_int8": [_I, _P, _P, _P, _P, _P, _P, _P, _P,
                                           _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                           _I, _F, _P],
    # rows, H, KV, dh, n_p * page_size, pool element bytes, SM count,
    # [out] workspace elements -> keys per range
    "famous_paged_decode_attention_plan": [_I, _I, _I, _I, _I, _I, _I, _PLL],
    # dtype, q, k, v, [k_scale, v_scale,] page_table, out, split
    # workspace (or null), splits, B, C, H, KV, dh, page_size, n_p,
    # n_pages, slot (int32 on the device, or null), q_offset (int32 on the
    # device), scale, stream
    "famous_paged_chunk_prefill": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _I, _I, _I, _I, _I, _I, _P, _P, _F, _P],
    "famous_paged_chunk_prefill_int8": [_I, _P, _P, _P, _P, _P, _P, _P, _P,
                                        _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                        _P, _P, _F, _P],
    # dtype, a, b, out, B, S, R, stream
    "famous_rglru_scan": [_I, _P, _P, _P, _I, _I, _I, _P],
    # dtype (r, k, v), logw dtype, r, k, v, logw, u, s0 (or null), out,
    # s_final, workspace, BH, S, dh, chunk, stream
    "famous_wkv6_scan": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                         _I, _I, _P],
    # BH, S, dh, chunk, [out] workspace elements -> chunks a batch·head
    "famous_wkv6_scan_plan": [_I, _I, _I, _I, _PLL],
    # q, latent rows, lens, out, workspace, rows, Skv, slot stride, keys
    # per range, scale, stream
    "famous_mla_decode": [_P, _P, _P, _P, _P, _I, _I, _LL, _I, _F, _P],
    # rows, Skv, SM count, [out] workspace elements -> keys per range
    "famous_mla_decode_plan": [_I, _I, _I, _PLL],
}


class _LaunchRecord(ctypes.Structure):
    """``famous::LaunchRecord`` of ``csrc/common.cuh``, field for field."""

    _fields_ = [("name", ctypes.c_char * 48), ("grid", _I * 3),
                ("block", _I * 3), ("dyn_smem", _LL), ("smem_cap", _LL),
                ("static_smem", _LL), ("regs", _I), ("max_threads", _I),
                ("smem_optin", _I), ("grid_stride", _I), ("extent", _LL * 3),
                ("tile", _LL * 3), ("ws_written", _LL)]

    def launch(self) -> "kernel_check.Launch":
        return kernel_check.Launch(
            name=self.name.decode(), grid=tuple(self.grid),
            block=tuple(self.block), dyn_smem=self.dyn_smem,
            smem_cap=self.smem_cap, static_smem=self.static_smem,
            regs=self.regs, max_threads=self.max_threads,
            smem_optin=self.smem_optin, extent=tuple(self.extent),
            tile=tuple(self.tile),
            grid_stride=tuple(bool(self.grid_stride >> d & 1)
                              for d in range(3)),
            ws_written=self.ws_written)


_LOG_CAP = 16          # records one wrapper call can leave
_LOG_ON = False        # the library's launch log, as last set


def load():
    """The loaded kernel library (built on first use), its launch log on
    exactly while the contract checker is."""
    global _LIB, _LOG_ON
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.famous_error_string.argtypes = [ctypes.c_int]
        lib.famous_error_string.restype = ctypes.c_char_p
        lib.famous_launch_log.argtypes = [ctypes.c_int]
        lib.famous_launch_log.restype = None
        lib.famous_launch_log_take.argtypes = [
            ctypes.POINTER(_LaunchRecord), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        lib.famous_launch_log_take.restype = ctypes.c_int
        _LIB = lib
        _LOG_ON = False
        lib.famous_launch_log(0)
    on = kernel_check.kernel_check_enabled()
    if on != _LOG_ON:
        _LIB.famous_launch_log(int(on))
        _LOG_ON = on
    return _LIB


def take_launches() -> tuple[list, int]:
    """The launches recorded since the last take, as
    :class:`kernel_check.Launch`, and how many records were lost."""
    recs = (_LaunchRecord * _LOG_CAP)()
    dropped = ctypes.c_int(0)
    n = _LIB.famous_launch_log_take(recs, _LOG_CAP, ctypes.byref(dropped))
    return [recs[i].launch() for i in range(n)], dropped.value


def plan(query: str, *args) -> tuple[int, int]:
    """A kernel's launch plan for a static shape: the C query ``query``
    returns its launch parameter (split count, keys per range) and sets the
    f32 workspace elements the launch needs (0: none)."""
    n = ctypes.c_longlong(0)
    first = getattr(load(), query)(*args, ctypes.byref(n))
    return first, n.value


def check(name: str, err: int,
          workspace: torch.Tensor | None = None) -> None:
    """Raise when a launch reported a CUDA error; while the contract
    checker is on, check what the call launched against ``workspace``, the
    scratch the wrapper allocated for it (None or empty: none)."""
    launches, dropped = take_launches() if _LOG_ON else ([], 0)
    if err != 0:
        msg = _LIB.famous_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
    if _LOG_ON:
        kernel_check.check_wrapper(
            name, launches, 0 if workspace is None else workspace.numel(),
            dropped)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (the plans of the two
    projection kernels, the chunk, decode and MHA kernels size their grids
    by it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """The launch path's device check: every tensor on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"{name}: the kernel needs CUDA tensors on one device, got "
                f"{[str(x.device) for x in tensors]}")


def require_dtype(name: str, *tensors: torch.Tensor) -> int:
    dt = tensors[0].dtype
    if dt not in DTYPE_CODE or any(t.dtype != dt for t in tensors):
        raise ValueError(f"{name}: float32 or bfloat16 operands of one dtype, "
                         f"got {[t.dtype for t in tensors]}")
    return DTYPE_CODE[dt]


def require_int32(name: str, *tensors: torch.Tensor) -> None:
    """Index operands (page tables, lengths): contiguous int32."""
    for t in tensors:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: index operands must be contiguous "
                             f"int32, got {t.dtype}")


def device_scalar(name: str, x, device) -> torch.Tensor:
    """A runtime scalar as the kernels read it: a one-element int32 tensor
    on ``device``.  A Python int becomes one by ``torch.full`` (a fill
    kernel, no host copy); a 0-d or one-element integer tensor on
    ``device`` is passed as it is (converted to int32 on the device when
    it is not), so a value staged for a CUDA graph is read at replay."""
    if not isinstance(x, torch.Tensor):
        return torch.full((1,), operator.index(x), dtype=torch.int32,
                          device=device)
    if (x.numel() != 1
            or x.dtype.is_floating_point or x.dtype == torch.bool
            or x.device != torch.device(device)):
        raise ValueError(f"{name}: a runtime scalar must be an int or a "
                         f"one-element integer tensor on {device}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    x = x.reshape(1)
    return x if x.dtype == torch.int32 and x.is_contiguous() \
        else x.to(torch.int32).contiguous()


def require_pool(name: str, k_pages, v_pages, k_scale, v_scale, dh: int,
                 H: int) -> None:
    """The paged kernels' pools: contiguous (n_pages, page_size, KV, dh)
    K and V of one shape with KV dividing H; int8 pools with contiguous
    f32 (n_pages, page_size, KV) scale pools, fp pools of the query's
    dtype (checked by the caller) and no scales."""
    if (k_pages.dim() != 4 or k_pages.shape != v_pages.shape
            or k_pages.shape[3] != dh or H % k_pages.shape[2]):
        raise ValueError(f"{name}: pools {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)} for dh={dh}, H={H}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError(f"{name}: pools must be contiguous")
    if k_scale is None:
        return
    if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
        raise ValueError(f"{name}: int8 pools, got {k_pages.dtype}")
    for s in (k_scale, v_scale):
        if (s.shape != k_pages.shape[:3] or s.dtype != torch.float32
                or not s.is_contiguous()):
            raise ValueError(f"{name}: scale pools must be contiguous f32 "
                             f"{tuple(k_pages.shape[:3])}, got "
                             f"{s.dtype} {tuple(s.shape)}")


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each element of ``x`` (f32): 2^(floor(log2|x|) - 7),
    0 where ``x`` is 0."""
    _, e = torch.frexp(x.abs())        # |x| = m 2^e, m in [0.5, 1)
    ulp = torch.ldexp(torch.ones_like(x), e - 8)
    return torch.where(x == 0, torch.zeros_like(x), ulp)


def ulp_gate(out: torch.Tensor, ref: torch.Tensor, atol: float):
    """A bf16 kernel output against the unrounded f32 ``ref`` of the same
    bf16 inputs: every element within half a bf16 ulp of ``ref`` plus
    ``atol`` (the f32 gate of the same computation), ``|out - ref| <= 0.5
    ulp_bf16(ref) + atol``.  A kernel that rounds its f32 result once,
    with that result within ``atol`` of ``ref``, always passes; one off by
    a whole ulp does not.  Returns (the largest absolute error, the
    largest error past ``atol`` in ulps of ``ref``, which the gate holds
    to 0.5, whether every element passed and ``out`` is finite)."""
    out, ref = out.float(), ref.float()
    if not out.numel():
        return 0.0, 0.0, True
    err = (out - ref).abs()
    ulp = bf16_ulp(ref)
    past = torch.clamp(err - atol, min=0.0)
    ulps = torch.where(ulp > 0, past / torch.where(ulp > 0, ulp, 1.0),
                       torch.where(past > 0, float("inf"), 0.0))
    worst = float(ulps.max())
    return (float(err.max()), worst,
            worst <= 0.5 and bool(torch.isfinite(out).all()))
