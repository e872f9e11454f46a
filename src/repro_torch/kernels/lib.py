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
tensors (which the serving and training paths never do).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo"]
KERNELS = ("matmul_tiled", "decode_attention", "chunk_prefill",
           "mha_forward", "mha_bwd_dq", "mha_bwd_dkv")

# dtype codes of the C interface
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class KernelStats:
    """Launch counters of the kernel wrappers (see module docstring)."""

    def __init__(self):
        self.launches = {k: 0 for k in KERNELS}
        self.plain_on_cuda = {k: 0 for k in KERNELS}

    def reset(self) -> None:
        for d in (self.launches, self.plain_on_cuda):
            for k in d:
                d[k] = 0


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
_SIGNATURES = {
    "famous_matmul_tiled": [_I, _P, _P, _P, _I, _I, _I, _P],
    "famous_decode_attention": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _LL, _LL, _LL, _LL, _LL, _LL, _F, _P],
    "famous_chunk_prefill": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _LL, _LL, _LL, _LL, _LL, _LL, _F, _P],
    "famous_mha_forward": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _I, _F, _P],
    "famous_mha_bwd_dq": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _I, _F, _P],
    "famous_mha_bwd_dkv": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _I, _I, _I, _F, _P],
}


def load():
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.famous_error_string.argtypes = [ctypes.c_int]
        lib.famous_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check(name: str, err: int) -> None:
    """Raise when a launch reported a CUDA error."""
    if err != 0:
        msg = _LIB.famous_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


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
