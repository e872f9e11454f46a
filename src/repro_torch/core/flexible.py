"""Runtime programmability (the port of ``repro.core.flexible``): the
paper's §IV-C on a GPU.

FAMOUS synthesises once (fixing TS and resource maxima) and then serves any
(heads, d_model, sequence length) at or below the synthesis-time maxima by
reprogramming loop bounds from the MicroBlaze at runtime — no re-synthesis.

JAX's analogue of "synthesis" is XLA compilation; the port's is a CUDA
graph capture (``serve/graphs.py``).  Two mechanisms:

* :class:`FlexibleAttention` — ONE captured program at the maxima, per
  (batch, dtype), as JAX keeps one executable per static shape.  Smaller
  topologies are zero-padded to the maxima and masked; the actual
  sequence length and head dim arrive as *runtime operands* (one-element
  int32 tensors on the device, like the µB control words), so no new
  capture ever happens.  Padded heads are the idle PE groups of tests
  #2–#3; padded sequence = masked keys; the softmax scale uses the actual
  head dim (tests #4–#5's d_model sweep).

* :class:`BucketCache` — a small cache of executables keyed by rounded-up
  shape buckets, trading a handful of captures for zero padding waste.
  The serving engine uses its ``next_pow2`` for monolithic prefill; the
  single-program mode is the paper-faithful extreme point (bucket count =
  1).

Neither holds a hand-written kernel: JAX computes both with einsums
outside any Pallas kernel, and so does the port, with ``torch.einsum``.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.core import famous
from repro_torch.serve import graphs


def _resolve(device) -> torch.device:
    # serve.engine imports this module: import it when first needed
    from repro_torch.serve.engine import resolve_device
    return resolve_device(device)


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    return type(out)(_clone(o) for o in out)


class FlexibleAttention:
    """One program, every topology ≤ (max_heads, max_seq, max_head_dim).

    On a CUDA device the padded program is a ``graphs.Executable`` with a
    key per (batch, dtype): its first call runs eagerly (the warm-up), the
    second captures it, and every later call — any topology — replays it.
    It reads q/k/v from static buffers at (B, max_seq, max_heads,
    max_head_dim) and ``seq_len`` / ``head_dim`` from device memory.
    ``compilations`` counts the builds of the padded program: its captures
    on the card, its keys elsewhere (one eager build per key on the CPU);
    the paper-faithful single-program claim is that it stays at 1 across
    topologies."""

    def __init__(self, max_heads: int, max_seq: int, max_head_dim: int,
                 cfg: famous.FamousConfig | None = None, causal: bool = True,
                 device="cuda"):
        self.max_heads = max_heads
        self.max_seq = max_seq
        self.max_head_dim = max_head_dim
        self.cfg = cfg or famous.FamousConfig()
        self.causal = causal
        self.device = _resolve(device)
        self._bufs: dict = {}       # (B, dtype) -> static (q, k, v)
        # (seq_len, head_dim), read by the program in device memory
        self._scalars = graphs.StaticInput((2,), torch.int32, self.device,
                                           depth=2)
        self._exec = graphs.Executable(self._program,
                                       graphs.GraphPool(self.device))

    @property
    def compilations(self) -> int:
        if graphs.capture_enabled(self.device):
            return len(self._exec.graph_keys)
        return len(self._exec.keys)

    def _program(self, key):
        q, k, v = self._bufs[key]
        sc = self._scalars.tensor
        return self._padded_attention(q, k, v, sc[0:1], sc[1:2])

    def _padded_attention(self, q, k, v, seq_len, head_dim):
        """q, k, v: (B, max_seq, max_heads, max_head_dim) zero-padded;
        seq_len, head_dim: one-element int tensors, never read on the
        host."""
        f32 = torch.float32
        scale = 1.0 / torch.sqrt(head_dim.to(f32))
        pos = torch.arange(self.max_seq, device=q.device)
        ok = (pos < seq_len)[None, :]                       # key padding mask
        if self.causal:
            ok = ok & (pos[None, :] <= pos[:, None])
        s = torch.einsum("bqhd,bkhd->bhqk", q.to(f32) * scale, k.to(f32))
        s = torch.where(ok[None, None], s, torch.finfo(f32).min)  # finite
        p = torch.softmax(s, dim=-1)                        # rows NaN-free
        return torch.einsum("bhqk,bkhd->bqhd", p, v.to(f32)).to(q.dtype)

    def __call__(self, q, k, v):
        """q,k,v: (B, S, H, dh) with S ≤ max_seq, H ≤ max_heads, dh ≤ max."""
        B, S, H, dh = q.shape
        if not (S <= self.max_seq and H <= self.max_heads
                and dh <= self.max_head_dim):
            raise ValueError(
                f"topology {(S, H, dh)} exceeds synthesis-time maxima "
                f"{(self.max_seq, self.max_heads, self.max_head_dim)}")
        key = (B, q.dtype)
        if key not in self._bufs:
            shape = (B, self.max_seq, self.max_heads, self.max_head_dim)
            self._bufs[key] = tuple(
                torch.zeros(shape, dtype=q.dtype, device=self.device)
                for _ in range(3))
        for buf, x in zip(self._bufs[key], (q, k, v)):
            buf.zero_()
            buf[:, :S, :H, :dh].copy_(x)
        self._scalars.put((S, dh))
        out = self._exec(key)
        return out[:, :S, :H, :dh].clone()


class CapturedFunction:
    """``fn(*tensors)`` as an executable, the port's ``jax.jit``: on a CUDA
    device one ``graphs.Executable`` key per signature (shape, dtype) of
    its arguments, which it copies into static buffers (the first call of
    a signature runs eagerly, the second captures, later calls replay);
    elsewhere, or inside ``graphs.disable_capture()``, ``fn`` runs eagerly.
    Returns fresh tensors."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self._exec = None
        self._args: dict = {}

    @property
    def compilations(self) -> int:
        return 0 if self._exec is None else len(self._exec.graph_keys)

    def __call__(self, *args):
        dev = args[0].device
        if not graphs.capture_enabled(dev):
            return self.fn(*args)
        if self._exec is None:
            self._exec = graphs.Executable(
                lambda key: self.fn(*self._args[key]), graphs.GraphPool(dev))
        key = tuple((tuple(a.shape), a.dtype) for a in args)
        if key not in self._args:
            self._args[key] = [a.clone() for a in args]
        else:
            for buf, a in zip(self._args[key], args):
                buf.copy_(a)
        return _clone(self._exec(key))


class BucketCache:
    """Shape-bucketed executable cache: build one per bucket, pad within.
    ``get(seq)`` returns (the bucket's executable, bucket): a
    :class:`CapturedFunction` of ``fn(..., bucket=b)``, built on a miss."""

    def __init__(self, fn: Callable,
                 bucket_fn: Callable[[int], int] | None = None):
        self._fn = fn
        self._cache: dict = {}
        self._bucket = bucket_fn or next_pow2
        self.hits = 0
        self.misses = 0

    def get(self, seq: int):
        b = self._bucket(seq)
        if b not in self._cache:
            self.misses += 1
            self._cache[b] = CapturedFunction(
                functools.partial(self._fn, bucket=b))
        else:
            self.hits += 1
        return self._cache[b], b

    def __len__(self):
        return len(self._cache)


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (next_pow2(1) == 1)."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()
