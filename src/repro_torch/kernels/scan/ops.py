"""The recurrence kernels from the models' layouts (the port of
``repro.kernels.scan.ops``): the RG-LRU scan on (B, S, R), and wkv6 on the
model's (B, H, S, dh) heads, flattened to the kernel's (B·H, S, dh) rows
with the per-head bonus ``u`` repeated over the batch.  Unlike the JAX
wrapper, ``wkv6`` also takes a carried state ``s0`` and returns the final
state, which chunked prefill carries across engine chunks.

``plain=True`` runs the kernels' plain versions whatever the device (the
models' non-kernel impls); otherwise the wrappers launch the kernels on
CUDA tensors and run the plain versions on CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels.scan import linear_scan, ref


def rglru(a, b, plain: bool = False):
    """a, b: (B, S, R) -> h: (B, S, R) f32, h_t = a_t h_{t-1} + b_t from
    h = 0."""
    if plain:
        return ref.rglru_reference(a, b)
    return linear_scan.rglru_scan(a.contiguous(), b.contiguous())


def wkv6(r, k, v, logw, u, s0=None, chunk: int = 64, plain: bool = False):
    """r, k, v, logw: (B, H, S, dh); u: (H, dh); s0: optional (B, H, dh, dh).
    Returns (out (B, H, S, dh) f32, s_final (B, H, dh, dh) f32)."""
    B, H, S, dh = r.shape

    def flat(x):
        return x.reshape(B * H, S, dh).contiguous()

    uu = u.to(torch.float32)[None].expand(B, H, dh).reshape(B * H, dh)
    s = (None if s0 is None
         else s0.to(torch.float32).reshape(B * H, dh, dh).contiguous())
    fn = ref.wkv6_chunked_reference if plain else linear_scan.wkv6_scan
    out, s_final = fn(flat(r), flat(k), flat(v), flat(logw), uu.contiguous(),
                      s, chunk=chunk)
    return out.reshape(B, H, S, dh), s_final.reshape(B, H, dh, dh)
