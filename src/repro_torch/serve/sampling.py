"""Batched per-request token sampling for the serving engine.

Everything request-specific — temperature, top-k, seed, position — arrives
as plain per-slot operands.  Greedy is ``argmax`` with the first index on
ties, as in JAX.

Reproducibility: the noise for a slot is drawn from a ``torch.Generator``
seeded with ``(seed << 32) | token_index`` — a pure function of the
*request's* seed and how many tokens it has generated, independent of which
slot it landed in, what else is in the batch, or preemption history, the
contract of ``repro.serve.sampling``.  The bits differ from the JAX
package's ``fold_in(PRNGKey(seed), index)`` + gumbel, so a seeded request
samples other tokens than it does there (a known divergence, ROADMAP
Queue 3); greedy requests are token-identical.
"""
from __future__ import annotations

import torch


def fold_seed(seed: int) -> int:
    """Fold an arbitrary non-negative python int into uint32 range
    (xor-fold of the high bits — the identity for seeds < 2^32)."""
    s = int(seed)
    while s >> 32:
        s = (s >> 32) ^ (s & 0xFFFFFFFF)
    return s


def _gumbel(seed: int, index: int, n: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) << 32) | (int(index) & 0xFFFFFFFF))
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def _sample_one(lg, t: float, k: int, s: int, idx: int, cap: int):
    """One token from one logit row — a pure function of (seed, token
    index, logits)."""
    if t <= 0:
        return torch.argmax(lg)
    kth = torch.topk(lg, cap).values[min(max(k, 1), cap) - 1]
    masked = torch.where((lg < kth) & (k > 0),
                         torch.full_like(lg, float("-inf")), lg)
    g = _gumbel(s, idx, lg.shape[-1], lg.device)
    return torch.argmax(masked / max(t, 1e-6) + g)


def sample_tokens(logits, temperature, top_k, seed, index, k_cap: int = 0):
    """Sample one token per slot.

    logits: (B, vocab) f32 on the device; temperature, top_k, seed, index:
    (B,) host numpy arrays (``<= 0`` temperature means greedy, ``0`` top-k
    means the full vocab); k_cap: bound on the batch's largest top_k
    (``0`` -> full vocab).  Returns (B,) int64 on the logits' device."""
    v = logits.shape[-1]
    cap = v if k_cap <= 0 else min(k_cap, v)
    return torch.stack([
        _sample_one(logits[b], float(temperature[b]), int(top_k[b]),
                    int(seed[b]), int(index[b]), cap)
        for b in range(logits.shape[0])])
