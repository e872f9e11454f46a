"""Batched per-request token sampling for the serving engine.

Everything request-specific — temperature, top-k, seed, position — arrives
as plain per-slot operands.  Greedy is ``argmax`` with the first index on
ties, as in JAX.

Reproducibility: the noise for a slot is JAX's own.  The key is
``fold_in(PRNGKey(seed), token_index)`` and the noise
``jax.random.gumbel(key, (vocab,), float32)``, recomputed here bit for bit:
the threefry2x32 hash in int64 tensor arithmetic masked to 32 bits, JAX's
partitionable ``random_bits`` layout (counter ``i`` hashed as the pair
``(0, i)``, the two output words xor-ed), and its uniform -> gumbel map with
``minval = finfo(float32).tiny``.  The noise is a pure function of the
*request's* seed and how many tokens it has generated, independent of which
slot it landed in, what else is in the batch, or preemption history, so a
seeded request samples the same tokens as it does on the JAX engine.
"""
from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def fold_seed(seed: int) -> int:
    """Fold an arbitrary non-negative python int into uint32 range
    (xor-fold of the high bits — the identity for seeds < 2^32)."""
    s = int(seed)
    while s >> 32:
        s = (s >> 32) ^ (s & 0xFFFFFFFF)
    return s


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK32


def threefry2x32(k0: int, k1: int, x0, x1):
    """The threefry2x32 hash of JAX's PRNG (20 rounds) on the count pairs
    ``(x0, x1)``: int64 tensors (or ints) holding uint32 values.  Returns
    the two uint32 output words as int64 tensors."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x0, x1


def fold_in_key(seed: int, index: int) -> tuple[int, int]:
    """``jax.random.fold_in(jax.random.PRNGKey(seed), index)`` as its two
    uint32 words, for a uint32 ``seed`` and a non-negative ``index``."""
    a, b = threefry2x32(0, int(seed) & _MASK32, torch.tensor(0),
                        torch.tensor(int(index) & _MASK32))
    return int(a), int(b)


def random_bits(key: tuple[int, int], n: int, device) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` (the partitionable layout)
    as int64 values in [0, 2^32)."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(i), i)
    return y0 ^ y1


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """JAX's ``_uniform`` with ``minval=tiny, maxval=1`` for float32: the
    top 23 bits as a mantissa of [1, 2), minus one, then
    ``max(tiny, u * (1 - tiny) + tiny)`` (``1 - tiny`` is 1 in float32)."""
    mant = (bits >> 9) | 0x3F800000
    u = mant.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(u + _TINY, _TINY)


def gumbel(seed: int, index: int, n: int, device) -> torch.Tensor:
    """``jax.random.gumbel(fold_in(PRNGKey(seed), index), (n,), float32)``
    (the default "low" mode), computed on ``device``."""
    u = uniform_from_bits(random_bits(fold_in_key(seed, index), n, device))
    return -torch.log(-torch.log(u))


def _sample_one(lg, t: float, k: int, s: int, idx: int, cap: int):
    """One token from one logit row — a pure function of (seed, token
    index, logits)."""
    if t <= 0:
        return torch.argmax(lg)
    kth = torch.topk(lg, cap).values[min(max(k, 1), cap) - 1]
    masked = torch.where((lg < kth) & (k > 0),
                         torch.full_like(lg, float("-inf")), lg)
    g = gumbel(s, idx, lg.shape[-1], lg.device)
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


def verify_tokens(logits, temperature, top_k, seed, index0, k_cap: int = 0):
    """Sample all W verify positions of every slot.

    logits: (B, W, vocab) f32 from ``transformer.verify_step``; position j
    of slot b samples with token index ``index0[b] + j`` — the index plain
    decode reaches after accepting j tokens — and the request's own
    (temperature, top_k, seed), so entry (b, j) is *the* token sequential
    decoding of the draft prefix would emit (:func:`_sample_one` is a pure
    function of seed, index and logits).  Host operands as in
    :func:`sample_tokens`.  Returns (B, W) int64 on the logits' device."""
    v = logits.shape[-1]
    cap = v if k_cap <= 0 else min(k_cap, v)
    return torch.stack([
        torch.stack([
            _sample_one(logits[b, j], float(temperature[b]), int(top_k[b]),
                        int(seed[b]), int(index0[b]) + j, cap)
            for j in range(logits.shape[1])])
        for b in range(logits.shape[0])])
