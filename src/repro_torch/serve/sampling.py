"""Batched per-request token sampling for the serving engine.

Everything request-specific — temperature, top-k, seed, position — arrives
as ``(B,)`` tensors on the logits' device, and every slot is sampled at
once by a few batched tensor ops, as JAX's vmapped ``sample_tokens`` does:
no value is read on the host, so the sampler can be captured in a CUDA
graph and replayed for any request mix.  The only static input is
``k_cap``, a bound on the batch's largest top-k (``torch.topk`` takes a
host ``k``, as ``jax.lax.top_k`` takes a static one).  Greedy is
``argmax`` with the first index on ties, as in JAX.

Reproducibility: the noise for a slot is JAX's own.  The key is
``fold_in(PRNGKey(seed), token_index)`` and the noise
``jax.random.gumbel(key, (vocab,), float32)``, recomputed here bit for bit:
the threefry2x32 hash in int64 tensor arithmetic masked to 32 bits (key
words and counts alike may be tensors), JAX's partitionable
``random_bits`` layout (counter ``i`` hashed as the pair ``(0, i)``, the
two output words xor-ed), and its uniform -> gumbel map with ``minval =
finfo(float32).tiny``.  The noise is a pure function of the *request's*
seed and how many tokens it has generated, independent of which slot it
landed in, what else is in the batch, or preemption history, so a seeded
request samples the same tokens as it does on the JAX engine.
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


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash of JAX's PRNG (20 rounds) on the count pairs
    ``(x0, x1)`` under the key ``(k0, k1)``: ints or int64 tensors holding
    uint32 values, broadcast against each other.  Returns the two uint32
    output words as int64 tensors."""
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


def fold_in(seed: torch.Tensor, index: torch.Tensor):
    """``jax.random.fold_in(jax.random.PRNGKey(seed), index)`` elementwise
    over int64 tensors of uint32 seeds and non-negative indices: the two
    key words, int64 tensors of the broadcast shape."""
    index = index & _MASK32
    return threefry2x32(0, seed, torch.zeros_like(index), index)


def fold_in_key(seed: int, index: int) -> tuple[int, int]:
    """:func:`fold_in` for one host ``seed`` and ``index``, as two ints."""
    a, b = fold_in(torch.tensor(int(seed) & _MASK32), torch.tensor(int(index)))
    return int(a), int(b)


def random_bits(key, n: int, device) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` (the partitionable layout)
    as int64 values in [0, 2^32).  ``key``: two ints, or two int64 tensors
    of shape ``(..., 1)`` for a batch of keys, giving ``(..., n)``."""
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


def _gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(uniform_from_bits(bits)))


def gumbel(seed: int, index: int, n: int, device) -> torch.Tensor:
    """``jax.random.gumbel(fold_in(PRNGKey(seed), index), (n,), float32)``
    (the default "low" mode), computed on ``device``."""
    return _gumbel_from_bits(random_bits(fold_in_key(seed, index), n, device))


def _sample(logits, temperature, top_k, seed, index, cap: int):
    """One token per row of ``logits`` (..., V); the operands have the
    rows' shape ``(...)``.  Row-wise the arithmetic of JAX's
    ``_sample_one``: top-k keeps logits >= the k-th largest (``top_k`` 0
    keeps all), Gumbel noise from ``fold_in(PRNGKey(seed), index)``, and
    the argmax of ``masked / max(t, 1e-6) + noise`` where ``t > 0``, the
    plain argmax elsewhere."""
    greedy = torch.argmax(logits, dim=-1)
    k = top_k.to(torch.int64).expand(greedy.shape)
    kth = torch.topk(logits, cap, dim=-1).values.gather(
        -1, (k.clamp(1, cap) - 1)[..., None])
    masked = torch.where((k > 0)[..., None] & (logits < kth),
                         float("-inf"), logits)
    a, b = fold_in(seed.to(torch.int64), index.to(torch.int64))
    noise = _gumbel_from_bits(random_bits((a[..., None], b[..., None]),
                                          logits.shape[-1], logits.device))
    t = temperature.to(torch.float32)
    sampled = torch.argmax(masked / t.clamp_min(1e-6)[..., None] + noise,
                           dim=-1)
    return torch.where(t > 0, sampled, greedy)


def sample_tokens(logits, temperature, top_k, seed, index, k_cap: int = 0):
    """Sample one token per slot.

    logits: (B, vocab) f32; temperature: (B,) f32 (``<= 0`` means
    greedy); top_k: (B,) int (``0`` means the full vocab); seed: (B,)
    int64 holding uint32 per-request seeds; index: (B,) int per-request
    token index (``len(req.out)``) — all on the logits' device.  k_cap:
    static bound on the batch's largest top_k (``0`` -> full vocab).
    Returns (B,) int64."""
    v = logits.shape[-1]
    cap = v if k_cap <= 0 else min(k_cap, v)
    return _sample(logits, temperature, top_k, seed, index, cap)


def verify_tokens(logits, temperature, top_k, seed, index0, k_cap: int = 0):
    """Sample all W verify positions of every slot.

    logits: (B, W, vocab) f32 from ``transformer.verify_step``; position j
    of slot b samples with token index ``index0[b] + j`` — the index plain
    decode reaches after accepting j tokens — and the request's own
    (temperature, top_k, seed), so entry (b, j) is *the* token sequential
    decoding of the draft prefix would emit (the sampler is a pure
    function of seed, index and logits).  Device operands as in
    :func:`sample_tokens`.  Returns (B, W) int64."""
    v, W = logits.shape[-1], logits.shape[1]
    cap = v if k_cap <= 0 else min(k_cap, v)
    index = index0.to(torch.int64)[:, None] + torch.arange(
        W, dtype=torch.int64, device=logits.device)
    return _sample(logits, temperature[:, None], top_k[:, None],
                   seed[:, None], index, cap)
