"""PyTorch port, runtime programmability (``repro_torch.core.flexible``,
the paper's §IV-C) against the JAX package's ``repro.core.flexible`` on
the same numpy inputs, on the CPU (one eager build of the padded program
per (batch, dtype); on the card that build is a CUDA graph capture):

* ports of ``tests/test_famous_core.py``'s flexible tests: one program
  serves every (h, SL, dh) within the maxima, each output within 2e-5 of
  JAX's ``FlexibleAttention`` and of the port's ``attention_reference``,
  and ``compilations`` stays at 1, as JAX's;
* causal and non-causal, the softmax scale taken from the actual head dim,
  padded rows NaN-free, and ``seq_len`` / ``head_dim`` held in tensors
  whose host reads raise (what a graph would freeze);
* ``BucketCache`` hits, misses and ``len`` equal to JAX's on one get
  sequence, its executables computing ``fn(x, bucket=b)``;
* ``next_pow2`` as in the JAX suite.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_prefill_graph import HostReadError, NoHostRead
from repro.core import flexible as jflexible
from repro_torch.analysis.retrace_guard import retrace_guard
from repro_torch.core import famous, flexible

torch.set_num_threads(1)
TOL = 2e-5


def _qkv(seed, B, S, H, dh):
    rng = np.random.default_rng(seed)
    return [(0.5 * rng.standard_normal((B, S, H, dh))).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
def test_one_program_many_topologies_matches_jax(causal):
    """Table I tests #1-#8 on one program: vary h, SL and d_head."""
    fa = flexible.FlexibleAttention(max_heads=8, max_seq=128,
                                    max_head_dim=64, causal=causal,
                                    device="cpu")
    jfa = jflexible.FlexibleAttention(max_heads=8, max_seq=128,
                                      max_head_dim=64, causal=causal)
    for (H, S, dh) in [(8, 128, 64), (4, 128, 64), (2, 64, 64),
                       (8, 128, 32), (3, 96, 16)]:
        q, k, v = _qkv(S + H + dh, 2, S, H, dh)
        out = fa(*map(torch.from_numpy, (q, k, v)))
        want = jfa(*map(jnp.asarray, (q, k, v)))
        ref = famous.attention_reference(*map(torch.from_numpy, (q, k, v)),
                                         causal=causal)
        assert out.shape == (2, S, H, dh)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=TOL,
                                   err_msg=f"{(H, S, dh)}")
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=TOL,
                                   err_msg=f"{(H, S, dh)}")
    assert fa.compilations == 1 == jfa._fn._cache_size()


def test_counts_compilations_like_jax():
    """One build reused across topologies, as JAX's trace counter shows;
    a new batch size is a new static shape in both."""
    fa = flexible.FlexibleAttention(max_heads=4, max_seq=64, max_head_dim=32,
                                    device="cpu")
    jfa = jflexible.FlexibleAttention(max_heads=4, max_seq=64,
                                      max_head_dim=32)
    assert fa.compilations == jfa.compilations == 0
    for (H, S, dh) in [(4, 64, 32), (2, 32, 16), (3, 48, 32)]:
        qkv = _qkv(H + S, 1, S, H, dh)
        fa(*map(torch.from_numpy, qkv))
        jfa(*map(jnp.asarray, qkv))
    assert fa.compilations == jfa.compilations == 1
    with retrace_guard(fa):
        fa(*map(torch.from_numpy, _qkv(9, 1, 20, 2, 8)))
    qkv = _qkv(7, 2, 16, 4, 32)
    fa(*map(torch.from_numpy, qkv))
    jfa(*map(jnp.asarray, qkv))
    assert fa.compilations == jfa.compilations == 2


def test_scale_uses_actual_head_dim():
    """dh=16 inside a 64-wide program: scores scaled by 1/sqrt(16), not
    1/sqrt(64) (tests #4-#5's d_model sweep)."""
    fa = flexible.FlexibleAttention(max_heads=2, max_seq=32, max_head_dim=64,
                                    causal=False, device="cpu")
    q, k, v = map(torch.from_numpy, _qkv(3, 1, 32, 2, 16))
    out = fa(q, k, v)
    right = famous.attention_reference(q, k, v, causal=False,
                                       scale=1 / math.sqrt(16))
    wrong = famous.attention_reference(q, k, v, causal=False,
                                       scale=1 / math.sqrt(64))
    np.testing.assert_allclose(out.numpy(), right.numpy(), atol=TOL)
    assert float((out - wrong).abs().max()) > 1e-2


@pytest.mark.parametrize("causal", [True, False])
def test_padded_rows_nan_free_and_scalars_never_read(causal):
    """The padded program on scalars whose host reads raise: every row,
    the padded ones included, finite; the real block equal to the
    exact-shape reference."""
    fa = flexible.FlexibleAttention(max_heads=4, max_seq=48, max_head_dim=32,
                                    causal=causal, device="cpu")
    S, H, dh = 20, 3, 24
    q, k, v = map(torch.from_numpy, _qkv(5, 2, S, H, dh))
    pad = torch.zeros((3, 2, 48, 4, 32))
    pad[:, :, :S, :H, :dh] = torch.stack([q, k, v])
    sc = torch.tensor([S, dh], dtype=torch.int32)
    seq_len, head_dim = NoHostRead(sc[0:1]), NoHostRead(sc[1:2])
    with pytest.raises(HostReadError):
        int(seq_len)
    out = fa._padded_attention(*pad, seq_len, head_dim).as_subclass(
        torch.Tensor)
    assert bool(torch.isfinite(out).all())
    ref = famous.attention_reference(q, k, v, causal=causal)
    np.testing.assert_allclose(out[:, :S, :H, :dh].numpy(), ref.numpy(),
                               atol=TOL)


def test_exceeding_the_maxima_raises():
    fa = flexible.FlexibleAttention(max_heads=2, max_seq=16, max_head_dim=8,
                                    device="cpu")
    q = torch.zeros((1, 17, 2, 8))
    with pytest.raises(ValueError, match="maxima"):
        fa(q, q, q)


def test_bucket_cache_matches_jax():
    seqs = (10, 17, 33, 60, 100, 120, 16, 1, 2, 3)
    cache = flexible.BucketCache(lambda x, bucket: torch.tanh(x) * bucket)
    jcache = jflexible.BucketCache(lambda x, bucket: jnp.tanh(x) * bucket)
    for n in seqs:
        fn, b = cache.get(n)
        jfn, jb = jcache.get(n)
        assert b == jb
        x = np.linspace(-2, 2, b, dtype=np.float32)
        np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(),
                                   np.asarray(jfn(jnp.asarray(x))),
                                   rtol=1e-6)
    assert (cache.hits, cache.misses, len(cache)) == \
        (jcache.hits, jcache.misses, len(jcache)) == (3, 7, 7)
    custom = flexible.BucketCache(lambda x, bucket: x,
                                  bucket_fn=lambda n: 64 * -(-n // 64))
    assert custom.get(65)[1] == 128 and custom.get(1)[1] == 64


@pytest.mark.parametrize("n,expect", [
    (1, 1), (2, 2), (3, 4), (4, 4), (5, 8), (127, 128), (128, 128),
    (129, 256),
])
def test_next_pow2(n, expect):
    assert flexible.next_pow2(n) == expect == jflexible.next_pow2(n)


def test_flexible_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        flexible.FlexibleAttention(max_heads=1, max_seq=8, max_head_dim=8)
