"""PyTorch port, the batched sampler: ``sample_tokens`` and
``verify_tokens`` with every operand a device tensor, token for token
against the JAX package's vmapped samplers (jitted with a static
``k_cap``, as the JAX engine runs them) on seeded batches that mix greedy
and hot slots, ``top_k`` 0 / 1 / k / V, tied logits, seeds above 2^32
(folded as both engines fold them), ``k_cap`` 1 to V and verify widths 1
to 5; and against the port's earlier per-slot loop, kept here as an
oracle."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (one torch thread)
from repro.serve import sampling as jsampling
from repro_torch.serve import sampling

V = 97
B = 7


@functools.lru_cache(maxsize=None)
def _jax_sampler(verify: bool):
    fn = jsampling.verify_tokens if verify else jsampling.sample_tokens
    return jax.jit(fn, static_argnames=("k_cap",))


def _mix(seed: int, rows: tuple, ties: bool = False):
    """Logits of shape ``rows + (V,)`` and (B,) operands: greedy (t 0 and
    t < 0) and hot slots, top_k 0 / 1 / a middle k / V, seeds drawn up
    to 2^40 and folded to uint32, token indices up to 2^31."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal(rows + (V,)).astype(np.float32) * 3
    if ties:    # a coarse grid: every row holds runs of equal logits
        logits = np.round(logits).astype(np.float32)
    temps = rng.choice(np.array([0.0, -1.0, 0.3, 0.8, 1.0, 1.7],
                                np.float32), size=B)
    temps[0], temps[1] = 0.0, 0.9       # always one greedy, one hot slot
    topk = rng.choice(np.array([0, 1, 5, 23, V], np.int32), size=B)
    seeds = np.array([sampling.fold_seed(int(s)) for s in
                      rng.integers(0, 2**40, size=B)], np.uint32)
    seeds[2] = sampling.fold_seed(2**32 + 9)
    idx = rng.integers(0, 2**31 - 8, size=B).astype(np.int32)
    return logits, temps, topk, seeds, idx


def _port(logits, temps, topk, seeds, idx, k_cap, verify=False):
    fn = sampling.verify_tokens if verify else sampling.sample_tokens
    return fn(torch.from_numpy(logits), torch.from_numpy(temps),
              torch.from_numpy(topk.astype(np.int64)),
              torch.from_numpy(seeds.astype(np.int64)),
              torch.from_numpy(idx.astype(np.int64)), k_cap=k_cap).numpy()


def _jax(logits, temps, topk, seeds, idx, k_cap, verify=False):
    return np.asarray(_jax_sampler(verify)(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(topk),
        jnp.asarray(seeds), jnp.asarray(idx), k_cap=k_cap))


@pytest.mark.parametrize("k_cap", [0, 1, 2, 3, 8, 23, 64, V - 1, V, V + 5])
@pytest.mark.parametrize("ties", [False, True])
def test_sample_tokens_match_jax(k_cap, ties):
    ops = _mix(k_cap * 2 + ties, (B,), ties)
    mine = _port(*ops, k_cap)
    np.testing.assert_array_equal(mine, _jax(*ops, k_cap))
    assert mine.dtype == np.int64


@pytest.mark.parametrize("W", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("k_cap", [1, 32, V])
def test_verify_tokens_match_jax(W, k_cap):
    ops = _mix(100 + W * 7 + k_cap, (B, W), ties=W % 2 == 0)
    mine = _port(*ops, k_cap, verify=True)
    assert mine.shape == (B, W)
    np.testing.assert_array_equal(mine, _jax(*ops, k_cap, verify=True))


def test_verify_position_j_is_decode_at_index_plus_j():
    """Entry (b, j) of the verify grid is the token ``sample_tokens``
    gives for row (b, j) at token index ``index[b] + j``: what makes
    speculative verification token-identical to plain decode."""
    W = 4
    logits, temps, topk, seeds, idx = _mix(7, (B, W))
    grid = _port(logits, temps, topk, seeds, idx, 32, verify=True)
    for j in range(W):
        col = _port(np.ascontiguousarray(logits[:, j]), temps, topk, seeds,
                    idx + j, 32)
        np.testing.assert_array_equal(grid[:, j], col)


def test_greedy_ties_take_the_first_index():
    logits = np.zeros((3, V), np.float32)
    logits[0, [5, 9]] = 2.0
    logits[1, :] = 1.0
    logits[2, [V - 1, 40]] = 7.0
    zeros = np.zeros(3)
    ops = (logits, zeros.astype(np.float32), zeros.astype(np.int32),
           zeros.astype(np.uint32), zeros.astype(np.int32))
    np.testing.assert_array_equal(_port(*ops, 1), [5, 0, 40])
    np.testing.assert_array_equal(_jax(*ops, 1), [5, 0, 40])


def test_top_k_one_is_greedy_when_hot():
    """A hot slot with top_k 1 keeps only its maximum: it samples the
    greedy token whatever the noise."""
    logits, temps, topk, seeds, idx = _mix(3, (B,))
    temps[:] = 1.3
    topk[:] = 1
    greedy = logits.argmax(-1)
    np.testing.assert_array_equal(_port(logits, temps, topk, seeds, idx, 1),
                                  greedy)


# ---------------------------------------------------------------------------
# the port's earlier per-slot loop (host operands), kept as an oracle
# ---------------------------------------------------------------------------


def _loop_one(lg, t: float, k: int, s: int, idx: int, cap: int):
    if t <= 0:
        return torch.argmax(lg)
    kth = torch.topk(lg, cap).values[min(max(k, 1), cap) - 1]
    masked = torch.where((lg < kth) & (k > 0),
                         torch.full_like(lg, float("-inf")), lg)
    g = sampling.gumbel(s, idx, lg.shape[-1], lg.device)
    return torch.argmax(masked / max(t, 1e-6) + g)


def _loop(logits, temps, topk, seeds, idx, k_cap):
    lg = torch.from_numpy(logits)
    cap = V if k_cap <= 0 else min(k_cap, V)
    rows = lg.reshape(-1, V)
    W = 1 if lg.ndim == 2 else lg.shape[1]
    out = [_loop_one(rows[r], float(temps[r // W]), int(topk[r // W]),
                     int(seeds[r // W]), int(idx[r // W]) + r % W, cap)
           for r in range(rows.shape[0])]
    return torch.stack(out).reshape(lg.shape[:-1]).numpy()


@pytest.mark.parametrize("seed", range(6))
def test_batched_sampler_matches_the_per_slot_loop(seed):
    W = 1 + seed % 3
    rows = (B,) if seed < 3 else (B, W)
    ops = _mix(200 + seed, rows, ties=seed % 2 == 1)
    k_cap = (0, 4, 16)[seed % 3]
    np.testing.assert_array_equal(
        _port(*ops, k_cap, verify=len(rows) == 2), _loop(*ops, k_cap))


def test_fold_in_matches_the_scalar_key():
    """The batched ``fold_in`` gives ``fold_in_key``'s words per slot."""
    seeds = np.array([0, 42, 2**32 - 1, 123456789], np.int64)
    idx = np.array([0, 3, 7, 2**31 - 1], np.int64)
    a, b = sampling.fold_in(torch.from_numpy(seeds), torch.from_numpy(idx))
    for i in range(4):
        assert (int(a[i]), int(b[i])) == sampling.fold_in_key(seeds[i],
                                                              idx[i])
