"""FAMOUS core on PyTorch: the serving half of ``repro.core.famous``.

The paper decomposes MHA into three processing modules — QKV_PM (Algorithm
1, the column-tiled projection), QK_PM (scores + softmax) and SV_PM — and
this module keeps the JAX package's three interchangeable implementations
of them, selected by ``FamousConfig.impl``:

  impl="reference"  paper-faithful eager oracle (explicit TS-tile loop).
  impl="xla"        plain torch ops: one fused projection, dense masked
                    attention.
  impl="pallas"     the hand-written Hopper kernels (kernels/qkv,
                    kernels/attention, kernels/decode) on CUDA tensors;
                    their plain versions on CPU tensors.  Trainable: the
                    attention kernel carries a flash autograd function
                    whose dq and dk/dv passes are kernels too, and the QKV
                    matmul kernel differentiates through itself.

Ported: the projection, full-sequence attention (``attention`` with the
flash autograd function of ``attention_xla``, and ``mha_block``), and the
serving path's chunked-prefill and decode attention.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class FamousConfig:
    """Tiling + dispatch knobs (the TS analogue and runtime maxima)."""

    tile_d: int = 512       # TS for the QKV_PM reduction dim (d_model)
    tile_q: int = 512       # query-tile rows held on-chip in QK/SV modules
    tile_k: int = 512       # key-tile columns streamed through QK/SV modules
    impl: str = "xla"       # reference | xla | pallas
    quant: str = "none"     # none | int8  (paper uses 8-bit fixed point)
    # Runtime-programmable maxima (paper §IV-C).
    max_heads: int = 0
    max_seq: int = 0
    max_d_model: int = 0


def _check_quant(cfg: FamousConfig) -> None:
    if cfg.quant != "none":
        raise NotImplementedError(
            "quant='int8' comes with the int8 slice of the port "
            "(ROADMAP Queue 2: matmul_tiled_int8)")


# ---------------------------------------------------------------------------
# QKV_PM — Algorithm 1
# ---------------------------------------------------------------------------


def qkv_projection_reference(x, wq, wk, wv, bq=None, bk=None, bv=None, *,
                             tile_d: int = 64):
    """Paper-faithful Algorithm 1: the projection tiled along D (the
    reduction dim) with partial sums accumulated in f32, the bias added at
    the end.  x: (..., S, D); w*: (D, H, dh)."""
    d = x.shape[-1]
    tile_d = min(tile_d, d)
    assert d % tile_d == 0, (d, tile_d)

    def one(w):
        acc = torch.zeros(x.shape[:-1] + w.shape[1:], dtype=torch.float32,
                          device=x.device)
        for t in range(d // tile_d):  # the (d_model / TS) BRAM reloads
            xs = x[..., t * tile_d:(t + 1) * tile_d].to(torch.float32)
            ws = w[t * tile_d:(t + 1) * tile_d].to(torch.float32)
            acc = acc + torch.einsum("...sd,dhe->...she", xs, ws)
        return acc

    q, k, v = one(wq), one(wk), one(wv)
    if bq is not None:
        q, k, v = q + bq, k + bk, v + bv
    return q.to(x.dtype), k.to(x.dtype), v.to(x.dtype)


def fuse_qkv_weights(wq, wk, wv) -> torch.Tensor:
    """[Wq|Wk|Wv] as one (D, H*dh + 2*KV*dh) matrix."""
    D = wq.shape[0]
    return torch.cat([wq.reshape(D, -1), wk.reshape(D, -1),
                      wv.reshape(D, -1)], dim=-1)


def qkv_projection_xla(x, wq, wk, wv, bq=None, bk=None, bv=None, *,
                       w_qkv=None):
    """Fused projection in ``x.dtype``: one read of x feeds three matmuls,
    like the shared X BRAM in QKV_PM."""
    w = w_qkv if w_qkv is not None else fuse_qkv_weights(wq, wk, wv)
    qkv = x @ w.to(x.dtype)
    nq = wq.shape[1] * wq.shape[2]
    nk = wk.shape[1] * wk.shape[2]
    q = qkv[..., :nq].reshape(x.shape[:-1] + wq.shape[1:])
    k = qkv[..., nq:nq + nk].reshape(x.shape[:-1] + wk.shape[1:])
    v = qkv[..., nq + nk:].reshape(x.shape[:-1] + wv.shape[1:])
    if bq is not None:
        q, k, v = q + bq.to(q.dtype), k + bk.to(k.dtype), v + bv.to(v.dtype)
    return q, k, v


def qkv_projection(x, wq, wk, wv, bq=None, bk=None, bv=None, *,
                   cfg: FamousConfig = FamousConfig(), w_qkv=None):
    """x: (B, S, D); w*: (D, heads, dh).  ``w_qkv``: the fused matrix when
    the caller holds one (the model does: it is fused once at load time);
    otherwise it is concatenated here."""
    _check_quant(cfg)
    if cfg.impl == "reference":
        return qkv_projection_reference(x, wq, wk, wv, bq, bk, bv,
                                        tile_d=cfg.tile_d)
    if cfg.impl == "pallas":
        from repro_torch.kernels.qkv import ops as qkv_ops
        w = w_qkv if w_qkv is not None else fuse_qkv_weights(wq, wk, wv)
        shapes = (wq.shape[1:], wk.shape[1:], wv.shape[1:])
        return qkv_ops.qkv_projection(x, w.to(x.dtype).contiguous(), shapes,
                                      bq, bk, bv)
    return qkv_projection_xla(x, wq, wk, wv, bq, bk, bv, w_qkv=w_qkv)


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------


def _mask_bias(q_pos, k_pos, *, causal: bool, window: int,
               dtype=torch.float32):
    """Additive mask bias (0 / -inf) for (len(q_pos), len(k_pos))."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    return torch.zeros(ok.shape, dtype=dtype, device=ok.device).masked_fill(
        ~ok, float("-inf"))


def _broadcast_kv(x, num_q_heads):
    """GQA: repeat kv heads to match query heads. x: (B, S, KV, dh)."""
    kv = x.shape[-2]
    if kv == num_q_heads:
        return x
    return torch.repeat_interleave(x, num_q_heads // kv, dim=-2)


# ---------------------------------------------------------------------------
# QK_PM + softmax + SV_PM — Algorithms 2 & 3
# ---------------------------------------------------------------------------


def attention_reference(q, k, v, *, causal=True, window=0, scale=None,
                        q_offset=0):
    """Paper-faithful QK_PM/SV_PM: materialise S (the FPGA keeps S in
    BRAM), full softmax, then S·V.  A row with no visible key is NaN, as
    in JAX.  q: (B, Sq, H, dh); k, v: (B, Skv, KV, dh)."""
    B, Sq, H, dh = q.shape
    Skv = k.shape[1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(dh)
    k = _broadcast_kv(k, H)
    v = _broadcast_kv(v, H)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Skv, device=q.device)
    s = s + _mask_bias(q_pos, k_pos, causal=causal, window=window)[None, None]
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
    return out.to(q.dtype)


def _flash_forward(q, k, v, *, causal, window, scale, q_offset, block_k):
    """Online-softmax forward over key tiles.  q, k, v: (B, S, H, dh), kv
    already broadcast to H heads.  Returns (out (B, Sq, H, dh),
    lse (B, H, Sq))."""
    B, Sq, H, dh = q.shape
    Skv = k.shape[1]
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    acc = torch.zeros((B, H, Sq, dh), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Sq), float("-inf"), device=q.device)
    l = torch.zeros((B, H, Sq), device=q.device)
    for k0 in range(0, Skv, block_k):
        kt, vt = k[:, k0:k0 + block_k], v[:, k0:k0 + block_k]
        k_pos = k0 + torch.arange(kt.shape[1], device=q.device)
        # f32 products of the operands (exact for bf16), f32 sums: JAX's
        # native-dtype dot with preferred_element_type=f32
        s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                         kt.to(torch.float32)) * scale
        s = s + _mask_bias(q_pos, k_pos, causal=causal,
                           window=window)[None, None]
        m_new = torch.maximum(m, s.amax(-1))
        # fully masked rows (m_new = -inf): exp(-inf - -inf) -> guard
        safe_m = torch.where(torch.isinf(m_new), 0.0, m_new)
        p = torch.exp(torch.where(torch.isinf(s), float("-inf"),
                                  s - safe_m[..., None]))
        corr = torch.where(torch.isinf(m), 0.0, torch.exp(m - safe_m))
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, vt.to(torch.float32))
        m = m_new
    l_safe = l.clamp_min(1e-30)
    out = (acc / l_safe[..., None]).transpose(1, 2).to(q.dtype)
    lse = torch.where(torch.isinf(m), m, m + torch.log(l_safe))
    return out, lse


def _flash_bwd(q, k, v, out, lse, dout, *, causal, window, scale, q_offset,
               block_k):
    """Flash backward: recompute probabilities block by block, so the full
    S / P matrices are never held.  Returns (dq, dk, dv) in the inputs'
    dtypes."""
    B, Sq, H, dh = q.shape
    Skv = k.shape[1]
    qf = q.to(torch.float32) * scale
    do = dout.to(torch.float32).transpose(1, 2)                  # (B,H,Sq,dh)
    delta = torch.sum(do * out.to(torch.float32).transpose(1, 2), -1)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    dq = torch.zeros((B, Sq, H, dh), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, Skv, H, dh), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for k0 in range(0, Skv, block_k):
        kt = k[:, k0:k0 + block_k].to(torch.float32)
        vt = v[:, k0:k0 + block_k].to(torch.float32)
        k_pos = k0 + torch.arange(kt.shape[1], device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kt)
        s = s + _mask_bias(q_pos, k_pos, causal=causal,
                           window=window)[None, None]
        p = torch.where(torch.isinf(s) | torch.isinf(lse[..., None]), 0.0,
                        torch.exp(s - lse[..., None]))
        dv[:, k0:k0 + block_k] = torch.einsum("bhqk,bhqd->bkhd", p, do)
        dp = torch.einsum("bhqd,bkhd->bhqk", do, vt)
        ds = p * (dp - delta[..., None])
        dq += scale * torch.einsum("bhqk,bkhd->bqhd", ds, kt)
        dk[:, k0:k0 + block_k] = scale * torch.einsum(
            "bhqk,bqhd->bkhd", ds, q.to(torch.float32))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """The flash custom VJP of ``attention_xla`` (JAX ``_flash_fwd_rule`` /
    ``_flash_bwd_rule``): saves (q, k, v, out, lse), recomputes P per key
    tile in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset, block_k):
        args = dict(causal=causal, window=window, scale=scale,
                    q_offset=q_offset, block_k=block_k)
        out, lse = _flash_forward(q, k, v, **args)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = args
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout, **ctx.args)
        return dq, dk, dv, None, None, None, None, None


def attention_xla(q, k, v, *, causal=True, window=0, scale=None, q_offset=0,
                  block_k: int = 512):
    """Plain torch ops with the tiling idea: online softmax over key tiles
    (running max/sum) so S is never materialised, with a flash autograd
    function (blockwise recompute) so the backward never holds P either.
    Short or ragged key lengths take the reference."""
    B, Sq, H, dh = q.shape
    Skv = k.shape[1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(dh)
    k = _broadcast_kv(k, H)
    v = _broadcast_kv(v, H)
    if Skv <= block_k or Skv % block_k:
        return attention_reference(q, k, v, causal=causal, window=window,
                                   scale=scale, q_offset=q_offset)
    return _FlashAttention.apply(q, k, v, causal, window, scale, q_offset,
                                 block_k)


def attention(q, k, v, *, causal=True, window=0, scale=None, q_offset=0,
              cfg: FamousConfig = FamousConfig()):
    """Dense multi-head attention — FAMOUS QK_PM -> softmax -> SV_PM.
    q: (B, Sq, H, dh); k, v: (B, Skv, KV, dh).  Returns (B, Sq, H, dh)."""
    if cfg.impl == "reference":
        return attention_reference(q, k, v, causal=causal, window=window,
                                   scale=scale, q_offset=q_offset)
    if cfg.impl == "pallas":
        from repro_torch.kernels.attention import ops as attn_ops
        return attn_ops.mha(q, k, v, causal=causal, window=window,
                            scale=scale, q_offset=q_offset,
                            block_q=cfg.tile_q, block_k=cfg.tile_k)
    return attention_xla(q, k, v, causal=causal, window=window, scale=scale,
                         q_offset=q_offset, block_k=cfg.tile_k)


# ---------------------------------------------------------------------------
# attention against a KV cache (serving)
# ---------------------------------------------------------------------------


def _dense_masked(q, k, v, ok, scale):
    """Dense oracle: softmax over keys where ``ok`` (broadcast to
    (B, H, Sq, Skv)); a row with no visible key is NaN, as in JAX."""
    H = q.shape[2]
    k = _broadcast_kv(k, H)
    v = _broadcast_kv(v, H)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32) * scale,
                     k.to(torch.float32))
    s = s.masked_fill(~ok, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
    return out.to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *, scale=None,
                     cfg: FamousConfig = FamousConfig()):
    """One-token attention against a KV cache (serving decode step).

    q: (B, 1, H, dh); caches: (B, S_max, KV, dh); cache_len: (B,) int —
    number of valid cache entries (the new token's k/v already written)."""
    dh = q.shape[-1]
    Smax = k_cache.shape[1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(dh)
    if cfg.impl == "pallas":
        from repro_torch.kernels.decode import ops as dec_ops
        return dec_ops.decode_attention(q, k_cache, v_cache, cache_len,
                                        scale=scale)
    pos = torch.arange(Smax, device=q.device)[None, :]
    ok = pos < cache_len.to(q.device)[:, None]                # (B, Smax)
    return _dense_masked(q, k_cache, v_cache, ok[:, None, None, :], scale)


def chunked_prefill_attention(q, k_cache, v_cache, q_offset: int, *,
                              scale=None, cfg: FamousConfig = FamousConfig()):
    """Chunked-prefill attention: a chunk of C query tokens at absolute
    positions ``[q_offset, q_offset + C)`` attends causally to the resident
    prefix plus its own chunk, both already written into the cache.

    q: (B, C, H, dh); caches: (B, S_max, KV, dh); ``q_offset`` a host
    integer — one kernel build serves every offset."""
    C, dh = q.shape[1], q.shape[-1]
    Skv = k_cache.shape[1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(dh)
    if cfg.impl == "pallas":
        from repro_torch.kernels.decode import ops as dec_ops
        return dec_ops.chunk_prefill_attention(q, k_cache, v_cache, q_offset,
                                               scale=scale)
    q_pos = q_offset + torch.arange(C, device=q.device)
    ok = torch.arange(Skv, device=q.device)[None, :] <= q_pos[:, None]
    return _dense_masked(q, k_cache, v_cache, ok[None, None], scale)


# ---------------------------------------------------------------------------
# Full MHA layer (projection + attention + output) — the paper's fig. 3 box.
# ---------------------------------------------------------------------------


def mha_block(x, params, *, num_heads, num_kv_heads, causal=True, window=0,
              qk_norm_fn=None, cfg: FamousConfig = FamousConfig(),
              rope_fn=None, q_offset=0):
    """x: (B, S, D).  params: dict with wq/wk/wv (D, H, dh), optional b*,
    wo (H, dh, D).  Returns (B, S, D)."""
    del num_heads, num_kv_heads  # read off the weights' shapes
    q, k, v = qkv_projection(
        x, params["wq"], params["wk"], params["wv"],
        params.get("bq"), params.get("bk"), params.get("bv"), cfg=cfg)
    if qk_norm_fn is not None:
        q, k = qk_norm_fn(q, k)
    if rope_fn is not None:
        q, k = rope_fn(q, k)
    out = attention(q, k, v, causal=causal, window=window, q_offset=q_offset,
                    cfg=cfg)
    return torch.einsum("bshe,hed->bsd", out, params["wo"].to(out.dtype))
