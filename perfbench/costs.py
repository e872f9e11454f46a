"""The yardstick's arithmetic: the H100's peaks, and the operations and
bytes that a kernel's or a step's inputs need, worked out from shapes.

The peaks are NVIDIA's data sheet for the H100 SXM (dense rates), the
figures ``repro_torch.core.analytical.H100`` uses: 989 TFLOP/s in bf16
and 3.35 TB/s of HBM bandwidth, at the full 700 W.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def block_params(m: dict) -> int:
    """Weights one token multiplies in one layer: the q, k, v and output
    projections and the FFN, an expert layer's ``experts_per_token``
    experts and its router."""
    D, H, KV, dh, F = (m["d_model"], m["num_heads"], m["num_kv_heads"],
                       m["head_dim"], m["d_ff"])
    attn = D * (H + 2 * KV) * dh + H * dh * D
    if m["num_experts"]:
        return attn + m["experts_per_token"] * 3 * D * F + D * m["num_experts"]
    return attn + 3 * D * F


def token_flops(m: dict, context: int, head: bool) -> float:
    """Model FLOPs of one real token that attends over ``context`` keys:
    2 x the weights it multiplies (the LM head where ``head``: decode
    computes logits, a prefill chunk does not) plus attention's
    4 x context x heads x head_dim, in every layer."""
    L = m["num_layers"]
    w = L * block_params(m) + (m["d_model"] * m["vocab_size"] if head else 0)
    return 2.0 * w + 4.0 * context * m["num_heads"] * m["head_dim"] * L


def chunk_flops(m: dict, start: int, n: int) -> float:
    """A prefill chunk's ``n`` real tokens at positions start.. (pads not
    counted); token i attends over start + i + 1 keys."""
    ctx = n * start + n * (n + 1) // 2
    return token_flops(m, 0, False) * n + \
        4.0 * ctx * m["num_heads"] * m["head_dim"] * m["num_layers"]


def decode_flops(m: dict, cache_lens) -> float:
    """A decode step's tokens, one a decoding slot at ``cache_len``: each
    attends over cache_len + 1 keys."""
    return sum(token_flops(m, int(c) + 1, True) for c in cache_lens)


def decode_attention_bytes(m: dict, cache_lens, elem: int = 2) -> float:
    """What one decode step's ``decode_attention`` calls need, over every
    layer: each decoding slot's q and output row, and its K and V rows
    up to and including its new one (cache_len + 1), each read once."""
    H, KV, dh = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    n = len(cache_lens)
    kv = sum(int(c) + 1 for c in cache_lens)
    return float(m["num_layers"] * elem * (2 * n * H * dh + 2 * kv * KV * dh))
