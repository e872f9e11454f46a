"""Kimi-K2-Instruct's model module (DeepSeek-V3's block): the layout that
``perfbench/weights.py`` draws, the plain reference that decides
``correct``, and the operations and bytes the per-layer readers count
(``perfbench/reference/__init__.py`` says what a model module defines).
It is also the repository's plain reference of the architecture: the CPU
tests of the port hold it against the port at a small size.

The configuration's ``model`` holds the release's ``config.json`` keys
(with the cuts its file lists in ``reduced``), plus ``router_experts``
(the router's width, the release's ``n_routed_experts``, where
``n_routed_experts`` gives the experts held here) and ``expert_lo`` (the
first of them).

The reference is float32 PyTorch with TF32 off, no kernels, no cache and
no batching: one request at a time, its whole sequence, attention in
blocks of query rows (so that a 17k-token sequence fits), one layer's
weights upcast at a time.  It imports nothing of the program.

The model, from DeepSeek-V3's ``modeling_deepseek.py``
(``DeepseekV3Attention``, ``DeepseekV3MoE``, ``MoEGate``):

- ``x = embed(tokens)``; per layer ``x += attn(rms(x) * ln1)`` then ``x +=
  ffn(rms(x) * ln2)``; ``rms(x) = x / sqrt(mean(x^2) + rms_norm_eps)``;
  final norm and the LM head.
- Latent attention: ``q = rms(x W_qa) * q_a_norm W_qb`` per head [q_nope
  (qk_nope_head_dim) | q_rope (qk_rope_head_dim)]; ``[c | k_rope] = x
  W_kva``, ``c = rms(c) * kv_a_norm``; per head ``[k_nope | v] = c W_kvb``;
  K = [k_nope | k_rope] with one k_rope every head shares; q_rope and
  k_rope rotated; causal softmax of ``q.K * scale``, ``scale =
  (nope + rope)^-0.5 * mscale(factor, mscale_all_dim)^2``; the heads'
  ``P V`` through ``W_o``.
- Rotary dims: YaRN (``yarn_find_correction_range`` over beta_fast and
  beta_slow, a linear ramp between the interpolated ``1 / (factor
  theta^(2i/d))`` and the extrapolated ``1 / theta^(2i/d)`` frequencies,
  cos and sin times ``mscale(factor, mscale) / mscale(factor,
  mscale_all_dim)``).  Departure, as the program: the release rotates
  interleaved pairs of the rope dims and this reference rotates halves,
  which is the same model with those weight columns permuted (the random
  weights have no order to keep).
- FFN: layers before ``first_k_dense_replace`` a SwiGLU of width
  ``intermediate_size``; the others ``noaux_tc`` routing with one group:
  scores ``sigmoid(h R)`` in f32, each token's top-k by score plus the
  correction bias, weights the chosen scores normalised to sum 1 times
  ``routed_scaling_factor``; each chosen expert a SwiGLU of width
  ``moe_intermediate_size``; plus ``n_shared_experts`` shared SwiGLU
  experts of that width (one of ``n_shared * width``) on every token.
  Every token is routed: nothing is dropped (``drops`` stays 0).
- The expert share: the router keeps its ``router_experts`` outputs, and
  only the held experts [expert_lo, expert_lo + n_routed_experts) add
  their part, as on the chip of the deployment; ``held`` counts the real
  choices that land on them.

``quant="fp8"`` is the control: every matrix product's operands rounded
to float8 e4m3 (per-row scales for activations, per-column for weights),
accumulated in float32; the router stays float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference import check
from perfbench.reference.model import _fp8
from perfbench.weights import leaf as _leaf

STACK = "blocks/pos0/"
# the correction bias's draw: N(0, 1) / sqrt(BIAS_FAN_IN), standard
# deviation 0.05 against sigmoid scores of spread about 0.2
BIAS_FAN_IN = 400
# the model keys the port's ModelConfig names otherwise, and those it does
# not take (the rest have the same name)
PORT_NAMES = {"num_hidden_layers": "num_layers", "hidden_size": "d_model",
              "num_attention_heads": "num_heads",
              "num_key_value_heads": "num_kv_heads",
              "intermediate_size": "dense_d_ff",
              "moe_intermediate_size": "d_ff",
              "first_k_dense_replace": "first_dense_layers",
              "n_shared_experts": "shared_experts",
              "num_experts_per_tok": "experts_per_token",
              "n_routed_experts": "experts_held",
              "router_experts": "num_experts",
              "hidden_act": "act", "tie_word_embeddings": "tie_embeddings"}
NOT_PORT = ("max_position_embeddings", "model_type", "moe_layer_freq",
            "n_group", "topk_group", "num_nextn_predict_layers", "seq_aux",
            "rms_norm_eps", "rope_scaling", "norm_topk_prob", "topk_method")


def _sizes(m: dict) -> dict:
    return {"L": m["num_hidden_layers"], "D": m["hidden_size"],
            "V": m["vocab_size"], "H": m["num_attention_heads"],
            "qr": m["q_lora_rank"], "kr": m["kv_lora_rank"],
            "nope": m["qk_nope_head_dim"], "rope": m["qk_rope_head_dim"],
            "dv": m["v_head_dim"], "Fd": m["intermediate_size"],
            "F": m["moe_intermediate_size"], "E": m["router_experts"],
            "Eh": m["n_routed_experts"], "K": m["num_experts_per_tok"],
            "Fs": m["n_shared_experts"] * m["moe_intermediate_size"],
            "lead": m["first_k_dense_replace"]}


def _attn_layout(pre: str, lead: tuple, z: dict) -> dict:
    D, H, qr, kr = z["D"], z["H"], z["qr"], z["kr"]
    dq = z["nope"] + z["rope"]
    return {pre + "attn/wq_a": (lead + (D, qr), D, "w"),
            pre + "attn/q_a_norm": (lead + (qr,), None, "scale"),
            pre + "attn/wq_b": (lead + (qr, H, dq), qr, "w"),
            pre + "attn/wkv_a": (lead + (D, kr + z["rope"]), D, "w"),
            pre + "attn/kv_a_norm": (lead + (kr,), None, "scale"),
            pre + "attn/wkv_b": (lead + (kr, H, z["nope"] + z["dv"]), kr, "w"),
            pre + "attn/wo": (lead + (H, z["dv"], D), H * z["dv"], "w")}


def _mlp_layout(pre: str, lead: tuple, D: int, F: int) -> dict:
    return {pre + "w_in": (lead + (D, F), D, "w"),
            pre + "w_gate": (lead + (D, F), D, "w"),
            pre + "w_out": (lead + (F, D), F, "w")}


def layout(m: dict) -> dict:
    """``{path: (shape, contracting width or None, kind)}`` of the port's
    spec tree for sizes ``m``, in draw order: the embedding, each leading
    dense layer ``lead<i>``, the stacked MoE layers ``blocks/pos0`` (their
    held experts, the router, its correction bias and the shared expert),
    the final norm and the LM head."""
    z = _sizes(m)
    D, n = z["D"], z["L"] - z["lead"]
    out = {"embed/embedding": ((z["V"], D), None, "embed")}
    for i in range(z["lead"]):
        pre = f"lead{i}/"
        out[pre + "ln1/scale"] = ((D,), None, "scale")
        out.update(_attn_layout(pre, (), z))
        out[pre + "ln2/scale"] = ((D,), None, "scale")
        out.update(_mlp_layout(pre + "ffn/", (), D, z["Fd"]))
    out[STACK + "ln1/scale"] = ((n, D), None, "scale")
    out.update(_attn_layout(STACK, (n,), z))
    out[STACK + "ln2/scale"] = ((n, D), None, "scale")
    out[STACK + "ffn/router"] = ((n, D, z["E"]), D, "router")
    out.update({STACK + "ffn/w_in": ((n, z["Eh"], D, z["F"]), D, "w"),
                STACK + "ffn/w_gate": ((n, z["Eh"], D, z["F"]), D, "w"),
                STACK + "ffn/w_out": ((n, z["Eh"], z["F"], D), z["F"], "w")})
    out[STACK + "ffn/router_bias"] = ((n, z["E"]), BIAS_FAN_IN, "router")
    if z["Fs"]:
        out.update(_mlp_layout(STACK + "ffn/shared/", (n,), D, z["Fs"]))
    out["final_norm/scale"] = ((D,), None, "scale")
    out["lm_head/w"] = ((D, z["V"]), D, "w")
    return out


def _mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def rope_tables(m: dict, device):
    """The rotary dims' inverse frequencies and the cos/sin scale
    (DeepseekV3YarnRotaryEmbedding; plain rope without ``rope_scaling``)."""
    dim, base = m["qk_rope_head_dim"], float(m["rope_theta"])
    expo = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / base ** expo
    rs = m.get("rope_scaling")
    if not rs:
        return extra, 1.0
    f, orig = float(rs["factor"]), rs["original_max_position_embeddings"]

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp
    inv = (1.0 / (f * base ** expo)) * (1 - keep) + extra * keep
    return inv, _mscale(f, rs["mscale"]) / _mscale(f, rs["mscale_all_dim"])


def softmax_scale(m: dict) -> float:
    s = (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]) ** -0.5
    rs = m.get("rope_scaling")
    if rs and rs.get("mscale_all_dim"):
        s *= _mscale(float(rs["factor"]), rs["mscale_all_dim"]) ** 2
    return s


class Reference:
    def __init__(self, tree: dict, m: dict, quant: str | None = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"quant {quant!r}")
        self.t, self.m, self.quant = tree, m, quant
        self.z = _sizes(m)
        self.eps = float(m["rms_norm_eps"])
        self.drops = 0          # nothing is dropped: every token is routed
        self.held = 0           # real choices on the held experts

    # -- pieces ---------------------------------------------------------------
    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.quant == "fp8":
            a, w = _fp8(a, -1), _fp8(w, 0)
        return a @ w

    def rms(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) \
            * scale

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x (n, [heads,] rope) at positions pos (n,): halves rotated."""
        inv, msc = rope_tables(self.m, x.device)
        ang = pos.to(torch.float32)[:, None] * inv
        if x.ndim == 3:
            ang = ang[:, None, :]
        cos, sin = ang.cos() * msc, ang.sin() * msc
        half = x.shape[-1] // 2
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def layer(self, i: int) -> dict:
        """Layer ``i``'s weights in float32 (expert stacks as drawn, upcast
        one expert at a time)."""
        z = self.z
        if i < z["lead"]:
            pre, j = f"lead{i}/", None
        else:
            pre, j = STACK, i - z["lead"]

        def get(name):
            x = _leaf(self.t, pre + name)
            return x if j is None else x[j]

        w = {n: get(n).float() for n in (
            "ln1/scale", "ln2/scale", "attn/wq_a", "attn/q_a_norm",
            "attn/wq_b", "attn/wkv_a", "attn/kv_a_norm", "attn/wkv_b",
            "attn/wo")}
        if j is None:
            for n in ("w_in", "w_gate", "w_out"):
                w["ffn/" + n] = get("ffn/" + n).float()
        else:
            w["ffn/router"] = get("ffn/router").float()
            w["ffn/router_bias"] = get("ffn/router_bias").float()
            for n in ("w_in", "w_gate", "w_out"):
                w["ffn/" + n] = get("ffn/" + n)          # (Eh, ...) as drawn
            if z["Fs"]:
                for n in ("w_in", "w_gate", "w_out"):
                    w["ffn/shared/" + n] = get("ffn/shared/" + n).float()
        return w

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return _leaf(self.t, "embed/embedding")[tokens].float()

    def attn(self, w: dict, x: torch.Tensor, qblock: int = 256):
        """Causal latent attention over one sequence x (n, D), in blocks
        of ``qblock`` query rows.  Returns (n, D)."""
        z, n = self.z, x.shape[0]
        H, nope, kr = z["H"], z["nope"], z["kr"]
        pos = torch.arange(n, device=x.device)
        h = self.rms(x, w["ln1/scale"])
        qa = self.rms(self.mm(h, w["attn/wq_a"]), w["attn/q_a_norm"])
        q = self.mm(qa, w["attn/wq_b"].reshape(z["qr"], -1)).reshape(n, H, -1)
        q = torch.cat([q[..., :nope], self.rope(q[..., nope:], pos)], -1)
        kv = self.mm(h, w["attn/wkv_a"])
        c = self.rms(kv[:, :kr], w["attn/kv_a_norm"])
        k_rope = self.rope(kv[:, kr:], pos)
        kvb = self.mm(c, w["attn/wkv_b"].reshape(kr, -1)).reshape(n, H, -1)
        k = torch.cat([kvb[..., :nope],
                       k_rope[:, None, :].expand(n, H, -1)], -1)
        v = kvb[..., nope:]
        scale = softmax_scale(self.m)
        out = torch.empty(n, H, z["dv"], device=x.device)
        keys = torch.arange(n, device=x.device)
        for s0 in range(0, n, qblock):
            s1 = min(s0 + qblock, n)
            qq = q[s0:s1]
            if self.quant == "fp8":
                qq, kk = _fp8(qq, -1), _fp8(k[:s1], -1)
            else:
                kk = k[:s1]
            s = torch.einsum("qhd,khd->hqk", qq, kk) * scale
            s = s.masked_fill(keys[None, None, :s1] > pos[None, s0:s1, None],
                              float("-inf"))
            p = torch.softmax(s, dim=-1)
            vv = v[:s1]
            if self.quant == "fp8":
                p, vv = _fp8(p, -1), _fp8(vv, 0)
            out[s0:s1] = torch.einsum("hqk,khd->qhd", p, vv)
        return self.mm(out.reshape(n, -1), w["attn/wo"].reshape(-1, z["D"]))

    @staticmethod
    def _swiglu(ref, h, w_in, w_gate, w_out):
        return ref.mm(F.silu(ref.mm(h, w_gate)) * ref.mm(h, w_in), w_out)

    def route(self, h: torch.Tensor, w: dict):
        """(row, expert, weight) of every choice of rows h (n, D) that lands
        on a held expert; ``held`` counts them."""
        z = self.z
        scores = torch.sigmoid(h @ w["ffn/router"])
        topi = (scores + w["ffn/router_bias"]).topk(z["K"], dim=-1).indices
        wts = scores.gather(-1, topi)
        wts = wts / (wts.sum(-1, keepdim=True) + 1e-20) \
            * float(self.m["routed_scaling_factor"])
        lo = self.m.get("expert_lo", 0)
        on = (topi >= lo) & (topi < lo + z["Eh"])
        self.held += int(on.sum())
        rows, k = on.nonzero(as_tuple=True)
        return rows, topi[rows, k] - lo, wts[rows, k]

    def ffn(self, w: dict, x: torch.Tensor, moe: bool) -> torch.Tensor:
        h = self.rms(x, w["ln2/scale"])
        if not moe:
            return self._swiglu(self, h, w["ffn/w_in"], w["ffn/w_gate"],
                                w["ffn/w_out"])
        y = torch.zeros_like(h)
        rows, experts, wts = self.route(h, w)
        for e in range(self.z["Eh"]):
            sel = experts == e
            if not bool(sel.any()):
                continue
            r = rows[sel]
            we = [w["ffn/" + n][e].float() for n in ("w_in", "w_gate",
                                                      "w_out")]
            y.index_add_(0, r, wts[sel, None] * self._swiglu(self, h[r], *we))
        if self.z["Fs"]:
            y = y + self._swiglu(self, h, w["ffn/shared/w_in"],
                                 w["ffn/shared/w_gate"],
                                 w["ffn/shared/w_out"])
        return y

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Final hidden states (n, D) of one sequence."""
        x = self.embed(tokens)
        for i in range(self.z["L"]):
            w = self.layer(i)
            x = x + self.attn(w, x)
            x = x + self.ffn(w, x, moe=i >= self.z["lead"])
            del w
        return x

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        head = _leaf(self.t, "lm_head/w").float()
        return self.mm(self.rms(x, _leaf(self.t, "final_norm/scale").float()),
                       head)


def logits_for(ref: Reference, engine: dict, log: list, requests: dict,
               rids: list[int], device):
    """The reference's logits at every served position of ``rids`` and the
    served tokens there, one request at a time: the router routes every
    token on its own, so no request's result depends on what it shared a
    batch with, and the program's steps need no replay."""
    seqs, first, served = check.sequences(requests, rids, device)
    out = [ref.logits(ref.forward(s)[f:]) for s, f in zip(seqs, first)]
    return torch.cat(out), served


# -- operations and bytes, read by perfbench/readers.py -----------------------
def attn_params(m: dict) -> int:
    """Weights of one latent-attention layer: q_a, q_b, kv_a, kv_b, o."""
    z = _sizes(m)
    dq = z["nope"] + z["rope"]
    return (z["D"] * z["qr"] + z["qr"] * z["H"] * dq
            + z["D"] * (z["kr"] + z["rope"])
            + z["kr"] * z["H"] * (z["nope"] + z["dv"])
            + z["H"] * z["dv"] * z["D"])


def token_weights(m: dict) -> float:
    """Weights one token multiplies over the layers: attention everywhere,
    the dense FFN in the leading layers; in the MoE layers the router, the
    shared experts and the routed experts at the share of its k choices
    that lands on the held ones in expectation (k x held / router width):
    the model's work on this chip, not the dense worst case the program
    computes."""
    z = _sizes(m)
    D, n_moe = z["D"], z["L"] - z["lead"]
    dense = z["lead"] * 3 * D * z["Fd"]
    moe = n_moe * (D * z["E"] + 3 * D * z["Fs"]
                   + z["K"] * z["Eh"] / z["E"] * 3 * D * z["F"])
    return z["L"] * attn_params(m) + dense + moe


def _attn_flops_per_key(m: dict) -> float:
    """Scores over nope + rope dims and P V over v dims, every head, every
    layer (the published equations, 2 FLOP a multiply-add)."""
    z = _sizes(m)
    return 2.0 * z["H"] * (z["nope"] + z["rope"] + z["dv"]) * z["L"]


def token_flops(m: dict, context: int, head: bool) -> float:
    """Model FLOPs of one real token that attends over ``context`` keys:
    2 x :func:`token_weights` (plus the LM head where ``head``) and the
    attention over its context."""
    w = token_weights(m) + (m["hidden_size"] * m["vocab_size"] if head else 0)
    return 2.0 * w + _attn_flops_per_key(m) * context


def chunk_flops(m: dict, start: int, n: int) -> float:
    """A prefill chunk's ``n`` real tokens at positions start..; token i
    attends over start + i + 1 keys."""
    ctx = n * start + n * (n + 1) // 2
    return token_flops(m, 0, False) * n + _attn_flops_per_key(m) * ctx


def decode_flops(m: dict, cache_lens) -> float:
    return sum(token_flops(m, int(c) + 1, True) for c in cache_lens)


def decode_attention_bytes(m: dict, cache_lens, elem: int = 2) -> float:
    """What one decode step's ``mla_decode`` calls need, over every layer:
    each decoding slot's latent rows up to and including its new one
    (cache_len + 1 rows of kv_lora_rank + rope values), read once, and its
    absorbed query (heads x (kv_lora_rank + rope)) and latent output
    (heads x kv_lora_rank)."""
    z = _sizes(m)
    row = z["kr"] + z["rope"]
    n = len(cache_lens)
    keys = sum(int(c) + 1 for c in cache_lens)
    return float(z["L"] * elem * (keys * row + n * z["H"] * (row + z["kr"])))
