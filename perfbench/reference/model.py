"""The default model module: the benchmark's definition of a
configuration whose file names no ``"reference"`` (``perfbench/reference/
__init__.py`` says what a model module defines).  It holds the layout
that ``perfbench/weights.py`` draws, the plain reference that decides
``correct``, and the operations and bytes the per-layer readers count.

The reference is the configuration's decoder in float32 PyTorch, with
TF32 off, no kernels, no cache layout of the program's and no batching of
its own.  It imports nothing of the program; it reads the spec tree that
the benchmark drew and the sizes of the configuration file, and upcasts
one layer's weights at a time.

The model, as the configuration states it: token embedding; per layer
``x += attn(rms(x) * ln1)`` then ``x += ffn(rms(x) * ln2)``; ``rms(x) =
x / sqrt(mean(x^2) + eps)``; attention with rotary positions (half split,
``theta ** (-i / half)``) on q and k, causal softmax of ``q k / sqrt(dh)``,
each query head reading kv head ``head // (H / KV)``; a gated FFN
``act(h W_gate) * (h W_in) W_out`` with ``act`` SiLU or tanh-GELU, or,
with experts, token-choice top-k routing (below); a final norm and the LM
head.

Routing (GShard capacity, as the configuration states it): the router's
logits ``h R`` in float32, soft-capped ``c tanh(l / c)`` where a cap is
given; each token's top-k experts weighted by the softmax of its top-k
capped logits; tokens routed in groups of ``S`` (the largest divisor of
the batch's tokens not above 256), each expert taking at most ``C =
min(max(4, ceil(f S k / E)), S)`` tokens of a group, first choices before
second choices, earlier tokens first; a token's choice past capacity
adds nothing.  Which tokens share a group is the batch the program ran,
so :func:`replay` runs the program's steps in order (chunks of one slot,
decode steps over every slot row, pads and idle rows included).

``quant="fp8"`` is the control: every matrix product's operands rounded
to float8 e4m3 (per-row scales for activations, per-column for weights),
accumulated in float32; the router stays float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference import check
from perfbench.weights import leaf as _leaf

BLOCK = "blocks/pos0/"
FP8_MAX = 448.0
# the model keys of a configuration file that the port's ModelConfig
# names otherwise, and those it does not take (the rest have the same
# name)
PORT_NAMES = {"router_softcap": "logit_softcap"}
NOT_PORT = ("norm_eps", "context_length")


def layout(m: dict) -> dict:
    """``{path: (shape, contracting width or None, kind)}`` of the spec
    tree of model sizes ``m`` (a configuration file's ``model``), in the
    order ``weights.make`` draws them; kind is ``"w"`` (a matrix),
    ``"scale"`` (a norm scale), ``"embed"`` or ``"router"``."""
    L, D, V = m["num_layers"], m["d_model"], m["vocab_size"]
    H, KV, dh, F = m["num_heads"], m["num_kv_heads"], m["head_dim"], m["d_ff"]
    E = m["num_experts"]
    out = {"embed/embedding": ((V, D), None, "embed"),
           BLOCK + "ln1/scale": ((L, D), None, "scale"),
           BLOCK + "attn/wq": ((L, D, H, dh), D, "w"),
           BLOCK + "attn/wk": ((L, D, KV, dh), D, "w"),
           BLOCK + "attn/wv": ((L, D, KV, dh), D, "w"),
           BLOCK + "attn/wo": ((L, H, dh, D), H * dh, "w"),
           BLOCK + "ln2/scale": ((L, D), None, "scale")}
    if E:
        out.update({BLOCK + "ffn/router": ((L, D, E), D, "router"),
                    BLOCK + "ffn/w_in": ((L, E, D, F), D, "w"),
                    BLOCK + "ffn/w_gate": ((L, E, D, F), D, "w"),
                    BLOCK + "ffn/w_out": ((L, E, F, D), F, "w")})
    else:
        out.update({BLOCK + "ffn/w_in": ((L, D, F), D, "w"),
                    BLOCK + "ffn/w_gate": ((L, D, F), D, "w"),
                    BLOCK + "ffn/w_out": ((L, F, D), F, "w")})
    out["final_norm/scale"] = ((D,), None, "scale")
    out["lm_head/w"] = ((D, V), D, "w")
    return out


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    s = amax / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Reference:
    def __init__(self, tree: dict, m: dict, quant: str | None = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"quant {quant!r}")
        self.t, self.m, self.quant = tree, m, quant
        self.H, self.KV, self.dh = m["num_heads"], m["num_kv_heads"], \
            m["head_dim"]
        self.eps = float(m["norm_eps"])
        self.act = {"silu": F.silu,
                    "gelu": lambda x: F.gelu(x, approximate="tanh")}[m["act"]]
        self.drops = 0          # token choices past capacity (replay)

    # -- pieces ---------------------------------------------------------------
    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.quant == "fp8":
            a, w = _fp8(a, -1), _fp8(w, 0)
        return a @ w

    def bmm(self, eq: str, a: torch.Tensor, b: torch.Tensor, da: int,
            db: int) -> torch.Tensor:
        if self.quant == "fp8":
            a, b = _fp8(a, da), _fp8(b, db)
        return torch.einsum(eq, a, b)

    def rms(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) \
            * scale

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x (..., n, heads, dh) at positions pos (..., n)."""
        half = self.dh // 2
        freq = float(self.m["rope_theta"]) ** (
            -torch.arange(half, dtype=torch.float32, device=x.device) / half)
        ang = pos.to(torch.float32)[..., None] * freq
        sin, cos = ang.sin()[..., None, :], ang.cos()[..., None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def layer(self, i: int) -> dict:
        """Layer ``i``'s weights in float32; expert stacks stay as drawn
        and are upcast one expert at a time."""
        t, D = self.t, self.m["d_model"]
        w = {n: _leaf(t, BLOCK + n)[i].float()
             for n in ("ln1/scale", "ln2/scale")}
        for n in ("wq", "wk", "wv"):
            w[n] = _leaf(t, BLOCK + "attn/" + n)[i].float().reshape(D, -1)
        w["wo"] = _leaf(t, BLOCK + "attn/wo")[i].float().reshape(-1, D)
        for n in ("w_in", "w_gate", "w_out"):
            leaf = _leaf(t, BLOCK + "ffn/" + n)[i]
            w[n] = leaf if self.m["num_experts"] else leaf.float()
        if self.m["num_experts"]:
            w["router"] = _leaf(t, BLOCK + "ffn/router")[i].float()
        return w

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return _leaf(self.t, "embed/embedding")[tokens].float()

    def qkv(self, w: dict, x: torch.Tensor, pos: torch.Tensor):
        """q, k, v (..., n, heads, dh) of residual rows x (..., n, D)."""
        h = self.rms(x, w["ln1/scale"])
        sh = h.shape[:-1]
        q = self.mm(h, w["wq"]).reshape(*sh, self.H, self.dh)
        k = self.mm(h, w["wk"]).reshape(*sh, self.KV, self.dh)
        v = self.mm(h, w["wv"]).reshape(*sh, self.KV, self.dh)
        return self.rope(q, pos), self.rope(k, pos), v

    def attend(self, q, K, V, valid) -> torch.Tensor:
        """q (b, n, H, dh) over keys K, V (b, m, KV, dh); row (b, n) sees
        keys ``[0, valid[b, n])``.  Returns (b, n, H * dh)."""
        b, n = q.shape[:2]
        g = self.H // self.KV
        qg = q.reshape(b, n, self.KV, g, self.dh)
        s = self.bmm("bnkgd,bmkd->bkgnm", qg, K, -1, -1) \
            / math.sqrt(self.dh)
        keys = torch.arange(K.shape[1], device=q.device)
        s = s.masked_fill(keys >= valid[:, None, None, :, None],
                          float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = self.bmm("bkgnm,bmkd->bnkgd", p, V, -1, 1)
        return o.reshape(b, n, self.H * self.dh)

    def ffn_dense(self, w: dict, h: torch.Tensor) -> torch.Tensor:
        return self.mm(self.act(self.mm(h, w["w_gate"])) * self.mm(h, w["w_in"]),
                       w["w_out"])

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        head = _leaf(self.t, "lm_head/w").float()
        return self.mm(self.rms(x, _leaf(self.t, "final_norm/scale").float()),
                       head)

    # -- routing --------------------------------------------------------------
    @staticmethod
    def group_size(T: int, target: int = 256) -> int:
        s = min(target, T)
        while T % s:
            s -= 1
        return s

    def route(self, h: torch.Tensor, router: torch.Tensor, group: int):
        """Routing of rows h (T, D) in consecutive groups of ``group``
        rows: (row index, expert, weight) of every kept choice."""
        m = self.m
        E, K = m["num_experts"], m["experts_per_token"]
        T = h.shape[0]
        lg = h @ router
        cap = float(m["router_softcap"])
        if cap:
            lg = cap * torch.tanh(lg / cap)
        topv, topi = lg.topk(K, dim=-1)
        wts = torch.softmax(topv, dim=-1)
        S = self.group_size(group)
        G = T // S
        C = min(max(4, math.ceil(m["capacity_factor"] * S * K / E)), S)
        taken = torch.zeros(G, 1, E, dtype=torch.int64, device=h.device)
        rows, experts, weights = [], [], []
        for k in range(K):
            oh = F.one_hot(topi[:, k], E).reshape(G, S, E)
            pos = taken + oh.cumsum(1) - oh
            kept = ((pos < C) & (oh > 0)).any(-1).reshape(T)
            self.drops += int(T - kept.sum())
            idx = kept.nonzero()[:, 0]
            rows.append(idx)
            experts.append(topi[idx, k])
            weights.append(wts[idx, k])
            taken = taken + oh.sum(1, keepdim=True)
        return torch.cat(rows), torch.cat(experts), torch.cat(weights)

    def ffn_moe(self, w: dict, h: torch.Tensor, group: int,
                block: int = 8192) -> torch.Tensor:
        rows, experts, weights = self.route(h, w["router"], group)
        y = torch.zeros_like(h)
        for e in range(self.m["num_experts"]):
            sel = experts == e
            r, wt = rows[sel], weights[sel]
            if not len(r):
                continue
            we = {n: w[n][e].float() for n in ("w_in", "w_gate", "w_out")}
            for a in range(0, len(r), block):
                rr = r[a:a + block]
                y.index_add_(0, rr, wt[a:a + block, None]
                             * self.ffn_dense(we, h[rr]))
            del we
        return y


def sequence_logits(ref: Reference, seqs: list[torch.Tensor],
                    first: list[int], qblock: int = 1024) -> list:
    """Each sequence ``seqs[i]`` (int64 tokens on the device) whole, one
    request at a time, causal; returns the float32 logits of positions
    ``first[i]`` to the end.  For models without experts, whose requests
    share nothing."""
    if ref.m["num_experts"]:
        raise ValueError("an expert model's routing groups span requests: "
                         "use replay()")
    xs = [ref.embed(s) for s in seqs]
    for i in range(ref.m["num_layers"]):
        w = ref.layer(i)
        for j, x in enumerate(xs):
            pos = torch.arange(x.shape[0], device=x.device)
            q, k, v = ref.qkv(w, x, pos)
            a = torch.empty_like(x)
            for s0 in range(0, x.shape[0], qblock):
                s1 = min(s0 + qblock, x.shape[0])
                a[s0:s1] = ref.attend(q[None, s0:s1], k[None, :s1],
                                      v[None, :s1], pos[None, s0:s1] + 1)[0]
            x = x + ref.mm(a, w["wo"])
            xs[j] = x + ref.ffn_dense(w, ref.rms(x, w["ln2/scale"]))
        del w
    return [ref.logits(x[f:]) for x, f in zip(xs, first)]


def replay(ref: Reference, steps: list, n_slots: int, max_seq: int,
           scored: list, device, row_block: int = 16384) -> torch.Tensor:
    """The program's steps again, in order, one layer at a time.

    ``steps``: dicts in execution order, ``{"kind": "chunk", "slot",
    "start", "tokens"}`` (the chunk's tokens, pads included, at positions
    start..start + len - 1 of the slot) or ``{"kind": "decode",
    "tokens", "cache_len"}`` (one row a slot: its token at position
    cache_len[s], written to row min(cache_len[s], max_seq - 1) of the
    slot and attending over cache_len[s] + 1 rows).  ``scored``: (step
    index, row) pairs whose logits are returned, in that order."""
    if not ref.m["num_experts"]:
        raise ValueError("a model without experts shares nothing between "
                         "requests: use sequence_logits()")
    rows_of, tok, pos, n = [], [], [], 0
    for st in steps:
        t = torch.as_tensor(st["tokens"], dtype=torch.int64)
        if st["kind"] == "chunk":
            p = st["start"] + torch.arange(len(t))
        else:
            p = torch.as_tensor(st["cache_len"], dtype=torch.int64)
        rows_of.append((n, n + len(t)))
        tok.append(t)
        pos.append(p)
        n += len(t)
    tok = torch.cat(tok).to(device)
    pos = torch.cat(pos).to(device)
    X = torch.empty(n, ref.m["d_model"], dtype=torch.float32, device=device)
    for a in range(0, n, row_block):
        X[a:a + row_block] = ref.embed(tok[a:a + row_block])
    KV, dh = ref.KV, ref.dh
    slot_rows = torch.arange(n_slots, device=device)
    for i in range(ref.m["num_layers"]):
        w = ref.layer(i)
        Kc = torch.zeros(n_slots, max_seq, KV, dh, device=device)
        Vc = torch.zeros_like(Kc)
        for st, (r0, r1) in zip(steps, rows_of):
            x = X[r0:r1]
            q, k, v = ref.qkv(w, x, pos[r0:r1])
            if st["kind"] == "chunk":
                s, p0 = st["slot"], st["start"]
                Kc[s, p0:p0 + len(x)] = k
                Vc[s, p0:p0 + len(x)] = v
                top = p0 + len(x)
                a = ref.attend(q[None], Kc[s:s + 1, :top], Vc[s:s + 1, :top],
                               pos[None, r0:r1] + 1)[0]
            else:
                cl = pos[r0:r1]
                at = cl.clamp(max=max_seq - 1)
                Kc[slot_rows, at] = k
                Vc[slot_rows, at] = v
                top = int(cl.max()) + 1
                a = ref.attend(q[:, None], Kc[:, :top], Vc[:, :top],
                               (cl + 1)[:, None])[:, 0]
            X[r0:r1] = x + ref.mm(a, w["wo"])
        del Kc, Vc
        # the FFN: each step's rows routed as one batch, chunks and decode
        # steps apart (their batch sizes differ)
        for kind in ("chunk", "decode"):
            idx = [torch.arange(r0, r1) for st, (r0, r1)
                   in zip(steps, rows_of) if st["kind"] == kind]
            if not idx:
                continue
            group = len(idx[0])
            idx = torch.cat(idx).to(device)
            for a in range(0, len(idx), row_block // group * group):
                ii = idx[a:a + row_block // group * group]
                X[ii] += ref.ffn_moe(w, ref.rms(X[ii], w["ln2/scale"]), group)
        del w
    idx = torch.tensor([rows_of[s][0] + r for s, r in scored],
                       dtype=torch.int64, device=device)
    return ref.logits(X[idx])


def logits_for(ref: Reference, engine: dict, log: list, requests: dict,
               rids: list[int], device):
    """The reference's logits at every served position of ``rids``, and
    the served tokens there, in one order: a model without experts one
    request at a time (:func:`sequence_logits`), an expert model by
    running the program's steps again (:func:`replay`), from the engine's
    first step to the last step of a sampled request."""
    if not ref.m["num_experts"]:
        seqs, first, served = check.sequences(requests, rids, device)
        return torch.cat(sequence_logits(ref, seqs, first)), served
    steps, scored, served = check.steps_to(log, requests, rids, device)
    return replay(ref, steps, engine["slots"], engine["max_seq"], scored,
                  device), served


# -- operations and bytes, read by perfbench/readers.py -----------------------
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
