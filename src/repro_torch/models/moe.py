"""Token-choice top-k Mixture-of-Experts FFN (grok-1, kimi-k2): the port
of ``repro.models.moe``.

GShard-style *grouped dense dispatch*: tokens are split into G groups;
each group dispatches into a per-group expert buffer of capacity C via a
(G, S_g, E, C) one-hot einsum, and every product is a dense einsum (no
scatter, no gather, no shape taken from the data), so a serving step
holding it captures as one CUDA graph.  Capacity is bounded per group:
C = min(max(4, ceil(cf · S_g · K / E)), S_g).  Tokens beyond an expert's
capacity within their group are dropped (GShard semantics); priority is
earlier-rank choice first, then sequence order.

The arithmetic is JAX's, step for step: the softcap before both the
softmax and the top-k, per-choice priority by cumsum, a bf16 ``dispatch``
and an f32 ``combine`` cast to ``x.dtype``.  The JAX module's sharding
hints (``constrain``) and remat names (``checkpoint_name``) do nothing
without a mesh and are dropped; no Pallas kernel is involved there, and
the grouped products here are ``torch.einsum`` as JAX's are XLA einsums.

Expert parallelism (``transformer.shard_params`` and ``TrainLayout`` on a
"model" axis that divides E): a rank holds the experts ``tp_experts`` =
[lo, hi) of ``w_in`` / ``w_gate`` / ``w_out`` and the whole router.  It
routes every token over all E experts with the unsharded capacity, so
routing and drops are the unsharded layer's, then keeps its experts'
columns of ``dispatch`` and ``combine`` (Python int bounds: the shapes
stay fixed), multiplies only its experts, and the ranks' shares of the
output are summed over the "model" group (``tp_sum``).

DeepSeek-V3's routing (kimi-k2-instruct, ``cfg.scoring_func ==
"sigmoid"``, :func:`apply_moe_dropless`): scores ``sigmoid(x R)`` in f32,
the top-k by score plus the correction bias ``router_bias`` (``noaux_tc``;
the bias picks, it never weights), weights the chosen scores
normalised to sum 1 times ``routed_scaling_factor``; every token is
routed, nothing dropped.  The layer holds the routed experts
``cfg.experts_here`` = [lo, hi) of the router's E (one chip's share of an
expert-parallel deployment; all E by default) and computes only their
part: each held expert over every row, weighted by the row's weight on it
(0 where the row did not choose it).  With K held experts and every row
a group, that is the worst case of top-K over the held ones, a dense and
fixed shape with no (G, S, E, C) dispatch built.  ``shared`` SwiGLU
experts see every row and are added to the routed part.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models.module import ParamSpec


def moe_spec(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    lo, hi = cfg.experts_here
    spec = {
        # the router stays f32 whatever the model's dtype
        "router": ParamSpec((d, e), ("embed", None), scale=0.02,
                            dtype=torch.float32),
        "w_in": ParamSpec((hi - lo, d, f), ("experts", None, "expert_ff")),
        "w_gate": ParamSpec((hi - lo, d, f), ("experts", None, "expert_ff")),
        "w_out": ParamSpec((hi - lo, f, d), ("experts", "expert_ff", None)),
    }
    if cfg.scoring_func == "sigmoid":
        spec["router_bias"] = ParamSpec((e,), (None,), init="zeros",
                                        dtype=torch.float32)
    if cfg.shared_experts:
        spec["shared"] = layers.mlp_spec(d, cfg.shared_experts * f)
    return spec


def _group_shape(T: int, target_group: int = 256) -> tuple[int, int]:
    """Split T tokens into (G, S_g) with T = G*S_g and S_g ~ target."""
    sg = min(target_group, T)
    while T % sg:
        sg -= 1
    return T // sg, sg


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a zero row.  A
    comparison against ``arange``, so it never reads ``idx`` on the host."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def router_dispatch(logits: torch.Tensor, K: int, capacity_factor: float,
                    softcap: float = 0.0):
    """logits: (G, S, E) f32.  Returns (dispatch (G,S,E,C) bf16,
    combine (G,S,E,C) f32, aux load-balance loss (0-dim f32))."""
    G, S, E = logits.shape
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    C = max(4, int(-(-capacity_factor * S * K // E)))
    C = min(C, S)
    gates = torch.softmax(logits, dim=-1)                 # (G,S,E)
    topw, topi = torch.topk(logits, K, dim=-1)            # (G,S,K)
    topw = torch.softmax(topw, dim=-1)

    dev = logits.device
    running = torch.zeros((G, 1, E), dtype=torch.int32, device=dev)
    dispatch = torch.zeros((G, S, E, C), dtype=torch.bfloat16, device=dev)
    combine = torch.zeros((G, S, E, C), dtype=torch.float32, device=dev)
    for k in range(K):
        mask_k = _one_hot(topi[..., k], E, torch.int32)   # (G,S,E)
        pos_k = (running + torch.cumsum(mask_k, dim=1, dtype=torch.int32)
                 - mask_k)                                 # (G,S,E)
        keep = (pos_k < C) & (mask_k > 0)
        oh = _one_hot(torch.where(keep, pos_k, C), C + 1,
                      torch.bfloat16)[..., :C]             # (G,S,E,C)
        oh = oh * mask_k[..., None].to(torch.bfloat16)
        dispatch = dispatch + oh
        combine = combine + oh.to(torch.float32) * topw[..., k, None, None]
        running = running + torch.sum(mask_k, dim=1, keepdim=True,
                                      dtype=torch.int32)
    frac = torch.mean(_one_hot(topi, E, torch.float32), dim=(0, 1, 2))
    aux = E * torch.sum(frac * gates.mean(dim=(0, 1)))    # load-balance loss
    return dispatch, combine, aux


def _router_logits(p: dict, xg: torch.Tensor) -> torch.Tensor:
    return torch.einsum("gsd,de->gse", xg.to(torch.float32),
                        p["router"].to(torch.float32))


def _rank_groups(p: dict, T: int) -> tuple[int, int]:
    """(G, S_g) of a rank's ``T`` tokens.  In sharded training
    (``batch_ranks`` in ``p``, set by ``transformer.TrainLayout``) the
    groups are the global batch's: S_g from the ``batch_ranks * T`` global
    tokens, which must split into whole groups a rank, so routing and
    capacity are the unsharded step's."""
    n = p.get("batch_ranks", 1)
    Sg = _group_shape(n * T)[1]
    if T % Sg:
        raise ValueError(
            f"a batch rank's {T} tokens do not hold whole MoE groups of "
            f"{Sg} (the global batch's {n * T} tokens): give each rank a "
            f"multiple of {Sg} tokens")
    return T // Sg, Sg


def count_routing(counts, dispatch: torch.Tensor, K: int) -> None:
    """Add one layer call's routing to ``counts`` = (acc (4+,) int64, rows
    (T,) bool: which of the call's T = G*S token rows are real): acc +=
    [the real rows' top-k choices, those kept, those dropped, the capacity
    rows computed (G*E*C)].  Device ops only, nothing read on the host,
    so a captured graph adds on every replay; it reads ``dispatch`` and
    changes nothing the layer computes."""
    acc, rows = counts
    G, S, E, C = dispatch.shape
    kept = (dispatch.reshape(G * S, E * C) * rows[:, None]).sum(
        dtype=torch.int64)
    real = rows.sum(dtype=torch.int64) * K
    acc[:3] += torch.stack((real, kept, real - kept))
    acc[3] += G * E * C


def apply_moe(p: dict, x: torch.Tensor, cfg: ModelConfig,
              return_aux: bool = False, counts=None):
    """x: (B, S, D) -> (B, S, D).  Grouped dense top-k routing.  Under
    expert parallelism (``tp_experts``) the rank's share of y, summed over
    the "model" group by ``tp_sum``; in sharded training ``tp_in``
    (Megatron's f) takes the input first.  ``counts``: see
    :func:`count_routing` (over all E experts, before a rank keeps its
    own)."""
    if cfg.scoring_func == "sigmoid":
        if return_aux:
            raise ValueError("the dropless sigmoid router has no auxiliary "
                             "load-balance loss")
        return apply_moe_dropless(p, x, cfg, counts)
    B, S, D = x.shape
    K = cfg.experts_per_token
    G, Sg = _rank_groups(p, B * S)
    xg = x.reshape(G, Sg, D)
    if "tp_in" in p:
        xg = p["tp_in"](xg)

    dispatch, combine, aux = router_dispatch(
        _router_logits(p, xg), K, cfg.capacity_factor, cfg.logit_softcap)
    if counts is not None:
        count_routing(counts, dispatch, K)
    if "tp_experts" in p:
        lo, hi = p["tp_experts"]
        dispatch, combine = dispatch[:, :, lo:hi], combine[:, :, lo:hi]

    dt = x.dtype
    buf = torch.einsum("gsec,gsd->gecd", dispatch.to(dt), xg)
    h_in = torch.einsum("gecd,edf->gecf", buf, p["w_in"].to(dt))
    h_gate = torch.einsum("gecd,edf->gecf", buf, p["w_gate"].to(dt))
    h = layers.act_fn(cfg.act)(h_gate) * h_in
    out_buf = torch.einsum("gecf,efd->gecd", h, p["w_out"].to(dt))

    y = torch.einsum("gsec,gecd->gsd", combine.to(dt), out_buf)
    if "tp_sum" in p:
        y = p["tp_sum"](y)
    y = y.reshape(B, S, D)
    if return_aux:
        return y, aux
    return y


def sigmoid_route(logits: torch.Tensor, bias, K: int, scale: float):
    """DeepSeek-V3's ``noaux_tc`` routing with one group: logits (T, E)
    f32 -> (top-k experts (T, K), their weights (T, K) f32).  The top-k
    of ``sigmoid(logits) + bias`` (``bias`` None: of the scores), weighted
    by their scores normalised to sum 1, times ``scale``."""
    scores = torch.sigmoid(logits)
    pick = scores if bias is None else scores + bias.to(torch.float32)
    topi = torch.topk(pick, K, dim=-1).indices
    w = scores.gather(-1, topi)
    return topi, w / (w.sum(-1, keepdim=True) + 1e-20) * scale


def count_dropless(counts, topi: torch.Tensor, lo: int, hi: int) -> None:
    """Add one dropless layer call's routing to ``counts`` (see
    :func:`count_routing`): every real choice kept, none dropped, the held
    experts' rows computed ((hi - lo) x T), and, in the fifth entry, the
    real choices that land on the held experts [lo, hi)."""
    acc, rows = counts
    real = rows.sum(dtype=torch.int64) * topi.shape[1]
    acc[:3] += torch.stack((real, real, torch.zeros_like(real)))
    acc[3] += (hi - lo) * topi.shape[0]
    held = (topi >= lo) & (topi < hi) & rows[:, None]
    acc[4] += held.sum(dtype=torch.int64)


def apply_moe_dropless(p: dict, x: torch.Tensor, cfg: ModelConfig,
                       counts=None) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D): sigmoid routing over all E experts
    (:func:`sigmoid_route`), the held experts [lo, hi) computed over
    every row and weighted, plus the shared experts.  Device ops only,
    nothing read on the host."""
    if "tp_experts" in p:
        raise ValueError(f"{cfg.name}: the dropless router runs on one "
                         "chip's expert share (cfg.expert_lo / "
                         "experts_held), not under tensor parallelism")
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    topi, w = sigmoid_route(xt.to(torch.float32) @ p["router"].to(
        torch.float32), p.get("router_bias"), cfg.experts_per_token,
        cfg.routed_scaling_factor)
    lo, hi = cfg.experts_here
    if counts is not None:
        count_dropless(counts, topi, lo, hi)
    held = torch.arange(lo, hi, device=x.device)
    # each row's weight on each held expert, 0 where it did not pick it
    comb = ((topi[:, :, None] == held) * w[:, :, None]).sum(1)  # (T, Eh)
    dt = x.dtype
    h = layers.act_fn(cfg.act)(torch.matmul(xt, p["w_gate"].to(dt))) \
        * torch.matmul(xt, p["w_in"].to(dt))                     # (Eh, T, F)
    out = torch.bmm(h, p["w_out"].to(dt))                        # (Eh, T, D)
    y = torch.bmm(comb[:, None, :], out.transpose(0, 1).to(
        torch.float32))[:, 0].to(dt)                             # (T, D)
    if "shared" in p:
        y = y + layers.apply_mlp(p["shared"], xt, cfg.act)
    return y.reshape(B, S, D)


def aux_load_balance_loss(p: dict, x: torch.Tensor,
                          cfg: ModelConfig) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (mean fraction * prob)."""
    B, S, D = x.shape
    G, Sg = _group_shape(B * S)
    _, _, aux = router_dispatch(_router_logits(p, x.reshape(G, Sg, D)),
                                cfg.experts_per_token, cfg.capacity_factor,
                                cfg.logit_softcap)
    return aux
