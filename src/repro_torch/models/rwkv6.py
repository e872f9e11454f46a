"""RWKV-6 "Finch" block: data-dependent-decay linear attention + channel mix
(the port of ``repro.models.rwkv6``).

wkv6 recurrence per head (state S of dk x dv):

    out_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
    S_t   = diag(w_t) S_{t-1} + k_t v_tᵀ,       w_t = exp(-exp(ŵ_t)) ∈ (0,1)

The full sequence runs the chunked parallel form: training and
``forward`` (:func:`apply_rwkv_time_mix` without a cache) differentiate
through :func:`wkv6_chunked`, the torch port of JAX's; monolithic prefill
(with a cache, from its state) and chunked prefill run it through
``kernels/scan`` with ``impl="pallas"`` (the ``wkv6_scan`` kernel on CUDA
tensors), and otherwise monolithic prefill runs :func:`wkv6_chunked` and
chunked prefill the kernel's plain version, carrying the state across
engine chunks.  Decode runs one step in torch ops, as JAX does.  The
time-mix block takes ``fcfg`` only to choose between the kernel and the
plain versions.  As in JAX, a sequence of S tokens is cut into chunks of
``min(64, S)``, which must divide S.

Tensor parallelism (``transformer.shard_params`` and ``TrainLayout``
under "heads_flat" / "heads" / "mlp" -> "model"): a rank holds its heads'
columns of ``w_r``, ``w_k``, ``w_v``, ``w_g``, ``w0`` and ``wB``, their
``u``, ``ln_scale`` and ``ln_bias``, the matching rows of ``w_o`` and its
slice of the channel mix's hidden; ``mu``, ``wA`` and the channel mix's
``w_r`` stay whole.  Head counts come from the rank's projection width,
never from the (whole) input width.  The output norm spans the model
width, so its two statistics are sums over the "model" group
(``tp_stat``), and the row-parallel products after ``w_o`` and the
channel mix's ``w_v`` are summed by ``tp_sum``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.famous import FamousConfig
from repro_torch.kernels import lib
from repro_torch.kernels.scan import ops as scan_ops
from repro_torch.models import layers
from repro_torch.models.module import ParamSpec

_LORA = 64  # low-rank width of the data-dependent decay projection
f32 = torch.float32


def rwkv6_spec(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    h = d // cfg.rwkv_head_dim
    dh = cfg.rwkv_head_dim
    lora = min(_LORA, d)
    return {
        # token-shift mixing coefficients (r, k, v, w, g)
        "mu": ParamSpec((5, d), (None, "embed"), init="uniform", scale=0.5),
        "w_r": ParamSpec((d, d), ("embed", "heads_flat")),
        "w_k": ParamSpec((d, d), ("embed", "heads_flat")),
        "w_v": ParamSpec((d, d), ("embed", "heads_flat")),
        "w_g": ParamSpec((d, d), ("embed", "heads_flat")),
        # decay: ŵ_t = w0 + tanh(x̄ A) B   (low-rank data dependence)
        "w0": ParamSpec((d,), ("heads_flat",), init="uniform", scale=1.0),
        "wA": ParamSpec((d, lora), ("embed", None), scale=0.1),
        "wB": ParamSpec((lora, d), (None, "heads_flat"), scale=0.1),
        "u": ParamSpec((h, dh), ("heads", "head_dim"), init="uniform",
                       scale=0.5),
        "ln_scale": ParamSpec((d,), ("heads_flat",), init="ones"),
        "ln_bias": ParamSpec((d,), ("heads_flat",), init="zeros"),
        "w_o": ParamSpec((d, d), ("heads_flat", "embed")),
    }


def channel_mix_spec(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu": ParamSpec((2, d), (None, "embed"), init="uniform", scale=0.5),
        "w_k": ParamSpec((d, f), ("embed", "mlp")),
        "w_v": ParamSpec((f, d), ("mlp", "embed")),
        "w_r": ParamSpec((d, d), ("embed", None)),
    }


def wkv6_chunk_len(S: int, chunk: int = 64) -> int:
    """The chunk of a wkv6 over S steps, ``min(chunk, S)``; raises
    ``ValueError`` unless it divides S (JAX asserts it)."""
    c = min(chunk, S)
    if c < 1 or S % c:
        raise ValueError(f"wkv6: S={S} is not a multiple of chunk={c}: "
                         f"the chunked form takes S <= {chunk} or a "
                         f"multiple of {chunk}")
    return c


def wkv6_chunked(r, k, v, logw, u, s0=None, chunk: int = 64):
    """r, k, v, logw: (B, H, S, dh), logw <= 0; u: (H, dh); s0: optional
    (B, H, dh, dh) carried state.  Returns (out (B, H, S, dh) f32,
    s_final (B, H, dh, dh) f32), differentiable.  Within a chunk the
    decays become cumulative log-decay masks (every ratio <= 1) and the
    work dense products; the state crosses chunks in order."""
    B, H, S, dh = r.shape
    chunk = wkv6_chunk_len(S, chunk)
    r, k, v, logw = (x.to(f32) for x in (r, k, v, logw))
    s = (torch.zeros((B, H, dh, dh), dtype=f32, device=r.device)
         if s0 is None else s0.to(f32))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=f32, device=r.device),
                     diagonal=-1)                          # strict lower
    u = u.to(f32)[None, :, None, :]
    outs = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        rb, kb, vb, wb = r[:, :, sl], k[:, :, sl], v[:, :, sl], logw[:, :, sl]
        cw = torch.cumsum(wb, dim=2)                       # logW_t inclusive
        cw_prev = cw - wb                                  # logW_{t-1}
        # inter-chunk: r_t ⊙ W_{t-1} applied to the incoming state
        qexp = rb * torch.exp(cw_prev)
        inter = qexp @ s
        # intra-chunk: A[t, s] = Σ_d r[t,d] exp(cw_prev[t,d] - cw[s,d]) k[s,d]
        kexp = kb * torch.exp(-cw)
        att = (qexp @ kexp.transpose(-1, -2)) * tri
        diag = (rb * u * kb).sum(-1)
        intra = att @ vb + diag[..., None] * vb
        # S' = diag(W_C) S + Σ_t diag(W_C / W_t) k_t v_tᵀ
        k_dec = kb * torch.exp(cw[:, :, -1:] - cw)
        s = (torch.exp(cw[:, :, -1])[..., None] * s
             + k_dec.transpose(-1, -2) @ vb)
        outs.append(inter + intra)
    return torch.cat(outs, dim=2), s


def wkv6_step(r, k, v, logw, u, s):
    """One decode step. r, k, v, logw: (B, H, dh); u: (H, dh); s: (B, H,
    dh, dh) f32.  Returns (out (B, H, dh) f32, new state)."""
    r, k, v, logw = (x.to(f32) for x in (r, k, v, logw))
    kv = k[..., :, None] * v[..., None, :]
    out = torch.einsum("bhd,bhde->bhe", r, s + u[None, :, :, None] * kv)
    return out, torch.exp(logw)[..., None] * s + kv


def _token_shift(x, prev):
    """x: (B, S, D); prev: (B, D) last token of the previous segment."""
    if prev is None:
        prev = torch.zeros_like(x[:, 0])
    return torch.cat([prev.to(x.dtype)[:, None], x[:, :-1]], dim=1)


def _mix(x, x_prev, mu):
    return x + (x_prev - x) * mu.to(x.dtype)


def make_rwkv_cache(cfg: ModelConfig, batch: int, dtype,
                    device="cuda") -> dict:
    """Per-slot state: the wkv state ``s`` (batch, H, dh, dh) f32 and the
    two token-shift rows ``x_tm``/``x_cm`` (batch, D) in the model dtype."""
    d = cfg.d_model
    h = d // cfg.rwkv_head_dim
    dh = cfg.rwkv_head_dim
    return {
        "s": torch.zeros((batch, h, dh, dh), dtype=f32, device=device),
        "x_tm": torch.zeros((batch, d), dtype=dtype, device=device),
        "x_cm": torch.zeros((batch, d), dtype=dtype, device=device),
    }


RWKV_CACHE_AXES = {"s": ("batch", "heads", None, None),
                   "x_tm": ("batch", "embed"), "x_cm": ("batch", "embed")}


def _time_mix_qkvwg(p, x, x_prev):
    dt = x.dtype
    xs = [_mix(x, x_prev, p["mu"][i]) for i in range(5)]
    r = xs[0] @ p["w_r"].to(dt)
    k = xs[1] @ p["w_k"].to(dt)
    v = xs[2] @ p["w_v"].to(dt)
    g = xs[4] @ p["w_g"].to(dt)
    wx = xs[3].to(f32)
    what = (p["w0"].to(f32)
            + torch.tanh(wx @ p["wA"].to(f32)) @ p["wB"].to(f32))
    # Clamp ŵ ≤ 0 so per-step log-decay ∈ [-1, 0): keeps the chunked form's
    # exp(-cumsum) factors within f32 range (|cw| ≤ chunk).  Documented
    # deviation: decays faster than 1/e per token are saturated.
    logw = -torch.exp(torch.clamp(what, -20.0, 0.0))
    return r, k, v, g, logw


def _heads(x, dh):
    """(B, S, H * dh) -> (B, H, S, dh), H from the width of ``x`` (a
    tensor-parallel rank's own heads)."""
    return x.reshape(x.shape[0], x.shape[1], -1, dh).transpose(1, 2)


def _sharded_layernorm(p, x, width: int, eps: float = 1e-6):
    """``layers.apply_norm``'s LayerNorm over a row of ``width`` whose
    columns are spread over the "model" group, this rank holding ``x``'s:
    JAX's two passes, the mean from the summed f32 partial sums, then the
    variance from the summed centred squares (``tp_stat``), each rank
    scaling its own columns."""
    dt = x.dtype
    mu = p["tp_stat"](torch.sum(x, -1, keepdim=True, dtype=f32)) / width
    xc = x - mu.to(dt)
    var = p["tp_stat"](torch.sum(xc.square(), -1, keepdim=True,
                                 dtype=f32)) / width
    y = xc * torch.rsqrt(var + eps).to(dt)
    return y * p["ln_scale"].to(dt) + p["ln_bias"].to(dt)


def _finish(p, out, g, x):
    """Norm over the model width, the silu gate and the output
    projection; under tensor parallelism the norm of the rank's columns
    (:func:`_sharded_layernorm`) and its partial product summed over the
    "model" group (``tp_sum``)."""
    if "tp_stat" in p:
        out = _sharded_layernorm(p, out.to(x.dtype), x.shape[-1])
    else:
        out = layers.apply_norm({"scale": p["ln_scale"],
                                 "bias": p["ln_bias"]},
                                out.to(x.dtype), "layernorm")
    out = out * F.silu(g)
    y = out @ p["w_o"].to(x.dtype)
    if "tp_sum" in p:
        y = p["tp_sum"](y)
    return y


def last_valid(x, n_valid):
    """``x[:, n_valid - 1]`` for a one-element int tensor ``n_valid``, as a
    gather on the device (an index by a tensor scalar would read it on the
    host).  x: (B, S, ...) -> (B, ...)."""
    return x.index_select(1, (n_valid - 1).reshape(1))[:, 0]


def apply_rwkv_time_mix(p, x, cfg: ModelConfig, cache=None, chunk: int = 64,
                        fcfg: FamousConfig = FamousConfig()):
    """The time mix over a whole sequence, x: (B, S, D).  Without a cache
    (training, ``forward``) it returns y through :func:`wkv6_chunked`,
    differentiable.  With one (monolithic prefill: {"s", "x_tm"}, the
    carried state and token shift) the wkv runs from ``cache["s"]`` on the
    ``wkv6_scan`` kernel under ``impl="pallas"`` and on
    :func:`wkv6_chunked` otherwise, and the result is (y, {"s", "x_tm"}).
    S must be at most ``chunk`` or a multiple of it (``ValueError``).  In
    sharded training ``tp_in`` (Megatron's f) takes x first."""
    if "tp_in" in p:
        x = p["tp_in"](x)
    B, S = x.shape[:2]
    dh = cfg.rwkv_head_dim
    x_prev = _token_shift(x, None if cache is None else cache["x_tm"])
    r, k, v, g, logw = _time_mix_qkvwg(p, x, x_prev)
    rh, kh, vh, wh = (_heads(t, dh) for t in (r, k, v, logw))
    s0 = None if cache is None else cache["s"]
    if cache is not None and fcfg.impl == "pallas":
        out, s_fin = scan_ops.wkv6(rh, kh, vh, wh, p["u"].to(f32), s0=s0,
                                   chunk=chunk)
    else:
        out, s_fin = wkv6_chunked(rh, kh, vh, wh, p["u"], s0=s0, chunk=chunk)
    y = _finish(p, out.transpose(1, 2).reshape(B, S, -1), g, x)
    if cache is None:
        return y
    return y, {"s": s_fin, "x_tm": x[:, -1]}


def apply_rwkv_time_mix_chunk(p, x, cache, cfg: ModelConfig, n_valid,
                              chunk: int = 64,
                              fcfg: FamousConfig = FamousConfig()):
    """Chunked prefill: carry (s, x_tm) across fixed-shape chunks.

    x: (1, C, D), only the first ``n_valid`` (an int or a one-element int
    tensor on x's device, a runtime scalar never read on the host)
    positions real.  Pad positions cannot pollute the carried state: their k is
    zeroed (no kv contribution) and their log-decay is zeroed (identity
    decay), so ``s_final`` is the state after the last real token; the
    token-shift state becomes ``x[:, n_valid - 1]``.  Pad outputs are junk,
    discarded upstream."""
    B, S = x.shape[:2]
    dh = cfg.rwkv_head_dim
    n_valid = lib.device_scalar("apply_rwkv_time_mix_chunk", n_valid,
                                x.device)
    x_prev = _token_shift(x, cache["x_tm"])
    r, k, v, g, logw = _time_mix_qkvwg(p, x, x_prev)
    valid = (torch.arange(S, device=x.device) < n_valid)[None, :, None]
    k = torch.where(valid, k, torch.zeros((), dtype=k.dtype, device=k.device))
    logw = torch.where(valid, logw, torch.zeros((), dtype=f32,
                                                device=logw.device))
    rh, kh, vh, wh = (_heads(t, dh) for t in (r, k, v, logw))
    out, s_fin = scan_ops.wkv6(rh, kh, vh, wh, p["u"].to(f32), s0=cache["s"],
                               chunk=chunk, plain=fcfg.impl != "pallas")
    out = out.transpose(1, 2).reshape(B, S, -1)
    return _finish(p, out, g, x), {"s": s_fin,
                                   "x_tm": last_valid(x, n_valid)}


def apply_rwkv_time_mix_decode(p, x, cache, cfg: ModelConfig):
    """One token. x: (B, 1, D); cache: {"s", "x_tm"}.  Returns (y, new
    {"s", "x_tm"})."""
    B = x.shape[0]
    dh = cfg.rwkv_head_dim
    x_prev = cache["x_tm"].to(x.dtype)[:, None]
    r, k, v, g, logw = _time_mix_qkvwg(p, x, x_prev)
    out, s_new = wkv6_step(*(t.reshape(B, -1, dh) for t in (r, k, v, logw)),
                           p["u"].to(f32), cache["s"])
    return _finish(p, out.reshape(B, 1, -1), g, x), {"s": s_new,
                                                     "x_tm": x[:, -1]}


def apply_channel_mix(p, x, cfg: ModelConfig, cache_x=None):
    """RWKV channel mix (relu² FFN with token shift). Returns (y, x_last).
    Under tensor parallelism the rank's slice of the hidden: its partial
    ``kk @ w_v`` summed over the "model" group (``tp_sum``) before the
    whole receptance gate; in sharded training ``tp_in`` (Megatron's f)
    takes ``xk``, the only input of the sharded product."""
    x_prev = _token_shift(x, cache_x)
    xk = _mix(x, x_prev, p["mu"][0])
    xr = _mix(x, x_prev, p["mu"][1])
    if "tp_in" in p:
        xk = p["tp_in"](xk)
    dt = x.dtype
    kk = layers.act_fn("relu_sq")(xk @ p["w_k"].to(dt))
    vv = kk @ p["w_v"].to(dt)
    if "tp_sum" in p:
        vv = p["tp_sum"](vv)
    rr = torch.sigmoid(xr @ p["w_r"].to(dt))
    return rr * vv, x[:, -1]
