"""Griffin/RecurrentGemma recurrent block: temporal conv + RG-LRU (the port
of ``repro.models.rglru``).

The recurrence h_t = a_t h_{t-1} + b_t runs three ways:

  * training and ``forward`` (:func:`apply_rglru` without a cache)
    differentiate through :func:`associative_scan`, the torch port of
    JAX's ``jax.lax.associative_scan`` with its ``combine``, in log-depth
    steps, as JAX differentiates its own;
  * monolithic prefill (:func:`apply_rglru` with a cache) and chunked
    prefill run it through ``kernels/scan`` with ``impl="pallas"`` (the
    ``rglru_scan`` kernel on CUDA tensors); monolithic prefill on other
    impls runs :func:`associative_scan`, chunked prefill the kernel's
    plain sequential version, carrying the slot's state across chunks;
  * decode carries (h, conv window) state one token at a time in torch
    ops.

The block takes ``fcfg`` only to choose between the kernel and the plain
versions, as the attention ops do.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.famous import FamousConfig
from repro_torch.kernels import lib
from repro_torch.kernels.scan import ops as scan_ops
from repro_torch.models import layers
from repro_torch.models.module import ParamSpec

_C = 8.0  # RG-LRU decay sharpness constant (Griffin §2.4)
f32 = torch.float32


def rglru_spec(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    r = cfg.lru_width or d
    w = cfg.conv_width
    return {
        "w_x": ParamSpec((d, r), ("embed", "mlp")),
        "w_gate": ParamSpec((d, r), ("embed", "mlp")),
        "conv_w": ParamSpec((w, r), (None, "mlp"), scale=0.5),
        "conv_b": ParamSpec((r,), ("mlp",), init="zeros"),
        "w_a": ParamSpec((r, r), ("mlp", None)),
        "b_a": ParamSpec((r,), (None,), init="zeros"),
        "w_i": ParamSpec((r, r), ("mlp", None)),
        "b_i": ParamSpec((r,), (None,), init="zeros"),
        # Λ parameterised so a = exp(-C*softplus(Λ)·r_t) starts near 0.9..0.99
        "lam": ParamSpec((r,), (None,), init="uniform", scale=1.0),
        "w_out": ParamSpec((r, d), ("mlp", "embed")),
    }


def _channels(p, name):
    """A replicated (R,) parameter, cut to this rank's channels under
    tensor parallelism (``tp_channels``; in sharded training the leaf
    comes through Megatron's f, so the ranks' slices of its gradient are
    summed)."""
    if "tp_channels" in p:
        lo, hi = p["tp_channels"]
        return p[name][lo:hi]
    return p[name]


def _gates(p, xc):
    """Recurrence gate r_t and input gate i_t from the conv output.  Under
    tensor parallelism xc holds this rank's channels and ``w_a``/``w_i``
    their rows: the partial products are summed over the "model" group
    and cut back to the rank's channels in one reduce-scatter
    (``tp_scatter``; in training its backward gathers the ranks'
    slices)."""
    pre_a = xc @ p["w_a"].to(xc.dtype)
    pre_i = xc @ p["w_i"].to(xc.dtype)
    if "tp_channels" in p:
        lo, hi = p["tp_channels"]
        r = pre_a.shape[-1]
        pre_a, pre_i = p["tp_scatter"](torch.cat([pre_a, pre_i], dim=-1),
                                       ((lo, hi), (r + lo, r + hi)))
    rg = torch.sigmoid(pre_a.to(f32) + _channels(p, "b_a").to(f32))
    ig = torch.sigmoid(pre_i.to(f32) + _channels(p, "b_i").to(f32))
    return rg, ig


def _decay(p, rg):
    # jax.nn.softplus is logaddexp(x, 0)
    lam = _channels(p, "lam").to(f32)
    log_a = -_C * torch.logaddexp(lam, torch.zeros_like(lam)) * rg
    a = torch.exp(log_a)
    return a, torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))


def _combine(left, right):
    """JAX's combine of two (a, b) scan elements: ``h -> a_r (a_l h + b_l)
    + b_r``."""
    al, bl = left
    ar, br = right
    return al * ar, ar * bl + br


def _interleave(a, b, axis: int):
    """[a0, b0, a1, b1, ...] along ``axis``; ``a`` has as many elements
    as ``b`` or one more."""
    n = b.shape[axis]
    pairs = torch.stack([a.narrow(axis, 0, n), b], dim=axis + 1)
    out = pairs.flatten(axis, axis + 1)
    if a.shape[axis] > n:
        out = torch.cat([out, a.narrow(axis, n, 1)], dim=axis)
    return out


def associative_scan(a, b, axis: int = 1):
    """Inclusive scan of (a, b) under :func:`_combine` along ``axis``: the
    port of ``jax.lax.associative_scan`` (its odd/even recursion, so the
    same products in the same order), ``ceil(log2 S)`` levels deep and
    differentiable.  Returns (prod a, h) with h_t = a_t h_{t-1} + b_t from
    h = 0."""
    n = a.shape[axis]
    if n < 2:
        return a, b

    def sl(x, start, stop=None, step=1):
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(start, stop, step)
        return x[tuple(idx)]

    reduced = _combine((sl(a, 0, -1, 2), sl(b, 0, -1, 2)),
                       (sl(a, 1, None, 2), sl(b, 1, None, 2)))
    odd = associative_scan(*reduced, axis=axis)
    if n % 2 == 0:
        even = _combine((sl(odd[0], 0, -1), sl(odd[1], 0, -1)),
                        (sl(a, 2, None, 2), sl(b, 2, None, 2)))
    else:
        even = _combine(odd, (sl(a, 2, None, 2), sl(b, 2, None, 2)))
    even = [torch.cat([sl(x, 0, 1), e], dim=axis)
            for x, e in zip((a, b), even)]
    return tuple(_interleave(e, o, axis) for e, o in zip(even, odd))


def _scan_operands(p, xc):
    """The recurrence's (a, b), f32: h_t = a_t h_{t-1} + b_t."""
    rg, ig = _gates(p, xc)
    a, gain = _decay(p, rg)
    return a, gain * (ig * xc.to(f32))


def rglru_scan_full(p, xc):
    """The full-sequence recurrence of JAX's ``rglru_scan`` (no carried
    state, no pad): xc (B, S, R) -> h (B, S, R) f32 through
    :func:`associative_scan`."""
    return associative_scan(*_scan_operands(p, xc), axis=1)[1]


def rglru_scan(p, xc, h0=None, n_valid=None,
               fcfg: FamousConfig = FamousConfig()):
    """xc: (B, S, R) conv output -> recurrence output (B, S, R) f32.

    h0: optional (B, R) carried state (chunked prefill), folded in as
    ``h_1 = a_1 h0 + b_1``.  n_valid: optional one-element int tensor (a
    runtime scalar, compared on the device) — positions
    >= n_valid are pad, their update masked to the identity (a = 1, b = 0),
    so ``h[:, -1]`` is exactly the state after the last real token.  After
    those two steps the scan is the kernel's function of (a, b):
    ``impl="pallas"`` runs ``scan_ops.rglru``, other impls its plain
    sequential version."""
    a, b = _scan_operands(p, xc)
    if n_valid is not None:
        valid = (torch.arange(xc.shape[1], device=xc.device)
                 < n_valid)[None, :, None]
        a = torch.where(valid, a, torch.ones((), dtype=f32, device=a.device))
        b = torch.where(valid, b, torch.zeros((), dtype=f32, device=b.device))
    if h0 is not None:
        b = b.clone()
        b[:, 0] += a[:, 0] * h0.to(f32)
    return scan_ops.rglru(a, b, plain=fcfg.impl != "pallas")


def rglru_step(p, xc_t, h_prev):
    """One decode step. xc_t: (B, R); h_prev: (B, R) f32 -> h_t."""
    a, b = _scan_operands(p, xc_t[:, None, :])
    return a[:, 0] * h_prev + b[:, 0]


def _conv1d(p, x, state=None, n_valid=None):
    """Causal depthwise temporal conv of width W. x: (B, S, R); state:
    (B, W-1, R) previous inputs.  Returns (y f32, new state): the W-1
    inputs ending at the last real position (``n_valid``, a one-element int
    tensor, gathered on the device; the pad tail excluded) or at the
    end."""
    w = p["conv_w"].to(f32)  # (W, R)
    W = w.shape[0]
    S = x.shape[1]
    xf = x.to(f32)
    if state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=f32,
                          device=x.device)
    else:
        pad = state.to(f32)
    xp = torch.cat([pad, xf], dim=1)
    y = 0
    for i in range(W):          # Python's sum, in the JAX order
        y = y + xp[:, i:i + S] * w[i]
    y = y + p["conv_b"].to(f32)
    if n_valid is None:
        new_state = xp[:, -(W - 1):]
    else:
        new_state = xp.index_select(
            1, n_valid + torch.arange(W - 1, device=x.device))
    return y, new_state


def make_rglru_cache(cfg: ModelConfig, batch: int, dtype,
                     device="cuda") -> dict:
    """Per-slot state: ``h`` (batch, R) and the conv window ``conv``
    (batch, W-1, R), both f32 whatever the model dtype, as in JAX."""
    r = cfg.lru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, r), dtype=f32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, r), dtype=f32,
                            device=device),
    }


RGLRU_CACHE_AXES = {"h": ("batch", "mlp"), "conv": ("batch", None, "mlp")}


def _out(p, gate, h, x):
    y = layers.act_fn("gelu")(gate.to(f32)) * h
    y = y.to(x.dtype) @ p["w_out"].to(x.dtype)
    if "tp_sum" in p:
        y = p["tp_sum"](y)
    return y


def apply_rglru(p: dict, x: torch.Tensor, cfg: ModelConfig,
                cache: dict | None = None,
                fcfg: FamousConfig = FamousConfig()):
    """x: (B, S, D) -> (B, S, D).  Without a cache (training, ``forward``)
    the recurrence is :func:`associative_scan`, differentiable.  With one
    (monolithic prefill from a fresh state; its ``conv`` window feeds the
    conv) it is the ``rglru_scan`` kernel under ``impl="pallas"`` and the
    associative scan otherwise, and the result is (out, new state {"h",
    "conv"}).  In sharded training ``tp_in`` (Megatron's f) takes x
    first."""
    if "tp_in" in p:
        x = p["tp_in"](x)
    xb = x @ p["w_x"].to(x.dtype)
    gate = x @ p["w_gate"].to(x.dtype)
    xc, conv_state = _conv1d(p, xb, None if cache is None else cache["conv"])
    if cache is not None and fcfg.impl == "pallas":
        h = rglru_scan(p, xc, fcfg=fcfg)
    else:
        h = rglru_scan_full(p, xc)
    out = _out(p, gate, h, x)
    if cache is None:
        return out
    return out, {"h": h[:, -1], "conv": conv_state}


def apply_rglru_chunk(p: dict, x: torch.Tensor, cfg: ModelConfig,
                      cache: dict, n_valid,
                      fcfg: FamousConfig = FamousConfig()):
    """Chunked prefill: carries the recurrent state across chunks (the
    caller zeroes it for a fresh sequence) and masks pad positions >=
    ``n_valid`` (an int or a one-element int tensor on x's device, a
    runtime scalar never read on the host) so their updates are the
    identity.  x: (1, C, D); cache:
    {"h", "conv"} of the slot.  Returns (out (1, C, D), new state)."""
    n_valid = lib.device_scalar("apply_rglru_chunk", n_valid, x.device)
    xb = x @ p["w_x"].to(x.dtype)
    gate = x @ p["w_gate"].to(x.dtype)
    xc, conv_state = _conv1d(p, xb, cache["conv"], n_valid=n_valid)
    h = rglru_scan(p, xc, h0=cache["h"], n_valid=n_valid, fcfg=fcfg)
    return _out(p, gate, h, x), {"h": h[:, -1], "conv": conv_state}


def apply_rglru_decode(p: dict, x: torch.Tensor, cache: dict,
                       cfg: ModelConfig):
    """One token. x: (B, 1, D) -> (out (B, 1, D), new state)."""
    xb = x @ p["w_x"].to(x.dtype)
    gate = x @ p["w_gate"].to(x.dtype)
    xc, conv_state = _conv1d(p, xb, cache["conv"])
    h = rglru_step(p, xc[:, 0], cache["h"])
    return _out(p, gate[:, 0], h, x)[:, None], {"h": h, "conv": conv_state}
