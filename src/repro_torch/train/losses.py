"""Losses (the port of ``repro.train.losses``).  The LM loss computes f32
logits in sequence chunks of the final hidden states, as the JAX package
does; the chunk loop is a Python loop."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def _ce_from_logits(logits: torch.Tensor, targets: torch.Tensor):
    """logits: (..., V) f32; targets: (...) int. Returns (sum_ce, sum_z2)."""
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    return torch.sum(lse - tgt), torch.sum(torch.square(lse))


def chunked_lm_loss(params, hidden: torch.Tensor, targets: torch.Tensor,
                    cfg: ModelConfig, *, chunk: int = 512,
                    z_loss: float = 0.0):
    """hidden: (B, S, D); targets: (B, S). Mean next-token CE."""
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S  # odd lengths take the unchunked path
    ce_sum = hidden.new_zeros((), dtype=torch.float32)
    z2_sum = hidden.new_zeros((), dtype=torch.float32)
    for s0 in range(0, S, chunk):
        logits = transformer.logits_fn(params, hidden[:, s0:s0 + chunk], cfg)
        ce, z2 = _ce_from_logits(logits, targets[:, s0:s0 + chunk])
        ce_sum = ce_sum + ce
        z2_sum = z2_sum + z2
    n_tok = B * S
    loss = ce_sum / n_tok
    if z_loss:
        loss = loss + z_loss * z2_sum / n_tok
    return loss


def lm_loss(params, batch: dict, cfg: ModelConfig, fcfg, *,
            remat: bool = True, chunk: int = 512, z_loss: float = 0.0,
            compute_dtype=None, layout=None):
    """The mean next-token loss of ``batch``.  With a ``layout``
    (``transformer.TrainLayout``) ``params`` are the rank's shards and
    ``batch`` the rank's rows: the loss of those rows divided by the
    number of batch ranks, whose sum over them is the global batch's mean
    (so every batch-axis collective of the gradient is a plain sum)."""
    if layout is not None:
        params = layout.outer(params,
                              tokens=not batch["inputs"].is_floating_point())
    hidden = transformer.forward(params, batch["inputs"], cfg, fcfg,
                                 remat=remat, return_hidden=True,
                                 compute_dtype=compute_dtype, layout=layout)
    loss = chunked_lm_loss(params, hidden, batch["targets"].long(), cfg,
                           chunk=chunk, z_loss=z_loss)
    if layout is not None and layout.comm.dp > 1:
        loss = loss / layout.comm.dp
    return loss
