"""Losses (the port of ``repro.train.losses``).  The LM loss computes f32
logits in sequence chunks of the final hidden states, as the JAX package
does; the chunk loop is a Python loop.  In the sharded train step a head
whose vocabulary splits over "model" gives each rank its columns'
logits, and the cross entropy is vocab-parallel
(:class:`VocabParallelCE`): no rank holds a whole vocabulary table or a
whole row of logits."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def _lse_and_target(logits: torch.Tensor, targets: torch.Tensor):
    """logits: (..., V) f32; targets: (...) int.  Returns each row's
    log-sum-exp and target logit."""
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    return lse, tgt


class VocabParallelCE(torch.autograd.Function):
    """Each row's log-sum-exp and target logit from a rank's columns
    [lo, lo + n) of the logits (..., n) f32, the vocabulary split over the
    "model" group of ``comm`` (``parallel.sharding.MeshComm``): the row
    max all-reduced with "max" (a stabiliser only, no gradient), the sum
    of exp(logits - max) all-reduced, the target logit a masked gather
    summed over the group.  Every rank returns the same (lse, target).
    Backward, the rank's columns of softmax times lse's gradient plus its
    one-hot columns times the target's: the rank's slice of the whole
    gradient, with no collective."""

    @staticmethod
    def forward(ctx, logits, targets, lo: int, comm):
        n = logits.shape[-1]
        m = logits.detach().amax(-1, keepdim=True)
        comm.all_reduce(m, ("model",), "max")
        s = torch.exp(logits - m).sum(-1)
        comm.all_reduce(s, ("model",))
        lse = m[..., 0] + torch.log(s)
        local = targets - lo
        inside = (local >= 0) & (local < n)
        idx = local.clamp(0, n - 1)[..., None]
        tgt = torch.where(inside, torch.gather(logits, -1, idx)[..., 0],
                          torch.zeros((), dtype=logits.dtype,
                                      device=logits.device))
        comm.all_reduce(tgt, ("model",))
        ctx.save_for_backward(logits, lse, idx, inside)
        return lse, tgt

    @staticmethod
    def backward(ctx, g_lse, g_tgt):
        logits, lse, idx, inside = ctx.saved_tensors
        grad = torch.exp(logits - lse[..., None]) * g_lse[..., None]
        hot = torch.where(inside, g_tgt, torch.zeros((), dtype=g_tgt.dtype,
                                                     device=g_tgt.device))
        grad.scatter_add_(-1, idx, hot[..., None])
        return grad, None, None, None


def chunked_lm_loss(params, hidden: torch.Tensor, targets: torch.Tensor,
                    cfg: ModelConfig, *, chunk: int = 512,
                    z_loss: float = 0.0, vocab=None):
    """hidden: (B, S, D); targets: (B, S). Mean next-token CE.
    ``vocab``: ``(lo, comm)`` where the head is vocab-parallel (a rank's
    columns from ``lo``, ``TrainLayout.vocab["head"]``): each chunk's
    hidden states come through Megatron's f, the head gives the rank's
    columns, and :class:`VocabParallelCE` the loss."""
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S  # odd lengths take the unchunked path
    ce_sum = hidden.new_zeros((), dtype=torch.float32)
    z2_sum = hidden.new_zeros((), dtype=torch.float32)
    for s0 in range(0, S, chunk):
        h, t = hidden[:, s0:s0 + chunk], targets[:, s0:s0 + chunk]
        if vocab is None:
            lse, tgt = _lse_and_target(transformer.logits_fn(params, h, cfg),
                                       t)
        else:
            lo, comm = vocab
            logits = transformer.logits_fn(params, comm.copy_to_model(h), cfg)
            lse, tgt = VocabParallelCE.apply(logits, t, lo, comm)
        ce_sum = ce_sum + torch.sum(lse - tgt)
        z2_sum = z2_sum + torch.sum(torch.square(lse))
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
    (so every batch-axis collective of the gradient is a plain sum); a
    vocab-parallel head takes the vocab-parallel cross entropy."""
    vocab = None
    if layout is not None:
        params = layout.outer(params,
                              tokens=not batch["inputs"].is_floating_point())
        if layout.vocab["head"] is not None:
            vocab = (layout.vocab["head"][0], layout.comm)
    hidden = transformer.forward(params, batch["inputs"], cfg, fcfg,
                                 remat=remat, return_hidden=True,
                                 compute_dtype=compute_dtype, layout=layout)
    loss = chunked_lm_loss(params, hidden, batch["targets"].long(), cfg,
                           chunk=chunk, z_loss=z_loss, vocab=vocab)
    if layout is not None and layout.comm.dp > 1:
        loss = loss / layout.comm.dp
    return loss
