"""Draft-model-free speculative drafting: prompt-lookup / n-gram proposals.

A copy of ``repro.serve.draft`` (the port imports nothing of the JAX
package).  Pure host-side policy, like the Scheduler: drafting runs
between device steps on plain python lists, so a drafter can never add a
device sync to the hot loop.

The idea (ROADMAP: Peng et al.'s length-adaptive co-design applied to
decode): when output structure is predictable — quoting the prompt,
repeating a generated pattern, boilerplate — the *sequence itself* is a
free draft model.  :class:`PromptLookupDrafter` matches the longest
trailing n-gram of ``prompt + generated history`` against an earlier
occurrence in the same sequence and proposes the tokens that followed it.
The engine then verifies all proposed tokens in ONE batched forward
(``transformer.verify_step``) and accepts the longest matching prefix:
every accepted draft token skips a full sequential decode step, and a
fully-rejected draft still yields the one token plain decode would have
produced (speculative serving is token-identical by construction — see
docs/serving.md).

A drafter is any object with ``draft(seq, k) -> list`` proposing up to
``k`` continuation tokens of ``seq``; the engine treats drafting as
best-effort and surfaces drafter exceptions as per-request errors
(``req.error``) rather than letting one poisoned request take down the
batch.
"""
from __future__ import annotations

from repro_torch.obs.runtime import NULL_OBSERVER


class PromptLookupDrafter:
    """Propose the continuation of the most recent earlier occurrence of
    the sequence's trailing n-gram (longest n first).

    ``max_ngram`` trades match precision against hit rate: longer n-grams
    misfire less (higher acceptance per draft) but match less often.
    Proposals are capped at ``k`` tokens by the caller — the engine passes
    ``min(draft_k, tokens the request may still emit)``.
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 observer=None):
        assert 1 <= min_ngram <= max_ngram, (min_ngram, max_ngram)
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        # observability seam (repro_torch.obs.runtime, host-pure):
        # lookup hit rate + volume
        self.obs = observer if observer is not None else NULL_OBSERVER

    def draft(self, seq, k: int) -> list:
        """Up to ``k`` proposed continuation tokens of ``seq`` (prompt +
        generated history, most recent last); ``[]`` when nothing matches.
        """
        out = self._lookup(seq, k)
        self.obs.on_draft_lookup(bool(out), len(out))
        return out

    def _lookup(self, seq, k: int) -> list:
        n_seq = len(seq)
        if k <= 0 or n_seq < self.min_ngram + 1:
            return []
        for n in range(min(self.max_ngram, n_seq - 1), self.min_ngram - 1, -1):
            pat = list(seq[-n:])
            # most recent earlier occurrence that has a continuation
            # (i + n < n_seq); the trailing n-gram itself is excluded by
            # the range bound
            for i in range(n_seq - n - 1, -1, -1):
                if list(seq[i:i + n]) == pat:
                    return [int(t) for t in seq[i + n:i + n + k]]
        return []
