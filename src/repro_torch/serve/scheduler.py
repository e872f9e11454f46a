"""Pure-policy scheduler for the serving engine (no jax, no device state).

The "no jax" contract is machine-enforced: lint rule RA004
(``repro.analysis.lint``) fails the build if this module ever imports
``jax``/``jax.numpy``, with no baseline escape hatch.

The engine is split into two layers:

  * **Scheduler** (this module) — *decides*.  Owns the request queues,
    per-slot lifecycle state, the per-step token budget, chunked-prefill
    interleaving with decode, youngest-first preemption choice and
    fairness accounting.  Plain host-side python: policy changes never
    touch an executable.
  * **Runtime** (:class:`repro_torch.serve.engine.ServingEngine`) — *executes*.
    Owns params, caches, the page allocator and exactly two hot
    executables: one fixed-shape prefill chunk and one decode step.

Each engine step asks the scheduler for a :class:`StepPlan`: which
prefill chunks to run (slot, start offset, number of real tokens) and
which slots decode.  Budgeting: every decoding slot consumes one token of
the per-step budget; what remains is spent on prefill chunks of
``chunk`` tokens, oldest admission first.  A long prompt therefore
prefills one budget-sized chunk at a time *between* decode steps —
bounding everyone's TPOT — instead of stalling every decode slot
head-of-line while it prefills monolithically.  At least one chunk is
always granted when prefill work exists (forward progress even when
``token_budget < n_decode + chunk``).

The default budget ``n_slots * decode_width + chunk`` yields exactly one
prefill chunk per step while decodes are active, and ``budget // chunk``
chunks per step on an otherwise idle engine (fastest possible TTFT).
``decode_width`` is 1 for plain decode; the speculative engine sets it to
``draft_k + 1`` so every decoding slot is charged the verify executable's
true fixed-shape cost.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.obs.runtime import NULL_OBSERVER

FREE = "free"
PREFILL = "prefill"
DECODE = "decode"


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    chunk: int = 32        # fixed prefill-chunk shape (the ONE prefill executable)
    token_budget: int = 0  # per-step token target; 0 -> n_slots*width + chunk
    # tokens a decoding slot consumes per step.  Plain decode: 1.
    # Speculative decode: draft_k + 1 — the verify executable is fixed-shape,
    # so a decoding slot costs its full draft width whether or not the
    # drafter proposed anything (short drafts ride as pad rows), and the
    # budget must charge for it or prefill chunks get crowded in under the
    # true compute cost of the step.
    decode_width: int = 1


@dataclasses.dataclass(frozen=True)
class PrefillChunk:
    slot: int
    start: int   # absolute offset of the chunk's first token
    n: int       # real tokens in this chunk (<= chunk; the rest is pad)


@dataclasses.dataclass
class StepPlan:
    chunks: list
    decode_slots: list


@dataclasses.dataclass
class SlotInfo:
    req: object = None
    admit_seq: int = -1
    state: str = FREE
    target: int = 0   # tokens to prefill (prompt + resumed output - 1)
    done: int = 0     # tokens prefilled so far


class Scheduler:
    def __init__(self, n_slots: int, cfg: SchedulerConfig = SchedulerConfig(),
                 observer=None):
        assert cfg.chunk >= 1
        self.cfg = cfg
        # the injectable observability seam (repro_torch.obs.runtime — jax-free
        # like this module, so the RA004 purity contract holds transitively)
        self.obs = observer if observer is not None else NULL_OBSERVER
        self.slots = [SlotInfo() for _ in range(n_slots)]
        self.pending: list = []   # fresh requests, FIFO
        self.resume: list = []    # preempted requests — re-enter ahead of fresh
        self.step_count = 0
        self._admit_counter = 0
        # fairness accounting, per request id
        self.stats: dict = {}

    # -- queues ---------------------------------------------------------------
    def enqueue(self, req, *, front: bool = False) -> None:
        (self.resume if front else self.pending).append(req)
        st = self._stats(req)
        st.setdefault("enqueue_step", self.step_count)
        self.obs.on_enqueue(req.rid)
        self.obs.on_queue_depth(len(self.resume) + len(self.pending))

    def next_queued(self):
        q = self.resume if self.resume else self.pending
        return q[0] if q else None

    def pop_queued(self):
        q = self.resume if self.resume else self.pending
        req = q.pop(0)
        self.obs.on_queue_depth(len(self.resume) + len(self.pending))
        return req

    @property
    def has_queued(self) -> bool:
        return bool(self.resume or self.pending)

    @property
    def busy(self) -> bool:
        return any(s.state != FREE for s in self.slots)

    def free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s.state == FREE:
                return i
        return None

    def occupied(self) -> list:
        return [i for i, s in enumerate(self.slots) if s.state != FREE]

    # -- lifecycle ------------------------------------------------------------
    def bind(self, slot: int, req, n_tokens: int, cached: int = 0) -> str:
        """Admit ``req`` (sequence length ``n_tokens``) into ``slot``.
        ``cached`` tokens at the head of the sequence are already resident
        (prefix-cache hit): prefill starts at the first uncached token and
        the saving is charged to the fairness ledger (``cached_tokens``).
        Returns the slot's state: PREFILL (chunks pending) or DECODE
        (nothing left to prefill — single-token, or fully cached)."""
        info = self.slots[slot]
        assert info.state == FREE, (slot, info.state)
        info.req = req
        info.admit_seq = self._admit_counter
        self._admit_counter += 1
        info.target = n_tokens - 1
        info.done = min(cached, info.target)
        info.state = PREFILL if info.done < info.target else DECODE
        st = self._stats(req)
        st["admit_step"] = self.step_count
        if info.done:
            st["cached_tokens"] = st.get("cached_tokens", 0) + info.done
        self.obs.on_admit(req.rid, slot, n_tokens, info.done)
        return info.state

    def mark_prefilled(self, slot: int) -> None:
        """Monolithic path: the whole prompt prefilled at admission."""
        info = self.slots[slot]
        info.done = info.target
        info.state = DECODE

    def on_chunk(self, slot: int, n: int) -> bool:
        """Record ``n`` prefilled tokens; True when prefill completed (the
        slot flips to DECODE and starts decoding next step)."""
        info = self.slots[slot]
        info.done += n
        self._stats(info.req)["prefill_tokens"] = \
            self._stats(info.req).get("prefill_tokens", 0) + n
        self.obs.on_prefill_tokens(n)
        if info.done >= info.target:
            info.state = DECODE
            return True
        return False

    def on_decode_token(self, slot: int) -> None:
        st = self._stats(self.slots[slot].req)
        st["decode_tokens"] = st.get("decode_tokens", 0) + 1
        st.setdefault("first_token_step", self.step_count)

    def on_draft(self, slot: int, drafted: int, accepted: int) -> None:
        """Speculative accounting: ``drafted`` proposed tokens were
        verified this step and ``accepted`` of them survived (the bonus
        token is charged through :meth:`on_decode_token` like any other)."""
        st = self._stats(self.slots[slot].req)
        st["drafted_tokens"] = st.get("drafted_tokens", 0) + drafted
        st["accepted_tokens"] = st.get("accepted_tokens", 0) + accepted

    def release(self, slot: int):
        """Retire / fail / preempt: free the slot, return its request."""
        info = self.slots[slot]
        req = info.req
        self.slots[slot] = SlotInfo()
        return req

    def preempt(self, slot: int):
        """Release + account a preemption; the caller re-enqueues (front)."""
        st = self._stats(self.slots[slot].req)
        st["preemptions"] = st.get("preemptions", 0) + 1
        self.obs.on_preempt(self.slots[slot].req.rid, slot)
        return self.release(slot)

    def preempt_victim(self, exclude=()) -> Optional[int]:
        """Youngest occupied slot by admission order (prefilling or
        decoding) — the cheapest work to throw away and redo."""
        cands = [i for i in self.occupied() if i not in exclude]
        if not cands:
            return None
        return max(cands, key=lambda i: self.slots[i].admit_seq)

    # -- planning -------------------------------------------------------------
    def plan(self) -> StepPlan:
        """One step's worth of work under the token budget."""
        decode_slots = [i for i, s in enumerate(self.slots)
                        if s.state == DECODE]
        budget = self.cfg.token_budget or (
            len(self.slots) * self.cfg.decode_width + self.cfg.chunk)
        left = budget - len(decode_slots) * self.cfg.decode_width
        chunks: list = []
        prefilling = sorted((s.admit_seq, i) for i, s in enumerate(self.slots)
                            if s.state == PREFILL)
        for _, i in prefilling:        # oldest first: finish before starting
            info = self.slots[i]
            done = info.done
            while done < info.target and (left >= self.cfg.chunk
                                          or not chunks):
                n = min(self.cfg.chunk, info.target - done)
                chunks.append(PrefillChunk(slot=i, start=done, n=n))
                done += n
                left -= self.cfg.chunk   # a chunk costs its full shape
            if left < self.cfg.chunk and chunks:
                break
        return StepPlan(chunks=chunks, decode_slots=decode_slots)

    def tick(self) -> None:
        self.step_count += 1

    # -- accounting -----------------------------------------------------------
    def _stats(self, req) -> dict:
        return self.stats.setdefault(req.rid, {})

    def fairness(self, rid) -> dict:
        """Per-request accounting: queueing delay, TTFT in steps, work done,
        prefix-cache savings (``cached_tokens``), preemption count — the
        host-side ledger behind the TTFT/TPOT percentiles in
        benchmarks/serving_bench.py."""
        st = dict(self.stats.get(rid, {}))
        if "enqueue_step" in st and "first_token_step" in st:
            st["ttft_steps"] = st["first_token_step"] - st["enqueue_step"]
        return st
