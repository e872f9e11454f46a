"""Serving engine on PyTorch: the Runtime half of ``repro.serve.engine``.

The policy — admission, the per-step token budget, chunked-prefill
interleaving with decode, fairness accounting — lives in the pure-python
:class:`~repro_torch.serve.scheduler.Scheduler` (a copy of the JAX
package's).  Each :meth:`ServingEngine.step` executes one plan: budgeted
prefill chunks first (``transformer.prefill_chunk``: ``chunk`` tokens of
one slot at a runtime offset, written straight into the slot's cache
rows), then one batched decode across all slots
(``transformer.decode_step``), then greedy or seeded sampling.

This slice of the port serves the contiguous cache with chunked prefill and
plain decode.  ``cache_kind="paged"``, ``prefix_cache``, ``speculative``,
``kv_dtype="int8"``, ``mesh`` and ``prefill_mode="monolithic"`` raise
``NotImplementedError`` naming the ROADMAP slice that brings them.

PyTorch runs eagerly, so there is no executable cache: ``compilations``
reports zero executables of each kind (the kernels are built once, into one
shared library), and ``kernel_launches`` reads the kernel wrappers' launch
counters.  Per-slot sequence state lives on the host as numpy arrays and is
copied to the device once per launch; each decode step makes exactly one
device->host sync, to read the sampled tokens.

Observability is one injectable seam: pass
``observer=repro_torch.obs.Observer(...)``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.famous import FamousConfig
from repro_torch.core.flexible import next_pow2
from repro_torch.kernels import lib
from repro_torch.models import transformer
from repro_torch.obs.runtime import NULL_OBSERVER
from repro_torch.obs.trace import now as _clock
from repro_torch.serve import sampling
from repro_torch.serve.scheduler import DECODE, Scheduler, SchedulerConfig


@dataclasses.dataclass
class Request:
    rid: int
    tokens: list
    max_new: int = 16
    # per-request sampling params: temperature <= 0 -> greedy (default);
    # top_k == 0 -> full-vocab; seed=None falls back to the request id.
    temperature: float = 0.0
    top_k: int = 0
    seed: Optional[int] = None
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    error: Optional[str] = None
    # wall-clock marks for TTFT/TPOT accounting (repro_torch.obs.trace.now)
    t_submit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None


def _not_ported(what: str, slice_name: str):
    return NotImplementedError(
        f"{what} is not ported yet: it comes with {slice_name} "
        "(ROADMAP.md, Queue 1)")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (the default
    everywhere) without a CUDA device raises: the port never drops to the
    CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return dev


class ServingEngine:
    """The Runtime: executes the Scheduler's plans against device state."""

    def __init__(self, params, cfg: ModelConfig, fcfg: FamousConfig,
                 n_slots: int = 4, max_seq: int = 256, dtype=torch.float32,
                 cache_kind: str = "contiguous", prefill_mode: str = "chunked",
                 chunk: int = 32, token_budget: int = 0,
                 prefix_cache: bool = False, speculative: bool = False,
                 kv_dtype: str = "fp", mesh=None, observer=None,
                 device="cuda"):
        """``params``: the spec tree (``init_params(model_spec(cfg))`` or
        ``convert.params_from_jax``) or the serving layout of
        ``transformer.prepare_params``, on ``device``."""
        if cache_kind == "paged":
            raise _not_ported("cache_kind='paged'", "slice 4 (paged KV)")
        if prefix_cache:
            raise _not_ported("prefix_cache", "slice 4 (paged KV and the "
                              "prefix cache)")
        if kv_dtype == "int8":
            raise _not_ported("kv_dtype='int8'", "slice 5 (int8 KV)")
        if speculative:
            raise _not_ported("speculative", "slice 6 (speculative verify)")
        if mesh is not None:
            raise _not_ported("mesh", "slice 10 (tensor-parallel serving)")
        if prefill_mode == "monolithic":
            raise _not_ported("prefill_mode='monolithic'",
                              "slice 7 (monolithic prefill)")
        assert cache_kind == "contiguous", cache_kind
        assert prefill_mode == "chunked", prefill_mode
        assert kv_dtype == "fp", kv_dtype
        self.device = resolve_device(device)
        self.obs = observer if observer is not None else NULL_OBSERVER
        self.params = transformer.prepare_params(params, cfg)
        self.cfg = cfg
        self.fcfg = fcfg
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.dtype = dtype
        self.chunk = min(chunk, max_seq)
        # pads stay inside the cache (positions < ceil(target/C)*C <= max_seq)
        assert max_seq % self.chunk == 0, (max_seq, self.chunk)
        assert self.chunk <= 64 or self.chunk % 64 == 0, self.chunk
        self.sched = Scheduler(n_slots, SchedulerConfig(
            chunk=self.chunk, token_budget=token_budget, decode_width=1),
            observer=self.obs)
        self.caches = transformer.make_caches(cfg, n_slots, max_seq, dtype,
                                              self.device)
        # per-slot sequence state lives on the HOST: slot-granular updates
        # are plain numpy writes, copied to the device once per launch
        self.cache_len = np.zeros((n_slots,), np.int32)
        self.last_token = np.zeros((n_slots,), np.int32)
        self._slot_seq: list[Optional[list]] = [None] * n_slots
        self.obs.register_census(lambda: self.compilations)

    @property
    def compilations(self) -> dict:
        """Executable census.  Eager PyTorch compiles nothing per shape:
        every kind reports 0 (the kernels are one shared library, built
        once per process)."""
        return {"prefill": 0, "decode": 0, "verify": 0, "clear": 0}

    @property
    def kernel_launches(self) -> dict:
        """Launches of each hand-written kernel so far in this process
        (``repro_torch.kernels.lib.STATS``)."""
        return dict(lib.STATS.launches)

    # -- admission ------------------------------------------------------------
    def add_request(self, req: Request) -> int:
        """Admit a request into a free slot.  No prefill happens here: the
        scheduler doles the prompt out as chunks inside :meth:`step`."""
        slot = self.sched.free_slot()
        assert slot is not None, "no free slot"
        seq = list(req.tokens) + list(req.out)
        n = len(seq)
        assert 1 <= n <= self.max_seq
        state = self.sched.bind(slot, req, n, cached=0)
        self._slot_seq[slot] = seq
        if req.t_submit is None:
            req.t_submit = _clock()
        if state == DECODE and self.sched.slots[slot].target == 0:
            # nothing to prefill: clear any stale per-slot state
            transformer.clear_slot(self.caches, slot)
        if state == DECODE:
            # generation restarts at the last prompt token: it is re-decoded
            # so its K/V entry lands at position n-1
            self.cache_len[slot] = n - 1
            self.last_token[slot] = seq[-1]
        else:
            self.cache_len[slot] = 0
        return slot

    # -- the step -------------------------------------------------------------
    def step(self):
        """Execute one scheduler plan: budgeted prefill chunks, then one
        batched decode across the decoding slots.  Returns the requests
        that finished this step."""
        finished = []
        self.obs.on_step(
            queue_depth=len(self.sched.resume) + len(self.sched.pending),
            occupied=len(self.sched.occupied()))
        plan = self.sched.plan()
        for ch in plan.chunks:
            seq = self._slot_seq[ch.slot]
            toks = np.zeros((1, self.chunk), np.int64)
            toks[0, :ch.n] = seq[ch.start:ch.start + ch.n]
            with self.obs.phase("prefill_chunk", slot=ch.slot,
                                rid=self.sched.slots[ch.slot].req.rid,
                                start=ch.start, n=ch.n):
                transformer.prefill_chunk(
                    self.params, torch.from_numpy(toks).to(self.device),
                    self.caches, ch.slot, ch.start, ch.n, self.cfg, self.fcfg)
            self.cache_len[ch.slot] = ch.start + ch.n
            if self.sched.on_chunk(ch.slot, ch.n):
                # prefill complete: decode restarts at the last token,
                # whose K/V entry is then written exactly once at n-1
                self.last_token[ch.slot] = seq[-1]
        self._decode_plain(list(plan.decode_slots), finished)
        self.sched.tick()
        return finished

    def _sampling_operands(self, active):
        """Per-slot sampling operands (host numpy)."""
        temps = np.zeros((self.n_slots,), np.float32)
        topks = np.zeros((self.n_slots,), np.int32)
        seeds = np.zeros((self.n_slots,), np.uint32)
        idxs = np.zeros((self.n_slots,), np.int32)
        for i in active:
            r = self.sched.slots[i].req
            temps[i] = r.temperature
            topks[i] = r.top_k
            seeds[i] = sampling.fold_seed(r.rid if r.seed is None else r.seed)
            idxs[i] = len(r.out)
        return temps, topks, seeds, idxs

    def _maybe_retire(self, i: int, req: Request, now: float,
                      finished: list) -> None:
        """Release the slot when the request hit its length limits."""
        if (len(req.out) >= req.max_new
                or int(self.cache_len[i]) >= self.max_seq - 1):
            req.done = True
            req.t_done = now
            self.obs.on_retire(req, i)
            finished.append(req)
            self.sched.release(i)
            self._slot_seq[i] = None
            self.cache_len[i] = 0

    def _decode_plain(self, active: list, finished: list) -> None:
        if not active:
            return
        act = np.zeros((self.n_slots,), bool)
        act[active] = True
        # the observer phase wraps dispatch AND the step's one device->host
        # sync, so the span is the host-observed decode latency
        with self.obs.phase("decode", slots=len(active)):
            logits, self.caches = transformer.decode_step(
                self.params,
                torch.from_numpy(self.last_token.astype(np.int64)).to(
                    self.device),
                self.caches,
                torch.from_numpy(self.cache_len).to(self.device),
                self.cfg, self.fcfg)
            temps, topks, seeds, idxs = self._sampling_operands(active)
            if temps.any():
                k_cap = next_pow2(max(int(topks.max()), 1))
                next_tok = sampling.sample_tokens(logits, temps, topks, seeds,
                                                  idxs, k_cap=k_cap)
            else:  # all-greedy step (the default)
                next_tok = torch.argmax(logits, dim=-1)
            toks = next_tok.cpu().numpy()   # the step's ONE device->host sync
        self.cache_len[act] += 1
        self.last_token[act] = toks[act]
        self.obs.on_tokens(len(active))
        now = _clock()
        for i in active:
            req = self.sched.slots[i].req
            req.out.append(int(toks[i]))
            if req.t_first is None:
                req.t_first = now
            self.sched.on_decode_token(i)
            self._maybe_retire(i, req, now, finished)

    # -- the loop -------------------------------------------------------------
    def run(self, requests: list[Request], max_steps: int = 1000):
        """Serve ``requests`` to completion.  Exhausting ``max_steps``
        returns *every* request: unfinished ones come back with
        ``req.error`` set, ``done=False`` and whatever ``req.out`` they
        produced."""
        now = _clock()
        for req in requests:
            if req.t_submit is None:
                req.t_submit = now
            self.sched.enqueue(req)
        done = []
        steps = 0
        while (self.sched.has_queued or self.sched.busy) \
                and steps < max_steps:
            while self.sched.has_queued and self.sched.free_slot() is not None:
                self.add_request(self.sched.pop_queued())
            done.extend(self.step())
            steps += 1
        for slot in self.sched.occupied():
            req = self.sched.release(slot)
            self.cache_len[slot] = 0
            self._slot_seq[slot] = None
            req.error = req.error or (
                f"evicted mid-flight at max_steps={max_steps}")
            done.append(req)
        for req in self.sched.resume:
            req.error = req.error or (
                f"preempted and not resumed within max_steps={max_steps}")
            done.append(req)
        self.sched.resume = []
        for req in self.sched.pending:
            req.error = req.error or (
                f"never admitted within max_steps={max_steps}")
            done.append(req)
        self.sched.pending = []
        now = _clock()
        for req in done:
            if req.error is not None and req.t_done is None:
                req.t_done = now
                self.obs.on_retire(req)
        return done
