"""Serving engine on PyTorch: the Runtime half of ``repro.serve.engine``.

The policy — admission, the per-step token budget, chunked-prefill
interleaving with decode, fairness accounting — lives in the pure-python
:class:`~repro_torch.serve.scheduler.Scheduler` (a copy of the JAX
package's).  Each :meth:`ServingEngine.step` executes one plan: budgeted
prefill chunks first (``transformer.prefill_chunk``: ``chunk`` tokens of
one slot at a runtime offset, written straight into the slot's cache
rows), then one batched decode across all slots
(``transformer.decode_step``), then greedy or seeded sampling.  With
``prefill_mode="monolithic"`` (JAX's comparison path) admission instead
prefills the whole prompt at once (``transformer.prefill`` into a batch-1
contiguous scratch cache, then ``transformer.write_prefill_to_slot``):
zero-padded to a power-of-two bucket for stacks of global and local
attention only (``bucketed``), at its exact length for recurrent stacks,
whose state would absorb the pad.  With
``speculative=True`` the decode is replaced by one verify step
(``transformer.verify_step``, width ``draft_k + 1``): a host-side
prompt-lookup drafter proposes tokens, the verify forward scores all of
them at once, and the engine accepts the longest prefix the model agrees
with plus the model's own next token (token-identical to plain decode),
rolling back the rest by bookkeeping.

The KV cache is per-slot contiguous stripes (rings for sliding-window
layers; RG-LRU and RWKV-6 layers keep per-slot recurrent state, which the
decode step commits only for the slots it decodes), or
(``cache_kind="paged"``) one shared page pool per global-attention layer
with the host-side
:class:`~repro_torch.serve.paged.PageAllocator` doing admission control,
youngest-first preemption and, with ``prefix_cache=True``, aliasing of
identical full prompt blocks across requests (admission maps cached
blocks into the page table and prefill starts at the first uncached
token; retirement publishes the prompt's blocks onto the cached-free
LRU).  ``kv_dtype="int8"`` (paged only) quantizes K/V at write time and
the paged kernels dequantize in their tiles.  ``FamousConfig(impl=
"pallas", quant="int8")`` runs every QKV projection through the int8
kernel on weights quantized once here.

``mesh`` (``launch.mesh.make_serving_mesh(tp, dp)``, a ``DeviceMesh``
over one process a rank, ("data", "model") or ("pod", "data",
"model")): the JAX engine's ``mesh=`` places params and caches with
``NamedSharding``s under ``sharding_rules`` (default ``SERVE_TP_RULES``)
and GSPMD computes the rest; here every rank holds the same shards
(``transformer.shard_params``, ``make_caches(mesh=)``) under any rule set
of ``parallel/sharding.py`` and runs this whole engine — scheduler,
allocator, drafter, sampler — in lockstep with the others:

  * tensor parallelism over "model": attention heads and kv heads (a
    rank's query heads may span several whole kv heads), RWKV-6 heads,
    the FFN / LRU hidden and MoE experts, the row-parallel products
    summed over the "model" group;
  * a vocabulary over "model" (TP_ONLY / DEFAULT / ZERO_SEQ rules):
    the vocab-parallel lookup, and the head's logits gathered over
    "model" inside the decode and verify steps, as JAX pins them
    replicated, so every rank samples the same tokens;
  * every other sharded dim ("embed" over "data" or every axis, grok-1's
    "expert_ff", RWKV-6 columns that would cut a head) gathered at each
    step inside the layer that reads it (``transformer.ServeLayout``);
  * replica groups (the slot axis "batch" over "pod" and "data"): the
    contiguous caches' and recurrent states' slots are cut over the
    groups (``transformer.slot_range``); a decode or verify step computes
    the group's slots and gathers the logits over the groups; a chunk,
    a monolithic prefill or a clear of slot s runs on s's group, while
    the other groups run the step's gathers alone
    (``ServeLayout.shadow``).  Page pools have no slot axis: every group
    holds the whole pool and computes every slot of an all-attention
    stack (a hybrid stack's rings and states are per slot, so its
    groups compute their own slots and write their slots' pages).

Over a mesh of one rank nothing is cut and no collective runs: the
engine is bit-identical to ``mesh=None``.  Graphs capture the
collectives in the steps (the first, eager call makes the
communicator); a backend whose collectives cannot be captured (gloo, as
when several ranks share one card) raises at capture, so such a mesh
serves inside ``graphs.disable_capture()``.

The executables (``serve/graphs.py``): on a CUDA device the prefill chunk
(or, monolithic, the prefill of each padded length, one graph a length),
``clear_slot``, the decode step and the verify step each run as a
captured CUDA graph, the steps with the greedy argmax in the same graph,
and the sampler of each step as graphs keyed ``(kind, k_cap)``, as JAX's
``_sample`` is keyed by its static ``k_cap``.  The chunk's ``slot``,
``offset`` and ``n_valid`` and the cleared slot are runtime scalars
staged into device buffers that the kernels and index ops read there,
so one chunk graph serves every (slot, offset, n_valid) and one clear
graph every slot, as JAX jits both once with traced scalars.
``compilations`` counts the captured ``prefill``, ``decode``, ``verify``
and ``clear`` graphs (at most one each when prefill is chunked: the
engine has one static shape of each; a monolithic engine one ``prefill``
graph per length used twice); the sampler graphs are not counted, as JAX
does not count ``_sample``.  On the CPU, or inside ``graphs.disable_capture()``, every
step runs eagerly on the same static buffers and the census stays all
zeros.  ``kernel_launches`` reads the kernel wrappers' launch counters,
replays included.  Per-slot sequence state lives on the host as numpy
arrays and is copied, from pinned staging buffers without blocking, into
the executables' static input buffers before each call (the page table
only when the allocator changed it; the chunk's inputs from a ring of
host copies, so the chunks of one step never wait on each other's
transfers); caches and params are never reallocated, so the graphs'
addresses stay valid.  Each decode step makes exactly one device->host
sync, to read the sampled tokens; a chunk makes none.

The prefill and clear graphs have a memory pool of their own: they return
nothing (the caches they update were allocated before any capture), but
in a pool shared with the steps, whichever graph is captured second may
place its live outputs in blocks the other uses as scratch, and which
comes second depends on the traffic.  Apart, no replay can overwrite
what another graph returned.

Observability is one injectable seam: pass
``observer=repro_torch.obs.Observer(...)``.  With an observer that traces
(``observer.tracer`` set), :meth:`ServingEngine.step` opens a ``step`` span
holding ``plan``, ``stage`` (the static inputs' puts), ``replay`` (each
executable call, by kind), ``wait`` (the host blocked on the device: the
step's sync and any staging stall) and ``emit`` (token bookkeeping and
retirement); on CUDA each executable call is timed between CUDA events,
read after the step's sync (``graphs.ExecTimer``); an MoE stack adds each
layer call's routing to one int64 device accumulator inside the
executables (``moe.count_routing``), read only when the observer is
pulled.  Without one, none of that exists: no event, no accumulator, the
same graphs.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ATTN, LOCAL_ATTN, RWKV6, ModelConfig
from repro_torch.core.famous import FamousConfig
from repro_torch.core.flexible import next_pow2
from repro_torch.kernels import lib
from repro_torch.models import rwkv6, transformer
from repro_torch.obs.runtime import NULL_OBSERVER
from repro_torch.obs.trace import now as _clock
from repro_torch.parallel import sharding as shd
from repro_torch.serve import graphs, sampling
from repro_torch.serve.draft import PromptLookupDrafter
from repro_torch.serve.paged import (PageAllocator, PagedCacheConfig,
                                     PagePoolExhausted, block_hashes)
from repro_torch.serve.scheduler import (DECODE, PREFILL, Scheduler,
                                         SchedulerConfig)


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
    error: Optional[str] = None  # set when the page pool can never back it
    # wall-clock marks for TTFT/TPOT accounting (repro_torch.obs.trace.now)
    t_submit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None


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
                 cache_kind: str = "contiguous", page_size: int = 16,
                 n_pages: Optional[int] = None, prefill_mode: str = "chunked",
                 chunk: int = 32, token_budget: int = 0,
                 prefix_cache: bool = False, speculative: bool = False,
                 draft_k: int = 4, drafter=None, kv_dtype: str = "fp",
                 mesh=None, sharding_rules=None, observer=None,
                 device="cuda"):
        """``params``: the spec tree (``init_params(model_spec(cfg))`` or
        ``convert.params_from_jax``) or the serving layout of
        ``transformer.prepare_params``, on ``device``.  ``n_pages`` (paged
        only) counts the null page; ``None`` backs a full batch of
        ``max_seq`` sequences, less oversubscribes the pool.
        ``speculative``: verify up to ``draft_k`` drafted tokens a step;
        ``drafter`` is any object with ``draft(seq, k) -> list`` (default
        :class:`~repro_torch.serve.draft.PromptLookupDrafter`).
        ``mesh``: a serving mesh and ``sharding_rules`` a rule set of
        ``parallel/sharding.py`` (see the module docstring); ``params``
        must then be the spec tree (or its rank's shards)."""
        if draft_k < 1:
            raise ValueError(f"draft_k must be at least 1, got {draft_k}")
        if fcfg.quant not in ("none", "int8"):
            raise ValueError(f"quant {fcfg.quant!r}")
        if cache_kind not in ("contiguous", "paged"):
            raise ValueError(f"cache_kind {cache_kind!r}")
        if prefill_mode not in ("chunked", "monolithic"):
            raise ValueError(f"prefill_mode {prefill_mode!r}")
        if kv_dtype not in ("fp", "int8"):
            raise ValueError(f"kv_dtype {kv_dtype!r}")
        if kv_dtype == "int8" and cache_kind != "paged":
            raise ValueError("kv_dtype='int8' requires cache_kind='paged'")
        if prefix_cache and (cache_kind != "paged"
                             or prefill_mode != "chunked"):
            raise ValueError("prefix_cache requires cache_kind='paged' and "
                             "chunked prefill")
        if cfg.is_mla and (speculative or prefill_mode != "chunked"):
            raise ValueError(f"{cfg.name}: latent attention serves with "
                             "chunked prefill and plain decode; speculative "
                             "verify and monolithic prefill are not "
                             "supported for it")
        self.device = resolve_device(device)
        self.obs = observer if observer is not None else NULL_OBSERVER
        self._span = self.obs.span
        tracing = self.obs.tracer is not None
        # device time per executable call, where the events exist
        self._timer = (graphs.ExecTimer(self.device, self.obs)
                       if tracing and self.device.type == "cuda" else None)
        # [real choices, kept, dropped, capacity rows, held] over MoE layer
        # calls (held: real choices that land on this chip's experts, for
        # the dropless router; moe.count_dropless)
        self._moe_counts = (torch.zeros(5, dtype=torch.int64,
                                        device=self.device)
                            if tracing and cfg.num_experts else None)
        if self._moe_counts is not None:
            self.obs.register_routing(self._read_routing)
        self.mesh = mesh
        rules = sharding_rules or shd.SERVE_TP_RULES
        mesh_kw = {"mesh": mesh, "rules": rules} if mesh is not None else {}
        self.params = (transformer.shard_params(params, cfg, mesh, rules)
                       if mesh is not None
                       else transformer.prepare_params(params, cfg))
        if fcfg.quant == "int8" and fcfg.impl == "pallas":
            # the int8 kernel's W, quantized once here (JAX: every call)
            self.params = transformer.quantize_qkv(self.params)
        self.cfg = cfg
        self.fcfg = fcfg
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.dtype = dtype
        self.paged = cache_kind == "paged"
        self.chunked = prefill_mode == "chunked"
        self.chunk = min(chunk, max_seq)
        if self.chunked:
            # pads stay inside the cache (positions < ceil(target/C)*C <=
            # max_seq) and the wkv6 chunked form needs S % min(64, S) == 0
            assert max_seq % self.chunk == 0, (max_seq, self.chunk)
            assert self.chunk <= 64 or self.chunk % 64 == 0, self.chunk
        # recurrent state cannot absorb junk pad tokens, so the monolithic
        # path prefills those stacks at exact length (chunks mask pads)
        self.bucketed = all(k in (ATTN, LOCAL_ATTN) for k in cfg.pattern_unit)
        # -- speculative decoding -------------------------------------------
        # The verify step writes K/V at [cache_len, cache_len + W) and rolls
        # back by bookkeeping only: rejected positions hold junk that is
        # masked and overwritten before it is read.  That needs position-
        # addressed storage: sliding-window rings overwrite their oldest
        # rows and recurrent state cannot rewind, so only all-global-
        # attention stacks run speculatively; the others decode plainly
        # (``speculative_active`` False), as in the JAX engine.
        self.draft_k = draft_k
        all_attn = all(k == ATTN for k in transformer.layer_kinds(cfg))
        self.speculative_active = speculative and all_attn
        self.drafter = drafter if drafter is not None else \
            PromptLookupDrafter(observer=self.obs)
        self.spec_steps = 0      # verify steps executed
        self.spec_drafted = 0    # draft tokens proposed to the verifier
        self.spec_accepted = 0   # draft tokens accepted (bonus excluded)
        self.sched = Scheduler(n_slots, SchedulerConfig(
            chunk=self.chunk, token_budget=token_budget,
            decode_width=(draft_k + 1) if self.speculative_active else 1),
            observer=self.obs)
        if self.paged:
            assert max_seq % page_size == 0, (max_seq, page_size)
            if n_pages is None:
                n_pages = PagedCacheConfig.default_pool(n_slots, max_seq,
                                                        page_size)
            self.pcfg = PagedCacheConfig(page_size=page_size, n_pages=n_pages)
            self.alloc = PageAllocator(self.pcfg, n_slots, max_seq,
                                       observer=self.obs)
            self.caches = transformer.make_caches(
                cfg, n_slots, max_seq, dtype, self.device, cache_kind="paged",
                page_size=page_size, n_pages=n_pages, kv_dtype=kv_dtype,
                **mesh_kw)
        else:
            self.caches = transformer.make_caches(cfg, n_slots, max_seq,
                                                  dtype, self.device,
                                                  **mesh_kw)
        # the slots this rank computes where the groups cut the slot axis
        self._rows = None if mesh is None else transformer.slot_range(
            cfg, n_slots, mesh, rules, cache_kind, kv_dtype)
        self._first_slot = 0 if self._rows is None else self._rows[0]
        self._comm = None if self._rows is None else shd.MeshComm(mesh, rules)
        # aliasing cached prompt blocks needs an architecture whose whole
        # prefix state lives in the page pool: rings and recurrent state are
        # per slot and not content-addressable, so hybrid and recurrent
        # stacks prefill cold (``prefix_cache_active`` False), as in JAX
        self.prefix_cache_active = prefix_cache and all_attn
        self.prefix_hit_pages = 0      # pages aliased instead of allocated
        self.prefix_hit_tokens = 0     # tokens whose prefill was skipped
        self._slot_hashes: list[Optional[list]] = [None] * n_slots
        # per-slot sequence state lives on the HOST: slot-granular updates
        # are plain numpy writes, copied to the device once per launch
        self.cache_len = np.zeros((n_slots,), np.int32)
        self.last_token = np.zeros((n_slots,), np.int32)
        self._slot_seq: list[Optional[list]] = [None] * n_slots
        self._failed: list[Request] = []
        self._pt_version = -1          # page-table version on the device
        # -- the executables: static inputs, staged from pinned host copies
        wait = functools.partial(self._span, "wait", on="stage")

        def static(shape, dtype, depth=1):
            return graphs.StaticInput(shape, dtype, self.device, depth, wait)

        W = draft_k + 1
        self._in = {
            "tokens": static((n_slots, W) if self.speculative_active
                             else (n_slots,), torch.int64),
            "cache_len": static((n_slots,), torch.int32),
            "active": static((n_slots,), torch.bool),
            "temperature": static((n_slots,), torch.float32),
            "top_k": static((n_slots,), torch.int64),
            "seed": static((n_slots,), torch.int64),
            "index": static((n_slots,), torch.int64),
        }
        # the chunk's tokens and its (slot, offset, n_valid): a ring of
        # host copies one deeper than a step's most chunks (the scheduler
        # plans at most budget // chunk, and always one)
        budget = self.sched.cfg.token_budget or (
            n_slots * self.sched.cfg.decode_width + self.chunk)
        depth = max(1, budget // self.chunk) + 1
        self._in["chunk_tokens"] = static((1, self.chunk), torch.int64, depth)
        self._in["chunk_scalars"] = static((3,), torch.int32, depth)
        self._in["clear_slot"] = static((1,), torch.int32)
        if self.paged:
            self._in["page_table"] = static(self.alloc.page_table.shape,
                                            torch.int32)
        # page pools have no slot axis: an all-global-attention paged stack
        # holds no per-slot state for clear_slot to zero
        self._has_slot_state = not (self.paged and all_attn)
        if not self.chunked:
            # the monolithic prefill's inputs: the slot, and a token
            # buffer per padded length (made at its first use); the
            # prompt is prefilled into one batch-1 contiguous scratch cache
            self._in["prefill_slot"] = static((1,), torch.int32, 2)
            self._prefill_tokens: dict[int, graphs.StaticInput] = {}
            self._scratch = transformer.make_caches(
                cfg, 1, max_seq, dtype, self.device, slots=n_slots,
                **mesh_kw)
        self._pool = graphs.GraphPool(self.device)
        self._chunk_pool = graphs.GraphPool(self.device)
        if mesh is not None and math.prod(shd.axis_sizes(mesh).values()) > 1:
            import torch.distributed as dist
            backend = str(dist.get_backend())
            if backend != "nccl":
                # a gloo collective stages through the host: no graph can
                # hold it
                self._pool.blocker = self._chunk_pool.blocker = (
                    f"the {backend} collectives over this mesh cannot be "
                    f"captured in a CUDA graph: serve it inside "
                    f"repro_torch.serve.graphs.disable_capture()")
        self._exec = {kind: graphs.Executable(
            functools.partial(self._step_fn, kind), self._pool)
            for kind in ("decode", "verify")}
        self._exec["prefill"] = graphs.Executable(
            self._prefill_chunk_fn if self.chunked else self._prefill_fn,
            self._chunk_pool)
        self._exec["clear"] = graphs.Executable(self._clear_fn,
                                                self._chunk_pool)
        self.obs.register_census(lambda: self.compilations)

    @property
    def compilations(self) -> dict:
        """Executable census: captured CUDA graphs of each kind (the
        samplers' graphs, keyed ``(kind, k_cap)``, are not counted)."""
        return {kind: sum(not isinstance(k, tuple)
                          for k in self._exec[kind].graph_keys)
                for kind in ("prefill", "decode", "verify", "clear")}

    @property
    def prefill_compilations(self) -> int:
        """Captured prefill graphs: at most one chunked, one per padded
        length used twice or more monolithic (JAX counts the executables
        it compiled, one per length; :attr:`prefill_keys` is that
        count's counterpart on every device)."""
        return self.compilations["prefill"]

    @property
    def prefill_keys(self) -> list:
        """The keys the prefill executable has run under: ``"prefill"``
        for the chunk, the padded lengths when monolithic (JAX's
        ``_prefill_exec`` keys)."""
        return self._exec["prefill"].keys

    @property
    def graph_stats(self) -> dict:
        """What the executables cost and did: captured keys, replays, the
        seconds spent capturing and the device memory their pools reserved
        (in all, and for the steps' pool and the chunk's apart), and the
        chunk inputs' staging stalls (puts that waited on a transfer still
        pending, and their host seconds)."""
        pools = {"step": self._pool, "prefill": self._chunk_pool}
        staged = [self._in[n] for n in ("chunk_tokens", "chunk_scalars")]
        return {"keys": {k: [str(x) for x in e.graph_keys]
                         for k, e in self._exec.items()},
                "replays": {k: e.replays for k, e in self._exec.items()},
                "capture_s": sum(p.capture_s for p in pools.values()),
                "pool_bytes": sum(p.bytes for p in pools.values()),
                "pools": {k: {"capture_s": p.capture_s, "bytes": p.bytes}
                          for k, p in pools.items()},
                "chunk_stalls": sum(x.stalls for x in staged),
                "chunk_stall_s": sum(x.stall_s for x in staged)}

    def _read_routing(self) -> dict:
        """The MoE routing totals (one copy to the host, which syncs:
        device spans still unread are read after it)."""
        real, kept, dropped, rows, held = self._moe_counts.tolist()
        if self._timer is not None:
            self._timer.synced()
        out = {"real": real, "kept": kept, "dropped": dropped,
               "capacity_rows": rows}
        if self.cfg.scoring_func == "sigmoid":
            out["held"] = held
        return out

    @property
    def acceptance_rate(self) -> float:
        """Accepted draft tokens / proposed draft tokens (bonus excluded)."""
        return self.spec_accepted / max(self.spec_drafted, 1)

    @property
    def accepted_per_step(self) -> float:
        """Mean tokens emitted per verify step (1.0 = plain-decode pace)."""
        return ((self.spec_steps + self.spec_accepted)
                / max(self.spec_steps, 1))

    @property
    def kernel_launches(self) -> dict:
        """Launches of each hand-written kernel so far in this process
        (``repro_torch.kernels.lib.STATS``)."""
        return dict(lib.STATS.launches)

    def cache_bytes_per_device(self) -> int:
        """KV and state cache bytes resident on this rank's device: the
        pools and, for int8, their scale pools; under a mesh this rank's
        shards only (about 1/TP of the unsharded total where the kv-head
        or hidden dims shard, 1/dp of the per-slot leaves where replica
        groups cut the slots; a page pool stays whole on every group)."""
        return sum(buf.numel() * buf.element_size()
                   for cache in self.caches for buf in cache.values())

    def _owns(self, slot: int) -> bool:
        """Whether this rank's replica group computes ``slot``."""
        return self._rows is None or self._rows[0] <= slot < self._rows[1]

    def _local(self, t: torch.Tensor) -> torch.Tensor:
        """The rows of a per-slot input (or the page table) that this
        rank's group computes: a view, the whole tensor without groups."""
        return t if self._rows is None else t[self._rows[0]:self._rows[1]]

    def _shadow(self, head: bool) -> None:
        """A prefill of a slot another group owns: its gathers alone."""
        self.params["layout"].shadow(self.params, head)

    def _page_table(self):
        """The static device page table, copied into only when the
        allocator mutated it (steady-state decode reuses it)."""
        if self._pt_version != self.alloc.version:
            self._in["page_table"].put(self.alloc.page_table)
            self._pt_version = self.alloc.version
        return self._in["page_table"].tensor

    # -- the step functions (graphs.Executable bodies) ------------------------
    def _prefill_chunk_fn(self, key):
        """The chunked ``"prefill"`` executable's body (JAX's
        ``_prefill_chunk_exec``): one chunk of the staged tokens at the
        staged (slot, offset, n_valid), read on the device.  Returns
        nothing: the caches are updated in place."""
        sc = self._in["chunk_scalars"].tensor
        kw = {"page_table": self._local(self._in["page_table"].tensor)} \
            if self.paged else {}
        if self._moe_counts is not None:
            kw["moe_counts"] = (self._moe_counts, torch.arange(
                self.chunk, device=self.device) < sc[2])
        transformer.prefill_chunk(self.params, self._in["chunk_tokens"].tensor,
                                  self.caches, sc[0:1], sc[1:2], sc[2:3],
                                  self.cfg, self.fcfg, **kw)
        return ()

    def _prefill_fn(self, length: int):
        """The monolithic ``"prefill"`` executable's body for one padded
        ``length`` (JAX's ``_prefill_fn``): the staged prompt prefilled
        from a zeroed batch-1 scratch cache, then written into the staged
        slot (its stripes, or, paged, its pages through its page-table
        row, gathered on the device).  Returns nothing."""
        for cache in self._scratch:
            for buf in cache.values():
                buf.zero_()
        transformer.prefill(self.params, self._prefill_tokens[length].tensor,
                            self._scratch, self.cfg, self.fcfg)
        slot = self._in["prefill_slot"].tensor
        page_ids = (self._local(self._in["page_table"].tensor)
                    .index_select(0, slot)[0] if self.paged else None)
        transformer.write_prefill_to_slot(self.caches, self._scratch, slot,
                                          self.cfg, page_ids=page_ids)
        return ()

    def _prefill_monolithic(self, slot: int, seq: list) -> None:
        """Prefill ``seq[:-1]`` into ``slot`` in one call: zero-padded to
        its power-of-two bucket (at most ``max_seq``) when ``bucketed``,
        else at its exact length."""
        m = len(seq) - 1
        plen = min(next_pow2(m), self.max_seq) if self.bucketed else m
        if plen not in self._prefill_tokens:
            self._prefill_tokens[plen] = graphs.StaticInput(
                (1, plen), torch.int64, self.device, 2)
        toks = np.zeros((1, plen), np.int64)
        toks[0, :m] = seq[:m]
        with self.obs.phase("prefill", slot=slot,
                            rid=self.sched.slots[slot].req.rid, n=m,
                            length=plen):
            if self.paged:
                self._page_table()
            if self._owns(slot):
                with self._span("stage"):
                    self._prefill_tokens[plen].put(toks)
                    self._in["prefill_slot"].put((slot - self._first_slot,))
                self._call("prefill", plen)
            else:
                self._shadow(head=True)

    def _clear_fn(self, key):
        """The ``"clear"`` executable's body: ``clear_slot`` at the staged
        slot."""
        transformer.clear_slot(self.caches, self._in["clear_slot"].tensor,
                               self.cfg, paged=self.paged)
        return ()

    def _step_fn(self, kind: str, key):
        """The ``kind`` executable's body.  Key ``kind``: the decode step
        over every slot (``"decode"``) or the verify step of width
        ``draft_k + 1`` (``"verify"``) on the static inputs, and its greedy
        tokens.  Key ``(kind, k_cap)``: the sampler on that step's
        logits."""
        if key == kind:
            kw = {"page_table": self._local(self._in["page_table"].tensor)} \
                if self.paged else {}
            if kind == "decode":
                step, kw["active"] = (transformer.decode_step,
                                      self._local(self._in["active"].tensor))
            else:
                step = transformer.verify_step
            if self._rows is not None and self.cfg.num_experts:
                kw["slot_rows"] = (self._gather_slots, *self._rows[:2])
            if self._moe_counts is not None:
                # an MoE layer routes every slot's rows under replica
                # groups, the group's own without
                act = self._in["active"].tensor
                if self._rows is None:
                    act = self._local(act)
                if kind == "verify":
                    act = act[:, None].expand(-1, self.draft_k + 1)
                kw["moe_counts"] = (self._moe_counts, act.reshape(-1))
            logits, _ = step(self.params,
                             self._local(self._in["tokens"].tensor),
                             self.caches,
                             self._local(self._in["cache_len"].tensor),
                             self.cfg, self.fcfg, **kw)
            if self._rows is not None:
                logits = self._gather_slots(logits)
            return logits, torch.argmax(logits, dim=-1)
        sample = sampling.sample_tokens if kind == "decode" \
            else sampling.verify_tokens
        return sample(self._exec[kind].outputs[kind][0],
                      *(self._in[n].tensor for n in
                        ("temperature", "top_k", "seed", "index")),
                      k_cap=key[1])

    def _gather_slots(self, x: torch.Tensor) -> torch.Tensor:
        """Every group's slot rows of ``x`` (this group's, (B / dp, ...)),
        gathered over the groups' axes."""
        return self._comm.gather(x, (self._rows[2],) + (None,) * (x.ndim - 1))

    def _call(self, kind: str, key):
        """Executable ``kind`` at ``key``, inside a ``replay`` span named by
        what it runs (the sampler's keys are tuples) and, when the timer
        exists, between its CUDA events."""
        name = "sample" if isinstance(key, tuple) else kind
        with self._span("replay", exec=name):
            if self._timer is None:
                return self._exec[kind](key)
            start = self._timer.start()
            out = self._exec[kind](key)
            self._timer.stop(name, self.obs.step, start)
            return out

    def _run_step(self, kind: str, active: list):
        """Run the ``kind`` step on the staged inputs, then its sampler
        where a request samples.  Returns the tokens (device)."""
        _, greedy = self._call(kind, kind)
        temps, topks, seeds, idxs = self._sampling_operands(active)
        if not temps.any():              # an all-greedy step (the default)
            return greedy
        with self._span("stage"):
            for name, v in (("temperature", temps), ("top_k", topks),
                            ("seed", seeds), ("index", idxs)):
                self._in[name].put(v)
        k_cap = next_pow2(max(int(topks.max()), 1))
        return self._call(kind, (kind, k_cap))

    # -- admission ------------------------------------------------------------
    def _prefix_hashes(self, req: Request, n: int):
        """(prompt-block hashes, lookup cap) for an admission of total
        sequence length ``n``.  Only full prompt blocks inside the first
        ``n - 1`` tokens may be aliased: decode restarts at token ``n - 1``
        and writes its K/V, so the page holding position ``n - 1`` must be
        private.  Memoized on the request (a request deferred at the queue
        head is probed every step)."""
        ps = self.pcfg.page_size
        cached = getattr(req, "_block_hashes", None)
        if cached is None or cached[0] != ps:
            cached = (ps, block_hashes(req.tokens, ps))
            req._block_hashes = cached
        hashes = cached[1]
        return hashes, min(len(hashes), (n - 1) // ps)

    def add_request(self, req: Request) -> int:
        """Admit a request into a free slot.  Chunked, no prefill happens
        here: the scheduler doles the prompt out as chunks inside
        :meth:`step`; monolithic, the whole prompt is prefilled now (an
        RWKV-6 stack takes prefill lengths up to 64 or multiples of 64, and
        raises ``ValueError`` for others before any state changes).  Paged
        mode reserves the sequence's pages first; on
        :class:`PagePoolExhausted` the engine state is untouched.  With the
        prefix cache, every full prompt block that hits the index is
        aliased into the slot's page table and prefill starts at the first
        uncached token.  A preempted request (non-empty ``req.out``)
        re-prefills prompt + generated-so-far, minus any cached head."""
        slot = self.sched.free_slot()
        assert slot is not None, "no free slot"
        seq = list(req.tokens) + list(req.out)
        n = len(seq)
        assert 1 <= n <= self.max_seq
        if not self.chunked and n > 1 and not self.bucketed and \
                RWKV6 in transformer.layer_kinds(self.cfg):
            # the chunked wkv6 form's length rule, checked before any
            # state changes (JAX asserts it inside the prefill)
            rwkv6.wkv6_chunk_len(n - 1)
        n_cached = 0
        if self.paged:
            if self.prefix_cache_active:
                hashes, cap = self._prefix_hashes(req, n)
                hits = self.alloc.lookup(hashes[:cap])
                self.obs.on_prefix_lookup(req.rid, len(hits),
                                          len(hits) * self.pcfg.page_size)
                if hits:
                    self.alloc.map_prefix(slot, hits)
                    n_cached = len(hits) * self.pcfg.page_size
                    self.prefix_hit_pages += len(hits)
                    self.prefix_hit_tokens += n_cached
                self._slot_hashes[slot] = hashes
            try:
                self.alloc.grow(slot, n)  # PagePoolExhausted if oversize
            except PagePoolExhausted:
                self.alloc.free(slot)     # roll back any mapped prefix
                self._slot_hashes[slot] = None
                raise
        state = self.sched.bind(slot, req, n, cached=n_cached)
        self._slot_seq[slot] = seq
        if req.t_submit is None:
            req.t_submit = _clock()
        if not self.chunked and state == PREFILL:
            self._prefill_monolithic(slot, seq)
            self.sched.mark_prefilled(slot)
            state = DECODE
        if (state == DECODE and self.sched.slots[slot].target == 0
                and self._has_slot_state and self._owns(slot)):
            # nothing to prefill: clear any stale per-slot state
            with self._span("stage"):
                self._in["clear_slot"].put(slot - self._first_slot)
            self._call("clear", "clear")
        if state == DECODE:
            # generation restarts at the last prompt token: it is re-decoded
            # so its K/V entry lands at position n-1 (a private page, even
            # when everything before it was a prefix-cache hit)
            self.cache_len[slot] = n - 1
            self.last_token[slot] = seq[-1]
        else:
            self.cache_len[slot] = n_cached
        return slot

    # -- preemption / page growth ---------------------------------------------
    def _preempt(self, slot: int) -> None:
        """Evict a running sequence: free its pages and queue it for
        re-admission ahead of fresh requests.  Its generated tokens stay on
        the request; resuming is a longer chunked prefill."""
        req = self.sched.preempt(slot)
        self.cache_len[slot] = 0
        self._slot_seq[slot] = None
        self._slot_hashes[slot] = None   # partial prefill: never published
        self.alloc.free(slot)
        self.sched.enqueue(req, front=True)

    def _fail_slot(self, slot: int, err: str) -> None:
        req = self.sched.release(slot)
        req.error, req.done = err, True
        req.t_done = _clock()
        self.cache_len[slot] = 0
        self._slot_seq[slot] = None
        self._slot_hashes[slot] = None
        if self.paged:
            self.alloc.free(slot)
        self.obs.on_retire(req, slot)
        self._failed.append(req)

    def _grow_active(self, active: list) -> list:
        """Reserve the next token's page for every decoding slot, preempting
        youngest-first when the pool runs dry.  A lone sequence that cannot
        grow is failed rather than crashing."""
        for i in list(active):
            if i not in active:
                continue
            while True:
                try:
                    self.alloc.grow(i, int(self.cache_len[i]) + 1)
                    break
                except PagePoolExhausted as e:
                    victim = self.sched.preempt_victim()
                    if victim == i and len(self.sched.occupied()) == 1:
                        self._fail_slot(i, str(e))
                        active.remove(i)
                        break
                    self._preempt(victim)
                    if victim in active:
                        active.remove(victim)
                    if victim == i:
                        break
        return active

    # -- the step -------------------------------------------------------------
    def step(self):
        """Execute one scheduler plan: budgeted prefill chunks, then one
        batched decode across the decoding slots.  Returns the requests
        that finished (or, paged, failed) this step."""
        finished = []
        self.obs.on_step(
            queue_depth=len(self.sched.resume) + len(self.sched.pending),
            occupied=len(self.sched.occupied()))
        with self._span("step"):
            with self._span("plan"):
                plan = self.sched.plan()
            if self.paged and plan.chunks:
                with self._span("stage"):
                    self._page_table()
            for ch in plan.chunks:
                self._check_chunk(ch.slot, ch.start, ch.n)
                seq = self._slot_seq[ch.slot]
                toks = np.zeros((1, self.chunk), np.int64)
                toks[0, :ch.n] = seq[ch.start:ch.start + ch.n]
                with self.obs.phase("prefill_chunk", slot=ch.slot,
                                    rid=self.sched.slots[ch.slot].req.rid,
                                    start=ch.start, n=ch.n):
                    if self._owns(ch.slot):
                        with self._span("stage"):
                            self._in["chunk_tokens"].put(toks)
                            self._in["chunk_scalars"].put(
                                (ch.slot - self._first_slot, ch.start, ch.n))
                        self._call("prefill", "prefill")
                    else:
                        self._shadow(head=False)
                self.cache_len[ch.slot] = ch.start + ch.n
                if self.sched.on_chunk(ch.slot, ch.n):
                    # prefill complete: decode restarts at the last token,
                    # whose K/V entry is then written exactly once at n-1
                    self.last_token[ch.slot] = seq[-1]
            if self.speculative_active:
                self._decode_speculative(list(plan.decode_slots), finished)
            else:
                self._decode_plain(list(plan.decode_slots), finished)
            self.sched.tick()
        return finished

    def _check_chunk(self, slot: int, start: int, n: int) -> None:
        """The chunk's runtime scalars, checked on the host before they are
        staged (the kernels and index ops read them on the device, where
        nothing can check them): a slot of the batch, 1..chunk real
        tokens, and, for contiguous stripes, the chunk inside
        ``max_seq`` (a paged chunk's pad rows past the table land on the
        null page)."""
        if not (0 <= slot < self.n_slots and 1 <= n <= self.chunk
                and start >= 0
                and (self.paged or start + self.chunk <= self.max_seq)):
            raise ValueError(f"chunk of slot {slot} at {start} with {n} "
                             f"tokens outside {self.n_slots} slots x "
                             f"{self.max_seq} positions (chunk "
                             f"{self.chunk})")

    def _sampling_operands(self, active):
        """Per-slot sampling operands (host numpy)."""
        temps = np.zeros((self.n_slots,), np.float32)
        topks = np.zeros((self.n_slots,), np.int64)
        seeds = np.zeros((self.n_slots,), np.int64)
        idxs = np.zeros((self.n_slots,), np.int64)
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
            if self.paged:
                if self.prefix_cache_active and self._slot_hashes[i]:
                    # publish-on-retire: the slot's full prompt blocks (now
                    # written) become index entries; its pages drop to
                    # refcount 0 in free() but stay warm on the LRU
                    self.alloc.publish(i, self._slot_hashes[i])
                self._slot_hashes[i] = None
                self.alloc.free(i)

    def _decode_plain(self, active: list, finished: list) -> None:
        if self.paged and active:
            active = self._grow_active(active)
            finished.extend(self._failed)
            self._failed.clear()
        if not active:
            return
        act = np.zeros((self.n_slots,), bool)
        act[active] = True
        # the observer phase wraps staging, dispatch or replay AND the
        # step's one device->host sync: the host-observed decode latency
        with self.obs.phase("decode", slots=len(active)):
            with self._span("stage"):
                if self.paged:
                    self._page_table()
                self._in["tokens"].put(self.last_token)
                self._in["cache_len"].put(self.cache_len)
                self._in["active"].put(act)
            next_tok = self._run_step("decode", active)
            with self._span("wait", on="sync"):
                toks = next_tok.cpu().numpy()   # the step's ONE host sync
        if self._timer is not None:
            self._timer.synced()
        with self._span("emit"):
            if self.cfg.is_mla:
                # every layer's decode read cache_len + 1 latent rows of
                # each decoding slot
                self.obs.on_latent_rows(len(transformer.layer_kinds(
                    self.cfg)) * int((self.cache_len[act] + 1).sum()))
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

    # -- speculative decode ---------------------------------------------------
    def _draft_for(self, i: int) -> list:
        """The slot's draft, capped so a full accept can neither overshoot
        ``max_new`` nor run ``cache_len`` past the ``max_seq - 1`` retire
        line.  A drafter's failure is the request's (caught by the caller).
        """
        req = self.sched.slots[i].req
        room = min(self.draft_k,
                   req.max_new - len(req.out) - 1,
                   self.max_seq - 2 - int(self.cache_len[i]))
        if room <= 0:
            return []
        seq = list(req.tokens) + list(req.out)
        return [int(t) for t in self.drafter.draft(seq, room)][:room]

    def _decode_speculative(self, active: list, finished: list) -> None:
        """One verify step: draft on the host, verify every slot's draft in
        ONE forward of width ``draft_k + 1``, accept each slot's longest
        matching prefix plus the model's bonus/correction token, and roll
        back the rest by bookkeeping (contiguous: junk K/V past
        ``cache_len`` is masked and overwritten; paged: tail pages grown
        for rejected tokens shrink back to the pool)."""
        W = self.draft_k + 1
        drafts: dict[int, list] = {}
        for i in list(active):
            try:
                drafts[i] = self._draft_for(i)
            except Exception as e:   # a poisoned request fails alone
                self._fail_slot(i, f"drafter failed: {type(e).__name__}: {e}")
                active.remove(i)
        if self.paged and active:
            # the next token's page as in plain decode (preempting
            # youngest-first); draft pages on top are opportunistic: on
            # exhaustion the draft is dropped, never a live sequence
            active = self._grow_active(active)
            for i in list(active):
                d = drafts.get(i, [])
                if not d:
                    continue
                try:
                    self.alloc.grow(i, int(self.cache_len[i]) + 1 + len(d))
                except PagePoolExhausted:
                    drafts[i] = []
        finished.extend(self._failed)
        self._failed.clear()
        if not active:
            return
        toks = np.zeros((self.n_slots, W), np.int64)
        for i in active:
            toks[i, 0] = self.last_token[i]
            d = drafts.get(i, [])
            if d:
                toks[i, 1:1 + len(d)] = d
        with self.obs.phase("verify", slots=len(active),
                            drafted=sum(len(d) for d in drafts.values())):
            with self._span("stage"):
                if self.paged:
                    self._page_table()
                self._in["tokens"].put(toks)
                self._in["cache_len"].put(self.cache_len)
                if self._moe_counts is not None:
                    act = np.zeros((self.n_slots,), bool)
                    act[active] = True
                    self._in["active"].put(act)
            cand = self._run_step("verify", active)
            with self._span("wait", on="sync"):
                cand = cand.cpu().numpy()    # (n_slots, W); the ONE sync
        if self._timer is not None:
            self._timer.synced()
        with self._span("emit"):
            now = _clock()
            self.spec_steps += 1
            self.obs.on_spec_step()
            for i in active:
                req = self.sched.slots[i].req
                d = drafts.get(i, [])
                # cand[i, j] is the token sequential decode would emit
                # after the draft prefix d[:j]; draft token j survives iff
                # it is exactly that, and the first mismatch position
                # contributes the model's own token, so every step emits
                # 1..W tokens of plain decode's stream
                n_acc = 1
                for j, dt in enumerate(d):
                    if int(cand[i, j]) != dt:
                        break
                    n_acc += 1
                emitted = [int(t) for t in cand[i, :n_acc]]
                self.spec_drafted += len(d)
                self.spec_accepted += n_acc - 1
                self.obs.on_draft_verified(req.rid, len(d), n_acc - 1)
                self.obs.on_tokens(n_acc)
                self.sched.on_draft(i, len(d), n_acc - 1)
                self.cache_len[i] += n_acc
                self.last_token[i] = emitted[-1]
                req.out.extend(emitted)
                if req.t_first is None:
                    req.t_first = now
                for _ in range(n_acc):
                    self.sched.on_decode_token(i)
                if self.paged:
                    # rollback: return the pages grown for rejected
                    # draft tokens (a draft cut at a page boundary must
                    # not leak)
                    self.alloc.shrink(i, int(self.cache_len[i]))
                self._maybe_retire(i, req, now, finished)

    # -- admission control ----------------------------------------------------
    def _admissible(self, req: Request) -> bool:
        """Paged admission control: admit only if the sequence's pages are
        free right now.  Raises :class:`PagePoolExhausted` for a request no
        pool state could ever admit."""
        if not self.paged:
            return True
        n = len(req.tokens) + len(req.out)
        if n > self.max_seq:
            raise PagePoolExhausted(
                f"request {req.rid} length {n} exceeds max_seq "
                f"{self.max_seq}")
        need = self.pcfg.pages_for(n)
        if need > self.pcfg.n_pages - 1:
            raise PagePoolExhausted(
                f"request {req.rid} needs {need} pages but the pool only "
                f"has {self.pcfg.n_pages - 1} allocatable")
        if self.prefix_cache_active:
            hashes, cap = self._prefix_hashes(req, n)
            return self.alloc.can_admit(
                n, hits=self.alloc.lookup(hashes[:cap]))
        return self.alloc.can_admit(n)

    # -- the loop -------------------------------------------------------------
    def run(self, requests: list[Request], max_steps: int = 1000):
        """Serve ``requests`` to completion.  Preempted sequences re-enter
        ahead of fresh ones; requests the pool can never back come back
        with ``req.error`` set.  Exhausting ``max_steps`` returns *every*
        request: unfinished ones come back with ``req.error`` set,
        ``done=False`` and whatever ``req.out`` they produced."""
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
                try:
                    if not self._admissible(self.sched.next_queued()):
                        break
                except PagePoolExhausted as e:
                    req = self.sched.pop_queued()
                    req.error, req.done = str(e), True
                    req.t_done = _clock()
                    self.obs.on_retire(req)
                    done.append(req)
                    continue
                self.add_request(self.sched.pop_queued())
            done.extend(self.step())
            steps += 1
        for slot in self.sched.occupied():
            req = self.sched.release(slot)
            self.cache_len[slot] = 0
            self._slot_seq[slot] = None
            if self.paged:
                self._slot_hashes[slot] = None
                self.alloc.free(slot)
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
