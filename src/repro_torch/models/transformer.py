"""Block-stack model (the port of ``repro.models.transformer``): stacks
of global attention, sliding-window attention (a per-slot ring buffer),
RG-LRU and RWKV-6 blocks with a dense or a token-choice MoE FFN
(``models/moe.py``) — decoders such as qwen2-7b and the MoE grok-1 and
kimi-k2, the hybrid recurrentgemma-2b, the attention-free rwkv6-1.6b, and
the famous-bert and hubert-xlarge encoders.  Every entry point takes int
tokens or, for the stub frontends of the audio and vlm configs
(``models/frontends.py``), float embeddings (B, S, d_model).

Parameters come in two layouts:

  * the **spec tree** of :func:`model_spec` — the JAX package's structure,
    stacked ``(num_units, ...)`` leaves included, as ``init_params`` and
    ``repro_torch.convert`` produce it.  :func:`forward` (training) takes
    this one, so gradients land in the stacked leaves;
  * the **serving layout** of :func:`prepare_params` — one dict per layer
    (views into the stacked leaves; :func:`layer_kinds` names each one's
    block kind), ``[Wq|Wk|Wv]`` fused once in every attention layer (and,
    by :func:`quantize_qkv`, quantized once for the int8 kernel), and one
    f32 copy of the LM head.  The serving step functions take it.

JAX's ``lax.scan`` over the stacked units becomes a loop over them; its
``jax.checkpoint`` around each unit becomes ``torch.utils.checkpoint``.
Caches are one dict per layer — ``{"k", "v"}`` contiguous per-slot stripes
or sliding-window rings, or a shared page pool (plus f32 scale pools when
int8) that global-attention layers address through a ``page_table``;
``{"h", "conv"}`` for RG-LRU and ``{"s", "x_tm", "x_cm"}`` for RWKV-6
layers, per slot even when the attention is paged — written in place (see
``models/attention.py``).

The mesh: :func:`param_axes` and :func:`cache_axes` name every leaf's
logical axes, as JAX's do, and a :class:`MeshLayout` resolves them under
a rule set: what stays split for compute (attention heads, RWKV-6 heads,
the FFN / LRU hidden, MoE experts and the vocabulary over "model") and
what is gathered inside the unit that reads it.  Serving
(``ServingEngine(mesh=)``): :func:`shard_params` cuts the spec tree to
one rank's shards and marks the parts whose products need a collective
(:class:`ServeLayout`), ``make_caches(mesh=)`` allocates the rank's
cache shapes (:func:`slot_range`: a replica group's slots), and the step
functions below run on a rank's layout, gathering as it says
(:func:`_layers`).  Sharded training (``make_train_step(mesh=)``):
:class:`TrainLayout`, and :func:`forward` gathers each unit's leaves
inside the unit and runs the tensor-parallel blocks with Megatron's f
and g.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN, LOCAL_ATTN, RGLRU, RWKV6,
                                      ModelConfig)
from repro_torch.core.famous import FamousConfig
from repro_torch.kernels import lib
from repro_torch.models import attention, layers, module, moe, rglru, rwkv6
from repro_torch.models.module import ParamSpec, stack_specs
from repro_torch.parallel import sharding as shd

# ---------------------------------------------------------------------------
# parameter spec
# ---------------------------------------------------------------------------


def _check_supported(cfg: ModelConfig) -> None:
    kinds = set(layer_kinds(cfg))
    if (not kinds <= {ATTN, LOCAL_ATTN, RGLRU, RWKV6}
            or cfg.norm not in ("rmsnorm", "layernorm")
            or cfg.act not in ("silu", "gelu", "relu_sq")):
        raise ValueError(
            f"{cfg.name}: block kinds {sorted(kinds)}, norm {cfg.norm!r} "
            f"or act {cfg.act!r} unknown: the model runs global-attention, "
            "sliding-window, RG-LRU and RWKV-6 blocks, RMSNorm or "
            "LayerNorm, SiLU, GELU or relu²")


def layer_kinds(cfg: ModelConfig) -> tuple[str, ...]:
    """The block kind of every layer, in order: the pattern unit repeated
    ``num_units`` times, then the tail (the serving layout's order)."""
    return tuple(cfg.pattern_unit) * cfg.num_units + tuple(cfg.tail_layers)


def _ffn_spec(cfg: ModelConfig):
    if cfg.num_experts:
        return moe.moe_spec(cfg)
    gated = cfg.act in ("silu", "gelu") and cfg.norm == "rmsnorm"
    return layers.mlp_spec(cfg.d_model, cfg.d_ff, cfg.act, gated=gated)


def block_spec(kind: str, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    if kind in (ATTN, LOCAL_ATTN):
        return {
            "ln1": layers.norm_spec(d, cfg.norm),
            "attn": attention.attn_spec(cfg),
            "ln2": layers.norm_spec(d, cfg.norm),
            "ffn": _ffn_spec(cfg),
        }
    if kind == RGLRU:
        return {
            "ln1": layers.norm_spec(d, cfg.norm),
            "rec": rglru.rglru_spec(cfg),
            "ln2": layers.norm_spec(d, cfg.norm),
            "ffn": _ffn_spec(cfg),
        }
    if kind == RWKV6:
        return {
            "ln1": layers.norm_spec(d, cfg.norm),
            "tm": rwkv6.rwkv6_spec(cfg),
            "ln2": layers.norm_spec(d, cfg.norm),
            "cm": rwkv6.channel_mix_spec(cfg),
        }
    raise ValueError(kind)


def model_spec(cfg: ModelConfig) -> dict:
    _check_supported(cfg)
    unit = {f"pos{i}": block_spec(k, cfg)
            for i, k in enumerate(cfg.pattern_unit)}
    spec: dict[str, Any] = {
        "embed": layers.embed_spec(cfg.vocab_size, cfg.d_model),
        "blocks": stack_specs(unit, cfg.num_units),
        "final_norm": layers.norm_spec(cfg.d_model, cfg.norm),
    }
    for i, k in enumerate(cfg.tail_layers):
        spec[f"tail{i}"] = block_spec(k, cfg)
    if not cfg.tie_embeddings:
        spec["lm_head"] = {
            "w": ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                           scale=0.02)
        }
    return spec


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]


def prepare_params(params: dict, cfg: ModelConfig) -> dict:
    """Spec tree -> serving layout (idempotent).

    The LM head is held once in f32 (``logits_fn`` computes in f32, as in
    JAX): for bf16 weights that is one extra ``d_model x vocab`` f32 tensor
    (2.2 GB at qwen2-7b's width) made here, instead of a fresh f32 copy of
    the head on every decode step."""
    if "layers" in params:
        return params
    _check_supported(cfg)
    per_layer = []
    for u in range(cfg.num_units):
        unit = _index_tree(params["blocks"], u)
        for i in range(len(cfg.pattern_unit)):
            per_layer.append(unit[f"pos{i}"])
    for i in range(len(cfg.tail_layers)):
        per_layer.append(params[f"tail{i}"])
    out_layers = []
    for blk in per_layer:
        blk = dict(blk)
        if "attn" in blk:
            blk["attn"] = attention.fuse_qkv(blk["attn"])
        out_layers.append(blk)
    if cfg.tie_embeddings:
        unembed = params["embed"]["embedding"].to(torch.float32).t()
    else:
        unembed = params["lm_head"]["w"].to(torch.float32)
    return {"embed": params["embed"], "layers": out_layers,
            "final_norm": params["final_norm"], "unembed_f32": unembed}


def quantize_qkv(params: dict) -> dict:
    """The serving layout with every layer's fused QKV weight also
    quantized once to int8 (``attention.quantize_qkv``), for
    ``FamousConfig(impl="pallas", quant="int8")``.  Returns a new dict;
    the tensors it shares with ``params`` are not copied."""
    layers_q = [dict(blk, attn=attention.quantize_qkv(blk["attn"]))
                if "attn" in blk else blk for blk in params["layers"]]
    return dict(params, layers=layers_q)


# ---------------------------------------------------------------------------
# logical axes and the mesh
# ---------------------------------------------------------------------------


def param_axes(cfg: ModelConfig) -> dict:
    """Logical-axis tree matching the spec tree of :func:`model_spec`
    (``stack_specs`` prepends "layers" to the stacked leaves)."""
    return module.logical_axes(model_spec(cfg))


def cache_axes(cfg: ModelConfig, cache_kind: str = "contiguous",
               kv_dtype: str = "fp") -> list:
    """Logical-axis tree matching :func:`make_caches` (one dict a layer):
    contiguous attention caches ("batch", seq, "kv_heads", "head_dim");
    page pools drop the slot axis and, int8, add the scale pools."""
    def block_axes(kind):
        if kind == ATTN and cache_kind == "paged":
            return (attention.PAGED_ATTN_CACHE_AXES_INT8
                    if kv_dtype == "int8"
                    else attention.PAGED_ATTN_CACHE_AXES)
        if kind in (ATTN, LOCAL_ATTN):
            return attention.ATTN_CACHE_AXES
        if kind == RGLRU:
            return rglru.RGLRU_CACHE_AXES
        return rwkv6.RWKV_CACHE_AXES

    return [dict(block_axes(k)) for k in layer_kinds(cfg)]


# the logical axes tensor parallelism splits over "model": attention heads
# and kv heads, RWKV-6's flat heads, the FFN / LRU hidden and the MoE
# experts
TP_AXES = ("heads", "kv_heads", "heads_flat", "mlp", "experts")
# what a rank keeps split for compute where it shards over "model": the
# TP_AXES and the vocabulary (the vocab-parallel lookup, LM head and loss)
SPLIT_AXES = TP_AXES + ("vocab",)


def check_mesh(cfg: ModelConfig, mesh, rules) -> None:
    """Raise ``ValueError`` for a rule set that gives "batch" to "model":
    tensor parallelism needs the "model" ranks to see the same rows (in
    serving, the same slots).  Every other placement of every rule set of
    ``parallel/sharding.py`` serves and trains, on any data, pod and model
    axes."""
    if "model" in shd.entry_axes(shd.rule_axes(mesh, rules, "batch")):
        raise ValueError("a rule set that shards \"batch\" over \"model\" "
                         "cannot run: the model ranks must see the same "
                         "rows")


def _rwkv_head_cut(cfg: ModelConfig, mesh, rules) -> bool:
    """Whether RWKV-6's D columns ("heads_flat") split over more ranks
    than its heads ("heads") do, so that a rank's columns would cut a
    head: its time mix then runs on gathered leaves."""
    if RWKV6 not in layer_kinds(cfg):
        return False
    d = cfg.d_model
    ways = [shd.sharded_size(shd.spec_for_axes(mesh, (name,), rules, (n,))[0],
                             mesh)
            for name, n in (("heads_flat", d), ("heads", d // cfg.rwkv_head_dim))]
    return ways[0] != ways[1]


def gather_spec(spec: tuple, axes: tuple, head_cut: bool) -> tuple:
    """The entries of a leaf's ``spec`` (logical ``axes``) that are
    gathered inside the unit that reads it, None elsewhere: every sharded
    dim but a :data:`SPLIT_AXES` dim over "model" (split for compute;
    RWKV-6's columns not where ``head_cut``) and the slot axis "batch" (a
    rank computes its own slots)."""
    def kept(entry, name):
        return name == "batch" or (entry == "model" and name in SPLIT_AXES
                                   and not (head_cut and name == "heads_flat"))
    return tuple(None if kept(e, n) else e for e, n in zip(spec, axes))


def _compute_spec(spec: tuple, gspec: tuple) -> tuple:
    """What stays split for compute: the entries the gather spec drops."""
    return tuple(e if g is None else None for e, g in zip(spec, gspec))


def _gathered(gspec: tuple) -> bool:
    return any(e is not None for e in gspec)


def _tp_parts(cfg: ModelConfig, spec: dict, mesh, coords: dict,
              ops: dict) -> dict:
    """The tensor-parallel entries of one block, by part, from its leaves'
    compute specs ``spec`` (one layer's, no "layers" entry) on ``mesh``.
    Where a part's heads, flat heads, hidden or experts split over more
    than one rank, the collectives its functions apply, from ``ops``:
    "sum" after the row-parallel products (``tp_sum``), "stat" for
    RWKV-6's norm statistics (``tp_stat``), "scatter" for the RG-LRU gates
    (``tp_scatter``) and, in training, "in", Megatron's f (``tp_in``); and
    the rank's ranges: its experts (``tp_experts``), LRU channels
    (``tp_channels``), and, where its query heads split over kv heads
    that stay whole, the kernels' head layout (``kv_head``,
    :func:`attention.head_spread`).  A part that stays whole gets
    nothing."""
    def split(entry):
        return shd.sharded_size(entry, mesh) > 1

    def rank_range(entry, n):
        return shd.shard_range(entry, n, mesh, coords)

    f = {"tp_in": ops["in"]} if "in" in ops else {}
    parts = {}
    if "attn" in spec and split(spec["attn"]["wq"][1]):
        a, H, KV = spec["attn"], cfg.num_heads, cfg.num_kv_heads
        parts["attn"] = dict(f, tp_sum=ops["sum"])
        if not split(a["wk"][1]) and KV > 1:
            parts["attn"]["kv_head"] = attention.head_spread(
                H, KV, *rank_range(a["wq"][1], H))
    if "ffn" in spec:
        w_in = spec["ffn"]["w_in"]
        if cfg.num_experts and split(w_in[0]):
            parts["ffn"] = dict(f, tp_sum=ops["sum"], tp_experts=rank_range(
                w_in[0], cfg.num_experts))
        elif not cfg.num_experts and split(w_in[1]):
            parts["ffn"] = dict(f, tp_sum=ops["sum"])
    if "rec" in spec and split(spec["rec"]["w_x"][1]):
        parts["rec"] = dict(f, tp_sum=ops["sum"], tp_scatter=ops["scatter"],
                            tp_channels=rank_range(
                                spec["rec"]["w_x"][1],
                                cfg.lru_width or cfg.d_model))
    if "tm" in spec and split(spec["tm"]["w_r"][1]):
        parts["tm"] = dict(f, tp_sum=ops["sum"], tp_stat=ops["stat"])
    if "cm" in spec and split(spec["cm"]["w_k"][1]):
        parts["cm"] = dict(f, tp_sum=ops["sum"])
    return parts


def _block_names(cfg: ModelConfig) -> list:
    return ([f"pos{i}" for i in range(len(cfg.pattern_unit))]
            + [f"tail{i}" for i in range(len(cfg.tail_layers))])


class MeshLayout:
    """One rank's placement of the spec tree on ``mesh`` under ``rules``,
    the part shared by the sharded train step (:class:`TrainLayout`) and
    tensor-parallel serving (:class:`ServeLayout`).  JAX places the same
    tree with ``tree_shardings``; GSPMD then computes the rest.  The port
    keeps each leaf's shard (``specs``) and runs every sharded dim one of
    two ways:

      * split for compute: a :data:`TP_AXES` dim over "model" (Megatron's
        tensor parallelism, the entries of :func:`_tp_parts` with the
        collectives of :meth:`_ops`), and the vocabulary over "model"
        (``vocab``: the rank's [lo, hi) of the embedding's and of the LM
        head's, None where it stays whole; a vocab-parallel lookup, head
        and loss);
      * gathered whole inside the unit that reads it, at each use
        (``gspecs``, :func:`gather_spec`): "embed" over "data" (FSDP) or
        over every axis (ZERO_SEQ_RULES), grok-1's "expert_ff", RWKV-6
        columns that would cut a head.  A part whose split is not whole
        heads so runs on gathered leaves, with no collective of its own.

    ``blocks``: per block ("pos<i>" of the unit, "tail<i>") its leaves'
    gather specs and its parts' tensor-parallel entries (``compute``: its
    leaves' compute specs, what stays split); ``comm``: the
    collectives (:class:`~repro_torch.parallel.sharding.MeshComm`)."""

    def __init__(self, cfg: ModelConfig, mesh, rules):
        check_mesh(cfg, mesh, rules)
        self.cfg, self.mesh = cfg, mesh
        self.comm = c = shd.MeshComm(mesh, rules)
        self.head_cut = _rwkv_head_cut(cfg, mesh, rules)
        spec_tree = model_spec(cfg)
        axes = module.logical_axes(spec_tree)
        self.specs = shd.tree_specs(mesh, axes, rules,
                                    module.param_shapes(spec_tree))
        self.gspecs = module.tree_map2(
            lambda s, a: gather_spec(s, a, self.head_cut), self.specs, axes)
        cspecs = module.tree_map2(_compute_spec, self.specs, self.gspecs)
        ops = self._ops()
        self.blocks, self.compute = {}, {}
        for name in _block_names(cfg):
            stacked = name.startswith("pos")
            g = self.gspecs["blocks"][name] if stacked else self.gspecs[name]
            s = cspecs["blocks"][name] if stacked else cspecs[name]
            if stacked:   # the stacked leaves lose their "layers" entry
                g = module.tree_map(lambda x: x[1:], g)
                s = module.tree_map(lambda x: x[1:], s)
            self.blocks[name] = (g, _tp_parts(cfg, s, mesh, c.coords, ops))
            self.compute[name] = s

        def vocab(entry):
            if shd.sharded_size(entry, mesh) == 1:
                return None
            return shd.shard_range(entry, cfg.vocab_size, mesh, c.coords)

        self.vocab = {"embed": vocab(cspecs["embed"]["embedding"][0])}
        self.vocab["head"] = (self.vocab["embed"] if cfg.tie_embeddings
                              else vocab(cspecs["lm_head"]["w"][1]))

    def _ops(self) -> dict:
        """The collectives of the tensor-parallel parts (none here)."""
        return {}


# the leaves a tensor-parallel part reads for the rank's share only while
# they stay whole over "model" (kv projections whose heads do not split,
# qk-norm scales, the router, the RG-LRU's per-channel gate biases and
# decay, the RWKV-6 token-shift mixes and decay LoRA's first factor): in
# training each comes through Megatron's f, so that the ranks' partial
# gradients are summed
TRAIN_F_LEAVES = {"attn": ("wk", "wv", "bk", "bv", "q_norm", "k_norm"),
                  "ffn": ("router",), "rec": ("b_a", "b_i", "lam"),
                  "tm": ("mu", "wA")}


class TrainLayout(MeshLayout):
    """One rank's side of the sharded train step (``make_train_step(
    mesh=)``) under ``rules`` (default ``DEFAULT_RULES``): the
    :class:`MeshLayout` with Megatron's collectives, which have gradients
    (``comm``'s): f (``tp_in``) on the last replicated activation before a
    part's sharded products, g (``tp_sum``) after its row-parallel one,
    the all-reduce with an all-reduce backward for RWKV-6's norm
    statistics and the reduce-scatter with a gathering backward for the
    RG-LRU gates.  The whole leaves such a part reads for the rank's share
    only (:data:`TRAIN_F_LEAVES`) come through f themselves.  A gathered
    dim's gradient is summed over the batch axes it spans and cut to the
    rank's slice, so remat gathers again.  The vocabulary stays split over
    "model": the lookup masks the tokens outside the rank's rows and sums
    over "model" (g, whose backward is the identity, so each rank's table
    gradient is its own rows'), the LM head is column-parallel behind f,
    and ``losses.chunked_lm_loss`` takes the vocab-parallel cross
    entropy."""

    def __init__(self, cfg: ModelConfig, mesh, rules=None):
        super().__init__(cfg, mesh, rules or shd.DEFAULT_RULES)
        self.whole = {}
        for name, (g, parts) in self.blocks.items():
            # a leaf is whole for compute where none of its dims stays
            # split
            self.whole[name] = {part: tuple(
                n for n in TRAIN_F_LEAVES.get(part, ()) if n in g[part]
                and not any(shd.sharded_size(e, mesh) > 1
                            for e in self.compute[name][part][n]))
                for part in parts}

    def _ops(self) -> dict:
        c = self.comm
        return {"sum": c.reduce_from_model, "stat": c.sum_over_model,
                "scatter": c.scatter_to_model, "in": c.copy_to_model}

    def _gather(self, tree, gspecs):
        return module.tree_map2(self.comm.gather_grad, tree, gspecs)

    def block(self, p: dict, name: str) -> dict:
        """Block ``name`` ("pos<i>" of a unit, "tail<i>") from the rank's
        shards: gathered, and marked where it runs tensor-parallel."""
        gspecs, parts = self.blocks[name]
        p = self._gather(p, gspecs)
        for part, entries in parts.items():
            q = dict(p[part], **entries)
            for leaf in self.whole[name][part]:
                q[leaf] = self.comm.copy_to_model(q[leaf])
            p[part] = q
        if self.cfg.num_experts and "ffn" in p and self.comm.dp > 1:
            p["ffn"] = dict(p["ffn"], batch_ranks=self.comm.dp)
        return p

    def outer(self, params: dict, tokens: bool = True) -> dict:
        """``params`` with the leaves outside the units gathered: the
        final norm, the LM head, and the embedding where it is read (for
        ``tokens``, or as a tied head; a stub frontend's embeddings never
        read it), each but its vocabulary dim where that splits over
        "model".  A vocab-parallel embedding carries its rows' range and
        g for :func:`layers.embed_lookup`."""
        out = dict(params)
        for k in ("embed", "final_norm", "lm_head"):
            if k in params and (k != "embed" or tokens
                                or self.cfg.tie_embeddings):
                out[k] = self._gather(params[k], self.gspecs[k])
        if self.vocab["embed"] is not None and tokens:
            out["embed"] = dict(out["embed"], vocab_range=self.vocab["embed"],
                                tp_sum=self.comm.reduce_from_model)
        return out


class ServeLayout(MeshLayout):
    """Tensor-parallel serving's side of the :class:`MeshLayout`
    (:func:`shard_params`; rules default ``SERVE_TP_RULES``): every
    collective of a part is the in-place sum over the "model" group
    (:class:`~repro_torch.parallel.sharding.ModelSum`).  Where a rule set
    shards more than the :data:`TP_AXES`: each serving layer's leaves named in
    ``gathers`` are gathered at every step inside the layer
    (:meth:`layer`), the embedding's and the f32 LM head's likewise
    (:meth:`embed`, :meth:`logits`), and a vocab-parallel head's logits
    are gathered over "model" inside the step, as JAX's engine pins them
    replicated, so the sampler and the host loop run as they are.
    :meth:`shadow` issues a step's gathers alone, for a replica group
    that does not own the slot a chunk or a prefill writes."""

    def __init__(self, cfg: ModelConfig, mesh, rules=None):
        super().__init__(cfg, mesh, rules or shd.SERVE_TP_RULES)
        self.layer_names = [f"pos{i}" for i in range(len(cfg.pattern_unit))
                            ] * cfg.num_units + [
            f"tail{i}" for i in range(len(cfg.tail_layers))]
        self.gathers = {name: {
            part: {n: s for n, s in leaves.items() if _gathered(s)}
            for part, leaves in g.items()
            if any(_gathered(s) for s in leaves.values())}
            for name, (g, _) in self.blocks.items()}
        g = self.gspecs["embed"]["embedding"]
        self.embed_gather = g if _gathered(g) else None
        # the f32 head: the tied embedding transposed, or the LM head
        g = (tuple(reversed(g)) if cfg.tie_embeddings
             else self.gspecs["lm_head"]["w"])
        self.head_gather = g if _gathered(g) else None

    def _ops(self) -> dict:
        msum = shd.model_sum(self.mesh)
        return {} if msum is None else {"sum": msum, "stat": msum,
                                        "scatter": msum.scatter}

    def layer(self, i: int, p: dict) -> dict:
        """Serving layer ``i``'s leaves ``p`` with the ones it gathers
        gathered whole (a new dict; ``p`` itself where none is)."""
        g = self.gathers[self.layer_names[i]]
        if not g:
            return p
        p = dict(p)
        for part, leaves in g.items():
            p[part] = dict(p[part], **{n: self.comm.gather(p[part][n], s)
                                       for n, s in leaves.items()})
        return p

    def embed(self, p: dict) -> dict:
        if self.embed_gather is None:
            return p
        return dict(p, embedding=self.comm.gather(p["embedding"],
                                                  self.embed_gather))

    def logits(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """f32 logits of ``x`` through the rank's f32 head ``w``: gathered
        first where the rule set cuts its embed dim; the vocab-parallel
        columns then gathered over "model"."""
        if self.head_gather is not None:
            w = self.comm.gather(w, self.head_gather)
        y = x.to(torch.float32) @ w
        if self.vocab["head"] is not None:
            y = self.comm.gather(y, (None,) * (y.ndim - 1) + ("model",))
        return y

    def shadow(self, params: dict, head: bool) -> None:
        """The gathers of one prefill on the serving layout ``params``, in
        its order, with nothing computed: the embedding's, every layer's
        and, for a monolithic prefill (``head``), the LM head's.  A replica
        group runs this for a slot another group owns, so that every
        gather over the groups' axes meets its peers; every other
        collective of a prefill stays inside the owning group."""
        self.embed(params["embed"])
        for i, p in enumerate(params["layers"]):
            self.layer(i, p)
        if head and self.head_gather is not None:
            self.comm.gather(params["unembed_f32"], self.head_gather)


def shard_params(params: dict, cfg: ModelConfig, mesh, rules=None) -> dict:
    """This rank's serving layout of the spec tree ``params`` on ``mesh``
    (JAX places the same tree with ``tree_shardings``): every leaf cut to
    (a copy of) the rank's shard of its resolved spec (``rules``, default
    ``SERVE_TP_RULES``; a dim the rule's axes do not divide stays whole,
    the replicate fallback), then :func:`prepare_params`, so each rank
    fuses [Wq|Wk|Wv] from its own heads' slices.  A leaf that already has
    the rank's shard shape is taken as that shard (a rank that drew its
    weights leaf by leaf and kept only its shards).  Each part whose
    heads, flat heads, hidden or experts split over more than one rank
    gets :func:`_tp_parts`' entries, and the result holds the rank's
    :class:`ServeLayout` as ``"layout"``.  Where the rule set shards more
    — "vocab" over "model", "embed" over "data" or every axis, grok-1's
    "expert_ff" — a vocab-parallel embedding carries its rows' range and
    the "model" sum for :func:`layers.embed_lookup`, the f32 head keeps
    the rank's columns, and an attention whose leaves are gathered at
    each step is not fused (the projection fuses the gathered leaves).
    Over a mesh of one rank nothing is cut, no collective runs and every
    step computes what it computes on ``prepare_params(params, cfg)``."""
    if "layers" in params:
        raise ValueError("shard_params takes the spec tree (model_spec's "
                         "structure), not the serving layout")
    layout = ServeLayout(cfg, mesh, rules)
    coords = layout.comm.coords
    shapes = module.param_shapes(model_spec(cfg))

    def own(t, spec_shape):
        spec, whole = spec_shape
        if tuple(t.shape) != whole.shape:
            if tuple(t.shape) != shd.local_shape(whole.shape, spec, mesh):
                raise ValueError(
                    f"a leaf of shape {tuple(t.shape)} is neither whole "
                    f"{whole.shape} nor this rank's shard of it under {spec}")
            return t
        # a cut leaf is copied, so the whole tensor can be freed
        part = shd.local_shard(t, spec, mesh, coords)
        return t if part is t else part.clone()

    local = module.tree_map2(
        own, params, module.tree_map2(lambda s, w: (s, w), layout.specs,
                                      shapes))
    out = prepare_params(local, cfg)
    for blk, name in zip(out["layers"], layout.layer_names):
        for part, entries in layout.blocks[name][1].items():
            blk[part] = dict(blk[part], **entries)
        if "attn" in layout.gathers[name]:
            blk["attn"] = {k: v for k, v in blk["attn"].items()
                           if k != "w_qkv"}
    if layout.vocab["embed"] is not None:
        out["embed"] = dict(out["embed"], vocab_range=layout.vocab["embed"],
                            tp_sum=shd.model_sum(mesh))
    out["layout"] = layout
    return out


def slot_range(cfg: ModelConfig, n_slots: int, mesh, rules=None,
               cache_kind: str = "contiguous", kv_dtype: str = "fp"):
    """The slots this rank computes where its caches' slot axis ("batch")
    splits over replica groups (the pod and data axes): ``(lo, hi,
    entry)``, [lo, hi) and the spec entry that cuts them.  None where
    every rank holds every slot: no per-slot cache leaf (global attention
    on page pools, which have no slot axis and stay whole on every group,
    as JAX replicates them) or a slot count the groups do not divide (the
    replicate fallback)."""
    if not any(ax[0] == "batch" for layer in cache_axes(cfg, cache_kind,
                                                        kv_dtype)
               for ax in layer.values()):
        return None
    entry = shd.spec_for_axes(mesh, ("batch",), rules or shd.SERVE_TP_RULES,
                              (n_slots,))[0]
    if shd.sharded_size(entry, mesh) == 1:
        return None
    lo, hi = shd.shard_range(entry, n_slots, mesh, shd.mesh_coords(mesh))
    return lo, hi, entry


class MeshCaches(list):
    """A rank's caches (one dict a layer) with the leaves it holds cut
    along a dim their layer does not split (RWKV-6's token-shift rows
    under a rule set that shards "embed"): ``gathers`` names each layer's
    and its gather spec, ``comm`` gathers them; :func:`_layers` gathers
    them for the layer and writes the rank's shards back after it."""

    def __init__(self, caches: list, gathers: list, comm):
        super().__init__(caches)
        self.gathers, self.comm = gathers, comm


def _layers(params: dict, caches: list, cfg: ModelConfig):
    """(kind, layer params, layer cache) of every layer, in order.  On a
    mesh (the serving layout's ``"layout"``) each layer's leaves come
    gathered where its rule set says (:meth:`ServeLayout.layer`), and a
    cache leaf of :class:`MeshCaches` comes gathered whole, its shard
    written back after the layer."""
    layout = params.get("layout")
    gathers = getattr(caches, "gathers", None)
    for i, (kind, p, cache) in enumerate(zip(layer_kinds(cfg),
                                             params["layers"], caches)):
        if layout is not None:
            p = layout.layer(i, p)
        g = gathers[i] if gathers else None
        if not g:
            yield kind, p, cache
            continue
        comm = caches.comm
        full = dict(cache, **{n: comm.gather(cache[n], s)
                              for n, s in g.items()})
        yield kind, p, full
        for n, s in g.items():
            cache[n].copy_(shd.local_shard(full[n], s, comm.mesh,
                                           comm.coords))


# ---------------------------------------------------------------------------
# block application (full sequence)
# ---------------------------------------------------------------------------


def _apply_ffn(p, x, cfg: ModelConfig):
    if cfg.num_experts:
        return moe.apply_moe(p, x, cfg)
    return layers.apply_mlp(p, x, cfg.act)


def _ffn_residual(p, x, cfg: ModelConfig, slot_rows=None):
    """``x + FFN(ln2(x))``: the second half of an attention or RG-LRU
    block, on every path (full sequence, prefill, chunk, decode,
    verify).  ``slot_rows`` (a replica group's decode or verify, see
    :func:`decode_step`): an MoE FFN routes every slot's rows, gathered,
    in one group as the unsharded step does, and keeps its own."""
    h = layers.apply_norm(p["ln2"], x, cfg.norm)
    if slot_rows is not None and cfg.num_experts:
        gather, lo, hi = slot_rows
        return x + _apply_ffn(p["ffn"], gather(h), cfg)[lo:hi]
    return x + _apply_ffn(p["ffn"], h, cfg)


def _embed_inputs(params, inputs, dtype):
    if not inputs.is_floating_point():
        p = params["embed"]
        if "layout" in params:   # a mesh's serving layout
            p = params["layout"].embed(p)
        return layers.embed_lookup(p, inputs, dtype)
    return inputs.to(dtype)  # frontend stub: precomputed embeddings


def apply_block(kind: str, p: dict, x: torch.Tensor, cfg: ModelConfig,
                fcfg: FamousConfig, q_offset: int = 0) -> torch.Tensor:
    """One block on the full sequence, x: (B, S, D): global or
    sliding-window attention, RG-LRU or RWKV-6, each with its FFN (the
    channel mix for RWKV-6).  The recurrences are the differentiable torch
    scans of ``models/{rglru,rwkv6}.py``.  (The JAX block's
    ``constrain_residual`` sharding hints are identities in the port,
    ``parallel/incontext.py``, and are left out.)"""
    if kind in (ATTN, LOCAL_ATTN):
        window = cfg.window if kind == LOCAL_ATTN else 0
        x = x + attention.apply_attn(
            p["attn"], layers.apply_norm(p["ln1"], x, cfg.norm), cfg, fcfg,
            window=window, q_offset=q_offset)
        return _ffn_residual(p, x, cfg)
    if kind == RGLRU:
        x = x + rglru.apply_rglru(
            p["rec"], layers.apply_norm(p["ln1"], x, cfg.norm), cfg)
        return _ffn_residual(p, x, cfg)
    x = x + rwkv6.apply_rwkv_time_mix(
        p["tm"], layers.apply_norm(p["ln1"], x, cfg.norm), cfg)
    y, _ = rwkv6.apply_channel_mix(
        p["cm"], layers.apply_norm(p["ln2"], x, cfg.norm), cfg)
    return x + y


def forward(params: dict, inputs: torch.Tensor, cfg: ModelConfig,
            fcfg: FamousConfig = FamousConfig(), *, remat: bool = True,
            return_hidden: bool = False, compute_dtype=None,
            layout: TrainLayout | None = None) -> torch.Tensor:
    """inputs: int tokens (B, S), or float embeddings (B, S, D) for the
    stub frontends, on the spec tree.  Returns f32 logits
    (B, S, vocab), or the final hidden states (B, S, D) when
    ``return_hidden`` (the chunked loss computes logits chunk by chunk).

    The loop over stacked units indexes the ``(num_units, ...)`` leaves,
    so gradients land in them.  ``remat=True`` recomputes each unit in the
    backward (``torch.utils.checkpoint``, non-reentrant), as
    ``jax.checkpoint`` does.

    ``layout``: a rank's :class:`TrainLayout`; ``params`` then hold the
    rank's shards, with the leaves outside the units already whole
    (``layout.outer``).  Each unit's and tail block's leaves are gathered
    inside it (so the recompute gathers again, in the same order on every
    rank).  An MoE layer routes in the global batch's groups
    (``moe.apply_moe``)."""
    _check_supported(cfg)
    x = _embed_inputs(params, inputs,
                      compute_dtype or params["final_norm"]["scale"].dtype)

    def block(p, name):
        return p if layout is None else layout.block(p, name)

    def unit_body(x, u):
        unit = _index_tree(params["blocks"], u)
        for i, kind in enumerate(cfg.pattern_unit):
            x = apply_block(kind, block(unit[f"pos{i}"], f"pos{i}"), x, cfg,
                            fcfg)
        return x

    for u in range(cfg.num_units):
        x = (checkpoint(unit_body, x, u, use_reentrant=False) if remat
             else unit_body(x, u))
    for i, kind in enumerate(cfg.tail_layers):
        x = apply_block(kind, block(params[f"tail{i}"], f"tail{i}"), x, cfg,
                        fcfg)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    if return_hidden:
        return x
    return logits_fn(params, x, cfg)


# ---------------------------------------------------------------------------
# serving: caches, chunked prefill, decode
# ---------------------------------------------------------------------------


def logits_fn(params, x, cfg: ModelConfig):
    """f32 logits (..., vocab) from final hidden states, on either layout
    (the serving layout holds its f32 LM head once; on a mesh whose head
    is vocab-parallel, its columns' logits gathered over "model").  In the
    sharded train step a vocab-parallel head gives the rank's columns
    (``losses.chunked_lm_loss``)."""
    if "unembed_f32" in params:
        if "layout" in params:
            return params["layout"].logits(x, params["unembed_f32"])
        return x.to(torch.float32) @ params["unembed_f32"]
    if cfg.tie_embeddings:
        return layers.unembed_logits(params["embed"], x)
    return x.to(torch.float32) @ params["lm_head"]["w"].to(torch.float32)


def _compute_dtype(params):
    return params["final_norm"]["scale"].dtype


def _layer_cache_shape(kind, cfg, batch, max_seq, dtype, cache_kind,
                       page_size, n_pages, kv_dtype) -> dict:
    if kind == ATTN and cache_kind == "paged":
        return attention.paged_attn_cache_shape(cfg, n_pages, page_size,
                                                dtype, kv_dtype)
    if kind in (ATTN, LOCAL_ATTN):
        window = cfg.window if kind == LOCAL_ATTN else 0
        return attention.attn_cache_shape(cfg, batch, max_seq, window, dtype)
    if kind == RGLRU:
        return rglru.rglru_cache_shape(cfg, batch, dtype)
    return rwkv6.rwkv_cache_shape(cfg, batch, dtype)


def make_caches(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                device="cuda", *, cache_kind: str = "contiguous",
                page_size: int = 0, n_pages: int = 0,
                kv_dtype: str = "fp", mesh=None, rules=None,
                slots: int | None = None, shapes_only: bool = False) -> list:
    """One cache per layer.

    cache_kind="contiguous": a ``(batch, max_seq, kv, dh)`` K/V pair per
    global-attention layer.  cache_kind="paged": a shared ``(n_pages,
    page_size, kv, dh)`` pool per global-attention layer instead, addressed
    through the page table that ``prefill_chunk`` and ``decode_step``
    receive; memory then follows live tokens, not ``batch x max_seq`` (see
    ``serve/paged.py``).  kv_dtype="int8" (paged only) stores int8 pools
    with f32 per-token scale pools; writes quantize, the kernels dequantize
    in their tiles.  Sliding-window rings (``min(max_seq, window)`` rows)
    and recurrent state are O(window) or O(1) per slot and stay per slot
    in both kinds.  Given a ``mesh``, each leaf has this rank's shape of
    :func:`cache_axes` resolved under ``rules`` (default
    ``SERVE_TP_RULES``), as JAX places the caches: the slot axis cut over
    the replica groups (:func:`slot_range`), the kv heads, RWKV-6 heads
    and LRU hidden over "model"; where a leaf is also cut along a dim its
    layer does not split, the result is a :class:`MeshCaches`.
    ``slots``: the slot count the placement is resolved for, where it is
    not ``batch`` (a one-slot scratch cache placed as one slot of the
    engine's).  ``shapes_only``: the whole caches'
    :class:`~repro_torch.models.module.ShapeDtype` leaves, allocating
    nothing (JAX's ``shapes_only``, one dict a layer where JAX stacks a
    unit's layers); ``device`` is not read, and no ``mesh`` is taken."""
    _check_supported(cfg)
    if mesh is not None:
        if shapes_only:
            raise ValueError("shapes_only gives the whole caches' shapes; "
                             "a rank's are shd.local_shape of them")
        rules = rules or shd.SERVE_TP_RULES
        full = make_caches(cfg, slots or batch, max_seq, dtype,
                           cache_kind=cache_kind, page_size=page_size,
                           n_pages=n_pages, kv_dtype=kv_dtype,
                           shapes_only=True)
        axes = cache_axes(cfg, cache_kind, kv_dtype)
        specs = shd.tree_specs(mesh, axes, rules, full)
        cut = _rwkv_head_cut(cfg, mesh, rules)
        caches, gathers = [], []
        for cache, spec, ax in zip(full, specs, axes):
            layer = {}
            for n, buf in cache.items():
                shape = list(shd.local_shape(buf.shape, spec[n], mesh))
                if slots is not None and ax[n][0] == "batch":
                    shape[0] = batch
                layer[n] = torch.zeros(shape, dtype=buf.dtype, device=device)
            caches.append(layer)
            g = {n: gather_spec(spec[n], ax[n], cut) for n in cache}
            gathers.append({n: s for n, s in g.items() if _gathered(s)})
        if not any(gathers):
            return caches
        return MeshCaches(caches, gathers, shd.MeshComm(mesh, rules))
    if cache_kind not in ("contiguous", "paged"):
        raise ValueError(f"cache_kind {cache_kind!r}")
    if kv_dtype not in ("fp", "int8"):
        raise ValueError(f"kv_dtype {kv_dtype!r}")
    if cache_kind == "contiguous" and kv_dtype != "fp":
        raise ValueError("kv_dtype='int8' requires paged caches")
    if cache_kind == "paged" and (page_size <= 0 or n_pages <= 0):
        raise ValueError(f"paged caches need page_size and n_pages, got "
                         f"{page_size}, {n_pages}")
    shapes = [_layer_cache_shape(kind, cfg, batch, max_seq, dtype,
                                 cache_kind, page_size, n_pages, kv_dtype)
              for kind in layer_kinds(cfg)]
    return shapes if shapes_only else [module.zeros_like_shapes(c, device)
                                       for c in shapes]


def _read_slot_state(cache: dict, slot, offset) -> dict:
    """The slot's row of a per-slot state (a gather), or zeros when
    ``offset == 0``, so a reused slot cannot leak the previous occupant's
    recurrent state into a fresh sequence (chunk 0 starts from zero state;
    later chunks carry).  ``slot``, ``offset``: one-element int tensors,
    never read on the host."""
    def read(buf):
        row = buf.index_select(0, slot)
        return torch.where(offset.reshape((1,) * row.ndim) > 0, row,
                           torch.zeros((), dtype=row.dtype,
                                       device=row.device))
    return {n: read(buf) for n, buf in cache.items()}


def _write_slot_state(cache: dict, sub: dict, slot) -> None:
    for n, buf in cache.items():
        buf.index_put_((slot,), sub[n].to(buf.dtype))


def _commit_state(cache: dict, new: dict, active) -> None:
    """Write a decode step's recurrent state in place, only for the
    ``active`` slots when a mask is given.  The decode step runs over every
    slot, and a slot that is free or partway through a chunked prefill gets
    junk state; its carried state must survive the step (JAX's
    ``_mask_state_update``)."""
    for n, buf in cache.items():
        val = new[n].to(buf.dtype)
        if active is not None:
            keep = active.reshape((-1,) + (1,) * (buf.ndim - 1))
            val = torch.where(keep, val, buf)
        buf.copy_(val)


def prefill(params, tokens, caches, cfg: ModelConfig,
            fcfg: FamousConfig = FamousConfig()):
    """Monolithic prefill: the whole prompt ``tokens`` (B, S) int (or
    (B, S, D) embeddings) at positions [0, S) in one forward, on the
    serving layout, filling
    ``caches`` (contiguous: K/V stripes of at least S rows or rings, and
    recurrent state, which it starts from) in place.  Attention runs
    ``famous.attention`` (``impl="pallas"``: the ``mha_forward`` kernel),
    the recurrences the scan kernels under ``impl="pallas"`` (the
    models' torch scans otherwise).  An RWKV-6 stack takes S up to 64 or a
    multiple of 64 (``ValueError`` otherwise, before its wkv runs).
    Returns (last-position logits (B, vocab) f32, caches)."""
    x = _embed_inputs(params, tokens, _compute_dtype(params))
    for kind, p, cache in _layers(params, caches, cfg):
        h = layers.apply_norm(p["ln1"], x, cfg.norm)
        if kind in (ATTN, LOCAL_ATTN):
            a, _ = attention.apply_attn_prefill(
                p["attn"], h, cache, cfg, fcfg,
                window=cfg.window if kind == LOCAL_ATTN else 0)
            x = _ffn_residual(p, x + a, cfg)
        elif kind == RGLRU:
            a, new = rglru.apply_rglru(p["rec"], h, cfg, cache, fcfg)
            x = _ffn_residual(p, x + a, cfg)
            _commit_state(cache, new, None)
        else:
            a, tm = rwkv6.apply_rwkv_time_mix(p["tm"], h, cfg, cache,
                                              fcfg=fcfg)
            x = x + a
            h = layers.apply_norm(p["ln2"], x, cfg.norm)
            y, _ = rwkv6.apply_channel_mix(p["cm"], h, cfg)
            x = x + y
            _commit_state(cache, dict(tm, x_cm=h[:, -1]), None)
    x = layers.apply_norm(params["final_norm"], x[:, -1:], cfg.norm)
    return logits_fn(params, x, cfg)[:, 0], caches


def prefill_chunk(params, tokens, caches, slot, offset, n_valid,
                  cfg: ModelConfig, fcfg: FamousConfig = FamousConfig(),
                  page_table=None):
    """One fixed-shape prefill chunk for a single slot of the batched caches.

    tokens: (1, C) int (or (1, C, D) embeddings) at absolute positions
    [offset, offset+C); only the first ``n_valid`` are real: the pad
    tail's junk K/V is never read (a ring keeps only real positions), and
    its recurrent updates are masked to the identity (an MoE layer routes
    the pad rows too, as JAX's does).  Writes the slot's K/V into the caches in place — its
    contiguous stripe or ring, or, given ``page_table`` ((n_slots, n_p)
    int32 on the device), its pages of the pools — and carries its
    recurrent state across chunks (``offset == 0`` starts from zero
    state).  ``slot``, ``offset`` and ``n_valid`` are runtime scalars:
    ints, or one-element int tensors on the device (as the engine stages
    them for its CUDA graph).  They become device tensors here, once, and
    nothing below reads them on the host, so ONE captured graph serves
    every (slot, offset, n_valid), as one JAX executable does; the caller
    keeps them in range (``0 <= slot < n_slots``, ``1 <= n_valid <= C``,
    ``offset + C <= max_seq`` for contiguous stripes).  Returns the caches
    only: prefill logits are dead weight (generation restarts by decoding
    the last prompt token), so the LM head is never computed."""
    dev = tokens.device
    slot, offset, n_valid = (lib.device_scalar("prefill_chunk", v, dev)
                             for v in (slot, offset, n_valid))
    x = _embed_inputs(params, tokens, _compute_dtype(params))
    for kind, p, cache in _layers(params, caches, cfg):
        h = layers.apply_norm(p["ln1"], x, cfg.norm)
        if kind == ATTN and page_table is not None:
            a, _ = attention.apply_attn_chunk_paged(
                p["attn"], h, cache, page_table, slot, offset, cfg, fcfg)
            x = _ffn_residual(p, x + a, cfg)
        elif kind in (ATTN, LOCAL_ATTN):
            a, _ = attention.apply_attn_chunk(
                p["attn"], h, cache, slot, offset, n_valid, cfg, fcfg,
                window=cfg.window if kind == LOCAL_ATTN else 0)
            x = _ffn_residual(p, x + a, cfg)
        elif kind == RGLRU:
            sub = _read_slot_state(cache, slot, offset)
            a, sub = rglru.apply_rglru_chunk(p["rec"], h, cfg, sub, n_valid,
                                             fcfg)
            x = _ffn_residual(p, x + a, cfg)
            _write_slot_state(cache, sub, slot)
        else:
            sub = _read_slot_state(cache, slot, offset)
            a, tm = rwkv6.apply_rwkv_time_mix_chunk(p["tm"], h, sub, cfg,
                                                    n_valid, fcfg=fcfg)
            x = x + a
            h = layers.apply_norm(p["ln2"], x, cfg.norm)
            y, _ = rwkv6.apply_channel_mix(p["cm"], h, cfg,
                                           cache_x=sub["x_cm"])
            x = x + y
            _write_slot_state(cache, dict(tm, x_cm=rwkv6.last_valid(
                h, n_valid)), slot)
    return caches


def decode_step(params, tokens, caches, cache_len, cfg: ModelConfig,
                fcfg: FamousConfig = FamousConfig(), page_table=None,
                active=None, slot_rows=None):
    """tokens: (B,) int (or (B, D) embeddings); cache_len: (B,) int32 on
    the device; page_table: optional (B, n_p) int32 on the device, given
    when the global-attention caches are page pools; active: optional (B,) bool on the device.  Runs
    over every slot (fixed batch).  Attention caches need no mask: the junk
    K/V of inactive slots is masked by ``cache_len`` and overwritten by the
    next chunk (or lands on the null page, or outside every later window).
    Recurrent state is read unconditionally and carried across prefill
    chunks, so it commits only where ``active`` (everywhere when None).
    ``slot_rows``: where a replica group decodes its own slots (B of the
    engine's, ``ServingEngine``), ``(gather, lo, hi)``: the gather of
    every group's rows over the groups' axes and the group's slots, for
    an MoE FFN (:func:`_ffn_residual`).  Returns (logits (B, vocab) f32,
    caches)."""
    inputs = tokens[:, None] if tokens.ndim == 1 else tokens[:, None, :]
    x = _embed_inputs(params, inputs, _compute_dtype(params))
    for kind, p, cache in _layers(params, caches, cfg):
        h = layers.apply_norm(p["ln1"], x, cfg.norm)
        if kind == ATTN and page_table is not None:
            a, _ = attention.apply_attn_decode_paged(
                p["attn"], h, cache, page_table, cache_len, cfg, fcfg)
            x = _ffn_residual(p, x + a, cfg, slot_rows)
        elif kind in (ATTN, LOCAL_ATTN):
            a, _ = attention.apply_attn_decode(
                p["attn"], h, cache, cache_len, cfg, fcfg,
                window=cfg.window if kind == LOCAL_ATTN else 0)
            x = _ffn_residual(p, x + a, cfg, slot_rows)
        elif kind == RGLRU:
            a, new = rglru.apply_rglru_decode(p["rec"], h, cache, cfg)
            x = _ffn_residual(p, x + a, cfg, slot_rows)
            _commit_state(cache, new, active)
        else:
            a, tm = rwkv6.apply_rwkv_time_mix_decode(p["tm"], h, cache, cfg)
            x = x + a
            h = layers.apply_norm(p["ln2"], x, cfg.norm)
            y, _ = rwkv6.apply_channel_mix(p["cm"], h, cfg,
                                           cache_x=cache["x_cm"])
            x = x + y
            _commit_state(cache, dict(tm, x_cm=h[:, -1]), active)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    return logits_fn(params, x, cfg)[:, 0], caches


def verify_step(params, tokens, caches, cache_len, cfg: ModelConfig,
                fcfg: FamousConfig = FamousConfig(), page_table=None,
                slot_rows=None):
    """Speculative verify: decode W tokens per slot in ONE forward.

    tokens: (B, W) int — row b is ``[last_token, draft_1..draft_{W-1}]``
    at absolute positions ``cache_len[b] + j`` (pad rows past a short draft
    are ignored by the caller); cache_len: (B,) int32 valid entries BEFORE
    the first token, on the device; page_table as in :func:`decode_step`.
    Returns (logits (B, W, vocab) f32, caches): ``logits[b, j]`` is what
    the j+1-th of sequential :func:`decode_step` calls over ``tokens[b,
    :j+1]`` would give (causal attention makes the two identical), so the
    engine can accept the longest draft prefix the model agrees with and
    stay token-identical to plain decode.  Only global-attention stacks
    verify: a ring would overwrite its oldest rows before the accepted
    count is known, and recurrent state cannot roll back to an
    intermediate position (the engine decodes plainly instead).
    ``slot_rows`` as in :func:`decode_step`."""
    kinds = set(layer_kinds(cfg))
    if kinds != {ATTN}:
        raise ValueError(f"verify_step only supports global-attention "
                         f"layers, got {sorted(kinds)}")
    x = _embed_inputs(params, tokens, _compute_dtype(params))
    writes = None
    if page_table is None:   # every layer's write indices, made once
        writes = attention.verify_writes(cache_len, tokens.shape[1],
                                         caches[0]["k"].shape[1])
    for _, p, cache in _layers(params, caches, cfg):
        h = layers.apply_norm(p["ln1"], x, cfg.norm)
        if page_table is not None:
            a, _ = attention.apply_attn_verify_paged(
                p["attn"], h, cache, page_table, cache_len, cfg, fcfg)
        else:
            a, _ = attention.apply_attn_verify(p["attn"], h, cache,
                                               cache_len, cfg, fcfg,
                                               writes=writes)
        x = _ffn_residual(p, x + a, cfg, slot_rows)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    return logits_fn(params, x, cfg), caches


def clear_slot(caches, slot, cfg: ModelConfig, paged: bool = False) -> list:
    """Zero slot ``slot``'s per-slot cache rows in place — K/V stripes,
    rings and recurrent state (stale-state hygiene for length-1 admissions
    that skip prefill).  ``slot``: an int or a one-element int tensor on
    the caches' device, never read on the host (``index_fill_``), so one
    captured graph clears every slot.  Page pools (global attention,
    ``paged``) have no slot axis (``buf[slot]`` would be page ``slot``, a
    live page) and are left alone: the slot's pages were freed, and any
    stale content is unreachable (its table row is null, reads are
    ``cache_len``-masked)."""
    bufs = [buf for kind, cache in zip(layer_kinds(cfg), caches)
            if not (paged and kind == ATTN) for buf in cache.values()]
    if bufs:
        idx = lib.device_scalar("clear_slot", slot,
                                bufs[0].device).to(torch.int64)
        for buf in bufs:
            buf.index_fill_(0, idx, 0)
    return caches


def _scatter_pages(pool, kv_seq, page_ids):
    """Write a contiguous (max_seq, ...) stripe into pool pages in place:
    pool (n_pages, page_size, ...); page_ids (n_p,) int on the device,
    NULL-padded past the slot's live pages (the null page absorbs the
    padded stretch); max_seq == n_p * page_size.  The padding names the
    null page many times, so every duplicate id writes the last stretch
    that names it (``attention._last_writer`` at page granularity): the
    sequential order's result, as on the CPU and in JAX, whatever order
    the device applies the writes in."""
    n_p, ps = page_ids.shape[0], pool.shape[1]
    pages = kv_seq.reshape((n_p, ps) + kv_seq.shape[1:]).to(pool.dtype)
    last = attention._last_writer(page_ids, torch.zeros_like(page_ids), 1)
    pool[page_ids] = pages.index_select(0, last)
    return pool


def _scatter_paged_kv(dst: dict, src_k, src_v, page_ids) -> dict:
    """A slot's contiguous K/V stripes (max_seq, kv, dh) into a paged
    global-attention pool, quantized at write time when the pool is int8
    (scale pools present); the scale rows go to the same page ids as
    their int8 rows."""
    if "k_scale" in dst:
        kq, ks = attention._kv_quantize(src_k)
        vq, vs = attention._kv_quantize(src_v)
        for name, val in (("k", kq), ("v", vq), ("k_scale", ks),
                          ("v_scale", vs)):
            _scatter_pages(dst[name], val, page_ids)
    else:
        _scatter_pages(dst["k"], src_k, page_ids)
        _scatter_pages(dst["v"], src_v, page_ids)
    return dst


def write_prefill_to_slot(caches, one, slot, cfg: ModelConfig,
                          page_ids=None) -> list:
    """Write a single-sequence prefill cache ``one`` (batch 1, contiguous,
    as :func:`prefill` fills it) into slot ``slot`` of the batched
    ``caches``, in place.  ``slot``: an int or a one-element int tensor on
    the caches' device, never read on the host.  Every per-slot leaf
    takes its slot row (``index_copy_``); with ``page_ids`` ((n_p,) int on
    the device, the slot's page-table row, NULL-padded) the
    global-attention K/V stripes are cut into pages and scattered to the
    slot's pages instead (:func:`_scatter_paged_kv`)."""
    idx = None
    for kind, dst, src in zip(layer_kinds(cfg), caches, one):
        if page_ids is not None and kind == ATTN:
            _scatter_paged_kv(dst, src["k"][0], src["v"][0], page_ids)
            continue
        for n, buf in dst.items():
            if idx is None:
                idx = lib.device_scalar("write_prefill_to_slot", slot,
                                        buf.device).to(torch.int64)
            buf.index_copy_(0, idx, src[n].to(buf.dtype))
    return caches
