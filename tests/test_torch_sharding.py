"""PyTorch port, the logical-axis layer: ``parallel/sharding.py``,
``launch/mesh.py``'s abstract meshes, ``parallel/incontext.py``, the axes
trees (``module.logical_axes`` / ``param_shapes``,
``transformer.param_axes`` / ``cache_axes``, ``step.state_logical_axes``)
and ``RunConfig``, against the JAX package on the CPU.

JAX's ``tests/test_sharding.py`` cases run on the port, each also held to
JAX's ``spec_for_axes`` on the same abstract mesh (a port spec is a tuple;
JAX's ``PartitionSpec`` compares equal to it).  For all 11 configs at full
width the trees equal JAX's leaf for leaf, and every leaf's resolved spec
equals JAX's under the four rule sets on six meshes, divisibility
fallbacks included.  Spec resolution reads names and sizes only, so 256-
and 512-way meshes resolve on one host."""
import dataclasses
import warnings

import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import base as jbase
from repro.launch import mesh as jmesh
from repro.models import module as jmodule
from repro.models import transformer as jtransformer
from repro.parallel import incontext as jincontext
from repro.parallel import sharding as jshd
from repro.train import step as jstep
from repro_torch.configs import base
from repro_torch.launch.mesh import abstract_mesh, make_production_mesh
from repro_torch.models import module, transformer
from repro_torch.parallel import incontext
from repro_torch.parallel import sharding as shd
from repro_torch.train import step as step_lib

torch.set_num_threads(1)

MESH2 = abstract_mesh((16, 16), ("data", "model"))
MESH3 = abstract_mesh((2, 16, 16), ("pod", "data", "model"))
MESH4 = abstract_mesh((1, 4), ("data", "model"))
JMESH = {m: jmesh.abstract_mesh(m.axis_sizes, m.axis_names)
         for m in (MESH2, MESH3, MESH4)}
RULES = ["DEFAULT_RULES", "TP_ONLY_RULES", "SERVE_TP_RULES",
         "ZERO_SEQ_RULES"]
MESHES = [((1, 1), ("data", "model")), ((1, 2), ("data", "model")),
          ((1, 4), ("data", "model")), ((2, 2), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
# kimi-k2-instruct (base.PORT_ONLY) has no JAX twin to hold its axes to,
# and latent attention runs on no mesh (transformer.check_mesh refuses it)
ARCHS = [a for a in base.list_configs() if a not in base.PORT_ONLY]
CACHES = [("contiguous", "fp"), ("paged", "fp"), ("paged", "int8")]


def _both(mesh, axes, rules=None, shape=None):
    """The port's spec, held equal to JAX's on the same mesh."""
    mine = shd.spec_for_axes(mesh, axes, rules, shape)
    theirs = jshd.spec_for_axes(JMESH[mesh], axes, rules, shape)
    assert mine == theirs and isinstance(mine, tuple), (mine, theirs)
    return mine


# -- JAX's tests/test_sharding.py, on the port ------------------------------

def test_spec_basic():
    assert _both(MESH2, ("embed", "mlp")) == P("data", "model")


def test_divisibility_fallback_drops_axis():
    # hubert vocab 504 is not divisible by the 16-way model axis
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        spec = _both(MESH2, ("vocab", "embed"), shape=(504, 1280))
    assert spec == P(None, "data")


def test_heads_fallback():
    # qwen2's 28 heads don't divide 16 -> replicate; embed still FSDP-sharded
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        spec = _both(MESH2, ("embed", "heads", "head_dim"),
                     shape=(3584, 28, 128))
    assert spec == P("data", None, None)
    # command-r's 96 heads do divide
    spec = _both(MESH2, ("embed", "heads", "head_dim"),
                 shape=(12288, 96, 128))
    assert spec == P("data", "model", None)


def test_tuple_prefix_fallback():
    # batch 2 on a (pod=2, data=16) dp tuple -> falls back to ("pod",)
    spec = _both(MESH3, ("batch", None), shape=(2, 8))
    assert spec == P(("pod",), None) or spec == P("pod", None)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        # batch 1 -> fully replicated
        spec = _both(MESH3, ("batch", None), shape=(1, 8))
    assert spec == P(None, None)
    # batch 256 -> full dp tuple
    spec = _both(MESH3, ("batch", None), shape=(256, 8))
    assert spec == P(("pod", "data"), None)


def test_axis_used_once():
    spec = _both(MESH2, ("mlp", "heads"), shape=(256, 32))
    assert spec == P("model", None)


def test_missing_mesh_axis_dropped():
    spec = _both(MESH2, ("batch",), shape=(256,))
    assert spec == P("data")  # no "pod" on the single-pod mesh


def test_tree_specs_with_shapes():
    """``tree_specs`` (JAX's ``tree_shardings``) on a mesh of one rank;
    the leaves' shapes come from tensors and from ``ShapeDtype``."""
    mesh = abstract_mesh((1, 1), ("data", "model"))
    axes_tree = {"w": ("embed", "mlp"), "b": ("mlp",)}
    shapes = {"w": torch.empty(64, 128),
              "b": module.ShapeDtype((128,), torch.float32)}
    out = shd.tree_specs(mesh, axes_tree, None, shapes)
    assert out["w"] == P("data", "model")
    assert out["b"] == P("model")
    assert shd.tree_specs(mesh, [axes_tree], None, [shapes]) == [out]


def test_replicate_fallback_warns_once():
    """A non-divisible ruled dim replicates with ONE RuntimeWarning per
    distinct (axis, dim, mesh-axes) combo — not one per tree leaf."""
    shd._REPLICATE_WARNED.clear()
    with pytest.warns(RuntimeWarning, match="kv_heads.*not divisible"):
        spec = shd.spec_for_axes(MESH4, (None, None, "kv_heads", "head_dim"),
                                 shape=(2, 32, 6, 16))
    assert spec == P(None, None, None, None)
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # a repeat would now raise
        spec = shd.spec_for_axes(MESH4, (None, None, "kv_heads", "head_dim"),
                                 shape=(2, 32, 6, 16))
    assert spec == P(None, None, None, None)
    with pytest.warns(RuntimeWarning, match="kv_heads.*dim 10"):
        shd.spec_for_axes(MESH4, (None, None, "kv_heads", "head_dim"),
                          shape=(2, 32, 10, 16))   # a distinct fallback


def test_divisible_path_does_not_warn():
    shd._REPLICATE_WARNED.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        spec = _both(MESH4, (None, None, "kv_heads", "head_dim"),
                     shape=(2, 32, 8, 16))
    assert spec == P(None, None, "model", None)


def test_serve_tp_rules():
    """Serving TP: heads/kv_heads/mlp shard over "model"; vocab and embed
    replicate so logits (and the LM head) come back replicated."""
    rules = shd.SERVE_TP_RULES
    assert _both(MESH4, ("embed", "heads", "head_dim"),
                 rules, (64, 8, 16)) == P(None, "model", None)
    assert _both(MESH4, ("embed", "vocab"), rules, (64, 256)) == P(None, None)
    assert _both(MESH4, ("embed", "mlp"), rules, (64, 128)) == P(None, "model")


def test_dp_helpers():
    assert shd.dp_axes(MESH3) == jshd.dp_axes(JMESH[MESH3]) == ("pod", "data")
    assert shd.dp_size(MESH3) == jshd.dp_size(JMESH[MESH3]) == 32
    assert shd.dp_size(MESH2) == jshd.dp_size(JMESH[MESH2]) == 16
    assert shd.replicated(MESH2) == P()
    assert shd.batch_spec(MESH3, 3, shape=(64, 8, 8)) == \
        P(("pod", "data"), None, None)


# -- the rule sets, the axes trees, the resolved specs ----------------------

@pytest.mark.parametrize("name", RULES)
def test_rule_sets_equal_jax(name):
    assert getattr(shd, name) == getattr(jshd, name)


def _cfgs(arch):
    return base.get_config(arch), jbase.get_config(arch)


def _jax_layer(tree, cfg, layer):
    """Layer ``layer``'s subtree of a JAX cache tree (stacked units, then
    the tail) and whether its leaves carry the stacking dim."""
    n = cfg.num_units * len(cfg.pattern_unit)
    if layer < n:
        return tree["blocks"][f"pos{layer % len(cfg.pattern_unit)}"], True
    return tree[f"tail{layer - n}"], False


def _same_tree(mine, theirs, leaf=lambda a, b: a == b):
    if isinstance(mine, dict):
        assert set(mine) == set(theirs), (sorted(mine), sorted(theirs))
        for k in mine:
            _same_tree(mine[k], theirs[k], leaf)
    else:
        assert leaf(mine, theirs), (mine, theirs)


def _port_caches(cfg, kind, dt):
    return transformer.make_caches(cfg, 4, 2048, torch.bfloat16, "meta",
                                   cache_kind=kind, page_size=16,
                                   n_pages=513, kv_dtype=dt)


def _jax_caches(jcfg, kind, dt):
    return jtransformer.make_caches(jcfg, 4, 2048, jnp.bfloat16, True,
                                    cache_kind=kind, page_size=16,
                                    n_pages=513, kv_dtype=dt)


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_trees_match_jax(arch):
    """``param_axes``, ``param_shapes`` and ``state_logical_axes`` have the
    spec tree's structure and equal JAX's leaf for leaf; ``cache_axes``
    (contiguous, paged, paged int8) has the port's cache structure (a
    dict a layer) and equals JAX's per-layer leaf, stacking dim off, and
    the caches' shapes agree with it."""
    cfg, jcfg = _cfgs(arch)
    _same_tree(transformer.param_axes(cfg), jtransformer.param_axes(jcfg))
    state, jstate = step_lib.state_logical_axes(cfg), \
        jstep.state_logical_axes(jcfg)
    _same_tree(state, jstate)
    _same_tree(module.param_shapes(transformer.model_spec(cfg)),
               jmodule.param_shapes(jtransformer.model_spec(jcfg)),
               lambda a, b: a.shape == tuple(b.shape)
               and str(a.dtype).split(".")[-1] == str(b.dtype))
    for kind, dt in CACHES:
        axes = transformer.cache_axes(cfg, kind, dt)
        jaxes = jtransformer.cache_axes(jcfg, kind, dt)
        caches, jcaches = _port_caches(cfg, kind, dt), _jax_caches(jcfg, kind,
                                                                    dt)
        assert len(axes) == len(caches) == cfg.num_layers
        for layer, (ax, cache) in enumerate(zip(axes, caches)):
            jax_ax, stacked = _jax_layer(jaxes, cfg, layer)
            jax_c, _ = _jax_layer(jcaches, cfg, layer)
            cut = 1 if stacked else 0
            assert ax.keys() == cache.keys() == jax_ax.keys()
            for n in ax:
                assert ax[n] == tuple(jax_ax[n])[cut:]
                assert tuple(cache[n].shape) == tuple(jax_c[n].shape)[cut:]
                assert len(ax[n]) == cache[n].ndim


def _spec_pairs(cfg, jcfg):
    """(axes, shape) of every leaf of the params and of the three cache
    kinds, the port's and JAX's side by side."""
    pairs = []
    axes = module.tree_leaves(transformer.param_axes(cfg))
    shapes = module.tree_leaves(module.param_shapes(
        transformer.model_spec(cfg)))
    pairs += [(a, s.shape) for a, s in zip(axes, shapes)]
    for kind, dt in CACHES:
        for ax, cache in zip(transformer.cache_axes(cfg, kind, dt),
                             _port_caches(cfg, kind, dt)):
            pairs += [(ax[n], tuple(cache[n].shape)) for n in sorted(ax)]
    return pairs


@pytest.mark.parametrize("mesh_def", MESHES, ids=lambda m: "x".join(
    map(str, m[0])) if isinstance(m, tuple) else str(m))
@pytest.mark.parametrize("rules", RULES)
def test_specs_match_jax(rules, mesh_def):
    """Every leaf of every config's params and caches resolves to JAX's
    spec under the rule set on the mesh (fallbacks included)."""
    mesh = abstract_mesh(*mesh_def)
    jm = jmesh.abstract_mesh(*mesh_def)
    mine_rules, jax_rules = getattr(shd, rules), getattr(jshd, rules)
    n = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for arch in ARCHS:
            cfg, jcfg = _cfgs(arch)
            for axes, shape in _spec_pairs(cfg, jcfg):
                mine = shd.spec_for_axes(mesh, axes, mine_rules, shape)
                theirs = jshd.spec_for_axes(jm, axes, jax_rules, shape)
                assert mine == theirs, (arch, axes, shape, mine, theirs)
                local = shd.local_shape(shape, mine, mesh)
                assert all(d * shd.sharded_size(e, mesh) == s for d, e, s
                           in zip(local, tuple(mine), shape))
                n += 1
    assert n > 500


# -- meshes, local shards, in-context constraints, RunConfig ----------------

def test_production_mesh_is_abstract():
    for multi, jm in ((False, ((16, 16), ("data", "model"))),
                      (True, ((2, 16, 16), ("pod", "data", "model")))):
        m = make_production_mesh(multi_pod=multi)
        assert (m.axis_sizes, m.axis_names) == jm
        assert shd.axis_sizes(m) == dict(zip(jm[1], jm[0]))


@pytest.mark.parametrize("spec", [("model", None), (None, "model"),
                                  (("data", "model"), None),
                                  ("data", "model"), (None, None)])
def test_local_shards_tile_the_tensor(spec):
    """The four ranks' shards (``local_shard``) of a (2, 2) mesh tile the
    tensor, each element held by as many ranks as the spec replicates it
    over; each shard is a view of the shape ``local_shape`` gives."""
    mesh = abstract_mesh((2, 2), ("data", "model"))
    t = torch.arange(8 * 12).reshape(8, 12)
    seen = torch.zeros_like(t)
    for d in range(2):
        for m in range(2):
            part = shd.local_shard(t, spec, mesh, {"data": d, "model": m})
            assert tuple(part.shape) == shd.local_shape(t.shape, spec, mesh)
            assert (part.untyped_storage().data_ptr()
                    == t.untyped_storage().data_ptr())     # a view
            seen += torch.isin(t, part).long()
    parts = shd.sharded_size(spec[0], mesh) * shd.sharded_size(spec[1], mesh)
    assert (seen == 4 // parts).all()


def test_incontext_is_the_identity():
    x = torch.randn(2, 3, 4, 8)
    with incontext.use_rules(shd.SERVE_TP_RULES):
        assert incontext._ACTIVE_RULES.get() is shd.SERVE_TP_RULES
        assert incontext.constrain(x, ("batch", None, "heads", None)) is x
        assert incontext.constrain_residual(x, 28) is x
        assert incontext.reshard_fwd_bwd(x, ("batch",), ("seq",)) is x
        q, k, v = incontext.constrain_attn_activations(x, x, x, 4)
        assert q is k is v is x
    assert incontext._ACTIVE_RULES.get() is None
    assert incontext.heads_divide_model(28) is jincontext.heads_divide_model(
        28) is True
    assert not incontext.heads_divide_model(28, MESH2)
    assert incontext.heads_divide_model(96, MESH2)


@pytest.mark.parametrize("tp,dp", [(1, 1), (2, 1), (4, 1), (2, 2)])
def test_run_config(tp, dp):
    """``RunConfig`` is JAX's: the same fields and mesh shape; no mesh at
    tp == dp == 1."""
    mine = base.RunConfig(arch="qwen2-7b", tp=tp, dp=dp)
    theirs = jbase.RunConfig(arch="qwen2-7b", tp=tp, dp=dp)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.mesh_shape == theirs.mesh_shape == (dp, tp)
    assert mine.needs_mesh == theirs.needs_mesh == (tp * dp > 1)
    if not mine.needs_mesh:
        assert mine.make_mesh() is None
    with pytest.raises(AssertionError):
        base.RunConfig(arch="qwen2-7b", tp=0)
