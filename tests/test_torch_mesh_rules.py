"""PyTorch port, the rest of the serving mesh: ``ServingEngine(mesh=,
sharding_rules=)`` under every rule set of ``parallel/sharding.py``, with
replica groups, query heads that span kv heads and RWKV-6 columns that cut
a head, against the JAX package's unsharded engine.

GSPMD only moves data, so JAX's engine on any mesh gives its unsharded
engine's tokens; every rank here must give them too.  The ranks of each
world size (2, 4, 8) are ``torch.multiprocessing`` spawns of one gloo
group over a ``FileStore``, started once for the module (:func:`ranks`);
each builds its world's meshes and runs their cases on the CPU (the
kernels' plain versions under ``impl="pallas"``), while the parent runs
the JAX engine on the same numpy weights.  Every join has a deadline.

The cases:
  * the rule sets TP_ONLY / DEFAULT / ZERO_SEQ ("vocab" over "model":
    the vocab-parallel lookup and head; "embed" over "data" or every
    axis: gathered in each layer) on (1, 2) and (2, 2) x contiguous /
    paged x xla / pallas, and on (1, 4) and (2, 1);
  * replica groups (SERVE_TP_RULES on (2, 1) and (2, 2)) for the attn
    and hybrid configs, contiguous (slots cut over the groups: each
    group's cache bytes are half of one group's) and paged (the pool
    whole on every group); with an MoE (the decode routes every slot's
    rows in one group), monolithic prefill, seeded sampling and the
    launcher's ``--mesh-shape 2,1``;
  * 12 query heads over 3 kv heads at TP=2 (6 heads a rank over groups
    of 4) and TP=4 (3 heads a rank);
  * RWKV-6 under ZERO_SEQ (its token-shift rows cut over "model": the
    cache leaf gathered in its layer) and on 8 ranks, whose 64 columns
    would cut the shrunk config's 4 heads of 16 (the time mix then runs
    on gathered leaves).
"""
import gc
import os
import pickle
import time
import traceback
import warnings

import numpy as np
import pytest
import torch

# the ranks import this module; jax, repro and the helpers that use them
# are imported inside the functions the parent process runs
from repro_torch import convert
from repro_torch.configs.base import get_config, shrink
from repro_torch.core.famous import FamousConfig
from repro_torch.parallel import sharding as shd
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.paged import PagedCacheConfig

torch.set_num_threads(1)

ARCHS = {
    "attn": ("qwen2-7b", dict(num_heads=8, num_kv_heads=4, head_dim=8)),
    "hybrid": ("recurrentgemma-2b", {}),
    "kv12": ("qwen2-7b", dict(num_heads=12, num_kv_heads=3, head_dim=8)),
    "moe": ("grok-1-314b", {}),
    "rwkv": ("rwkv6-1.6b", {}),
}
ENGINE = dict(n_slots=2, max_seq=32, chunk=8, page_size=8)
RULES = {"serve_tp": shd.SERVE_TP_RULES, "tp_only": shd.TP_ONLY_RULES,
         "default": shd.DEFAULT_RULES, "zero_seq": shd.ZERO_SEQ_RULES}
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "1x4": (1, 4), "2x2": (2, 2),
          "1x8": (1, 8)}
JOIN_S = 300


def _case(arch, mesh, rules, kind="contiguous", impl="xla", **kw):
    return (arch, mesh, rules, dict(impl=impl, cache_kind=kind, **kw))


# name -> (arch, mesh, rules, engine kwargs); "sampled" draws seeded top-k
CASES = {}
for _m in ("1x2", "2x2"):
    for _r in ("tp_only", "default", "zero_seq"):
        for _k in ("contiguous", "paged"):
            for _i in ("xla", "pallas"):
                CASES[f"rules-{_r}-{_m}-{_k}-{_i}"] = _case(
                    "attn", _m, _r, _k, _i)
for _m in ("1x4", "2x1"):
    for _r in ("tp_only", "default", "zero_seq"):
        CASES[f"rules-{_r}-{_m}-contiguous-xla"] = _case("attn", _m, _r)
for _m in ("2x1", "2x2"):
    for _a, _i in (("attn", "pallas"), ("hybrid", "xla")):
        for _k in ("contiguous", "paged"):
            CASES[f"dp-{_a}-{_m}-{_k}"] = _case(_a, _m, "serve_tp", _k, _i)
CASES.update({
    "dp-moe-2x1-contiguous": _case("moe", "2x1", "serve_tp"),
    "dp-monolithic-2x1": _case("attn", "2x1", "serve_tp",
                               prefill_mode="monolithic"),
    "default-monolithic-2x2": _case("attn", "2x2", "default", "paged",
                                    prefill_mode="monolithic"),
    "dp-seeded-2x1": _case("attn", "2x1", "serve_tp", sampled=True),
    "default-seeded-2x2": _case("attn", "2x2", "default", "paged",
                                sampled=True),
    "hybrid-default-2x2-paged": _case("hybrid", "2x2", "default", "paged"),
    "kv12-1x2-contiguous": _case("kv12", "1x2", "serve_tp", impl="pallas"),
    "kv12-1x2-paged": _case("kv12", "1x2", "serve_tp", "paged", "pallas"),
    "kv12-1x4-contiguous": _case("kv12", "1x4", "serve_tp", impl="pallas"),
    "kv12-1x4-paged": _case("kv12", "1x4", "serve_tp", "paged", "pallas"),
    "rwkv-zero_seq-1x2": _case("rwkv", "1x2", "zero_seq"),
    "rwkv-zero_seq-2x2": _case("rwkv", "2x2", "zero_seq"),
    "rwkv-head-cut-1x8": _case("rwkv", "1x8", "serve_tp"),
})


def _world(mesh):
    return int(np.prod(MESHES[mesh]))


def _cfg(arch):
    name, over = ARCHS[arch]
    return shrink(get_config(name), **over)


def _prompts(cfg, sampled=False):
    rng = np.random.default_rng(1)
    out = []
    for i in range(3):
        kw = dict(temperature=0.8, top_k=8, seed=77 + i) if sampled else {}
        out.append((i, [int(t) for t in
                         rng.integers(0, cfg.vocab_size, 5 + 4 * i)], kw))
    return out


def _serve(arch, weights, mesh, rules, kw):
    """Serve the case's three requests.  Returns (tokens by rid,
    engine)."""
    kw = dict(kw)
    impl, sampled = kw.pop("impl"), kw.pop("sampled", False)
    cfg = _cfg(arch)
    eng = ServingEngine(convert.tree_from_jax(weights[arch], "cpu"), cfg,
                        FamousConfig(impl=impl), mesh=mesh,
                        sharding_rules=rules, device="cpu", **ENGINE, **kw)
    done = eng.run([Request(rid=i, tokens=t, max_new=5, **skw)
                    for i, t, skw in _prompts(cfg, sampled)])
    assert all(r.error is None for r in done), [r.error for r in done]
    return {r.rid: tuple(r.out) for r in done}, eng


def _try(fn):
    """A case's result, or the traceback it raised."""
    try:
        return fn()
    except Exception:
        return {"error": traceback.format_exc()}


def _launcher():
    """``launch/serve.py --mesh-shape 2,1`` on the smoke config."""
    from repro_torch.launch import serve as serve_launch
    done = serve_launch.main(["--smoke", "--device", "cpu", "--requests",
                              "3", "--max-new", "4", "--max-seq", "32",
                              "--chunk", "8", "--slots", "2",
                              "--mesh-shape", "2,1"])
    return dict(tokens={r.rid: tuple(r.out) for r in done},
                errors=[r.error for r in done if r.error])


def _whole_vocab_held(eng, cfg):
    """Whether the rank holds a whole vocabulary table: the embedding or
    the f32 LM head."""
    p = eng.params
    V, D = cfg.vocab_size, cfg.d_model
    return (tuple(p["embed"]["embedding"].shape) == (V, D)
            or tuple(p["unembed_f32"].shape) == (D, V))


def _rank_cases(world, weights):
    from repro_torch.launch.mesh import make_mesh
    meshes = {n: make_mesh(s, ("data", "model"), "cpu")
              for n, s in MESHES.items() if int(np.prod(s)) == world}
    out = {}
    for name, (arch, mname, rname, kw) in CASES.items():
        if mname not in meshes:
            continue

        def run(arch=arch, mesh=meshes[mname], rules=RULES[rname], kw=kw):
            toks, eng = _serve(arch, weights, mesh, rules, kw)
            if eng.paged:
                eng.alloc.assert_invariants()
            return dict(tokens=toks, bytes=eng.cache_bytes_per_device(),
                        keys={k: list(e.keys) for k, e in eng._exec.items()},
                        whole_vocab=_whole_vocab_held(eng, _cfg(arch)))
        out[name] = _try(run)
    if world == 2:
        out["launcher-2x1"] = _try(_launcher)
    return out


def _rank_main(rank, world, tmp):
    """One rank: join the gloo group, run the world size's cases, write
    them to ``tmp/rank{rank}.pkl``, and tear the groups down only once
    every rank of the world has written its own (:func:`_all_done`)."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        with open(os.path.join(tmp, "weights.pkl"), "rb") as f:
            weights = pickle.load(f)
        with warnings.catch_warnings():
            # the replicate fallback warns; here it is intended
            warnings.simplefilter("ignore", RuntimeWarning)
            out = _rank_cases(world, weights)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        _all_done(store, world)
        dist.destroy_process_group()


def _all_done(store, world, timeout_s=JOIN_S):
    """Tear-down in order.  Under the loaded suite a rank of world 4 once
    ended in SIGABRT ("terminate called without an active exception")
    after two of its peers had exited cleanly: past the last collective,
    in tear-down.  So the cases' engines, which sit in reference cycles
    holding the mesh's groups, are collected now rather than during the
    interpreter's exit, and no rank destroys its groups until every rank
    has counted in through the store (not through gloo), so no
    collective of them is in flight."""
    gc.collect()
    store.add("done", 1)
    deadline = time.monotonic() + timeout_s
    while store.add("done", 0) < world and time.monotonic() < deadline:
        time.sleep(0.05)


def _jax_key(arch, kw):
    kw = dict(kw)
    return (arch, kw.pop("impl"), kw.pop("cache_kind"),
            kw.pop("prefill_mode", "chunked"), kw.pop("sampled", False))


def _jax_tokens(jweights, key):
    from repro.configs.base import get_config as jget_config
    from repro.configs.base import shrink as jshrink
    from repro.core.famous import FamousConfig as JFamousConfig
    from repro.serve.engine import Request as JRequest
    from repro.serve.engine import ServingEngine as JServingEngine

    arch, impl, kind, mode, sampled = key
    name, over = ARCHS[arch]
    jcfg = jshrink(jget_config(name), **over)
    eng = JServingEngine(jweights[arch], jcfg, JFamousConfig(impl=impl),
                         cache_kind=kind, prefill_mode=mode, **ENGINE)
    done = eng.run([JRequest(rid=i, tokens=t, max_new=5, **skw)
                    for i, t, skw in _prompts(_cfg(arch), sampled)])
    assert all(r.error is None for r in done), [r.error for r in done]
    return {r.rid: tuple(r.out) for r in done}


def _jax_cache_bytes(arch, kind, mesh, rules):
    """A rank's cache bytes as JAX places the caches: each leaf's shard
    shape under ``spec_for_axes`` of JAX's ``cache_axes`` on ``mesh``."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_config as jget_config
    from repro.configs.base import shrink as jshrink
    from repro.launch.mesh import abstract_mesh
    from repro.models import transformer as jtransformer
    from repro.parallel import sharding as jshd

    name, over = ARCHS[arch]
    jcfg = jshrink(jget_config(name), **over)
    n_pages = PagedCacheConfig.default_pool(
        ENGINE["n_slots"], ENGINE["max_seq"], ENGINE["page_size"])
    shapes = jtransformer.make_caches(
        jcfg, ENGINE["n_slots"], ENGINE["max_seq"], jnp.float32,
        shapes_only=True, cache_kind=kind, page_size=ENGINE["page_size"],
        n_pages=n_pages)
    axes = jtransformer.cache_axes(jcfg, kind)
    jmesh = abstract_mesh(MESHES[mesh], ("data", "model"))
    sizes = dict(zip(("data", "model"), MESHES[mesh]))
    total = 0
    for leaf, ax in zip(jax.tree_util.tree_leaves(shapes),
                        jax.tree_util.tree_leaves(
                            axes, is_leaf=lambda x: isinstance(x, tuple))):
        spec = jshd.spec_for_axes(jmesh, ax, rules, leaf.shape)
        n = 1
        for d, entry in zip(leaf.shape, tuple(spec) + (None,) * 8):
            ways = 1
            for a in (() if entry is None else
                      entry if isinstance(entry, tuple) else (entry,)):
                ways *= sizes[a]
            n *= d // ways
        total += n * np.dtype(leaf.dtype).itemsize
    return total


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the ranks of every world size at once, compute the JAX
    baselines meanwhile, then join them under a deadline.  Returns
    (results by world size: a list by rank of {case: result}, JAX tokens
    by case name)."""
    import jax.numpy as jnp
    import torch.multiprocessing as mp
    from repro.configs.base import get_config as jget_config
    from repro.configs.base import shrink as jshrink
    from torch_port_helpers import random_jax_params

    jweights = {a: random_jax_params(jshrink(jget_config(n), **o), seed=4,
                                     dtype=jnp.float32)
                for a, (n, o) in ARCHS.items()}
    weights = {a: _to_numpy(w) for a, w in jweights.items()}
    procs, dirs = {}, {}
    for world in sorted({_world(m) for _, m, _, _ in CASES.values()}):
        tmp = str(tmp_path_factory.mktemp(f"world{world}"))
        with open(os.path.join(tmp, "weights.pkl"), "wb") as f:
            pickle.dump(weights, f)
        dirs[world] = tmp
        procs[world] = mp.start_processes(_rank_main, args=(world, tmp),
                                          nprocs=world, join=False,
                                          start_method="spawn")
    keys = {name: _jax_key(arch, kw)
            for name, (arch, _, _, kw) in CASES.items()}
    jax_runs = {key: _jax_tokens(jweights, key) for key in set(keys.values())}
    jax_tokens = {name: jax_runs[key] for name, key in keys.items()}
    deadline = time.monotonic() + JOIN_S
    try:
        for world, ctx in procs.items():
            while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    pytest.fail(f"the {world} ranks did not finish in "
                                f"{JOIN_S} s")
    finally:
        for ctx in procs.values():
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
    results = {}
    for world, tmp in dirs.items():
        results[world] = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results[world].append(pickle.load(f))
    return results, jax_tokens


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _per_rank(ranks, world, case):
    """The case's result on every rank of ``world``, failing on a rank
    that raised."""
    out = []
    for r, res in enumerate(ranks[0][world]):
        got = res[case]
        assert "error" not in got, f"rank {r} of {world}: {got['error']}"
        out.append(got)
    return out


def _jax_identical(ranks, case):
    """Every rank's tokens are the JAX engine's; returns the results."""
    res = _per_rank(ranks, _world(CASES[case][1]), case)
    for r, got in enumerate(res):
        assert got["tokens"] == ranks[1][case], (case, r)
    return res


RULE_CASES = [n for n in CASES if n.startswith("rules-")]


@pytest.mark.parametrize("case", RULE_CASES)
def test_every_rule_set_serves_like_jax(ranks, case):
    """TP_ONLY, DEFAULT and ZERO_SEQ on (1, 2), (2, 2), (1, 4) and
    (2, 1): every rank gives JAX's tokens with one executable of each
    kind, and where the mesh has a "model" axis no rank holds a whole
    vocabulary table."""
    model = MESHES[CASES[case][1]][1]
    for got in _jax_identical(ranks, case):
        assert got["keys"]["prefill"] == ["prefill"]
        assert got["keys"]["decode"] == ["decode"]
        assert model == 1 or not got["whole_vocab"]


DP_CASES = [n for n in CASES if n.startswith("dp-")
            and n.split("-")[1] in ("attn", "hybrid")]


@pytest.mark.parametrize("case", DP_CASES)
def test_replica_groups_serve_like_jax(ranks, case):
    """Replica groups on (2, 1) and (2, 2): JAX's tokens on every rank,
    and each rank's cache bytes those of the shard shapes JAX's
    ``spec_for_axes`` gives (contiguous: half of one group's; page pools:
    whole)."""
    arch, mesh, rules, kw = CASES[case]
    want = _jax_cache_bytes(arch, kw["cache_kind"], mesh, RULES[rules])
    for got in _jax_identical(ranks, case):
        assert got["bytes"] == want


@pytest.mark.parametrize("case", ["dp-moe-2x1-contiguous",
                                  "dp-monolithic-2x1",
                                  "default-monolithic-2x2",
                                  "dp-seeded-2x1", "default-seeded-2x2",
                                  "hybrid-default-2x2-paged"])
def test_replica_groups_moe_monolithic_and_seeded(ranks, case):
    """An MoE decode over replica groups (every slot's rows routed in one
    group), monolithic prefill (a group that does not own the slot runs
    the prefill's gathers alone), seeded sampling and a hybrid stack
    under DEFAULT on page pools: JAX's tokens on every rank."""
    _jax_identical(ranks, case)


@pytest.mark.parametrize("case", ["kv12-1x2-contiguous", "kv12-1x2-paged",
                                  "kv12-1x4-contiguous", "kv12-1x4-paged"])
def test_query_heads_spanning_kv_heads_serve_like_jax(ranks, case):
    """12 query heads over 3 whole kv heads: at TP=2 a rank's 6 heads
    span two kv heads' groups of 4, at TP=4 a rank's 3 heads one or two;
    the kernels' head layout pairs each with its own kv head."""
    _jax_identical(ranks, case)


@pytest.mark.parametrize("case", ["rwkv-zero_seq-1x2", "rwkv-zero_seq-2x2",
                                  "rwkv-head-cut-1x8"])
def test_rwkv6_gathered_leaves_serve_like_jax(ranks, case):
    """RWKV-6 under ZERO_SEQ (the token-shift rows' D cut over "model",
    gathered in their layer and written back as shards) and on 8 ranks,
    whose 64 columns would cut the 4 heads of 16: the time mix runs on
    gathered leaves, the channel mix's hidden stays split."""
    _jax_identical(ranks, case)


def test_launcher_serves_on_replica_groups(ranks):
    """``launch/serve.py --mesh-shape 2,1`` serves: every request
    finishes, and both ranks emit the same tokens."""
    res = _per_rank(ranks, 2, "launcher-2x1")
    assert not res[0]["errors"] and not res[1]["errors"]
    assert res[0]["tokens"] == res[1]["tokens"]
    assert all(len(t) == 4 for t in res[0]["tokens"].values())
