"""PyTorch port, tensor-parallel serving (the port of
``tests/test_mesh_serving.py``): ``ServingEngine(mesh=make_serving_mesh(
tp))`` over ``torch.distributed``, one process a rank.

The ranks of each world size (1, 2, 4) are ``torch.multiprocessing``
spawns of one gloo group over a ``FileStore``, started once for the module
(:func:`ranks`); each runs the whole matrix of its world size on the CPU
(the kernels' plain versions under ``impl="pallas"``) and writes its
results.  While they run, the module computes the JAX package's unsharded
engine on the same weights (``random_jax_params``: every leaf, biases and
norm scales too, drawn from numpy) and each test compares one case: every
rank's tokens equal the JAX engine's and rank 0's.  Beyond JAX's matrix:
query heads sharded over replicated kv heads (8 / 2 heads at TP=4),
monolithic prefill at TP=2 and a gloo mesh refusing graph capture (the
other rule sets, replica groups, heads that span kv heads and the RWKV-6
head cut: ``tests/test_torch_mesh_rules.py``).  Every join has a
deadline, so a hung rank fails the module instead of eating the clock.

The attn config is shrink(qwen2-7b) at 8 heads / 4 kv heads of 8 so that
TP=4 shards the kv dim; the hybrid config (recurrentgemma-2b) keeps its 1
kv head, so the replicate fallback runs live (kv replicated, heads, FFN
and LRU hidden sharded; at TP=4 its 4 heads shard one a rank).  The moe
config, shrink(grok-1-314b), splits its 4 experts 2 and 1 a rank
(expert parallelism) and at TP=4 its 4 heads over 2 whole kv heads; the
rwkv config, shrink(rwkv6-1.6b), its 4 heads of 16 and the channel mix's
hidden, with the output norm's statistics summed over the ranks.
"""
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
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.parallel import sharding as shd
from repro_torch.serve.engine import Request, ServingEngine

torch.set_num_threads(1)

ARCHS = {
    "attn": ("qwen2-7b", dict(num_heads=8, num_kv_heads=4, head_dim=8)),
    "hybrid": ("recurrentgemma-2b", {}),
    # beyond JAX's matrix: TP=4 shards the 8 query heads, but 2 kv heads
    # do not divide 4 and stay whole (each rank's 2 heads read one of them)
    "attn_kv2": ("qwen2-7b", dict(num_heads=8, num_kv_heads=2, head_dim=8)),
    "moe": ("grok-1-314b", {}),
    "rwkv": ("rwkv6-1.6b", {}),
}
# the configs whose TP=1 engine is held bit for bit to mesh=None
TP1_ARCHS = ("attn", "moe", "rwkv")
ENGINE = dict(n_slots=2, max_seq=32, chunk=8, page_size=8)
JOIN_S = 300

# (case name, arch, engine kwargs) run by every rank of a world size > 1;
# "sampled" cases draw seeded top-k tokens
MATRIX = [(f"{arch}-{ck}-{impl}", arch,
           dict(impl=impl, cache_kind=ck))
          for arch in ("attn", "hybrid", "moe", "rwkv")
          for ck in ("contiguous", "paged")
          for impl in ("xla", "pallas")]
MATRIX += [("seeded", "attn", dict(impl="xla", cache_kind="paged",
                                   sampled=True))]
EXTRA = {
    2: [("prefix-spec", "attn", dict(impl="xla", cache_kind="paged",
                                     prefix_cache=True, speculative=True,
                                     draft_k=3)),
        ("monolithic-contiguous", "attn",
         dict(impl="pallas", cache_kind="contiguous",
              prefill_mode="monolithic")),
        ("monolithic-paged", "attn",
         dict(impl="pallas", cache_kind="paged",
              prefill_mode="monolithic"))],
    4: [("kv2-contiguous", "attn_kv2",
         dict(impl="pallas", cache_kind="contiguous")),
        ("kv2-paged", "attn_kv2", dict(impl="pallas", cache_kind="paged"))],
}


def _cfg(arch):
    name, over = ARCHS[arch]
    return shrink(get_config(name), **over)


def _prompts(cfg, sampled=False):
    rng = np.random.default_rng(0)
    out = []
    for i in range(3):
        kw = dict(temperature=0.8, top_k=8, seed=123 + i) if sampled else {}
        out.append((i, [int(t) for t in
                         rng.integers(0, cfg.vocab_size, 5 + 3 * i)], kw))
    return out


def _serve(arch, weights, mesh, kw):
    """Serve the case's three requests.  Returns (tokens by rid,
    engine)."""
    kw = dict(kw)
    impl, sampled = kw.pop("impl"), kw.pop("sampled", False)
    cfg = _cfg(arch)
    with warnings.catch_warnings():
        # the replicate fallback warns; here it is intended
        warnings.simplefilter("ignore", RuntimeWarning)
        eng = ServingEngine(convert.tree_from_jax(weights[arch], "cpu"), cfg,
                            FamousConfig(impl=impl), mesh=mesh,
                            device="cpu", **ENGINE, **kw)
    done = eng.run([Request(rid=i, tokens=t, max_new=5, **skw)
                    for i, t, skw in _prompts(cfg, sampled)])
    assert all(r.error is None for r in done), [r.error for r in done]
    return {r.rid: tuple(r.out) for r in done}, eng


def _keys(eng):
    return {k: list(e.keys) for k, e in eng._exec.items()}


def _case(fn):
    """A case's result, or the traceback it raised."""
    try:
        return fn()
    except Exception:
        return {"error": traceback.format_exc()}


def _tp1(arch, ck, weights, mesh):
    """``arch`` served on a mesh of one rank and without a mesh."""
    kw = dict(impl="xla", cache_kind=ck)
    base, beng = _serve(arch, weights, None, kw)
    toks, eng = _serve(arch, weights, mesh, kw)
    return dict(
        tokens=toks, base_tokens=base,
        caches=[{n: b.numpy() for n, b in c.items()} for c in eng.caches],
        base_caches=[{n: b.numpy() for n, b in c.items()}
                     for c in beng.caches],
        census=eng.compilations, base_census=beng.compilations,
        keys=_keys(eng), base_keys=_keys(beng),
        bytes=eng.cache_bytes_per_device(),
        base_bytes=beng.cache_bytes_per_device())


def _rank_cases(world, weights):
    from repro_torch.analysis.retrace_guard import retrace_guard
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serve import graphs

    mesh = make_serving_mesh(tp=world, device_type="cpu")
    out = {}
    if world == 1:
        for arch in TP1_ARCHS:
            for ck in ("contiguous", "paged"):
                out[f"tp1-{arch}-{ck}"] = _case(
                    lambda arch=arch, ck=ck: _tp1(arch, ck, weights, mesh))
        return out
    for name, arch, kw in MATRIX + EXTRA.get(world, []):
        def run(arch=arch, kw=kw):
            toks, eng = _serve(arch, weights, mesh, kw)
            res = dict(tokens=toks, keys=_keys(eng),
                       bytes=eng.cache_bytes_per_device())
            if eng.paged:
                eng.alloc.assert_invariants()
            res["speculative_active"] = eng.speculative_active
            return res
        out[name] = _case(run)
    if world == 2:
        def guard():
            _, eng = _serve("attn", weights, mesh,
                            dict(impl="xla", cache_kind="paged"))
            before = _keys(eng)
            cfg = _cfg("attn")
            rng = np.random.default_rng(7)
            fresh = [Request(rid=100 + i, max_new=4,
                             tokens=[int(t) for t in rng.integers(
                                 0, cfg.vocab_size, 4 + i)])
                     for i in range(3)]
            with retrace_guard(eng, label="warm TP engine"):
                eng.run(fresh)
            return dict(before=before, after=_keys(eng))
        out["retrace-guard"] = _case(guard)

        def capture():
            enabled = graphs.capture_enabled
            graphs.capture_enabled = lambda device: True
            try:
                _serve("attn", weights, mesh,
                       dict(impl="xla", cache_kind="contiguous"))
            except RuntimeError as e:
                return dict(raised=str(e))
            finally:
                graphs.capture_enabled = enabled
            return dict(raised=None)
        out["capture-gloo"] = _case(capture)

        def rank_leaves():
            # the engine given this rank's shards alone (each leaf cut
            # before the engine sees it) serves as when given whole leaves
            from repro_torch.models import module, transformer
            cfg = _cfg("moe")
            tree = convert.tree_from_jax(weights["moe"], "cpu")
            specs = shd.tree_specs(mesh, transformer.param_axes(cfg),
                                   shd.SERVE_TP_RULES,
                                   module.param_shapes(transformer.model_spec(
                                       cfg)))
            cut = module.tree_map2(lambda t, sp: shd.local_shard(
                t, sp, mesh).clone(), tree, specs)
            eng = ServingEngine(cut, cfg, FamousConfig(impl="xla"),
                                mesh=mesh, device="cpu", **ENGINE)
            done = eng.run([Request(rid=i, tokens=t, max_new=5)
                            for i, t, _ in _prompts(cfg)])
            return dict(tokens={r.rid: tuple(r.out) for r in done},
                        w_in=tuple(eng.params["layers"][0]["ffn"]["w_in"]
                                   .shape))
        out["rank-leaves"] = _case(rank_leaves)
    return out


def _rank_main(rank, world, tmp):
    """One rank: join the gloo group, run the world size's cases, write
    them to ``tmp/rank{rank}.pkl``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world)
    try:
        with open(os.path.join(tmp, "weights.pkl"), "rb") as f:
            weights = pickle.load(f)
        out = _rank_cases(world, weights)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _jax_tokens(jweights, arch, kw):
    from repro.configs.base import get_config as jget_config
    from repro.configs.base import shrink as jshrink
    from repro.core.famous import FamousConfig as JFamousConfig
    from repro.serve.engine import Request as JRequest
    from repro.serve.engine import ServingEngine as JServingEngine

    kw = dict(kw)
    impl, sampled = kw.pop("impl"), kw.pop("sampled", False)
    name, over = ARCHS[arch]
    jcfg = jshrink(jget_config(name), **over)
    eng = JServingEngine(jweights[arch], jcfg, JFamousConfig(impl=impl),
                         **ENGINE, **kw)
    done = eng.run([JRequest(rid=i, tokens=t, max_new=5, **skw)
                    for i, t, skw in _prompts(_cfg(arch), sampled)])
    assert all(r.error is None for r in done), [r.error for r in done]
    return {r.rid: tuple(r.out) for r in done}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the ranks of every world size at once, compute the JAX
    baselines meanwhile, then join them under a deadline.  Returns
    (results by world size: a list by rank of {case: result}, JAX tokens
    by case name, the unsharded port engine's cache bytes by kind)."""
    import jax.numpy as jnp
    import torch.multiprocessing as mp
    from repro.configs.base import get_config as jget_config
    from repro.configs.base import shrink as jshrink
    from torch_port_helpers import random_jax_params

    jweights = {a: random_jax_params(jshrink(jget_config(n), **o), seed=3,
                                     dtype=jnp.float32)
                for a, (n, o) in ARCHS.items()}
    weights = {a: _to_numpy(w) for a, w in jweights.items()}
    procs, dirs = {}, {}
    for world in (1, 2, 4):
        tmp = str(tmp_path_factory.mktemp(f"tp{world}"))
        with open(os.path.join(tmp, "weights.pkl"), "wb") as f:
            pickle.dump(weights, f)
        dirs[world] = tmp
        procs[world] = mp.start_processes(_rank_main, args=(world, tmp),
                                          nprocs=world, join=False,
                                          start_method="spawn")
    cases = {n: (a, kw) for n, a, kw in MATRIX}
    for extra in EXTRA.values():
        cases.update({n: (a, kw) for n, a, kw in extra})
    jax_tokens = {n: _jax_tokens(jweights, a, kw)
                  for n, (a, kw) in cases.items()}
    base_bytes = {ck: _serve("attn", weights, None,
                             dict(impl="xla", cache_kind=ck))[1]
                  .cache_bytes_per_device()
                  for ck in ("contiguous", "paged")}
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
    return results, jax_tokens, base_bytes


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


def _same_tokens_everywhere(ranks, world, case):
    res = _per_rank(ranks, world, case)
    want = ranks[1][case]
    for r, got in enumerate(res):
        assert got["tokens"] == want, (world, r, case)
    return res


def _tp1_bit_identical(ranks, arch, cache_kind):
    (got,) = _per_rank(ranks, 1, f"tp1-{arch}-{cache_kind}")
    assert got["tokens"] == got["base_tokens"]
    for a, b in zip(got["caches"], got["base_caches"]):
        assert a.keys() == b.keys()
        for n in a:
            np.testing.assert_array_equal(a[n], b[n])
    assert got["census"] == got["base_census"]
    assert got["keys"] == got["base_keys"]
    assert got["bytes"] == got["base_bytes"]


@pytest.mark.parametrize("cache_kind", ["contiguous", "paged"])
def test_tp1_mesh_bit_identical(ranks, cache_kind):
    """A mesh of one rank changes nothing: same tokens, bitwise-equal final
    caches, the same executables and census, the same cache bytes."""
    _tp1_bit_identical(ranks, "attn", cache_kind)


@pytest.mark.parametrize("cache_kind", ["contiguous", "paged"])
@pytest.mark.parametrize("arch", ["moe", "rwkv"])
def test_tp1_mesh_bit_identical_moe_and_rwkv6(ranks, arch, cache_kind):
    """The same for expert parallelism and RWKV-6 heads: over a "model"
    axis of one rank no expert, head or hidden is cut and no collective
    added."""
    _tp1_bit_identical(ranks, arch, cache_kind)


@pytest.mark.parametrize("arch", ["attn", "hybrid", "moe", "rwkv"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("cache_kind", ["contiguous", "paged"])
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_parity_matrix(ranks, tp, cache_kind, impl, arch):
    """Token-identical to the JAX unsharded engine on every rank, and one
    executable of each kind, as without a mesh."""
    for got in _same_tokens_everywhere(ranks, tp,
                                       f"{arch}-{cache_kind}-{impl}"):
        assert got["keys"]["prefill"] == ["prefill"]
        assert got["keys"]["decode"] == ["decode"]


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_parity_seeded_sampling(ranks, tp):
    _same_tokens_everywhere(ranks, tp, "seeded")


def test_tp_prefix_cache_and_speculative(ranks):
    """The host-side allocator, prefix index and drafter run on every rank
    alike: token-identical, allocator invariants held after the drain
    (checked on each rank)."""
    for got in _same_tokens_everywhere(ranks, 2, "prefix-spec"):
        assert got["speculative_active"]


def test_tp_retrace_guard(ranks):
    """A warm TP engine serves a fresh batch inside ``retrace_guard`` and
    runs no executable under a new key."""
    for got in _per_rank(ranks, 2, "retrace-guard"):
        assert got["after"] == got["before"]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("cache_kind", ["contiguous", "paged"])
def test_cache_bytes_per_device_shrink(ranks, tp, cache_kind):
    """The attn config's caches are all kv-head-sharded leaves: each rank
    holds exactly 1/TP of the unsharded bytes."""
    want = ranks[2][cache_kind]
    for got in _per_rank(ranks, tp, f"attn-{cache_kind}-xla"):
        assert got["bytes"] * tp == want


@pytest.mark.parametrize("arch", ["moe", "rwkv"])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("cache_kind", ["contiguous", "paged"])
def test_cache_bytes_per_device_moe_and_rwkv6(ranks, cache_kind, tp, arch):
    """grok-1's attention caches shrink with the kv heads (2 of them: at
    TP=4 they stay whole, as JAX's replicate fallback places them);
    RWKV-6's wkv state shrinks with the heads while the token-shift rows
    stay whole on every rank."""
    cfg = _cfg(arch)
    want = _per_rank(ranks, 1, f"tp1-{arch}-{cache_kind}")[0]["base_bytes"]
    if arch == "moe":
        kv_ways = tp if cfg.num_kv_heads % tp == 0 else 1
        expect = want // kv_ways
    else:
        h, dh = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        state = cfg.num_layers * ENGINE["n_slots"] * h * dh * dh * 4
        expect = want - state + state // tp
    for got in _per_rank(ranks, tp, f"{arch}-{cache_kind}-xla"):
        assert got["bytes"] == expect


@pytest.mark.parametrize("cache_kind", ["contiguous", "paged"])
def test_tp4_heads_sharded_kv_replicated(ranks, cache_kind):
    """8 query heads over 2 kv heads at TP=4: each rank's 2 heads read one
    kv head of a replicated cache (as JAX places it: every rank holds all
    the kv bytes)."""
    res = _same_tokens_everywhere(ranks, 4, f"kv2-{cache_kind}")
    assert len({got["bytes"] for got in res}) == 1


@pytest.mark.parametrize("cache_kind", ["contiguous", "paged"])
def test_tp2_monolithic_prefill(ranks, cache_kind):
    for got in _same_tokens_everywhere(ranks, 2, f"monolithic-{cache_kind}"):
        # prompts of 5, 8 and 11 tokens prefill 4, 7 and 10 of them
        assert got["keys"]["prefill"] == [4, 8, 16]


def test_engine_takes_the_rank_shards(ranks):
    """Each rank may hand the engine its shards alone (a rank that drew
    its weights leaf by leaf): shrink(grok-1-314b) then serves JAX's
    tokens with 2 of 4 experts a rank."""
    for got in _per_rank(ranks, 2, "rank-leaves"):
        assert got["tokens"] == ranks[1]["moe-contiguous-xla"]
        assert got["w_in"][0] == 2


def test_gloo_sum_refuses_capture(ranks):
    """A gloo group's sum stages through the host, so a TP engine over it
    raises at its first call with capture enabled, on every rank."""
    for got in _per_rank(ranks, 2, "capture-gloo"):
        assert got["raised"] and "cannot be captured" in got["raised"]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ["grok-1-314b", "rwkv6-1.6b"])
def test_moe_and_rwkv6_meshes_pass_the_check(arch, tp):
    """MoE experts and RWKV-6 heads over "model" pass the mesh check at
    the shrunk and the full configs' widths."""
    from repro_torch.models import transformer
    for cfg in (shrink(get_config(arch)), get_config(arch)):
        transformer.check_mesh(cfg, abstract_mesh((1, tp), ("data", "model")),
                               shd.SERVE_TP_RULES)
