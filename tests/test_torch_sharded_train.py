"""PyTorch port, training at scale: the sharded train step
(``make_train_step(mesh=)``) over ``torch.distributed``, one process a rank,
against the JAX package's unsharded ``make_train_step``.

GSPMD only moves data, so the sharded step's math is the unsharded step's:
after each step every rank's gathered parameters and moments, its loss and
its gradient norm must be JAX's on the same numpy weights and batches
(``random_jax_params``; ``TOL`` as in ``test_torch_train.py``).

The ranks of each world size (1, 2, 4) are ``torch.multiprocessing``
spawns of one gloo group over a ``FileStore``, started once for the module
(:func:`ranks`); each runs its whole matrix on the CPU (the kernels' plain
versions under ``impl="pallas"``) and writes its results: rank 0 the
gathered state, every rank a digest of it, so the test holds every rank to
rank 0's bits and rank 0 to JAX.  While they run, the parent runs JAX.
Every join has a deadline.

The matrix: shrink(famous-bert) and shrink(qwen2-7b) at 8 / 4 heads of 8
on meshes (data 2, model 1), (1, 2), (pod 2, 1, 1) and (2, 2) under the
default, tensor-parallel-only and ZeRO-3 + sequence rule sets;
shrink(grok-1-314b), shrink(rwkv6-1.6b) and shrink(recurrentgemma-2b)
(grok-1 at 32 rows of 16 tokens, so each rank routes whole 256-token MoE
groups) on (2, 1) (data parallelism with FSDP) and on (1, 2) and (2, 2)
under the default and tensor-parallel-only rule sets (expert parallelism,
RWKV-6 heads, the RG-LRU's channels and recurrentgemma-2b's query heads
over its one whole kv head); a mesh of one rank bit for bit against
``mesh=None``; ``ValueError`` for a batch that does not split;
``make_global_batch`` row by row; an elastic resize (save on (2, 1) at
step 2, restore on (1, 2) and on (pod 2) and go on to JAX's step 4); a
fault on one rank of a 2-rank ``Trainer`` that every rank restores from;
and on 2 ranks, the MoE layer's expert shares against the whole layer and
the gradients of ``MeshComm``'s statistics sum and gate reduce-scatter
against the same functions computed on one process.
"""
import hashlib
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
from repro_torch.configs.base import ShapeConfig, get_config, shrink
from repro_torch.core.famous import FamousConfig
from repro_torch.models.module import tree_leaves, tree_map, tree_map2
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as shd
from repro_torch.train import step as step_lib

torch.set_num_threads(1)

HEADS = dict(num_heads=8, num_kv_heads=4, head_dim=8)
ARCHS = {"bert": ("famous-bert", HEADS), "qwen": ("qwen2-7b", HEADS),
         "grok": ("grok-1-314b", {}), "rwkv": ("rwkv6-1.6b", {}),
         "rg": ("recurrentgemma-2b", {}), "qwen3": ("qwen3-32b", HEADS)}
SHAPE = ShapeConfig("sharded", 16, 4, "train")
SHAPES = {"grok": ShapeConfig("sharded_moe", 16, 32, "train")}
MESHES = {"2x1": (2, 1), "1x2": (1, 2), "pod2": (2, 1, 1), "2x2": (2, 2)}
RULES = {"default": shd.DEFAULT_RULES, "tp_only": shd.TP_ONLY_RULES,
         "zero_seq": shd.ZERO_SEQ_RULES}
WORLD_MESHES = {2: ("2x1", "1x2", "pod2"), 4: ("2x2",)}
DP_ONLY = ("grok", "rwkv", "rg")
# the families a "model" axis splits with collectives of their own, on
# the meshes and rule sets they train on with model > 1
MODEL_AXIS = ("grok", "rwkv", "rg")
MODEL_MESHES = {2: ("1x2",), 4: ("2x2",)}
MODEL_RULES = ("default", "tp_only")
STEPS, LONG = 2, 4
TOL = 1e-4
LR = 1e-3
JOIN_S = 300


def _cfg(arch):
    name, over = ARCHS[arch]
    return shrink(get_config(name), **over)


def _shape(arch):
    return SHAPES.get(arch, SHAPE)


def _tcfg(**kw):
    return step_lib.TrainConfig(
        compute_dtype=torch.float32, loss_chunk=16,
        optimizer=adamw.AdamWConfig(lr=LR), schedule_warmup=2,
        schedule_total=100, **kw)


def _whole_state(weights):
    """The JAX train state layout around numpy weights: zero moments."""
    zeros = tree_map(np.zeros_like, weights)
    return {"params": weights,
            "opt": {"m": zeros, "v": zeros, "count": np.int32(0)},
            "step": np.int32(0)}


def _gathered(state, specs, comm):
    """Every leaf of a rank's state gathered whole, as numpy."""
    return tree_map2(lambda t, s: comm.gather(t.detach(), s).numpy()
                     if isinstance(t, torch.Tensor) else np.asarray(t),
                     state, specs)


def _digest(tree):
    h = hashlib.sha256()
    for a in tree_leaves(tree):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _result(metrics, state, ts, lead, **extra):
    whole = _gathered(state, ts.state_specs, ts.layout.comm)
    return dict(metrics=metrics, digest=_digest(whole),
                state=whole if lead else None, **extra)


def _train(arch, weights, mesh, rules, steps, state=None, start=0):
    """``steps`` sharded steps from ``state`` (default: the whole numpy
    weights cut to the rank's shards) at step ``start``.  Returns
    (metrics, state, train step)."""
    from repro_torch.data import pipeline
    cfg = _cfg(arch)
    if state is None:
        state = step_lib.shard_state(convert.train_state_from_jax(
            _whole_state(weights[arch]), "cpu"), cfg, mesh, rules)
    ts = step_lib.make_train_step(cfg, FamousConfig(impl="pallas"), _tcfg(),
                                  mesh, rules)
    metrics = []
    for i in range(start, start + steps):
        batch = pipeline.make_global_batch(cfg, _shape(arch), 0, i, mesh,
                                           rules, "cpu")
        state, m = ts(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state, ts


def _case(fn):
    """A case's result, or the traceback it raised."""
    try:
        return fn()
    except Exception:
        return {"error": traceback.format_exc()}


def _raises(fn):
    try:
        fn()
    except (NotImplementedError, ValueError) as e:
        return dict(raised=type(e).__name__, message=str(e))
    return dict(raised=None)


def _one_rank_cases(weights):
    """A mesh of one rank against ``mesh=None``, through the launcher's
    ``build``: states and metrics bit for bit."""
    from repro_torch.launch import train as train_launch
    from repro_torch.launch.mesh import make_training_mesh
    mesh = make_training_mesh((1, 1), "cpu")
    out = {}
    for arch in ("bert", "qwen"):
        def run(arch=arch):
            res = {}
            for name, m in (("none", None), ("mesh", mesh)):
                _, state, ts, batch_fn = train_launch.build(
                    None, SHAPE, smoke=False, tcfg=_tcfg(), seed=5,
                    device="cpu", cfg=_cfg(arch), mesh=m)
                ms = []
                for i in range(STEPS):
                    state, met = ts(state, batch_fn(i))
                    ms.append({k: float(v) for k, v in met.items()})
                res[name] = dict(metrics=ms, state=tree_map(
                    lambda t: t.detach().numpy() if isinstance(
                        t, torch.Tensor) else t, state))
            return res
        out[f"one-rank-{arch}"] = _case(run)
    return out


def _pipeline_case(mesh):
    """This rank's rows, and the rows ``host_batch`` was asked for."""
    from repro_torch.data import pipeline
    asked = []
    real = pipeline.host_batch

    def spy(cfg, shape, seed, step, lo=0, hi=None):
        asked.append((lo, hi))
        return real(cfg, shape, seed, step, lo, hi)

    pipeline.host_batch = spy
    try:
        batch = pipeline.make_global_batch(_cfg("qwen"), SHAPE, 7, 3, mesh,
                                           None, "cpu")
    finally:
        pipeline.host_batch = real
    return dict(asked=asked, rows=pipeline.batch_rows(SHAPE, mesh),
                batch={k: v.numpy() for k, v in batch.items()})


def _elastic_case(weights, meshes, tmp, lead):
    """Save on (2, 1) at step 2; restore on (1, 2) and on (pod 2) and go
    on to step 4."""
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train import elastic
    cfg = _cfg("qwen")
    ckpt = os.path.join(tmp, "elastic")
    _, state, ts = _train("qwen", weights, meshes["2x1"], None, STEPS)
    ckpt_lib.save_checkpoint(ckpt, STEPS, state, specs=ts.state_specs,
                             mesh=meshes["2x1"])
    out = {}
    for name in ("1x2", "pod2"):
        like = step_lib.init_state(cfg, _tcfg(), torch.Generator(), "cpu",
                                   meshes[name])
        restored, step = elastic.reshard_restore(
            ckpt, like, meshes[name], step_lib.state_logical_axes(cfg))
        metrics, state2, ts2 = _train("qwen", weights, meshes[name], None,
                                      LONG - STEPS, restored, step)
        out[name] = _result(metrics, state2, ts2, lead, step=step)
    return out


def _trainer_case(weights, mesh, tmp, rank, lead):
    """A 4-step ``Trainer`` on (2, 1), checkpoints every 2 steps, with a
    fault injected on rank 0 alone at step 3 (once), and without."""
    from repro_torch.data import pipeline
    from repro_torch.train import trainer as trainer_lib
    cfg = _cfg("qwen")
    out = {}
    for name in ("clean", "fault"):
        hit = []

        def fault(step):
            if name == "fault" and rank == 0 and step == 3 and not hit:
                hit.append(step)
                raise trainer_lib.InjectedFault("rank 0 lost at step 3")

        state = step_lib.shard_state(convert.train_state_from_jax(
            _whole_state(weights["qwen"]), "cpu"), cfg, mesh)
        ts = step_lib.make_train_step(cfg, FamousConfig(impl="pallas"),
                                      _tcfg(), mesh)
        tr = trainer_lib.Trainer(
            ts, state,
            lambda i: pipeline.make_global_batch(cfg, SHAPE, 0, i, mesh,
                                                 None, "cpu"),
            trainer_lib.TrainerConfig(total_steps=LONG, ckpt_every=2,
                                      ckpt_dir=os.path.join(tmp, name)),
            fault_hook=fault, mesh=mesh, state_specs=ts.state_specs)
        tr.run()
        # a replayed step's metrics replace the first try's
        by_step = {m["step"]: {k: m[k] for k in ("loss", "grad_norm")}
                   for m in tr.metrics_log}
        out[name] = _result([by_step[i] for i in sorted(by_step)], tr.state,
                            ts, lead,
                            restarts=tr.restarts,
                            failed_steps=[f["step"] for f in tr.failures])
    return out


def _moe_input():
    return torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 128, _cfg("grok").d_model)).astype(np.float32))


def _moe_shares(weights, mesh):
    """This rank's share of layer 0's MoE output on ``mesh`` (1, 2):
    ``transformer.shard_params``' experts and range, without the sum."""
    from repro_torch.models import moe, transformer
    cfg = _cfg("grok")
    p = transformer.shard_params(convert.tree_from_jax(weights["grok"], "cpu"),
                                 cfg, mesh)["layers"][0]["ffn"]
    share = moe.apply_moe({k: v for k, v in p.items() if k != "tp_sum"},
                          _moe_input(), cfg)
    return dict(share=share.numpy(), experts=p["tp_experts"],
                w_in=p["w_in"].shape[0])


# the ranges of the last dim each of 2 ranks keeps in the reduce-scatter
SCATTER_RANGES = {0: ((0, 2), (4, 6)), 1: ((2, 4), (6, 8))}


def _comm_inputs(rank):
    """Rank ``rank``'s partial products and the weights of its loss."""
    rng = np.random.default_rng(100 + rank)
    x, w = (torch.from_numpy(rng.standard_normal((3, 8)).astype(np.float32))
            for _ in range(2))
    return x, w


COMM_FNS = ("sum_over_model", "scatter_to_model")


def _comm_losses(fn, xs, ws, ranks, reduce, scatter):
    """Each rank's loss through ``fn`` (the statistics sum ``reduce`` or
    the gate reduce-scatter ``scatter``) of its partial product, and the
    function's outputs."""
    out = []
    for r, x, w in zip(ranks, xs, ws):
        if fn == "sum_over_model":
            y = reduce(x)
            out.append(((y * w).sum(), (y,)))
        else:
            parts = scatter(x, SCATTER_RANGES[r])
            out.append((sum((q * w[:, lo:hi]).sum() for q, (lo, hi)
                            in zip(parts, SCATTER_RANGES[r])), parts))
    return out


def _comm_grads(mesh, rank):
    """``MeshComm.sum_over_model`` and ``scatter_to_model`` on this rank's
    inputs: each one's outputs and the gradient of its loss."""
    comm = shd.MeshComm(mesh)
    res = {}
    for fn in COMM_FNS:
        x, w = _comm_inputs(rank)
        x.requires_grad_(True)
        ((loss, outs),) = _comm_losses(fn, [x], [w], [rank],
                                       comm.sum_over_model,
                                       comm.scatter_to_model)
        loss.backward()
        res[fn] = dict(outs=[q.detach().numpy() for q in outs],
                       grad=x.grad.numpy())
    return res


def _rank_cases(world, rank, weights, tmp):
    from repro_torch.launch.mesh import make_training_mesh
    if world == 1:
        return _one_rank_cases(weights)
    meshes = {n: make_training_mesh(MESHES[n], "cpu")
              for n in WORLD_MESHES[world]}
    lead = rank == 0
    out = {}
    for mname, mesh in meshes.items():
        for arch in ("bert", "qwen"):
            for rname, rules in RULES.items():
                def run(arch=arch, mesh=mesh, rules=rules):
                    metrics, state, ts = _train(arch, weights, mesh, rules,
                                                STEPS)
                    return _result(metrics, state, ts, lead)
                out[f"{arch}-{mname}-{rname}"] = _case(run)
    for mname in MODEL_MESHES[world]:
        for arch in MODEL_AXIS:
            for rname in MODEL_RULES:
                def tp(arch=arch, mesh=meshes[mname], rules=RULES[rname]):
                    metrics, state, ts = _train(arch, weights, mesh, rules,
                                                STEPS)
                    return _result(metrics, state, ts, lead)
                out[f"{arch}-{mname}-{rname}"] = _case(tp)
    if world == 4:
        return out
    for arch in DP_ONLY:
        def dp(arch=arch):
            metrics, state, ts = _train(arch, weights, meshes["2x1"], None,
                                        STEPS)
            return _result(metrics, state, ts, lead)
        out[f"{arch}-2x1-default"] = _case(dp)

    def qk_norm():
        metrics, state, ts = _train("qwen3", weights, meshes["1x2"], None,
                                    STEPS)
        return _result(metrics, state, ts, lead)
    out["qwen3-1x2-default"] = _case(qk_norm)
    out["moe-shares"] = _case(lambda: _moe_shares(weights, meshes["1x2"]))
    out["comm-grads"] = _case(lambda: _comm_grads(meshes["1x2"], rank))

    def microbatches():
        from repro_torch.data import pipeline
        mesh = meshes["2x1"]
        cfg = _cfg("qwen")
        state = step_lib.init_state(cfg, _tcfg(), torch.Generator(), "cpu",
                                    mesh)
        ts = step_lib.make_train_step(cfg, FamousConfig(impl="pallas"),
                                      _tcfg(microbatches=4), mesh)
        batch = pipeline.make_global_batch(cfg, SHAPE, 0, 0, mesh, None,
                                           "cpu")
        return dict(step=_raises(lambda: ts(state, batch)),
                    pipeline=_raises(lambda: pipeline.make_global_batch(
                        cfg, ShapeConfig("odd", 16, 3, "train"), 0, 0, mesh,
                        None, "cpu")))
    out["refuse-batch"] = _case(microbatches)
    for mname in ("2x1", "pod2", "1x2"):
        out[f"pipeline-{mname}"] = _case(
            lambda mname=mname: _pipeline_case(meshes[mname]))
    out["elastic"] = _case(lambda: _elastic_case(weights, meshes, tmp, lead))
    out["trainer"] = _case(lambda: _trainer_case(weights, meshes["2x1"], tmp,
                                                 rank, lead))
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
        with warnings.catch_warnings():
            # the replicate fallback warns; here it is intended
            warnings.simplefilter("ignore", RuntimeWarning)
            out = _rank_cases(world, rank, weights, tmp)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _jax_run(arch, weights):
    """JAX's unsharded ``make_train_step`` (impl "xla") on ``arch`` from
    the numpy weights, for 4 steps (qwen, which the resize and the trainer
    continue) or 2: metrics of every step and the state after each.  Run
    in a worker process of its own, one an arch."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_config as jget_config
    from repro.configs.base import shrink as jshrink
    from repro.core.famous import FamousConfig as JFamousConfig
    from repro.data import pipeline as jpipeline
    from repro.optim import adamw as jadamw
    from repro.train import step as jstep

    name, over = ARCHS[arch]
    jcfg, shape = jshrink(jget_config(name), **over), _shape(arch)
    steps = LONG if arch == "qwen" else STEPS
    # remat recomputes the same values, so JAX compiles without it (a
    # quarter less time); the port keeps it on, so its recompute gathers
    # again
    tcfg = jstep.TrainConfig(compute_dtype=jnp.float32, loss_chunk=16,
                             optimizer=jadamw.AdamWConfig(lr=LR),
                             schedule_warmup=2, schedule_total=100,
                             remat=False)
    state = jax.tree_util.tree_map(jnp.asarray, _whole_state(weights))
    ts = jax.jit(jstep.make_train_step(jcfg, JFamousConfig(impl="xla"),
                                       tcfg))
    metrics, states = [], {}
    for i in range(steps):
        batch = {k: jnp.asarray(v) for k, v in
                 jpipeline.host_batch(jcfg, shape, 0, i).items()}
        state, m = ts(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        states[i + 1] = jax.tree_util.tree_map(np.asarray, state)
    return dict(metrics=metrics, states=states)


def _jax_global_batch():
    """JAX's ``make_global_batch`` on its 1-device mesh, as numpy."""
    from repro.configs.base import get_config as jget_config
    from repro.configs.base import shrink as jshrink
    from repro.data import pipeline as jpipeline
    from repro.launch.mesh import make_mesh
    from repro.parallel import sharding as jshd
    jcfg = jshrink(jget_config(ARCHS["qwen"][0]), **ARCHS["qwen"][1])
    mesh = make_mesh((1, 1), ("data", "model"))
    b = jpipeline.make_global_batch(
        jcfg, SHAPE, 7, 3, jshd.batch_sharding(
            mesh, 2, None, (SHAPE.global_batch, SHAPE.seq_len)))
    return {k: np.asarray(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the ranks of every world size at once, run JAX meanwhile,
    then join them under a deadline.  Returns (results by world size: a
    list by rank of {case: result}, JAX runs by arch, JAX's global
    batch)."""
    import concurrent.futures
    import multiprocessing

    import jax.numpy as jnp
    import torch.multiprocessing as mp
    from repro.configs.base import get_config as jget_config
    from repro.configs.base import shrink as jshrink
    from torch_port_helpers import random_jax_params

    jcfgs = {a: jshrink(jget_config(n), **o) for a, (n, o) in ARCHS.items()}
    weights = {a: _to_numpy(random_jax_params(c, seed=11, dtype=jnp.float32))
               for a, c in jcfgs.items()}
    procs, dirs = {}, {}
    for world in (1, 2, 4):
        tmp = str(tmp_path_factory.mktemp(f"world{world}"))
        with open(os.path.join(tmp, "weights.pkl"), "wb") as f:
            pickle.dump(weights, f)
        dirs[world] = tmp
        procs[world] = mp.start_processes(_rank_main, args=(world, tmp),
                                          nprocs=world, join=False,
                                          start_method="spawn")
    with concurrent.futures.ProcessPoolExecutor(
            len(ARCHS), mp_context=multiprocessing.get_context("spawn")) as ex:
        futures = {a: ex.submit(_jax_run, a, weights[a]) for a in ARCHS}
        jax_batch = _jax_global_batch()
        jax_runs = {a: f.result(timeout=JOIN_S) for a, f in futures.items()}
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
    return results, jax_runs, jax_batch, weights


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


def _close_state(got, want, what):
    """Every parameter and moment leaf at TOL (atol relative to the
    leaf's largest entry, as ``test_torch_train.py`` holds gradients)."""
    for part in ("params", "m", "v"):
        a = got["params"] if part == "params" else got["opt"][part]
        b = want["params"] if part == "params" else want["opt"][part]
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            np.testing.assert_allclose(
                x, y, rtol=TOL, atol=TOL * max(np.abs(y).max(), 1e-30),
                err_msg=f"{what}: {part}")
    assert int(got["step"]) == int(want["step"])
    assert int(got["opt"]["count"]) == int(want["opt"]["count"])


def _close_metrics(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        for name in g:
            np.testing.assert_allclose(g[name], w[name], rtol=TOL,
                                       err_msg=f"{what}: {name} @ {i}")


def _held_to_jax(res, jax_run, steps, what, first=0):
    """Every rank: the metrics JAX gave for steps [first, first + len) and
    rank 0's bits; rank 0: JAX's state after ``steps``."""
    for r, got in enumerate(res):
        _close_metrics(got["metrics"], jax_run["metrics"][first:],
                       f"{what} rank {r}")
        assert got["digest"] == res[0]["digest"], f"{what}: rank {r}'s " \
            f"state differs from rank 0's"
    _close_state(res[0]["state"], jax_run["states"][steps], what)


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ["bert", "qwen"])
def test_sharded_step_matches_jax(ranks, arch, mesh, rules):
    """Two sharded steps on every mesh and rule set: on every rank the
    loss, grad norm and schedule of JAX's unsharded step, and the
    parameters and both moments, gathered, of JAX's state."""
    world = 4 if mesh == "2x2" else 2
    res = _per_rank(ranks, world, f"{arch}-{mesh}-{rules}")
    _held_to_jax(res, ranks[1][arch], STEPS, f"{arch} {mesh} {rules}")


@pytest.mark.parametrize("arch", DP_ONLY)
def test_data_parallel_trains_moe_and_recurrent_like_jax(ranks, arch):
    """Data parallelism with FSDP ("embed" and grok-1's "expert_ff" over
    "data") on the MoE and recurrent families, which a "model" axis
    cannot split yet."""
    res = _per_rank(ranks, 2, f"{arch}-2x1-default")
    _held_to_jax(res, ranks[1][arch], STEPS, f"{arch} 2x1")


@pytest.mark.parametrize("rules", MODEL_RULES)
@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("arch", MODEL_AXIS)
def test_model_axis_trains_moe_and_recurrent_like_jax(ranks, arch, mesh,
                                                       rules):
    """A "model" axis of 2 over grok-1's experts, RWKV-6's heads and
    channel-mix hidden, and the RG-LRU's channels and recurrentgemma-2b's
    query heads (over its one whole kv head), with data parallelism on
    (2, 2): JAX's unsharded step on every rank, all ranks' states equal."""
    world = 4 if mesh == "2x2" else 2
    res = _per_rank(ranks, world, f"{arch}-{mesh}-{rules}")
    _held_to_jax(res, ranks[1][arch], STEPS, f"{arch} {mesh} {rules}")


def test_qk_norm_trains_on_a_model_axis(ranks):
    """qwen3's per-head q and k norm scales stay whole while the heads
    split: each rank reads them for its own heads only, so they come
    through Megatron's f and their gradients are summed over "model"
    (without it the ranks' scales drift apart from the first step)."""
    res = _per_rank(ranks, 2, "qwen3-1x2-default")
    _held_to_jax(res, ranks[1]["qwen3"], STEPS, "qwen3 1x2")


def test_moe_expert_shares_sum_to_the_whole_layer(ranks):
    """Each of 2 ranks multiplies its 2 of the 4 experts (routing over
    all 4 with the whole layer's capacity); the shares summed equal the
    unsharded layer's output."""
    from repro_torch.models import moe
    res = _per_rank(ranks, 2, "moe-shares")
    assert [tuple(g["experts"]) for g in res] == [(0, 2), (2, 4)]
    assert all(g["w_in"] == 2 for g in res)
    cfg = _cfg("grok")
    p = {k: torch.tensor(v[0]) for k, v in
         ranks[3]["grok"]["blocks"]["pos0"]["ffn"].items()}
    whole = moe.apply_moe(p, _moe_input(), cfg).numpy()
    np.testing.assert_allclose(res[0]["share"] + res[1]["share"], whole,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fn", COMM_FNS)
def test_mesh_comm_gradients_match_one_process(ranks, fn):
    """The RWKV-6 norm statistics' all-reduce (its backward an all-reduce)
    and the RG-LRU gates' reduce-scatter (its backward the ranks' slices
    gathered), each on 2 ranks, against the same function of both ranks'
    inputs on one process under autograd: the outputs, and every rank's
    input gradient of the sum of the ranks' losses."""
    res = [got[fn] for got in _per_rank(ranks, 2, "comm-grads")]
    xs, ws = zip(*(_comm_inputs(r) for r in range(2)))
    xs = [x.requires_grad_(True) for x in xs]

    def scatter(x, ranges):
        full = xs[0] + xs[1]
        return tuple(full[:, lo:hi] for lo, hi in ranges)

    runs = _comm_losses(fn, xs, ws, range(2), lambda x: xs[0] + xs[1],
                        scatter)
    sum(loss for loss, _ in runs).backward()
    for r, (got, (_, outs)) in enumerate(zip(res, runs)):
        for a, b in zip(got["outs"], outs):
            np.testing.assert_allclose(a, b.detach().numpy(), rtol=1e-6)
        np.testing.assert_allclose(got["grad"], xs[r].grad.numpy(),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("where", ["step", "pipeline"])
def test_a_batch_that_does_not_split_raises(ranks, where):
    """4 rows over 2 batch ranks and 4 microbatches: the step raises
    before any collective; 3 rows over 2 batch ranks: the pipeline
    raises."""
    for got in _per_rank(ranks, 2, "refuse-batch"):
        assert got[where]["raised"] == "ValueError", got


@pytest.mark.parametrize("arch", ["bert", "qwen"])
def test_one_rank_mesh_is_bit_identical(ranks, arch):
    """A (1, 1) mesh through ``launch.train.build``: nothing is cut and
    no collective runs, so states and metrics equal ``mesh=None``'s bit
    for bit."""
    (got,) = _per_rank(ranks, 1, f"one-rank-{arch}")
    assert got["mesh"]["metrics"] == got["none"]["metrics"]
    for a, b in zip(tree_leaves(got["mesh"]["state"]),
                    tree_leaves(got["none"]["state"])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mesh", ["2x1", "pod2", "1x2"])
def test_make_global_batch_builds_only_the_rank_rows(ranks, mesh):
    """Each rank asked ``host_batch`` for its rows only; concatenated in
    rank order, the batch ranks' rows are ``host_batch``'s and JAX's
    ``make_global_batch``'s bit for bit (model ranks hold the same
    rows)."""
    from repro_torch.data import pipeline
    res = _per_rank(ranks, 2, f"pipeline-{mesh}")
    want = pipeline.host_batch(_cfg("qwen"), SHAPE, 7, 3)
    rows = sorted({tuple(g["rows"]) for g in res})
    for g in res:
        assert g["asked"] == [tuple(g["rows"])]
    got = {k: np.concatenate([next(g["batch"][k] for g in res
                                   if tuple(g["rows"]) == r) for r in rows])
           for k in want}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], ranks[2][k])
    split = 1 if mesh == "1x2" else 2
    assert len(rows) == split


@pytest.mark.parametrize("mesh", ["1x2", "pod2"])
def test_elastic_resize_continues_to_jax_step_4(ranks, mesh):
    """Saved on (2, 1) at step 2 and restored by ``reshard_restore`` on
    another mesh: steps 3 and 4 give JAX's metrics and state."""
    res = [got[mesh] for got in _per_rank(ranks, 2, "elastic")]
    assert all(got["step"] == STEPS for got in res)
    _held_to_jax(res, ranks[1]["qwen"], LONG, f"resize to {mesh}",
                 first=STEPS)


def test_trainer_fault_on_one_rank_restores_every_rank(ranks):
    """Rank 0 alone fails at step 3: every rank agrees, restores step 2
    and replays, and ends with the clean run's bits and JAX's state."""
    res = _per_rank(ranks, 2, "trainer")
    for r, got in enumerate(res):
        assert got["clean"]["restarts"] == 0
        assert got["fault"]["restarts"] == 1, (r, got["fault"])
        assert got["fault"]["failed_steps"] == [3], (r, got["fault"])
        assert got["fault"]["digest"] == got["clean"]["digest"] == \
            res[0]["clean"]["digest"], r
        _close_metrics(got["fault"]["metrics"], ranks[1]["qwen"]["metrics"],
                       f"trainer rank {r}")
    _close_state(res[0]["fault"]["state"], ranks[1]["qwen"]["states"][LONG],
                 "trainer")
