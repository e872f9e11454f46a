"""PyTorch port, the vocab-parallel embedding, LM head and cross entropy
of the sharded train step (``make_train_step(mesh=)``), and query heads
that span kv heads in training, against the JAX package's unsharded step.

Where "vocab" splits over "model" (DEFAULT_RULES, TP_ONLY_RULES) a rank
keeps its rows of the embedding and its columns of the LM head: the
lookup masks the other tokens and sums over "model", the head is
column-parallel behind Megatron's f, and ``losses.VocabParallelCE`` gives
the loss from the rank's columns.  No rank gathers a whole vocabulary
table.  The ranks of each world size (2, 4) are ``torch.multiprocessing``
spawns of one gloo group over a ``FileStore``, started once for the
module; the parent runs JAX meanwhile on the same numpy weights and
batches.

The cases, at z-loss 1e-2 and an odd sequence length (15: the loss takes
its unchunked path): shrink(qwen2-7b) at 8 / 4 heads of 8 (untied) and
shrink(recurrentgemma-2b) (tied) on (1, 2) and (2, 2) under DEFAULT;
qwen2-7b at 12 / 3 heads of 8 under TP_ONLY on (1, 2) (6 query heads a
rank over kv groups of 4) and (1, 4) (3 a rank).  Each: the first step's
loss and gradients against ``jax.value_and_grad``, then 2 steps' metrics
and state against JAX's ``make_train_step``.
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
from repro_torch.configs.base import ShapeConfig, get_config, shrink
from repro_torch.core.famous import FamousConfig
from repro_torch.models.module import tree_leaves, tree_map, tree_map2
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as shd
from repro_torch.train import step as step_lib

torch.set_num_threads(1)

ARCHS = {"qwen": ("qwen2-7b", dict(num_heads=8, num_kv_heads=4,
                                   head_dim=8)),
         "rg": ("recurrentgemma-2b", {}),
         "kv12": ("qwen2-7b", dict(num_heads=12, num_kv_heads=3,
                                   head_dim=8))}
SHAPE = ShapeConfig("odd", 15, 4, "train")
RULES = {"default": shd.DEFAULT_RULES, "tp_only": shd.TP_ONLY_RULES}
# name -> (arch, mesh, rules)
CASES = {"qwen-1x2": ("qwen", (1, 2), "default"),
         "rg-1x2": ("rg", (1, 2), "default"),
         "kv12-1x2": ("kv12", (1, 2), "tp_only"),
         "qwen-2x2": ("qwen", (2, 2), "default"),
         "rg-2x2": ("rg", (2, 2), "default"),
         "kv12-1x4": ("kv12", (1, 4), "tp_only")}
Z_LOSS = 1e-2
STEPS = 2
TOL = 1e-4
LR = 1e-3
JOIN_S = 300


def _cfg(arch):
    name, over = ARCHS[arch]
    return shrink(get_config(name), **over)


def _tcfg():
    return step_lib.TrainConfig(
        compute_dtype=torch.float32, loss_chunk=16, z_loss=Z_LOSS,
        optimizer=adamw.AdamWConfig(lr=LR), schedule_warmup=2,
        schedule_total=100)


def _whole_state(weights):
    zeros = tree_map(np.zeros_like, weights)
    return {"params": weights,
            "opt": {"m": zeros, "v": zeros, "count": np.int32(0)},
            "step": np.int32(0)}


def _try(fn):
    try:
        return fn()
    except Exception:
        return {"error": traceback.format_exc()}


def _run(arch, weights, mesh, rules, lead):
    """The first step's loss and gradients (gathered), then STEPS steps:
    metrics, the gathered state (rank 0) and the shapes of every leaf
    the steps gathered."""
    from repro_torch.data import pipeline
    cfg = _cfg(arch)
    state = step_lib.shard_state(convert.train_state_from_jax(
        _whole_state(weights[arch]), "cpu"), cfg, mesh, rules)
    ts = step_lib.make_train_step(cfg, FamousConfig(impl="pallas"), _tcfg(),
                                  mesh, rules)
    comm = ts.layout.comm

    def batch(i):
        return pipeline.make_global_batch(cfg, SHAPE, 0, i, mesh, rules,
                                          "cpu")

    def whole(tree, specs):
        return tree_map2(lambda t, s: comm.gather(t.detach(), s).numpy()
                         if isinstance(t, torch.Tensor) else np.asarray(t),
                         tree, specs)

    gathered = []
    real = shd.MeshComm.gather

    def spy(self, t, spec):
        out = real(self, t, spec)
        gathered.append(tuple(out.shape))
        return out

    shd.MeshComm.gather = spy
    try:
        loss, grads = ts.grads_of(state["params"], batch(0))
        metrics = []
        for i in range(STEPS):
            state, m = ts(state, batch(i))
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        shd.MeshComm.gather = real
    # every rank gathers (a collective); rank 0 keeps the result
    grads = whole(grads, ts.state_specs["params"])
    state = whole(state, ts.state_specs)
    return dict(loss=float(loss), grads=grads if lead else None,
                metrics=metrics, gathered=sorted(set(gathered)),
                vocab=dict(ts.layout.vocab), state=state if lead else None)


def _rank_main(rank, world, tmp):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_training_mesh
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world)
    try:
        with open(os.path.join(tmp, "weights.pkl"), "rb") as f:
            weights = pickle.load(f)
        meshes = {m: make_training_mesh(m, "cpu")
                  for m in sorted({m for _, m, _ in CASES.values()
                                   if int(np.prod(m)) == world})}
        out = {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            for name, (arch, m, r) in CASES.items():
                if m in meshes:
                    out[name] = _try(lambda arch=arch, m=m, r=r: _run(
                        arch, weights, meshes[m], RULES[r], rank == 0))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _jax_run(arch, weights):
    """JAX's unsharded step (impl "xla") from the numpy weights: the
    first batch's loss and gradients (``jax.value_and_grad``), then
    STEPS steps' metrics and final state."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_config as jget_config
    from repro.configs.base import shrink as jshrink
    from repro.core.famous import FamousConfig as JFamousConfig
    from repro.data import pipeline as jpipeline
    from repro.optim import adamw as jadamw
    from repro.train import losses as jlosses
    from repro.train import step as jstep

    name, over = ARCHS[arch]
    jcfg = jshrink(jget_config(name), **over)
    fcfg = JFamousConfig(impl="xla")
    tcfg = jstep.TrainConfig(compute_dtype=jnp.float32, loss_chunk=16,
                             z_loss=Z_LOSS,
                             optimizer=jadamw.AdamWConfig(lr=LR),
                             schedule_warmup=2, schedule_total=100,
                             remat=False)

    def batch(i):
        return {k: jnp.asarray(v) for k, v in
                jpipeline.host_batch(jcfg, SHAPE, 0, i).items()}

    state = jax.tree_util.tree_map(jnp.asarray, _whole_state(weights))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jlosses.lm_loss(p, b, jcfg, fcfg, remat=False,
                                     chunk=16, z_loss=Z_LOSS,
                                     compute_dtype=jnp.float32)))(
        state["params"], batch(0))
    ts = jax.jit(jstep.make_train_step(jcfg, fcfg, tcfg))
    metrics = []
    for i in range(STEPS):
        state, m = ts(state, batch(i))
        metrics.append({k: float(v) for k, v in m.items()})
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(loss=float(loss), grads=to_np(grads), metrics=metrics,
                state=to_np(state))


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import jax.numpy as jnp
    import torch.multiprocessing as mp
    from repro.configs.base import get_config as jget_config
    from repro.configs.base import shrink as jshrink
    from torch_port_helpers import random_jax_params

    weights = {a: _to_numpy(random_jax_params(jshrink(jget_config(n), **o),
                                              seed=13, dtype=jnp.float32))
               for a, (n, o) in ARCHS.items()}
    procs, dirs = {}, {}
    for world in (2, 4):
        tmp = str(tmp_path_factory.mktemp(f"world{world}"))
        with open(os.path.join(tmp, "weights.pkl"), "wb") as f:
            pickle.dump(weights, f)
        dirs[world] = tmp
        procs[world] = mp.start_processes(_rank_main, args=(world, tmp),
                                          nprocs=world, join=False,
                                          start_method="spawn")
    jax_runs = {a: _jax_run(a, weights[a]) for a in ARCHS}
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
    return results, jax_runs


def _per_rank(ranks, case):
    world = int(np.prod(CASES[case][1]))
    out = []
    for r, res in enumerate(ranks[0][world]):
        got = res[case]
        assert "error" not in got, f"rank {r} of {world}: {got['error']}"
        out.append(got)
    return out


def _close_leaves(got, want, what):
    """Every leaf at TOL (atol relative to the leaf's largest entry, as
    ``test_torch_train.py`` holds gradients)."""
    for x, y in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_allclose(
            x, y, rtol=TOL, atol=TOL * max(np.abs(y).max(), 1e-30),
            err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_vocab_parallel_step_matches_jax(ranks, case):
    """On every rank the first step's loss and, gathered, its gradients
    are ``jax.value_and_grad``'s; after 2 steps every rank's metrics and
    rank 0's parameters and moments are JAX's."""
    want = ranks[1][CASES[case][0]]
    res = _per_rank(ranks, case)
    for r, got in enumerate(res):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL,
                                   err_msg=f"{case} rank {r}")
        for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
            for k in g:
                np.testing.assert_allclose(g[k], w[k], rtol=TOL,
                                           err_msg=f"{case} {k} @ {i}")
    _close_leaves(res[0]["grads"], want["grads"], f"{case}: gradients")
    for part in ("params", "m", "v"):
        _close_leaves(res[0]["state"]["params"] if part == "params"
                      else res[0]["state"]["opt"][part],
                      want["state"]["params"] if part == "params"
                      else want["state"]["opt"][part], f"{case}: {part}")


@pytest.mark.parametrize("case", ["qwen-1x2", "rg-1x2", "qwen-2x2",
                                  "rg-2x2"])
def test_no_rank_gathers_a_whole_vocab_table(ranks, case):
    """Under DEFAULT_RULES with "model" > 1 the embedding's and the
    head's vocabulary stay split (each rank its half), and none of the
    leaves the steps gathered is a whole vocabulary table."""
    cfg = _cfg(CASES[case][0])
    V, D = cfg.vocab_size, cfg.d_model
    for got in _per_rank(ranks, case):
        for k in ("embed", "head"):
            lo, hi = got["vocab"][k]
            assert hi - lo == V // 2
        assert (V, D) not in got["gathered"]
        assert (D, V) not in got["gathered"]
