"""PyTorch port, elastic resize and int8 gradient compression (the ports
of ``tests/test_train.py``'s ``test_elastic_reshard_restore``,
``test_gradient_compression_error_feedback`` and
``test_compress_decompress_roundtrip``), and the bf16 gate in ulps that
``chip_smoke.py`` holds its bf16 decode rows to (``lib.ulp_gate``).

``compressed_psum_tree`` is held to the JAX function itself: run unchanged
under ``jax.vmap(..., axis_name="pod")`` on the stacked inputs of the ranks
of one pod group, with a mesh stand-in whose ``.shape`` is ``{"pod": n}``,
its results must equal every rank's bit for bit.  The ranks are one
``torch.multiprocessing`` spawn of 4 gloo ranks over a ``FileStore``
(:func:`ranks`), which hold the pod axis at 1, 2 and 4 ranks: meshes
(pod 4, data 1), (pod 2, data 2) and (pod 1, data 4), model 1.  The same
ranks restore a whole-state checkpoint onto a (data 2, model 2) mesh.
"""
import os
import pickle
import time
import traceback

import numpy as np
import pytest
import torch

# the ranks import this module; jax and repro are imported inside the
# functions the parent process runs
from repro_torch import convert
from repro_torch.configs.base import get_config, shrink
from repro_torch.kernels import lib
from repro_torch.models.module import tree_leaves, tree_map2
from repro_torch.optim import compression
from repro_torch.train import elastic

torch.set_num_threads(1)

WORLD = 4
PODS = (4, 2, 1)
JOIN_S = 300


def _inputs(n_pod, rank, rnd):
    """Rank ``rank``'s gradient tree (an f32 and a bf16 leaf) of round
    ``rnd`` on the mesh with ``n_pod`` pods."""
    rng = np.random.default_rng(1000 * n_pod + 10 * rank + rnd)
    return {"w": (rng.standard_normal((24, 16)) * 3).astype(np.float32),
            "b": {"v": rng.standard_normal(40).astype(np.float32)}}


def _bf16(a):
    import ml_dtypes
    return a.astype(ml_dtypes.bfloat16)


def _tree(g):
    """The numpy tree as tensors: "b"'s leaf in bf16."""
    return {"w": convert.to_torch(g["w"], "cpu"),
            "b": {"v": convert.to_torch(_bf16(g["b"]["v"]), "cpu")}}


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else convert.to_numpy(v)
            for k, v in tree.items()}


def _compression_case(n_pod):
    """Two rounds of ``compressed_psum_tree`` over the "pod" axis, the
    second fed the first's residuals."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((n_pod, WORLD // n_pod, 1), ("pod", "data", "model"),
                     "cpu")
    rank = dist.get_rank()
    out, res = [], None
    for rnd in range(2):
        g, res = compression.compressed_psum_tree(
            _tree(_inputs(n_pod, rank, rnd)), mesh, "pod", res)
        out.append(dict(grads=_np(g), residuals=_np(res)))
    coords = {a: mesh.get_local_rank(a) for a in ("pod", "data")}
    return dict(rounds=out, coords=coords)


def _elastic_case(tmp):
    """A whole state saved as one device saves it, restored onto a
    (data 2, model 2) mesh: every rank's shard, gathered, is the saved
    leaf bit for bit."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_training_mesh
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train import step as step_lib
    cfg = shrink(get_config("qwen2-7b"), num_heads=8, num_kv_heads=4,
                 head_dim=8)
    tcfg = step_lib.TrainConfig()
    state = step_lib.init_state(cfg, tcfg, torch.Generator().manual_seed(0),
                                "cpu")
    d = os.path.join(tmp, "el")
    if dist.get_rank() == 0:
        ckpt_lib.save_checkpoint(d, 3, state)
    mesh = make_training_mesh((2, 2), "cpu")
    comm = shd.MeshComm(mesh)
    comm.barrier()
    like = step_lib.init_state(cfg, tcfg, torch.Generator(), "cpu", mesh)
    restored, step = elastic.reshard_restore(
        d, like, mesh, step_lib.state_logical_axes(cfg))
    whole = tree_map2(lambda t, s: comm.gather(t.detach(), s),
                      restored, step_lib.state_specs(cfg, mesh))
    same = all(torch.equal(a.detach(), b) for a, b in
               zip(tree_leaves(state), tree_leaves(whole)))
    sharded = any(a.shape != b.shape for a, b in
                  zip(tree_leaves(state), tree_leaves(restored)))
    grads = all(a.requires_grad == b.requires_grad for a, b in
                zip(tree_leaves(state["params"]),
                    tree_leaves(restored["params"])))
    return dict(step=step, same=same, sharded=sharded, requires_grad=grads)


def _case(fn):
    try:
        return fn()
    except Exception:
        return {"error": traceback.format_exc()}


def _rank_main(rank, world, tmp):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world)
    try:
        out = {f"pod{n}": _case(lambda n=n: _compression_case(n))
               for n in PODS}
        out["elastic"] = _case(lambda: _elastic_case(tmp))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the 4 ranks and join them under a deadline; a list by rank
    of {case: result}."""
    import torch.multiprocessing as mp

    tmp = str(tmp_path_factory.mktemp("ranks"))
    ctx = mp.start_processes(_rank_main, args=(WORLD, tmp), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                pytest.fail(f"the ranks did not finish in {JOIN_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    out = []
    for r in range(WORLD):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            got = pickle.load(f)
        for case, res in got.items():
            assert "error" not in res, f"rank {r} {case}: {res['error']}"
        out.append(got)
    return out


class _PodMesh:
    """The JAX function reads only ``mesh.shape[axis]``."""

    def __init__(self, n):
        self.shape = {"pod": n}


def _jax_psum(n_pod, members, rnd, residuals):
    """JAX's ``compressed_psum_tree`` under ``vmap(axis_name="pod")`` on
    the stacked round-``rnd`` inputs of ``members`` (global ranks in pod
    order)."""
    import jax
    import jax.numpy as jnp
    from repro.optim import compression as jcompression

    gs = [_inputs(n_pod, r, rnd) for r in members]
    g = {"w": jnp.stack([jnp.asarray(x["w"]) for x in gs]),
         "b": {"v": jnp.stack([jnp.asarray(_bf16(x["b"]["v"]))
                               for x in gs])}}

    def one(g, r):
        return jcompression.compressed_psum_tree(g, _PodMesh(n_pod), "pod",
                                                 r)

    if residuals is None:
        out, res = jax.vmap(lambda g: one(g, None), axis_name="pod")(g)
    else:
        out, res = jax.vmap(one, axis_name="pod")(g, residuals)
    return out, res


@pytest.mark.parametrize("n_pod", PODS)
def test_compressed_psum_matches_jax_bit_for_bit(ranks, n_pod):
    """Two rounds (the second fed the first's residuals) on every pod
    group: every rank's mean gradient and residual equal JAX's, bit for
    bit, f32 and bf16 leaves alike."""
    import jax
    groups = {}
    for r, got in enumerate(ranks):
        res = got[f"pod{n_pod}"]
        groups.setdefault(res["coords"]["data"], []).append(
            (res["coords"]["pod"], r))
    for members in groups.values():
        members = [r for _, r in sorted(members)]
        assert len(members) == n_pod
        jres = None
        for rnd in range(2):
            jout, jres = _jax_psum(n_pod, members, rnd, jres)
            for i, r in enumerate(members):
                got = ranks[r][f"pod{n_pod}"]["rounds"][rnd]
                want = jax.tree_util.tree_map(
                    lambda a: np.asarray(a[i]).astype(np.float32),
                    (jout, jres))
                for a, b in zip(tree_leaves(got["grads"]) +
                                tree_leaves(got["residuals"]),
                                tree_leaves(want[0]) + tree_leaves(want[1])):
                    np.testing.assert_array_equal(a, b)


def test_gradient_compression_error_feedback(ranks):
    """On a pod axis of one rank: the mean is the input within half an
    int8 step, and the residual holds exactly the quantization error."""
    for r, got in enumerate(ranks):
        out = got["pod1"]["rounds"][0]
        g = _inputs(1, r, 0)["w"]
        scale = float(np.abs(g).max()) / 127.0
        assert float(np.abs(out["grads"]["w"] - g).max()) <= scale * 0.51
        np.testing.assert_allclose(g - out["grads"]["w"],
                                   out["residuals"]["w"], atol=1e-6)


def test_compress_decompress_roundtrip():
    g = torch.from_numpy(
        (np.random.default_rng(1).standard_normal(128) * 3.0)
        .astype(np.float32))
    q, scale, resid = compression.compress(g)
    assert q.dtype == torch.int8
    np.testing.assert_allclose(
        (compression.decompress(q, scale) + resid).numpy(), g.numpy(),
        atol=1e-6)


def test_elastic_reshard_restore(ranks):
    """Saved as one device saves it, restored onto a (data 2, model 2)
    mesh: the shards are cut (some leaf is smaller), and gathered they
    are the saved state bit for bit, on every rank."""
    for got in ranks:
        res = got["elastic"]
        assert res == dict(step=3, same=True, sharded=True,
                           requires_grad=True), res


def test_validate_resize():
    probs = elastic.validate_resize({"pod": 2, "data": 16, "model": 16},
                                    {"pod": 4, "data": 16, "model": 16}, 256)
    assert probs == []
    probs = elastic.validate_resize({"data": 16, "model": 16},
                                    {"data": 8, "model": 32}, 256)
    assert len(probs) == 2
    probs = elastic.validate_resize({"data": 2}, {"data": 3}, 8)
    assert len(probs) == 2


@pytest.mark.parametrize("m", [0.75, 1.0, -3.25, 200.0])
def test_ulp_gate_takes_a_rounding_flip_and_refuses_two_ulps(m):
    """The bf16 gate of ``chip_smoke.py``'s decode rows.  A reference one
    f32 step short of the midpoint above the bf16 value ``m`` (away from
    0) rounds to ``m``; a kernel whose f32 result lands just past that
    midpoint rounds to ``m``'s neighbour, one ulp from the bf16-rounded
    reference, and passes; an output two ulps from it does not."""
    s = 1.0 if m > 0 else -1.0
    u = float(lib.bf16_ulp(torch.tensor([m])))
    assert u == 2.0 ** (np.floor(np.log2(abs(m))) - 7)
    mid = torch.tensor([m + s * 0.5 * u], dtype=torch.float32)
    ref = torch.nextafter(mid, torch.tensor([m], dtype=torch.float32))
    assert float(ref.to(torch.bfloat16).float()) == m
    flip = torch.tensor([m + s * u]).to(torch.bfloat16)
    assert float(flip.float()) == m + s * u        # one ulp from m
    err, ulps, ok = lib.ulp_gate(flip, ref, 2e-5)
    assert ok and 0.5 * u < err <= 0.5 * u + 2e-5 and ulps <= 0.5, (err,
                                                                     ulps)
    assert lib.ulp_gate(torch.tensor([m]).to(torch.bfloat16), ref, 2e-5)[2]
    two = torch.tensor([m + 2 * s * u]).to(torch.bfloat16)
    assert float(two.float()) == m + 2 * s * u
    err, ulps, ok = lib.ulp_gate(two, ref, 2e-5)
    assert not ok and ulps > 1.4, (err, ulps)
    assert lib.bf16_ulp(torch.zeros(1)).item() == 0.0
