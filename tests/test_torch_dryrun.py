"""PyTorch port: the dry run's shapes, bytes and CLI against the JAX
package's.

* ``launch/specs.input_specs`` against JAX's ``launch/specs.input_specs``,
  shapes for every config and ``supported_cells`` entry (the caches with
  JAX's stacked ``blocks`` unstacked a layer at a time); the inputs'
  dtypes are the port's (int64 tokens, f32 embeddings);
* ``transformer.make_caches(shapes_only=True)`` against JAX's leaf by
  leaf: contiguous, paged and int8 pools, every config;
* ``train/step.state_shapes`` against JAX's, f32 and bf16 moments;
* one pod1 rank's bytes against JAX's shard shapes under
  ``DEFAULT_RULES`` on an abstract (16, 16) mesh, exactly: qwen2-7b
  ``train_4k``'s state, ``decode_32k``'s spec-tree parameters and caches;
  the tokens' dtype and the serving layout's f32 head reported apart;
* the CLI in a subprocess on one production cell.

The FLOP counts against JAX's HLO are in ``test_torch_dryrun_flops.py``.
No production mesh is built in this process but inside
``dryrun.fake_world``, which destroys its group on leaving.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import base as jbase
from repro.launch import mesh as jmesh
from repro.launch import specs as jspecs
from repro.models import module as jmodule
from repro.models import transformer as jtransformer
from repro.optim import adamw as jadamw
from repro.parallel import sharding as jshd
from repro.train import step as jstep
from repro_torch.configs import base
from repro_torch.launch import dryrun, specs
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.train import step

torch.set_num_threads(1)
SRC = Path(__file__).resolve().parent.parent / "src"


def dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return np.dtype(dt).name


def jax_layers(caches: dict, cfg) -> list:
    """JAX's cache tree (a unit's layers stacked in ``blocks``, then the
    tails) as one dict of (shape, dtype) a layer, in the port's order."""
    out = []
    for u in range(cfg.num_units):
        for i in range(len(cfg.pattern_unit)):
            out.append({n: (tuple(s.shape[1:]), dtype_name(s.dtype))
                        for n, s in caches["blocks"][f"pos{i}"].items()})
    for i in range(len(cfg.tail_layers)):
        out.append({n: (tuple(s.shape), dtype_name(s.dtype))
                    for n, s in caches[f"tail{i}"].items()})
    return out


def port_layers(caches: list) -> list:
    return [{n: (tuple(s.shape), dtype_name(s.dtype)) for n, s in c.items()}
            for c in caches]


def flat(tree, prefix=()) -> dict:
    """{path: (shape, dtype)} of a nested dict of shape leaves."""
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in
                flat(tree[k], prefix + (k,)).items()}
    return {prefix: (tuple(tree.shape), dtype_name(tree.dtype))}


# kimi-k2-instruct (base.PORT_ONLY) has no JAX twin to hold its specs to,
# and runs unsharded only, so the dry run over a mesh leaves it out
JAX_ARCHS = [a for a in base.list_configs() if a not in base.PORT_ONLY]
CELLS = [(a, s) for a in JAX_ARCHS for s in base.supported_cells(a)]


def test_cells_match_jax():
    assert CELLS == [(a, s) for a in jbase.list_configs()
                     for s in jbase.supported_cells(a)]
    assert dryrun.all_cells() == [c for c in CELLS if c[0] != "famous-bert"]


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_input_specs_match_jax(arch, shape_name):
    got = specs.input_specs(arch, shape_name)
    want = jspecs.input_specs(arch, shape_name)
    assert set(got) == set(want)
    cfg = base.get_config(arch)
    for k in got:
        if k == "caches":
            assert port_layers(got[k]) == jax_layers(want[k], cfg)
            continue
        assert got[k].shape == tuple(want[k].shape), k
        # the port's steps are fed int64 tokens and f32 embeddings
        float_in = cfg.frontend and k in ("inputs", "tokens")
        assert got[k].dtype == (torch.float32 if float_in else
                                torch.int32 if k == "cache_len"
                                else torch.int64), k


KINDS = [dict(), dict(cache_kind="paged", page_size=16, n_pages=10),
         dict(cache_kind="paged", page_size=8, n_pages=7, kv_dtype="int8")]


# encoder-only configs have no caches
DECODERS = [a for a in JAX_ARCHS
            if not base.get_config(a).is_encoder_only]


@pytest.mark.parametrize("arch", DECODERS)
@pytest.mark.parametrize("kind", range(len(KINDS)),
                         ids=["contiguous", "paged", "paged-int8"])
def test_shapes_only_caches_match_jax(arch, kind):
    cfg = base.get_config(arch)
    kw = KINDS[kind]
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16),
                          (torch.float32, jnp.float32)):
        got = transformer.make_caches(cfg, 3, 40, dtype, shapes_only=True,
                                      **kw)
        want = jtransformer.make_caches(jbase.get_config(arch), 3, 40,
                                        jdtype, True, **kw)
        assert port_layers(got) == jax_layers(want, cfg)
        # the allocating path gives the same shapes
        real = transformer.make_caches(cfg, 3, 40, dtype, "meta", **kw)
        assert port_layers(real) == port_layers(got)


@pytest.mark.parametrize("arch", JAX_ARCHS)
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_state_shapes_match_jax(arch, moments):
    tdt, jdt = getattr(torch, moments), getattr(jnp, moments)
    tcfg = step.TrainConfig(optimizer=adamw.AdamWConfig(moment_dtype=tdt))
    jtcfg = jstep.TrainConfig(
        optimizer=jadamw.AdamWConfig(moment_dtype=jdt))
    got = flat(step.state_shapes(base.get_config(arch), tcfg))
    want = flat(jstep.state_shapes(jbase.get_config(arch), jtcfg))
    assert got == want


def jax_shard_bytes(axes, shapes) -> int:
    """Bytes of one rank's shards of ``shapes`` under JAX's DEFAULT_RULES
    on the pod1 abstract mesh."""
    mesh = jmesh.abstract_mesh((16, 16), ("data", "model"))
    shardings = jshd.tree_shardings(mesh, axes, None, shapes)
    leaves = jax.tree_util.tree_leaves(shapes)
    shs = jax.tree_util.tree_leaves(shardings)
    assert len(leaves) == len(shs)
    return sum(math.prod(sh.shard_shape(s.shape)) * np.dtype(s.dtype).itemsize
               for s, sh in zip(leaves, shs))


@pytest.mark.filterwarnings("ignore::RuntimeWarning")
def test_pod1_rank_bytes_match_jax_shards():
    cfg, jcfg = base.get_config("qwen2-7b"), jbase.get_config("qwen2-7b")
    with dryrun.fake_world(256):
        mesh = dryrun.production_mesh(False)
        train = dryrun.lower_train(cfg, base.SHAPES["train_4k"], mesh)
        serve = dryrun.lower_serve(cfg, base.SHAPES["decode_32k"], mesh)
    assert not dist.is_initialized()

    # the train state: parameters and moments (count and step are host
    # scalars in the port, replicated int32 scalars in JAX)
    jt = jstep.TrainConfig(param_dtype=jnp.float32, remat=True)
    st = jstep.state_shapes(jcfg, jt)
    axes = jstep.state_logical_axes(jcfg)
    scalars = 2 * 4
    assert train.parts["state_bytes"] + scalars == \
        jax_shard_bytes(axes, st)
    # the train batch: int64 (B/16, S) inputs and targets, JAX's int32
    assert train.parts["input_bytes"] == 2 * 16 * 4096 * 8

    # the spec tree's bf16 parameters and the caches
    spec = jtransformer.model_spec(jcfg)
    pshapes = jmodule.param_shapes(spec, jnp.bfloat16)
    assert serve.parts["param_bytes"] == jax_shard_bytes(
        jmodule.logical_axes(spec), pshapes)
    dec = jspecs.decode_input_specs(jcfg, jbase.SHAPES["decode_32k"])
    want_cache = jax_shard_bytes(jtransformer.cache_axes(jcfg),
                                 dec["caches"])
    # 8 slots x 32768 x 4 kv heads (which 16 does not divide) x 128 x
    # (k, v) x bf16 x 28 layers
    assert serve.parts["cache_bytes"] == want_cache == \
        8 * 32768 * 4 * 128 * 2 * 2 * 28
    # apart: the serving layout's f32 head holds the rank's (embed, vocab)
    # shard of the LM head at 4 bytes, and the tokens are int64
    assert serve.parts["unembed_f32_bytes"] == (3584 // 16) * (
        152064 // 16) * 4
    assert serve.parts["input_bytes"] == 8 * 8 + 8 * 4


def test_cli_one_cell(tmp_path):
    out = tmp_path / "dryrun"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run(
        [sys.executable, "-W", "ignore", "-m", "repro_torch.launch.dryrun",
         "--arch", "qwen2-7b", "--shape", "decode_32k", "--mesh", "pod1",
         "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "ALL CELLS PASSED" in r.stdout
    assert r.stdout.startswith("OK   qwen2-7b")
    res = json.loads((out / "qwen2-7b__decode_32k__pod1.json").read_text())
    assert res["ok"] and res["hw"] == "h100-sxm" and res["mesh"] == "pod1"
    mem = res["memory"]
    assert mem["per_device_bytes"] == mem["argument_bytes"] + \
        mem["peak_bytes"]
    # the serving layout holds the LM head's shard in f32 in place of bf16
    assert mem["argument_bytes"] == (mem["param_bytes"]
                                     + mem["unembed_f32_bytes"] // 2
                                     + mem["cache_bytes"]
                                     + mem["input_bytes"])
    assert mem["fits_80gb"] == (mem["per_device_bytes"] <= 80e9)
    rf = res["roofline"]
    assert rf["chips"] == 256 and rf["dominant"] in ("compute", "memory",
                                                     "collective")
    assert rf["flops_per_dev"] == res["cost"]["flops"] > 0
    assert res["cost"]["coll_counts"]["all-reduce"] > 0
    for k in ("useful_flop_ratio", "roofline_fraction", "t_compute_s",
              "t_memory_s", "t_collective_s"):
        assert rf[k] > 0, k
    # the list of cells, and no group left in this process
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--list"], env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.stdout.split("\n")[:-1] == [f"{a} {s}" for a, s in
                                         dryrun.all_cells()]
    assert not dist.is_initialized()
