"""PyTorch port: the dry run's FLOP count against JAX's.

The port's train, prefill and decode steps run on ``meta`` tensors under
``roofline/op_cost.analyse_ops`` (``dryrun.lower_*`` with no mesh); JAX's
are the same steps jitted and compiled on one CPU device (no mesh, so
every sharding constraint is a no-op, as on JAX's smoke mesh), counted by
``repro.roofline.hlo_cost.analyse_hlo``, at ``SMOKE_SHAPES`` on shrunk
configs, ``impl="xla"`` and ``remat=True`` as JAX's dry run lowers them
(a prefill cell takes the train shape's batch and length).  The counts
agree at rel 1e-6, but rwkv6-1.6b's training step, held at rel 1e-3: see
:func:`test_rwkv6_train_flops_gap`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import base as jbase
from repro.core.famous import FamousConfig as JFamousConfig
from repro.launch import specs as jspecs
from repro.models import module as jmodule
from repro.models import transformer as jtransformer
from repro.optim import adamw as jadamw
from repro.roofline import hlo_cost
from repro.train import step as jstep
from repro_torch.configs import base
from repro_torch.launch import dryrun
from repro_torch.roofline import op_cost

torch.set_num_threads(1)

TRAIN = base.SMOKE_SHAPES["smoke_train"]
PREFILL = dataclasses.replace(TRAIN, name="smoke_prefill", kind="prefill")
DECODE = base.SMOKE_SHAPES["smoke_decode"]


def jax_flops(arch: str, shape) -> float:
    cfg = jbase.shrink(jbase.get_config(arch))
    jshape = jbase.ShapeConfig(shape.name, shape.seq_len, shape.global_batch,
                               shape.kind)
    fcfg = JFamousConfig(impl="xla")
    if shape.kind == "train":
        tcfg = jstep.TrainConfig(
            param_dtype=jnp.float32, remat=True,
            optimizer=jadamw.AdamWConfig(moment_dtype=jnp.float32))
        fn = jstep.make_train_step(cfg, fcfg, tcfg)
        args = (jstep.state_shapes(cfg, tcfg),
                jspecs.train_input_specs(cfg, jshape))
    else:
        params = jmodule.param_shapes(jtransformer.model_spec(cfg),
                                      jnp.bfloat16)
        if shape.kind == "prefill":
            def fn(p, inputs, caches):
                return jtransformer.prefill(p, inputs, caches, cfg, fcfg)
            args = (params,
                    jspecs.train_input_specs(cfg, jshape,
                                             jnp.bfloat16)["inputs"],
                    jtransformer.make_caches(cfg, shape.global_batch,
                                             shape.seq_len, jnp.bfloat16,
                                             shapes_only=True))
        else:
            def fn(p, tokens, caches, cache_len):
                return jtransformer.decode_step(p, tokens, caches, cache_len,
                                                cfg, fcfg)
            dec = jspecs.decode_input_specs(cfg, jshape)
            args = (params, dec["tokens"], dec["caches"], dec["cache_len"])
    compiled = jax.jit(fn).lower(*args).compile()
    return hlo_cost.analyse_hlo(compiled.as_text()).flops


def port_flops(arch: str, shape) -> float:
    cfg = base.shrink(base.get_config(arch))
    low = dryrun.lower(cfg, shape)
    return op_cost.analyse_ops(low.fn, *low.args).flops


CASES = [(a, s) for a in ("qwen2-7b", "grok-1-314b", "recurrentgemma-2b")
         for s in (TRAIN, PREFILL, DECODE)] + [("rwkv6-1.6b", DECODE)]


@pytest.mark.parametrize("arch,shape", CASES,
                         ids=[f"{a}-{s.kind}" for a, s in CASES])
def test_flops_match_jax_hlo(arch, shape):
    got, want = port_flops(arch, shape), jax_flops(arch, shape)
    assert got == pytest.approx(want, rel=1e-6), (got, want)


def test_rwkv6_train_flops_gap():
    """rwkv6-1.6b's training step counts 0.05% under JAX's.  JAX's chunked
    wkv takes the bonus term's diagonal as an einsum
    (``einsum("bhtd,bhtd->bht", r * u, k)``), a dot of 2·B·H·S·dh FLOPs
    to XLA; the port's ``wkv6_chunked`` takes it as an elementwise product
    and a sum, which are no matrix product.  The training step runs it
    twice a layer (the forward, and again under remat), and its gradient
    is elementwise in both."""
    got, want = port_flops("rwkv6-1.6b", TRAIN), jax_flops("rwkv6-1.6b",
                                                           TRAIN)
    assert got == pytest.approx(want, rel=1e-3), (got, want)
    cfg = base.shrink(base.get_config("rwkv6-1.6b"))
    dh = cfg.rwkv_head_dim
    diag = 2 * TRAIN.global_batch * (cfg.d_model // dh) * TRAIN.seq_len * dh
    assert want - got == 2 * cfg.num_layers * diag
