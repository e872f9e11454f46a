"""PyTorch port, the rest of the dense zoo: qwen3-32b (per-head qk
RMSNorm, dh 80), deepseek-7b (MHA: as many kv heads as query heads) and
command-r-plus-104b (12 query heads a kv head, tied embeddings), shrunk
with their head layouts kept, against the JAX package on the same
weights: ``transformer.forward`` logits, engine tokens (chunked on
contiguous KV, and on paged int8 KV with the prefix cache) and one
training gradient on qwen3-32b; the weights' ``q_norm``/``k_norm``
crossing ``convert`` and kept by ``fuse_qkv``; and, over every config,
``supported_cells`` and ``param_count`` equal to JAX's and the registry
equal to JAX's.  Tolerance at f32: 1e-4 on logits and gradients (relative to a
leaf's largest entry), tokens identical."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import config_as_jax, random_jax_params, tokens
from repro.configs import base as jbase
from repro.configs.base import get_config as jget_config
from repro.configs.base import shrink as jshrink
from repro.core.famous import FamousConfig as JFamousConfig
from repro.models import transformer as jtransformer
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JServingEngine
from repro_torch import convert
from repro_torch.configs import base
from repro_torch.configs.base import get_config, shrink
from repro_torch.core.famous import FamousConfig
from repro_torch.models import module, transformer
from repro_torch.serve.engine import Request, ServingEngine

TOL = 1e-4
# shrunk with the full configs' head layouts: qwen3-32b's 80-dim heads,
# deepseek-7b's group of 1, command-r-plus-104b's group of 12
SHRINK = {"qwen3-32b": dict(head_dim=80),
          "deepseek-7b": dict(num_heads=4, num_kv_heads=4),
          "command-r-plus-104b": dict(num_heads=12, num_kv_heads=1)}
ARCHS = tuple(SHRINK)


@functools.lru_cache(maxsize=None)
def _weights(arch, seed=3):
    cfg = shrink(get_config(arch), **SHRINK[arch])
    jcfg = jshrink(jget_config(arch), **SHRINK[arch])
    jp = random_jax_params(jcfg, seed=seed)
    return cfg, jcfg, jp


def test_registry_is_jax_less_the_configs_to_come():
    """Every JAX config, the MoE and frontend ones included, each a
    field-for-field copy."""
    moe_or_frontend = {n for n in jbase.list_configs()
                       if jget_config(n).num_experts or jget_config(n).frontend}
    assert moe_or_frontend == {"grok-1-314b", "kimi-k2-1t-a32b",
                               "hubert-xlarge", "llava-next-34b"}
    # the port-only configs (base.PORT_ONLY) have no JAX twin; every other
    # is compared on the JAX dataclass's fields, the port's own left off
    assert [n for n in base.list_configs()
            if n not in base.PORT_ONLY] == jbase.list_configs()
    for name in jbase.list_configs():
        assert config_as_jax(get_config(name), jget_config(name)) == \
            dataclasses.asdict(jget_config(name))


@pytest.mark.parametrize("arch", jbase.list_configs())
def test_cells_and_param_count_match_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert base.supported_cells(arch) == jbase.supported_cells(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert (cfg.is_attention_free, cfg.is_subquadratic) == \
        (jcfg.is_attention_free, jcfg.is_subquadratic)


def test_qk_norm_weights_cross_and_survive_fusion():
    """``q_norm``/``k_norm`` are drawn from the seed (not ones), cross
    ``convert`` leaf for leaf and stay beside the fused ``w_qkv``."""
    cfg, jcfg, jp = _weights("qwen3-32b")
    tree = convert.tree_from_jax(jp, "cpu")
    served = transformer.prepare_params(tree, cfg)
    for u in range(cfg.num_units):
        blk = served["layers"][u]["attn"]
        assert "w_qkv" in blk
        for name in ("q_norm", "k_norm"):
            want = np.asarray(jp["blocks"]["pos0"]["attn"][name])[u]
            assert not np.allclose(want, 1.0)
            np.testing.assert_array_equal(convert.to_numpy(blk[name]), want)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch, impl):
    cfg, jcfg, jp = _weights(arch)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 24))
    want = jtransformer.forward(jp, jnp.asarray(toks, jnp.int32), jcfg,
                                JFamousConfig(impl="xla"))
    got = transformer.forward(convert.tree_from_jax(jp, "cpu"),
                              torch.from_numpy(toks), cfg,
                              FamousConfig(impl=impl))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)


ENGINE_KW = {"contiguous": dict(chunk=8),
             "paged int8 prefix": dict(chunk=8, cache_kind="paged",
                                       page_size=8, kv_dtype="int8",
                                       prefix_cache=True)}


@pytest.mark.parametrize("case", list(ENGINE_KW))
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_jax(arch, case):
    """Greedy and seeded requests; the shared 16-token head hits the
    prefix cache on the paged run."""
    kw = ENGINE_KW[case]
    cfg, jcfg, jp = _weights(arch)
    rng = np.random.default_rng(7)
    head = tokens(rng, cfg.vocab_size, 16)
    prompts = [head + tokens(rng, cfg.vocab_size, n) for n in (4, 11, 1)]
    prompts.append(tokens(rng, cfg.vocab_size, 5))

    def reqs(cls):
        return [cls(rid=i, tokens=list(p), max_new=5,
                    **(dict(temperature=0.8, top_k=4, seed=11) if i % 2
                       else {}))
                for i, p in enumerate(prompts)]

    jeng = JServingEngine(jp, jcfg, JFamousConfig(impl="xla"), n_slots=2,
                          max_seq=64, **kw)
    want = [r.out for r in sorted(jeng.run(reqs(JRequest)),
                                  key=lambda r: r.rid)]
    eng = ServingEngine(convert.params_from_jax(jp, cfg, "cpu"), cfg,
                        FamousConfig(impl="pallas"), n_slots=2, max_seq=64,
                        device="cpu", **kw)
    got = [r.out for r in sorted(eng.run(reqs(Request)),
                                 key=lambda r: r.rid)]
    assert got == want
    if kw.get("prefix_cache"):
        assert eng.prefix_hit_tokens == jeng.prefix_hit_tokens > 0


def test_qwen3_train_gradient_matches_jax():
    """One gradient of the LM loss at f32 on shrunk qwen3-32b: every leaf
    (the qk-norm scales included) against ``jax.grad`` of JAX's loss."""
    from repro.data import pipeline as jpipeline
    from repro.train import losses as jlosses
    from repro_torch.configs.base import SMOKE_SHAPES
    from repro_torch.data import pipeline
    from repro_torch.train import step as step_lib
    cfg, jcfg, jp = _weights("qwen3-32b")
    shape = SMOKE_SHAPES["smoke_train"]
    jbatch = {k: jnp.asarray(v) for k, v in jpipeline.host_batch(
        jcfg, jbase.SMOKE_SHAPES["smoke_train"], 0, 0).items()}
    fcfg = JFamousConfig(impl="xla")
    jloss, jgrads = jax.value_and_grad(lambda p: jlosses.lm_loss(
        p, jbatch, jcfg, fcfg, chunk=16, compute_dtype=jnp.float32))(jp)
    params = convert.tree_from_jax(jp, "cpu")
    module.tree_map(lambda p: p.requires_grad_(True), params)
    ts = step_lib.make_train_step(cfg, FamousConfig(impl="pallas"),
                                  step_lib.TrainConfig(
                                      compute_dtype=torch.float32,
                                      loss_chunk=16))
    loss, grads = ts.grads_of(params, pipeline.device_batch(cfg, shape, 0, 0,
                                                            "cpu"))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    leaves = module.tree_leaves(grads)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b,
                                   atol=TOL * np.abs(b).max(), rtol=TOL)
