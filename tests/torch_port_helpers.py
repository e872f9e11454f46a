"""Shared inputs for the PyTorch-port parity tests (``test_torch_*.py``):
JAX parameter trees whose every leaf — biases and norm scales included —
is drawn from a numpy seed, so a bias or scale bug cannot hide behind a
zeros or ones init."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import module as jax_module
from repro.models import transformer as jax_transformer

torch.set_num_threads(1)


def config_as_jax(cfg, jcfg) -> dict:
    """The port's ``cfg`` as a dict on the JAX dataclass's fields, to hold
    equal to ``dataclasses.asdict(jcfg)``, after checking that each field
    the JAX dataclass lacks (the port's latent attention, DeepSeek-V3
    routing and leading dense layers) holds its default, off."""
    import dataclasses
    jax_names = {f.name for f in dataclasses.fields(jcfg)}
    port = dataclasses.asdict(cfg)
    own = {f.name: f.default for f in dataclasses.fields(cfg)
           if f.name not in jax_names}
    assert {k: port[k] for k in own} == own, cfg.name
    return {k: port[k] for k in jax_names}


def _leaf_name(path) -> str:
    return str(getattr(path[-1], "key", path[-1]))


def random_jax_params(cfg, seed: int = 0, dtype=jnp.float32):
    """JAX params for ``cfg`` with every leaf filled from numpy."""
    params = jax_module.init_params(jax_transformer.model_spec(cfg),
                                    jax.random.PRNGKey(0), jnp.float32)
    rng = np.random.default_rng(seed)

    def fill(path, a):
        name = _leaf_name(path)
        stacked = any(_leaf_name(path[:i + 1]) == "blocks"
                      for i in range(len(path)))
        shape = a.shape[1:] if stacked else a.shape
        z = rng.standard_normal(a.shape).astype(np.float32)
        if name == "scale":
            x = 1.0 + 0.1 * z
        elif name.startswith("b"):
            x = 0.1 * z
        elif name == "embedding":
            x = z
        elif name == "wo":
            x = z / math.sqrt(shape[0] * shape[1])
        elif name in ("w_in", "w_gate", "w_out") and len(shape) == 3:
            # an MoE expert stack (E, fan_in, fan_out)
            x = z / math.sqrt(shape[1])
        else:
            x = z / math.sqrt(shape[0])
        return jnp.asarray(x, dtype)

    return jax.tree_util.tree_map_with_path(fill, params)


def tokens(rng, vocab, n):
    return [int(t) for t in rng.integers(0, vocab, size=n)]
