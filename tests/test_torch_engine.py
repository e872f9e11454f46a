"""PyTorch port, serving engine: greedy token identity with the JAX engine
on the same weights, the seeded-sampling contract, the options that are
not ported yet, and the no-fallback rules (no silent CPU path, no plain
result where a kernel was asked for)."""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import random_jax_params, tokens
from repro.configs.base import get_config as jget_config
from repro.configs.base import shrink as jshrink
from repro.core.famous import FamousConfig as JFamousConfig
from repro.models import transformer as jtransformer
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JServingEngine
from repro_torch import convert
from repro_torch.configs.base import get_config, shrink
from repro_torch.core.famous import FamousConfig
from repro_torch.kernels import lib
from repro_torch.kernels.decode import chunk_prefill, decode_attn
from repro_torch.kernels.qkv import qkv_proj
from repro_torch.models import module, transformer
from repro_torch.serve import sampling
from repro_torch.serve.engine import Request, ServingEngine

SRC = Path(__file__).resolve().parents[1] / "src"


def _cfgs():
    return shrink(get_config("qwen2-7b")), jshrink(jget_config("qwen2-7b"))


def _prompts():
    rng = np.random.default_rng(11)
    # several chunks (chunk=8), a length-1 prompt (the clear_slot path),
    # and more requests than slots
    return [tokens(rng, 256, n) for n in (20, 1, 9, 17, 30)]


@pytest.mark.parametrize("timpl", ["xla", "pallas"])
def test_greedy_tokens_match_jax_engine(timpl):
    cfg, jcfg = _cfgs()
    jparams = random_jax_params(jcfg, seed=5)
    prompts = _prompts()
    jeng = JServingEngine(jparams, jcfg, JFamousConfig(impl="xla"),
                          n_slots=2, max_seq=64, chunk=8)
    jdone = sorted(jeng.run([JRequest(rid=i, tokens=list(p), max_new=6)
                             for i, p in enumerate(prompts)]),
                   key=lambda r: r.rid)
    eng = ServingEngine(convert.params_from_jax(jparams, cfg, "cpu"), cfg,
                        FamousConfig(impl=timpl), n_slots=2, max_seq=64,
                        chunk=8, device="cpu")
    done = sorted(eng.run([Request(rid=i, tokens=list(p), max_new=6)
                           for i, p in enumerate(prompts)]),
                  key=lambda r: r.rid)
    assert all(r.error is None for r in done)
    assert [r.out for r in done] == [r.out for r in jdone]
    # on the CPU no kernel launches: the plain versions ran
    assert eng.compilations == {"prefill": 0, "decode": 0, "verify": 0,
                                "clear": 0}


def _engine(n_slots, device="cpu"):
    cfg, _ = _cfgs()
    gen = torch.Generator().manual_seed(0)
    params = module.init_params(transformer.model_spec(cfg), gen,
                                torch.float32, "cpu")
    return ServingEngine(params, cfg, FamousConfig(impl="pallas"),
                         n_slots=n_slots, max_seq=64, chunk=8, device=device)


def test_seeded_sampling_independent_of_slots():
    """A seeded request samples the same tokens whatever the batch: the
    noise is a pure function of (seed, token index)."""
    rng = np.random.default_rng(6)
    prompt = tokens(rng, 256, 9)
    extras = [tokens(rng, 256, 7) for _ in range(3)]

    def run(extra, n_slots, **kw):
        reqs = [Request(rid=0, tokens=list(prompt), max_new=6, seed=42, **kw)]
        reqs += [Request(rid=i + 1, tokens=list(p), max_new=6)
                 for i, p in enumerate(extra)]
        done = sorted(_engine(n_slots).run(reqs), key=lambda r: r.rid)
        return done[0].out

    hot = dict(temperature=0.8, top_k=5)
    assert run([], 2, **hot) == run(extras, 3, **hot) == run(extras, 1, **hot)
    greedy = run([], 2)
    assert run(extras, 3, temperature=0.7, top_k=1) == greedy


@pytest.mark.parametrize("seed,index", [(0, 0), (42, 3), (2**32 - 1, 7),
                                        (123456789, 100000)])
def test_sampling_noise_is_jax_random(seed, index):
    """``fold_in(PRNGKey(seed), index)``, ``random.bits`` and the uniform
    draw are bit-identical to live ``jax.random``.  The gumbel noise
    ``-log(-log(u))`` agrees to 2e-6 absolute: the two libraries round the
    last bit of a float32 log differently (their inner ``-log(u)`` agrees
    to 2 ulp), and the outer log turns that into an absolute error."""
    import jax
    import jax.numpy as jnp
    key = jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)),
                             np.int32(index))
    mine = sampling.fold_in_key(seed, index)
    assert mine == tuple(int(x) for x in np.asarray(jax.random.key_data(key)))
    n = 4099
    bits = sampling.random_bits(mine, n, "cpu")
    np.testing.assert_array_equal(
        bits.numpy(), np.asarray(jax.random.bits(key, (n,), jnp.uint32)))
    tiny = np.finfo(np.float32).tiny
    u = sampling.uniform_from_bits(bits).numpy()
    ju = np.asarray(jax.random.uniform(key, (n,), jnp.float32, minval=tiny,
                                       maxval=1.0))
    np.testing.assert_array_equal(u.view(np.int32), ju.view(np.int32))
    g = sampling.gumbel(seed, index, n, "cpu").numpy()
    jg = np.asarray(jax.random.gumbel(key, (n,), jnp.float32))
    w = -torch.log(torch.from_numpy(u)).numpy()
    np.testing.assert_array_max_ulp(w, -np.asarray(jnp.log(ju)), maxulp=2)
    np.testing.assert_allclose(g, jg, atol=2e-6, rtol=0)


@pytest.mark.parametrize("timpl", ["xla", "pallas"])
def test_seeded_tokens_match_jax_engine(timpl):
    """Seeded, hot sampling with top-k gives the JAX engine's tokens."""
    cfg, jcfg = _cfgs()
    jparams = random_jax_params(jcfg, seed=5)
    prompts = _prompts()
    hot = [dict(temperature=0.9, top_k=0, seed=7),
           dict(temperature=1.3, top_k=5, seed=2**32 + 9),
           dict(temperature=0.6, top_k=3, seed=None)]

    def reqs(cls):
        return [cls(rid=i, tokens=list(p), max_new=6, **hot[i % 3])
                for i, p in enumerate(prompts)]

    jeng = JServingEngine(jparams, jcfg, JFamousConfig(impl="xla"),
                          n_slots=2, max_seq=64, chunk=8)
    jdone = sorted(jeng.run(reqs(JRequest)), key=lambda r: r.rid)
    eng = ServingEngine(convert.params_from_jax(jparams, cfg, "cpu"), cfg,
                        FamousConfig(impl=timpl), n_slots=2, max_seq=64,
                        chunk=8, device="cpu")
    done = sorted(eng.run(reqs(Request)), key=lambda r: r.rid)
    assert [r.out for r in done] == [r.out for r in jdone]


@pytest.mark.parametrize("kw,exc,needle", [
    (dict(speculative=True, draft_k=0), ValueError,
     "draft_k must be at least 1"),
    (dict(kv_dtype="int8"), ValueError, "int8' requires cache_kind='paged'"),
    (dict(prefix_cache=True), ValueError,
     "prefix_cache requires cache_kind='paged' and chunked"),
])
def test_unported_options_raise(kw, exc, needle):
    """int8 KV and the prefix cache need the paged cache (and the prefix
    cache chunked prefill); a speculative engine needs a draft of at least
    one token (JAX asserts it)."""
    cfg, _ = _cfgs()
    with pytest.raises(exc, match=needle):
        ServingEngine({}, cfg, FamousConfig(), device="cpu", **kw)


def test_engine_without_cuda_raises_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _engine(2, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine({}, _cfgs()[0], FamousConfig())


@pytest.mark.parametrize("call", [
    lambda t: qkv_proj.matmul_tiled(t((4, 8)), t((8, 16))),
    lambda t: qkv_proj.matmul_tiled_int8(
        t((4, 32), torch.int8), t((16, 32), torch.int8), t((4, 1)),
        t((1, 16))),
    lambda t: decode_attn.decode_attention(
        t((2, 4, 16)), t((2, 8, 2, 16)), t((2, 8, 2, 16)),
        torch.zeros(2, dtype=torch.int32, device="meta"), scale=0.25),
    lambda t: decode_attn.decode_attention(
        t((6, 4, 16)), t((2, 8, 2, 16)), t((2, 8, 2, 16)),
        torch.zeros(6, dtype=torch.int32, device="meta"), scale=0.25,
        rows_per_slot=3),
    lambda t: chunk_prefill.chunk_prefill(
        t((1, 4, 4, 16)), t((1, 8, 2, 16)), t((1, 8, 2, 16)), 0, scale=0.25),
    lambda t: decode_attn.paged_decode_attention(
        t((2, 4, 16)), t((9, 4, 2, 16)), t((9, 4, 2, 16)),
        t((2, 2), torch.int32), t((2,), torch.int32), scale=0.25),
    lambda t: decode_attn.paged_decode_attention_int8(
        t((2, 4, 16)), t((9, 4, 2, 16), torch.int8),
        t((9, 4, 2, 16), torch.int8), t((9, 4, 2)), t((9, 4, 2)),
        t((2, 2), torch.int32), t((2,), torch.int32), scale=0.25),
    lambda t: chunk_prefill.paged_chunk_prefill(
        t((1, 4, 4, 16)), t((9, 4, 2, 16)), t((9, 4, 2, 16)),
        t((1, 2), torch.int32), 0, scale=0.25),
    lambda t: chunk_prefill.paged_chunk_prefill_int8(
        t((1, 4, 4, 16)), t((9, 4, 2, 16), torch.int8),
        t((9, 4, 2, 16), torch.int8), t((9, 4, 2)), t((9, 4, 2)),
        t((1, 2), torch.int32), 0, scale=0.25),
])
def test_kernel_wrappers_never_fall_back_off_the_cpu(call):
    """A tensor that is not on the CPU goes to the kernel launch, which
    refuses it here; the plain version is never returned instead."""
    def t(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")
    before = dict(lib.STATS.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        call(t)
    assert lib.STATS.launches == before


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(lib, "NVCC_DEFAULT", str(tmp_path / "nvcc"))
    monkeypatch.setattr(lib, "_LIB", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        lib.load()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        lib.build()


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "assert len(mods) >= 50, mods\n"
        "new = {'repro_torch.kernels.attention.mha', "
        "'repro_torch.kernels.attention.ops', "
        "'repro_torch.kernels.attention.ref', 'repro_torch.train.step', "
        "'repro_torch.train.trainer', 'repro_torch.train.checkpoint', "
        "'repro_torch.train.losses', 'repro_torch.optim.adamw', "
        "'repro_torch.data.pipeline', 'repro_torch.launch.train', "
        "'repro_torch.configs.famous_bert', 'repro_torch.serve.paged', "
        "'repro_torch.core.quant', 'repro_torch.serve.draft', "
        "'repro_torch.kernels.scan.linear_scan', "
        "'repro_torch.kernels.scan.ops', 'repro_torch.kernels.scan.ref', "
        "'repro_torch.models.rglru', 'repro_torch.models.rwkv6', "
        "'repro_torch.configs.recurrentgemma_2b', "
        "'repro_torch.configs.rwkv6_1b6', "
        "'repro_torch.configs.qwen3_32b', 'repro_torch.configs.deepseek_7b', "
        "'repro_torch.configs.command_r_plus_104b', "
        "'repro_torch.parallel.sharding', 'repro_torch.parallel.incontext', "
        "'repro_torch.launch.mesh', 'repro_torch.train.elastic', "
        "'repro_torch.optim.compression', 'repro_torch.launch.dryrun', "
        "'repro_torch.launch.specs', 'repro_torch.roofline.op_cost'}\n"
        "assert new <= set(mods), new - set(mods)\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized(), 'an import started a group'\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # chip_smoke.py imports its modules inside functions: read its source
    smoke = (SRC.parent / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|repro)\b", smoke,
                         re.MULTILINE)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-1.6b"])
def test_recurrent_archs_build_an_engine(arch):
    """Both recurrent families build an engine from the spec tree: per-slot
    rings and recurrent state, no speculation, no prefix sharing."""
    cfg = shrink(get_config(arch))
    params = module.init_params(transformer.model_spec(cfg),
                                torch.Generator().manual_seed(0),
                                torch.float32, "cpu")
    eng = ServingEngine(params, cfg, FamousConfig(impl="pallas"), n_slots=2,
                        max_seq=64, chunk=8, cache_kind="paged",
                        prefix_cache=True, speculative=True, device="cpu")
    assert not eng.speculative_active and not eng.prefix_cache_active
    kinds = transformer.layer_kinds(cfg)
    assert len(eng.caches) == len(kinds) == cfg.num_layers
    for kind, cache in zip(kinds, eng.caches):
        want = {"local_attn": {"k", "v"}, "rglru": {"h", "conv"},
                "rwkv6": {"s", "x_tm", "x_cm"}}[kind]
        assert set(cache) == want
        assert all(buf.shape[0] == 2 for buf in cache.values())


@pytest.mark.parametrize("arch,over", [
    ("qwen2-7b", dict(num_experts=4, experts_per_token=2)),
    ("recurrentgemma-2b", dict(num_experts=4, experts_per_token=2)),
])
def test_moe_still_raises(arch, over):
    """Experts on a dense or hybrid stack build: ``model_spec`` equals
    JAX's leaf for leaf in shape and dtype (the router f32), and an engine
    serves from it."""
    cfg = shrink(get_config(arch), **over)
    spec = transformer.model_spec(cfg)
    jspec = jtransformer.model_spec(jshrink(jget_config(arch), **over))
    leaves = module.tree_leaves(spec)
    jleaves = jax.tree_util.tree_leaves(
        jspec, is_leaf=lambda s: hasattr(s, "shape"))
    assert [s.shape for s in leaves] == [s.shape for s in jleaves]
    assert [s.dtype == torch.float32 for s in leaves] == \
        [s.dtype == jnp.float32 for s in jleaves]
    assert any(s.dtype == torch.float32 for s in leaves)
    params = module.init_params(spec, torch.Generator().manual_seed(0),
                                torch.float32, "cpu")
    eng = ServingEngine(params, cfg, FamousConfig(impl="pallas"), n_slots=2,
                        max_seq=32, chunk=8, device="cpu")
    done = eng.run([Request(rid=0, tokens=[3, 5, 7], max_new=3)])
    assert len(done[0].out) == 3


@pytest.mark.parametrize("arch", ["hubert-xlarge", "famous-bert"])
def test_serve_launcher_refuses_encoder_only_as_jax(arch):
    """``launch.serve`` of an encoder-only config exits with JAX's
    message (it has no decode step), before it asks for a device."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match=f"{arch}-smoke is encoder-only: "
                                         "no decode serving"):
        serve.main(["--arch", arch, "--smoke"])
