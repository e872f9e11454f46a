"""PyTorch port, the bodies of the serving engine's ``"prefill"`` and
``"clear"`` CUDA graphs on the CPU: ``transformer.prefill_chunk`` and
``transformer.clear_slot`` with their runtime scalars as int32 tensors.

* ``prefill_chunk`` with ``slot``, ``offset`` and ``n_valid`` as views of
  one staged (3,) int32 tensor (the engine's form) against
  ``jax.jit(repro.models.transformer.prefill_chunk)`` with traced
  scalars, on five shrunk configurations: qwen2-7b on contiguous stripes,
  on a paged fp pool, and on a paged int8 pool whose second slot starts
  at a prefix-cache offset that is not a multiple of the chunk;
  recurrentgemma-2b with a 32-token chunk over its 16-row ring; rwkv6-1.6b.
  Every cache starts dirty (random), and the chunks include ``offset ==
  0`` on a dirty slot and ``n_valid == 1``.  Every cache leaf after the
  sequence at 1e-5 (f32), both port impls.
* ``clear_slot`` with a tensor slot against JAX's jitted one.
* No host read: the chunk body and ``clear_slot`` run on scalars whose
  ``__index__``, ``__int__``, ``__bool__``, ``item`` and ``tolist`` raise
  (the stubbed graph of ``test_torch_graphs.py`` re-runs the body on every
  replay, so it would hide a value frozen at capture), in the functions
  and in the engine's staged buffers.
* The engine's ``"clear"`` graph (length-1 prompts on a recurrent stack)
  captured once through the stubbed capture, tokens equal to eager.
* The ring writes' source rule against JAX's ``mode="drop"`` scatter for
  every (offset, n_valid) of chunks longer and shorter than the ring.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_graphs import stub_graphs  # noqa: F401  (a fixture)
from torch_port_helpers import random_jax_params, tokens
from repro.configs.base import get_config as jget_config
from repro.configs.base import shrink as jshrink
from repro.core.famous import FamousConfig as JFamousConfig
from repro.models import transformer as jtransformer
from repro_torch import convert
from repro_torch.configs.base import get_config, shrink
from repro_torch.core.famous import FamousConfig
from repro_torch.models import attention, transformer
from repro_torch.serve import graphs
from repro_torch.serve.engine import Request, ServingEngine

TOL = 1e-5
IMPLS = ("xla", "pallas")
N_SLOTS = 3

# name -> (arch, chunk, max_seq, cache kwargs, [(slot, offset, n_valid)]);
# paged tables: every slot's pages private except slot 1's first three,
# which alias slot 0's (a prefix-cache hit of 12 tokens)
CONFIGS = {
    "qwen2-7b contiguous": ("qwen2-7b", 8, 64, {}, [
        (2, 0, 8), (2, 8, 5), (0, 0, 1), (1, 0, 8), (1, 8, 8), (1, 16, 3),
        (2, 0, 6)]),
    "qwen2-7b paged fp": ("qwen2-7b", 8, 64, dict(
        cache_kind="paged", page_size=4), [
        (0, 0, 8), (0, 8, 8), (0, 16, 7), (2, 0, 1), (1, 12, 8),
        (1, 20, 8), (1, 28, 1)]),
    "qwen2-7b paged int8 prefix": ("qwen2-7b", 8, 64, dict(
        cache_kind="paged", page_size=4, kv_dtype="int8"), [
        (0, 0, 8), (0, 8, 8), (0, 16, 7), (1, 12, 8), (1, 20, 8),
        (1, 28, 1), (2, 0, 3)]),
    "recurrentgemma-2b chunk 32": ("recurrentgemma-2b", 32, 128, {}, [
        (1, 0, 32), (1, 32, 32), (1, 64, 7), (0, 0, 1), (2, 0, 32),
        (2, 32, 20), (0, 0, 17)]),
    "rwkv6-1.6b": ("rwkv6-1.6b", 8, 64, {}, [
        (2, 0, 8), (2, 8, 5), (0, 0, 1), (1, 0, 8), (1, 8, 8), (1, 16, 3),
        (2, 0, 6)]),
}


@functools.lru_cache(maxsize=None)
def _model(arch):
    cfg, jcfg = shrink(get_config(arch)), jshrink(jget_config(arch))
    jp = random_jax_params(jcfg, seed=11)
    return cfg, jcfg, jp, convert.params_from_jax(jp, cfg, "cpu")


def _page_table(max_seq, ps):
    n_p = max_seq // ps
    ids = iter(range(1, 1 + 3 * n_p))
    pt = np.zeros((N_SLOTS, n_p), np.int32)
    for s in range(N_SLOTS):
        for j in range(n_p):
            pt[s, j] = pt[0, j] if (s == 1 and j < 3) else next(ids)
    return pt, 1 + int(pt.max())


def _dirty_caches(jcfg, max_seq, kw, rng):
    """JAX caches of ``N_SLOTS`` slots filled from numpy (int8 pools with
    int8 values, scales positive), and the page table for paged ones."""
    pt = None
    extra = {}
    if kw.get("cache_kind") == "paged":
        pt, n_pages = _page_table(max_seq, kw["page_size"])
        extra = dict(n_pages=n_pages)
    jc = jtransformer.make_caches(jcfg, N_SLOTS, max_seq, jnp.float32,
                                  **kw, **extra)

    def fill(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        if a.dtype == jnp.int8:
            return jnp.asarray(rng.integers(-127, 128, a.shape), jnp.int8)
        x = rng.standard_normal(a.shape).astype(np.float32)
        return jnp.asarray(np.abs(x) * 0.02 if name.endswith("scale") else x)

    return jax.tree_util.tree_map_with_path(fill, jc), pt


def _staged(slot, offset, n_valid):
    """The engine's form: views of one staged (3,) int32 tensor."""
    sc = torch.tensor([slot, offset, n_valid], dtype=torch.int32)
    return sc[0:1], sc[1:2], sc[2:3]


def _assert_caches(caches, jcaches, cfg):
    back = convert.caches_from_jax(jcaches, cfg, "cpu")
    for i, (mine, theirs) in enumerate(zip(caches, back)):
        assert set(mine) == set(theirs)
        for name in mine:
            np.testing.assert_allclose(
                mine[name].numpy(), theirs[name].numpy(), atol=TOL, rtol=TOL,
                err_msg=f"layer {i} {name}")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", list(CONFIGS))
def test_tensor_scalar_prefill_chunk_matches_jitted_jax(case, impl):
    arch, C, max_seq, kw, triples = CONFIGS[case]
    cfg, jcfg, jp, params = _model(arch)
    rng = np.random.default_rng(len(case))
    jcaches, pt = _dirty_caches(jcfg, max_seq, kw, rng)
    caches = convert.caches_from_jax(jcaches, cfg, "cpu")
    jfn = jax.jit(functools.partial(
        jtransformer.prefill_chunk, cfg=jcfg, fcfg=JFamousConfig(impl="xla")))
    jkw = {} if pt is None else {"page_table": jnp.asarray(pt)}
    tkw = {} if pt is None else {"page_table": torch.from_numpy(pt)}
    prompt = tokens(rng, cfg.vocab_size, max_seq)
    for slot, offset, n in triples:
        toks = np.zeros((1, C), np.int32)
        toks[0, :n] = prompt[offset:offset + n]
        jcaches = jfn(jp, jnp.asarray(toks), jcaches, jnp.int32(slot),
                      jnp.int32(offset), jnp.int32(n), **jkw)
        out = transformer.prefill_chunk(
            params, torch.from_numpy(toks).long(), caches,
            *_staged(slot, offset, n), cfg, FamousConfig(impl=impl), **tkw)
        assert out is caches
    assert jfn._cache_size() == 1         # one executable for every triple
    _assert_caches(caches, jcaches, cfg)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ["qwen2-7b", "recurrentgemma-2b",
                                  "rwkv6-1.6b"])
def test_tensor_slot_clear_matches_jitted_jax(arch, paged):
    cfg, jcfg, _, _ = _model(arch)
    kw = dict(cache_kind="paged", page_size=4) if paged else {}
    jcaches, _ = _dirty_caches(jcfg, 32, kw, np.random.default_rng(3))
    caches = convert.caches_from_jax(jcaches, cfg, "cpu")
    jclear = jax.jit(functools.partial(jtransformer.clear_slot, cfg=jcfg,
                                       paged=paged))
    for slot in (1, 0, 2):
        jcaches = jclear(jcaches, jnp.int32(slot))
        transformer.clear_slot(caches, torch.tensor([slot], dtype=torch.int32),
                               cfg, paged=paged)
    assert jclear._cache_size() == 1
    _assert_caches(caches, jcaches, cfg)


# ---------------------------------------------------------------------------
# no host read of a runtime scalar
# ---------------------------------------------------------------------------

class HostReadError(AssertionError):
    pass


class NoHostRead(torch.Tensor):
    """A tensor whose value the host may not read: what a captured graph
    would freeze.  Results of torch ops on it stay of this class."""

    @staticmethod
    def __new__(cls, t):
        return torch.Tensor._make_subclass(cls, t)

    def _read(self, *args, **kwargs):
        raise HostReadError("a runtime scalar was read on the host")

    __index__ = __int__ = __bool__ = __float__ = _read
    item = tolist = numpy = __array__ = _read


def _guarded(*values):
    return [NoHostRead(t) for t in _staged(*values)]


def test_no_host_read_bites():
    """The guard catches the reads a graph would freeze: a slice bound, a
    Python branch, ``int()``."""
    slot, offset, _ = _guarded(1, 8, 3)
    x = torch.zeros(4, 16)
    with pytest.raises(HostReadError):
        x[0, offset:offset + 4]
    with pytest.raises(HostReadError):
        if offset > 0:
            pass
    with pytest.raises(HostReadError):
        int(slot)
    assert x.index_select(0, slot).shape == (1, 16)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", list(CONFIGS))
def test_prefill_chunk_and_clear_read_no_scalar_on_the_host(case, impl):
    arch, C, max_seq, kw, triples = CONFIGS[case]
    cfg, jcfg, _, params = _model(arch)
    rng = np.random.default_rng(5)
    jcaches, pt = _dirty_caches(jcfg, max_seq, kw, rng)
    caches = convert.caches_from_jax(jcaches, cfg, "cpu")
    tkw = {} if pt is None else {"page_table": torch.from_numpy(pt)}
    toks = torch.from_numpy(np.asarray([tokens(rng, cfg.vocab_size, C)]))
    for slot, offset, n in triples[:3]:
        transformer.prefill_chunk(params, toks, caches,
                                  *_guarded(slot, offset, n), cfg,
                                  FamousConfig(impl=impl), **tkw)
    transformer.clear_slot(caches, _guarded(2, 0, 1)[0], cfg,
                           paged=pt is not None)


@pytest.mark.parametrize("case", ["qwen2-7b paged int8 prefix",
                                  "recurrentgemma-2b chunk 32"])
def test_engine_stages_scalars_the_host_never_reads(stub_graphs, case):
    """The engine's staged chunk and clear buffers replaced by guarded
    tensors: a whole served batch through the stubbed graphs reads none of
    them on the host (``put`` writes them by ``copy_``)."""
    arch, C, _, kw, _ = CONFIGS[case]
    cfg, _, _, params = _model(arch)
    kw = {k: v for k, v in kw.items() if k != "kv_dtype"} | (
        {"kv_dtype": kw["kv_dtype"], "prefix_cache": True}
        if "kv_dtype" in kw else {})
    eng = ServingEngine(params, cfg, FamousConfig(impl="pallas"), n_slots=2,
                        max_seq=128, chunk=C, device="cpu", **kw)
    for name in ("chunk_scalars", "clear_slot"):
        eng._in[name].tensor = NoHostRead(eng._in[name].tensor)
    rng = np.random.default_rng(2)
    head = tokens(rng, cfg.vocab_size, 12)
    prompts = [head + tokens(rng, cfg.vocab_size, n) for n in (30, 9, 45)]
    prompts += [tokens(rng, cfg.vocab_size, 1)] * 2
    done = eng.run([Request(rid=i, tokens=p, max_new=4)
                    for i, p in enumerate(prompts)])
    assert all(r.error is None and len(r.out) == 4 for r in done)
    assert eng.compilations["prefill"] == 1
    assert eng.graph_stats["replays"]["prefill"] > 0


def test_clear_graph_captured_once(stub_graphs):
    """Length-1 prompts skip prefill and clear their slot's rings and
    recurrent state through the ``"clear"`` graph: captured once, replayed
    for later slots, tokens equal to eager."""
    cfg, _, _, params = _model("recurrentgemma-2b")
    rng = np.random.default_rng(9)
    prompts = [tokens(rng, cfg.vocab_size, n) for n in (20, 1, 1, 13, 1, 1)]

    def serve():
        eng = ServingEngine(params, cfg, FamousConfig(impl="pallas"),
                            n_slots=2, max_seq=64, chunk=8, device="cpu")
        done = sorted(eng.run([Request(rid=i, tokens=p, max_new=5)
                               for i, p in enumerate(prompts)]),
                      key=lambda r: r.rid)
        return [r.out for r in done], eng

    with graphs.disable_capture():
        eager, _ = serve()
    graphed, eng = serve()
    assert graphed == eager
    assert eng.compilations == {"prefill": 1, "decode": 1, "verify": 0,
                                "clear": 1}
    assert eng.graph_stats["replays"]["clear"] == 3


# ---------------------------------------------------------------------------
# the ring's fixed-shape write rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ring,C", [(16, 32), (16, 8), (5, 16), (4, 4)])
def test_ring_write_source_matches_jax_drop_writes(ring, C):
    """For every (offset, n_valid): the row each chunk position lands in
    under JAX's rule (write the last ``min(n_valid, ring)`` real positions
    at ``position % ring``, drop the rest) equals the fixed-shape rule's
    source, and the rows it leaves are exactly those no position writes."""
    for offset in range(0, 3 * ring + 2):
        for n in range(1, C + 1):
            c = np.arange(C)
            ok = (c < n) & (c >= n - ring)
            want = {int((offset + i) % ring): int(i) for i in c[ok]}
            src, written = attention.ring_write_source(
                ring, torch.tensor([offset], dtype=torch.int32),
                torch.tensor([n], dtype=torch.int32), C)
            got = {r: int(src[r]) for r in range(ring) if written[r]}
            assert got == want, (offset, n)
