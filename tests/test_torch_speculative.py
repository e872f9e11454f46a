"""PyTorch port, speculative decoding: the copied prompt-lookup drafter,
``verify_step`` against the JAX package's and against sequential
``decode_step`` calls (contiguous, paged, int8 pools; xla and pallas
impls), writes past ``max_seq`` dropped and not clamped, a randomized
harness that holds the port's speculative engine token for token to the
JAX speculative engine, and the rollback cases of the JAX suite (a draft
rejected at a page boundary, fully rejected drafts, an oracle drafter,
preemption mid-speculation, a poisoned drafter).

The JAX side runs ``impl="xla"`` (its Pallas kernels in interpret mode
are too slow for the harness); the port runs both impls, its kernels'
plain versions on the CPU.  Logits: 1e-4 against JAX, 3e-5 + 1e-5
relative against the port's own sequential decode (the tolerance of the
JAX suite's verify-vs-decode test)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import random_jax_params
from repro.configs.base import get_config as jget_config
from repro.configs.base import shrink as jshrink
from repro.core.famous import FamousConfig as JFamousConfig
from repro.models import transformer as jtransformer
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JServingEngine
from repro.serve.paged import PagedCacheConfig
from repro_torch import convert
from repro_torch.configs.base import LOCAL_ATTN, get_config, shrink
from repro_torch.core.famous import FamousConfig
from repro_torch.models import transformer
from repro_torch.serve.draft import PromptLookupDrafter
from repro_torch.serve.engine import Request, ServingEngine

CFG, JCFG = shrink(get_config("qwen2-7b")), jshrink(jget_config("qwen2-7b"))
V = CFG.vocab_size
MAX_SEQ = 32
CHUNK = 8


@functools.lru_cache(maxsize=None)
def _jparams():
    return random_jax_params(JCFG, seed=21)


@functools.lru_cache(maxsize=None)
def _params():
    return convert.params_from_jax(_jparams(), CFG, "cpu")


def _serve(reqs, jax=False, **kw):
    """Serve ``reqs`` (dicts of Request fields) on the port's engine, or on
    the JAX engine (``impl="xla"``) with ``jax=True``."""
    if jax:
        kw.pop("fcfg", None)
        eng = JServingEngine(_jparams(), JCFG, JFamousConfig(impl="xla"),
                             n_slots=kw.pop("n_slots", 2), max_seq=MAX_SEQ,
                             chunk=CHUNK, **kw)
        cls = JRequest
    else:
        eng = ServingEngine(_params(), CFG,
                            kw.pop("fcfg", FamousConfig(impl="xla")),
                            n_slots=kw.pop("n_slots", 2), max_seq=MAX_SEQ,
                            chunk=CHUNK, device="cpu", **kw)
        cls = Request
    done = sorted(eng.run([cls(**dict(r)) for r in reqs]),
                  key=lambda r: r.rid)
    return done, eng


# ---------------------------------------------------------------------------
# drafter (a copy of the JAX package's; the JAX suite's unit tests)
# ---------------------------------------------------------------------------


def test_drafter_empty_cases():
    d = PromptLookupDrafter()
    assert d.draft([1, 2, 3], 0) == []
    assert d.draft([1], 4) == []
    assert d.draft([], 4) == []
    assert d.draft([1, 2, 3, 4], 4) == []


def test_drafter_finds_longest_ngram():
    d = PromptLookupDrafter(max_ngram=3)
    assert d.draft([1, 2, 3, 9, 1, 2, 3], 2) == [9, 1]


def test_drafter_prefers_most_recent_match():
    d = PromptLookupDrafter(max_ngram=2)
    assert d.draft([5, 1, 2, 7, 1, 2, 8, 1, 2], 3) == [8, 1, 2]


def test_drafter_falls_back_to_shorter_ngram():
    d = PromptLookupDrafter(max_ngram=3, min_ngram=1)
    assert d.draft([4, 6, 4, 7, 9, 4], 1) == [7]


def test_drafter_truncates_at_sequence_end():
    d = PromptLookupDrafter(max_ngram=2)
    assert d.draft([1, 2, 9, 1, 2], 4) == [9, 1, 2]


# ---------------------------------------------------------------------------
# verify_step: against JAX, and against sequential decode
# ---------------------------------------------------------------------------

PS = 8


def _jax_caches(kind, batch):
    n_p = MAX_SEQ // PS
    if kind == "contiguous":
        return jtransformer.make_caches(JCFG, batch, MAX_SEQ, jnp.float32), {}
    caches = jtransformer.make_caches(
        JCFG, batch, MAX_SEQ, jnp.float32, cache_kind="paged", page_size=PS,
        n_pages=batch * n_p + 1,
        kv_dtype="int8" if kind == "paged_int8" else "fp")
    # slot b owns pages 1 + b*n_p .. (b+1)*n_p, in reverse order
    pt = np.stack([1 + b * n_p + np.arange(n_p)[::-1] for b in range(batch)])
    return caches, {"page_table": jnp.asarray(pt, jnp.int32)}


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("kind", ["contiguous", "paged", "paged_int8"])
def test_verify_step_matches_jax_and_sequential_decode(kind, impl):
    """Two slots at different lengths: decode a prefix on the JAX model,
    carry the caches over, then verify W tokens on both packages.  The
    port's logits and caches must equal JAX's, and its logits those of W
    sequential port ``decode_step`` calls from the same state (causal
    attention makes them identical; int8 pools quantize the same values
    on both paths)."""
    rng = np.random.default_rng(1)
    B, W = 2, 4
    L = (5, 9)
    jfcfg = JFamousConfig(impl="xla")
    jcaches, jkw = _jax_caches(kind, B)
    seq = rng.integers(0, V, size=(B, max(L) + W))
    for t in range(max(L)):
        # slot b decodes its tokens up to L[b]; past it, it idles
        lens = np.minimum(t, L)
        _, jcaches = jtransformer.decode_step(
            _jparams(), jnp.asarray(seq[:, t], jnp.int32), jcaches,
            jnp.asarray(lens, jnp.int32), JCFG, jfcfg,
            active=jnp.asarray([t < L[0], t < L[1]]), **jkw)
    vtok = np.stack([seq[b, L[b]:L[b] + W] for b in range(B)])
    jlogits, jafter = jtransformer.verify_step(
        _jparams(), jnp.asarray(vtok, jnp.int32), jcaches,
        jnp.asarray(L, jnp.int32), JCFG, jfcfg, **jkw)
    caches = convert.caches_from_jax(jcaches, CFG, "cpu")
    kw = {k: convert.to_torch(np.asarray(v), "cpu") for k, v in jkw.items()}
    fcfg = FamousConfig(impl=impl)
    logits, after = transformer.verify_step(
        _params(), torch.from_numpy(vtok), caches,
        torch.tensor(L, dtype=torch.int32), CFG, fcfg, **kw)
    assert logits.shape == (B, W, V)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-5)
    for mine, theirs in zip(after, convert.caches_from_jax(jafter, CFG,
                                                           "cpu")):
        for name in theirs:
            np.testing.assert_allclose(mine[name].float().numpy(),
                                       theirs[name].float().numpy(),
                                       atol=1e-5, rtol=1e-5)
    # the same state, decoded one token at a time
    seq_caches = convert.caches_from_jax(jcaches, CFG, "cpu")
    for j in range(W):
        lg, seq_caches = transformer.decode_step(
            _params(), torch.from_numpy(vtok[:, j]), seq_caches,
            torch.tensor([L[0] + j, L[1] + j], dtype=torch.int32), CFG, fcfg,
            **kw)
        np.testing.assert_allclose(logits[:, j].numpy(), lg.numpy(),
                                   atol=3e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("kind", ["contiguous", "paged", "paged_int8"])
def test_verify_attention_matches_jax_kernel(kind, impl):
    """``famous.(paged_)verify_attention`` against JAX's with impl="pallas"
    (its decode kernels in interpret mode, rows flattened as in its
    wrapper): lengths 0, mid and at the cache's end, so pad rows clip."""
    from repro.core import famous as jfamous
    from repro.core import quant as jquant
    from repro_torch.core import famous as tfamous
    rng = np.random.default_rng(7)
    B, W, H, KV, dh = 3, 4, 4, 2, 16
    q = rng.standard_normal((B, W, H, dh)).astype(np.float32)
    cl = np.array([0, 13, MAX_SEQ - 2], np.int32)
    jcfg = JFamousConfig(impl="pallas")
    tcfg = FamousConfig(impl=impl)
    tq, tcl = torch.from_numpy(q), torch.from_numpy(cl)
    if kind == "contiguous":
        k, v = (rng.standard_normal((B, MAX_SEQ, KV, dh)).astype(np.float32)
                for _ in range(2))
        want = jfamous.verify_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), jnp.asarray(cl),
                                        cfg=jcfg)
        got = tfamous.verify_attention(tq, torch.from_numpy(k),
                                       torch.from_numpy(v), tcl, cfg=tcfg)
    else:
        n_p = MAX_SEQ // PS
        n_pages = 1 + B * n_p
        k, v = (rng.standard_normal((n_pages, PS, KV, dh)).astype(np.float32)
                for _ in range(2))
        pt = (1 + rng.permutation(B * n_p)).reshape(B, n_p).astype(np.int32)
        jk, jv, kw, tkw = jnp.asarray(k), jnp.asarray(v), {}, {}
        if kind == "paged_int8":
            (jk, ks), (jv, vs) = (jquant.quantize(a, axis=-1)
                                  for a in (jk, jv))
            kw = dict(k_scale=ks[..., 0], v_scale=vs[..., 0])
            tkw = {n: convert.to_torch(np.asarray(a), "cpu")
                   for n, a in kw.items()}
        want = jfamous.paged_verify_attention(
            jnp.asarray(q), jk, jv, jnp.asarray(pt), jnp.asarray(cl),
            cfg=jcfg, **kw)
        got = tfamous.paged_verify_attention(
            tq, convert.to_torch(np.asarray(jk), "cpu"),
            convert.to_torch(np.asarray(jv), "cpu"), torch.from_numpy(pt),
            tcl, cfg=tcfg, **tkw)
    assert got.shape == (B, W, H, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_verify_past_max_seq_drops_writes():
    """A slot two tokens short of ``max_seq`` verifies W = 4 tokens: the
    two past the end are dropped, as JAX's ``mode="drop"`` drops them.
    A clamped write would put token 3's K/V over token 1's at the last
    row; the port's cache must equal JAX's there."""
    rng = np.random.default_rng(2)
    W = 4
    jcaches, _ = _jax_caches("contiguous", 1)
    jcaches = jax_fill(jcaches, rng)
    L = MAX_SEQ - 2
    vtok = rng.integers(0, V, size=(1, W))
    jfcfg = JFamousConfig(impl="xla")
    _, jafter = jtransformer.verify_step(
        _jparams(), jnp.asarray(vtok, jnp.int32), jcaches,
        jnp.asarray([L], jnp.int32), JCFG, jfcfg)
    caches = convert.caches_from_jax(jcaches, CFG, "cpu")
    before = [{k: v.clone() for k, v in c.items()} for c in caches]
    for impl in ("xla", "pallas"):
        caches = [{k: v.clone() for k, v in c.items()} for c in before]
        _, after = transformer.verify_step(
            _params(), torch.from_numpy(vtok), caches,
            torch.tensor([L], dtype=torch.int32), CFG, FamousConfig(impl=impl))
        want = convert.caches_from_jax(jafter, CFG, "cpu")
        for mine, theirs, old in zip(after, want, before):
            for name in ("k", "v"):
                assert torch.equal(mine[name][:, :L], old[name][:, :L])
                np.testing.assert_allclose(mine[name].numpy(),
                                           theirs[name].numpy(), atol=1e-5,
                                           rtol=1e-5)
                assert not torch.equal(mine[name][0, L + 1],
                                       old[name][0, L + 1])


def jax_fill(caches, rng):
    """A contiguous JAX cache tree filled with numpy noise."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype), caches)


def test_verify_step_rejects_non_attention_stacks():
    """Only global-attention stacks verify, as in JAX: a config with
    another block kind is refused before anything runs."""
    bad = dataclasses.replace(CFG, pattern_unit=(LOCAL_ATTN,))
    with pytest.raises(ValueError, match="global-attention"):
        transformer.verify_step({}, torch.zeros((1, 2), dtype=torch.long),
                                [], torch.zeros(1, dtype=torch.int32), bad)


# ---------------------------------------------------------------------------
# the randomized harness: the port's speculative engine == JAX's
# ---------------------------------------------------------------------------

N_MIXES = 16


def _random_mix(mix_seed):
    """One serving scenario for the qwen2-7b smoke config (the only stack
    the port serves): engine kwargs and requests, drawn as in the JAX
    suite's harness."""
    rng = np.random.default_rng(20_000 + mix_seed)
    kw = {"fcfg": FamousConfig(impl="pallas" if rng.random() < 0.5
                               else "xla"),
          "n_slots": int(rng.integers(2, 4)),
          "draft_k": int(rng.integers(1, 6))}
    if rng.random() < 0.5:
        ps = int(rng.choice([4, 8]))
        kw.update(cache_kind="paged", page_size=ps)
        if rng.random() < 0.4:
            kw["n_pages"] = (PagedCacheConfig(page_size=ps, n_pages=2)
                             .pages_for(MAX_SEQ) + 1 + int(rng.integers(0, 3)))
        if rng.random() < 0.5:
            kw["prefix_cache"] = True
        if rng.random() < 0.3:
            kw["kv_dtype"] = "int8"
    reqs = []
    shared = [int(t) for t in rng.integers(0, V, 11)]
    for i in range(int(rng.integers(3, 6))):
        max_new = int(rng.integers(3, 9))
        n = int(rng.integers(1, MAX_SEQ - max_new + 1))
        if rng.random() < 0.5:
            motif = [int(t) for t in rng.integers(0, V, 3)]
            prompt = (motif * MAX_SEQ)[:n]
        elif rng.random() < 0.5:
            prompt = (shared + [int(t) for t in
                                rng.integers(0, V, MAX_SEQ)])[:n]
        else:
            prompt = [int(t) for t in rng.integers(0, V, n)]
        greedy = rng.random() < 0.6
        reqs.append(dict(rid=i, tokens=prompt, max_new=max_new,
                         temperature=0.0 if greedy else
                         float(rng.uniform(0.5, 1.0)),
                         top_k=int(rng.choice([0, 4, 8])),
                         seed=int(rng.integers(0, 2**31))))
    return kw, reqs


@pytest.mark.parametrize("mix_seed", range(N_MIXES))
def test_speculative_engine_matches_jax_random_mix(mix_seed):
    """Token for token equal to the JAX speculative engine on the same mix
    (itself held to JAX's plain engine by the JAX suite), with the same
    drafted and accepted counts, nothing dropped or errored, and the page
    allocator's invariants intact."""
    kw, reqs = _random_mix(mix_seed)
    jdone, jeng = _serve(reqs, jax=True, speculative=True, **dict(kw))
    done, eng = _serve(reqs, speculative=True, **dict(kw))
    assert eng.speculative_active
    assert len(done) == len(reqs)
    assert all(r.error is None and r.done for r in done), \
        [(r.rid, r.error) for r in done]
    assert [r.out for r in done] == [r.out for r in jdone], kw
    assert (eng.spec_steps, eng.spec_drafted, eng.spec_accepted) == \
        (jeng.spec_steps, jeng.spec_drafted, jeng.spec_accepted)
    if kw.get("cache_kind") == "paged":
        eng.alloc.assert_invariants()
        assert eng.alloc.free_pages == jeng.alloc.free_pages


# ---------------------------------------------------------------------------
# rollback edge cases (scripted drafters make the accept length exact)
# ---------------------------------------------------------------------------


class ScriptedDrafter:
    """Drafts ``(ref_out[pos + j] + delta) % vocab``: delta=0 is an oracle
    (every draft token accepted), any other delta has the first draft
    token rejected."""

    def __init__(self, prompt_len, ref_out, vocab, delta=0):
        self.prompt_len, self.ref, self.vocab, self.delta = \
            prompt_len, list(ref_out), vocab, delta

    def draft(self, seq, k):
        pos = len(seq) - self.prompt_len
        return [(t + self.delta) % self.vocab
                for t in self.ref[pos:pos + k]]


class PoisonDrafter(PromptLookupDrafter):
    """Raises for one prompt; drafts normally for everyone else."""

    def __init__(self, poison_prefix):
        super().__init__()
        self.poison = list(poison_prefix)

    def draft(self, seq, k):
        if seq[:len(self.poison)] == self.poison:
            raise RuntimeError("poisoned request")
        return super().draft(seq, k)


def _ref_out(prompt, max_new, **kw):
    """Plain-decode tokens from the JAX engine; the port's plain engine
    must agree."""
    reqs = [dict(rid=0, tokens=list(prompt), max_new=max_new)]
    jdone, _ = _serve(reqs, jax=True, **dict(kw))
    done, _ = _serve(reqs, **dict(kw))
    assert done[0].error is None and done[0].out == jdone[0].out
    return done[0].out


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
def test_rejected_draft_at_page_boundary_frees_pages(kv_dtype):
    """A fully rejected draft that grew the slot across a page boundary
    gives the page back: held pages track ``cache_len`` after every step
    and the pool is whole after retirement (int8: the scale rows share the
    page ids)."""
    rng = np.random.default_rng(3)
    prompt = [int(t) for t in rng.integers(0, V, 6)]
    kw = dict(cache_kind="paged", page_size=4, kv_dtype=kv_dtype)
    ref = _ref_out(prompt, 12, **kw)
    eng = ServingEngine(_params(), CFG, FamousConfig(impl="pallas"),
                        n_slots=2, max_seq=MAX_SEQ, chunk=CHUNK,
                        speculative=True, draft_k=5, device="cpu",
                        drafter=ScriptedDrafter(len(prompt), ref, V, 1), **kw)
    req = Request(rid=0, tokens=list(prompt), max_new=12)
    eng.sched.enqueue(req)
    eng.add_request(eng.sched.pop_queued())
    while not req.done:
        eng.step()
        eng.alloc.assert_invariants()
        if not req.done:
            assert eng.alloc.pages_held(0) == \
                eng.pcfg.pages_for(int(eng.cache_len[0]))
    assert req.error is None and req.out == ref
    assert eng.spec_accepted == 0
    assert eng.alloc.free_pages == eng.pcfg.n_pages - 1


def test_fully_rejected_drafts_emit_exactly_one_token_per_step():
    rng = np.random.default_rng(4)
    prompt = [int(t) for t in rng.integers(0, V, 5)]
    ref = _ref_out(prompt, 8)
    done, eng = _serve([dict(rid=0, tokens=prompt, max_new=8)],
                       speculative=True, draft_k=3,
                       drafter=ScriptedDrafter(len(prompt), ref, V, 7))
    assert done[0].out == ref
    assert eng.spec_accepted == 0 and eng.spec_drafted > 0
    assert eng.spec_steps == len(ref)
    assert eng.acceptance_rate == 0.0 and eng.accepted_per_step == 1.0


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_oracle_drafter_hits_max_new_exactly(impl):
    """Every draft accepted: the request ends with exactly ``max_new``
    tokens (the draft cap trims the last step), in two verify steps."""
    rng = np.random.default_rng(5)
    prompt = [int(t) for t in rng.integers(0, V, 5)]
    max_new = 7
    ref = _ref_out(prompt, max_new)
    done, eng = _serve([dict(rid=0, tokens=prompt, max_new=max_new)],
                       fcfg=FamousConfig(impl=impl), speculative=True,
                       draft_k=3,
                       drafter=ScriptedDrafter(len(prompt), ref, V, 0))
    assert done[0].out == ref and len(done[0].out) == max_new
    assert eng.spec_steps == 2
    assert eng.spec_accepted == max_new - eng.spec_steps
    assert eng.acceptance_rate == 1.0


def test_preemption_mid_speculation_matches_jax():
    """A pool too small for every slot preempts while drafts are in
    flight; the port's tokens and preemptions equal the JAX engine's, and
    equal plain decode's."""
    rng = np.random.default_rng(6)
    prompts = [[int(t) for t in rng.integers(0, V, 14 + 5 * i)]
               for i in range(3)]
    reqs = [dict(rid=i, tokens=p, max_new=8) for i, p in enumerate(prompts)]
    kw = dict(cache_kind="paged", page_size=4,
              n_pages=PagedCacheConfig(page_size=4, n_pages=2)
              .pages_for(MAX_SEQ) + 2)
    plain, _ = _serve(reqs, **dict(kw))
    jdone, jeng = _serve(reqs, jax=True, speculative=True, draft_k=4,
                         **dict(kw))
    done, eng = _serve(reqs, fcfg=FamousConfig(impl="pallas"),
                       speculative=True, draft_k=4, **dict(kw))
    assert all(r.error is None for r in done)
    assert [r.out for r in done] == [r.out for r in jdone] == \
        [r.out for r in plain]
    preempts = [sum(st.get("preemptions", 0) for st in e.sched.stats.values())
                for e in (eng, jeng)]
    assert preempts[0] == preempts[1] >= 1
    eng.alloc.assert_invariants()


def test_poisoned_drafter_fails_alone():
    """The request whose drafting raises comes back with ``req.error``;
    the others finish with plain decode's tokens."""
    rng = np.random.default_rng(8)
    prompts = [[int(t) for t in rng.integers(0, V, 6 + 2 * i)]
               for i in range(3)]
    reqs = [dict(rid=i, tokens=p, max_new=6) for i, p in enumerate(prompts)]
    ref, _ = _serve(reqs)
    for kind in ({}, dict(cache_kind="paged", page_size=4)):
        spec, eng = _serve(reqs, speculative=True,
                           drafter=PoisonDrafter(prompts[1]), **kind)
        assert spec[1].error is not None and "poisoned" in spec[1].error
        for i in (0, 2):
            assert spec[i].error is None and spec[i].out == ref[i].out
        if kind:
            eng.alloc.assert_invariants()
            assert eng.alloc.free_pages == eng.pcfg.n_pages - 1
