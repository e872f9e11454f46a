"""PyTorch port, kimi-k2-instruct (DeepSeek-V3's block) against the plain
reference ``perfbench/reference/kimi_k2.py`` at a tiny size of the same
structure: d 256, 4 heads, q rank 64, kv rank 32, heads of 16 + 8 for the
scores and 16 for the values, YaRN on; a dense first layer and two MoE
layers of 32 routed experts, top-8 by sigmoid score plus the correction
bias, 8 of them held, one shared expert.  Float32 on the CPU.

* chunked prefill then decode through the engine's latent cache against
  the reference's full forward pass, logits and served tokens;
* the absorbed decode against the expanded equations;
* the expert share: the routed parts of the 4 shares [0, 8) .. [24, 32)
  plus the shared expert once equal the uncut layer;
* the routing counters: nothing dropped, the held choices the
  reference's count;
* ``mla_decode``'s plain mirror of the kernel's tile algebra against the
  absorbed decode (and the kernel against the mirror where CUDA exists);
* the paths latent attention does not take raise their errors;
* the registry's ``kimi-k2-instruct`` at the catalog's 1.04T-A32B.
"""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import weights  # noqa: E402
from perfbench.reference import check, kimi_k2  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.famous import FamousConfig  # noqa: E402
from repro_torch.kernels import lib  # noqa: E402
from repro_torch.kernels.decode import mla_decode as mla_ops  # noqa: E402
from repro_torch.kernels.decode import ref as dec_ref  # noqa: E402
from repro_torch.models import attention, module, moe, transformer  # noqa: E402,E501
from repro_torch.obs.runtime import Observer  # noqa: E402
from repro_torch.serve.engine import Request, ServingEngine  # noqa: E402

# the release's config.json keys, shrunk (perfbench/configs/
# kimi-k2-instruct-8L.json's model with these sizes)
M = {"num_hidden_layers": 3, "hidden_size": 256, "num_attention_heads": 4,
     "num_key_value_heads": 4, "q_lora_rank": 64, "kv_lora_rank": 32,
     "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
     "intermediate_size": 384, "moe_intermediate_size": 64,
     "first_k_dense_replace": 1, "n_shared_experts": 1,
     "n_routed_experts": 8, "router_experts": 32, "expert_lo": 0,
     "num_experts_per_tok": 8, "vocab_size": 512, "rms_norm_eps": 1e-6,
     "rope_theta": 50000, "routed_scaling_factor": 2.827,
     "rope_scaling": {"beta_fast": 1, "beta_slow": 1, "factor": 32,
                      "mscale": 1, "mscale_all_dim": 1,
                      "original_max_position_embeddings": 4096,
                      "type": "yarn"}}
FCFG = FamousConfig(impl="pallas")     # the kernels' plain versions here
SEED = 2305843009213693951


def tiny_cfg(**over):
    """The registry's kimi-k2-instruct at :data:`M`'s sizes."""
    sizes = dict(num_layers=3, d_model=256, num_heads=4, num_kv_heads=4,
                 q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=16,
                 qk_rope_head_dim=8, v_head_dim=16, d_ff=64, dense_d_ff=384,
                 num_experts=32, experts_held=8, vocab_size=512)
    return dataclasses.replace(get_config("kimi-k2-instruct"),
                               **dict(sizes, **over))


def draw(m=M, seed=SEED):
    return weights.make(kimi_k2.layout(m), torch.float32, seed, "cpu")


def test_the_layout_is_the_ports():
    """The reference's layout draws the port's spec tree leaf for leaf."""
    want = {k: tuple(v.shape) for k, v in weights.flat(module.param_shapes(
        transformer.model_spec(tiny_cfg()))).items()}
    got = {k: v[0] for k, v in kimi_k2.layout(M).items()}
    assert want == got


def _serve(tree, cfg, prompts, max_new, observer=None, chunk=16):
    eng = ServingEngine(tree, cfg, FCFG, n_slots=3, max_seq=96, chunk=chunk,
                        device="cpu", observer=observer)
    reqs = [Request(rid=i, tokens=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.sched.enqueue(r)
    while eng.sched.busy or eng.sched.has_queued:
        while eng.sched.has_queued and eng.sched.free_slot() is not None:
            eng.add_request(eng.sched.pop_queued())
        eng.step()
    return eng, reqs


PROMPTS = [list(range(5, 31)), [7 * i % 500 + 3 for i in range(41)],
           [11 * i % 499 + 1 for i in range(17)], list(range(100, 160))]


@torch.no_grad()
def test_chunks_then_decode_follow_the_reference():
    """(a) prefill in 16-token chunks (pads routed and written), then
    absorbed decodes on the latent cache: every decode's logits against
    the reference's full forward pass over the same tokens, 1e-4 (float32
    both sides: the port's sums run in other orders, through the
    absorbed form, over one 4-head layer's 8 held experts), and the
    served tokens are the reference's best at every position."""
    tree, cfg = draw(), tiny_cfg()
    params = transformer.prepare_params(tree, cfg)
    caches = transformer.make_caches(cfg, 2, 96, torch.float32, "cpu")
    seq = torch.tensor(PROMPTS[1] + PROMPTS[3][:20])
    n_prompt = 41
    for off in range(0, 48, 16):
        chunk = torch.zeros(1, 16, dtype=torch.int64)
        n = min(16, n_prompt - off)
        chunk[0, :n] = seq[off:off + n]
        transformer.prefill_chunk(params, chunk, caches, 1, off, n, cfg, FCFG)
    got = []
    for pos in range(n_prompt, len(seq)):
        toks = torch.tensor([0, int(seq[pos])])
        lens = torch.tensor([0, pos], dtype=torch.int32)
        logits, _ = transformer.decode_step(params, toks, caches, lens, cfg,
                                            FCFG)
        got.append(logits[1])
    ref = kimi_k2.Reference(tree, M)
    want = ref.logits(ref.forward(seq))[n_prompt:]
    torch.testing.assert_close(torch.stack(got), want, rtol=1e-4, atol=1e-4)
    eng, reqs = _serve(tree, cfg, PROMPTS, 6)
    lg, served = kimi_k2.logits_for(kimi_k2.Reference(tree, M), {}, [],
                                    {r.rid: r for r in reqs},
                                    [r.rid for r in reqs], "cpu")
    assert float(check._gaps(lg, served).max()) < 1e-4


@torch.no_grad()
def test_absorbed_decode_equals_the_expanded_form():
    """(b) one layer's attention at the last position of a sequence: the
    absorbed decode on the latent cache against the expanded equations
    over the whole sequence (1e-5: float32, other summation orders)."""
    tree, cfg = draw(), tiny_cfg()
    p = transformer.prepare_params(tree, cfg)["layers"][1]["attn"]
    x = torch.randn(1, 21, 256, generator=torch.Generator().manual_seed(5))
    full = attention.apply_mla(p, x, cfg, FCFG)
    cache = {"kv": torch.zeros(1, 32, 40)}
    _, rows = attention._mla_project(p, x[:, :20], cfg, torch.arange(20))
    cache["kv"][0, :20] = rows[0]
    out, cache = attention.apply_mla_decode(
        p, x[:, 20:], cache, torch.tensor([20], dtype=torch.int32), cfg, FCFG)
    torch.testing.assert_close(out[:, 0], full[:, 20], rtol=1e-5, atol=1e-5)


@torch.no_grad()
def test_the_shares_add_up_to_the_uncut_layer():
    """(c) the uncut layer holds all 32 experts; each share [lo, lo + 8)
    routes over all 32 and computes its own; the shares' routed parts
    plus the shared expert counted once equal the uncut reference's FFN
    (1e-5)."""
    m_all = dict(M, n_routed_experts=32)
    tree = draw(m_all)
    w_all = kimi_k2.Reference(tree, m_all).layer(1)
    x = torch.randn(37, 256, generator=torch.Generator().manual_seed(9))
    want = kimi_k2.Reference(tree, m_all).ffn(w_all, x, moe=True)
    h = kimi_k2.Reference(tree, m_all).rms(x, w_all["ln2/scale"])
    p_all = transformer.prepare_params(
        tree, tiny_cfg(experts_held=32))["layers"][1]["ffn"]
    shared = moe.layers.apply_mlp(p_all["shared"], h, "silu")
    total = shared.clone()
    for lo in range(0, 32, 8):
        cfg = tiny_cfg(expert_lo=lo, experts_held=8)
        p = dict(p_all, **{n: p_all[n][lo:lo + 8]
                           for n in ("w_in", "w_gate", "w_out")})
        total += moe.apply_moe(p, h[None], cfg)[0] - shared
    torch.testing.assert_close(total, want, rtol=1e-5, atol=1e-5)
    # and one share alone is the reference's share
    ref8 = kimi_k2.Reference(tree, dict(M, expert_lo=8))
    w8 = dict(w_all, **{f"ffn/{n}": w_all[f"ffn/{n}"][8:16]
                        for n in ("w_in", "w_gate", "w_out")})
    p8 = dict(p_all, **{n: p_all[n][8:16] for n in ("w_in", "w_gate",
                                                    "w_out")})
    torch.testing.assert_close(
        moe.apply_moe(p8, h[None], tiny_cfg(expert_lo=8))[0],
        ref8.ffn(w8, x, moe=True), rtol=1e-5, atol=1e-5)


@torch.no_grad()
def test_routing_counters_drop_nothing_and_hold_the_references_choices():
    """(d) the engine's routing accumulator (traced): every real row's 8
    choices kept, none dropped, the held rows computed 8 a row, and the
    real choices on the held experts the reference's count over the same
    tokens (each request's prompt and served tokens but the last)."""
    tree, cfg = draw(), tiny_cfg()
    obs = Observer(trace=True)
    eng, reqs = _serve(tree, cfg, PROMPTS, 5, observer=obs)
    c = obs.routing()
    rows = sum(len(r.tokens) + len(r.out) - 1 for r in reqs)
    assert c["dropped"] == 0 and c["kept"] == c["real"] == 8 * 2 * rows
    ref = kimi_k2.Reference(tree, M)
    for r in reqs:
        ref.forward(torch.tensor(r.tokens + r.out[:-1]))
    assert c["held"] == ref.held > 0
    text = obs.prometheus_text()
    assert f'repro_moe_choices_total{{outcome="held"}} {c["held"]}' in text
    # every decode read cache_len + 1 latent rows in each of 3 layers
    decoded = sum(sum(range(len(r.tokens), len(r.tokens) + len(r.out)))
                  for r in reqs)
    assert f"repro_mla_latent_rows_total {3 * decoded}" in text


def _absorbed_inputs(R=3, Skv=300, seed=4):
    g = torch.Generator().manual_seed(seed)
    q = (torch.randn(R, 64, 576, generator=g) * 0.05).to(torch.bfloat16)
    kv = torch.randn(R, Skv, 576, generator=g).to(torch.bfloat16)
    return q, kv


@pytest.mark.parametrize("lens", [[1, 63, 65], [64, 300, 129], [200, 2, 0]])
def test_the_kernels_mirror_matches_the_absorbed_decode(lens):
    """(e) ``mla_decode_split_reference`` (ranges of L, 64-key tiles, a
    base-2 online softmax, P rounded to bf16) against the plain absorbed
    decode of the same bf16 inputs in float32: within 1e-2 + 2e-3 |ref|
    (P's bf16 rounding moves each weight by up to 2^-9 of itself, so an
    output moves by up to 2^-9 of the spread of the values it averages,
    about 0.008 for rows of N(0, 1) values over two keys); a row of
    length 0 gives exactly 0."""
    q, kv = _absorbed_inputs()
    ln = torch.tensor(lens, dtype=torch.int32)
    plain = dec_ref.mla_decode_reference(q.float(), kv.float(), ln,
                                         scale=0.1309, dv=512)
    for L in (64, 128, 2048):
        mirror = dec_ref.mla_decode_split_reference(
            q, kv, ln, scale=0.1309, dv=512, L=L).float()
        torch.testing.assert_close(mirror, plain, rtol=2e-3, atol=1e-2)
    if 0 in lens:
        assert torch.equal(mirror[lens.index(0)],
                           torch.zeros(64, 512))


@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="no CUDA device: mla_decode runs on the card")
def test_the_kernel_matches_its_mirror():
    q, kv = _absorbed_inputs(R=4, Skv=4200)
    ln = torch.tensor([64, 2048, 2049, 4200], dtype=torch.int32)
    before = lib.STATS.snapshot()
    out = mla_ops.mla_decode(q.cuda(), kv.cuda(), ln.cuda(), scale=0.1309,
                             dv=512)
    after = lib.STATS.snapshot()
    assert after["launches"]["mla_decode"] == \
        before["launches"]["mla_decode"] + 1
    assert after["designs"]["mla_decode.tc"] == \
        before["designs"]["mla_decode.tc"] + 1
    L, _ = mla_ops.plan(4, 4200, torch.cuda.get_device_properties(0)
                        .multi_processor_count)
    mirror = dec_ref.mla_decode_split_reference(q, kv, ln, scale=0.1309,
                                                dv=512, L=L)
    torch.testing.assert_close(out.cpu().float(), mirror.float(),
                               rtol=2e-3, atol=2e-3)


def test_the_kernel_is_registered_and_counted():
    """``mla_decode`` is one of the library's kernels, its one design is
    counted apart, and a launch on the card is in the counters that graph
    captures carry."""
    assert "mla_decode" in lib.KERNELS and "mla_decode.tc" in lib.DESIGNS
    snap = lib.STATS.snapshot()
    assert "mla_decode" in snap["launches"]
    assert "mla_decode.tc" in snap["designs"]


def test_paths_latent_attention_does_not_take_raise():
    """(f) paged and int8 caches, speculative verify, monolithic prefill
    and tensor parallelism each refuse a latent-attention config."""
    cfg, tree = tiny_cfg(), draw()
    with pytest.raises(ValueError, match="paged and int8 caches"):
        transformer.make_caches(cfg, 2, 64, torch.float32, "cpu",
                                cache_kind="paged", page_size=16, n_pages=9)
    with pytest.raises(ValueError, match="paged and int8 caches"):
        ServingEngine(tree, cfg, FCFG, n_slots=2, max_seq=64,
                      cache_kind="paged", kv_dtype="int8", device="cpu")
    for kw in (dict(speculative=True), dict(prefill_mode="monolithic")):
        with pytest.raises(ValueError, match="not supported for it"):
            ServingEngine(tree, cfg, FCFG, n_slots=2, max_seq=64,
                          device="cpu", **kw)
    params = transformer.prepare_params(tree, cfg)
    caches = transformer.make_caches(cfg, 2, 64, torch.float32, "cpu")
    with pytest.raises(ValueError, match="speculative verify"):
        transformer.verify_step(params, torch.zeros(2, 3, dtype=torch.int64),
                                caches, torch.zeros(2, dtype=torch.int32),
                                cfg, FCFG)
    with pytest.raises(ValueError, match="monolithic prefill"):
        transformer.prefill(params, torch.zeros(1, 8, dtype=torch.int64),
                            transformer.make_caches(cfg, 1, 64, torch.float32,
                                                    "cpu"), cfg, FCFG)
    with pytest.raises(ValueError, match="tensor parallelism"):
        transformer.check_mesh(cfg, None, None)


def test_the_registry_entry_at_the_catalogs_size():
    """kimi-k2-instruct whole: 1.04T parameters, 32B active (the
    catalog's "1.04T-A32B"): the dense first layer and the shared expert
    count as active, 8 of the 384 routed experts a token."""
    cfg = get_config("kimi-k2-instruct")
    assert 1.0e12 <= cfg.param_count() <= 1.1e12
    assert 30e9 <= cfg.active_param_count() <= 34e9
    assert transformer.layer_kinds(cfg) == ("attn",) * 61
    assert cfg.num_units == 60 and cfg.experts_here == (0, 384)
