"""PyTorch port, the cost model (``core/analytical.py``) and the roofline
arithmetic (``roofline/analysis.py``) against the JAX package's.

* ``mha_latency``'s modules (flops, device-memory bytes, working set,
  steps, II, total) equal to JAX's under a spec built from JAX's ``V5E``
  at run time, over shapes with and without GQA, int8 and f32 operands,
  a kv length of its own and clipped tiles;
* ``autotune_tiles`` picking JAX's tiles under that spec, and finding a
  tiling on :data:`H100` at the quickstart's call, where JAX's candidates
  find none;
* ``paper_gops`` equal to JAX's;
* ``model_flops`` equal to JAX's for every config and ``SHAPES`` entry,
  and JAX's ``test_model_flops_definitions`` /
  ``test_roofline_dominant_and_fraction`` restated;
* ``Roofline.roofline_fraction`` dividing by its own spec's peak;
* the ring model of moved bytes against JAX's ``collective_bytes`` on
  synthetic HLO.

No number of a TPU is written here: the V5E figures are read from JAX's
``V5E``.  The HLO-reading half of JAX's roofline (``analyse``, the
``hlo_cost`` cases of ``tests/test_roofline.py``) is restated for the
operator counter that stands in for it in ``tests/test_torch_op_cost.py``.
"""
import dataclasses

import pytest

from repro.configs import base as jbase
from repro.core import analytical as janalytical
from repro.roofline import analysis as jroofline
from repro_torch.configs import base
from repro_torch.core import analytical
from repro_torch.roofline import analysis

V5E = janalytical.V5E
# JAX's V5E field by field in the port's spec (VMEM in the place of shared
# memory, the MXU's dim as the alignment, the DMA latency as the launch's)
V5E_EQUAL = analytical.GpuSpec(
    name="v5e-equal", peak_bf16=V5E.peak_bf16, peak_int8=V5E.peak_int8,
    hbm_bw=V5E.hbm_bw, link_bw=V5E.ici_bw, hbm_bytes=V5E.hbm_bytes,
    smem_bytes=V5E.vmem_bytes, align=V5E.mxu,
    launch_latency=V5E.dma_latency)

SHAPES = (
    dict(batch=1, seq=64, heads=8, kv_heads=8, head_dim=96, d_model=768,
         tile_q=64, tile_k=64, tile_d=64),
    dict(batch=8, seq=2048, heads=8, kv_heads=8, head_dim=96, d_model=768),
    dict(batch=2, seq=512, heads=28, kv_heads=4, head_dim=128,
         d_model=3584, tile_q=128, tile_k=256, tile_d=512),
    dict(batch=4, seq=256, heads=28, kv_heads=4, head_dim=128, d_model=3584,
         kv_seq=2048, quant="int8"),
    dict(batch=1, seq=100, heads=6, kv_heads=2, head_dim=64, d_model=384,
         tile_q=48, tile_k=80, tile_d=200, dtype_bytes=4),
)
FIELDS = ("flops", "hbm_bytes", "steps", "ii", "t_compute", "t_memory",
          "t_total")


@pytest.mark.parametrize("shape", SHAPES, ids=range(len(SHAPES)))
def test_mha_latency_matches_jax(shape):
    got = analytical.mha_latency(hw=V5E_EQUAL, **shape)
    want = janalytical.mha_latency(hw=V5E, **shape)
    assert len(got.modules) == len(want.modules) == 3
    for g, w in zip(got.modules, want.modules):
        assert g.name == w.name
        for f in FIELDS:
            assert getattr(g, f) == pytest.approx(getattr(w, f), rel=1e-12), f
        # the working set: shared memory here, VMEM there
        assert g.smem_bytes == pytest.approx(w.vmem_bytes, rel=1e-12)
    assert got.total == pytest.approx(want.total, rel=1e-12)
    assert got.gops() == pytest.approx(want.gops(), rel=1e-12)
    assert analytical.fits_smem(got, V5E_EQUAL) == \
        janalytical.fits_vmem(want, V5E)
    assert got.table().splitlines()[1:] == want.table().splitlines()[1:]


@pytest.mark.parametrize("call", (
    dict(batch=8, seq=2048, heads=8, kv_heads=8, head_dim=96, d_model=768),
    dict(batch=1, seq=4096, heads=28, kv_heads=4, head_dim=128,
         d_model=3584, quant="int8"),
))
def test_autotune_picks_jax_tiles_under_v5e(call):
    got = analytical.autotune_tiles(hw=V5E_EQUAL, **call)
    want = janalytical.autotune_tiles(hw=V5E, **call)
    assert got["tiles"] == want["tiles"]
    assert got["latency"].total == pytest.approx(want["latency"].total,
                                                 rel=1e-12)


def test_autotune_finds_a_tiling_on_the_h100():
    """The quickstart's call: JAX's candidates (128-2048) under the
    double-buffer rule fit nothing in 232448 B; with 64 the port picks a
    tiling that fits."""
    call = dict(batch=8, seq=2048, heads=8, kv_heads=8, head_dim=96,
                d_model=768)
    with pytest.raises(ValueError, match="no feasible tiling"):
        analytical.autotune_tiles(candidates=(128, 256, 512, 1024, 2048),
                                  **call)
    tuned = analytical.autotune_tiles(**call)
    tiles, lat = tuned["tiles"], tuned["latency"]
    assert analytical.fits_smem(lat)
    assert all(t % analytical.H100.align == 0 for t in tiles.values())
    assert 64 in tiles.values()
    assert lat.total > 0


def test_h100_spec():
    hw = analytical.H100
    assert (hw.peak_bf16, hw.peak_int8, hw.peak_f32) == (989e12, 1979e12,
                                                         67e12)
    assert (hw.hbm_bw, hw.smem_bytes, hw.sms, hw.align) == (3.35e12, 232448,
                                                            132, 64)


@pytest.mark.parametrize("seq,d_model,heads", ((64, 768, 8), (128, 512, 4),
                                               (2048, 4096, 32)))
def test_paper_gops_matches_jax(seq, d_model, heads):
    assert analytical.paper_gops(seq=seq, d_model=d_model, heads=heads) == \
        janalytical.paper_gops(seq=seq, d_model=d_model, heads=heads)


def test_model_flops_match_jax_for_every_config_and_shape():
    names = base.list_configs()
    assert names == jbase.list_configs()
    assert set(base.SHAPES) == set(jbase.SHAPES)
    for name in names:
        for key in base.SHAPES:
            got = analysis.model_flops(base.get_config(name),
                                       base.SHAPES[key])
            want = jroofline.model_flops(jbase.get_config(name),
                                         jbase.SHAPES[key])
            assert got == want, (name, key)


def test_model_flops_definitions():
    cfg = base.get_config("deepseek-7b")
    n = cfg.param_count()
    assert analysis.model_flops(cfg, base.SHAPES["train_4k"]) == \
        pytest.approx(6.0 * n * 256 * 4096)
    assert analysis.model_flops(cfg, base.SHAPES["decode_32k"]) == \
        pytest.approx(2.0 * n * 128)
    moe = base.get_config("kimi-k2-1t-a32b")
    assert analysis.model_flops(moe, base.SHAPES["train_4k"]) < \
        6.0 * moe.param_count() * 256 * 4096 / 5  # active << total


def _roofline(hw, **over):
    kw = dict(arch="a", shape="s", mesh="m", flops=hw.peak_bf16,
              bytes_accessed=hw.hbm_bw / 2, coll_bytes=0.0, t_compute=1.0,
              t_memory=0.5, t_collective=0.0,
              model_flops_total=hw.peak_bf16 * 256, chips=256,
              coll_detail={}, hw=hw)
    kw.update(over)
    return analysis.Roofline(**kw)


def test_roofline_dominant_and_fraction():
    r = _roofline(analytical.H100)
    assert r.dominant == "compute"
    assert r.roofline_fraction == pytest.approx(1.0)
    assert r.useful_flop_ratio == pytest.approx(1.0)
    assert _roofline(analytical.H100, t_memory=2.0).dominant == "memory"
    assert _roofline(analytical.H100, t_collective=3.0).dominant == \
        "collective"


def test_roofline_fraction_divides_by_its_own_spec():
    """JAX's ``roofline_fraction`` divides by V5E's peak whatever part it
    was given; the port's by its spec's."""
    half = dataclasses.replace(analytical.H100, name="half",
                               peak_bf16=analytical.H100.peak_bf16 / 2)
    flops = 1e15
    for hw in (analytical.H100, half, V5E_EQUAL):
        r = _roofline(hw, model_flops_total=flops, chips=1, t_compute=1.0,
                      t_memory=0.0)
        assert r.roofline_fraction == pytest.approx(flops / hw.peak_bf16)
    j = jroofline.Roofline(
        arch="a", shape="s", mesh="m", flops=flops, bytes_accessed=0.0,
        coll_bytes=0.0, t_compute=1.0, t_memory=0.0, t_collective=0.0,
        model_flops_total=flops, chips=1, coll_detail={})
    assert j.roofline_fraction == pytest.approx(
        _roofline(V5E_EQUAL, model_flops_total=flops, chips=1,
                  t_compute=1.0, t_memory=0.0).roofline_fraction)
    assert _roofline(analytical.H100).row()["hw"] == "h100-sxm"


SYNTH_HLO = """
HloModule synth

ENTRY %main (p0: f32[1024,256]) -> f32[1024,256] {
  %p0 = f32[1024,256]{1,0} parameter(0)
  %ar = f32[1024,256]{1,0} all-reduce(%p0), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = f32[4096,256]{1,0} all-gather(%ar), replica_groups=[64,4]<=[256], dimensions={0}
  %rs = bf16[128,256]{1,0} reduce-scatter(%ar), replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}
  %aa = f32[1024,256]{1,0} all-to-all(%ar), replica_groups={{0,1}}, dimensions={0}
  ROOT %cp = f32[1024,256]{1,0} collective-permute(%ar), source_target_pairs={{0,1}}
}
"""
# (kind, result bytes, group size) of each collective in SYNTH_HLO
SYNTH_OPS = (("all-reduce", 1024 * 256 * 4, 4),
             ("all-gather", 4096 * 256 * 4, 4),
             ("reduce-scatter", 128 * 256 * 2, 8),
             ("all-to-all", 1024 * 256 * 4, 2),
             ("collective-permute", 1024 * 256 * 4, 1))


def test_moved_bytes_match_jax_collective_bytes():
    coll = jroofline.collective_bytes(SYNTH_HLO)
    for kind, nbytes, n in SYNTH_OPS:
        assert analysis.moved_bytes(kind, nbytes, n) == \
            pytest.approx(coll[kind], rel=1e-12), kind
    assert sum(analysis.moved_bytes(*op) for op in SYNTH_OPS) == \
        pytest.approx(coll["total_moved"], rel=1e-12)
    with pytest.raises(ValueError, match="unknown collective"):
        analysis.moved_bytes("broadcast", 8, 2)
