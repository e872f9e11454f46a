"""PyTorch port: the operator cost counter (``roofline/op_cost.py``), the
counterpart of JAX's ``roofline/hlo_cost.py``, with the cases of
``tests/test_roofline.py`` restated for an eager count on ``meta``
tensors:

* a product's FLOPs exact;
* a Python loop of 12 products counted 12 times (the eager twin of the
  scan-trip case: an eager step runs every trip);
* an elementwise pass's bytes within JAX's bounds;
* each collective's moved bytes and count over a fake (2, 2) mesh against
  ``analysis.moved_bytes``;
* the peak of live bytes of a known sequence exact;
* ``argument_bytes`` counting a storage once and skipping host tensors;
* ``analysis.analyse`` building the roofline from an ``OpCost``.
"""
import warnings

import pytest
import torch
import torch.distributed as dist

from repro_torch.core.analytical import H100
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.roofline import analysis, op_cost

torch.set_num_threads(1)
MiB = 2**20


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_dot_flops_exact():
    M, K, N = 256, 512, 128
    cost = op_cost.analyse_ops(lambda a, b: a @ b, meta(M, K), meta(K, N))
    assert cost.flops == 2 * M * K * N
    # read both operands, write the product
    assert cost.bytes_accessed == 4 * (M * K + K * N + M * N)


def test_loop_of_products_counted_every_trip():
    M, n_steps = 128, 12

    def f(x, w):
        for _ in range(n_steps):
            x = torch.tanh(x @ w)
        return x

    cost = op_cost.analyse_ops(f, meta(M, M), meta(M, M))
    assert cost.flops == 2 * M * M * M * n_steps


def test_bytes_reasonable_for_elementwise():
    N = 1 << 20
    cost = op_cost.analyse_ops(lambda x: x * 2.0 + 1.0, meta(N))
    # JAX's bounds; unfused, two passes each read and write 4 MiB
    assert 4e6 <= cost.bytes_accessed <= 3e7, cost.bytes_accessed
    assert cost.bytes_accessed == 4 * 4 * N


def test_views_and_metadata_move_no_bytes():
    x = meta(64, 32)
    cost = op_cost.analyse_ops(
        lambda x: x.t()[:16].unsqueeze(0).expand(4, 16, 64).view(4, 16, 8, 8),
        x)
    assert cost.bytes_accessed == 0 and cost.peak_bytes == 0


def test_peak_of_a_known_sequence_exact():
    def f(a, b):
        x = a @ b            # 4 MiB live
        y = x @ b            # 8 MiB
        del x                # 4 MiB
        z = y @ b            # 8 MiB
        del y
        return z

    a = meta(1024, 1024)
    cost = op_cost.analyse_ops(f, a, a)
    assert cost.peak_bytes == 8 * MiB
    # the arguments are not counted, nor is an in-place update of them
    assert op_cost.analyse_ops(lambda a: a.mul_(2), a).peak_bytes == 0


def test_collectives_over_a_fake_mesh():
    b = 1024 * 256 * 4
    with dryrun.fake_world(4):
        mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), "cpu")
        model, data = mesh.get_group("model"), mesh.get_group("data")
        x = meta(1024, 256)

        def f():
            dist.all_reduce(x, group=model)
            dist.all_reduce(x)                  # the whole world
            dist.all_gather_into_tensor(meta(2048, 256), x, group=model)
            dist.reduce_scatter_tensor(meta(512, 256), x, group=data)
            dist.all_to_all_single(meta(1024, 256), x, group=data)

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            cost = op_cost.analyse_ops(f)
    assert not dist.is_initialized()
    want = {
        "all-reduce": analysis.moved_bytes("all-reduce", b, 2)
        + analysis.moved_bytes("all-reduce", b, 4),
        "all-gather": analysis.moved_bytes("all-gather", 2 * b, 2),
        "reduce-scatter": analysis.moved_bytes("reduce-scatter", b // 2, 2),
        "all-to-all": analysis.moved_bytes("all-to-all", b, 2),
    }
    assert cost.coll_by_type == pytest.approx(want)
    assert cost.coll_moved == pytest.approx(sum(want.values()))
    assert cost.coll_counts == {"all-reduce": 2, "all-gather": 1,
                                "reduce-scatter": 1, "all-to-all": 1}
    # a collective moves no bytes of memory traffic in the count
    assert cost.bytes_accessed == 0 and cost.flops == 0


def test_fake_world_refuses_a_process_with_a_group():
    with dryrun.fake_world(2):
        with pytest.raises(RuntimeError, match="already has a default"):
            with dryrun.fake_world(4):
                pass
        assert dist.get_world_size() == 2
    assert not dist.is_initialized()


def test_argument_bytes_counts_a_storage_once_and_skips_the_host():
    w = meta(256, 64)
    tree = {"w": w, "views": [w[:10], w.t()],
            "other": (meta(8, dtype=torch.int8),),
            "host": torch.zeros(1000), "layout": object()}
    assert op_cost.argument_bytes(tree) == 256 * 64 * 4 + 8
    assert op_cost.argument_bytes(tree, {"again": w}) == 256 * 64 * 4 + 8


def test_analyse_builds_the_roofline_from_an_op_cost():
    cost = op_cost.OpCost(flops=989e12, bytes_accessed=3.35e12 / 2,
                          coll_moved=450e9 / 4,
                          coll_by_type={"all-reduce": 450e9 / 4},
                          coll_counts={"all-reduce": 3}, peak_bytes=0)
    r = analysis.analyse("a", "s", "pod1", cost=cost, chips=256,
                         model_flops_total=989e12 * 256,
                         memory_per_device=2**30, hw=H100)
    assert (r.t_compute, r.t_memory, r.t_collective) == pytest.approx(
        (1.0, 0.5, 0.25))
    assert r.dominant == "compute" and r.t_bound == pytest.approx(1.0)
    assert r.roofline_fraction == pytest.approx(1.0)
    assert r.useful_flop_ratio == pytest.approx(1.0)
    row = r.row()
    assert row["collectives"] == {"all-reduce": 3}
    assert row["hw"] == H100.name and row["memory_per_device_gib"] == 1.0
