"""PyTorch port, the training path: ``transformer.forward`` logits, three
``make_train_step`` steps from one state (``convert.train_state_from_jax``)
against the JAX package's, the data pipeline bit for bit, and ports of the
JAX trainer tests (checkpoint round trip, keep-last-k, fault-injection
restore, exact resume, straggler watchdog), all on the CPU at shrunk
sizes.  Weights and inputs come from numpy seeds.  Tolerance at f32:
1e-4 on logits, 1e-4 relative on losses and gradient norms (the two
frameworks sum in other orders)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import config_as_jax, random_jax_params
from repro.configs.base import SMOKE_SHAPES as JSMOKE_SHAPES
from repro.configs.base import get_config as jget_config
from repro.configs.base import shrink as jshrink
from repro.core.famous import FamousConfig as JFamousConfig
from repro.data import pipeline as jpipeline
from repro.models import module as jmodule
from repro.models import transformer as jtransformer
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.configs.base import SMOKE_SHAPES, ShapeConfig, get_config, shrink
from repro_torch.core.famous import FamousConfig
from repro_torch.data import pipeline
from repro_torch.launch import train as train_launch
from repro_torch.models import module, transformer
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import step as step_lib
from repro_torch.train import trainer as trainer_lib

ARCHS = ["qwen2-7b", "famous-bert"]
SHAPE = SMOKE_SHAPES["smoke_train"]
TOL = 1e-4


def _cfgs(arch):
    return shrink(get_config(arch)), jshrink(jget_config(arch))


def _tcfg(**kw):
    base = dict(compute_dtype=torch.float32, loss_chunk=16,
                optimizer=adamw.AdamWConfig(lr=1e-2),
                schedule_warmup=2, schedule_total=100)
    base.update(kw)
    return step_lib.TrainConfig(**base)


def _jtcfg():
    return jstep.TrainConfig(compute_dtype=jnp.float32, loss_chunk=16,
                             optimizer=jadamw.AdamWConfig(lr=1e-2),
                             schedule_warmup=2, schedule_total=100)


def _batch(cfg, step=0):
    return pipeline.device_batch(cfg, SHAPE, 0, step, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_tree_matches_jax(arch):
    """Same tree, leaf shapes, initializers and scales (LayerNorm biases
    and the ungated MLP included for famous-bert)."""
    cfg, jcfg = _cfgs(arch)
    assert config_as_jax(cfg, jcfg) == dataclasses.asdict(jcfg)
    tleaves = module.tree_leaves(transformer.model_spec(cfg))
    jleaves = jmodule._leaves_with_path(jtransformer.model_spec(jcfg))[0]
    assert [(s.shape, s.init, s.scale) for s in tleaves] == \
        [(s.shape, s.init, s.scale) for _, s in jleaves]


@pytest.mark.parametrize("timpl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch, timpl):
    """``transformer.forward`` on the spec tree (stacked leaves, remat on)
    against JAX's, same weights, at f32."""
    cfg, jcfg = _cfgs(arch)
    jparams = random_jax_params(jcfg, seed=2)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 24))
    want = jtransformer.forward(jparams, jnp.asarray(toks, jnp.int32), jcfg,
                                JFamousConfig(impl="xla"))
    got = transformer.forward(convert.tree_from_jax(jparams, "cpu"),
                              torch.from_numpy(toks), cfg,
                              FamousConfig(impl=timpl))
    assert got.dtype == torch.float32 and got.shape == (2, 24, 256)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)


@functools.lru_cache(maxsize=None)
def _jax_run(arch):
    """Initial JAX state, the gradients there on step 0's batch, and the
    metrics of 3 steps of JAX's train step (impl="xla")."""
    from repro.train import losses as jlosses
    _, jcfg = _cfgs(arch)
    tcfg = _jtcfg()
    fcfg = JFamousConfig(impl="xla")
    state = jstep.init_state(jcfg, tcfg, jax.random.PRNGKey(1))
    state = dict(state, params=random_jax_params(jcfg, seed=4))
    ts = jax.jit(jstep.make_train_step(jcfg, fcfg, tcfg))
    init = jax.tree_util.tree_map(np.asarray, state)
    batches = [{k: jnp.asarray(v) for k, v in jpipeline.host_batch(
        jcfg, JSMOKE_SHAPES["smoke_train"], 0, i).items()} for i in range(3)]
    grads = jax.grad(lambda p: jlosses.lm_loss(
        p, batches[0], jcfg, fcfg, chunk=tcfg.loss_chunk,
        compute_dtype=jnp.float32))(state["params"])
    metrics = []
    for b in batches:
        state, m = ts(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return init, jax.tree_util.tree_map(np.asarray, grads), metrics


@pytest.mark.parametrize("timpl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_jax(arch, timpl):
    """Every gradient leaf at the shared initial state, then the loss
    trajectory, gradient norms and schedule of three steps.  (The updated
    parameters are not compared leaf by leaf: where a gradient entry is
    near 0, AdamW's normalised step turns a last-digit difference of the
    gradient into a different step.)"""
    cfg, _ = _cfgs(arch)
    init, jgrads, jmetrics = _jax_run(arch)
    state = convert.train_state_from_jax(init, "cpu")
    ts = step_lib.make_train_step(cfg, FamousConfig(impl=timpl), _tcfg())
    _, grads = ts.grads_of(state["params"], _batch(cfg, 0))
    for a, b in zip(module.tree_leaves(grads),
                    jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(a.numpy(), b, atol=TOL * np.abs(b).max(),
                                   rtol=TOL)
    for i in range(3):
        state, m = ts(state, _batch(cfg, i))
        for name in ("loss", "grad_norm", "lr_scale"):
            np.testing.assert_allclose(float(m[name]), jmetrics[i][name],
                                       rtol=TOL, err_msg=f"{name} @ {i}")
    assert int(state["step"]) == 3 and int(state["opt"]["count"]) == 3


def test_microbatch_grad_equivalence():
    """Accumulated microbatch gradients equal the single-batch ones."""
    cfg, _ = _cfgs("famous-bert")
    s1 = step_lib.init_state(cfg, _tcfg(), torch.Generator().manual_seed(0),
                             "cpu")
    s2 = {"params": module.tree_map(
              lambda p: p.detach().clone().requires_grad_(), s1["params"]),
          "opt": adamw.init_opt_state(s1["params"], adamw.AdamWConfig()),
          "step": s1["step"].clone()}
    fcfg = FamousConfig(impl="pallas")
    b = _batch(cfg)
    s1, m1 = step_lib.make_train_step(cfg, fcfg, _tcfg())(s1, b)
    s2, m2 = step_lib.make_train_step(cfg, fcfg, _tcfg(microbatches=2))(s2, b)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    for a, c in zip(module.tree_leaves(s1["params"]),
                    module.tree_leaves(s2["params"])):
        np.testing.assert_allclose(a.detach().numpy(), c.detach().numpy(),
                                   atol=1e-5, rtol=1e-4)


def test_grad_compression_trains_as_without():
    """JAX's ``make_train_step`` never reads ``grad_compression``, so one
    step with the flag on gives the state of one step with it off, bit
    for bit."""
    cfg, _ = _cfgs("famous-bert")
    fcfg = FamousConfig(impl="pallas")
    b = _batch(cfg)
    states = []
    for flag in (False, True):
        s = step_lib.init_state(cfg, _tcfg(),
                                torch.Generator().manual_seed(0), "cpu")
        s, m = step_lib.make_train_step(
            cfg, fcfg, _tcfg(grad_compression=flag))(s, b)
        states.append((s, m))
    (s0, m0), (s1, m1) = states
    assert torch.equal(m0["loss"], m1["loss"])
    assert int(s0["step"]) == int(s1["step"]) == 1
    for a, c in zip(module.tree_leaves(s0["params"]) +
                    module.tree_leaves(s0["opt"]["m"]) +
                    module.tree_leaves(s0["opt"]["v"]),
                    module.tree_leaves(s1["params"]) +
                    module.tree_leaves(s1["opt"]["m"]) +
                    module.tree_leaves(s1["opt"]["v"])):
        assert torch.equal(a.detach(), c.detach())


@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_batches_match_jax_bit_for_bit(arch):
    cfg, jcfg = _cfgs(arch)
    shape = ShapeConfig("t", 24, 3, "train")
    for step in (0, 5):
        mine = pipeline.host_batch(cfg, shape, 7, step)
        theirs = jpipeline.host_batch(jcfg, shape, 7, step)
        for k in ("inputs", "targets"):
            assert mine[k].dtype == theirs[k].dtype
            np.testing.assert_array_equal(mine[k], theirs[k])
        dev = pipeline.device_batch(cfg, shape, 7, step, "cpu")
        assert dev["inputs"].dtype == torch.int64
        np.testing.assert_array_equal(dev["targets"].numpy(),
                                      theirs["targets"])


def test_prefetch_iterator_yields_the_steps_in_order():
    cfg, _ = _cfgs("qwen2-7b")
    it = pipeline.PrefetchIterator(cfg, SHAPE, pipeline.DataConfig(seed=3),
                                   "cpu", start_step=4)
    try:
        for want in (4, 5, 6):
            step, batch = next(it)
            assert step == want
            np.testing.assert_array_equal(
                batch["inputs"].numpy(),
                pipeline.host_batch(cfg, SHAPE, 3, want)["inputs"])
    finally:
        it.close()
    assert not it._thread.is_alive()


def _fresh(cfg, seed=0):
    tcfg = _tcfg()
    st = step_lib.init_state(cfg, tcfg, torch.Generator().manual_seed(seed),
                             "cpu")
    return st, step_lib.make_train_step(cfg, FamousConfig(impl="pallas"),
                                        tcfg)


def test_checkpoint_roundtrip(tmp_path):
    cfg, _ = _cfgs("famous-bert")
    state, ts = _fresh(cfg)
    state, _ = ts(state, _batch(cfg))        # non-zero moments and step
    d = str(tmp_path / "ck")
    ckpt_lib.save_checkpoint(d, 7, state)
    assert ckpt_lib.latest_step(d) == 7
    restored, step = ckpt_lib.restore_checkpoint(d, state)
    assert step == 7
    for (pa, a), (pb, b) in zip(ckpt_lib._flatten(state),
                                ckpt_lib._flatten(restored)):
        assert pa == pb and a.dtype == b.dtype
        assert a.requires_grad == b.requires_grad
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())


def test_checkpoint_reads_the_jax_layout(tmp_path):
    """A checkpoint the JAX package wrote restores into the port's state:
    same paths, same leaf files."""
    from repro.train import checkpoint as jckpt
    cfg, jcfg = _cfgs("famous-bert")
    jstate = jstep.init_state(jcfg, _jtcfg(), jax.random.PRNGKey(0))
    d = str(tmp_path / "jck")
    jckpt.save_checkpoint(d, 2, jstate)
    like = convert.train_state_from_jax(
        jax.tree_util.tree_map(np.zeros_like, jstate), "cpu")
    restored, step = ckpt_lib.restore_checkpoint(d, like)
    assert step == 2
    for a, b in zip(module.tree_leaves(restored["params"]),
                    jax.tree_util.tree_leaves(jstate["params"])):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))


def test_checkpoint_gc_keeps_last_k(tmp_path):
    d = str(tmp_path / "ck")
    state = {"x": torch.arange(4.0), "step": torch.tensor(0)}
    for s in range(6):
        ckpt_lib.save_checkpoint(d, s, state, keep=3)
    assert ckpt_lib.all_steps(d) == [3, 4, 5]


def test_async_checkpoint_snapshots_before_in_place_updates(tmp_path):
    d = str(tmp_path / "ck")
    x = torch.zeros(4)
    ck = ckpt_lib.AsyncCheckpointer(d)
    ck.save(1, {"x": x})
    x.add_(1.0)                    # the training loop updates in place
    ck.wait()
    restored, _ = ckpt_lib.restore_checkpoint(d, {"x": x})
    assert torch.all(restored["x"] == 0)


def test_trainer_fault_injection_restores(tmp_path):
    """Inject failures at steps 5 and 9; the run completes with restarts."""
    cfg, _ = _cfgs("famous-bert")
    state, ts = _fresh(cfg)
    fired = set()

    def fault(step):
        if step in (5, 9) and step not in fired:
            fired.add(step)
            raise trainer_lib.InjectedFault(f"simulated node loss @ {step}")

    tr = trainer_lib.Trainer(
        ts, state, lambda s: _batch(cfg, s),
        trainer_lib.TrainerConfig(total_steps=12, ckpt_every=4,
                                  ckpt_dir=str(tmp_path / "ft")),
        fault_hook=fault)
    final = tr.run()
    assert int(final["step"]) == 12
    assert tr.restarts == 2 and len(tr.failures) == 2


def test_trainer_without_checkpoints_raises_on_a_fault():
    cfg, _ = _cfgs("famous-bert")
    state, ts = _fresh(cfg)

    def fault(step):
        if step == 1:
            raise trainer_lib.InjectedFault("lost")

    tr = trainer_lib.Trainer(
        ts, state, lambda s: _batch(cfg, s),
        trainer_lib.TrainerConfig(total_steps=3, ckpt_dir=None),
        fault_hook=fault)
    with pytest.raises(RuntimeError, match="step 1 failed"):
        tr.run()


def test_trainer_resume_from_checkpoint_is_exact(tmp_path):
    """Stop after step 6, restart: final params equal an uninterrupted run
    (deterministic data pipeline => exact replay)."""
    cfg, _ = _cfgs("famous-bert")
    st, ts = _fresh(cfg)
    for i in range(10):
        st, _ = ts(st, _batch(cfg, i))

    d = str(tmp_path / "resume")
    st2, ts2 = _fresh(cfg)
    trainer_lib.Trainer(ts2, st2, lambda s: _batch(cfg, s),
                        trainer_lib.TrainerConfig(total_steps=6, ckpt_every=3,
                                                  ckpt_dir=d)).run()
    st3, ts3 = _fresh(cfg, seed=1)     # other weights: the restore wins
    final = trainer_lib.Trainer(
        ts3, st3, lambda s: _batch(cfg, s),
        trainer_lib.TrainerConfig(total_steps=10, ckpt_every=3,
                                  ckpt_dir=d)).run()
    assert int(final["step"]) == 10
    for a, b in zip(module.tree_leaves(st["params"]),
                    module.tree_leaves(final["params"])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-6)


def test_straggler_watchdog(tmp_path):
    import time
    cfg, _ = _cfgs("famous-bert")
    state, inner = _fresh(cfg)
    factor = 5.0
    durations = []   # this run's measured steps, so load cannot hide step 8

    def slow_step(state, batch):
        if int(state["step"]) == 8:
            # simulated straggler host: at least 2 x factor x the longest
            # earlier step, so step 8 exceeds factor x any rolling median
            time.sleep(max(0.3, 2 * factor * max(durations)))
        t0 = time.monotonic()
        out = inner(state, batch)
        durations.append(time.monotonic() - t0)
        return out

    tr = trainer_lib.Trainer(
        slow_step, state, lambda s: _batch(cfg, s),
        trainer_lib.TrainerConfig(total_steps=12, ckpt_every=100,
                                  ckpt_dir=str(tmp_path / "st"),
                                  straggler_factor=factor))
    tr.run()
    assert any(e.step == 8 for e in tr.straggler_events), tr.straggler_events


def test_train_launcher_needs_cuda_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_launch.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
    tr = train_launch.main(["--smoke", "--device", "cpu", "--steps", "3",
                            "--ckpt-every", "2", "--ckpt-dir",
                            str(tmp_path / "cpu")])
    assert int(tr.state["step"]) == 3 and len(tr.metrics_log) == 3
    assert all(np.isfinite(m["loss"]) for m in tr.metrics_log)
    assert ckpt_lib.all_steps(str(tmp_path / "cpu")) == [0, 2, 3]
