"""Trainer behavior: history cadence, early stop, best-snapshot, checkpointing
(reference behaviors at Poisson-1D.py:201-224, AdvDiff.py:291-341)."""

import numpy as np
import pytest

import hpvpinns_tpu as hv


def _tiny_problem():
    cfg = hv.Poisson1DConfig(
        dtype="float64", n_test=5, n_quad=10, layers=(1, 8, 8, 1),
        train=hv.TrainConfig(iterations=60, check_every=10),
    )
    return hv.build(cfg)


def test_history_cadence_and_keys():
    prob = _tiny_problem()
    res = hv.train(prob, verbose=False)
    assert res.iterations_run == 60
    np.testing.assert_array_equal(res.history["iteration"], [10, 20, 30, 40, 50, 60])
    for key in ("loss", "lossb", "lossv"):
        assert key in res.history and len(res.history[key]) == 6
    assert res.steps_per_sec > 0


def test_early_stop_on_threshold():
    prob = _tiny_problem()
    cfg = hv.TrainConfig(iterations=1000, check_every=10, threshold=1e30)
    res = hv.train(prob, cfg, verbose=False)
    assert res.stopped_early and res.iterations_run == 10


def test_partial_final_chunk():
    prob = _tiny_problem()
    cfg = hv.TrainConfig(iterations=25, check_every=10)
    res = hv.train(prob, cfg, verbose=False)
    assert res.iterations_run == 25
    np.testing.assert_array_equal(res.history["iteration"], [10, 20, 25])


def test_best_snapshot():
    prob = _tiny_problem()
    cfg = hv.TrainConfig(iterations=60, check_every=10, best_snapshot_fraction=0.5)
    res = hv.train(prob, cfg, verbose=False)
    assert res.best_params is not None
    # best loss among records after the snapshot window opened
    snap_losses = [l for it, l in zip(res.history["iteration"], res.history["loss"]) if it > 30]
    best_loss, _ = prob.loss_fn(res.best_params, prob.data)
    np.testing.assert_allclose(float(best_loss), min(snap_losses), rtol=1e-9)


def test_checkpoint_roundtrip(tmp_path):
    prob = _tiny_problem()
    cfg = hv.TrainConfig(
        iterations=30, check_every=10, checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=20
    )
    res = hv.train(prob, cfg, verbose=False)

    from hpvpinns_tpu.training.checkpoint import Checkpointer

    ck = Checkpointer(str(tmp_path / "ckpt"))
    step, restored = ck.restore()
    assert step == 30
    jax_trees_equal = lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=0, atol=0
    )
    import jax

    jax.tree.map(jax_trees_equal, restored["params"], res.params)


def test_resume_from_checkpoint(tmp_path):
    prob = _tiny_problem()
    cfg = hv.TrainConfig(iterations=30, check_every=10, checkpoint_dir=str(tmp_path / "c"))
    res = hv.train(prob, cfg, verbose=False)

    from hpvpinns_tpu.training.checkpoint import Checkpointer

    ck = Checkpointer(str(tmp_path / "c"))
    _, restored = ck.restore()
    res2 = hv.train(prob, hv.TrainConfig(iterations=10, check_every=10), params=restored["params"], verbose=False)
    assert res2.history["loss"][-1] <= res.history["loss"][-1] * 1.5  # keeps improving-ish


def test_lbfgs_phase_improves_loss():
    cfg = hv.Poisson1DConfig(
        dtype="float64", n_test=8, n_quad=16, layers=(1, 10, 10, 1),
        train=hv.TrainConfig(iterations=200, lbfgs_iterations=200, check_every=50),
    )
    prob = hv.build(cfg)
    res = hv.train(prob, cfg.train, verbose=False)
    assert res.iterations_run == 400
    # L-BFGS phase records continue the same history
    np.testing.assert_array_equal(
        res.history["iteration"], np.arange(50, 401, 50)
    )
    adam_end = res.history["loss"][3]
    assert res.history["loss"][-1] < adam_end


def test_profiling_time_fn():
    import jax
    import jax.numpy as jnp

    from hpvpinns_tpu.utils.profiling import time_fn

    f = jax.jit(lambda x: (x * 2).sum())
    stats = time_fn(f, jnp.ones(128), iters=10, warmup=2)
    assert stats["iters_per_sec"] > 0 and stats["best_s"] <= stats["mean_s"] * 1.01


def test_profiler_trace_writes(tmp_path):
    import jax
    import jax.numpy as jnp

    from hpvpinns_tpu.utils.profiling import device_memory_stats, trace

    with trace(str(tmp_path)):
        jax.block_until_ready(jax.jit(lambda x: x * 2)(jnp.ones(64)))
    import os

    found = any(f for _, _, fs in os.walk(tmp_path) for f in fs)
    assert found, "profiler trace produced no files"
    stats = device_memory_stats()
    assert isinstance(stats, dict)


def test_checkpoint_cadence_non_multiple(tmp_path):
    """checkpoint_every=25 with check_every=10 must save on a regular >=25-iter
    cadence (30, 60, 90) — not the irregular 30, 55, 80 the old modulo trigger
    produced — plus the final save."""
    prob = _tiny_problem()
    cfg = hv.TrainConfig(
        iterations=90, check_every=10,
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=25, checkpoint_keep_last=0,
    )
    hv.train(prob, cfg, verbose=False)

    from hpvpinns_tpu.training.checkpoint import Checkpointer

    ck = Checkpointer(str(tmp_path / "ck"), keep_last=0)
    assert ck._steps() == [30, 60, 90]


def test_async_checkpointing_roundtrip(tmp_path):
    """checkpoint_async=True: training completes, writes finalize, restore
    matches the final params; retention holds."""
    prob = _tiny_problem()
    cfg = hv.TrainConfig(
        iterations=40, check_every=10,
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=10,
        checkpoint_keep_last=2, checkpoint_async=True,
    )
    res = hv.train(prob, cfg, verbose=False)

    from hpvpinns_tpu.training.checkpoint import Checkpointer

    ck = Checkpointer(str(tmp_path / "ck"), keep_last=2, use_async=True)
    step, restored = ck.restore()
    assert step == 40
    assert len(ck._steps()) <= 2
    import jax

    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=0),
        restored["params"], res.params,
    )


def test_checkpoint_retention(tmp_path):
    from hpvpinns_tpu.training.checkpoint import Checkpointer

    prob = _tiny_problem()
    import jax

    params = prob.init_params(jax.random.key(0))
    ck = Checkpointer(str(tmp_path), keep_last=2)
    for step in (10, 20, 30, 40):
        ck.save(step, params, {"t": step})
    assert ck._steps() == [30, 40]
    assert ck.latest_step() == 40
    ck_all = Checkpointer(str(tmp_path / "all"), keep_last=0)
    for step in (1, 2, 3, 4):
        ck_all.save(step, params, {})
    assert ck_all._steps() == [1, 2, 3, 4]
