"""Config-space fuzz: random small configurations must build, train a few
steps, and evaluate without crashing (construction robustness net)."""

import numpy as np
import pytest

import hpvpinns_tpu as hv

def _rng(name: str, trial: int):
    """Per-test deterministic stream: failures reproduce in isolation.
    (Stable across processes — no salted str hash.)"""
    return np.random.default_rng([20260816, trial, sum(name.encode())])


def _tc(RNG):
    return hv.TrainConfig(iterations=int(RNG.integers(5, 25)), check_every=5)


def _any_activation(RNG):
    return str(RNG.choice(["sin", "tanh", "gelu", "swish"]))


@pytest.mark.parametrize("trial", range(6))
def test_fuzz_poisson1d(trial):
    RNG = _rng("p1d", trial)
    n_elem = int(RNG.integers(1, 5))
    cfg = hv.Poisson1DConfig(
        dtype=str(RNG.choice(["float32", "float64"])),
        activation=_any_activation(RNG),
        var_form=int(RNG.choice([1, 2, 3])),
        n_elements=n_elem,
        n_test=int(RNG.integers(2, 12)),
        n_quad=int(RNG.integers(4, 24)),
        layers=(1,) + tuple(int(RNG.integers(3, 12)) for _ in range(int(RNG.integers(1, 3)))) + (1,),
        adaptive_slope=bool(RNG.integers(0, 2)),
        deriv_mode=str(RNG.choice(["taylor", "jvp"])),
        train=_tc(RNG),
    )
    prob = hv.build(cfg)
    res = hv.train(prob, verbose=False)
    assert np.isfinite(res.final_aux["loss"])
    assert np.isfinite(hv.evaluate_problem(prob, res.params)["rel_l2"])


@pytest.mark.parametrize("trial", range(4))
def test_fuzz_poisson2d(trial):
    RNG = _rng("p2d", trial)
    cfg = hv.Poisson2DConfig(
        dtype="float64",
        activation=_any_activation(RNG),
        scheme=str(RNG.choice(["VPINNs", "PINNs"])),
        var_form=int(RNG.choice([0, 1, 2])),
        n_elements_x=int(RNG.integers(1, 4)),
        n_elements_y=int(RNG.integers(1, 4)),
        n_test_x=int(RNG.integers(2, 6)),
        n_test_y=int(RNG.integers(2, 6)),
        n_quad=int(RNG.integers(4, 10)),
        n_bound=int(RNG.integers(4, 30)),
        layers=(2, int(RNG.integers(3, 10)), 1),
        deriv_mode=str(RNG.choice(["taylor", "jvp"])),
        train=_tc(RNG),
    )
    prob = hv.build(cfg)
    res = hv.train(prob, verbose=False)
    assert np.isfinite(res.final_aux["loss"])


@pytest.mark.parametrize("trial", range(3))
def test_fuzz_advdiff(trial):
    RNG = _rng("adv", trial)
    cfg = hv.AdvDiffConfig(
        dtype="float64",
        var_form=int(RNG.choice([0, 1])),
        epsilon_model=str(RNG.choice(["scalar", "quadratic"])),
        inverse=bool(RNG.integers(0, 2)),
        n_elements_x=int(RNG.integers(1, 3)),
        n_elements_t=int(RNG.integers(1, 3)),
        n_test_x=int(RNG.integers(2, 6)),
        n_test_t=int(RNG.integers(2, 6)),
        n_quad=int(RNG.integers(4, 10)),
        velocity=float(RNG.uniform(0.2, 2.0)),
        layers=(2, int(RNG.integers(3, 10)), 1),
        train=_tc(RNG),
    )
    prob = hv.build(cfg)
    res = hv.train(prob, verbose=False)
    assert np.isfinite(res.final_aux["loss"])


@pytest.mark.parametrize("trial", range(2))
def test_fuzz_poisson3d(trial):
    RNG = _rng("p3d", trial)
    cfg = hv.Poisson3DConfig(
        dtype="float64",
        var_form=int(RNG.choice([0, 1])),
        n_elements_x=int(RNG.integers(1, 3)),
        n_elements_y=1,
        n_elements_z=int(RNG.integers(1, 3)),
        n_test_x=int(RNG.integers(2, 4)),
        n_test_y=2,
        n_test_z=int(RNG.integers(2, 4)),
        n_quad=int(RNG.integers(3, 6)),
        layers=(3, int(RNG.integers(3, 8)), 1),
        train=_tc(RNG),
    )
    prob = hv.build(cfg)
    res = hv.train(prob, verbose=False)
    assert np.isfinite(res.final_aux["loss"])


@pytest.mark.parametrize("trial", range(2))
def test_fuzz_burgers(trial):
    RNG = _rng("burg", trial)
    cfg = hv.BurgersConfig(
        dtype="float64",
        var_form=int(RNG.choice([0, 1])),
        hard_bc=bool(RNG.integers(0, 2)),
        n_elements_x=int(RNG.integers(1, 3)),
        n_elements_t=int(RNG.integers(1, 3)),
        n_test_x=int(RNG.integers(2, 6)),
        n_test_t=int(RNG.integers(2, 6)),
        n_quad=int(RNG.integers(4, 10)),
        nu=float(RNG.uniform(0.02, 0.3)),
        layers=(2, int(RNG.integers(3, 10)), 1),
        train=_tc(RNG),
    )
    prob = hv.build(cfg)
    res = hv.train(prob, verbose=False)
    assert np.isfinite(res.final_aux["loss"])


@pytest.mark.parametrize("trial", range(3))
def test_fuzz_helmholtz2d(trial):
    RNG = _rng("helm", trial)
    cfg = hv.Helmholtz2DConfig(
        dtype="float64",
        activation=_any_activation(RNG),
        var_form=int(RNG.choice([0, 1])),
        hard_bc=bool(RNG.integers(0, 2)),
        inverse=bool(RNG.integers(0, 2)),
        n_elements_x=int(RNG.integers(1, 4)),
        n_elements_y=int(RNG.integers(1, 4)),
        n_test_x=int(RNG.integers(2, 6)),
        n_test_y=int(RNG.integers(2, 6)),
        n_quad=int(RNG.integers(4, 10)),
        n_bound=int(RNG.integers(4, 30)),
        n_sensors=int(RNG.integers(4, 20)),
        k=float(RNG.uniform(1.0, 9.0)),
        wave_angle_deg=float(RNG.uniform(0.0, 90.0)),
        layers=(2, int(RNG.integers(3, 10)), 1),
        deriv_mode=str(RNG.choice(["taylor", "jvp"])),
        train=_tc(RNG),
    )
    prob = hv.build(cfg)
    res = hv.train(prob, verbose=False)
    assert np.isfinite(res.final_aux["loss"])
    assert np.isfinite(hv.evaluate_problem(prob, res.params)["rel_l2"])


def test_matmul_precision_reaches_spec():
    """matmul_precision flows from every problem config into the MLP spec
    (on the GPU it decides between full-FP32 and TF32 float32 matmuls)."""
    import hpvpinns_tpu as hv

    for cfg_cls in (
        hv.Poisson1DConfig, hv.Poisson2DConfig, hv.Poisson3DConfig,
        hv.AdvDiffConfig, hv.BurgersConfig, hv.AdvDiff2DConfig,
        hv.Helmholtz2DConfig,
    ):
        cfg = cfg_cls(matmul_precision="high")
        prob = hv.build(cfg)
        assert prob.spec.precision == "high", cfg_cls.__name__
