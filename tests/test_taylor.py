"""Fused Taylor-mode propagation vs nested-JVP oracle (ops/taylor.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import hpvpinns_tpu as hv
from hpvpinns_tpu.models.mlp import MLP, init_mlp, mlp_apply
from hpvpinns_tpu.ops.fields import scalar_fields_1d, scalar_fields_2d
from hpvpinns_tpu.ops.taylor import taylor_fields_1d, taylor_fields_2d


@pytest.mark.parametrize("act", ["sin", "tanh", "gelu", "swish"])
def test_taylor_1d_matches_jvp(act):
    spec = MLP(layers=(1, 9, 7, 1), activation=act)
    params = init_mlp(spec, jax.random.key(3), dtype=jnp.float64)
    x = jnp.linspace(-1, 1, 23).reshape(1, -1)
    u_fn = lambda X: mlp_apply(spec, params, X)
    u0, ux0, uxx0 = scalar_fields_1d(u_fn, x)
    u1, ux1, uxx1 = taylor_fields_1d(spec, params, x)
    np.testing.assert_allclose(np.asarray(u1), np.asarray(u0), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(ux1), np.asarray(ux0), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(uxx1), np.asarray(uxx0), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("act", ["sin", "tanh"])
def test_taylor_2d_matches_jvp(act):
    spec = MLP(layers=(2, 8, 8, 1), activation=act)
    params = init_mlp(spec, jax.random.key(4), dtype=jnp.float64)
    x = jnp.linspace(-1, 1, 5).reshape(1, 1, 5)
    y = jnp.linspace(-0.5, 0.5, 4).reshape(1, 4, 1)
    x, y = jnp.broadcast_arrays(x, y)
    u_fn = lambda X: mlp_apply(spec, params, X)
    f0 = scalar_fields_2d(u_fn, x, y, second_y=True)
    f1 = taylor_fields_2d(spec, params, x, y, second_y=True)
    for key in ("u", "ux", "uxx", "uy", "uyy"):
        np.testing.assert_allclose(
            np.asarray(f1[key]), np.asarray(f0[key]), rtol=1e-10, atol=1e-12, err_msg=key
        )


def test_taylor_first_y_only_contract():
    spec = MLP(layers=(2, 6, 1), activation="tanh")
    params = init_mlp(spec, jax.random.key(5), dtype=jnp.float64)
    x = jnp.ones((1, 2, 2)) * 0.3
    y = jnp.ones((1, 2, 2)) * 0.1
    out = taylor_fields_2d(spec, params, x, y, first_y_only=True)
    assert set(out) == {"u", "ux", "uxx", "uy"}


@pytest.mark.parametrize("problem_cfg", [
    hv.Poisson1DConfig(dtype="float64", n_quad=12, n_test=6),
    hv.Poisson2DConfig(dtype="float64", n_quad=6),
    pytest.param(hv.AdvDiffConfig(dtype="float64"), marks=pytest.mark.slow),
])
def test_losses_and_grads_mode_invariant(problem_cfg):
    """Loss and gradients must be identical under deriv_mode 'taylor' vs 'jvp'
    for every problem family."""
    import dataclasses

    pt = hv.build(dataclasses.replace(problem_cfg, deriv_mode="taylor"))
    pj = hv.build(dataclasses.replace(problem_cfg, deriv_mode="jvp"))
    params = pt.init_params(jax.random.key(0))
    lt, _ = pt.loss_fn(params, pt.data)
    lj, _ = pj.loss_fn(params, pj.data)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-12)
    gt = jax.grad(lambda p: pt.loss_fn(p, pt.data)[0])(params)
    gj = jax.grad(lambda p: pj.loss_fn(p, pj.data)[0])(params)
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-9, atol=1e-12
        ),
        gt,
        gj,
    )


def test_adaptive_slope_taylor_matches_jvp():
    """Opt-in trainable activation slope act(s*z): the fused-propagation
    chain rule (s, s^2 factors) must match generic autodiff."""
    spec = MLP(layers=(2, 10, 10, 1), activation="tanh", adaptive_slope=True)
    params = init_mlp(spec, jax.random.key(0), dtype=jnp.float64)
    params = [dict(l, s=l["s"] * 1.3) if "s" in l else l for l in params]
    x = jnp.linspace(-1, 1, 12).reshape(1, 3, 4)
    y = x[:, ::-1] * 0.5
    u_fn = lambda X: mlp_apply(spec, params, X)
    f0 = scalar_fields_2d(u_fn, x, y)
    f1 = taylor_fields_2d(spec, params, x, y)
    for key in ("u", "ux", "uy", "uxx", "uyy"):
        np.testing.assert_allclose(
            np.asarray(f1[key]), np.asarray(f0[key]), rtol=1e-10, atol=1e-12, err_msg=key
        )


def test_adaptive_slope_trains_and_pallas_rejects():
    import hpvpinns_tpu as hv

    cfg = hv.Poisson1DConfig(
        dtype="float64", n_quad=12, n_test=6, layers=(1, 8, 1), adaptive_slope=True,
        train=hv.TrainConfig(iterations=100, check_every=50),
    )
    prob = hv.build(cfg)
    res = hv.train(prob, verbose=False)
    slopes = [float(l["s"]) for l in res.params["net"] if "s" in l]
    assert slopes and any(abs(s - 1.0) > 1e-4 for s in slopes)


@pytest.mark.parametrize(
    "cfg",
    [
        hv.Poisson1DConfig(),
        hv.Poisson2DConfig(),
        hv.Poisson3DConfig(),
        hv.Helmholtz2DConfig(),
        hv.AdvDiffConfig(),
        hv.AdvDiff2DConfig(),
        hv.BurgersConfig(),
    ],
    ids=lambda c: type(c).__name__,
)
def test_unknown_deriv_mode_raises(cfg):
    """Only the two XLA engines exist; any other deriv_mode (the removed
    "pallas" among them) fails at build time instead of falling through."""
    with pytest.raises(ValueError, match="unknown deriv_mode 'pallas'"):
        hv.build(dataclasses.replace(cfg, deriv_mode="pallas"))


def test_bench_scale_f32_matches_f64():
    """The bench-scale problem (64 elements, 16x16 quadrature, 10x10 test
    functions) in float32 at matmul precision "highest" matches its float64
    twin: loss to 1e-5 and gradient to 1e-4 relative (the tolerances
    chip_smoke.py holds the GPU to), for both derivative engines."""
    import jax

    for mode in ("taylor", "jvp"):
        cfg = dataclasses.replace(hv.poisson2d_scaled(8, 16, 10), deriv_mode=mode)
        p32 = hv.build(cfg)
        p64 = hv.build(dataclasses.replace(cfg, dtype="float64"))
        params = p32.init_params(jax.random.key(0))
        params64 = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
        grad_fn = lambda prob, p: jax.jit(jax.value_and_grad(prob.loss_fn, has_aux=True))(p, prob.data)
        (l32, _), g32 = grad_fn(p32, params)
        (l64, _), g64 = grad_fn(p64, params64)
        assert abs(float(l32) - float(l64)) <= 1e-5 * abs(float(l64)), mode
        f32 = np.concatenate([np.ravel(x) for x in jax.tree.leaves(g32)])
        f64 = np.concatenate([np.ravel(x) for x in jax.tree.leaves(g64)])
        assert np.linalg.norm(f32 - f64) <= 1e-4 * np.linalg.norm(f64), mode


def test_firsts_only_matches_full_fields_across_engines():
    """firsts_only mode (var_form-1 fast path: no second-order streams) must
    agree with the full-field engines on u, ux, uy — for taylor AND jvp."""
    spec = MLP(layers=(2, 8, 8, 1), activation="tanh")
    params = init_mlp(spec, jax.random.key(6), dtype=jnp.float64)
    x = jnp.linspace(-1, 1, 6).reshape(1, 1, 6)
    y = jnp.linspace(-0.5, 0.5, 3).reshape(1, 3, 1)
    x, y = jnp.broadcast_arrays(x, y)
    u_fn = lambda X: mlp_apply(spec, params, X)
    full = taylor_fields_2d(spec, params, x, y, second_y=True)
    ft = taylor_fields_2d(spec, params, x, y, firsts_only=True)
    fj = scalar_fields_2d(u_fn, x, y, firsts_only=True)
    assert set(ft) == set(fj) == {"u", "ux", "uy"}
    for key in ("u", "ux", "uy"):
        np.testing.assert_allclose(np.asarray(ft[key]), np.asarray(full[key]), rtol=1e-12, err_msg=key)
        np.testing.assert_allclose(np.asarray(fj[key]), np.asarray(full[key]), rtol=1e-10, atol=1e-13, err_msg=key)


@pytest.mark.slow
def test_form1_losses_unchanged_by_firsts_only_fast_path():
    """The firsts_only fast path is a pure optimization: form-1 losses and
    grads for poisson2d/advdiff/burgers must equal the jvp engine's."""
    import dataclasses

    for cfg in (
        hv.Poisson2DConfig(dtype="float64", var_form=1, n_quad=6),
        hv.AdvDiffConfig(dtype="float64", var_form=1),
        hv.BurgersConfig(dtype="float64", var_form=1, n_quad=6, layers=(2, 6, 1)),
    ):
        pt = hv.build(dataclasses.replace(cfg, deriv_mode="taylor"))
        pj = hv.build(dataclasses.replace(cfg, deriv_mode="jvp"))
        params = pt.init_params(jax.random.key(1))
        lt, _ = pt.loss_fn(params, pt.data)
        lj, _ = pj.loss_fn(params, pj.data)
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-12)
        gt = jax.grad(lambda p: pt.loss_fn(p, pt.data)[0])(params)
        gj = jax.grad(lambda p: pj.loss_fn(p, pj.data)[0])(params)
        jax.tree.map(
            lambda a, b: np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-9, atol=1e-12
            ),
            gt, gj,
        )
