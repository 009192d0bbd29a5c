"""2D space-time advection-diffusion with inverse coefficient identification.

    u_t + vx u_x + vy u_y - eps (u_xx + u_yy) = f   on [-1,1]^2 x [0,T]

The 2-space-dimension generalization of the reference's 1D inverse family
(AdvDiff.py:161-180 for the weak form; :63 for the trainable coefficient) —
no reference analog.  It composes existing framework tiers: the 3D
tensor-product machinery (sum-factorized triple contractions, time as the
slowest axis) with the 1D family's identification pipeline (trainable pde
leaves, interior sensors, manufactured forcing).

The problem is MANUFACTURED: there is no closed-form solution of the
homogeneous 2D advection-diffusion IBVP on a box, so the framework poses the
forced equation with

    u(x, y, t) = sin(pi x) sin(pi y) e^{-t}

(homogeneous on all four side walls) and the exactly matching forcing; the
ground truth enters only through f, the t = 0 face, and the sensor readings
— the same construction as the 1D family's spatially-varying-velocity mode
(problems/advdiff.py::make_manufactured).
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp

from hpvpinns_tpu.config import AdvDiff2DConfig
from hpvpinns_tpu.geometry.mesh import TensorMesh3D
from hpvpinns_tpu.models.mlp import MLP, mlp_apply
from hpvpinns_tpu.ops.assembly import advdiff2d_residual, variational_loss
from hpvpinns_tpu.ops.taylor import taylor_fields_3d
from hpvpinns_tpu.problems.base import Problem, check_deriv_mode, make_net_init
from hpvpinns_tpu.problems.build import build_elements_3d, make_weighted_basis
from hpvpinns_tpu.spectral.quadrature import gauss_lobatto_jacobi
from hpvpinns_tpu.utils.sampling import lhs_box, lhs_interval


def u_exact(x, y, t):
    """The manufactured solution (host numpy; broadcastable arrays)."""
    return np.sin(np.pi * x) * np.sin(np.pi * y) * np.exp(-t)


def make_forcing(cfg: AdvDiff2DConfig, eps_fn=None):
    """f = u_t + vx u_x + vy u_y - eps (u_xx + u_yy) for the manufactured u
    at the TRUE coefficients (host float64, projected offline).  `eps_fn`
    poses a TRUE space-dependent diffusivity MAP eps(x, y) — beyond the
    family's scalar coefficient (generic array ops: called on host numpy
    here and, for forward runs, on device arrays in the weak form)."""
    vx, vy = cfg.velocity
    eps_scalar = cfg.gamma / np.pi

    def f_fn(X, Y, T):
        sx, cx = np.sin(np.pi * X), np.cos(np.pi * X)
        sy, cy = np.sin(np.pi * Y), np.cos(np.pi * Y)
        eps = eps_fn(X, Y) if eps_fn is not None else eps_scalar
        return np.exp(-T) * (
            -sx * sy
            + vx * np.pi * cx * sy
            + vy * np.pi * sx * cy
            + 2.0 * eps * np.pi**2 * sx * sy
        )

    return f_fn


def training_data(cfg: AdvDiff2DConfig, rng: np.random.Generator):
    """Side-wall + initial-face + interior-sensor data (the 2D twin of the
    1D family's layout, AdvDiff.py:357-384,464-483)."""
    T = cfg.t_final
    (xl, xr), (yl, yr) = cfg.domain_x, cfg.domain_y
    n = cfg.n_bound
    pts, vals = [], []
    # Four side walls: fix x or y, LHS over (other-space, t).
    for fixed_axis, lo_hi, free in (
        (0, (xl, xr), [(yl, yr), (0.0, T)]),
        (1, (yl, yr), [(xl, xr), (0.0, T)]),
    ):
        for val in lo_hi:
            free_pts = lhs_box(free, n, rng)
            p = np.insert(free_pts, fixed_axis, val, axis=1)
            pts.append(p)
            vals.append(u_exact(p[:, 0:1], p[:, 1:2], p[:, 2:3]))
    # Initial face t = 0.
    xy = lhs_box([(xl, xr), (yl, yr)], n, rng)
    p0 = np.hstack([xy, np.zeros((n, 1))])
    pts.append(p0)
    vals.append(u_exact(p0[:, 0:1], p0[:, 1:2], p0[:, 2:3]))
    # Interior sensors: fixed (x, y) stations, LHS times, exact readings
    # (+ optional measurement noise on the readings only).
    noise_rng = np.random.default_rng(rng.integers(0, 2**31))
    for sx, sy in cfg.sensor_stations:
        ts = T * lhs_interval(0, 1, cfg.n_sensors_per_station, rng)
        p = np.hstack([np.full_like(ts, sx), np.full_like(ts, sy), ts])
        pts.append(p)
        reading = u_exact(p[:, 0:1], p[:, 1:2], p[:, 2:3])
        if cfg.sensor_noise_std > 0:
            reading = reading + noise_rng.normal(0.0, cfg.sensor_noise_std, reading.shape)
        vals.append(reading)
    return np.concatenate(pts), np.concatenate(vals)


def build(
    cfg: AdvDiff2DConfig,
    rng: np.random.Generator | None = None,
    epsilon_fn=None,
) -> Problem:
    """`epsilon_fn(x, y)` poses the manufactured problem at a TRUE
    space-dependent diffusivity map (jnp-traceable, generic array ops):
    the forcing, the forward weak form (exact autodiff eps_x/eps_y through
    the IBP terms), and extras["epsilon_fn"] all carry it.  Identification
    of the map itself is the two-phase linear fit
    (inverse.fit_epsilon_field2d) — the family's trainable coefficient
    stays the reference-style scalar."""
    dtype = jnp.dtype(cfg.dtype)
    rng = rng or np.random.default_rng(cfg.train.seed)
    if epsilon_fn is not None:
        _gx = np.linspace(*cfg.domain_x, 257)
        _gy = np.linspace(*cfg.domain_y, 257)
        _GX, _GY = np.meshgrid(_gx, _gy, indexing="ij")
        eps_true = float(np.mean(np.asarray(epsilon_fn(_GX, _GY))))
    else:
        eps_true = cfg.gamma / np.pi
    if cfg.grid_x is not None or cfg.grid_y is not None or cfg.grid_t is not None:
        from hpvpinns_tpu.geometry.mesh import Interval1D

        def _axis(grid, lo, hi, n):
            if grid is not None:
                return Interval1D(np.asarray(grid, dtype=np.float64))
            return Interval1D.uniform(lo, hi, n)

        mesh = TensorMesh3D(
            axis_x=_axis(cfg.grid_x, *cfg.domain_x, cfg.n_elements_x),
            axis_y=_axis(cfg.grid_y, *cfg.domain_y, cfg.n_elements_y),
            axis_z=_axis(cfg.grid_t, 0.0, cfg.t_final, cfg.n_elements_t),
        )
    else:
        mesh = TensorMesh3D.uniform(
            *cfg.domain_x, cfg.n_elements_x,
            *cfg.domain_y, cfg.n_elements_y,
            0.0, cfg.t_final, cfg.n_elements_t,
        )
    xq, wq = gauss_lobatto_jacobi(cfg.n_quad, 0.0, 0.0)
    ntx = cfg.n_test_x_per_elem if cfg.n_test_x_per_elem is not None else cfg.n_test_x
    nty = cfg.n_test_y_per_elem if cfg.n_test_y_per_elem is not None else cfg.n_test_y
    ntt = cfg.n_test_t_per_elem if cfg.n_test_t_per_elem is not None else cfg.n_test_t
    nx_max, ny_max, nt_max = (int(np.max(v)) for v in (ntx, nty, ntt))
    bx = make_weighted_basis(nx_max, xq, wq, dtype)
    by = make_weighted_basis(ny_max, xq, wq, dtype)
    bt = make_weighted_basis(nt_max, xq, wq, dtype)
    f_fn = make_forcing(cfg, eps_fn=epsilon_fn)
    elems = build_elements_3d(mesh, xq, wq, f_fn, ntx, nty, ntt, dtype)

    Xb, ub = training_data(cfg, rng)
    data = {
        "elements": elems,
        "basis_x": bx,
        "basis_y": by,
        "basis_t": bt,
        "xb": jnp.asarray(Xb, dtype=dtype),
        "ub": jnp.asarray(ub, dtype=dtype),
    }

    spec = MLP(layers=cfg.layers, activation=cfg.activation,
               adaptive_slope=cfg.adaptive_slope, precision=cfg.matmul_precision)
    var_form, wb = cfg.var_form, cfg.lossb_weight
    inverse = cfg.inverse
    mode = check_deriv_mode(cfg.deriv_mode)
    vx_true, vy_true = cfg.velocity

    def pde_init():
        if not inverse:
            return {}
        pde = {"epsilon": jnp.asarray(cfg.epsilon_init, dtype=dtype)}
        if cfg.velocity_trainable:
            pde["velocity"] = jnp.asarray(cfg.velocity_init, dtype=dtype)
        return pde

    def eps_of(params):
        return params["pde"]["epsilon"] if inverse else eps_true

    def v_of(params):
        """(vx, vy) — trainable vector leaf or the true constants."""
        if inverse and cfg.velocity_trainable:
            v = params["pde"]["velocity"]
            return v[0], v[1]
        return vx_true, vy_true

    def _eps_args(params, x, y):
        """(eps, eps_x, eps_y) for the weak form: the trainable scalar, or
        the TRUE field with exact autodiff derivatives on forward runs."""
        if epsilon_fn is not None and not inverse:
            e = epsilon_fn(x, y)
            _, ex = jax.jvp(lambda q: epsilon_fn(q, y), (x,), (jnp.ones_like(x),))
            _, ey = jax.jvp(lambda q: epsilon_fn(x, q), (y,), (jnp.ones_like(y),))
            return e, ex, ey
        return eps_of(params), 0.0, 0.0

    def _fields_fn(params):
        if mode == "taylor":
            return lambda x, y, z, **kw: taylor_fields_3d(spec, params["net"], x, y, z, **kw)
        return None

    def residual_fn(params, data):
        """Masked weak residual Res[e, m, k, r] — the per-element indicator
        source for adaptive refinement (adaptive.py)."""
        el = data["elements"]
        vx, vy = v_of(params)
        e, ex, ey = _eps_args(params, el.x, el.y)
        res = advdiff2d_residual(
            lambda X: mlp_apply(spec, params["net"], X), el,
            data["basis_x"], data["basis_y"], data["basis_t"],
            var_form, vx, vy, e, fields_fn=_fields_fn(params),
            epsilon_x=ex, epsilon_y=ey,
        )
        return res * el.mask

    _enriched_cache = {}

    def enriched_residual_fn(params, enrich: int = 2):
        """Weak residual against the tensor test modes NOT in the training
        basis — hierarchical a-posteriori estimation on the 3D space-time
        family.  Returns [E, M+e, K+e, R+e] with the trained block zeroed."""
        n_x, n_y, n_t = nx_max + enrich, ny_max + enrich, nt_max + enrich
        key = (n_x, n_y, n_t)
        if key not in _enriched_cache:
            bx_en = make_weighted_basis(n_x, xq, wq, dtype)
            by_en = make_weighted_basis(n_y, xq, wq, dtype)
            bt_en = make_weighted_basis(n_t, xq, wq, dtype)
            elems_en = build_elements_3d(mesh, xq, wq, f_fn, n_x, n_y, n_t, dtype)
            new_mask = np.ones((n_t, n_y, n_x))
            new_mask[:nt_max, :ny_max, :nx_max] = 0.0
            _enriched_cache[key] = (
                bx_en, by_en, bt_en, elems_en, jnp.asarray(new_mask, dtype=dtype)
            )
        bx_en, by_en, bt_en, elems_en, new_mask = _enriched_cache[key]
        vx, vy = v_of(params)
        e, ex, ey = _eps_args(params, elems_en.x, elems_en.y)
        res = advdiff2d_residual(
            lambda X: mlp_apply(spec, params["net"], X), elems_en,
            bx_en, by_en, bt_en, var_form, vx, vy, e,
            fields_fn=_fields_fn(params), epsilon_x=ex, epsilon_y=ey,
        )
        return res * new_mask[None]

    def loss_fn(params, data, axis_name=None):
        u_fn = lambda X: mlp_apply(spec, params["net"], X)
        el = data["elements"]
        if mode == "taylor":
            fields_fn = lambda x, y, z, **kw: taylor_fields_3d(spec, params["net"], x, y, z, **kw)
        else:
            fields_fn = None
        vx, vy = v_of(params)
        e, ex, ey = _eps_args(params, el.x, el.y)
        res = advdiff2d_residual(
            u_fn, el, data["basis_x"], data["basis_y"], data["basis_t"],
            var_form, vx, vy, e, fields_fn=fields_fn,
            epsilon_x=ex, epsilon_y=ey,
        )
        lossv = variational_loss(res, el.mask, el.n_test)
        if axis_name is not None:  # explicit all-reduce (shard_map path)
            lossv = jax.lax.psum(lossv, axis_name)
        ub_pred = u_fn(data["xb"])
        lossb = jnp.mean((data["ub"] - ub_pred) ** 2)
        loss = wb * lossb + lossv
        aux = {"loss": loss, "lossb": lossb, "lossv": lossv}
        if inverse:
            aux["epsilon"] = params["pde"]["epsilon"]
            if cfg.velocity_trainable:
                vx_, vy_ = v_of(params)
                aux["vx"] = vx_
                aux["vy"] = vy_
                aux["velocity"] = jnp.sqrt(vx_ * vx_ + vy_ * vy_)  # |V| trajectory
        return loss, aux

    # Test grid: 33 x 33 space at 11 time slices.
    xt = np.linspace(*cfg.domain_x, 33)
    yt = np.linspace(*cfg.domain_y, 33)
    tt = np.linspace(0.0, cfg.t_final, 11)
    XT, YT, TT = np.meshgrid(xt, yt, tt, indexing="ij")
    test_points = np.stack([XT.reshape(-1), YT.reshape(-1), TT.reshape(-1)], axis=-1)
    test_values = u_exact(test_points[:, 0:1], test_points[:, 1:2], test_points[:, 2:3])

    return Problem(
        name="advdiff2d",
        config=cfg,
        spec=spec,
        data=data,
        loss_fn=loss_fn,
        init_params=make_net_init(spec, pde_init=pde_init, dtype=dtype),
        exact=u_exact,
        test_points=test_points,
        test_values=test_values,
        extras={
            "mesh": mesh,
            "residual_fn": residual_fn,
            "enriched_residual_fn": enriched_residual_fn,
            "epsilon_fn": epsilon_fn,
            "eps_true": eps_true,
            "eps_domain_mean": lambda params: (
                float(np.asarray(params["pde"]["epsilon"])) if inverse else eps_true
            ),
            "velocity_true": float(np.hypot(vx_true, vy_true)),
            "v_of": v_of,
            "f_rhs": f_fn,
            "test_grid_shape": (33, 33, 11),
        },
    )
