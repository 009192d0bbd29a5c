"""2D Poisson benchmark: Delta u = f on [-1, 1]^2, hp-VPINN / PINN.

Problem of record (main/Poisson-2D/hp-VPINN-Poisson-2D.py):
    u(x, y) = (0.1 sin(2 pi x) + tanh(10 x)) sin(2 pi y)   (:300-305)
    f = Delta u                                            (:307-310)
    boundary data: 80 LHS points per edge                  (:313-347)
    VPINN loss = 10 lossb + lossv; PINN loss = 10 lossb + lossp  (:126-129)
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp

from hpvpinns_tpu.config import Poisson2DConfig
from hpvpinns_tpu.geometry.mesh import TensorMesh2D
from hpvpinns_tpu.models.mlp import MLP, mlp_apply
from hpvpinns_tpu.ops.assembly import poisson2d_residual, variational_loss
from hpvpinns_tpu.ops.fields import scalar_fields_2d
from hpvpinns_tpu.ops.taylor import taylor_fields_2d
from hpvpinns_tpu.problems.base import Problem, check_deriv_mode, make_net_init
from hpvpinns_tpu.problems.build import build_elements_2d
from hpvpinns_tpu.problems.build import make_weighted_basis
from hpvpinns_tpu.spectral.quadrature import gauss_lobatto_jacobi
from hpvpinns_tpu.utils.sampling import lhs_box, lhs_interval

OMEGA_X = 2 * np.pi
OMEGA_Y = 2 * np.pi
R1 = 10.0


def u_exact(x, y):
    """Poisson-2D.py:303-305."""
    return (0.1 * np.sin(OMEGA_X * x) + np.tanh(R1 * x)) * np.sin(OMEGA_Y * y)


def f_rhs(x, y):
    """f = Delta u (Poisson-2D.py:307-310)."""
    return (
        -0.1 * OMEGA_X**2 * np.sin(OMEGA_X * x)
        - (2 * R1**2) * np.tanh(R1 * x) / np.cosh(R1 * x) ** 2
    ) * np.sin(OMEGA_Y * y) + (0.1 * np.sin(OMEGA_X * x) + np.tanh(R1 * x)) * (
        -(OMEGA_Y**2) * np.sin(OMEGA_Y * y)
    )


def boundary_points(cfg: Poisson2DConfig, rng: np.random.Generator, u_ex=u_exact):
    """80 LHS points per edge with exact data (Poisson-2D.py:313-347)."""
    (xl, xr), (yl, yu) = cfg.domain_x, cfg.domain_y
    n = cfg.n_bound
    edges = []
    for _ in range(2):  # up, lo: x varies
        x = lhs_interval(xl, xr, n, rng)
        edges.append(np.hstack([x, np.full_like(x, yu if _ == 0 else yl)]))
    for _ in range(2):  # ri, le: y varies
        y = lhs_interval(yl, yu, n, rng)
        edges.append(np.hstack([np.full_like(y, xr if _ == 0 else xl), y]))
    Xb = np.concatenate(edges)
    ub = u_ex(Xb[:, 0:1], Xb[:, 1:2])
    return Xb, ub


def default_lift(X):
    """Boundary interpolant g for the benchmark solution: g = x tanh(10)
    sin(2 pi y) matches u_exact on all four edges (u vanishes at y = +-1)."""
    return X[:, 0:1] * np.tanh(R1) * jnp.sin(OMEGA_Y * X[:, 1:2])


def default_envelope(X):
    """D(x, y) = (1 - x^2)(1 - y^2): vanishes on the boundary of [-1,1]^2."""
    return (1.0 - X[:, 0:1] ** 2) * (1.0 - X[:, 1:2] ** 2)


def build(
    cfg: Poisson2DConfig,
    rng: np.random.Generator | None = None,
    u_fn=None,
    f_fn=None,
    lift_fn=None,
    envelope_fn=None,
) -> Problem:
    """`lift_fn`/`envelope_fn` (jnp-traceable [P,2] -> [P,1]) switch on the
    hard-BC ansatz u = lift + envelope * N: the boundary condition is exact
    by construction, the boundary loss vanishes, and all network capacity
    goes to the PDE (default_lift/default_envelope fit the shipped benchmark
    solution).  Derivative fields then come from the generic JVP engine (the composite is no longer a bare MLP).

    `u_fn`/`f_fn` override the exact solution and forcing (numpy-vectorized
    (x, y) -> value; f = Delta u convention, Poisson-2D.py:307-310)."""
    u_ex = u_fn or u_exact
    f_rh = f_fn or f_rhs
    dtype = jnp.dtype(cfg.dtype)
    rng = rng or np.random.default_rng(cfg.train.seed)
    if cfg.grid_x is not None or cfg.grid_y is not None:
        from hpvpinns_tpu.geometry.mesh import Interval1D

        ax = (
            Interval1D(np.asarray(cfg.grid_x, dtype=np.float64))
            if cfg.grid_x is not None
            else Interval1D.uniform(*cfg.domain_x, cfg.n_elements_x)
        )
        ay = (
            Interval1D(np.asarray(cfg.grid_y, dtype=np.float64))
            if cfg.grid_y is not None
            else Interval1D.uniform(*cfg.domain_y, cfg.n_elements_y)
        )
        mesh = TensorMesh2D(axis_x=ax, axis_y=ay)
    else:
        mesh = TensorMesh2D.uniform(
            *cfg.domain_x, cfg.n_elements_x, *cfg.domain_y, cfg.n_elements_y
        )
    xq, wq = gauss_lobatto_jacobi(cfg.n_quad, 0.0, 0.0)

    ntx = (
        np.asarray(cfg.n_test_x_per_elem)
        if cfg.n_test_x_per_elem is not None
        else np.full(mesh.axis_x.n_elem, cfg.n_test_x)
    )
    nty = (
        np.asarray(cfg.n_test_y_per_elem)
        if cfg.n_test_y_per_elem is not None
        else np.full(mesh.axis_y.n_elem, cfg.n_test_y)
    )
    bx = make_weighted_basis(int(ntx.max()), xq, wq, dtype)
    by = make_weighted_basis(int(nty.max()), xq, wq, dtype)
    elems = build_elements_2d(mesh, xq, wq, xq, wq, f_rh, ntx, nty, dtype)

    Xb, ub = boundary_points(cfg, rng, u_ex)

    # PINN-mode residual collocation points (Poisson-2D.py:350-356).
    Xf = lhs_box([cfg.domain_x, cfg.domain_y], cfg.n_residual, rng)
    ff = f_rh(Xf[:, 0:1], Xf[:, 1:2])

    data = {
        "elements": elems,
        "basis_x": bx,
        "basis_y": by,
        "xb": jnp.asarray(Xb, dtype=dtype),
        "ub": jnp.asarray(ub, dtype=dtype),
        "xf": jnp.asarray(Xf, dtype=dtype),
        "ff": jnp.asarray(ff, dtype=dtype),
    }

    spec = MLP(layers=cfg.layers, activation=cfg.activation,
               adaptive_slope=cfg.adaptive_slope, precision=cfg.matmul_precision)
    var_form, scheme, wb = cfg.var_form, cfg.scheme, cfg.lossb_weight
    mode = check_deriv_mode(cfg.deriv_mode)
    if scheme not in ("VPINNs", "PINNs"):
        raise ValueError(f"scheme must be 'VPINNs' or 'PINNs'; got {scheme!r}")
    if scheme == "VPINNs" and var_form == 2:
        # The verbatim reference form 2 (Poisson-2D.py:108-115) is only a
        # consistent weak form on a single [-1,1]^2 element (missing 1/jac^2
        # scalings and the boundary flux) — warn when that precondition fails.
        on_ref_elem = (
            cfg.n_elements_x == 1
            and cfg.n_elements_y == 1
            and cfg.domain_x == (-1.0, 1.0)
            and cfg.domain_y == (-1.0, 1.0)
        )
        if not on_ref_elem:
            import warnings

            warnings.warn(
                "Poisson-2D var_form=2 replicates the reference's inconsistent "
                "twice-integrated form (Poisson-2D.py:108-115): it is only a "
                "valid weak form on a single [-1,1]^2 element. Use var_form "
                "'2c' for the mathematically correct twice-IBP form, or 0/1.",
                stacklevel=2,
            )
    hard_bc = cfg.hard_bc or lift_fn is not None or envelope_fn is not None
    if hard_bc:
        from hpvpinns_tpu.problems.base import make_composite_apply

        lift = lift_fn or default_lift
        envelope = envelope_fn or default_envelope
        mode = "jvp"  # composite ansatz: generic autodiff engine
        composite = make_composite_apply(spec, lift, envelope)

    def make_u_fn(params):
        if hard_bc:
            return composite(params)
        return lambda X: mlp_apply(spec, params["net"], X)

    def residual_fn(params, data):
        """Masked weak residual Res[e, k, r] — the per-element indicator
        source for adaptive refinement (adaptive.py)."""
        u_fn = make_u_fn(params)
        if mode == "taylor":
            fields_fn = lambda x, y, **kw: taylor_fields_2d(spec, params["net"], x, y, **kw)
        else:
            fields_fn = None
        el = data["elements"]
        res = poisson2d_residual(
            u_fn, el, data["basis_x"], data["basis_y"], var_form, fields_fn=fields_fn
        )
        return res * el.mask

    _enriched_cache = {}

    def enriched_residual_fn(params, enrich: int = 3):
        """Weak residual against the tensor test modes NOT in the training
        basis (either index beyond it): hierarchical a-posteriori estimation,
        the 2D twin of poisson1d's (see adaptive.element_indicator).
        Returns [E, K+enrich, R+enrich] with the trained block zeroed."""
        n_x = int(ntx.max()) + enrich
        n_y = int(nty.max()) + enrich
        key = (n_x, n_y)
        if key not in _enriched_cache:
            bx_en = make_weighted_basis(n_x, xq, wq, dtype)
            by_en = make_weighted_basis(n_y, xq, wq, dtype)
            elems_en = build_elements_2d(
                mesh, xq, wq, xq, wq, f_rh,
                np.full(mesh.axis_x.n_elem, n_x), np.full(mesh.axis_y.n_elem, n_y),
                dtype,
            )
            # keep only genuinely NEW modes: zero the trained (k, r) block
            new_mask = np.ones((n_y, n_x))
            new_mask[: int(nty.max()), : int(ntx.max())] = 0.0
            _enriched_cache[key] = (bx_en, by_en, elems_en, jnp.asarray(new_mask, dtype=dtype))
        bx_en, by_en, elems_en, new_mask = _enriched_cache[key]
        u_fn = make_u_fn(params)
        res = poisson2d_residual(u_fn, elems_en, bx_en, by_en, var_form)
        return res * new_mask[None]

    def loss_fn(params, data, axis_name=None):
        u_fn = make_u_fn(params)
        el = data["elements"]
        ub_pred = u_fn(data["xb"])
        lossb = jnp.mean((data["ub"] - ub_pred) ** 2)
        aux = {"lossb": lossb}
        if scheme == "VPINNs":
            res = residual_fn(params, data)
            lossv = variational_loss(res, el.mask, el.n_test)
            if axis_name is not None:  # explicit all-reduce (shard_map path)
                lossv = jax.lax.psum(lossv, axis_name)
            loss = wb * lossb + lossv
            aux["lossv"] = lossv
        else:  # strong-form PINN comparison mode (Poisson-2D.py:124,128-129)
            flds = scalar_fields_2d(
                u_fn, data["xf"][:, 0:1], data["xf"][:, 1:2], second_y=True
            )
            f_pred = flds["uxx"] + flds["uyy"]
            lossp = jnp.mean((f_pred - data["ff"]) ** 2)
            loss = wb * lossb + lossp
            aux["lossp"] = lossp
        aux["loss"] = loss
        return loss, aux

    # Dense test grid, 201 x 201 at delta 0.01 (Poisson-2D.py:418-426).
    xt = np.arange(cfg.domain_x[0], cfg.domain_x[1] + 0.01, 0.01)
    yt = np.arange(cfg.domain_y[0], cfg.domain_y[1] + 0.01, 0.01)
    XT, YT = np.meshgrid(xt, yt)
    test_points = np.stack([XT.reshape(-1), YT.reshape(-1)], axis=-1)
    test_values = u_ex(test_points[:, 0:1], test_points[:, 1:2])

    return Problem(
        name="poisson2d",
        config=cfg,
        spec=spec,
        data=data,
        loss_fn=loss_fn,
        init_params=make_net_init(spec, dtype=dtype),
        apply_override=(lambda params, X: make_u_fn(params)(X)) if hard_bc else None,
        exact=u_ex,
        test_points=test_points,
        test_values=test_values,
        extras={
            "mesh": mesh,
            "f_rhs": f_rh,
            "residual_fn": residual_fn,
            "enriched_residual_fn": enriched_residual_fn,
            "test_grid_shape": (len(yt), len(xt)),
        },
    )
