"""3D Poisson: Delta u = f on [-1, 1]^3, hp-VPINN.

No reference analog — the volumetric generalization the tensor-product
architecture makes natural (SURVEY.md §5: "high-order 2D/3D tensor-product
bases use factored contractions"): sum-factorized triple contractions
(ops/contract.py::contract_3d), fused 3-axis derivative propagation
(ops/taylor.py::taylor_fields_3d), element axis sharded like every other
problem.

Default manufactured solution (separable, steep in x like the 2D benchmark
family):  u = (0.1 sin(2 pi x) + tanh(5 x)) sin(2 pi y) sin(2 pi z).
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp

from hpvpinns_tpu.config import Poisson3DConfig
from hpvpinns_tpu.geometry.mesh import TensorMesh3D
from hpvpinns_tpu.models.mlp import MLP, mlp_apply
from hpvpinns_tpu.ops.assembly import poisson3d_residual, variational_loss
from hpvpinns_tpu.ops.taylor import taylor_fields_3d
from hpvpinns_tpu.problems.base import Problem, check_deriv_mode, make_net_init
from hpvpinns_tpu.problems.build import build_elements_3d, make_weighted_basis
from hpvpinns_tpu.spectral.quadrature import gauss_lobatto_jacobi
from hpvpinns_tpu.utils.sampling import lhs_box

OMEGA = 2 * np.pi
R1 = 5.0


def _gx(x):
    return 0.1 * np.sin(OMEGA * x) + np.tanh(R1 * x)


def _gx2(x):
    return -0.1 * OMEGA**2 * np.sin(OMEGA * x) - (2 * R1**2) * np.tanh(R1 * x) / np.cosh(R1 * x) ** 2


def u_exact(x, y, z):
    return _gx(x) * np.sin(OMEGA * y) * np.sin(OMEGA * z)


def f_rhs(x, y, z):
    """f = Delta u (same sign convention as the 2D problem)."""
    return (
        _gx2(x) * np.sin(OMEGA * y) * np.sin(OMEGA * z)
        - 2 * OMEGA**2 * _gx(x) * np.sin(OMEGA * y) * np.sin(OMEGA * z)
    )


def boundary_points(cfg: Poisson3DConfig, rng: np.random.Generator, u_ex):
    """LHS points on each of the 6 faces with exact data."""
    (xl, xr), (yl, yu), (zl, zu) = cfg.domain_x, cfg.domain_y, cfg.domain_z
    n = cfg.n_bound
    faces = []
    for fixed_axis, lo_hi in ((0, (xl, xr)), (1, (yl, yu)), (2, (zl, zu))):
        free = [b for i, b in enumerate(((xl, xr), (yl, yu), (zl, zu))) if i != fixed_axis]
        for val in lo_hi:
            pts_free = lhs_box(free, n, rng)
            pts = np.insert(pts_free, fixed_axis, val, axis=1)
            faces.append(pts)
    Xb = np.concatenate(faces)
    ub = u_ex(Xb[:, 0:1], Xb[:, 1:2], Xb[:, 2:3])
    return Xb, ub


def default_lift(X):
    """Boundary interpolant for the benchmark solution: g = x tanh(5)
    sin(2 pi y) sin(2 pi z) matches u_exact on all six faces (u vanishes on
    the y/z faces; on x = +-1, u = +-tanh(5) sin sin)."""
    return (
        X[:, 0:1] * np.tanh(R1)
        * jnp.sin(OMEGA * X[:, 1:2]) * jnp.sin(OMEGA * X[:, 2:3])
    )


def default_envelope(X):
    """D = (1-x^2)(1-y^2)(1-z^2): vanishes on the boundary of [-1,1]^3."""
    return (
        (1.0 - X[:, 0:1] ** 2) * (1.0 - X[:, 1:2] ** 2) * (1.0 - X[:, 2:3] ** 2)
    )


def build(
    cfg: Poisson3DConfig,
    rng: np.random.Generator | None = None,
    u_fn=None,
    f_fn=None,
    lift_fn=None,
    envelope_fn=None,
) -> Problem:
    """`cfg.hard_bc` (or explicit lift_fn/envelope_fn) switches on the lifted
    ansatz u = g + D * N — Dirichlet data exact by construction on all six
    faces (defaults fit the shipped benchmark solution)."""
    u_ex = u_fn or u_exact
    f_rh = f_fn or f_rhs
    dtype = jnp.dtype(cfg.dtype)
    rng = rng or np.random.default_rng(cfg.train.seed)
    mesh = TensorMesh3D.uniform(
        *cfg.domain_x, cfg.n_elements_x,
        *cfg.domain_y, cfg.n_elements_y,
        *cfg.domain_z, cfg.n_elements_z,
    )
    xq, wq = gauss_lobatto_jacobi(cfg.n_quad, 0.0, 0.0)

    ntx = cfg.n_test_x_per_elem if cfg.n_test_x_per_elem is not None else cfg.n_test_x
    nty = cfg.n_test_y_per_elem if cfg.n_test_y_per_elem is not None else cfg.n_test_y
    ntz = cfg.n_test_z_per_elem if cfg.n_test_z_per_elem is not None else cfg.n_test_z
    bx = make_weighted_basis(int(np.max(ntx)), xq, wq, dtype)
    by = make_weighted_basis(int(np.max(nty)), xq, wq, dtype)
    bz = make_weighted_basis(int(np.max(ntz)), xq, wq, dtype)
    elems = build_elements_3d(mesh, xq, wq, f_rh, ntx, nty, ntz, dtype)

    Xb, ub = boundary_points(cfg, rng, u_ex)
    data = {
        "elements": elems,
        "basis_x": bx,
        "basis_y": by,
        "basis_z": bz,
        "xb": jnp.asarray(Xb, dtype=dtype),
        "ub": jnp.asarray(ub, dtype=dtype),
    }

    spec = MLP(layers=cfg.layers, activation=cfg.activation,
               adaptive_slope=cfg.adaptive_slope, precision=cfg.matmul_precision)
    var_form, wb = cfg.var_form, cfg.lossb_weight
    mode = check_deriv_mode(cfg.deriv_mode)
    hard_bc = getattr(cfg, "hard_bc", False) or lift_fn is not None or envelope_fn is not None
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
        """Masked weak residual Res[e, m, k, r] (indicator source + the
        Gauss-Newton residual block, training/gauss_newton.py)."""
        u_fn_ = make_u_fn(params)
        el = data["elements"]
        if mode == "taylor":
            fields_fn = lambda x, y, z, **kw: taylor_fields_3d(spec, params["net"], x, y, z, **kw)
        else:
            fields_fn = None
        res = poisson3d_residual(
            u_fn_, el, data["basis_x"], data["basis_y"], data["basis_z"], var_form,
            fields_fn=fields_fn,
        )
        return res * el.mask

    def loss_fn(params, data, axis_name=None):
        u_fn_ = make_u_fn(params)
        el = data["elements"]
        res = residual_fn(params, data)
        lossv = variational_loss(res, el.mask, el.n_test)
        if axis_name is not None:
            lossv = jax.lax.psum(lossv, axis_name)
        ub_pred = u_fn_(data["xb"])
        lossb = jnp.mean((data["ub"] - ub_pred) ** 2)
        loss = wb * lossb + lossv
        return loss, {"loss": loss, "lossb": lossb, "lossv": lossv}

    # Dense-ish test grid (41^3 points).
    nt = 41
    xt = np.linspace(*cfg.domain_x, nt)
    yt = np.linspace(*cfg.domain_y, nt)
    zt = np.linspace(*cfg.domain_z, nt)
    XT, YT, ZT = np.meshgrid(xt, yt, zt, indexing="ij")
    test_points = np.stack([XT.reshape(-1), YT.reshape(-1), ZT.reshape(-1)], axis=-1)
    test_values = u_ex(test_points[:, 0:1], test_points[:, 1:2], test_points[:, 2:3])

    return Problem(
        name="poisson3d",
        config=cfg,
        spec=spec,
        data=data,
        loss_fn=loss_fn,
        init_params=make_net_init(spec, dtype=dtype),
        apply_override=(lambda params, X: make_u_fn(params)(X)) if hard_bc else None,
        exact=u_ex,
        test_points=test_points,
        test_values=test_values,
        extras={"mesh": mesh, "f_rhs": f_rh, "residual_fn": residual_fn,
                "test_grid_shape": (nt, nt, nt)},
    )
