"""Steady incompressible Navier-Stokes — Kovasznay flow.

The framework's first SYSTEM of coupled PDEs (no reference analog:
every family in ehsankharazmi/hp-VPINNs is a scalar PDE).  A single
3-output ansatz w = (u, v, p) is trained against the stacked weak
residual of x/y-momentum + continuity (ops/assembly.py::ns_residual);
the problem-module structure mirrors the scalar families'
(problems/poisson2d.py ← Poisson-2D.py:30-257).

Exact solution (Kovasznay 1948), the standard laminar-wake benchmark:

    lam = Re/2 - sqrt(Re^2/4 + 4 pi^2)
    u   = 1 - e^{lam x} cos(2 pi y)
    v   = (lam / 2 pi) e^{lam x} sin(2 pi y)
    p   = (1 - e^{2 lam x}) / 2

which satisfies the system exactly for nu = 1/Re (both momentum
components reduce to the quadratic nu lam^2 - lam - 4 pi^2 nu = 0).

Inverse mode: nu = params["pde"]["nu"] is trainable and identified from
interior (u, v) sensors — the Navier-Stokes twin of the reference's
trainable-epsilon advection-diffusion problem (AdvDiff.py:63,165,173).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from hpvpinns_tpu.config import KovasznayConfig
from hpvpinns_tpu.geometry.mesh import Interval1D, TensorMesh2D
from hpvpinns_tpu.models.mlp import MLP, mlp_apply
from hpvpinns_tpu.ops.assembly import ns_residual, variational_loss
from hpvpinns_tpu.problems.base import Problem, make_net_init
from hpvpinns_tpu.problems.build import build_elements_2d, make_weighted_basis
from hpvpinns_tpu.spectral.quadrature import gauss_lobatto_jacobi
from hpvpinns_tpu.utils.sampling import lhs_interval


def lam_of(re: float) -> float:
    return re / 2.0 - np.sqrt(re * re / 4.0 + 4.0 * np.pi**2)


def exact_fields(x, y, re: float):
    """(u, v, p) of the Kovasznay solution, float64 host math.

    x, y: broadcastable arrays; returns three arrays of the broadcast shape.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    lam = lam_of(re)
    ex = np.exp(lam * x)
    u = 1.0 - ex * np.cos(2.0 * np.pi * y)
    v = (lam / (2.0 * np.pi)) * ex * np.sin(2.0 * np.pi * y)
    p = 0.5 * (1.0 - np.exp(2.0 * lam * x))
    u, v, p = np.broadcast_arrays(u, v, p)
    return u, v, p


def exact_stacked(x, y, re: float):
    """Exact (u, v, p) stacked on a trailing component axis [..., 3]."""
    u, v, p = exact_fields(x, y, re)
    return np.stack([u, v, p], axis=-1)


def training_data(cfg: KovasznayConfig, rng: np.random.Generator):
    """LHS boundary points on the four edges with exact Dirichlet data.

    Returns (Xb [4n, 2], wb [4n, 3]) — full-state (u, v, p) rows; the
    caller slices off p when cfg.bc_pressure is False.
    """
    (xl, xr), (yl, yr) = cfg.domain_x, cfg.domain_y
    n = cfg.n_bound
    xs = lhs_interval(xl, xr, n, rng)
    xs2 = lhs_interval(xl, xr, n, rng)
    ys = lhs_interval(yl, yr, n, rng)
    ys2 = lhs_interval(yl, yr, n, rng)
    pts = np.concatenate(
        [
            np.hstack([np.full_like(ys, xl), ys]),
            np.hstack([np.full_like(ys2, xr), ys2]),
            np.hstack([xs, np.full_like(xs, yl)]),
            np.hstack([xs2, np.full_like(xs2, yr)]),
        ]
    )
    vals = exact_stacked(pts[:, 0], pts[:, 1], cfg.re)
    return pts, vals


def sensor_data(cfg: KovasznayConfig, rng: np.random.Generator):
    """Interior (u, v) velocity sensors for the inverse problem."""
    (xl, xr), (yl, yr) = cfg.domain_x, cfg.domain_y
    xs = lhs_interval(xl, xr, cfg.n_sensors, rng)
    ys = lhs_interval(yl, yr, cfg.n_sensors, rng)
    pts = np.hstack([xs, ys])
    u, v, _ = exact_fields(pts[:, 0], pts[:, 1], cfg.re)
    vals = np.stack([u, v], axis=-1)
    if cfg.sensor_noise > 0.0:
        vals = vals + cfg.sensor_noise * rng.standard_normal(vals.shape)
    return pts, vals


def exact_uv_jnp(re: float):
    """The exact velocity pair as jnp-traceable (x, y) -> (u, v) maps
    (the hard-BC lift differentiates through them via nested JVPs)."""
    lam = lam_of(re)

    def u(x, y):
        return 1.0 - jnp.exp(lam * x) * jnp.cos(2.0 * jnp.pi * y)

    def v(x, y):
        return (lam / (2.0 * jnp.pi)) * jnp.exp(lam * x) * jnp.sin(2.0 * jnp.pi * y)

    return u, v


def coons_lift_jnp(g_fn, domain_x, domain_y):
    """Transfinite (Coons) boundary interpolant, jnp-traceable — uses g
    ONLY on the four edges and matches it there exactly (the traceable
    twin of galerkin.coons_lift)."""
    a, b = domain_x
    c, d = domain_y

    def lift(x, y):
        s = (x - a) / (b - a)
        t = (y - c) / (d - c)
        return (
            (1 - s) * g_fn(jnp.full_like(x, a), y)
            + s * g_fn(jnp.full_like(x, b), y)
            + (1 - t) * g_fn(x, jnp.full_like(y, c))
            + t * g_fn(x, jnp.full_like(y, d))
            - (1 - s) * (1 - t) * g_fn(jnp.full_like(x, a), jnp.full_like(y, c))
            - s * (1 - t) * g_fn(jnp.full_like(x, b), jnp.full_like(y, c))
            - (1 - s) * t * g_fn(jnp.full_like(x, a), jnp.full_like(y, d))
            - s * t * g_fn(jnp.full_like(x, b), jnp.full_like(y, d))
        )

    return lift


def build(cfg: KovasznayConfig, rng: np.random.Generator | None = None) -> Problem:
    dtype = jnp.dtype(cfg.dtype)
    rng = rng or np.random.default_rng(cfg.train.seed)
    mesh = TensorMesh2D(
        axis_x=(
            Interval1D(np.asarray(cfg.grid_x, dtype=np.float64))
            if cfg.grid_x is not None
            else Interval1D.uniform(*cfg.domain_x, cfg.n_elements_x)
        ),
        axis_y=(
            Interval1D(np.asarray(cfg.grid_y, dtype=np.float64))
            if cfg.grid_y is not None
            else Interval1D.uniform(*cfg.domain_y, cfg.n_elements_y)
        ),
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
    elems = build_elements_2d(mesh, xq, wq, xq, wq, None, ntx, nty, dtype)

    Xb, wb_full = training_data(cfg, rng)
    ub = wb_full if cfg.bc_pressure else wb_full[:, :2]
    data = {
        "elements": elems,
        "basis_x": bx,
        "basis_y": by,
        "xb": jnp.asarray(Xb, dtype=dtype),
        "ub": jnp.asarray(ub, dtype=dtype),
    }
    if not cfg.bc_pressure:
        # Single-point pressure anchor at the domain corner: the classical
        # gauge fix when only velocity is prescribed on the boundary.
        xa = np.array([[cfg.domain_x[0], cfg.domain_y[0]]])
        _, _, pa = exact_fields(xa[:, 0], xa[:, 1], cfg.re)
        data["x_anchor"] = jnp.asarray(xa, dtype=dtype)
        data["p_anchor"] = jnp.asarray(pa.reshape(1, 1), dtype=dtype)
    if cfg.inverse:
        Xs, us = sensor_data(cfg, rng)
        data["xs"] = jnp.asarray(Xs, dtype=dtype)
        data["us"] = jnp.asarray(us, dtype=dtype)

    var_form, wb_weight = cfg.var_form, cfg.lossb_weight
    wa = cfg.p_anchor_weight
    nu_true = 1.0 / cfg.re
    # Per-equation residual weights [1, 3, 1, 1], baked into every residual
    # view (loss, GN residual vector, adaptive indicator) so the Gauss-
    # Newton identity and the marking stay consistent with the objective.
    eqw = (
        jnp.asarray(cfg.eq_weights, dtype=dtype)[None, :, None, None]
        if cfg.eq_weights is not None
        else None
    )

    def _weighted(res):
        return res if eqw is None else res * eqw

    spec = MLP(
        layers=cfg.layers,
        activation=cfg.activation,
        adaptive_slope=cfg.adaptive_slope,
        precision=cfg.matmul_precision,
    )

    if cfg.hard_bc:
        if not cfg.bc_pressure:
            raise ValueError(
                "hard_bc requires bc_pressure=True: with (u, v) exact by "
                "construction the boundary p data is what fixes the gauge"
            )
        from hpvpinns_tpu.problems.base import make_composite_apply

        ue_fn, ve_fn = exact_uv_jnp(cfg.re)
        clift_u = coons_lift_jnp(ue_fn, cfg.domain_x, cfg.domain_y)
        clift_v = coons_lift_jnp(ve_fn, cfg.domain_x, cfg.domain_y)
        (xa_, xb_), (ya_, yb_) = cfg.domain_x, cfg.domain_y
        sx = ((xb_ - xa_) / 2.0) ** 2
        sy = ((yb_ - ya_) / 2.0) ** 2

        def _lift(X):
            x, y = X[:, 0:1], X[:, 1:2]
            return jnp.concatenate(
                [clift_u(x, y), clift_v(x, y), jnp.zeros_like(x)], axis=-1
            )

        def _envelope(X):
            # normalized bubble (1 at the domain center, 0 on the walls)
            # for the velocity pair; the pressure output is unenveloped
            x, y = X[:, 0:1], X[:, 1:2]
            bub = ((x - xa_) * (xb_ - x) / sx) * ((y - ya_) * (yb_ - y) / sy)
            return jnp.concatenate([bub, bub, jnp.ones_like(bub)], axis=-1)

        _composite = make_composite_apply(spec, _lift, _envelope)

        def make_w_fn(params):
            return _composite(params)

    else:

        def make_w_fn(params):
            return lambda X: mlp_apply(spec, params["net"], X)

    def nu_of(params):
        return params["pde"]["nu"] if cfg.inverse else nu_true

    def residual_fn(params, data):
        """Masked weak residual Res[e, i, k, r] (i = momx, momy, cont) —
        the adaptive-refinement indicator source and the Gauss-Newton
        residual block (the mask/n_test contract matches variational_loss,
        so sum(r^2) == loss holds for the GN resvec)."""
        el = data["elements"]
        res = ns_residual(
            make_w_fn(params), el, data["basis_x"], data["basis_y"], var_form,
            nu_of(params),
        )
        return _weighted(res) * el.mask[:, None]

    _enriched_cache = {}

    def enriched_residual_fn(params, enrich: int = 3):
        """Weak residual against the tensor test modes NOT in the training
        basis (hierarchical a-posteriori indicator; same construction as
        the scalar families' — see adaptive.element_indicator).
        Returns [E, 3, K+enrich, R+enrich] with the trained block zeroed."""
        n_x = int(ntx.max()) + enrich
        n_y = int(nty.max()) + enrich
        key = (n_x, n_y)
        if key not in _enriched_cache:
            bx_en = make_weighted_basis(n_x, xq, wq, dtype)
            by_en = make_weighted_basis(n_y, xq, wq, dtype)
            elems_en = build_elements_2d(
                mesh, xq, wq, xq, wq, None,
                np.full(mesh.axis_x.n_elem, n_x), np.full(mesh.axis_y.n_elem, n_y),
                dtype,
            )
            new_mask = np.ones((n_y, n_x))
            new_mask[: int(nty.max()), : int(ntx.max())] = 0.0
            _enriched_cache[key] = (
                bx_en, by_en, elems_en, jnp.asarray(new_mask, dtype=dtype)
            )
        bx_en, by_en, elems_en, new_mask = _enriched_cache[key]
        res = ns_residual(
            make_w_fn(params), elems_en, bx_en, by_en, var_form, nu_of(params)
        )
        return _weighted(res) * new_mask[None, None]

    def loss_fn(params, data, axis_name=None):
        w_fn = make_w_fn(params)
        el = data["elements"]
        res = ns_residual(
            w_fn, el, data["basis_x"], data["basis_y"], var_form, nu_of(params)
        )
        lossv = variational_loss(_weighted(res), el.mask[:, None], el.n_test)
        if axis_name is not None:  # explicit all-reduce (shard_map path)
            lossv = jax.lax.psum(lossv, axis_name)
        wb_pred = w_fn(data["xb"])
        if not cfg.bc_pressure:
            wb_pred = wb_pred[:, :2]
        lossb = jnp.mean((data["ub"] - wb_pred) ** 2)
        loss = wb_weight * lossb + lossv
        aux = {"loss": loss, "lossb": lossb, "lossv": lossv}
        if not cfg.bc_pressure:
            p_pred = w_fn(data["x_anchor"])[:, 2:3]
            lossa = jnp.sum((p_pred - data["p_anchor"]) ** 2)
            loss = loss + wa * lossa
            aux["lossa"] = lossa
            aux["loss"] = loss
        if cfg.inverse:
            us_pred = w_fn(data["xs"])[:, :2]
            losss = jnp.mean((data["us"] - us_pred) ** 2)
            loss = loss + wb_weight * losss
            aux["losss"] = losss
            aux["nu"] = params["pde"]["nu"]  # per-poll trajectory, like the
            # advdiff epsilon history (AdvDiff.py:327-330)
            aux["loss"] = loss
        return loss, aux

    # Quadratic extra terms, registered so the Gauss-Newton residual-vector
    # identity sum(r^2) == loss stays exact in every configuration.
    reg_parts = []
    if not cfg.bc_pressure:
        reg_parts.append(
            lambda params, data: jnp.sqrt(wa)
            * (make_w_fn(params)(data["x_anchor"])[:, 2:3] - data["p_anchor"]).reshape(-1)
        )
    if cfg.inverse:
        reg_parts.append(
            lambda params, data: jnp.sqrt(wb_weight / data["us"].size)
            * (make_w_fn(params)(data["xs"])[:, :2] - data["us"]).reshape(-1)
        )

    def reg_resvec_fn(params, data):
        return jnp.concatenate([f(params, data) for f in reg_parts])

    pde_init = (
        (lambda: {"nu": jnp.asarray(cfg.nu_init, dtype=dtype)}) if cfg.inverse else None
    )

    # Dense evaluation grid; trailing component axis (u, v, p).
    xt = np.linspace(*cfg.domain_x, 100)
    yt = np.linspace(*cfg.domain_y, 100)
    XT, YT = np.meshgrid(xt, yt)
    test_points = np.stack([XT.reshape(-1), YT.reshape(-1)], axis=-1)
    test_values = exact_stacked(test_points[:, 0], test_points[:, 1], cfg.re)

    return Problem(
        name="kovasznay",
        config=cfg,
        spec=spec,
        data=data,
        loss_fn=loss_fn,
        init_params=make_net_init(spec, pde_init=pde_init, dtype=dtype),
        exact=lambda x, y: exact_stacked(x, y, cfg.re),
        apply_override=(
            (lambda params, X: make_w_fn(params)(X)) if cfg.hard_bc else None
        ),
        test_points=test_points,
        test_values=test_values,
        extras={
            "mesh": mesh,
            "residual_fn": residual_fn,
            "enriched_residual_fn": enriched_residual_fn,
            "test_grid_shape": (len(yt), len(xt)),
            "component_names": ("u", "v", "p"),
            "nu_true": nu_true,
            "nu_of": nu_of,
            **({"reg_resvec_fn": reg_resvec_fn} if reg_parts else {}),
        },
    )
