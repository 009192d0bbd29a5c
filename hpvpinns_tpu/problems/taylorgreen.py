"""Unsteady incompressible Navier-Stokes — the Taylor-Green vortex.

The framework's second PDE SYSTEM and its first TIME-DEPENDENT one (no
reference analog: every family in ehsankharazmi/hp-VPINNs is a scalar
PDE).  A single 3-input (x, y, t) / 3-output (u, v, p) ansatz is trained
against the stacked weak residual of x/y-momentum + continuity on the
space-time tensor machinery (ops/assembly.py::ns_unsteady_residual; time
is the slowest element axis, exactly like the advdiff2d family's —
problems/advdiff2d.py).  The module structure mirrors the steady system's
(problems/kovasznay.py).

Exact solution (Taylor & Green 1937), the standard decaying-vortex
benchmark, for nu = 1/Re:

    u = -cos(x) sin(y) e^{-2 nu t}
    v =  sin(x) cos(y) e^{-2 nu t}
    p = -(cos(2x) + cos(2y))/4 e^{-4 nu t}

Inverse mode: nu = params["pde"]["nu"] is trainable and identified from
interior space-time (u, v) sensors — the unsteady twin of the reference's
trainable-epsilon problem (AdvDiff.py:63,165,173).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from hpvpinns_tpu.config import TaylorGreenConfig
from hpvpinns_tpu.geometry.mesh import Interval1D, TensorMesh3D
from hpvpinns_tpu.models.mlp import MLP, mlp_apply
from hpvpinns_tpu.ops.assembly import ns_unsteady_residual, variational_loss
from hpvpinns_tpu.problems.base import Problem, make_net_init
from hpvpinns_tpu.problems.build import build_elements_3d, make_weighted_basis
from hpvpinns_tpu.spectral.quadrature import gauss_lobatto_jacobi
from hpvpinns_tpu.utils.sampling import lhs_box, lhs_interval


def exact_fields(x, y, t, re: float):
    """(u, v, p) of the Taylor-Green solution, float64 host math.

    x, y, t: broadcastable arrays; returns three broadcast-shaped arrays.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    nu = 1.0 / re
    e = np.exp(-2.0 * nu * t)
    u = -np.cos(x) * np.sin(y) * e
    v = np.sin(x) * np.cos(y) * e
    p = -0.25 * (np.cos(2.0 * x) + np.cos(2.0 * y)) * e**2
    u, v, p = np.broadcast_arrays(u, v, p)
    return u, v, p


def exact_stacked(x, y, t, re: float):
    """Exact (u, v, p) stacked on a trailing component axis [..., 3]."""
    u, v, p = exact_fields(x, y, t, re)
    return np.stack([u, v, p], axis=-1)


def exact_uv_jnp(re: float):
    """The exact velocity pair as jnp-traceable (x, y, t) -> scalar maps
    (the hard-BC lift differentiates through them via nested JVPs; the
    space-time twin of problems/kovasznay.py::exact_uv_jnp)."""
    nu = 1.0 / re

    def u(x, y, t):
        return -jnp.cos(x) * jnp.sin(y) * jnp.exp(-2.0 * nu * t)

    def v(x, y, t):
        return jnp.sin(x) * jnp.cos(y) * jnp.exp(-2.0 * nu * t)

    return u, v


def coons_lift_spacetime_jnp(g_fn, domain_x, domain_y, t_final,
                             t_start: float = 0.0, g_ic_fn=None):
    """Space-time transfinite interpolant for the 5 DATA faces of the box
    [a,b] x [c,d] x [t0,T]: the four side walls (all t) and the t = t0 face.
    g_fn(x, y, t) -> scalar is used ONLY on those faces and matched there
    exactly:

        L(x,y,t) = C_xy[g(.,.,t)](x,y)
                 + (1 - tau) * (g0(x,y) - C_xy[g0](x,y)),
        tau = (t - t0)/(T - t0)

    where C_xy is the 2D Coons interpolant at frozen t (the traceable twin
    of the per-step lifts in galerkin.solve_ns_unsteady) and g0 is the
    initial face: ``g_ic_fn(x, y)`` when given — a previous slab's trained
    ansatz at the interface time in a hard-BC time march
    (training/timemarch.py) — else g_fn at t0.  The correction term
    vanishes on the side walls for ANY g0 (a transfinite interpolant
    matches its generator on the boundary), so wall exactness survives;
    at t = t0 it restores the full initial face.  The t = T face carries
    no data — an IVP's outflow in time.  t_start = 0, g_ic_fn = None
    reproduces the original single-domain lift exactly."""
    a, b = domain_x
    c, d = domain_y

    def _coons(h_fn, x, y):
        # C_xy[h]: exact on all four walls for any h(x, y).
        s = (x - a) / (b - a)
        r = (y - c) / (d - c)
        fa = jnp.full_like(x, a)
        fb = jnp.full_like(x, b)
        fc = jnp.full_like(y, c)
        fd = jnp.full_like(y, d)
        return (
            (1 - s) * h_fn(fa, y)
            + s * h_fn(fb, y)
            + (1 - r) * h_fn(x, fc)
            + r * h_fn(x, fd)
            - (1 - s) * (1 - r) * h_fn(fa, fc)
            - s * (1 - r) * h_fn(fb, fc)
            - (1 - s) * r * h_fn(fa, fd)
            - s * r * h_fn(fb, fd)
        )

    span = t_final - t_start

    def lift(x, y, t):
        if g_ic_fn is not None:
            g0 = g_ic_fn
        else:
            def g0(xx, yy):
                return g_fn(xx, yy, jnp.full_like(xx, t_start))
        tau = (t - t_start) / span
        return _coons(lambda xx, yy: g_fn(xx, yy, t), x, y) + (1.0 - tau) * (
            g0(x, y) - _coons(g0, x, y)
        )

    return lift


def training_data(cfg: TaylorGreenConfig, rng: np.random.Generator, ic_fn=None):
    """LHS points on the four side walls + the t = t_start face, with exact
    full-state data (the space-time twin of the Kovasznay layout; face
    structure as advdiff2d's — problems/advdiff2d.py::training_data).

    `ic_fn(xy) -> [n, 3]` (host numpy, (u, v, p) columns) overrides the
    INITIAL face only — a previous time slab's network state in a
    time-marching sequence (training/timemarch.py); without it any slab
    starts from the exact decaying vortex at t_start.

    Returns (Xb [5n, 3], wb [5n, 3]); the caller slices off p when
    cfg.bc_pressure is False.
    """
    T0, T = cfg.t_start, cfg.t_final
    (xl, xr), (yl, yr) = cfg.domain_x, cfg.domain_y
    n = cfg.n_bound
    pts = []
    for fixed_axis, lo_hi, free in (
        (0, (xl, xr), [(yl, yr), (T0, T)]),
        (1, (yl, yr), [(xl, xr), (T0, T)]),
    ):
        for val in lo_hi:
            free_pts = lhs_box(free, n, rng)
            pts.append(np.insert(free_pts, fixed_axis, val, axis=1))
    xy0 = lhs_box([(xl, xr), (yl, yr)], n, rng)
    pts.append(np.hstack([xy0, np.full((n, 1), T0)]))
    Xb = np.concatenate(pts)
    vals = exact_stacked(Xb[:, 0], Xb[:, 1], Xb[:, 2], cfg.re)
    if ic_fn is not None:
        vals = vals.copy()
        vals[4 * n :] = np.asarray(ic_fn(xy0)).reshape(n, 3)
    return Xb, vals


def sensor_data(cfg: TaylorGreenConfig, rng: np.random.Generator):
    """Interior space-time (u, v) velocity sensors (inverse mode)."""
    (xl, xr), (yl, yr) = cfg.domain_x, cfg.domain_y
    pts = lhs_box(
        [(xl, xr), (yl, yr), (cfg.t_start, cfg.t_final)], cfg.n_sensors, rng
    )
    u, v, _ = exact_fields(pts[:, 0], pts[:, 1], pts[:, 2], cfg.re)
    vals = np.stack([u, v], axis=-1)
    if cfg.sensor_noise > 0.0:
        vals = vals + cfg.sensor_noise * rng.standard_normal(vals.shape)
    return pts, vals


def build(
    cfg: TaylorGreenConfig,
    rng: np.random.Generator | None = None,
    ic_fn=None,
    ic_lift_fns=None,
) -> Problem:
    """``ic_lift_fns`` (hard-BC time marching): a pair of jnp-traceable
    (x, y) -> [n, 1] maps for the u and v INITIAL-face states that the
    Coons space-time lift interpolates instead of the analytic vortex at
    t_start — a previous slab's trained ansatz at the interface time
    (training/timemarch.py builds them).  The side walls stay analytic
    (they carry exact data at every slab), so hard-BC slabs chain with an
    exact velocity handoff.  Requires cfg.hard_bc."""
    dtype = jnp.dtype(cfg.dtype)
    rng = rng or np.random.default_rng(cfg.train.seed)
    if cfg.hard_bc and ic_fn is not None and ic_lift_fns is None:
        raise ValueError(
            "hard_bc's space-time lift interpolates the analytic vortex on "
            "the t = t_start face; a handed-off ic_fn needs the matching "
            "traceable ic_lift_fns pair so the lift carries the SAME "
            "predicted state (training/timemarch.py constructs both)"
        )
    if ic_lift_fns is not None and not cfg.hard_bc:
        raise ValueError("ic_lift_fns is a hard-BC lift hook; set hard_bc=True")
    if cfg.inverse and ic_fn is not None:
        raise ValueError(
            "ic_fn marches the FORWARD problem (an inverse run's sensors "
            "live on the global horizon); set inverse=False"
        )

    def _axis(grid, lo, hi, n):
        if grid is not None:
            return Interval1D(np.asarray(grid, dtype=np.float64))
        return Interval1D.uniform(lo, hi, n)

    mesh = TensorMesh3D(
        axis_x=_axis(cfg.grid_x, *cfg.domain_x, cfg.n_elements_x),
        axis_y=_axis(cfg.grid_y, *cfg.domain_y, cfg.n_elements_y),
        axis_z=_axis(cfg.grid_t, cfg.t_start, cfg.t_final, cfg.n_elements_t),
    )
    xq, wq = gauss_lobatto_jacobi(cfg.n_quad, 0.0, 0.0)
    ntx = cfg.n_test_x_per_elem if cfg.n_test_x_per_elem is not None else cfg.n_test_x
    nty = cfg.n_test_y_per_elem if cfg.n_test_y_per_elem is not None else cfg.n_test_y
    ntt = cfg.n_test_t_per_elem if cfg.n_test_t_per_elem is not None else cfg.n_test_t
    eq_sel = None
    if cfg.p_test_enrich > 0:
        # MOMENTUM-targeted test enrichment (pressure-gauge treatment): the
        # tensor test orders rise by p_test_enrich for the equations that
        # see grad p (x/y-momentum, rows 0-1); continuity keeps the base
        # orders via an equation-selective mask over the extra modes.
        if any(v is not None for v in (cfg.n_test_x_per_elem,
                                       cfg.n_test_y_per_elem,
                                       cfg.n_test_t_per_elem)):
            raise ValueError("p_test_enrich does not compose with "
                             "per-element test orders")
        e = int(cfg.p_test_enrich)
        bx0, by0, bt0 = cfg.n_test_x, cfg.n_test_y, cfg.n_test_t
        ntx, nty, ntt = bx0 + e, by0 + e, bt0 + e
        sel = np.ones((3, ntt, nty, ntx))
        sel[2] = 0.0
        sel[2, :bt0, :by0, :bx0] = 1.0  # continuity: base block only
        eq_sel = jnp.asarray(sel, dtype=dtype)
    nx_max, ny_max, nt_max = (int(np.max(v)) for v in (ntx, nty, ntt))
    bx = make_weighted_basis(nx_max, xq, wq, dtype)
    by = make_weighted_basis(ny_max, xq, wq, dtype)
    bt = make_weighted_basis(nt_max, xq, wq, dtype)
    elems = build_elements_3d(mesh, xq, wq, None, ntx, nty, ntt, dtype)

    Xb, wb_full = training_data(cfg, rng, ic_fn=ic_fn)
    ub = wb_full if cfg.bc_pressure else wb_full[:, :2]
    data = {
        "elements": elems,
        "basis_x": bx,
        "basis_y": by,
        "basis_t": bt,
        "xb": jnp.asarray(Xb, dtype=dtype),
        "ub": jnp.asarray(ub, dtype=dtype),
    }
    if not cfg.bc_pressure:
        # Pressure anchor CURVE: unsteady gauge freedom is a free function
        # of t, so the anchor is one spatial point across LHS times.
        ta = lhs_interval(cfg.t_start, cfg.t_final, cfg.n_anchor, rng).reshape(-1)
        xa = np.stack([
            np.full_like(ta, cfg.domain_x[0]),
            np.full_like(ta, cfg.domain_y[0]),
            ta,
        ], axis=-1)
        _, _, pa = exact_fields(xa[:, 0], xa[:, 1], xa[:, 2], cfg.re)
        data["x_anchor"] = jnp.asarray(xa, dtype=dtype)
        data["p_anchor"] = jnp.asarray(pa.reshape(-1, 1), dtype=dtype)
    if cfg.inverse:
        Xs, us = sensor_data(cfg, rng)
        data["xs"] = jnp.asarray(Xs, dtype=dtype)
        data["us"] = jnp.asarray(us, dtype=dtype)
    if cfg.p_zero_mean_weight > 0.0:
        # Zero-mean-per-time-slice gauge penalty (pressure treatment): pin
        # the spatial quadrature mean of p at n_zero_mean_t slices to the
        # exact slice mean (identically 0 on the standard [0, pi]^2 box —
        # the classical zero-mean gauge convention).  Everything here is
        # offline f64 host precompute, per the framework's split.
        nq_zm = 16
        xg, wg = gauss_lobatto_jacobi(nq_zm, 0.0, 0.0)
        xs_zm = 0.5 * (xg + 1.0) * (cfg.domain_x[1] - cfg.domain_x[0]) + cfg.domain_x[0]
        ys_zm = 0.5 * (xg + 1.0) * (cfg.domain_y[1] - cfg.domain_y[0]) + cfg.domain_y[0]
        W2 = np.outer(wg, wg)
        w_norm = (W2 / W2.sum()).reshape(-1)
        YZ, XZ = np.meshgrid(ys_zm, xs_zm, indexing="ij")
        t_zm = np.linspace(cfg.t_start, cfg.t_final, cfg.n_zero_mean_t + 1)[1:]
        pts = np.stack([
            np.broadcast_to(XZ.reshape(-1), (len(t_zm), w_norm.size)),
            np.broadcast_to(YZ.reshape(-1), (len(t_zm), w_norm.size)),
            np.broadcast_to(t_zm[:, None], (len(t_zm), w_norm.size)),
        ], axis=-1)
        _, _, p_ex = exact_fields(pts[..., 0], pts[..., 1], pts[..., 2], cfg.re)
        data["x_zeromean"] = jnp.asarray(pts.reshape(-1, 3), dtype=dtype)
        data["w_zeromean"] = jnp.asarray(w_norm, dtype=dtype)
        data["p_mean_exact"] = jnp.asarray(p_ex @ w_norm, dtype=dtype)  # [K]

    var_form, wb_weight = cfg.var_form, cfg.lossb_weight
    wa = cfg.p_anchor_weight
    nu_true = 1.0 / cfg.re
    eqw = (
        jnp.asarray(cfg.eq_weights, dtype=dtype)[None, :, None, None, None]
        if cfg.eq_weights is not None
        else None
    )

    def _weighted(res):
        return res if eqw is None else res * eqw

    def _mask_eq(res):
        # equation-selective p_test_enrich mask (TRAINING basis shape only —
        # the enriched adaptive indicator builds its own larger mask)
        return res if eq_sel is None else res * eq_sel[None]

    w_zm = cfg.p_zero_mean_weight
    n_zm = cfg.n_zero_mean_t

    def _zeromean_resvec(params, data):
        p_pred = make_w_fn(params)(data["x_zeromean"])[:, 2].reshape(n_zm, -1)
        means = p_pred @ data["w_zeromean"]
        return jnp.sqrt(w_zm / n_zm) * (means - data["p_mean_exact"])

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
        u_ic, v_ic = ic_lift_fns if ic_lift_fns is not None else (None, None)
        lift_u = coons_lift_spacetime_jnp(
            ue_fn, cfg.domain_x, cfg.domain_y, cfg.t_final,
            t_start=cfg.t_start, g_ic_fn=u_ic,
        )
        lift_v = coons_lift_spacetime_jnp(
            ve_fn, cfg.domain_x, cfg.domain_y, cfg.t_final,
            t_start=cfg.t_start, g_ic_fn=v_ic,
        )
        (xa_, xb_), (ya_, yb_) = cfg.domain_x, cfg.domain_y
        sx = ((xb_ - xa_) / 2.0) ** 2
        sy = ((yb_ - ya_) / 2.0) ** 2
        T0_, T_ = cfg.t_start, cfg.t_final

        def _lift(X):
            x, y, t = X[:, 0:1], X[:, 1:2], X[:, 2:3]
            return jnp.concatenate(
                [lift_u(x, y, t), lift_v(x, y, t), jnp.zeros_like(x)], axis=-1
            )

        def _envelope(X):
            # velocity envelope vanishing on the 5 DATA faces (side walls
            # + t = t_start), normalized to 1 at the domain center at
            # t = T; the pressure output is unenveloped (soft wall-p data
            # = gauge).  (t - t0)/(T - t0) anchors a time SLAB's envelope
            # at its own initial face (t_start = 0: the original factor).
            x, y, t = X[:, 0:1], X[:, 1:2], X[:, 2:3]
            bub = ((x - xa_) * (xb_ - x) / sx) * ((y - ya_) * (yb_ - y) / sy)
            bub = bub * ((t - T0_) / (T_ - T0_))
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
        """Masked weak residual Res[e, i, m, k, r] (i = momx, momy, cont) —
        indicator source and GN residual block (mask/n_test contract as
        variational_loss, so sum(r^2) == loss for the GN resvec)."""
        el = data["elements"]
        res = ns_unsteady_residual(
            make_w_fn(params), el, data["basis_x"], data["basis_y"],
            data["basis_t"], var_form, nu_of(params),
        )
        return _weighted(_mask_eq(res)) * el.mask[:, None]

    _enriched_cache = {}

    def enriched_residual_fn(params, enrich: int = 3):
        """Weak residual against the tensor test modes NOT in the training
        basis (hierarchical indicator — see adaptive.element_indicator).
        Returns [E, 3, M+e, K+e, R+e] with the trained block zeroed."""
        n_x, n_y, n_t = nx_max + enrich, ny_max + enrich, nt_max + enrich
        key = (n_x, n_y, n_t)
        if key not in _enriched_cache:
            bx_en = make_weighted_basis(n_x, xq, wq, dtype)
            by_en = make_weighted_basis(n_y, xq, wq, dtype)
            bt_en = make_weighted_basis(n_t, xq, wq, dtype)
            elems_en = build_elements_3d(mesh, xq, wq, None, n_x, n_y, n_t, dtype)
            new_mask = np.ones((n_t, n_y, n_x))
            new_mask[:nt_max, :ny_max, :nx_max] = 0.0
            _enriched_cache[key] = (
                bx_en, by_en, bt_en, elems_en, jnp.asarray(new_mask, dtype=dtype)
            )
        bx_en, by_en, bt_en, elems_en, new_mask = _enriched_cache[key]
        res = ns_unsteady_residual(
            make_w_fn(params), elems_en, bx_en, by_en, bt_en, var_form,
            nu_of(params),
        )
        return _weighted(res) * new_mask[None, None]

    def loss_fn(params, data, axis_name=None):
        w_fn = make_w_fn(params)
        el = data["elements"]
        res = ns_unsteady_residual(
            w_fn, el, data["basis_x"], data["basis_y"], data["basis_t"],
            var_form, nu_of(params),
        )
        lossv = variational_loss(_weighted(_mask_eq(res)), el.mask[:, None], el.n_test)
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
            lossa = jnp.mean((p_pred - data["p_anchor"]) ** 2)
            loss = loss + wa * lossa
            aux["lossa"] = lossa
            aux["loss"] = loss
        if w_zm > 0.0:
            rz = _zeromean_resvec(params, data)
            lossz = jnp.sum(rz * rz)
            loss = loss + lossz
            aux["lossz"] = lossz
            aux["loss"] = loss
        if cfg.inverse:
            us_pred = w_fn(data["xs"])[:, :2]
            losss = jnp.mean((data["us"] - us_pred) ** 2)
            loss = loss + wb_weight * losss
            aux["losss"] = losss
            aux["nu"] = params["pde"]["nu"]
            aux["loss"] = loss
        return loss, aux

    # Quadratic extra terms registered so the Gauss-Newton residual-vector
    # identity sum(r^2) == loss stays exact in every configuration.
    reg_parts = []
    if not cfg.bc_pressure:
        reg_parts.append(
            lambda params, data: jnp.sqrt(wa / data["p_anchor"].size)
            * (make_w_fn(params)(data["x_anchor"])[:, 2:3] - data["p_anchor"]).reshape(-1)
        )
    if cfg.inverse:
        reg_parts.append(
            lambda params, data: jnp.sqrt(wb_weight / data["us"].size)
            * (make_w_fn(params)(data["xs"])[:, :2] - data["us"]).reshape(-1)
        )
    if w_zm > 0.0:
        reg_parts.append(_zeromean_resvec)

    def reg_resvec_fn(params, data):
        return jnp.concatenate([f(params, data) for f in reg_parts])

    pde_init = (
        (lambda: {"nu": jnp.asarray(cfg.nu_init, dtype=dtype)}) if cfg.inverse else None
    )

    # Dense evaluation grid (x fastest, t slowest); trailing component axis.
    xt = np.linspace(*cfg.domain_x, 41)
    yt = np.linspace(*cfg.domain_y, 41)
    tt = np.linspace(cfg.t_start, cfg.t_final, 9)
    TT, YT, XT = np.meshgrid(tt, yt, xt, indexing="ij")
    test_points = np.stack(
        [XT.reshape(-1), YT.reshape(-1), TT.reshape(-1)], axis=-1
    )
    test_values = exact_stacked(
        test_points[:, 0], test_points[:, 1], test_points[:, 2], cfg.re
    )

    return Problem(
        name="taylorgreen",
        config=cfg,
        spec=spec,
        data=data,
        loss_fn=loss_fn,
        init_params=make_net_init(spec, pde_init=pde_init, dtype=dtype),
        exact=lambda x, y, t: exact_stacked(x, y, t, cfg.re),
        apply_override=(
            (lambda params, X: make_w_fn(params)(X)) if cfg.hard_bc else None
        ),
        test_points=test_points,
        test_values=test_values,
        extras={
            "mesh": mesh,
            "residual_fn": residual_fn,
            "enriched_residual_fn": enriched_residual_fn,
            "test_grid_shape": (len(tt), len(yt), len(xt)),
            "component_names": ("u", "v", "p"),
            "nu_true": nu_true,
            "nu_of": nu_of,
            **({"reg_resvec_fn": reg_resvec_fn} if reg_parts else {}),
        },
    )
