"""2D Helmholtz benchmark: Delta u + k^2 u = f on [-1, 1]^2, hp-VPINN.

The oscillatory, INDEFINITE extension of the Poisson family — no reference
analog (the reference stops at elliptic/parabolic scalar problems,
Poisson-2D.py / AdvDiff.py); this family composes the existing tensor-product
machinery (ops/assembly.helmholtz2d_residual = the Poisson weak forms,
Poisson-2D.py:91-105, plus a zeroth-order mass term) with a benchmark chosen
so nothing hides behind a manufactured forcing:

    u(x, y) = sin(k (x cos th + y sin th) + phase),   f = 0

— an exact homogeneous plane-wave solution, driven ENTIRELY through its
Dirichlet boundary trace.  At the default k = 9 the solution oscillates
~3 wavelengths per axis, the regime where spectral test spaces (and hp
refinement) separate from low-order methods, and k^2 = 81 sits between the
Dirichlet-Laplacian eigenvalues 78.96 and 83.89 so the continuous problem
is well-posed.

`inverse=True` poses wavenumber identification: k^2 becomes a trainable pde
leaf (the Helmholtz twin of the reference's trainable epsilon, AdvDiff.py:63)
informed by interior sensor readings.  The weak residual is LINEAR in k^2,
so a closed-form network-free estimate ships alongside (closed_form_k_sq).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from hpvpinns_tpu.config import Helmholtz2DConfig
from hpvpinns_tpu.geometry.mesh import Interval1D, TensorMesh2D
from hpvpinns_tpu.models.mlp import MLP, mlp_apply
from hpvpinns_tpu.ops.assembly import helmholtz2d_residual, variational_loss
from hpvpinns_tpu.ops.taylor import taylor_fields_2d
from hpvpinns_tpu.problems.base import Problem, check_deriv_mode, make_net_init
from hpvpinns_tpu.problems.build import build_elements_2d, make_weighted_basis
from hpvpinns_tpu.spectral.quadrature import gauss_lobatto_jacobi
from hpvpinns_tpu.utils.sampling import lhs_box, lhs_interval


def make_exact(cfg: Helmholtz2DConfig):
    """The tilted plane wave (host numpy; also traces under jnp since only
    ufuncs touch the inputs)."""
    th = np.deg2rad(cfg.wave_angle_deg)
    kx, ky = cfg.k * np.cos(th), cfg.k * np.sin(th)
    phase = cfg.wave_phase

    def u_exact(x, y):
        return np.sin(kx * x + ky * y + phase)

    return u_exact


def make_exact_jnp(cfg: Helmholtz2DConfig):
    """jnp-traceable twin of make_exact (hard-BC lift, device paths)."""
    th = float(np.deg2rad(cfg.wave_angle_deg))
    kx, ky = float(cfg.k * np.cos(th)), float(cfg.k * np.sin(th))
    phase = float(cfg.wave_phase)
    return lambda x, y: jnp.sin(kx * x + ky * y + phase)


def zero_forcing(x, y):
    """f = 0: the plane wave solves the HOMOGENEOUS Helmholtz equation."""
    return np.zeros(np.broadcast(x, y).shape)


def boundary_points(cfg: Helmholtz2DConfig, rng: np.random.Generator, u_ex):
    """n_bound LHS points per edge with exact Dirichlet data (the
    Poisson-2D.py:313-347 layout)."""
    (xl, xr), (yl, yu) = cfg.domain_x, cfg.domain_y
    n = cfg.n_bound
    edges = []
    for i in range(2):  # top, bottom: x varies
        x = lhs_interval(xl, xr, n, rng)
        edges.append(np.hstack([x, np.full_like(x, yu if i == 0 else yl)]))
    for i in range(2):  # right, left: y varies
        y = lhs_interval(yl, yu, n, rng)
        edges.append(np.hstack([np.full_like(y, xr if i == 0 else xl), y]))
    Xb = np.concatenate(edges)
    ub = u_ex(Xb[:, 0:1], Xb[:, 1:2])
    return Xb, ub


def make_coons_lift(cfg: Helmholtz2DConfig, g_jnp):
    """Transfinite (Coons) interpolant of the boundary trace of g — a
    jnp-traceable lift that matches g on all four edges while using ONLY
    boundary values (the interior stays the network's to find).  The 2D
    twin of the NS families' trace lift (problems/kovasznay.py)."""
    (xl, xr), (yl, yu) = cfg.domain_x, cfg.domain_y

    def lift(X):
        x, y = X[:, 0:1], X[:, 1:2]
        s = (x - xl) / (xr - xl)
        t = (y - yl) / (yu - yl)
        edges = (
            (1 - s) * g_jnp(xl, y)
            + s * g_jnp(xr, y)
            + (1 - t) * g_jnp(x, yl)
            + t * g_jnp(x, yu)
        )
        corners = (
            (1 - s) * (1 - t) * g_jnp(xl, yl)
            + (1 - s) * t * g_jnp(xl, yu)
            + s * (1 - t) * g_jnp(xr, yl)
            + s * t * g_jnp(xr, yu)
        )
        return edges - corners

    return lift


def make_envelope(cfg: Helmholtz2DConfig):
    """D(x, y) vanishing on the boundary of the (possibly non-unit) box."""
    (xl, xr), (yl, yu) = cfg.domain_x, cfg.domain_y

    def envelope(X):
        xi = (2 * X[:, 0:1] - xl - xr) / (xr - xl)
        eta = (2 * X[:, 1:2] - yl - yu) / (yu - yl)
        return (1.0 - xi**2) * (1.0 - eta**2)

    return envelope


def build(
    cfg: Helmholtz2DConfig,
    rng: np.random.Generator | None = None,
    u_fn=None,
    f_fn=None,
) -> Problem:
    """`u_fn`/`f_fn` pose a manufactured variant (numpy-vectorized
    (x, y) -> value; convention f = Delta u + k^2 u); the default is the
    homogeneous plane-wave benchmark (f = 0)."""
    u_ex = u_fn or make_exact(cfg)
    f_rh = f_fn or zero_forcing
    dtype = jnp.dtype(cfg.dtype)
    rng = rng or np.random.default_rng(cfg.train.seed)
    k_sq_true = float(cfg.k) ** 2

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
    data = {
        "elements": elems,
        "basis_x": bx,
        "basis_y": by,
        "xb": jnp.asarray(Xb, dtype=dtype),
        "ub": jnp.asarray(ub, dtype=dtype),
    }
    if cfg.inverse:
        # Interior sensors: the data that makes k^2 identifiable (the
        # Helmholtz twin of the 1D family's stations, AdvDiff.py:464-479).
        Xs = lhs_box([cfg.domain_x, cfg.domain_y], cfg.n_sensors, rng)
        us = u_ex(Xs[:, 0:1], Xs[:, 1:2])
        if cfg.sensor_noise_std > 0:
            noise_rng = np.random.default_rng(rng.integers(0, 2**31))
            us = us + noise_rng.normal(0.0, cfg.sensor_noise_std, us.shape)
        data["xs"] = jnp.asarray(Xs, dtype=dtype)
        data["us"] = jnp.asarray(us, dtype=dtype)

    spec = MLP(layers=cfg.layers, activation=cfg.activation,
               adaptive_slope=cfg.adaptive_slope, precision=cfg.matmul_precision)
    var_form, wb = cfg.var_form, cfg.lossb_weight
    mode = check_deriv_mode(cfg.deriv_mode)
    hard_bc = cfg.hard_bc
    if hard_bc:
        from hpvpinns_tpu.problems.base import make_composite_apply

        g_jnp = make_exact_jnp(cfg) if u_fn is None else (
            lambda x, y: u_fn(x, y)  # caller-supplied manufactured solution
        )
        mode = "jvp"  # composite ansatz: generic autodiff engine
        composite = make_composite_apply(
            spec, make_coons_lift(cfg, g_jnp), make_envelope(cfg)
        )

    def make_u_fn(params):
        if hard_bc:
            return composite(params)
        return lambda X: mlp_apply(spec, params["net"], X)

    def k_sq_of(params):
        if cfg.inverse:
            return params["pde"]["k_sq"]
        return k_sq_true

    def residual_fn(params, data):
        """Masked weak residual Res[e, k, r] (adaptive-refinement source)."""
        u_of = make_u_fn(params)
        if mode == "taylor":
            fields_fn = lambda x, y, **kw: taylor_fields_2d(spec, params["net"], x, y, **kw)
        else:
            fields_fn = None
        el = data["elements"]
        res = helmholtz2d_residual(
            u_of, el, data["basis_x"], data["basis_y"], k_sq_of(params),
            var_form, fields_fn=fields_fn,
        )
        return res * el.mask

    _enriched_cache = {}

    def enriched_residual_fn(params, enrich: int = 3):
        """Weak residual against the tensor test modes NOT in the training
        basis (hierarchical a-posteriori estimation — see
        adaptive.element_indicator and the poisson2d twin)."""
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
            new_mask = np.ones((n_y, n_x))
            new_mask[: int(nty.max()), : int(ntx.max())] = 0.0
            _enriched_cache[key] = (bx_en, by_en, elems_en, jnp.asarray(new_mask, dtype=dtype))
        bx_en, by_en, elems_en, new_mask = _enriched_cache[key]
        u_of = make_u_fn(params)
        res = helmholtz2d_residual(
            u_of, elems_en, bx_en, by_en, k_sq_of(params), var_form
        )
        return res * new_mask[None]

    def loss_fn(params, data, axis_name=None):
        u_of = make_u_fn(params)
        el = data["elements"]
        ub_pred = u_of(data["xb"])
        lossb = jnp.mean((data["ub"] - ub_pred) ** 2)
        res = residual_fn(params, data)
        lossv = variational_loss(res, el.mask, el.n_test)
        if axis_name is not None:  # explicit all-reduce (shard_map path)
            import jax as _jax

            lossv = _jax.lax.psum(lossv, axis_name)
        loss = wb * lossb + lossv
        aux = {"lossb": lossb, "lossv": lossv}
        if cfg.inverse:
            losss = jnp.mean((data["us"] - u_of(data["xs"])) ** 2)
            loss = loss + wb * losss
            aux["losss"] = losss
            aux["k_sq"] = params["pde"]["k_sq"]
        aux["loss"] = loss
        return loss, aux

    # Sensor misfit as a registered quadratic term, so the Gauss-Newton
    # residual-vector identity sum(r^2) == loss stays exact in inverse mode.
    def reg_resvec_fn(params, data):
        u_of = make_u_fn(params)
        return (
            jnp.sqrt(wb / data["us"].size)
            * (u_of(data["xs"]) - data["us"]).reshape(-1)
        )

    pde_init = None
    if cfg.inverse:
        pde_init = lambda: {"k_sq": jnp.asarray(cfg.k_sq_init, dtype=dtype)}

    # Dense test grid at delta 0.01 (the Poisson-2D.py:418-426 convention).
    xt = np.arange(cfg.domain_x[0], cfg.domain_x[1] + 0.01, 0.01)
    yt = np.arange(cfg.domain_y[0], cfg.domain_y[1] + 0.01, 0.01)
    XT, YT = np.meshgrid(xt, yt)
    test_points = np.stack([XT.reshape(-1), YT.reshape(-1)], axis=-1)
    test_values = u_ex(test_points[:, 0:1], test_points[:, 1:2])

    return Problem(
        name="helmholtz2d",
        config=cfg,
        spec=spec,
        data=data,
        loss_fn=loss_fn,
        init_params=make_net_init(spec, pde_init=pde_init, dtype=dtype),
        apply_override=(lambda params, X: make_u_fn(params)(X)) if hard_bc else None,
        exact=u_ex,
        test_points=test_points,
        test_values=test_values,
        extras={
            "mesh": mesh,
            "f_rhs": f_rh,
            "k_sq_true": k_sq_true,
            "residual_fn": residual_fn,
            "enriched_residual_fn": enriched_residual_fn,
            "test_grid_shape": (len(yt), len(xt)),
            **({"reg_resvec_fn": reg_resvec_fn} if cfg.inverse else {}),
        },
    )


def closed_form_k_sq(problem: Problem, params) -> float:
    """Network-free wavenumber estimate from a FITTED network: the weak
    residual is affine in k^2 — Res(k^2) = A + k^2 B — so the least-squares
    minimizer over all masked test entries is closed-form,

        k^2* = -<B, A> / <B, B>.

    Pair with a data-only (or joint) fit of the network; the estimate costs
    two residual assemblies and no optimizer.  The Helmholtz analog of the
    1D family's network-free routes (inverse.py; AdvDiff.py:63 is the
    reference's gradient-descent-only take)."""
    cfg = problem.config
    data = problem.data
    el = data["elements"]
    res_fn = problem.extras["residual_fn"]
    if cfg.inverse:
        import jax

        p0 = jax.tree_util.tree_map(lambda x: x, params)
        p0 = dict(p0, pde=dict(p0["pde"], k_sq=jnp.asarray(0.0, el.x.dtype)))
        p1 = dict(p0, pde=dict(p0["pde"], k_sq=jnp.asarray(1.0, el.x.dtype)))
    else:
        raise ValueError("closed_form_k_sq needs an inverse-mode problem "
                         "(k_sq as a pde leaf)")
    A = np.asarray(res_fn(p0, data), dtype=np.float64)
    B = np.asarray(res_fn(p1, data), dtype=np.float64) - A
    denom = float((B * B).sum())
    return -float((B * A).sum()) / denom
