"""Viscous Burgers equation — the framework's nonlinear space-time family.

    u_t + u u_x = nu u_xx   on (x, t) in [-1, 1] x [0, T]
    u(x, 0) = -sin(pi x),  u(+-1, t) = 0

No reference analog (ehsankharazmi/hp-VPINNs is linear-PDE only); this is the
canonical nonlinear PINN benchmark (nu = 0.01/pi develops a steep interior
front at x = 0 by t ~ 0.5), included to exercise the variational assembly on
a NONLINEAR weak form: the convection term is assembled in conservation form
(u u_x = (u^2/2)_x, ops/assembly.py::burgers_residual), which the linear
reference machinery cannot express.

Exact solution via the Cole-Hopf transformation, evaluated with Gauss-Hermite
quadrature (Basdevant et al. 1986 form):

    u(x, t) = -2 nu d/dx log phi,   phi = heat-kernel convolution of
    exp(-(1 - cos(pi x)) / (2 pi nu))  [the transformed initial condition]

which reduces to a ratio of two Hermite-quadrature integrals after the
substitution eta = x - 2 sqrt(nu t) z.
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp

from hpvpinns_tpu.config import BurgersConfig
from hpvpinns_tpu.geometry.mesh import TensorMesh2D
from hpvpinns_tpu.models.mlp import MLP, mlp_apply
from hpvpinns_tpu.ops.assembly import burgers_residual, variational_loss
from hpvpinns_tpu.ops.taylor import taylor_fields_2d
from hpvpinns_tpu.problems.base import Problem, check_deriv_mode, make_net_init
from hpvpinns_tpu.problems.build import build_elements_2d, make_weighted_basis
from hpvpinns_tpu.spectral.quadrature import gauss_lobatto_jacobi
from hpvpinns_tpu.utils.sampling import lhs_interval


def u_initial(x):
    return -np.sin(np.pi * x)


def u_exact(x, t, nu, n_hermite: int = 128):
    """Cole-Hopf solution by Gauss-Hermite quadrature (float64 host math).

    x, t: broadcastable arrays; exact -sin(pi x) at t = 0.  The integrand's
    exponent is offset by its per-point maximum before exponentiation, so the
    ratio is stable even for nu = 0.01/pi where exp(-1/(pi nu)) underflows.
    """
    x = np.asarray(x, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    x, t = np.broadcast_arrays(x, t)
    z, w = np.polynomial.hermite.hermgauss(n_hermite)  # int e^{-z^2} f(z) dz

    xc = x.reshape(-1, 1)
    tc = np.maximum(t.reshape(-1, 1), 1e-30)  # t=0 rows replaced below
    eta = xc - 2.0 * np.sqrt(nu * tc) * z[None, :]
    # log of the transformed IC (constant factor cancels in the ratio):
    # phi0(eta) = exp((1 - cos(pi eta)) / (2 pi nu)) ∝ exp(-cos(pi eta)/(2 pi nu))
    log_f = -np.cos(np.pi * eta) / (2.0 * np.pi * nu)
    # Fold log(w) INTO the stabilized exponent: the offset max then belongs
    # to the term that actually dominates the sums, so den's largest term is
    # exactly 1 and the ratio cannot 0/0 even when the bare-log_f max sits
    # at a far Hermite tail node whose weight underflows (measured: f32 NaN
    # band |x| <= 0.02 at t = 0.5 for nu = 0.01/pi — the viscous shock).
    e = np.log(w)[None, :] + log_f
    f = np.exp(e - e.max(axis=1, keepdims=True))
    num = np.sum(np.sin(np.pi * eta) * f, axis=1)
    den = np.sum(f, axis=1)
    u = (-num / den).reshape(x.shape)
    return np.where(t == 0, u_initial(x), u)


def default_lift(X):
    """g(x, t) = -sin(pi x): exact on the IC and on both walls."""
    return -jnp.sin(jnp.pi * X[:, 0:1])


def u_exact_jnp(x, t, nu, n_hermite: int = 96):
    """jnp-traceable twin of :func:`u_exact` (same Cole-Hopf / Gauss-Hermite
    form, same max-offset stabilization) for use INSIDE an ansatz — e.g. the
    exact-restart hard-BC slab lift in time marching, which the derivative
    engines differentiate through via nested JVPs.  `t` must be > 0 (a slab
    start time); the t = 0 limit is `default_lift`."""
    z, w = np.polynomial.hermite.hermgauss(n_hermite)
    # log(w) in f64 HOST math before the cast: at n = 96 the tail weights
    # underflow float32 (w ~ exp(-z_max^2) ~ 1e-70), but their logs (~-160)
    # are perfectly representable.
    lw = jnp.asarray(np.log(w), dtype=x.dtype)
    z = jnp.asarray(z, dtype=x.dtype)
    eta = x - 2.0 * jnp.sqrt(nu * t) * z[None, :]
    log_f = -jnp.cos(jnp.pi * eta) / (2.0 * jnp.pi * nu)
    # Stabilize with log(w) folded in (same reasoning as u_exact: den's max
    # term is then exactly 1, so the ratio cannot 0/0 in float32 at the
    # viscous shock where the bare-log_f max lands on an underflowing tail
    # node — the measured NaN band |x| <= 0.02 at t = 0.5).
    e = lw[None, :] + log_f
    e = e - jax.lax.stop_gradient(e.max(axis=1, keepdims=True))
    f = jnp.exp(e)
    num = jnp.sum(jnp.sin(jnp.pi * eta) * f, axis=1, keepdims=True)
    den = jnp.sum(f, axis=1, keepdims=True)
    return -num / den


def make_interface_lift(u0_fn, domain_x):
    """Hard-BC lift for a time slab [t0, t1] from its start-face state.

    ``u0_fn(x) -> [n, 1]`` (jnp-traceable) is the slab's initial condition —
    a previous slab's trained ansatz evaluated at the interface time in a
    time march, or :func:`u_exact_jnp` at t0 for the exact-restart control.
    The lift is constant in t,

        g(x, t) = u0(x) - [(1-s) u0(a) + s u0(b)],   s = (x-a)/(b-a),

    i.e. u0 minus its linear wall interpolant: EXACTLY zero on both walls
    (the benchmark's homogeneous Dirichlet data) for all t, and equal to u0
    on the start face up to u0's own wall residue — which is identically
    zero when the previous slab was itself hard-BC, so hard-BC slabs CHAIN
    with an exact handoff.  Pair with make_default_envelope(scfg), whose
    time factor vanishes at the slab's own t_start.  No reference analog
    (single-domain training only, AdvDiff.py:35-53)."""
    a, b = domain_x

    def lift(X):
        x = X[:, 0:1]
        u0 = u0_fn(x)
        edge = jnp.full((1, 1), a, dtype=X.dtype)
        ua = u0_fn(edge)
        ub = u0_fn(jnp.full((1, 1), b, dtype=X.dtype))
        s = (x - a) / (b - a)
        return u0 - ((1.0 - s) * ua + s * ub)

    return lift


def make_default_envelope(cfg: BurgersConfig, rate: float = 4.0):
    """(x-a)(b-x)/((b-a)/2)^2 * (1 - exp(-rate (t-t0)/(T-t0))) — the
    saturating time factor measured best for space-time hard-BC ansatzes
    (MEASUREMENTS.md); anchored at cfg.t_start so a slab's envelope
    vanishes on ITS OWN initial face (t_start = 0 reproduces the original
    single-domain factor exactly)."""
    a, b = cfg.domain_x
    scale = ((b - a) / 2.0) ** 2
    t0, span = cfg.t_start, cfg.t_final - cfg.t_start

    def envelope(X):
        tfac = 1.0 - jnp.exp(-rate * (X[:, 1:2] - t0) / span)
        return (X[:, 0:1] - a) * (b - X[:, 0:1]) / scale * tfac

    return envelope


def training_data(cfg: BurgersConfig, rng: np.random.Generator, ic_fn=None):
    """Boundary walls + initial edge, LHS-sampled (AdvDiff's layout without
    the interior sensors — this is a forward problem).

    The initial edge sits at t = cfg.t_start with values from `ic_fn(x)`
    (host numpy, [n,1] -> [n,1]) when given — a previous time slab's network
    state in a time-marching sequence — else the exact Cole-Hopf solution at
    t_start (which is the canonical -sin(pi x) IC for t_start = 0)."""
    T0, T, (xl, xr) = cfg.t_start, cfg.t_final, cfg.domain_x
    n = cfg.n_bound
    t_up = T0 + (T - T0) * lhs_interval(0, 1, n, rng)
    t_lo = T0 + (T - T0) * lhs_interval(0, 1, n, rng)
    x_in = lhs_interval(xl, xr, n, rng)
    pts = [
        np.hstack([np.full_like(t_up, xr), t_up]),
        np.hstack([np.full_like(t_lo, xl), t_lo]),
        np.hstack([x_in, np.full_like(x_in, T0)]),
    ]
    if ic_fn is not None:
        u0 = np.asarray(ic_fn(x_in)).reshape(n, 1)
    elif T0 == 0.0:
        u0 = u_initial(x_in)
    else:
        u0 = u_exact(x_in, np.full_like(x_in, T0), cfg.nu)
    vals = [np.zeros((n, 1)), np.zeros((n, 1)), u0]
    return np.concatenate(pts), np.concatenate(vals)


def build(
    cfg: BurgersConfig,
    rng: np.random.Generator | None = None,
    lift_fn=None,
    envelope_fn=None,
    ic_fn=None,
) -> Problem:
    dtype = jnp.dtype(cfg.dtype)
    rng = rng or np.random.default_rng(cfg.train.seed)
    if (
        (cfg.hard_bc or envelope_fn is not None)
        and lift_fn is None
        and (ic_fn is not None or cfg.t_start != 0.0)
    ):
        raise ValueError(
            "hard_bc's DEFAULT lift interpolates the analytic -sin(pi x) IC "
            "at t = 0; a time-slab run (t_start > 0 or a handed-off ic_fn) "
            "needs an explicit lift_fn built from the slab's own start face "
            "(make_interface_lift — training/timemarch.py constructs it)"
        )
    if cfg.grid_x is not None or cfg.grid_t is not None:
        from hpvpinns_tpu.geometry.mesh import Interval1D

        mesh = TensorMesh2D(
            axis_x=(
                Interval1D(np.asarray(cfg.grid_x, dtype=np.float64))
                if cfg.grid_x is not None
                else Interval1D.uniform(*cfg.domain_x, cfg.n_elements_x)
            ),
            axis_y=(
                Interval1D(np.asarray(cfg.grid_t, dtype=np.float64))
                if cfg.grid_t is not None
                else Interval1D.uniform(cfg.t_start, cfg.t_final, cfg.n_elements_t)
            ),
        )
    else:
        mesh = TensorMesh2D.uniform(
            *cfg.domain_x, cfg.n_elements_x, cfg.t_start, cfg.t_final,
            cfg.n_elements_t,
        )
    xq, wq = gauss_lobatto_jacobi(cfg.n_quad, 0.0, 0.0)

    ntx = (
        np.asarray(cfg.n_test_x_per_elem)
        if cfg.n_test_x_per_elem is not None
        else np.full(mesh.axis_x.n_elem, cfg.n_test_x)
    )
    ntt = (
        np.asarray(cfg.n_test_t_per_elem)
        if cfg.n_test_t_per_elem is not None
        else np.full(mesh.axis_y.n_elem, cfg.n_test_t)
    )
    bx = make_weighted_basis(int(ntx.max()), xq, wq, dtype)
    bt = make_weighted_basis(int(ntt.max()), xq, wq, dtype)
    elems = build_elements_2d(mesh, xq, wq, xq, wq, None, ntx, ntt, dtype)

    Xb, ub = training_data(cfg, rng, ic_fn=ic_fn)
    data = {
        "elements": elems,
        "basis_x": bx,
        "basis_t": bt,
        "xb": jnp.asarray(Xb, dtype=dtype),
        "ub": jnp.asarray(ub, dtype=dtype),
    }
    n_strong = int(getattr(cfg, "n_strong", 0))
    if n_strong > 0:
        xlw, xrw = cfg.strong_window or cfg.domain_x
        xs = lhs_interval(xlw, xrw, n_strong, rng)
        ts = cfg.t_start + (cfg.t_final - cfg.t_start) * lhs_interval(
            0.0, 1.0, n_strong, rng
        )
        data["xr"] = jnp.asarray(np.hstack([xs, ts]), dtype=dtype)

    var_form, wb, nu = cfg.var_form, cfg.lossb_weight, cfg.nu
    mode = check_deriv_mode(cfg.deriv_mode)

    # Front input feature (front_feature): the -sin(pi x) IC is odd, so the
    # viscous front forms and STAYS at x = 0; its steady-shock profile is
    # -A tanh(A x / (2 nu)).  Appending tanh(x/delta) as a third network
    # input transfers the advection-diffusion outflow layer_feature to the
    # nonlinear family — and is MEASURED NEGATIVE here (MEASUREMENTS.md
    # "Physics-feature transfer"): the interior front is constrained only
    # by the weak residual, whose test modes cannot see the 6.4e-3 scale,
    # so the loss falls 10x while the error rises 10-35x.  Kept as a
    # documented cautionary control (see BurgersConfig.front_feature).
    feature_fn = None
    layers = cfg.layers
    if getattr(cfg, "front_feature", False):
        delta = (
            float(cfg.front_feature_scale)
            if cfg.front_feature_scale is not None
            else 2.0 * nu
        )

        def feature_fn(X, _d=delta):
            return jnp.tanh(X[:, 0:1] / _d)

        layers = (layers[0] + 1,) + tuple(layers[1:])
        mode = "jvp"  # augmented-input ansatz: generic autodiff engine

    spec = MLP(layers=layers, activation=cfg.activation,
               adaptive_slope=cfg.adaptive_slope, precision=cfg.matmul_precision)
    hard_bc = cfg.hard_bc or lift_fn is not None or envelope_fn is not None
    if hard_bc:
        from hpvpinns_tpu.problems.base import make_composite_apply

        lift = lift_fn or default_lift
        envelope = envelope_fn or make_default_envelope(cfg)
        mode = "jvp"  # composite ansatz: generic autodiff engine
        composite = make_composite_apply(spec, lift, envelope, feature_fn=feature_fn)
    elif feature_fn is not None:
        from hpvpinns_tpu.problems.base import make_feature_apply

        feature_apply = make_feature_apply(spec, feature_fn)

    def make_u_fn(params):
        if hard_bc:
            return composite(params)
        if feature_fn is not None:
            return feature_apply(params)
        return lambda X: mlp_apply(spec, params["net"], X)

    def _fields_fn(params):
        if mode == "taylor":
            return lambda x, y, **kw: taylor_fields_2d(spec, params["net"], x, y, **kw)
        return None

    def residual_fn(params, data):
        """Masked weak residual Res[e, k, r] — the per-element indicator
        source for adaptive refinement (adaptive.py)."""
        el = data["elements"]
        res = burgers_residual(
            make_u_fn(params), el, data["basis_x"], data["basis_t"], var_form, nu,
            fields_fn=_fields_fn(params),
        )
        return res * el.mask

    _enriched_cache = {}

    def enriched_residual_fn(params, enrich: int = 3):
        """Weak residual against the tensor test modes NOT in the training
        basis — hierarchical a-posteriori estimation for the nonlinear family
        (same construction as poisson2d's; see adaptive.element_indicator).
        Returns [E, K+enrich, R+enrich] with the trained block zeroed."""
        n_x = int(ntx.max()) + enrich
        n_t = int(ntt.max()) + enrich
        key = (n_x, n_t)
        if key not in _enriched_cache:
            bx_en = make_weighted_basis(n_x, xq, wq, dtype)
            bt_en = make_weighted_basis(n_t, xq, wq, dtype)
            elems_en = build_elements_2d(
                mesh, xq, wq, xq, wq, None,
                np.full(mesh.axis_x.n_elem, n_x), np.full(mesh.axis_y.n_elem, n_t),
                dtype,
            )
            new_mask = np.ones((n_t, n_x))
            new_mask[: int(ntt.max()), : int(ntx.max())] = 0.0
            _enriched_cache[key] = (bx_en, bt_en, elems_en, jnp.asarray(new_mask, dtype=dtype))
        bx_en, bt_en, elems_en, new_mask = _enriched_cache[key]
        res = burgers_residual(
            make_u_fn(params), elems_en, bx_en, bt_en, var_form, nu,
            fields_fn=_fields_fn(params),
        )
        return res * new_mask[None]

    def strong_res(params, Xr):
        """Pointwise strong residual u_t + u u_x - nu u_xx through the FULL
        ansatz (generic nested-JVP engine, so composite/feature ansatzes
        differentiate exactly) — the pinning term the weak objective's
        measured quasi-null front directions need (MEASUREMENTS.md
        "Physics-feature transfer")."""
        from hpvpinns_tpu.ops.fields import scalar_fields_2d

        f = scalar_fields_2d(make_u_fn(params), Xr[:, 0], Xr[:, 1], first_y_only=True)
        return f["uy"] + f["u"] * f["ux"] - nu * f["uxx"]

    ws = float(getattr(cfg, "strong_weight", 1.0))

    def loss_fn(params, data, axis_name=None):
        u_fn = make_u_fn(params)
        el = data["elements"]
        res = burgers_residual(
            u_fn, el, data["basis_x"], data["basis_t"], var_form, nu,
            fields_fn=_fields_fn(params),
        )
        lossv = variational_loss(res, el.mask, el.n_test)
        if axis_name is not None:  # explicit all-reduce (shard_map path)
            lossv = jax.lax.psum(lossv, axis_name)
        ub_pred = u_fn(data["xb"])
        lossb = jnp.mean((data["ub"] - ub_pred) ** 2)
        loss = wb * lossb + lossv
        aux = {"loss": loss, "lossb": lossb, "lossv": lossv}
        if n_strong > 0:
            lossr = jnp.mean(strong_res(params, data["xr"]) ** 2)
            loss = loss + ws * lossr
            aux = {"loss": loss, "lossb": lossb, "lossv": lossv, "lossr": lossr}
        return loss, aux

    # Dense space-time test grid, matching the AdvDiff layout.
    xt = np.linspace(cfg.domain_x[0], cfg.domain_x[1], 256)
    tt = np.arange(cfg.t_start, cfg.t_final + 0.01, 0.01)
    XT, TT = np.meshgrid(xt, tt)
    test_points = np.stack([XT.reshape(-1), TT.reshape(-1)], axis=-1)
    test_values = u_exact(test_points[:, 0:1], test_points[:, 1:2], nu)

    return Problem(
        name="burgers",
        config=cfg,
        spec=spec,
        data=data,
        loss_fn=loss_fn,
        init_params=make_net_init(spec, dtype=dtype),
        apply_override=(
            (lambda params, X: make_u_fn(params)(X))
            if (hard_bc or feature_fn is not None)
            else None
        ),
        exact=lambda x, t: u_exact(x, t, nu),
        test_points=test_points,
        test_values=test_values,
        extras={
            "mesh": mesh,
            "residual_fn": residual_fn,
            "enriched_residual_fn": enriched_residual_fn,
            "test_grid_shape": (len(tt), len(xt)),
            # GN resvec hook: the strong-collocation block, scaled so
            # sum(r^2) contributes exactly ws * mean(strong^2) to the loss
            **(
                {
                    "reg_resvec_fn": lambda params, data: (
                        jnp.sqrt(ws / data["xr"].shape[0])
                        * strong_res(params, data["xr"]).reshape(-1)
                    )
                }
                if n_strong > 0
                else {}
            ),
        },
    )
