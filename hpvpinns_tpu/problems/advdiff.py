"""Space-time advection-diffusion with inverse coefficient identification.

    u_t + V u_x = eps u_xx   on (x, t) in [-1, 1] x [0, T]
    u(x, 0) = -sin(pi x),  u(+-1, t) = 0                   (AdvDiff.py:351-353)
    true eps = gamma / pi                                   (AdvDiff.py:41-42)

The diffusion coefficient eps is a *trainable parameter* initialized at 1.0
(AdvDiff.py:63) entering the weak residual (AdvDiff.py:165,173); it is trained
jointly with the network by the same optimizer.  Identifiability comes from 15
interior sensor readings (3 stations x 5 LHS times, AdvDiff.py:464-483) added
to the boundary/initial data.  The exact solution is an 800-term Fourier
series (AdvDiff.py:416-445).
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp

from hpvpinns_tpu.config import AdvDiffConfig
from hpvpinns_tpu.geometry.mesh import TensorMesh2D
from hpvpinns_tpu.models.mlp import MLP, mlp_apply
from hpvpinns_tpu.ops.assembly import advdiff_residual, variational_loss
from hpvpinns_tpu.ops.taylor import taylor_fields_2d
from hpvpinns_tpu.problems.base import Problem, check_deriv_mode, make_net_init
from hpvpinns_tpu.problems.build import build_elements_2d, make_weighted_basis
from hpvpinns_tpu.spectral.quadrature import gauss_lobatto_jacobi
from hpvpinns_tpu.utils.sampling import lhs_interval


def u_initial(x):
    """AdvDiff.py:351-353."""
    return -np.sin(np.pi * x)


def u_exact(x, t, epsilon, velocity, trunc=800):
    """Analytic Fourier-series solution (AdvDiff.py:416-445), vectorized.

    x, t: broadcastable column arrays [N, 1]; at t == 0 returns u_initial
    exactly, as the reference does (AdvDiff.py:442-443).
    """
    x = np.asarray(x, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    x, t = np.broadcast_arrays(x, t)
    D, V = epsilon, velocity
    p = np.arange(0, trunc + 1.0)[None, :]
    xc = x.reshape(-1, 1)
    tc = t.reshape(-1, 1)

    c0 = 16 * np.pi**2 * D**3 * V * np.exp(V / D / 2 * (xc - V * tc / 2))
    c1_n = (-1.0) ** p * 2 * p * np.sin(p * np.pi * xc) * np.exp(-D * p**2 * np.pi**2 * tc)
    c1_d = V**4 + 8 * (V * np.pi * D) ** 2 * (p**2 + 1) + 16 * (np.pi * D) ** 4 * (p**2 - 1) ** 2
    c1 = np.sinh(V / D / 2) * np.sum(c1_n / c1_d, axis=-1, keepdims=True)
    c2_n = (
        (-1.0) ** p
        * (2 * p + 1)
        * np.cos((p + 0.5) * np.pi * xc)
        * np.exp(-D * (2 * p + 1) ** 2 * np.pi**2 * tc / 4)
    )
    c2_d = V**4 + (V * np.pi * D) ** 2 * (8 * p**2 + 8 * p + 10) + (np.pi * D) ** 4 * (
        4 * p**2 + 4 * p - 3
    ) ** 2
    c2 = np.cosh(V / D / 2) * np.sum(c2_n / c2_d, axis=-1, keepdims=True)
    c = (c0 * (c1 + c2)).reshape(x.shape)
    return np.where(t == 0, u_initial(x), c)


def default_lift(X):
    """Space-time lift g(x, t) = -sin(pi x) for the benchmark problem: exact
    on BOTH data boundaries (u(+-1, t) = 0 since sin(+-pi) = 0, and
    u(x, 0) = -sin(pi x), AdvDiff.py:351-353)."""
    return -jnp.sin(jnp.pi * X[:, 0:1])


def make_default_envelope(cfg: AdvDiffConfig, rate: float = 4.0):
    """D(x, t) = (x - a)(b - x)/((b-a)/2)^2 * (1 - exp(-rate t / T)):
    vanishes on x = a, b and on t = 0 — the hard-BC ansatz u = g + D * N then
    satisfies the BC and the IC exactly for any parameters.

    The SATURATING time factor matters (measured, MEASUREMENTS.md): a linear
    t/T factor keeps suppressing the network for all t and wrecks coefficient
    identification (eps err 612% f32).  NOTE: even with this envelope, the
    hard-BC ansatz is seed-UNRELIABLE for f32 coefficient identification
    (8-330% across seeds; the exactly-enforced IC/BC leaves only the 15
    sensors to constrain eps) — prefer soft BC for inverse runs (robust
    4-7%); hard-BC is the right tool for forward problems."""
    a, b = cfg.domain_x
    scale = ((b - a) / 2.0) ** 2

    def envelope(X):
        tfac = 1.0 - jnp.exp(-rate * X[:, 1:2] / cfg.t_final)
        return (X[:, 0:1] - a) * (b - X[:, 0:1]) / scale * tfac

    return envelope


def training_data(cfg: AdvDiffConfig, rng: np.random.Generator, u_data_fn=None,
                  ic_fn=None):
    """Boundary + initial + interior-sensor data (AdvDiff.py:357-384,464-483).

    `u_data_fn(x, t) -> u` (host numpy, column arrays) overrides the data
    source everywhere — boundary, initial edge, AND sensor readings — for
    manufactured-solution problems (make_manufactured); the default is the
    benchmark's homogeneous BC / -sin(pi x) IC / exact-series sensors.
    `ic_fn(x) -> u` overrides the INITIAL edge only (placed at t =
    cfg.t_start) — a previous time slab's network state in a time-marching
    sequence (training/timemarch.py); without it a t_start > 0 slab uses
    the exact series at t_start.
    """
    T0, T, (xl, xr) = cfg.t_start, cfg.t_final, cfg.domain_x
    n = cfg.n_bound
    eps_true = cfg.gamma / np.pi

    t_up = T0 + (T - T0) * lhs_interval(0, 1, n, rng)
    t_lo = T0 + (T - T0) * lhs_interval(0, 1, n, rng)
    x_in = lhs_interval(xl, xr, n, rng)
    t_in = np.full_like(x_in, T0)
    pts = [
        np.hstack([np.full_like(t_up, xr), t_up]),
        np.hstack([np.full_like(t_lo, xl), t_lo]),
        np.hstack([x_in, t_in]),
    ]
    if ic_fn is not None:
        u0 = np.asarray(ic_fn(x_in)).reshape(n, 1)
    elif u_data_fn is not None:
        u0 = u_data_fn(x_in, t_in)
    elif T0 == 0.0:
        u0 = u_initial(x_in)
    else:
        u0 = u_exact(x_in, t_in, eps_true, cfg.velocity, cfg.fourier_terms)
    if u_data_fn is None:
        vals = [np.zeros((n, 1)), np.zeros((n, 1)), u0]
    else:
        vals = [
            u_data_fn(np.full_like(t_up, xr), t_up),
            u_data_fn(np.full_like(t_lo, xl), t_lo),
            u0,
        ]

    # Interior sensors: fixed x stations, LHS times, exact-series readings
    # (+ optional measurement noise — robustness knob, beyond the reference).
    # The noise uses its own child generator (spawned unconditionally) so the
    # sensor LOCATIONS are identical with and without noise.
    noise_rng = np.random.default_rng(rng.integers(0, 2**31))
    for station in cfg.sensor_stations:
        ts = T0 + (T - T0) * lhs_interval(0, 1, cfg.n_sensors_per_station, rng)
        xs = np.full_like(ts, station)
        pts.append(np.hstack([xs, ts]))
        if u_data_fn is None:
            reading = u_exact(xs, ts, eps_true, cfg.velocity, cfg.fourier_terms)
        else:
            reading = u_data_fn(xs, ts)
        if cfg.sensor_noise_std > 0:
            reading = reading + noise_rng.normal(0.0, cfg.sensor_noise_std, reading.shape)
        vals.append(reading)
    return np.concatenate(pts), np.concatenate(vals)


def make_manufactured(
    cfg: AdvDiffConfig, velocity_fn, epsilon: float | None = None, profile: str = "sin",
):
    """Manufactured-solution pair (u_fn, f_fn) for the FORCED equation

        u_t + V(x) u_x - eps u_xx = f(x, t)

    with u(x, t) = sin(pi x) exp(-t): homogeneous at x = +-1 for the
    benchmark domain, so the data pipeline needs no changes beyond reading
    u_fn.  The analytic solution of the reference problem only exists for
    CONSTANT velocity (AdvDiff.py:416-445); this is how the framework poses
    problems whose true advection field genuinely varies in space — the
    ground truth enters only through f and the sensor readings.

    `velocity_fn` must be written with generic array operators (e.g.
    ``lambda x: 1.0 + 0.3 * x``): it is called on host numpy arrays here and
    on device arrays inside the weak form.  `epsilon` defaults to the
    config's true value gamma/pi; it may also be a CALLABLE eps(x) — a true
    space-dependent diffusion field (identified with epsilon_model=
    "quadratic" or "mlp"; the operator convention is the non-divergence form
    eps(x) u_xx, matching the weak-form assembly).

    `profile` selects the spatial shape (both vanish at x = +-1):
      "sin": u = sin(pi x) e^{-t} — but u_xx vanishes at x = 0, so a FIELD
             eps(x) is locally unobservable there (measured:
             the neural-field recovery plateaus ~12-19% on this profile);
      "cos": u = cos(pi x / 2) e^{-t} — u_xx nonvanishing in the whole
             interior: the observable choice for coefficient-FIELD inversion.
    """
    if epsilon is None:
        eps_fn = lambda x: cfg.gamma / np.pi  # noqa: E731
    elif callable(epsilon):
        eps_fn = epsilon
    else:
        eps_fn = lambda x: epsilon  # noqa: E731

    if profile == "sin":

        def u_fn(x, t):
            return np.sin(np.pi * x) * np.exp(-t)

        def f_fn(X, T):
            return np.exp(-T) * (
                -np.sin(np.pi * X)
                + velocity_fn(X) * np.pi * np.cos(np.pi * X)
                + eps_fn(X) * np.pi**2 * np.sin(np.pi * X)
            )

    elif profile == "cos":
        h = np.pi / 2.0

        def u_fn(x, t):
            return np.cos(h * x) * np.exp(-t)

        def f_fn(X, T):
            return np.exp(-T) * (
                -np.cos(h * X)
                - velocity_fn(X) * h * np.sin(h * X)
                + eps_fn(X) * h**2 * np.cos(h * X)
            )

    else:
        raise ValueError(f"profile must be 'sin' or 'cos'; got {profile!r}")

    return u_fn, f_fn


def build(
    cfg: AdvDiffConfig,
    rng: np.random.Generator | None = None,
    lift_fn=None,
    envelope_fn=None,
    u_fn=None,
    f_fn=None,
    velocity_fn=None,
    epsilon_fn=None,
    ic_fn=None,
) -> Problem:
    """`cfg.hard_bc` (or explicit lift_fn/envelope_fn, jnp-traceable
    [P,2] -> [P,1]) switches on the lifted ansatz u = g + D * N: the IC and BC
    hold exactly by construction, so the data loss reduces to the interior
    sensors and all remaining capacity goes to the PDE + identification.
    Defaults fit the benchmark problem (default_lift / make_default_envelope).

    Manufactured-solution overrides (beyond the reference, whose F = 0 at
    AdvDiff.py:180): `u_fn(x, t)` replaces the exact solution everywhere
    (boundary/IC/sensor data, test grid, extras["exact"]); `f_fn(X, T)` is a
    forcing projected offline onto the test basis exactly like the Poisson
    RHS (build_elements_2d); `velocity_fn(x)` is the TRUE space-dependent
    advection field used by forward runs (trainable runs start from
    cfg.velocity_init and must recover it from the data).  Use
    `make_manufactured(cfg, velocity_fn)` for a consistent (u_fn, f_fn) pair.
    """
    dtype = jnp.dtype(cfg.dtype)
    rng = rng or np.random.default_rng(cfg.train.seed)
    # `epsilon_fn` is the TRUE space-dependent diffusion field of a
    # manufactured problem (make_manufactured(..., epsilon=epsilon_fn)); the
    # scalar eps_true report becomes its exact domain mean.
    if epsilon_fn is not None:
        _exs = np.linspace(cfg.domain_x[0], cfg.domain_x[1], 4097)
        eps_true = float(
            np.trapezoid(np.asarray(epsilon_fn(_exs)), _exs)
            / (cfg.domain_x[1] - cfg.domain_x[0])
        )
    else:
        eps_true = cfg.gamma / np.pi
    if cfg.grid_x is not None or cfg.grid_t is not None:
        from hpvpinns_tpu.geometry.mesh import Interval1D

        ax = (
            Interval1D(np.asarray(cfg.grid_x, dtype=np.float64))
            if cfg.grid_x is not None
            else Interval1D.uniform(*cfg.domain_x, cfg.n_elements_x)
        )
        at = (
            Interval1D(np.asarray(cfg.grid_t, dtype=np.float64))
            if cfg.grid_t is not None
            else Interval1D.uniform(cfg.t_start, cfg.t_final, cfg.n_elements_t)
        )
        mesh = TensorMesh2D(axis_x=ax, axis_y=at)
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
    elems = build_elements_2d(mesh, xq, wq, xq, wq, f_fn, ntx, ntt, dtype)

    Xb, ub = training_data(cfg, rng, u_data_fn=u_fn, ic_fn=ic_fn)
    data = {
        "elements": elems,
        "basis_x": bx,
        "basis_t": bt,
        "xb": jnp.asarray(Xb, dtype=dtype),
        "ub": jnp.asarray(ub, dtype=dtype),
    }

    var_form, wb, V = cfg.var_form, cfg.lossb_weight, cfg.velocity
    inverse = cfg.inverse
    mode = check_deriv_mode(cfg.deriv_mode)

    # Outflow boundary-layer input feature (layer_feature): the exact
    # solution has a layer of width eps/V at the outflow wall that a plain
    # coordinate MLP cannot resolve at trainable budgets — the measured
    # max-abs limiter of the family's FORWARD accuracy (MEASUREMENTS.md
    # "advdiff forward GN ladder": max-abs pinned at ~0.037 across capacity,
    # p, and h-clustering).  Appending the steady layer profile
    # exp(V (x - x_out)/eps) as a third network input hands the ansatz the
    # one length scale it is missing; the network stays in charge of the
    # amplitude/time dependence.
    feature_fn = None
    layers = cfg.layers
    if cfg.layer_feature:
        if inverse:
            raise ValueError(
                "layer_feature builds the outflow profile from the TRUE eps "
                "— a forward-problem tool only (it would leak the answer "
                "into an inverse run's ansatz); set inverse=False"
            )
        xl_, xr_ = cfg.domain_x
        if velocity_fn is not None:
            v_out = float(np.asarray(velocity_fn(np.asarray([xr_], dtype=np.float64)))[0])
            if v_out < 0:
                v_out = float(np.asarray(velocity_fn(np.asarray([xl_], dtype=np.float64)))[0])
        else:
            v_out = float(V)
        out_wall = xr_ if v_out >= 0 else xl_
        sgn = 1.0 if v_out >= 0 else -1.0
        if cfg.layer_feature_scale is not None:
            delta = float(cfg.layer_feature_scale)
        else:
            delta = eps_true / max(abs(v_out), 1e-12)

        def feature_fn(X, _w=out_wall, _d=delta, _s=sgn):
            # <= 1 everywhere in the domain; decays inward on the layer scale
            return jnp.exp(_s * (X[:, 0:1] - _w) / _d)

        layers = (layers[0] + 1,) + tuple(layers[1:])
        mode = "jvp"  # augmented-input ansatz: generic autodiff engine

    spec = MLP(layers=layers, activation=cfg.activation,
               adaptive_slope=cfg.adaptive_slope, precision=cfg.matmul_precision)
    hard_bc = getattr(cfg, "hard_bc", False) or lift_fn is not None or envelope_fn is not None
    if hard_bc:
        from hpvpinns_tpu.problems.base import make_composite_apply

        if ic_fn is not None or cfg.t_start != 0.0:
            raise ValueError(
                "hard_bc's lifted ansatz interpolates the analytic IC at "
                "t = 0; time-slab runs (t_start > 0 or a handed-off ic_fn) "
                "need soft BC"
            )
        if u_fn is not None and lift_fn is None:
            raise ValueError(
                "hard_bc with a manufactured u_fn needs an explicit lift_fn: "
                "the default lift interpolates the BENCHMARK's -sin(pi x) IC"
            )
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

    eps_model = cfg.epsilon_model
    if eps_model not in ("scalar", "quadratic", "mlp"):
        raise ValueError(
            f"epsilon_model must be 'scalar', 'quadratic' or 'mlp'; got {eps_model!r}"
        )
    if eps_model == "mlp":
        from hpvpinns_tpu.models.mlp import init_mlp

        eps_spec = MLP(layers=cfg.epsilon_mlp_layers, activation="tanh")
    vel_model = cfg.velocity_model
    if vel_model not in ("scalar", "linear", "quadratic"):
        raise ValueError(
            f"velocity_model must be 'scalar', 'linear' or 'quadratic'; got {vel_model!r}"
        )
    n_vel_coef = {"linear": 2, "quadratic": 3}.get(vel_model, 0)

    def pde_init():
        if not inverse:
            return {}
        pde = {}
        if eps_model == "quadratic":
            pde["eps_coef"] = jnp.asarray([cfg.epsilon_init, 0.0, 0.0], dtype=dtype)
        elif eps_model == "mlp":
            # Neural coefficient field, initialized (near-)flat at
            # epsilon_init: Xavier weights give small outputs and the final
            # bias carries the level.  Deterministic init from the train seed
            # (pde_init takes no key by the Problem contract).
            net = init_mlp(eps_spec, jax.random.key(cfg.train.seed + 101), dtype=dtype)
            # near-FLAT start at epsilon_init: shrink the output layer so the
            # field is epsilon_init + O(0.01) (Xavier alone gives O(1) wiggle,
            # which poisons the early PDE residual)
            net[-1] = dict(net[-1], W=net[-1]["W"] * 0.01,
                           b=net[-1]["b"] + jnp.asarray(cfg.epsilon_init, dtype=dtype))
            pde["eps_net"] = net
        else:
            pde["epsilon"] = jnp.asarray(cfg.epsilon_init, dtype=dtype)
        if cfg.velocity_trainable:
            if n_vel_coef:
                coef = [cfg.velocity_init] + [0.0] * (n_vel_coef - 1)
                pde["vel_coef"] = jnp.asarray(coef, dtype=dtype)
            else:
                pde["velocity"] = jnp.asarray(cfg.velocity_init, dtype=dtype)
        return pde

    def v_of(params, x):
        """The advection velocity at points x — a scalar, a trainable scalar,
        a trainable polynomial field V(x) = v0 + v1 x (+ v2 x^2), or the true
        manufactured field (forward runs with velocity_fn)."""
        if inverse and cfg.velocity_trainable:
            if n_vel_coef:
                c = params["pde"]["vel_coef"]
                v = c[0] + c[1] * x
                if n_vel_coef == 3:
                    v = v + c[2] * x * x
                return v
            return params["pde"]["velocity"]
        if velocity_fn is not None:
            return velocity_fn(x)
        return V

    def eps_of(params, x):
        """Scalar or field eps(x) from the trainable PDE leaves (forward
        runs: the true field/scalar)."""
        if not inverse:
            return epsilon_fn(x) if epsilon_fn is not None else eps_true
        if eps_model == "quadratic":
            c = params["pde"]["eps_coef"]
            return c[0] + c[1] * x + c[2] * x * x
        if eps_model == "mlp":
            flat = jnp.reshape(x, (-1, 1))
            return mlp_apply(eps_spec, params["pde"]["eps_net"], flat).reshape(jnp.shape(x))
        return params["pde"]["epsilon"]

    def eps_x_of(params, x):
        """d(eps)/dx — the extra IBP term for variable eps (analytic for the
        quadratic field; exact autodiff of the neural field)."""
        if inverse and eps_model == "quadratic":
            c = params["pde"]["eps_coef"]
            return c[1] + 2.0 * c[2] * x
        if inverse and eps_model == "mlp":
            flat = jnp.reshape(x, (-1, 1))
            f = lambda z: mlp_apply(eps_spec, params["pde"]["eps_net"], z)
            _, dx = jax.jvp(f, (flat,), (jnp.ones_like(flat),))
            return dx.reshape(jnp.shape(x))
        if not inverse and epsilon_fn is not None:
            # forward run at a true varying field: exact autodiff of the
            # (jnp-traceable) epsilon_fn
            _, dx = jax.jvp(epsilon_fn, (x,), (jnp.ones_like(x),))
            return dx
        return 0.0

    a_dom, b_dom = cfg.domain_x
    _mx = 0.5 * (a_dom + b_dom)
    _mx2 = (a_dom * a_dom + a_dom * b_dom + b_dom * b_dom) / 3.0

    if eps_model == "mlp":
        _eps_mean_grid = jnp.linspace(a_dom, b_dom, 257).reshape(-1, 1).astype(dtype)

    def eps_domain_mean(params):
        """Exact domain average of eps(x) (not a quadrature-point mean —
        GLJ points cluster at edges and would bias the report; the neural
        field is averaged on a uniform 257-point grid)."""
        if not inverse:
            return eps_true
        if eps_model == "quadratic":
            c = params["pde"]["eps_coef"]
            return c[0] + c[1] * _mx + c[2] * _mx2
        if eps_model == "mlp":
            return jnp.mean(mlp_apply(eps_spec, params["pde"]["eps_net"], _eps_mean_grid))
        return params["pde"]["epsilon"]

    def vel_domain_mean(params):
        """Exact domain average of the (possibly trainable) velocity."""
        if inverse and cfg.velocity_trainable:
            if n_vel_coef:
                c = params["pde"]["vel_coef"]
                v = c[0] + c[1] * _mx
                if n_vel_coef == 3:
                    v = v + c[2] * _mx2
                return v
            return params["pde"]["velocity"]
        if velocity_fn is not None:
            xs = np.linspace(a_dom, b_dom, 4097)
            return float(np.trapezoid(np.asarray(velocity_fn(xs)), xs) / (b_dom - a_dom))
        return V

    def _fields_fn(params):
        if mode == "taylor":
            return lambda x, y, **kw: taylor_fields_2d(spec, params["net"], x, y, **kw)
        return None

    def residual_fn(params, data):
        """Masked weak residual Res[e, k, r] — the per-element indicator
        source for adaptive refinement (adaptive.py)."""
        el = data["elements"]
        res = advdiff_residual(
            make_u_fn(params), el, data["basis_x"], data["basis_t"], var_form,
            v_of(params, el.x), eps_of(params, el.x),
            fields_fn=_fields_fn(params), epsilon_x=eps_x_of(params, el.x),
        )
        return res * el.mask

    _enriched_cache = {}

    def enriched_residual_fn(params, enrich: int = 3):
        """Weak residual against the tensor test modes NOT in the training
        basis — hierarchical a-posteriori estimation (same construction as
        burgers'; see adaptive.element_indicator).  Returns
        [E, K+enrich, R+enrich] with the trained block zeroed."""
        n_x = int(ntx.max()) + enrich
        n_t = int(ntt.max()) + enrich
        key = (n_x, n_t)
        if key not in _enriched_cache:
            bx_en = make_weighted_basis(n_x, xq, wq, dtype)
            bt_en = make_weighted_basis(n_t, xq, wq, dtype)
            elems_en = build_elements_2d(
                mesh, xq, wq, xq, wq, f_fn,
                np.full(mesh.axis_x.n_elem, n_x), np.full(mesh.axis_y.n_elem, n_t),
                dtype,
            )
            new_mask = np.ones((n_t, n_x))
            new_mask[: int(ntt.max()), : int(ntx.max())] = 0.0
            _enriched_cache[key] = (bx_en, bt_en, elems_en, jnp.asarray(new_mask, dtype=dtype))
        bx_en, bt_en, elems_en, new_mask = _enriched_cache[key]
        res = advdiff_residual(
            make_u_fn(params), elems_en, bx_en, bt_en, var_form,
            v_of(params, elems_en.x), eps_of(params, elems_en.x),
            fields_fn=_fields_fn(params), epsilon_x=eps_x_of(params, elems_en.x),
        )
        return res * new_mask[None]

    def loss_fn(params, data, axis_name=None):
        u_fn = make_u_fn(params)
        el = data["elements"]
        eps = eps_of(params, el.x)
        fields_fn = _fields_fn(params)
        res = advdiff_residual(
            u_fn, el, data["basis_x"], data["basis_t"], var_form, v_of(params, el.x), eps,
            fields_fn=fields_fn, epsilon_x=eps_x_of(params, el.x),
        )
        lossv = variational_loss(res, el.mask, el.n_test)
        if axis_name is not None:  # explicit all-reduce (shard_map path)
            lossv = jax.lax.psum(lossv, axis_name)
        ub_pred = u_fn(data["xb"])
        lossb = jnp.mean((data["ub"] - ub_pred) ** 2)
        loss = wb * lossb + lossv
        if inverse and cfg.epsilon_reg > 0 and eps_model in ("quadratic", "mlp"):
            # Tikhonov smoothness on the coefficient field (coefficient
            # inversion is unobservable where u_xx ~ 0)
            lossr = cfg.epsilon_reg * jnp.mean(eps_x_of(params, el.x) ** 2)
            loss = loss + lossr
        aux = {"loss": loss, "lossb": lossb, "lossv": lossv}
        if inverse:
            aux["epsilon"] = eps_domain_mean(params)
            if eps_model == "quadratic":
                aux["eps_c1"] = params["pde"]["eps_coef"][1]
                aux["eps_c2"] = params["pde"]["eps_coef"][2]
            if cfg.velocity_trainable:
                aux["velocity"] = vel_domain_mean(params)
                if n_vel_coef:
                    aux["vel_c1"] = params["pde"]["vel_coef"][1]
                    if n_vel_coef == 3:
                        aux["vel_c2"] = params["pde"]["vel_coef"][2]
        return loss, aux

    if inverse and cfg.epsilon_reg > 0 and eps_model in ("quadratic", "mlp"):
        def reg_resvec_fn(params, data):
            """Tikhonov penalty as least-squares residuals: sum(r^2) equals
            the loss_fn's lossr term exactly (Gauss-Newton support)."""
            el = data["elements"]
            ex = eps_x_of(params, el.x) * jnp.ones_like(el.x)
            return jnp.sqrt(cfg.epsilon_reg / ex.size) * ex.reshape(-1)
    else:
        reg_resvec_fn = None

    # Dense space-time test grid: 256 x-points, time step 0.01 (AdvDiff.py:448-450).
    xt = np.linspace(cfg.domain_x[0], cfg.domain_x[1], 256)
    tt = np.arange(cfg.t_start, cfg.t_final + 0.01, 0.01)
    XT, TT = np.meshgrid(xt, tt)
    test_points = np.stack([XT.reshape(-1), TT.reshape(-1)], axis=-1)
    if u_fn is None:
        exact = lambda x, t: u_exact(x, t, eps_true, cfg.velocity, cfg.fourier_terms)
    else:
        exact = u_fn
    test_values = exact(test_points[:, 0:1], test_points[:, 1:2])

    # The scalar "true velocity" report: the domain mean of the manufactured
    # field when one is given (coefficient trajectories are compared against
    # it by the CLI/accuracy harness), else the reference's constant V.
    if velocity_fn is not None:
        _xs = np.linspace(a_dom, b_dom, 4097)
        velocity_true = float(np.trapezoid(np.asarray(velocity_fn(_xs)), _xs) / (b_dom - a_dom))
    else:
        velocity_true = cfg.velocity

    return Problem(
        name="advdiff",
        config=cfg,
        spec=spec,
        data=data,
        loss_fn=loss_fn,
        init_params=make_net_init(spec, pde_init=pde_init, dtype=dtype),
        apply_override=(
            (lambda params, X: make_u_fn(params)(X))
            if (hard_bc or feature_fn is not None)
            else None
        ),
        exact=exact,
        test_points=test_points,
        test_values=test_values,
        extras={
            "mesh": mesh,
            "residual_fn": residual_fn,
            "enriched_residual_fn": enriched_residual_fn,
            "reg_resvec_fn": reg_resvec_fn,
            "eps_true": eps_true,
            "eps_of": eps_of,
            "eps_domain_mean": eps_domain_mean,
            "v_of": v_of,
            "vel_domain_mean": vel_domain_mean,
            "velocity_true": velocity_true,
            "velocity_fn": velocity_fn,
            "epsilon_fn": epsilon_fn,
            "f_rhs": f_fn,
            "test_grid_shape": (len(tt), len(xt)),
        },
    )
