"""1D Poisson benchmark: -u'' = f on [-1, 1], hp-VPINN.

Problem of record (main/Poisson-1D/hp-VPINN-Poisson-1D.py):
    u(x) = 0.1 sin(8 pi x) + tanh(80 x)              (:248-253)
    f(x) = -u''(x)                                    (:255-257)
    boundary data: u(+-1) only                        (:298-299)
    loss = lossb_weight * mean((u_b - u_hat_b)^2) + sum_e mean_n Res^2
                                                      (:98-100)
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp

from hpvpinns_tpu.config import Poisson1DConfig
from hpvpinns_tpu.geometry.mesh import Interval1D
from hpvpinns_tpu.models.mlp import MLP, mlp_apply
from hpvpinns_tpu.ops.assembly import poisson1d_residual, variational_loss
from hpvpinns_tpu.ops.taylor import taylor_fields_1d
from hpvpinns_tpu.problems.base import Problem, check_deriv_mode, make_net_init
from hpvpinns_tpu.problems.build import build_elements_1d, make_weighted_basis
from hpvpinns_tpu.spectral.quadrature import gauss_lobatto_jacobi

OMEGA = 8 * np.pi
AMP = 1.0
R1 = 80.0


def u_exact(x):
    """Poisson-1D.py:251-253."""
    return AMP * (0.1 * np.sin(OMEGA * x) + np.tanh(R1 * x))


def f_rhs(x):
    """f = -u'' (Poisson-1D.py:255-257)."""
    g = -0.1 * OMEGA**2 * np.sin(OMEGA * x) - (2 * R1**2) * np.tanh(R1 * x) / np.cosh(R1 * x) ** 2
    return -AMP * g


def make_mesh(cfg: Poisson1DConfig) -> Interval1D:
    if cfg.grid is not None:
        return Interval1D(grid=np.asarray(cfg.grid, dtype=np.float64))
    return Interval1D.uniform(cfg.domain[0], cfg.domain[1], cfg.n_elements)


def default_lift_1d(domain, u_ex):
    """Linear interpolant of the Dirichlet data over the domain."""
    a, b = domain
    ua, ub = float(u_ex(np.array(a))), float(u_ex(np.array(b)))

    def lift(X):
        return ua + (ub - ua) * (X - a) / (b - a)

    return lift


def default_envelope_1d(domain):
    """D(x) = (x - a)(b - x), vanishing at both endpoints."""
    a, b = domain

    def envelope(X):
        return (X - a) * (b - X)

    return envelope


def build(cfg: Poisson1DConfig, u_fn=None, f_fn=None, hard_bc: bool | None = None) -> Problem:
    """Build the problem; `u_fn`/`f_fn` override the exact solution and
    forcing (custom manufactured solutions — the reference requires editing
    the driver script, Poisson-1D.py:251-257).  Both must be numpy-vectorized;
    f = -u''."""
    u_ex = u_fn or u_exact
    f_rh = f_fn or f_rhs
    dtype = jnp.dtype(cfg.dtype)
    mesh = make_mesh(cfg)
    hard_bc = cfg.hard_bc if hard_bc is None else hard_bc
    lift = default_lift_1d(cfg.domain, u_ex) if hard_bc else None
    envelope = default_envelope_1d(cfg.domain) if hard_bc else None
    xq, wq = gauss_lobatto_jacobi(cfg.n_quad, 0.0, 0.0)

    n_per_elem = (
        np.asarray(cfg.n_test_per_elem)
        if cfg.n_test_per_elem is not None
        else np.full(mesh.n_elem, cfg.n_test)
    )
    basis = make_weighted_basis(int(n_per_elem.max()), xq, wq, dtype)
    elems = build_elements_1d(mesh, xq, wq, f_rh, n_per_elem, dtype)

    # Boundary training data: the domain endpoints (Poisson-1D.py:298-299).
    xb = np.asarray(cfg.domain, dtype=np.float64)[:, None]
    ub = u_ex(xb)

    data = {
        "elements": elems,
        "basis": basis,
        "xb": jnp.asarray(xb, dtype=dtype),
        "ub": jnp.asarray(ub, dtype=dtype),
    }

    spec = MLP(layers=cfg.layers, activation=cfg.activation,
               adaptive_slope=cfg.adaptive_slope, precision=cfg.matmul_precision)
    var_form = cfg.var_form
    lossb_weight = cfg.lossb_weight
    mode = check_deriv_mode(cfg.deriv_mode)
    if hard_bc:
        mode = "jvp"  # composite ansatz: generic AD

    if hard_bc:
        from hpvpinns_tpu.problems.base import make_composite_apply

        composite = make_composite_apply(spec, lift, envelope)

    def make_u_fn(params):
        if hard_bc:
            return composite(params)
        return lambda X: mlp_apply(spec, params["net"], X)

    def residual_fn(params, data):
        """Masked weak residual Res[e, n] — the per-element a-posteriori
        error indicator source for adaptive refinement (adaptive.py)."""
        u_fn = make_u_fn(params)
        if mode == "taylor":
            fields_fn = lambda x: taylor_fields_1d(spec, params["net"], x)
        else:
            fields_fn = None
        res = poisson1d_residual(u_fn, data["elements"], data["basis"], var_form, fields_fn=fields_fn)
        return res * data["elements"].mask

    def loss_fn(params, data, axis_name=None):
        u_fn = make_u_fn(params)
        res = residual_fn(params, data)
        lossv = variational_loss(res, data["elements"].mask, data["elements"].n_test)
        if axis_name is not None:  # explicit all-reduce (shard_map path)
            lossv = jax.lax.psum(lossv, axis_name)
        ub_pred = u_fn(data["xb"])
        lossb = jnp.mean((data["ub"] - ub_pred) ** 2)
        loss = lossb_weight * lossb + lossv
        return loss, {"loss": loss, "lossb": lossb, "lossv": lossv}

    _enriched_cache = {}

    def enriched_residual_fn(params, enrich: int = 4):
        """Weak residual against the NEXT `enrich` test modes beyond the
        training basis (hierarchical a-posteriori estimation): the trained
        residual is near-orthogonal to the training modes, so under-resolution
        shows up exactly in the first untrained modes.  Returns [E, enrich]."""
        n_max = int(n_per_elem.max())
        key = n_max + enrich
        if key not in _enriched_cache:
            basis_en = make_weighted_basis(key, xq, wq, dtype)
            elems_en = build_elements_1d(
                mesh, xq, wq, f_rh, np.full(mesh.n_elem, key), dtype
            )
            _enriched_cache[key] = (basis_en, elems_en)
        basis_en, elems_en = _enriched_cache[key]
        u_fn = make_u_fn(params)
        res = poisson1d_residual(u_fn, elems_en, basis_en, var_form)
        return res[:, n_max:]

    xt = np.arange(-1.0, 1.0 + 0.001, 0.001)[:, None]  # Poisson-1D.py:315-316
    return Problem(
        name="poisson1d",
        config=cfg,
        spec=spec,
        data=data,
        loss_fn=loss_fn,
        init_params=make_net_init(spec, dtype=dtype),
        apply_override=(lambda params, X: make_u_fn(params)(X)) if hard_bc else None,
        exact=u_ex,
        test_points=xt,
        test_values=u_ex(xt),
        extras={
            "mesh": mesh,
            "f_rhs": f_rh,
            "residual_fn": residual_fn,
            "enriched_residual_fn": enriched_residual_fn,
        },
    )
