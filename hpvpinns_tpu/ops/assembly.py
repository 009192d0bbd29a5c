"""Variational (weak-form) residual assembly, batched over elements.

Replicates the mathematics of the reference's graph-build element loops —
Poisson-1D.py:64-96, Poisson-2D.py:68-120, AdvDiff.py:108-182 — as fully
batched contractions with a leading element axis (the vmap/sharding axis).

Residual definition per element e and test function n (1D) / (k, r) (2D):

    Res[e, n] = U[e, n] - F[e, n]

where F is the offline RHS projection (ops free of the network, precomputed
on host; Poisson-1D.py:277-291, Poisson-2D.py:386-414) and U contracts the
network's derivative fields against the quadrature-weighted test basis.
`var_form` selects how many times the second-order term was integrated by
parts; the sign/jacobian pattern of every form below follows the reference
formulas exactly (cited per branch).

All basis matrices arrive with quadrature weights already folded in
(Wphi[n,q] = w_q * phi_n(xi_q)); jacobians are per-element vectors so the
whole assembly is element-uniform code — ragged test-function counts
(p-nonuniformity, Poisson-1D.py:268) are handled by masking in the loss.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax

from hpvpinns_tpu.ops.contract import contract_1d, contract_2d
from hpvpinns_tpu.ops.fields import scalar_fields_1d, scalar_fields_2d


def _register(cls, meta_fields=()):
    data_fields = tuple(
        f.name for f in dataclasses.fields(cls) if f.name not in meta_fields
    )
    jax.tree_util.register_dataclass(cls, data_fields, tuple(meta_fields))
    return cls


@dataclass(frozen=True)
class Basis1D:
    """Quadrature-weighted test basis on one reference axis.

    wphi/wdphi/wd2phi: [N, Q] = w_q * {phi, phi', phi''}_n(xi_q).
    dphi_b: [N, 2] UNweighted phi'_n at xi = -1, +1 (boundary-flux term of the
    twice-integrated form, Poisson-1D.py:89-90).
    """

    wphi: jax.Array
    wdphi: jax.Array
    wd2phi: jax.Array
    dphi_b: jax.Array


@dataclass(frozen=True)
class Elements1D:
    """Per-element geometry + targets for a 1D assembly.

    x:      [E, Q] physical quadrature points.
    bounds: [E, 2] physical element endpoints.
    jac:    [E]    affine jacobian (x_r - x_l)/2 per element.
    f_proj: [E, N] RHS projections F[e, n].
    mask:   [E, N] 1.0 where test index n < n_test[e] (p-nonuniform support).
    n_test: [E]    per-element test-function counts (float, for the mean).
    """

    x: jax.Array
    bounds: jax.Array
    jac: jax.Array
    f_proj: jax.Array
    mask: jax.Array
    n_test: jax.Array


@dataclass(frozen=True)
class Elements2D:
    """Per-element geometry + targets for a tensor-product 2D assembly.

    x, y:   [E, Qy, Qx] physical quadrature points (y = slow axis, matching
            the reference's meshgrid flattening, Poisson-2D.py:362-364).
    bounds_x, bounds_y: [E, 2] physical per-axis element bounds (needed by
            weak forms with live element-boundary flux terms — the machinery
            the reference builds-but-never-uses at AdvDiff.py:132-154).
    jac_x, jac_y: [E] per-axis jacobians; full jacobian = jac_x * jac_y.
    f_proj: [E, K, R] RHS projections F[e, k, r] (zeros for AdvDiff,
            AdvDiff.py:180).
    mask:   [E, K, R] test-index mask; n_test: [E] = number of active (k, r)
            pairs per element.
    """

    x: jax.Array
    y: jax.Array
    bounds_x: jax.Array
    bounds_y: jax.Array
    jac_x: jax.Array
    jac_y: jax.Array
    f_proj: jax.Array
    mask: jax.Array
    n_test: jax.Array


_register(Basis1D)
_register(Elements1D)
_register(Elements2D)


def poisson1d_residual(u_fn, elems: Elements1D, basis: Basis1D, var_form: int, fields_fn=None):
    """Res[e, n] for -u'' = f with test fns phi_n (Poisson-1D.py:82-94).

    var_form 1:  U = -jac * sum_q w u_xx phi_n            (:83-84)
    var_form 2:  U =        sum_q w u_x  phi'_n           (:86-87)  [jacobians
                 cancel: dx = jac dxi, d/dx = (1/jac) d/dxi]
    var_form 3:  U = -(1/jac) sum_q w u phi''_n
                     + (1/jac) [u(x_r) phi'_n(+1) - u(x_l) phi'_n(-1)]  (:88-91)
    """
    with jax.named_scope("vpinn_fields_1d"):
        if fields_fn is None:
            u, ux, uxx = scalar_fields_1d(u_fn, elems.x)
        else:  # fused Taylor-mode propagation (ops/taylor.py)
            u, ux, uxx = fields_fn(elems.x)
    if var_form == 1:
        U = -elems.jac[:, None] * contract_1d(basis.wphi, uxx)
    elif var_form == 2:
        U = contract_1d(basis.wdphi, ux)
    elif var_form == 3:
        inv_jac = 1.0 / elems.jac[:, None]
        U = -inv_jac * contract_1d(basis.wd2phi, u)
        u_b = u_fn(elems.bounds.reshape(-1, 1)).reshape(elems.bounds.shape)
        flux = u_b[:, 1:2] * basis.dphi_b[None, :, 1] - u_b[:, 0:1] * basis.dphi_b[None, :, 0]
        U = U + inv_jac * flux
    else:
        raise ValueError(f"Poisson-1D var_form must be 1, 2 or 3; got {var_form}")
    return U - elems.f_proj


def _edge_values_2d(u_fn, elems: Elements2D):
    """Ansatz values on the four element edges, at the quadrature nodes of
    the tangential axis.

    Returns (u_left, u_right) each [E, Qy] — u at (x = bounds_x, y_qy) — and
    (u_bottom, u_top) each [E, Qx] — u at (x_qx, y = bounds_y).  This is the
    live version of the boundary-quadrature tensors the reference constructs
    but never uses (AdvDiff.py:132-154).
    """
    import jax.numpy as jnp

    y_edge = elems.y[:, :, 0]  # [E, Qy] (y constant along qx)
    x_edge = elems.x[:, 0, :]  # [E, Qx] (x constant along qy)

    def eval_at(a, b):  # a, b: [E, P] -> u [E, P]
        pts = jnp.stack([a, b], axis=-1).reshape(-1, 2)
        return u_fn(pts).reshape(a.shape)

    xl = jnp.broadcast_to(elems.bounds_x[:, 0:1], y_edge.shape)
    xr = jnp.broadcast_to(elems.bounds_x[:, 1:2], y_edge.shape)
    yb = jnp.broadcast_to(elems.bounds_y[:, 0:1], x_edge.shape)
    yt = jnp.broadcast_to(elems.bounds_y[:, 1:2], x_edge.shape)
    return eval_at(xl, y_edge), eval_at(xr, y_edge), eval_at(x_edge, yb), eval_at(x_edge, yt)


def _flux_2d(u_lo, u_hi, wphi_tan, dphi_b):
    """Boundary-flux tensor [u dphi]_lo^hi integrated along the tangential
    axis:  Flux[e, k] outer dphi_b[r] -> [E, K, R]-compatible pieces.

    u_lo/u_hi: [E, Qtan] edge values; wphi_tan: [K, Qtan] weighted tangential
    basis; dphi_b: [R, 2] UNweighted normal-basis derivative at xi = -1, +1.
    Returns [E, K, R]: sum_q wphi_tan[k,q] (u_hi[e,q] dphi_b[r,1]
                                            - u_lo[e,q] dphi_b[r,0]).
    """
    import jax.numpy as jnp

    t_hi = jnp.einsum("kq,eq->ek", wphi_tan, u_hi, precision=jax.lax.Precision.HIGHEST)
    t_lo = jnp.einsum("kq,eq->ek", wphi_tan, u_lo, precision=jax.lax.Precision.HIGHEST)
    return t_hi[:, :, None] * dphi_b[None, None, :, 1] - t_lo[:, :, None] * dphi_b[None, None, :, 0]


def poisson2d_residual(u_fn, elems: Elements2D, bx: Basis1D, by: Basis1D, var_form, fields_fn=None):
    """Res[e, k, r] for Delta u = f on tensor-product elements
    (Poisson-2D.py:91-118; integrand convention f = Delta u, :307-310).

    var_form 0:  U = jac * C(phi_r, phi_k, u_xx + u_yy)             (:93-96)
    var_form 1:  U = -jac_y * C(phi'_r, phi_k, u_x)
                     -jac_x * C(phi_r, phi'_k, u_y)                 (:98-105;
                 jac/jac_x = jac_y and vice versa)
    var_form 2:  U = jac * [C(phi''_r, phi_k, u) + C(phi_r, phi''_k, u)]
                 (:108-115 — NOTE: reproduces the reference formula verbatim.
                 It omits the 1/jac^2 reference-derivative scalings AND the
                 [u dphi] boundary flux of an exact second integration by
                 parts, so it is a consistent weak form only on a single
                 [-1,1]^2 element AND for solutions vanishing on the domain
                 boundary; prefer var_form '2c' or 0/1 otherwise. The
                 configuration of record uses var_form=1.)
    var_form '2c' (this framework; the corrected exact twice-IBP form):
                 U = (jac_y/jac_x) [C(phi''_r, phi_k, u) - FluxX]
                   + (jac_x/jac_y) [C(phi_r, phi''_k, u) - FluxY]
                 FluxX[e,k,r] = sum_qy w phi_k(eta) [u phi'_r]_{x_l}^{x_r},
                 FluxY analogous — since phi(+-1) = 0, one boundary term of
                 each double integration by parts survives; with the proper
                 1/jac^2 derivative scalings this agrees with forms 0/1 on
                 ANY mesh to quadrature accuracy.

    C(a, b, g) = sum_{qy,qx} w_x a(xi_qx) w_y b(eta_qy) g[qy, qx].
    """
    with jax.named_scope("vpinn_fields_2d"):
        f2d = fields_fn or (lambda *a, **k: scalar_fields_2d(u_fn, *a, **k))
        # form 1 (once-integrated) needs NO second derivatives: skip the
        # second-order propagation streams entirely
        flds = f2d(elems.x, elems.y, firsts_only=(var_form == 1))
    jac = (elems.jac_x * elems.jac_y)[:, None, None]
    if var_form == 0:
        U = jac * contract_2d(bx.wphi, by.wphi, flds["uxx"] + flds["uyy"])
    elif var_form == 1:
        U = -(
            elems.jac_y[:, None, None] * contract_2d(bx.wdphi, by.wphi, flds["ux"])
            + elems.jac_x[:, None, None] * contract_2d(bx.wphi, by.wdphi, flds["uy"])
        )
    elif var_form == 2:
        U = jac * (
            contract_2d(bx.wd2phi, by.wphi, flds["u"])
            + contract_2d(bx.wphi, by.wd2phi, flds["u"])
        )
    elif var_form == "2c":
        u_l, u_r, u_b, u_t = _edge_values_2d(u_fn, elems)
        flux_x = _flux_2d(u_l, u_r, by.wphi, bx.dphi_b)
        flux_y_er = _flux_2d(u_b, u_t, bx.wphi, by.dphi_b)  # [E, R, K]
        flux_y = flux_y_er.transpose(0, 2, 1)
        U = (elems.jac_y / elems.jac_x)[:, None, None] * (
            contract_2d(bx.wd2phi, by.wphi, flds["u"]) - flux_x
        ) + (elems.jac_x / elems.jac_y)[:, None, None] * (
            contract_2d(bx.wphi, by.wd2phi, flds["u"]) - flux_y
        )
    else:
        raise ValueError(f"Poisson-2D var_form must be 0, 1, 2 or '2c'; got {var_form}")
    return U - elems.f_proj


def helmholtz2d_residual(u_fn, elems: Elements2D, bx: Basis1D, by: Basis1D, k_sq, var_form: int, fields_fn=None):
    """Res[e, k, r] for the 2D Helmholtz equation  Delta u + k^2 u = f  on
    tensor-product elements — the oscillatory/INDEFINITE extension of
    poisson2d_residual (same Laplacian weak forms, Poisson-2D.py:91-105,
    plus the zeroth-order mass term; no reference analog).

    var_form 0:  U = jac * C(phi_r, phi_k, u_xx + u_yy + k^2 u)
    var_form 1:  U = -jac_y * C(phi'_r, phi_k, u_x)
                     -jac_x * C(phi_r, phi'_k, u_y)
                     + jac * k^2 * C(phi_r, phi_k, u)
                 (only the second-order term integrates by parts; the mass
                 term needs no derivatives, so form 1 still skips every
                 second-order propagation stream)

    `k_sq` may be a traced scalar — the trainable wavenumber-identification
    leaf params["pde"]["k_sq"], the Helmholtz twin of the reference's
    trainable epsilon (AdvDiff.py:63).
    """
    with jax.named_scope("vpinn_fields_helmholtz2d"):
        f2d = fields_fn or (lambda *a, **k: scalar_fields_2d(u_fn, *a, **k))
        flds = f2d(elems.x, elems.y, firsts_only=(var_form == 1))
    jac = (elems.jac_x * elems.jac_y)[:, None, None]
    if var_form == 0:
        U = jac * contract_2d(
            bx.wphi, by.wphi, flds["uxx"] + flds["uyy"] + k_sq * flds["u"]
        )
    elif var_form == 1:
        U = (
            -(
                elems.jac_y[:, None, None] * contract_2d(bx.wdphi, by.wphi, flds["ux"])
                + elems.jac_x[:, None, None] * contract_2d(bx.wphi, by.wdphi, flds["uy"])
            )
            + k_sq * jac * contract_2d(bx.wphi, by.wphi, flds["u"])
        )
    else:
        raise ValueError(f"Helmholtz-2D var_form must be 0 or 1; got {var_form}")
    return U - elems.f_proj


def advdiff_residual(u_fn, elems: Elements2D, bx: Basis1D, bt: Basis1D, var_form: int, velocity, epsilon, fields_fn=None, epsilon_x=0.0):
    """Res[e, k, r] for u_t + V u_x - eps u_xx = 0 in space-time elements
    (AdvDiff.py:161-180; F = 0, the weak residual itself is minimized :180).

    The slow axis of Elements2D is time here (meshgrid convention
    AdvDiff.py:397-400).  `epsilon` may be a traced scalar — the trainable
    diffusion coefficient of the inverse problem (AdvDiff.py:63,165,173) —
    or a field broadcastable to [E, Qt, Qx] (space-dependent coefficient
    identification; beyond the reference): it multiplies the integrand
    inside the quadrature sum, which reduces to the reference's formula for
    constant epsilon.

    var_form 0:  U = jac * C(phi_r, phi_k, u_t + V u_x - eps u_xx)   (:161-167)
    var_form 1:  U = jac * C(phi_r, phi_k, u_t + V u_x + eps_x u_x)
                     + jac_t * C(phi'_r, phi_k, eps u_x)             (:169-174;
                 jac/jac_x = jac_t).  For variable eps(x) the integration by
                 parts of -eps u_xx produces BOTH terms (∫(eps phi)_x u_x =
                 ∫ eps_x phi u_x + ∫ eps phi' u_x); `epsilon_x` is the
                 analytic d(eps)/dx (0 for the reference's constant eps,
                 which recovers the reference formula exactly).
    var_form 2 (this framework; scalar eps only):  the diffusion term twice
                 integrated by parts, with the surviving [u phi'] boundary
                 flux LIVE — the space-time use of the boundary-quadrature
                 tensors the reference constructs but never exercises
                 (AdvDiff.py:132-154):
                 U = jac * C(phi_r, phi_k, u_t + V u_x)
                     - eps (jac_t/jac_x) [C(phi''_r, phi_k, u) - FluxX].
    """
    with jax.named_scope("vpinn_fields_2d"):
        f2d = fields_fn or (lambda *a, **k: scalar_fields_2d(u_fn, *a, **k))
        # only the un-integrated form 0 needs u_xx; forms 1/2 skip the
        # second-order propagation streams entirely
        kw = {"first_y_only": True} if var_form == 0 else {"firsts_only": True}
        flds = f2d(elems.x, elems.y, **kw)
    ut, ux = flds["uy"], flds["ux"]
    jac = (elems.jac_x * elems.jac_y)[:, None, None]
    if var_form == 0:
        integrand = ut + velocity * ux - epsilon * flds["uxx"]
        U = jac * contract_2d(bx.wphi, bt.wphi, integrand)
    elif var_form == 1:
        U = jac * contract_2d(bx.wphi, bt.wphi, ut + velocity * ux + epsilon_x * ux)
        U = U + elems.jac_y[:, None, None] * contract_2d(bx.wdphi, bt.wphi, epsilon * ux)
    elif var_form == 2:
        if not (isinstance(epsilon_x, (int, float)) and epsilon_x == 0.0):
            raise ValueError("AdvDiff var_form=2 supports scalar epsilon only")
        u_l, u_r, _, _ = _edge_values_2d(u_fn, elems)
        flux_x = _flux_2d(u_l, u_r, bt.wphi, bx.dphi_b)
        U = jac * contract_2d(bx.wphi, bt.wphi, ut + velocity * ux)
        U = U - epsilon * (elems.jac_y / elems.jac_x)[:, None, None] * (
            contract_2d(bx.wd2phi, bt.wphi, flds["u"]) - flux_x
        )
    else:
        raise ValueError(f"AdvDiff var_form must be 0, 1 or 2; got {var_form}")
    return U - elems.f_proj


def burgers_residual(u_fn, elems: Elements2D, bx: Basis1D, bt: Basis1D, var_form: int, nu, fields_fn=None):
    """Res[e, k, r] for the viscous Burgers equation
    u_t + u u_x = nu u_xx in space-time elements (F = 0).

    No reference analog — the framework's first NONLINEAR weak form; the
    convection term enters in conservation form (u u_x = (u^2/2)_x), so its
    integration by parts is exact and the quadrature sees the smoother u^2.

    var_form 0:  U = jac * C(phi_r, phi_k, u_t + u u_x - nu u_xx)
    var_form 1:  U = jac * C(phi_r, phi_k, u_t)
                     - (1/2) jac_t * C(phi'_r, phi_k, u^2)
                     + nu jac_t * C(phi'_r, phi_k, u_x)
                 [both x-IBPs drop their fluxes: phi_r(+-1) = 0]
    """
    with jax.named_scope("vpinn_fields_2d"):
        f2d = fields_fn or (lambda *a, **k: scalar_fields_2d(u_fn, *a, **k))
        # form 1's conservation-form convection + once-IBP diffusion need
        # only first derivatives
        kw = {"first_y_only": True} if var_form == 0 else {"firsts_only": True}
        flds = f2d(elems.x, elems.y, **kw)
    u, ut, ux = flds["u"], flds["uy"], flds["ux"]
    jac = (elems.jac_x * elems.jac_y)[:, None, None]
    jt = elems.jac_y[:, None, None]
    if var_form == 0:
        U = jac * contract_2d(bx.wphi, bt.wphi, ut + u * ux - nu * flds["uxx"])
    elif var_form == 1:
        U = (
            jac * contract_2d(bx.wphi, bt.wphi, ut)
            - 0.5 * jt * contract_2d(bx.wdphi, bt.wphi, u * u)
            + nu * jt * contract_2d(bx.wdphi, bt.wphi, ux)
        )
    else:
        raise ValueError(f"Burgers var_form must be 0 or 1; got {var_form}")
    return U - elems.f_proj


def ns_residual(w_fn, elems: Elements2D, bx: Basis1D, by: Basis1D, var_form: int, nu, fields_fn=None):
    """Res[e, i, k, r] for the steady incompressible Navier-Stokes SYSTEM

        u u_x + v u_y + p_x - nu (u_xx + u_yy) = 0     (i = 0, x-momentum)
        u v_x + v v_y + p_y - nu (v_xx + v_yy) = 0     (i = 1, y-momentum)
        u_x + v_y                              = 0     (i = 2, continuity)

    on tensor-product elements — the framework's first system of coupled
    PDEs (no reference analog: ehsankharazmi/hp-VPINNs is scalar-PDE only;
    the assembly pattern generalizes poisson2d_residual's, Poisson-2D.py:
    91-118, to a vector ansatz w = (u, v, p)).

    w_fn maps [P, 2] -> [P, 3].  The convection term stays in convective
    (non-conservation) form — it needs first derivatives only, which both
    forms below already have.

    var_form 0:  U_i = jac * C(phi_r, phi_k, strong integrand_i)
    var_form 1:  diffusion AND pressure-gradient once integrated by parts
                 (test functions vanish on element walls, so no flux):
      U_0 = jac * C(phi_r, phi_k, u u_x + v u_y)
            + nu [jac_y C(phi'_r, phi_k, u_x) + jac_x C(phi_r, phi'_k, u_y)]
            - jac_y C(phi'_r, phi_k, p)
      U_1 = analogous with v and - jac_x C(phi_r, phi'_k, p)
      U_2 = jac * C(phi_r, phi_k, u_x + v_y)

    Returns [E, 3, K, R]; the zero RHS projection broadcasts over the
    equation axis (f_proj[:, None]).
    """
    import jax.numpy as jnp

    from hpvpinns_tpu.ops.fields import vector_fields_2d

    with jax.named_scope("vpinn_fields_ns"):
        f2d = fields_fn or (lambda *a, **k: vector_fields_2d(w_fn, *a, **k))
        flds = f2d(elems.x, elems.y, firsts_only=(var_form == 1))
    w, wx, wy = flds["w"], flds["wx"], flds["wy"]
    u, v, p = w[..., 0], w[..., 1], w[..., 2]
    ux, vx, px = wx[..., 0], wx[..., 1], wx[..., 2]
    uy, vy_, py = wy[..., 0], wy[..., 1], wy[..., 2]
    conv_u = u * ux + v * uy
    conv_v = u * vx + v * vy_
    div = ux + vy_
    jac = (elems.jac_x * elems.jac_y)[:, None, None]
    jx = elems.jac_x[:, None, None]
    jy = elems.jac_y[:, None, None]
    if var_form == 0:
        wxx, wyy = flds["wxx"], flds["wyy"]
        U0 = jac * contract_2d(
            bx.wphi, by.wphi,
            conv_u + px - nu * (wxx[..., 0] + wyy[..., 0]),
        )
        U1 = jac * contract_2d(
            bx.wphi, by.wphi,
            conv_v + py - nu * (wxx[..., 1] + wyy[..., 1]),
        )
    elif var_form == 1:
        U0 = (
            jac * contract_2d(bx.wphi, by.wphi, conv_u)
            + nu * (
                jy * contract_2d(bx.wdphi, by.wphi, ux)
                + jx * contract_2d(bx.wphi, by.wdphi, uy)
            )
            - jy * contract_2d(bx.wdphi, by.wphi, p)
        )
        U1 = (
            jac * contract_2d(bx.wphi, by.wphi, conv_v)
            + nu * (
                jy * contract_2d(bx.wdphi, by.wphi, vx)
                + jx * contract_2d(bx.wphi, by.wdphi, vy_)
            )
            - jx * contract_2d(bx.wphi, by.wdphi, p)
        )
    else:
        raise ValueError(f"Navier-Stokes var_form must be 0 or 1; got {var_form}")
    U2 = jac * contract_2d(bx.wphi, by.wphi, div)
    U = jnp.stack([U0, U1, U2], axis=1)
    return U - elems.f_proj[:, None]


def ns_unsteady_residual(w_fn, elems: Elements3D, bx: Basis1D, by: Basis1D, bt: Basis1D, var_form: int, nu, fields_fn=None):
    """Res[e, i, m, k, r] for the UNSTEADY incompressible Navier-Stokes
    SYSTEM on space-time tensor elements (time = the slowest z axis, like
    advdiff2d):

        u_t + u u_x + v u_y + p_x - nu (u_xx + u_yy) = 0   (i = 0)
        v_t + u v_x + v v_y + p_y - nu (v_xx + v_yy) = 0   (i = 1)
        u_x + v_y                                    = 0   (i = 2)

    The time-dependent twin of ns_residual (steady Kovasznay system) —
    no reference analog.  w_fn maps [P, 3] (x, y, t) -> [P, 3] (u, v, p).

    var_form 0:  U_i = jac * C3(phi_r, phi_k, phi_m, strong integrand_i)
    var_form 1:  diffusion AND pressure-gradient once integrated by parts
                 in SPACE (test functions vanish on element side walls;
                 the u_t term stays strong — first order in time):
      U_0 = jac * C3(phi, phi, phi, u_t + u u_x + v u_y)
            + nu [jx C3(phi', phi, phi, u_x) + jy C3(phi, phi', phi, u_y)]
            - jx C3(phi', phi, phi, p)
      U_1 = analogous with v and - jy C3(phi, phi', phi, p)
      U_2 = jac * C3(phi, phi, phi, u_x + v_y)

    Returns [E, 3, M, K, R]; the zero RHS projection broadcasts over the
    equation axis (f_proj[:, None]).
    """
    import jax.numpy as jnp

    from hpvpinns_tpu.ops.contract import contract_3d
    from hpvpinns_tpu.ops.fields import vector_fields_3d

    with jax.named_scope("vpinn_fields_ns3d"):
        f3d = fields_fn or (lambda *a, **k: vector_fields_3d(w_fn, *a, **k))
        flds = f3d(elems.x, elems.y, elems.z, second=(var_form == 0))
    w, wx, wy, wt = flds["w"], flds["wx"], flds["wy"], flds["wz"]
    u, v = w[..., 0], w[..., 1]
    ux, vx, px = wx[..., 0], wx[..., 1], wx[..., 2]
    uy, vy_, py = wy[..., 0], wy[..., 1], wy[..., 2]
    conv_u = wt[..., 0] + u * ux + v * uy
    conv_v = wt[..., 1] + u * vx + v * vy_
    div = ux + vy_
    jac = (elems.jac_x * elems.jac_y * elems.jac_z)[:, None, None, None]
    if var_form == 0:
        wxx, wyy = flds["wxx"], flds["wyy"]
        U0 = jac * contract_3d(
            bx.wphi, by.wphi, bt.wphi,
            conv_u + px - nu * (wxx[..., 0] + wyy[..., 0]),
        )
        U1 = jac * contract_3d(
            bx.wphi, by.wphi, bt.wphi,
            conv_v + py - nu * (wxx[..., 1] + wyy[..., 1]),
        )
    elif var_form == 1:
        p = w[..., 2]
        jx = (elems.jac_y * elems.jac_z)[:, None, None, None]
        jy = (elems.jac_x * elems.jac_z)[:, None, None, None]
        U0 = (
            jac * contract_3d(bx.wphi, by.wphi, bt.wphi, conv_u)
            + nu * (
                jx * contract_3d(bx.wdphi, by.wphi, bt.wphi, ux)
                + jy * contract_3d(bx.wphi, by.wdphi, bt.wphi, uy)
            )
            - jx * contract_3d(bx.wdphi, by.wphi, bt.wphi, p)
        )
        U1 = (
            jac * contract_3d(bx.wphi, by.wphi, bt.wphi, conv_v)
            + nu * (
                jx * contract_3d(bx.wdphi, by.wphi, bt.wphi, vx)
                + jy * contract_3d(bx.wphi, by.wdphi, bt.wphi, vy_)
            )
            - jy * contract_3d(bx.wphi, by.wdphi, bt.wphi, p)
        )
    else:
        raise ValueError(f"unsteady Navier-Stokes var_form must be 0 or 1; got {var_form}")
    U2 = jac * contract_3d(bx.wphi, by.wphi, bt.wphi, div)
    U = jnp.stack([U0, U1, U2], axis=1)
    return U - elems.f_proj[:, None]


def variational_loss(res: jax.Array, mask: jax.Array, n_test: jax.Array) -> jax.Array:
    """loss_v = sum_e mean_n Res[e, n]^2 (Poisson-1D.py:95-96) with per-element
    test counts handled by masking (inactive test indices contribute zero)."""
    res2 = (res * mask) ** 2
    per_elem = res2.reshape(res.shape[0], -1).sum(axis=1) / n_test
    return per_elem.sum()


@dataclass(frozen=True)
class Elements3D:
    """Per-element geometry + targets for a tensor-product 3D assembly.

    x, y, z: [E, Qz, Qy, Qx] physical quadrature points (z slowest, x
    fastest); jac_*: [E] per-axis jacobians; f_proj/mask: [E, M, K, R];
    n_test: [E].  (No reference analog — 3D generalization.)
    """

    x: jax.Array
    y: jax.Array
    z: jax.Array
    jac_x: jax.Array
    jac_y: jax.Array
    jac_z: jax.Array
    f_proj: jax.Array
    mask: jax.Array
    n_test: jax.Array


_register(Elements3D)


def advdiff2d_residual(
    u_fn, elems: Elements3D, bx: Basis1D, by: Basis1D, bt: Basis1D,
    var_form: int, vx, vy, epsilon, fields_fn=None, epsilon_x=0.0, epsilon_y=0.0,
):
    """Res[e, m, k, r] for the 2D space-time advection-diffusion equation

        u_t + vx u_x + vy u_y - eps (u_xx + u_yy) = f

    on tensor-product (x, y, t) elements — the 2-space-dimension
    generalization of the reference's 1D space-time family (AdvDiff.py:
    161-180), assembled on the 3D machinery (time = the slowest z axis, so
    the element flat order is e = (ex*Ey + ey)*Et + et).

    var_form 0:  U = jac * C3(phi_r, phi_k, phi_m, ut + vx ux + vy uy
                              - eps (uxx + uyy))
    var_form 1:  both diffusion terms once integrated by parts (the test
                 functions vanish at the element x/y walls, so no flux):
                 U = jac * C3(phi_r, phi_k, phi_m, ut + vx ux + vy uy)
                     + eps (jac/jac_x) C3(phi'_r, phi_k, phi_m, ux)
                     + eps (jac/jac_y) C3(phi_r, phi'_k, phi_m, uy)

    vx/vy/epsilon may be traced scalars (trainable coefficients) or fields
    broadcastable to [E, Qt, Qy, Qx].  For a FIELD eps(x, y) under form 1,
    the integration by parts of -eps (u_xx + u_yy) produces BOTH the
    eps-weighted gradient terms and the eps_x u_x + eps_y u_y advection-like
    terms (the 2D twin of advdiff_residual's variable-eps contract);
    `epsilon_x`/`epsilon_y` are the analytic field derivatives (0 for the
    scalar coefficient, which recovers the scalar formula exactly).
    """
    from hpvpinns_tpu.ops.contract import contract_3d

    with jax.named_scope("vpinn_fields_3d"):
        if fields_fn is None:
            from hpvpinns_tpu.ops.fields import scalar_fields_3d

            flds = scalar_fields_3d(u_fn, elems.x, elems.y, elems.z, second=(var_form == 0))
        else:
            flds = fields_fn(elems.x, elems.y, elems.z, second=(var_form == 0))
        # form 0 never touches uzz (u_t is first-order): XLA dead-code
        # eliminates that propagation stream from the engines.
    ut, ux, uy = flds["uz"], flds["ux"], flds["uy"]
    jac = (elems.jac_x * elems.jac_y * elems.jac_z)[:, None, None, None]
    adv = ut + vx * ux + vy * uy
    if var_form == 0:
        U = jac * contract_3d(
            bx.wphi, by.wphi, bt.wphi, adv - epsilon * (flds["uxx"] + flds["uyy"])
        )
    elif var_form == 1:
        jx = (elems.jac_y * elems.jac_z)[:, None, None, None]
        jy = (elems.jac_x * elems.jac_z)[:, None, None, None]
        adv1 = adv + epsilon_x * ux + epsilon_y * uy
        U = (
            jac * contract_3d(bx.wphi, by.wphi, bt.wphi, adv1)
            + jx * contract_3d(bx.wdphi, by.wphi, bt.wphi, epsilon * ux)
            + jy * contract_3d(bx.wphi, by.wdphi, bt.wphi, epsilon * uy)
        )
    else:
        raise ValueError(f"AdvDiff-2D var_form must be 0 or 1; got {var_form}")
    return U - elems.f_proj


def poisson3d_residual(
    u_fn, elems: Elements3D, bx: Basis1D, by: Basis1D, bz: Basis1D, var_form: int, fields_fn=None
):
    """Res[e, m, k, r] for Delta u = f on tensor-product 3D elements —
    the volumetric generalization of poisson2d_residual (same f = Delta u
    convention and form numbering 0/1).

    var_form 0:  U = jac * C(phi_r, phi_k, phi_m, u_xx + u_yy + u_zz)
    var_form 1:  U = -(jac/jac_x) C(phi'_r, phi_k, phi_m, u_x)
                     -(jac/jac_y) C(phi_r, phi'_k, phi_m, u_y)
                     -(jac/jac_z) C(phi_r, phi_k, phi'_m, u_z)
    """
    from hpvpinns_tpu.ops.contract import contract_3d

    with jax.named_scope("vpinn_fields_3d"):
        if fields_fn is None:
            from hpvpinns_tpu.ops.fields import scalar_fields_3d

            flds = scalar_fields_3d(u_fn, elems.x, elems.y, elems.z, second=(var_form == 0))
        else:
            flds = fields_fn(elems.x, elems.y, elems.z, second=(var_form == 0))
    jac = (elems.jac_x * elems.jac_y * elems.jac_z)[:, None, None, None]
    if var_form == 0:
        U = jac * contract_3d(
            bx.wphi, by.wphi, bz.wphi, flds["uxx"] + flds["uyy"] + flds["uzz"]
        )
    elif var_form == 1:
        jx = (elems.jac_y * elems.jac_z)[:, None, None, None]
        jy = (elems.jac_x * elems.jac_z)[:, None, None, None]
        jz = (elems.jac_x * elems.jac_y)[:, None, None, None]
        U = -(
            jx * contract_3d(bx.wdphi, by.wphi, bz.wphi, flds["ux"])
            + jy * contract_3d(bx.wphi, by.wdphi, bz.wphi, flds["uy"])
            + jz * contract_3d(bx.wphi, by.wphi, bz.wdphi, flds["uz"])
        )
    else:
        raise ValueError(f"Poisson-3D var_form must be 0 or 1; got {var_form}")
    return U - elems.f_proj
