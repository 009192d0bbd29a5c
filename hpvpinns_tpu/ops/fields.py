"""Batched evaluation of the network and its PDE derivatives at quadrature points.

The reference evaluates `net_u`/`net_du` separately per element inside the
graph-build loop with nested reverse-mode `tf.gradients`
(Poisson-1D.py:75-76,144-148; Poisson-2D.py:81-83,175-185; AdvDiff.py:123-125).
Here all elements' quadrature points are batched into one flat [E*Q, d] array
and the derivatives come from *nested forward-mode JVPs* on the whole batch —
each JVP is just another chain of batched matmuls through the MLP, so the
entire field evaluation (u, u_x, u_xx, u_y, u_yy, u_t) stays matmul-shaped.

Forward mode is the right AD direction: the network input dimension is 1-2,
and only diagonal second derivatives are needed (no mixed terms in any of the
reference's PDE operators).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from hpvpinns_tpu.ops.derivatives import coord_tangent, dir_deriv, value_and_dir_derivs2


def scalar_fields_1d(u_fn, x):
    """(u, u_x, u_xx) at points x of shape [..., Q].

    u_fn maps [P, 1] -> [P, 1]; returns three arrays shaped like x.
    """
    shape = x.shape
    X = x.reshape(-1, 1)
    v = coord_tangent(X, 0)
    u, ux, uxx = value_and_dir_derivs2(u_fn, X, v)
    return u.reshape(shape), ux.reshape(shape), uxx.reshape(shape)


def scalar_fields_2d(
    u_fn, x, y, *,
    second_y: bool = True, first_y_only: bool = False, firsts_only: bool = False,
):
    """Network value and per-axis derivatives at 2D points.

    x, y: arrays of identical shape [..., Qy, Qx] (physical coordinates).
    u_fn maps [P, 2] -> [P, 1].

    Returns a dict with keys 'u', 'ux', 'uxx' and, depending on flags,
    'uy', 'uyy' (second_y) or just 'uy' (first_y_only — the AdvDiff case,
    where the y axis is time and only u_t is needed, AdvDiff.py:242-245).
    firsts_only=True returns {u, ux, uy} with NO nested (second-order) JVPs —
    the mode for once-integrated weak forms (var_form 1).
    """
    shape = x.shape
    X = jnp.stack([x.reshape(-1), y.reshape(-1)], axis=-1)
    vx = coord_tangent(X, 0)
    if firsts_only:
        vy = coord_tangent(X, 1)
        u, ux = jax.jvp(u_fn, (X,), (vx,))
        _, uy = jax.jvp(u_fn, (X,), (vy,))
        return {"u": u.reshape(shape), "ux": ux.reshape(shape), "uy": uy.reshape(shape)}
    u, ux, uxx = value_and_dir_derivs2(u_fn, X, vx)
    out = {
        "u": u.reshape(shape),
        "ux": ux.reshape(shape),
        "uxx": uxx.reshape(shape),
    }
    vy = coord_tangent(X, 1)
    if first_y_only:
        uy = dir_deriv(u_fn, X, vy)
        out["uy"] = uy.reshape(shape)
    elif second_y:
        _, uy, uyy = value_and_dir_derivs2(u_fn, X, vy)
        out["uy"] = uy.reshape(shape)
        out["uyy"] = uyy.reshape(shape)
    return out


def vector_fields_2d(w_fn, x, y, *, firsts_only: bool = False):
    """Vector-valued network fields at 2D points — the engine for PDE
    SYSTEMS (e.g. the steady Navier-Stokes (u, v, p) triple).

    w_fn maps [P, 2] -> [P, C]; x, y have identical shape [..., Qy, Qx].
    One nested-JVP chain differentiates ALL C components simultaneously
    (the JVP primitives in ops/derivatives.py are shape-generic), so the
    cost over the shared trunk is identical to the scalar engines'.

    Returns {'w', 'wx', 'wy'} plus {'wxx', 'wyy'} unless firsts_only, each
    shaped [..., Qy, Qx, C].  (No reference analog — the reference's PDE
    families are all scalar.)
    """
    shape = x.shape
    X = jnp.stack([x.reshape(-1), y.reshape(-1)], axis=-1)
    vx = coord_tangent(X, 0)
    vy = coord_tangent(X, 1)
    if firsts_only:
        w, wx = jax.jvp(w_fn, (X,), (vx,))
        _, wy = jax.jvp(w_fn, (X,), (vy,))
        c = w.shape[-1]
        return {
            "w": w.reshape(shape + (c,)),
            "wx": wx.reshape(shape + (c,)),
            "wy": wy.reshape(shape + (c,)),
        }
    w, wx, wxx = value_and_dir_derivs2(w_fn, X, vx)
    _, wy, wyy = value_and_dir_derivs2(w_fn, X, vy)
    c = w.shape[-1]
    return {
        "w": w.reshape(shape + (c,)),
        "wx": wx.reshape(shape + (c,)),
        "wy": wy.reshape(shape + (c,)),
        "wxx": wxx.reshape(shape + (c,)),
        "wyy": wyy.reshape(shape + (c,)),
    }


def vector_fields_3d(w_fn, x, y, z, *, second: bool = True):
    """Vector-valued network fields at 3D points — the engine for unsteady
    PDE SYSTEMS on the space-time tensor machinery (e.g. the Taylor-Green
    (u, v, p) triple with time as the slowest z axis).

    w_fn maps [P, 3] -> [P, C]; x, y, z have identical shape
    [..., Qz, Qy, Qx].  One nested-JVP chain per axis differentiates ALL C
    components simultaneously (the 3D twin of vector_fields_2d).

    Returns {'w', 'wx', 'wy', 'wz'} plus {'wxx', 'wyy'} when `second`
    (no 'wzz': the unsteady systems are first-order in time), each shaped
    [..., Qz, Qy, Qx, C].  (No reference analog — the reference's PDE
    families are all scalar.)
    """
    shape = x.shape
    X = jnp.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], axis=-1)
    vx = coord_tangent(X, 0)
    vy = coord_tangent(X, 1)
    vz = coord_tangent(X, 2)
    out = {}
    if second:
        w, wx, wxx = value_and_dir_derivs2(w_fn, X, vx)
        _, wy, wyy = value_and_dir_derivs2(w_fn, X, vy)
        c = w.shape[-1]
        out["wxx"] = wxx.reshape(shape + (c,))
        out["wyy"] = wyy.reshape(shape + (c,))
    else:
        w, wx = jax.jvp(w_fn, (X,), (vx,))
        _, wy = jax.jvp(w_fn, (X,), (vy,))
        c = w.shape[-1]
    _, wz = jax.jvp(w_fn, (X,), (vz,))
    out["w"] = w.reshape(shape + (c,))
    out["wx"] = wx.reshape(shape + (c,))
    out["wy"] = wy.reshape(shape + (c,))
    out["wz"] = wz.reshape(shape + (c,))
    return out


def scalar_fields_3d(u_fn, x, y, z, *, second: bool = True):
    """Network value and per-axis derivatives at 3D points [..., Qz, Qy, Qx].

    Returns {'u','ux','uy','uz'} plus {'uxx','uyy','uzz'} when `second`.
    """
    shape = x.shape
    X = jnp.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], axis=-1)
    out = {}
    for k, name1, name2 in ((0, "ux", "uxx"), (1, "uy", "uyy"), (2, "uz", "uzz")):
        v = coord_tangent(X, k)
        if second:
            u, d1, d2 = value_and_dir_derivs2(u_fn, X, v)
            out[name2] = d2.reshape(shape)
        else:
            u, d1 = jax.jvp(u_fn, (X,), (v,))
        out[name1] = d1.reshape(shape)
    out["u"] = u.reshape(shape)
    return out
