"""Fused Taylor-mode derivative propagation through the MLP.

The generic path (ops/fields.py) computes u, u_x, u_xx by *nesting JVPs
around the whole network*: each nesting level re-traverses the layer chain,
so the 2D forms cost ~8 forward passes.  Because the ansatz is a plain dense
MLP, the derivatives can instead be propagated *alongside* the forward pass
in closed form — one traversal, all fields:

  per layer l with z = h W + b (W constant w.r.t. x):
    z_k    = h_k W                    (first derivative, direction k)
    z_kk   = h_kk W                   (diagonal second derivative)
    a      = act(z)
    a_k    = act'(z) z_k
    a_kk   = act''(z) z_k^2 + act'(z) z_kk

All five fields (u, u_x, u_xx, u_y, u_yy) share one activation evaluation and
one traversal; every operation is a batched matmul or an elementwise op, and
XLA fuses the elementwise chains between the matmuls.  Ordinary reverse-mode
AD differentiates straight through this, so training losses built on it get
gradients for free.

Equivalent to (and tested against) the nested-JVP path; both replace the
reference's nested tf.gradients (Poisson-1D.py:144-155, Poisson-2D.py:175-194).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from hpvpinns_tpu.models.mlp import MLP

# act -> (f, f', f'') as elementwise closures of the activation value/input.
# Expressed in terms that reuse already-computed quantities where possible.


def act_derivs(name: str, z):
    """(act, act1, act2) first/second-derivative table — the single source of
    truth for all derivative engines (taylor and the Pallas kernels)."""
    if name == "sin":
        s, c = jnp.sin(z), jnp.cos(z)
        return s, c, -s
    if name == "tanh":
        t = jnp.tanh(z)
        d1 = 1.0 - t * t
        return t, d1, -2.0 * t * d1
    if name == "gelu":
        a = jax.nn.gelu(z)
        d1 = jax.grad(lambda q: jax.nn.gelu(q).sum())(z)
        d2 = jax.grad(lambda q: jax.grad(lambda r: jax.nn.gelu(r).sum())(q).sum())(z)
        return a, d1, d2
    if name == "swish":
        s = jax.nn.sigmoid(z)
        a = z * s
        d1 = s * (1.0 + z * (1.0 - s))
        d2 = s * (1.0 - s) * (2.0 + z * (1.0 - 2.0 * s))
        return a, d1, d2
    raise ValueError(f"no closed-form derivatives for activation {name!r}")


def act_derivs3(name: str, z):
    """(act, act1, act2, act3) including the third derivative — needed by the
    backward of second-derivative propagation (sin/tanh only)."""
    if name == "sin":
        s, c = jnp.sin(z), jnp.cos(z)
        return s, c, -s, -c
    if name == "tanh":
        t = jnp.tanh(z)
        d1 = 1.0 - t * t
        return t, d1, -2.0 * t * d1, -2.0 * d1 * (1.0 - 3.0 * t * t)
    raise ValueError(f"no third-derivative table for activation {name!r}")


def mlp_fields(spec: MLP, params, X, directions, second: bool = True):
    """Network value + per-direction first (and optionally second)
    derivatives, fused.

    X: [P, d] points.  directions: tuple of input-coordinate indices, e.g.
    (0,) for u_x/u_xx only, (0, 1) for both axes.
    Returns (u [P, out], firsts, seconds) where firsts/seconds are tuples of
    [P, out] arrays ordered like `directions`; seconds is () when
    second=False — the once-integrated weak forms (var_form 1) need no
    second derivatives, and skipping the hkk streams removes 2 of the 5
    propagation matmul chains.

    Layout note: the 1 + 2*len(directions) streams propagate as SEPARATE
    per-stream matmuls rather than one stacked [S*P, H] matmul per layer,
    which avoids materializing the stack (and its transpose in the
    backward); XLA fuses the elementwise chains between the small matmuls.
    """
    prec = jax.lax.Precision(spec.precision)
    dot = lambda A, W: jnp.dot(A, W, precision=prec)

    h = X
    # Seed tangents: dX/dx_k = e_k broadcast over the batch.
    hk = [
        jnp.zeros_like(X).at[..., k].set(1.0) for k in directions
    ]
    hkk = [jnp.zeros_like(X) for _ in directions] if second else []

    for layer in params[:-1]:
        W, b = layer["W"], layer["b"]
        z = dot(h, W) + b
        zk = [dot(t, W) for t in hk]
        zkk = [dot(t, W) for t in hkk]
        if "s" in layer:  # adaptive slope: act(s z) => chain rule gains s, s^2
            slope = layer["s"]
            a, d1, d2 = act_derivs(spec.activation, slope * z)
            d2 = d2 * slope * slope
            d1 = d1 * slope
        else:
            a, d1, d2 = act_derivs(spec.activation, z)
        h = a
        hkk = [d2 * t * t + d1 * s for t, s in zip(zk, zkk)]
        hk = [d1 * t for t in zk]

    W, b = params[-1]["W"], params[-1]["b"]
    u = dot(h, W) + b
    firsts = tuple(dot(t, W) for t in hk)
    seconds = tuple(dot(t, W) for t in hkk)
    return u, firsts, seconds


def taylor_fields_1d(spec: MLP, params, x):
    """(u, u_x, u_xx) at x [..., Q] — fused-propagation twin of
    ops.fields.scalar_fields_1d."""
    shape = x.shape
    X = x.reshape(-1, 1)
    u, (ux,), (uxx,) = mlp_fields(spec, params, X, (0,))
    return u.reshape(shape), ux.reshape(shape), uxx.reshape(shape)


def taylor_fields_2d(
    spec: MLP, params, x, y, *,
    second_y: bool = True, first_y_only: bool = False, firsts_only: bool = False,
):
    """Fused-propagation twin of ops.fields.scalar_fields_2d (same contract).

    firsts_only=True returns {u, ux, uy} with the second-derivative streams
    never propagated — the right mode for once-integrated weak forms
    (var_form 1), which need no second derivatives."""
    shape = x.shape
    X = jnp.stack([x.reshape(-1), y.reshape(-1)], axis=-1)
    if firsts_only:
        u, (ux, uy), _ = mlp_fields(spec, params, X, (0, 1), second=False)
        return {"u": u.reshape(shape), "ux": ux.reshape(shape), "uy": uy.reshape(shape)}
    if first_y_only or second_y:
        u, (ux, uy), (uxx, uyy) = mlp_fields(spec, params, X, (0, 1))
        out = {"u": u.reshape(shape), "ux": ux.reshape(shape), "uxx": uxx.reshape(shape)}
        out["uy"] = uy.reshape(shape)
        if not first_y_only:
            out["uyy"] = uyy.reshape(shape)
        return out
    u, (ux,), (uxx,) = mlp_fields(spec, params, X, (0,))
    return {"u": u.reshape(shape), "ux": ux.reshape(shape), "uxx": uxx.reshape(shape)}


def taylor_fields_3d(spec: MLP, params, x, y, z, *, second: bool = True):
    """Fused-propagation twin of ops.fields.scalar_fields_3d."""
    shape = x.shape
    X = jnp.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], axis=-1)
    u, firsts, seconds = mlp_fields(spec, params, X, (0, 1, 2))
    out = {"u": u.reshape(shape)}
    for name, arr in zip(("ux", "uy", "uz"), firsts):
        out[name] = arr.reshape(shape)
    if second:
        for name, arr in zip(("uxx", "uyy", "uzz"), seconds):
            out[name] = arr.reshape(shape)
    return out
