"""PDE differential operators via forward-mode autodiff on point batches.

Replaces the reference's nested reverse-mode `tf.gradients` chains
(Poisson-1D.py:144-155, Poisson-2D.py:175-194, AdvDiff.py:236-253) with
nested JVPs applied to the *whole batched* forward function:

  * the MLP acts row-wise on X [P, d], so the directional derivative with a
    broadcast coordinate tangent e_k recovers the per-point partial du/dx_k;
  * one nested JVP yields (u, d_v u, d_vv u) in a single traced computation
    that is a chain of batched matmuls, with no per-point
    autodiff graphs and no materialized Hessians.

Forward-over-forward is the right AD mode here: inputs are 1-2 dimensional
per point and we need diagonal second derivatives only.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def dir_deriv(f, X, v):
    """First directional derivative: d/dt f(X + t v) at t=0."""
    return jax.jvp(f, (X,), (v,))[1]


def value_and_dir_derivs2(f, X, v):
    """(f(X), d_v f, d_vv f) via one nested JVP.

    f maps [P, d] -> [P, out]; v is a tangent of X's shape (typically a
    broadcast coordinate direction).  Cost ~4 forward passes, all batched.
    """

    def f_and_first(x):
        return jax.jvp(f, (x,), (v,))

    (u, du), (_, d2u) = jax.jvp(f_and_first, (X,), (v,))
    return u, du, d2u


def coord_tangent(X, axis: int):
    """Unit tangent along input coordinate `axis`, broadcast over the batch."""
    v = jnp.zeros_like(X)
    return v.at[..., axis].set(1.0)
