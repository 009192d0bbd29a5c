"""Quadrature-weighted basis contractions — the variational hot path.

The reference builds, per element e and test index n, graph nodes
`tf.reduce_sum(w_q * D(u)(x_q) * phi_n(xi_q))` inside a Python double loop
(Poisson-1D.py:83-91, Poisson-2D.py:93-115) — O(E*N) scalar reductions.
Here the same mathematics is two dense contractions:

  1D:  U[e, n]    = sum_q        Wphi[n, q] * g[e, q]
  2D:  U[e, k, r] = sum_{qy, qx} Wphi_y[k, qy] * Wphi_x[r, qx] * g[e, qy, qx]

with the quadrature weights folded into the basis matrices offline
(Wphi[n, q] = w_q * phi_n(xi_q)).  The 2D case is *sum-factorized*: contract
the fast (x) axis first, then the slow (y) axis — two batched matmuls instead
of materializing the [Q^2, N_x*N_y] outer-product table the reference loops
over.  Both shapes lower straight onto batched matmuls via XLA dot_general.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# The variational residual is numerically delicate (losses reach <1e-10 in the
# reference's early-stop thresholds): always request full-float32 matmuls
# (no reduced-precision tensor-core passes) for these contractions.
_PREC = jax.lax.Precision.HIGHEST


def contract_1d(wphi: jax.Array, g: jax.Array) -> jax.Array:
    """U[..., n] = sum_q wphi[n, q] * g[..., q].

    wphi: [N, Q] weighted basis (weights folded in).
    g:    [..., Q] integrand samples (leading axes = element/batch axes).
    Returns [..., N].
    """
    return jnp.einsum("nq,...q->...n", wphi, g, precision=_PREC)


def contract_2d(wphi_x: jax.Array, wphi_y: jax.Array, g: jax.Array) -> jax.Array:
    """Sum-factorized tensor-product contraction.

    wphi_x: [R, Qx] weighted basis on the fast (x) axis.
    wphi_y: [K, Qy] weighted basis on the slow (y) axis.
    g:      [..., Qy, Qx] integrand samples.
    Returns U[..., K, R] = sum_{qy,qx} wphi_y[K,qy] wphi_x[R,qx] g[..., qy, qx],
    matching the reference's flattened-meshgrid double sum
    (Poisson-2D.py:94-96 with q = qy*Qx + qx from np.meshgrid row-major
    flattening, Poisson-2D.py:362-364).
    """
    t = jnp.einsum("rx,...yx->...yr", wphi_x, g, precision=_PREC)
    return jnp.einsum("ky,...yr->...kr", wphi_y, t, precision=_PREC)


def contract_3d(
    wphi_x: jax.Array, wphi_y: jax.Array, wphi_z: jax.Array, g: jax.Array
) -> jax.Array:
    """Sum-factorized 3D tensor-product contraction (no reference analog —
    the architecture's generalization of contract_2d to volumetric elements).

    wphi_x: [R, Qx] (fast axis), wphi_y: [K, Qy], wphi_z: [M, Qz] (slow axis).
    g: [..., Qz, Qy, Qx].
    Returns U[..., M, K, R]; three batched matmuls instead of the O(Q^3 N^3)
    dense table a naive tensor-product loop would materialize.
    """
    t = jnp.einsum("rx,...zyx->...zyr", wphi_x, g, precision=_PREC)
    t = jnp.einsum("ky,...zyr->...zkr", wphi_y, t, precision=_PREC)
    return jnp.einsum("mz,...zkr->...mkr", wphi_z, t, precision=_PREC)
