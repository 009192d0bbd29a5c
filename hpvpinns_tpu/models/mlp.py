"""Dense MLP ansatz network as a plain pytree.

Reproduces the reference network family (Poisson-1D.py:110-142): Xavier
truncated-normal init with std = sqrt(2/(fan_in+fan_out)), zero biases,
`sin` (1D Poisson) or `tanh` (2D Poisson / AdvDiff) hidden activation, and a
linear output layer.  The reference creates a per-layer adaptive-activation
slope `a=0.01` but never uses it (Poisson-1D.py:117,134); here the idea is
implemented properly as an OPT-IN trainable per-layer slope s_l applied as
activation(s_l * z) (Jagtap-et-al-style adaptive activation), enabled with
`MLP(adaptive_slope=True)` — the slope leaves train under the same optimizer
like every other parameter.  Default off, matching the reference's effective
behavior.

Layout notes: parameters are a flat list of (W, b) so the forward pass is a
chain of batched matmuls; `mlp_apply` is written for [P, d_in] point batches so
forward-mode JVPs through it (ops/derivatives.py) stay matmul-shaped.  Matmul
precision is configurable because the variational residual needs more
precision than reduced-precision (TF32/bf16) tensor-core matmuls give.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

_ACTIVATIONS = {
    "sin": jnp.sin,
    "tanh": jnp.tanh,
    "gelu": jax.nn.gelu,
    "swish": jax.nn.swish,
}


@dataclass(frozen=True)
class MLP:
    """Static network spec (hashable; safe as a jit static arg)."""

    layers: tuple
    activation: str = "tanh"
    precision: str = "highest"  # float32 matmul precision (lax.Precision)
    adaptive_slope: bool = False  # trainable per-layer activation slope s_l

    def __post_init__(self):
        object.__setattr__(self, "layers", tuple(int(w) for w in self.layers))
        if self.activation not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {self.activation!r}")

    @property
    def n_layers(self) -> int:
        return len(self.layers) - 1


def init_mlp(spec: MLP, key: jax.Array, dtype=jnp.float32):
    """Xavier truncated-normal weights (std=sqrt(2/(in+out)), truncated at
    ±2 std, matching tf.truncated_normal, Poisson-1D.py:122-126), zero biases.
    """
    params = []
    keys = jax.random.split(key, spec.n_layers)
    for l in range(spec.n_layers):
        fan_in, fan_out = spec.layers[l], spec.layers[l + 1]
        std = jnp.sqrt(jnp.asarray(2.0 / (fan_in + fan_out), dtype=dtype))
        W = (
            jax.random.truncated_normal(
                keys[l], -2.0, 2.0, (fan_in, fan_out), dtype=dtype
            )
            * std
        )
        b = jnp.zeros((fan_out,), dtype=dtype)
        layer = {"W": W, "b": b}
        if spec.adaptive_slope and l < spec.n_layers - 1:
            layer["s"] = jnp.asarray(1.0, dtype=dtype)  # activation(s * z)
        params.append(layer)
    return params


def mlp_apply(spec: MLP, params, X):
    """Forward pass on a batch of points X: [P, d_in] -> [P, d_out]."""
    act = _ACTIVATIONS[spec.activation]
    prec = jax.lax.Precision(spec.precision)
    H = X
    for layer in params[:-1]:
        z = jnp.dot(H, layer["W"], precision=prec) + layer["b"]
        if "s" in layer:
            z = layer["s"] * z
        H = act(z)
    last = params[-1]
    return jnp.dot(H, last["W"], precision=prec) + last["b"]
