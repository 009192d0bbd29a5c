"""Problem bundle: everything the generic trainer needs.

The reference couples problem definition, graph construction, and training
into one VPINN class per script (Poisson-1D.py:30-224 etc.).  Here a problem
module's `build(config)` returns a `Problem`: static spec + device-ready data
pytree + pure loss/apply functions.  The trainer (training/trainer.py) and the
sharding layer (parallel/sharding.py) are generic over this interface.

Parameter pytree convention:
    params = {"net": [{W, b}, ...], "pde": {...}}
`pde` holds trainable PDE coefficients (the inverse problem's epsilon,
AdvDiff.py:63); it is empty for forward problems.  Both leaves train under the
same optimizer, exactly as the reference's single Adam over all tf.Variables.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import jax.numpy as jnp
import numpy as np

from hpvpinns_tpu.models.mlp import MLP, init_mlp, mlp_apply


DERIV_MODES = ("taylor", "jvp")


def check_deriv_mode(mode: str) -> str:
    """The derivative-field engine a config names: "taylor" (one-pass
    propagation, ops/taylor.py) or "jvp" (nested JVPs, ops/fields.py)."""
    if mode not in DERIV_MODES:
        raise ValueError(f"unknown deriv_mode {mode!r}; expected one of {DERIV_MODES}")
    return mode


@dataclass
class Problem:
    name: str
    config: Any
    spec: MLP
    data: Any  # pytree passed to loss_fn; data["elements"] carries the
    # element-sharded arrays (leading axis = element)
    loss_fn: Callable  # (params, data) -> (loss, aux_dict)
    init_params: Callable  # (jax.random.key) -> params
    exact: Optional[Callable] = None  # vectorized exact solution
    test_points: Optional[np.ndarray] = None  # dense eval grid [P, d]
    test_values: Optional[np.ndarray] = None  # exact u at test_points [P, 1]
    extras: Dict[str, Any] = field(default_factory=dict)
    apply_override: Optional[Callable] = None  # (params, X) -> u, for
    # composite ansatzes (e.g. hard-BC lifting u = g + D * N)

    def apply(self, params, X):
        """Solution ansatz at points X: [P, d_in] -> [P, 1]."""
        if self.apply_override is not None:
            return self.apply_override(params, X)
        return mlp_apply(self.spec, params["net"], X)


def make_composite_apply(
    spec: MLP, lift: Callable, envelope: Callable, feature_fn: Optional[Callable] = None
):
    """Hard-BC ansatz factory: u(params, X) = lift(X) + envelope(X) * N(X).

    The envelope vanishes on the boundary and the lift interpolates the
    Dirichlet data there, so the BC holds exactly for any parameters.
    An optional `feature_fn(X) -> [P, m]` augments the network INPUT
    (N([X, feature(X)])) — see make_feature_apply."""

    def u_of(params):
        def apply(X):
            Xf = X if feature_fn is None else jnp.concatenate([X, feature_fn(X)], axis=-1)
            return lift(X) + envelope(X) * mlp_apply(spec, params["net"], Xf)

        return apply

    return u_of


def make_feature_apply(spec: MLP, feature_fn: Callable):
    """Input-feature ansatz factory: u(params, X) = N([X, feature(X)]).

    `feature_fn` maps [P, d] points to [P, m] extra input columns (jnp
    traceable, so every derivative engine that nests JVPs through the whole
    ansatz — ops/fields.py — differentiates it exactly).  The spec's first
    layer width must be d + m.  Used for physics-aware inputs a plain
    coordinate MLP represents poorly at trainable budgets, e.g. the
    exp(V (x - b)/eps) outflow boundary-layer profile of the advection-
    diffusion family (AdvDiffConfig.layer_feature; the measured limiter of
    that family's forward accuracy, benchmarks/MEASUREMENTS.md)."""

    def u_of(params):
        def apply(X):
            Xf = jnp.concatenate([X, feature_fn(X)], axis=-1)
            return mlp_apply(spec, params["net"], Xf)

        return apply

    return u_of


def make_net_init(spec: MLP, pde_init: Optional[Callable] = None, dtype=None):
    """Standard init_params factory: Xavier net + optional PDE coefficients."""

    def init(key):
        params = {"net": init_mlp(spec, key, dtype=dtype), "pde": {}}
        if pde_init is not None:
            params["pde"] = pde_init()
        return params

    return init
