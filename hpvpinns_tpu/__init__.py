"""hp-VPINNs in JAX — an accelerator framework for variational
physics-informed neural networks with hp-domain-decomposition.

Re-designed from scratch (not a port) with the capabilities of the reference
implementation `ehsankharazmi/hp-VPINNs` (TF1/CPU, see /root/reference):
Petrov–Galerkin weak-form residuals of a dense-MLP PDE ansatz, tested against
Jacobi-polynomial test functions on each element of a domain decomposition and
integrated with Gauss–Lobatto–Jacobi quadrature.

Design decisions (vs. the reference's per-element Python graph loop):
  * quadrature nodes/weights and test-function basis tensors are precomputed
    offline in float64 and contracted on device — only the network forward and
    its derivatives are live compute (mirrors the reference's offline/online
    split, Poisson-1D.py:73-74,276-294);
  * all elements are batched into a leading array axis; the element loop
    (Poisson-1D.py:64-96) becomes fused sum-factorized einsum contractions
    (ops/contract.py);
  * network derivatives use forward-mode JVP applied to whole point batches —
    matmul-shaped, no per-point autodiff graphs (replaces nested tf.gradients,
    Poisson-1D.py:144-148);
  * the element axis is the sharding axis: GSPMD/`shard_map` over a
    `jax.sharding.Mesh` with a single `psum` for loss/grad reduction
    (parallel/sharding.py).
"""

from hpvpinns_tpu import config, evaluate, problems
from hpvpinns_tpu.config import (
    AdvDiff2DConfig,
    AdvDiffConfig,
    BurgersConfig,
    Helmholtz2DConfig,
    helmholtz2d_precision,
    helmholtz2d_quality,
    KovasznayConfig,
    TaylorGreenConfig,
    burgers_precision,
    burgers_quality,
    kovasznay_precision,
    kovasznay_quality,
    Poisson1DConfig,
    Poisson2DConfig,
    Poisson3DConfig,
    TrainConfig,
    advdiff2d_precision,
    advdiff_of_record,
    advdiff_precision,
    advdiff_forward_precision,
    advdiff_quality,
    poisson1d_of_record,
    poisson1d_precision,
    poisson1d_quality,
    poisson2d_of_record,
    poisson2d_precision,
    poisson2d_quality,
    poisson2d_scaled,
    poisson3d_precision,
    poisson3d_quality,
    taylorgreen_precision,
    taylorgreen_quality,
)
from hpvpinns_tpu.evaluate import evaluate as evaluate_problem
from hpvpinns_tpu.evaluate import predict, rel_l2
from hpvpinns_tpu.problems import build
from hpvpinns_tpu.serving import (
    ServedModel,
    export_model,
    load_model,
    save_model,
)
from hpvpinns_tpu.training import (
    EnsembleResult,
    GNResult,
    TimeMarchResult,
    TrainResult,
    gauss_newton,
    time_march,
    train,
    train_ensemble,
)

__version__ = "0.1.0"
