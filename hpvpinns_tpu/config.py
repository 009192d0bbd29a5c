"""Explicit configuration objects.

The reference has no config system: hyperparameters are module-level constants
silently read from inside the VPINN classes (var_form/lossb_weight/LR at
Poisson-1D.py:231-240 used at :82-102; scheme at Poisson-2D.py:279 used at
:126-129; V/LR at AdvDiff.py:35-52 used at :161-191).  Here every knob is an
explicit frozen dataclass; the three `*_of_record()` presets reproduce the
reference's configurations of record exactly.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class TrainConfig:
    """Optimization loop settings (reference: Adam, full batch, loss-threshold
    early stop polled every 10 iters; Poisson-1D.py:201-224)."""

    learning_rate: float = 1e-3
    iterations: int = 1001
    lbfgs_iterations: int = 0  # optional second-phase L-BFGS (full batch);
    # 0 disables.  The reference is Adam-only; L-BFGS is the standard
    # full-batch accelerator for variational/PINN losses (BASELINE.json).
    gn_iterations: int = 0  # optional third-phase Gauss-Newton/LM polish on
    # the stacked residual vector (training/gauss_newton.py); counts ACCEPTED
    # LM steps.  Measured to break the first-order u~2e-3 plateau: the loss
    # drops to the discretization floor in O(100) steps (MEASUREMENTS.md).
    gn_damping_init: float = 1e-3  # initial LM damping lambda
    gn_solve: Optional[str] = None  # LM step kernel: "normal" | "host" |
    # "qr" | "cg" | "lsqr"; None = auto (host-f64 solve for sub-f64 runs —
    # the measured f32 conditioning fix; "qr" is the pure-on-device
    # alternative; "cg"/"lsqr" are MATRIX-FREE kernels via jvp/vjp — no
    # [M, P] Jacobian, O(M+P) memory, element-sharded under a mesh; lsqr
    # is the cond(J)-stable one).
    gn_cg_tol: float = 1e-3  # matrix-free kernels: relative forcing tolerance
    gn_cg_maxiter: Optional[int] = None  # matrix-free iteration cap
    # (None = min(n_params, 2000) — the measured poisson3d-equalizing cap)
    gn_jac_chunk: Optional[int] = None  # dense kernels: vmapped passes per
    # Jacobian-build block.  None = gauss_newton's auto rule (whole-J vmap
    # when min(M, P) <= 2048) — which OOMs on LARGE MESHES where each pass
    # drags the full per-element assembly (helmholtz E=8: 1981 simultaneous
    # passes needed 22.5 GB of device memory); set ~256 there.
    threshold: Optional[float] = None  # early stop when loss < threshold
    check_every: int = 10  # host-side loss poll cadence (reference: 10)
    log_every: int = 100  # console print cadence (reference: 100)
    seed: int = 1234
    best_snapshot_fraction: Optional[float] = None  # AdvDiff keeps the best
    # params over the final 10% of iterations (AdvDiff.py:327-330): set 0.9.
    checkpoint_dir: Optional[str] = None
    checkpoint_every: Optional[int] = None
    checkpoint_keep_last: int = 3  # retained checkpoints (0 = keep all)
    checkpoint_async: bool = False  # background serialization: the training
    # loop is not blocked by checkpoint IO (orbax AsyncCheckpointer)


@dataclass(frozen=True)
class Poisson1DConfig:
    """1D Poisson -u'' = f on [-1, 1] (main/Poisson-1D)."""

    layers: Tuple[int, ...] = (1, 20, 20, 20, 20, 1)
    activation: str = "sin"  # Poisson-1D.py:134
    adaptive_slope: bool = False  # trainable per-layer activation slope (the
    # reference creates-but-never-uses this, Poisson-1D.py:117)
    matmul_precision: str = "highest"  # float32 matmul precision: "highest"
    # = full FP32; "high" and "default" let the GPU round operands to TF32
    # (PERF.md has the measured error of each)
    var_form: int = 1  # 1 | 2 | 3 (zero/one/two integrations by parts)
    n_elements: int = 1
    grid: Optional[Tuple[float, ...]] = None  # non-uniform override
    # (the reference's N_Element==3 special case [-1,-0.1,0.1,1],
    # Poisson-1D.py:270-273)
    n_test: int = 60
    n_test_per_elem: Optional[Tuple[int, ...]] = None  # p-nonuniformity
    n_quad: int = 80
    lossb_weight: float = 1.0  # Poisson-1D.py:240,100
    hard_bc: bool = False  # lifted ansatz u = g + (x-a)(b-x) N: BC exact
    domain: Tuple[float, float] = (-1.0, 1.0)
    dtype: str = "float32"
    deriv_mode: str = "taylor"  # "taylor" (fused one-pass propagation) | "jvp"
    train: TrainConfig = field(
        default_factory=lambda: TrainConfig(iterations=1001, threshold=2e-32)
    )


@dataclass(frozen=True)
class Poisson2DConfig:
    """2D Poisson Delta u = f on [-1, 1]^2 (main/Poisson-2D)."""

    layers: Tuple[int, ...] = (2, 5, 5, 5, 1)
    activation: str = "tanh"  # Poisson-2D.py:165
    adaptive_slope: bool = False  # trainable per-layer activation slope (the
    # reference creates-but-never-uses this, Poisson-1D.py:117)
    matmul_precision: str = "highest"  # float32 matmul precision: "highest"
    # = full FP32; "high" and "default" let the GPU round operands to TF32
    # (PERF.md has the measured error of each)
    scheme: str = "VPINNs"  # 'VPINNs' | 'PINNs' (Poisson-2D.py:126-129)
    var_form: object = 1  # 0 | 1 | 2 (reference-verbatim) | "2c" (corrected
    # exact twice-IBP form with 1/jac^2 scalings + boundary flux)
    n_elements_x: int = 4
    n_elements_y: int = 4
    grid_x: Optional[Tuple[float, ...]] = None  # non-uniform x boundaries
    # (adaptive refinement / front clustering; overrides n_elements_x)
    grid_y: Optional[Tuple[float, ...]] = None
    n_test_x: int = 5
    n_test_y: int = 5
    n_test_x_per_elem: Optional[Tuple[int, ...]] = None
    n_test_y_per_elem: Optional[Tuple[int, ...]] = None
    n_quad: int = 10  # per axis per element
    n_bound: int = 80  # boundary points per edge (Poisson-2D.py:313-347)
    n_residual: int = 100  # PINN-mode collocation points (Poisson-2D.py:350-356)
    lossb_weight: float = 10.0  # Poisson-2D.py:127
    hard_bc: bool = False  # lifted ansatz with the shipped default
    # lift/envelope (benchmark solution); custom lifts via build(lift_fn=...)
    domain_x: Tuple[float, float] = (-1.0, 1.0)
    domain_y: Tuple[float, float] = (-1.0, 1.0)
    dtype: str = "float32"
    deriv_mode: str = "taylor"  # "taylor" (fused one-pass propagation) | "jvp"
    train: TrainConfig = field(default_factory=lambda: TrainConfig(iterations=10001))


@dataclass(frozen=True)
class Poisson3DConfig:
    """3D Poisson Delta u = f on [-1, 1]^3 — no reference analog; the
    volumetric generalization of the tensor-product architecture."""

    layers: Tuple[int, ...] = (3, 20, 20, 20, 1)
    activation: str = "tanh"
    var_form: int = 1  # 0 | 1
    adaptive_slope: bool = False  # trainable per-layer activation slope (the
    # reference creates-but-never-uses this, Poisson-1D.py:117)
    matmul_precision: str = "highest"  # float32 matmul precision: "highest"
    # = full FP32; "high" and "default" let the GPU round operands to TF32
    # (PERF.md has the measured error of each)
    n_elements_x: int = 2
    n_elements_y: int = 2
    n_elements_z: int = 2
    n_test_x: int = 5
    n_test_y: int = 5
    n_test_z: int = 5
    n_test_x_per_elem: Optional[Tuple[int, ...]] = None  # p-nonuniformity
    n_test_y_per_elem: Optional[Tuple[int, ...]] = None
    n_test_z_per_elem: Optional[Tuple[int, ...]] = None
    n_quad: int = 8  # per axis per element
    n_bound: int = 100  # boundary points per face (6 faces)
    lossb_weight: float = 10.0
    hard_bc: bool = False  # lifted ansatz: all six Dirichlet faces exact
    domain_x: Tuple[float, float] = (-1.0, 1.0)
    domain_y: Tuple[float, float] = (-1.0, 1.0)
    domain_z: Tuple[float, float] = (-1.0, 1.0)
    dtype: str = "float32"
    deriv_mode: str = "taylor"
    train: TrainConfig = field(default_factory=lambda: TrainConfig(iterations=5001))


@dataclass(frozen=True)
class Helmholtz2DConfig:
    """2D Helmholtz  Delta u + k^2 u = f  on [-1, 1]^2 — the oscillatory,
    INDEFINITE extension of the Poisson family (no reference analog; the
    canonical hp stress case — resolving ~k/pi waves per axis is where
    spectral test spaces earn their keep).

    Benchmark solution (problems/helmholtz.py): the tilted plane wave
    u = sin(k (x cos th + y sin th) + phase), an EXACT homogeneous solution
    (f = 0) driven entirely through its boundary trace — so unlike the
    manufactured families there is no forcing to hide behind.  k defaults
    to 9.0 (k^2 = 81 sits between the Dirichlet-Laplacian eigenvalues
    (pi/2)^2 * 32 = 78.96 and * 34 = 83.89, keeping the continuous problem
    well-posed).  `inverse=True` makes k^2 a trainable pde leaf identified
    from interior sensors (the Helmholtz twin of AdvDiff.py:63's epsilon;
    its residual is LINEAR in k^2, so a closed-form network-free estimate
    ships alongside — problems/helmholtz.py::closed_form_k_sq)."""

    layers: Tuple[int, ...] = (2, 30, 30, 30, 1)
    activation: str = "tanh"  # "sin" is the matched prior for waves —
    # measured per-preset (MEASUREMENTS.md)
    adaptive_slope: bool = False
    matmul_precision: str = "highest"  # float32 matmul precision: "highest"
    # = full FP32; "high" and "default" let the GPU round operands to TF32
    var_form: int = 1  # 0 | 1 (Laplacian once integrated by parts; the mass
    # term k^2 ∫ u phi never needs derivatives)
    n_elements_x: int = 4
    n_elements_y: int = 4
    grid_x: Optional[Tuple[float, ...]] = None  # non-uniform x boundaries
    # (adaptive refinement; overrides n_elements_x)
    grid_y: Optional[Tuple[float, ...]] = None
    n_test_x: int = 10
    n_test_y: int = 10
    n_test_x_per_elem: Optional[Tuple[int, ...]] = None  # p-nonuniformity
    n_test_y_per_elem: Optional[Tuple[int, ...]] = None
    n_quad: int = 16  # per axis per element (>= ~k/E + p quad points resolve
    # the oscillation against the test basis)
    n_bound: int = 80  # boundary points per edge (Poisson-2D.py:313-347 layout)
    lossb_weight: float = 10.0
    k: float = 9.0  # true wavenumber (k^2 is the PDE coefficient)
    wave_angle_deg: float = 30.0  # plane-wave direction (off-axis so the
    # solution is genuinely 2D, not a tensor product)
    wave_phase: float = 0.3  # phase offset (breaks the odd symmetry)
    inverse: bool = False  # k^2 trainable from interior sensors; False
    # (default) is the forward benchmark
    k_sq_init: float = 60.0  # trainable start (true k^2 = 81)
    n_sensors: int = 60  # LHS interior sensor points when inverse
    sensor_noise_std: float = 0.0  # additive N(0, std) on sensor READINGS only
    hard_bc: bool = False  # lifted ansatz u = Coons(boundary trace) +
    # (1-xi^2)(1-eta^2) N: the Dirichlet trace exact by construction
    domain_x: Tuple[float, float] = (-1.0, 1.0)
    domain_y: Tuple[float, float] = (-1.0, 1.0)
    dtype: str = "float32"
    deriv_mode: str = "taylor"  # "taylor" (fused one-pass propagation) | "jvp"
    train: TrainConfig = field(default_factory=lambda: TrainConfig(iterations=10001))


@dataclass(frozen=True)
class AdvDiffConfig:
    """Space-time advection-diffusion u_t + V u_x - eps u_xx = 0 on
    [-1, 1] x [0, T], inverse identification of eps (main/AdvDiff-Identification).
    """

    layers: Tuple[int, ...] = (2, 5, 5, 5, 1)
    activation: str = "tanh"  # AdvDiff.py:226
    adaptive_slope: bool = False  # trainable per-layer activation slope (the
    # reference creates-but-never-uses this, Poisson-1D.py:117)
    matmul_precision: str = "highest"  # float32 matmul precision: "highest"
    # = full FP32; "high" and "default" let the GPU round operands to TF32
    # (PERF.md has the measured error of each)
    var_form: int = 0  # 0 | 1 (AdvDiff.py:38) | 2 (twice-IBP diffusion with
    # live boundary flux — the machinery AdvDiff.py:132-154 sketches; scalar eps)
    n_elements_x: int = 1
    n_elements_t: int = 1
    grid_x: Optional[Tuple[float, ...]] = None  # non-uniform x-element
    # boundaries (adaptive refinement; overrides n_elements_x)
    grid_t: Optional[Tuple[float, ...]] = None  # non-uniform t-element
    # boundaries (adaptive refinement; overrides n_elements_t)
    n_test_x: int = 5
    n_test_t: int = 5
    n_test_x_per_elem: Optional[Tuple[int, ...]] = None  # p-nonuniformity
    # per x-axis element (adaptive p-refinement; overrides n_test_x)
    n_test_t_per_elem: Optional[Tuple[int, ...]] = None
    n_quad: int = 10
    n_bound: int = 80  # per side/initial edge (AdvDiff.py:357-384)
    lossb_weight: float = 10.0  # folded into lossb in the reference (AdvDiff.py:184)
    velocity: float = 1.0  # V (AdvDiff.py:43)
    velocity_trainable: bool = False  # ALSO identify V jointly with eps
    # (beyond the reference — V then starts at velocity_init)
    velocity_init: float = 0.5
    velocity_model: str = "scalar"  # "scalar" | "linear" | "quadratic" —
    # shape of the trainable velocity when velocity_trainable:
    # V(x) = v0 [+ v1 x [+ v2 x^2]] (space-dependent advection identification;
    # beyond the reference.  Pair with build(u_fn=, f_fn=, velocity_fn=) /
    # make_manufactured for data whose true velocity actually varies.)
    gamma: float = 0.1  # true eps = gamma / pi (AdvDiff.py:41-42)
    epsilon_init: float = 1.0  # trainable start (AdvDiff.py:63)
    epsilon_model: str = "scalar"  # "scalar" (reference parity) | "quadratic"
    # (space-dependent eps(x) = c0 + c1 x + c2 x^2, identified jointly;
    # beyond the reference) | "mlp" (eps(x) = tiny neural field — identifies
    # coefficient profiles beyond polynomials; initialized flat at
    # epsilon_init)
    epsilon_mlp_layers: Tuple[int, ...] = (1, 8, 8, 1)  # the eps(x) neural
    # field architecture when epsilon_model="mlp" (tanh activations)
    epsilon_reg: float = 0.0  # Tikhonov smoothness penalty on FIELD eps
    # models: loss += epsilon_reg * mean_q eps'(x_q)^2.  Coefficient
    # inversion is ill-posed where the solution's u_xx vanishes (the field
    # is locally unobservable there); the measured stabilizing range for the
    # neural field is ~1e-4..1e-2 (MEASUREMENTS.md)
    inverse: bool = True  # eps trainable; False freezes it at the true value
    hard_bc: bool = False  # lifted space-time ansatz u = g + D(x,t) N: the
    # IC and BC hold exactly (data loss reduces to the interior sensors)
    layer_feature: bool = False  # append the steady outflow-layer profile
    # exp(V (x - x_out)/eps_true) as an extra NETWORK INPUT (the first layer
    # width grows by 1 automatically).  The exact solution has a boundary
    # layer of width eps/V at the outflow wall that a plain coordinate MLP
    # cannot resolve at trainable budgets — the measured max-abs limiter of
    # the family's forward accuracy (MEASUREMENTS.md "advdiff forward GN
    # ladder").  A FORWARD-problem tool: the feature is built from the TRUE
    # eps (inverse runs would leak the answer into the ansatz).
    layer_feature_scale: Optional[float] = None  # layer-width override for
    # the feature (defaults to eps_true/|V| at the outflow wall)
    n_sensors_per_station: int = 5  # interior data for identifiability
    sensor_stations: Tuple[float, ...] = (-0.5, 0.0, 0.5)  # AdvDiff.py:464-479
    sensor_noise_std: float = 0.0  # additive N(0, std) noise on the interior
    # sensor READINGS only (boundary/initial data stay exact) — robustness
    # studies for the inverse problem (beyond the reference)
    t_final: float = 1.0
    t_start: float = 0.0  # time-slab lower edge: the space-time domain is
    # [domain_x] x [t_start, t_final] with the IC placed at t = t_start
    # (exact series values by default, or a handed-off network state via
    # build(..., ic_fn=) — training/timemarch.py drives slab sequences)
    domain_x: Tuple[float, float] = (-1.0, 1.0)
    fourier_terms: int = 800  # exact-solution series truncation (AdvDiff.py:416)
    dtype: str = "float32"
    deriv_mode: str = "taylor"  # "taylor" (fused one-pass propagation) | "jvp"
    train: TrainConfig = field(
        default_factory=lambda: TrainConfig(
            iterations=1501, threshold=2e-11, best_snapshot_fraction=0.9
        )
    )


@dataclass(frozen=True)
class AdvDiff2DConfig:
    """2D space-time advection-diffusion

        u_t + vx u_x + vy u_y - eps (u_xx + u_yy) = f

    on [-1, 1]^2 x [0, T] — the 2-space-dimension generalization of the
    reference's inverse family (no reference analog), assembled on the 3D
    tensor machinery (time = slowest axis).  The problem is MANUFACTURED
    (problems/advdiff2d.py): u = sin(pi x) sin(pi y) e^{-t} with the matching
    forcing, so the coefficients are exactly verifiable; eps (and optionally
    the velocity vector) are identified from interior sensors."""

    layers: Tuple[int, ...] = (3, 16, 16, 16, 1)
    activation: str = "tanh"
    adaptive_slope: bool = False
    matmul_precision: str = "highest"  # float32 matmul precision: "highest"
    # = full FP32; "high" and "default" let the GPU round operands to TF32
    # (PERF.md has the measured error of each)
    var_form: int = 1  # 0 | 1 (both diffusion terms once integrated by parts)
    n_elements_x: int = 1
    n_elements_y: int = 1
    n_elements_t: int = 1
    grid_x: Optional[Tuple[float, ...]] = None  # non-uniform element
    # boundaries per axis (adaptive refinement; override n_elements_*)
    grid_y: Optional[Tuple[float, ...]] = None
    grid_t: Optional[Tuple[float, ...]] = None
    n_test_x: int = 5
    n_test_y: int = 5
    n_test_t: int = 5
    n_test_x_per_elem: Optional[Tuple[int, ...]] = None  # p-nonuniformity
    # per axis element (adaptive p-refinement; overrides n_test_*)
    n_test_y_per_elem: Optional[Tuple[int, ...]] = None
    n_test_t_per_elem: Optional[Tuple[int, ...]] = None
    n_quad: int = 8  # per axis per element
    n_bound: int = 80  # per face (4 side walls + the t = 0 face)
    lossb_weight: float = 10.0
    velocity: Tuple[float, float] = (1.0, 0.5)  # true (vx, vy)
    velocity_trainable: bool = False  # ALSO identify (vx, vy) jointly
    velocity_init: Tuple[float, float] = (0.5, 0.25)
    gamma: float = 0.1  # true eps = gamma / pi (matching the 1D family)
    epsilon_init: float = 1.0
    inverse: bool = True  # eps trainable; False freezes it at the true value
    sensor_stations: Tuple[Tuple[float, float], ...] = (
        (-0.5, -0.5), (-0.5, 0.5), (0.0, 0.0), (0.5, -0.5), (0.5, 0.5),
    )  # interior (x, y) stations for identifiability
    n_sensors_per_station: int = 5  # LHS times per station
    sensor_noise_std: float = 0.0
    t_final: float = 1.0
    domain_x: Tuple[float, float] = (-1.0, 1.0)
    domain_y: Tuple[float, float] = (-1.0, 1.0)
    dtype: str = "float32"
    deriv_mode: str = "taylor"
    train: TrainConfig = field(
        default_factory=lambda: TrainConfig(
            iterations=3000, check_every=100, best_snapshot_fraction=0.9
        )
    )


@dataclass(frozen=True)
class BurgersConfig:
    """Viscous Burgers u_t + u u_x = nu u_xx on [-1, 1] x [0, T],
    u(x, 0) = -sin(pi x), u(+-1, t) = 0 — the framework's nonlinear
    space-time family (no reference analog; canonical PINN benchmark,
    nu = 0.01/pi develops a steep interior front at x = 0)."""

    layers: Tuple[int, ...] = (2, 20, 20, 20, 20, 1)
    activation: str = "tanh"
    adaptive_slope: bool = False
    matmul_precision: str = "highest"  # float32 matmul precision: "highest"
    # = full FP32; "high" and "default" let the GPU round operands to TF32
    # (PERF.md has the measured error of each)
    var_form: int = 1  # 0 | 1 (conservation-form convection IBP)
    n_elements_x: int = 4
    n_elements_t: int = 2
    grid_x: Optional[Tuple[float, ...]] = None  # non-uniform x-element
    # boundaries (cluster elements at the x = 0 front; overrides n_elements_x)
    grid_t: Optional[Tuple[float, ...]] = None  # non-uniform t-element
    # boundaries (adaptive time-axis marking; overrides n_elements_t)
    n_test_x: int = 8
    n_test_t: int = 8
    n_test_x_per_elem: Optional[Tuple[int, ...]] = None  # p-nonuniformity
    # per x-axis element (adaptive p-refinement; overrides n_test_x)
    n_test_t_per_elem: Optional[Tuple[int, ...]] = None
    n_quad: int = 16
    n_bound: int = 80  # per side/initial edge (LHS, matching AdvDiff's layout)
    lossb_weight: float = 10.0
    nu: float = 0.01 / 3.141592653589793
    hard_bc: bool = False  # lifted ansatz: IC/BC exact by construction
    front_feature: bool = False  # append tanh(x/delta) as an extra NETWORK
    # INPUT (first layer width grows by 1 automatically).  The -sin(pi x) IC
    # is odd, so the viscous front forms AND STAYS at x = 0 with steady-shock
    # width ~2 nu/|u| — a known geometric prior (the same one the
    # hand-clustered quality grid encodes).  MEASURED NEGATIVE on the
    # precision preset (MEASUREMENTS.md "Physics-feature transfer"): the
    # INTERIOR front is constrained only by the weak residual, whose p=10
    # test modes cannot see the 6.4e-3 scale — loss falls 10x while the
    # error rises 10-35x.  Ships as a documented cautionary control; the
    # advdiff layer_feature works because its layer sits ON the boundary
    # where the data loss pins it.  Composes with hard_bc.
    front_feature_scale: Optional[float] = None  # width override for the
    # feature (defaults to 2 nu, the steady viscous-shock scale at |u| ~ 1)
    n_strong: int = 0  # strong-form collocation points: adds
    # strong_weight * mean((u_t + u u_x - nu u_xx)^2) over n_strong
    # LHS-sampled interior points to the loss (a hybrid weak+strong
    # objective).  Built as the constructive fix for the front_feature
    # negative (the weak objective's quasi-null front directions need a
    # POINTWISE pin) and MEASURED NEGATIVE on the precision preset too:
    # the strong residual at a 6.4e-3-wide front carries 1/delta^2-scale
    # u_xx values that f32 optimization cannot drive down, and the
    # gradient pressure redirects capacity from the bulk (MEASUREMENTS.md
    # "Physics-feature transfer").  Ships as a general hybrid-loss
    # capability + documented control.  0 = pure variational (default).
    strong_weight: float = 1.0  # weight of the strong-residual term
    strong_window: Optional[Tuple[float, float]] = None  # x-range to sample
    # the collocation points in (e.g. a front strip (-0.15, 0.15));
    # None = the whole spatial domain
    t_final: float = 1.0
    t_start: float = 0.0  # time-slab lower edge (IC at t = t_start: exact
    # Cole-Hopf values by default, or build(..., ic_fn=) for a handed-off
    # network state — training/timemarch.py drives slab sequences)
    domain_x: Tuple[float, float] = (-1.0, 1.0)
    dtype: str = "float32"
    deriv_mode: str = "taylor"
    train: TrainConfig = field(
        default_factory=lambda: TrainConfig(iterations=5000, check_every=100)
    )


@dataclass(frozen=True)
class KovasznayConfig:
    """Steady incompressible Navier-Stokes, Kovasznay flow (Re = 1/nu):

        (w . grad) w + grad p = nu Lap w,   div w = 0
        on [x_l, x_r] x [y_l, y_r],  w = (u, v)

    with the exact laminar wake solution (Kovasznay 1948)

        lam = Re/2 - sqrt(Re^2/4 + 4 pi^2)
        u = 1 - e^{lam x} cos(2 pi y),  v = (lam / 2 pi) e^{lam x} sin(2 pi y)
        p = (1 - e^{2 lam x}) / 2.

    The framework's first SYSTEM of coupled PDEs (3-output ansatz; no
    reference analog — ehsankharazmi/hp-VPINNs is scalar-PDE only).  The
    weak residual stacks x/y-momentum + continuity per element
    (ops/assembly.py::ns_residual)."""

    layers: Tuple[int, ...] = (2, 30, 30, 30, 3)  # (u, v, p) output triple
    activation: str = "tanh"
    adaptive_slope: bool = False
    matmul_precision: str = "highest"
    var_form: int = 1  # 0 | 1 (once-IBP diffusion + pressure gradient)
    re: float = 40.0  # Reynolds number; nu = 1/re
    n_elements_x: int = 2
    n_elements_y: int = 2
    grid_x: Optional[Tuple[float, ...]] = None  # non-uniform x-element bounds
    grid_y: Optional[Tuple[float, ...]] = None
    n_test_x: int = 8
    n_test_y: int = 8
    n_test_x_per_elem: Optional[Tuple[int, ...]] = None  # p-nonuniformity
    n_test_y_per_elem: Optional[Tuple[int, ...]] = None
    n_quad: int = 14
    n_bound: int = 60  # LHS boundary points per edge
    lossb_weight: float = 10.0
    hard_bc: bool = False  # lifted ansatz w = L + D * N with L = the Coons
    # transfinite interpolant of the exact VELOCITY boundary traces and
    # D = (bubble, bubble, 1): u and v satisfy the Dirichlet BC exactly for
    # any parameters, p stays soft-constrained on the boundary (the gauge),
    # and all network capacity goes to the PDE — the system twin of the
    # scalar families' hard-BC mode (requires bc_pressure=True)
    eq_weights: Optional[Tuple[float, float, float]] = None  # per-equation
    # residual weights (x-momentum, y-momentum, continuity).  The measured
    # relative-error limiter of every frontier point is the SMALLEST
    # component (v: equal absolute error at 10x smaller magnitude —
    # MEASUREMENTS.md Kovasznay ladder); weighting the y-momentum row up
    # rebalances the objective toward it.  Applied inside the weak residual
    # (loss AND GN residual vector see it consistently).
    bc_pressure: bool = True  # constrain p on the boundary from the exact
    # solution alongside (u, v).  True keeps the boundary mismatch a plain
    # 3-component least-squares block, so the Gauss-Newton residual-vector
    # identity sum(r^2) == loss holds with no extra machinery (the gauge is
    # fixed by the boundary data).  False = velocity-only Dirichlet BC plus
    # a single-point pressure anchor (the classical gauge fix; registered
    # as extras['reg_resvec_fn'] so GN still applies).
    p_anchor_weight: float = 10.0  # weight of the pressure-anchor term
    # (bc_pressure=False only)
    inverse: bool = False  # trainable viscosity: nu = params["pde"]["nu"],
    # identified from interior velocity sensors (the NS twin of the
    # reference's trainable-epsilon inverse problem, AdvDiff.py:63,165,173)
    nu_init: float = 0.1  # inverse-mode initial viscosity
    n_sensors: int = 64  # interior (u, v) sensors (inverse mode; LHS-sampled)
    sensor_noise: float = 0.0  # additive N(0, noise^2) on sensor readings
    domain_x: Tuple[float, float] = (-0.5, 1.0)
    domain_y: Tuple[float, float] = (-0.5, 1.5)
    dtype: str = "float32"
    deriv_mode: str = "jvp"  # vector ansatz: the shape-generic JVP engine
    train: TrainConfig = field(
        default_factory=lambda: TrainConfig(iterations=5000, check_every=100)
    )


@dataclass(frozen=True)
class TaylorGreenConfig:
    """UNSTEADY incompressible Navier-Stokes, Taylor-Green vortex
    (nu = 1/Re):

        w_t + (w . grad) w + grad p = nu Lap w,   div w = 0
        on [x_l, x_r] x [y_l, y_r] x [0, T],  w = (u, v)

    with the exact decaying-vortex solution

        u = -cos(x) sin(y) e^{-2 nu t}
        v =  sin(x) cos(y) e^{-2 nu t}
        p = -(cos(2x) + cos(2y))/4 e^{-4 nu t}.

    The framework's second PDE SYSTEM and its first TIME-DEPENDENT one:
    a 3-input (x, y, t) / 3-output (u, v, p) ansatz against the stacked
    momentum+continuity weak residual on the space-time tensor machinery
    (ops/assembly.py::ns_unsteady_residual; time = the slowest axis, like
    advdiff2d).  No reference analog."""

    layers: Tuple[int, ...] = (3, 30, 30, 30, 3)
    activation: str = "tanh"
    adaptive_slope: bool = False
    matmul_precision: str = "highest"
    var_form: int = 1  # 0 | 1 (once-IBP diffusion + pressure, in space)
    hard_bc: bool = False  # lifted ansatz: velocity exact on the 5 data
    # faces (side walls at all t + the t=0 face) by construction via the
    # space-time transfinite interpolant
    # (problems/taylorgreen.py::coons_lift_spacetime_jnp); requires
    # bc_pressure=True (wall p data fixes the gauge, as KovasznayConfig)
    re: float = 10.0  # Reynolds number; nu = 1/re
    n_elements_x: int = 2
    n_elements_y: int = 2
    n_elements_t: int = 2
    grid_x: Optional[Tuple[float, ...]] = None
    grid_y: Optional[Tuple[float, ...]] = None
    grid_t: Optional[Tuple[float, ...]] = None
    n_test_x: int = 6
    n_test_y: int = 6
    n_test_t: int = 6
    n_test_x_per_elem: Optional[Tuple[int, ...]] = None  # p-nonuniformity
    n_test_y_per_elem: Optional[Tuple[int, ...]] = None
    n_test_t_per_elem: Optional[Tuple[int, ...]] = None
    n_quad: int = 10
    n_bound: int = 60  # LHS points per face (4 side walls + the t=0 face)
    lossb_weight: float = 10.0
    eq_weights: Optional[Tuple[float, float, float]] = None  # per-equation
    # residual weights (x-momentum, y-momentum, continuity) — same contract
    # as KovasznayConfig.eq_weights
    bc_pressure: bool = True  # prescribe p on the side walls alongside
    # (u, v) (keeps the GN residual identity a plain least-squares block);
    # False = velocity-only walls + a pressure anchor CURVE (p at one
    # spatial point across n_anchor times — unsteady gauge freedom is a
    # free function of t, so a single point cannot fix it)
    p_anchor_weight: float = 10.0
    n_anchor: int = 16  # anchor times (bc_pressure=False only)
    p_zero_mean_weight: float = 0.0  # >0 adds the per-TIME-SLICE zero-mean
    # gauge penalty: the quadrature mean of p over the spatial domain is
    # pinned to the exact slice mean (identically 0 on the standard
    # [0, pi]^2 Taylor-Green box) at n_zero_mean_t times — the classical
    # gauge convention attacking the family's measured pressure limiter
    # (unsteady gauge = a free function of t; MEASUREMENTS.md)
    n_zero_mean_t: int = 16  # time slices of the zero-mean penalty
    p_test_enrich: int = 0  # extra tensor test modes for the MOMENTUM rows
    # only (the equations that see grad p): continuity keeps the base
    # orders via an equation-selective mask.  NOTE the masked extra
    # continuity rows still count in the per-element n_test normalizer, so
    # >0 also down-weights continuity by (base/enriched)^3 — intentional
    # part of the treatment, documented in MEASUREMENTS.md.
    inverse: bool = False  # trainable viscosity nu = params["pde"]["nu"]
    nu_init: float = 0.3  # inverse-mode initial viscosity
    n_sensors: int = 96  # interior space-time (u, v) sensors (inverse mode)
    sensor_noise: float = 0.0
    domain_x: Tuple[float, float] = (0.0, float(np.pi))
    domain_y: Tuple[float, float] = (0.0, float(np.pi))
    t_final: float = 1.0
    t_start: float = 0.0  # time-slab lower edge: the space-time box is
    # [domain] x [t_start, t_final] with the IC face at t = t_start (exact
    # vortex values by default, or a handed-off network state via
    # build(..., ic_fn=) — training/timemarch.py drives slab sequences)
    dtype: str = "float32"
    deriv_mode: str = "jvp"  # vector ansatz: the shape-generic JVP engine
    train: TrainConfig = field(
        default_factory=lambda: TrainConfig(iterations=5000, check_every=100)
    )


def kovasznay_quality() -> KovasznayConfig:
    """Measured quality point for the Navier-Stokes system (round-3,
    benchmarks/MEASUREMENTS.md): default 2x2 mesh / 8x8 test / 30-wide
    triple-output net at Adam-10k + L-BFGS-10k.  Measured in f32: stacked
    (u, v, p) rel-L2 **7.1e-3** (u 6.5e-3, v 3.0e-2, p 8.7e-3)."""
    return KovasznayConfig(
        train=TrainConfig(iterations=10000, lbfgs_iterations=10000, check_every=1000),
    )


def kovasznay_precision() -> KovasznayConfig:
    """GN-grade frontier for the Navier-Stokes SYSTEM, in f32 (round-3
    measurement, benchmarks/MEASUREMENTS.md): hard-BC lifted ansatz
    (velocity exact by construction via the Coons trace interpolant),
    3x3 mesh, 50-wide net, Adam-10k + L-BFGS-10k + LM on the on-device QR
    kernel.  Measured in f32: stacked (u, v, p) rel-L2
    **5.6e-5** (u 5.1e-5, v 2.3e-4, p 7.2e-5) — 4.2x below the
    soft-BC GN point (2.38e-4; set hard_bc=False for it), 126x
    below the quality preset.  The GN phase is worth 6-15x over the
    Adam+LBFGS plateau on its own; width 64 + 10x10 test measured NO
    gain (capacity is not the limiter)."""
    return KovasznayConfig(
        layers=(2, 50, 50, 50, 3),
        n_elements_x=3,
        n_elements_y=3,
        hard_bc=True,
        train=TrainConfig(
            iterations=10000,
            lbfgs_iterations=10000,
            gn_iterations=250,
            gn_solve="qr",
            check_every=1000,
        ),
    )


def taylorgreen_quality() -> TaylorGreenConfig:
    """Measured quality point for the UNSTEADY Navier-Stokes system
    (round-3, benchmarks/MEASUREMENTS.md): default 2x2x2 space-time mesh /
    6^3 test / 30-wide triple-output net at Adam-10k + L-BFGS-10k.
    Measured in f32: stacked (u, v, p) rel-L2 **6.6e-3** (u 3.2e-3,
    v 4.3e-3, p 1.8e-2)."""
    return TaylorGreenConfig(
        train=TrainConfig(iterations=10000, lbfgs_iterations=10000, check_every=1000),
    )


def taylorgreen_precision() -> TaylorGreenConfig:
    """GN-grade frontier for the UNSTEADY Navier-Stokes system, in f32
    (round-3 measurement, benchmarks/MEASUREMENTS.md "Taylor-Green VPINN"):
    space-time hard-BC lift (velocity exact on the 4 side walls and
    the t=0 face via the transfinite interpolant), 3x3x2 space-time mesh,
    6^3 test, 50-wide net, var_form 0, Adam-10k + L-BFGS-10k + LM on the
    on-device QR kernel, PLUS the zero-mean-per-time-slice pressure-gauge
    penalty at weight 10 (round-4 ablation, MEASUREMENTS.md "gauge
    treatments": zm10 beats zm1 beats none — p 1.04e-3 -> 6.8e-4 -> 5.7e-4;
    momentum-row test enrichment measured WORSE, 1.14e-3).  Measured in
    f32: stacked (u, v, p) rel-L2 **2.09e-4**
    (u 1.06e-4, v 1.25e-4, p 5.72e-4) — 32x below the quality preset; the
    GN phase alone is worth 11x on this family.  Pressure is the component
    limiter (the unsteady gauge is a free function of t pinned only by
    wall data); the two measured attacks compose: testing grad p DIRECTLY
    (var_form 0, no spatial IBP — beats once-IBP form 1 at both 6^3 and
    8^3 test budgets) and pinning the gauge's one soft mode (the slice
    mean) to its exact value."""
    return TaylorGreenConfig(
        layers=(3, 50, 50, 50, 3),
        n_elements_x=3,
        n_elements_y=3,
        var_form=0,
        hard_bc=True,
        p_zero_mean_weight=10.0,
        train=TrainConfig(
            iterations=10000,
            lbfgs_iterations=10000,
            gn_iterations=250,
            gn_solve="qr",
            check_every=1000,
        ),
    )


def burgers_quality() -> BurgersConfig:
    """Measured quality point (benchmarks/MEASUREMENTS.md): hard-BC lifted
    ansatz + front-clustered 5-element x-grid (the nu = 0.01/pi front lives
    at x = 0) + L-BFGS — rel-L2 8.6e-3 in f32, 16x better than the
    uniform-grid config at the same budget."""
    return BurgersConfig(
        grid_x=(-1.0, -0.3, -0.08, 0.08, 0.3, 1.0),
        n_test_x=10,
        n_quad=20,
        hard_bc=True,
        train=TrainConfig(iterations=10000, lbfgs_iterations=20000, check_every=1000),
    )


def poisson1d_of_record() -> Poisson1DConfig:
    """Poisson-1D.py:231-240."""
    return Poisson1DConfig()


def poisson2d_of_record() -> Poisson2DConfig:
    """Poisson-2D.py:279-288,434."""
    return Poisson2DConfig()


def advdiff_of_record() -> AdvDiffConfig:
    """AdvDiff.py:35-53."""
    return AdvDiffConfig()


def poisson1d_quality() -> Poisson1DConfig:
    """Measured winner of the round-2 variant study (MEASUREMENTS.md): the
    reference's own non-uniform 3-element hp grid (Poisson-1D.py:270-273),
    p=30, a (1,30,30,30,1) sin net and an L-BFGS phase — rel-L2 4.9-6.1e-3
    across 3 seeds in f32, 40x below the single-element config
    of record's 0.25 plateau (which is representation-limited on the
    tanh(80x) layer)."""
    return Poisson1DConfig(
        grid=(-1.0, -0.1, 0.1, 1.0),
        n_elements=3,
        n_test=30,
        layers=(1, 30, 30, 30, 1),
        train=TrainConfig(iterations=5000, lbfgs_iterations=5000, check_every=200),
    )


def poisson2d_quality(hard_bc: bool = False) -> Poisson2DConfig:
    """Measured time-to-accuracy Pareto winner (benchmarks/MEASUREMENTS.md):
    (2,48x4,1) tanh net, 10x10 test fns, 16-pt quadrature, Adam10k+LBFGS5k —
    rel-L2 8.7e-4 in f32.  hard_bc=True lifts the ansatz (boundary exact by
    construction) and extends the L-BFGS budget: measured 3.1e-4."""
    return Poisson2DConfig(
        layers=(2, 48, 48, 48, 48, 1),
        n_test_x=10,
        n_test_y=10,
        n_quad=16,
        hard_bc=hard_bc,
        train=TrainConfig(
            iterations=10000,
            lbfgs_iterations=20000 if hard_bc else 5000,
            check_every=1000,
        ),
    )


def advdiff_quality() -> AdvDiffConfig:
    """Measured optimizer-study winner for coefficient identification
    (benchmarks/MEASUREMENTS.md): float64 Adam5k + L-BFGS10k — epsilon to
    2.4% of truth (0.03259 vs 0.03183).  The f32 path plateaus around 10%
    from single-precision loss conditioning."""
    return AdvDiffConfig(
        dtype="float64",
        train=TrainConfig(
            iterations=5000,
            lbfgs_iterations=10000,
            check_every=500,
            best_snapshot_fraction=0.9,
        ),
    )


def poisson1d_precision() -> Poisson1DConfig:
    """GN-grade precision preset (round-3 Gauss-Newton study,
    benchmarks/MEASUREMENTS.md): the quality hp grid with the test space
    raised to p=50 and a 200-accepted-step Levenberg-Marquardt polish after
    Adam-1000 (training/gauss_newton.py) — measured rel-L2 1.09e-4 in f64,
    45x below the f32 quality point (4.9e-3).  Richer test spaces were
    pointless before GN because first-order methods could not minimize them;
    this preset pairs the two.  f32 GN stalls on Jacobian conditioning
    (MEASUREMENTS.md) — use `--preset quality` for an f32 run.
    Reference trainer being superseded: Poisson-1D.py:201-224."""
    return replace(
        poisson1d_quality(),
        dtype="float64",
        n_test=50,
        train=TrainConfig(iterations=1000, gn_iterations=200, check_every=200),
    )


def advdiff_precision() -> AdvDiffConfig:
    """GN-grade identification preset (round-3 study, MEASUREMENTS.md): the
    reference's own inverse configuration (AdvDiff.py:35-53) with a
    150-accepted-step LM phase after Adam-1500 — identifies epsilon to 0.15%
    of truth in f64, 16x better than advdiff_quality (2.4% at
    Adam5k+LBFGS10k) in a fraction of the budget.  The reference's sole
    validation was a plot of the recovered epsilon (AdvDiff.py:544-545)."""
    return AdvDiffConfig(
        dtype="float64",
        train=TrainConfig(iterations=1500, gn_iterations=150, check_every=300),
    )


def advdiff_forward_precision() -> AdvDiffConfig:
    """GN-grade FORWARD frontier for the space-time family (round-3 late
    measurement, MEASUREMENTS.md "advdiff (1D) forward GN ladder"): the
    outflow-layer input feature (layer_feature) composed with the
    front-clustered x-grid and a 150-step QR-LM phase.  The feature breaks
    the family's measured max-abs wall (0.037 -> 0.015) and the two levers
    compose: rel-L2 **1.76e-3 in f32** (f64 CPU control 1.49e-3) vs 5.61e-3 for the pre-feature clustered record.  Selected by
    `run advdiff --preset precision --forward`; the plain precision preset
    remains the eps-identification point (layer_feature is forward-only by
    construction)."""
    return AdvDiffConfig(
        inverse=False,
        layer_feature=True,
        layers=(2, 32, 32, 32, 1),
        grid_x=(-1.0, 0.5, 0.9, 1.0),
        n_test_x=10,
        n_test_t=10,
        n_quad=16,
        train=TrainConfig(
            iterations=1500, gn_iterations=150, gn_solve="qr", check_every=300
        ),
    )


def poisson2d_precision(hard_bc: bool = True) -> Poisson2DConfig:
    """GN-grade 2D accuracy frontier in f32 (round-3 late measurement,
    benchmarks/MEASUREMENTS.md): the quality configuration plus a
    50-accepted-step LM phase whose damped normal equations solve on the
    host in f64 (auto-enabled for f32 — training/gauss_newton.py).  Measured
    in f32: rel-L2 7.3e-5 hard-BC (4.2x below the round-2 hard-BC record
    3.1e-4), 2.9e-4 soft-BC.  The round-2 'GN is f64-CPU-only' caveat is obsolete: the f32
    stall was the SOLVE precision, not the Jacobian's."""
    base = poisson2d_quality(hard_bc=hard_bc)
    return replace(base, train=replace(base.train, gn_iterations=50))


def helmholtz2d_quality() -> Helmholtz2DConfig:
    """Measured quality point for the oscillatory family (re-tuned round 5,
    benchmarks/MEASUREMENTS.md "Helmholtz k-ladder"): sin-activation net
    (the matched prior for waves), 4x4 mesh, 10x10 test functions, the
    hard-BC Coons trace lift, Adam-5k + L-BFGS-5k + a 10-step QR LM tail.
    Measured in f32: rel-L2 **1.23e-3** (max err 2.34e-3) at k = 9 — the
    cheaper point of the same lifted ansatz the precision preset deepens
    (3.41e-4), restoring a monotone quality->precision ladder.  The round-4
    soft-BC point (4.21e-4) cost more than the precision preset — it remains in MEASUREMENTS.md as the soft-BC reference
    row; pass hard_bc=False + the old budgets to reproduce it."""
    return Helmholtz2DConfig(
        activation="sin",
        hard_bc=True,
        train=TrainConfig(iterations=5000, lbfgs_iterations=5000,
                          gn_iterations=10, gn_solve="qr", check_every=1000),
    )


def helmholtz2d_precision() -> Helmholtz2DConfig:
    """GN-grade frontier for the Helmholtz family in f32 (round-4,
    benchmarks/MEASUREMENTS.md "Helmholtz"): the quality configuration
    plus a hard-BC Coons-lifted ansatz (the Dirichlet trace — the ONLY
    data this f = 0 problem has — exact by construction) and an LM phase
    on the on-device QR kernel.  Measured in f32: rel-L2
    **3.41e-4**, max err 6.94e-4 (the lift's decisive win: 5.7x below
    soft-BC on the boundary-dominated max error), loss 33x below quality
    — the residual gap is representation-limited, not optimizer-limited."""
    base = helmholtz2d_quality()
    return replace(
        base,
        hard_bc=True,
        # NOT derived from quality's budgets: the round-5 quality re-tune
        # halved the warm phases (see helmholtz2d_quality), while this
        # recipe's measured 3.41e-4 is at the full Adam-10k + L-BFGS-10k
        # warm + GN-50 (round-4 row, reproduced bit-equal round 5).
        train=replace(base.train, iterations=10000, lbfgs_iterations=10000,
                      gn_iterations=50, gn_solve="qr"),
    )


def burgers_precision() -> BurgersConfig:
    """GN-grade nonlinear space-time frontier in f32 (round-3 late
    measurement, benchmarks/MEASUREMENTS.md): the hand-clustered hard-BC
    quality grid plus a 40-accepted-step LM phase.  Measured in f32:
    rel-L2 **1.50e-3** with the shipped on-device QR kernel (the host-f64
    solve gave 1.58e-3, MEASUREMENTS.md "LM step kernels") —
    5.7x below the quality preset (8.6e-3) and 3.9x below the adaptive
    h-loop record (5.9e-3).  Gauss-Newton handles the nonlinear
    (convective) residual exactly like the linear families: r(theta) is
    what it is; LM only needs its Jacobian."""
    base = burgers_quality()
    return replace(base, train=replace(base.train, gn_iterations=40, gn_solve="qr"))


def poisson3d_quality(hard_bc: bool = False) -> Poisson3DConfig:
    """Measured 3D quality point (benchmarks/MEASUREMENTS.md): (3,48,48,48,1)
    net, 6^3 test fns, 10^3 quadrature points, 8 elements, Adam10k+LBFGS10k —
    rel-L2 1.34e-2 in f32; hard_bc=True lifts the ansatz
    (all six faces exact) — measured 8.6e-3."""
    return Poisson3DConfig(
        layers=(3, 48, 48, 48, 1),
        n_test_x=6,
        n_test_y=6,
        n_test_z=6,
        n_quad=10,
        hard_bc=hard_bc,
        train=TrainConfig(iterations=10000, lbfgs_iterations=10000, check_every=1000),
    )


def poisson3d_precision(hard_bc: bool = True) -> Poisson3DConfig:
    """GN-grade volumetric frontier in f32 (round-3 measurement, round-4
    matrix-free update — benchmarks/MEASUREMENTS.md): quality with the test
    space raised to 8^3 plus a 30-accepted-step LM phase on the MATRIX-FREE
    CG kernel.  Measured in f32, same warm start: rel-L2 **1.037e-3** (cg,
    tol 1e-4) vs 1.056e-3 for the dense QR kernel and 1.057e-3 for the
    round-3 host-f64 row — equal accuracy.  The dense build has to chunk
    the Jacobian on a memory-limited device (jac_chunk); the CG
    kernel never materializes J at all (O(M+P) memory, element-shardable).
    At the quality p=6 the same GN phase gives only 6.59e-3: the 6^3 weak
    objective's own minimizer is ~6e-3-class, so p is the lever GN unlocks
    (the measured 1D p=30 -> p=50 mechanism, confirmed volumetric)."""
    base = poisson3d_quality(hard_bc=hard_bc)
    return replace(
        base,
        n_test_x=8, n_test_y=8, n_test_z=8,
        # Matrix-free CG at tol 1e-4 / cap 2000 reproduces the dense-kernel
        # record (1.0367e-3 vs qr 1.0564e-3, SAME warm start) without
        # forming J — MEASUREMENTS.md "matrix-free LM" — so the 3D preset
        # ships it.  The old
        # min(P, 500) iteration cap was the earlier stall (1.64e-3).
        # p=10 measured NEGATIVE (1.22e-3): p=8 is the volumetric optimum,
        # like 2D/burgers at their shipped orders.
        train=replace(base.train, gn_iterations=30, gn_solve="cg",
                      gn_cg_tol=1e-4, gn_cg_maxiter=2000),
    )


def advdiff2d_precision() -> AdvDiff2DConfig:
    """GN-grade FORWARD frontier for the 2-space-dimension space-time family,
    in f32 (round-3 late measurement, benchmarks/MEASUREMENTS.md): eps
    frozen at truth, a 32-wide net, the test space raised to 8^3 with 10^3
    quadrature, Adam-5000 + a 120-accepted-step LM phase on the on-device QR
    kernel.  Measured in f32: rel-L2 **1.86e-3** — 67x below the Adam-only forward point (0.124) and
    11x below Adam+GN at the default capacity/test space (2.0e-2).  Width
    is NOT the limiter (48-wide at GN-60 measured 3.5e-3; 32-wide GN-120
    beats it) and the budget is converged (GN-200 reproduces
    GN-120 to 4 digits).  The preset is FORWARD-only because joint eps
    identification under GN measured NEGATIVE (0.13% -> 0.93% despite 30x
    lower loss — MEASUREMENTS.md); use `--preset record` for the inverse
    workflow."""
    return AdvDiff2DConfig(
        layers=(3, 32, 32, 32, 1),
        n_test_x=8,
        n_test_y=8,
        n_test_t=8,
        n_quad=10,
        inverse=False,
        train=TrainConfig(
            iterations=5000,
            gn_iterations=120,
            gn_solve="qr",
            check_every=500,
            best_snapshot_fraction=0.9,
        ),
    )


def poisson2d_scaled(n_elem_axis: int = 8, n_quad: int = 16, n_test: int = 10) -> Poisson2DConfig:
    """The scaled multi-device benchmark config (BASELINE.json config 5):
    n_elem_axis^2 elements, higher quadrature/test order."""
    return Poisson2DConfig(
        n_elements_x=n_elem_axis,
        n_elements_y=n_elem_axis,
        n_test_x=n_test,
        n_test_y=n_test,
        n_quad=n_quad,
        layers=(2, 20, 20, 20, 1),
        train=TrainConfig(iterations=2001),
    )


__all__ = [
    "TrainConfig",
    "Poisson1DConfig",
    "Poisson2DConfig",
    "Poisson3DConfig",
    "Helmholtz2DConfig",
    "helmholtz2d_quality",
    "helmholtz2d_precision",
    "AdvDiffConfig",
    "AdvDiff2DConfig",
    "BurgersConfig",
    "burgers_quality",
    "poisson1d_of_record",
    "poisson2d_of_record",
    "advdiff_of_record",
    "poisson1d_quality",
    "poisson2d_quality",
    "advdiff_quality",
    "poisson1d_precision",
    "poisson2d_precision",
    "advdiff_precision",
    "advdiff_forward_precision",
    "burgers_precision",
    "poisson3d_precision",
    "advdiff2d_precision",
    "poisson3d_quality",
    "poisson2d_scaled",
    "replace",
]
