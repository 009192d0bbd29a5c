"""Gauss-Newton / Levenberg-Marquardt optimizer on the VPINN residual vector.

The hp-VPINN objective is a textbook nonlinear least-squares problem: with the
masked weak residuals Res[e, n] (Poisson-1D.py:94-96) and the boundary/data
mismatch (Poisson-1D.py:98-100), the training loss

    loss = sum_e mean_n Res[e, n]^2 + w_b * mean_b (u_b - u(x_b))^2

is exactly ||r(theta)||^2 for the stacked residual vector

    r = [ Res[e, n] / sqrt(n_test_e) ,  sqrt(w_b / N_b) * (u(x_b) - u_b) ].

The networks are tiny (P <~ 10^4 parameters) and the residual count M is a few
thousand, so the full Jacobian J = dr/dtheta [M, P] is cheap to form by
batched reverse-mode AD, and the damped normal equations solve on one device
(or the f64 CPU) quickly.  First-order optimizers (the reference's Adam,
Poisson-1D.py:102-107; this framework's Adam + L-BFGS trainer) were measured
to plateau at u ~ 2e-3 rel-L2 independent of budget (benchmarks/
MEASUREMENTS.md) — the curvature of the squared-residual bowl is exactly what
Gauss-Newton models and what gradient methods crawl through.

Algorithm: Levenberg-Marquardt with lambda*I damping and Nielsen's
gain-ratio trust-region control.  Per accepted iterate: one jitted
residual+Jacobian evaluation; per candidate step: one P x P (or, when the
system is underdetermined, M x M dual) Cholesky solve and one jitted loss
evaluation.  Rejected steps reuse (r, J) and only re-solve with a larger
damping, so stalls are cheap.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.flatten_util import ravel_pytree


def make_residual_vector(problem) -> Callable:
    """(params, data) -> flat residual vector r with sum(r^2) == loss.

    Requires the problem to expose `extras["residual_fn"]` (masked weak
    residual with leading element axis) — all six shipped families do.
    Problems may register `extras["reg_resvec_fn"]` for extra quadratic
    regularization terms (e.g. the advdiff epsilon-field Tikhonov penalty);
    without it, configs whose loss contains such terms are rejected rather
    than silently optimizing a different objective.
    """
    residual_fn = problem.extras.get("residual_fn")
    if residual_fn is None:
        raise ValueError(
            f"problem {problem.name!r} exposes no extras['residual_fn']; "
            "Gauss-Newton needs the weak-residual vector"
        )
    if getattr(problem.config, "scheme", "VPINNs") != "VPINNs":
        raise ValueError("Gauss-Newton supports the variational scheme only")
    reg_fn = problem.extras.get("reg_resvec_fn")
    wb = getattr(problem.config, "lossb_weight", 1.0)

    def resvec(params, data):
        el = data["elements"]
        res = residual_fn(params, data)  # masked, [E, ...]
        n_elem = res.shape[0]
        rv = (res.reshape(n_elem, -1) / jnp.sqrt(el.n_test)[:, None]).reshape(-1)
        ub_pred = problem.apply(params, data["xb"])
        if ub_pred.ndim == 2 and ub_pred.shape[-1] != data["ub"].shape[-1]:
            # Partial-state Dirichlet data for PDE systems (e.g. Navier-
            # Stokes velocity-only BC): the convention is that `ub` holds
            # the LEADING ansatz components (problems/kovasznay.py).
            ub_pred = ub_pred[:, : data["ub"].shape[-1]]
        n_b = data["ub"].size
        rb = jnp.sqrt(wb / n_b) * (ub_pred - data["ub"]).reshape(-1)
        parts = [rv, rb]
        if reg_fn is not None:
            parts.append(reg_fn(params, data).reshape(-1))
        return jnp.concatenate(parts)

    return resvec


@dataclass
class GNResult:
    params: Any
    history: Dict[str, np.ndarray]
    iterations_run: int
    accepted: int
    wall_time_s: float
    stopped: str  # "iterations" | "gtol" | "ftol" | "damping"
    final_aux: Dict[str, float] = field(default_factory=dict)


def _build_kernels(resvec, unravel, data, n_params: int, n_res: int,
                   jac_chunk: Optional[int] = None,
                   cg_maxiter: Optional[int] = None, cg_tol: float = 1e-3,
                   cg_precond: int = 0):
    """Jitted LM computational kernels over the FLAT parameter vector.

    `jac_chunk` bounds the Jacobian build's peak memory: the min(M, P)
    vmapped tangent/cotangent passes run as `lax.map` over blocks of that
    many rows/columns, so only one block of intermediates is live at a time
    (a whole-Jacobian vmap of poisson3d quality requested 17.4 GB of
    device memory).  None = whole-Jacobian vmap (fastest) when
    min(M, P) <= 2048, else blocks of 256.

    Every jitted kernel takes ``data`` as an explicit ARGUMENT rather than
    closing over it: a closed-over jax.Array constant is forbidden inside
    jit when it spans non-addressable devices, i.e. whenever the element
    mesh crosses a process boundary (the 2-process DCN-analog leg in
    parallel/multihost_check.py).  ``data`` is still taken at build time
    only to shape the chunked-Jacobian basis."""

    def r_of(theta, data):
        return resvec(unravel(theta), data)

    # Forward-mode when the parameter count is the smaller dimension,
    # reverse-mode otherwise: both produce J[M, P]; the vmapped pass count is
    # min(M, P).
    fwd = n_params <= n_res
    n_pass = n_params if fwd else n_res
    if jac_chunk is None:
        jac_chunk = n_pass if n_pass <= 2048 else 256

    if jac_chunk >= n_pass:
        def jac(theta, data):
            f = jax.jacfwd if fwd else jax.jacrev
            return f(lambda th: r_of(th, data))(theta)
    else:
        # pad the pass count to a multiple of the chunk so lax.map sees a
        # rectangular [n_blocks, chunk, n_pass] basis; padded rows are zero
        # seeds (cheap) and are sliced off the result.
        n_pad = -n_pass % jac_chunk
        eye = jnp.eye(n_pass, dtype=jnp.result_type(float))
        basis = jnp.concatenate(
            [eye, jnp.zeros((n_pad, n_pass), dtype=eye.dtype)]
        ).reshape(-1, jac_chunk, n_pass)

        if fwd:
            def jac(theta, data):
                f = lambda th: r_of(th, data)  # noqa: E731
                def block(seeds):  # [C, P] tangents -> [C, M] rows of J^T
                    return jax.vmap(
                        lambda v: jax.jvp(f, (theta,), (v,))[1]
                    )(seeds)
                cols = jax.lax.map(block, basis).reshape(-1, n_res)[:n_pass]
                return cols.T  # [M, P]
        else:
            def jac(theta, data):
                _, vjp = jax.vjp(lambda th: r_of(th, data), theta)
                def block(seeds):  # [C, M] cotangents -> [C, P] rows of J
                    return jax.vmap(lambda v: vjp(v)[0])(seeds)
                return jax.lax.map(block, basis).reshape(-1, n_params)[:n_pass]

    @jax.jit
    def r_and_J(theta, data):
        return r_of(theta, data), jac(theta, data)

    @jax.jit
    def loss_of(theta, data):
        r = r_of(theta, data)
        return jnp.sum(r * r)

    dual = n_res < n_params  # underdetermined: min-norm GN step via JJ^T

    @jax.jit
    def lm_step(r, J, lam):
        """delta = -argmin ||r + J d||^2 + lam ||d||^2 and the predicted
        squared-residual decrease of the undamped model."""
        if dual:
            A = J @ J.T + lam * jnp.eye(J.shape[0], dtype=J.dtype)
            c = jax.scipy.linalg.cho_factor(A)
            delta = -J.T @ jax.scipy.linalg.cho_solve(c, r)
        else:
            g = J.T @ r
            A = J.T @ J + lam * jnp.eye(J.shape[1], dtype=J.dtype)
            c = jax.scipy.linalg.cho_factor(A)
            delta = -jax.scipy.linalg.cho_solve(c, g)
        pred = r + J @ delta
        pred_decrease = jnp.sum(r * r) - jnp.sum(pred * pred)
        grad_inf = jnp.max(jnp.abs(J.T @ r))
        return delta, pred_decrease, grad_inf

    @jax.jit
    def lm_step_qr(r, J, lam):
        """Pure-on-device damped step via QR of the AUGMENTED system
        [J; sqrt(lam) I] — the textbook alternative to lm_step_host for
        f32 runs.  The augmented least-squares solve is backward-stable
        at cond(J) rather than the normal equations' cond(J)^2, so the f32
        LM loop keeps accepting steps without the per-candidate host pull of
        the [M, P] Jacobian (~120 MB/step for the poisson2d precision
        config).  The sqrt(lam)*I block makes the stacked
        matrix full column rank for any M vs P, so no primal/dual branch is
        needed: the solution equals the damped (min-norm when M < P) step.
        """
        p = J.shape[1]
        A = jnp.concatenate([J, jnp.sqrt(lam) * jnp.eye(p, dtype=J.dtype)])
        b = jnp.concatenate([r, jnp.zeros((p,), dtype=r.dtype)])
        q, R = jnp.linalg.qr(A)
        delta = -jax.scipy.linalg.solve_triangular(R, q.T @ b, lower=False)
        pred = r + J @ delta
        pred_decrease = jnp.sum(r * r) - jnp.sum(pred * pred)
        grad_inf = jnp.max(jnp.abs(J.T @ r))
        return delta, pred_decrease, grad_inf

    def lm_step_host(r, J, lam):
        """Host float64 variant of lm_step: the normal equations square the
        Jacobian's condition number, which in f32 stalls LM early
        (MEASUREMENTS.md f32 caveat).  Pulling (r, J) to the host and
        solving in f64 removes the solve-precision half of that stall; the
        f32 Jacobian's own accuracy remains the floor.

        A failed Cholesky (roundoff can leave JJ^T + lam*I numerically
        indefinite for ill-conditioned f32 Jacobians, and a non-finite J
        poisons it outright) returns delta=None — the LM loop treats that
        exactly like a rejected step and inflates lam, the standard LM
        remedy, instead of crashing."""
        import scipy.linalg as sla

        r64 = np.asarray(r, dtype=np.float64)
        J64 = np.asarray(J, dtype=np.float64)
        try:
            if dual:
                A = J64 @ J64.T + lam * np.eye(J64.shape[0])
                delta = -J64.T @ sla.cho_solve(sla.cho_factor(A), r64)
            else:
                g = J64.T @ r64
                A = J64.T @ J64 + lam * np.eye(J64.shape[1])
                delta = -sla.cho_solve(sla.cho_factor(A), g)
        except (np.linalg.LinAlgError, ValueError):
            # LinAlgError: numerically indefinite A; ValueError: scipy's
            # finite check on a NaN/Inf Jacobian.  Both mean "don't trust
            # this step".
            return None, 0.0, float("inf")
        pred = r64 + J64 @ delta
        pred_decrease = float(r64 @ r64 - pred @ pred)
        grad_inf = float(np.max(np.abs(J64.T @ r64)))
        return jnp.asarray(delta, dtype=r.dtype), pred_decrease, grad_inf

    # Default iteration cap: n_params (the exact-arithmetic Krylov bound),
    # capped at 2000.  Measured on poisson3d precision (f32, P ~ 5k):
    # the old min(P, 500) cap truncated the solve to rel-L2 1.64e-3 where
    # maxiter 2000 reaches 1.04e-3 — EQUAL to the dense qr kernel
    # (MEASUREMENTS.md).
    max_cg = cg_maxiter if cg_maxiter is not None else min(n_params, 2000)

    @jax.jit
    def lm_step_cg(theta, lam, data):
        """MATRIX-FREE damped step: CG on (J^T J + lam I) delta = -J^T r with
        J applied only through jvp/vjp products — the [M, P] Jacobian is
        never materialized.  This is the kernel that scales: peak memory is
        O(M + P) instead of O(M*P) (the dense build of poisson3d quality
        needs 17.4 GB unchunked), and under a GSPMD element mesh every matvec is
        an ordinary jitted residual pass whose element axis stays sharded —
        the only collective is the psum XLA inserts for the vjp reduction,
        so the LM precision phase runs multi-device without ever gathering J.

        CG inexactness is safe by construction: the gain ratio compares the
        ACTUAL model decrease of the returned delta (one extra jvp), so a
        truncated solve just looks like a smaller trust-region step — rho
        stays honest and the Nielsen lambda control self-corrects (larger
        lam => better-conditioned system => CG converges faster).

        Stopping: ||A delta + g|| <= eta * ||g|| or cg_maxiter, with the
        Eisenstat-Walker-style forcing eta = min(cg_tol, ||g||): far from
        the optimum a loose solve is enough (the trust region truncates the
        step anyway), while near it the tolerance tightens with the gradient
        so the inexact steps keep the fast local convergence instead of
        plateauing at the fixed-rtol floor.  The default cg_tol=1e-3 is
        measured: on a poisson1d f64 polish, 1e-2 stalls at loss 3e-5 while
        1e-3 matches the dense normal-equations solve (3.4e-12 after 20
        accepted steps) at mean 9 CG iterations/step.

        `cg_precond` > 0 turns on a Jacobi preconditioner with the diagonal
        of J^T J ESTIMATED matrix-free by Hutchinson probing: for Rademacher
        z, E[(J^T z) ∘ (J^T z)] = diag(J^T J) exactly, so cg_precond vjp
        passes per accepted iterate buy a column-scale equilibration —
        the standard cure when CG's iteration count is dominated by
        badly-scaled parameter blocks (biases vs weights).
        """
        f = lambda th: r_of(th, data)  # noqa: E731
        r, jvp_lin = jax.linearize(f, theta)
        _, vjp = jax.vjp(f, theta)
        g = vjp(r)[0]  # J^T r

        def matvec(v):
            return vjp(jvp_lin(v))[0] + lam * v

        if cg_precond > 0:
            key = jax.random.key(17)
            zs = jax.random.rademacher(
                key, (cg_precond, n_res), dtype=r.dtype)
            diag_est = jax.lax.map(
                lambda z: vjp(z)[0] ** 2, zs).mean(axis=0)
            minv = 1.0 / (diag_est + lam)
        else:
            minv = None

        def precond(v):
            return v if minv is None else minv * v

        b = -g
        rs0 = jnp.vdot(b, b)
        eta = jnp.minimum(cg_tol, jnp.sqrt(rs0))
        tol2 = (eta * eta) * rs0

        def cond(state):
            _, _, _, _, rs, k = state
            return (k < max_cg) & (rs > tol2)

        def body(state):
            x, rk, p, rz, rs, k = state
            Ap = matvec(p)
            alpha = rz / jnp.vdot(p, Ap)
            x = x + alpha * p
            rk = rk - alpha * Ap
            zk = precond(rk)
            rz_new = jnp.vdot(rk, zk)
            beta = rz_new / rz
            return (x, rk, zk + beta * p, rz_new, jnp.vdot(rk, rk), k + 1)

        x0 = jnp.zeros_like(g)
        z0 = precond(b)
        delta, _, _, _, _, k = jax.lax.while_loop(
            cond, body, (x0, b, z0, jnp.vdot(b, z0), rs0, 0))
        pred = r + jvp_lin(delta)
        pred_decrease = jnp.sum(r * r) - jnp.sum(pred * pred)
        grad_inf = jnp.max(jnp.abs(g))
        return delta, pred_decrease, grad_inf, k

    @jax.jit
    def lm_step_lsqr(theta, lam, data):
        """MATRIX-FREE damped step via LSQR (Paige & Saunders 1982, the
        damped variant): Golub-Kahan bidiagonalization of J itself applied
        through jvp/vjp products, solving min ||J d + r||^2 + lam ||d||^2
        WITHOUT ever forming J^T J.  This is the f32 twin of the dense
        "qr" kernel: backward-stable at cond(J) where CG-on-the-normal-
        operator squares it (the measured f32 damping-stall mechanism,
        MEASUREMENTS.md), at the identical per-iteration cost (one jvp +
        one vjp) and the same O(M + P), element-sharded memory profile.

        Stopping mirrors the CG kernel's Eisenstat-Walker forcing: the LSQR
        running estimate of ||A_aug^T r_aug|| (= phibar * alpha * |c|)
        against eta * ||J^T r||, eta = min(cg_tol, ||J^T r||).
        """
        f = lambda th: r_of(th, data)  # noqa: E731
        r, jvp_lin = jax.linearize(f, theta)
        _, vjp = jax.vjp(f, theta)
        g = vjp(r)[0]  # J^T r (for grad_inf and the forcing scale)
        damp = jnp.sqrt(lam)

        b = -r
        eps_tiny = jnp.asarray(1e-30, dtype=r.dtype)

        beta1 = jnp.linalg.norm(b)
        u0 = b / jnp.maximum(beta1, eps_tiny)
        v_raw = vjp(u0)[0]
        alpha1 = jnp.linalg.norm(v_raw)
        v0 = v_raw / jnp.maximum(alpha1, eps_tiny)

        gnorm = alpha1 * beta1  # ||A^T b|| = ||J^T r||
        eta = jnp.minimum(cg_tol, jnp.sqrt(gnorm))
        tol = eta * gnorm

        def cond(state):
            _, _, _, _, _, _, ntest, k = state
            return (k < max_cg) & (ntest > tol)

        def body(state):
            x, w, u, v, alpha, (phibar, rhobar), _, k = state
            u_new = jvp_lin(v) - alpha * u
            beta = jnp.linalg.norm(u_new)
            u_new = u_new / jnp.maximum(beta, eps_tiny)
            v_new = vjp(u_new)[0] - beta * v
            alpha_new = jnp.linalg.norm(v_new)
            v_new = v_new / jnp.maximum(alpha_new, eps_tiny)
            # eliminate the damping row
            rhobar1 = jnp.sqrt(rhobar * rhobar + damp * damp)
            c1 = rhobar / jnp.maximum(rhobar1, eps_tiny)
            phibar1 = c1 * phibar
            # Givens rotation on the bidiagonal
            rho = jnp.sqrt(rhobar1 * rhobar1 + beta * beta)
            c = rhobar1 / jnp.maximum(rho, eps_tiny)
            s = beta / jnp.maximum(rho, eps_tiny)
            theta_ = s * alpha_new
            rhobar_new = -c * alpha_new
            phi = c * phibar1
            phibar_new = s * phibar1
            x = x + (phi / jnp.maximum(rho, eps_tiny)) * w
            w = v_new - (theta_ / jnp.maximum(rho, eps_tiny)) * w
            # running estimate of ||A_aug^T r_aug||; phibar carries an
            # alternating sign through the damping elimination (cs1 < 0
            # when rhobar < 0), so the magnitude is what converges
            ntest = jnp.abs(phibar_new * alpha_new * c)
            return (x, w, u_new, v_new, alpha_new,
                    (phibar_new, rhobar_new), ntest, k + 1)

        x0 = jnp.zeros_like(g)
        init = (x0, v0, u0, v0, alpha1, (beta1, alpha1), gnorm + tol, 0)
        delta, *_, k = jax.lax.while_loop(cond, body, init)
        pred = r + jvp_lin(delta)
        pred_decrease = jnp.sum(r * r) - jnp.sum(pred * pred)
        grad_inf = jnp.max(jnp.abs(g))
        return delta, pred_decrease, grad_inf, k

    return r_and_J, loss_of, {
        "normal": lm_step, "host": lm_step_host, "qr": lm_step_qr,
        "cg": lm_step_cg, "lsqr": lm_step_lsqr,
    }


def gauss_newton(
    problem,
    params,
    data=None,
    iterations: int = 100,
    damping_init: float = 1e-3,
    damping_max: float = 1e12,
    gtol: float = 0.0,
    ftol: float = 0.0,
    verbose: bool = True,
    log_every: int = 10,
    host_solve: Optional[bool] = None,
    jac_chunk: Optional[int] = None,
    solve: Optional[str] = None,
    mesh=None,
    cg_maxiter: Optional[int] = None,
    cg_tol: float = 1e-3,
    cg_precond: int = 0,
) -> GNResult:
    """Levenberg-Marquardt polish of a (usually pre-trained) parameter pytree.

    `iterations` counts ACCEPTED steps; each costs one Jacobian build.  The
    damping lambda adapts by Nielsen's gain-ratio rule: accepted steps with
    gain ratio rho shrink lambda by max(1/3, 1-(2 rho-1)^3), rejections grow
    it geometrically (2, 4, 8, ...) until the model is trusted again.
    Stops on gtol (inf-norm of J^T r), ftol (relative loss decrease), an
    exhausted damping range, or the iteration budget.

    `solve` picks the damped-step kernel: "normal" (on-device damped normal
    equations — right for f64), "host" (pull (r, J) to the host, square and
    Cholesky-solve in f64 — the measured fix for the f32 damping
    stall), or "qr" (pure-on-device QR of the augmented [J; sqrt(lam) I]
    system — cond(J)-stable in f32 with NO host pull), or "cg" (MATRIX-FREE:
    conjugate gradients on the damped normal operator through jvp/vjp
    products, never materializing the [M, P] Jacobian — O(M + P) memory and
    the only kernel whose every pass stays element-sharded under a mesh).
    Default (None): "host" for sub-f64 parameters, "normal" for f64.
    `host_solve` is the pre-"qr" boolean spelling of the same choice and is
    honored when `solve` is not given.

    `mesh` shards the element axis of `data` across the device mesh (GSPMD,
    same layout as trainer.train) and replicates the parameter vector; all
    LM kernels then run partitioned.  "cg" is the recommended solver there
    (its matvecs reduce over the sharded axis with a single inserted psum);
    the dense kernels still work but materialize/gather J.
    """
    if solve is None:
        if host_solve is not None:
            solve = "host" if host_solve else "normal"
    elif solve not in ("normal", "host", "qr", "cg", "lsqr"):
        raise ValueError(
            f"solve must be 'normal', 'host', 'qr', 'cg' or 'lsqr', got {solve!r}"
        )
    data = problem.data if data is None else data
    resvec = make_residual_vector(problem)
    # Defensive copy (same contract as trainer.train: callers keep their tree)
    params = jax.tree.map(lambda a: jnp.array(a, copy=True), params)
    if mesh is not None:
        from hpvpinns_tpu.parallel.sharding import replicate, shard_problem

        data = shard_problem(data, mesh)
        params = replicate(params, mesh)
    theta, unravel = ravel_pytree(params)

    probe = resvec(params, data)
    # The LM objective must BE the training loss: ||r||^2 == loss, verified
    # numerically so a problem whose loss grows a term the residual vector
    # misses (e.g. an unregistered regularizer) fails loudly here.
    loss_probe = float(problem.loss_fn(params, data)[0])
    if not np.isclose(float(jnp.sum(probe * probe)), loss_probe, rtol=1e-4, atol=1e-12):
        raise ValueError(
            f"residual-vector identity violated: sum(r^2)="
            f"{float(jnp.sum(probe * probe)):.6e} vs loss={loss_probe:.6e}; "
            "the problem's loss contains terms outside extras['residual_fn'] "
            "+ boundary data (+ extras['reg_resvec_fn'])"
        )
    n_res, n_params = int(probe.size), int(theta.size)
    r_and_J, loss_of, lm_steps = _build_kernels(
        resvec, unravel, data, n_params, n_res, jac_chunk=jac_chunk,
        cg_maxiter=cg_maxiter, cg_tol=cg_tol, cg_precond=cg_precond,
    )
    if solve is None:
        solve = (
            "host" if jnp.dtype(theta.dtype) != jnp.dtype(jnp.float64) else "normal"
        )
    lm_step = lm_steps[solve]

    aux_of = jax.jit(lambda th, d: problem.loss_fn(unravel(th), d)[1])

    lam, nu = float(damping_init), 2.0
    records = []
    stopped = "iterations"
    accepted = 0
    t0 = time.perf_counter()

    matrix_free = solve in ("cg", "lsqr")
    if matrix_free:
        r = J = None
        loss = float(loss_of(theta, data))
    else:
        r, J = r_and_J(theta, data)
        loss = float(jnp.sum(r * r))
    cg_iters = None
    it = 0
    while accepted < iterations:
        it += 1
        lam_arr = jnp.asarray(lam, dtype=theta.dtype)
        if matrix_free:
            delta, pred_dec, grad_inf, cg_k = lm_step(theta, lam_arr, data)
            cg_iters = int(cg_k)
        else:
            delta, pred_dec, grad_inf = lm_step(r, J, lam_arr)
        if delta is None:  # host factorization failed: reject, inflate damping
            lam, nu = lam * nu, 2.0 * nu
            if lam > damping_max:
                stopped = "damping"
                break
            continue
        if float(grad_inf) <= gtol:
            stopped = "gtol"
            break
        theta_try = theta + delta
        loss_try = float(loss_of(theta_try, data))
        pred = float(pred_dec)
        rho = (loss - loss_try) / pred if pred > 0 else -1.0
        if rho > 0 and np.isfinite(loss_try):  # accept
            rel_dec = (loss - loss_try) / max(loss, 1e-300)
            theta, loss = theta_try, loss_try
            lam = lam * max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
            nu = 2.0
            accepted += 1
            aux_host = {k: float(v) for k, v in aux_of(theta, data).items()}
            rec = {"iteration": accepted, "damping": lam, **aux_host}
            if cg_iters is not None:
                rec["cg_iters"] = float(cg_iters)
            records.append(rec)
            if verbose and accepted % log_every == 0:
                print(
                    f"GN it {accepted}: loss {loss:.6e}, lam {lam:.1e}, "
                    f"|g|_inf {float(grad_inf):.2e}"
                )
            if ftol > 0 and rel_dec < ftol:
                stopped = "ftol"
                break
            if not matrix_free:
                r, J = r_and_J(theta, data)
        else:  # reject: inflate damping, reuse (r, J)
            lam, nu = lam * nu, 2.0 * nu
            if lam > damping_max:
                stopped = "damping"
                break

    params = unravel(theta)
    aux_host = {k: float(v) for k, v in aux_of(theta, data).items()}
    keys = sorted({k for rec in records for k in rec})
    history = {k: np.asarray([rec.get(k, np.nan) for rec in records]) for k in keys}
    return GNResult(
        params=params,
        history=history,
        iterations_run=it,
        accepted=accepted,
        wall_time_s=time.perf_counter() - t0,
        stopped=stopped,
        final_aux=aux_host,
    )
