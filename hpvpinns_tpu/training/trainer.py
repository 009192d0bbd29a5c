"""Generic jitted trainer.

Reproduces the reference training behavior (Poisson-1D.py:201-224,
Poisson-2D.py:233-253, AdvDiff.py:291-341): full-batch Adam (lr 1e-3, TF1
defaults = optax defaults), loss polled every `check_every` iterations with
threshold early stop, console logging every `log_every`, loss history
recording, and the AdvDiff best-snapshot-over-final-10% behavior
(AdvDiff.py:327-330) generalized to snapshotting the best *parameters*.

Accelerator structure: instead of one session.run per iteration plus three extra
graph executions for logging (Poisson-1D.py:207-213), the optimizer loop runs
as `lax.scan` chunks of `check_every` steps inside a single jitted function —
one host sync per chunk, zero recompilation, donated buffers.

Optional `mesh` shards the element axis across devices via `shard_map` with a
single `psum` (see parallel/sharding.py).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import jax
import numpy as np
import optax

from hpvpinns_tpu.config import TrainConfig
from hpvpinns_tpu.problems.base import Problem


@dataclass
class TrainResult:
    params: Any
    history: Dict[str, np.ndarray]  # 'iteration', 'loss', 'lossb', 'lossv', ...
    iterations_run: int
    wall_time_s: float
    steps_per_sec: float
    stopped_early: bool
    best_params: Optional[Any] = None
    final_aux: Dict[str, float] = field(default_factory=dict)

    @property
    def eval_params(self):
        """Parameters to report: the best snapshot when one was kept (the
        reference reports the best-loss prediction, AdvDiff.py:327-330),
        otherwise the final parameters."""
        return self.best_params if self.best_params is not None else self.params


def make_optimizer(cfg: TrainConfig) -> optax.GradientTransformation:
    """Adam with TF1 defaults (Poisson-1D.py:103: lr from config, beta/eps
    defaults identical between tf.train.AdamOptimizer and optax.adam).

    Wrapped in optax.flatten: the update then runs on one concatenated vector
    instead of per-leaf tiny ops, which keeps the number of kernel launches
    per step low for the small VPINN networks."""
    return optax.flatten(optax.adam(cfg.learning_rate))


def _build_lbfgs_chunk(loss_fn: Callable, opt, n_steps: int):
    """Jitted scan of n_steps L-BFGS updates (zoom linesearch inside jit)."""

    def loss_only(params, data):
        return loss_fn(params, data)[0]

    def chunk(params, opt_state, data):
        value_and_grad = optax.value_and_grad_from_state(lambda p: loss_only(p, data))

        def body(carry, _):
            p, s = carry
            value, grad = value_and_grad(p, state=s)
            updates, s = opt.update(
                grad, s, p, value=value, grad=grad, value_fn=lambda q: loss_only(q, data)
            )
            p = optax.apply_updates(p, updates)
            return (p, s), None

        (params, opt_state), _ = jax.lax.scan(body, (params, opt_state), None, length=n_steps)
        _, aux = loss_fn(params, data)
        return params, opt_state, aux

    # No donation: optax.lbfgs state aliases the params buffers at init, and
    # donating the same buffer via both arguments is an XLA error.
    return jax.jit(chunk)


def _build_chunk(loss_fn: Callable, opt: optax.GradientTransformation, n_steps: int):
    """Jitted scan over n_steps optimizer updates; returns last step's aux."""

    def chunk(params, opt_state, data):
        def body(carry, _):
            p, s = carry
            (_, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(p, data)
            updates, s = opt.update(grads, s, p)
            p = optax.apply_updates(p, updates)
            return (p, s), None

        (params, opt_state), _ = jax.lax.scan(
            body, (params, opt_state), None, length=n_steps
        )
        # Metrics are evaluated at the *updated* parameters, exactly like the
        # reference's post-step sess.run(loss) poll (Poisson-1D.py:208-213) —
        # one extra loss eval per chunk, so the recorded loss corresponds to
        # the returned params (and to any best-snapshot taken from them).
        _, aux = loss_fn(params, data)
        return params, opt_state, aux

    return jax.jit(chunk, donate_argnums=(0, 1))


def train(
    problem: Problem,
    cfg: Optional[TrainConfig] = None,
    mesh=None,
    params=None,
    verbose: bool = True,
) -> TrainResult:
    cfg = cfg or problem.config.train
    loss_fn = problem.loss_fn
    data = problem.data

    if mesh is not None:
        # GSPMD path: element arrays split over the mesh, params/basis
        # replicated; XLA partitions the contractions and inserts the
        # loss/grad all-reduce automatically.
        from hpvpinns_tpu.parallel.sharding import replicate, shard_problem

        data = shard_problem(data, mesh)

    if params is None:
        params = problem.init_params(jax.random.key(cfg.seed))
    else:
        # Defensive copy: the jitted chunks donate the params buffers, which
        # would silently invalidate a caller's pytree (warm starts, resumes).
        params = jax.tree.map(lambda a: jax.numpy.array(a, copy=True), params)
    if mesh is not None:
        params = replicate(params, mesh)
    opt = make_optimizer(cfg)
    opt_state = opt.init(params)

    check = max(1, cfg.check_every)

    checkpointer = None
    if cfg.checkpoint_dir is not None:
        from hpvpinns_tpu.training.checkpoint import Checkpointer

        checkpointer = Checkpointer(
            cfg.checkpoint_dir,
            keep_last=cfg.checkpoint_keep_last,
            use_async=cfg.checkpoint_async,
        )

    records: List[Dict[str, float]] = []
    stopped = False
    best_params = None
    min_loss = np.inf
    total_iters = cfg.iterations + cfg.lbfgs_iterations
    snap_after = (
        cfg.best_snapshot_fraction * total_iters
        if cfg.best_snapshot_fraction is not None
        else None
    )

    t0 = time.perf_counter()
    state = {"t_log": t0, "t_warm": None, "it_warm": 0, "it": 0, "it_saved": 0, "aux": {}}

    def run_phase(build_chunk, opt, params, opt_state, n_iters):
        nonlocal stopped, best_params, min_loss
        chunk_fn = build_chunk(loss_fn, opt, check)
        end = state["it"] + n_iters
        while state["it"] < end:
            n = min(check, end - state["it"])
            if n != check:
                chunk_fn = build_chunk(loss_fn, opt, n)
            params, opt_state, aux = chunk_fn(params, opt_state, data)
            it = state["it"] = state["it"] + n

            aux_host = {k: float(v) for k, v in aux.items()}  # device sync
            state["aux"] = aux_host
            if state["t_warm"] is None:
                state["t_warm"], state["it_warm"] = time.perf_counter(), it
            records.append({"iteration": it, **aux_host})
            loss_value = aux_host["loss"]

            if snap_after is not None and it > snap_after and loss_value < min_loss:
                min_loss = loss_value
                best_params = jax.tree.map(lambda a: np.asarray(a), params)
            if (
                checkpointer is not None
                and cfg.checkpoint_every
                and it - state["it_saved"] >= cfg.checkpoint_every
            ):
                checkpointer.save(it, params, opt_state)
                state["it_saved"] = it

            if cfg.threshold is not None and loss_value < cfg.threshold:
                if verbose:
                    print(f"It: {it}, Loss: {loss_value:.3e} (threshold reached)")
                stopped = True
                break
            if verbose and it % cfg.log_every < check:
                now = time.perf_counter()
                parts = ", ".join(f"{k}: {v:.3e}" for k, v in aux_host.items() if k != "loss")
                print(f"It: {it}, Loss: {loss_value:.3e}, {parts}, Time: {now - state['t_log']:.2f}")
                state["t_log"] = now
        return params, opt_state

    params, opt_state = run_phase(_build_chunk, opt, params, opt_state, cfg.iterations)

    if cfg.lbfgs_iterations > 0 and not stopped:
        # Second-phase full-batch L-BFGS with zoom linesearch: the standard
        # accelerator once Adam has found the basin.
        lbfgs = optax.lbfgs()
        lbfgs_state = lbfgs.init(params)
        params, _ = run_phase(
            _build_lbfgs_chunk, lbfgs, params, lbfgs_state, cfg.lbfgs_iterations
        )
        # The Adam opt_state is stale relative to the L-BFGS-moved params;
        # a resume from the final checkpoint restarts Adam with fresh moments.
        opt_state = opt.init(params)

    if cfg.gn_iterations > 0 and not stopped:
        # Third-phase Gauss-Newton/Levenberg-Marquardt on the residual
        # vector: second-order curvature for the final descent to the
        # discretization floor (training/gauss_newton.py).
        from hpvpinns_tpu.training.gauss_newton import gauss_newton

        gn = gauss_newton(
            problem,
            params,
            data=data,
            iterations=cfg.gn_iterations,
            damping_init=cfg.gn_damping_init,
            solve=cfg.gn_solve,
            cg_tol=cfg.gn_cg_tol,
            cg_maxiter=cfg.gn_cg_maxiter,
            jac_chunk=cfg.gn_jac_chunk,
            verbose=verbose,
            log_every=max(1, cfg.log_every // 10),
        )
        params = gn.params
        offset = state["it"]
        n_gn = len(gn.history.get("iteration", ()))
        for i in range(n_gn):
            records.append(
                {
                    k: (offset + gn.history[k][i] if k == "iteration" else float(gn.history[k][i]))
                    for k in gn.history
                }
            )
        state["it"] += gn.iterations_run
        state["aux"] = gn.final_aux
        # LM only ever accepts loss decreases, so the GN endpoint supersedes
        # any Adam/L-BFGS-phase best snapshot it undercuts.
        if gn.final_aux.get("loss", np.inf) < min_loss:
            best_params = None
            min_loss = gn.final_aux["loss"]
        opt_state = opt.init(params)
        if cfg.threshold is not None and gn.final_aux.get("loss", np.inf) < cfg.threshold:
            stopped = True

    it = state["it"]
    aux_host = state["aux"]
    t_warm, it_warm = state["t_warm"], state["it_warm"]

    jax.block_until_ready(params)
    t_end = time.perf_counter()
    wall = t_end - t0
    # Throughput from post-compile chunks when available (the first chunk
    # carries the one-time jit compile).
    if t_warm is not None and it > it_warm and t_end > t_warm:
        sps = (it - it_warm) / (t_end - t_warm)
    else:
        sps = it / wall if wall > 0 else float("nan")

    keys = sorted({k for r in records for k in r})
    history = {k: np.asarray([r.get(k, np.nan) for r in records]) for k in keys}
    if checkpointer is not None:
        checkpointer.save(it, params, opt_state)
        checkpointer.wait()  # barrier on async writes before returning
    return TrainResult(
        params=params,
        history=history,
        iterations_run=it,
        wall_time_s=wall,
        steps_per_sec=sps,
        stopped_early=stopped,
        best_params=best_params,
        final_aux=aux_host,
    )
