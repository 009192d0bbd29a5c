"""Vmapped seed-ensemble training: S independent networks in one jitted step.

The methodology of record runs multi-seed studies SERIALLY (the reference
fixes one seed, Poisson-1D.py:26-27; this repo's robustness tables re-run
training per seed, benchmarks/MEASUREMENTS.md).  At these sizes one
network's step is small matmuls plus elementwise work, far too little to
fill an accelerator, so stacking a leading seed axis over the parameters and
vmapping the loss-and-grad turns S sequential runs into one step that does S
times the work per launch.

Everything else is unchanged: the data pytree is shared (broadcast into the
vmap), Adam is elementwise so `optax.flatten(adam)` applies to the stacked
pytree verbatim, and the per-seed aux dict comes back with a leading [S] axis.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from hpvpinns_tpu.config import TrainConfig
from hpvpinns_tpu.problems.base import Problem
from hpvpinns_tpu.training.trainer import make_optimizer


@dataclass
class EnsembleResult:
    params_stack: Any  # pytree with leading seed axis [S, ...]
    seeds: List[int]
    history: Dict[str, np.ndarray]  # each [n_records, S]
    iterations_run: int
    wall_time_s: float
    steps_per_sec: float  # optimizer steps/s (each step advances ALL seeds)
    seed_steps_per_sec: float  # steps_per_sec * S (the serial-equivalent rate)
    final_aux: Dict[str, np.ndarray]  # each [S]

    def member(self, i: int):
        """Extract seed i's parameter pytree."""
        return jax.tree.map(lambda a: a[i], self.params_stack)

    def best_member(self, key: str = "loss"):
        """(index, params) of the seed with the lowest final `key`."""
        i = int(np.argmin(self.final_aux[key]))
        return i, self.member(i)


def init_ensemble(problem: Problem, seeds: Sequence[int]):
    """Stacked init: leading axis = seed."""
    keys = jnp.stack([jax.random.key(int(s)) for s in seeds])
    return jax.vmap(problem.init_params)(keys)


def _build_ens_chunk(loss_fn, opt, n_steps: int):
    """Jitted scan of n_steps vmapped-loss optimizer updates."""

    def ens_grad(params_stack, data):
        def one(p):
            (_, aux), g = jax.value_and_grad(loss_fn, has_aux=True)(p, data)
            return g, aux

        return jax.vmap(one)(params_stack)

    def chunk(params_stack, opt_state, data):
        def body(carry, _):
            p, s = carry
            grads, _ = ens_grad(p, data)
            updates, s = opt.update(grads, s, p)
            p = jax.tree.map(lambda a, u: a + u, p, updates)
            return (p, s), None

        (params_stack, opt_state), _ = jax.lax.scan(
            body, (params_stack, opt_state), None, length=n_steps
        )
        _, aux = ens_grad(params_stack, data)
        return params_stack, opt_state, aux

    return jax.jit(chunk, donate_argnums=(0, 1))


def train_ensemble(
    problem: Problem,
    cfg: Optional[TrainConfig] = None,
    seeds: Sequence[int] = (0, 1, 2, 3),
    verbose: bool = True,
    mesh=None,
) -> EnsembleResult:
    """Train len(seeds) independent initializations in one vmapped loop.

    Adam phase only: the ensemble exists for seed studies and
    best-of-S selection, both of which the Adam phase decides; polish the
    selected member afterwards with L-BFGS/Gauss-Newton if wanted.

    `mesh` shards the element axis of the shared data pytree across the
    device mesh (GSPMD, same layout as trainer.train) and replicates the
    stacked parameters: the seed axis composes with the element sharding —
    vmap batches the contraction, XLA partitions its element dimension and
    inserts the per-seed loss/grad all-reduce.
    """
    cfg = cfg or problem.config.train
    loss_fn = problem.loss_fn
    data = problem.data
    seeds = list(seeds)

    params_stack = init_ensemble(problem, seeds)
    if mesh is not None:
        from hpvpinns_tpu.parallel.sharding import replicate, shard_problem

        data = shard_problem(data, mesh)
        params_stack = replicate(params_stack, mesh)
    opt = make_optimizer(cfg)
    opt_state = opt.init(params_stack)

    check = max(1, cfg.check_every)
    chunk_fn = _build_ens_chunk(loss_fn, opt, check)

    records = []
    t0 = time.perf_counter()
    t_warm = None
    it = it_warm = 0
    aux_host: Dict[str, np.ndarray] = {}
    while it < cfg.iterations:
        n = min(check, cfg.iterations - it)
        if n != check:
            chunk_fn = _build_ens_chunk(loss_fn, opt, n)
        params_stack, opt_state, aux = chunk_fn(params_stack, opt_state, data)
        it += n
        aux_host = {k: np.asarray(v) for k, v in aux.items()}
        if t_warm is None:
            t_warm, it_warm = time.perf_counter(), it
        records.append({"iteration": it, **aux_host})
        if verbose and it % cfg.log_every < check:
            losses = aux_host["loss"]
            print(
                f"It: {it}, loss min/med/max: {losses.min():.3e}/"
                f"{np.median(losses):.3e}/{losses.max():.3e}"
            )
        if cfg.threshold is not None and aux_host["loss"].max() < cfg.threshold:
            break

    jax.block_until_ready(params_stack)
    t_end = time.perf_counter()
    if t_warm is not None and it > it_warm and t_end > t_warm:
        sps = (it - it_warm) / (t_end - t_warm)
    else:
        sps = it / max(t_end - t0, 1e-9)

    keys = sorted({k for r in records for k in r})
    history = {
        k: np.stack([np.broadcast_to(np.asarray(r.get(k, np.nan)), (len(seeds),)) if k != "iteration" else np.full(len(seeds), r[k]) for r in records])
        for k in keys
    }
    return EnsembleResult(
        params_stack=params_stack,
        seeds=seeds,
        history=history,
        iterations_run=it,
        wall_time_s=t_end - t0,
        steps_per_sec=sps,
        seed_steps_per_sec=sps * len(seeds),
        final_aux=aux_host,
    )
