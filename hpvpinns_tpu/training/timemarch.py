"""Slab-sequential time marching for the unsteady space-time families.

A single space-time solve must represent the whole horizon [0, T] in one
network; for long horizons the optimizer spreads capacity over an
ever-larger domain and accuracy decays.  Time marching splits the horizon
into S slabs and solves them sequentially, handing the trained network's
state at each slab's end time to the next slab as its initial condition —
the variational analog of a one-step time integrator, with the slab
interface enforced through the data loss exactly like the t = 0 IC.

No reference analog (the reference trains single space-time domains only,
AdvDiff.py:35-53); this composes the framework's existing machinery:
per-slab configs are ordinary `replace(cfg, t_start=a, t_final=b)`
problems built with `ic_fn=` (problems/burgers.py, problems/advdiff.py,
problems/taylorgreen.py — the unsteady NS system marches too, with the
full (u, v, p) state handed across each interface).  Hard-BC configs
march too (burgers + taylorgreen): each slab's lift interpolates the
PREDICTED interface state instead of the analytic t = 0 face
(_hard_bc_slab_kwargs), so the measured-best lifted ansatz composes with
marching — exact walls on every slab, exact handoff between hard-BC
slabs.
trained by the ordinary trainer (optionally warm-started from the previous
slab's parameters — the solution evolves smoothly, so the previous slab is
a better init than Xavier), and evaluated against the global exact
solution on each slab's own test grid.

Device notes: every slab is a full jitted train (Adam/L-BFGS/GN phases,
element-sharded under a mesh if given); the only host work between slabs
is one batched prediction at the interface (the IC handoff).
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import numpy as np

from hpvpinns_tpu.problems.base import Problem


@dataclass
class TimeMarchResult:
    edges: np.ndarray  # slab boundaries in time, [S+1]
    problems: List[Problem]  # one per slab (each carries its own test grid)
    params: List[Any]  # trained eval-params per slab
    per_slab: List[dict]  # per-slab metrics (rel_l2 vs exact on the slab)
    metrics: dict  # global metrics over the concatenated horizon grid
    wall_time_s: float = 0.0
    history: List[Any] = field(default_factory=list)

    def slab_of(self, t: np.ndarray) -> np.ndarray:
        """Owning slab index for each time (interface points go to the
        EARLIER slab, whose network actually matched data there)."""
        idx = np.searchsorted(self.edges[1:-1], np.asarray(t), side="left")
        return np.clip(idx, 0, len(self.problems) - 1)

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Piecewise prediction over the full horizon: each point is
        evaluated by the network of the slab that owns its time.  Output
        is [P, C] with C the problem's component count (1 for the scalar
        families, 3 for the (u, v, p) systems)."""
        from hpvpinns_tpu.evaluate import predict

        X = np.asarray(X)
        owner = self.slab_of(X[:, -1])
        n_comp = np.asarray(self.problems[0].test_values).reshape(
            len(self.problems[0].test_points), -1
        ).shape[1]
        out = np.zeros((X.shape[0], n_comp), dtype=np.float64)
        for k, (prob, p) in enumerate(zip(self.problems, self.params)):
            m = owner == k
            if m.any():
                out[m] = np.asarray(predict(prob, p, X[m])).reshape(-1, n_comp)
        return out


def _slab_builder(cfg):
    """Family dispatch: the slab-capable builders take ic_fn."""
    from hpvpinns_tpu.config import (
        AdvDiffConfig,
        BurgersConfig,
        TaylorGreenConfig,
    )
    from hpvpinns_tpu.problems import advdiff, burgers, taylorgreen

    if isinstance(cfg, BurgersConfig):
        return burgers.build
    if isinstance(cfg, (AdvDiffConfig, TaylorGreenConfig)):
        if cfg.inverse:
            raise ValueError(
                "time_march solves forward problems (the sensors of an "
                "inverse run live on the GLOBAL horizon; identify the "
                "coefficient first, then march the forward solve)"
            )
        if isinstance(cfg, AdvDiffConfig) and getattr(cfg, "hard_bc", False):
            raise ValueError(
                "hard-BC slab marching is implemented for burgers and "
                "taylorgreen (the families with measured march arms); "
                "advdiff marches soft-BC"
            )
        return advdiff.build if isinstance(cfg, AdvDiffConfig) else taylorgreen.build
    raise TypeError(
        f"time_march supports the slab-capable unsteady families "
        f"(BurgersConfig, AdvDiffConfig, TaylorGreenConfig); "
        f"got {type(cfg).__name__}"
    )


def _hard_bc_slab_kwargs(cfg, scfg, k, ic, prev_prob, prev_params):
    """Per-slab build kwargs that keep a hard-BC ansatz EXACT on the slab's
    own data faces when marching (VERDICT round-4 ask: the round-4 march
    arms were soft-BC only because the default lifts interpolate the
    analytic t = 0 face; these lifts interpolate the PREDICTED interface
    state instead, so the measured-best hard-BC ansatz composes with
    marching).

    burgers: a constant-in-t lift from the slab's start-face state
    (problems/burgers.py::make_interface_lift) — the previous slab's
    trained ansatz at the interface time for ic='net', the traceable
    Cole-Hopf solution for ic='exact'/slab 0 of a shifted horizon.
    taylorgreen: the generalized space-time Coons lift with the predicted
    (u, v) initial face (problems/taylorgreen.py::coons_lift_spacetime_jnp
    g_ic_fn hook); the side walls stay analytic (they carry exact data on
    every slab), so the velocity handoff is exact by construction.

    NOTE each 'net' lift closes over the previous slab's FULL ansatz, so
    slab k's lift evaluates a chain of k networks per point — linear
    per-slab cost growth, fine at the measured 3-6 slab counts."""
    import jax.numpy as jnp

    from hpvpinns_tpu.config import BurgersConfig, TaylorGreenConfig

    if not getattr(cfg, "hard_bc", False):
        return {}
    if isinstance(cfg, BurgersConfig):
        from hpvpinns_tpu.problems.burgers import (
            make_interface_lift,
            u_exact_jnp,
        )

        if k == 0 and scfg.t_start == 0.0:
            return {}  # the default lift IS the analytic IC
        t_if = scfg.t_start
        if k > 0 and ic == "net":
            def u0_fn(x, _prob=prev_prob, _params=prev_params, _t=t_if):
                X = jnp.concatenate([x, jnp.full_like(x, _t)], axis=-1)
                return _prob.apply(_params, X)
        else:
            def u0_fn(x, _nu=cfg.nu, _t=t_if):
                return u_exact_jnp(x, jnp.asarray(_t, dtype=x.dtype), _nu)
        return {"lift_fn": make_interface_lift(u0_fn, cfg.domain_x)}
    if isinstance(cfg, TaylorGreenConfig):
        if k == 0 or ic == "exact":
            return {}  # the generalized Coons lift is analytic at t_start
        t_if = scfg.t_start

        def _component(i):
            def g_ic(x, y, _prob=prev_prob, _params=prev_params,
                     _t=t_if, _i=i):
                X = jnp.concatenate(
                    [x, y, jnp.full_like(x, _t)], axis=-1
                )
                return _prob.apply(_params, X)[:, _i : _i + 1]

            return g_ic

        return {"ic_lift_fns": (_component(0), _component(1))}
    return {}


def time_march(
    cfg,
    n_slabs: int,
    train_cfg=None,
    warm_start: bool = True,
    ic: str = "net",
    mesh=None,
    edges=None,
    budget_weights=None,
    verbose: bool = True,
    progress: Optional[Callable[[int, dict], None]] = None,
) -> TimeMarchResult:
    """Solve cfg's problem over [cfg.t_start, cfg.t_final] in `n_slabs`
    sequential time slabs.

    cfg: a slab-capable unsteady config; its n_elements_t / iteration budget
        are PER SLAB (a 3-slab march with n_elements_t=2 spends 6 time
        elements and 3x the training budget of the single solve — compare
        at equal totals by dividing both by n_slabs).
    ic: "net" hands each slab the previous slab's trained network state
        (the honest marching mode — errors propagate); "exact" uses the
        analytic solution at every slab start (a per-slab-capacity control
        that isolates propagation error from representation error).  For
        the (u, v, p) system the full state is handed across (the builder
        slices the components its IC face actually constrains).
    warm_start: initialize each slab's network at the previous slab's
        trained parameters instead of a fresh Xavier draw.
    edges: explicit slab boundaries (len n_slabs+1, ascending, spanning
        [t_start, t_final]); default uniform.
    budget_weights: optional per-slab multipliers (len n_slabs, > 0) on the
        training budget (Adam/L-BFGS/GN iterations), normalized to mean 1
        so the march's TOTAL budget is unchanged.  Motivated by the
        equal-split study (benchmarks/timemarch_study.py): the FIRST slab
        owns the IC transient and dominates the marched error at a uniform
        split, so front-loading (e.g. [2, 0.8, 0.6, 0.6]) re-allocates
        iterations where the physics needs them.
    """
    import hpvpinns_tpu as hv

    if n_slabs < 1:
        raise ValueError("n_slabs must be >= 1")
    if ic not in ("net", "exact"):
        raise ValueError(f"ic must be 'net' or 'exact', got {ic!r}")
    build = _slab_builder(cfg)
    t0 = float(getattr(cfg, "t_start", 0.0))
    edges = (
        np.linspace(t0, cfg.t_final, n_slabs + 1)
        if edges is None
        else np.asarray(edges, dtype=np.float64)
    )
    if len(edges) != n_slabs + 1 or not np.all(np.diff(edges) > 0):
        raise ValueError("edges must be n_slabs+1 ascending times")
    weights = None
    if budget_weights is not None:
        weights = np.asarray(budget_weights, dtype=np.float64)
        if len(weights) != n_slabs or np.any(weights <= 0):
            raise ValueError(
                f"budget_weights must be {n_slabs} positive multipliers"
            )
        weights = weights * (n_slabs / weights.sum())  # mean 1: total fixed

    t_begin = time.perf_counter()
    problems: List[Problem] = []
    params_list: List[Any] = []
    per_slab: List[dict] = []
    histories: List[Any] = []
    prev_prob, prev_params = None, None
    for k in range(n_slabs):
        scfg = dataclasses.replace(
            cfg, t_start=float(edges[k]), t_final=float(edges[k + 1])
        )
        ic_fn = None
        if k > 0 and ic == "net":
            t_if = float(edges[k])
            p_prob, p_params = prev_prob, prev_params

            def ic_fn(x, _prob=p_prob, _params=p_params, _t=t_if):
                # x: spatial columns only ([n, 1] scalar families, [n, 2]
                # systems); append the interface time and return the full
                # state [n, C] — the family builder slices what it needs.
                from hpvpinns_tpu.evaluate import predict

                x = np.asarray(x)
                X = np.hstack([x, np.full((len(x), 1), _t)])
                return np.asarray(predict(_prob, _params, X)).reshape(len(x), -1)

        prob = build(
            scfg, ic_fn=ic_fn,
            **_hard_bc_slab_kwargs(cfg, scfg, k, ic, prev_prob, prev_params),
        )
        init = prev_params if (warm_start and prev_params is not None) else None
        tc_k = train_cfg
        if weights is not None:
            base = train_cfg if train_cfg is not None else cfg.train
            w = float(weights[k])
            tc_k = dataclasses.replace(
                base,
                iterations=max(1, int(round(base.iterations * w))),
                lbfgs_iterations=int(round(base.lbfgs_iterations * w)),
                gn_iterations=int(round(base.gn_iterations * w)),
            )
        res = hv.train(prob, tc_k, mesh=mesh, params=init, verbose=verbose)
        m = hv.evaluate_problem(prob, res.eval_params)
        loss = res.final_aux.get("loss")
        m = {"slab": k, "t0": float(edges[k]), "t1": float(edges[k + 1]),
             "iterations": res.iterations_run,
             "final_loss": None if loss is None else float(loss), **m}
        per_slab.append(m)
        if progress is not None:
            progress(k, m)
        problems.append(prob)
        params_list.append(res.eval_params)
        histories.append(res.history)
        prev_prob, prev_params = prob, res.eval_params

    # Global metrics: every slab's own dense test grid, concatenated.  The
    # slabs are equal-length by default so this is (near-)uniform coverage
    # of the horizon; interface rows appear once per adjacent slab, each
    # evaluated by its own network — a deliberate stress on the handoff.
    preds, exacts = [], []
    from hpvpinns_tpu.evaluate import predict, rel_l2

    for prob, p in zip(problems, params_list):
        n_pts = len(prob.test_points)
        preds.append(np.asarray(predict(prob, p)).reshape(n_pts, -1))
        exacts.append(np.asarray(prob.test_values).reshape(n_pts, -1))
    u_pred, u_true = np.concatenate(preds), np.concatenate(exacts)
    err = u_pred - u_true
    metrics = {
        "rel_l2": float(np.linalg.norm(err) / np.linalg.norm(u_true)),
        "max_abs_err": float(np.max(np.abs(err))),
        "mean_abs_err": float(np.mean(np.abs(err))),
    }
    if u_true.shape[1] > 1:
        names = problems[0].extras.get(
            "component_names", tuple(f"c{i}" for i in range(u_true.shape[1]))
        )
        for i, name in enumerate(names):
            metrics[f"rel_l2_{name}"] = rel_l2(u_pred[:, i], u_true[:, i])
    return TimeMarchResult(
        edges=edges,
        problems=problems,
        params=params_list,
        per_slab=per_slab,
        metrics=metrics,
        wall_time_s=time.perf_counter() - t_begin,
        history=histories,
    )
