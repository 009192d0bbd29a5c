"""Subprocess entry point for the host-f64 LM polish (training/hybrid.py).

Forces the CPU backend and float64 BEFORE any backend starts, so the
child never opens the accelerator the parent process holds, rebuilds the
problem from the JSON spec at
``dtype="float64"``, warm-starts the Gauss-Newton/LM phase from the
parent's parameters, and writes the polished leaves + an f64 evaluation
summary back into the exchange directory.

Protocol (all paths relative to the single argv[1] directory):
  spec.json    in   {"config": config_to_spec(...), "gn": {...}}
  params.npz   in   flattened leaves, leaf_0..leaf_{n-1}
  polished.npz out  same layout, float64
  summary.json out  loss/accepted/stopped/wall_s + f64 metrics for the
                    polished AND the incoming parameters
"""

import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402


def main(tmpdir: str) -> None:
    import dataclasses

    import hpvpinns_tpu as hv
    from hpvpinns_tpu.training.gauss_newton import gauss_newton
    from hpvpinns_tpu.training.hybrid import config_from_spec

    with open(os.path.join(tmpdir, "spec.json")) as fh:
        spec = json.load(fh)
    cfg = config_from_spec(spec["config"])
    cfg = dataclasses.replace(cfg, dtype="float64")
    prob = hv.build(cfg)

    template = prob.init_params(jax.random.key(0))
    _, treedef = jax.tree_util.tree_flatten(template)
    z = np.load(os.path.join(tmpdir, "params.npz"))
    leaves = [np.asarray(z[f"leaf_{i}"], dtype=np.float64)
              for i in range(len(z.files))]
    params = jax.tree_util.tree_unflatten(treedef, leaves)

    metrics_start = hv.evaluate_problem(prob, params)

    gn_opts = spec["gn"]
    t0 = time.perf_counter()
    gn = gauss_newton(
        prob,
        params,
        iterations=gn_opts["iterations"],
        solve=gn_opts["solve"],
        damping_init=gn_opts["damping_init"],
        ftol=gn_opts["ftol"],
        gtol=gn_opts["gtol"],
        cg_tol=gn_opts["cg_tol"],
        cg_maxiter=gn_opts["cg_maxiter"],
        jac_chunk=gn_opts.get("jac_chunk"),
        verbose=gn_opts.get("verbose", False),
    )
    wall = time.perf_counter() - t0

    out_leaves, _ = jax.tree_util.tree_flatten(gn.params)
    np.savez(os.path.join(tmpdir, "polished.npz"),
             **{f"leaf_{i}": np.asarray(l, dtype=np.float64)
                for i, l in enumerate(out_leaves)})
    summary = {
        "loss": float(gn.final_aux.get("loss")),
        "accepted": int(gn.accepted),
        "stopped": str(gn.stopped),
        "wall_s": round(wall, 2),
        "metrics": {k: float(v)
                    for k, v in hv.evaluate_problem(prob, gn.params).items()},
        "metrics_start": {k: float(v) for k, v in metrics_start.items()},
    }
    with open(os.path.join(tmpdir, "summary.json"), "w") as fh:
        json.dump(summary, fh)


if __name__ == "__main__":
    main(sys.argv[1])
