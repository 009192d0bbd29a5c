"""Real multi-process execution check.

SURVEY.md section 5 asks for cross-process XLA collectives via
jax.distributed.  A multi-host cluster is not needed to prove that code
path: two LOCAL processes, each owning 4 virtual CPU devices
(xla_force_host_platform_device_count), form a genuine 2-process JAX cluster
over a localhost coordinator — cross-process collectives run through the
same distributed runtime a multi-host cluster uses.

`run_multiprocess_check()` (parent) spawns N children running
`python -m hpvpinns_tpu.parallel.multihost_check --child`; every child
  1. brings the cluster up through parallel.distributed.initialize(),
  2. builds the same tiny Poisson-2D problem,
  3. lays it out on the GLOBAL element mesh (parallel/sharding.py is
     host-count agnostic: meshes come from jax.devices()),
  4. jits one loss+grad evaluation — XLA inserts the cross-process
     all-reduce — and reports loss and grad-norm.
The parent compares every child's numbers against a single-process
8-device run of the identical problem: equality proves the multi-host
layout computes exactly what the single-host one does.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile


_DEVICES_PER_PROC = 4
_N_PROC = 2


def _tiny_config():
    import hpvpinns_tpu as hv

    # float32 everywhere: the check must compute identically whether the
    # host process has x64 enabled (pytest conftest) or not (graft dryrun).
    return hv.Poisson2DConfig(
        n_elements_x=4, n_elements_y=2, n_quad=4, n_test_x=3, n_test_y=3,
        layers=(2, 8, 8, 1), dtype="float32",
        train=hv.TrainConfig(iterations=1),
    )


def _loss_and_gradnorm_on_mesh():
    """Shared child/parent computation: loss + grad 2-norm of the tiny
    problem laid out over the element mesh spanning ALL global devices,
    plus a 2-accepted-step Gauss-Newton/LM phase on the matrix-free CG
    kernel over the SAME global mesh — the precision optimizer's matvec
    psum and the LM accept/reject control flow crossing the process
    boundary (the single-process virtual-mesh GN parity leg in
    __graft_entry__.dryrun_multichip, promoted to a real 2-process
    cluster)."""
    import jax
    import jax.numpy as jnp

    import hpvpinns_tpu as hv
    from hpvpinns_tpu.parallel.sharding import element_mesh, replicate, shard_problem
    from hpvpinns_tpu.training.gauss_newton import gauss_newton

    prob = hv.build(_tiny_config())
    mesh = element_mesh()  # global devices, both processes
    data = shard_problem(prob.data, mesh)
    params = replicate(prob.init_params(jax.random.key(0)), mesh)

    @jax.jit
    def loss_and_gradnorm(params, data):
        (loss, _), grads = jax.value_and_grad(prob.loss_fn, has_aux=True)(params, data)
        sq = sum(jnp.sum(g * g) for g in jax.tree_util.tree_leaves(grads))
        return loss, jnp.sqrt(sq)

    loss, gnorm = loss_and_gradnorm(params, data)
    gn = gauss_newton(prob, prob.init_params(jax.random.key(3)),
                      iterations=2, solve="cg", mesh=mesh, verbose=False)
    return {
        "loss": float(loss),
        "grad_norm": float(gnorm),
        "gn_loss": float(gn.final_aux["loss"]),
        "gn_accepted": int(gn.accepted),
        "n_global_devices": len(jax.devices()),
        "process_count": jax.process_count(),
    }


def _child_main(argv):
    port, process_id, num_processes, out_path = argv
    import jax

    jax.config.update("jax_platforms", "cpu")

    from hpvpinns_tpu.parallel import distributed

    topo = distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=int(num_processes),
        process_id=int(process_id),
    )
    result = {**_loss_and_gradnorm_on_mesh(), **topo}
    with open(out_path, "w") as f:
        json.dump(result, f)
    # Clean shutdown so the coordinator does not log dropped-peer warnings.
    jax.distributed.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_multiprocess_check(timeout_s: float = 300.0) -> dict:
    """Spawn the 2-process cluster; return child results + the expected
    single-process reference computed in-process (requires the caller to be
    running on >= 8 CPU devices, e.g. under tests/conftest.py)."""
    port = _free_port()
    tmp = tempfile.mkdtemp(prefix="hpvpinn_mh_")
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={_DEVICES_PER_PROC}"
    # Ensure the repo (and its graft entry) is importable from the children.
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    procs, outs = [], []
    for pid in range(_N_PROC):
        out_path = os.path.join(tmp, f"proc{pid}.json")
        outs.append(out_path)
        procs.append(
            subprocess.Popen(
                [sys.executable, "-m", "hpvpinns_tpu.parallel.multihost_check",
                 "--child", str(port), str(pid), str(_N_PROC), out_path],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
        )
    logs = []
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append({"returncode": p.returncode, "stdout": stdout[-2000:], "stderr": stderr[-2000:]})

    children = []
    for pid, out_path in enumerate(outs):
        if not os.path.exists(out_path):
            raise RuntimeError(
                f"multihost child {pid} produced no result "
                f"(rc={logs[pid]['returncode']}): {logs[pid]['stderr'][-800:]}"
            )
        with open(out_path) as f:
            children.append(json.load(f))

    ref = _loss_and_gradnorm_on_mesh()
    return {
        "children": children,
        "reference": {**ref, "n_devices": ref["n_global_devices"]},
        "logs": logs,
    }


def assert_multiprocess_matches(result: dict, rtol: float = 1e-6,
                                gn_rtol: float = 1e-4):
    """The 2-process cluster must compute the single-process numbers.

    `gn_rtol` matches the single-process sharded-vs-unsharded GN parity
    tolerance (__graft_entry__ / tests/test_sharding.py): the CG matvec's
    cross-process psum may reduce in a different order than the
    single-process all-reduce, so the accepted-step losses agree to f32
    reduction noise rather than bit-exactly."""
    import numpy as np

    ref = result["reference"]
    assert ref["n_devices"] >= _N_PROC * _DEVICES_PER_PROC, (
        f"reference leg ran on {ref['n_devices']} devices; need "
        f"{_N_PROC * _DEVICES_PER_PROC} for an apples-to-apples mesh"
    )
    for child in result["children"]:
        assert child["process_count"] == _N_PROC, child
        assert child["n_global_devices"] == _N_PROC * _DEVICES_PER_PROC, child
        np.testing.assert_allclose(child["loss"], ref["loss"], rtol=rtol)
        np.testing.assert_allclose(child["grad_norm"], ref["grad_norm"], rtol=rtol)
        assert child["gn_accepted"] == ref["gn_accepted"] == 2, (
            child["gn_accepted"], ref["gn_accepted"])
        np.testing.assert_allclose(child["gn_loss"], ref["gn_loss"],
                                   rtol=gn_rtol)


if __name__ == "__main__":
    if len(sys.argv) >= 2 and sys.argv[1] == "--child":
        _child_main(sys.argv[2:6])
    else:
        res = run_multiprocess_check()
        assert_multiprocess_matches(res)
        print(json.dumps({k: res[k] for k in ("children", "reference")}, indent=2))
