"""Hybrid precision pipeline: f32 device training + host-f64 LM polish.

The reference trains entirely in float64 (`hp-VPINN-Poisson-1D.py:46-51`
builds the whole TF graph in ``tf.float64``).  The device path here trains
in float32 with HIGHEST-precision matmuls, and the measured forward
frontiers carry a bounded f32 tax (MEASUREMENTS.md "f64-CPU controls").
The hybrid pipeline recovers those f64 digits: train on the device as
usual, then polish the trained parameters with the float64
Gauss-Newton/LM phase on the HOST CPU.

The polish runs in a SUBPROCESS that forces ``jax_platforms=cpu`` +
``jax_enable_x64`` before any backend starts.  Two reasons: the parent
process already holds the accelerator (a JAX process reserves most of its
memory, so a second process that opened it would fail), and the parent's
backend and dtype settings are fixed once it has initialized.  The child
rebuilds the SAME problem at float64 from a JSON config spec, warm-starts
from the device parameters, and returns the polished pytree plus
f64-evaluated metrics.  Moving the polish onto the device, in the same
process, is an open roadmap item.

Measured (MEASUREMENTS.md round-4 "hybrid f64 polish"): the poisson2d
f32 plateau 7.3e-5 is partly f32 *measurement* (the same parameters
evaluate to 4.4e-5 in f64) and the polish breaks it cleanly.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from dataclasses import dataclass
from typing import Optional

import jax
import numpy as np

from hpvpinns_tpu import config as config_mod
from hpvpinns_tpu.config import TrainConfig

__all__ = [
    "PolishResult",
    "config_from_spec",
    "config_to_spec",
    "polish_f64",
]


def config_to_spec(cfg) -> dict:
    """Serialize a frozen problem config to a JSON-safe spec dict.

    The spec records the config class name plus every field;  tuples
    survive the JSON round-trip via :func:`config_from_spec`'s
    list->tuple normalization (no config field is a genuine list).
    """
    if not dataclasses.is_dataclass(cfg):
        raise TypeError(f"not a config dataclass: {type(cfg).__name__}")
    return {"family": type(cfg).__name__, "fields": dataclasses.asdict(cfg)}


def _tuplify(value):
    if isinstance(value, list):
        return tuple(_tuplify(v) for v in value)
    return value


def config_from_spec(spec: dict):
    """Rebuild a problem config from :func:`config_to_spec` output."""
    cls = getattr(config_mod, spec["family"], None)
    if cls is None or not dataclasses.is_dataclass(cls):
        raise ValueError(f"unknown config family: {spec['family']!r}")
    fields = {k: _tuplify(v) for k, v in spec["fields"].items()}
    if isinstance(fields.get("train"), dict):
        fields["train"] = TrainConfig(**{k: _tuplify(v)
                                         for k, v in fields["train"].items()})
    return cls(**fields)


@dataclass(frozen=True)
class PolishResult:
    """Outcome of a host-f64 LM polish.

    ``params`` is the polished pytree cast back to the caller's problem
    dtype (ready for the chip / serving);  ``params_f64`` keeps the full
    float64 leaves for host-side use.  ``metrics`` are the WORKER's
    float64 evaluation of the polished network (rel-L2 et al.), i.e. the
    honest numbers free of f32 evaluation noise;  ``metrics_start`` is
    the same evaluation of the incoming chip parameters, so the pair
    attributes chip-vs-polish improvement without a separate run.
    """

    params: dict
    params_f64: dict
    loss: float
    accepted: int
    stopped: str
    wall_s: float
    metrics: dict
    metrics_start: dict


def polish_f64(
    cfg,
    params,
    iterations: int = 50,
    solve: str = "normal",
    damping_init: float = 1e-3,
    ftol: float = 0.0,
    gtol: float = 0.0,
    cg_tol: float = 1e-3,
    cg_maxiter: Optional[int] = None,
    jac_chunk: Optional[int] = 128,
    timeout: Optional[float] = None,
    verbose: bool = False,
    python: Optional[str] = None,
) -> PolishResult:
    """Polish ``params`` with a float64 Gauss-Newton/LM phase on the host.

    ``cfg`` is the ORIGINAL (typically float32) problem config; the
    worker rebuilds it with ``dtype="float64"`` on CPU, so the offline
    tables regain full precision too (they are assembled host-side in
    f64 regardless — problems/build.py — but the online contractions and
    the LM solve now run in f64 as well).  ``solve="normal"`` is the
    right default at f64 (gauss_newton's own auto rule); "cg"/"lsqr"
    keep the polish matrix-free for large parameter counts.

    `iterations` counts ACCEPTED LM steps, same contract as
    :func:`hpvpinns_tpu.training.gauss_newton.gauss_newton`.

    ``jac_chunk=128`` (default) bounds the dense kernels' f64
    Jacobian-build memory: the whole-J vmap at f64 measured >30 GB
    resident on the poisson2d precision config (1920 simultaneous
    cotangent passes through the 2D assembly tensors), while 128-wide
    blocks keep the build in the hundreds of MB at a few extra
    `lax.map` steps.  Pass None to restore gauss_newton's own rule.
    """
    leaves, treedef = jax.tree_util.tree_flatten(params)
    with tempfile.TemporaryDirectory(prefix="hvp_polish_") as tmp:
        np.savez(os.path.join(tmp, "params.npz"),
                 **{f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)})
        spec = {
            "config": config_to_spec(cfg),
            "gn": {
                "iterations": int(iterations),
                "solve": solve,
                "damping_init": float(damping_init),
                "ftol": float(ftol),
                "gtol": float(gtol),
                "cg_tol": float(cg_tol),
                "cg_maxiter": cg_maxiter,
                "jac_chunk": jac_chunk,
                "verbose": bool(verbose),
            },
        }
        with open(os.path.join(tmp, "spec.json"), "w") as fh:
            json.dump(spec, fh)

        env = dict(os.environ)
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.run(
            [python or sys.executable, "-m",
             "hpvpinns_tpu.training._polish_worker", tmp],
            env=env, capture_output=True, text=True, timeout=timeout,
        )
        if verbose and proc.stdout:
            print(proc.stdout, end="", flush=True)
        summary_path = os.path.join(tmp, "summary.json")
        if proc.returncode != 0 or not os.path.exists(summary_path):
            raise RuntimeError(
                "f64 polish worker failed "
                f"(rc={proc.returncode}):\n{proc.stderr[-2000:]}"
            )
        with open(summary_path) as fh:
            summary = json.load(fh)
        z = np.load(os.path.join(tmp, "polished.npz"))
        out64 = [np.asarray(z[f"leaf_{i}"]) for i in range(len(z.files))]

    params_f64 = jax.tree_util.tree_unflatten(treedef, out64)
    params_cast = jax.tree_util.tree_unflatten(
        treedef,
        [np.asarray(o, dtype=np.asarray(l).dtype)
         for o, l in zip(out64, leaves)],
    )
    return PolishResult(
        params=params_cast,
        params_f64=params_f64,
        loss=float(summary["loss"]),
        accepted=int(summary["accepted"]),
        stopped=str(summary["stopped"]),
        wall_s=float(summary["wall_s"]),
        metrics=summary["metrics"],
        metrics_start=summary["metrics_start"],
    )
