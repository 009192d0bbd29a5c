"""Deployment/serving tier: StableHLO model artifacts via `jax.export`.

The reference has NO deployment story — its trained networks die with the
TF1 session process (Poisson-1D.py:201-224 trains and plots in one script;
no saver, no export).  This module is the serving path: a trained ansatz (plain MLP or composite hard-BC lift) is
lowered ONCE to a self-contained, platform-tagged StableHLO artifact with a
*symbolic batch dimension*, so it can be

- saved/loaded without any model-building Python (the artifact carries the
  weights as constants and the full ansatz computation as StableHLO),
- called at any batch size without retracing,
- served on a backend it was never traced on: `platforms=("cpu", "cuda")`
  by default uses jax.export's cross-platform lowering, so an artifact
  exported from a CPU trainer runs on a GPU server and vice versa.

Artifact layout (a directory):
    model.stablehlo   -- the exported StableHLO module (portable bytecode,
                         versioned by jax.export's calling convention)
    meta.json         -- problem name, full config (reconstructible), i/o
                         signature, dtype, platforms, param count, and the
                         calling-convention fields that rebuild the
                         `jax.export.Exported` around the module

jax.export's own `Exported.serialize` needs the optional `flatbuffers`
package, which a serving host need not have; the artifact's calling
convention is fixed (one [b, d_in] array in, one [b, n_out] array out), so
meta.json records the few fields that vary and `load_model` rebuilds the
`Exported` from them.

`meta.json` makes the artifact self-describing: `load_model` returns a
`ServedModel` whose `.predict(X)` is the ansatz, and `rebuild_problem`
reconstructs the exact `Problem` (grid, quadrature, exact solution) for
validation — the CLI's `serve --check` compares the served artifact
against the rebuilt problem's exact solution on its dense test grid.

Exporting from a saved orbax checkpoint (no retraining) is a library
one-liner on top of this module:

    from hpvpinns_tpu.training.checkpoint import Checkpointer
    step, tree = Checkpointer(ckpt_dir).restore()
    hv.save_model(out_dir, problem, tree["params"])
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np

_FORMAT_VERSION = 2
_MODEL_FILE = "model.stablehlo"
_META_FILE = "meta.json"


def _compute_dtype(params) -> np.dtype:
    """The ansatz compute dtype = the network weights' dtype."""
    import jax

    return np.asarray(jax.tree_util.tree_leaves(params["net"])[0]).dtype


def export_model(problem, params, *, platforms: Tuple[str, ...] = ("cpu", "cuda")):
    """Lower the trained ansatz to a `jax.export.Exported` with a symbolic
    batch axis.

    The parameters are closed over as constants — the artifact is
    self-contained.  Works for every ansatz the framework builds (plain
    MLP, hard-BC composite lift+envelope, feature-augmented inputs): the
    export traces `problem.apply(params, X)` itself.
    """
    import jax
    from jax import export as jexport

    d_in = int(problem.test_points.shape[1])
    dtype = _compute_dtype(params)
    (b,) = jexport.symbolic_shape("b")
    spec = jax.ShapeDtypeStruct((b, d_in), dtype)

    def fn(x):
        return problem.apply(params, x)

    return jexport.export(jax.jit(fn), platforms=tuple(platforms))(spec)


def exported_fields(exported) -> dict:
    """The calling-convention fields of an artifact's `Exported` that are not
    implied by its fixed one-array-in, one-array-out signature."""
    return {
        "fun_name": exported.fun_name,
        "calling_convention_version": exported.calling_convention_version,
        "module_kept_var_idx": list(exported.module_kept_var_idx),
        "uses_global_constants": exported.uses_global_constants,
        "out_dtype": np.dtype(exported.out_avals[0].dtype).name,
    }


def rebuild_exported(module: bytes, meta: dict):
    """The `jax.export.Exported` of an artifact: its StableHLO `module` with
    a symbolic batch dim b, input [b, d_in] and output [b, n_out]."""
    import jax
    from jax import export as jexport

    (b,) = jexport.symbolic_shape("b")
    dtype = np.dtype(meta["dtype"])
    fields = meta["exported"]
    return jexport.Exported(
        fun_name=fields["fun_name"],
        in_tree=jax.tree.structure(((0,), {})),
        in_avals=(jax.core.ShapedArray((b, meta["d_in"]), dtype),),
        out_tree=jax.tree.structure(0),
        out_avals=(jax.core.ShapedArray((b, meta["n_out"]), np.dtype(fields["out_dtype"])),),
        _has_named_shardings=True,
        _in_named_shardings=(None,),
        _out_named_shardings=(None,),
        in_shardings_hlo=(None,),
        out_shardings_hlo=(None,),
        nr_devices=1,
        platforms=tuple(meta["platforms"]),
        ordered_effects=(),
        unordered_effects=(),
        disabled_safety_checks=(),
        mlir_module_serialized=module,
        calling_convention_version=fields["calling_convention_version"],
        module_kept_var_idx=tuple(fields["module_kept_var_idx"]),
        uses_global_constants=fields["uses_global_constants"],
        _get_vjp=None,
    )


def save_model(
    path: str,
    problem,
    params,
    *,
    platforms: Tuple[str, ...] = ("cpu", "cuda"),
    extra_meta: Optional[dict] = None,
) -> dict:
    """Export + write the artifact directory; returns the metadata dict."""
    import jax

    exported = export_model(problem, params, platforms=platforms)
    probe = problem.apply(params, problem.test_points[:1].astype(_compute_dtype(params)))
    n_params = sum(int(np.size(leaf)) for leaf in jax.tree_util.tree_leaves(params))
    meta = {
        "format_version": _FORMAT_VERSION,
        "problem": problem.name,
        "config_class": type(problem.config).__name__,
        "config": dataclasses.asdict(problem.config),
        "d_in": int(problem.test_points.shape[1]),
        "n_out": int(np.asarray(probe).shape[-1]),
        "dtype": np.dtype(_compute_dtype(params)).name,
        "platforms": list(exported.platforms),
        "n_params": n_params,
        "jax_version": jax.__version__,
        "exported": exported_fields(exported),
    }
    rebuilt = rebuild_exported(exported.mlir_module_serialized, meta)
    # str(): symbolic dims from two scopes never compare equal
    if str((rebuilt.in_avals, rebuilt.out_avals)) != str((exported.in_avals, exported.out_avals)):
        raise ValueError(
            f"ansatz signature {exported.in_avals} -> {exported.out_avals} is not "
            "the artifact's [b, d_in] -> [b, n_out] calling convention"
        )
    if extra_meta:
        meta.update(extra_meta)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, _MODEL_FILE), "wb") as f:
        f.write(exported.mlir_module_serialized)
    with open(os.path.join(path, _META_FILE), "w") as f:
        json.dump(meta, f, indent=1, default=str)
    return meta


@dataclass
class ServedModel:
    """A loaded artifact: `.predict(X)` is the ansatz, batch-size agnostic."""

    exported: Any
    meta: dict
    path: str

    def predict(self, X: np.ndarray) -> np.ndarray:
        import jax.numpy as jnp

        X = np.asarray(X)
        if X.ndim != 2 or X.shape[1] != self.meta["d_in"]:
            raise ValueError(
                f"expected points of shape [n, {self.meta['d_in']}], got {X.shape}"
            )
        x = jnp.asarray(X, dtype=self.meta["dtype"])
        return np.asarray(self.exported.call(x))

    def rebuild_problem(self):
        """Reconstruct the exact `Problem` this artifact was trained on
        (grid, quadrature, exact solution) from the stored config."""
        import hpvpinns_tpu as hv

        if self.meta.get("manufactured"):
            raise ValueError(
                "artifact was trained on a --manufactured-* problem whose "
                "u_fn/f_fn are not stored in the config; rebuild_problem "
                "would compare against the WRONG truth.  predict() remains "
                "fully usable (the artifact is self-contained)."
            )
        return hv.build(config_from_meta(self.meta))


def load_model(path: str) -> ServedModel:
    with open(os.path.join(path, _META_FILE)) as f:
        meta = json.load(f)
    if meta.get("format_version", 0) != _FORMAT_VERSION:
        raise ValueError(
            f"artifact format {meta.get('format_version')} is not this "
            f"library's ({_FORMAT_VERSION}); re-export it with save_model"
        )
    with open(os.path.join(path, _MODEL_FILE), "rb") as f:
        exported = rebuild_exported(f.read(), meta)
    return ServedModel(exported=exported, meta=meta, path=path)


def config_from_meta(meta: dict):
    """Rebuild the frozen config dataclass from the JSON round trip
    (lists back to the tuples the dataclasses declare; nested TrainConfig)."""
    import hpvpinns_tpu as hv

    cls = getattr(hv, meta["config_class"])

    def detuple(v):
        if isinstance(v, list):
            return tuple(detuple(x) for x in v)
        return v

    d = {k: detuple(v) for k, v in dict(meta["config"]).items()}
    if isinstance(d.get("train"), dict):
        d["train"] = hv.TrainConfig(**{k: detuple(v) for k, v in d["train"].items()})
    return cls(**d)
