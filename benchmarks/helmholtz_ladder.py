"""Helmholtz k-ladder: pollution error vs hp budget, plus the ladder fix.

Round 4 shipped the oscillatory/indefinite family at a single wavenumber
(k = 9, ~3 wavelengths/axis) with an INVERTED preset ladder (the soft-BC
quality preset, 4.21e-4, cost more than the precision preset, 3.41e-4).
This study measures, in ONE process so every row shares the device:

1. `lad9` — the k = 9 preset ladder re-measure: quality-soft (the round-4
   preset), quality-hard (the same budgets under the hard-BC Coons trace
   lift, no GN), precision.  Whichever quality variant is the monotone
   time-to-accuracy point becomes the preset.
2. `kfix` — the pollution ladder at FIXED hp budget: the precision recipe
   (4x4 mesh, 10x10 test, q16, hard-BC + GN-50 QR LM) at k = 18, 27, 36
   (~6/9/11.5 wavelengths per axis).  The k^2 values all sit between
   Dirichlet-Laplacian eigenvalue clusters of [-1,1]^2 ((pi/2)^2 (m^2+n^2):
   324 -> 131.3 in the (130, 136) gap, 729 -> 295.5 in (293, 296),
   1296 -> 525.3 in (522, 530)), so the continuous problems stay
   well-posed — the degradation this arm measures is the DISCRETE
   pollution (fixed test space + fixed net vs growing oscillation), the
   thing hp test spaces exist to control on Helmholtz.
3. `khp` — the same ks with the mesh h-scaled to hold waves-per-element
   constant (E = 4k/9 per axis: 8, 12, 16; per-element quadrature and
   test order fixed), the hp answer to pollution with the NET fixed —
   what h buys, and where the w30 sin network becomes the limiter.
4. `ident` — the trainable-k^2 VPINN sensor route at k = 9 (inverse=True:
   k^2 a pde leaf fit jointly with the net from 60 interior sensors, the
   Helmholtz twin of AdvDiff.py:63's epsilon), the built-and-unit-tested
   path that had no measured row; reports k^2 rel err vs the network-free
   reduced route's 1.78e-9 (ACCURACY.json helmholtz2d_reduced_f64cpu).

Run from the repo root on the chip:  python benchmarks/helmholtz_ladder.py
(ARMS=lad9,kfix,khp,ident env override).  One JSON row per run.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import hpvpinns_tpu as hv  # noqa: E402


def _run(name, cfg, extra=()):
    prob = hv.build(cfg)
    t0 = time.perf_counter()
    res = hv.train(prob, verbose=False)
    wall = time.perf_counter() - t0
    m = hv.evaluate_problem(prob, res.eval_params)
    row = {"arm": name, "k": cfg.k, "elems": cfg.n_elements_x,
           "hard_bc": cfg.hard_bc, "gn": cfg.train.gn_iterations,
           "wall_s": round(wall, 1), "final_loss": res.final_aux.get("loss"),
           **{k: float(v) for k, v in m.items()}}
    for k in extra:
        row[k] = float(res.history[k][-1]) if k in res.history else None
    print(json.dumps(row), flush=True)
    return row, res


def _quality(hard):
    """The ROUND-4 quality budgets (Adam-10k + L-BFGS-10k, no GN) under
    either BC treatment — pinned explicitly because the shipped quality
    preset was re-tuned to hard-BC 5k+5k+GN-10 from this study's own
    measurements (66.6 s / 1.23e-3 candidate C, /tmp probe merged into
    MEASUREMENTS.md); this harness keeps reproducing the pre-retune arms."""
    cfg = hv.helmholtz2d_quality()
    return dataclasses.replace(
        cfg, hard_bc=hard,
        train=dataclasses.replace(cfg.train, iterations=10000,
                                  lbfgs_iterations=10000, gn_iterations=0))


def _precision(k=9.0, elems=4):
    cfg = hv.helmholtz2d_precision()
    train = cfg.train
    if elems > 4:
        # whole-J vmap OOMs past the preset mesh (E=8: 1981 simultaneous
        # passes -> 22.5 G HBM measured); chunk the dense QR build
        train = dataclasses.replace(train, gn_jac_chunk=256)
    return dataclasses.replace(cfg, k=k, n_elements_x=elems,
                               n_elements_y=elems, train=train)


def arm_lad9():
    _run("quality-soft k9", _quality(False))
    _run("quality-hard k9", _quality(True))
    _run("precision k9", _precision())


def arm_kfix():
    for k in (18.0, 27.0, 36.0):
        _run(f"precision-fixed k{int(k)}", _precision(k=k))


def _quality_k(k, elems):
    """The retuned quality recipe (hard-BC 5k+5k + 10-step LM) with the LM
    on the matrix-free LSQR kernel: the dense QR path's whole-J vmap needs
    22.5 GB at E=8 — lsqr is the documented f32-stable matrix-free twin and
    never forms J."""
    cfg = hv.helmholtz2d_quality()
    return dataclasses.replace(
        cfg, k=k, n_elements_x=elems, n_elements_y=elems,
        train=dataclasses.replace(cfg.train, gn_solve="lsqr",
                                  gn_cg_maxiter=800))


def arm_kfixq():
    """Pollution at fixed hp, quality recipe (the cheap same-recipe twin of
    kfix — k = 9 at E = 4 is the shipped preset itself)."""
    for k in (9.0, 18.0, 27.0, 36.0):
        _run(f"quality-fixed k{int(k)}", _quality_k(k, 4))


def arm_khp():
    """The hp answer: E grown to hold waves-per-element constant
    (E = 4k/9 per axis), recipe otherwise fixed."""
    for k, e in ((18.0, 8), (27.0, 12), (36.0, 16)):
        _run(f"quality-hp k{int(k)} E{e}", _quality_k(k, e))


def arm_ident():
    from hpvpinns_tpu.problems.helmholtz import closed_form_k_sq

    # soft-BC + round-4 budgets pinned (the measured 1.6e-6 row ran this
    # way; hard-BC identification is a documented negative on AdvDiff and
    # the retuned quality preset is now hard-BC)
    base = dataclasses.replace(hv.helmholtz2d_quality(), hard_bc=False)
    cfg = dataclasses.replace(
        base, inverse=True,
        train=dataclasses.replace(base.train, iterations=10000,
                                  lbfgs_iterations=10000,
                                  gn_iterations=30, gn_solve="qr"),
    )
    prob = hv.build(cfg)
    t0 = time.perf_counter()
    res = hv.train(prob, verbose=False)
    wall = time.perf_counter() - t0
    k_sq_true = prob.extras["k_sq_true"]
    k_hat = float(res.params["pde"]["k_sq"])
    cf = closed_form_k_sq(prob, res.params)
    m = hv.evaluate_problem(prob, res.eval_params)
    print(json.dumps({
        "arm": "trainable-k2 k9", "k_sq_true": k_sq_true,
        "k_sq_hat": k_hat, "rel_err": abs(k_hat - k_sq_true) / k_sq_true,
        "closed_form_k_sq": cf,
        "closed_form_rel_err": abs(cf - k_sq_true) / k_sq_true,
        "field_rel_l2": float(m["rel_l2"]), "wall_s": round(wall, 1),
        "n_sensors": cfg.n_sensors,
    }), flush=True)


ARMS = {"lad9": arm_lad9, "kfix": arm_kfix, "kfixq": arm_kfixq,
        "khp": arm_khp, "ident": arm_ident}


def main():
    for arm in os.environ.get("ARMS", "lad9,kfix,khp,ident").split(","):
        ARMS[arm.strip()]()


if __name__ == "__main__":
    main()
