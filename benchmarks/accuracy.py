"""Accuracy harness: run the reference configurations of record (and the
extended hp/L-BFGS variants) end to end and record quality metrics.

Writes benchmarks/ACCURACY.json: per-config rel-L2, max error, final losses,
recovered epsilon, wall time, steps/s.  This is the measured counterpart of
BASELINE.md's configs-of-record table (the reference publishes no numbers;
these are the numbers a reference user gets when they switch).

Run: python benchmarks/accuracy.py [--quick]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import hpvpinns_tpu as hv
from hpvpinns_tpu.config import replace


_ONLY = None  # --only substring filter; run() returns None for skipped rows


def run(name, cfg, extra=(), build_fn=None):
    if _ONLY and not any(s in name for s in _ONLY):
        return None
    prob = (build_fn or hv.build)(cfg)
    t0 = time.perf_counter()
    res = hv.train(prob, verbose=False)
    wall = time.perf_counter() - t0
    rec = {
        "config": name,
        "dtype": cfg.dtype,
        "iterations": res.iterations_run,
        "wall_s": round(wall, 2),
        # steps_per_sec is the trainer's WINDOWED rate (pure step time);
        # wall_s includes compilation and the GN phase, so iterations/wall_s
        # can sit far below it — both are recorded so every row reconciles.
        "steps_per_sec": round(res.steps_per_sec, 1),
        "steps_per_sec_wall": round(res.iterations_run / max(wall, 1e-9), 1),
        "final_loss": res.final_aux.get("loss"),
        **hv.evaluate_problem(prob, res.params),
    }
    if "epsilon" in res.final_aux:
        rec["epsilon"] = float(prob.extras["eps_domain_mean"](res.eval_params))
        rec["epsilon_true"] = prob.extras["eps_true"]
        rec["epsilon_rel_err"] = abs(rec["epsilon"] - rec["epsilon_true"]) / rec["epsilon_true"]
    if "velocity" in res.final_aux:
        vdm = prob.extras.get("vel_domain_mean")
        rec["velocity"] = (
            float(vdm(res.eval_params)) if vdm else float(res.final_aux["velocity"])
        )
        rec["velocity_true"] = prob.extras["velocity_true"]
        rec["velocity_rel_err"] = abs(rec["velocity"] - rec["velocity_true"]) / abs(rec["velocity_true"])
        if "vel_coef" in res.eval_params["pde"]:
            import numpy as np

            c = np.asarray(res.eval_params["pde"]["vel_coef"], dtype=float)
            rec["vel_coef"] = c.tolist()
            vfn = prob.extras.get("velocity_fn")
            if vfn is not None:  # field-level error vs the manufactured truth
                xs = np.linspace(*prob.config.domain_x, 2001)
                vh = sum(c[i] * xs**i for i in range(len(c)))
                vt = np.asarray(vfn(xs), dtype=float)
                rec["vel_field_rel_l2"] = float(
                    np.linalg.norm(vh - vt) / np.linalg.norm(vt)
                )
    for key, fn in extra:
        rec[key] = fn(prob, res)
    print(json.dumps(rec), flush=True)
    return rec


def parity_records(q: int):
    """float64 CPU parity rows: the three configs-of-record exactly as the
    reference runs them (float64 throughout, Poisson-1D.py:46-51,116; CPU
    pinned, :105), plus f64 extended rows that show what the same framework
    delivers with an L-BFGS phase at reference-class budgets.

    These are the rows BASELINE.md's 'first measurement step' promises: the
    numbers a reference user gets at the reference's own precision."""
    import jax

    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_platforms", "cpu")

    records = []
    # Poisson-1D config of record, f64 (Poisson-1D.py:231-240).
    cfg = replace(hv.poisson1d_of_record(), dtype="float64")
    cfg = replace(cfg, train=replace(cfg.train, iterations=cfg.train.iterations // q))
    records.append(run("poisson1d_of_record_f64cpu", cfg))

    # Poisson-2D config of record, f64 (Poisson-2D.py:279-288, 10001 iters).
    cfg = replace(hv.poisson2d_of_record(), dtype="float64")
    cfg = replace(cfg, train=replace(cfg.train, iterations=cfg.train.iterations // q, check_every=50))
    records.append(run("poisson2d_of_record_f64cpu", cfg))

    # AdvDiff inverse config of record, f64 (AdvDiff.py:35-53).
    cfg = replace(hv.advdiff_of_record(), dtype="float64")
    cfg = replace(cfg, train=replace(cfg.train, iterations=cfg.train.iterations // q))
    records.append(run("advdiff_of_record_f64cpu", cfg))

    # Extended f64 rows: same problems, quality budgets (MEASUREMENTS.md).
    cfg = replace(
        hv.poisson1d_quality(),
        dtype="float64",
        train=hv.TrainConfig(iterations=3000 // q, lbfgs_iterations=2000 // q, check_every=100),
    )
    records.append(run("poisson1d_quality_f64cpu", cfg))

    cfg = replace(
        hv.advdiff_of_record(),
        dtype="float64",
        train=hv.TrainConfig(
            iterations=5000 // q, lbfgs_iterations=10000 // q, check_every=500,
        ),
    )
    records.append(run("advdiff_lbfgs_f64cpu", cfg))

    # Gauss-Newton/LM third-phase rows (round 3): the second-order residual
    # optimizer that breaks the first-order u~2e-3 plateau
    # (training/gauss_newton.py; measured study in MEASUREMENTS.md).
    pre = hv.poisson1d_precision()  # the shipped GN preset IS the row config
    cfg = replace(
        pre,
        train=replace(
            pre.train,
            iterations=pre.train.iterations // q,
            gn_iterations=max(10, pre.train.gn_iterations // q),
        ),
    )
    records.append(run("poisson1d_gn_f64cpu", cfg))

    pre = hv.advdiff_precision()
    cfg = replace(
        pre,
        train=replace(
            pre.train,
            iterations=pre.train.iterations // q,
            gn_iterations=max(10, pre.train.gn_iterations // q),
        ),
    )
    records.append(run("advdiff_gn_f64cpu", cfg))

    # Joint eps + velocity identification (beyond reference).
    cfg = replace(
        hv.advdiff_of_record(),
        dtype="float64",
        velocity_trainable=True,
        velocity_init=0.5,
        train=hv.TrainConfig(
            iterations=5000 // q, lbfgs_iterations=10000 // q, check_every=500,
        ),
    )
    records.append(run("advdiff_joint_eps_velocity_f64cpu", cfg))

    # Non-polynomial eps(x) FIELD identification: neural field trained
    # jointly, then the two-phase direct linear fit on the frozen solution
    # (inverse.fit_epsilon_field).  Data-rich regime (39 stations x 20
    # readings, lossb_weight 1e3) — the measured configuration where the
    # fit halves the joint plateau (MEASUREMENTS.md).
    import jax.numpy as jnp
    import numpy as np

    from hpvpinns_tpu.inverse import fit_epsilon_field
    from hpvpinns_tpu.problems import advdiff

    eps_fn = lambda x: (0.1 / jnp.pi) * (1.0 + 0.5 * jnp.sin(jnp.pi * x))  # noqa: E731
    vfn = lambda x: 1.0 + 0.0 * x  # noqa: E731
    cfg = hv.AdvDiffConfig(
        dtype="float64", epsilon_model="mlp", epsilon_init=0.1, epsilon_reg=1e-2,
        sensor_stations=tuple(float(s) for s in np.linspace(-0.95, 0.95, 39)),
        n_sensors_per_station=20, lossb_weight=1e3,
        train=hv.TrainConfig(
            iterations=4000 // q, lbfgs_iterations=4000 // q, check_every=500,
        ),
    )
    u_fn, f_fn = advdiff.make_manufactured(cfg, vfn, epsilon=eps_fn, profile="cos")
    prob = advdiff.build(cfg, u_fn=u_fn, f_fn=f_fn, velocity_fn=vfn, epsilon_fn=eps_fn)
    t0 = time.perf_counter()
    res = hv.train(prob, verbose=False)
    wall = time.perf_counter() - t0
    xs = np.linspace(*cfg.domain_x, 513)
    et = np.asarray(eps_fn(xs))
    ej = np.asarray(
        prob.extras["eps_of"](res.eval_params, xs.reshape(-1, 1))
    ).reshape(-1)
    _, eps_hat, info = fit_epsilon_field(prob, res.eval_params, order=6, reg=1e-3)
    ef = np.asarray(eps_hat(xs)).reshape(-1)
    records.append({
        "config": "advdiff_eps_field_twophase_f64cpu",
        "dtype": "float64",
        "iterations": res.iterations_run,
        "wall_s": round(wall, 2),
        # steps_per_sec is the trainer's WINDOWED rate (pure step time);
        # wall_s includes compilation and the GN phase, so iterations/wall_s
        # can sit far below it — both are recorded so every row reconciles.
        "steps_per_sec": round(res.steps_per_sec, 1),
        "steps_per_sec_wall": round(res.iterations_run / max(wall, 1e-9), 1),
        "final_loss": res.final_aux.get("loss"),
        **hv.evaluate_problem(prob, res.params),
        "eps_field_rel_l2_joint": float(np.linalg.norm(ej - et) / np.linalg.norm(et)),
        "eps_field_rel_l2_fit": float(np.linalg.norm(ef - et) / np.linalg.norm(et)),
        "fit_order": 6,
        "fit_reg": 1e-3,
    })

    records.append(als_field_record())
    records.append(reduced_scalar_record())
    records.append(reduced_2d_record())
    records.append(reduced_field_sparse_record())
    records.append(burgers_viscosity_record())
    records.append(reduced_helmholtz_record())
    return records


def reduced_helmholtz_record():
    """Network-free WAVENUMBER identification for the oscillatory family
    (inverse.reduced_identify_helmholtz: scan + Brent over k^2 with the
    exact indefinite spectral solver in the loop) — clean and 1%-noise
    legs plus the GN/CRLB interval, the same route the `identify
    helmholtz2d` CLI runs.  Regenerates the `helmholtz2d_reduced_f64cpu`
    row that round 4 merged by hand (ADVICE round-4 item)."""
    from hpvpinns_tpu import uncertainty as uq
    from hpvpinns_tpu.inverse import reduced_identify_helmholtz

    cfg = hv.Helmholtz2DConfig(dtype="float64", inverse=True)
    prob = hv.build(cfg)
    k_sq_t = prob.extras["k_sq_true"]
    t0 = time.perf_counter()
    k_hat, info = reduced_identify_helmholtz(prob)
    wall_clean = time.perf_counter() - t0

    cfg_n = replace(cfg, sensor_noise_std=1e-2)
    prob_n = hv.build(cfg_n)
    t0 = time.perf_counter()
    k_hat_n, info_n = reduced_identify_helmholtz(prob_n)
    wall_noise = time.perf_counter() - t0
    ci = uq.reduced_helmholtz_ci(prob_n, k_hat_n, noise_std=1e-2)

    return {
        "config": "helmholtz2d_reduced_f64cpu",
        "dtype": "float64",
        "k_sq_true": float(k_sq_t),
        "clean": {
            "k_sq_hat": k_hat,
            "rel_err": abs(k_hat - k_sq_t) / k_sq_t,
            "n_solves": info["n_solves"],
            "n_sensors": info["n_sensors"],
            "wall_s": round(wall_clean, 2),
            "p": info["p"],
            "method": info["method"],
        },
        "noise_1pct": {
            "k_sq_hat": k_hat_n,
            "rel_err": abs(k_hat_n - k_sq_t) / k_sq_t,
            "n_solves": info_n["n_solves"],
            "wall_s": round(wall_noise, 2),
        },
        "noise_1pct_ci95": list(ci["ci95"][0]),
        "noise_1pct_crlb_std": ci["std"][0],
    }


def reduced_field_sparse_record():
    """Differentiable reduced FIELD identification in the sparse-sensor
    regime (inverse.reduced_identify_field): the route that works where ALS
    diverges and the neural field plateaus (MEASUREMENTS.md regime map)."""
    import jax.numpy as jnp
    import numpy as np

    from hpvpinns_tpu.inverse import reduced_identify_field
    from hpvpinns_tpu.problems import advdiff

    eps_fn = lambda x: (0.1 / jnp.pi) * (1.0 + 0.5 * jnp.sin(jnp.pi * x))  # noqa: E731
    vfn = lambda x: 1.0 + 0.0 * x  # noqa: E731
    cfg = hv.AdvDiffConfig(
        dtype="float64",
        sensor_stations=tuple(float(s) for s in np.linspace(-0.95, 0.95, 7)),
        n_sensors_per_station=5,
    )
    u_fn, f_fn = advdiff.make_manufactured(cfg, vfn, epsilon=eps_fn, profile="cos")
    prob = advdiff.build(cfg, u_fn=u_fn, f_fn=f_fn, velocity_fn=vfn, epsilon_fn=eps_fn)
    t0 = time.perf_counter()
    _, ef, info = reduced_identify_field(prob, eps_order=8)
    wall = time.perf_counter() - t0
    xs = np.linspace(*cfg.domain_x, 513)
    et = np.asarray(eps_fn(xs))
    return {
        "config": "advdiff_eps_field_reduced_sparse_f64cpu",
        "dtype": "float64",
        "wall_s": round(wall, 2),
        "n_sensors": 35,
        "eps_field_rel_l2_fit": float(
            np.linalg.norm(np.asarray(ef(xs)) - et) / np.linalg.norm(et)
        ),
        "method": "reduced-field (lbfgsb through differentiable expm; no network)",
    }


def burgers_viscosity_record():
    """Viscosity identification for the nonlinear family
    (inverse.reduced_identify_burgers)."""
    from hpvpinns_tpu.inverse import reduced_identify_burgers

    prob = hv.build(hv.BurgersConfig(dtype="float64"))
    t0 = time.perf_counter()
    nu_hat, info = reduced_identify_burgers(prob)
    wall = time.perf_counter() - t0
    nu_true = prob.config.nu
    return {
        "config": "burgers_viscosity_reduced_f64cpu",
        "dtype": "float64",
        "wall_s": round(wall, 2),
        "nu": nu_hat,
        "nu_true": nu_true,
        "nu_rel_err": abs(nu_hat - nu_true) / nu_true,
        "n_forward_solves": info["n_solves"],
        "method": "reduced (brent over exact nonlinear solves; no network)",
    }


def reduced_2d_record():
    """Reduced identification of all three advdiff2d scalars with the
    tensor-product direct solver in the loop (inverse.reduced_identify2d)."""
    from hpvpinns_tpu.inverse import reduced_identify2d

    prob = hv.build(hv.AdvDiff2DConfig(dtype="float64"))
    t0 = time.perf_counter()
    coef, info = reduced_identify2d(prob, p=12, maxiter=300)
    wall = time.perf_counter() - t0
    et = prob.extras["eps_true"]
    return {
        "config": "advdiff2d_reduced_f64cpu",
        "dtype": "float64",
        "wall_s": round(wall, 2),
        "epsilon_rel_err": abs(float(coef[0]) - et) / et,
        "vx_rel_err": abs(float(coef[1]) - 1.0),
        "vy_rel_err": abs(float(coef[2]) - 0.5) / 0.5,
        "n_forward_solves": info["n_solves"],
        "method": "reduced (nelder-mead over exact tensor solves; no network)",
    }


def reduced_scalar_record():
    """Reduced-formulation scalar identification on the reference's own
    benchmark and sensor layout (inverse.reduced_identify): eps to ~1e-8 in
    ~16 exact forward solves — vs the Adam route's ~2e-2 at record budgets."""
    from hpvpinns_tpu.inverse import reduced_identify

    prob = hv.build(replace(hv.advdiff_of_record(), dtype="float64"))
    t0 = time.perf_counter()
    coef, _, info = reduced_identify(prob)
    wall = time.perf_counter() - t0
    et = prob.extras["eps_true"]
    return {
        "config": "advdiff_reduced_scalar_f64cpu",
        "dtype": "float64",
        "wall_s": round(wall, 2),
        "epsilon": float(coef[0]),
        "epsilon_true": et,
        "epsilon_rel_err": abs(float(coef[0]) - et) / et,
        "n_forward_solves": info["n_solves"],
        "method": "reduced (brent over exact forward solves; no network)",
    }


def als_field_record():
    """Network-free alternating-linear identification (inverse.als_identify)
    on the same truth/sensing as the neural field rows: the clean-dense-data
    champion (measured ~150x below the neural plateau, MEASUREMENTS.md)."""
    import jax.numpy as jnp
    import numpy as np

    from hpvpinns_tpu.inverse import als_identify
    from hpvpinns_tpu.problems import advdiff

    eps_fn = lambda x: (0.1 / jnp.pi) * (1.0 + 0.5 * jnp.sin(jnp.pi * x))  # noqa: E731
    vfn = lambda x: 1.0 + 0.0 * x  # noqa: E731
    cfg = hv.AdvDiffConfig(
        dtype="float64", n_quad=24, n_test_x=14, n_test_t=10,
        sensor_stations=tuple(float(s) for s in np.linspace(-0.95, 0.95, 19)),
        n_sensors_per_station=20,
    )
    u_fn, f_fn = advdiff.make_manufactured(cfg, vfn, epsilon=eps_fn, profile="cos")
    prob = advdiff.build(cfg, u_fn=u_fn, f_fn=f_fn, velocity_fn=vfn, epsilon_fn=eps_fn)
    t0 = time.perf_counter()
    uf, _, ef, _ = als_identify(prob, iters=3)
    wall = time.perf_counter() - t0
    xs = np.linspace(*cfg.domain_x, 513)
    et = np.asarray(eps_fn(xs))
    eh = np.asarray(ef(xs)).reshape(-1)
    u_hat = uf(prob.test_points).reshape(-1)
    u_tr = np.asarray(prob.test_values).reshape(-1)
    return {
        "config": "advdiff_eps_field_als_f64cpu",
        "dtype": "float64",
        "wall_s": round(wall, 2),
        "rel_l2": float(np.linalg.norm(u_hat - u_tr) / np.linalg.norm(u_tr)),
        "eps_field_rel_l2_fit": float(np.linalg.norm(eh - et) / np.linalg.norm(et)),
        "method": "als (no network)",
    }


def precision_records(q):
    """The f32 Gauss-Newton accuracy-frontier rows (`--preset precision`;
    MEASUREMENTS.md round-3 GN sweep: poisson2d 7.3e-5, burgers 1.50e-3,
    poisson3d 1.06e-3, advdiff2d forward 1.86e-3)."""

    def scaled(cfg):
        t = cfg.train
        return replace(
            cfg,
            train=replace(
                t,
                iterations=t.iterations // q,
                lbfgs_iterations=t.lbfgs_iterations // q,
                gn_iterations=max(5, t.gn_iterations // q),
            ),
        )

    return [
        run("poisson2d_precision_f32", scaled(hv.poisson2d_precision())),
        run("burgers_precision_f32", scaled(hv.burgers_precision())),
        run("poisson3d_precision_f32", scaled(hv.poisson3d_precision())),
        run("advdiff2d_precision_f32", scaled(hv.advdiff2d_precision())),
        # the advdiff FORWARD frontier (layer feature + clustered grid + QR
        # LM — `run advdiff --preset precision --forward`, 1.76e-3 measured)
        run("advdiff_forward_precision_f32",
            scaled(hv.advdiff_forward_precision())),
        # the Navier-Stokes SYSTEM frontier (hard-BC lift; stacked rel-L2 5.6e-5
        # measured — `run kovasznay --preset precision`)
        run("kovasznay_precision_f32", scaled(hv.kovasznay_precision())),
        # the UNSTEADY NS frontier (space-time hard-BC lift + direct-grad-p
        # form 0 + zero-mean pressure-gauge penalty; stacked rel-L2 2.09e-4
        # measured — `run taylorgreen --preset precision`)
        run("taylorgreen_precision_f32", scaled(hv.taylorgreen_precision())),
        # the oscillatory/indefinite frontier (hard-BC Coons lift of the
        # boundary trace + QR LM — `run helmholtz2d --preset precision`)
        run("helmholtz2d_precision_f32", scaled(hv.helmholtz2d_precision())),
    ]


def hybrid_records(q, families=None):
    """Hybrid precision-pipeline rows (MEASUREMENTS.md "Hybrid precision
    pipeline"): train each precision preset in f32 on the device as usual,
    then polish the trained parameters with the host-f64 LM subprocess
    (training/hybrid.polish_f64, the `--polish-f64` CLI path) and record
    the f32 / f64-eval / f64-polished / f32-castback ladder per family.
    The castback row ("rel_l2") is what the serving path keeps.  Training
    budget as `--precision`, plus several hours of host polish at full
    budget."""
    import subprocess

    from hpvpinns_tpu.training.hybrid import polish_f64

    # (family, preset, polish iters, polish solve kernel, kernel kwargs).
    # "normal" is gauss_newton's own f64 auto rule and matches the measured
    # round-4 rows; poisson3d ships the matrix-free CG kernel instead for the
    # same reason its chip preset does (config.poisson3d_precision: the dense
    # Jacobian build is the 17-min/OOM-class wall, CG reproduces the dense
    # record at 10.8x less GN wall — MEASUREMENTS.md "matrix-free LM").
    fams = [
        ("poisson2d", hv.poisson2d_precision, 25, "normal", {}),
        ("kovasznay", hv.kovasznay_precision, 50, "normal", {}),
        ("burgers", hv.burgers_precision, 40, "normal", {}),
        # taylorgreen ships the matrix-free CG kernel for the same reason
        # poisson3d does: the dense f64 J build (11.7k x 5.4k through the
        # space-time NS assembly) blew the 3 h polish timeout TWICE in
        # round 5; cg at 400 inner iters measured ~80 s per accepted step
        # (2-step probe, /tmp leftover params: loss -> 4.7e-9, rel-L2 flat
        # at 2.0e-4 — the objective-limited signature).
        ("taylorgreen", hv.taylorgreen_precision, 15, "cg",
         {"cg_tol": 1e-4, "cg_maxiter": 400}),
        ("advdiff_fwd", hv.advdiff_forward_precision, 50, "normal", {}),
        ("poisson3d", hv.poisson3d_precision, 30, "cg",
         {"cg_tol": 1e-4, "cg_maxiter": 2000}),
        ("helmholtz2d", hv.helmholtz2d_precision, 30, "normal", {}),
    ]
    if families:
        unknown = set(families) - {f for f, *_ in fams}
        if unknown:
            raise SystemExit(f"unknown hybrid families: {sorted(unknown)}")
        fams = [row for row in fams if row[0] in families]
    records = []
    for fam, factory, polish_iters, solve, solve_kw in fams:
        cfg = factory()
        t = cfg.train
        cfg = replace(cfg, train=replace(
            t, iterations=t.iterations // q,
            lbfgs_iterations=t.lbfgs_iterations // q,
            gn_iterations=max(5, t.gn_iterations // q)))
        prob = hv.build(cfg)
        t0 = time.perf_counter()
        res = hv.train(prob, verbose=False)
        chip_wall = time.perf_counter() - t0
        chip = hv.evaluate_problem(prob, res.eval_params)
        try:
            pr = polish_f64(cfg, res.eval_params,
                            iterations=max(5, polish_iters // q),
                            solve=solve, jac_chunk=128, timeout=10800,
                            **solve_kw)
        except (RuntimeError, subprocess.TimeoutExpired) as e:
            # One family's polish blowing its 3 h budget must not lose the
            # remaining families' rows; record the failure and move on.
            print(json.dumps({"config": f"{fam}_hybrid_polish",
                              "error": str(e)[:500]}), file=sys.stderr,
                  flush=True)
            continue
        cast = hv.evaluate_problem(prob, pr.params)
        rec = {
            "config": f"{fam}_hybrid_polish",
            "dtype": "float32-chip + float64-host-polish",
            "chip_wall_s": round(chip_wall, 1),
            "polish_solve": solve,
            "polish_iters": pr.accepted,
            "polish_wall_s": round(pr.wall_s, 1),
            "chip_rel_l2": float(chip["rel_l2"]),
            "f64_eval_rel_l2": float(pr.metrics_start["rel_l2"]),
            "f64_polished_rel_l2": float(pr.metrics["rel_l2"]),
            # castback = the number a user keeps after `--polish-f64`
            "rel_l2": float(cast["rel_l2"]),
            "max_abs_err": float(cast["max_abs_err"]),
        }
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


def merge_into(out_path: str, records):
    """Merge rows into ACCURACY.json by config name (parity rows coexist
    with the f32 rows)."""
    existing = []
    if os.path.exists(out_path):
        with open(out_path) as f:
            existing = json.load(f)
    by_name = {r["config"]: r for r in existing}
    for r in records:
        if r is None:  # row skipped by the --only filter
            continue
        by_name[r["config"]] = r
    merged = list(by_name.values())
    with open(out_path, "w") as f:
        json.dump(merged, f, indent=1)
    return merged


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="1/10 iteration budgets")
    ap.add_argument(
        "--parity", action="store_true",
        help="run ONLY the float64-CPU configs-of-record parity set and merge "
        "the rows into ACCURACY.json",
    )
    ap.add_argument(
        "--precision", action="store_true",
        help="run ONLY the f32 Gauss-Newton precision-preset rows "
        "and merge them into ACCURACY.json",
    )
    ap.add_argument(
        "--hybrid", action="store_true",
        help="run ONLY the hybrid f32-train + host-f64-polish rows "
        "(training budget as --precision, plus hours of host polish) "
        "and merge them into ACCURACY.json",
    )
    ap.add_argument(
        "--families", default=None,
        help="comma-separated family filter for --hybrid (e.g. "
        "'taylorgreen,poisson3d'); default = all seven",
    )
    ap.add_argument(
        "--only", default=None,
        help="comma-separated substring filter on row names for the "
        "default and --precision tiers (e.g. 'helmholtz2d_quality'): "
        "non-matching rows are skipped, so a single re-measured row stays "
        "regenerable without re-running the whole tier",
    )
    ap.add_argument("--out", default=os.path.join(os.path.dirname(__file__), "ACCURACY.json"))
    args = ap.parse_args()
    if args.only:
        global _ONLY
        _ONLY = tuple(s.strip() for s in args.only.split(",") if s.strip())
    q = 10 if args.quick else 1

    from hpvpinns_tpu.cli import _enable_compile_cache

    _enable_compile_cache()

    if args.parity:
        records = parity_records(q)
        merge_into(args.out, records)
        print(f"merged {len(records)} parity rows into {args.out}", file=sys.stderr)
        return

    if args.precision:
        records = precision_records(q)
        merge_into(args.out, records)
        print(f"merged {len(records)} precision rows into {args.out}", file=sys.stderr)
        return

    if args.hybrid:
        fam_filter = (set(args.families.split(",")) if args.families else None)
        records = hybrid_records(q, families=fam_filter)
        merge_into(args.out, records)
        print(f"merged {len(records)} hybrid rows into {args.out}", file=sys.stderr)
        return

    records = []
    # 1. Poisson-1D config of record (Poisson-1D.py:231-240).
    cfg = hv.poisson1d_of_record()
    cfg = replace(cfg, train=replace(cfg.train, iterations=cfg.train.iterations // q))
    records.append(run("poisson1d_of_record", cfg))

    # 2. Poisson-1D hp (the reference's 3-element special grid) + L-BFGS.
    records.append(
        run(
            "poisson1d_hp3_lbfgs",
            hv.Poisson1DConfig(
                grid=(-1.0, -0.1, 0.1, 1.0), n_quad=60, n_test=40,
                train=hv.TrainConfig(
                    iterations=4000 // q, lbfgs_iterations=3000 // q, check_every=100
                ),
            ),
        )
    )

    # 3. Poisson-1D hp 4 uniform subdomains (BASELINE.json config 2).
    records.append(
        run(
            "poisson1d_hp4",
            hv.Poisson1DConfig(
                n_elements=4, n_quad=60, n_test=30,
                train=hv.TrainConfig(
                    iterations=4000 // q, lbfgs_iterations=3000 // q, check_every=100
                ),
            ),
        )
    )

    # 4. Poisson-2D config of record (Poisson-2D.py:279-288, 10001 iters).
    cfg = hv.poisson2d_of_record()
    cfg = replace(cfg, train=replace(cfg.train, iterations=cfg.train.iterations // q, check_every=50))
    records.append(run("poisson2d_of_record", cfg))

    # 5. Poisson-2D extended: +L-BFGS phase.
    cfg = hv.poisson2d_of_record()
    cfg = replace(
        cfg,
        train=hv.TrainConfig(iterations=10000 // q, lbfgs_iterations=5000 // q, check_every=100),
    )
    records.append(run("poisson2d_lbfgs", cfg))

    # 6. AdvDiff inverse config of record (AdvDiff.py:35-53).
    cfg = hv.advdiff_of_record()
    cfg = replace(cfg, train=replace(cfg.train, iterations=cfg.train.iterations // q))
    records.append(run("advdiff_of_record", cfg))

    # 7. AdvDiff inverse, extended budget.
    cfg = hv.advdiff_of_record()
    cfg = replace(cfg, train=hv.TrainConfig(iterations=15000 // q, check_every=100, best_snapshot_fraction=0.9))
    records.append(run("advdiff_extended", cfg))

    # 8. AdvDiff inverse + L-BFGS: epsilon to ~2% of truth (f64-CPU measured
    # eps=0.03259 vs 0.03183).
    cfg = hv.advdiff_of_record()
    cfg = replace(
        cfg,
        train=hv.TrainConfig(iterations=5000 // q, lbfgs_iterations=10000 // q, check_every=500),
    )
    records.append(run("advdiff_lbfgs", cfg))

    # 9. Poisson-2D quality config (north-star chase): deep net + L-BFGS.
    records.append(
        run(
            "poisson2d_quality",
            hv.Poisson2DConfig(
                layers=(2, 48, 48, 48, 48, 1), n_test_x=10, n_test_y=10, n_quad=16,
                train=hv.TrainConfig(
                    iterations=10000 // q, lbfgs_iterations=20000 // q, check_every=1000
                ),
            ),
        )
    )

    # 10. Poisson-3D (beyond reference): volumetric hp-VPINN.
    records.append(
        run(
            "poisson3d",
            hv.Poisson3DConfig(
                train=hv.TrainConfig(
                    iterations=3000 // q, lbfgs_iterations=2000 // q, check_every=500
                ),
            ),
        )
    )

    # 11. Poisson-2D quality preset + hard-BC lifting (the flagship rows).
    records.append(run("poisson2d_quality_hardbc", hv.poisson2d_quality(hard_bc=True)))

    # 12. AdvDiff inverse, hard-BC lifted space-time ansatz (f32:
    # eps to ~4.5%, beating the ~10% soft-BC plateau — MEASUREMENTS.md).
    cfg = hv.AdvDiffConfig(
        hard_bc=True,
        train=hv.TrainConfig(iterations=15000 // q, lbfgs_iterations=15000 // q, check_every=500),
    )
    records.append(run("advdiff_hardbc_f32", cfg))

    # 12b. AdvDiff inverse with 7 spatial sensor stations: the measured
    # identifiability lever (MEASUREMENTS.md) — eps to 1.5-3.9% in f32.
    cfg = hv.AdvDiffConfig(
        sensor_stations=(-0.75, -0.5, -0.25, 0.0, 0.25, 0.5, 0.75),
        train=hv.TrainConfig(iterations=15000 // q, lbfgs_iterations=15000 // q, check_every=500),
    )
    records.append(run("advdiff_7stations_f32", cfg))

    # 12c. Spatially-varying advection identification (beyond reference):
    # manufactured forcing with true V(x) = 1 + 0.3 x, trainable linear field
    # jointly with eps.  The forced problem is far better conditioned than the
    # homogeneous benchmark: f32 reaches sub-% coefficients
    # (MEASUREMENTS.md).
    from hpvpinns_tpu.problems import advdiff as _advdiff

    _v_true = lambda x: 1.0 + 0.3 * x  # noqa: E731
    cfg = hv.AdvDiffConfig(
        velocity_trainable=True, velocity_model="linear", velocity_init=0.5,
        var_form=1,
        sensor_stations=(-0.75, -0.5, -0.25, 0.0, 0.25, 0.5, 0.75),
        train=hv.TrainConfig(
            iterations=3000 // q, lbfgs_iterations=3000 // q, check_every=500
        ),
    )

    def _build_manufactured(c):
        u_fn, f_fn = _advdiff.make_manufactured(c, _v_true)
        return _advdiff.build(c, u_fn=u_fn, f_fn=f_fn, velocity_fn=_v_true)

    records.append(
        run("advdiff_velocity_field_f32", cfg, build_fn=_build_manufactured)
    )

    # 13/14. Viscous Burgers nu = 0.01/pi (nonlinear, beyond reference):
    # default uniform grid vs the front-clustered hp quality preset.
    cfg = hv.BurgersConfig()
    cfg = replace(cfg, train=replace(cfg.train, iterations=cfg.train.iterations // q))
    records.append(run("burgers_default_f32", cfg))
    cfg = hv.burgers_quality()
    cfg = replace(
        cfg,
        train=replace(
            cfg.train,
            iterations=cfg.train.iterations // q,
            lbfgs_iterations=cfg.train.lbfgs_iterations // q,
        ),
    )
    records.append(run("burgers_quality_f32", cfg))

    # 15. Helmholtz k = 9 (oscillatory/indefinite, beyond reference): the
    # homogeneous plane-wave benchmark driven only by its Dirichlet trace.
    cfg = hv.helmholtz2d_quality()
    cfg = replace(
        cfg,
        train=replace(
            cfg.train,
            iterations=cfg.train.iterations // q,
            lbfgs_iterations=cfg.train.lbfgs_iterations // q,
        ),
    )
    records.append(run("helmholtz2d_quality_f32", cfg))

    merge_into(args.out, records)
    print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
