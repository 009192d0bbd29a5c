"""Smoke run of the hp-VPINN trainer on the GPU.

Drives the main path once through the entry points a user calls
(`hv.build -> hv.train`, the Gauss-Newton phase, the ensemble step, the CLI
`run ... --export` and `serve --check`) at the widths the repo ships, and
holds every computation to the plain reference: the same loss and gradients
at the same parameters, evaluated on the CPU in float64 in this process.

    python chip_smoke.py          # one GPU: every phase below
    python chip_smoke.py --four   # only the element-sharded path, 4 GPUs

It exits non-zero, printing no result, when JAX's default device is not a
GPU or when any phase fails.  Earlier lines give the card's name and power
limit, each phase's result and its tolerance; the last line of standard
output is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

# Tolerances.  A float32 step at matmul precision "highest" agrees with the
# float64 reference to ~1e-7 relative in the loss and ~1e-6 in the gradient
# (measured on the CPU); TF32 matmuls would miss by ~1e-3.
LOSS_RTOL = 1e-5  # f32 loss vs f64 reference, relative
GRAD_RTOL = 1e-4  # f32 gradient vs f64 reference, relative 2-norm
ENGINE_RTOL = 1e-5  # taylor vs jvp derivative engines, both f32 on the GPU
F64_RTOL = 1e-10  # f64 on the GPU vs f64 on the CPU (summation order only)
SERVE_RTOL = 1e-5  # served artifact vs problem.apply, relative 2-norm
HIGHEST_DOT_RTOL = 1e-5  # "highest" f32 dot vs f64, relative 2-norm
SHARD_RTOL = 1e-5  # sharded vs one-device Adam/shard_map step, relative 2-norm
SHARD_GN_RTOL = 1e-8  # sharded vs one-device converged-CG LM steps, float64


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"FAILED: {msg}")


def rel_err(a, b) -> float:
    """||a - b|| / ||b|| over all leaves of two pytrees (or two arrays)."""
    import jax

    fa = np.concatenate([np.ravel(np.asarray(x, np.float64)) for x in jax.tree.leaves(a)])
    fb = np.concatenate([np.ravel(np.asarray(x, np.float64)) for x in jax.tree.leaves(b)])
    return float(np.linalg.norm(fa - fb) / max(np.linalg.norm(fb), 1e-300))


def loss_and_grad(prob, params):
    import jax

    (loss, _), grad = jax.jit(jax.value_and_grad(prob.loss_fn, has_aux=True))(
        params, prob.data
    )
    return float(loss), grad


def f64_reference(cfg, params):
    """Loss and gradient of `cfg`'s problem at `params`, evaluated on the CPU
    in float64: the plain reference every device computation is held to."""
    import jax

    import hpvpinns_tpu as hv

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        prob = hv.build(dataclasses.replace(cfg, dtype="float64"))
        p64 = jax.tree.map(lambda a: jax.device_put(np.asarray(a, np.float64), cpu), params)
        return loss_and_grad(prob, p64)


def compare_to_reference(name: str, prob, params) -> None:
    """Device loss/gradient at `params` vs the CPU float64 reference."""
    loss, grad = loss_and_grad(prob, params)
    loss64, grad64 = f64_reference(prob.config, params)
    e_loss = abs(loss - loss64) / abs(loss64)
    e_grad = rel_err(grad, grad64)
    log(f"  {name}: loss {loss:.9e} vs f64 {loss64:.9e}: rel {e_loss:.2e} "
        f"(tol {LOSS_RTOL:g}); grad rel {e_grad:.2e} (tol {GRAD_RTOL:g})")
    check(np.isfinite(loss) and e_loss <= LOSS_RTOL, f"{name} loss vs f64 reference")
    check(e_grad <= GRAD_RTOL, f"{name} gradient vs f64 reference")


def compare_engines(name: str, prob, params) -> None:
    """taylor vs jvp derivative engines at the same parameters, on the device."""
    import hpvpinns_tpu as hv

    other = hv.build(dataclasses.replace(prob.config, deriv_mode="jvp"))
    lt, gt = loss_and_grad(prob, params)
    lj, gj = loss_and_grad(other, params)
    e_loss, e_grad = abs(lt - lj) / abs(lj), rel_err(gt, gj)
    log(f"  {name}: taylor vs jvp loss rel {e_loss:.2e}, grad rel {e_grad:.2e} "
        f"(tol {ENGINE_RTOL:g})")
    check(e_loss <= ENGINE_RTOL and e_grad <= ENGINE_RTOL, f"{name} taylor vs jvp")


def memory_line(compiled) -> str:
    m = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes", "alias_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return ", ".join(f"{f.replace('_size_in_bytes', '')} {getattr(m, f)}" for f in fields)


def final_line(devices) -> str:
    """The result line: the device as JAX reports it."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices)}})


def require_gpu():
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX's default device is "
                         f"{devices[0].platform!r}")
    from hpvpinns_tpu.utils.profiling import gpu_card

    log(f"card: {gpu_card()}")
    log(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}")
    return devices


def run_cli(argv) -> list:
    """hpvpinns_tpu.cli.main(argv) in this process; returns its JSON lines."""
    from hpvpinns_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    check(rc == 0, f"cli {' '.join(argv)} returned {rc}:\n{out[-2000:]}")
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


# --------------------------------------------------------------------- phases


def phase_matmul_precision():
    """One 256-wide f32 dot at each lax.Precision against numpy float64."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    a = rng.standard_normal((4096, 256)).astype(np.float32)
    b = rng.standard_normal((256, 256)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    errs = {}
    for prec in ("default", "high", "highest"):
        f = jax.jit(lambda x, y, p=prec: jnp.dot(x, y, precision=jax.lax.Precision(p)))
        errs[prec] = rel_err(f(a, b), want)
    log("  f32 dot [4096,256]x[256,256] vs f64: " + ", ".join(
        f"{k} rel {v:.2e}" for k, v in errs.items()) + f" (highest tol {HIGHEST_DOT_RTOL:g})")
    check(errs["highest"] <= HIGHEST_DOT_RTOL, "'highest' f32 dot is not FP32-accurate")


def phase_bench_scale():
    """hv.build -> hv.train on the bench problem: Adam chunks then L-BFGS."""
    import jax

    import hpvpinns_tpu as hv
    from hpvpinns_tpu.training.trainer import _build_chunk, make_optimizer

    prob = hv.build(hv.poisson2d_scaled(n_elem_axis=8, n_quad=16, n_test=10))
    params0 = prob.init_params(jax.random.key(0))
    compare_to_reference("bench-scale init", prob, params0)
    compare_engines("bench-scale init", prob, params0)

    opt = make_optimizer(prob.config.train)
    compiled = _build_chunk(prob.loss_fn, opt, 10).lower(
        params0, opt.init(params0), prob.data).compile()
    log(f"  bench-scale 10-step chunk memory: {memory_line(compiled)}")

    cfg = hv.TrainConfig(iterations=30, check_every=10, lbfgs_iterations=10)
    loss0 = float(prob.loss_fn(params0, prob.data)[0])
    res = hv.train(prob, cfg, verbose=False)
    hist = res.history["loss"]
    log(f"  trained {res.iterations_run} steps (30 Adam + 10 L-BFGS): loss "
        f"{loss0:.4e} -> {hist[-1]:.4e}")
    check(res.iterations_run == 40 and np.all(np.isfinite(hist)), "bench-scale training")
    check(hist[-1] < loss0, "bench-scale loss did not decrease")
    compare_to_reference("bench-scale trained", prob, res.params)
    return prob, res.params


def phase_serving(prob, params):
    """save_model/load_model round trip; the artifact predicts on the GPU."""
    import jax

    import hpvpinns_tpu as hv

    X = np.asarray(prob.test_points, np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        meta = hv.save_model(os.path.join(tmp, "art"), prob, params)
        model = hv.load_model(os.path.join(tmp, "art"))
        served = model.predict(X)
    live = np.asarray(jax.jit(prob.apply)(params, X))
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        p64 = jax.tree.map(lambda a: jax.device_put(np.asarray(a, np.float64), cpu), params)
        ref = np.asarray(prob.apply(p64, X.astype(np.float64)))
    e_live, e_ref = rel_err(served, live), rel_err(served, ref)
    log(f"  artifact {meta['platforms']} on {len(X)} points: vs GPU apply rel "
        f"{e_live:.2e}, vs CPU f64 apply rel {e_ref:.2e} (tol {SERVE_RTOL:g})")
    check("cuda" in meta["platforms"], "artifact lacks the cuda platform")
    check(e_live <= SERVE_RTOL and e_ref <= SERVE_RTOL, "served predictions")


def phase_quality_cli():
    """`run poisson2d --preset quality --export DIR`, then `serve DIR --check`."""
    with tempfile.TemporaryDirectory() as tmp:
        art = os.path.join(tmp, "quality")
        lines = run_cli(["run", "poisson2d", "--preset", "quality", "--iterations", "200",
                         "--lbfgs-iterations", "50", "--quiet", "--export", art])
        summary = next(d for d in lines if "rel_l2" in d)
        check(np.isfinite(summary["rel_l2"]), "quality run rel_l2")
        served = run_cli(["serve", art, "--check"])[-1]
    log(f"  quality preset (2,48x4,1), 200 Adam + 50 L-BFGS: rel_l2 "
        f"{summary['rel_l2']:.4e}; serve --check on {served['platforms']}: rel_l2 "
        f"{served['rel_l2']:.4e}")
    check(np.isfinite(served["rel_l2"]), "serve --check rel_l2")
    check(abs(served["rel_l2"] - summary["rel_l2"]) <= 1e-3 * summary["rel_l2"],
          "served rel_l2 differs from the trained model's")


def phase_precision_gn():
    """poisson2d_precision (hard-BC): two accepted LM steps per kernel."""
    import hpvpinns_tpu as hv

    prob = hv.build(hv.poisson2d_precision())
    warm = hv.train(prob, hv.TrainConfig(iterations=200, check_every=100), verbose=False)
    start = float(prob.loss_fn(warm.params, prob.data)[0])
    for solve in ("host", "qr", "cg"):
        gn = hv.gauss_newton(prob, warm.params, iterations=2, solve=solve, verbose=False)
        end = gn.final_aux["loss"]
        log(f"  LM '{solve}': {gn.accepted} accepted of {gn.iterations_run} tried, "
            f"loss {start:.4e} -> {end:.4e} ({gn.stopped})")
        check(gn.accepted == 2 and end < start, f"LM '{solve}' did not take 2 accepted steps")
        compare_to_reference(f"after LM '{solve}'", prob, gn.params)


def phase_f64_device():
    """poisson1d_precision in float64 on the GPU: Adam then 2 LM steps."""
    import jax

    import hpvpinns_tpu as hv

    cfg = hv.poisson1d_precision()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, iterations=50, check_every=10, gn_iterations=2))
    prob = hv.build(cfg)
    res = hv.train(prob, verbose=False)
    leaf = jax.tree.leaves(res.params)[0]
    platform = next(iter(leaf.devices())).platform
    check(leaf.dtype == np.float64 and platform == "gpu",
          f"f64 parameters are {leaf.dtype} on {platform}")
    loss, grad = loss_and_grad(prob, res.params)
    loss64, grad64 = f64_reference(prob.config, res.params)
    e_loss, e_grad = abs(loss - loss64) / abs(loss64), rel_err(grad, grad64)
    log(f"  poisson1d precision f64 on {platform}: {res.iterations_run} steps, loss "
        f"{loss:.15e} vs CPU {loss64:.15e}: rel {e_loss:.2e}, grad rel {e_grad:.2e} "
        f"(tol {F64_RTOL:g})")
    check(e_loss <= F64_RTOL and e_grad <= F64_RTOL, "f64 GPU vs f64 CPU")
    lines = run_cli(["run", "poisson1d", "--preset", "precision", "--iterations", "50",
                     "--gn-iterations", "2", "--quiet"])
    summary = next(d for d in lines if "rel_l2" in d)
    log(f"  cli run poisson1d --preset precision (f64): rel_l2 {summary['rel_l2']:.4e}")
    check(np.isfinite(summary["rel_l2"]), "f64 CLI run")


def phase_wide_point():
    """W=256, depth 3, S=4 ensemble chunk (bench.measure_wide_point shapes)."""
    import jax

    import bench
    import hpvpinns_tpu as hv
    from hpvpinns_tpu.training.ensemble import _build_ens_chunk, init_ensemble
    from hpvpinns_tpu.training.trainer import make_optimizer

    prob = bench.wide_point_problem(width=256, depth=3)
    stack = init_ensemble(prob, range(4))
    member0 = jax.tree.map(lambda a: a[0], stack)
    compare_to_reference("wide W=256 init", prob, member0)
    compare_engines("wide W=256 init", prob, member0)

    opt = make_optimizer(hv.TrainConfig())
    state = opt.init(stack)
    chunk = _build_ens_chunk(prob.loss_fn, opt, 5)
    log(f"  wide 5-step S=4 chunk memory: "
        f"{memory_line(chunk.lower(stack, state, prob.data).compile())}")
    stack, state, aux = chunk(stack, state, prob.data)
    losses = np.asarray(aux["loss"])
    log(f"  wide S=4 chunk: losses {np.array2string(losses, precision=4)}")
    check(losses.shape == (4,) and np.all(np.isfinite(losses)), "wide-point chunk")


def phase_four(devices):
    """The element-sharded path on a 4-device element_mesh at bench scale,
    each step compared with the same work on one device."""
    import jax
    import optax

    import hpvpinns_tpu as hv
    from hpvpinns_tpu.parallel.sharding import (
        element_mesh, replicate, shard_map_loss, shard_problem,
    )

    check(len(devices) >= 4, f"--four needs 4 devices, found {len(devices)}")
    mesh = element_mesh(devices[:4])
    prob = hv.build(hv.poisson2d_scaled(n_elem_axis=8, n_quad=16, n_test=10))
    data = shard_problem(prob.data, mesh)
    shards = data["elements"].x.addressable_shards
    per_device = sorted((s.device.id, s.data.shape[0]) for s in shards)
    log(f"  element shards (device id, elements): {per_device}")
    check(len({d for d, _ in per_device}) == 4 and all(n == 16 for _, n in per_device),
          "elements are not spread 16 per device")

    cfg = hv.TrainConfig(iterations=20, check_every=10)
    one = hv.train(prob, cfg, verbose=False)
    four = hv.train(prob, cfg, mesh=mesh, verbose=False)
    e_loss = abs(four.final_aux["loss"] - one.final_aux["loss"]) / one.final_aux["loss"]
    e_par = rel_err(four.params, one.params)
    log(f"  GSPMD hv.train 20 steps: loss {four.final_aux['loss']:.9e} vs one device "
        f"{one.final_aux['loss']:.9e}: rel {e_loss:.2e}, params rel {e_par:.2e} "
        f"(tol {SHARD_RTOL:g})")
    check(e_loss <= SHARD_RTOL and e_par <= SHARD_RTOL, "GSPMD vs one device")

    opt = optax.flatten(optax.adam(1e-3))

    def step(loss_fn):
        def train_step(params, opt_state, data):
            (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, data)
            updates, opt_state = opt.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), loss

        return jax.jit(train_step)

    params = prob.init_params(jax.random.key(0))
    p_one, l_one = step(prob.loss_fn)(params, opt.init(params), prob.data)
    rp = replicate(params, mesh)
    p_sm, l_sm = step(shard_map_loss(prob.loss_fn, data, mesh))(rp, replicate(opt.init(params), mesh), data)
    e_loss = abs(float(l_sm) - float(l_one)) / float(l_one)
    e_par = rel_err(p_sm, p_one)
    log(f"  shard_map step: loss rel {e_loss:.2e}, params rel {e_par:.2e} (tol {SHARD_RTOL:g})")
    check(e_loss <= SHARD_RTOL and e_par <= SHARD_RTOL, "shard_map vs one device")

    # The LM leg runs in float64 with the CG solve converged (cg_tol 1e-12):
    # at the default forcing (1e-3) the truncated CG step depends on which
    # iteration the stopping test fires, so sharded and one-device steps
    # differ by ~the forcing (four H100s, f32: parameters 3.2e-3 apart at a
    # loss 5e-5 apart) even though both are valid LM steps.
    prob64 = hv.build(dataclasses.replace(prob.config, dtype="float64"))
    warm64 = jax.tree.map(lambda a: np.asarray(a, np.float64), one.params)
    gn = dict(iterations=2, solve="cg", cg_tol=1e-12, verbose=False)
    gn_one = hv.gauss_newton(prob64, warm64, **gn)
    gn_four = hv.gauss_newton(prob64, warm64, mesh=mesh, **gn)
    l1, l4 = gn_one.final_aux["loss"], gn_four.final_aux["loss"]
    e_loss, e_par = abs(l4 - l1) / l1, rel_err(gn_four.params, gn_one.params)
    log(f"  sharded 'cg' LM (f64): {gn_four.accepted} accepted, loss {l4:.15e} vs one device "
        f"{l1:.15e}: rel {e_loss:.2e}, params rel {e_par:.2e} (tol {SHARD_GN_RTOL:g})")
    check(gn_four.accepted == 2 and gn_one.accepted == 2, "sharded LM accepted steps")
    check(e_loss <= SHARD_GN_RTOL and e_par <= SHARD_GN_RTOL, "sharded LM vs one device")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the element-sharded path on four GPUs")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)  # f64 reference and f64 phase
    devices = require_gpu()
    from hpvpinns_tpu.cli import _enable_compile_cache

    _enable_compile_cache()

    if args.four:
        phases = [("four-device element mesh", lambda: phase_four(devices))]
    else:
        state = {}
        phases = [
            ("matmul precision", phase_matmul_precision),
            ("bench-scale train", lambda: state.update(bench=phase_bench_scale())),
            ("serving", lambda: phase_serving(*state["bench"])),
            ("quality preset via CLI", phase_quality_cli),
            ("precision LM kernels", phase_precision_gn),
            ("float64 on the GPU", phase_f64_device),
            ("wide point", phase_wide_point),
        ]
    for name, fn in phases:
        t0 = time.perf_counter()
        log(f"phase {name}:")
        fn()
        log(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
    print(final_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
