"""Benchmark harness.

Measures training-step throughput on the scaled hp-VPINN Poisson-2D workload
(BASELINE.json config 5: 64-element 2D Poisson, high-order quadrature) and
reports it as quadrature-point residual evaluations per second per chip — the
hot-path unit of work (network forward + nested JVPs + weighted-basis
contraction at one quadrature point of one element).

The reference publishes no numbers (BASELINE.md); the baseline is this same
workload measured with matched hyperparameters on one CPU host
(benchmarks/baseline_cpu.json, the stand-in for the TF1-CPU original, which
predates installable TF).  `vs_baseline` is the speedup ratio against the
float64 CPU row — the reference runs float64 on a CPU-pinned session
(Poisson-1D.py:46-51,105,116), so that is the apples-to-apples denominator;
the stricter float32-CPU cross-ratio is reported on stderr.

It measures the GPU and refuses to run anywhere else.  Prints exactly one
JSON line:
    {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...}
and the detail (device, card, every table) as one JSON line on stderr.
"""

from __future__ import annotations

import json
import os
import sys
import time

# Published peaks of the units a float32 step at matmul precision "highest"
# uses: FP32 on the CUDA cores (no tensor cores) and HBM bandwidth.  NVIDIA
# H100 data sheet, dense rates, at the full power limit.  Keyed by
# jax.Device.device_kind; a kind not listed gets no roofline fields.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops_per_s": 67e12, "bytes_per_s": 3.35e12},  # SXM5
    "NVIDIA H100 PCIe": {"flops_per_s": 51e12, "bytes_per_s": 2.0e12},
}


def device_info() -> dict:
    """The measured device, as JAX and nvidia-smi report it.  Raises unless
    JAX's default device is a GPU: a CPU number is not a device number."""
    import jax

    from hpvpinns_tpu.utils.profiling import gpu_card

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"bench.py measures a GPU; JAX's default device is {dev.platform!r}")
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "count": len(jax.devices()),
        "card": gpu_card(),
    }


def build_bench_problem(n_elem_axis: int = 8, n_quad: int = 16, layers=None):
    """The bench workload: n_elem_axis^2 elements, n_quad^2 quadrature points
    and 10x10 test functions per element; `layers` overrides the
    (2,20,20,20,1) net."""
    import dataclasses

    from hpvpinns_tpu.cli import _enable_compile_cache

    _enable_compile_cache()
    import hpvpinns_tpu as hv

    cfg = hv.poisson2d_scaled(n_elem_axis=n_elem_axis, n_quad=n_quad, n_test=10)
    if layers is not None:
        cfg = dataclasses.replace(cfg, layers=tuple(layers))
    return hv.build(cfg)


def _best_window(chunk, params, opt_state, data, n_chunks: int, trials: int):
    """Best of `trials` windows of `n_chunks` back-to-back chunk launches,
    each ended by a device sync; the best window is the least disturbed by
    other work on the shared host."""
    import jax

    best_dt = float("inf")
    aux = None
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(n_chunks):
            params, opt_state, aux = chunk(params, opt_state, data)
        jax.block_until_ready(aux["loss"])
        best_dt = min(best_dt, time.perf_counter() - t0)
    return best_dt, params, opt_state, aux


def measure_steps_per_sec(steps: int = 200, warmup: int = 20, trials: int = 5) -> dict:
    import jax

    import hpvpinns_tpu as hv
    from hpvpinns_tpu.training.trainer import _build_chunk, make_optimizer

    prob = build_bench_problem()
    params = prob.init_params(jax.random.key(0))
    opt = make_optimizer(hv.TrainConfig())
    opt_state = opt.init(params)

    # Measure the trainer's actual unit of work: a lax.scan chunk of
    # `chunk_len` optimizer steps per launch (training/trainer.py).
    chunk_len = 10
    chunk = _build_chunk(prob.loss_fn, opt, chunk_len)
    data = prob.data
    for _ in range(max(1, warmup // chunk_len)):
        params, opt_state, aux = chunk(params, opt_state, data)
    jax.block_until_ready(aux["loss"])

    n_chunks = max(1, steps // chunk_len)
    best_dt, params, opt_state, aux = _best_window(
        chunk, params, opt_state, data, n_chunks, trials
    )

    el = prob.data["elements"]
    n_elem = el.x.shape[0]
    n_qpts = el.x.shape[1] * el.x.shape[2]
    steps_per_sec = n_chunks * chunk_len / best_dt
    result = {
        "steps_per_sec": steps_per_sec,
        "residual_evals_per_sec": steps_per_sec * n_elem * n_qpts,
        "n_elem": n_elem,
        "n_quad_pts_per_elem": n_qpts,
        "final_loss": float(aux["loss"]),
    }
    result.update(roofline_fields(chunk, chunk_len, steps_per_sec, (params, opt_state, data)))
    return result


def roofline_fields(chunk, chunk_len: int, steps_per_sec: float, args, device_kind=None) -> dict:
    """FLOPs and bytes from XLA's cost analysis of the compiled step graph
    (no hand counting), against the card's published peaks.
    `roofline_bound` names the larger of the two per-step lower bounds
    (flops/peak vs bytes/bandwidth) and `roofline_attainment` is how much of
    that bound the measured step reaches (1.0 = at the roofline; the rest
    is launch and sync overhead the roofline cannot see).  A device kind
    with no entry in PEAKS gets the counts and no roofline fields."""
    import jax

    cost = chunk.lower(*args).compile().cost_analysis()
    flops_per_step = float(cost["flops"]) / chunk_len
    bytes_per_step = float(cost.get("bytes accessed", 0.0)) / chunk_len
    out = {
        "flops_per_step_xla": flops_per_step,
        "bytes_per_step_xla": bytes_per_step,
        "flops_per_sec": flops_per_step * steps_per_sec,
    }
    peaks = PEAKS.get(device_kind or jax.devices()[0].device_kind)
    if peaks is None:
        return out
    t_compute = flops_per_step / peaks["flops_per_s"]
    t_hbm = bytes_per_step / peaks["bytes_per_s"]
    out.update({
        "peak_flops_per_s": peaks["flops_per_s"],
        "peak_bytes_per_s": peaks["bytes_per_s"],
        "flops_share_of_peak": out["flops_per_sec"] / peaks["flops_per_s"],
        "roofline_bound": "hbm" if t_hbm >= t_compute else "compute",
        "roofline_step_s": max(t_hbm, t_compute),
        "roofline_attainment": max(t_hbm, t_compute) * steps_per_sec,
    })
    if bytes_per_step > 0:
        out["arithmetic_intensity"] = flops_per_step / bytes_per_step
    return out


def measure_ensemble_scaling(seed_counts=(1, 4, 8), steps: int = 100, trials: int = 3) -> list:
    """Seed-fleet throughput: S stacked networks per step (training/
    ensemble.py).  One network's step is far too small to fill the card, so
    seeds/s should scale well above the S=1 rate."""
    import jax

    import hpvpinns_tpu as hv
    from hpvpinns_tpu.training.ensemble import _build_ens_chunk, init_ensemble
    from hpvpinns_tpu.training.trainer import make_optimizer

    prob = build_bench_problem()
    rows = []
    chunk_len = 10
    for s in seed_counts:
        params = init_ensemble(prob, range(s))
        opt = make_optimizer(hv.TrainConfig())
        opt_state = opt.init(params)
        chunk = _build_ens_chunk(prob.loss_fn, opt, chunk_len)
        data = prob.data
        params, opt_state, aux = chunk(params, opt_state, data)
        jax.block_until_ready(aux["loss"])
        n_chunks = max(1, steps // chunk_len)
        best_dt, params, opt_state, aux = _best_window(
            chunk, params, opt_state, data, n_chunks, trials
        )
        sps = n_chunks * chunk_len / best_dt
        rows.append({"seeds": s, "steps_per_sec": sps, "seed_steps_per_sec": sps * s})
    return rows


def wide_point_problem(width: int = 256, depth: int = 3, n_elem_axis: int = 8, n_quad: int = 16):
    """The wide operating point's problem: the bench workload with a
    (2, width x depth, 1) net."""
    return build_bench_problem(n_elem_axis, n_quad, layers=(2,) + (width,) * depth + (1,))


def measure_wide_point(width: int = 256, seeds: int = 4, depth: int = 3,
                       steps: int = 50, trials: int = 3,
                       n_elem_axis: int = 8, n_quad: int = 16) -> dict:
    """The wide operating point: width x seed-ensemble COMPOSED on the same
    64-element scaled workload, with the utilization fields from XLA's cost
    analysis of the compiled step."""
    import jax

    import hpvpinns_tpu as hv
    from hpvpinns_tpu.training.ensemble import _build_ens_chunk, init_ensemble
    from hpvpinns_tpu.training.trainer import make_optimizer

    prob = wide_point_problem(width, depth, n_elem_axis, n_quad)
    chunk_len = 5
    params = init_ensemble(prob, range(seeds))
    opt = make_optimizer(hv.TrainConfig())
    opt_state = opt.init(params)
    chunk = _build_ens_chunk(prob.loss_fn, opt, chunk_len)
    data = prob.data
    params, opt_state, aux = chunk(params, opt_state, data)
    jax.block_until_ready(aux["loss"])

    n_chunks = max(1, steps // chunk_len)
    best_dt, params, opt_state, aux = _best_window(
        chunk, params, opt_state, data, n_chunks, trials
    )
    sps = n_chunks * chunk_len / best_dt

    el = prob.data["elements"]
    n_elem = el.x.shape[0]
    n_qpts = el.x.shape[1] * el.x.shape[2]
    row = {
        "width": width,
        "depth": depth,
        "seeds": seeds,
        "steps_per_sec": sps,
        "seed_steps_per_sec": sps * seeds,
        "residual_evals_per_sec": sps * seeds * n_elem * n_qpts,
    }
    row.update(roofline_fields(chunk, chunk_len, sps, (params, opt_state, data)))
    return row


def main():
    device = device_info()
    result = {"device": device}
    result.update(measure_steps_per_sec())
    result["ensemble_scaling"] = measure_ensemble_scaling()
    result["wide_point"] = measure_wide_point()

    baseline_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "benchmarks", "baseline_cpu.json")
    with open(baseline_path) as f:
        baseline = json.load(f)
    # float64 row = the reference's own numerics (see module docstring)
    vs_baseline = result["residual_evals_per_sec"] / baseline["float64"]["residual_evals_per_sec"]
    result["vs_float32_cpu"] = (
        result["residual_evals_per_sec"] / baseline["float32"]["residual_evals_per_sec"]
    )

    print(
        json.dumps(
            {
                "metric": "poisson2d_scaled_residual_evals_per_sec_per_chip",
                "value": result["residual_evals_per_sec"],
                "unit": "quadrature-point residual evals/s/chip",
                "vs_baseline": vs_baseline,
            }
        )
    )
    print(json.dumps({"detail": result}), file=sys.stderr)


if __name__ == "__main__":
    main()
