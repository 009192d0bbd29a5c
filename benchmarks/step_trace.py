"""Device-time breakdown of the training step from a jax.profiler trace.

    python benchmarks/step_trace.py [--width W] [--depth D] [--seeds S]
                                    [--deriv-mode taylor|jvp] [--out DIR]

Builds the bench problem (bench.build_bench_problem; with --width the wide
operating point), warms the trainer's scan chunk, traces a few chunks, and
sums the device time of every GPU kernel in the trace.  Kernels are sorted
into the derivative-field forward (op path inside a `vpinn_fields_*` named
scope, ops/assembly.py, outside any `transpose`), its backward (the same
scope under `transpose`) and the rest (weak-form contraction, loss,
optimizer); inside the scan most kernels replay from CUDA-graph command
buffers and stay unattributed, so the field forward is also timed alone
(jitted by itself at the step's shapes) and set beside a lower bound
computed from its shapes and the card's published peaks (bench.PEAKS).

Prints one JSON line; `--out DIR` keeps the raw trace there.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def field_forward_bound(layers, n_points: int, streams: int, seeds: int, peaks) -> dict:
    """Least time of the field forward on the card: `streams` value/tangent
    matmul chains of [n_points, h_in] x [h_in, h_out] per layer (2 flops per
    multiply-add), each layer's output per stream written once and read
    once in float32."""
    pairs = list(zip(layers[:-1], layers[1:]))
    flops = seeds * streams * sum(2.0 * n_points * a * b for a, b in pairs)
    nbytes = seeds * streams * sum(2.0 * 4 * n_points * b for _, b in pairs)
    t_flops = flops / peaks["flops_per_s"]
    t_bytes = nbytes / peaks["bytes_per_s"]
    return {"flops": flops, "bytes": nbytes, "bound_s": max(t_flops, t_bytes),
            "bound": "compute" if t_flops >= t_bytes else "hbm"}


def hlo_op_paths(hlo_text: str) -> dict:
    """HLO instruction name -> its op_name metadata (the JAX op path, with
    named scopes) in a compiled module's text."""
    return dict(re.findall(
        r'\n\s*(?:ROOT )?%?([\w.\-]+) = [^\n]*?op_name="([^"]*)"', hlo_text))


def device_kernels(trace_path: str, op_paths: dict):
    """(name, duration_ns, start_ns, op path) of every kernel on GPU planes.
    A kernel's op path comes from whichever of its stats names an HLO
    instruction in `op_paths`; kernels replayed from a CUDA-graph command
    buffer name none and stay unattributed."""
    import jax

    pd = jax.profiler.ProfileData.from_file(trace_path)
    out = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            # XLA's own op lines mirror the kernels of the stream lines.
            if "XLA Ops" in line.name or "XLA Modules" in line.name or "Steps" in line.name:
                continue
            for ev in line.events:
                stats = [str(v) for _, v in ev.stats] + [ev.name]
                path = next((op_paths[v] for v in stats if v in op_paths), "")
                out.append((ev.name, ev.duration_ns, ev.start_ns, path))
    return out


def time_fields_forward(prob, params, reps: int = 50) -> float:
    """Seconds per call of the derivative-field forward alone (the network
    and its first-derivative streams at every quadrature point, as the
    var_form-1 weak form needs them), jitted at the step's shapes and
    vmapped over the seed axis of `params`."""
    import jax

    from hpvpinns_tpu.models.mlp import MLP, mlp_apply
    from hpvpinns_tpu.ops.fields import scalar_fields_2d
    from hpvpinns_tpu.ops.taylor import taylor_fields_2d

    cfg = prob.config
    spec = MLP(layers=cfg.layers, activation=cfg.activation, precision=cfg.matmul_precision)
    el = prob.data["elements"]

    def fields(p):
        if cfg.deriv_mode == "taylor":
            return taylor_fields_2d(spec, p["net"], el.x, el.y, firsts_only=True)
        return scalar_fields_2d(lambda X: mlp_apply(spec, p["net"], X), el.x, el.y,
                                firsts_only=True)

    f = jax.jit(jax.vmap(fields))
    jax.block_until_ready(f(params))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = f(params)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def busy_ns(kernels) -> float:
    """Union of the kernels' intervals, in ns."""
    spans = sorted((s, s + d) for _, d, s, _ in kernels)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--deriv-mode", default="taylor", choices=("taylor", "jvp"))
    ap.add_argument("--chunks", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import dataclasses

    import jax

    import bench
    import hpvpinns_tpu as hv
    from hpvpinns_tpu.training.ensemble import _build_ens_chunk, init_ensemble
    from hpvpinns_tpu.training.trainer import make_optimizer

    device = bench.device_info()
    layers = None if args.width is None else (2,) + (args.width,) * args.depth + (1,)
    prob = bench.build_bench_problem(layers=layers)
    if args.deriv_mode != prob.config.deriv_mode:
        prob = hv.build(dataclasses.replace(prob.config, deriv_mode=args.deriv_mode))
    chunk_len = 10
    params = init_ensemble(prob, range(args.seeds))
    opt = make_optimizer(hv.TrainConfig())
    state = opt.init(params)
    chunk = _build_ens_chunk(prob.loss_fn, opt, chunk_len)
    for _ in range(3):
        params, state, aux = chunk(params, state, prob.data)
    jax.block_until_ready(aux["loss"])

    out_dir = args.out or tempfile.mkdtemp(prefix="step_trace_")
    t0 = time.perf_counter()
    with jax.profiler.trace(out_dir):
        for _ in range(args.chunks):
            params, state, aux = chunk(params, state, prob.data)
        jax.block_until_ready(aux["loss"])
    window_s = time.perf_counter() - t0
    path = sorted(glob.glob(os.path.join(out_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    op_paths = hlo_op_paths(chunk.lower(params, state, prob.data).compile().as_text())
    kernels = device_kernels(path, op_paths)
    steps = args.chunks * chunk_len

    groups = collections.Counter()
    by_op = collections.Counter()
    for name, dur, _, text in kernels:
        if "vpinn_fields" in text:
            groups["fields_bwd" if "transpose" in text else "fields_fwd"] += dur
        else:
            groups["other"] += dur
        by_op[re.sub(r"\d+", "#", text or name)] += dur
    total = sum(groups.values())
    cfg = prob.config
    n_points = prob.data["elements"].x.shape[0] * cfg.n_quad ** 2
    streams = 3 if cfg.var_form == 1 else 5  # (u, ux, uy) [+ uxx, uyy]
    peaks = bench.PEAKS.get(device["device_kind"])
    row = {
        "device": device,
        "layers": list(cfg.layers),
        "seeds": args.seeds,
        "deriv_mode": args.deriv_mode,
        "steps": steps,
        "n_kernels_per_step": len(kernels) / steps,
        "kernel_time_per_step_s": total / 1e9 / steps,
        "busy_per_step_s": busy_ns(kernels) / 1e9 / steps,
        "window_per_step_s": window_s / steps,
        "share": {k: v / total for k, v in groups.items()},
        "per_step_s": {k: v / 1e9 / steps for k, v in groups.items()},
        "top_ops": [(k, v / 1e9 / steps) for k, v in by_op.most_common(12)],
        "unattributed_share": sum(d for _, d, _, t in kernels if "jit(" not in t) / total,
        "fields_fwd_alone_s": time_fields_forward(prob, params),
    }
    if peaks is not None:
        b = field_forward_bound(cfg.layers, n_points, streams, args.seeds, peaks)
        b["share_of_bound_alone"] = b["bound_s"] / row["fields_fwd_alone_s"]
        row["fields_fwd_roofline"] = b
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
