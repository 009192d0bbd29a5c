"""The GPU measurement tooling (bench.py, chip_smoke.py,
benchmarks/step_trace.py), checked on the CPU: what they compute from shapes
and peaks, how they refuse a machine without a GPU, and their comparison
helpers at tiny sizes.  The one test that needs the card is marked `gpu`.
"""

import dataclasses
import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import hpvpinns_tpu as hv

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load(relpath):
    spec = importlib.util.spec_from_file_location(pathlib.Path(relpath).stem, ROOT / relpath)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bench = _load("bench.py")
chip_smoke = _load("chip_smoke.py")
step_trace = _load("benchmarks/step_trace.py")


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def test_peak_table_has_h100_sxm_and_pcie():
    sxm = bench.PEAKS["NVIDIA H100 80GB HBM3"]
    pcie = bench.PEAKS["NVIDIA H100 PCIe"]
    # FP32 on the CUDA cores (not TF32 tensor cores) and HBM bandwidth.
    assert sxm == {"flops_per_s": 67e12, "bytes_per_s": 3.35e12}
    assert pcie == {"flops_per_s": 51e12, "bytes_per_s": 2.0e12}


def _tiny_chunk():
    from hpvpinns_tpu.training.trainer import _build_chunk, make_optimizer

    prob = hv.build(hv.Poisson2DConfig(n_elements_x=2, n_elements_y=2, n_quad=4,
                                       n_test_x=3, n_test_y=3, layers=(2, 8, 1)))
    params = prob.init_params(jax.random.key(0))
    opt = make_optimizer(hv.TrainConfig())
    return _build_chunk(prob.loss_fn, opt, 2), (params, opt.init(params), prob.data)


@pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe", "unknown kind"])
def test_roofline_fields_only_for_known_kinds(kind):
    chunk, args = _tiny_chunk()
    out = bench.roofline_fields(chunk, 2, 100.0, args, device_kind=kind)
    assert out["flops_per_step_xla"] > 0 and "flops_per_sec" in out
    if kind in bench.PEAKS:
        assert out["roofline_bound"] in ("hbm", "compute")
        assert out["peak_flops_per_s"] == bench.PEAKS[kind]["flops_per_s"]
        assert out["roofline_step_s"] > 0
    else:
        assert not any(k.startswith(("peak", "roofline")) for k in out)


def test_bench_device_info_refuses_cpu():
    with pytest.raises(RuntimeError, match="measures a GPU"):
        bench.device_info()


def test_bench_main_raises_when_a_phase_raises(monkeypatch, capsys):
    monkeypatch.setattr(bench, "device_info", lambda: {"platform": "gpu"})
    monkeypatch.setattr(bench, "measure_steps_per_sec", lambda: {"residual_evals_per_sec": 1.0})

    def broken():
        raise MemoryError("out of device memory")

    monkeypatch.setattr(bench, "measure_ensemble_scaling", broken)
    with pytest.raises(MemoryError):
        bench.main()
    assert capsys.readouterr().out == ""  # no result line


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_chip_smoke_fails_without_gpu(alone, tmp_path):
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = _cpu_env()
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_final_line():
    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    line = json.loads(chip_smoke.final_line([Dev(), Dev(), Dev(), Dev()]))
    assert line == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}


def test_chip_smoke_reference_helpers_tiny():
    """compare_to_reference / compare_engines pass for an f32 problem whose
    reference is its own f64 twin on the CPU, and f64_reference is exactly
    the f64 problem's loss."""
    prob = hv.build(hv.Poisson2DConfig(n_elements_x=2, n_elements_y=2, n_quad=6,
                                       n_test_x=3, n_test_y=3, layers=(2, 8, 8, 1)))
    params = prob.init_params(jax.random.key(1))
    chip_smoke.compare_to_reference("tiny", prob, params)
    chip_smoke.compare_engines("tiny", prob, params)
    loss64, grad64 = chip_smoke.f64_reference(prob.config, params)
    p64 = hv.build(dataclasses.replace(prob.config, dtype="float64"))
    want = float(p64.loss_fn(jax.tree.map(lambda a: np.asarray(a, np.float64), params),
                             p64.data)[0])
    assert loss64 == pytest.approx(want, rel=1e-14)
    assert chip_smoke.rel_err(grad64, grad64) == 0.0
    with pytest.raises(RuntimeError, match="FAILED"):
        chip_smoke.check(False, "deliberate")


def test_step_trace_hlo_op_paths():
    text = ('\n  %fusion.3 = f32[2]{0} fusion(%p), kind=kLoop, calls=%fc, '
            'metadata={op_name="jit(chunk)/while/body/jvp(vpinn_fields_2d)/tanh" '
            'source_file="x.py"}\n  ROOT %tuple.1 = (f32[]) tuple(%a), '
            'metadata={op_name="jit(chunk)/tuple"}\n  %p = f32[2]{0} parameter(0)')
    assert step_trace.hlo_op_paths(text) == {
        "fusion.3": "jit(chunk)/while/body/jvp(vpinn_fields_2d)/tanh",
        "tuple.1": "jit(chunk)/tuple",
    }


def test_step_trace_busy_is_interval_union():
    kernels = [("a", 10, 0, ""), ("b", 10, 5, ""), ("c", 5, 30, "")]  # (name, dur, start, path)
    assert step_trace.busy_ns(kernels) == 20.0


def test_step_trace_field_forward_bound():
    peaks = {"flops_per_s": 1e12, "bytes_per_s": 1e9}
    b = step_trace.field_forward_bound((2, 4, 1), n_points=10, streams=3, seeds=2, peaks=peaks)
    assert b["flops"] == 2 * 3 * (2 * 10 * 2 * 4 + 2 * 10 * 4 * 1)
    assert b["bytes"] == 2 * 3 * (2 * 4 * 10 * 4 + 2 * 4 * 10 * 1)
    assert b["bound"] == "hbm" and b["bound_s"] == b["bytes"] / 1e9


@pytest.fixture
def gpu_env():
    """Environment for a child process that runs on the GPU.  This test
    process stays on the CPU (conftest.py), so whether a card is present is
    asked of nvidia-smi; skips where there is none."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True).returncode != 0:
        pytest.skip("no NVIDIA GPU on this machine")
    env = dict(os.environ)
    for var in ("JAX_PLATFORMS", "XLA_FLAGS"):
        env.pop(var, None)
    return env


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu_env):
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=gpu_env,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
