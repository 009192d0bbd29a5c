"""CLI surface: presets, overrides, artifact emission."""

import json

import numpy as np
import pytest

from hpvpinns_tpu.cli import _config_from_args, build_parser, main


def parse(argv):
    return build_parser().parse_args(argv)


def test_preset_override_mapping():
    args = parse(
        "run poisson1d --iterations 50 --n-quad 12 --n-test 4 --grid=-1,-0.1,0.1,1 "
        "--lbfgs-iterations 7 --var-form 2 --layers 1,8,1".split()
    )
    cfg = _config_from_args(args)
    assert cfg.train.iterations == 50
    assert cfg.train.lbfgs_iterations == 7
    assert cfg.n_quad == 12
    assert cfg.var_form == 2
    assert cfg.layers == (1, 8, 1)
    assert cfg.grid == (-1.0, -0.1, 0.1, 1.0)
    assert cfg.n_elements == 3


def test_advdiff_forward_flag():
    args = parse("run advdiff --forward --iterations 5".split())
    cfg = _config_from_args(args)
    assert cfg.inverse is False


def test_run_end_to_end(capsys, tmp_path):
    rc = main(
        (
            f"run poisson1d --iterations 30 --n-quad 10 --n-test 4 --layers 1,6,1 "
            f"--quiet --record {tmp_path}/rec --outdir {tmp_path}/viz --plots"
        ).split()
    )
    assert rc == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    summary = lines[0]
    assert summary["problem"] == "poisson1d"
    assert summary["iterations"] == 30
    assert "rel_l2" in summary
    assert any("plots" in l for l in lines)
    assert (tmp_path / "rec.npz").exists()


def test_run_init_record_warm_start(capsys, tmp_path):
    """--record-params then --init-record: the warm-started run resumes from
    the stored network (first-step loss ~= the recorded final loss, far below
    a cold init's)."""
    base = (
        "run poisson1d --iterations 40 --n-quad 10 --n-test 4 --layers 1,6,1 "
        "--quiet"
    ).split()
    rc = main(base + ["--record", f"{tmp_path}/warm", "--record-params"])
    assert rc == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    rc = main(base + ["--init-record", f"{tmp_path}/warm.npz"])
    assert rc == 0
    warm = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    # 40 more steps from the stored params can only improve on the record
    assert warm["final_loss"] <= first["final_loss"] * 1.05


def test_run_init_record_rejects_ensemble(capsys, tmp_path):
    rc = main(
        "run poisson1d --iterations 20 --n-quad 10 --n-test 4 --layers 1,6,1 "
        f"--quiet --record {tmp_path}/w --record-params".split()
    )
    assert rc == 0
    capsys.readouterr()
    rc = main(
        f"run poisson1d --iterations 20 --n-quad 10 --n-test 4 --layers 1,6,1 "
        f"--quiet --seeds 2 --init-record {tmp_path}/w.npz".split()
    )
    assert rc == 2
    assert "--seeds" in capsys.readouterr().err


def test_advdiff_quadratic_epsilon_run(capsys):
    """Regression: the summary's epsilon report must not KeyError when the pde
    pytree holds 'eps_coef' instead of 'epsilon' (quadratic epsilon_model)."""
    rc = main(
        "run advdiff --epsilon-model quadratic --iterations 20 --n-quad 6 "
        "--n-test-x 3 --n-test-t 3 --layers 2,6,1 --quiet".split()
    )
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert np.isfinite(summary["epsilon"])
    assert summary["epsilon_true"] == pytest.approx(0.1 / np.pi)


def test_quality_presets():
    """The measured winners (MEASUREMENTS.md) are one flag away."""
    cfg = _config_from_args(parse("run poisson2d --preset quality".split()))
    assert cfg.layers == (2, 48, 48, 48, 48, 1)
    assert cfg.n_test_x == 10 and cfg.n_quad == 16
    assert cfg.train.iterations == 10000 and cfg.train.lbfgs_iterations == 5000

    cfg = _config_from_args(parse("run poisson2d --preset quality --hard-bc".split()))
    assert cfg.hard_bc is True and cfg.train.lbfgs_iterations == 20000

    cfg = _config_from_args(parse("run poisson1d --preset quality".split()))
    # the reference's own non-uniform 3-element hp grid (measured winner)
    assert cfg.grid == (-1.0, -0.1, 0.1, 1.0) and cfg.train.lbfgs_iterations == 5000

    cfg = _config_from_args(parse("run advdiff --preset quality".split()))
    assert cfg.dtype == "float64" and cfg.train.lbfgs_iterations == 10000

    cfg = _config_from_args(parse("run poisson3d --preset quality".split()))
    assert cfg.layers == (3, 48, 48, 48, 1) and cfg.n_test_x == 6

    # overrides still apply on top of a quality preset
    cfg = _config_from_args(parse("run poisson2d --preset quality --iterations 7".split()))
    assert cfg.train.iterations == 7 and cfg.layers == (2, 48, 48, 48, 48, 1)


def test_precision_presets():
    """The f64-CPU Gauss-Newton accuracy-frontier points (round-3 GN study)
    ship as `--preset precision` for the families with a measured win."""
    cfg = _config_from_args(parse("run poisson1d --preset precision".split()))
    assert cfg.dtype == "float64" and cfg.n_test == 50
    assert cfg.grid == (-1.0, -0.1, 0.1, 1.0)  # the quality hp grid
    assert cfg.train.iterations == 1000 and cfg.train.gn_iterations == 200

    cfg = _config_from_args(parse("run advdiff --preset precision".split()))
    assert cfg.dtype == "float64" and cfg.inverse
    assert cfg.train.iterations == 1500 and cfg.train.gn_iterations == 150

    # --forward switches advdiff precision to the FORWARD frontier (the
    # layer-feature + clustered-grid + QR-LM point, 1.76e-3 on chip)
    cfg = _config_from_args(parse("run advdiff --preset precision --forward".split()))
    assert not cfg.inverse and cfg.layer_feature
    assert cfg.grid_x == (-1.0, 0.5, 0.9, 1.0) and cfg.train.gn_solve == "qr"

    # the 2D frontier runs ON CHIP: f32 + hard-BC + GN-50 (host-f64 solve)
    cfg = _config_from_args(parse("run poisson2d --preset precision".split()))
    assert cfg.dtype == "float32" and cfg.hard_bc
    assert cfg.train.gn_iterations == 50 and cfg.train.lbfgs_iterations == 20000

    # overrides still apply on top
    cfg = _config_from_args(parse("run poisson1d --preset precision --gn-iterations 7".split()))
    assert cfg.train.gn_iterations == 7 and cfg.n_test == 50

    # the LM step kernel is selectable (--gn-solve; default None = auto)
    assert cfg.train.gn_solve is None
    cfg = _config_from_args(parse(
        "run poisson2d --preset precision --gn-solve qr".split()))
    assert cfg.train.gn_solve == "qr"

    # the nonlinear family's frontier also runs ON CHIP (f32 + GN-40)
    cfg = _config_from_args(parse("run burgers --preset precision".split()))
    assert cfg.dtype == "float32" and cfg.hard_bc
    assert cfg.train.gn_iterations == 40
    assert cfg.grid_x == (-1.0, -0.3, -0.08, 0.08, 0.3, 1.0)

    # the volumetric family ships too (chunked-Jacobian GN, 6.59e-3)
    cfg = _config_from_args(parse("run poisson3d --preset precision".split()))
    assert cfg.hard_bc and cfg.train.gn_iterations == 30

    # the 2-space-dimension space-time family ships FORWARD-only (joint eps
    # under GN measured negative — MEASUREMENTS.md): eps frozen at truth,
    # 32-wide net, p=8^3 test space, GN-120 on the on-device QR kernel
    cfg = _config_from_args(parse("run advdiff2d --preset precision".split()))
    assert not cfg.inverse and cfg.layers == (3, 32, 32, 32, 1)
    assert cfg.n_test_x == cfg.n_test_y == cfg.n_test_t == 8
    assert cfg.train.gn_iterations == 120 and cfg.train.gn_solve == "qr"

    # the steady NS SYSTEM frontier (hard-BC Coons lift, 5.6e-5 on chip)
    cfg = _config_from_args(parse("run kovasznay --preset precision".split()))
    assert cfg.hard_bc and cfg.layers == (2, 50, 50, 50, 3)
    assert cfg.train.gn_iterations == 250 and cfg.train.gn_solve == "qr"

    # the UNSTEADY NS frontier (space-time hard-BC lift + direct-grad-p
    # form 0 + zero-mean pressure-gauge penalty, 2.09e-4 on chip)
    cfg = _config_from_args(parse("run taylorgreen --preset precision".split()))
    assert cfg.hard_bc and cfg.layers == (3, 50, 50, 50, 3)
    assert cfg.var_form == 0
    assert cfg.p_zero_mean_weight == 10.0
    assert (cfg.n_elements_x, cfg.n_elements_y, cfg.n_elements_t) == (3, 3, 2)
    assert cfg.train.gn_iterations == 250 and cfg.train.gn_solve == "qr"

    # the oscillatory/indefinite family (sin prior + hard-BC trace lift + QR LM)
    cfg = _config_from_args(parse("run helmholtz2d --preset precision".split()))
    assert cfg.hard_bc and cfg.activation == "sin"
    assert cfg.train.gn_iterations == 50 and cfg.train.gn_solve == "qr"
    # round-5 retune: quality = the time-to-accuracy knee of the SAME
    # lifted ansatz precision deepens (1.23e-3 @ 67 s vs 3.41e-4 @ 169 s)
    cfg = _config_from_args(parse("run helmholtz2d --preset quality".split()))
    assert cfg.hard_bc and cfg.activation == "sin"
    assert cfg.train.iterations == 5000 and cfg.train.lbfgs_iterations == 5000
    assert cfg.train.gn_iterations == 10 and cfg.train.gn_solve == "qr"
    # precision keeps its own full warm budgets (not derived from quality)
    cfg = _config_from_args(parse("run helmholtz2d --preset precision".split()))
    assert cfg.train.iterations == 10000 and cfg.train.lbfgs_iterations == 10000


def test_precision_preset_runs_end_to_end(capsys):
    """Tiny-budget structural pass through the Adam->GN precision path."""
    rc = main(
        "run poisson1d --preset precision --iterations 20 --gn-iterations 3 "
        "--n-test 6 --n-quad 12 --layers 1,8,1 --quiet".split()
    )
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert summary["problem"] == "poisson1d" and np.isfinite(summary["rel_l2"])


def test_quality_preset_runs_end_to_end(capsys):
    rc = main(
        "run poisson2d --preset quality --iterations 20 --lbfgs-iterations 0 "
        "--n-quad 4 --layers 2,6,1 --quiet".split()
    )
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert summary["problem"] == "poisson2d" and np.isfinite(summary["rel_l2"])


def test_grid_x_flags_parse():
    cfg = _config_from_args(parse("run poisson2d --grid-x=-1,-0.2,0.2,1 --grid-y=-1,0,1".split()))
    assert cfg.grid_x == (-1.0, -0.2, 0.2, 1.0) and cfg.grid_y == (-1.0, 0.0, 1.0)
    cfg = _config_from_args(parse("run burgers --grid-x=-1,-0.1,0.1,1".split()))
    assert cfg.grid_x == (-1.0, -0.1, 0.1, 1.0)


def test_var_form_2c_parses():
    args = parse("run poisson2d --var-form 2c --iterations 5".split())
    cfg = _config_from_args(args)
    assert cfg.var_form == "2c"


def test_presets_command(capsys):
    assert main(["presets"]) == 0
    out = capsys.readouterr().out
    assert "poisson1d" in out and "advdiff" in out


def test_cli_manufactured_velocity_field(capsys):
    """run advdiff --manufactured-velocity 1.0,0.3 --velocity-model linear:
    forced problem, polynomial V(x) identification, vel_coef in the summary."""
    rc = main(
        "run advdiff --manufactured-velocity 1.0,0.3 --identify-velocity "
        "--velocity-model linear --dtype float64 --iterations 50 --quiet".split()
    )
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(out[-1])
    assert summary["problem"] == "advdiff"
    assert len(summary["vel_coef"]) == 2
    assert abs(summary["velocity_true"] - 1.0) < 1e-9  # mean of 1 + 0.3x


def test_identify_cli_reduced_and_als(capsys):
    """identify: network-free identification one-liners (reduced scalar on
    the benchmark; als field on a manufactured truth)."""
    import json

    from hpvpinns_tpu.cli import main

    rc = main("identify advdiff".split())
    assert rc == 0
    s = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert s["method"] == "reduced"
    assert s["epsilon_rel_err"] < 1e-6
    assert s["n_forward_solves"] < 40

    rc = main(
        "identify advdiff --method als --stations 19 --sensors-per-station 20 "
        "--manufactured-velocity 1.0 --manufactured-epsilon sin:0.0318,0.5 "
        "--manufactured-profile cos".split()
    )
    assert rc == 0
    s = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert s["eps_field_rel_l2"] < 2e-3


def test_run_gap_flag(capsys):
    """--gap prints the VPINN-gap report (net vs exact vs direct solve)."""
    import json

    from hpvpinns_tpu.cli import main

    # the hp grid: a degree-40 single element cannot resolve tanh(80x)
    rc = main(
        "run poisson1d --dtype float64 --iterations 100 --quiet --gap "
        "--grid=-1,-0.1,0.1,1".split()
    )
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    gap = json.loads(lines[-1])["gap"]
    # tanh(80x) at p=40 on the hp grid: direct solve ~6e-5 (layer-limited)
    assert gap["rel_l2_galerkin_vs_exact"] < 1e-3
    assert set(gap) == {
        "rel_l2_net_vs_exact", "rel_l2_galerkin_vs_exact", "rel_l2_net_vs_galerkin"
    }


def test_identify_scalar_manufactured_epsilon_truth_report(capsys):
    """Regression: a scalar --manufactured-epsilon must become the problem's
    reported eps_true (folded into gamma), and the reduced route identifies
    it under a VARIABLE known velocity field."""
    import json

    from hpvpinns_tpu.cli import main

    rc = main(
        "identify advdiff --manufactured-velocity 1.0,0.3 "
        "--manufactured-epsilon 0.0318".split()
    )
    assert rc == 0
    s = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert s["epsilon_true"] == pytest.approx(0.0318)
    assert s["epsilon_rel_err"] < 1e-5


def test_identify_record_artifact(capsys, tmp_path):
    import json

    import numpy as np

    from hpvpinns_tpu.cli import main

    rc = main(f"identify advdiff --record {tmp_path}/rec".split())
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["record"].endswith("rec.npz")
    d = np.load(tmp_path / "rec.npz")
    assert set(d.files) >= {"coef", "x", "eps", "method"}
    assert d["eps"].shape == (513,)


@pytest.mark.slow
def test_identify2d_map_als_cli(capsys, tmp_path):
    """identify advdiff2d --method als: the 2D diffusivity-MAP route with the
    heatmap artifact (round-2 VERDICT item 6)."""
    import json
    import os

    from hpvpinns_tpu.cli import main

    rc = main(
        f"identify advdiff2d --method als --plots --outdir {tmp_path} "
        f"--record {tmp_path}/map2d".split()
    )
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    s = json.loads(lines[0])
    assert s["method"] == "als (2D map)"
    assert s["eps_map_rel_l2"] < 0.12
    rec = json.loads(lines[1])["record"]
    plots = json.loads(lines[2])["plots"]
    assert os.path.exists(rec) and os.path.exists(plots[0])
    import numpy as np

    z = np.load(rec)
    assert z["eps"].shape == z["eps_true"].shape == (101, 101)


@pytest.mark.slow
def test_identify_uncertainty_cli(capsys):
    """identify advdiff --uncertainty: CI columns in the JSON; the 95% CI
    covers truth at the measured calibration (6/6 in MEASUREMENTS.md)."""
    import json

    from hpvpinns_tpu.cli import main

    rc = main("identify advdiff --uncertainty --noise 1e-3".split())
    assert rc == 0
    s = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    u = s["uncertainty"]
    assert u["params"] == ["epsilon"]
    assert u["truth_covered"] is True
    assert 2e-4 < u["sigma_est"] < 5e-3


def test_run_seeds_ensemble_cli(capsys):
    """run --seeds N: vmapped seed-fleet with per-seed metrics + best member."""
    import json

    from hpvpinns_tpu.cli import main

    rc = main(
        "run poisson1d --seeds 3 --iterations 40 --n-quad 10 --layers 1,8,1 "
        "--dtype float64 --quiet".split()
    )
    assert rc == 0
    s = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert s["seeds"] == 3 and len(s["per_seed"]) == 3
    assert s["rel_l2_min"] <= s["rel_l2_median"] <= s["rel_l2_max"]
    assert s["seed_steps_per_sec"] == pytest.approx(3 * s["steps_per_sec"], rel=0.01)


def test_run_seeds_polish_phase(capsys):
    """--seeds with lbfgs/gn budgets polishes the best member (phase-2)."""
    import json

    from hpvpinns_tpu.cli import main

    rc = main(
        "run poisson1d --seeds 2 --iterations 60 --gn-iterations 12 "
        "--n-quad 16 --n-test 8 --layers 1,10,10,1 --dtype float64 --quiet".split()
    )
    assert rc == 0
    s = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert s["polished"]["gn_iterations"] == 12
    assert s["polished"]["rel_l2"] <= s["rel_l2_min"]


def test_run_seeds_with_mesh(capsys):
    """--mesh --seeds: the ensemble branch receives the mesh (the round-3
    silent-ignore fix) — runs on the 8-device virtual mesh and reports the
    same summary shape."""
    import json

    from hpvpinns_tpu.cli import main

    rc = main(
        "run poisson1d --seeds 2 --mesh --iterations 30 --n-quad 10 "
        "--layers 1,8,1 --dtype float64 --quiet".split()
    )
    assert rc == 0
    s = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert s["seeds"] == 2 and len(s["per_seed"]) == 2


@pytest.fixture
def restore_cache_config():
    import jax

    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_compile_cache_defaults_to_checkout(monkeypatch, restore_cache_config):
    import os

    import jax

    from hpvpinns_tpu import cli

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    cli._enable_compile_cache()
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(cli.__file__)))
    assert jax.config.jax_compilation_cache_dir == os.path.join(checkout, ".jax_cache")
    assert cli.COMPILE_CACHE_DIR == os.path.join(checkout, ".jax_cache")


def test_compile_cache_env_var_sets_nothing(monkeypatch, restore_cache_config):
    import jax

    from hpvpinns_tpu import cli

    jax.config.update("jax_compilation_cache_dir", "/sentinel")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    cli._enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == "/sentinel"


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_maybe_enable_x64_leaves_platforms(dtype):
    import jax

    from hpvpinns_tpu import cli

    before = jax.config.jax_platforms
    cli._maybe_enable_x64(dtype)
    assert jax.config.jax_platforms == before
    assert jax.config.jax_enable_x64  # conftest enables it; f64 must keep it
