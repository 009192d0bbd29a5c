"""Serving tier: jax.export StableHLO artifacts (hpvpinns_tpu/serving.py).

The reference has no deployment path (its trained nets die with the TF1
session process); these tests pin the rebuild's serving contract:
export -> save -> load -> call must reproduce the live ansatz
bit-for-bit-ish (same backend, same dtype), at ANY batch size (symbolic
batch dim), for plain-MLP AND composite hard-BC ansatzes, and the artifact
directory must be self-describing (config rebuilds the exact Problem).
"""

import json
import os

import jax
import numpy as np
import pytest

import hpvpinns_tpu as hv
from hpvpinns_tpu import serving


def _roundtrip(cfg, path, seed=0):
    """Artifact written by save_model and read back by load_model: the
    StableHLO module plus the calling convention rebuilt from meta.json."""
    prob = hv.build(cfg)
    params = prob.init_params(jax.random.key(seed))
    hv.save_model(str(path), prob, params, platforms=("cpu",))
    return prob, params, hv.load_model(str(path)).exported


@pytest.mark.parametrize(
    "cfg",
    [
        hv.Poisson1DConfig(),
        hv.KovasznayConfig(hard_bc=True),  # composite Coons-lifted triple
    ],
    ids=["poisson1d", "kovasznay_hardbc"],
)
def test_export_roundtrip_matches_live_apply(cfg, tmp_path):
    prob, params, exp = _roundtrip(cfg, tmp_path / "art")
    dtype = np.dtype(serving._compute_dtype(params))
    X = np.asarray(prob.test_points[:67], dtype=dtype)
    got = np.asarray(exp.call(X))
    want = np.asarray(prob.apply(params, X))
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)


def test_symbolic_batch_any_size(tmp_path):
    prob, params, exp = _roundtrip(hv.Poisson1DConfig(), tmp_path / "art")
    dtype = np.dtype(serving._compute_dtype(params))
    for n in (1, 13, 200):
        X = np.linspace(-1.0, 1.0, n, dtype=dtype).reshape(-1, 1)
        got = np.asarray(exp.call(X))
        assert got.shape == (n, 1)
        want = np.asarray(prob.apply(params, X))
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)


def test_save_load_artifact_dir(tmp_path):
    cfg = hv.Poisson2DConfig(hard_bc=True)
    prob = hv.build(cfg)
    params = prob.init_params(jax.random.key(3))
    meta = hv.save_model(str(tmp_path / "art"), prob, params, platforms=("cpu",))
    assert meta["problem"] == "poisson2d"
    assert meta["config_class"] == "Poisson2DConfig"
    assert os.path.exists(tmp_path / "art" / "model.stablehlo")
    with open(tmp_path / "art" / "meta.json") as f:
        assert json.load(f)["d_in"] == 2

    model = hv.load_model(str(tmp_path / "art"))
    X = np.asarray(prob.test_points[:31])
    got = model.predict(X)
    want = np.asarray(prob.apply(params, X.astype(model.meta["dtype"])))
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)

    # self-describing: the stored config rebuilds the SAME problem
    prob2 = model.rebuild_problem()
    assert prob2.name == prob.name
    assert prob2.config == prob.config
    np.testing.assert_allclose(prob2.test_points, prob.test_points)


def test_config_from_meta_roundtrips_tuples():
    cfg = hv.Poisson1DConfig(
        grid=(-1.0, -0.1, 0.1, 1.0),
        n_elements=3,
        layers=(1, 20, 20, 1),
        train=hv.TrainConfig(iterations=7, gn_iterations=2, gn_solve="qr"),
    )
    meta = {
        "config_class": "Poisson1DConfig",
        "config": json.loads(json.dumps(__import__("dataclasses").asdict(cfg))),
    }
    assert serving.config_from_meta(meta) == cfg


def test_f64_artifact_drops_tpu_platform_tag(tmp_path):
    # The GPU runs float64, so an f64 artifact keeps the default cpu+cuda
    # tagging (no platform is dropped) and still serves on the CPU.
    prob = hv.build(hv.Poisson1DConfig(dtype="float64"))
    params = prob.init_params(jax.random.key(0))
    assert serving._compute_dtype(params) == np.float64
    meta = hv.save_model(str(tmp_path / "a"), prob, params)
    assert meta["platforms"] == ["cpu", "cuda"]
    X = np.asarray(prob.test_points[:9])
    got = hv.load_model(str(tmp_path / "a")).predict(X)
    np.testing.assert_allclose(got, np.asarray(prob.apply(params, X)), rtol=1e-12, atol=0)


def test_manufactured_artifact_refuses_wrong_truth_check(tmp_path):
    prob = hv.build(hv.Poisson1DConfig())
    params = prob.init_params(jax.random.key(0))
    hv.save_model(str(tmp_path / "m"), prob, params, platforms=("cpu",),
                  extra_meta={"manufactured": True})
    model = hv.load_model(str(tmp_path / "m"))
    model.predict(np.zeros((3, 1)))  # predict stays usable
    with pytest.raises(ValueError, match="manufactured"):
        model.rebuild_problem()


def test_predict_rejects_wrong_width(tmp_path):
    prob = hv.build(hv.Poisson1DConfig())
    params = prob.init_params(jax.random.key(0))
    hv.save_model(str(tmp_path / "a"), prob, params, platforms=("cpu",))
    model = hv.load_model(str(tmp_path / "a"))
    with pytest.raises(ValueError, match="expected points"):
        model.predict(np.zeros((4, 2)))


def test_cli_export_and_serve(tmp_path, capsys):
    from hpvpinns_tpu import cli

    art = str(tmp_path / "art")
    rc = cli.main([
        "run", "poisson1d", "--iterations", "5", "--lbfgs-iterations", "0",
        "--quiet", "--export", art,
    ])
    assert rc == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert any(d.get("export") == art for d in lines)

    rc = cli.main(["serve", art, "--check", "--out", str(tmp_path / "pred.npz")])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["problem"] == "poisson1d"
    assert out["n_points"] > 0
    # 5 Adam steps is no solution; the check only needs to be finite and
    # computed (the exact-solution comparison path executes end to end)
    assert np.isfinite(out["rel_l2"])
    with np.load(tmp_path / "pred.npz") as z:
        assert z["Y"].shape[0] == out["n_points"]


def test_default_platforms_are_cpu_and_cuda(tmp_path):
    prob = hv.build(hv.Poisson2DConfig())
    params = prob.init_params(jax.random.key(2))
    meta = hv.save_model(str(tmp_path / "a"), prob, params)
    assert meta["platforms"] == ["cpu", "cuda"]
    X = np.asarray(prob.test_points[:17])
    got = hv.load_model(str(tmp_path / "a")).predict(X)
    np.testing.assert_allclose(got, np.asarray(prob.apply(params, X)), rtol=0, atol=5e-6)


def test_artifact_needs_no_flatbuffers(tmp_path, monkeypatch):
    """Saving and loading never touch jax.export's flatbuffers serializer,
    which a serving host need not have installed."""
    import sys

    monkeypatch.setitem(sys.modules, "flatbuffers", None)  # import now fails
    monkeypatch.delitem(sys.modules, "jax._src.export.serialization", raising=False)
    prob = hv.build(hv.Poisson1DConfig())
    params = prob.init_params(jax.random.key(0))
    hv.save_model(str(tmp_path / "a"), prob, params)
    X = np.linspace(-1.0, 1.0, 5, dtype=np.float32).reshape(-1, 1)
    got = hv.load_model(str(tmp_path / "a")).predict(X)
    np.testing.assert_allclose(got, np.asarray(prob.apply(params, X)), rtol=0, atol=5e-6)


def test_load_rejects_other_format_version(tmp_path):
    prob = hv.build(hv.Poisson1DConfig())
    hv.save_model(str(tmp_path / "a"), prob, prob.init_params(jax.random.key(0)))
    meta_path = tmp_path / "a" / "meta.json"
    meta = json.loads(meta_path.read_text())
    meta["format_version"] = 1
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="re-export"):
        hv.load_model(str(tmp_path / "a"))
