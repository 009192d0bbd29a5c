"""Hybrid f32 device training + host-f64 LM polish (training/hybrid.py).

The subprocess worker is exercised for real (it is the production path:
the polish ALWAYS runs out-of-process on the CPU, so it never opens the
accelerator the training process holds).  Configs cross the boundary as JSON specs; parameters
as flattened npz leaves.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest

import hpvpinns_tpu as hv
from hpvpinns_tpu.training.hybrid import (
    config_from_spec,
    config_to_spec,
    polish_f64,
)

TINY = hv.Poisson1DConfig(
    layers=(1, 10, 10, 1), n_elements=3, n_quad=10, n_test=5,
    train=hv.TrainConfig(iterations=300),
)


def test_config_spec_roundtrip_all_presets():
    presets = [
        hv.poisson1d_of_record(), hv.poisson2d_precision(),
        hv.poisson3d_precision(), hv.advdiff_of_record(),
        hv.advdiff2d_precision(), hv.burgers_precision(),
        hv.kovasznay_precision(), hv.taylorgreen_precision(), TINY,
    ]
    for cfg in presets:
        spec = json.loads(json.dumps(config_to_spec(cfg)))
        assert config_from_spec(spec) == cfg


def test_config_spec_rejects_unknown_family():
    with pytest.raises(ValueError):
        config_from_spec({"family": "NoSuchConfig", "fields": {}})


@pytest.mark.slow  # spawns the f64 subprocess worker (~30 s incl. re-import)
def test_polish_f64_improves_and_preserves_dtype():
    prob = hv.build(TINY)
    res = hv.train(prob, verbose=False)
    loss0 = float(res.final_aux["loss"])

    pr = polish_f64(TINY, res.params, iterations=5, solve="normal",
                    timeout=900)
    assert pr.accepted == 5
    assert pr.loss < loss0  # every LM step is an ACCEPTED decrease
    assert set(pr.metrics) >= {"rel_l2", "max_abs_err", "mean_abs_err"}
    # worker evaluated the polished net at f64; parent cast-back agrees
    m_parent = hv.evaluate_problem(prob, pr.params)
    assert np.isclose(m_parent["rel_l2"], pr.metrics["rel_l2"],
                      rtol=1e-4, atol=1e-9)
    # cast-back params keep the caller's leaf dtypes; f64 twin is f64
    for a, b in zip(jax.tree_util.tree_leaves(res.params),
                    jax.tree_util.tree_leaves(pr.params)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
    for leaf in jax.tree_util.tree_leaves(pr.params_f64):
        assert np.asarray(leaf).dtype == np.float64
    # the start metrics are the incoming params' f64 evaluation
    m0 = hv.evaluate_problem(prob, res.params)
    assert np.isclose(pr.metrics_start["rel_l2"], m0["rel_l2"],
                      rtol=1e-3, atol=1e-9)


@pytest.mark.slow
def test_cli_polish_f64(capsys, tmp_path):
    from hpvpinns_tpu.cli import main

    rc = main(
        (
            "run poisson1d --iterations 200 --n-quad 10 --n-test 4 "
            "--layers 1,8,1 --n-elements 3 --quiet --polish-f64 3 "
            f"--record {tmp_path}/rec"
        ).split()
    )
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(out[0])
    pol = summary["polish_f64"]
    assert pol["accepted"] == 3
    assert pol["loss"] <= summary["final_loss"]
    assert "rel_l2" in pol["metrics_f64"] and "rel_l2" in pol["castback"]
