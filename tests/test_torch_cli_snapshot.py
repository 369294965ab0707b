"""Which snapshot the port's evaluation CLI loads, against the reference's
rules (``relationalgraphlearning_tpu/cli/test.py:29-33``, ``:122-147``,
``:195``, ``:224-225``): ``--il`` / ``--checkpoint il`` loads ``il_model``,
``final`` ``rl_model``, ``best`` (or no flag, when it exists)
``rl_model_best``, else ``rl_model``; with none found a trainable policy
runs at a random init, with a warning, and the record says so. A directory
with no torch checkpoint at all (a committed run of the JAX package) takes
its exported ``.npz``; one with the port's checkpoints never does.

Each snapshot is saved with weights of its own seed, so loading the wrong
one shows in the parameters (compared bit for bit)."""

import json
import logging

import pytest
import torch

from mprl_parity import two_torch_threads  # noqa: F401
from relationalgraphlearning_tpu_torch import checkpoints
from relationalgraphlearning_tpu_torch.cli import test as cli
from relationalgraphlearning_tpu_torch.configs.base import load_config_module
from relationalgraphlearning_tpu_torch.policies.model_predictive_rl import (
    ModelPredictiveRLPolicy)
from relationalgraphlearning_tpu_torch.training import checkpoint as ckpt
from relationalgraphlearning_tpu_torch.training import trainer as tr

from test_torch_cli_train import ROOT, TOY_CONFIG

SEEDS = {"il_model": 1, "rl_model": 2, "rl_model_best": 3}


def _run_dir(tmp_path, snapshots, name="run"):
    """A run directory holding ``snapshots``, each the port's checkpoint
    of a policy at its own seed; ``il_model`` with the IL optimizer (SGD),
    as the train loop writes it."""
    d = tmp_path / name
    d.mkdir()
    (d / "config.py").write_text(TOY_CONFIG)
    config = load_config_module(str(d / "config.py"))
    for snap in snapshots:
        policy = ModelPredictiveRLPolicy(config.policy, config.env,
                                         device="cpu")
        policy.init_params(torch.Generator().manual_seed(SEEDS[snap]))
        trainer = tr.MPRLTrainer(policy)
        if snap == "il_model":
            trainer.set_learning_rate(config.train.il_learning_rate,
                                      config.train.il_optimizer)
        ckpt.save(str(d / snap), trainer)
    return d, config


def _params_of(d, snap):
    return ckpt.load(str(d / snap))["params"]


def _loaded(config, weights):
    _, policy, _ = cli.build(config, "model_predictive_rl", weights, "cpu")
    return policy.networks.state_dict()


def _equal(a, b):
    assert a.keys() == b.keys()
    return all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("il, checkpoint, want", [
    (False, None, "rl_model_best"),
    (False, "best", "rl_model_best"),
    (False, "final", "rl_model"),
    (False, "il", "il_model"),
    (True, None, "il_model"),
    (True, "final", "il_model"),        # --il wins, as in the reference
])
def test_flags_pick_the_reference_snapshot(tmp_path, il, checkpoint, want):
    d, config = _run_dir(tmp_path, SEEDS)
    weights = cli.weights_of(str(d), il, checkpoint)
    assert weights == str(d / want)
    assert cli.loaded_name(weights, True) == want
    assert _equal(_loaded(config, weights), _params_of(d, want))


def test_no_best_falls_back_to_the_final_snapshot(tmp_path):
    d, config = _run_dir(tmp_path, ("il_model", "rl_model"))
    weights = cli.weights_of(str(d))
    assert weights == str(d / "rl_model")
    assert _equal(_loaded(config, weights), _params_of(d, "rl_model"))
    # --checkpoint best names a snapshot that is not there: random init
    assert cli.weights_of(str(d), checkpoint="best") is None


def test_il_only_directory_evaluates_its_own_weights_or_warns(
        tmp_path, caplog, capsys):
    """A run stopped after imitation, in a directory named after a
    committed run (``mprl_td``): ``--il`` evaluates its own ``il_model``;
    with no flag the reference looks for ``rl_model`` and finds none, so
    the policy runs at a random init with a warning. The committed JAX
    weights are never taken."""
    d, config = _run_dir(tmp_path, ("il_model",), name="mprl_td")
    weights = cli.weights_of(str(d), il=True)
    assert weights == str(d / "il_model")
    assert _equal(_loaded(config, weights), _params_of(d, "il_model"))
    assert cli.weights_of(str(d)) is None
    with caplog.at_level(logging.WARNING):
        record = cli.main(["--model_dir", str(d), "--test_size", "2",
                           "--device", "cpu"])
    assert record["checkpoint"] == cli.RANDOM_INIT
    assert "evaluating random init" in caplog.text
    record = cli.main(["--model_dir", str(d), "--il", "--test_size", "2",
                       "--device", "cpu"])
    assert record["checkpoint"] == "il_model"
    capsys.readouterr()


def test_committed_run_without_torch_checkpoint_takes_the_npz(caplog):
    d = ROOT / "results" / "mprl_td"        # holds the JAX rl_model_best
    weights = cli.weights_of(str(d))
    assert weights == str(checkpoints.weights_path("mprl_td"))
    assert cli.loaded_name(weights, True) == "rl_model_best"
    assert cli.weights_of(str(d), checkpoint="best") == weights
    # the JAX run has no rl_model or il_model: the reference's random init
    assert cli.weights_of(str(d), checkpoint="final") is None
    assert cli.weights_of(str(d), il=True) is None


def test_neither_gives_a_random_init_with_the_warning(tmp_path, caplog,
                                                      capsys):
    d, config = _run_dir(tmp_path, ())
    assert cli.weights_of(str(d)) is None
    with caplog.at_level(logging.WARNING):
        record = cli.main(["--model_dir", str(d), "--test_size", "2",
                           "--device", "cpu"])
    assert record["checkpoint"] == "none (RANDOM INIT — no checkpoint found)"
    assert "random init" in caplog.text
    # the seeded random init: the same weights on every call
    assert _equal(_loaded(config, None), _loaded(config, None))
    # a policy without parameters never warns
    assert cli.loaded_name(None, False) == "none (untrained policy)"
    capsys.readouterr()


@pytest.mark.parametrize("flags, name, checkpoint", [
    ([], "eval_test.json", "rl_model_best"),
    (["--checkpoint", "final"], "eval_test_final.json", "rl_model"),
    (["--checkpoint", "il"], "eval_test_il.json", "il_model"),
    (["--checkpoint", "best", "--planning_depth", "1"],
     "eval_test_d1_best.json", "rl_model_best"),
    (["--il"], "eval_test.json", "il_model"),   # the reference adds no _il
])
def test_record_name_and_suffix_follow_the_reference(tmp_path, capsys,
                                                     flags, name,
                                                     checkpoint):
    d, _ = _run_dir(tmp_path, SEEDS)
    out = tmp_path / "records"
    out.mkdir()
    record = cli.main(["--model_dir", str(d), "--test_size", "2",
                       "--device", "cpu", "--out", str(out), *flags])
    assert record["checkpoint"] == checkpoint
    assert [p.name for p in out.iterdir()] == [name]
    assert json.loads((out / name).read_text()) == record
    capsys.readouterr()
