"""Resuming an RL checkpoint: the port against the JAX package.

The reference resumes ``rl_model`` by making the RL optimizer from the
run's config and restoring the checkpoint into it
(``relationalgraphlearning_tpu/training/train_loop.py:184-188``): optax
holds the rate in the transform, so the checkpoint brings back only Adam's
``count``/``mu``/``nu``, and a resumed run moves at its config's rate. The
case that tells the two rates apart is the unicycle anneal's stage 2: the
committed stage 1 (``results/mp_unicycle``) trained at the default 1e-3,
stage 2's config (``configs/icra_benchmark/mp_unicycle_anneal.py``) asks
for 5e-4.

Checked here: the exported ``checkpoints/mp_unicycle_state.npz`` equals
the orbax restore bit for bit; the converted state written as the port's
``rl_model``, resumed under stage 2's config (``train_loop.resume_rl``),
takes one RL step (TD targets) equal to the JAX package's step from the
same restore on the same minibatch, parameters and Adam moments at
``tests/test_torch_trainer.py``'s tolerance, with the step count carried
on; a checkpoint of another optimizer kind is refused on both sides; and
the toy train loop, resumed under a config of another rate, trains and
logs at that rate with the step count carried on.
"""

import dataclasses
import logging
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_checkpoint_export as export
from mprl_parity import two_torch_threads  # noqa: F401
from mprl_parity import ROOT
from relationalgraphlearning_tpu.configs import base as jbase
from relationalgraphlearning_tpu.training import checkpoint as jckpt
from relationalgraphlearning_tpu.training import train_loop as jtl
from relationalgraphlearning_tpu_torch import checkpoints
from relationalgraphlearning_tpu_torch.configs import base as tbase
from relationalgraphlearning_tpu_torch.convert import mprl_networks_from_flax
from relationalgraphlearning_tpu_torch.training import checkpoint as ckpt
from relationalgraphlearning_tpu_torch.training import train_loop as tl
from test_torch_trainer import TOL, _batch, _jax_batch, _torch_batch
from test_torch_train_loop import OPTS, _config

ANNEAL = str(ROOT / "configs" / "icra_benchmark" / "mp_unicycle_anneal.py")
STAGE1 = ROOT / "results" / "mp_unicycle" / "rl_model_best"
STEP = 1_550_000  # Adam's count in the committed stage 1 checkpoint


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_restore(tmp_path, optimizer="adam", learning_rate=5e-4):
    """The JAX package's resume of stage 1 under stage 2's config: the
    trainer built from it, its optimizer set, the checkpoint (a copy)
    restored into that template -> (trainer, state)."""
    config = jbase.load_config_module(ANNEAL)
    art = jtl.build(config, "model_predictive_rl")
    art.trainer.set_learning_rate(learning_rate, optimizer)
    params = art.policy.init_params(jax.random.PRNGKey(0))
    copy = tmp_path / "rl_model"
    shutil.copytree(STAGE1, copy)
    return art.trainer, jckpt.restore(str(copy), art.trainer.init(params))


def _torch_resume(tmp_path, **train):
    """The port's resume of the converted stage 1 under stage 2's config
    (``train`` overriding its ``TrainConfig``) -> (config, artifacts)."""
    config = tbase.load_config_module(ANNEAL)
    config = dataclasses.replace(config, train=dataclasses.replace(
        config.train, **train))
    art = tl.build(config, "model_predictive_rl", 0, "cpu")
    path = str(tmp_path / "torch" / "rl_model")
    checkpoints.write_rl_model("mp_unicycle", path)
    tl.resume_rl(art.trainer, path, config.train)
    return config, art


def test_exported_state_equals_the_orbax_restore():
    _, _, state = export.restore("mp_unicycle")
    want = export.flat_state(state)
    with np.load(checkpoints.DIR / "mp_unicycle_state.npz") as z:
        got = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        assert got[k].dtype == a.dtype and got[k].shape == a.shape, k
        assert np.array_equal(got[k], a), k
    assert int(got["opt_state/1/0/count"]) == STEP
    # params, target params, mu and nu of 33,506 parameters, and the count
    assert sum(a.size for a in want.values()) == 4 * 33_506 + 1


def test_resumed_rl_step_matches_jax_at_the_configs_rate(tmp_path):
    jtrainer, state = _jax_restore(tmp_path)
    config, art = _torch_resume(tmp_path)
    trainer = art.trainer
    assert config.train.rl_learning_rate == 5e-4
    assert trainer.optimizer.param_groups[0]["lr"] == 5e-4
    assert tl.optimizer_step(trainer) == STEP
    start = mprl_networks_from_flax(_np_tree(state.params))
    for n, p in zip(trainer.names, trainer.params):
        assert torch.equal(p, start[n]), n

    b = _batch(3)
    state, aux_j = jtrainer.train_step(state, _jax_batch(b),
                                       jnp.asarray(1.0), use_td=True)
    aux = trainer.train_step(_torch_batch(b), torch.tensor(1.0),
                             use_td=True)
    for got, want in zip(aux, aux_j):
        np.testing.assert_allclose(float(got), float(want), **TOL)
    want = mprl_networks_from_flax(_np_tree(state.params))
    for n, p in zip(trainer.names, trainer.params):
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   **TOL, err_msg=f"params: {n}")
    adam = state.opt_state[1][0]
    assert int(adam.count) == STEP + 1
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        want = mprl_networks_from_flax(_np_tree(tree))
        for n, p in zip(trainer.names, trainer.params):
            got = trainer.optimizer.state[p][key]
            np.testing.assert_allclose(got.numpy(), want[n].numpy(), **TOL,
                                       err_msg=f"{key}: {n}")
    assert tl.optimizer_step(trainer) == STEP + 1
    # Adam's step is proportional to the rate: at 1e-3 (the checkpoint's
    # run) each parameter would move twice as far, which the comparison
    # above tells apart when a move is far above its tolerance
    moved = max(float((p.detach() - start[n]).abs().max())
                for n, p in zip(trainer.names, trainer.params))
    assert moved > 100 * TOL["atol"], moved


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_a_checkpoint_of_another_optimizer_kind_is_refused(tmp_path, side):
    if side == "jax":  # an Adam state into an SGD template
        with pytest.raises(Exception):
            _jax_restore(tmp_path, optimizer="sgd", learning_rate=0.01)
    else:
        with pytest.raises(ValueError, match="adam state"):
            _torch_resume(tmp_path, optimizer="sgd")


def test_toy_resume_trains_at_the_configs_rate(tmp_path, caplog):
    """A toy run at the RL rate 1e-3, resumed under a config of 5e-4: the
    resumed run's optimizer is the config's, its step count goes on from
    the checkpoint's, and the log names the rate."""
    out = str(tmp_path / "run")
    tl.train(_config(), "model_predictive_rl", out, seed=0, opts=OPTS,
             device="cpu")
    saved = ckpt.load(str(tmp_path / "run" / "rl_model"))
    assert saved["learning_rate"] == 1e-3
    steps = int(saved["optimizer_state"][0]["step"])
    assert steps > 0
    caplog.set_level(logging.INFO, logger=tl.__name__)
    cfg = _config(rl_learning_rate=5e-4)
    art = tl.build(cfg, "model_predictive_rl", 0, "cpu")
    result = tl.train(cfg, "model_predictive_rl", out, seed=0, opts=OPTS,
                      device="cpu", resume=True, art=art)
    assert f"adam at rate 0.0005, step {steps})" in caplog.text
    assert art.trainer.learning_rate == 5e-4
    assert art.trainer.optimizer.param_groups[0]["lr"] == 5e-4
    assert tl.optimizer_step(art.trainer) == steps + result["rl_sgd_steps"]
    assert ckpt.load(str(tmp_path / "run" / "rl_model"))[
        "learning_rate"] == 5e-4
