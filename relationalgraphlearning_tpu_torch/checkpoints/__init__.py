"""Exported weights of the committed checkpoints (MP-RGL and the one-step
baselines), and per-case references of their 500-case test evaluations
(the ORCA robot's too).

``<model>.npz`` holds every array of the JAX package's restored
``state.params`` for ``results/<model>/rl_model_best``, keyed by its flax
path; ``<model>_state.npz`` (for ``mp_unicycle``) every array of the whole
``TrainState``: ``params``, ``target_params`` and the optimizer's state
(``opt_state/1/0/{count,mu,nu}``, Adam behind the clip's chain), keyed by
its path; ``<run>_test_reference.npz`` holds, for each evaluated configuration,
each test case's outcome, steps (successes; -1 otherwise) and discounted
return from the JAX package's ``Explorer.run_cases``. Both are written by
``tests/test_torch_checkpoint_export.py --write``, which also holds the
weights equal to the checkpoints.

A whole state becomes a checkpoint of the port that a run resumes (the
counterpart of copying the reference's ``rl_model_best`` into a run's
``rl_model``, ``configs/icra_benchmark/mp_unicycle_anneal.py``)::

    python -m relationalgraphlearning_tpu_torch.checkpoints mp_unicycle \
        data/mp_unicycle_anneal/rl_model
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from relationalgraphlearning_tpu_torch.convert import tree_from_flat

DIR = Path(__file__).resolve().parent


def weights_path(model: str) -> Path:
    path = DIR / f"{model}.npz"
    if not path.exists():
        known = sorted(p.stem for p in DIR.glob("*.npz")
                       if not p.stem.endswith("_test_reference"))
        raise FileNotFoundError(f"no exported weights for {model!r} in {DIR}"
                                f"; exported: {known}")
    return path


def load_flax_tree(model: str) -> dict:
    """The flax param tree of ``model`` as nested dicts of numpy arrays."""
    with np.load(weights_path(model)) as z:
        return tree_from_flat({k: z[k] for k in z.files})


def load_test_reference(run: str) -> dict:
    """{"outcome", "steps", "ret"} of each of the 500 test cases of the
    evaluated configuration ``run`` (e.g. ``mprl_td_d2_w4``)."""
    with np.load(DIR / f"{run}_test_reference.npz") as z:
        return {k: z[k] for k in z.files}


def write_rl_model(model: str, path: str, device="cpu") -> dict:
    """Write ``model``'s exported ``TrainState`` (``<model>_state.npz``) as
    the port's MP-RGL checkpoint ``path`` (``path/state.pt``) -> the state
    written. The config of the run that trained it
    (``results/<model>/config.py`` of the repository) builds the nets (the
    parameters' order) and names the RL optimizer's rate, which optax keeps
    out of the state."""
    from relationalgraphlearning_tpu_torch.configs.base import (
        load_config_module)
    from relationalgraphlearning_tpu_torch.convert import (
        mprl_train_state_from_flax)
    from relationalgraphlearning_tpu_torch.policies.factory import (
        make_policy)
    from relationalgraphlearning_tpu_torch.training import checkpoint

    config = load_config_module(
        str(DIR.parents[1] / "results" / model / "config.py"))
    policy = make_policy("model_predictive_rl", config.policy, config.env,
                         device=device)
    names = [n for n, _ in policy.networks.named_parameters()]
    if config.train.optimizer != "adam":
        raise ValueError(f"{model}'s config trains with "
                         f"{config.train.optimizer}; its state is Adam's")
    state = mprl_train_state_from_flax(load_flax_tree(f"{model}_state"),
                                       names,
                                       config.train.rl_learning_rate,
                                       device=device)
    checkpoint.save_state(path, state)
    return state
