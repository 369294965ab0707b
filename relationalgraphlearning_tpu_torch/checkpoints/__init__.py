"""Exported weights of the committed checkpoints (MP-RGL and the one-step
baselines), and per-case references of their 500-case test evaluations
(the ORCA robot's too).

``<model>.npz`` holds every array of the JAX package's restored
``state.params`` for ``results/<model>/rl_model_best``, keyed by its flax
path; ``<run>_test_reference.npz`` holds, for each evaluated configuration,
each test case's outcome, steps (successes; -1 otherwise) and discounted
return from the JAX package's ``Explorer.run_cases``. Both are written by
``tests/test_torch_checkpoint_export.py --write``, which also holds the
weights equal to the checkpoints.
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
