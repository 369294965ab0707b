"""The PyTorch port's MP-RGL weights and per-case references, exported from
the JAX package's committed checkpoints.

The port imports neither JAX nor orbax, so it cannot read
``results/<model>/rl_model_best``. This file, which may import both, does:

    python tests/test_torch_checkpoint_export.py --write

restores each model's checkpoint through the JAX package as its evaluation
CLI does (``training/train_loop.build``, ``trainer.init``,
``training/checkpoint.restore``; ``cli/test.py:120-140``) and writes

- ``relationalgraphlearning_tpu_torch/checkpoints/<model>.npz``: every array
  of ``state.params`` (params only), keyed by its flax path
  (``params/value_graph_model/w_r/dense_0/kernel``, ...);
- ``relationalgraphlearning_tpu_torch/checkpoints/<run>_test_reference.npz``
  for each evaluated configuration: the outcome (``OUTCOME_*``), the steps
  of a successful case (-1 otherwise) and the discounted return of each of
  the 500 test cases, from the JAX package's ``Explorer.run_cases`` called
  on one case at a time (one jit, 500 calls; ``--runs`` picks a subset).

As a test it restores the checkpoints again (from a copy, so nothing under
``results/`` is touched) and holds every array of the committed ``.npz``
equal to them bit for bit, and the per-case records to the committed
``eval_test*.json`` (``--summary`` prints them side by side).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
CKPT_DIR = ROOT / "relationalgraphlearning_tpu_torch" / "checkpoints"
MODELS = ("mprl_td", "mp_unicycle_anneal")
# evaluated configuration -> (model, planner overrides, committed record)
RUNS = {
    "mprl_td": ("mprl_td", {}, "eval_test.json"),
    "mprl_td_d1": ("mprl_td", {"planning_depth": 1}, "eval_test_d1.json"),
    "mprl_td_d2_w4": ("mprl_td", {"planning_depth": 2, "planning_width": 4},
                      "eval_test_d2_w4.json"),
    "mp_unicycle_anneal": ("mp_unicycle_anneal", {}, "eval_test.json"),
}


def _jax():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def restore(model: str, overrides: dict | None = None):
    """(config, artifacts, state) of ``results/<model>/rl_model_best``,
    restored from a temporary copy of the checkpoint."""
    jax = _jax()
    from relationalgraphlearning_tpu.configs.base import load_config_module
    from relationalgraphlearning_tpu.training import checkpoint as ckpt
    from relationalgraphlearning_tpu.training.train_loop import build

    config = load_config_module(str(ROOT / "results" / model / "config.py"))
    if overrides:
        config = dataclasses.replace(config, policy=dataclasses.replace(
            config.policy, mprl=dataclasses.replace(
                config.policy.mprl, **overrides)))
    art = build(config, "model_predictive_rl")
    state = art.trainer.init(art.policy.init_params(jax.random.PRNGKey(0)))
    with tempfile.TemporaryDirectory() as tmp:
        copy = Path(tmp) / "rl_model_best"
        shutil.copytree(ROOT / "results" / model / "rl_model_best", copy)
        state = ckpt.restore(str(copy), state)
    return config, art, state


def flat_params(params) -> dict:
    """``state.params`` as {flax path: numpy array}."""
    jax = _jax()
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in leaves}


def per_case_reference(run: str) -> dict:
    """Outcome, steps (success only, else -1) and discounted return of each
    test case from ``Explorer.run_cases`` on one case at a time."""
    jax = _jax()
    import jax.numpy as jnp

    from relationalgraphlearning_tpu import types as T

    model, overrides, _ = RUNS[run]
    config, art, state = restore(model, overrides)
    sim = config.env.sim
    ev = jax.jit(lambda p, idx: art.explorer.run_cases(
        p, sim.test_seed_offset, idx, jax.random.PRNGKey(1)))
    n = sim.test_size
    outcome = np.zeros(n, np.int8)
    steps = np.full(n, -1, np.int16)
    ret = np.zeros(n, np.float32)
    for i in range(n):
        s = ev(state.params, jnp.asarray([i]))
        if float(s.success_rate) == 1.0:
            outcome[i] = T.OUTCOME_REACH_GOAL
            steps[i] = round(float(s.avg_nav_time) / config.env.time_step)
        elif float(s.collision_rate) == 1.0:
            outcome[i] = T.OUTCOME_COLLISION
        else:
            outcome[i] = T.OUTCOME_TIMEOUT
        ret[i] = float(s.avg_return)
    return dict(outcome=outcome, steps=steps, ret=ret)


@pytest.mark.parametrize("model", MODELS)
def test_exported_weights_equal_the_checkpoint(model):
    _, _, state = restore(model)
    want = flat_params(state.params)
    with np.load(CKPT_DIR / f"{model}.npz") as z:
        got = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        assert got[k].dtype == a.dtype == np.float32, k
        assert got[k].shape == a.shape, k
        assert np.array_equal(got[k], a), k
    assert sum(a.size for a in want.values()) == 33_506


@pytest.mark.parametrize("run", sorted(RUNS))
def test_per_case_reference_is_well_formed(run):
    with np.load(CKPT_DIR / f"{run}_test_reference.npz") as z:
        outcome, steps, ret = z["outcome"], z["steps"], z["ret"]
    assert outcome.shape == steps.shape == ret.shape == (500,)
    assert set(np.unique(outcome)) <= {1, 2, 3}
    success = outcome == 1
    assert (steps[success] > 0).all() and (steps[~success] == -1).all()
    assert np.isfinite(ret).all()


def summary(run: str) -> dict:
    """The per-case records of ``run`` reduced as the reference's
    ``EvalStats`` (rates, nav time over successes, mean return), beside the
    committed record of the same evaluation."""
    model, _, record = RUNS[run]
    with np.load(CKPT_DIR / f"{run}_test_reference.npz") as z:
        outcome, steps, ret = z["outcome"], z["steps"], z["ret"]
    success = outcome == 1
    got = dict(success_rate=success.mean(),
               collision_rate=(outcome == 2).mean(),
               timeout_rate=(outcome == 3).mean(),
               nav_time=steps[success].mean() * 0.25, ret=ret.mean())
    committed = json.loads((ROOT / "results" / model / record).read_text())
    return {k: (float(v), committed["return" if k == "ret" else k])
            for k, v in got.items()}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_per_case_reference_adds_up_to_the_committed_record(run):
    """The one-case-a-call records give the committed rates exactly; the
    reference's batched program and its one-case program may take another
    step in a case or two (nav time within 2 steps' worth over ~480
    successes) and differ in the returns' last digits."""
    s = summary(run)
    for k in ("success_rate", "collision_rate", "timeout_rate"):
        assert abs(s[k][0] - s[k][1]) < 1e-6, (k, s[k])
    assert abs(s["nav_time"][0] - s["nav_time"][1]) < 2 * 0.25 / 400
    assert abs(s["ret"][0] - s["ret"][1]) < 1e-4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", action="store_true",
                    help="write the weight and per-case reference files")
    ap.add_argument("--runs", nargs="*", default=sorted(RUNS),
                    choices=sorted(RUNS),
                    help="evaluated configurations to write references for")
    ap.add_argument("--no-weights", action="store_true",
                    help="write the per-case references only")
    ap.add_argument("--summary", action="store_true",
                    help="print each run's per-case records reduced beside "
                         "its committed record (no JAX needed)")
    args = ap.parse_args(argv)
    if args.summary:
        for run in args.runs:
            print(run, {k: f"{got:.6f} [{want:.6f}]"
                        for k, (got, want) in summary(run).items()})
        return 0
    if not args.write:
        ap.error("pass --write or --summary (run this file with pytest to "
                 "check)")
    CKPT_DIR.mkdir(exist_ok=True)
    if not args.no_weights:
        for model in MODELS:
            _, _, state = restore(model)
            np.savez(CKPT_DIR / f"{model}.npz", **flat_params(state.params))
            print(f"wrote {model}.npz", flush=True)
    for run in args.runs:
        t0 = time.perf_counter()
        ref = per_case_reference(run)
        np.savez(CKPT_DIR / f"{run}_test_reference.npz", **ref)
        print(f"wrote {run}_test_reference.npz in "
              f"{time.perf_counter() - t0:.0f} s: success "
              f"{np.mean(ref['outcome'] == 1):.3f}, collision "
              f"{np.mean(ref['outcome'] == 2):.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
