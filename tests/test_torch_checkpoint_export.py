"""The PyTorch port's weights and per-case references, exported from the JAX
package's committed checkpoints and records (MP-RGL and the paper's
baselines).

The port imports neither JAX nor orbax, so it cannot read
``results/<model>/rl_model_best``. This file, which may import both, does:

    python tests/test_torch_checkpoint_export.py --write

restores each model's checkpoint through the JAX package as its evaluation
CLI does (``training/train_loop.build``, ``trainer.init``,
``training/checkpoint.restore``; ``cli/test.py:120-140``) and writes

- ``relationalgraphlearning_tpu_torch/checkpoints/<model>.npz``: every array
  of ``state.params`` (params only), keyed by its flax path
  (``params/value_graph_model/w_r/dense_0/kernel``, ...);
- ``relationalgraphlearning_tpu_torch/checkpoints/<model>_state.npz`` for
  the models of ``STATE_MODELS`` (the start of a resumed run): every array
  of the whole ``TrainState`` (``params``, ``target_params``, the Adam
  state ``opt_state/1/0/{count,mu,nu}``), keyed by its path;
- ``relationalgraphlearning_tpu_torch/checkpoints/<run>_test_reference.npz``
  for each evaluated configuration: the outcome (``OUTCOME_*``), the steps
  of a successful case (-1 otherwise) and the discounted return of each of
  the 500 test cases (``--runs`` picks a subset). The MP-RGL runs' come
  from the JAX package's ``Explorer.run_cases`` called on one case at a
  time (one jit, 500 calls); the baselines' and ``mp_unicycle``'s from one
  program over all 500 cases, ``run_cases``'s own scan with its final
  carry kept (for ``mp_unicycle`` the program ``tools/diag_unicycle.py``
  runs), which is the program whose reduction the committed record is: its
  per-case results
  add up to that record to the last digit, while one case a call flips 2
  of ``orca_th10``'s 500 outcomes (ORCA's float32 LP near a tie). A run
  applies the JAX CLI's overrides (``--human_num``, the planner's,
  ``--orca_time_horizon``) after the restore, as that CLI does; ORCA runs
  restore nothing (an untrained policy).

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
# model -> (policy, parameter count)
MODELS = {
    "mprl_td": ("model_predictive_rl", 33_506),
    "mp_unicycle_anneal": ("model_predictive_rl", 33_506),
    "mp_unicycle": ("model_predictive_rl", 33_506),
    "cadrl": ("cadrl", 27_401),
    "sarl": ("sarl", 96_502),
    "sarl_om": ("sarl", 103_702),
    "lstm_rl": ("lstm_rl", 45_451),
    "rgl": ("rgl", 22_813),
}
# evaluated configuration -> (model directory, policy, the JAX CLI's
# overrides, committed record)
RUNS = {
    "mprl_td": ("mprl_td", "model_predictive_rl", {}, "eval_test.json"),
    "mprl_td_d1": ("mprl_td", "model_predictive_rl", {"planning_depth": 1},
                   "eval_test_d1.json"),
    "mprl_td_d2_w4": ("mprl_td", "model_predictive_rl",
                      {"planning_depth": 2, "planning_width": 4},
                      "eval_test_d2_w4.json"),
    "mp_unicycle_anneal": ("mp_unicycle_anneal", "model_predictive_rl", {},
                           "eval_test.json"),
    "mp_unicycle": ("mp_unicycle", "model_predictive_rl", {},
                    "eval_test.json"),
    "cadrl": ("cadrl", "cadrl", {"human_num": 5}, "eval_test.json"),
    "sarl": ("sarl", "sarl", {}, "eval_test.json"),
    "sarl_om": ("sarl_om", "sarl", {}, "eval_test.json"),
    "lstm_rl": ("lstm_rl", "lstm_rl", {}, "eval_test.json"),
    "rgl": ("rgl", "rgl", {}, "eval_test.json"),
    "orca": ("orca", "orca", {}, "eval_test.json"),
    "orca_th10": ("orca_th10", "orca", {"orca_time_horizon": 10.0},
                  "eval_test_th10.json"),
}
PLANNER = ("planning_depth", "planning_width")
# models whose whole training state is exported (``<model>_state.npz``)
STATE_MODELS = ("mp_unicycle",)


def _jax():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def configure(model: str, overrides: dict | None = None):
    """The JAX ``Config`` of ``results/<model>`` (its ``config.py``, else
    the defaults) with the CLI's ``overrides`` -> (config, policy kwargs)."""
    _jax()
    from relationalgraphlearning_tpu.configs.base import (
        Config, load_config_module)

    path = ROOT / "results" / model / "config.py"
    config = load_config_module(str(path)) if path.exists() else Config()
    over = dict(overrides or {})
    if "human_num" in over:
        config = dataclasses.replace(config, env=dataclasses.replace(
            config.env, sim=dataclasses.replace(
                config.env.sim, human_num=over.pop("human_num"))))
    planner = {k: over.pop(k) for k in PLANNER if k in over}
    if planner:
        config = dataclasses.replace(config, policy=dataclasses.replace(
            config.policy, mprl=dataclasses.replace(
                config.policy.mprl, **planner)))
    kwargs = {}
    if "orca_time_horizon" in over:
        kwargs["time_horizon"] = over.pop("orca_time_horizon")
    assert not over, over
    return config, kwargs


def restore(model: str, policy: str | None = None,
            overrides: dict | None = None):
    """(config, artifacts, state) of ``results/<model>/rl_model_best``,
    restored from a temporary copy of the checkpoint into a template built
    from the model's own config, then rebuilt with ``overrides``. A model
    with no checkpoint (ORCA) gets ``state`` None."""
    jax = _jax()
    from relationalgraphlearning_tpu.training import checkpoint as ckpt
    from relationalgraphlearning_tpu.training.train_loop import build

    policy = policy or MODELS[model][0]
    src = ROOT / "results" / model / "rl_model_best"
    state = None
    if src.exists():
        config, kwargs = configure(model)
        art = build(config, policy, policy_kwargs=kwargs)
        state = art.trainer.init(
            art.policy.init_params(jax.random.PRNGKey(0)))
        with tempfile.TemporaryDirectory() as tmp:
            copy = Path(tmp) / "rl_model_best"
            shutil.copytree(src, copy)
            state = ckpt.restore(str(copy), state)
    config, kwargs = configure(model, overrides)
    art = build(config, policy, policy_kwargs=kwargs)
    return config, art, state


def flat_params(params) -> dict:
    """``state.params`` as {flax path: numpy array}."""
    jax = _jax()
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in leaves}


def flat_state(state) -> dict:
    """The whole ``TrainState`` as {path: numpy array}, the path's parts
    joined by "/" (``opt_state/1/0/mu/params/...``)."""
    jax = _jax()

    def part(k):
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                return str(getattr(k, attr))
        raise TypeError(k)

    leaves, _ = jax.tree_util.tree_flatten_with_path(state)
    return {"/".join(map(part, path)): np.asarray(leaf)
            for path, leaf in leaves}


ONE_CASE_A_CALL = ("mprl_td", "mprl_td_d1", "mprl_td_d2_w4",
                   "mp_unicycle_anneal")


def _final_carry(explorer, params, phase_offset: int, case_indices, key):
    """``Explorer.run_cases``'s rollout with each case's outcome (a case not
    done a timeout), steps and discounted return kept."""
    jax = _jax()
    import jax.numpy as jnp

    from relationalgraphlearning_tpu import types as T
    from relationalgraphlearning_tpu.envs.scenarios import case_key

    states, _ = jax.vmap(explorer.env.reset)(jax.vmap(
        lambda i: case_key(explorer.base_seed, phase_offset, i))(
            case_indices))
    eps = jnp.asarray(0.0)

    def body(carry, _):
        states, key, ep_ret = carry
        key, sub = jax.random.split(key)
        out = explorer._step(states, explorer._act(params, states, sub, eps))
        gamma_t = explorer.gamma ** (
            states.step.astype(jnp.float32) * explorer.cfg.time_step
            * states.robot[..., T.VPREF])
        ep_ret = ep_ret + jnp.where(~states.done, gamma_t * out.reward, 0.0)
        return (out.state, key, ep_ret), None

    init = (states, key, jnp.zeros(case_indices.shape[0]))
    (final, _, ep_ret), _ = jax.lax.scan(body, init, None,
                                         explorer.cfg.max_steps)
    return (jnp.where(final.done, final.outcome, T.OUTCOME_TIMEOUT),
            final.step, ep_ret)


def per_case_reference(run: str) -> dict:
    """Outcome, steps (success only, else -1) and discounted return of each
    test case: from ``Explorer.run_cases`` on one case at a time for the
    runs of ``ONE_CASE_A_CALL``, else from one program over all cases."""
    jax = _jax()
    import jax.numpy as jnp

    from relationalgraphlearning_tpu import types as T

    model, policy, overrides, _ = RUNS[run]
    config, art, state = restore(model, policy, overrides)
    params = None if state is None else state.params
    sim = config.env.sim
    n = sim.test_size
    if run not in ONE_CASE_A_CALL:
        outcome, steps, ret = map(np.asarray, jax.jit(
            lambda p, idx: _final_carry(art.explorer, p, sim.test_seed_offset,
                                        idx, jax.random.PRNGKey(1)))(
                params, jnp.arange(n)))
        success = outcome == T.OUTCOME_REACH_GOAL
        return dict(outcome=outcome.astype(np.int8),
                    steps=np.where(success, steps, -1).astype(np.int16),
                    ret=ret.astype(np.float32))
    ev = jax.jit(lambda p, idx: art.explorer.run_cases(
        p, sim.test_seed_offset, idx, jax.random.PRNGKey(1)))
    outcome = np.zeros(n, np.int8)
    steps = np.full(n, -1, np.int16)
    ret = np.zeros(n, np.float32)
    for i in range(n):
        s = ev(params, jnp.asarray([i]))
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
    assert sum(a.size for a in want.values()) == MODELS[model][1]


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
    model, _, _, record = RUNS[run]
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
    """The per-case records give the committed rates exactly; the
    reference's batched program and its one-case program (the MP-RGL
    records) may take another step in a case or two (nav time within 2
    steps' worth over ~480 successes) and differ in the returns' last
    digits."""
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
    ap.add_argument("--models", nargs="*", default=list(MODELS),
                    choices=list(MODELS),
                    help="models to write weights for")
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
        for model in args.models:
            _, _, state = restore(model)
            np.savez(CKPT_DIR / f"{model}.npz", **flat_params(state.params))
            print(f"wrote {model}.npz", flush=True)
            if model in STATE_MODELS:
                np.savez(CKPT_DIR / f"{model}_state.npz", **flat_state(state))
                print(f"wrote {model}_state.npz", flush=True)
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
