"""Evaluation CLI of the PyTorch port (port of
``relationalgraphlearning_tpu/cli/test.py``) for every policy of the
factory: MP-RGL, the one-step baselines (``cadrl``, ``sarl``, ``lstm_rl``,
``gcn``/``rgl``) and the robot policies without parameters (``orca``,
``linear``, ``socialforce``).

Loads the config from ``--model_dir`` (its ``config.py``, read by the
port's loader; the defaults when it has none) and, for a trained policy,
the snapshot the reference picks (``snapshot``): ``il_model`` with ``--il``
or ``--checkpoint il``, ``rl_model`` with ``--checkpoint final``,
``rl_model_best`` with ``--checkpoint best`` or when it exists, else
``rl_model``. A directory with a checkpoint of the port's ``cli/train.py``
is read as such; one with none (a run of the JAX package) gives its
``rl_model_best`` through the weights exported from it
(``relationalgraphlearning_tpu_torch/checkpoints/<model>.npz``, the model
named by the directory's name). With no snapshot found, a trainable policy
is evaluated at a random init, with a warning and so named in the record.
It runs the seeded cases of ``--phase`` through ``Explorer.run_cases`` on
the card (``--device cpu`` on the CPU) and prints the same record as the
reference. The record goes to ``--out`` when given (into a directory
``--out`` as the reference's ``eval_<phase><suffix>.json``); nothing is
written into ``--model_dir``. ``--visualize`` rolls ``--test_case`` alone
and draws it (``--traj`` a PNG, ``--video_file`` a GIF or an mp4) in place
of the evaluation (``utils/render.py``).

    python -m relationalgraphlearning_tpu_torch.cli.test \\
        --model_dir results/mprl_td [--planning_depth 1] [--test_size 500] \\
        [--device cpu] [--out eval.json]
    python -m relationalgraphlearning_tpu_torch.cli.test \\
        --model_dir data/mp_separate_s0 --checkpoint final
    python -m relationalgraphlearning_tpu_torch.cli.test \\
        --model_dir results/mprl_td --visualize --test_case 3 \\
        --traj case3.png --video_file case3.gif
    python -m relationalgraphlearning_tpu_torch.cli.test --policy sarl \\
        --model_dir results/sarl
    python -m relationalgraphlearning_tpu_torch.cli.test --policy orca \\
        --model_dir results/orca_th10 --orca_time_horizon 10
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import subprocess
import sys
import time
from typing import Optional

import torch

from relationalgraphlearning_tpu_torch import checkpoints
from relationalgraphlearning_tpu_torch.configs.base import (
    Config, load_config_module)
from relationalgraphlearning_tpu_torch.envs.crowd_sim import CrowdSim
from relationalgraphlearning_tpu_torch.policies.factory import (
    make_policy, policy_factory)
from relationalgraphlearning_tpu_torch.training import checkpoint as ckpt
from relationalgraphlearning_tpu_torch.training.explorer import Explorer

log = logging.getLogger(__name__)

PLANNER = ("planning_depth", "planning_width", "sparse_search")
SNAPSHOTS = ("il_model", "rl_model", "rl_model_best")
RANDOM_INIT = "none (RANDOM INIT — no checkpoint found)"
ACTION_SPACE = ("rotation_constraint", "rotation_samples")


def _git_sha():
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stderr=subprocess.DEVNULL).decode().strip()
    except (OSError, subprocess.CalledProcessError):
        return None


def configure(model_dir: str, human_num=None, **overrides):
    """The model directory's config with the planner and action-space
    ``overrides`` (None: keep) -> (config, the overrides as the record
    lists them)."""
    cfg_path = os.path.join(model_dir, "config.py")
    config = load_config_module(cfg_path) if os.path.exists(cfg_path) \
        else Config()
    if human_num is not None:
        config = dataclasses.replace(config, env=dataclasses.replace(
            config.env, sim=dataclasses.replace(
                config.env.sim, human_num=human_num)))
    mprl_over = {k: overrides[k] for k in PLANNER
                 if overrides.get(k) is not None}
    if mprl_over:
        config = dataclasses.replace(config, policy=dataclasses.replace(
            config.policy, mprl=dataclasses.replace(
                config.policy.mprl, **mprl_over)))
    aspace_over = {k: overrides[k] for k in ACTION_SPACE
                   if overrides.get(k) is not None}
    if aspace_over:
        config = dataclasses.replace(config, policy=dataclasses.replace(
            config.policy, action_space=dataclasses.replace(
                config.policy.action_space, **aspace_over)))
        mprl_over.update(aspace_over)  # recorded with planner overrides
    return config, mprl_over


def snapshot(model_dir: str, il: bool = False,
             checkpoint: Optional[str] = None, exists=ckpt.exists) -> str:
    """The snapshot the reference evaluates (``cli/test.py:128-137``):
    ``il_model`` for ``il`` or ``checkpoint="il"``, ``rl_model`` for
    ``"final"``, ``rl_model_best`` for ``"best"`` or when it ``exists``,
    else ``rl_model``."""
    if il or checkpoint == "il":
        return "il_model"
    if checkpoint == "final":
        return "rl_model"
    if checkpoint == "best" or exists(os.path.join(model_dir,
                                                   "rl_model_best")):
        return "rl_model_best"
    return "rl_model"


def weights_of(model_dir: str, il: bool = False,
               checkpoint: Optional[str] = None) -> Optional[str]:
    """Where the weights of ``model_dir``'s ``snapshot`` come from: its
    torch checkpoint when the directory holds any (a run of the port); in a
    directory with none (a run of the JAX package, whose orbax snapshots
    the port does not read) its ``rl_model_best`` exported as
    ``checkpoints/<model>.npz``. None: no such snapshot (a random init)."""
    if any(ckpt.exists(os.path.join(model_dir, s)) for s in SNAPSHOTS):
        path = os.path.join(model_dir, snapshot(model_dir, il, checkpoint))
        return path if ckpt.exists(path) else None
    name = snapshot(model_dir, il, checkpoint, exists=os.path.isdir)
    if name == "rl_model_best":
        model = os.path.basename(os.path.normpath(model_dir))
        return str(checkpoints.weights_path(model))
    if os.path.isdir(os.path.join(model_dir, name)):
        raise FileNotFoundError(
            f"{os.path.join(model_dir, name)} is a snapshot of the JAX "
            "package; only its rl_model_best is exported for the port")
    return None


def loaded_name(weights: Optional[str], trainable: bool) -> str:
    """The record's ``"checkpoint"``: the snapshot loaded, as the
    reference names it."""
    if not trainable:
        return "none (untrained policy)"
    if weights is None:
        return RANDOM_INIT
    if weights.endswith(".npz"):
        return "rl_model_best"
    return os.path.basename(os.path.normpath(weights))


def build(config, policy_name: str, weights, device,
          policy_kwargs: dict | None = None):
    """(env, policy with the ``weights`` (``weights_of``; None: a policy
    without parameters, or a trainable one at a seeded random init),
    explorer)."""
    env = CrowdSim(config.env, device=device)
    policy = make_policy(policy_name, config.policy, config.env,
                         device=device, **(policy_kwargs or {}))
    if weights is None and policy_factory[policy_name].trainable:
        policy.init_params(torch.Generator().manual_seed(0))
    elif weights and weights.endswith(".npz"):
        model = os.path.basename(weights)[:-len(".npz")]
        policy.load_flax(checkpoints.load_flax_tree(model))
    elif weights:
        policy.networks.load_state_dict(ckpt.load(weights)["params"])
    return env, policy, Explorer(env, policy, config.policy.gamma)


def record_suffix(args) -> str:
    """The suffix of the reference's ``eval_<phase><suffix>.json``."""
    suffix = ""
    if args.planning_depth is not None:
        suffix += f"_d{args.planning_depth}"
    if args.planning_width is not None:
        suffix += f"_w{args.planning_width}"
    if args.sparse_search:
        suffix += "_sparse"
    if args.rotation_constraint is not None:
        suffix += f"_rc{args.rotation_constraint:g}"
    if args.rotation_samples is not None:
        suffix += f"_rs{args.rotation_samples}"
    if args.checkpoint:
        suffix += f"_{args.checkpoint}"
    if args.safety_space is not None:
        suffix += f"_ss{args.safety_space:g}"
    if args.orca_time_horizon is not None:
        suffix += f"_th{args.orca_time_horizon:g}"
    return suffix


def visualize(env, policy, offset: int, args):
    """``--visualize``: one test case rolled and drawn -> its
    ``EpisodeTrajectory``."""
    from relationalgraphlearning_tpu_torch.utils.render import (
        render_traj, render_video, rollout_trajectory)

    traj = rollout_trajectory(env, policy, offset, args.test_case)
    print(f"case {args.test_case}: outcome={traj.outcome_name} "
          f"nav_time={traj.nav_time:.2f}s return="
          f"{traj.cumulative_reward:.4f}", file=sys.stderr)
    for path, draw in ((args.traj, render_traj),
                       (args.video_file, render_video)):
        if path:
            draw(traj, path)
            print(f"wrote {path}", file=sys.stderr)
    return traj


def main(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a policy with the "
                                "PyTorch port")
    p.add_argument("--policy", default="model_predictive_rl",
                   choices=sorted(policy_factory))
    p.add_argument("--model_dir", required=True)
    p.add_argument("--il", action="store_true",
                   help="evaluate the IL snapshot")
    p.add_argument("--checkpoint", default=None,
                   choices=[None, "il", "best", "final"],
                   help="which snapshot to evaluate (default: best if "
                        "present, else final rl_model)")
    p.add_argument("--phase", default="test", choices=["val", "test"])
    p.add_argument("--test_size", type=int, default=None)
    p.add_argument("--human_num", type=int, default=None)
    p.add_argument("--planning_depth", type=int, default=None)
    p.add_argument("--planning_width", type=int, default=None)
    p.add_argument("--sparse_search", action="store_true", default=None)
    p.add_argument("--rotation_constraint", type=float, default=None)
    p.add_argument("--rotation_samples", type=int, default=None)
    p.add_argument("--safety_space", type=float, default=None,
                   help="the ORCA robot policy's safety space (only for "
                        "--policy orca)")
    p.add_argument("--orca_time_horizon", type=float, default=None,
                   help="the ORCA robot policy's time horizon (only for "
                        "--policy orca; the humans keep the env's)")
    p.add_argument("--visualize", action="store_true",
                   help="roll --test_case alone and draw it")
    p.add_argument("--test_case", type=int, default=0)
    p.add_argument("--traj", default=None,
                   help="save the trajectory plot to this PNG")
    p.add_argument("--video_file", default=None,
                   help="save the episode's animation (.gif; .mp4 needs "
                        "ffmpeg)")
    p.add_argument("--device", default="cuda",
                   help="torch device; the card unless asked (cpu)")
    p.add_argument("--out", default=None,
                   help="write the record to this JSON file, or into this "
                        "directory as eval_<phase><suffix>.json")
    args = p.parse_args(argv)
    if not os.path.isdir(args.model_dir):
        p.error(f"no model directory {args.model_dir}")
    policy_kwargs = {}
    if args.safety_space is not None:
        if args.policy != "orca":
            p.error("--safety_space only applies to --policy orca")
        policy_kwargs["safety_space"] = args.safety_space
    if args.orca_time_horizon is not None:
        if args.policy != "orca":
            p.error("--orca_time_horizon only applies to --policy orca")
        policy_kwargs["time_horizon"] = args.orca_time_horizon

    config, overrides = configure(
        args.model_dir, args.human_num,
        **{k: getattr(args, k) for k in PLANNER + ACTION_SPACE})
    trained = policy_factory[args.policy].trainable
    weights = weights_of(args.model_dir, args.il, args.checkpoint) \
        if trained else None
    checkpoint_loaded = loaded_name(weights, trained)
    if trained and weights is None:
        log.warning("no %s snapshot in %s — evaluating random init",
                    snapshot(args.model_dir, args.il, args.checkpoint),
                    args.model_dir)
    env, policy, explorer = build(config, args.policy, weights, args.device,
                                  policy_kwargs)
    sim = config.env.sim
    offset = sim.test_seed_offset if args.phase == "test" \
        else sim.val_seed_offset
    if args.visualize:
        return visualize(env, policy, offset, args)
    size = args.test_size or (sim.test_size if args.phase == "test"
                              else sim.val_size)
    t0 = time.perf_counter()
    ev = explorer.run_cases(offset, range(size))
    ev = type(ev)(*(float(x) for x in ev))
    seconds = time.perf_counter() - t0
    print(f"{args.phase} phase ({size} cases): success "
          f"{ev.success_rate:.3f}, collision {ev.collision_rate:.3f}, "
          f"timeout {ev.timeout_rate:.3f}, nav time {ev.avg_nav_time:.2f}s, "
          f"total reward {ev.avg_return:.4f}, danger freq "
          f"{ev.danger_frequency:.4f}, avg min separation in danger "
          f"{ev.avg_min_dist:.3f} ({seconds:.1f} s on {args.device}; "
          f"weights {weights or 'none'})",
          file=sys.stderr)
    record = {
        "policy": args.policy, "phase": args.phase, "cases": size,
        "checkpoint": checkpoint_loaded,
        "human_num": sim.human_num,
        "robot_kinematics": config.env.robot_kinematics,
        "git_sha": _git_sha(),
        "success_rate": ev.success_rate,
        "collision_rate": ev.collision_rate,
        "timeout_rate": ev.timeout_rate,
        "nav_time": ev.avg_nav_time,
        "return": ev.avg_return,
        "danger_frequency": ev.danger_frequency,
        "avg_min_dist": ev.avg_min_dist,
    }
    if overrides:
        record["planner_overrides"] = overrides
    if args.safety_space is not None:
        record["safety_space"] = args.safety_space
    if args.orca_time_horizon is not None:
        record["orca_time_horizon"] = args.orca_time_horizon
    text = json.dumps(record, indent=1)
    print(text)
    if args.out:
        out = args.out
        if os.path.isdir(out):
            out = os.path.join(out, f"eval_{args.phase}"
                               f"{record_suffix(args)}.json")
        with open(out, "w") as f:
            f.write(text)
    return record


if __name__ == "__main__":
    with torch.no_grad():
        main()
