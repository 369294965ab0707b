"""Evaluation CLI of the PyTorch port (port of ``relationalgraphlearning_tpu/cli/test.py``
for the MP-RGL policy).

Loads the config from ``--model_dir`` (the JAX package's ``config.py``,
read by the port's loader) and the weights exported from its checkpoint
(``relationalgraphlearning_tpu_torch/checkpoints/<model>.npz``, the model
named by the directory's name), runs the seeded cases of ``--phase`` through
``Explorer.run_cases`` on the card (``--device cpu`` on the CPU) and prints
the same record as the reference. The record goes to ``--out`` when given;
nothing is written into ``--model_dir``.

    python -m relationalgraphlearning_tpu_torch.cli.test \\
        --model_dir results/mprl_td [--planning_depth 1] [--test_size 500] \\
        [--device cpu] [--out eval.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

from relationalgraphlearning_tpu_torch import checkpoints
from relationalgraphlearning_tpu_torch.configs.base import (
    Config, load_config_module)
from relationalgraphlearning_tpu_torch.envs.crowd_sim import CrowdSim
from relationalgraphlearning_tpu_torch.policies.model_predictive_rl import (
    ModelPredictiveRLPolicy)
from relationalgraphlearning_tpu_torch.training.explorer import Explorer

PLANNER = ("planning_depth", "planning_width", "sparse_search")
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


def build(config, model: str, device):
    """(env, policy with the exported weights of ``model``, explorer)."""
    env = CrowdSim(config.env, device=device)
    policy = ModelPredictiveRLPolicy(config.policy, config.env, device=device)
    policy.load_flax(checkpoints.load_flax_tree(model))
    return env, policy, Explorer(env, policy, config.policy.gamma)


def main(argv=None):
    p = argparse.ArgumentParser(description="Evaluate an MP-RGL model with "
                                "the PyTorch port")
    p.add_argument("--policy", default="model_predictive_rl",
                   choices=["model_predictive_rl"])
    p.add_argument("--model_dir", required=True)
    p.add_argument("--phase", default="test", choices=["val", "test"])
    p.add_argument("--test_size", type=int, default=None)
    p.add_argument("--human_num", type=int, default=None)
    p.add_argument("--planning_depth", type=int, default=None)
    p.add_argument("--planning_width", type=int, default=None)
    p.add_argument("--sparse_search", action="store_true", default=None)
    p.add_argument("--rotation_constraint", type=float, default=None)
    p.add_argument("--rotation_samples", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; the card unless asked (cpu)")
    p.add_argument("--out", default=None,
                   help="write the record to this JSON file")
    args = p.parse_args(argv)
    if not os.path.isdir(args.model_dir):
        p.error(f"no model directory {args.model_dir}")

    config, overrides = configure(
        args.model_dir, args.human_num,
        **{k: getattr(args, k) for k in PLANNER + ACTION_SPACE})
    model = os.path.basename(os.path.normpath(args.model_dir))
    env, policy, explorer = build(config, model, args.device)
    sim = config.env.sim
    offset = sim.test_seed_offset if args.phase == "test" \
        else sim.val_seed_offset
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
          f"{ev.avg_min_dist:.3f} ({seconds:.1f} s on {args.device})",
          file=sys.stderr)
    record = {
        "policy": args.policy, "phase": args.phase, "cases": size,
        "checkpoint": "rl_model_best",  # its exported weights
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
    text = json.dumps(record, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return record


if __name__ == "__main__":
    with torch.no_grad():
        main()
