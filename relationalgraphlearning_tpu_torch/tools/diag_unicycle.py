"""Unicycle failure breakdown (counterpart of ``tools/diag_unicycle.py``).

Re-runs the 500-case test protocol on a trained unicycle MP-RGL model,
recording each step's robot and humans, the action, dmin, done and outcome,
then dissects every collision:

- the colliding human's bearing in the robot's heading frame (front, side
  or behind: a unicycle cannot strafe, so side and behind hits mean the
  kinematic constraint, front hits mean bad planning);
- the robot's speed at impact, and whether its turn was saturated
  (|dθ| at the rotation constraint) in the 4 steps before;
- the heading error against the goal's direction at impact;
- the time to impact and the closing speed;
- dmin the step before: inside the discomfort zone already (seen coming)
  or not.

The rollout is the port's evaluation path (``Explorer``'s decision and env
step), one step captured as a CUDA graph on the card. The weights are the
directory's torch ``rl_model_best`` (a run of the port) or, for a run of
the JAX package, its exported ``checkpoints/<name>.npz`` (``cli/test.py``'s
``weights_of``). Writes ``<model_dir>/diagnosis.json`` (or ``--out``) and
prints the summary as JSON.

    python -m relationalgraphlearning_tpu_torch.tools.diag_unicycle \\
        --model_dir results/mp_unicycle [--cases 500] [--out d.json] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from relationalgraphlearning_tpu_torch import types as T
from relationalgraphlearning_tpu_torch.captured import Graphed
from relationalgraphlearning_tpu_torch.cli import test as eval_cli
from relationalgraphlearning_tpu_torch.envs.crowd_sim import EnvState

POLICY = "model_predictive_rl"


def setup(model_dir: str, device):
    """(config, explorer) of ``model_dir`` with its weights, as the port's
    evaluation CLI builds them."""
    config, _ = eval_cli.configure(model_dir)
    weights = eval_cli.weights_of(model_dir)
    if weights is None:
        raise FileNotFoundError(f"no rl_model_best for {model_dir}")
    _, _, explorer = eval_cli.build(config, POLICY, weights, device)
    return config, explorer


@torch.no_grad()
def rollout(explorer, cases: int, graphed=None) -> dict:
    """Test cases [0, ``cases``) rolled for ``max_steps`` steps -> numpy
    records: ``robots`` [T, B, 9] and ``humans`` [T, B, N, 9] before each
    step, ``actions`` [T, B, 2], ``dmins``, ``dones``, ``outcomes`` [T, B]
    after it, and the final ``outcome`` and ``step`` [B]. ``graphed``: None
    captures the step on the card and runs eagerly on the CPU."""
    cfg = explorer.cfg
    states, _ = explorer.env.reset(range(cases), cfg.sim.test_seed_offset,
                                   explorer.base_seed)
    if graphed is None:
        graphed = states.robot.is_cuda

    def step(*carry):
        s = EnvState(*carry)
        actions = explorer._act(s)
        out = explorer._step(s, actions)
        return (*out.state, actions, out.dmin)

    fn = Graphed(step, *states) if graphed else step
    carry = tuple(states)
    rec = {k: [] for k in ("robots", "humans", "actions", "dmins", "dones",
                           "outcomes")}
    for _ in range(cfg.max_steps):
        outs = fn(*carry)
        for k, v in zip(rec, (carry[0], carry[1], outs[5], outs[6],
                              outs[3], outs[4])):
            rec[k].append(v.clone())
        carry = tuple(t.clone() for t in outs[:5])
    out = {k: torch.stack(v).cpu().numpy() for k, v in rec.items()}
    out.update(outcome=carry[4].cpu().numpy(), step=carry[2].cpu().numpy())
    return out


def diagnose(rec: dict, config, cases: int) -> tuple[dict, list]:
    """The collision rows and the summary of a ``rollout`` record, as the
    reference computes them (``tools/diag_unicycle.py:71-140``)."""
    robots, humans, acts, dmins = (rec["robots"], rec["humans"],
                                   rec["actions"], rec["dmins"])
    outcome, steps = rec["outcome"], rec["step"]
    rc = config.policy.action_space.rotation_constraint
    dt = config.env.time_step
    coll = np.where(outcome == T.OUTCOME_COLLISION)[0]
    rows = []
    for b in coll.tolist():
        t = int(steps[b]) - 1  # the step at which the collision landed
        r = robots[t, b]
        hx = humans[t, b]
        pr, vr, th = r[0:2], r[2:4], r[8]
        # the colliding human: the closest at impact
        d = np.linalg.norm(hx[:, 0:2] - pr, axis=-1) - hx[:, 4] - r[4]
        j = int(np.argmin(d))
        rel = hx[j, 0:2] - pr
        bear = (np.arctan2(rel[1], rel[0]) - th + np.pi) % (2 * np.pi) - np.pi
        sector = ("front" if abs(bear) < np.pi / 4 else
                  "side" if abs(bear) < 3 * np.pi / 4 else "behind")
        goal_dir = np.arctan2(r[6] - pr[1], r[5] - pr[0])
        herr = (goal_dir - th + np.pi) % (2 * np.pi) - np.pi
        t0 = max(0, t - 4)
        sat = bool(np.any(np.abs(acts[t0:t + 1, b, 1]) > 0.95 * rc))
        closing = float(np.linalg.norm(vr - hx[j, 2:4]))
        rows.append({
            "case": int(b), "t_impact_s": round((t + 1) * dt, 2),
            "bearing_deg": round(float(np.degrees(bear)), 1),
            "sector": sector,
            "robot_speed": round(float(np.linalg.norm(vr)), 3),
            "turn_saturated_last4": sat,
            "heading_err_deg": round(float(np.degrees(herr)), 1),
            "closing_speed": round(closing, 3),
            "dmin_prev_step": round(float(dmins[max(0, t - 1), b]), 3),
            "seen_coming": bool(dmins[max(0, t - 1), b]
                                < config.env.reward.discomfort_dist),
        })

    def frac(values, digits):
        return round(float(np.mean(values)) if rows else 0.0, digits)

    def median(values, digits):
        return round(float(np.median(values)) if rows else 0.0, digits)

    summary = {
        "cases": cases,
        "success": int((outcome == T.OUTCOME_REACH_GOAL).sum()),
        "collision": int(len(coll)),
        "timeout": int((outcome == T.OUTCOME_TIMEOUT).sum()),
        "sector_counts": {s: sum(1 for r in rows if r["sector"] == s)
                          for s in ("front", "side", "behind")},
        "turn_saturated_frac": frac(
            [r["turn_saturated_last4"] for r in rows], 3),
        "seen_coming_frac": frac([r["seen_coming"] for r in rows], 3),
        "stopped_at_impact_frac": frac(
            [r["robot_speed"] < 0.1 for r in rows], 3),
        "median_t_impact_s": median([r["t_impact_s"] for r in rows], 2),
        "median_closing_speed": median(
            [r["closing_speed"] for r in rows], 3),
        "median_abs_heading_err_deg": median(
            [abs(r["heading_err_deg"]) for r in rows], 1),
    }
    return summary, rows


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_dir", default="results/mp_unicycle")
    p.add_argument("--cases", type=int, default=500)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; the card unless asked (cpu)")
    args = p.parse_args(argv)

    config, explorer = setup(args.model_dir, torch.device(args.device))
    summary, rows = diagnose(rollout(explorer, args.cases), config,
                             args.cases)
    print(json.dumps(summary))
    out = args.out or os.path.join(args.model_dir, "diagnosis.json")
    with open(out, "w") as f:
        json.dump({"summary": summary, "collisions": rows}, f, indent=1)
    print(f"wrote {out}")
    return {"summary": summary, "collisions": rows}


if __name__ == "__main__":
    main()
