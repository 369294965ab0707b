"""The 500-case evaluation of MP-RGL on a unicycle robot: ``drivers/eval.py``'s
evaluation (``Explorer.run_cases`` itself, graphed, the recorder around the
program's own step), judged by the non-holonomic plain reference
(``reference/mprl_unicycle.py``). Work: cases × steps env-steps a call.

A recorded step holds the states, not the action: the robot's next state
carries its heading and velocity after the turn. The judge takes as the
program's action the one of the reference's action space whose
propagation reproduces the next robot state exactly (none reads NaN, which
fails every comparison), then judges the decision by how far the
reference's planning return of that action lies below its best (a near
tie at the root's clip excused), and the env step from the state the
program was in.
"""

from __future__ import annotations

import torch

from benchmarks.drivers import common, eval as eval_driver, mprl_judge
from benchmarks.drivers.eval import tiny  # noqa: F401
from benchmarks.reference import mprl, mprl_unicycle as ref
from benchmarks.reference import scenarios


def step_errors(env: dict, robot, humans, step, action, next_robot,
                next_humans, done, outcome) -> tuple[float, int]:
    """(largest float difference, outcomes that differ) of the program's
    step against the reference's unicycle step on live envs."""
    if robot.shape[0] == 0:
        return 0.0, 0
    out = ref.env_step(robot, humans, step, action, env)
    err = float(torch.stack([(out.robot - next_robot).abs().max(),
                             (out.humans - next_humans).abs().max()]).max())
    bad = int(((out.done != done) | (torch.where(out.done, out.outcome, 0)
                                     != torch.where(done, outcome, 0))
               ).sum())
    return err, bad


class Driver(eval_driver.Driver):
    def check(self, control: bool = False) -> list:
        """The starts, and the sampled decisions and env steps, against the
        reference. ``control``: the reference in the program's place, its
        nets in TF32 and its env step in bfloat16."""
        dev, env = self.ctx.device, self.cfg["env"]
        planner = ref.Planner(self.cfg, common.to_device(self.arrays, dev),
                              dev)
        keys = scenarios.case_key(self.ctx.seed & common.SEED_MASK,
                                  self.offset, self.cases())
        robot0, humans0 = (torch.as_tensor(a, device=dev) for a in
                           scenarios.generate_cases(keys,
                                                    scenarios.attrs(env)))
        start = max(float((inputs[0] - robot0).abs().max())
                    + float((inputs[1] - humans0).abs().max())
                    for n, inputs, _ in self.recorder.kept
                    if n % self.steps == 0)
        s = self.sampled()
        if s is None:
            return [("start_err", start, 0.0), ("none_judged", 1.0, 0.0)]
        humans = s["humans"][..., :5]
        act = ref.recover_actions(planner.actions, s["robot"],
                                  s["next_robot"], env["time_step"])
        if control:
            act = mprl_judge.control_actions(planner, s["robot"], humans)
            out = mprl.in_precision(torch.bfloat16, ref.env_step,
                                    s["robot"], s["humans"], s["step"], act,
                                    env)
            s.update(next_robot=out.robot, next_humans=out.humans,
                     done=out.done, outcome=out.outcome)
        gap = mprl_judge.decision_gap(planner, s["robot"], humans, act)
        err, bad = step_errors(env, s["robot"], s["humans"], s["step"], act,
                               s["next_robot"], s["next_humans"], s["done"],
                               s["outcome"])
        lim = self.traffic["check"]["limits"]
        return [("start_err", start, 0.0),
                ("decision_gap", gap, lim["decision_gap"]),
                ("step_err", err, lim["step_err"]),
                ("outcome_mismatch", float(bad), 0.0),
                ("none_judged", 0.0, 0.0)]
