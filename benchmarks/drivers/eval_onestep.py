"""The 500-case evaluation of a one-step lookahead policy (LM-SARL):
``Explorer.run_cases`` as in ``drivers/eval.py``, every call resetting the
mix's cases and rolling them to the step limit through the captured step
graph, with the policy the configuration names and its checkpoint's
weights. Work: cases × steps env-steps a call.

The reference (``reference/sarl.py``) judges the starting states against
its scenarios (exactly) and a seeded sample of the kept live steps: the
decision, by how far the reference's one-step return of the program's
action lies below its best of the action set (a near tie excused), and the
env step from the state the program was in.
"""

from __future__ import annotations

import torch

from benchmarks.counters import onestep
from benchmarks.drivers import common, eval as eval_driver, mprl_judge
from benchmarks.reference import mprl as ref
from benchmarks.reference import sarl
from benchmarks.reference import scenarios


def tiny(cfg: dict, traffic: dict) -> None:
    """Cut a configuration and mix in place to a CPU test's size: 8 cases
    of 20 steps, 24 states judged."""
    traffic["cases"] = 8
    cfg["env"]["time_limit"] = 5.0
    traffic["check"]["states"] = 24


class Driver(eval_driver.Driver):
    def build(self) -> None:
        """The configuration's policy with the checkpoint's weights and the
        explorer."""
        from relationalgraphlearning_tpu_torch.convert import tree_from_flat
        from relationalgraphlearning_tpu_torch.envs.crowd_sim import CrowdSim
        from relationalgraphlearning_tpu_torch.policies.factory import (
            make_policy)
        from relationalgraphlearning_tpu_torch.training.explorer import (
            Explorer)
        config = common.port_config(self.cfg)
        dev = self.ctx.device
        self.cuda = torch.device(dev).type == "cuda"
        self.arrays = common.checkpoint_arrays(self.cfg)
        self.policy = make_policy(config.policy.name, config.policy,
                                  config.env, device=dev)
        self.policy.load_flax(tree_from_flat(self.arrays))
        self.explorer = Explorer(CrowdSim(config.env, device=dev),
                                 self.policy, config.policy.gamma,
                                 self.ctx.seed & common.SEED_MASK)
        self.offset = config.env.sim.test_seed_offset
        self.steps = config.env.max_steps

    def call(self, win) -> None:
        with win.span("run_cases"):
            self.explorer.run_cases(self.offset, self.cases())
            if self.cuda:
                torch.cuda.synchronize()
        work = self.traffic["cases"] * self.steps
        win.count("env_steps", work)
        win.count("model_flops", work * onestep.decision(self.cfg))

    def check(self, control: bool = False) -> list:
        dev = self.ctx.device
        planner = sarl.OneStep(self.cfg, common.to_device(self.arrays, dev),
                               dev)
        keys = scenarios.case_key(self.ctx.seed & common.SEED_MASK,
                                  self.offset, self.cases())
        robot0, humans0 = (torch.as_tensor(a, device=dev) for a in
                           scenarios.generate_cases(
                               keys, scenarios.attrs(self.cfg["env"])))
        start = max(float((inputs[0] - robot0).abs().max())
                    + float((inputs[1] - humans0).abs().max())
                    for n, inputs, _ in self.recorder.kept
                    if n % self.steps == 0)
        s = self.sampled()
        if s is None:
            return [("start_err", start, 0.0), ("none_judged", 1.0, 0.0)]
        humans = s["humans"][..., :5]
        act = s["next_robot"][:, ref.VX:ref.VY + 1]
        if control:
            with mprl_judge.tf32():
                act = planner.decide(s["robot"], humans)[0]
            out = ref.in_precision(torch.bfloat16, ref.env_step,
                                   s["robot"], s["humans"], s["step"], act,
                                   self.cfg["env"])
            s.update(next_robot=out.robot, next_humans=out.humans,
                     done=out.done, outcome=out.outcome)
        _, q = planner.decide(s["robot"], humans)
        gap = float(planner.gap(q, act).max())
        err, bad = mprl_judge.step_errors(
            self.cfg["env"], s["robot"], s["humans"], s["step"], act,
            s["next_robot"], s["next_humans"], s["done"], s["outcome"])
        lim = self.traffic["check"]["limits"]
        return [("start_err", start, 0.0),
                ("decision_gap", gap, lim["decision_gap"]),
                ("step_err", err, lim["step_err"]),
                ("outcome_mismatch", float(bad), 0.0),
                ("none_judged", 0.0, 0.0)]
