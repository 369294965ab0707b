"""The 500-case evaluation (``Explorer.run_cases``): every call resets the
mix's cases from their seeded scenarios and rolls them all for the step
limit, one captured decision and env step replayed a step, then reduces
the paper's metrics. Work: cases × steps env-steps a call.

The window calls ``run_cases`` itself. After set-up has captured the step
graph, the explorer's graph (the eager step on the CPU) is wrapped by a
recorder that keeps, of each call, the arguments and results of the first
step and of a few steps the seed picks: the program's own states,
unchanged.
The reference judges the starting states against its own scenarios
(exactly), and a seeded sample of the kept live steps' decisions and env
steps from the state the program was in.

The mix may plan the configuration's weights at another width
(``planning_width``): the program, the reference and the FLOP count all
take it.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmarks.counters import flops
from benchmarks.drivers import common, mprl_judge
from benchmarks.reference import mprl as ref
from benchmarks.reference import scenarios


def tiny(cfg: dict, traffic: dict) -> None:
    """Cut a configuration and mix in place to a CPU test's size: 3 cases
    of 10 steps, 4 states judged."""
    traffic["cases"] = 3
    cfg["env"]["time_limit"] = 2.5
    traffic["check"]["states"] = 4


class Driver:
    def __init__(self, ctx):
        self.ctx, self.traffic = ctx, ctx.traffic
        self.cfg = common.planned(ctx.config, ctx.traffic)

    def cases(self) -> np.ndarray:
        n = self.traffic["cases"]
        return self.ctx.seed * n + np.arange(n, dtype=np.int64)

    def build(self) -> None:
        """The policy with the checkpoint's weights and the explorer."""
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
        self.policy = make_policy("model_predictive_rl", config.policy,
                                  config.env, device=dev)
        self.policy.load_flax(tree_from_flat(self.arrays))
        self.explorer = Explorer(CrowdSim(config.env, device=dev),
                                 self.policy, config.policy.gamma,
                                 self.ctx.seed & common.SEED_MASK)
        self.offset = config.env.sim.test_seed_offset
        self.steps = config.env.max_steps

    def setup(self) -> None:
        self.build()
        ex = self.explorer
        ex.run_cases(self.offset, self.cases())  # captures, warms each shape
        rng, per_call = (common.check_rng(self.ctx.seed),
                         self.traffic["check"]["steps_per_call"])
        picks: set = set()

        def keep(n):  # each call's first step, and steps the seed draws
            t = n % self.steps
            if t == 0:
                picks.clear()
                picks.update((1 + common.sample(rng, self.steps - 1,
                                                per_call)).tolist())
            return t == 0 or t in picks
        self.recorder = common.Recorder(
            ex._graphs[self.traffic["cases"]] if self.cuda else ex.eval_step,
            keep)
        if self.cuda:
            ex._graphs[self.traffic["cases"]] = self.recorder
        else:  # the eager loop calls the step itself
            ex.eval_step = self.recorder

    def trajectory(self) -> list:
        """Every carry of one call of the mix's cases, step by step (for a
        set-up that needs the states visited; before ``setup``)."""
        ex = self.explorer
        carry = ex.initial_carry(self.offset, self.cases())
        step = ex.capture(carry) if self.cuda else ex.eval_step
        states = [tuple(t.clone() for t in carry)]
        for _ in range(self.steps):
            carry = step(*carry)
            states.append(tuple(t.clone() for t in carry))
        return states

    def call(self, win) -> None:
        with win.span("run_cases"):
            self.explorer.run_cases(self.offset, self.cases())
            if self.cuda:
                torch.cuda.synchronize()
        win.count("env_steps", self.traffic["cases"] * self.steps)
        win.count("model_flops", self.traffic["cases"] * self.steps
                  * flops.decision(self.cfg))

    def end_to_end(self, obs) -> dict:
        return {"eval_env_steps_per_s": obs.counters["env_steps"]
                / obs.window_s}

    def release(self) -> None:
        del self.policy, self.explorer

    # ----------------------------------------------------------- the check
    def sampled(self):
        """A seeded sample of the kept steps' live cases: robot, humans,
        step, and the program's next state (None when no case was live)."""
        rng = common.check_rng(self.ctx.seed)
        kept = [(inputs, outputs) for _, inputs, outputs
                in self.recorder.kept]
        live = [(k, int(b)) for k, (inputs, _) in enumerate(kept)
                for b in torch.nonzero(~inputs[3]).flatten().tolist()]
        picks = [live[i] for i in common.sample(
            rng, len(live), self.traffic["check"]["states"])]
        if not picks:
            return None

        def S(side, field):
            return torch.stack([kept[k][side][field][b] for k, b in picks])
        return dict(robot=S(0, 0), humans=S(0, 1), step=S(0, 2),
                    next_robot=S(1, 0), next_humans=S(1, 1), done=S(1, 3),
                    outcome=S(1, 4))

    def check(self, control: bool = False) -> list:
        dev = self.ctx.device
        P = common.to_device(self.arrays, dev)
        planner = ref.Planner(self.cfg, P, dev)
        cfg = scenarios.attrs(self.cfg["env"])
        keys = scenarios.case_key(self.ctx.seed & common.SEED_MASK,
                                  self.offset, self.cases())
        robot0, humans0 = (torch.as_tensor(a, device=dev) for a in
                           scenarios.generate_cases(keys, cfg))
        start = max(float((inputs[0] - robot0).abs().max())
                    + float((inputs[1] - humans0).abs().max())
                    for n, inputs, _ in self.recorder.kept
                    if n % self.steps == 0)
        s = self.sampled()
        if s is None:
            return [("start_err", start, 0.0), ("none_judged", 1.0, 0.0)]
        act = s["next_robot"][:, ref.VX:ref.VY + 1]
        if control:
            act = mprl_judge.control_actions(
                planner, s["robot"], s["humans"][..., :5])
            out = ref.in_precision(torch.bfloat16, ref.env_step,
                                   s["robot"], s["humans"], s["step"], act,
                                   self.cfg["env"])
            s.update(next_robot=out.robot, next_humans=out.humans,
                     done=out.done, outcome=out.outcome)
        gap = mprl_judge.decision_gap(planner, s["robot"],
                                      s["humans"][..., :5], act)
        err, bad = mprl_judge.step_errors(
            self.cfg["env"], s["robot"], s["humans"], s["step"], act,
            s["next_robot"], s["next_humans"], s["done"], s["outcome"])
        lim = self.traffic["check"]["limits"]
        return [("start_err", start, 0.0),
                ("decision_gap", gap, lim["decision_gap"]),
                ("step_err", err, lim["step_err"]),
                ("outcome_mismatch", float(bad), 0.0),
                ("none_judged", 0.0, 0.0)]
