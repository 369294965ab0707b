"""One robot's decision: ``ModelPredictiveRLPolicy.predict`` on one joint
state, captured once as a graph at batch 1 (as ``tools/bench_extra.py``'s
``decide``), each decision timed from the host's call to the
``torch.cuda.synchronize()`` that ends it.

Set-up rolls the mix's seeded cases once through the evaluation path and
keeps the live joint states visited, step by step; the window replays them
in that order, one decision a call, from the first state again when they
run out. The reference judges a seeded sample of the window's decisions.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmarks.counters import flops
from benchmarks.drivers import common, mprl_judge
from benchmarks.drivers.eval import Driver as Eval
from benchmarks.reference import mprl as ref


def tiny(cfg: dict, traffic: dict) -> None:
    """Cut a configuration and mix in place to a CPU test's size: the
    states of 3 cases of 10 steps, up to 1,000 decisions judged."""
    traffic["cases"] = 3
    cfg["env"]["time_limit"] = 2.5
    traffic["check"]["decisions"] = 1000


class Driver:
    def __init__(self, ctx):
        self.ctx, self.traffic = ctx, ctx.traffic
        self.cfg = common.planned(ctx.config, ctx.traffic)
        self.latency: list = []
        self.kept: dict = {}

    def setup(self) -> None:
        from relationalgraphlearning_tpu_torch import types as T
        from relationalgraphlearning_tpu_torch.captured import Graphed
        roll = Eval(self.ctx)
        roll.build()  # the evaluation path at the mix's case count
        states = roll.trajectory()  # the states the window replays
        robots, humans = [], []
        for t in range(len(states) - 1):
            live = ~states[t][3]
            robots.append(states[t][0][live])
            humans.append(T.observable(states[t][1][live]))
        self.robots = torch.cat(robots).contiguous()
        self.humans = torch.cat(humans).contiguous()
        self.policy, self.arrays = roll.policy, roll.arrays
        del roll
        rng = common.check_rng(self.ctx.seed)
        self.picks = set(common.sample(rng, self.robots.shape[0],
                                       self.traffic["check"]["decisions"])
                         .tolist())

        def decide(r, h):
            return self.policy.predict(T.JointState(r, h))

        self.cuda = torch.device(self.ctx.device).type == "cuda"
        r0, h0 = self.robots[0], self.humans[0]
        self.decide = Graphed(decide, r0, h0) if self.cuda else decide
        self.decide(r0, h0)
        self.i = 0

    def call(self, win) -> None:
        i = self.i % self.robots.shape[0]
        r, h = self.robots[i], self.humans[i]
        timed = win.obs.traced and self.cuda
        if timed:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        with win.span("decision"):
            t0 = time.perf_counter()
            if timed:
                ev[0].record()
            out = self.decide(r, h)
            if timed:
                ev[1].record()
            if self.cuda:
                torch.cuda.synchronize()
            self.latency.append(time.perf_counter() - t0)
        if timed:
            win.sample("decision_device_ms", ev[0].elapsed_time(ev[1]))
        if i in self.picks and i not in self.kept:
            self.kept[i] = out.clone()
        self.i += 1
        win.count("decisions", 1)
        win.count("model_flops", flops.decision(self.cfg))

    def end_to_end(self, obs) -> dict:
        return {"decision_ms_p95":
                1000 * float(np.percentile(self.latency, 95))}

    def release(self) -> None:
        del self.policy, self.decide

    def check(self, control: bool = False) -> list:
        dev = self.ctx.device
        planner = ref.Planner(self.cfg, common.to_device(self.arrays, dev),
                              dev)
        idx = sorted(self.kept)
        robot, humans = self.robots[idx], self.humans[idx]
        if control:
            act = mprl_judge.control_actions(planner, robot, humans)
        else:
            act = torch.stack([self.kept[i] for i in idx]) if idx else \
                torch.zeros((0, 2), device=dev)
        gap = mprl_judge.decision_gap(planner, robot, humans, act)
        return [("decision_gap", gap,
                 self.traffic["check"]["limits"]["decision_gap"]),
                ("none_judged", float(not idx), 0.0)]
