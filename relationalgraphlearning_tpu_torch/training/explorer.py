"""Explorer: batched evaluation rollouts and their metrics (port of
``run_cases`` from ``relationalgraphlearning_tpu/training/explorer.py``).

``run_cases`` rolls B seeded cases for all ``max_steps`` steps, as the
reference's ``lax.scan`` does: done envs freeze, nothing exits early. Each
step is one decision and one env step (``eval_step``), a function of fixed
shape tensors that syncs nothing with the host; on the card it is captured
once as a CUDA graph and replayed every step (``captured.Graphed``), as the
reference runs its rollout as one jitted program.

Metrics, as the reference reduces them: success, collision and timeout
rates (a case not done at the end is a timeout); navigation time over
successes only; the discounted return γ^(t·Δt·v_pref) over all cases; the
share of in-episode steps with dmin below the discomfort distance (the step
that ends an episode excluded) and the mean dmin over those steps.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import Tensor

from relationalgraphlearning_tpu_torch import types as T
from relationalgraphlearning_tpu_torch.captured import Graphed
from relationalgraphlearning_tpu_torch.envs.crowd_sim import CrowdSim, EnvState
from relationalgraphlearning_tpu_torch.geometry import holonomic_to_unicycle


class EvalStats(NamedTuple):
    success_rate: Tensor
    collision_rate: Tensor
    timeout_rate: Tensor
    avg_nav_time: Tensor  # over successful episodes
    avg_return: Tensor  # discounted cumulative reward, all episodes
    danger_frequency: Tensor  # share of in-episode steps with dmin < d_disc
    avg_min_dist: Tensor  # mean dmin over danger steps


class EvalCarry(NamedTuple):
    """What one evaluation step carries, per case [B]."""

    robot: Tensor
    humans: Tensor
    step: Tensor
    done: Tensor
    outcome: Tensor
    ep_return: Tensor
    danger_steps: Tensor  # int32
    danger_dmin: Tensor
    total_steps: Tensor  # int32, live steps

    @property
    def states(self) -> EnvState:
        return EnvState(*self[:5])

    @property
    def case_outcome(self) -> Tensor:
        """Each case's ``OUTCOME_*``, a case not done counted a timeout."""
        return torch.where(self.done, self.outcome, T.OUTCOME_TIMEOUT)


class Explorer:
    def __init__(self, env: CrowdSim, policy, gamma: float,
                 base_seed: int = 0,
                 rotation_constraint: float = 3.14159265 / 4):
        self.env = env
        self.policy = policy
        self.gamma = gamma
        self.base_seed = base_seed
        self.cfg = env.cfg
        self.kinematics = getattr(policy, "kinematics",
                                  None) or env.cfg.robot_kinematics
        # a holonomic demonstrator inside a unicycle-configured env has its
        # (vx, vy) converted to a feasible (v, dtheta), and the env steps
        # unicycle
        self.convert_to_unicycle = (self.kinematics == T.HOLONOMIC
                                    and env.cfg.robot_kinematics
                                    == T.UNICYCLE)
        self.rotation_constraint = rotation_constraint
        if self.convert_to_unicycle:
            self.kinematics = T.UNICYCLE
        self._graphs: dict = {}

    def _step(self, states: EnvState, actions: Tensor):
        if self.convert_to_unicycle:
            actions = holonomic_to_unicycle(
                actions, states.robot[..., T.THETA], self.rotation_constraint)
        return self.env.step(states, actions, kinematics=self.kinematics)

    def _act(self, states: EnvState, epsilon: float = 0.0,
             generator: Optional[torch.Generator] = None) -> Tensor:
        js = T.JointState(states.robot, T.observable(states.humans))
        return self.policy.predict(js, epsilon, generator)

    # ------------------------------------------------------------------ eval
    def initial_carry(self, phase_offset: int, case_indices) -> EvalCarry:
        states, _ = self.env.reset(case_indices, phase_offset, self.base_seed)
        B, dev = states.step.shape[0], states.robot.device
        zeros = torch.zeros(B, device=dev)
        izeros = torch.zeros(B, dtype=torch.int32, device=dev)
        return EvalCarry(*states, zeros, izeros, zeros.clone(),
                         izeros.clone())

    def eval_step(self, *carry: Tensor, epsilon: float = 0.0,
                  generator: Optional[torch.Generator] = None
                  ) -> tuple[Tensor, ...]:
        """One decision and one env step of every case: ``EvalCarry``'s
        tensors in, the next ones out."""
        c = EvalCarry(*carry)
        states = c.states
        out = self._step(states, self._act(states, epsilon, generator))
        live = ~c.done
        gamma_t = torch.pow(self.gamma, c.step.to(torch.float32)
                            * self.cfg.time_step * c.robot[..., T.VPREF])
        danger = (live & (out.dmin < self.cfg.reward.discomfort_dist)
                  & ~out.state.done)
        return (*out.state,
                c.ep_return + torch.where(live, gamma_t * out.reward, 0.0),
                c.danger_steps + danger,
                c.danger_dmin + torch.where(danger, out.dmin, 0.0),
                c.total_steps + live)

    def capture(self, carry: EvalCarry) -> Graphed:
        """The step graph for this many cases: captured on the first call
        (over ``carry``, which it leaves as it is) and kept."""
        B = carry.step.shape[0]
        if B not in self._graphs:
            self._graphs[B] = Graphed(self.eval_step, *carry)
        return self._graphs[B]

    def rollout(self, phase_offset: int, case_indices, epsilon: float = 0.0,
                generator: Optional[torch.Generator] = None,
                graphed: Optional[bool] = None) -> EvalCarry:
        """Every case rolled for ``max_steps`` steps -> the final carry.

        ``graphed``: None captures on the card and runs eagerly on the CPU;
        True on the CPU raises; False is the eager loop. A graphed rollout
        explores nothing (ε = 0, no generator).
        """
        carry = self.initial_carry(phase_offset, case_indices)
        on_card = carry.robot.is_cuda
        if graphed is None:
            graphed = on_card
        if graphed and not on_card:
            raise ValueError("a graphed rollout needs CUDA tensors")
        if graphed and (epsilon != 0 or generator is not None):
            raise ValueError("a graphed rollout runs with epsilon = 0 and no "
                             "generator")
        if graphed:
            step = self.capture(carry)
            for _ in range(self.cfg.max_steps):
                carry = step(*carry)
            return EvalCarry(*(t.clone() for t in carry))
        for _ in range(self.cfg.max_steps):
            carry = self.eval_step(*carry, epsilon=epsilon,
                                   generator=generator)
        return EvalCarry(*carry)

    def stats(self, final: EvalCarry) -> EvalStats:
        """The reference's metrics of a final carry."""
        success = final.outcome == T.OUTCOME_REACH_GOAL
        collision = final.outcome == T.OUTCOME_COLLISION
        timeout = (final.outcome == T.OUTCOME_TIMEOUT) | ~final.done
        nav_time = final.step.to(torch.float32) * self.cfg.time_step
        n = float(final.step.shape[0])
        n_succ = torch.clamp(success.sum(), min=1)
        return EvalStats(
            success_rate=success.sum() / n,
            collision_rate=collision.sum() / n,
            timeout_rate=timeout.sum() / n,
            avg_nav_time=torch.where(success, nav_time, 0.0).sum() / n_succ,
            avg_return=final.ep_return.mean(),
            danger_frequency=final.danger_steps.sum()
            / torch.clamp(final.total_steps.sum(), min=1),
            avg_min_dist=final.danger_dmin.sum()
            / torch.clamp(final.danger_steps.sum(), min=1))

    def run_cases(self, phase_offset: int, case_indices,
                  epsilon: float = 0.0,
                  generator: Optional[torch.Generator] = None,
                  graphed: Optional[bool] = None) -> EvalStats:
        """Roll each seeded case to the step limit; reduce the reference's
        metrics."""
        return self.stats(self.rollout(phase_offset, case_indices, epsilon,
                                       generator, graphed))
