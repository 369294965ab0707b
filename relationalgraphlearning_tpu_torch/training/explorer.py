"""Explorer: batched evaluation rollouts and their metrics, and the
auto-resetting collection that feeds training (port of
``relationalgraphlearning_tpu/training/explorer.py``).

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

``collect`` (``explorer.py:179-256``) steps B envs ``num_steps`` times;
an env that ends an episode resets at once to its next case (env b plays
cases b, b + B, b + 2B, ...), so every step yields a transition. The
reference draws a reset's scenario inside its program; here the phase's
scenarios are generated on the host into a table on the device
(``CaseTable``, the same bits as ``CrowdSim.reset``), grown between
iterations, and a reset is a gather from it: one step (decision, env step,
the record, the reset) syncs nothing and is captured once as a CUDA graph
per (B, steps), writing its carry and trajectory in place. ε-exploration
reads the iteration's draws ([steps, B] action indices and uniforms) and ε
from tensors, so one graph serves every ε. ``update_memory`` turns a
trajectory into Monte-Carlo (imitation) or one-step TD (RL) targets and
pushes it; ``count_episodes`` reduces its finished episodes.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch import Tensor

from relationalgraphlearning_tpu_torch import types as T
from relationalgraphlearning_tpu_torch.captured import Graphed
from relationalgraphlearning_tpu_torch.envs import scenarios
from relationalgraphlearning_tpu_torch.envs.crowd_sim import CrowdSim, EnvState
from relationalgraphlearning_tpu_torch.geometry import holonomic_to_unicycle
from relationalgraphlearning_tpu_torch.training import replay_buffer as rb
from relationalgraphlearning_tpu_torch.utils import profiling


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


class RolloutCarry(NamedTuple):
    """What an auto-resetting collection carries, per env [B]."""

    robot: Tensor
    humans: Tensor
    step: Tensor
    done: Tensor
    outcome: Tensor
    case_counter: Tensor  # int64, the case the env resets to next
    ep_step: Tensor  # int32
    ep_return: Tensor

    @property
    def states(self) -> EnvState:
        return EnvState(*self[:5])


class Trajectory(NamedTuple):
    """A collection's record, [T, B, ...]."""

    robot: Tensor
    humans: Tensor  # observable [T, B, N, 5]
    action: Tensor
    reward: Tensor
    terminal: Tensor  # bool: the episode ended at this step
    outcome: Tensor
    dmin: Tensor
    next_robot: Tensor
    next_humans: Tensor
    ep_step: Tensor  # the step's index in its episode (0-based, at s_t)
    ep_return: Tensor  # discounted return through this step


class CaseTable:
    """The seeded scenarios of one phase, cases [0, capacity), on the env's
    device: robot [C, 9] and humans [C, N, 9] FullStates. ``ensure`` grows
    it on the host (doubling, with ``scenarios.generate_cases``, the same
    bits ``CrowdSim.reset`` places); a reset gathers from it."""

    def __init__(self, env: CrowdSim, phase_offset: int, base_seed: int = 0):
        self.env, self.phase_offset, self.base_seed = (env, phase_offset,
                                                       base_seed)
        n = env.cfg.sim.human_num
        self.robot = torch.zeros((0, 9), device=env.device)
        self.humans = torch.zeros((0, n, 9), device=env.device)

    @property
    def capacity(self) -> int:
        return self.robot.shape[0]

    def ensure(self, n: int) -> None:
        """Cases [0, n) in the table. Growing reallocates the table (a
        captured step that gathers from it must be captured again)."""
        cap = self.capacity
        if n <= cap:
            return
        with profiling.span("explorer.case_table_grow"):
            new = np.arange(cap, max(n, 2 * cap, 1024))
            robot, humans = scenarios.generate_cases(
                scenarios.case_key(self.base_seed, self.phase_offset, new),
                self.env.cfg)
            dev = self.env.device
            self.robot = torch.cat([self.robot,
                                    torch.from_numpy(robot).to(dev)])
            self.humans = torch.cat([self.humans,
                                     torch.from_numpy(humans).to(dev)])
        profiling.count("explorer.case_rows", new.shape[0])


class _CollectWork(NamedTuple):
    """The tensors one collection iteration reads and writes in place."""

    t: Tensor  # [1] int64, the trajectory row the next step writes
    epsilon: Tensor  # [] float32
    explore_idx: Tensor  # [T, B] int64 action indices
    explore_u: Tensor  # [T, B] uniforms
    carry: RolloutCarry
    traj: Trajectory

    def tensors(self) -> tuple:
        return (*self[:4], *self.carry, *self.traj)


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
        self._tables: dict = {}
        self._collect_graphs: dict = {}

    def _step(self, states: EnvState, actions: Tensor):
        if self.convert_to_unicycle:
            actions = holonomic_to_unicycle(
                actions, states.robot[..., T.THETA], self.rotation_constraint)
        return self.env.step(states, actions, kinematics=self.kinematics)

    def _act(self, states: EnvState, epsilon=0.0,
             generator: Optional[torch.Generator] = None,
             draws: Optional[tuple[Tensor, Tensor]] = None) -> Tensor:
        if getattr(self.policy, "query_env", False):
            # the privileged lookahead: the policy reads the env's own crowd
            # step for s' (the reference's query_env)
            return self.policy.predict_env(self.env, states, epsilon,
                                           generator, draws)
        js = T.JointState(states.robot, T.observable(states.humans))
        if draws is None:
            return self.policy.predict(js, epsilon, generator)
        return self.policy.predict(js, epsilon, generator, draws=draws)

    def _gamma_bar(self, robot: Tensor) -> Tensor:
        return torch.pow(self.gamma, self.cfg.time_step * robot[..., T.VPREF])

    # ------------------------------------------------------------------ eval
    def initial_carry(self, phase_offset: int, case_indices) -> EvalCarry:
        with profiling.span("explorer.reset"):  # the host's scenario draw
            states, _ = self.env.reset(case_indices, phase_offset,
                                       self.base_seed)
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
        dev = c.robot.device
        with profiling.device_phase("step.plan", dev):
            actions = self._act(states, epsilon, generator)
        with profiling.device_phase("step.env", dev):
            out = self._step(states, actions)
        with profiling.device_phase("step.book", dev):
            live = ~c.done
            gamma_t = torch.pow(self.gamma, c.step.to(torch.float32)
                                * self.cfg.time_step * c.robot[..., T.VPREF])
            danger = (live & (out.dmin < self.cfg.reward.discomfort_dist)
                      & ~out.state.done)
            book = (c.ep_return + torch.where(live, gamma_t * out.reward,
                                              0.0),
                    c.danger_steps + danger,
                    c.danger_dmin + torch.where(danger, out.dmin, 0.0),
                    c.total_steps + live)
        return (*out.state, *book)

    def capture(self, carry: EvalCarry) -> Graphed:
        """The step graph for this many cases: captured on the first call
        (over ``carry``, which it leaves as it is) and kept."""
        B = carry.step.shape[0]
        if B not in self._graphs:
            self._graphs[B] = Graphed(self.eval_step, *carry,
                                      name="explorer.eval_step")
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

    # ------------------------------------------------------------ collection
    def case_table(self, phase_offset: int) -> CaseTable:
        if phase_offset not in self._tables:
            self._tables[phase_offset] = CaseTable(self.env, phase_offset,
                                                   self.base_seed)
        return self._tables[phase_offset]

    def init_carry(self, batch: int, phase_offset: int) -> RolloutCarry:
        """A fresh auto-reset carry: env b starts case b, then strides by
        B (``explorer.py:179-192``)."""
        table = self.case_table(phase_offset)
        table.ensure(batch)
        dev = table.robot.device
        izeros = torch.zeros(batch, dtype=torch.int32, device=dev)
        return RolloutCarry(
            robot=table.robot[:batch].clone(),
            humans=table.humans[:batch].clone(),
            step=izeros, done=torch.zeros(batch, dtype=torch.bool,
                                          device=dev),
            outcome=torch.full((batch,), T.OUTCOME_NOTHING,
                               dtype=torch.int32, device=dev),
            case_counter=torch.arange(batch, 2 * batch, device=dev),
            ep_step=izeros.clone(),
            ep_return=torch.zeros(batch, device=dev))

    def draws(self, generator: torch.Generator, num_steps: int, batch: int
              ) -> tuple[Tensor, Tensor]:
        """One iteration's exploration draws from ``generator``: action
        indices in [0, A) and uniforms, each [num_steps, batch]."""
        dev = generator.device
        return (torch.randint(0, self.policy.action_space.shape[0],
                              (num_steps, batch), generator=generator,
                              device=dev),
                torch.rand((num_steps, batch), generator=generator,
                           device=dev))

    def _work(self, batch: int, num_steps: int) -> _CollectWork:
        dev, n = self.env.device, self.cfg.sim.human_num

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        i32 = torch.int32
        carry = RolloutCarry(z(batch, 9), z(batch, n, 9), z(batch, dtype=i32),
                             z(batch, dtype=torch.bool), z(batch, dtype=i32),
                             z(batch, dtype=torch.int64), z(batch, dtype=i32),
                             z(batch))
        Tb = (num_steps, batch)
        traj = Trajectory(z(*Tb, 9), z(*Tb, n, 5), z(*Tb, 2), z(*Tb),
                          z(*Tb, dtype=torch.bool), z(*Tb, dtype=i32),
                          z(*Tb), z(*Tb, 9), z(*Tb, n, 5), z(*Tb, dtype=i32),
                          z(*Tb))
        return _CollectWork(z(1, dtype=torch.int64), z(),
                            z(*Tb, dtype=torch.int64), z(*Tb), carry, traj)

    @torch.no_grad()
    def _collect_step(self, w: _CollectWork, table: CaseTable,
                      stride: Optional[int] = None) -> None:
        """One decision, env step, record and auto-reset of every env,
        written in place into ``w`` (``explorer.py:205-256``). A reset env
        moves on by ``stride`` cases: the batch's size, or the global
        batch's when ``w`` holds one rank's envs of it
        (``sharding.ParallelCollect``)."""
        c, row = w.carry, w.t
        states = c.states
        dev = c.robot.device
        with profiling.device_phase("collect.plan", dev):
            draws = (w.explore_idx.index_select(0, row)[0],
                     w.explore_u.index_select(0, row)[0])
            actions = self._act(states, w.epsilon, draws=draws)
        with profiling.device_phase("collect.env", dev):
            out = self._step(states, actions)
        with profiling.device_phase("collect.record", dev):
            gamma_t = torch.pow(self.gamma, c.ep_step.to(torch.float32)
                                * self.cfg.time_step
                                * c.robot[..., T.VPREF])
            ep_return = c.ep_return + gamma_t * out.reward
            record = Trajectory(
                robot=c.robot, humans=T.observable(c.humans),
                action=actions, reward=out.reward, terminal=out.done,
                outcome=out.state.outcome, dmin=out.dmin,
                next_robot=out.state.robot,
                next_humans=T.observable(out.state.humans),
                ep_step=c.ep_step, ep_return=ep_return)
            for dst, src in zip(w.traj, record):
                dst.index_copy_(0, row, src[None])
            # a finished env resets to its next case: the reference's
            # reset, then a select by done (explorer.py:227-244)
            done = out.done
            B = done.shape[0]
            stride = B if stride is None else stride
            fresh = (table.robot.index_select(0, c.case_counter),
                     table.humans.index_select(0, c.case_counter),
                     torch.zeros_like(c.step), torch.zeros_like(c.done),
                     torch.full_like(c.outcome, T.OUTCOME_NOTHING))
            new = [torch.where(done.reshape((B,) + (1,) * (old.dim() - 1)),
                               f, old) for f, old in zip(fresh, out.state)]
            new += [torch.where(done, c.case_counter + stride,
                                c.case_counter),
                    torch.where(done, 0, c.ep_step + 1),
                    torch.where(done, 0.0, ep_return)]
            for dst, src in zip(c, new):
                dst.copy_(src)
            row.add_(1)

    @profiling.spanned("explorer.collect")
    def collect(self, carry: RolloutCarry, num_steps: int,
                phase_offset: int, epsilon: float = 0.0,
                draws: Optional[tuple[Tensor, Tensor]] = None,
                graphed: Optional[bool] = None
                ) -> tuple[RolloutCarry, Trajectory]:
        """``num_steps`` auto-reset steps of the B envs of ``carry`` ->
        (the next carry, the trajectory [num_steps, B]).

        ε-exploration reads ``draws`` (``self.draws``); without them only
        ε = 0 runs. ``graphed``: None captures on the card and runs eagerly
        on the CPU; True on the CPU raises; False is the eager loop. Both
        run ``_collect_step`` on the same tensors.
        """
        B, on_card = carry.ep_step.shape[0], carry.robot.is_cuda
        if graphed is None:
            graphed = on_card
        if graphed and not on_card:
            raise ValueError("a graphed collection needs CUDA tensors")
        if draws is None and epsilon != 0:
            raise ValueError("exploration with epsilon > 0 needs draws")
        table = self.case_table(phase_offset)
        table.ensure(int(carry.case_counter.max()) + B * num_steps + 1)
        if graphed:
            key = (B, num_steps, phase_offset)
            w, graph, cap = self._collect_graphs.get(key, (None, None, None))
            if cap != table.capacity:  # first call, or the table grew
                w = self._work(B, num_steps)
                graph = Graphed(lambda: self._collect_step(w, table),
                                state=w.tensors(),
                                name="explorer.collect_step")
                self._collect_graphs[key] = (w, graph, table.capacity)
            step: Callable = graph
        else:
            w = self._work(B, num_steps)
            step = lambda: self._collect_step(w, table)  # noqa: E731
        for dst, src in zip(w.carry, carry):
            dst.copy_(src)
        w.t.zero_()
        w.epsilon.fill_(float(epsilon))
        if draws is not None:
            w.explore_idx.copy_(draws[0])
            w.explore_u.copy_(draws[1])
        for _ in range(num_steps):
            step()
        return (RolloutCarry(*(t.clone() for t in w.carry)),
                Trajectory(*(t.clone() for t in w.traj)))

    def collect_graph(self, batch: int, num_steps: int,
                      phase_offset: int) -> Optional[Graphed]:
        """The captured collection step of (batch, num_steps,
        phase_offset), once ``collect`` has captured it, else None."""
        return self._collect_graphs.get((batch, num_steps, phase_offset),
                                        (None, None, None))[1]

    # --------------------------------------------------------- target making
    @torch.no_grad()
    @profiling.spanned("explorer.update_memory")
    def update_memory(self, buffer: rb.ReplayBuffer, traj: Trajectory,
                      value_fn: Optional[Callable],
                      imitation_learning: bool) -> rb.ReplayBuffer:
        """Value targets of ``traj``, pushed into ``buffer``
        (``explorer.py:259-292``). Imitation: the Monte-Carlo return with
        the per-step discount γ^(Δt·v_pref), stopped at terminals; a trailing
        episode with no terminal after it is marked invalid. RL: the
        one-step TD target r + γ̄·(1 − terminal)·V(s') with ``value_fn``
        (the target net's value)."""
        gamma_bar = self._gamma_bar(traj.robot)  # [T, B]
        term = traj.terminal.to(torch.float32)
        if imitation_learning:
            values = torch.empty_like(traj.reward)
            g = torch.zeros_like(traj.reward[-1])
            for t in range(traj.reward.shape[0] - 1, -1, -1):
                g = traj.reward[t] + gamma_bar[t] * (1.0 - term[t]) * g
                values[t] = g
            seen_term_after = torch.flip(
                torch.cumsum(torch.flip(term, (0,)), 0), (0,)) > 0
            valid = seen_term_after.to(torch.float32)
        else:
            v_next = value_fn(traj.next_robot, traj.next_humans)
            values = traj.reward + gamma_bar * (1.0 - term) * v_next
            valid = torch.ones_like(traj.reward)

        def flat(a):
            return a.reshape((-1,) + a.shape[2:])

        return rb.push(buffer, rb.Transition(
            robot=flat(traj.robot), humans=flat(traj.humans),
            value=flat(values), reward=flat(traj.reward),
            next_robot=flat(traj.next_robot),
            next_humans=flat(traj.next_humans), valid=flat(valid),
            terminal=flat(term)))

    @profiling.spanned("explorer.count_episodes")
    def count_episodes(self, traj: Trajectory) -> dict:
        """Stats of the episodes that ended in ``traj``
        (``explorer.py:294-311``), 0-d tensors."""
        term = traj.terminal
        succ = term & (traj.outcome == T.OUTCOME_REACH_GOAL)
        coll = term & (traj.outcome == T.OUTCOME_COLLISION)
        tout = term & (traj.outcome == T.OUTCOME_TIMEOUT)
        n = torch.clamp(term.sum(), min=1)
        return {
            "episodes": term.sum(),
            "success_rate": succ.sum() / n,
            "collision_rate": coll.sum() / n,
            "timeout_rate": tout.sum() / n,
            "avg_nav_time": torch.where(
                succ, (traj.ep_step + 1) * self.cfg.time_step, 0.0).sum()
            / torch.clamp(succ.sum(), min=1),
            "avg_return": torch.where(term, traj.ep_return, 0.0).sum() / n,
        }
