"""One-step lookahead value policies: CADRL, SARL, LSTM-RL and the
model-free RGL (port of ``relationalgraphlearning_tpu/policies/one_step.py``).

For every discrete action the robot moves analytically and the humans at
constant velocity; the return of the action is the estimated reward plus
γ^(Δt·v_pref)·V(s'), and the policy takes the first action of highest
return (``torch.argmax``, as ``jnp.argmax``), with ε-exploration. The whole
action sweep of all envs is one batched forward of the value net. With
``query_env`` the humans of s' come from the env's own crowd step instead
(``CrowdSim.lookahead_actions``).

Each policy's ``networks`` is one ``nn.Module`` whose ``forward(robot
[..., 9], humans [..., N, 5])`` returns the value [...]: it rotates the
joint state into the goal frame (``state_transform.rotate_joint_state``),
appends the occupancy maps when ``with_om``, and runs the value net on the
rows; ``GCNPolicy``'s runs the RGL value estimator on the raw states. So a
trainer's ``functional_call(policy.networks, params, (robot, humans))``
differentiates the whole of V.

With the port's profiling on (``utils/profiling.py``), a lookahead records
the device phases ``plan.lookahead`` (the reward estimate and the robot's
and humans' next states), ``plan.om`` (the occupancy maps) and
``plan.value_net`` (the rows through the value net), and counts the human
rows of the value net (``plan.value_rows``) and the maps built
(``plan.om_rows``); off, it launches what it launched without them.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import Tensor, nn

from relationalgraphlearning_tpu_torch import types as T
from relationalgraphlearning_tpu_torch.configs.base import (
    EnvConfig, PolicyConfig)
from relationalgraphlearning_tpu_torch.convert import (
    cadrl_from_flax, lstm_rl_from_flax, sarl_from_flax,
    value_estimator_from_flax)
from relationalgraphlearning_tpu_torch.envs.reward import estimate_reward
from relationalgraphlearning_tpu_torch.geometry import propagate_full_state
from relationalgraphlearning_tpu_torch.models.baseline_nets import (
    CADRLNet, LstmRLNet, SARLNet)
from relationalgraphlearning_tpu_torch.models.init import lecun_normal_
from relationalgraphlearning_tpu_torch.models.value_estimator import (
    ValueEstimator)
from relationalgraphlearning_tpu_torch.policies import state_transform as st
from relationalgraphlearning_tpu_torch.policies.action_space import (
    build_action_space)
from relationalgraphlearning_tpu_torch.policies.base import epsilon_greedy
from relationalgraphlearning_tpu_torch.utils import profiling


class RotatedValue(nn.Module):
    """V(robot, humans) of a value net that reads rotated rows (with the
    occupancy maps appended when ``cfg.with_om``)."""

    def __init__(self, model: nn.Module, cfg: PolicyConfig, kinematics: str):
        super().__init__()
        self.model = model
        self.kinematics = kinematics
        self.om = (cfg.om_cell_num, cfg.om_cell_size, cfg.om_channel_size) \
            if cfg.with_om else None

    def maps(self, humans: Tensor) -> Optional[Tensor]:
        """Each human's occupancy map [..., N, om_width], or None without
        ``with_om``."""
        return None if self.om is None else \
            st.build_occupancy_maps(humans, *self.om)

    def rows(self, robot: Tensor, humans: Tensor,
             maps: Optional[Tensor]) -> Tensor:
        """The rotated rows, with ``maps`` appended when given."""
        rows = st.rotate_joint_state(robot, humans, self.kinematics)
        return rows if maps is None else torch.cat([rows, maps], -1)

    def head(self, rows: Tensor) -> Tensor:
        """The value net on the rows -> the value [...]."""
        out = self.model(rows)
        return out[0] if isinstance(out, tuple) else out  # SARL: (v, w)

    def forward(self, robot: Tensor, humans: Tensor) -> Tensor:
        return self.head(self.rows(robot, humans, self.maps(humans)))

    def value(self, robot: Tensor, humans: Tensor) -> Tensor:
        return self(robot, humans)


class RawValue(nn.Module):
    """V(robot, humans) of a value net that reads the raw states."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, robot: Tensor, humans: Tensor) -> Tensor:
        return self.model(robot, humans)

    def value(self, robot: Tensor, humans: Tensor) -> Tensor:
        return self(robot, humans)


def om_width(cfg: PolicyConfig) -> int:
    """The width the occupancy maps add to each row."""
    if not cfg.with_om:
        return 0
    cells = cfg.om_cell_num ** 2
    return cells if cfg.om_channel_size == 1 else 3 * cells


class OneStepLookaheadPolicy:
    """The shared machinery; a subclass gives ``_networks`` and
    ``_from_flax``."""

    trainable = True

    def __init__(self, policy_cfg: PolicyConfig, env_cfg: EnvConfig,
                 device="cuda"):
        self.cfg = policy_cfg
        self.env_cfg = env_cfg
        self.device = torch.device(device)
        self.gamma = policy_cfg.gamma
        self.kinematics = env_cfg.robot_kinematics
        self.query_env = policy_cfg.query_env
        self.action_space = torch.as_tensor(build_action_space(
            policy_cfg.action_space, env_cfg.robot_v_pref, self.kinematics),
            device=self.device)
        self.networks = self._networks().to(self.device)
        self.eval()

    def _networks(self) -> nn.Module:
        raise NotImplementedError

    @staticmethod
    def _from_flax(tree: Mapping) -> dict:
        raise NotImplementedError

    def init_params(self, generator: torch.Generator
                    ) -> "OneStepLookaheadPolicy":
        """Fresh weights, drawn as flax's defaults draw them
        (``models/init.py``) from the CPU ``generator``."""
        lecun_normal_(self.networks, generator)
        return self

    def load_flax(self, tree: Mapping) -> "OneStepLookaheadPolicy":
        """Load the flax param tree of the value net (strictly)."""
        self.networks.model.load_state_dict(self._from_flax(tree))
        return self

    def train(self) -> "OneStepLookaheadPolicy":
        self.networks.train().requires_grad_(True)
        return self

    def eval(self) -> "OneStepLookaheadPolicy":
        self.networks.eval().requires_grad_(False)
        return self

    def value(self, robot: Tensor, humans: Tensor) -> Tensor:
        """V(s) [...] of robot [..., 9] and humans [..., N, 5]."""
        return self.networks(robot, humans)

    def _next_values(self, robot: Tensor, humans: Tensor) -> Tensor:
        """``value`` of the lookahead's next states, in the device phases
        ``plan.om`` (the occupancy maps) and ``plan.value_net`` (the rows
        through the value net), with the rows and maps counted."""
        net = self.networks
        if not isinstance(net, RotatedValue):
            with profiling.device_phase("plan.value_net", self.device):
                return net(robot, humans)
        with profiling.device_phase("plan.om", self.device):
            maps = net.maps(humans)
        with profiling.device_phase("plan.value_net", self.device):
            rows = net.rows(robot, humans, maps)
            del maps  # the net runs without the maps' own copy alive
            v = net.head(rows)
        n = humans.shape[:-1].numel()
        profiling.count("plan.value_rows", n)
        if net.om is not None:
            profiling.count("plan.om_rows", n)
        return v

    def _gamma_bar(self, robot: Tensor) -> Tensor:
        return torch.pow(self.gamma,
                         self.env_cfg.time_step * robot[..., T.VPREF])

    def _actions_like(self, robot: Tensor) -> Tensor:
        return self.action_space.expand(robot.shape[:-1]
                                        + self.action_space.shape)

    # ------------------------------------------------------------ prediction
    @torch.no_grad()
    def action_values(self, js: T.JointState) -> Tensor:
        """The one-step return of every action [..., A], the humans at
        constant velocity."""
        A = self.action_space.shape[0]
        robot = js.robot[..., None, :].expand(js.robot.shape[:-1] + (A, 9))
        humans = js.humans[..., None, :, :].expand(
            js.humans.shape[:-2] + (A,) + js.humans.shape[-2:])
        acts = self._actions_like(robot[..., 0, :])
        with profiling.device_phase("plan.lookahead", self.device):
            r = estimate_reward(robot, humans, acts, self.env_cfg)
            next_robot = propagate_full_state(
                robot, acts, self.env_cfg.time_step, self.kinematics)
            next_humans = torch.cat([
                T.position(humans) + T.velocity(humans)
                * self.env_cfg.time_step, humans[..., T.VX:]], -1)
        v_next = self._next_values(next_robot, next_humans)
        return r.reward + self._gamma_bar(js.robot)[..., None] * v_next

    def _choose(self, returns: Tensor, epsilon, generator, draws) -> Tensor:
        greedy = self.action_space[torch.argmax(returns, dim=-1)]
        return epsilon_greedy(greedy, self.action_space, epsilon, generator,
                              draws)

    @torch.no_grad()
    def predict(self, js: T.JointState, epsilon=0.0,
                generator: Optional[torch.Generator] = None,
                draws: Optional[tuple[Tensor, Tensor]] = None) -> Tensor:
        """The greedy action [..., 2], with ε-exploration
        (``epsilon_greedy``: draws from ``generator`` or given ``draws``)."""
        return self._choose(self.action_values(js), epsilon, generator,
                            draws)

    @torch.no_grad()
    def action_values_env(self, env, states) -> Tensor:
        """The one-step return of every action [B, A] with the humans moved
        by the env's own crowd step (``env.lookahead_actions``)."""
        with profiling.device_phase("plan.lookahead", self.device):
            rew, next_robot, next_obs = env.lookahead_actions(
                states, self.action_space)
        A = self.action_space.shape[0]
        v_next = self._next_values(next_robot, next_obs[:, None].expand(
            (next_obs.shape[0], A) + next_obs.shape[1:]))
        return rew + self._gamma_bar(states.robot)[..., None] * v_next

    @torch.no_grad()
    def predict_env(self, env, states, epsilon=0.0,
                    generator: Optional[torch.Generator] = None,
                    draws: Optional[tuple[Tensor, Tensor]] = None) -> Tensor:
        """``predict`` with the env-queried lookahead -> actions [B, 2]."""
        return self._choose(self.action_values_env(env, states), epsilon,
                            generator, draws)


class CADRLPolicy(OneStepLookaheadPolicy):
    """CADRL: the single-human pairwise value net, its minimum over the
    humans on a crowd."""

    def _networks(self):
        return RotatedValue(CADRLNet(13 + om_width(self.cfg),
                                     self.cfg.cadrl_mlp_dims),
                            self.cfg, self.kinematics)

    _from_flax = staticmethod(cadrl_from_flax)


class SARLPolicy(OneStepLookaheadPolicy):
    """SARL: attention pooling over the humans."""

    def _networks(self):
        c = self.cfg
        return RotatedValue(SARLNet(
            13 + om_width(c), c.sarl_mlp1_dims, c.sarl_mlp2_dims,
            c.sarl_attention_dims, c.sarl_mlp3_dims,
            c.sarl_with_global_state), c, self.kinematics)

    _from_flax = staticmethod(sarl_from_flax)

    @torch.no_grad()
    def attention_weights(self, js: T.JointState) -> Tensor:
        """SARL's attention over the humans [..., N]."""
        net = self.networks
        return net.model(net.rows(js.robot, js.humans,
                                  net.maps(js.humans)))[1]


class LstmRLPolicy(OneStepLookaheadPolicy):
    """LSTM-RL: the humans, farthest first, through an LSTM."""

    def _networks(self):
        c = self.cfg
        return RotatedValue(LstmRLNet(
            st.ROTATED_HUMAN_DIM + om_width(c), c.lstm_hidden_dim,
            c.lstm_mlp_dims, c.lstm_with_interaction_module, c.lstm_mlp1_dims),
            c, self.kinematics)

    _from_flax = staticmethod(lstm_rl_from_flax)


class GCNPolicy(OneStepLookaheadPolicy):
    """The model-free RGL (the paper's one-step ablation): the RGL value
    estimator over the raw states."""

    def _networks(self):
        return RawValue(ValueEstimator(self.cfg.gcn,
                                       self.cfg.mprl.value_network_dims))

    _from_flax = staticmethod(value_estimator_from_flax)
