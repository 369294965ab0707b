"""Model-predictive RL policy, MP-RGL (port of
``relationalgraphlearning_tpu/policies/model_predictive_rl.py``).

81 discrete actions (5 speeds × 16 rotations + stop); ``action_clip`` keeps
the top ``planning_width`` actions by one-step value; the d-step planning
value

    V_planning(s, d, w) = max over clipped actions of
        V(s)/d + (d−1)/d · [ R̂(s,a) + γ^(Δt·v_pref) · V_planning(ŝ', d−1, w) ]

has the value estimator at its leaves, the learned dynamics for ŝ' and the
reward estimate R̂. As in the reference, the tree is evaluated level by
level: each level runs every branch × candidate action as one batched RGL
forward, for any leading batch dimensions, with no host sync and no
data-dependent branch.

Ties: ``jax.lax.top_k`` puts the lower index first among equal values and
``jnp.argmax`` takes the first maximum; a stable descending sort and
``torch.argmax`` do the same here.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import Tensor

from relationalgraphlearning_tpu_torch import types as T
from relationalgraphlearning_tpu_torch.configs.base import (
    EnvConfig, PolicyConfig)
from relationalgraphlearning_tpu_torch.convert import mprl_networks_from_flax
from relationalgraphlearning_tpu_torch.envs.reward import estimate_reward
from relationalgraphlearning_tpu_torch.models.mprl_networks import (
    MPRLNetworks)
from relationalgraphlearning_tpu_torch.policies.action_space import (
    build_action_group_index, build_action_space)
from relationalgraphlearning_tpu_torch.policies.base import epsilon_greedy


def _take(x: Tensor, idx: Tensor, trailing: int) -> Tensor:
    """x [..., A, *t] (``trailing`` dims t) at idx [..., W] along A."""
    dim = idx.dim() - 1
    index = idx.reshape(idx.shape + (1,) * trailing).expand(
        idx.shape + x.shape[dim + 1:])
    return torch.gather(x, dim, index)


class ModelPredictiveRLPolicy:
    trainable = True

    def __init__(self, policy_cfg: PolicyConfig, env_cfg: EnvConfig,
                 device="cuda"):
        self.cfg = policy_cfg
        self.env_cfg = env_cfg
        self.device = torch.device(device)
        self.gamma = policy_cfg.gamma
        self.kinematics = env_cfg.robot_kinematics
        mprl = policy_cfg.mprl
        self.depth = mprl.planning_depth
        self.width = mprl.planning_width
        self.do_action_clip = mprl.do_action_clip
        self.sparse_search = mprl.sparse_search
        self.action_space = torch.as_tensor(build_action_space(
            policy_cfg.action_space, env_cfg.robot_v_pref, self.kinematics),
            device=self.device)
        self.action_group_index = torch.as_tensor(build_action_group_index(
            policy_cfg.action_space, mprl.sparse_speed_samples,
            mprl.sparse_rotation_samples), dtype=torch.int64,
            device=self.device)
        self.networks = MPRLNetworks(
            policy_cfg, time_step=env_cfg.time_step,
            kinematics=self.kinematics).to(self.device).eval()
        self.networks.requires_grad_(False)

    def load_flax(self, tree: Mapping) -> "ModelPredictiveRLPolicy":
        """Load a flax ``MPRLNetworks`` param tree (all its keys, strictly)."""
        self.networks.load_state_dict(mprl_networks_from_flax(tree))
        return self

    # ------------------------------------------------------------- net calls
    def value(self, robot: Tensor, humans: Tensor) -> Tensor:
        return self.networks.value(robot, humans)

    def next_state(self, robot: Tensor, humans: Tensor, action: Tensor):
        return self.networks.next_state(robot, humans, action)

    def _gamma_bar(self, robot: Tensor) -> Tensor:
        return torch.pow(self.gamma,
                         self.env_cfg.time_step * robot[..., T.VPREF])

    def _all_actions(self, robot: Tensor) -> Tensor:
        return self.action_space.expand(robot.shape[:-1]
                                        + self.action_space.shape)

    # ------------------------------------------------------- batched planner
    def _expand(self, robot: Tensor, humans: Tensor, actions: Tensor):
        """Evaluate ``actions`` [..., A, 2] from robot [..., 9] and humans
        [..., N, 5] -> (reward estimate [..., A], next_robot [..., A, 9],
        next_humans [..., A, N, 5])."""
        A = actions.shape[-2]
        robot_b = robot[..., None, :].expand(robot.shape[:-1] + (A, 9))
        humans_b = humans[..., None, :, :].expand(
            humans.shape[:-2] + (A,) + humans.shape[-2:])
        r = estimate_reward(robot_b, humans_b, actions, self.env_cfg)
        next_robot, next_humans = self.next_state(robot_b, humans_b, actions)
        return r.reward, next_robot, next_humans

    def _clip_actions(self, robot: Tensor, humans: Tensor, width: int):
        """The top ``width`` actions by one-step value (``action_clip``) and
        their expansion: actions [..., width, 2], reward [..., width],
        next_robot [..., width, 9], next_humans [..., width, N, 5]."""
        acts = self._all_actions(robot)
        rew, nr, nh = self._expand(robot, humans, acts)
        v1 = rew + self._gamma_bar(robot)[..., None] * self.value(nr, nh)
        if self.sparse_search:
            idx = self._sparse_topk(v1, width)
        else:
            idx = torch.sort(v1, dim=-1, descending=True,
                             stable=True).indices[..., :width]
        return (_take(acts, idx, 1), _take(rew, idx, 0), _take(nr, idx, 1),
                _take(nh, idx, 2))

    def _sparse_topk(self, v1: Tensor, width: int) -> Tensor:
        """Group-diverse top-k (``action_clip``'s sparse_search): in
        descending one-step value, skip any action whose coarse (speed,
        rotation) bucket is already taken; ``width`` masked argmax rounds."""
        groups = self.action_group_index
        masked = v1
        picks = []
        for _ in range(width):
            i = torch.argmax(masked, dim=-1)
            picks.append(i)
            masked = torch.where(groups == groups[i][..., None],
                                 float("-inf"), masked)
        return torch.stack(picks, dim=-1)

    def v_planning(self, robot: Tensor, humans: Tensor, depth: int) -> Tensor:
        """Batched V_planning over any leading dimensions -> [...]."""
        v_cur = self.value(robot, humans)
        if depth <= 1:
            return v_cur
        if self.do_action_clip:
            _, rew, nr, nh = self._clip_actions(robot, humans, self.width)
        else:
            rew, nr, nh = self._expand(robot, humans,
                                       self._all_actions(robot))
        v_next = self.v_planning(nr, nh, depth - 1)
        returns = v_cur[..., None] / depth + (depth - 1) / depth * (
            rew + self._gamma_bar(robot)[..., None] * v_next)
        return returns.amax(-1)

    @torch.no_grad()
    def action_values(self, js: T.JointState) -> Tensor:
        """The planning return of every action [..., A] (width clipping
        applies only below the root)."""
        rew, nr, nh = self._expand(js.robot, js.humans,
                                   self._all_actions(js.robot))
        # V_planning counts the node it is called on (depth 1 is a leaf), so
        # a d-step plan is the root action plus V_planning(s', d)
        v_next = self.v_planning(nr, nh, self.depth)
        return rew + self._gamma_bar(js.robot)[..., None] * v_next

    @torch.no_grad()
    def predict(self, js: T.JointState, epsilon: float = 0.0,
                generator: Optional[torch.Generator] = None) -> Tensor:
        """The greedy planning action [..., 2], with ε-exploration."""
        if self.do_action_clip and self.depth > 1:
            acts, rew, nr, nh = self._clip_actions(js.robot, js.humans,
                                                   self.width)
            v_next = self.v_planning(nr, nh, self.depth)  # see action_values
            returns = rew + self._gamma_bar(js.robot)[..., None] * v_next
            best = torch.argmax(returns, dim=-1)
            greedy = _take(acts, best[..., None], 1)[..., 0, :]
        else:
            greedy = self.action_space[torch.argmax(self.action_values(js),
                                                    dim=-1)]
        return epsilon_greedy(greedy, self.action_space, epsilon, generator)

    def rgl_forwards_per_decision(self) -> int:
        """Six-node RGL forwards one ``predict`` runs for one state, counted
        from the tree's shapes (value and predictor graph models both)."""
        A, w, d = self.action_space.shape[0], self.width, self.depth
        pred = 0 if self.cfg.mprl.linear_state_predictor else 1

        def planning(nodes: int, depth: int) -> int:  # v_planning's forwards
            if depth <= 1:
                return nodes
            kids = nodes * (w if self.do_action_clip else A)
            clip = nodes * A * (1 + pred) if self.do_action_clip \
                else kids * pred
            return nodes + clip + planning(kids, depth - 1)

        if self.do_action_clip and d > 1:
            return A * (1 + pred) + planning(w, d)
        return A * pred + planning(A, d)
