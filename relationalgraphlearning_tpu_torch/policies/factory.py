"""Policy registry (port of ``relationalgraphlearning_tpu/policies/factory.py``):
MP-RGL, the one-step value policies (``cadrl``, ``sarl``, ``lstm_rl``,
``gcn`` and its alias ``rgl``) and the three robot policies without
parameters."""

from __future__ import annotations

from relationalgraphlearning_tpu_torch.configs.base import (
    EnvConfig, PolicyConfig)
from relationalgraphlearning_tpu_torch.policies.model_predictive_rl import (
    ModelPredictiveRLPolicy)
from relationalgraphlearning_tpu_torch.policies.one_step import (
    CADRLPolicy, GCNPolicy, LstmRLPolicy, SARLPolicy)
from relationalgraphlearning_tpu_torch.policies.robot_policies import (
    LinearPolicy, ORCARobotPolicy, SocialForceRobotPolicy)

policy_factory = {
    "model_predictive_rl": ModelPredictiveRLPolicy,
    "cadrl": CADRLPolicy,
    "sarl": SARLPolicy,
    "lstm_rl": LstmRLPolicy,
    "gcn": GCNPolicy,
    "rgl": GCNPolicy,  # the model-free RGL one-step policy
    "orca": ORCARobotPolicy,
    "linear": LinearPolicy,
    "socialforce": SocialForceRobotPolicy,
}


def make_policy(name: str, policy_cfg: PolicyConfig, env_cfg: EnvConfig,
                **kwargs):
    """The policy ``name`` on ``device`` (a keyword; default the card)."""
    try:
        cls = policy_factory[name]
    except KeyError:
        raise KeyError(f"unknown policy {name!r}; available: "
                       f"{sorted(policy_factory)}") from None
    return cls(policy_cfg, env_cfg, **kwargs)
