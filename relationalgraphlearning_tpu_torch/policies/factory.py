"""Policy registry (port of ``relationalgraphlearning_tpu/policies/factory.py``).

The port has MP-RGL and the three robot policies without parameters. The
one-step value policies of the reference (``cadrl``, ``sarl``, ``lstm_rl``,
``gcn``, ``rgl``) are not ported yet (ROADMAP Queue A 9); their names raise
an error that says so.
"""

from __future__ import annotations

from relationalgraphlearning_tpu_torch.configs.base import (
    EnvConfig, PolicyConfig)
from relationalgraphlearning_tpu_torch.policies.model_predictive_rl import (
    ModelPredictiveRLPolicy)
from relationalgraphlearning_tpu_torch.policies.robot_policies import (
    LinearPolicy, ORCARobotPolicy, SocialForceRobotPolicy)

policy_factory = {
    "model_predictive_rl": ModelPredictiveRLPolicy,
    "orca": ORCARobotPolicy,
    "linear": LinearPolicy,
    "socialforce": SocialForceRobotPolicy,
}

NOT_PORTED = ("cadrl", "sarl", "lstm_rl", "gcn", "rgl")


def make_policy(name: str, policy_cfg: PolicyConfig, env_cfg: EnvConfig,
                **kwargs):
    """The policy ``name`` on ``device`` (a keyword; default the card)."""
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"policy {name!r} is not ported to PyTorch yet: the one-step "
            "policies wait for ROADMAP Queue A 9; ported: "
            f"{sorted(policy_factory)}")
    try:
        cls = policy_factory[name]
    except KeyError:
        raise KeyError(f"unknown policy {name!r}; available: "
                       f"{sorted(policy_factory)}") from None
    return cls(policy_cfg, env_cfg, **kwargs)
