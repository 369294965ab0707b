"""The MP-RGL planner's expansion with the humans predicted on every
(node, action) row, as ``next_state`` does: the reference that the
planner's shared prediction is held to, on the CPU and on the card. It
imports nothing of JAX."""

from relationalgraphlearning_tpu_torch.envs.reward import estimate_reward


def per_action_expand(pol):
    """A stand-in for ``pol._expand`` that predicts per action; set it as
    ``pol._expand`` to plan with it."""

    def expand(robot, humans, actions):
        A = actions.shape[-2]
        robot_b = robot[..., None, :].expand(robot.shape[:-1] + (A, 9))
        humans_b = humans[..., None, :, :].expand(
            humans.shape[:-2] + (A,) + humans.shape[-2:])
        r = estimate_reward(robot_b, humans_b, actions, pol.env_cfg)
        return (r.reward,) + pol.networks.next_state(robot_b, humans_b,
                                                     actions)

    return expand
