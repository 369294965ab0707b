"""The one-step evaluation's faults: the decisions altered, the occupancy
maps zeroed, the starting states moved."""

from benchmarks.tests.faults.eval import half_the_envs_step, robot_stays


def flip_decisions(mp):
    from relationalgraphlearning_tpu_torch.policies.one_step import (
        OneStepLookaheadPolicy)
    orig = OneStepLookaheadPolicy.predict

    def predict(self, js, *a, **kw):
        return -orig(self, js, *a, **kw)
    mp.setattr(OneStepLookaheadPolicy, "predict", predict)


def maps_zeroed(mp):
    from relationalgraphlearning_tpu_torch.policies import state_transform
    orig = state_transform.build_occupancy_maps
    mp.setattr(state_transform, "build_occupancy_maps",
               lambda humans, *a: 0 * orig(humans, *a))


def start_moved(mp):
    from relationalgraphlearning_tpu_torch.envs import scenarios
    orig = scenarios.generate_cases

    def generate_cases(*a, **kw):
        robot, humans = orig(*a, **kw)
        humans = humans.copy()
        humans[..., 0] += 1e-3  # every human's x, a millimetre
        return robot, humans
    mp.setattr(scenarios, "generate_cases", generate_cases)


FAULTS = {"state unchanged": robot_stays,
          "half the batch": half_the_envs_step,
          "answer altered": flip_decisions,
          "occupancy maps zeroed": maps_zeroed,
          "start moved": start_moved}
