"""The crowd driver's faults: the agents keep their velocities (ORCA's
step skipped), half of the crowd valued as the other half, the windows
shifted where the rebuild produces them."""

import torch


def crowd_stays(mp):
    from relationalgraphlearning_tpu_torch.envs import mega_crowd
    mp.setattr(mega_crowd, "centralized_orca_step_knn",
               lambda pos, vel, *a, **kw: vel)


def half_the_crowd_valued(mp):
    from relationalgraphlearning_tpu_torch.models.sparse_rgl import (
        SparseValueNet)
    orig = SparseValueNet.forward

    def forward(self, states, *a, **kw):
        v = orig(self, states, *a, **kw)
        half = v[:v.shape[0] // 2]
        return torch.cat([half, half])
    mp.setattr(SparseValueNet, "forward", forward)


def windows_shifted(mp):
    from relationalgraphlearning_tpu_torch.envs import mega_crowd
    orig = mega_crowd.rebuild

    def rebuild(*a, **kw):
        pos, other, cg, co, cand, em, cov = orig(*a, **kw)
        return pos, other, cg, co, torch.roll(cand, 1, -1), em, cov
    mp.setattr(mega_crowd, "rebuild", rebuild)


FAULTS = {"state unchanged": crowd_stays,
          "half the batch": half_the_crowd_valued,
          "answer altered": windows_shifted}
