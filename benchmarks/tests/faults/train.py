"""The training driver's faults: Adam's update never applied, half of each
minibatch left out (the mean over the rest), the decisions altered."""

from benchmarks.tests.faults._mprl import flip_decisions


def frozen_params(mp):
    from relationalgraphlearning_tpu_torch.training.trainer import (
        MPRLTrainer)
    mp.setattr(MPRLTrainer, "apply_grads", lambda self: None)


def half_minibatch(mp):
    from relationalgraphlearning_tpu_torch.training import replay_buffer
    orig = replay_buffer.sample
    mp.setattr(replay_buffer, "sample",
               lambda buf, idx: orig(buf, idx[:idx.shape[0] // 2]))


FAULTS = {"state unchanged": frozen_params,
          "half the batch": half_minibatch,
          "answer altered": flip_decisions}
