"""Model FLOPs of the one-step lookahead of SARL (with or without the
occupancy maps), counted from the configuration's widths as
``flops.py`` counts: 2·i·o a dense layer's row; the rotation, the maps'
binning, the softmax, the pooling and the reward are not counted.

A decision scores every action of the set in one forward: each action's
next state is a row a human through mlp1, mlp2 and the attention, then one
row through mlp3.
"""

from __future__ import annotations

from benchmarks.counters.flops import _mlp


def actions(config: dict) -> int:
    a = config["policy"]["action_space"]
    return 1 + a["speed_samples"] * a["rotation_samples"]


def row_width(config: dict) -> int:
    """A human's row: the rotated joint state's 13, then its map."""
    pol = config["policy"]
    om = pol["om_cell_num"] ** 2 * pol["om_channel_size"] \
        if pol["with_om"] else 0
    return 13 + om


def value_rows(config: dict) -> int:
    """Human rows through the value net (and maps built) a decision."""
    return actions(config) * config["env"]["sim"]["human_num"]


def human_row(config: dict) -> int:
    """mlp1, mlp2 and the attention on one human's row (the attention
    reads the embedding beside the crowd's mean with the global state)."""
    pol = config["policy"]
    e = pol["sarl_mlp1_dims"][-1]
    return (_mlp(row_width(config), pol["sarl_mlp1_dims"])
            + _mlp(e, pol["sarl_mlp2_dims"])
            + _mlp(2 * e if pol["sarl_with_global_state"] else e,
                   pol["sarl_attention_dims"]))


def action_row(config: dict) -> int:
    """mlp3 on the robot's six values and the pooled feature."""
    pol = config["policy"]
    return _mlp(6 + pol["sarl_mlp2_dims"][-1], pol["sarl_mlp3_dims"])


def decision(config: dict) -> int:
    return value_rows(config) * human_row(config) \
        + actions(config) * action_row(config)
