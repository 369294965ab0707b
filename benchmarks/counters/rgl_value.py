"""MP-RGL's value kernel (``csrc/rgl_value.cu``): its float32 operations
for one call, from the call's shapes and the groups of forwards that share
their humans, and for one decision of a d-level, w-wide planning tree.

The count is the work the planner's tree defines: a group's humans are
embedded once (their w_h rows, their rows of X·Wa and X·W1, their scores
against each other), then each forward's robot part. A group is the
forwards whose humans are one prediction: a node's A children in a clip,
and a parent's w kept children at the level below. It does not follow how
the kernel lays a call out (the kernel embeds the humans of a gathered
level once a forward), so a roofline read from it measures the same work
whatever implements the forward. The widths are the kernel's, the MP-RGL
graph every configuration of the port builds (``ops/rgl_value.py``'s
``check_networks``).
"""

from __future__ import annotations

from benchmarks.counters import flops


def call(n: int, groups: int, humans: int) -> int:
    """Float32 operations (two an FMA) of ``n`` forwards whose humans come
    in ``groups`` groups: each group's humans once (w_h, their rows of
    X·Wa and X·W1, their scores), then each forward's robot part (w_r, its
    rows of X·Wa and X·W1, its relation row and column, layer 1's rows,
    layer 2's row 0, the value network)."""
    N = humans
    group = N * (5 * 64 + 64 * 32 + 2 * 32 * 32) + N * N * 32
    forward = (9 * 64 + 64 * 32 + 2 * 32 * 32 + 32 * (2 * N + 1)
               + 32 * (N + 1) + 32 * 32 + 32 + N * 32 * (N + 3)
               + 32 * 32 + 32 * 32 + 32 * 100 + 100 * 100 + 100)
    return 2 * (groups * group + n * forward)


def levels(config: dict) -> list:
    """The value calls of one decision, in the planner's order, as
    (name, forwards, groups): the root's clip over all A actions (one
    group, the root's prediction), then each level of ``V_planning``: its
    nodes' own values (grouped by parent) and, above the leaves, the clip
    of each node's A children (grouped by node). The forwards sum to
    ``flops.planner_forwards``'s value forwards."""
    pol = config["policy"]
    a = pol["action_space"]
    A = 1 + a["speed_samples"] * a["rotation_samples"]
    d, w = pol["mprl"]["planning_depth"], pol["mprl"]["planning_width"]
    out = [("root clip", A, 1)]
    parents = 1
    for depth in range(d, 0, -1):
        nodes = parents * w
        out.append((f"nodes {d - depth + 1}", nodes, parents))
        if depth > 1:
            out.append((f"clip {d - depth + 1}", nodes * A, nodes))
        parents = nodes
    assert sum(n for _, n, _ in out) == flops.planner_forwards(config)[0]
    return out


def decision(config: dict) -> int:
    """The value kernel's operations for one decision of one state."""
    humans = config["env"]["sim"]["human_num"]
    return sum(call(n, g, humans) for _, n, g in levels(config))


def launches(config: dict) -> int:
    """The value kernel's launches a decision: one a call."""
    return len(levels(config))
