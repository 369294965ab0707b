"""Model FLOPs of the cells' nets, counted from the configuration's shapes.

A dense layer of ``i`` inputs and ``o`` outputs counts 2·i·o per row (its
multiply-adds); biases, ReLUs, softmaxes, the reward and ORCA are not
counted. A backward pass counts twice its forward (the gradients of the
inputs and of the weights).
"""

from __future__ import annotations


def _mlp(in_dim: int, dims) -> int:
    widths = [in_dim, *dims]
    return sum(2 * a * b for a, b in zip(widths, widths[1:]))


def _gcn_widths(gcn: dict) -> list:
    dims = [gcn["gcn2_w1_dim"], gcn["final_state_dim"]]
    while len(dims) < gcn["num_layer"]:
        dims.append(gcn["final_state_dim"])
    return dims[:gcn["num_layer"]]


def rgl_forward(gcn: dict, humans: int) -> int:
    """One relational graph forward over a robot and ``humans`` nodes: the
    embeddings, then per layer X·Wa, (X·Wa)·Xᵀ, A·(H·W)."""
    n = humans + 1
    f = _mlp(gcn["robot_state_dim"], gcn["wr_dims"]) \
        + humans * _mlp(gcn["human_state_dim"], gcn["wh_dims"])
    d = gcn["wr_dims"][-1]
    for out in _gcn_widths(gcn):
        f += n * 2 * d * gcn["final_state_dim"]  # X·Wa
        f += n * n * 2 * gcn["final_state_dim"]  # scores
        f += n * 2 * d * out  # H·W
        f += n * n * 2 * out  # A·(H·W)
        d = out
    return f


def mprl_value(config: dict) -> int:
    """V(s): the value graph model and the value network on the robot's
    node."""
    pol = config["policy"]
    gcn, n = pol["gcn"], config["env"]["sim"]["human_num"]
    return rgl_forward(gcn, n) + _mlp(gcn["final_state_dim"],
                                      pol["mprl"]["value_network_dims"])


def mprl_predict(config: dict) -> int:
    """The state predictor: its graph model and the motion head on each
    human's node."""
    pol = config["policy"]
    gcn, n = pol["gcn"], config["env"]["sim"]["human_num"]
    return rgl_forward(gcn, n) + n * _mlp(
        gcn["final_state_dim"], pol["mprl"]["motion_predictor_dims"])


def planner_forwards(config: dict) -> tuple[int, int]:
    """(value forwards, predictor forwards) of one decision: the root's
    top-w clip over all A actions, then V_planning to depth d, each level
    clipping every node's A children to w. The predictor reads no action,
    so it runs once for each expanded node (the root and every node above
    the leaves: 1 + w + … + w^(d−1)) and the node's A children share it."""
    pol = config["policy"]
    a = pol["action_space"]
    A = 1 + a["speed_samples"] * a["rotation_samples"]
    d, w = pol["mprl"]["planning_depth"], pol["mprl"]["planning_width"]
    values, preds = A, 1  # the root's one-step values of every action
    nodes = w
    for depth in range(d, 0, -1):
        values += nodes  # V(s) of each node
        if depth > 1:
            values += nodes * A
            preds += nodes
            nodes *= w
    return values, preds


def decision(config: dict) -> int:
    v, p = planner_forwards(config)
    return v * mprl_value(config) + p * mprl_predict(config)


def sgd_step(config: dict) -> int:
    """One minibatch: forward and backward of V and the predictor, and the
    target net's V of the next states."""
    rows = config["train"]["batch_size"]
    v, p = mprl_value(config), mprl_predict(config)
    return rows * (3 * (v + p) + v)


def sparse_rgl_step(config: dict) -> int:
    """SparseRGL's value of every agent of the crowd: the embedding, then
    per layer H·Wa, K scores and K weighted sums of d, H·W, then the value
    network."""
    gcn, crowd = config["gcn"], config["crowd"]
    n, K = crowd["agents"], crowd["k_gnn"]
    f = _mlp(gcn["human_state_dim"], gcn["wh_dims"])
    d = gcn["wh_dims"][-1]
    for out in _gcn_widths(gcn):
        f += 2 * d * gcn["final_state_dim"] + 2 * 2 * d * K + 2 * d * out
        d = out
    f += _mlp(d, config["value_network_dims"])
    return n * f
