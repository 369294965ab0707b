"""The 10,240-agent crowd: ``MegaCrowdRollout`` (kNN ORCA and SparseRGL's
per-agent values every step, the graphs rebuilt every R steps, the block
backend's aggregation through kernel #1), one call rolling the seeded crowd
the mix's steps from the same start. Work: agents × steps agent-steps a
call.

Set-up draws the start and the net's weights from the seed on the device,
in one call each, and loads the weights into the program's net; one call
then builds the kernel and captures a chunk's steps as a graph.

The check reads one chunk of one call (the chunk the seed picks, of a call
drawn from the seed uniformly over the run's calls, one held at a time), as
its graph is handed it: the rebuilt graphs, windows and masks, and the
positions and velocities the chunk starts from, then what the chunk
returns. The
reference checks the graphs against an exact kNN search, rebuilds the
windows and masks from the program's graph, and rolls the chunk's steps
itself (kNN ORCA and SparseRGL by gathering) from the same start.
"""

from __future__ import annotations

import math

import torch

from benchmarks.counters import flops
from benchmarks.drivers import common, mprl_judge
from benchmarks.reference import crowd as ref
from benchmarks.reference.orca import ORCAParams


def make_weights(cfg: dict, gen: torch.Generator, device) -> dict:
    """SparseValueNet's weights, U(±1/√fan_in) as a Linear's default, from
    one draw on the device -> {name: tensor} keyed as the reference's."""
    gcn = cfg["gcn"]
    shapes = {}
    widths = [gcn["human_state_dim"], *gcn["wh_dims"]]
    for i, (a, b) in enumerate(zip(widths, widths[1:])):
        shapes[f"graph_model/w_h/dense_{i}"] = (a, b, True)
    d = gcn["wh_dims"][-1]
    shapes["graph_model/w_a"] = (d, gcn["final_state_dim"], False)
    dims = [gcn["gcn2_w1_dim"], gcn["final_state_dim"]][:gcn["num_layer"]]
    while len(dims) < gcn["num_layer"]:
        dims.append(gcn["final_state_dim"])
    for i, b in enumerate(dims):
        shapes[f"graph_model/gcn_w{i + 1}"] = (d, b, False)
        d = b
    widths = [d, *cfg["value_network_dims"]]
    for i, (a, b) in enumerate(zip(widths, widths[1:])):
        shapes[f"value_network/dense_{i}"] = (a, b, True)
    total = sum(a * b + (b if bias else 0) for a, b, bias in shapes.values())
    u = torch.rand(total, generator=gen, device=device) * 2 - 1
    out, at = {}, 0
    for name, (a, b, bias) in shapes.items():
        bound = 1.0 / math.sqrt(a)
        out[name + "/kernel"] = u[at:at + a * b].reshape(a, b) * bound
        at += a * b
        if bias:
            out[name + "/bias"] = u[at:at + b] * bound
            at += b
    return out


def port_state(weights: dict) -> dict:
    """The weights as the port's ``SparseValueNet.state_dict``."""
    out = {}
    for key, t in weights.items():
        name, kind = key.rsplit("/", 1)
        parts = name.split("/")
        mod = ".".join(
            f"layers.{p.split('_')[1]}" if p.startswith("dense_") else
            f"gcn_layers.{int(p[5:]) - 1}" if p.startswith("gcn_w") else p
            for p in parts)
        out[f"{mod}.{'weight' if kind == 'kernel' else 'bias'}"] = (
            t.t().contiguous() if kind == "kernel" else t.clone())
    return out


def tiny(cfg: dict, traffic: dict) -> None:
    """Cut a configuration and mix in place to a CPU test's size: 512
    agents in windows of B=64, C=448, 4 steps a call rebuilt every 2."""
    cfg["crowd"]["agents"] = 512
    traffic.update(block_B=64, block_C=448, steps_per_call=4,
                   rebuild_every=2)


class Driver:
    def __init__(self, ctx):
        self.ctx, self.cfg, self.traffic = ctx, ctx.config, ctx.traffic
        self.covs: list = []

    def setup(self) -> None:
        from relationalgraphlearning_tpu_torch.configs.base import GCNConfig
        from relationalgraphlearning_tpu_torch.envs.mega_crowd import (
            MegaCrowdRollout)
        from relationalgraphlearning_tpu_torch.models.sparse_rgl import (
            SparseValueNet)
        cr, tr, dev = self.cfg["crowd"], self.traffic, self.ctx.device
        self.cuda = torch.device(dev).type == "cuda"
        gen = torch.Generator(device=dev).manual_seed(self.ctx.seed)
        side = cr["side_m"] * math.sqrt(cr["agents"] / 10240.0)
        self.pos0 = (torch.rand((cr["agents"], 2), generator=gen,
                                device=dev) * 2 - 1) * side
        self.weights = make_weights(self.cfg, gen, dev)
        gcn = GCNConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in self.cfg["gcn"].items()})
        net = SparseValueNet(gcn, tuple(self.cfg["value_network_dims"]),
                             backend=tr["backend"]).to(dev)
        net.load_state_dict(port_state(self.weights))
        self.rollout = MegaCrowdRollout(
            cr["k_orca"], tr["backend"], tr["block_B"], tr["block_C"],
            tr["rebuild_every"], tr["packed"], net=net, device=dev,
            graphed=self.cuda)
        self.steps = tr["steps_per_call"]
        self.chunks = self.steps // tr["rebuild_every"]
        self.rollout(self.pos0, self.steps)  # builds #1, captures a chunk
        rng = common.check_rng(self.ctx.seed)
        self.pick = int(rng.integers(self.chunks))

        def keep(n):
            """The seed's chunk of call c with chance 1/(c + 1), in place of
            the one held: a uniform draw over the calls so far."""
            if n % self.chunks != self.pick or \
                    rng.random() * (n // self.chunks + 1) >= 1:
                return False
            rec.kept.clear()
            return True
        if self.cuda:
            self.launches = dict(self.rollout.graph.launches)
            rec = self.rollout.graph = common.Recorder(self.rollout.graph,
                                                       keep)
        else:  # the eager loop calls the chunk itself
            rec = self.rollout.chunk = common.Recorder(self.rollout.chunk,
                                                       keep)

    def call(self, win) -> None:
        with win.span("rollout"):
            _, _, cov = self.rollout(self.pos0, self.steps)
            if self.cuda:
                torch.cuda.synchronize()
        self.covs.append(cov)
        n = self.cfg["crowd"]["agents"]
        win.count("agent_steps", n * self.steps)
        win.count("chunks", self.chunks)
        win.count("model_flops", self.steps * flops.sparse_rgl_step(self.cfg))
        if self.cuda:
            win.count("fba_launches", self.chunks * self.launches.get(
                "fused_block_attention_packed_shared", 0))

    def end_to_end(self, obs) -> dict:
        return {"agent_steps_per_s": obs.counters["agent_steps"]
                / obs.window_s}

    def release(self) -> None:
        rec = self.rollout.graph if self.cuda else self.rollout.chunk
        self.kept = rec.kept
        del self.rollout

    def check(self, control: bool = False) -> list:
        """The kept chunk against the reference. ``control``:
        the reference in the program's place, its kNN search and ORCA in
        bfloat16 and its matmuls in TF32 (the precisions below the
        configuration's float32)."""
        cr, tr, lim = (self.cfg["crowd"], self.traffic,
                       self.traffic["check"]["limits"])
        (_, inputs, outputs), = self.kept
        pos, vel, goals, rad, vmax, act, cols_gnn, cols_orca, cand, em = \
            inputs
        cap = cr["max_per_cell"]
        if control:
            low = pos.to(torch.bfloat16)
            cols_gnn = ref.knn(low, cr["k_gnn"], cap)
            cols_orca = ref.knn(low, cr["k_orca"], cap)
        knn = 0
        for cols, k in ((cols_gnn, cr["k_gnn"]), (cols_orca, cr["k_orca"])):
            want = ref.graph_distances(pos, ref.knn(pos, k, cap))
            got = ref.graph_distances(pos, cols)
            tol = 1e-5 * want.abs().clamp(min=1.0)
            knn += int(((got - want).abs() > tol).any(-1).sum())
        cand_r, em_r, fits = ref.windows(cols_gnn, tr["block_B"],
                                         tr["block_C"])
        window = float(int((cand_r != cand).sum()) + int((em_r != em).sum())
                       + (0 if fits else 1)) if not control else 0.0
        cov = float(1.0 - min(float(c) for c in self.covs))
        params = ORCAParams(cr["orca_neighbor_dist"], cr["orca_time_horizon"],
                            cr["time_step"], cr["orca_safety_space"])
        layers = (self.cfg["gcn"]["num_layer"], len(self.cfg["gcn"]
                                                    ["wh_dims"]),
                  len(self.cfg["value_network_dims"]))
        args = (pos, vel, goals, rad, vmax, act, inputs[6], inputs[7])
        rest = (tr["rebuild_every"], cr["time_step"], params, self.weights,
                layers)
        want = ref.chunk(*args, *rest)
        if control:
            with mprl_judge.tf32():
                got = ref.chunk(*args, *rest, orca_dtype=torch.bfloat16)
        else:
            got = outputs
        motion = max(float((got[0] - want[0]).abs().max()),
                     float((got[1] - want[1]).abs().max()))
        value = float((got[2] - want[2]).abs().max()
                      / want[2].abs().max().clamp(min=1e-30))
        return [("knn_mismatch", float(knn), lim["knn_mismatch"]),
                ("window_mismatch", window, 0.0),
                ("coverage_short", cov, 0.0),
                ("motion_err", motion, lim["motion_err"]),
                ("value_rel_err", value, lim["value_rel_err"])]
