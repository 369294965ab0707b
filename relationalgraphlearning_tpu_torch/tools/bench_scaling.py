"""Weak scaling of the node-partitioned paths of the port (counterpart of
``bench_scaling.py`` at the repository's root): the partitioned SparseRGL
forwards (ring, all-gather, block halo) and the partitioned mega-crowd
rollout at D = 1, 2, 4, 8 ranks, n = 2048·D.

    python -m relationalgraphlearning_tpu_torch.tools.bench_scaling
    python -m relationalgraphlearning_tpu_torch.tools.bench_scaling --mega
    python -m relationalgraphlearning_tpu_torch.tools.bench_scaling \
        --device cpu --ranks 1,2 --n_per_shard 256   # a small run on the CPU

The D ranks run as threads of one process on one device
(``parallel/comm.py::LocalComm``), as the reference's ranks ran on a
virtual CPU mesh: every collective runs for real, but the ranks share one
card (or the CPU), so the rates are plumbing, not a prediction of D cards.
On the card each program is captured once as one CUDA graph of all ranks
(``Mesh.capture``; the mega rollout with its rebuilds), the counterpart of
the reference's jitted ``shard_map``, and ``reps`` replays are timed after
one untimed run (``bench_scaling.py:75-87``, ``:131-136``). Prints one JSON
line a (method, D) with the reference's keys, or one a D with ``--mega``.

The checked rows of ``chip_smoke.py``'s phase 11 live here too
(``partition_row``, ``mega_row``: one eager run and one graph, launches
counted, graphed == eager bit for bit, each forward against one device),
so that the protocol has one home; ``main`` times it.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import time

import torch

from relationalgraphlearning_tpu_torch import captured
from relationalgraphlearning_tpu_torch.configs.base import GCNConfig
from relationalgraphlearning_tpu_torch.envs.orca import ORCAParams
from relationalgraphlearning_tpu_torch.models.sparse_rgl import (
    SparseRGL, SparseValueNet)
from relationalgraphlearning_tpu_torch.ops import block_graph as bg
from relationalgraphlearning_tpu_torch.ops import fused_block as fb
from relationalgraphlearning_tpu_torch.ops.sparse import knn_graph
from relationalgraphlearning_tpu_torch.parallel import graph_partition as gp
from relationalgraphlearning_tpu_torch.parallel import partitioned_build as pb
from relationalgraphlearning_tpu_torch.parallel.mesh import make_mesh
from relationalgraphlearning_tpu_torch.tools import bench_extra as be

# bench_scaling.py's protocol (measure :20-90, measure_mega :93-146) at
# the sizes chip_smoke.py's phase 11 checks
PARTITION = dict(ranks=(1, 2, 4, 8), n_per_rank=2048, K=16, inner=8, B=128,
                 C=448)
MEGA = dict(ranks=(1, 2, 4, 8), n_per_rank=2048, steps=16, R=8, n_cap=2688,
            B=128, C=512, K=16, K_orca=10, mig_cap=256)
PARTITION_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_parallel.py:99-100
MEGA_ATOL = 1e-4            # tests/test_partitioned_build.py:99-102
MEGA_VMEAN_FULL = 1e-3      # |vmean| at full size, against one device
# a replay against the eager run on the same inputs: the same kernels in
# the same order, so the same bits
REPLAY_TOL = dict(rtol=0, atol=0)


def seeded_value_net(backend: str, dev, seed: int = 1) -> SparseValueNet:
    """The value net (``GCNConfig``, head 32-100-100-1) drawn from
    ``seed``, as chip_smoke.py's rows draw it."""
    g = torch.Generator().manual_seed(seed)
    return SparseValueNet(GCNConfig(), backend=backend,
                          generator=g).to(dev).eval()


def partition_chain_rank(comm, model, method, halo, inner, states, a, b):
    """One rank of ``inner`` chained partitioned forwards, each output
    re-injected into the velocity columns (bench_scaling.py:55-58)."""
    s = states
    for _ in range(inner):
        if method == "block_halo":
            h = gp.block_rgl_rank(comm, model, halo, s, a, b)
        else:
            h = gp.sparse_rgl_rank(comm, model, method, s, a, b)
        s = torch.cat([s[:, :2], h[:, :2] * 1e-6, s[:, 4:]], dim=-1)
    return s


def partition_inputs(D, method, dev, seed=0, cfg=None):
    """bench_scaling.measure's set-up at n = 2048·D: uniform positions in a
    100 m box (spatially sorted for the block path), K=16 dense kNN; the
    block path's windows, packed masks and halo (``cfg``: PARTITION's
    sizes, or another's)."""
    cfg = cfg or PARTITION
    n = cfg["n_per_rank"] * D
    g = torch.Generator().manual_seed(seed)
    pos = (torch.rand(n, 2, generator=g) * 100.0).to(dev)
    if method == "block_halo":
        pos = pos[bg.spatial_sort(pos)]
    states = torch.cat([pos, torch.zeros_like(pos),
                        torch.full_like(pos[:, :1], 0.3)], -1)
    cols = knn_graph(pos, cfg["K"])
    if method != "block_halo":
        return states, cols, None, None, 0
    cand, cov = bg.block_window(cols, cfg["B"], cfg["C"])
    if float(cov) != 1.0:
        raise RuntimeError(f"block_halo D={D}: window coverage {float(cov)}")
    mbits = fb.pack_emask(bg.block_masks(cols, cand))
    halo = max(8, -(-gp.halo_reach(cand, cfg["B"], n // D) // 8) * 8)
    if halo >= n // D:
        raise RuntimeError(f"block_halo D={D}: halo {halo} >= {n // D} rows")
    return states, cols, cand, mbits, halo


def partition_row(method, D, model, dev):
    """One row of bench_scaling.measure, checked: the eager ranks (their
    launches counted) and the ranks captured as one CUDA graph
    (``Mesh.capture``), the graph equal to the eager run bit for bit."""
    cfg = PARTITION
    states, cols, cand, mbits, halo = partition_inputs(D, method, dev)
    n = states.shape[0]
    mesh = make_mesh(data=D, device=dev)
    a, b = (cand, mbits) if method == "block_halo" else (cols, None)
    rep = (model, method, halo, cfg["inner"])
    captured.reset_launch_counts()
    eager_out = mesh.run(partition_chain_rank, replicated=rep,
                         row_sharded=(states, a, b))
    torch.cuda.synchronize()
    launches = captured.launch_counts()
    want = {k: 0 for k in launches}
    if method == "block_halo":
        want["fused_block_attention_packed_shared"] = D * 2 * cfg["inner"]
    if launches != want:
        raise RuntimeError(f"{method} D={D}: launches {launches}, want "
                           f"{want}")
    t = time.perf_counter()
    graph = mesh.capture(partition_chain_rank, replicated=rep,
                         row_sharded=(states, a, b))
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t
    if graph.launches != want:
        raise RuntimeError(f"{method} D={D}: the graph holds "
                           f"{graph.launches}, want {want}")
    torch.testing.assert_close(graph(states, a, b), eager_out, **REPLAY_TOL,
                               msg=lambda m: f"{method} D={D} graphed vs "
                               f"eager: {m}")

    # one forward against the one-device SparseRGL: gather on the card;
    # block on the CPU, where #1's plain version runs, so the halo path's
    # kernel is held against code that shares nothing with it
    if method == "block_halo":
        got = gp.partitioned_block_rgl(model, states, cand, mbits, mesh,
                                       halo)
        one = SparseRGL(GCNConfig(), backend="block").eval()
        one.load_state_dict(model.state_dict())
        want_h = one(states.cpu(), cols.cpu(), block_cand=cand.cpu(),
                     block_emask=mbits.cpu()).to(dev)
    else:
        got = gp.partitioned_sparse_rgl(model, states, cols, mesh,
                                        method=method)
        want_h = model(states, cols)
    torch.cuda.synchronize()
    err = float((got - want_h).abs().max())
    rel = float(((got - want_h).abs()
                 / (PARTITION_TOL["atol"] + PARTITION_TOL["rtol"]
                    * want_h.abs())).max())
    torch.testing.assert_close(got, want_h, **PARTITION_TOL,
                               msg=lambda m: f"{method} D={D}: {m}")
    return dict(method=method, D=D, n=n, halo=halo, capture_s=capture_s,
                max_abs_err=err, err_over_limit=rel, launches=launches,
                graph_launches=graph.launches)


def mega_graph_rank(comm, spec, sh):
    """Per rank: a chunk's sort and build on these shards; the value net's
    states, the windows and masks, and the active slots."""
    sh = pb._local_sort(sh, spec)
    _, _, cand, mbits, *_ = pb._build_graph(comm, sh, spec)
    states = torch.cat([sh.pos, sh.vel, sh.rad[:, None]], dim=-1)
    return states, cand, mbits, sh.active


def mega_values_check(D, spec, net, sh, dev):
    """The rollout's value net (#1 through the full-slab halo) per agent on
    its final shards, against the same ranks on the CPU, where #1's plain
    version runs: every agent's value, the halo's edge rows included."""
    mesh = make_mesh(data=D, device=dev)
    states, cand, mbits, active = mesh.run(mega_graph_rank,
                                           replicated=(spec,),
                                           row_sharded=(sh,))
    got = mesh.run(pb._value_net_fullshard, replicated=(net,),
                   row_sharded=(states, cand, mbits))
    want = make_mesh(data=D, device="cpu").run(
        pb._value_net_fullshard, replicated=(copy.deepcopy(net).cpu(),),
        row_sharded=(states.cpu(), cand.cpu(), mbits.cpu()))
    got, want = got[active].cpu(), want[active.cpu()]
    torch.testing.assert_close(got, want, **PARTITION_TOL,
                               msg=lambda m: f"mega D={D} values: {m}")
    return float((got - want).abs().max())


def mega_row(D, net, dev):
    cfg = MEGA
    n = cfg["n_per_rank"] * D
    half = 100.0 * math.sqrt(n / 10240.0)   # the mega_crowd density
    g = torch.Generator().manual_seed(0)
    pos = ((torch.rand(n, 2, generator=g) * 2.0 - 1.0) * half).to(dev)
    spec = pb.BandSpec(D=D, n_cap=cfg["n_cap"], x0=-half, band_w=2 * half / D,
                       y0=-half, cell=2 * half / 64, grid_w=256, B=cfg["B"],
                       C=cfg["C"], K=cfg["K"], K_orca=cfg["K_orca"],
                       mig_cap=cfg["mig_cap"])
    agents = (pos, torch.zeros_like(pos), -pos,
              torch.full((n,), 0.3, device=dev), torch.ones(n, device=dev))
    shards = pb.init_crowd_shards(*(a.cpu() for a in agents), spec,
                                  device=dev)
    mesh = make_mesh(data=D, device=dev)
    run = pb.partitioned_mega_rollout(mesh, spec, net, ORCAParams(),
                                      cfg["steps"], cfg["R"])
    captured.reset_launch_counts()
    sh, diag = run(shards)
    torch.cuda.synchronize()
    launches = captured.launch_counts()
    want = {k: 0 for k in launches}
    want["fused_block_attention_packed_shared"] = D * 2 * cfg["steps"]
    want["orca_velocity"] = D * cfg["steps"]      # one a rank and step
    if launches != want:
        raise RuntimeError(f"mega D={D}: launches {launches}, want {want}")
    diag = {k: float(v) for k, v in diag.items()}
    aid = sh.aid[sh.active].sort().values.cpu()
    if not torch.equal(aid, torch.arange(n, dtype=aid.dtype)):
        raise RuntimeError(f"mega D={D}: {aid.numel()} of {n} agents kept")
    if (diag["win_cov"] != 1.0 or diag["overflow"] != 0
            or diag["lost"] != 0 or not math.isfinite(diag["vmean"])):
        raise RuntimeError(f"mega D={D}: diagnostics {diag}")

    # the whole rollout of every rank, rebuilds included, as one graph
    graphed = pb.partitioned_mega_rollout(mesh, spec, net, ORCAParams(),
                                          cfg["steps"], cfg["R"],
                                          graphed=True)
    t = time.perf_counter()
    g_sh, g_diag = graphed(shards)              # captures, then replays
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t
    if graphed.graph.launches != want:
        raise RuntimeError(f"mega D={D}: the graph holds "
                           f"{graphed.graph.launches}, want {want}")
    for name, got, ref in zip(sh._fields, g_sh, sh):
        torch.testing.assert_close(got, ref, **REPLAY_TOL, msg=lambda m: (
            f"mega D={D} graphed {name} vs eager: {m}"))
    if {k: float(v) for k, v in g_diag.items()} != diag:
        raise RuntimeError(f"mega D={D}: graphed diagnostics {g_diag} vs "
                           f"eager {diag}")

    # the one-device loop: dense kNN, kNN ORCA, the gather value net
    one = SparseValueNet(GCNConfig(), backend="gather").to(dev).eval()
    one.load_state_dict(net.state_dict())
    rpos, _, rvmean = pb.single_device_rollout(
        one, *agents, ORCAParams(), cfg["steps"], cfg["R"], cfg["K"],
        cfg["K_orca"])
    dpos = (sh.pos[sh.active][sh.aid[sh.active].argsort()] - rpos).abs()
    dpos = dpos.amax(-1)
    dvmean = abs(diag["vmean"] - float(rvmean))
    row = dict(D=D, n=n, capture_s=capture_s,
               graph_launches=graphed.graph.launches, **diag,
               max_dvalue=mega_values_check(D, spec, net, sh, dev),
               max_dpos=float(dpos.max()),
               agents_dpos_over_1e4=int((dpos > MEGA_ATOL).sum()),
               dvmean=dvmean, launches=launches)
    if dvmean > MEGA_VMEAN_FULL:
        raise RuntimeError(f"mega D={D}: |vmean - one device| = {dvmean} "
                           f"> {MEGA_VMEAN_FULL} ({row})")
    return row


# ------------------------------------------------------ the reference's tool
def _note(device) -> str:
    where = ("one card" if torch.device(device).type == "cuda"
             else "the CPU")
    return f"D ranks as threads on {where}: plumbing, not scaling"


@torch.no_grad()
def measure(method: str, n_devices: int, n_per_shard: int = 2048,
            K: int = 16, inner: int = 8, reps: int = 3,
            device="cuda") -> dict:
    """``bench_scaling.py:20-90``: ``inner`` chained partitioned SparseRGL
    forwards of ``method`` on ``n_devices`` ranks at n = n_per_shard·D
    (block halo: B=128, C=448, packed masks, the least halo a multiple of
    8), each output re-injected into the velocity columns. Returns
    medges_per_s (n·K·inner·num_layer edges a run), the final states and
    the kernel launches of one run."""
    graphed = be.on_card(device)
    D = n_devices
    cfg = dict(PARTITION, n_per_rank=n_per_shard, K=K, inner=inner)
    states, cols, cand, mbits, halo = partition_inputs(D, method, device,
                                                       cfg=cfg)
    model = seeded_value_net("gather", device).graph_model
    mesh = make_mesh(data=D, device=device)
    a, b = (cand, mbits) if method == "block_halo" else (cols, None)
    rep = (model, method, halo, inner)
    captured.reset_launch_counts()
    if graphed:
        graph = mesh.capture(partition_chain_rank, replicated=rep,
                             row_sharded=(states, a, b))
        run = lambda: graph(states, a, b)  # noqa: E731
        launches = graph.launches
    else:
        run = lambda: mesh.run(partition_chain_rank,  # noqa: E731
                               replicated=rep, row_sharded=(states, a, b))
    out = run()
    be.sync(device)
    if not graphed:
        launches = captured.launch_counts()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = run()
    be.sync(device)
    dt = (time.perf_counter() - t0) / reps
    n = states.shape[0]
    edges = n * K * inner * GCNConfig().num_layer
    return dict(method=method, D=D, n=n, halo=halo, seconds=dt,
                medges_per_s=edges / dt / 1e6, states=out.clone(),
                launches=launches, graphed=graphed)


@torch.no_grad()
def measure_mega(n_devices: int, n_per_shard: int = 2048, steps: int = 16,
                 rebuild_every: int = 8, reps: int = 3,
                 device="cuda") -> dict:
    """``bench_scaling.py:93-146``: the partitioned mega-crowd rollout
    (``parallel/partitioned_build.py``: migration, per-rank build, ORCA and
    the block value net through #1) at n = n_per_shard·D in a
    density-matched box. Prints the reference's line; returns the rate,
    the coverages and the kernel launches of one run."""
    graphed = be.on_card(device)
    D = n_devices
    n = n_per_shard * D
    half = 100.0 * math.sqrt(n / 10240.0)
    g = torch.Generator().manual_seed(0)
    pos = ((torch.rand(n, 2, generator=g) * 2.0 - 1.0) * half).to(device)
    spec = pb.BandSpec(
        D=D, n_cap=-(-int(n_per_shard * 1.3) // 128) * 128, x0=-half,
        band_w=2 * half / D, y0=-half, cell=2 * half / 64, grid_w=256,
        B=128, C=512, K=16, K_orca=10, mig_cap=max(64, n_per_shard // 8))
    agents = (pos, torch.zeros_like(pos), -pos,
              torch.full((n,), 0.3, device=device),
              torch.ones(n, device=device))
    shards = pb.init_crowd_shards(*(x.cpu() for x in agents), spec,
                                  device=device)
    run = pb.partitioned_mega_rollout(
        make_mesh(data=D, device=device), spec,
        seeded_value_net("block", device), ORCAParams(), steps,
        rebuild_every, graphed=graphed)
    captured.reset_launch_counts()
    _, diag = run(shards)                   # on the card: captures
    be.sync(device)
    launches = run.graph.launches if graphed else captured.launch_counts()
    cov = (float(diag["band_cov"]), float(diag["win_cov"]))
    t0 = time.perf_counter()
    for _ in range(reps):
        _, diag = run(shards)
    be.sync(device)
    dt = (time.perf_counter() - t0) / reps
    line = {
        "metric": f"partitioned mega-crowd agent-steps/s (D={D}, n={n}, "
                  f"R={rebuild_every}, weak)",
        "value": round(n * steps / dt, 1), "unit": "agent-steps/s",
        "band_cov": cov[0], "win_cov": cov[1], "note": _note(device)}
    print(json.dumps(line), flush=True)
    return dict(line=line, D=D, n=n, agent_steps_per_s=n * steps / dt,
                seconds=dt,
                launches=launches, diag={k: float(v) for k, v in
                                         diag.items()})


def main(argv=None) -> list:
    """Print the reference's lines; return (line, record) pairs."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, where nothing is captured")
    ap.add_argument("--mega", action="store_true",
                    help="the partitioned mega-crowd rollout instead")
    ap.add_argument("--ranks", default="1,2,4,8")
    ap.add_argument("--n_per_shard", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    be.check_device(args.device, "bench_scaling")
    ranks = [int(r) for r in args.ranks.split(",")]
    out = []
    if args.mega:
        for D in ranks:
            r = measure_mega(D, args.n_per_shard, reps=args.reps,
                             device=args.device)
            out.append((r["line"], r))
        return out
    for method in ("ring", "allgather", "block_halo"):
        base = None
        for D in ranks:
            r = measure(method, D, args.n_per_shard, reps=args.reps,
                        device=args.device)
            e = r["medges_per_s"]
            base = base or e
            line = {
                "metric": f"partitioned edges/s ({method}, D={D}, weak)",
                "value": round(e, 2), "unit": "Medges/s",
                "scaling_efficiency_vs_D1": round(e / (base * D), 3),
                "note": _note(args.device)}
            print(json.dumps(line), flush=True)
            out.append((line, r))
    return out


if __name__ == "__main__":
    main()
