"""The extended benchmarks of the port (counterpart of ``bench_extra.py`` at
the repository's root): planning decisions/s and the per-decision latency,
the relation chain's edges/s over its routes, and the mega-crowd rollouts
at 10,240 and 102,400 agents.

    python -m relationalgraphlearning_tpu_torch.tools.bench_extra
    python -m relationalgraphlearning_tpu_torch.tools.bench_extra \\
        --device cpu --crowd_n 1024 --big_n 2048   # a small run on the CPU

Prints the reference's twelve JSON lines (``bench_extra.py:324-382``), in
its order, with its metric names and keys, after a first line naming the
device. Each line's program runs as the reference compiles it: captured
once as a CUDA graph on the card (``captured.Graphed``; the chain through
``relation_chain.runner``, the rollout through ``MegaCrowdRollout``, the
collection through ``Explorer.collect``) and timed by the reference's
protocol, the median of ``trials`` timed regions of ``reps`` calls, each
region ended by a synchronise. On the CPU everything runs eagerly. The
single planning decision is also timed eagerly, on a line of its own.

Backends as the reference names them: ``"pallas"`` is kernel #1 (the
``block`` route of ``relation_chain.py``), ``"chunk"`` kernel #4, ``"xla"``
the windowed dense block path in plain PyTorch (``block_dense``); the
mega crowd's ``"gather"`` backend is the value net on torch ops, and
``"block"`` with ``packed=True`` runs #1.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from typing import Callable, Optional

import torch

from relationalgraphlearning_tpu_torch import captured
from relationalgraphlearning_tpu_torch import relation_chain as rc
from relationalgraphlearning_tpu_torch import types as T
from relationalgraphlearning_tpu_torch.captured import Graphed
from relationalgraphlearning_tpu_torch.configs.base import (
    EnvConfig, MPRLConfig, PolicyConfig)
from relationalgraphlearning_tpu_torch.envs import mega_crowd as mc
from relationalgraphlearning_tpu_torch.envs.crowd_sim import CrowdSim
from relationalgraphlearning_tpu_torch.ops.sparse import knn_graph_auto
from relationalgraphlearning_tpu_torch.policies.factory import make_policy
from relationalgraphlearning_tpu_torch.training.explorer import Explorer

# the reference's backend names → the chain's routes
ROUTE_OF = {"pallas": "block", "chunk": "chunk", "xla": "block_dense"}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timeit(fn: Callable, device, reps: int = 20, trials: int = 3) -> float:
    """Seconds a call of ``fn``: the median of ``trials`` timed regions of
    ``reps`` calls, after one call (the reference's ``_timeit``)."""
    fn()
    sync(device)
    ts = []
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync(device)
        ts.append((time.perf_counter() - t0) / reps)
    return statistics.median(ts)


def device_name(device) -> str:
    """The card's name and power limit (``nvidia-smi``), or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def on_card(device) -> bool:
    """Whether ``device`` is the card: there every program is captured."""
    return torch.device(device).type == "cuda"


def times(graph_launches: dict, n: int) -> dict:
    """A graph's launches over n replays."""
    return {k: v * n for k, v in graph_launches.items()}


# --------------------------------------------------------------- planning
def planning_throughput(batch: int = 64, steps: int = 32, device="cuda",
                        reps: int = 5, lat_reps: int = 50,
                        trials: int = 3) -> dict:
    """``bench_extra.py:46-73``: the d=2, w=2 MP-RGL planner, random init
    from seed 0, collecting ``batch`` envs × ``steps`` steps at ε = 0
    (decisions/s), then one state's ``predict`` (seconds a decision). The
    collection runs as ``Explorer.collect`` runs it (one step captured on
    the card); the decision is captured too, and timed eagerly beside it.
    Returns decisions_per_s, latency_s, latency_s_eager and the kernel
    launches of one timed collection and one decision."""
    graphed = on_card(device)
    cfg = EnvConfig(human_policy="orca")
    pcfg = PolicyConfig(mprl=MPRLConfig(planning_depth=2, planning_width=2))
    policy = make_policy("model_predictive_rl", pcfg, cfg, device=device)
    policy.init_params(torch.Generator().manual_seed(0))
    ex = Explorer(CrowdSim(cfg, device=device), policy, pcfg.gamma)
    carry = ex.init_carry(batch, 0)
    captured.reset_launch_counts()
    dt = timeit(lambda: ex.collect(carry, steps, 0, graphed=graphed), device,
                reps, trials)
    if graphed:
        collect_launches = times(ex.collect_graph(batch, steps, 0).launches,
                                 steps)
    else:
        collect_launches = captured.launch_counts()

    robot = carry.robot[0].clone()
    humans = T.observable(carry.humans[0]).contiguous()

    def decide(r, h):
        return policy.predict(T.JointState(r, h))

    lat_eager = timeit(lambda: decide(robot, humans), device, lat_reps,
                       trials)
    if graphed:
        g = Graphed(decide, robot, humans)
        lat = timeit(lambda: g(robot, humans), device, lat_reps, trials)
        decide_launches = g.launches
    else:
        lat, decide_launches = lat_eager, captured.launch_counts()
    return dict(decisions_per_s=batch * steps / dt, latency_s=lat,
                latency_s_eager=lat_eager, graphed=graphed,
                launches=dict(collect=collect_launches,
                              decision=decide_launches))


# ------------------------------------------------------------ the chain
def chain_rate(prep: dict, h0, n: int, K: int, inner: int, device,
               reps: int, trials: int) -> dict:
    """Gedges/s of ``inner`` applications of the prepared route from h0
    (n·K·inner edges a run), the run captured once on the card; the
    kernel launches one run holds."""
    graphed = on_card(device)
    captured.reset_launch_counts()
    f = rc.runner(prep, h0, inner, graphed=graphed)
    launches = f.launches if graphed else None
    dt = timeit(lambda: f(h0), device, reps, trials)
    if not graphed:
        launches = {k: v // (reps * trials + 1)
                    for k, v in captured.launch_counts().items()}
    return dict(edges_per_s=n * K * inner / dt, seconds=dt,
                coverage=float(prep["coverage"]), launches=launches)


def edges_throughput(n: int = 8192, K: int = 16, d: int = 64,
                     inner: int = 100, device="cuda", reps: int = 30,
                     trials: int = 3) -> dict:
    """``bench_extra.py:76-107``: the loop-carried gather chain (sddmm →
    neighbour softmax → spmm, then the row normalisation) over the kNN
    graph of n uniform positions in a 100 m box, from unit-normal
    features."""
    cols = rc.crowd_graph(n, K, seed=0, device=device, sort=False)
    g = torch.Generator().manual_seed(1)
    h0 = torch.randn((n, d), generator=g).to(device)
    return chain_rate(rc.prepare("gather", cols), h0, n, K, inner, device,
                      reps, trials)


def edges_throughput_block(n: int = 8192, K: int = 16, d: int = 64,
                           inner: int = 100, B: int = 256, C: int = 544,
                           backend: str = "pallas", device="cuda",
                           reps: int = 30, trials: int = 3) -> dict:
    """``bench_extra.py:110-190``: the same chain over spatially sorted
    positions and unit seed features through the window: ``"pallas"``
    kernel #1 (fused l2norm, unshifted softmax), ``"chunk"`` kernel #4,
    ``"xla"`` the dense block path. Adds the route's coverage."""
    cols = rc.crowd_graph(n, K, seed=0, device=device)
    h0 = rc.seed_features(n, d, seed=1, device=device)
    prep = rc.prepare(ROUTE_OF[backend], cols, B, C)
    return chain_rate(prep, h0, n, K, inner, device, reps, trials)


# ----------------------------------------------------------- mega crowd
def knn_overlap(pos, vel, rebuild_every: int) -> float:
    """``bench_extra.py:300-318``: march the final crowd one further chunk
    on a frozen graph; the share of each agent's fresh 16-NN that the stale
    graph holds, averaged over agents (``jnp.isin(fresh, stale)``)."""
    if rebuild_every <= 1:
        return 1.0
    stale = knn_graph_auto(pos, 16)
    fresh = knn_graph_auto(pos + vel * mc.DT * rebuild_every, 16)
    return float((fresh[:, :, None] == stale[:, None, :]).any(-1)
                 .float().mean())


def mega_crowd(n: int = 10240, K: int = 10, steps: int = 16,
               side: Optional[float] = None, backend: str = "gather",
               block_B: int = 256, block_C: int = 640,
               rebuild_every: int = 1, packed: bool = False,
               device="cuda") -> dict:
    """``bench_extra.py:193-321``: the n-agent crowd, kNN ORCA and the
    SparseRGL value net for ``steps`` steps, the graphs rebuilt every
    ``rebuild_every`` steps (``envs/mega_crowd.py``). One run warms up (and
    captures a chunk's steps on the card), the next is timed. Returns
    agent_steps_per_s, the minimum window coverage, ``knn_overlap``, the
    kernel launches of the timed run and its final (pos, vel)."""
    graphed = on_card(device)
    runner = mc.MegaCrowdRollout(K, backend, block_B, block_C, rebuild_every,
                                 packed, device=device, graphed=graphed)
    pos0 = mc.initial_crowd(n, side, device=device)
    runner(pos0, steps)
    sync(device)
    captured.reset_launch_counts()
    t0 = time.perf_counter()
    (pos, vel), vals, cov = runner(pos0, steps)
    sync(device)
    dt = time.perf_counter() - t0
    launches = (times(runner.graph.launches, steps // rebuild_every)
                if graphed else captured.launch_counts())
    if not bool(torch.isfinite(vals).all()):
        raise RuntimeError(f"mega crowd n={n} {backend}: non-finite values")
    return dict(agent_steps_per_s=n * steps / dt, seconds=dt,
                coverage=float(cov), knn_overlap=knn_overlap(
                    pos, vel, rebuild_every), launches=launches,
                value_mean_last=float(vals[-1]), final=(pos, vel))


# ------------------------------------------------------------------ main
def rows(device="cuda", edges_n: int = 8192, inner: int = 100,
         crowd_n: int = 10240, big_n: int = 102_400, batch: int = 64,
         steps: int = 32, mega_steps: int = 16, trials: int = 3):
    """The reference's twelve rows, in order: (its JSON line, our
    record), one at a time."""
    p = planning_throughput(batch, steps, device, trials=trials)
    yield ({"metric": "planning decisions/s (d=2 MP-RGL in env)",
            "value": round(p["decisions_per_s"], 1), "unit": "decisions/s",
            "latency_per_decision_ms": round(p["latency_s"] * 1e3, 3)}, p)
    yield ({"metric": "planning decision latency (eager)",
            "latency_per_decision_ms": round(p["latency_s_eager"] * 1e3, 3)},
           None)
    e = edges_throughput(edges_n, inner=inner, device=device, trials=trials)
    yield ({"metric": "relation edges/s (SDDMM+softmax+SpMM)",
            "value": round(e["edges_per_s"] / 1e9, 2), "unit": "Gedges/s"},
           e)
    for backend, metric in (
            ("chunk", "relation edges/s (chunked-fetch pallas kernel)"),
            ("pallas", "relation edges/s (block path, fused pallas kernel)"),
            ("xla", "relation edges/s (block path, XLA)")):
        r = edges_throughput_block(edges_n, inner=inner, backend=backend,
                                   device=device, trials=trials)
        yield ({"metric": metric, "value": round(r["edges_per_s"] / 1e9, 2),
                "unit": "Gedges/s", "coverage": r["coverage"]}, r)
    amortized = dict(backend="block", packed=True, rebuild_every=8,
                     steps=2 * mega_steps, block_C=576)
    for label, n in (("10k", crowd_n), ("100k", big_n)):
        m = mega_crowd(n, steps=mega_steps, device=device)
        yield ({"metric": f"{label}-agent crowd "
                + ("(kNN ORCA + SparseRGL values)" if label == "10k"
                   else "(grid kNN + ORCA + SparseRGL)"),
                "value": round(m["agent_steps_per_s"], 1),
                "unit": "agent-steps/s"}, m)
        m = mega_crowd(n, steps=mega_steps, backend="block", device=device)
        yield ({"metric": f"{label}-agent crowd (block MXU backend)",
                "value": round(m["agent_steps_per_s"], 1),
                "unit": "agent-steps/s", "coverage": m["coverage"]}, m)
        m = mega_crowd(n, device=device, **amortized)
        yield ({"metric": f"{label}-agent crowd (block+pallas, rebuild "
                          "every 8)",
                "value": round(m["agent_steps_per_s"], 1),
                "unit": "agent-steps/s", "coverage": m["coverage"],
                "knn_overlap": round(m["knn_overlap"], 4)}, m)
        if label == "10k":
            m = mega_crowd(n, backend="gather", rebuild_every=8,
                           steps=2 * mega_steps, device=device)
            yield ({"metric": "10k-agent crowd (gather, rebuild every 8)",
                    "value": round(m["agent_steps_per_s"], 1),
                    "unit": "agent-steps/s",
                    "knn_overlap": round(m["knn_overlap"], 4)}, m)


def parse_args(argv=None, description=__doc__):
    ap = argparse.ArgumentParser(description=description.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, where nothing is captured")
    ap.add_argument("--edges_n", type=int, default=8192)
    ap.add_argument("--inner", type=int, default=100)
    ap.add_argument("--crowd_n", type=int, default=10240)
    ap.add_argument("--big_n", type=int, default=102_400)
    ap.add_argument("--batch", type=int, default=64,
                    help="the planning collection's envs")
    ap.add_argument("--steps", type=int, default=32,
                    help="the planning collection's steps")
    ap.add_argument("--mega_steps", type=int, default=16,
                    help="steps of the unamortized crowd rows (twice as "
                         "many on the rebuild-every-8 rows)")
    ap.add_argument("--trials", type=int, default=3,
                    help="timed regions a row (the reference's 3)")
    return ap.parse_args(argv)


def check_device(device, tool: str) -> None:
    """A run on the card needs the card: nothing falls back to the CPU."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{tool}: no CUDA device (pass --device cpu for a "
                         "run on the CPU)")


def main(argv=None) -> list:
    """Print the device line and the twelve rows; return the records."""
    args = parse_args(argv)
    check_device(args.device, "bench_extra")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"device": device_name(args.device)}), flush=True)
    records = []
    for line, record in rows(args.device, args.edges_n, args.inner,
                             args.crowd_n, args.big_n, args.batch,
                             args.steps, args.mega_steps, args.trials):
        print(json.dumps(line), flush=True)
        records.append((line, record))
    return records


if __name__ == "__main__":
    main()
