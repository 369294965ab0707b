#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

It checks the port on the card; the end-to-end rates are the benchmark's
(``BENCHMARK.json``, ``benchmarks/run.py``, with ``--trace 1`` for where
the time goes) and the measurement tools' (``tools/``, run in phase 13).
It times only what nothing else measures: each kernel against its plain
version and its bound (the ``kernels`` line), the relation chain's routes,
the pallas rollout and the evaluations' walls.

Phases, each of which exits non-zero on failure:

1. Require CUDA; print the card's name and power limit (``nvidia-smi``).
2. Build the CUDA kernels from ``relationalgraphlearning_tpu_torch/csrc/``
   with ``nvcc`` for sm_90a, one ``nvcc`` a source, all at once.
3. Hold kernels #1/#2 against their plain PyTorch versions on the card at
   slice 1's shapes (the first rebuild's graph of the 10,240-agent crowd:
   nb=40, B=256, C=576, d=32) and on edge cases (rows with no edge,
   coverage < 1, the unshifted softmax on unit rows, all three epilogues,
   dv != d), at rtol=atol=1e-5; time kernel (warm and with a cold L2),
   plain version and one PyTorch call of the same function
   (``scaled_dot_product_attention``, a yardstick only); #1 also with an
   empty mask (``ms_no_edges``: the launch and each CTA's ids, mask words
   and edge lists, with no edge to read).
3b. The same for kernels #3 (per-edge gather), #4/#7 (chunked fetch, groups
   2 and 4), #5 (the r3 dense-mask form) and the aligned route of #1, at the
   relation chain's shapes (n=8192, K=16, B=256, d=64 and 32) and, for #3,
   at the pallas rollout's (n=10,240, d=32) with its own features held
   against float64; #3 with keys that are the values (one read a
   neighbour row) and with a separate value table, timed at both shapes
   with a cold L2 too; #4 and #7 also timed with a cold L2 and with an
   empty mask.
3c. Kernel #6 (the A/B harness's dense block attention) against its plain
   version at the harness's shapes (the chain's graph, nb=32, B=256, C=544,
   d=64) in all eight float32/bfloat16 x divide-before/after x bool/int-mask
   combinations, with rows with no edge and a coverage < 1 window (C=256):
   float32 at rtol=atol=1e-5, bfloat16 within one bfloat16 ulp; the four
   harness instantiations timed beside their bound, plain version and
   ``scaled_dot_product_attention`` + l2norm, and kernel #1 timed alone at
   the same shapes. #1, #5 and #6 are also timed with a cold L2
   (``cold_ms``).
4. Slice 1: ``mega_crowd_rollout`` at n=10,240, K=10, 32 steps, block
   backend with packed masks, B=256, C=576, rebuild every 8 steps, once
   eager (``graphed=False``) and once graphed (``MegaCrowdRollout``: each
   chunk's 8 steps one captured CUDA graph, captured first). The kernels'
   launch counts are zeroed just before the eager run and read just after;
   the shared-table kernel must have launched 64 times
   (2 GCN layers x 32 steps) and ORCA's kernel 32 times (one a step), and
   the chunk's graph must hold 16 launches of the one and 8 of the other
   and none of another kernel. Each graphed run must equal the
   eager run bit for bit. Checks coverage 1, finite results, the
   block+kernel value net against the gather backend on one rebuilt graph,
   and a small rollout on the card against the same rollout on the CPU.
   Its rate is the ``crowd10k.block_r8`` cell's.
5. The relation chain (``relation_chain.py``) at n=8192, K=16, d=64,
   inner=100, B=256 over every route, and ``chunk_d32`` beside ``block`` at
   d=32: coverage exactly 1, exactly ``inner`` launches of each route's
   kernel (counts zeroed before each route), one application and the final
   h of every route against the plain gather chain; then each route's
   ``inner`` applications captured as one CUDA graph (``runner``), which
   must hold exactly ``inner`` launches of the route's kernel and replay the
   eager run bit for bit; Gedges/s per route, graphed (5 replays between
   synchronises, the reference's protocol) and eager, as medians of
   interleaved runs.
6. Slice 2's rollout: ``mega_crowd_rollout(n=10240, K=10, steps=32,
   backend="pallas", rebuild_every=8)``, checked as in phase 4 and, after
   an eager warm-up, run eager and graphed 3 times each in turns for its
   agent-steps/s: exactly 64 launches of kernel #3 an eager run, 16 in the
   chunk's graph (ORCA's 32 and 8), replays equal to the eager run,
   finite results, and the pallas, block+kernel and gather value nets
   equal on one rebuilt graph.
7. The A/B harness (``tools/ab_kernel.py`` of the port) at its shapes
   (n=8192, K=16, d=64, B=256, C=544, inner=100), its checked runs alone
   (``rounds=0``; its rates are ``python -m
   relationalgraphlearning_tpu_torch.tools.ab_kernel``'s): coverage
   exactly 1 for the window and the chunked fetch, exactly ``inner``
   launches of #6 (#4 for ``chunkfetch_f32``) in each variant's checked
   chain run and in its captured graph, each replay equal to the checked
   run, and each variant's final h against the plain gather chain (the
   frozen-table variants against the same chain on the plain version).
8. MP-RGL evaluation (slice 7): the committed checkpoints' 500 seeded test
   cases through ``Explorer.run_cases`` on the card: ``mprl_td`` at its
   d=2, w=2, the same weights at d=1 and at d=2, w=4, and
   ``mp_unicycle_anneal`` at its d=2, w=8. Each runs eager and graphed (one
   decision and one env step captured once, replayed 100 times), in turns.
   Each run must hold success and collision within 0.010 and nav time
   within 0.20 s of the committed ``eval_test*.json``, agree with the JAX
   package's per-case outcomes (``checkpoints/<run>_test_reference.npz``)
   in at least 485 of 500 cases, and its graphed run must equal its eager
   run bit for bit. Then the unicycle failure breakdown
   (``tools/diag_unicycle.py`` of the port) of ``results/mp_unicycle``
   over the 500 cases, graphed and eager (bit for bit), held to its
   ``eval_test.json`` and the JAX per-case outcomes by the same limits,
   its summary printed beside the committed ``diagnosis.json``. None of
   kernels #1-#7 may launch; ORCA's kernel must (the env's humans), and so
   must MP-RGL's value kernel (the planner).
9. MP-RGL training (slice 8) at the full width of
   ``configs/icra_benchmark/mp_separate.py``: one captured SGD step held to
   one eager step (and 8 to 8) from the same state and minibatch indices,
   for the imitation optimizer (SGD, momentum 0.9) and the RL one (Adam),
   parameters, target and optimizer state bit for bit; 64 captured
   collection steps at B=16 held to 64 eager ones from the same carry and
   draws, the ORCA demonstrator and MP-RGL at ε = 0.5, bit for bit; then
   ``train_loop.train`` in its ``debug`` shrink (20 imitation episodes, 2
   epochs, 40 RL episodes, validation and target update every 20), graphed
   and eager in turns: the demonstrator gate passes, the losses are
   finite, the parameters moved, ``il_model``, ``rl_model``,
   ``rl_model_best`` and ``metrics.jsonl`` exist and ``rl_model`` restores
   to the live state, with the runs' walls and the capture seconds (the
   rates are the ``mp_rgl.train`` cell's). None of kernels #1-#7 may
   launch; ORCA's kernel and MP-RGL's value kernel must.
10. The paper's baselines (slice 9): the 500 seeded test cases of seven
    rows of its table through ``Explorer.run_cases`` on the card, built as
    the port's CLI builds them: ``sarl``, ``sarl_om``, ``lstm_rl``,
    ``cadrl`` (trained with one human, tested with ``--human_num 5``),
    ``rgl`` (the model-free one-step RGL) with the committed checkpoints'
    exported weights, and the ORCA robot at the env's time horizon and at
    ``--orca_time_horizon 10``. Each runs eager and graphed in turns and is
    held as in phase 8: success and collision within 0.010 and nav time
    within 0.20 s of the committed ``eval_test*.json``, at least 485 of 500
    outcomes equal to the JAX package's per-case records, graphed == eager
    bit for bit. ``sarl`` with the env-queried lookahead (``query_env``)
    runs graphed and eager too, held to each other bit for bit. The five
    baselines the port trained from scratch on the card
    (``relationalgraphlearning_tpu_torch/results/<row>_s0``, by
    ``tools/reproduce_quality.py``) run the same way, held to their
    committed ``eval_test.json`` with the same limits and graphed == eager,
    and so do the four MP-RGL runs the port trained on the card in slice
    14 (``mp_unicycle_anneal_s0``, stage 2 resumed from the converted
    committed stage 1; ``mp_unicycle_2stage_s0``, both stages;
    ``mp_unicycle_s0`` and ``mp_w4_s0``, the quality table's rows), each
    printed with the card's name and power limit. The resume check: stage
    1's exported state resumed under stage 2's config trains at that
    config's rate (5e-4) from the checkpoint's Adam step count, one
    captured RL step equals its eager step bit for bit and the same step
    on the CPU within rtol 1e-5, atol 1e-6.
    Then the value-only trainer (``VNRLTrainer``) on each learned baseline
    (``sarl``, ``sarl_om``, ``lstm_rl``, ``cadrl`` at one human, ``rgl``):
    one and 8 captured SGD steps against eager ones (SGD and Adam), 64
    captured collection steps against eager ones (the demonstrator, and the
    baseline at ε = 0.5), and ``train_loop.train`` in its debug shrink
    graphed (and, for ``sarl``, eager), with phase 9's checks. None of
    kernels #1-#7 may launch; ORCA's kernel must, and MP-RGL's value
    kernel may (the MP-RGL runs).
11. The node-partitioned paths of ``parallel/`` on D ranks run as threads
    on the one card (``LocalComm``, D = 1, 2, 4, 8), the reference's
    ``bench_scaling.py`` protocol at full width (``GCNConfig``, the value
    head 32-100-100-1): the ring, all-gather and block-halo SparseRGL
    forwards at n = 2048·D, K=16, 8 chained forwards (block halo: sorted,
    B=128, C=448, packed masks, the least halo a multiple of 8), each D in
    turn, each forward held to the one-device SparseRGL at rtol 2e-4 / atol 2e-5 and kernel #1 launched
    exactly D x 2 x 8 times on a block-halo row (none on the others); kernel
    #2 through ``block_halo_attention`` with a value table at D=4 (D
    launches, equal to its plain version, timed per launch with #1 at the
    same shapes); the partitioned mega-crowd rollout at n = 2048·D (n_cap
    2688, B=128, C=512, K=16, K_orca=10, 16 steps, R=8): window coverage 1,
    no overflow, none lost, every agent kept, #1
    launched D x 2 x 16 times and ORCA's kernel D x 16, |vmean| within
    1e-3 of the one-device loop (max |pos| difference reported); the
    reference's 600-agent D=4 case against the one-device loop at atol
    1e-4; and the D=2 block forward as
    two ``torch.distributed`` processes (gloo) sharing the card, equal to
    the threads' result bit for bit. Each forward row and mega run also
    runs graphed: every rank captured into one CUDA graph
    (``Mesh.capture``; the mega run with its per-chunk rebuilds), whose
    ``launches`` must be the eager run's (#1 D x 2 x 8, D x 2 x 16;
    ORCA's D x 16 in the mega run) and
    whose replay must equal the eager run bit for bit, beside the capture
    seconds. The rows (``partition_row``, ``mega_row``) are
    ``tools/bench_scaling.py``'s, whose ``main`` and ``--mega`` (phase 13)
    time them.
12. The data- and tensor-parallel path (``parallel/sharding.py``) at the
    full width of ``mp_separate``, the first stage of the reference's
    multi-device dry run at its meshes for 2, 4 and 8 devices, (data,
    model) = (2, 1), (2, 2), (4, 2) rank threads: 2 collection steps of the
    16 train envs split over data, equal to one device's bit for bit; the
    transitions pushed, a minibatch of 100 sampled and one dp/tp SGD step
    (the imitation optimizer) within value-loss rel 1e-4 and parameters
    1e-4 of one device (``tests/test_parallel.py:107-147``); the step
    captured as one graph of all ranks equal to the eager ranks bit for
    bit for SGD and Adam, every rank of an axis holding the same bits.
    Then ``cli.train --debug
    --mesh_data 2 --mesh_model 2`` to its end, ``cli.train --multihost``
    as two gloo processes against ``--mesh_data 2`` as threads at toy
    counts (the checkpoints bit for bit), ``NativeORCA`` against
    ``envs/orca.py`` on 64 test cases' humans on the card, and one
    ``mprl_td`` test case rendered to a GIF. None of #1-#7 may launch;
    ORCA's kernel must.
13. The repository's four measurement entry points (slice 13). Kernels
    #1/#2 in bfloat16 against their plain versions at ``bench_roofline``'s
    chain shapes (n=8192, K=16, d=64, B=256, C=640) and at the JAX test's
    (n=1024, K=8, B=128, C=384, d=32, dv=48), stable and unshifted, every
    epilogue, rows with no edge, within two bfloat16 ulps (rtol=atol=2^-7);
    timed at the roofline's shapes as phase 3 times the float32 rows (warm
    and cold L2, the byte bound with bfloat16 tables, the plain version,
    one bfloat16 ``scaled_dot_product_attention`` over the gathered window)
    beside the float32 kernel on the same rows; the FMA kernel of
    ``vpu_peak`` (``csrc/roofline.cu``) against its plain version, bit for
    bit. ORCA's velocity kernel (``csrc/orca_velocity.cu``) against its
    plain version (``envs/orca.py::orca_velocity_plain``) bit for bit at
    the crowd's kNN shapes (n=10,240, K=10), the dense env's (B=500, 5 and
    6 agents, the neighbour tables expanded), M=64 and on pile-ups where
    linearProgram3 decides; one launch a crowd step and one an env step;
    timed warm and with a cold L2 at the crowd's shapes beside its bound,
    the plain version's eager chain, and the whole kNN step (gathers
    included) with either. MP-RGL's value kernel (``csrc/rgl_value.cu``)
    against ``MPRLNetworks.value`` at rtol=atol=1e-5 on the committed
    ``mprl_td`` weights and states of the evaluation at B=500 (the root
    clip's 40,500 and the inner clip's 81,000 forwards with shared humans,
    the nodes' 1,000 and the leaves' 2,000 gathered) and at B=1 (the root
    clip's 81), each timed warm and with a cold L2 beside its operation
    bound and the plain version; four launches in a captured evaluation
    step. Then bench.py's collection graphed == eager at
    B=1024 (16 steps; ORCA's kernel once a step eager and in the step's
    graph, no other kernel),
    and each tool's ``main`` at the reference's sizes (``tools/bench.py``
    with 2 graphed trials and 1 eager, the reference's 5;
    ``tools/bench_extra.py``; ``tools/bench_roofline.py``, its record to
    ``chiprun_out/ROOFLINE.json``; ``tools/bench_scaling.py`` and ``--mega``
    with 1 timed replay a row, the reference's 3), printing their lines and
    walls, with exact launches: ORCA's kernel once an env step on
    bench.py's collection and the planner's, MP-RGL's value kernel four
    times a decision of the planner's, nothing else there; #1 100 times a fused-block chain row (f32 and bf16), 64
    times (and ORCA's 32) a 102,400-agent R=8 rollout, D·2·8 a block-halo
    row and D·2·16 (ORCA's D·16) a mega row; the FMA kernel 16 times in
    ``vpu_peak``. The ``kernels`` line takes ORCA's launches from that
    rollout's.
14. Print the ``kernels`` line, the card line and the last line.

Details go to ``chiprun_out/chip_smoke.json``. Needs one card and no network.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from benchmarks.counters import fba
from relationalgraphlearning_tpu_torch import captured, checkpoints
from relationalgraphlearning_tpu_torch import relation_chain as rc
from relationalgraphlearning_tpu_torch import types as T
from relationalgraphlearning_tpu_torch.cli import test as eval_cli
from relationalgraphlearning_tpu_torch.configs.base import (
    EnvConfig, GCNConfig, PolicyConfig, load_config_module)
from relationalgraphlearning_tpu_torch.envs import mega_crowd
from relationalgraphlearning_tpu_torch.envs.crowd_sim import CrowdSim
from relationalgraphlearning_tpu_torch.envs import orca as orca_env
from relationalgraphlearning_tpu_torch.envs.orca import ORCAParams
from relationalgraphlearning_tpu_torch.ops import _build
from relationalgraphlearning_tpu_torch.ops import ab_block as ab
from relationalgraphlearning_tpu_torch.ops import block_graph as bg
from relationalgraphlearning_tpu_torch.ops import fused_block as fb
from relationalgraphlearning_tpu_torch.ops import fused_chunk as fc
from relationalgraphlearning_tpu_torch.ops import fused_gather as fg
from relationalgraphlearning_tpu_torch.ops import rgl_value as rgv
from relationalgraphlearning_tpu_torch.ops import roofline
from relationalgraphlearning_tpu_torch.ops.sparse import knn_graph_auto
from relationalgraphlearning_tpu_torch.parallel import distributed
from relationalgraphlearning_tpu_torch.parallel import graph_partition as gp
from relationalgraphlearning_tpu_torch.parallel import partitioned_build as pb
from relationalgraphlearning_tpu_torch.parallel import sharding
from relationalgraphlearning_tpu_torch.policies.factory import make_policy
from relationalgraphlearning_tpu_torch.parallel.comm import run_local
from relationalgraphlearning_tpu_torch.parallel.mesh import (
    make_mesh, split_rows)
from relationalgraphlearning_tpu_torch.tools import ab_kernel as ak
from relationalgraphlearning_tpu_torch.tools import bench as tb
from relationalgraphlearning_tpu_torch.tools import bench_extra as tbe
from relationalgraphlearning_tpu_torch.tools import bench_roofline as tbr
from relationalgraphlearning_tpu_torch.tools import bench_scaling as bs
from relationalgraphlearning_tpu_torch.tools import diag_unicycle as diag
from relationalgraphlearning_tpu_torch.training import checkpoint as ckpt
from relationalgraphlearning_tpu_torch.training import replay_buffer as rb
from relationalgraphlearning_tpu_torch.training import train_loop
from relationalgraphlearning_tpu_torch.training.explorer import Explorer
from relationalgraphlearning_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
TOL = dict(rtol=1e-5, atol=1e-5)
SLICE = dict(n=10240, K=10, steps=32, backend="block", packed=True,
             block_B=256, block_C=576, rebuild_every=8)
PALLAS = dict(n=10240, K=10, steps=32, backend="pallas", rebuild_every=8)
CHAIN = dict(n=8192, K=16, inner=100, B=256, C=544)
# A replay of a captured graph against the eager run on the same inputs:
# the same kernels in the same order, so the same bits.
REPLAY_TOL = dict(rtol=0, atol=0)
# Graph replays a timed chain round takes between synchronises (the
# reference's ``_timeit`` amortises its dispatch the same way); an eager
# round is one chain run.
CHAIN_GRAPH_REPS = 5
# The final h of every route after CHAIN["inner"] applications against the
# plain gather chain's: the chain contracts (a CPU rehearsal at this size
# drifted 1.5e-7), so the float32 sums of one application stay that small.
CHAIN_FINAL_TOL = 1e-5
CHAIN_CASES = (("gather", 64), ("gather_kernel", 64), ("block", 64),
               ("chunk", 64), ("block", 32), ("chunk_d32", 32))
ROUTE_KERNEL = {"gather_kernel": "fused_gather_attention",
                "block": "fused_block_attention_packed_shared",
                "chunk": "chunk_block_attention",
                "chunk_d32": "chunk_block_attention"}
SOURCES = ("fused_block_attention.cu", "fused_gather_attention.cu",
           "chunk_block_attention.cu", "ab_block_attention.cu",
           "roofline.cu", "orca_velocity.cu", "rgl_value.cu")
# Kernel #6's four instantiations in the harness: (dtype, div_after,
# intmask); phase 3c also checks the other four combinations.
AB_VARIANTS = {"base_f32": (torch.float32, False, False),
               "divafter_f32": (torch.float32, True, False),
               "divafter_intmask_f32": (torch.float32, True, True),
               "divafter_bf16": (torch.bfloat16, True, False)}
# One bfloat16 ulp of the value (2^-7 of it; 2^-9 near zero): both sides
# round e (or e/den) and the output to bfloat16 with round-to-nearest-even,
# from float32 sums taken in another order.
BF16_TOL = dict(rtol=2**-7, atol=2**-9)
# The harness at the reference's shapes, its checked runs alone (no timed
# rounds: the harness's own entry point times them).
HARNESS = dict(rounds=0, B=256, C=544, inner=100)
# The bfloat16 chain's final h against the float32 gather chain: bfloat16
# features carry 8 bits, so each application rounds every element by up to
# half an ulp and the contracting chain holds about one step's rounding.
# Measured 5.36e-3 at these shapes, with the plain version on the CPU and
# with the kernel on an NVIDIA H100 alike; the limit is that drift with
# about half again of room, not an ulp count.
BF16_CHAIN_TOL = 2**-7
# The bfloat16 chain on kernel #6 against the same chain on its plain
# version: each application's float32 sums run in another order, so a
# rounding of e or of the output may land one ulp apart, and the chain
# contracts it. Measured 1.95e-3 (one ulp of a value in [0.25, 0.5)) on an
# NVIDIA H100; the limit is two such ulps.
BF16_KERNEL_CHAIN_TOL = 2**-8
# Phase 8: (run, model directory, planner overrides, committed record).
MPRL_RUNS = (("mprl_td", "mprl_td", {}, "eval_test.json"),
             ("mprl_td_d1", "mprl_td", {"planning_depth": 1},
              "eval_test_d1.json"),
             ("mprl_td_d2_w4", "mprl_td",
              {"planning_depth": 2, "planning_width": 4},
              "eval_test_d2_w4.json"),
             ("mp_unicycle_anneal", "mp_unicycle_anneal", {},
              "eval_test.json"))
# Against the committed record: 0.010 is 5 cases of 500, about two binomial
# standard deviations at p = 0.99; a nav time within one 0.25 s step. A
# near-tie that flips one planning decision changes a trajectory, so
# outcomes are held case by case to the JAX package's on most cases, not
# all.
MPRL_BOUNDS = dict(success_rate=0.010, collision_rate=0.010,
                   nav_time=0.20)
MPRL_MIN_AGREE = 485
# Phase 10: (run, model directory, policy, the CLI's overrides, committed
# record), held to MPRL_BOUNDS and MPRL_MIN_AGREE.
BASELINE_RUNS = (
    ("sarl", "sarl", "sarl", {}, "eval_test.json"),
    ("sarl_om", "sarl_om", "sarl", {}, "eval_test.json"),
    ("lstm_rl", "lstm_rl", "lstm_rl", {}, "eval_test.json"),
    ("cadrl", "cadrl", "cadrl", {"human_num": 5}, "eval_test.json"),
    ("rgl", "rgl", "rgl", {}, "eval_test.json"),
    ("orca", "orca", "orca", {}, "eval_test.json"),
    ("orca_th10", "orca_th10", "orca", {"orca_time_horizon": 10.0},
     "eval_test_th10.json"))
# Phase 10's training checks: (model of results/<model>/config.py, policy).
# The eager debug run (a minute each) runs for sarl only; the captured SGD
# steps and collection are held to eager ones for every baseline.
BASELINE_TRAIN = (("sarl", "sarl"), ("sarl_om", "sarl"),
                  ("lstm_rl", "lstm_rl"), ("cadrl", "cadrl"), ("rgl", "rgl"))
# Phase 10: where the runs of the learned baselines that the port trained
# from scratch on the card lie (tools/reproduce_quality.py, seed 0:
# <row>_s0), each held to its committed eval_test.json with MPRL_BOUNDS.
PORT_RESULTS = ROOT / "relationalgraphlearning_tpu_torch" / "results"
# Phase 10: the MP-RGL runs the port trained on the card (slice 14): the
# unicycle anneal's stage 2 from the converted committed stage 1, the two
# stages end to end, and the quality table's mp_unicycle and mp_w4 rows,
# each held to its own eval_test.json with MPRL_BOUNDS.
PORT_MPRL_RUNS = ("mp_unicycle_anneal_s0", "mp_unicycle_2stage_s0",
                  "mp_unicycle_s0", "mp_w4_s0")
# Phase 10's resume check: the exported state of results/<model>, resumed
# under stage 2's config, moves at that config's rate from its own Adam
# step count; the card's step against the CPU's at the trainer tests'
# tolerance (tests/test_torch_trainer.py).
RESUME = dict(model="mp_unicycle", step=1_550_000,
              config=ROOT / "configs" / "icra_benchmark"
              / "mp_unicycle_anneal.py")
RESUME_TOL = dict(rtol=1e-5, atol=1e-6)
# Published dense peaks (NVIDIA data sheets): float32 outside the tensor
# cores in FLOP/s, device memory in bytes/s. Matched on the card's name;
# the SXM part is the default.
PEAKS = (("H100 PCIe", 51e12, 2.0e12), ("H100 NVL", 60e12, 3.9e12),
         ("H100", 67e12, 3.35e12))


def peaks(name: str):
    for key, flops, bw in PEAKS:
        if key in name:
            return flops, bw
    raise RuntimeError(f"no published peaks for {name!r}")


def device_ms(fn, reps: int = 50) -> float:
    """Device time of one call of ``fn``, from CUDA events around ``reps``
    back-to-back calls. A sleep kernel queued first lets the host enqueue
    all calls before the first runs, so host overhead does not show."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * 2e9) + 1_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


_FLUSH = []


def device_ms_cold(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn`` with a cold L2: before each call a
    write over 128 MB (more than the card's 50 MB L2) evicts its inputs, and
    events around the call alone time it. The mean over ``reps`` calls."""
    if not _FLUSH:
        _FLUSH.append(torch.empty(32 << 20, dtype=torch.float32,
                                  device="cuda"))
    flush = _FLUSH[0]
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]

    def calls():
        for start, end in pairs:
            flush.fill_(1.0)
            start.record()
            fn()
            end.record()

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calls()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # as in device_ms: the host has queued every call before the first runs
    torch.cuda._sleep(int(2 * host_s * 2e9) + 1_000_000)
    calls()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def timed(fn) -> float:
    """Wall seconds of ``fn``, between synchronises of the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def bound(nbytes: float, ops: float, flops: float, bw: float):
    t_bytes, t_ops = nbytes / bw * 1e3, ops / flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def slice_inputs(dev, C=576):
    """The graph of the slice's first rebuild and the first GCN layer's
    inputs (q = w_a(H), keys = values = H) under the smoke's seeded net."""
    pos = mega_crowd.initial_crowd(SLICE["n"], device=dev)
    vel = torch.zeros_like(pos)
    pos, (vel,), cols, _, cand, mbits, cov = mega_crowd.rebuild(
        pos, (vel,), SLICE["K"], "block", SLICE["block_B"], C, True)
    net = bs.seeded_value_net("block", dev)
    states = torch.cat([pos, vel, torch.full_like(pos[:, :1], 0.3)], -1)
    with torch.no_grad():
        H = net.graph_model.w_h(states)
        q = net.graph_model.w_a(H)
    nb = cand.shape[0]
    return q.reshape(nb, -1, q.shape[1]).contiguous(), H, cand, mbits, cov


def unit_rows(t):
    return t / t.norm(dim=-1, keepdim=True)


def row_rel_err(got, exact) -> float:
    """max |got - exact| over the largest magnitude of exact's row."""
    scale = exact.abs().amax(-1, keepdim=True).clamp(min=1e-30)
    return float(((got.double() - exact).abs() / scale).max())


# ------------------------------------------------------------------ phase 3
def kernel_phase(dev, flops, bw, report):
    qb, H, cand, mbits, cov = slice_inputs(dev)
    if float(cov) != 1.0:
        raise RuntimeError(f"slice graph coverage {float(cov)} != 1")
    n, d = H.shape
    nb, B, _ = qb.shape
    C = cand.shape[1]

    # The 1e-5 checks run unit-normal features at the slice's shapes on the
    # slice's graph. The main path's own features (positions up to 200 m
    # through w_h) reach scores of ~4.5e3, where float32 rounding of a score
    # alone moves its softmax weight by more than 1e-5; those are held
    # against float64 below instead.
    g = torch.Generator(device="cpu").manual_seed(2)
    qn, xn, v48, v32 = (torch.randn(*s, generator=g).to(dev)
                        for s in ((nb, B, d), (n, d), (n, 48), (n, 32)))
    uq, ux = unit_rows(qn), unit_rows(xn)
    no_edge = mbits.clone()
    no_edge[0, 0, :] &= ~0x1F                  # rows 0-4 of block 0: no edge
    for c_cut in (448, 384, 320, 256):  # a window too small for the graph
        _, _, cand_cut, mbits_cut, cov_cut = slice_inputs(dev, C=c_cut)
        if float(cov_cut) < 1.0:
            break
    else:
        raise RuntimeError("no window below C=576 dropped an edge")
    report["notes"].append(f"coverage < 1 case: C={c_cut}, coverage "
                           f"{float(cov_cut)}")

    errs = {"shared": [], "separate": []}

    def compare(kind, label, args, epilogue="none", stable=True,
                zero_rows=False):
        if kind == "shared":
            got = fb.fused_block_attention_packed_shared(
                *args, epilogue=epilogue, stable=stable)
            want = fb.fused_block_attention_packed_shared_plain(
                *args, epilogue=epilogue, stable=stable)
        else:
            got = fb.fused_block_attention_packed(
                *args, epilogue=epilogue, stable=stable)
            want = fb.fused_block_attention_packed_plain(
                *args, epilogue=epilogue, stable=stable)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL,
                                   msg=lambda m: f"{kind}/{label}: {m}")
        if zero_rows and not (got[0, :5] == 0).all():
            raise RuntimeError(f"{kind}/{label}: rows with no edge are "
                               "not exactly 0")
        err = float((got - want).abs().max())
        errs[kind].append(err)
        report["cases"].append(dict(kernel=kind, case=label,
                                    epilogue=epilogue, stable=stable,
                                    max_abs_err=err))

    for epi in ("none", "l2norm", "relu"):
        compare("shared", "slice graph", (qn, xn, cand, mbits), epi)
        compare("shared", "unit rows, unshifted", (uq, ux, cand, mbits), epi,
                stable=False)
        compare("separate", "slice graph, dv=48", (qn, xn, v48, cand, mbits),
                epi)
        compare("separate", "unit rows, unshifted, dv=48",
                (uq, ux, v48, cand, mbits), epi, stable=False)
    compare("shared", "no-edge rows", (qn, xn, cand, no_edge),
            zero_rows=True)
    compare("separate", "no-edge rows", (qn, xn, v32, cand, no_edge),
            zero_rows=True)
    compare("shared", "coverage < 1", (qn, xn, cand_cut, mbits_cut))
    compare("separate", "coverage < 1", (qn, xn, v32, cand_cut, mbits_cut))

    # the main path's own layer-1 inputs, against float64: the error of each
    # float32 version over the largest magnitude of its row
    exact = fb.fused_block_attention_packed_shared_plain(
        qb.double(), H.double(), cand, mbits)
    kernel_rel = row_rel_err(fb.fused_block_attention_packed_shared(
        qb, H, cand, mbits), exact)
    plain_rel = row_rel_err(fb.fused_block_attention_packed_shared_plain(
        qb, H, cand, mbits), exact)
    report["main_path_features"] = dict(
        kernel_row_rel_err=kernel_rel, plain_row_rel_err=plain_rel,
        out_max=float(exact.abs().max()))
    print(f"main-path features vs float64: kernel {kernel_rel:.3g}, plain "
          f"{plain_rel:.3g} (row-relative)", flush=True)
    if kernel_rel > 1e-5:
        raise RuntimeError(f"kernel off float64 by {kernel_rel} of the row "
                           "on the main path's features")

    # time at the slice's shapes: the kernel, its plain version, and one
    # PyTorch call of the same function as a yardstick
    mask = fb.unpack_emask(mbits, B)
    edges = int(mask.sum())
    xg = H[cand.clamp(0, n - 1)]
    vg = v32[cand.clamp(0, n - 1)]
    no_edges = torch.zeros_like(mbits)
    rows = []
    for kind, name, replaces, dv, run, plain, lib in (
        ("shared", "fused_block_attention_packed_shared",
         "relationalgraphlearning_tpu/ops/pallas_block.py:192", d,
         lambda m: fb.fused_block_attention_packed_shared(qb, H, cand, m),
         lambda: fb.fused_block_attention_packed_shared_plain(
             qb, H, cand, mbits),
         lambda: F.scaled_dot_product_attention(qb, xg, xg, attn_mask=mask,
                                                scale=1.0)),
        ("separate", "fused_block_attention_packed",
         "relationalgraphlearning_tpu/ops/pallas_block.py:235", 32,
         lambda m: fb.fused_block_attention_packed(qb, H, v32, cand, m),
         lambda: fb.fused_block_attention_packed_plain(
             qb, H, v32, cand, mbits),
         lambda: F.scaled_dot_product_attention(qb, xg, vg, attn_mask=mask,
                                                scale=1.0)),
    ):
        ms = device_ms(lambda: run(mbits))
        cold_ms = device_ms_cold(lambda: run(mbits))
        # the launch and every CTA's set-up, with no edge to follow
        ms_no_edges = device_ms(lambda: run(no_edges))
        plain_ms = device_ms(plain, reps=20)
        try:
            library_ms = device_ms(lib)
        except RuntimeError as e:  # a yardstick only: note why it is absent
            library_ms = None
            report["notes"].append(f"{name}: library call failed: {e}")
        # #1's bytes and operations: the count fba_roofline.crowd divides
        # by. #2 also reads its value table and writes dv wide; per edge d
        # multiply-adds for the score, dv for the value sum, one exp and
        # one add for the denominator
        nbytes, ops = fba.launch(n, d, B, C, edges)
        if kind == "separate":
            nbytes += 4 * (n * dv + nb * B * (dv - d))
            ops = edges * (2 * d + 2 * dv + 2)
        bound_ms, bound_by = bound(nbytes, ops, flops, bw)
        dense_ops = nb * B * C * (2 * d + 2 * dv + 2)
        rows.append(dict(
            name=name, route="cuda",
            source="relationalgraphlearning_tpu_torch/csrc/"
                   "fused_block_attention.cu",
            replaces=replaces, launches=0,
            max_abs_err=max(errs[kind]), ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
            cold_ms=cold_ms))
        report["kernel_detail"][name] = dict(
            ms_no_edges=ms_no_edges,
            shapes=dict(nb=nb, B=B, C=C, d=d, dv=dv, n=n), edges=edges,
            bytes=nbytes, ops=ops, dense_ops=dense_ops,
            dense_bound_ms=bound(nbytes, dense_ops, flops, bw)[0],
            cases=len(errs[kind]))
        print(f"kernel {name}: {ms:.4f} ms, cold L2 {cold_ms:.4f} ms, no "
              f"edges {ms_no_edges:.4f} ms (plain {plain_ms:.4f} ms, "
              f"library {library_ms} ms, bound {bound_ms:.4f} ms by "
              f"{bound_by}), max_abs_err {max(errs[kind]):.3g} over "
              f"{len(errs[kind])} cases", flush=True)
    return rows


# ----------------------------------------------------------------- phase 3b
def timed_row(report, name, replaces, source, fn, plain, lib, nbytes, ops,
              flops, bw, errs, shapes, cold=False):
    """One ``kernels`` row; with ``cold``, also the kernel's time with a
    cold L2 (``cold_ms``)."""
    ms = device_ms(fn)
    plain_ms = device_ms(plain, reps=20)
    try:
        library_ms = device_ms(lib)
    except RuntimeError as e:  # a yardstick only: note why it is absent
        library_ms = None
        report["notes"].append(f"{name}: library call failed: {e}")
    bound_ms, bound_by = bound(nbytes, ops, flops, bw)
    report["kernel_detail"][name] = dict(shapes=shapes, bytes=nbytes,
                                         ops=ops, cases=len(errs))
    row = dict(name=name, route="cuda",
               source=f"relationalgraphlearning_tpu_torch/csrc/{source}",
               replaces=replaces, launches=0, max_abs_err=max(errs), ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=library_ms)
    if cold:
        row["cold_ms"] = device_ms_cold(fn)
    cold_ms = f", cold L2 {row['cold_ms']:.4f} ms" if cold else ""
    print(f"kernel {name}: {ms:.4f} ms{cold_ms} (plain {plain_ms:.4f} ms, "
          f"library {library_ms} ms, bound {bound_ms:.5f} ms by {bound_by}),"
          f" max_abs_err {max(errs):.3g} over {len(errs)} cases", flush=True)
    return row


def pallas_inputs(dev):
    """The pallas rollout's first graph (unsorted kNN, K=16) and its first
    GCN layer's inputs under the smoke's seeded net: q = w_a(H), H."""
    pos = mega_crowd.initial_crowd(PALLAS["n"], device=dev)
    vel = torch.zeros_like(pos)
    pos, (vel,), cols, _, _, _, _ = mega_crowd.rebuild(
        pos, (vel,), PALLAS["K"], "pallas", 256, 576, False)
    net = bs.seeded_value_net("pallas", dev)
    states = torch.cat([pos, vel, torch.full_like(pos[:, :1], 0.3)], -1)
    with torch.no_grad():
        H = net.graph_model.w_h(states)
        q = net.graph_model.w_a(H)
    return q, H, cols


def kernel_phase_2(dev, flops, bw, report):
    """Kernels #3, #4, #7, #5 and the aligned route of #1 against their plain
    versions on the card, at rtol=atol=1e-5, and their times."""
    n, K, B, C = CHAIN["n"], CHAIN["K"], CHAIN["B"], CHAIN["C"]
    cols = rc.crowd_graph(n, K, device=dev)
    g = torch.Generator(device="cpu").manual_seed(3)

    def randn(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    errs = {k: [] for k in ("#3", "#4", "#7", "#5", "aligned")}

    def compare(kernel, label, got, want, zero_rows=None):
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL,
                                   msg=lambda m: f"{kernel}/{label}: {m}")
        if zero_rows is not None and not (zero_rows(got) == 0).all():
            raise RuntimeError(f"{kernel}/{label}: rows with no edge are "
                               "not exactly 0")
        err = float((got - want).abs().max())
        errs[kernel].append(err)
        report["cases"].append(dict(kernel=kernel, case=label,
                                    max_abs_err=err))

    # ---- #3, the per-edge gather kernel: the chain's semantics
    q64, x64, v48 = randn(n, 64), randn(n, 64), randn(n, 48)
    # the separate value table draws from its own seed, leaving g's draws,
    # and so the later cases' inputs, as they were
    v64 = torch.randn(n, 64, generator=torch.Generator().manual_seed(4)).to(
        dev)
    mask = torch.rand(n, K, generator=g).to(dev) > 0.3
    mask[:4] = False                               # fully masked rows
    dup = cols.clone()
    dup[:, 1] = dup[:, 0]                          # a duplicate neighbour
    # keys ≡ values (x is v: one read a neighbour row) and x ≠ v (a value
    # table of its own, loaded beside the keys)
    for label, args in (("keys = values, chain graph, mask=None",
                         (q64, x64, x64, cols)),
                        ("keys = values, fully masked rows",
                         (q64, x64, x64, cols, mask)),
                        ("x != v, chain graph", (q64, x64, v64, cols)),
                        ("x != v, fully masked rows, dv=48",
                         (q64, x64, v48, cols, mask)),
                        ("keys = values, duplicate cols",
                         (q64, x64, x64, dup))):
        compare("#3", label, fg.fused_gather_attention(*args),
                fg.fused_gather_attention_plain(*args))
    for v in (x64, v48):
        got = fg.fused_gather_attention(q64, x64, v, cols, mask)
        torch.testing.assert_close(got[:4], v[cols[:4]].mean(1), **TOL)
    qp, Hp, colsp = pallas_inputs(dev)
    qn, xn = randn(*qp.shape), randn(*Hp.shape)
    compare("#3", "rollout graph, d=32", fg.fused_gather_attention(
        qn, xn, xn, colsp), fg.fused_gather_attention_plain(qn, xn, xn, colsp))
    # the main path's own layer-1 inputs (scores ~4.5e3), against float64
    exact = fg.fused_gather_attention_plain(qp.double(), Hp.double(),
                                            Hp.double(), colsp)
    kernel_rel = row_rel_err(fg.fused_gather_attention(qp, Hp, Hp, colsp),
                             exact)
    plain_rel = row_rel_err(fg.fused_gather_attention_plain(qp, Hp, Hp,
                                                            colsp), exact)
    report["pallas_main_path_features"] = dict(
        kernel_row_rel_err=kernel_rel, plain_row_rel_err=plain_rel)
    print(f"#3 on the pallas rollout's features vs float64: kernel "
          f"{kernel_rel:.3g}, plain {plain_rel:.3g} (row-relative)",
          flush=True)
    if kernel_rel > 1e-5:
        raise RuntimeError(f"kernel #3 off float64 by {kernel_rel} of the "
                           "row on the main path's features")

    # ---- #4 (d=64, groups=2) and #7 (d=32, groups=4), the chunked fetch
    art = {}
    for kernel, d, groups in (("#4", 64, 2), ("#7", 32, 4)):
        starts, tail, mbits, cov = fc.chunk_window(cols, B, groups=groups)
        if float(cov) != 1.0:
            raise RuntimeError(f"{kernel}: chunk_window coverage {float(cov)}")
        art[kernel] = (starts, tail, mbits)
        qr, xr = randn(n, d), randn(n, d)
        uq, ux = unit_rows(qr), unit_rows(xr)
        no_edge = mbits.clone()
        no_edge[0, 0, :] &= ~0x1F                 # rows 0-4: no edge
        for epi in ("none", "l2norm", "relu"):
            for label, (a, b), stable in (("stable", (qr, xr), True),
                                          ("unit rows, unshifted", (uq, ux),
                                           False)):
                args = (a, b, starts, tail, mbits, epi, stable, groups)
                compare(kernel, f"{label}, {epi}",
                        fc.chunk_block_attention(*args),
                        fc.chunk_block_attention_plain(*args))
        args = (qr, xr, starts, tail, no_edge, "none", True, groups)
        compare(kernel, "no-edge rows", fc.chunk_block_attention(*args),
                fc.chunk_block_attention_plain(*args),
                zero_rows=lambda o: o[:5])
        for ct in (128, 64, 32):                  # a tail too small
            cut = fc.chunk_window(cols, B, ct=ct, groups=groups)
            if float(cut[3]) < 1.0:
                break
        else:
            raise RuntimeError(f"{kernel}: no tail below 288 dropped an edge")
        report["notes"].append(f"{kernel} coverage < 1 case: ct={ct}, "
                               f"coverage {float(cut[3])}")
        args = (qr, xr, *cut[:3], "none", True, groups)
        compare(kernel, f"coverage < 1 (ct={ct})",
                fc.chunk_block_attention(*args),
                fc.chunk_block_attention_plain(*args))

    # ---- #5, the r3 form: pre-gathered tables, f32 mask, divide first
    cand, cov = bg.block_window(cols, B, C)
    emask = bg.block_masks(cols, cand)
    candc = cand.clamp(0, n - 1)
    xg, vg = x64[candc].contiguous(), v48[candc].contiguous()
    qb = q64.reshape(n // B, B, 64)
    em_f = emask.float()
    em_ne = em_f.clone()
    em_ne[0, :5] = 0.0                             # rows 0-4: no edge
    compare("#5", "chain window C=544", fb.fused_block_attention(
        qb, xg, vg, em_f), fb.fused_block_attention_plain(qb, xg, vg, em_f))
    compare("#5", "no-edge rows", fb.fused_block_attention(qb, xg, vg, em_ne),
            fb.fused_block_attention_plain(qb, xg, vg, em_ne),
            zero_rows=lambda o: o[0, :5])

    # ---- the aligned route: kernel #1 through the expanded aligned cand
    x32 = randn(n, 32)
    starts_a, cand_a, _ = bg.block_window_aligned(cols, B, 1024, 8)
    bits_a = fb.pack_emask(bg.block_masks(cols, cand_a))
    for epi in ("none", "l2norm"):
        args = (randn(n, 32), x32, x32, starts_a, 8, bits_a, epi)
        compare("aligned", f"align 8, window 1024, {epi}",
                fb.block_attention_fused_aligned(*args),
                fb.block_attention_fused_aligned_plain(*args))

    # ---- times: #3 at the pallas rollout's shapes with its features
    rows = []
    np_, dp = Hp.shape
    Kp = colsp.shape[1]
    kg = Hp[colsp]
    rows.append(timed_row(
        report, "fused_gather_attention", "tools/probe_mosaic_gather.py:68",
        "fused_gather_attention.cu",
        lambda: fg.fused_gather_attention(qp, Hp, Hp, colsp),
        lambda: fg.fused_gather_attention_plain(qp, Hp, Hp, colsp),
        lambda: F.scaled_dot_product_attention(qp[:, None], kg, kg,
                                               scale=1.0),
        4 * (2 * np_ * dp + np_ * dp) + 8 * colsp.numel(),
        np_ * Kp * (4 * dp + 2), flops, bw, errs["#3"],
        dict(n=np_, K=Kp, d=dp, dv=dp), cold=True))
    # the same with a value table of its own (x ≠ v, the values' rows
    # loaded beside the keys'): the cost of reading each row twice
    Hv = Hp.clone()
    report["kernel_detail"]["fused_gather_attention"]["ms_x_ne_v"] = \
        device_ms(lambda: fg.fused_gather_attention(qp, Hp, Hv, colsp))
    # and at the chain's (a detail: the chain's gather_kernel route)
    kg64 = x64[cols]

    def run64():
        return fg.fused_gather_attention(q64, x64, x64, cols)
    detail = dict(
        ms=device_ms(run64), cold_ms=device_ms_cold(run64),
        ms_x_ne_v=device_ms(lambda: fg.fused_gather_attention(
            q64, x64, v64, cols)),
        plain_ms=device_ms(lambda: fg.fused_gather_attention_plain(
            q64, x64, x64, cols), reps=20),
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(
            q64[:, None], kg64, kg64, scale=1.0)),
        bound=bound(4 * 3 * n * 64 + 8 * cols.numel(), n * K * (4 * 64 + 2),
                    flops, bw))
    report["kernel_detail"]["fused_gather_attention@chain"] = detail
    print(f"kernel fused_gather_attention: x != v "
          f"{report['kernel_detail']['fused_gather_attention']['ms_x_ne_v']:.4f}"
          f" ms; at the chain's shapes: {detail}", flush=True)

    # #4 and #7 at the chain's shapes on its unit features
    for kernel, d, groups, replaces in (
            ("#4", 64, 2, "relationalgraphlearning_tpu/ops/pallas_chunk.py:255"),
            ("#7", 32, 4, "tools/probe_chunk_d32.py:122")):
        starts, tail, mbits = art[kernel]
        h = rc.seed_features(n, d, device=dev)
        nb, ntot = mbits.shape[0], mbits.shape[-1]
        ids = fc.chunk_slot_ids(starts, tail, n, (ntot - tail.shape[1])
                                // starts.shape[1], groups)
        win = h[ids]
        wmask = fb.unpack_emask(mbits, B)
        hb = h.reshape(nb, B, d)
        edges = int(wmask.sum())
        rows.append(timed_row(
            report, f"chunk_block_attention[groups={groups}]", replaces,
            "chunk_block_attention.cu",
            lambda: fc.chunk_block_attention(h, h, starts, tail, mbits,
                                             "l2norm", False, groups),
            lambda: fc.chunk_block_attention_plain(h, h, starts, tail, mbits,
                                                   "l2norm", False, groups),
            lambda: F.scaled_dot_product_attention(hb, win, win,
                                                   attn_mask=wmask,
                                                   scale=1.0),
            4 * (3 * n * d + starts.numel() + mbits.numel())
            + 8 * tail.numel(), edges * (4 * d + 2), flops, bw,
            errs[kernel], dict(n=n, B=B, d=d, ntot=ntot, groups=groups,
                               edges=edges), cold=True))
        # the launch and every CTA's set-up, with no edge to follow
        no_edges = torch.zeros_like(mbits)
        ms_no_edges = device_ms(lambda: fc.chunk_block_attention(
            h, h, starts, tail, no_edges, "l2norm", False, groups))
        report["kernel_detail"][rows[-1]["name"]]["ms_no_edges"] = ms_no_edges
        print(f"  {rows[-1]['name']} with no edges: {ms_no_edges:.4f} ms",
              flush=True)

    # #5 at the chain's window (C=544, d=64)
    edges = int(emask.sum())
    rows.append(timed_row(
        report, "fused_block_attention",
        "relationalgraphlearning_tpu/ops/pallas_block.py:99",
        "fused_block_attention.cu",
        lambda: fb.fused_block_attention(qb, xg, vg, em_f),
        lambda: fb.fused_block_attention_plain(qb, xg, vg, em_f),
        lambda: F.scaled_dot_product_attention(qb, xg, vg, attn_mask=emask,
                                               scale=1.0),
        4 * (qb.numel() + xg.numel() + vg.numel() + em_f.numel()
             + n * vg.shape[-1]), edges * (2 * 64 + 2 * 48 + 2), flops, bw,
        errs["#5"], dict(n=n, B=B, C=C, d=64, dv=48, edges=edges),
        cold=True))
    report["aligned_route_max_abs_err"] = max(errs["aligned"])
    return rows


# ----------------------------------------------------------------- phase 3c
def kernel_phase_3c(dev, flops, bw, report):
    """Kernel #6 against its plain version in all eight combinations, and
    the harness's four instantiations timed; kernel #1 timed at the same
    shapes."""
    n, K, B, C, d = CHAIN["n"], CHAIN["K"], CHAIN["B"], CHAIN["C"], 64
    cols, cand, cov, mbits, h = ak.graph(n, K, d, B, C, device=dev)
    if float(cov) != 1.0:
        raise RuntimeError(f"#6: window coverage {float(cov)} != 1")
    nb = cand.shape[0]
    candc = cand.clamp(0, n - 1)
    no_edge = mbits.clone()
    no_edge[0, 0, :] &= ~0x1F                      # rows 0-4 of block 0
    cand_cut, cov_cut = bg.block_window(cols, B, 256)
    if float(cov_cut) >= 1.0:
        raise RuntimeError("#6: a window of 256 slots dropped no edge")
    bits_cut = fb.pack_emask(bg.block_masks(cols, cand_cut))
    report["notes"].append(f"#6 coverage < 1 case: C=256, coverage "
                           f"{float(cov_cut)}")
    g = torch.Generator(device="cpu").manual_seed(6)
    uq = unit_rows(torch.randn(n, d, generator=g)).to(dev)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL if dtype == torch.float32 else BF16_TOL
        hq, hx = uq.to(dtype).reshape(nb, B, d), h.to(dtype)
        cases = (("chain window", hq, hx[candc], mbits),
                 ("no-edge rows", hq, hx[candc], no_edge),
                 ("coverage < 1 (C=256)", hq,
                  hx[cand_cut.clamp(0, n - 1)], bits_cut))
        for div_after in (False, True):
            for intmask in (False, True):
                key = (dtype, div_after, intmask)
                errs[key] = []
                for label, qb, xg, bits in cases:
                    got = ab.ab_block_attention(qb, xg, bits, div_after,
                                                intmask)
                    want = ab.ab_block_attention_plain(qb, xg, bits,
                                                       div_after, intmask)
                    torch.cuda.synchronize()
                    what = (f"#6 {dtype} div_after={div_after} "
                            f"intmask={intmask}, {label}")
                    torch.testing.assert_close(
                        got.float(), want.float(), **tol,
                        msg=lambda m: f"{what}: {m}")
                    if label == "no-edge rows" and not (got[0, :5] == 0).all():
                        raise RuntimeError(f"{what}: rows with no edge are "
                                           "not exactly 0")
                    err = float((got.float() - want.float()).abs().max())
                    errs[key].append(err)
                    report["cases"].append(dict(
                        kernel="#6", case=label, dtype=str(dtype),
                        div_after=div_after, intmask=intmask,
                        max_abs_err=err))
    report["ab_block_max_abs_err"] = {
        f"{dt}, div_after={da}, intmask={im}": max(e)
        for (dt, da, im), e in errs.items()}

    # times of the harness's four instantiations at its shapes
    mask = fb.unpack_emask(mbits, B)
    edges = int(mask.sum())
    rows = []
    for name, (dtype, div_after, intmask) in AB_VARIANTS.items():
        hd = h.to(dtype)
        qb, xg = hd.reshape(nb, B, d), hd[candc]
        es = hd.element_size()
        rows.append(timed_row(
            report, f"ab_block_attention[{name}]", "tools/ab_kernel.py:73",
            "ab_block_attention.cu",
            lambda: ab.ab_block_attention(qb, xg, mbits, div_after, intmask),
            lambda: ab.ab_block_attention_plain(qb, xg, mbits, div_after,
                                                intmask),
            lambda: rc.normalize(F.scaled_dot_product_attention(
                qb, xg, xg, attn_mask=mask, scale=1.0)),
            es * (2 * qb.numel() + xg.numel()) + 4 * mbits.numel(),
            edges * (2 * d + 2 * d + 2), flops, bw,
            errs[(dtype, div_after, intmask)],
            dict(n=n, nb=nb, B=B, C=C, d=d, dtype=str(dtype),
                 edges=edges), cold=True))
        dense_ops = 4 * nb * B * C * d
        report["kernel_detail"][rows[-1]["name"]].update(
            dense_ops=dense_ops, dense_ops_ms=dense_ops / flops * 1e3)

    # kernel #1 alone at the same shapes (the chain's block route)
    qb = h.reshape(nb, B, d)

    def block_chain():
        return fb.fused_block_attention_packed_shared(qb, h, cand, mbits,
                                                      "l2norm", False)
    detail = dict(
        ms=device_ms(block_chain), cold_ms=device_ms_cold(block_chain),
        plain_ms=device_ms(lambda: fb.fused_block_attention_packed_shared_plain(
            qb, h, cand, mbits, "l2norm", False), reps=20),
        bound=bound(*fba.launch(n, d, B, C, edges), flops, bw))
    report["kernel_detail"]["fused_block_attention_packed_shared@chain"] = \
        detail
    print(f"kernel fused_block_attention_packed_shared at the chain's shapes "
          f"(d=64, C=544, l2norm, unshifted): {detail}", flush=True)
    return rows


# ------------------------------------------------------------------ phase 4
def knn_overlap(pos, vel, rebuild_every):
    """bench_extra.mega_crowd's staleness diagnostic: the share of each
    agent's fresh 16-NN, one further chunk on, that a frozen graph keeps."""
    stale = knn_graph_auto(pos, mega_crowd.K_GNN)
    fresh = knn_graph_auto(pos + vel * mega_crowd.DT * rebuild_every,
                           mega_crowd.K_GNN)
    return float((fresh[:, :, None] == stale[:, None, :]).any(-1)
                 .float().mean())


def rollout_turns(cfg, kernel, dev, runs):
    """The rollout ``cfg`` eager (``mega_crowd_rollout(graphed=False)``) and
    graphed (one ``MegaCrowdRollout``, captured first and timed apart, as the
    reference compiles before it times), ``runs`` times each in turns (E G,
    G E, ...). Each eager run zeroes the counts just before it and checks
    them just after: 2 launches of ``kernel`` and one of ORCA's a step, none
    of another. The chunk's graph must hold as many a step of its R, and a
    graphed run must equal the eager one bit for bit.
    Returns the eager run's ((pos, vel), values, coverage), its launches
    and the record of the turns (``walls``: each mode's seconds a run)."""
    layers, R = GCNConfig().num_layer, cfg["rebuild_every"]
    runner = mega_crowd.MegaCrowdRollout(
        **{k: v for k, v in cfg.items() if k not in ("n", "steps")},
        device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner(mega_crowd.initial_crowd(cfg["n"], device=dev), R)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    graph = runner.graph.launches
    want = _want({kernel: layers * R, ORCA_KERNEL: R})
    if graph != want:
        raise RuntimeError(f"the rollout chunk's graph holds {graph}, want "
                           f"{want}")
    walls = {"eager": [], "graphed": []}
    out = {}
    for r in range(runs):
        for mode in ("eager", "graphed")[::1 if r % 2 == 0 else -1]:
            torch.cuda.synchronize()
            captured.reset_launch_counts()
            t0 = time.perf_counter()
            if mode == "eager":
                out[mode] = mega_crowd.mega_crowd_rollout(**cfg, device=dev,
                                                          graphed=False)
            else:
                out[mode] = runner(mega_crowd.initial_crowd(cfg["n"],
                                                            device=dev),
                                   cfg["steps"])
            torch.cuda.synchronize()
            walls[mode].append(time.perf_counter() - t0)
            if mode == "eager":
                launches = captured.launch_counts()
                expect = _want({kernel: layers * cfg["steps"],
                                ORCA_KERNEL: cfg["steps"]})
                if launches != expect:
                    raise RuntimeError(f"kernel launches in the rollout: "
                                       f"{launches}, want {expect}")
    (pos, vel), vals, cov = out["eager"]
    (pos_g, vel_g), vals_g, cov_g = out["graphed"]
    replay_err = 0.0
    for name, got, ref in (("pos", pos_g, pos), ("vel", vel_g, vel),
                           ("values", vals_g, vals), ("coverage", cov_g,
                                                      cov)):
        torch.testing.assert_close(
            got, ref, **REPLAY_TOL,
            msg=lambda m: f"graphed rollout {name} vs eager: {m}")
        replay_err = max(replay_err, float((got - ref).abs().max()))
    turns = dict(walls=walls, capture_s=capture_s, graph_launches=graph,
                 replay_err=replay_err)
    return (pos, vel), vals, cov, launches, turns


def slice_phase(dev, report):
    """The slice's rollout, once eager and once graphed
    (``rollout_turns``), and its checks; its rate is the
    ``crowd10k.block_r8`` cell's."""
    (pos, vel), vals, cov, launches, turns = rollout_turns(
        SLICE, "fused_block_attention_packed_shared", dev, runs=1)
    del turns["walls"]
    if float(cov) != 1.0:
        raise RuntimeError(f"minimum coverage {float(cov)} != 1")
    for name, t in (("pos", pos), ("vel", vel), ("values", vals)):
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"non-finite {name}")
    if vals.shape != (SLICE["steps"],) or pos.shape != (SLICE["n"], 2):
        raise RuntimeError(f"shapes {tuple(vals.shape)}, {tuple(pos.shape)}")
    overlap = knn_overlap(pos, vel, SLICE["rebuild_every"])

    # the block+kernel value net equals the gather backend on one graph
    pos_s, (vel_s,), cols, _, cand, mbits, _ = mega_crowd.rebuild(
        pos, (vel,), SLICE["K"], "block", SLICE["block_B"], SLICE["block_C"],
        True)
    states = torch.cat([pos_s, vel_s, torch.full_like(pos_s[:, :1], 0.3)], -1)
    with torch.no_grad():
        v_block = bs.seeded_value_net("block", dev)(
            states, cols, block_cand=cand, block_emask=mbits)
        v_gather = bs.seeded_value_net("gather", dev)(states, cols)
    torch.testing.assert_close(v_block, v_gather, **TOL)
    net_err = float((v_block - v_gather).abs().max())

    # a small rollout on the card equals the same rollout on the CPU
    small = dict(SLICE, n=1024, steps=4, rebuild_every=2)
    (pc, vc), valc, covc = mega_crowd.mega_crowd_rollout(**small,
                                                         device="cpu")
    (pg, vg), valg, covg = mega_crowd.mega_crowd_rollout(**small, device=dev)
    for name, a, b in (("pos", pg, pc), ("vel", vg, vc),
                       ("values", valg, valc)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4,
                                   msg=lambda m: f"small rollout {name}: {m}")
    small_err = max(float((pg.cpu() - pc).abs().max()),
                    float((vg.cpu() - vc).abs().max()),
                    float((valg.cpu() - valc).abs().max()))

    report["slice"] = dict(
        config=SLICE, **turns, coverage=float(cov), knn_overlap=overlap,
        launches=launches, value_mean_last=float(vals[-1]),
        net_block_vs_gather_err=net_err,
        small_rollout_cuda_vs_cpu_err=small_err)
    print(f"slice: eager and graphed (capture {turns['capture_s']:.3f} s), "
          f"coverage {float(cov)}, knn_overlap "
          f"{overlap:.4f}, launches {launches}, graph launches "
          f"{ {k: v for k, v in turns['graph_launches'].items() if v} }, "
          f"replay vs eager {turns['replay_err']:.3g}, net block vs gather "
          f"{net_err:.3g}, small rollout card vs CPU {small_err:.3g}",
          flush=True)
    return launches


# ------------------------------------------------------------------ phase 5
def chain_phase(dev, report, rounds=5):
    """The relation chain over every route, eager and as captured graphs.
    Each route's counts are zeroed just before its checked eager run and
    read just after."""
    n, K, inner = CHAIN["n"], CHAIN["K"], CHAIN["inner"]
    cols = rc.crowd_graph(n, K, device=dev)
    h0 = {d: rc.seed_features(n, d, device=dev) for d in (64, 32)}
    gather = rc.prepare("gather", cols)
    ref_one = {d: rc.apply(gather, h) for d, h in h0.items()}
    ref_final = {d: rc.run(gather, h, inner) for d, h in h0.items()}
    preps, graphs, result, launches = {}, {}, {}, {}
    for route, d in CHAIN_CASES:
        label = f"{route}@d{d}"
        prep = preps[label] = rc.prepare(route, cols, CHAIN["B"], CHAIN["C"])
        cov = float(prep["coverage"])
        if cov != 1.0:
            raise RuntimeError(f"chain {label}: coverage {cov} != 1")
        one = rc.apply(prep, h0[d])
        torch.testing.assert_close(one, ref_one[d], **TOL,
                                   msg=lambda m: f"chain {label}, one "
                                                 f"application: {m}")
        torch.cuda.synchronize()
        captured.reset_launch_counts()
        h = rc.run(prep, h0[d], inner)
        torch.cuda.synchronize()
        got = captured.launch_counts()
        want = {k: 0 for k in got}
        if route in ROUTE_KERNEL:
            want[ROUTE_KERNEL[route]] = inner
        if got != want:
            raise RuntimeError(f"chain {label}: launches {got}, want {want}")
        launches[label] = got
        if not bool(torch.isfinite(h).all()):
            raise RuntimeError(f"chain {label}: non-finite h")
        final_err = float((h - ref_final[d]).abs().max())
        if final_err > CHAIN_FINAL_TOL:
            raise RuntimeError(f"chain {label}: final h off the gather chain "
                               f"by {final_err} > {CHAIN_FINAL_TOL}")
        # the inner applications captured once (timed apart, as the
        # reference compiles before it times): the graph holds exactly the
        # eager run's launches and replays it bit for bit
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graphs[label] = rc.runner(prep, h0[d], inner)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        if graphs[label].launches != want:
            raise RuntimeError(f"chain {label}: graph launches "
                               f"{graphs[label].launches}, want {want}")
        replayed = graphs[label](h0[d])
        torch.testing.assert_close(
            replayed, h, **REPLAY_TOL,
            msg=lambda m: f"chain {label}, replay vs eager: {m}")
        result[label] = dict(
            coverage=cov, one_step_err=float((one - ref_one[d]).abs().max()),
            final_err=final_err, launches=got, capture_s=capture_s,
            replay_err=float((replayed - h).abs().max()))

    # Gedges/s: interleaved runs (ABC... then ...CBA), graphed and eager in
    # the same turns, medians per route
    labels = [f"{r}@d{d}" for r, d in CHAIN_CASES]
    runs = {label: {"graphed": [], "eager": []} for label in labels}
    for r in range(rounds):
        for label in (labels if r % 2 == 0 else labels[::-1]):
            d = int(label.split("@d")[1])
            modes = (("graphed", CHAIN_GRAPH_REPS), ("eager", 1))
            for mode, reps in modes[::1 if r % 2 == 0 else -1]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    if mode == "graphed":
                        graphs[label](h0[d])
                    else:
                        rc.run(preps[label], h0[d], inner)
                torch.cuda.synchronize()
                runs[label][mode].append(
                    n * K * inner * reps / (time.perf_counter() - t0) / 1e9)
    for label in labels:
        res = result[label]
        res["gedges_per_s"] = statistics.median(runs[label]["graphed"])
        res["gedges_per_s_eager"] = statistics.median(runs[label]["eager"])
        res["gedges_per_s_runs"] = runs[label]["graphed"]
        res["gedges_per_s_eager_runs"] = runs[label]["eager"]
        print(f"chain {label}: {res['gedges_per_s']:.4f} Gedges/s graphed, "
              f"{res['gedges_per_s_eager']:.4f} eager (medians of {rounds}),"
              f" coverage {res['coverage']}, one-step err "
              f"{res['one_step_err']:.3g}, final err {res['final_err']:.3g}, "
              f"replay err {res['replay_err']:.3g}, launches "
              f"{ {k: v for k, v in res['launches'].items() if v} }, capture "
              f"{res['capture_s']:.3f} s", flush=True)
    report["chain"] = dict(config=CHAIN, final_tol=CHAIN_FINAL_TOL,
                           routes=result)
    return launches


# ------------------------------------------------------------------ phase 6
def pallas_phase(dev, report, runs=3):
    """Slice 2's rollout on the per-edge gather kernel, eager and graphed in
    turns (``rollout_turns``) after an eager warm-up, and its checks. The
    host's clock varies from run to run on a shared host, so medians are
    reported."""
    mega_crowd.mega_crowd_rollout(**{**PALLAS, "steps": 8}, device=dev,
                                  graphed=False)
    (pos, vel), vals, cov, launches, turns = rollout_turns(
        PALLAS, "fused_gather_attention", dev, runs)
    walls = turns.pop("walls")
    steps_done = PALLAS["n"] * PALLAS["steps"]
    turns.update(
        agent_steps_per_s=steps_done / statistics.median(walls["graphed"]),
        agent_steps_per_s_eager=steps_done / statistics.median(
            walls["eager"]),
        agent_steps_per_s_runs=[steps_done / w for w in walls["graphed"]],
        agent_steps_per_s_eager_runs=[steps_done / w
                                      for w in walls["eager"]])
    for name, t in (("pos", pos), ("vel", vel), ("values", vals)):
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"pallas rollout: non-finite {name}")
    if vals.shape != (PALLAS["steps"],) or pos.shape != (PALLAS["n"], 2):
        raise RuntimeError(f"shapes {tuple(vals.shape)}, {tuple(pos.shape)}")

    # pallas, block+kernel and gather value nets on one rebuilt graph
    pos_s, (vel_s,), cols, _, cand, mbits, cov_b = mega_crowd.rebuild(
        pos, (vel,), PALLAS["K"], "block", SLICE["block_B"],
        SLICE["block_C"], True)
    if float(cov_b) != 1.0:
        raise RuntimeError(f"block window coverage {float(cov_b)} != 1")
    states = torch.cat([pos_s, vel_s, torch.full_like(pos_s[:, :1], 0.3)], -1)
    with torch.no_grad():
        v_pallas = bs.seeded_value_net("pallas", dev)(states, cols)
        v_block = bs.seeded_value_net("block", dev)(
            states, cols, block_cand=cand, block_emask=mbits)
        v_gather = bs.seeded_value_net("gather", dev)(states, cols)
    torch.testing.assert_close(v_pallas, v_block, **TOL)
    torch.testing.assert_close(v_pallas, v_gather, **TOL)
    errs = dict(pallas_vs_block=float((v_pallas - v_block).abs().max()),
                pallas_vs_gather=float((v_pallas - v_gather).abs().max()))
    report["pallas_rollout"] = dict(
        config=PALLAS, **turns, launches=launches,
        value_mean_last=float(vals[-1]), **errs)
    print(f"pallas rollout: {turns['agent_steps_per_s']:.1f} agent-steps/s "
          f"graphed, {turns['agent_steps_per_s_eager']:.1f} eager, medians "
          f"of {runs} runs in turns (graphed "
          f"{turns['agent_steps_per_s_runs']}, eager "
          f"{turns['agent_steps_per_s_eager_runs']}; capture "
          f"{turns['capture_s']:.3f} s), launches "
          f"{ {k: v for k, v in launches.items() if v} }, graph launches "
          f"{ {k: v for k, v in turns['graph_launches'].items() if v} }, "
          f"replay vs eager {turns['replay_err']:.3g}, nets {errs}",
          flush=True)
    return launches


# ------------------------------------------------------------------ phase 7
def harness_phase(dev, report):
    """The A/B harness at its shapes, each variant's checked chain run and
    its captured graph. ``run`` zeroes the counts before each variant's
    checked chain run and reads #6's and #4's after; the totals over the
    whole run are read here too."""
    inner = HARNESS["inner"]
    torch.cuda.synchronize()
    captured.reset_launch_counts()
    finals = {}
    records = ak.run(**HARNESS, device=dev, finals=finals)
    torch.cuda.synchronize()
    total = captured.launch_counts()
    chunk, recs = records[0], records[1:]
    for rec in records:
        print(json.dumps(rec), flush=True)
    if chunk["chunk_coverage"] != 1.0:
        raise RuntimeError(f"harness: chunk coverage {chunk}")
    # ``run`` last zeroed the counts before chunkfetch_f32's checked run,
    # the last variant's; its graph's two warm-up runs and its capture came
    # after it, and its replay counts nothing
    want_total = {k: 0 for k in total}
    want_total["chunk_block_attention"] = inner * (1 + 2 + 1)
    for rec in recs:
        name = rec["variant"]
        if rec["coverage"] != 1.0:
            raise RuntimeError(f"harness {name}: coverage {rec['coverage']}")
        kernel = ("chunk_block_attention" if name == "chunkfetch_f32"
                  else "ab_block_attention")
        want = {"ab_block_attention": 0, "chunk_block_attention": 0,
                kernel: inner}
        if rec["launches"] != want or rec["graph_launches"] != want:
            raise RuntimeError(f"harness {name}: launches {rec['launches']}"
                               f", graph launches {rec['graph_launches']}, "
                               f"want {want}")
        if rec["replay_err"] > REPLAY_TOL["atol"]:
            raise RuntimeError(f"harness {name}: replay off the eager run by "
                               f"{rec['replay_err']}")
    if total != want_total:
        raise RuntimeError(f"harness: launches over the run {total}, want "
                           f"{want_total}")

    # final h: the gather-window variants and the chunked fetch compute the
    # chain's function at coverage 1; the frozen-table variants are held
    # against the same chain on the plain version
    n = CHAIN["n"]
    cols, cand, _, mbits, h0 = finals["graph"]
    ref = rc.run(rc.prepare("gather", cols), h0, inner)

    def plain_divafter_int(qb, xg, bits):
        return ab.ab_block_attention_plain(qb, xg, bits, True, True)

    refs = {"divafter_intmask_f32_NOGATHER": ak.chain(
                plain_divafter_int, torch.float32, no_gather=True,
                inner=inner)(h0, cand, mbits),
            "divafter_intmask_f32_TAILSIM": ak.chain(
                plain_divafter_int, torch.float32, tail_from=ak.TAIL_FROM,
                inner=inner)(h0, cand, mbits)}
    errs = {}
    for name, h in finals["h"].items():
        if h.shape != (n, 64) or not bool(torch.isfinite(h).all()):
            raise RuntimeError(f"harness {name}: final h {tuple(h.shape)}, "
                               f"finite: {bool(torch.isfinite(h).all())}")
        tol = BF16_CHAIN_TOL if name == "divafter_bf16" else CHAIN_FINAL_TOL
        errs[name] = float((h.float() - refs.get(name, ref)).abs().max())
        if errs[name] > tol:
            raise RuntimeError(f"harness {name}: final h off its reference "
                               f"by {errs[name]} > {tol}")
    bf16_plain = ak.chain(
        lambda qb, xg, bits: ab.ab_block_attention_plain(qb, xg, bits, True),
        torch.bfloat16, inner=inner)(h0.bfloat16(), cand, mbits)
    gap = float((finals["h"]["divafter_bf16"].float()
                 - bf16_plain.float()).abs().max())
    errs["divafter_bf16 vs its plain chain"] = gap
    print(f"harness: final h against the reference chains {errs}", flush=True)
    if gap > BF16_KERNEL_CHAIN_TOL:
        raise RuntimeError(f"harness divafter_bf16: final h off the plain "
                           f"bfloat16 chain by {gap} > {BF16_KERNEL_CHAIN_TOL}")
    report["harness"] = dict(config=HARNESS, records=records,
                             final_errs=errs, final_tol=CHAIN_FINAL_TOL,
                             bf16_final_tol=BF16_CHAIN_TOL,
                             bf16_kernel_chain_tol=BF16_KERNEL_CHAIN_TOL,
                             launches=total)
    return {rec["variant"]: rec["launches"] for rec in recs}


# ------------------------------------------------------------------ phase 8
def eval_setup(model, policy, overrides, dev, results=ROOT / "results"):
    """(config, env, policy, explorer) of ``<results>/<model>`` with the
    CLI's ``overrides`` (``human_num``, the planner's,
    ``orca_time_horizon``), as the port's CLI builds them: a trained policy
    with its weights."""
    over = dict(overrides)
    kwargs = {}
    if "orca_time_horizon" in over:
        kwargs["time_horizon"] = over.pop("orca_time_horizon")
    model_dir = str(results / model)
    config, _ = eval_cli.configure(model_dir, **over)
    trained = eval_cli.policy_factory[policy].trainable
    weights = eval_cli.weights_of(model_dir) if trained else None
    return (config, *eval_cli.build(config, policy, weights, dev, kwargs))


def eval_run(run, model, policy_name, overrides, record, dev, order,
             results=ROOT / "results", per_case=True):
    """One evaluated configuration's 500 cases, eager and graphed in
    ``order``, and its checks against ``<results>/<model>/<record>`` and,
    with ``per_case``, the JAX package's per-case records. Returns its
    report."""
    config, env, policy, explorer = eval_setup(model, policy_name, overrides,
                                               dev, results)
    sim = config.env.sim
    offset, cases = sim.test_seed_offset, range(sim.test_size)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    explorer.capture(explorer.initial_carry(offset, cases))
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    finals, walls = {}, {}
    for mode in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        finals[mode] = explorer.rollout(offset, cases,
                                        graphed=mode == "graphed")
        torch.cuda.synchronize()
        walls[mode] = time.perf_counter() - t0
    eager, graphed = finals["eager"], finals["graphed"]
    for name, got, ref in zip(eager._fields, graphed, eager):
        torch.testing.assert_close(
            got, ref, **REPLAY_TOL,
            msg=lambda m: f"{run}: graphed {name} vs eager: {m}")
    for name in ("robot", "humans", "ep_return", "danger_dmin"):
        if not bool(torch.isfinite(getattr(eager, name)).all()):
            raise RuntimeError(f"{run}: non-finite {name}")
    if eager.robot.shape != (sim.test_size, 9):
        raise RuntimeError(f"{run}: robot states {tuple(eager.robot.shape)}")
    stats = {k: float(v) for k, v in
             zip(explorer.stats(eager)._fields, explorer.stats(eager))}
    committed = json.loads((results / model / record).read_text())
    outcome = eager.case_outcome.cpu().numpy()
    if per_case:
        ref = checkpoints.load_test_reference(run)
        agree = int((outcome == ref["outcome"]).sum())
        both_succeed = (outcome == T.OUTCOME_REACH_GOAL) & (
            ref["outcome"] == T.OUTCOME_REACH_GOAL)
        same_steps = int((eager.step.cpu().numpy()[both_succeed]
                          == ref["steps"][both_succeed]).sum())
    else:  # a run of the port: no JAX records of it
        agree = same_steps = None
        both_succeed = outcome == T.OUTCOME_REACH_GOAL
    delta = dict(success_rate=stats["success_rate"]
                 - committed["success_rate"],
                 collision_rate=stats["collision_rate"]
                 - committed["collision_rate"],
                 nav_time=stats["avg_nav_time"] - committed["nav_time"])
    steps = sim.test_size * config.env.max_steps
    out = dict(
        run=run, model=model, policy=policy_name, overrides=overrides,
        cases=sim.test_size,
        stats=stats, committed={k: committed[k] for k in (
            "success_rate", "collision_rate", "timeout_rate", "nav_time",
            "return", "danger_frequency", "avg_min_dist")},
        delta=delta, outcome_agree=agree,
        successes_both=int(both_succeed.sum()), same_steps=same_steps,
        capture_s=capture_s, wall_s=walls["graphed"],
        wall_s_eager=walls["eager"], order=list(order),
        env_steps_per_s=steps / walls["graphed"],
        env_steps_per_s_eager=steps / walls["eager"])
    planner = policy_name == "model_predictive_rl"
    if planner:
        forwards = policy.rgl_forwards_per_decision()
        out.update(rgl_forwards_per_decision=forwards,
                   rgl_forwards_per_step=forwards * sim.test_size)
    print(f"{'mprl' if planner else 'baseline'} {run}: success "
          f"{stats['success_rate']:.3f} "
          f"[{committed['success_rate']:.3f}], collision "
          f"{stats['collision_rate']:.3f} [{committed['collision_rate']:.3f}]"
          f", timeout {stats['timeout_rate']:.3f} "
          f"[{committed['timeout_rate']:.3f}], nav time "
          f"{stats['avg_nav_time']:.4f} [{committed['nav_time']:.4f}] s, "
          f"return {stats['avg_return']:.4f} [{committed['return']:.4f}], "
          f"danger {stats['danger_frequency']:.4f} "
          f"[{committed['danger_frequency']:.4f}], min dist "
          f"{stats['avg_min_dist']:.4f} [{committed['avg_min_dist']:.4f}]; "
          + (f"outcomes equal to the JAX package's in {agree}/"
             f"{sim.test_size}, same steps in {same_steps}/"
             f"{int(both_succeed.sum())} shared successes; " if per_case
             else "") +
          f"capture {capture_s:.3f} s, graphed "
          f"{walls['graphed']:.3f} s ({out['env_steps_per_s']:.0f} env-steps"
          f"/s), eager {walls['eager']:.3f} s "
          f"({out['env_steps_per_s_eager']:.0f}), "
          + (f"{out['rgl_forwards_per_decision']} RGL forwards a decision, "
             if planner else "") + "graphed == eager",
          flush=True)
    misses = [f"|d {k}| = {abs(v):.4f} > {MPRL_BOUNDS[k]}"
              for k, v in delta.items() if abs(v) > MPRL_BOUNDS[k]]
    if per_case and agree < MPRL_MIN_AGREE:
        misses.append(f"{agree} outcomes equal < {MPRL_MIN_AGREE}")
    if misses:
        raise RuntimeError(f"{run}: {'; '.join(misses)}")
    return out


def diag_check(dev, model="mp_unicycle"):
    """The port's unicycle failure breakdown (``tools/diag_unicycle.py``)
    of ``results/<model>`` over the 500 test cases, graphed and eager (bit
    for bit), held to the committed ``eval_test.json`` with MPRL_BOUNDS and
    to the JAX package's per-case outcomes in MPRL_MIN_AGREE cases; its
    summary printed beside the committed ``diagnosis.json`` -> the report.
    """
    model_dir = ROOT / "results" / model
    config, explorer = diag.setup(str(model_dir), dev)
    cases = config.env.sim.test_size
    recs, walls = {}, {}
    for mode in ("graphed", "eager"):  # the first call captures
        walls[mode] = timed(lambda: recs.update({mode: diag.rollout(
            explorer, cases, graphed=mode == "graphed")}))
    for k, v in recs["eager"].items():
        if not np.array_equal(recs["graphed"][k], v):
            raise RuntimeError(f"diag {model}: graphed {k} != eager")
    rec = recs["graphed"]
    summary, rows = diag.diagnose(rec, config, cases)
    committed = json.loads((model_dir / "diagnosis.json").read_text())
    record = json.loads((model_dir / "eval_test.json").read_text())
    outcome = np.where(rec["dones"][-1], rec["outcome"], T.OUTCOME_TIMEOUT)
    agree = int((outcome == checkpoints.load_test_reference(model)[
        "outcome"]).sum())
    delta = dict(success_rate=summary["success"] / cases
                 - record["success_rate"],
                 collision_rate=summary["collision"] / cases
                 - record["collision_rate"])
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / f"diagnosis_{model}.json").write_text(json.dumps(
        {"summary": summary, "collisions": rows}, indent=1))
    print(f"diag {model}: {json.dumps(summary)}\n  committed "
          f"{json.dumps(committed['summary'])}\n  outcomes equal to the JAX "
          f"package's in {agree}/{cases}; graphed (with its capture) "
          f"{walls['graphed']:.2f} s, eager {walls['eager']:.2f} s, graphed "
          f"== eager", flush=True)
    misses = [f"|d {k}| = {abs(v):.4f} > {MPRL_BOUNDS[k]}"
              for k, v in delta.items() if abs(v) > MPRL_BOUNDS[k]]
    if agree < MPRL_MIN_AGREE:
        misses.append(f"{agree} outcomes equal < {MPRL_MIN_AGREE}")
    if misses:
        raise RuntimeError(f"diag {model}: {'; '.join(misses)}")
    return dict(model=model, summary=summary,
                committed=committed["summary"], outcome_agree=agree,
                delta=delta, wall_s_with_capture=walls["graphed"],
                wall_s_eager=walls["eager"])


def mprl_phase(dev, report):
    """The four evaluated configurations, each eager and graphed in turns
    (E G, G E, ...). Kernel counts are zeroed before the phase and read
    after it: this path launches none of #1-#7, ORCA's kernel and
    MP-RGL's value kernel."""
    precision = dict(
        float32_matmul_precision=torch.get_float32_matmul_precision(),
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    print(f"mprl: {precision}", flush=True)
    if precision != dict(float32_matmul_precision="highest",
                         matmul_allow_tf32=False, cudnn_allow_tf32=False):
        raise RuntimeError(f"float32 products must be exact: {precision}")
    captured.reset_launch_counts()
    runs = []
    with torch.no_grad():
        for i, (run, model, overrides, record) in enumerate(MPRL_RUNS):
            order = ("eager", "graphed")[::1 if i % 2 == 0 else -1]
            runs.append(eval_run(run, model, "model_predictive_rl",
                                 overrides, record, dev, order))
        diagnosis = diag_check(dev)
    launches = _only_orca("the MP-RGL path", plans=True)
    report["mprl"] = dict(precision=precision, runs=runs,
                          diagnosis=diagnosis, launches=launches)
    return launches


# ------------------------------------------------------------------ phase 9
TRAIN_CONFIG = ROOT / "configs" / "icra_benchmark" / "mp_separate.py"
TRAIN = dict(B=16, K=64)


def _state_equal(what, a: dict, b: dict):
    """Two trainer ``state_dict``s equal bit for bit."""
    for part in ("params", "target_params"):
        for k in a[part]:
            torch.testing.assert_close(
                b[part][k], a[part][k], **REPLAY_TOL,
                msg=lambda m: f"{what}: {part}.{k}: {m}")
    for i, (sa, sb) in enumerate(zip(a["optimizer_state"],
                                     b["optimizer_state"])):
        for k in sa:
            torch.testing.assert_close(
                sb[k], sa[k], **REPLAY_TOL,
                msg=lambda m: f"{what}: optimizer state {i}.{k}: {m}")


def sgd_check(art, buffer, gen, tc, label):
    """One and then 8 captured SGD steps against as many eager ones from
    the same state and indices, for SGD (imitation) and Adam (RL) -> the
    rows."""
    trainer = art.trainer
    rows = []
    for name, lr, use_td in (("sgd", tc.il_learning_rate, False),
                             ("adam", tc.rl_learning_rate, True)):
        trainer.set_learning_rate(lr, name)
        row = dict(optimizer=name, use_td=use_td)
        for n in (1, 8):
            idx = rb.sample_indices(buffer, gen, (n, tc.batch_size))
            before = trainer.state_dict()
            trainer.optimize(buffer, idx, use_td, graphed=False)
            eager = trainer.state_dict()
            trainer.load_state(before)
            # n = 1 captures (the warm-up restored), then replays once
            wall = timed(lambda: trainer.optimize(buffer, idx, use_td,
                                                graphed=True))
            row.setdefault("capture_s", wall)
            _state_equal(f"{name}: {n} graphed SGD steps vs eager",
                         eager, trainer.state_dict())
        print(f"{label} sgd[{name}]: graphed == eager over 1 and 8 steps "
              f"(params, target, optimizer state bit for bit); capture "
              f"{row['capture_s']:.3f} s", flush=True)
        rows.append(row)
    return rows


def collect_check(art, gen, offset, policy, label):
    """64 captured collection steps at B=16 against 64 eager ones from the
    same carry and draws (the demonstrator at ε = 0, ``policy`` at
    ε = 0.5), bit for bit: the checked graphed call replays the graph
    that the one before it captured -> the rows."""
    B, K = TRAIN["B"], TRAIN["K"]
    rows = []
    for name, expl, eps in (("orca_demonstrator", art.demonstrator_explorer,
                             0.0), (policy, art.explorer, 0.5)):
        carry = expl.init_carry(B, offset)
        draws = art.explorer.draws(gen, K, B)
        expl.collect(carry, K, offset, eps, draws, graphed=True)
        out = {mode: expl.collect(carry, K, offset, eps, draws,
                                  graphed=mode == "graphed")
               for mode in ("eager", "graphed")}
        for part, got, want in (("carry", out["graphed"][0], out["eager"][0]),
                                ("trajectory", out["graphed"][1],
                                 out["eager"][1])):
            for field, g, w in zip(want._fields, got, want):
                torch.testing.assert_close(
                    g, w, **REPLAY_TOL,
                    msg=lambda m: f"{name}: graphed {part}.{field}: {m}")
        traj = out["eager"][1]
        episodes = int(traj.terminal.sum())
        explored = int((draws[1] < eps).sum())
        row = dict(policy=name, epsilon=eps, B=B, steps=K,
                   episodes=episodes, explored_decisions=explored)
        print(f"{label} collect[{name}, eps {eps}]: {K} graphed steps == "
              f"eager, bit for bit ({episodes} episodes ended, "
              f"{explored} exploring decisions)", flush=True)
        rows.append(row)
    return rows


def debug_train(dev, mode, config_path, policy, label):
    """``train_loop.train`` of ``policy`` on the config at ``config_path``
    in its debug shrink, in a fresh directory, and its checks."""
    config = load_config_module(str(config_path))
    out_dir = OUT_DIR / f"{label}_debug_{mode}"
    if out_dir.exists():
        shutil.rmtree(out_dir)
    art = train_loop.build(config, policy, 0, dev)
    init = art.policy.init_params(torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in init.networks.state_dict().items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = train_loop.train(
        config, policy, str(out_dir), debug=True, seed=0,
        opts=train_loop.LoopOptions(graphed=mode == "graphed"), device=dev,
        art=art)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    misses = []
    if result["demo_success"] < 0.7:
        misses.append(f"demonstrator success {result['demo_success']}")
    losses = {k: result[k] for k in ("il_value_loss", "il_sp_loss",
                                     "value_loss", "sp_loss")}
    if not all(map(math.isfinite, losses.values())):
        misses.append(f"losses {losses}")
    live = art.trainer.state_dict()
    moved = sum(int(not torch.equal(live["params"][k], v))
                for k, v in init.items())
    if moved != len(init):
        misses.append(f"{len(init) - moved} parameter tensors never moved")
    for f in ("il_model", "rl_model", "rl_model_best"):
        if not ckpt.exists(str(out_dir / f)):
            misses.append(f"no checkpoint {f}")
    if not (out_dir / "metrics.jsonl").is_file():
        misses.append("no metrics.jsonl")
    saved = ckpt.load(str(out_dir / "rl_model"), map_location=dev)
    try:
        _state_equal("rl_model vs the live state", live, saved)
    except AssertionError as e:
        misses.append(str(e))
    if misses:
        raise RuntimeError(f"{label} debug train ({mode}): "
                           f"{'; '.join(misses)}")
    row = dict(mode=mode, wall_s=wall, result=result,
               params_moved=f"{moved}/{len(init)}",
               metrics_lines=len((out_dir / "metrics.jsonl").read_text()
                                 .splitlines()))
    print(f"{label} debug run ({mode}): {wall:.1f} s (IL "
          f"{result['il_wall_s']:.1f} s, RL {result['rl_wall_s']:.1f} s: "
          f"collection {result['rl_collect_s']:.1f}, SGD "
          f"{result['rl_sgd_s']:.1f}, validation {result['rl_val_s']:.1f}; "
          f"{result['il_sgd_steps']} + {result['rl_sgd_steps']} SGD steps); "
          f"demonstrator success {result['demo_success']:.3f}, IL val "
          f"success {result['il_val_success']:.3f}, final val success "
          f"{result['success_rate']:.3f} over {result['episodes']} RL "
          f"episodes; losses {losses}; all {moved} parameter tensors moved; "
          f"checkpoints and metrics.jsonl written, rl_model == live state",
          flush=True)
    shutil.rmtree(out_dir)
    return row


def train_checks(dev, config_path, policy, label, eager_debug=True) -> dict:
    """Phase 9's checks of ``policy``'s training on the config at
    ``config_path``: captured SGD steps and collection against eager, and
    the debug run graphed and (``eager_debug``) eager -> their report."""
    out = {}
    config = load_config_module(str(config_path))
    art = train_loop.build(config, policy, 0, dev)
    art.policy.init_params(torch.Generator().manual_seed(0))
    art.trainer.update_target()
    gen = torch.Generator(device=dev).manual_seed(0)
    offset = config.env.sim.train_seed_offset
    buffer = rb.create(20_000, config.env.sim.human_num, device=dev)
    carry = art.demonstrator_explorer.init_carry(TRAIN["B"], offset)
    for _ in range(2):  # demonstrations to sample minibatches from
        carry, traj = art.demonstrator_explorer.collect(
            carry, TRAIN["K"], offset)
        art.demonstrator_explorer.update_memory(buffer, traj, None, True)
    out["sgd"] = sgd_check(art, buffer, gen, config.train, label)
    out["collect"] = collect_check(
        art, gen, offset, {"model_predictive_rl": "mprl"}.get(policy, policy),
        label)
    runs = [debug_train(dev, mode, config_path, policy, label)
            for mode in ("graphed", "eager")[:1 + eager_debug]]
    out["debug_runs"] = runs
    if eager_debug:
        same = runs[0]["result"]["success_rate"] == runs[1]["result"][
            "success_rate"] and runs[0]["result"]["value_loss"] == runs[1][
            "result"]["value_loss"]
        out["debug_graphed_equals_eager"] = same
        print(f"{label} debug runs: graphed {runs[0]['wall_s']:.1f} s, "
              f"eager {runs[1]['wall_s']:.1f} s; same final val success "
              f"and loss: {same}", flush=True)
    return out


def train_phase(dev, report):
    """Slice 8's checks and rows. Kernel counts are zeroed before the phase
    and read after it: training launches none of #1-#7, ORCA's kernel
    and MP-RGL's value kernel (collection's planner)."""
    captured.reset_launch_counts()
    report["train"] = train_checks(dev, TRAIN_CONFIG, "model_predictive_rl",
                                   "train")
    launches = _only_orca("the training path", plans=True)
    report["train"]["launches"] = launches


def query_env_check(dev):
    """``sarl`` with the env-queried lookahead over the 500 test cases,
    graphed and eager, held to each other bit for bit -> its report."""
    config, env, policy, explorer = eval_setup("sarl", "sarl", {}, dev)
    policy.query_env = True
    sim = config.env.sim
    offset, cases = sim.test_seed_offset, range(sim.test_size)
    walls, finals = {}, {}
    for mode in ("graphed", "eager"):  # the first call captures
        walls[mode] = timed(lambda: finals.update({mode: explorer.rollout(
            offset, cases, graphed=mode == "graphed")}))
    for name, got, ref in zip(finals["eager"]._fields, finals["graphed"],
                              finals["eager"]):
        torch.testing.assert_close(
            got, ref, **REPLAY_TOL,
            msg=lambda m: f"sarl query_env: graphed {name} vs eager: {m}")
    stats = {k: float(v) for k, v in zip(
        explorer.stats(finals["eager"])._fields,
        explorer.stats(finals["eager"]))}
    print(f"baseline sarl query_env: success {stats['success_rate']:.3f}, "
          f"collision {stats['collision_rate']:.3f}, nav time "
          f"{stats['avg_nav_time']:.4f} s; graphed (with its capture) "
          f"{walls['graphed']:.3f} s, eager {walls['eager']:.3f} s; graphed "
          f"== eager", flush=True)
    return dict(stats=stats, wall_s_with_capture=walls["graphed"],
                wall_s_eager=walls["eager"])


def resume_check(dev, card):
    """Stage 1's exported state (``checkpoints/mp_unicycle_state.npz``)
    written as the port's ``rl_model`` and resumed under stage 2's config
    (``train_loop.resume_rl``): the config's optimizer and rate with the
    checkpoint's moments and step; one captured RL step (TD targets, a
    minibatch of stage 2's demonstrations) equal to its eager step bit for
    bit, and within RESUME_TOL of the same step on the CPU -> the report."""
    config = load_config_module(str(RESUME["config"]))
    tc = config.train
    path = str(OUT_DIR / "resume" / "rl_model")
    checkpoints.write_rl_model(RESUME["model"], path, device=dev)
    art = train_loop.build(config, "model_predictive_rl", 0, dev)
    train_loop.resume_rl(art.trainer, path, tc)
    trainer = art.trainer
    group = trainer.optimizer.param_groups[0]
    step_t = trainer.optimizer.state[trainer.params[0]]["step"]
    misses = []
    if (trainer.optimizer_name, trainer.learning_rate, group["lr"]) != (
            tc.optimizer, tc.rl_learning_rate, tc.rl_learning_rate):
        misses.append(f"{trainer.optimizer_name} at {group['lr']}, the "
                      f"config's {tc.optimizer} at {tc.rl_learning_rate}")
    if train_loop.optimizer_step(trainer) != RESUME["step"]:
        misses.append(f"step {train_loop.optimizer_step(trainer)}")
    if not (group["capturable"] and step_t.is_cuda):
        misses.append("Adam is not capturable on the card")
    gen = torch.Generator(device=dev).manual_seed(0)
    offset = config.env.sim.train_seed_offset
    buffer = rb.create(20_000, config.env.sim.human_num, device=dev)
    carry = art.demonstrator_explorer.init_carry(TRAIN["B"], offset)
    for _ in range(2):
        carry, traj = art.demonstrator_explorer.collect(
            carry, TRAIN["K"], offset)
        art.demonstrator_explorer.update_memory(buffer, traj, None, True)
    idx = rb.sample_indices(buffer, gen, (1, tc.batch_size))
    before = trainer.state_dict()
    trainer.optimize(buffer, idx, use_td=True, graphed=False)
    eager = trainer.state_dict()
    trainer.load_state(before)
    trainer.optimize(buffer, idx, use_td=True, graphed=True)
    _state_equal("resumed Adam step: graphed vs eager", eager,
                 trainer.state_dict())
    cpu = train_loop.build(config, "model_predictive_rl", 0, "cpu")
    train_loop.resume_rl(cpu.trainer, path, tc)
    cpu.trainer.optimize(
        rb.ReplayBuffer(rb.Transition(*(t.cpu() for t in buffer.data)),
                        buffer.ptr, buffer.size),
        idx.cpu(), use_td=True, graphed=False)
    want = cpu.trainer.state_dict()
    err = {}
    for part in ("params", "exp_avg", "exp_avg_sq"):
        pairs = ([(eager["params"][k], want["params"][k])
                  for k in want["params"]] if part == "params" else
                 [(g[part], w[part]) for g, w in zip(
                     eager["optimizer_state"], want["optimizer_state"])])
        err[part] = max(float((g.cpu() - w).abs().max()) for g, w in pairs)
        for g, w in pairs:
            if not torch.allclose(g.cpu(), w, **RESUME_TOL):
                misses.append(f"{part}: card vs CPU beyond {RESUME_TOL}")
                break
    steps = [float(s["step"]) for s in (eager["optimizer_state"][0],
                                        want["optimizer_state"][0])]
    if steps != [RESUME["step"] + 1] * 2:
        misses.append(f"steps after one step {steps}")
    if misses:
        raise RuntimeError(f"resume check: {'; '.join(misses)}")
    shutil.rmtree(OUT_DIR / "resume")
    print(f"resume: {RESUME['model']}'s exported state under "
          f"{RESUME['config'].name}: {tc.optimizer} at rate {group['lr']:g}, "
          f"step {RESUME['step']} -> {int(steps[0])}; one captured RL step "
          f"== its eager step bit for bit; card vs CPU max |d| params "
          f"{err['params']:.3g}, exp_avg {err['exp_avg']:.3g}, exp_avg_sq "
          f"{err['exp_avg_sq']:.3g} (within rtol {RESUME_TOL['rtol']}, atol "
          f"{RESUME_TOL['atol']}); {card}", flush=True)
    return dict(optimizer=tc.optimizer, rate=group["lr"],
                step_before=RESUME["step"], step_after=int(steps[0]),
                max_abs_err_vs_cpu=err, graphed_equals_eager=True)


def baselines_phase(dev, report):
    """Slices 9, 12 and 14: the seven evaluated baseline rows, the five the
    port trained from scratch and slice 14's four MP-RGL runs, each eager
    and graphed in turns, the env-queried lookahead, the resume check, and
    the value-only training of every learned baseline. Kernel counts are zeroed before the phase and read after it:
    this path launches none of #1-#7, and ORCA's kernel."""
    t0 = time.perf_counter()
    captured.reset_launch_counts()
    runs, port_runs = [], []
    with torch.no_grad():
        for i, (run, model, policy, overrides, record) in enumerate(
                BASELINE_RUNS):
            order = ("eager", "graphed")[::1 if i % 2 == 0 else -1]
            runs.append(eval_run(run, model, policy, overrides, record, dev,
                                 order))
        learned = dict(BASELINE_TRAIN)
        for i, (_, model, policy, overrides, _) in enumerate(
                r for r in BASELINE_RUNS if r[1] in learned):
            order = ("eager", "graphed")[::1 if i % 2 == 0 else -1]
            port_runs.append(eval_run(
                f"{model}_s0", f"{model}_s0", policy, overrides,
                "eval_test.json", dev, order, results=PORT_RESULTS,
                per_case=False))
        query_env = query_env_check(dev)
        card = tbe.device_name(dev)
        for i, run in enumerate(PORT_MPRL_RUNS):
            order = ("eager", "graphed")[::1 if i % 2 == 0 else -1]
            port_runs.append(eval_run(
                run, run, "model_predictive_rl", {}, "eval_test.json", dev,
                order, results=PORT_RESULTS, per_case=False))
            delta = port_runs[-1]["delta"]
            print(f"slice 14 {run}: held to its eval_test.json (d success "
                  f"{delta['success_rate']:+.4f}, d collision "
                  f"{delta['collision_rate']:+.4f}, d nav time "
                  f"{delta['nav_time']:+.4f} s); {card}", flush=True)
    resume = resume_check(dev, card)
    train = {model: train_checks(dev, ROOT / "results" / model / "config.py",
                                 policy, model, eager_debug=model == "sarl")
             for model, policy in BASELINE_TRAIN}
    launches = _only_orca("the baselines' path")
    seconds = time.perf_counter() - t0
    report["baselines"] = dict(runs=runs, port_trained=port_runs,
                               query_env=query_env, resume=resume,
                               train=train, launches=launches,
                               seconds=seconds)
    print(f"phase 10: {seconds:.1f} s", flush=True)


# ----------------------------------------------------------------- phase 11
# bench_scaling.py's protocol: its rows (partition_row, mega_row) and their
# sizes (PARTITION, MEGA) live in the port's tools/bench_scaling.py.
PARTITION, MEGA = bs.PARTITION, bs.MEGA
# the JAX package's tests/test_partitioned_build.py case
MEGA_SMALL = dict(n=600, steps=8, R=2, spec=dict(
    D=4, n_cap=256, x0=-24.0, band_w=12.0, y0=-24.0, cell=3.0, grid_w=64,
    B=64, C=256, K=8, K_orca=6, mig_cap=32))
MEGA_ATOL = bs.MEGA_ATOL


def kernel_2_on_halo(model, dev, flops, bw, report, D=4):
    """#2 on its path: ``block_halo_attention`` with a separate 32-wide
    value table at the D=4 block-halo row's shapes, unit-normal features.
    Then #1 and #2 on one rank's kernel inputs (rank 1's, as the path
    builds them): each held against its plain version, then timed."""
    cfg = PARTITION
    states, _, cand, mbits, halo = bs.partition_inputs(D, "block_halo",
                                                       dev)
    n, d = states.shape[0], GCNConfig().X_dim
    g = torch.Generator().manual_seed(7)
    q, x = (unit_rows(torch.randn(n, d, generator=g)).to(dev)
            for _ in range(2))
    v = torch.randn(n, 32, generator=g).to(dev)
    mesh = make_mesh(data=D, device=dev)
    captured.reset_launch_counts()
    got = mesh.run(lambda comm, *a: gp.block_halo_attention(comm, *a, halo),
                   row_sharded=(q, x, v, cand, mbits))
    torch.cuda.synchronize()
    launches = captured.launch_counts()
    if (launches["fused_block_attention_packed"] != D
            or launches["fused_block_attention_packed_shared"] != 0):
        raise RuntimeError(f"kernel #2 on the halo path: launches {launches}")
    B = cfg["B"]
    plain = fb.fused_block_attention_packed_plain(
        q.reshape(-1, B, d), x, v, cand, mbits).reshape(n, -1)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
    err = float((got - plain).abs().max())

    # rank 1's kernel inputs: the exchanged tables, local ids, masked words
    parts = [split_rows(t, D) for t in (q, x, v, cand, mbits)]
    qb, x_ext, v_ext, ids, bits = run_local(
        D, lambda comm: gp.halo_kernel_args(
            comm, *(p[comm.rank] for p in parts), halo), device=dev)[1]
    nb_loc = qb.shape[0]
    mask = fb.unpack_emask(bits, B)
    edges = int(mask.sum())
    xg, vg = x_ext[ids], v_ext[ids]
    timing = {}
    for name, dv, fn, plain_fn, lib in (
        ("fused_block_attention_packed_shared", d,
         lambda: fb.fused_block_attention_packed_shared(qb, x_ext, ids,
                                                        bits),
         lambda: fb.fused_block_attention_packed_shared_plain(
             qb, x_ext, ids, bits),
         lambda: F.scaled_dot_product_attention(qb, xg, xg, attn_mask=mask,
                                                scale=1.0)),
        ("fused_block_attention_packed", 32,
         lambda: fb.fused_block_attention_packed(qb, x_ext, v_ext, ids, bits),
         lambda: fb.fused_block_attention_packed_plain(qb, x_ext, v_ext, ids,
                                                       bits),
         lambda: F.scaled_dot_product_attention(qb, xg, vg, attn_mask=mask,
                                                scale=1.0)),
    ):
        out, want = fn(), plain_fn()
        torch.testing.assert_close(
            out, want, **TOL,
            msg=lambda m: f"{name} at the halo's shapes (rank 1): {m}")
        shared = name.endswith("shared")
        tables = (x_ext.numel() + (0 if shared else v_ext.numel())) * 4
        nbytes = (qb.numel() * 4 + tables + ids.numel() * 8
                  + bits.numel() * 4 + qb.shape[0] * B * dv * 4)
        bound_ms, bound_by = bound(nbytes, edges * (2 * d + 2 * dv + 2),
                                   flops, bw)
        try:
            library_ms = device_ms(lib)
        except RuntimeError as e:  # a yardstick only: note why it is absent
            library_ms = None
            report["notes"].append(f"{name} at the halo's shapes: library "
                                   f"call failed: {e}")
        timing[name] = dict(
            max_abs_err=float((out - want).abs().max()), ms=device_ms(fn),
            plain_ms=device_ms(plain_fn, reps=20),
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
            shapes=dict(nb=nb_loc, B=B, C=ids.shape[1], d=d, dv=dv,
                        table=x_ext.shape[0]), edges=edges)
    return dict(D=D, halo=halo, launches=launches, max_abs_err=err,
                timing=timing)


def mega_small_check(dev):
    """The JAX package's 600-agent D=4 case against the one-device loop,
    on the card, at the reference's limits."""
    c = MEGA_SMALL
    g = torch.Generator().manual_seed(0)
    n = c["n"]
    pos = (torch.rand(n, 2, generator=g) * 47.0 - 23.5).to(dev)
    agents = (pos, torch.zeros_like(pos), -pos,
              torch.full((n,), 0.3, device=dev), torch.ones(n, device=dev))
    spec = pb.BandSpec(**c["spec"])
    net = bs.seeded_value_net("block", dev)
    sh, diag = pb.partitioned_mega_rollout(
        make_mesh(data=spec.D, device=dev), spec, net, ORCAParams(),
        c["steps"], c["R"])(pb.init_crowd_shards(
            *(a.cpu() for a in agents), spec, device=dev))
    one = bs.seeded_value_net("gather", dev)
    rpos, rvel, rvmean = pb.single_device_rollout(
        one, *agents, ORCAParams(), c["steps"], c["R"], spec.K, spec.K_orca)
    order = sh.aid[sh.active].argsort()
    got_pos, got_vel = sh.pos[sh.active][order], sh.vel[sh.active][order]
    diag = {k: float(v) for k, v in diag.items()}
    out = dict(diag, max_dpos=float((got_pos - rpos).abs().max()),
               max_dvel=float((got_vel - rvel).abs().max()),
               dvmean=abs(diag["vmean"] - float(rvmean)),
               kept=int(sh.active.sum()))
    if (out["band_cov"] != 1.0 or out["win_cov"] != 1.0 or out["kept"] != n
            or out["max_dpos"] > MEGA_ATOL or out["max_dvel"] > MEGA_ATOL
            or out["dvmean"] > MEGA_ATOL):
        raise RuntimeError(f"600-agent D=4 rollout off the one-device loop: "
                           f"{out}")
    return out


def gloo_check(model, dev, D=2):
    """The D=2 block forward as two ``torch.distributed`` processes (gloo,
    through host memory) sharing the card, against the same ranks as
    threads: the same kernels on the same rows, so bit for bit."""
    states, _, cand, mbits, halo = bs.partition_inputs(D, "block_halo",
                                                       dev)
    threads = gp.partitioned_block_rgl(model, states, cand, mbits,
                                       make_mesh(data=D, device=dev), halo)
    t = time.perf_counter()
    procs = distributed.launch(
        gp.block_rgl_rank, D, replicated=(model, halo),
        row_sharded=(states, cand, mbits), device=str(dev), timeout=240.0)
    seconds = time.perf_counter() - t
    torch.testing.assert_close(procs, threads.cpu(), rtol=0, atol=0)
    return dict(D=D, backend="gloo", seconds=seconds,
                max_abs_err=float((procs - threads.cpu()).abs().max()))


def partition_phase(dev, flops, bw, report):
    """Slice 10: the node-partitioned paths on D ranks (threads on the
    card). Returns the launches of #1 and #2 on the halo paths."""
    t0 = time.perf_counter()
    model = bs.seeded_value_net("gather", dev).graph_model
    rows = []
    with torch.no_grad():
        for method in ("ring", "allgather", "block_halo"):
            for D in PARTITION["ranks"]:
                row = bs.partition_row(method, D, model, dev)
                rows.append(row)
                print(f"partitioned {method} D={D}: capture "
                      f"{row['capture_s']:.2f} s, graph == eager, max |err| "
                      f"{row['max_abs_err']:.3g} ({row['err_over_limit']:.3g}"
                      f" of the limit), halo {row['halo']}", flush=True)
        k2 = kernel_2_on_halo(model, dev, flops, bw, report)
        print(f"kernel #2 on the halo path (D=4): launches "
              f"{k2['launches']['fused_block_attention_packed']}, max |err| "
              f"{k2['max_abs_err']:.3g}; "
              + "; ".join(f"{k}: {v['ms']:.4f} ms (plain {v['plain_ms']:.4f}"
                          f", library {v['library_ms']}, bound "
                          f"{v['bound_ms']:.5f})"
                          for k, v in k2["timing"].items()), flush=True)
        net = bs.seeded_value_net("block", dev)
        mega = []
        for D in MEGA["ranks"]:
            row = bs.mega_row(D, net, dev)
            mega.append(row)
            print(f"partitioned mega D={D}: capture "
                  f"{row['capture_s']:.2f} s, graph == eager, band_cov "
                  f"{row['band_cov']}, win_cov {row['win_cov']}, overflow "
                  f"{row['overflow']:.0f}, lost {row['lost']:.0f}, max "
                  f"|dpos| {row['max_dpos']:.3g} "
                  f"({row['agents_dpos_over_1e4']} agents > 1e-4), |dvmean| {row['dvmean']:.3g}, max "
                  f"|dvalue| card vs CPU {row['max_dvalue']:.3g}",
                  flush=True)
        small = mega_small_check(dev)
        print(f"600 agents, D=4, against one device: {small}", flush=True)
        gloo = gloo_check(model, dev)
        print(f"D=2 as two gloo processes == threads, bit for bit "
              f"({gloo['seconds']:.1f} s)", flush=True)
    seconds = time.perf_counter() - t0
    report["partition"] = dict(rows=rows, kernel_2=k2, mega=mega,
                               mega_small=small, gloo=gloo, seconds=seconds)
    print(f"phase 11: {seconds:.1f} s", flush=True)
    halo1 = {f"block_halo@D={r['D']}":
             r["launches"]["fused_block_attention_packed_shared"]
             for r in rows if r["method"] == "block_halo"}
    halo1.update({f"mega@D={r['D']}":
                  r["launches"]["fused_block_attention_packed_shared"]
                  for r in mega})
    return dict(halo1=halo1, k2=k2)


# ----------------------------------------------------------------- phase 12
# The first stage of the reference's multi-device dry run (__graft_entry__
# .py:44-98: collect, push, sample, one dp/tp step) at the meshes it picks
# for 2, 4 and 8 devices, at the full width of mp_separate (its 16 train
# envs and minibatch of 100), 2 collection steps.
DP = dict(meshes=((2, 1), (2, 2), (4, 2)), B=16, K=2, eps=0.1)
DP_LOSS_REL, DP_PARAM_ATOL = 1e-4, 1e-4     # tests/test_parallel.py:142-147
# cli.train --multihost against --mesh_data 2 at toy counts (a config file
# in the repository's form; the port's loader reads it as its own)
DP_TOY = """
from relationalgraphlearning_tpu.configs.base import (
    Config, MPRLConfig, PolicyConfig, TrainConfig)


def get_config() -> Config:
    return Config(
        policy=PolicyConfig(mprl=MPRLConfig(planning_depth=2,
                                            planning_width=2)),
        train=TrainConfig(il_episodes=4, il_epochs=1, train_batches=5,
                          checkpoint_interval=4, capacity=2000))
"""
DP_TOY_FLAGS = ["--rl_train_episodes", "6", "--evaluation_interval", "3",
                "--target_update_interval", "3", "--val_size", "4",
                "--train_envs", "4", "--collect_steps", "16"]


def dp_fresh(config, state, dev, optimizer=None, lr=None):
    """The artifacts of ``config`` with the trainer's ``state``, and a
    fresh optimizer of ``optimizer`` at ``lr`` when given."""
    art = train_loop.build(config, "model_predictive_rl", 0, dev)
    art.trainer.load_state(state)
    if optimizer is not None:
        art.trainer.set_learning_rate(lr, optimizer)
    return art


def dp_ranks_agree(par, what):
    """Every rank of an axis holds the same bits (parameters and optimizer
    state), and the shards of data rank 0 are the trainer's whole state."""
    names = sharding._sharded_names(par.base.net, par.model)
    ranks = par.ranks
    for i, n in enumerate(ranks[0].names):
        for r, rt in enumerate(ranks):
            ref = ranks[r % par.model] if n in names else ranks[0]
            ok = torch.equal(rt.params[i], ref.params[i]) and all(
                torch.equal(t, ref.optimizer.state[ref.params[i]][k])
                for k, t in rt.optimizer.state[rt.params[i]].items())
            if not ok:
                raise RuntimeError(f"{what}: rank {r} differs on {n}")
        whole = (torch.cat([ranks[m].params[i] for m in range(par.model)])
                 if n in names else ranks[0].params[i])
        if not torch.equal(whole, par.base.params[i]):
            raise RuntimeError(f"{what}: the gathered {n} differs")


def dp_mesh_row(config, state, carry, draws, want, buffer, idx, one, D, M,
                dev):
    """One mesh: the split collection against one device's, one SGD step
    (the imitation optimizer) against one device's, graphed == eager for
    SGD and Adam, the ranks identical."""
    tc, sim = config.train, config.env.sim
    mesh = make_mesh(D, M, device=dev)
    label = f"dp/tp ({D}, {M})"
    art = dp_fresh(config, state, dev)
    collect = sharding.make_parallel_collect(art.explorer, mesh, DP["K"],
                                             sim.train_seed_offset)
    res = {}
    collect_s = timed(lambda: res.update(out=collect(
        carry, DP["eps"], draws, graphed=True)))
    _, traj = res["out"]
    for name, g, w in zip(want._fields, traj, want):
        if not torch.equal(g, w):
            raise RuntimeError(f"{label}: the split collection's {name} "
                               f"differs from one device's in "
                               f"{int((g != w).sum())} entries")
    row = dict(data=D, model=M, collect_capture_s=collect_s)
    for name, lr, use_td in (("sgd", tc.il_learning_rate, False),
                             ("adam", tc.rl_learning_rate, True)):
        runs = {}
        for mode in ("eager", "graphed"):
            par = sharding.ParallelTrainer(
                dp_fresh(config, state, dev, name, lr).trainer, mesh)
            aux = {}
            wall = timed(lambda: aux.update(a=par.optimize(
                buffer, idx, use_td, graphed=mode == "graphed")))
            runs[mode] = (par, aux["a"], wall)
        par, aux, capture_s = runs["graphed"]
        _state_equal(f"{label} {name}: graphed step vs eager",
                     runs["eager"][0].state_dict(), par.state_dict())
        dp_ranks_agree(par, f"{label} {name}")
        sub = dict(capture_s=capture_s, value_loss=float(aux.value_loss))
        if name == "sgd":
            one_state, one_aux = one
            rel = abs(float(aux.value_loss) - float(one_aux.value_loss)) \
                / abs(float(one_aux.value_loss))
            err = max(float((par.state_dict()["params"][k] - v).abs().max())
                      for k, v in one_state["params"].items())
            if rel > DP_LOSS_REL or err > DP_PARAM_ATOL:
                raise RuntimeError(f"{label}: the step against one device: "
                                   f"value loss rel {rel}, params {err}")
            sub.update(value_loss_rel_vs_one=rel, max_param_err_vs_one=err)
        row[name] = sub
    print(f"{label}: split collection == one device (B={DP['B']}, "
          f"{DP['K']} steps); SGD step vs one device: value loss rel "
          f"{row['sgd']['value_loss_rel_vs_one']:.2e}, params "
          f"{row['sgd']['max_param_err_vs_one']:.2e}; graphed == eager for "
          f"SGD and Adam, ranks identical (Adam's capture "
          f"{row['adam']['capture_s']:.2f} s)", flush=True)
    return row


def dp_cli_checks(dev):
    """``cli.train --debug --mesh_data 2 --mesh_model 2`` at mp_separate to
    its end, and ``--multihost`` as two gloo processes against
    ``--mesh_data 2`` as threads at toy counts, bit for bit."""
    from relationalgraphlearning_tpu_torch.cli import train as train_cli

    work = OUT_DIR / "phase12"
    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    t = time.perf_counter()
    result = train_cli.main(["--config", str(TRAIN_CONFIG), "--debug",
                             "--mesh_data", "2", "--mesh_model", "2",
                             "--output_dir", str(work / "mesh_debug")])
    debug_s = time.perf_counter() - t
    losses = [result[k] for k in ("il_value_loss", "value_loss", "sp_loss")]
    if (result["episodes"] < 40 or not all(map(math.isfinite, losses))
            or not ckpt.exists(str(work / "mesh_debug" / "rl_model"))):
        raise RuntimeError(f"cli.train --debug on a (2, 2) mesh: {result}")
    print(f"cli.train --debug --mesh_data 2 --mesh_model 2: {debug_s:.1f} s"
          f", {result['episodes']} RL episodes, final val success "
          f"{result['success_rate']:.3f}, losses {losses}", flush=True)

    cfg = work / "toy_config.py"
    cfg.write_text(DP_TOY)
    t = time.perf_counter()
    train_cli.main(["--config", str(cfg), "--output_dir",
                    str(work / "threads"), *DP_TOY_FLAGS, "--mesh_data", "2"])
    threads_s = time.perf_counter() - t
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, NPROC="2",
               JAX_COORDINATOR=f"localhost:{port}")
    t = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "relationalgraphlearning_tpu_torch.cli.train",
         "--config", str(cfg), "--output_dir", str(work / "procs"),
         *DP_TOY_FLAGS, "--multihost"], cwd=ROOT,
        env=dict(env, PROC_ID=str(i)), stdin=subprocess.DEVNULL,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    procs_s = time.perf_counter() - t
    (work / "procs.log").write_text("\n".join(logs))
    if [p.returncode for p in procs] != [0, 0]:
        raise RuntimeError(f"cli.train --multihost: exit codes "
                           f"{[p.returncode for p in procs]}:\n"
                           f"{logs[0][-3000:]}\n{logs[1][-3000:]}")
    _state_equal("cli.train --multihost (2 gloo processes) vs --mesh_data 2",
                 ckpt.load(str(work / "threads" / "rl_model")),
                 ckpt.load(str(work / "procs" / "rl_model")))
    print(f"cli.train --multihost as 2 gloo processes == --mesh_data 2 as "
          f"threads, rl_model bit for bit ({procs_s:.1f} s against "
          f"{threads_s:.1f} s)", flush=True)
    shutil.rmtree(work / "mesh_debug")
    return dict(debug_mesh_s=debug_s, debug_result=result,
                toy_threads_s=threads_s, toy_procs_s=procs_s)


def native_orca_check(dev):
    """``NativeORCA`` (the C++ solver through the host) against
    ``envs/orca.py`` on the card, on the humans of 64 test cases: the
    reference's tolerance for the two implementations; and equal to the
    host call on the same arrays."""
    from relationalgraphlearning_tpu_torch.envs.crowd_sim import CrowdSim
    from relationalgraphlearning_tpu_torch.envs.orca import (
        centralized_orca_step)
    from relationalgraphlearning_tpu_torch.runtime import native_orca

    if not native_orca.native_orca_available():
        raise RuntimeError("native ORCA: the C++ build failed")
    config = load_config_module(str(TRAIN_CONFIG))
    env = CrowdSim(config.env, device=dev)
    state, _ = env.reset(range(64), config.env.sim.test_seed_offset)
    h = state.humans
    pos, vel, rad = h[..., :2], h[..., 2:4], h[..., T.RADIUS]
    to = h[..., T.GX:T.GY + 1] - pos
    pref = to / torch.clamp(torch.linalg.norm(to, dim=-1, keepdim=True),
                            min=1e-9) * h[..., T.VPREF:T.VPREF + 1]
    vmax = h[..., T.VPREF]
    active = torch.ones_like(vmax, dtype=torch.bool)
    t = time.perf_counter()
    got = native_orca.NativeORCA()(pos, vel, rad, pref, vmax, active)
    native_s = time.perf_counter() - t
    want = centralized_orca_step(pos, vel, rad, pref, vmax, active,
                                 ORCAParams())
    host = native_orca.orca_step_batch_native(
        *(a.cpu().numpy() for a in (pos, vel, rad, pref, vmax)),
        active.cpu().numpy())
    diff = (got - want).abs()
    out = dict(cases=64, humans=int(h.shape[1]), device=str(got.device),
               median_abs_diff=float(diff.median()),
               max_abs_diff=float(diff.max()), seconds=native_s,
               equals_host_call=bool(torch.equal(got.cpu(),
                                                 torch.from_numpy(host))))
    if (got.device != pos.device or not out["equals_host_call"]
            or out["median_abs_diff"] >= 1e-3 or out["max_abs_diff"] >= 5e-2):
        raise RuntimeError(f"native ORCA against envs/orca.py: {out}")
    print(f"NativeORCA on the card's states (64 cases): median |diff| "
          f"{out['median_abs_diff']:.2e}, max {out['max_abs_diff']:.2e} "
          f"against envs/orca.py; == the host call", flush=True)
    return out


def render_check(dev):
    """One ``mprl_td`` test case rolled on the card and drawn to a GIF."""
    from relationalgraphlearning_tpu_torch.utils import render

    config, env, policy, _ = eval_setup("mprl_td", "model_predictive_rl",
                                        {}, dev)
    t = time.perf_counter()
    traj = render.rollout_trajectory(env, policy,
                                     config.env.sim.test_seed_offset, 0)
    path = OUT_DIR / "mprl_td_case0.gif"
    render.render_video(traj, str(path))
    out = dict(outcome=traj.outcome_name, steps=traj.steps,
               attention_rows=len(traj.attention), gif=str(path.name),
               gif_bytes=path.stat().st_size,
               seconds=time.perf_counter() - t)
    if out["gif_bytes"] == 0 or path.read_bytes()[:3] != b"GIF":
        raise RuntimeError(f"render: {out}")
    print(f"render: mprl_td test case 0 ({out['outcome']}, {out['steps']} "
          f"steps) -> {path.name}, {out['gif_bytes']} bytes", flush=True)
    return out


def dp_phase(dev, report):
    """Slice 11: the data- and tensor-parallel path (``parallel/sharding
    .py``) at mp_separate's width on three meshes, the train CLI over a
    mesh and as processes, native ORCA and the renderer. Kernel counts are
    zeroed before the phase and read after it: none of #1-#7 runs, and
    ORCA's kernel does."""
    t0 = time.perf_counter()
    captured.reset_launch_counts()
    config = load_config_module(str(TRAIN_CONFIG))
    tc, sim = config.train, config.env.sim
    art = train_loop.build(config, "model_predictive_rl", 0, dev)
    art.policy.init_params(torch.Generator().manual_seed(0))
    art.trainer.update_target()
    state = art.trainer.state_dict()
    gen = torch.Generator(device=dev).manual_seed(0)
    offset = sim.train_seed_offset
    carry = art.explorer.init_carry(DP["B"], offset)
    draws = art.explorer.draws(gen, DP["K"], DP["B"])
    _, want = art.explorer.collect(carry, DP["K"], offset, DP["eps"], draws,
                                   graphed=True)
    buffer = rb.create(64, sim.human_num, device=dev)
    art.explorer.update_memory(buffer, want, art.trainer.target.value, False)
    idx = rb.sample_indices(buffer, gen, (1, tc.batch_size))
    one = dp_fresh(config, state, dev, "sgd", tc.il_learning_rate).trainer
    one_aux = one.optimize(buffer, idx, False, graphed=False)
    rows = [dp_mesh_row(config, state, carry, draws, want, buffer, idx,
                        (one.state_dict(), one_aux), D, M, dev)
            for D, M in DP["meshes"]]
    cli = dp_cli_checks(dev)
    orca = native_orca_check(dev)
    gif = render_check(dev)
    launches = _only_orca("the dp/tp path")
    seconds = time.perf_counter() - t0
    report["dp"] = dict(rows=rows, cli=cli, native_orca=orca, render=gif,
                        launches=launches, seconds=seconds,
                        parameters=sum(p.numel() for p in art.trainer.params),
                        note="data x model ranks as threads on one card")
    print(f"phase 12: {seconds:.1f} s", flush=True)


# ----------------------------------------------------------------- phase 13
# Kernels #1/#2 in bfloat16 at bench_roofline.py's chain shapes (n=8192,
# K=16, d=64, B=256, C=640) and at the JAX test's set-up
# (tests/test_pallas_block.py:65-76: n=1024, K=8, B=128, C=384, d=32,
# dv=48): two bfloat16 ulps of the output. Both sides read the same
# bfloat16 features and round e and the output to nearest even from float32
# sums taken in other orders, so e and then the output may each land one ulp
# apart (the plain version against the JAX kernel on the CPU: at most one).
BF16_KERNEL_TOL = dict(rtol=2**-7, atol=2**-7)
BF16_SHAPES = (("roofline", dict(n=8192, K=16, B=256, C=640, d=64, dv=64,
                                 side=100.0)),
               ("jax_test", dict(n=1024, K=8, B=128, C=384, d=32, dv=48,
                                 side=30.0)))
# The FMA chain from x = 1: in both versions every step adds exactly one
# float32 ulp of 1 (1.0000001 is 1 + 2^-23 in float32, and neither the
# product's excess nor 1e-9 reaches half an ulp), so the same bits.
FMA = dict(n=1 << 20, fmas=128, passes=64)
FMA_TOL = dict(rtol=0, atol=0)
# The four tools' mains at the reference's sizes. Fewer trials where the
# protocol allows it: bench.py's collector 2 graphed trials (its 5) and 1
# eager trial; bench_scaling's 1 timed replay a row (its 3). bench_extra
# and bench_roofline keep theirs.
BENCH_ARGS = ["--trials", "2", "--eager_trials", "1"]
SCALING_ARGS = ["--reps", "1"]


def bf16_window(cfg, dev, seed=11):
    """The shape's sorted kNN graph, its window and packed mask, and
    unit-normal features (and unit rows for the unshifted softmax) in
    bfloat16."""
    cols = rc.crowd_graph(cfg["n"], cfg["K"], side=cfg["side"], seed=seed,
                          device=dev)
    cand, cov = bg.block_window(cols, cfg["B"], cfg["C"])
    if float(cov) != 1.0:
        raise RuntimeError(f"bf16 window coverage {float(cov)} != 1 ({cfg})")
    mbits = fb.pack_emask(bg.block_masks(cols, cand))
    g = torch.Generator().manual_seed(seed + 1)
    n, d, dv = cfg["n"], cfg["d"], cfg["dv"]
    q, x = (torch.randn(n, d, generator=g) for _ in range(2))
    v = torch.randn(n, dv, generator=g)
    bf = torch.bfloat16
    feats = {True: tuple(t.to(dev, bf) for t in (q, x, v)),
             False: tuple(t.to(dev, bf) for t in (unit_rows(q), unit_rows(x),
                                                  v))}
    return cand, mbits, feats


def bf16_kernel_phase(dev, flops, bw, report):
    """#1/#2 in bfloat16 against their plain versions on the card, stable
    and unshifted, every epilogue, rows with no edge; then timed at the
    roofline's shapes as phase 3 times the float32 rows."""
    errs = {"shared": [], "separate": []}
    for label, cfg in BF16_SHAPES:
        cand, mbits, feats = bf16_window(cfg, dev)
        B, d = cfg["B"], cfg["d"]
        no_edge = mbits.clone()
        no_edge[0, 0, :] &= ~0x1F                 # rows 0-4 of block 0
        for stable in (True, False):
            q, x, v = feats[stable]
            qb = q.reshape(-1, B, d)
            for epi in ("none", "l2norm", "relu"):
                for kind, fn, plain, args in (
                    ("shared", fb.fused_block_attention_packed_shared,
                     fb.fused_block_attention_packed_shared_plain,
                     (qb, x, cand)),
                    ("separate", fb.fused_block_attention_packed,
                     fb.fused_block_attention_packed_plain,
                     (qb, x, v, cand))):
                    for m, case in ((mbits, ""), (no_edge, ", no-edge rows")):
                        if m is no_edge and epi != "none":
                            continue
                        got = fn(*args, m, epilogue=epi, stable=stable)
                        want = plain(*args, m, epilogue=epi, stable=stable)
                        torch.cuda.synchronize()
                        what = (f"bf16 {kind} {label} stable={stable} "
                                f"{epi}{case}")
                        if got.dtype != torch.bfloat16:
                            raise RuntimeError(f"{what}: out is {got.dtype}")
                        torch.testing.assert_close(
                            got, want, **BF16_KERNEL_TOL,
                            msg=lambda msg: f"{what}: {msg}")
                        if case and not (got[0, :5] == 0).all():
                            raise RuntimeError(f"{what}: not exactly 0")
                        err = float((got.float() - want.float()).abs().max())
                        errs[kind].append(err)
                        report["cases"].append(dict(
                            kernel=f"{kind}[bf16]", case=f"{label}{case}",
                            epilogue=epi, stable=stable, max_abs_err=err))
    print(f"kernels #1/#2 bf16 == plain within 2^-7 over "
          f"{len(errs['shared'])} + {len(errs['separate'])} cases (max |err|"
          f" {max(errs['shared']):.3g}, {max(errs['separate']):.3g})",
          flush=True)

    # timed at the roofline's shapes, stable softmax (as the bench row)
    cfg = BF16_SHAPES[0][1]
    cand, mbits, feats = bf16_window(cfg, dev)
    q, x, v = feats[True]
    n, B, C, d, dv = cfg["n"], cfg["B"], cfg["C"], cfg["d"], cfg["dv"]
    qb = q.reshape(-1, B, d)
    nb = qb.shape[0]
    mask = fb.unpack_emask(mbits, B)
    edges = int(mask.sum())
    xg, vg = x[cand.clamp(0, n - 1)], v[cand.clamp(0, n - 1)]
    rows = []
    for kind, name, replaces, run, plain, lib in (
        ("shared", "fused_block_attention_packed_shared[bf16]",
         "relationalgraphlearning_tpu/ops/pallas_block.py:192",
         lambda: fb.fused_block_attention_packed_shared(qb, x, cand, mbits),
         lambda: fb.fused_block_attention_packed_shared_plain(
             qb, x, cand, mbits),
         lambda: F.scaled_dot_product_attention(qb, xg, xg, attn_mask=mask,
                                                scale=1.0)),
        ("separate", "fused_block_attention_packed[bf16]",
         "relationalgraphlearning_tpu/ops/pallas_block.py:235",
         lambda: fb.fused_block_attention_packed(qb, x, v, cand, mbits),
         lambda: fb.fused_block_attention_packed_plain(qb, x, v, cand,
                                                       mbits),
         lambda: F.scaled_dot_product_attention(qb, xg, vg, attn_mask=mask,
                                                scale=1.0)),
    ):
        tables = n * d * 2 + (0 if kind == "shared" else n * dv * 2)
        nbytes = (qb.numel() * 2 + tables + cand.numel() * 8
                  + mbits.numel() * 4 + nb * B * dv * 2)
        # float32 arithmetic on the CUDA cores: the float32 peak
        ops = edges * (2 * d + 2 * dv + 2)
        row = timed_row(report, name, replaces,
                        "fused_block_attention.cu", run, plain, lib, nbytes,
                        ops, flops, bw, errs[kind],
                        dict(nb=nb, B=B, C=C, d=d, dv=dv, n=n,
                             dtype="bfloat16"), cold=True)
        # the float32 kernel on the same graph and rows, for comparison
        f32 = [t.float() for t in (qb, x, v)]
        f32_run = ((lambda: fb.fused_block_attention_packed_shared(
            f32[0], f32[1], cand, mbits)) if kind == "shared" else
            (lambda: fb.fused_block_attention_packed(*f32, cand, mbits)))
        report["kernel_detail"][name].update(
            edges=edges, f32_ms=device_ms(f32_run),
            f32_cold_ms=device_ms_cold(f32_run))
        print(f"  the same in float32: "
              f"{report['kernel_detail'][name]['f32_ms']:.4f} ms, cold L2 "
              f"{report['kernel_detail'][name]['f32_cold_ms']:.4f} ms",
              flush=True)
        rows.append(row)

    # the FMA kernel of bench_roofline's vpu_peak against its plain version
    xf = torch.ones(FMA["n"], device=dev)
    fma = lambda: roofline.fma_chain(xf, FMA["fmas"], FMA["passes"])  # noqa
    fma_plain = lambda: roofline.fma_chain_plain(  # noqa: E731
        xf, FMA["fmas"], FMA["passes"])
    got, want = fma(), fma_plain()
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **FMA_TOL,
                               msg=lambda m: f"fma_chain vs plain: {m}")
    flops_done = 2 * FMA["fmas"] * FMA["passes"] * FMA["n"]
    ms = device_ms(fma, reps=20)
    plain_ms = device_ms(fma_plain, reps=2)
    bound_ms, bound_by = bound(8 * FMA["n"], flops_done, flops, bw)
    report["kernel_detail"]["fma_chain"] = dict(
        shapes=FMA, bytes=8 * FMA["n"], ops=flops_done, cases=1,
        tflops=flops_done / ms / 1e9)
    rows.append(dict(
        name="fma_chain", route="cuda",
        source="relationalgraphlearning_tpu_torch/csrc/roofline.cu",
        replaces="bench_roofline.py:65 (vpu_peak: XLA fusion, no "
                 "pl.pallas_call)",
        launches=0, max_abs_err=float((got - want).abs().max()), ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None))
    print(f"kernel fma_chain: {ms:.4f} ms ({flops_done / ms / 1e9:.2f} "
          f"TFLOP/s; plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms by "
          f"{bound_by}), == plain bit for bit", flush=True)
    return rows


# ORCA's kernel at the crowd's shapes (the crowd cell's kNN step)
ORCA = dict(n=10240, K=10)
ORCA_KERNEL = "orca_velocity"
# float32 operations of one ORCA line (its costliest branch, the leg):
# a lower bound on what a solve does, which depends on the data
ORCA_LINE_OPS = 47


def orca_inputs(dev, n, M, spread, seed):
    """n agents each against M random neighbours, `spread` m apart at
    most: a small spread piles them up, so that linearProgram3 decides."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape, lo=-1.0, hi=1.0):
        return (torch.rand(shape, generator=g) * (hi - lo) + lo).to(dev)
    return (u(n, 2, lo=-spread, hi=spread), u(n, 2),
            torch.full((n,), 0.3, device=dev), u(n, 2),
            torch.ones(n, device=dev), u(n, M, 2, lo=-spread, hi=spread),
            u(n, M, 2), torch.full((n, M), 0.3, device=dev),
            u(n, M) > -0.7)


def orca_crowd(dev, seed=0):
    """The crowd's kNN ORCA step as the rollout runs it: positions at the
    reference's density, the grid kNN, every 97th agent inactive."""
    n, K = ORCA["n"], ORCA["K"]
    g = torch.Generator().manual_seed(seed)
    pos = mega_crowd.initial_crowd(n, seed=seed, device=dev)
    vel = (torch.rand(n, 2, generator=g) - 0.5).to(dev)
    pref = (torch.rand(n, 2, generator=g) * 2 - 1).to(dev)
    rad, vmax = torch.full((n,), 0.3, device=dev), torch.ones(n, device=dev)
    act = torch.ones(n, dtype=torch.bool, device=dev)
    act[::97] = False
    cols = knn_graph_auto(pos, K, valid=act)
    return pos, vel, rad, pref, vmax, act, cols


def orca_phase(dev, flops, bw, report):
    """ORCA's velocity kernel against its plain version, bit for bit, its
    launches a step, and its time beside its bound and the eager chain."""
    params = ORCAParams()
    pos, vel, rad, pref, vmax, act, cols = orca_crowd(dev)
    me = torch.arange(ORCA["n"], device=dev)[:, None]
    crowd = (pos, vel, rad, pref, vmax, pos[cols], vel[cols], rad[cols],
             act[cols] & (cols != me))
    cases = [("crowd n=10240 K=10", crowd)]
    for B, n in ((500, 5), (500, 6)):
        g = torch.Generator().manual_seed(n)
        p = (torch.rand(B, n, 2, generator=g) * 8 - 4).to(dev)
        v = (torch.rand(B, n, 2, generator=g) * 2 - 1).to(dev)
        r = torch.full((B, n), 0.3, device=dev)
        valid = (torch.ones(B, 1, n, dtype=torch.bool, device=dev)
                 & ~torch.eye(n, dtype=torch.bool, device=dev))
        cases.append((f"dense B={B} n={n}", (
            p, v, r, (torch.rand(B, n, 2, generator=g) * 2 - 1).to(dev),
            torch.ones(B, n, device=dev), p[:, None].expand(B, n, n, 2),
            v[:, None].expand(B, n, n, 2), r[:, None].expand(B, n, n),
            valid)))
    for M, spread, seed in ((10, 1.0, 1), (10, 0.5, 2), (64, 2.0, 3)):
        cases.append((f"M={M} spread={spread}",
                      orca_inputs(dev, 2048, M, spread, seed)))
    lp3 = {}
    for label, args in cases:
        profiling.reset()
        got = orca_env.orca_velocity(*args, params)
        want = orca_env.orca_velocity_plain(*args, params)
        torch.cuda.synchronize()
        counted = profiling.snapshot()["counters"]
        lp3[label] = (counted["orca.lp3_agents"], args[0].shape[:-1].numel())
        if not torch.equal(got, want):
            bad = int((got != want).any(-1).sum())
            raise RuntimeError(f"orca_velocity vs plain, {label}: {bad} "
                               f"agents differ, max |diff| "
                               f"{float((got - want).abs().max()):.3g}")
    print(f"kernel orca_velocity == plain bit for bit over {len(cases)} "
          f"cases (agents through linearProgram3, of those solved: "
          f"{lp3})", flush=True)
    profiling.reset()

    # launches: one a crowd step (the kNN step) and one an env step (B=500)
    captured.reset_launch_counts()
    orca_env.centralized_orca_step_knn(pos, vel, rad, pref, vmax, act,
                                       params, ORCA["K"], cols=cols)
    crowd_launches = captured.launch_counts()[ORCA_KERNEL]
    config = load_config_module(str(TRAIN_CONFIG))
    env = CrowdSim(config.env, device=dev)
    state, _ = env.reset(range(500), config.env.sim.test_seed_offset)
    captured.reset_launch_counts()
    env.step(state, torch.zeros(500, 2, device=dev))
    env_launches = captured.launch_counts()[ORCA_KERNEL]
    torch.cuda.synchronize()
    if crowd_launches != 1 or env_launches != 1:
        raise RuntimeError(f"orca_velocity launches: {crowd_launches} a "
                           f"crowd step, {env_launches} an env step; want 1")

    run = lambda: orca_env.orca_velocity(*crowd, params)  # noqa: E731
    plain = lambda: orca_env.orca_velocity_plain(*crowd, params)  # noqa
    step = lambda: orca_env.centralized_orca_step_knn(  # noqa: E731
        pos, vel, rad, pref, vmax, act, params, ORCA["K"], cols=cols)
    ms, cold_ms = device_ms(run), device_ms_cold(run)
    plain_ms = device_ms(plain, reps=20)
    step_ms = device_ms(step)
    with_kernel = orca_env.orca_velocity    # the step's dispatch
    orca_env.orca_velocity = orca_env.orca_velocity_plain
    try:
        step_plain_ms = device_ms(step, reps=20)
    finally:
        orca_env.orca_velocity = with_kernel
    n, K = ORCA["n"], ORCA["K"]
    # each input read once (float32; valid one byte), the output written
    nbytes = n * 4 * (2 + 2 + 1 + 2 + 1) + n * K * (4 * 5 + 1) + n * 8
    ops = ORCA_LINE_OPS * n * K
    bound_ms, bound_by = bound(nbytes, ops, flops, bw)
    report["kernel_detail"]["orca_velocity"] = dict(
        shapes=ORCA, bytes=nbytes, ops=ops, cases=len(cases), lp3=lp3,
        step_ms=step_ms, step_plain_ms=step_plain_ms,
        env_step_launches=env_launches)
    print(f"kernel orca_velocity: {ms:.4f} ms, cold L2 {cold_ms:.4f} ms "
          f"(plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms by "
          f"{bound_by}); the kNN step with it {step_ms:.4f} ms, with the "
          f"plain version {step_plain_ms:.4f} ms; 1 launch a crowd step "
          f"and an env step", flush=True)
    return [dict(
        name="orca_velocity", route="cuda",
        source="relationalgraphlearning_tpu_torch/csrc/orca_velocity.cu",
        replaces="envs/orca.py:orca_velocity (XLA fusion, no "
                 "pl.pallas_call)",
        launches=crowd_launches, max_abs_err=0.0, ms=ms,
        cold_ms=cold_ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None)]


RGL_VALUE = "rgl_value"
RGL_VALUE_RUN = "mprl_td"   # the committed weights and config it runs


def rgl_value_flops(n: int, groups: int, humans: int) -> int:
    """Float32 operations (two an FMA) the value kernel does for ``n``
    forwards whose humans come in ``groups`` groups: each group's humans
    once (w_h, their rows of X·Wa and X·W1, their scores), then each
    forward's robot part (w_r, its rows of X·Wa and X·W1, its relation
    row and column, layer 1's rows, layer 2's row 0, the value network)."""
    N = humans
    group = N * (5 * 64 + 64 * 32 + 2 * 32 * 32) + N * N * 32
    forward = (9 * 64 + 64 * 32 + 2 * 32 * 32 + 32 * (2 * N + 1)
               + 32 * (N + 1) + 32 * 32 + 32 + N * 32 * (N + 3)
               + 32 * 32 + 32 * 32 + 32 * 100 + 100 * 100 + 100)
    return 2 * (groups * group + n * forward)


def rgl_value_phase(dev, flops, bw, report):
    """MP-RGL's value kernel against ``MPRLNetworks.value`` (its plain
    version) on the committed weights and states of the evaluation at
    B=500 (the four calls of a d=2 decision) and at B=1 (a decision's root
    clip); timed warm and with a cold L2 beside its operation bound and the
    plain version; its launches in one captured evaluation step."""
    config = load_config_module(
        str(ROOT / "results" / RGL_VALUE_RUN / "config.py"))
    env = CrowdSim(config.env, device=dev)
    policy = make_policy("model_predictive_rl", config.policy, config.env,
                         device=dev)
    policy.load_flax(checkpoints.load_flax_tree(RGL_VALUE_RUN))
    ex = Explorer(env, policy, config.policy.gamma)
    offset = config.env.sim.test_seed_offset
    carry = ex.initial_carry(offset, range(500))
    calls = {}
    with torch.no_grad():
        for _ in range(5):  # states a few decisions into the cases
            carry = type(carry)(*ex.eval_step(*carry))
        robot = carry.states.robot
        humans = T.observable(carry.states.humans)
        for B in (500, 1):
            r0, h0 = robot[:B], humans[:B]
            acts, _, nr, nh = policy._clip_actions(r0, h0, policy.width)
            views = {"root clip": policy._expand(
                r0, h0, policy._all_actions(r0))[1:]}
            if B > 1:
                views["nodes"] = (nr, nh)
                views["inner clip"] = policy._expand(
                    nr, nh, policy._all_actions(nr))[1:]
                views["leaves"] = policy._clip_actions(
                    nr, nh, policy.width)[2:]
            for view, (r, h) in views.items():
                got = policy.value(r, h)
                want = policy.networks.value(r, h)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                scale = float(want.abs().max())
                if not torch.allclose(got, want, **TOL):
                    raise RuntimeError(f"rgl_value vs plain, {view} B={B}: "
                                       f"max |diff| {err:.3g}")
                k = r.dim() - 1
                p = rgv.plan(r.shape[:-1], r.stride()[:k], h.stride()[:k],
                             h.shape[-2])
                run = lambda: policy.value(r, h)  # noqa: E731
                plain = lambda: policy.networks.value(r, h)  # noqa: E731
                ops = rgl_value_flops(p.n, p.groups, h.shape[-2])
                bound_ms, bound_by = bound(
                    4 * (r.numel() + p.groups * h.shape[-2] * 5 + p.n), ops,
                    flops, bw)
                calls[f"{view} B={B}"] = dict(
                    forwards=p.n, group=p.group_size, tiles=p.tiles,
                    ms=device_ms(run), cold_ms=device_ms_cold(run),
                    plain_ms=device_ms(plain, reps=20), bound_ms=bound_ms,
                    bound_by=bound_by, ops=ops, max_abs_err=err,
                    max_abs_value=scale)
    # one captured evaluation step: the value kernel four times
    with torch.no_grad():
        graph = ex.capture(ex.initial_carry(offset, range(16)))
    _expect("the MP-RGL evaluation step graph", graph.launches,
            _want({ORCA_KERNEL: 1, RGL_VALUE: 4}))
    step = [c for name, c in calls.items() if name.endswith("B=500")]
    total = {key: sum(c[key] for c in step)
             for key in ("ms", "cold_ms", "plain_ms", "bound_ms", "ops")}
    report["kernel_detail"][RGL_VALUE] = dict(
        run=RGL_VALUE_RUN, calls=calls, step=total,
        step_launches=graph.launches[RGL_VALUE])
    for name, c in calls.items():
        print(f"kernel rgl_value {name}: {c['forwards']} forwards (groups of "
              f"{c['group']}, {c['tiles']} tiles) {c['ms']:.4f} ms, cold L2 "
              f"{c['cold_ms']:.4f} ms (plain {c['plain_ms']:.4f} ms, bound "
              f"{c['bound_ms']:.5f} ms by {c['bound_by']}), max |diff| "
              f"{c['max_abs_err']:.3g} of |V| <= {c['max_abs_value']:.3g}",
              flush=True)
    print(f"kernel rgl_value: an evaluation step's four calls (B=500) "
          f"{total['ms']:.4f} ms, cold L2 {total['cold_ms']:.4f} ms (plain "
          f"{total['plain_ms']:.4f} ms, bound {total['bound_ms']:.5f} ms); "
          f"{graph.launches[RGL_VALUE]} launches a captured step", flush=True)
    return [dict(
        name=RGL_VALUE, route="cuda",
        source="relationalgraphlearning_tpu_torch/csrc/rgl_value.cu",
        replaces="none: models/rgl.py + mprl_networks.py value forward "
                 "(XLA fusion in the JAX package, no pl.pallas_call)",
        launches=graph.launches[RGL_VALUE],
        max_abs_err=max(c["max_abs_err"] for c in calls.values()),
        ms=total["ms"], cold_ms=total["cold_ms"], plain_ms=total["plain_ms"],
        bound_ms=total["bound_ms"], bound_by="operations", library_ms=None,
        b1=calls["root clip B=1"])]


def collector_check(dev, B=1024, steps=16):
    """bench.py's collection (the linear robot among ORCA humans) graphed
    against eager from the same carry, bit for bit, as phase 9 holds its
    collections; ORCA's kernel runs there once a step, in the eager loop
    and in the captured step, and no other kernel does."""
    cfg = EnvConfig(human_policy="orca")
    ex = Explorer(CrowdSim(cfg, device=dev),
                  make_policy("linear", PolicyConfig(), cfg, device=dev), 0.9)
    carry = ex.init_carry(B, 0)
    captured.reset_launch_counts()
    out = {"eager": ex.collect(carry, steps, 0, graphed=False)}
    torch.cuda.synchronize()
    _expect("bench.py's eager collection", captured.launch_counts(),
            _want({ORCA_KERNEL: steps}))
    out["graphed"] = ex.collect(carry, steps, 0, graphed=True)
    torch.cuda.synchronize()
    _expect("bench.py's collection step graph",
            ex.collect_graph(B, steps, 0).launches, _want({ORCA_KERNEL: 1}))
    for part, got, want in (("carry", out["graphed"][0], out["eager"][0]),
                            ("trajectory", out["graphed"][1],
                             out["eager"][1])):
        for field, g, w in zip(want._fields, got, want):
            torch.testing.assert_close(
                g, w, **REPLAY_TOL,
                msg=lambda m: f"bench collection: graphed {part}.{field}: "
                              f"{m}")
    return dict(B=B, steps=steps, episodes=int(out["eager"][1].terminal
                                               .sum()))


def _want(counts=None):
    """Every kernel's launches: ``counts``'s, none of another."""
    want = {k: 0 for k in captured.launch_counts()}
    want.update(counts or {})
    return want


def _only_orca(what, plans=False):
    """The launches since the counts were zeroed: ORCA's kernel (the env's
    step), MP-RGL's value kernel (the planner's; required where ``plans``)
    and none of #1-#7."""
    launches = captured.launch_counts()
    if not launches[ORCA_KERNEL] or (plans and not launches[RGL_VALUE]) or any(
            v for k, v in launches.items()
            if k not in (ORCA_KERNEL, RGL_VALUE)):
        raise RuntimeError(f"{what}: launches {launches}, want ORCA's kernel"
                           f"{' and' if plans else ','} MP-RGL's value "
                           f"kernel{'' if plans else ' at most'} alone")
    return launches


def _expect(what, got, want):
    if got != want:
        raise RuntimeError(f"{what}: launches {got}, want {want}")


def bench_phase(dev, report):
    """The four tools' mains at the reference's sizes, each on the card
    through its own entry point, their launches checked exactly: ORCA's
    kernel once an env step and a crowd step. Returns the launches on the
    tools' paths."""
    t0 = time.perf_counter()
    shared = "fused_block_attention_packed_shared"
    col = collector_check(dev)
    print(f"bench collection: {col['steps']} graphed steps == eager at "
          f"B={col['B']}, bit for bit ({col['episodes']} episodes ended), "
          f"{ORCA_KERNEL} once a step", flush=True)
    walls = {}

    def tool(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t
        print(f"{name}: {walls[name]:.1f} s", flush=True)
        return out

    head = tool("bench", tb.main, BENCH_ARGS)
    _expect("bench.py's collection", head["collector"]["launches"],
            _want({ORCA_KERNEL: head["line"]["horizon"]}))
    # the planners' collections: the defaults' 32 steps, one env step and
    # one d=2 decision (four value launches) each
    planning = dict(collect=_want({ORCA_KERNEL: 32, RGL_VALUE: 4 * 32}),
                    decision=_want({RGL_VALUE: 4}))
    for part, got in head["planning"]["launches"].items():
        _expect(f"planning {part}", got, planning[part])
    extra = tool("bench_extra", tbe.main, [])
    by_metric = {line["metric"]: rec for line, rec in extra if rec}
    for part, got in by_metric[
            "planning decisions/s (d=2 MP-RGL in env)"]["launches"].items():
        _expect(f"bench_extra planning {part}", got, planning[part])
    _expect("bench_extra fused-block chain", by_metric[
        "relation edges/s (block path, fused pallas kernel)"]["launches"],
        _want({shared: 100}))
    big = by_metric["100k-agent crowd (block+pallas, rebuild every 8)"]
    _expect("100k R=8 rollout", big["launches"],
            _want({shared: 64, ORCA_KERNEL: 32}))
    if big["coverage"] != 1.0:
        raise RuntimeError(f"100k R=8 rollout coverage {big['coverage']}")
    res, roof = tool("bench_roofline", tbr.main,
                     ["--out", str(OUT_DIR / "ROOFLINE.json")])
    for tag in ("f32", "bf16"):
        _expect(f"roofline fused block {tag}",
                roof[f"block_pallas_{tag}"]["launches"], _want({shared: 100}))
    _expect("roofline vpu_peak", roof["vpu_launches"], {"fma_chain": 16})
    scaling = tool("bench_scaling", bs.main, SCALING_ARGS)
    mega = tool("bench_scaling --mega", bs.main, SCALING_ARGS + ["--mega"])
    for line, rec in scaling:
        want = _want({shared: rec["D"] * 2 * 8
                      if rec["method"] == "block_halo" else 0})
        _expect(line["metric"], rec["launches"], want)
    for line, rec in mega:
        _expect(line["metric"], rec["launches"],
                _want({shared: rec["D"] * 2 * 16, ORCA_KERNEL: rec["D"] * 16}))
    seconds = time.perf_counter() - t0
    report["bench"] = dict(
        seconds=seconds, walls=walls, collector_check=col, bench=dict(
            line=head["line"], eager=head["eager"],
            trials=head["collector"]["trials"],
            table_capacity=head["collector"]["table_capacity"]),
        bench_extra=[line for line, _ in extra],
        extra_detail={line["metric"]: {k: v for k, v in rec.items()
                                       if k not in ("final",)}
                      for line, rec in extra if rec},
        roofline=res, roofline_detail=roof,
        scaling=[line for line, _ in scaling + mega],
        args=dict(bench=BENCH_ARGS, scaling=SCALING_ARGS))
    print(f"phase 13: {seconds:.1f} s", flush=True)
    return dict(bf16_shared=roof["block_pallas_bf16"]["launches"][shared],
                fma=roof["vpu_launches"]["fma_chain"],
                orca=big["launches"][ORCA_KERNEL])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = tbe.device_name("cuda")
    name = torch.cuda.get_device_name(0)
    flops, bw = peaks(name)
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {name}",
          flush=True)
    report = dict(card=card, device=name, peaks=dict(f32_flops=flops,
                                                      bytes_per_s=bw),
                  cases=[], notes=[], kernel_detail={})

    t = time.perf_counter()
    logs = _build.build_all([_build.CSRC / src for src in SOURCES])
    report["build"] = dict(seconds=time.perf_counter() - t, nvcc=logs)
    print(f"built {', '.join(SOURCES)} in {report['build']['seconds']:.1f} s "
          "(one nvcc each, in parallel)", flush=True)
    for src, log in logs.items():
        regs = sorted({line.split(":", 1)[1].strip() for line in
                       log.splitlines() if "registers" in line})
        spills = sorted({line.strip() for line in log.splitlines()
                         if "spill" in line})
        print(f"  ptxas {src}: {regs}; {spills}", flush=True)

    kernels = kernel_phase(dev, flops, bw, report)
    kernels += kernel_phase_2(dev, flops, bw, report)
    kernels += kernel_phase_3c(dev, flops, bw, report)
    slice_launches = slice_phase(dev, report)
    chain_launches = chain_phase(dev, report)
    pallas_launches = pallas_phase(dev, report)
    harness_launches = harness_phase(dev, report)
    mprl_phase(dev, report)
    train_phase(dev, report)
    baselines_phase(dev, report)
    partition = partition_phase(dev, flops, bw, report)
    dp_phase(dev, report)
    kernels += bf16_kernel_phase(dev, flops, bw, report)
    kernels += orca_phase(dev, flops, bw, report)
    kernels += rgl_value_phase(dev, flops, bw, report)
    bench = bench_phase(dev, report)
    # each kernel's launches on the path that runs it (0: no path does);
    # #2's only path is the halo attention with a value table
    path_launches = {
        "fused_block_attention_packed_shared":
            slice_launches["fused_block_attention_packed_shared"],
        "fused_block_attention_packed":
            partition["k2"]["launches"]["fused_block_attention_packed"],
        "fused_gather_attention": pallas_launches["fused_gather_attention"],
        "chunk_block_attention[groups=2]":
            chain_launches["chunk@d64"]["chunk_block_attention"],
        "chunk_block_attention[groups=4]":
            chain_launches["chunk_d32@d32"]["chunk_block_attention"],
        "fused_block_attention":
            slice_launches["fused_block_attention"],
        **{f"ab_block_attention[{name}]":
           harness_launches[name]["ab_block_attention"]
           for name in AB_VARIANTS},
        # bf16: #1 on bench_roofline's fused-block chain row; #2 on no path
        # (the JAX package runs it in bfloat16 only in its tests)
        "fused_block_attention_packed_shared[bf16]": bench["bf16_shared"],
        "fused_block_attention_packed[bf16]": 0,
        "fma_chain": bench["fma"],
        # bench_extra's 102,400-agent R=8 rollout, one a step
        "orca_velocity": bench["orca"],
        # one MP-RGL evaluation step (d=2): four a decision
        "rgl_value": report["kernel_detail"]["rgl_value"]["step_launches"]}
    for row in kernels:
        row["launches"] = path_launches[row["name"]]
        if row["name"] in partition["k2"]["timing"]:
            row["halo"] = dict(partition["k2"]["timing"][row["name"]])
            row["halo"]["launches"] = (
                partition["halo1"] if row["name"].endswith("shared") else
                {"block_halo_attention@D=4": row["launches"]})

    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    print(f"chip_smoke: {report['seconds']:.1f} s in all", flush=True)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
