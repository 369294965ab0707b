#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py            # the run the port is held to
    python3 chip_smoke.py --profile  # also where a rollout chunk's time
                                     # goes, eager and graphed

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
   backend with packed masks, B=256, C=576, rebuild every 8 steps, eager
   (``graphed=False``) and graphed (``MegaCrowdRollout``: each chunk's 8
   steps one captured CUDA graph, captured once before the timed runs), in
   turns. The kernels' launch counts are zeroed just before each eager run
   and read just after; the shared-table kernel must have launched 64 times
   (2 GCN layers x 32 steps), and the chunk's graph must hold 16 of its
   launches and none of another kernel. Each graphed run must equal the
   eager run bit for bit. Checks coverage 1, finite results, the
   block+kernel value net against the gather backend on one rebuilt graph,
   and a small rollout on the card against the same rollout on the CPU.
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
   backend="pallas", rebuild_every=8)``, eager and graphed in turns as in
   phase 4: exactly 64 launches of kernel #3 an eager run, 16 in the
   chunk's graph, replays equal to the eager run, finite results, and the
   pallas, block+kernel and gather value nets equal on one rebuilt graph.
7. The A/B harness (``tools/ab_kernel.py`` of the port) at its shapes
   (n=8192, K=16, d=64, B=256, C=544, inner=100), fewer rounds: coverage
   exactly 1 for the window and the chunked fetch, exactly ``inner``
   launches of #6 (#4 for ``chunkfetch_f32``) in each variant's checked
   chain run and in its captured graph, each replay equal to the checked
   run, and each variant's final h against the plain gather chain (the
   frozen-table variants against the same chain on the plain version);
   Gedges/s graphed and eager, in the same turns.
8. MP-RGL evaluation (slice 7): the committed checkpoints' 500 seeded test
   cases through ``Explorer.run_cases`` on the card: ``mprl_td`` at its
   d=2, w=2, the same weights at d=1 and at d=2, w=4, and
   ``mp_unicycle_anneal`` at its d=2, w=8. Each runs eager and graphed (one
   decision and one env step captured once, replayed 100 times), in turns.
   Each run must hold success and collision within 0.010 and nav time
   within 0.20 s of the committed ``eval_test*.json``, agree with the JAX
   package's per-case outcomes (``checkpoints/<run>_test_reference.npz``)
   in at least 485 of 500 cases, and its graphed run must equal its eager
   run bit for bit; none of kernels #1-#7 may launch.
9. Print the ``kernels`` line, the card line and the last line.

Details go to ``chiprun_out/chip_smoke.json``. Needs one card and no network.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from relationalgraphlearning_tpu_torch import captured, checkpoints
from relationalgraphlearning_tpu_torch import relation_chain as rc
from relationalgraphlearning_tpu_torch import types as T
from relationalgraphlearning_tpu_torch.cli import test as eval_cli
from relationalgraphlearning_tpu_torch.configs.base import GCNConfig
from relationalgraphlearning_tpu_torch.envs import mega_crowd
from relationalgraphlearning_tpu_torch.models.sparse_rgl import SparseValueNet
from relationalgraphlearning_tpu_torch.ops import _build
from relationalgraphlearning_tpu_torch.ops import ab_block as ab
from relationalgraphlearning_tpu_torch.ops import block_graph as bg
from relationalgraphlearning_tpu_torch.ops import fused_block as fb
from relationalgraphlearning_tpu_torch.ops import fused_chunk as fc
from relationalgraphlearning_tpu_torch.ops import fused_gather as fg
from relationalgraphlearning_tpu_torch.ops.sparse import knn_graph_auto
from relationalgraphlearning_tpu_torch.tools import ab_kernel as ak

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
           "chunk_block_attention.cu", "ab_block_attention.cu")
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
# The harness at the reference's shapes; fewer rounds and reps than its
# defaults (7 x 30) so that the script stays inside its time limit.
HARNESS = dict(rounds=5, reps=5, B=256, C=544, inner=100)
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
# Published dense peaks (NVIDIA data sheets): float32 outside the tensor
# cores in FLOP/s, device memory in bytes/s. Matched on the card's name;
# the SXM part is the default.
PEAKS = (("H100 PCIe", 51e12, 2.0e12), ("H100 NVL", 60e12, 3.9e12),
         ("H100", 67e12, 3.35e12))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


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
    net = seeded_net("block", dev)
    states = torch.cat([pos, vel, torch.full_like(pos[:, :1], 0.3)], -1)
    with torch.no_grad():
        H = net.graph_model.w_h(states)
        q = net.graph_model.w_a(H)
    nb = cand.shape[0]
    return q.reshape(nb, -1, q.shape[1]).contiguous(), H, cand, mbits, cov


def seeded_net(backend, dev, seed=1):
    g = torch.Generator().manual_seed(seed)
    return SparseValueNet(GCNConfig(), backend=backend,
                          generator=g).to(dev).eval()


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
        tables = n * d * 4 + (0 if kind == "shared" else n * dv * 4)
        nbytes = (qb.numel() * 4 + tables + cand.numel() * 8
                  + mbits.numel() * 4 + nb * B * dv * 4)
        # per edge: d multiply-adds for the score, dv for the value sum,
        # one exp and one add for the denominator
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
    net = seeded_net("pallas", dev)
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
        bound=bound(4 * (3 * n * d + mbits.numel()) + 8 * cand.numel(),
                    edges * (4 * d + 2), flops, bw))
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


def rollout_turns(cfg, kernel, dev, runs=3):
    """The rollout ``cfg`` eager (``mega_crowd_rollout(graphed=False)``) and
    graphed (one ``MegaCrowdRollout``, captured first and timed apart, as the
    reference compiles before it times), ``runs`` times each in turns (E G,
    G E, ...), after an eager warm-up: the host's clock varies from run to
    run on a shared host, so medians are reported. Each eager run zeroes the
    counts just before it and checks them just after: 2 launches of
    ``kernel`` a step, none of another. The chunk's graph must hold 2 a
    step of its R, and a graphed run must equal the eager one bit for bit.
    Returns the eager run's ((pos, vel), values, coverage), its launches
    and the record of the turns."""
    mega_crowd.mega_crowd_rollout(**{**cfg, "steps": 8}, device=dev,
                                  graphed=False)
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
    want = {k: 0 for k in graph}
    want[kernel] = layers * R
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
                expect = {k: 0 for k in launches}
                expect[kernel] = layers * cfg["steps"]
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
    steps_done = cfg["n"] * cfg["steps"]
    turns = dict(
        agent_steps_per_s=steps_done / statistics.median(walls["graphed"]),
        agent_steps_per_s_eager=steps_done / statistics.median(
            walls["eager"]),
        agent_steps_per_s_runs=[steps_done / w for w in walls["graphed"]],
        agent_steps_per_s_eager_runs=[steps_done / w
                                      for w in walls["eager"]],
        capture_s=capture_s, graph_launches=graph, replay_err=replay_err)
    return (pos, vel), vals, cov, launches, turns


def slice_phase(dev, report, runs=3):
    """The slice's rollout, eager and graphed in turns (``rollout_turns``),
    and its checks."""
    (pos, vel), vals, cov, launches, turns = rollout_turns(
        SLICE, "fused_block_attention_packed_shared", dev, runs)
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
        v_block = seeded_net("block", dev)(states, cols, block_cand=cand,
                                           block_emask=mbits)
        v_gather = seeded_net("gather", dev)(states, cols)
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
    print(f"slice: {turns['agent_steps_per_s']:.1f} agent-steps/s graphed, "
          f"{turns['agent_steps_per_s_eager']:.1f} eager, medians of {runs} "
          f"runs in turns (graphed {turns['agent_steps_per_s_runs']}, eager "
          f"{turns['agent_steps_per_s_eager_runs']}; capture "
          f"{turns['capture_s']:.3f} s), coverage {float(cov)}, knn_overlap "
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
    turns (``rollout_turns``), and its checks."""
    (pos, vel), vals, cov, launches, turns = rollout_turns(
        PALLAS, "fused_gather_attention", dev, runs)
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
        v_pallas = seeded_net("pallas", dev)(states, cols)
        v_block = seeded_net("block", dev)(states, cols, block_cand=cand,
                                           block_emask=mbits)
        v_gather = seeded_net("gather", dev)(states, cols)
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
    """The A/B harness at its shapes, each variant's chain graphed (its
    timed rows) and eager, in the same turns. ``run`` zeroes the counts of
    #6 and #4 before each variant's checked chain run and reads them after;
    the totals over the whole run are read here too."""
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
    # after it, then the timed rounds, whose replays count nothing and whose
    # eager runs count every launch
    timed = HARNESS["rounds"] * HARNESS["reps"]
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
        want_total[kernel] += inner * timed
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


# ------------------------------------------------------------- --profile
# ------------------------------------------------------------------ phase 8
def mprl_setup(model, overrides, dev):
    """(config, env, policy with the exported weights, explorer) of
    ``results/<model>`` with planner ``overrides``, as the port's CLI
    builds them."""
    config, _ = eval_cli.configure(str(ROOT / "results" / model),
                                   **overrides)
    return (config, *eval_cli.build(config, model, dev))


def mprl_run(run, model, overrides, record, dev, order):
    """One evaluated configuration's 500 cases, eager and graphed in
    ``order``, and its checks. Returns its report."""
    config, env, policy, explorer = mprl_setup(model, overrides, dev)
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
    committed = json.loads((ROOT / "results" / model / record).read_text())
    ref = checkpoints.load_test_reference(run)
    outcome = eager.case_outcome.cpu().numpy()
    agree = int((outcome == ref["outcome"]).sum())
    both_succeed = (outcome == T.OUTCOME_REACH_GOAL) & (
        ref["outcome"] == T.OUTCOME_REACH_GOAL)
    same_steps = int((eager.step.cpu().numpy()[both_succeed]
                      == ref["steps"][both_succeed]).sum())
    delta = dict(success_rate=stats["success_rate"]
                 - committed["success_rate"],
                 collision_rate=stats["collision_rate"]
                 - committed["collision_rate"],
                 nav_time=stats["avg_nav_time"] - committed["nav_time"])
    steps = sim.test_size * config.env.max_steps
    out = dict(
        run=run, model=model, overrides=overrides, cases=sim.test_size,
        stats=stats, committed={k: committed[k] for k in (
            "success_rate", "collision_rate", "timeout_rate", "nav_time",
            "return", "danger_frequency", "avg_min_dist")},
        delta=delta, outcome_agree=agree,
        successes_both=int(both_succeed.sum()), same_steps=same_steps,
        capture_s=capture_s, wall_s=walls["graphed"],
        wall_s_eager=walls["eager"], order=list(order),
        env_steps_per_s=steps / walls["graphed"],
        env_steps_per_s_eager=steps / walls["eager"],
        rgl_forwards_per_decision=policy.rgl_forwards_per_decision(),
        rgl_forwards_per_step=policy.rgl_forwards_per_decision()
        * sim.test_size)
    print(f"mprl {run}: success {stats['success_rate']:.3f} "
          f"[{committed['success_rate']:.3f}], collision "
          f"{stats['collision_rate']:.3f} [{committed['collision_rate']:.3f}]"
          f", timeout {stats['timeout_rate']:.3f} "
          f"[{committed['timeout_rate']:.3f}], nav time "
          f"{stats['avg_nav_time']:.4f} [{committed['nav_time']:.4f}] s, "
          f"return {stats['avg_return']:.4f} [{committed['return']:.4f}], "
          f"danger {stats['danger_frequency']:.4f} "
          f"[{committed['danger_frequency']:.4f}], min dist "
          f"{stats['avg_min_dist']:.4f} [{committed['avg_min_dist']:.4f}]; "
          f"outcomes equal to the JAX package's in {agree}/{sim.test_size}, "
          f"same steps in {same_steps}/{int(both_succeed.sum())} shared "
          f"successes; capture {capture_s:.3f} s, graphed "
          f"{walls['graphed']:.3f} s ({out['env_steps_per_s']:.0f} env-steps"
          f"/s), eager {walls['eager']:.3f} s "
          f"({out['env_steps_per_s_eager']:.0f}), "
          f"{out['rgl_forwards_per_decision']} RGL forwards a decision, "
          f"graphed == eager",
          flush=True)
    misses = [f"|d {k}| = {abs(v):.4f} > {MPRL_BOUNDS[k]}"
              for k, v in delta.items() if abs(v) > MPRL_BOUNDS[k]]
    if agree < MPRL_MIN_AGREE:
        misses.append(f"{agree} outcomes equal < {MPRL_MIN_AGREE}")
    if misses:
        raise RuntimeError(f"{run}: {'; '.join(misses)}")
    return out


def mprl_phase(dev, report):
    """The four evaluated configurations, each eager and graphed in turns
    (E G, G E, ...). Kernel counts are zeroed before the phase and read
    after it: this path launches none of #1-#7."""
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
            runs.append(mprl_run(run, model, overrides, record, dev, order))
    launches = captured.launch_counts()
    if any(launches.values()):
        raise RuntimeError(f"the MP-RGL path launched kernels: {launches}")
    report["mprl"] = dict(precision=precision, runs=runs, launches=launches)
    return launches


def mprl_profile_phase(dev, report, steps=10):
    """Where one evaluation step of ``mprl_td`` (500 cases, d=2, w=2) goes:
    host seconds of the decision (planner), the humans' ORCA step and the
    reward (collision check), each closed by a synchronise, over ``steps``
    eager steps; the profiler's device time by
    kernel over one eager step and over one graph replay."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from relationalgraphlearning_tpu_torch.envs.reward import compute_reward

    config, env, policy, explorer = mprl_setup("mprl_td", {}, dev)
    carry = explorer.initial_carry(config.env.sim.test_seed_offset,
                                   range(config.env.sim.test_size))
    times = dict(planner=0.0, orca=0.0, reward=0.0)
    with torch.no_grad():
        explorer.eval_step(*carry)
        for _ in range(steps):
            states = carry.states
            torch.cuda.synchronize()
            t = time.perf_counter()
            action = explorer._act(states)
            torch.cuda.synchronize()
            times["planner"] += time.perf_counter() - t
            t = time.perf_counter()
            human_v = env.human_velocities(states)
            torch.cuda.synchronize()
            times["orca"] += time.perf_counter() - t
            t = time.perf_counter()
            compute_reward(states.robot, T.observable(states.humans), human_v,
                           action, (states.step + 1.0) * config.env.time_step,
                           config.env)
            torch.cuda.synchronize()
            times["reward"] += time.perf_counter() - t
            carry = type(carry)(*explorer.eval_step(*carry))
        per_step = {k: v / steps for k, v in times.items()}

        def traced(fn):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            kernels = sorted(((ev.self_device_time_total, ev.count, ev.key)
                              for ev in prof.key_averages()
                              if ev.device_type == DeviceType.CUDA),
                             reverse=True)
            busy = sum(k[0] for k in kernels) / 1e6
            return dict(wall_s=wall, device_busy_s=busy,
                        device_idle_share=1 - busy / wall,
                        kernel_launches=sum(k[1] for k in kernels),
                        top=[dict(device_us=u, count=c, name=k)
                             for u, c, k in kernels[:15]])

        eager = traced(lambda: explorer.eval_step(*carry))
        graph = explorer.capture(carry)
        graph(*carry)
        graphed = traced(lambda: graph(*carry))
    report["mprl_profile"] = dict(host_s_per_step=per_step, eager=eager,
                                  graphed=graphed)
    print(f"mprl profile (mprl_td, 500 cases): host s a step with a sync "
          f"after each part {per_step}; eager step wall {eager['wall_s']:.4f}"
          f" s, device busy {eager['device_busy_s']:.4f} s (idle share "
          f"{eager['device_idle_share']:.3f}, {eager['kernel_launches']} "
          f"launches); graphed step wall {graphed['wall_s']:.4f} s, busy "
          f"{graphed['device_busy_s']:.4f} s (idle share "
          f"{graphed['device_idle_share']:.3f})", flush=True)
    for row in eager["top"][:10]:
        print(f"  {row['device_us'] / 1e3:10.3f} ms  x{row['count']:<6d} "
              f"{row['name'][:90]}", flush=True)


def profile_phase(dev, report):
    """Where one 8-step chunk of the slice's time goes: host time of each
    section with a synchronise after it, the chunk's wall time without those
    synchronises, and the profiler's device time by kernel over one more
    chunk; then the wall and device time of one graphed chunk (the rebuild
    eager, the steps one replay)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from relationalgraphlearning_tpu_torch.envs.orca import (
        ORCAParams, centralized_orca_step_knn)

    cfg = SLICE
    pos = mega_crowd.initial_crowd(cfg["n"], device=dev)
    vel = torch.zeros_like(pos)
    goals = -pos
    rad = torch.full((cfg["n"],), 0.3, device=dev)
    vmax = torch.ones_like(rad)
    act = torch.ones_like(rad, dtype=torch.bool)
    net = seeded_net("block", dev)
    sections = ("rebuild", "orca", "value_net")

    def chunk(times=None):
        """One rebuild and its 8 steps; with ``times``, a synchronise closes
        each section and its host time is added there."""
        nonlocal pos, vel, goals, rad, vmax, act
        t = time.perf_counter()

        def close(section):
            nonlocal t
            if times is not None:
                torch.cuda.synchronize()
                times[section] += time.perf_counter() - t
                t = time.perf_counter()

        pos, (vel, goals, rad, vmax, act), cols, cols_orca, cand, em, _ = \
            mega_crowd.rebuild(pos, (vel, goals, rad, vmax, act), cfg["K"],
                               "block", cfg["block_B"], cfg["block_C"], True)
        close("rebuild")
        for _ in range(cfg["rebuild_every"]):
            to = goals - pos
            dist = torch.linalg.norm(to, dim=-1, keepdim=True)
            pref = torch.where(dist > 1e-3, to / dist.clamp(min=1e-9), 0.0)
            vel = centralized_orca_step_knn(pos, vel, rad, pref, vmax, act,
                                            ORCAParams(), cfg["K"],
                                            cols=cols_orca)
            pos = pos + vel * mega_crowd.DT
            close("orca")
            with torch.no_grad():
                states = torch.cat([pos, vel, rad[:, None]], -1)
                net(states, cols, block_cand=cand, block_emask=em).mean()
            close("value_net")

    chunk()
    torch.cuda.synchronize()
    times = dict.fromkeys(sections, 0.0)
    chunk(times)
    t0 = time.perf_counter()
    chunk()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"profile: one 8-step chunk {wall:.4f} s; host seconds with a "
          f"sync after each section: {times}", flush=True)

    def traced(fn):
        """(device kernels by time, device busy s, the profiler) over one
        call of ``fn``."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = sorted(((ev.self_device_time_total, ev.count, ev.key)
                          for ev in prof.key_averages()
                          if ev.device_type == DeviceType.CUDA),
                         reverse=True)
        return kernels, sum(k[0] for k in kernels) / 1e6, prof

    kernels, busy, prof = traced(chunk)
    report["profile"] = dict(
        chunk_wall_s=wall, section_host_s=times,
        device_busy_s=busy, device_idle_share=1 - busy / wall,
        kernel_launches=sum(k[1] for k in kernels),
        top=[dict(device_us=u, count=c, name=k) for u, c, k in kernels[:25]])
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "profile_table.txt").write_text(prof.key_averages().table(
        sort_by="self_cuda_time_total", row_limit=40))
    print(f"profile: device busy {busy:.4f} s of the chunk's {wall:.4f} s "
          f"(idle share {1 - busy / wall:.3f}), "
          f"{sum(k[1] for k in kernels)} kernel launches", flush=True)
    for u, c, k in kernels[:10]:
        print(f"  {u / 1e3:10.3f} ms  x{c:<6d} {k[:90]}", flush=True)

    # the same chunk graphed: the rebuild eager, the 8 steps one replay
    runner = mega_crowd.MegaCrowdRollout(
        **{k: v for k, v in cfg.items() if k not in ("n", "steps")},
        device=dev)
    R = cfg["rebuild_every"]
    runner(pos, R)                                   # the capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner(pos, R)
    torch.cuda.synchronize()
    wall_g = time.perf_counter() - t0
    kernels_g, busy_g, _ = traced(lambda: runner(pos, R))
    report["profile"]["graphed"] = dict(
        chunk_wall_s=wall_g, device_busy_s=busy_g,
        device_idle_share=1 - busy_g / wall_g,
        top=[dict(device_us=u, count=c, name=k)
             for u, c, k in kernels_g[:25]])
    print(f"profile, graphed chunk: device busy {busy_g:.4f} s of "
          f"{wall_g:.4f} s (idle share {1 - busy_g / wall_g:.3f}; eager "
          f"{1 - busy / wall:.3f})", flush=True)


def backend_phase(dev, report, rounds=6):
    """The slice's eager rollout under each aggregation path of the value
    net (block+kernel #1, plain block, gather, pallas = kernel #3), in turns
    (ABCD DCBA ...), so that drift hits every path alike."""
    paths = (("block+kernel", "block", True), ("block, plain", "block", False),
             ("gather", "gather", False), ("pallas", "pallas", False))
    runs = {label: [] for label, _, _ in paths}
    order = [p for r in range(rounds) for p in (paths if r % 2 == 0
                                                 else paths[::-1])]
    for label, backend, packed in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mega_crowd.mega_crowd_rollout(**{**SLICE, "backend": backend,
                                         "packed": packed}, device=dev,
                                      graphed=False)
        torch.cuda.synchronize()
        runs[label].append(SLICE["n"] * SLICE["steps"]
                           / (time.perf_counter() - t0))
    report["backends"] = runs
    medians = {k: statistics.median(v) for k, v in runs.items()}
    print(f"backends, agent-steps/s, median of {rounds} runs each: "
          f"{medians}; all runs: {runs}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also break one rollout chunk's time down, time "
                         "the rollout under each aggregation path and break "
                         "one MP-RGL evaluation step down")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
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
    # each kernel's launches on the path that runs it (0: no path does)
    path_launches = {
        "fused_block_attention_packed_shared":
            slice_launches["fused_block_attention_packed_shared"],
        "fused_block_attention_packed":
            slice_launches["fused_block_attention_packed"],
        "fused_gather_attention": pallas_launches["fused_gather_attention"],
        "chunk_block_attention[groups=2]":
            chain_launches["chunk@d64"]["chunk_block_attention"],
        "chunk_block_attention[groups=4]":
            chain_launches["chunk_d32@d32"]["chunk_block_attention"],
        "fused_block_attention":
            slice_launches["fused_block_attention"],
        **{f"ab_block_attention[{name}]":
           harness_launches[name]["ab_block_attention"]
           for name in AB_VARIANTS}}
    for row in kernels:
        row["launches"] = path_launches[row["name"]]
    if args.profile:
        profile_phase(dev, report)
        backend_phase(dev, report)
        mprl_profile_phase(dev, report)

    report["kernels"] = kernels
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
