"""Interleaved A/B harness for the block kernel's math variants.

Counterpart of ``tools/ab_kernel.py``. Variants of the windowed block
attention (divide before or after the value product, bool or int mask,
float32 or bfloat16 features, a table that is gathered every iteration or
frozen, a tail gather, the chunked fetch) each run a loop-carried chain of
``inner`` applications over the relation chain's graph (n=8192, K=16, d=64,
B=256, C=544). Back-to-back runs of one program drift, so the variants run
in turns inside one process, many rounds, and each reports its median and
IQR: drift hits every variant alike. As the reference times one jitted scan
a chain, on the card each variant's chain is captured once as a CUDA graph
(``captured.Graphed``) and its timed runs replay it; eager runs of the same
chain, what a Python caller pays a launch at a time, are timed in the same
turns.

    python -m relationalgraphlearning_tpu_torch.tools.ab_kernel \\
        [--rounds 7] [--reps 30] [--B 256] [--C 544] [--inner 100]

prints the chunked fetch's coverage, then one JSON line per variant, with
the graphed and the eager Gedges/s. Every variant but ``chunkfetch_f32``
runs kernel #6 (``ops/ab_block.py``);
``chunkfetch_f32`` runs kernel #4 (``ops/fused_chunk.py``). The gather of
each iteration's window is ``torch`` indexing outside the kernel, as the
reference leaves it to XLA outside its kernel.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch
from torch import Tensor

from relationalgraphlearning_tpu_torch import relation_chain as rc
from relationalgraphlearning_tpu_torch.captured import Graphed
from relationalgraphlearning_tpu_torch.ops import (
    _build, ab_block, block_graph, fused_chunk)
from relationalgraphlearning_tpu_torch.ops.fused_block import pack_emask

N, K, D = 8192, 16, 64
NCH, CT = 2, 288            # the chunked fetch's chunks and tail slots
TAIL_FROM = 320             # TAILSIM: slots frozen at iteration 0
# the kernels the variants run (#6, and #4 for the chunked fetch)
_KERNELS = ("ab_block_attention", "chunk_block_attention")


def make_kernel(B: int, C: int, d: int, *, div_after: bool = False,
                intmask: bool = False):
    """(qb [nb, B, d], xg [nb, C, d], mbits) → [nb, B, d] through kernel #6
    (the plain version on CPU tensors)."""
    def call(qb: Tensor, xg: Tensor, mbits: Tensor) -> Tensor:
        return ab_block.ab_block_attention(qb, xg, mbits, div_after=div_after,
                                           intmask=intmask)
    return call


def chain(kernel_call, dtype: torch.dtype, no_gather: bool = False,
          tail_from: int | None = None, inner: int = 100):
    """f(h [n, d], cand [nb, C], mbits) → h after ``inner`` applications of
    ``kernel_call`` with q = the previous output and the window gathered
    from it. ``no_gather`` freezes iteration 0's window (the kernel-only
    ceiling); ``tail_from`` keeps slots [:tail_from] from iteration 0 and
    gathers the rest fresh (a stand-in for a chunked fetch plus a tail
    gather)."""
    def f(h: Tensor, cand: Tensor, mbits: Tensor) -> Tensor:
        n, d = h.shape
        nb = cand.shape[0]
        candc = cand.clamp(0, n - 1)
        xg0 = h[candc]
        for _ in range(inner):
            if no_gather:
                xg = xg0
            elif tail_from is not None:
                xg = torch.cat([xg0[:, :tail_from],
                                h[candc[:, tail_from:]]], 1)
            else:
                xg = h[candc]
            h = kernel_call(h.reshape(nb, n // nb, d), xg,
                            mbits).reshape(n, d).to(dtype)
        return h
    return f


def graph(n: int = N, K: int = K, d: int = D, B: int = 256, C: int = 544,
          device="cuda"):
    """The harness's inputs: (cols, cand, coverage, mbits, h0) over the
    relation chain's seeded crowd graph and unit-norm seed features."""
    cols = rc.crowd_graph(n, K, device=device)
    cand, cov = block_graph.block_window(cols, B, C)
    mbits = pack_emask(block_graph.block_masks(cols, cand))
    return cols, cand, cov, mbits, rc.seed_features(n, d, device=device)


def variants(cols: Tensor, B: int = 256, C: int = 544, inner: int = 100):
    """The reference's seven variants, name → (f(h, cand, mbits), dtype),
    and the chunked fetch's record (its coverage, ``nch``, ``ct``)."""
    f32, bf16 = torch.float32, torch.bfloat16
    divafter_int = make_kernel(B, C, D, div_after=True, intmask=True)
    table = {
        "base_f32": (chain(make_kernel(B, C, D), f32, inner=inner), f32),
        "divafter_f32": (chain(make_kernel(B, C, D, div_after=True), f32,
                               inner=inner), f32),
        "divafter_intmask_f32": (chain(divafter_int, f32, inner=inner), f32),
        "divafter_bf16": (chain(make_kernel(B, C, D, div_after=True), bf16,
                                inner=inner), bf16),
        "divafter_intmask_f32_NOGATHER": (
            chain(divafter_int, f32, no_gather=True, inner=inner), f32),
        "divafter_intmask_f32_TAILSIM": (
            chain(divafter_int, f32, tail_from=TAIL_FROM, inner=inner), f32),
    }
    starts, tail, cmbits, ccov = fused_chunk.chunk_window(
        cols, B, nch=NCH, ct=CT, thresh=80, chunk=128)

    def chunkfetch(h: Tensor, cand: Tensor, mbits: Tensor) -> Tensor:
        for _ in range(inner):
            h = fused_chunk.chunk_block_attention(
                h, h, starts, tail, cmbits, epilogue="l2norm", stable=False)
        return h

    table["chunkfetch_f32"] = (chunkfetch, f32)
    return table, dict(chunk_coverage=float(ccov), nch=NCH, ct=CT)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _seconds_a_call(fn, reps: int, device) -> float:
    """Wall seconds a call of ``fn``: ``reps`` calls between synchronises,
    as the reference's ``_timeit`` amortises its dispatch."""
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / reps


def run(rounds: int = 7, reps: int = 30, B: int = 256, C: int = 544,
        inner: int = 100, device="cuda", n: int = N,
        finals: dict | None = None, graphed: bool | None = None) -> list:
    """Warm every variant up, then time them in turns, ``rounds`` times
    ``reps`` chain runs each with a synchronise after each variant's reps
    (``rounds`` = 0: the checked runs alone, and no rates).

    ``graphed`` (default: on the card) captures each variant's chain once as
    a CUDA graph after its checked eager run; each turn then times ``reps``
    replays, then ``reps`` eager runs. CPU tensors run eagerly only.

    Returns the chunked fetch's record, then one record a variant: its
    median and best Gedges/s (n·K·inner edges a chain run) over the timed
    rounds (the replays when graphed, else the eager runs), the IQR of those
    rounds in % of the median, the eager rounds' median ``gedges_s_eager``,
    the window's coverage, ``launches``, the kernel launches of its first
    chain run (counts zeroed before it), and, when graphed,
    ``graph_launches``, the kernel launches one replay holds, and
    ``replay_err``, the largest |replay − first run| on the same inputs
    (None without a graph). ``finals``, if given, receives ``graph``, the
    (cols, cand, coverage, mbits, h0) that every variant ran on, and ``h``,
    each variant's h after its first chain run.
    """
    if graphed is None:
        graphed = torch.device(device).type == "cuda"
    cols, cand, cov, mbits, h0 = graph(n, K, D, B, C, device)
    table, chunk = variants(cols, B, C, inner)
    inputs, launches, outs, graphs, extra = {}, {}, {}, {}, {}
    for name, (f, dtype) in table.items():
        inputs[name] = h0.to(dtype)
        _sync(device)
        _build.reset_launch_counts()
        out = f(inputs[name], cand, mbits)
        _sync(device)
        counts = _build.launch_counts()
        launches[name] = {k: counts[k] for k in _KERNELS}
        outs[name] = out
        extra[name] = dict(graph_launches=None, replay_err=None)
        if graphed:
            g = graphs[name] = Graphed(f, inputs[name], cand, mbits)
            replay = g(inputs[name], cand, mbits)
            extra[name] = dict(
                graph_launches={k: g.launches[k] for k in launches[name]},
                replay_err=float((replay.float() - out.float()).abs().max()))
    if finals is not None:
        finals.update(graph=(cols, cand, cov, mbits, h0), h=outs)
    times = {name: [] for name in table}
    eager = {name: [] for name in table}
    for _ in range(rounds):
        for name, (f, _) in table.items():
            args = (inputs[name], cand, mbits)
            if graphed:
                times[name].append(_seconds_a_call(
                    lambda: graphs[name](*args), reps, device))
            eager[name].append(_seconds_a_call(lambda: f(*args), reps,
                                               device))
    if not graphed:
        times = eager
    records = [chunk]
    for name, ts in times.items():
        rates = {}
        if rounds:
            med, srt = statistics.median(ts), sorted(ts)
            rates = dict(
                gedges_s=n * K * inner / med / 1e9,
                # the fastest round is the least disturbed estimate of the
                # device, the median the sustained number
                gedges_s_best=n * K * inner / srt[0] / 1e9,
                iqr_pct=100 * (srt[len(ts) * 3 // 4] - srt[len(ts) // 4])
                / med,
                gedges_s_eager=n * K * inner
                / statistics.median(eager[name]) / 1e9)
        records.append(dict(
            variant=name, B=B, C=C, **rates, graphed=graphed,
            coverage=float(cov), launches=launches[name], **extra[name]))
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--B", type=int, default=256)
    ap.add_argument("--C", type=int, default=544)
    ap.add_argument("--inner", type=int, default=100)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_kernel: no CUDA device; the harness times the card",
              file=sys.stderr)
        return 1
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    for record in run(args.rounds, args.reps, args.B, args.C, args.inner):
        print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
