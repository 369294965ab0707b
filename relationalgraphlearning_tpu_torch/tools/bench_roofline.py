"""The roofline of the graph hot path on the card (counterpart of
``bench_roofline.py`` at the repository's root): the card's measured
ceilings, then the relation chain over the gather path, the windowed dense
block path and kernel #1, in float32 and bfloat16.

    python -m relationalgraphlearning_tpu_torch.tools.bench_roofline
    python -m relationalgraphlearning_tpu_torch.tools.bench_roofline \\
        --device cpu --n 512 ...                     # a small run on the CPU

What each key names on the card (the reference's names are the TPU's
units):

- ``mxu_f32_tflops``, ``mxu_bf16_tflops``: a chain of 16 products of
  4096 × 4096 matrices through ``torch.matmul`` (cuBLAS), TF32 off, so the
  float32 one runs on the CUDA cores and the bfloat16 one on the tensor
  cores (``bench_roofline.py:50-62``);
- ``vpu_f32_tflops``: 128 chained float32 FMAs an element a pass, 2^20
  elements, 64 passes, in one kernel written for it (``ops/roofline.py``,
  ``csrc/roofline.cu``; ``:65-81``): the CUDA cores' FMA rate;
- ``hbm_gb_s``: ``x + 1`` over 512 MB, 8 passes, read and write counted
  (``:84-96``): device memory;
- ``chain_*``: the loop-carried gather chain (``:99-130``),
  ``block_*``: the dense block path at B=256, C=640 (``:177-216``),
  ``block_pallas_*``: kernel #1 with the fused ``l2norm`` (``:218-255``),
  ``chain_pallas_gedges_s``: kernel #3 (``:261-266``), each over n=8192,
  K=16, d=64, 100 iterations, in float32 and bfloat16 where the reference
  runs both.

Every program runs captured as one CUDA graph on the card and is timed by
the reference's protocol (the median of 5 timed regions of ``reps``
calls). Prints one JSON line a measurement, as the reference does, and
writes the record to ``relationalgraphlearning_tpu_torch/results/
ROOFLINE.json`` (``--out``); the reference's ``docs/ROOFLINE.json`` is the
TPU's and is not touched. A failure of any kernel fails the tool.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
import torch

from relationalgraphlearning_tpu_torch import relation_chain as rc
from relationalgraphlearning_tpu_torch.captured import Graphed
from relationalgraphlearning_tpu_torch.ops import _build, roofline
from relationalgraphlearning_tpu_torch.tools import bench_extra as be

RECORD = Path(__file__).resolve().parents[1] / "results" / "ROOFLINE.json"
DTYPES = ((torch.float32, "f32"), (torch.bfloat16, "bf16"))


# the reference's ``_med_time``: the median of 5 timed regions
TRIALS = 5


def _program(fn, x, device):
    """``fn`` over x as one captured graph on the card, else ``fn``."""
    if be.on_card(device):
        g = Graphed(fn, x)
        return lambda: g(x)
    return lambda: fn(x)


def mxu_peak(dtype, m: int = 4096, inner: int = 16, device="cuda") -> float:
    """FLOP/s of ``inner`` chained m × m products (``:50-62``)."""
    a = torch.ones((m, m), dtype=dtype, device=device)
    b = torch.ones((m, m), dtype=dtype, device=device)

    def chain(a):
        for _ in range(inner):
            a = torch.matmul(a, b)
        return a

    dt = be.timeit(_program(chain, a, device), device, 3, TRIALS)
    return 2 * m * m * m * inner / dt


def vpu_peak(n: int = 1024 * 1024, inner: int = 64, fmas: int = 128,
             device="cuda") -> float:
    """FLOP/s of ``fmas`` chained FMAs an element a pass, ``inner`` passes
    (``:65-81``), one launch of the FMA kernel a call."""
    x = torch.ones((n,), device=device)
    dt = be.timeit(lambda: roofline.fma_chain(x, fmas, inner), device, 3,
                   TRIALS)
    return 2 * fmas * n * inner / dt


def hbm_bw(mb: int = 512, inner: int = 8, device="cuda") -> float:
    """Bytes/s of ``inner`` passes of x + 1 over ``mb`` MB, read and write
    (``:84-96``)."""
    n = mb * 1024 * 1024 // 4
    x = torch.ones((n,), device=device)

    def passes(x):
        for _ in range(inner):
            x = x + 1.0
        return x

    dt = be.timeit(_program(passes, x, device), device, 3, TRIALS)
    return 2 * 4 * n * inner / dt


def graph_chain(n: int = 8192, K: int = 16, d: int = 64, inner: int = 100,
                dtype=torch.float32, use_pallas: bool = False,
                device="cuda", reps: int = 10) -> dict:
    """``:99-130``: the gather chain (``use_pallas``: kernel #3) over the
    kNN graph of n unsorted uniform positions, from unit-normal features
    in ``dtype``; the output cast to ``dtype`` after the normalisation."""
    cols = rc.crowd_graph(n, K, seed=0, device=device, sort=False)
    g = torch.Generator().manual_seed(1)
    h0 = torch.randn((n, d), generator=g).to(device, dtype)
    prep = rc.prepare("gather_kernel" if use_pallas else "gather", cols)
    return be.chain_rate(prep, h0, n, K, inner, device, reps, TRIALS)


def block_chain(route: str, n: int = 8192, K: int = 16, d: int = 64,
                inner: int = 100, B: int = 256, C: int = 640,
                dtype=torch.float32, device="cuda", reps: int = 30) -> dict:
    """``:177-255``: the chain through the window over sorted positions
    from unit-normal features in ``dtype``: ``block_dense`` (the dense
    block path, then the normalisation) or ``block`` (kernel #1 with the
    stable softmax and the fused l2norm, as the reference calls it)."""
    cols = rc.crowd_graph(n, K, seed=0, device=device)
    g = torch.Generator().manual_seed(1)
    h0 = torch.randn((n, d), generator=g).to(device, dtype)
    prep = rc.prepare(route, cols, B, C, stable=True)
    return be.chain_rate(prep, h0, n, K, inner, device, reps, TRIALS)


def run(device="cuda", m: int = 4096, vpu_n: int = 1024 * 1024,
        hbm_mb: int = 512, n: int = 8192, inner: int = 100, B: int = 256,
        C: int = 640, out: Path = RECORD):
    """Measure, print each line, write the record; return (the record,
    each row's details)."""
    K, d = 16, 64
    res = {"device": be.device_name(device)}
    detail = {}
    # the ceilings unrounded: the ratios below divide by them
    peak = detail["ceilings"] = {
        "mxu_f32": mxu_peak(torch.float32, m, device=device),
        "mxu_bf16": mxu_peak(torch.bfloat16, m, device=device)}
    _build.reset_launch_counts()
    peak["vpu_f32"] = vpu_peak(vpu_n, device=device)
    detail["vpu_launches"] = {"fma_chain": _build.launch_counts()["fma_chain"]}
    peak["hbm"] = hbm_bw(hbm_mb, device=device)
    res["mxu_f32_tflops"] = round(peak["mxu_f32"] / 1e12, 1)
    res["mxu_bf16_tflops"] = round(peak["mxu_bf16"] / 1e12, 1)
    res["vpu_f32_tflops"] = round(peak["vpu_f32"] / 1e12, 2)
    res["hbm_gb_s"] = round(peak["hbm"] / 1e9, 1)
    notes = {"mxu_f32_tflops": "torch.matmul, TF32 off (CUDA cores)",
             "mxu_bf16_tflops": "torch.matmul (tensor cores)",
             "vpu_f32_tflops": "csrc/roofline.cu, chained FMAs",
             "hbm_gb_s": "x + 1, read and write"}
    for k in ("mxu_f32_tflops", "mxu_bf16_tflops", "vpu_f32_tflops",
              "hbm_gb_s"):
        print(json.dumps({"metric": f"ceiling {k}", "value": res[k],
                          "note": notes[k]}), flush=True)

    flops_per_edge = 2 * (d + d) + 6  # SDDMM + SpMM FMAs + softmax ops
    for dtype, tag in DTYPES:
        r = detail[f"chain_{tag}"] = graph_chain(n, K, d, inner, dtype,
                                                 device=device)
        e = r["edges_per_s"]
        eff = e * flops_per_edge
        res[f"chain_{tag}_gedges_s"] = round(e / 1e9, 2)
        res[f"chain_{tag}_eff_tflops"] = round(eff / 1e12, 2)
        res[f"chain_{tag}_vs_vpu"] = round(eff / peak["vpu_f32"], 3)
        print(json.dumps({
            "metric": f"graph chain ({tag}, n={n}, K={K}, d={d})",
            "gedges_per_s": res[f"chain_{tag}_gedges_s"],
            "effective_tflops": res[f"chain_{tag}_eff_tflops"],
            "fraction_of_vpu_ceiling": res[f"chain_{tag}_vs_vpu"],
        }), flush=True)

    hbm_sol = peak["hbm"] / (2 * d * 4)
    res["hbm_sol_gedges_s"] = round(hbm_sol / 1e9, 2)
    print(json.dumps({
        "metric": "HBM-bound speed-of-light (if gathers left chip)",
        "gedges_per_s": res["hbm_sol_gedges_s"],
        "note": "measured chain exceeding this proves L2-resident gathers",
    }), flush=True)

    for dtype, tag in DTYPES:
        r = detail[f"block_{tag}"] = block_chain("block_dense", n, K, d,
                                                 inner, B, C, dtype,
                                                 device=device)
        dense_flops = n * C * 2 * (d + d) * inner / r["seconds"]
        res[f"block_{tag}_gedges_s"] = round(r["edges_per_s"] / 1e9, 2)
        res[f"block_{tag}_dense_tflops"] = round(dense_flops / 1e12, 2)
        res[f"block_{tag}_vs_mxu"] = round(
            dense_flops / peak[f"mxu_{tag}"], 3)
        print(json.dumps({
            "metric": f"graph chain (windowed dense MXU, {tag})",
            "gedges_per_s": res[f"block_{tag}_gedges_s"],
            "dense_tflops": res[f"block_{tag}_dense_tflops"],
            "fraction_of_mxu_ceiling": res[f"block_{tag}_vs_mxu"],
            "coverage": r["coverage"],
        }), flush=True)

    for dtype, tag in DTYPES:
        r = detail[f"block_pallas_{tag}"] = block_chain(
            "block", n, K, d, inner, B, C, dtype, device=device)
        dense_flops = n * C * 2 * (d + d) * inner / r["seconds"]
        res[f"block_pallas_{tag}_gedges_s"] = round(r["edges_per_s"] / 1e9,
                                                    2)
        res[f"block_pallas_{tag}_vs_mxu"] = round(
            dense_flops / peak[f"mxu_{tag}"], 3)
        print(json.dumps({
            "metric": f"graph chain (pallas fused block, {tag})",
            "gedges_per_s": res[f"block_pallas_{tag}_gedges_s"],
            "fraction_of_mxu_ceiling": res[f"block_pallas_{tag}_vs_mxu"],
        }), flush=True)
    res["block_pallas_gedges_s"] = res["block_pallas_f32_gedges_s"]

    r = detail["chain_pallas"] = graph_chain(n, K, d, inner, use_pallas=True,
                                             device=device)
    res["chain_pallas_gedges_s"] = round(r["edges_per_s"] / 1e9, 2)
    print(json.dumps({"metric": "graph chain (pallas fused)",
                      "gedges_per_s": res["chain_pallas_gedges_s"]}),
          flush=True)

    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1) + "\n")
    print(json.dumps({"metric": "written", "path": str(out)}), flush=True)
    return res, detail


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, where nothing is captured")
    ap.add_argument("--m", type=int, default=4096,
                    help="the products' matrix size")
    ap.add_argument("--vpu_n", type=int, default=1024 * 1024)
    ap.add_argument("--hbm_mb", type=int, default=512)
    ap.add_argument("--n", type=int, default=8192, help="the chain's rows")
    ap.add_argument("--inner", type=int, default=100)
    ap.add_argument("--B", type=int, default=256)
    ap.add_argument("--C", type=int, default=640)
    ap.add_argument("--out", default=str(RECORD),
                    help="where the record goes")
    args = ap.parse_args(argv)
    be.check_device(args.device, "bench_roofline")
    torch.backends.cuda.matmul.allow_tf32 = False
    return run(args.device, args.m, args.vpu_n, args.hbm_mb, args.n,
               args.inner, args.B, args.C, Path(args.out))


if __name__ == "__main__":
    main()
