"""The port's roofline (``tools/bench_roofline.py``) on the CPU, against the
reference's ``bench_roofline.py`` and the JAX package.

- The chain it times (``relation_chain.py``'s gather, dense block and
  kernel #1 routes with a dtype) against the reference's loop bodies
  composed from the JAX package's ops on the same graph and features:
  float32 three iterations at 1e-5 (the algorithm: float32 sums in other
  orders); bfloat16 one iteration within one bfloat16 ulp of each value
  (``rtol`` 2^-7): both sides read the same bfloat16 features and compute
  in float32, so only a float32 sum that lands at a rounding boundary of
  the bfloat16 output may round the other way (5 of 32,768 values do on
  the gather chain here; the block paths agree bit for bit).
- The FMA chain's plain version gives the value the kernel's FMAs give
  from x = 1 (every step adds one ulp of 1).
- ``main`` at a tiny size prints the reference's lines and writes a record
  with the reference's keys (``docs/ROOFLINE.json``'s, and the gather
  kernel's row), to the path it is given.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mprl_parity import two_torch_threads  # noqa: F401
from relationalgraphlearning_tpu.ops import block_graph as jbg
from relationalgraphlearning_tpu.ops import pallas_block as jpb
from relationalgraphlearning_tpu.ops import sparse as jsp
from relationalgraphlearning_tpu_torch import relation_chain as rc
from relationalgraphlearning_tpu_torch.ops import _build as tbuild
from relationalgraphlearning_tpu_torch.ops import roofline
from relationalgraphlearning_tpu_torch.tools import bench_roofline as br

N, K, D, B, C = 512, 16, 64, 128, 384
ROOT = br.RECORD.parents[2]
BF16_TOL = dict(rtol=2**-7, atol=0)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _problem(sort):
    rng = np.random.RandomState(0)
    pos = rng.uniform(0, 25, (N, 2)).astype(np.float32)
    if sort:
        pos = pos[np.asarray(jbg.spatial_sort(jnp.asarray(pos)))]
    return np.array(jsp.knn_graph(jnp.asarray(pos), K)), \
        rng.randn(N, D).astype(np.float32)


def _norm(h):
    return h / jnp.maximum(jnp.linalg.norm(h, axis=-1, keepdims=True), 1e-6)


def _check(got, want, tag, tdt):
    assert got.dtype == tdt
    tol = dict(rtol=0, atol=1e-5) if tag == "f32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("tag", ["f32", "bf16"])
def test_gather_chain_matches_the_references(tag):
    """``bench_roofline.py:113-122``: sddmm, softmax, spmm with an all-true
    mask, the normalisation, then ``out.astype(dtype)``."""
    jdt, tdt = DTYPES[tag]
    inner = 3 if tag == "f32" else 1
    cols, h0 = _problem(sort=False)
    jc, mask = jnp.asarray(cols), jnp.ones((N, K), bool)
    h = jnp.asarray(h0).astype(jdt)
    for _ in range(inner):
        s = jsp.sddmm_fixed_k(h, h, jc, mask)
        h = _norm(jsp.spmm_fixed_k(jsp.neighbor_softmax(s, mask), h,
                                   jc)).astype(jdt)
    got = rc.run(rc.prepare("gather", torch.from_numpy(cols)),
                 torch.from_numpy(h0).to(tdt), inner)
    _check(got, np.asarray(h, np.float32), tag, tdt)


@pytest.mark.parametrize("tag", ["f32", "bf16"])
@pytest.mark.parametrize("route", ["block_dense", "block"])
def test_block_chain_matches_the_references(route, tag):
    """``:196-206`` (the dense block path, then the normalisation) and
    ``:240-244`` (the fused kernel, stable softmax, l2norm epilogue), one
    iteration each side then ``astype(dtype)``."""
    jdt, tdt = DTYPES[tag]
    cols, h0 = _problem(sort=True)
    jc = jnp.asarray(cols)
    cand, cov = jbg.block_window(jc, B, C)
    assert float(cov) == 1.0
    emask = jbg.block_masks(jc, cand)
    h = jnp.asarray(h0).astype(jdt)
    if route == "block_dense":
        want = _norm(jbg.block_attention(h, h, h, jc, cand, emask=emask))
    else:
        want = jpb.block_attention_pallas(h, h, h, cand,
                                          jpb.pack_emask(emask),
                                          interpret=True, epilogue="l2norm")
    prep = rc.prepare(route, torch.from_numpy(cols), B, C, stable=True)
    got = rc.apply(prep, torch.from_numpy(h0).to(tdt))
    _check(got, np.asarray(want.astype(jdt), np.float32), tag, tdt)


def test_fma_chain_plain_adds_an_ulp_a_step():
    x = torch.ones(64)
    got = roofline.fma_chain(x, fmas=16, passes=4)    # CPU: the plain one
    assert torch.equal(got, torch.full((64,), 1 + 64 * 2.0**-23))
    assert tbuild.launch_counts()["fma_chain"] == 0


def test_main_writes_the_references_record(tmp_path, capsys):
    out = tmp_path / "ROOFLINE.json"
    res, detail = br.main(["--device", "cpu", "--m", "64", "--vpu_n", "256",
                           "--hbm_mb", "1", "--n", "512", "--inner", "2",
                           "--B", "128", "--C", "384", "--out", str(out)])
    lines = [json.loads(s) for s in
             capsys.readouterr().out.strip().splitlines()]
    assert json.loads(out.read_text()) == res
    want = set(json.loads((ROOT / "docs" / "ROOFLINE.json").read_text()))
    assert set(res) == want | {"chain_pallas_gedges_s"}
    assert res["device"] == "cpu"
    metrics = [line["metric"] for line in lines]
    assert metrics[:4] == [f"ceiling {k}" for k in (
        "mxu_f32_tflops", "mxu_bf16_tflops", "vpu_f32_tflops", "hbm_gb_s")]
    assert "TF32 off" in lines[0]["note"]
    assert metrics[4:] == [
        "graph chain (f32, n=512, K=16, d=64)",
        "graph chain (bf16, n=512, K=16, d=64)",
        "HBM-bound speed-of-light (if gathers left chip)",
        "graph chain (windowed dense MXU, f32)",
        "graph chain (windowed dense MXU, bf16)",
        "graph chain (pallas fused block, f32)",
        "graph chain (pallas fused block, bf16)",
        "graph chain (pallas fused)", "written"]
    assert lines[7]["coverage"] == lines[8]["coverage"] == 1.0
    assert detail["vpu_launches"] == {"fma_chain": 0}   # CPU: plain
