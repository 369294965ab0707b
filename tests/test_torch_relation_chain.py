"""Port parity: the loop-carried relation-edge chain, three iterations a route,
against the same chain composed from the JAX package's ops on the same graph
and seed features (the loop bodies of ``bench_extra.py:76-190`` and
``bench_roofline.py:99-130``; ``bench_extra.py`` itself is not imported).

Each route's artifacts are made by the JAX package's own functions on the
JAX side and by the port's on the port's side. The kernels run as the JAX
package's tests run them on the CPU: Pallas in interpret mode for the block
and chunk routes; ``pallas_graph.fused_neighbor_attention`` (its chain) for
the gather kernel. The reference's chunk kernel assumes g = 2, so the d = 32
route (g = 4) is held against its plain block attention, as
``tools/probe_chunk_d32.py`` holds its kernel. Tolerance atol=2e-5 (the
tolerance of ``tests/test_pallas_chunk.py``): float32, three iterations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relationalgraphlearning_tpu.ops import block_graph as jbg
from relationalgraphlearning_tpu.ops import pallas_block as jpb
from relationalgraphlearning_tpu.ops import sparse as jsp
from relationalgraphlearning_tpu.ops.pallas_chunk import (
    chunk_block_attention as jcba, chunk_window as jcw)
from relationalgraphlearning_tpu.ops.pallas_graph import (
    fused_neighbor_attention as jfna)
from relationalgraphlearning_tpu_torch import relation_chain as trc

N, K, B, C, INNER = 1024, 16, 128, 448, 3
ATOL = 2e-5


def _graph():
    pos = np.random.RandomState(0).uniform(0, 35, (N, 2)).astype(np.float32)
    pos = pos[np.asarray(jbg.spatial_sort(jnp.asarray(pos)))]
    return np.array(jsp.knn_graph(jnp.asarray(pos), K))


def _norm(h):
    return h / jnp.maximum(jnp.linalg.norm(h, axis=-1, keepdims=True), 1e-6)


def _jax_chain(route, h, cols):
    """The route's loop body from JAX ops, ``INNER`` times."""
    jc = jnp.asarray(cols)
    if route == "block":
        cand, cov = jbg.block_window(jc, B, C)
        bits = jpb.pack_emask(jbg.block_masks(jc, cand))
    elif route == "chunk":
        starts, tail, bits, cov = jcw(jc, B)
    elif route in ("chunk_d32", "block_dense"):
        cand, cov = jbg.block_window(jc, B, C)
    for _ in range(INNER):
        if route == "gather":
            s = jsp.sddmm_fixed_k(h, h, jc)
            h = _norm(jsp.spmm_fixed_k(jsp.neighbor_softmax(s), h, jc))
        elif route == "gather_kernel":
            h = _norm(jfna(h, h, h, jc))
        elif route == "block":
            h = jpb.block_attention_pallas(h, h, h, cand, bits,
                                           interpret=True, epilogue="l2norm",
                                           stable=False)
        elif route == "chunk":
            h = jcba(h, h, starts, tail, bits, interpret=True,
                     epilogue="l2norm", stable=False)
        else:
            h = _norm(jbg.block_attention(h, h, h, jc, cand))
    return np.asarray(h), float(cov) if route in (
        "block", "block_dense", "chunk", "chunk_d32") else 1.0


@pytest.mark.parametrize("route", list(trc.ROUTES))
def test_chain_matches_jax_composition(route):
    cols = _graph()
    d = 32 if route == "chunk_d32" else 64
    h0 = trc.seed_features(N, d, seed=3, device="cpu")
    want, want_cov = _jax_chain(route, jnp.asarray(h0.numpy()), cols)
    got, cov = trc.relation_chain(h0, torch.from_numpy(cols).long(), route,
                                  inner=INNER, B=B, C=C)
    assert float(cov) == want_cov == 1.0
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # unit rows out, the unshifted softmax's precondition for the next step
    np.testing.assert_allclose(got.norm(dim=1).numpy(), 1.0, atol=1e-5)


def test_routes_agree_and_chain_is_seeded():
    """All the routes are one function at coverage 1; the graph and the
    features come from ``seed`` alone."""
    cols = trc.crowd_graph(1024, K, side=35.0, seed=4, device="cpu")
    assert torch.equal(cols, trc.crowd_graph(1024, K, side=35.0, seed=4,
                                             device="cpu"))
    h0 = trc.seed_features(1024, 32, seed=5, device="cpu")
    ref, _ = trc.relation_chain(h0, cols, "gather", inner=4, B=B, C=C)
    for route in trc.ROUTES[1:]:
        got, cov = trc.relation_chain(h0, cols, route, inner=4, B=B, C=C)
        assert float(cov) == 1.0
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_unknown_route_raises():
    with pytest.raises(ValueError, match="route"):
        trc.prepare("dense", torch.zeros(256, 4, dtype=torch.long))


@pytest.mark.parametrize("route", list(trc.ROUTES))
def test_runner_on_cpu_is_the_eager_loop(route):
    """``runner`` with ``graphed=None`` captures on the card only: on CPU
    tensors it is ``run``, bit for bit, and ``graphed=True`` raises."""
    cols = trc.crowd_graph(1024, K, side=35.0, seed=6, device="cpu")
    d = 32 if route == "chunk_d32" else 64
    h0 = trc.seed_features(1024, d, seed=7, device="cpu")
    prep = trc.prepare(route, cols, B, C)
    f = trc.runner(prep, h0, 3)
    torch.testing.assert_close(f(h0), trc.run(prep, h0, 3), rtol=0, atol=0)
    torch.testing.assert_close(trc.runner(prep, h0, 3, graphed=False)(h0),
                               trc.run(prep, h0, 3), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        trc.runner(prep, h0, 3, graphed=True)
