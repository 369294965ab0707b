"""Port parity: kNN graphs and the fixed-K attention chain against the JAX
package on the same seeded inputs.

Graphs are integer artifacts and must be exactly equal. The chain is held at
rtol=atol=1e-5: both sides compute in float32, but the two frameworks sum
the dot products and the softmax in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relationalgraphlearning_tpu.ops import sparse as jsp
from relationalgraphlearning_tpu_torch.ops import sparse as tsp

TOL = dict(rtol=1e-5, atol=1e-5)


def _crowd(n, seed, side=30.0):
    return np.random.RandomState(seed).uniform(0, side, (n, 2)).astype(
        np.float32)


@pytest.mark.parametrize("n,k,seed", [(256, 8, 0), (1024, 16, 1)])
def test_knn_graph_exact(n, k, seed):
    pos = _crowd(n, seed)
    want = np.asarray(jsp.knn_graph(jnp.asarray(pos), k))
    got = tsp.knn_graph(torch.from_numpy(pos), k).numpy()
    np.testing.assert_array_equal(got, want)


def test_knn_graphs_are_contiguous():
    """The kernels take contiguous ids; the exact kNN once returned a
    strided view of its sort."""
    pos = torch.from_numpy(_crowd(256, 12))
    assert tsp.knn_graph(pos, 8).is_contiguous()
    assert tsp.knn_graph_grid(pos, 8, 3.0, 16).is_contiguous()


def test_knn_graph_valid_mask_exact():
    pos = _crowd(300, 2)
    valid = np.random.RandomState(3).rand(300) > 0.2
    want = np.asarray(jsp.knn_graph(jnp.asarray(pos), 10,
                                    valid=jnp.asarray(valid)))
    got = tsp.knn_graph(torch.from_numpy(pos), 10,
                        valid=torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,k,cell,per_cell", [(1024, 10, 2.0, 16),
                                               (1024, 16, 3.0, 32),
                                               (512, 8, 1.0, 8)])
def test_knn_graph_grid_exact(n, k, cell, per_cell):
    """Including a crowded case (cell 3.0, 32 per cell) and a sparse one
    (cell 1.0) where some nodes see fewer than k candidates and the inf ties
    must break as JAX's top_k breaks them."""
    pos = _crowd(n, 4)
    want = np.asarray(jsp.knn_graph_grid(jnp.asarray(pos), k, cell, per_cell))
    got = tsp.knn_graph_grid(torch.from_numpy(pos), k, cell, per_cell).numpy()
    np.testing.assert_array_equal(got, want)


def test_knn_graph_auto_grid_branch_exact():
    """Grid branch with the density-derived cell size (threshold lowered)."""
    pos = _crowd(1024, 5, side=40.0)
    want = np.asarray(jsp.knn_graph_auto(jnp.asarray(pos), 16,
                                         grid_threshold=0))
    got = tsp.knn_graph_auto(torch.from_numpy(pos), 16,
                             grid_threshold=0).numpy()
    np.testing.assert_array_equal(got, want)
    exact = tsp.knn_graph(torch.from_numpy(pos), 16).numpy()
    # near-uniform crowd: the grid graph is the exact graph
    np.testing.assert_array_equal(np.sort(got, 1), np.sort(exact, 1))


@pytest.mark.parametrize("masked", [False, True])
def test_fixed_k_chain_matches(masked):
    rng = np.random.RandomState(6)
    n, k, d = 512, 12, 32
    pos = _crowd(n, 7)
    cols = np.asarray(jsp.knn_graph(jnp.asarray(pos), k))
    q, x, v = (rng.randn(n, d).astype(np.float32) for _ in range(3))
    mask = rng.rand(n, k) > 0.3 if masked else None
    if masked:
        mask[:5] = False  # fully masked rows average uniformly in both
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    want = jsp.spmm_fixed_k(
        jsp.neighbor_softmax(jsp.sddmm_fixed_k(
            jnp.asarray(q), jnp.asarray(x), jnp.asarray(cols), jm), jm),
        jnp.asarray(v), jnp.asarray(cols))
    tc = torch.from_numpy(np.array(cols)).long()
    got = tsp.spmm_fixed_k(
        tsp.neighbor_softmax(tsp.sddmm_fixed_k(
            torch.from_numpy(q), torch.from_numpy(x), tc, tm), tm),
        torch.from_numpy(v), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _edge_problem(seed, n=256, k=8, d=16, dv=24):
    rng = np.random.RandomState(seed)
    cols = np.asarray(jsp.knn_graph(jnp.asarray(_crowd(n, seed)), k))
    q, x = (rng.randn(n, d).astype(np.float32) for _ in range(2))
    v = rng.randn(n, dv).astype(np.float32)
    return q, x, v, cols, rng


def test_fixed_k_to_edges_exact():
    cols = np.asarray(jsp.knn_graph(jnp.asarray(_crowd(100, 8)), 6))
    rj, cj = jsp.fixed_k_to_edges(jnp.asarray(cols))
    rt, ct = tsp.fixed_k_to_edges(torch.from_numpy(np.array(cols)).long())
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


@pytest.mark.parametrize("masked", [False, True])
def test_edge_list_chain_matches(masked):
    """sddmm_edges → segment_softmax → spmm_edges, with rows that have no
    valid edge (their max is not finite until the mask fills it; they give
    zero) and rows with no edge at all (segment of length 0)."""
    q, x, v, cols, rng = _edge_problem(9)
    n = q.shape[0]
    rows, flat = (np.asarray(a) for a in
                  jsp.fixed_k_to_edges(jnp.asarray(cols)))
    keep = rows >= 3              # rows 0-2 have no edge in the list
    rows, flat = rows[keep], flat[keep]
    valid = rng.rand(rows.size) > 0.3 if masked else None
    if masked:
        valid[rows == 5] = False  # a row whose every edge is invalid
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.from_numpy(valid)
    s_j = jsp.sddmm_edges(jnp.asarray(q), jnp.asarray(x), jnp.asarray(rows),
                          jnp.asarray(flat), jv)
    a_j = jsp.segment_softmax(s_j, jnp.asarray(rows), n, jv)
    o_j = jsp.spmm_edges(a_j, jnp.asarray(v), jnp.asarray(rows),
                         jnp.asarray(flat), n)
    tr, tc = torch.from_numpy(rows).long(), torch.from_numpy(flat).long()
    s_t = tsp.sddmm_edges(torch.from_numpy(q), torch.from_numpy(x), tr, tc,
                          tv)
    a_t = tsp.segment_softmax(s_t, tr, n, tv)
    o_t = tsp.spmm_edges(a_t, torch.from_numpy(v), tr, tc, n)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **TOL)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), **TOL)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)
    assert (o_t[:3] == 0).all()
    if masked:
        assert (o_t[5] == 0).all()


def test_edge_list_equals_fixed_k_chain():
    q, x, v, cols, _ = _edge_problem(10)
    n = q.shape[0]
    tq, tx, tv = map(torch.from_numpy, (q, x, v))
    tc = torch.from_numpy(np.array(cols)).long()
    rows, flat = tsp.fixed_k_to_edges(tc)
    out_e = tsp.spmm_edges(tsp.segment_softmax(
        tsp.sddmm_edges(tq, tx, rows, flat), rows, n), tv, rows, flat, n)
    out_k = tsp.spmm_fixed_k(tsp.neighbor_softmax(
        tsp.sddmm_fixed_k(tq, tx, tc)), tv, tc)
    torch.testing.assert_close(out_e, out_k, **TOL)


def test_dense_adjacency_matches():
    """Duplicate neighbours add up, as the reference's scatter-add does."""
    q, x, _, cols, rng = _edge_problem(11, n=64, k=5)
    cols = np.array(cols)
    cols[:, 1] = cols[:, 0]
    vals = rng.rand(*cols.shape).astype(np.float32)
    want = jsp.dense_adjacency(jnp.asarray(vals), jnp.asarray(cols), 64)
    got = tsp.dense_adjacency(torch.from_numpy(vals),
                              torch.from_numpy(cols).long(), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
