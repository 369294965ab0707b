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
