"""Port parity: spatial sort, candidate windows, edge masks and the plain
block attention against the JAX package on the same seeded crowds.

Permutations, windows and masks are integers or bools and must be exactly
equal; coverage is the same mean of the same bools. ``block_attention`` is
held at rtol=atol=1e-5: float32 on both sides, sums in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relationalgraphlearning_tpu.ops import block_graph as jbg
from relationalgraphlearning_tpu.ops import sparse as jsp
from relationalgraphlearning_tpu_torch.ops import block_graph as tbg
from relationalgraphlearning_tpu_torch.ops import sparse as tsp

TOL = dict(rtol=1e-5, atol=1e-5)


def _sorted_crowd(n, seed, side=None):
    side = side or 10.0 * (n / 1024) ** 0.5
    pos = np.random.RandomState(seed).uniform(0, side, (n, 2)).astype(
        np.float32)
    perm = np.asarray(jbg.spatial_sort(jnp.asarray(pos)))
    return pos[perm]


@pytest.mark.parametrize("n,seed", [(777, 0), (1024, 1)])
def test_spatial_sort_exact(n, seed):
    pos = np.random.RandomState(seed).normal(0, 30, (n, 2)).astype(np.float32)
    want = np.asarray(jbg.spatial_sort(jnp.asarray(pos)))
    got = tbg.spatial_sort(torch.from_numpy(pos)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,K,B,C", [(1024, 8, 64, 192), (1024, 16, 128, 256),
                                     (512, 8, 64, 48)])
def test_block_window_and_masks_exact(n, K, B, C):
    """The last case overflows its window: coverage < 1 in both."""
    pos = _sorted_crowd(n, 2)
    cols = np.asarray(jsp.knn_graph(jnp.asarray(pos), K))
    cand_j, cov_j = jbg.block_window(jnp.asarray(cols), B, C)
    em_j = jbg.block_masks(jnp.asarray(cols), cand_j)
    tc = torch.from_numpy(np.array(cols)).long()
    cand_t, cov_t = tbg.block_window(tc, B, C)
    em_t = tbg.block_masks(tc, cand_t)
    np.testing.assert_array_equal(cand_t.numpy(), np.asarray(cand_j))
    assert float(cov_t) == float(cov_j)
    np.testing.assert_array_equal(em_t.numpy(), np.asarray(em_j))
    if C == 48:
        assert float(cov_t) < 1.0


def test_block_masks_with_validity_mask_exact():
    n, K, B, C = 512, 8, 64, 192
    pos = _sorted_crowd(n, 3)
    cols = np.asarray(jsp.knn_graph(jnp.asarray(pos), K))
    mask = np.random.RandomState(4).rand(n, K) > 0.3
    cand_j, _ = jbg.block_window(jnp.asarray(cols), B, C)
    want = jbg.block_masks(jnp.asarray(cols), cand_j, jnp.asarray(mask))
    tc = torch.from_numpy(np.array(cols)).long()
    cand_t, _ = tbg.block_window(tc, B, C)
    got = tbg.block_masks(tc, cand_t, torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("masked", [False, True])
def test_block_attention_matches(masked):
    n, K, B, C = 1024, 8, 64, 192
    pos = _sorted_crowd(n, 5)
    cols = np.asarray(jsp.knn_graph(jnp.asarray(pos), K))
    rng = np.random.RandomState(6)
    q, x = (rng.randn(n, 32).astype(np.float32) for _ in range(2))
    v = rng.randn(n, 48).astype(np.float32)
    mask = rng.rand(n, K) > 0.3 if masked else None
    if masked:
        mask[:3] = False  # rows with no edge give zero in both
    cand_j, _ = jbg.block_window(jnp.asarray(cols), B, C)
    want = jbg.block_attention(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(v), jnp.asarray(cols),
        cand_j, mask=None if mask is None else jnp.asarray(mask))
    tc = torch.from_numpy(np.array(cols)).long()
    cand_t, _ = tbg.block_window(tc, B, C)
    got = tbg.block_attention(
        torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(v), tc,
        cand_t, mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if masked:
        assert (got[:3] == 0).all()


def test_build_block_graph_matches():
    pos = np.random.RandomState(7).uniform(0, 12, (512, 2)).astype(np.float32)
    perm_j, cols_j, cand_j, em_j, cov_j = jbg.build_block_graph(
        jnp.asarray(pos), 8, 64, 192, pack=True)
    perm_t, cols_t, cand_t, em_t, cov_t = tbg.build_block_graph(
        torch.from_numpy(pos), 8, 64, 192, pack=True)
    np.testing.assert_array_equal(perm_t.numpy(), np.asarray(perm_j))
    np.testing.assert_array_equal(cols_t.numpy(), np.asarray(cols_j))
    np.testing.assert_array_equal(cand_t.numpy(), np.asarray(cand_j))
    np.testing.assert_array_equal(em_t.numpy(),
                                  np.asarray(em_j).view(np.int32))
    assert float(cov_t) == float(cov_j) == 1.0


def test_knn_then_block_on_port_only_equals_gather():
    """The port's own block path equals its gather chain at coverage 1."""
    pos = torch.from_numpy(_sorted_crowd(1024, 8))
    cols = tsp.knn_graph(pos, 8)
    cand, cov = tbg.block_window(cols, 64, 192)
    assert float(cov) == 1.0
    g = torch.Generator().manual_seed(9)
    h = torch.randn(1024, 32, generator=g)
    got = tbg.block_attention(h, h, h, cols, cand)
    want = tsp.spmm_fixed_k(
        tsp.neighbor_softmax(tsp.sddmm_fixed_k(h, h, cols)), h, cols)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("n,K,B,window,align", [(1024, 8, 128, 512, 8),
                                                (1024, 16, 128, 1024, 16),
                                                (512, 8, 64, 96, 8)])
def test_block_window_aligned_exact(n, K, B, window, align):
    """The last case is too small: coverage < 1 in both."""
    pos = _sorted_crowd(n, 11)
    cols = np.asarray(jsp.knn_graph(jnp.asarray(pos), K))
    st_j, cand_j, cov_j = jbg.block_window_aligned(jnp.asarray(cols), B,
                                                   window, align)
    st_t, cand_t, cov_t = tbg.block_window_aligned(
        torch.from_numpy(np.array(cols)).long(), B, window, align)
    np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j))
    np.testing.assert_array_equal(cand_t.numpy(), np.asarray(cand_j))
    assert float(cov_t) == float(cov_j)
    assert (float(cov_t) < 1.0) == (window == 96)


def test_gather_aligned_matches():
    n, B, align = 512, 64, 8
    pos = _sorted_crowd(n, 12)
    cols = np.asarray(jsp.knn_graph(jnp.asarray(pos), 8))
    starts, _, _ = jbg.block_window_aligned(jnp.asarray(cols), B, 256, align)
    x = np.random.RandomState(13).randn(n, 24).astype(np.float32)
    want = jbg.gather_aligned(jnp.asarray(x), starts, align)
    got = tbg.gather_aligned(torch.from_numpy(x),
                             torch.from_numpy(np.array(starts)).long(), align)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
