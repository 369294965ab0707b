"""Port parity: the per-edge gather kernel's plain version (kernel #3, behind
``SparseRGL(backend="pallas")``) against the JAX package's entry point
``pallas_graph.fused_neighbor_attention`` and its fixed-K chain, which is
what the JAX package's own tests hold it to (the Pallas kernel of
``tools/probe_mosaic_gather.py`` has no interpret switch and does not
compile off a TPU).

The chain's semantics, which the block kernels do not share, are named
cases here: a fully masked row averages its neighbours uniformly, and a
duplicate neighbour counts once per occurrence. Tolerance rtol=atol=1e-5:
float32 on both sides, sums in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relationalgraphlearning_tpu.ops import sparse as jsp
from relationalgraphlearning_tpu.ops.pallas_graph import (
    fused_neighbor_attention as jfna)
from relationalgraphlearning_tpu_torch.ops import _build as tbuild
from relationalgraphlearning_tpu_torch.ops import fused_gather as tfg

TOL = dict(rtol=1e-5, atol=1e-5)


def _problem(n=512, K=12, d=32, dv=32, seed=0):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0, 25, (n, 2)).astype(np.float32)
    cols = np.array(jsp.knn_graph(jnp.asarray(pos), K))
    q, x = (rng.randn(n, d).astype(np.float32) for _ in range(2))
    v = rng.randn(n, dv).astype(np.float32)
    return q, x, v, cols, rng


def _both(q, x, v, cols, mask):
    want = jfna(jnp.asarray(q), jnp.asarray(x), jnp.asarray(v),
                jnp.asarray(cols), None if mask is None else jnp.asarray(mask))
    got = tfg.fused_neighbor_attention(
        torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(v),
        torch.from_numpy(cols).long(),
        None if mask is None else torch.from_numpy(mask))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("dv", [32, 48])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_matches_jax_entry_point(masked, dv):
    q, x, v, cols, rng = _problem(dv=dv, seed=1)
    mask = None
    if masked:
        mask = rng.rand(*cols.shape) > 0.3
        mask[:4] = False   # fully masked rows
    got, want = _both(q, x, v, cols, mask)
    np.testing.assert_allclose(got, want, **TOL)
    if masked:
        # the chain's semantics: a fully masked row is the uniform average
        # of v over its cols (the block kernels give 0 there)
        np.testing.assert_allclose(got[:4], v[cols[:4]].mean(1), **TOL)


def test_duplicate_neighbours_count_with_multiplicity():
    q, x, v, cols, _ = _problem(seed=2)
    cols[:, 1] = cols[:, 0]       # every row sees neighbour 0 twice
    got, want = _both(q, x, v, cols, None)
    np.testing.assert_allclose(got, want, **TOL)
    # the block mask is a set: dropping the duplicate changes the row
    alt, _ = _both(q, x, v, np.concatenate([cols[:, :1], cols[:, 2:]], 1),
                   None)
    assert np.abs(alt - got).max() > 1e-3


def test_mask_none_is_every_edge_valid():
    q, x, v, cols, _ = _problem(seed=3)
    tq, tx, tv = map(torch.from_numpy, (q, x, v))
    tc = torch.from_numpy(cols).long()
    torch.testing.assert_close(
        tfg.fused_gather_attention(tq, tx, tv, tc),
        tfg.fused_gather_attention(tq, tx, tv, tc,
                                   torch.ones(cols.shape, dtype=torch.bool)),
        rtol=0, atol=0)


def test_plain_is_the_port_chain_and_the_jax_chain():
    q, x, v, cols, rng = _problem(n=256, K=8, d=16, dv=24, seed=4)
    mask = rng.rand(*cols.shape) > 0.2
    jm = jnp.asarray(mask)
    want = jsp.spmm_fixed_k(jsp.neighbor_softmax(jsp.sddmm_fixed_k(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(cols), jm), jm),
        jnp.asarray(v), jnp.asarray(cols))
    got = tfg.fused_gather_attention_plain(
        torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(v),
        torch.from_numpy(cols).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("bad", [-1, 512])
def test_out_of_range_ids_raise(bad):
    q, x, v, cols, _ = _problem(seed=5)
    tc = torch.from_numpy(cols).long()
    tc[7, 3] = bad
    with pytest.raises(ValueError, match="outside"):
        tfg.fused_gather_attention(torch.from_numpy(q), torch.from_numpy(x),
                                   torch.from_numpy(v), tc)


def test_cpu_tensors_launch_nothing():
    tbuild.reset_launch_counts()
    q, x, v, cols, _ = _problem(n=128, K=4, seed=6)
    tfg.fused_neighbor_attention(torch.from_numpy(q), torch.from_numpy(x),
                                 torch.from_numpy(v),
                                 torch.from_numpy(cols).long())
    assert tbuild.launch_counts()["fused_gather_attention"] == 0
