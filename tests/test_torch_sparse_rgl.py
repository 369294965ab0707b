"""Port parity: ``SparseValueNet`` against the flax model, weights carried over
by ``convert.py``.

The same seeded crowd and the same flax parameters go through both. The
gather backend is held against flax's gather backend, and the block backend
with a packed mask (the CUDA kernel's plain version here) against flax's
block backend with its uint32 mask (the Pallas kernel in interpret mode, as
the JAX package runs it off a TPU). Tolerance rtol=atol=1e-5: float32 on both
sides, sums in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relationalgraphlearning_tpu.configs.base import GCNConfig as JGCN
from relationalgraphlearning_tpu.models.sparse_rgl import (
    SparseRGL as JRGL, SparseValueNet as JNet)
from relationalgraphlearning_tpu.ops import block_graph as jbg
from relationalgraphlearning_tpu.ops import pallas_block as jpb
from relationalgraphlearning_tpu.ops import sparse as jsp
from relationalgraphlearning_tpu_torch.configs.base import GCNConfig as TGCN
from relationalgraphlearning_tpu_torch.convert import (
    sparse_rgl_from_flax, sparse_value_net_from_flax)
from relationalgraphlearning_tpu_torch.models.sparse_rgl import (
    SparseRGL as TRGL, SparseValueNet as TNet)
from relationalgraphlearning_tpu_torch.ops import block_graph as tbg
from relationalgraphlearning_tpu_torch.ops import fused_block as tfb

TOL = dict(rtol=1e-5, atol=1e-5)
N, K, B, C = 512, 8, 64, 192


def _crowd(seed):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0, 16, (N, 2)).astype(np.float32)
    pos = pos[np.asarray(jbg.spatial_sort(jnp.asarray(pos)))]
    vel = rng.uniform(-1, 1, (N, 2)).astype(np.float32)
    states = np.concatenate([pos, vel, np.full((N, 1), 0.3, np.float32)], -1)
    cols = np.array(jsp.knn_graph(jnp.asarray(pos), K))
    return states, cols


def _nets(backend, states, cols, seed, skip=False, **kw):
    jnet = JNet(JGCN(skip_connection=skip), backend=backend)
    params = jnet.init(jax.random.PRNGKey(seed), jnp.asarray(states),
                       jnp.asarray(cols), **kw)
    tnet = TNet(TGCN(skip_connection=skip), backend=backend)
    tnet.load_state_dict(sparse_value_net_from_flax(
        jax.tree.map(np.asarray, params)))
    return jnet, params, tnet


def test_convert_covers_every_parameter():
    states, cols = _crowd(0)
    _, params, tnet = _nets("gather", states, cols, 1)
    sd = sparse_value_net_from_flax(jax.tree.map(np.asarray, params))
    assert set(sd) == set(tnet.state_dict())
    n_flax = sum(np.asarray(a).size for a in jax.tree.leaves(params))
    assert sum(v.numel() for v in sd.values()) == n_flax
    k = np.asarray(params["params"]["graph_model"]["w_a"]["kernel"])
    np.testing.assert_array_equal(sd["graph_model.w_a.weight"].numpy(), k.T)


@pytest.mark.parametrize("skip", [False, True])
def test_sparse_rgl_from_flax_matches_a_flax_init(skip):
    """A bare SparseRGL tree (as the partitioned forwards take it): every
    parameter carried over, and the forward equal to flax's."""
    states, cols = _crowd(9)
    jrgl = JRGL(JGCN(skip_connection=skip))
    params = jrgl.init(jax.random.PRNGKey(10), jnp.asarray(states),
                       jnp.asarray(cols))
    sd = sparse_rgl_from_flax(jax.tree.map(np.asarray, params))
    trgl = TRGL(TGCN(skip_connection=skip))
    assert set(sd) == set(trgl.state_dict())
    assert sum(v.numel() for v in sd.values()) == sum(
        np.asarray(a).size for a in jax.tree.leaves(params))
    trgl.load_state_dict(sd)
    want = jrgl.apply(params, jnp.asarray(states), jnp.asarray(cols))
    with torch.no_grad():
        got = trgl(torch.from_numpy(states), torch.from_numpy(cols).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_gather_backend_matches_flax(masked, skip):
    states, cols = _crowd(2)
    mask = None
    if masked:
        mask = np.random.RandomState(3).rand(N, K) > 0.25
        mask[:4] = False  # rows with no edge
    jnet, params, tnet = _nets("gather", states, cols, 4, skip)
    want = jnet.apply(params, jnp.asarray(states), jnp.asarray(cols),
                      None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        got = tnet(torch.from_numpy(states), torch.from_numpy(cols).long(),
                   None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("packed", [True, False])
def test_block_backend_matches_flax(packed):
    """Packed: the fused kernels of both sides; bool: plain block_attention
    on both sides. Both equal the gather backend at coverage 1."""
    states, cols = _crowd(5)
    cand, cov = jbg.block_window(jnp.asarray(cols), B, C)
    assert float(cov) == 1.0
    em = jbg.block_masks(jnp.asarray(cols), cand)
    jem = jpb.pack_emask(em) if packed else em
    jnet, params, tnet = _nets("block", states, cols, 6, block_cand=cand,
                               block_emask=jem)
    want = jnet.apply(params, jnp.asarray(states), jnp.asarray(cols),
                      block_cand=cand, block_emask=jem)
    tcols = torch.from_numpy(cols).long()
    tcand = torch.from_numpy(np.array(cand)).long()
    tem = torch.from_numpy(np.array(em))
    if packed:
        tem = tfb.pack_emask(tem)
        assert tem.dtype == torch.int32
    with torch.no_grad():
        got = tnet(torch.from_numpy(states), tcols, block_cand=tcand,
                   block_emask=tem)
        gathered = TNet(TGCN(), backend="gather")
        gathered.load_state_dict(tnet.state_dict())
        ref = gathered(torch.from_numpy(states), tcols)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    torch.testing.assert_close(got, ref, **TOL)


def test_block_backend_builds_mask_when_absent():
    states, cols = _crowd(7)
    tcols = torch.from_numpy(cols).long()
    tcand, cov = tbg.block_window(tcols, B, C)
    assert float(cov) == 1.0
    g = torch.Generator().manual_seed(8)
    net_b = TNet(TGCN(), backend="block", generator=g)
    net_g = TNet(TGCN(), backend="gather")
    net_g.load_state_dict(net_b.state_dict())
    s = torch.from_numpy(states)
    with torch.no_grad():
        torch.testing.assert_close(net_b(s, tcols, block_cand=tcand),
                                   net_g(s, tcols), **TOL)


def test_seeded_init_is_reproducible():
    a = TNet(TGCN(), generator=torch.Generator().manual_seed(3))
    b = TNet(TGCN(), generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


@pytest.mark.parametrize("masked", [False, True])
def test_pallas_backend_matches_flax(masked):
    """backend="pallas": kernel #3's plain chain here, flax's
    ``fused_neighbor_attention`` there, weights converted unchanged (the
    flax tree is the same for every backend). A fully masked row averages
    its neighbours, as the gather chain does."""
    states, cols = _crowd(9)
    mask = None
    if masked:
        mask = np.random.RandomState(11).rand(N, K) > 0.25
        mask[:4] = False
    jnet, params, tnet = _nets("pallas", states, cols, 12)
    want = jnet.apply(params, jnp.asarray(states), jnp.asarray(cols),
                      None if mask is None else jnp.asarray(mask))
    tm = None if mask is None else torch.from_numpy(mask)
    with torch.no_grad():
        got = tnet(torch.from_numpy(states), torch.from_numpy(cols).long(),
                   tm)
        gathered = TNet(TGCN(), backend="gather")
        gathered.load_state_dict(tnet.state_dict())
        ref = gathered(torch.from_numpy(states),
                       torch.from_numpy(cols).long(), tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_block_backend_rejects_mask_beside_emask():
    states, cols = _crowd(10)
    net = TRGL(TGCN(), backend="block")
    tcols = torch.from_numpy(cols).long()
    with pytest.raises(ValueError, match="EITHER"):
        net(torch.from_numpy(states), tcols,
            mask=torch.ones(N, K, dtype=torch.bool),
            block_cand=torch.zeros(N // B, C, dtype=torch.long),
            block_emask=torch.zeros(N // B, B, C, dtype=torch.bool))


@pytest.mark.parametrize("backend", ["gather", "pallas"])
def test_mask_beside_emask_is_taken_off_the_block_backend(backend):
    """Only the block backend reads ``block_emask``, so only it refuses a
    ``mask`` beside one. The gather and pallas backends take both and give
    the result with ``mask`` alone, held against the JAX reference's net
    with the mask. A difference from the reference, which raises on both
    for every backend (``relationalgraphlearning_tpu/models/sparse_rgl.py:
    119-124``, ADVICE r5 #3)."""
    states, cols = _crowd(13)
    mask = np.random.RandomState(14).rand(N, K) > 0.25
    mask[:4] = False
    jnet, params, tnet = _nets(backend, states, cols, 15)
    want = jnet.apply(params, jnp.asarray(states), jnp.asarray(cols),
                      jnp.asarray(mask))
    tcols, tm = torch.from_numpy(cols).long(), torch.from_numpy(mask)
    tcand, _ = tbg.block_window(tcols, B, C)
    tem = tfb.pack_emask(tbg.block_masks(tcols, tcand))
    with torch.no_grad():
        both = tnet(torch.from_numpy(states), tcols, tm, block_cand=tcand,
                    block_emask=tem)
        alone = tnet(torch.from_numpy(states), tcols, tm)
    torch.testing.assert_close(both, alone, rtol=0, atol=0)
    np.testing.assert_allclose(both.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="EITHER"):
        jnet.apply(params, jnp.asarray(states), jnp.asarray(cols),
                   jnp.asarray(mask), block_cand=jnp.asarray(tcand.numpy()),
                   block_emask=jnp.asarray(tem.numpy()))
