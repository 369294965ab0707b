"""Port parity: the node-partitioned aggregation (``parallel/graph_partition
.py``) on 4 ranks against the JAX package's on a ``make_mesh(data=4)`` mesh of
the virtual CPU devices, weights carried over by ``convert.py``.

Function by function at rtol 1e-5 / atol 1e-6 (float32 on both sides, sums
in another order); the whole forward also against the port's single-device
``SparseRGL`` at the reference's own limit for that comparison (rtol 2e-4 /
atol 2e-5, ``tests/test_parallel.py``). The JAX side runs under ``jax.jit``;
its Pallas kernels run in interpret mode on the CPU, as the JAX package runs
them there. On the CPU the port's kernel wrappers run their plain versions,
so no kernel launches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from relationalgraphlearning_tpu.configs.base import GCNConfig as JGCN
from relationalgraphlearning_tpu.models.sparse_rgl import SparseRGL as JRGL
from relationalgraphlearning_tpu.ops import block_graph as jbg
from relationalgraphlearning_tpu.ops import sparse as jsp
from relationalgraphlearning_tpu.ops.pallas_block import pack_emask as jpack
from relationalgraphlearning_tpu.parallel import graph_partition as jgp
from relationalgraphlearning_tpu.parallel.mesh import make_mesh as jmesh
from relationalgraphlearning_tpu_torch.configs.base import GCNConfig as TGCN
from relationalgraphlearning_tpu_torch.convert import sparse_rgl_from_flax
from relationalgraphlearning_tpu_torch.models.sparse_rgl import (
    SparseRGL as TRGL)
from relationalgraphlearning_tpu_torch.ops import _build as tbuild
from relationalgraphlearning_tpu_torch.ops import fused_block as tfb
from relationalgraphlearning_tpu_torch.parallel import graph_partition as tgp
from relationalgraphlearning_tpu_torch.parallel.comm import run_local
from relationalgraphlearning_tpu_torch.parallel.mesh import (
    make_mesh, split_rows)

D = 4
FN_TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_TOL = dict(rtol=2e-4, atol=2e-5)   # tests/test_parallel.py:42,99


def _torch_rgl(params, backend="gather"):
    m = TRGL(TGCN(), backend=backend)
    m.load_state_dict(sparse_rgl_from_flax(jax.tree.map(np.asarray, params)))
    return m.eval()


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


@pytest.fixture(scope="module")
def jax_mesh():
    return jmesh(data=D, model=1, devices=jax.devices()[:D])


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(data=D, device="cpu")


# ----------------------------------------------------- ring and all-gather
SPARSE_CASES = {
    # n, K, positions scale, masked: 256 rows split evenly, 254 are padded
    # (tests/test_parallel.py), 35 = 8·4 + 3 is the dryrun's own size
    "even": (256, 8, 5.0, False),
    "masked_padded": (254, 8, 5.0, True),
    "dryrun": (8 * D + 3, 4, 10.0, False),
}


@pytest.fixture(scope="module")
def sparse_cases(jax_mesh):
    out = {}
    for name, (n, K, scale, masked) in SPARSE_CASES.items():
        rng = np.random.RandomState(n)
        states = rng.normal(size=(n, 5)).astype(np.float32)
        cols = np.asarray(jsp.knn_graph(jnp.asarray(states[:, :2] * scale),
                                        K))
        mask = None
        if masked:
            mask = rng.rand(n, K) > 0.25
            mask[:, 0] = True
        params = JRGL(JGCN()).init(jax.random.PRNGKey(1),
                                   jnp.asarray(states), jnp.asarray(cols))
        want = {}
        for method in ("ring", "allgather"):
            fn = jax.jit(lambda p, s, c, m, method=method:
                         jgp.partitioned_sparse_rgl(
                             p, JGCN(), s, c, jax_mesh, mask=m,
                             method=method))
            want[method] = np.asarray(fn(
                params, jnp.asarray(states), jnp.asarray(cols),
                None if mask is None else jnp.asarray(mask)))
        out[name] = (states, cols, mask, params, want)
    return out


@pytest.mark.parametrize("method", ["ring", "allgather"])
@pytest.mark.parametrize("case", list(SPARSE_CASES))
def test_partitioned_sparse_rgl_matches_jax_and_one_device(
        sparse_cases, mesh, method, case):
    states, cols, mask, params, want = sparse_cases[case]
    model = _torch_rgl(params)
    tmask = None if mask is None else _t(mask)
    with torch.no_grad():
        got = tgp.partitioned_sparse_rgl(model, _t(states), _t(cols,
                                                               torch.long),
                                         mesh, mask=tmask, method=method)
        single = model(_t(states), _t(cols, torch.long), tmask)
    assert got.shape == (states.shape[0], TGCN().final_state_dim)
    np.testing.assert_allclose(got.numpy(), want[method], **FN_TOL)
    np.testing.assert_allclose(got.numpy(), single.numpy(), **MODEL_TOL)


def test_ring_with_a_separate_value_table(jax_mesh, mesh):
    """``v`` not ``x``: two tables circulate, as in the reference."""
    rng = np.random.RandomState(5)
    n, K, d = 64, 6, 8
    q, x, v = (rng.normal(size=(n, w)).astype(np.float32)
               for w in (d, d, 12))
    cols = rng.randint(0, n, size=(n, K))
    mask = rng.rand(n, K) > 0.3
    mask[:3] = False                       # rows with no edge end as 0
    fn = shard_map(lambda q, x, v, c, m: jgp.ring_neighbor_attention(
        q, x, v, c, m, "data"), mesh=jax_mesh, in_specs=(P("data"),) * 5,
        out_specs=P("data"), check_vma=False)
    want = np.asarray(jax.jit(fn)(q, x, v, jnp.asarray(cols), mask))
    got = mesh.run(lambda comm, *a: tgp.ring_neighbor_attention(comm, *a),
                   row_sharded=(_t(q), _t(x), _t(v), _t(cols, torch.long),
                                _t(mask)))
    np.testing.assert_allclose(got.numpy(), want, **FN_TOL)
    assert (got[:3] == 0).all()


# ------------------------------------------------------ the block halo path
@pytest.fixture(scope="module")
def block_case():
    """tests/test_parallel.py's block set-up: 4096 sorted agents, K=8,
    B=64, C=224; the halo reach (~520 rows) stays under 1024 rows/rank."""
    n, K, B, C = 4096, 8, 64, 224
    pos = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (n, 2)) * 30)
    pos = pos[np.asarray(jbg.spatial_sort(jnp.asarray(pos)))]
    states = np.concatenate([pos, np.zeros((n, 2)), np.full((n, 1), 0.3)],
                            -1).astype(np.float32)
    cols = jsp.knn_graph(jnp.asarray(pos), K)
    cand, cov = jbg.block_window(cols, B, C)
    assert float(cov) == 1.0
    emask = jbg.block_masks(cols, cand)
    params = JRGL(JGCN(), backend="block").init(
        jax.random.PRNGKey(1), jnp.asarray(states), cols, block_cand=cand,
        block_emask=emask)
    halo = -(-jgp.halo_reach(cand, B, n // D) // 8) * 8
    assert 0 < halo < n // D
    return dict(n=n, B=B, states=states, cols=np.asarray(cols),
                cand=np.asarray(cand), emask=np.asarray(emask),
                packed=np.asarray(jpack(emask)), params=params, halo=halo)


def test_halo_reach_matches_jax(block_case):
    cand, B, n = block_case["cand"], block_case["B"], block_case["n"]
    for d in (1, 2, 4, 8):
        assert tgp.halo_reach(_t(cand), B, n // d) == jgp.halo_reach(
            jnp.asarray(cand), B, n // d)


@pytest.mark.parametrize("halo", [3, 64, 256])
def test_halo_exchange_matches_jax(jax_mesh, mesh, halo):
    """Including halo == n_loc, the full-adjacent-slab exchange."""
    rng = np.random.RandomState(halo)
    x = rng.normal(size=(D * 256, 5)).astype(np.float32)
    fn = shard_map(lambda a: jgp.halo_exchange(a, "data", halo),
                   mesh=jax_mesh, in_specs=(P("data"),),
                   out_specs=P("data"), check_vma=False)
    want = np.asarray(jax.jit(fn)(x))
    got = mesh.run(lambda comm, a: tgp.halo_exchange(comm, a, halo),
                   row_sharded=(_t(x),))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("halo", [0, -8])
def test_halo_exchange_needs_a_positive_halo(mesh, halo):
    with pytest.raises(ValueError, match="needs halo > 0"):
        mesh.run(lambda comm, a: tgp.halo_exchange(comm, a, halo),
                 row_sharded=(torch.zeros(D * 8, 2),))


def _features(n, seed):
    """Unit-norm q and x rows (|score| <= 1, so float32 rounding of a score
    moves no softmax weight by 1e-6) and a normal value table."""
    rng = np.random.RandomState(seed)
    q, x = (rng.normal(size=(n, 32)).astype(np.float32) for _ in range(2))
    return (q / np.linalg.norm(q, axis=1, keepdims=True),
            x / np.linalg.norm(x, axis=1, keepdims=True),
            rng.normal(size=(n, 24)).astype(np.float32))


def _jax_halo(jax_mesh, q, x, v, cand, emask, halo, shared):
    if shared:
        body = (lambda q, x, c, e: jgp.block_halo_attention(
            q, x, x, c, e, "data", halo))
        args = (q, x, cand, emask)
    else:
        body = (lambda q, x, v, c, e: jgp.block_halo_attention(
            q, x, v, c, e, "data", halo))
        args = (q, x, v, cand, emask)
    fn = shard_map(body, mesh=jax_mesh, in_specs=(P("data"),) * len(args),
                   out_specs=P("data"), check_vma=False)
    return np.asarray(jax.jit(fn)(*args))


@pytest.mark.parametrize("mask_kind", ["bool", "packed_shared",
                                       "packed_separate"])
def test_block_halo_attention_matches_jax(jax_mesh, mesh, block_case,
                                          mask_kind):
    """A bool mask runs the block math; a packed mask with ``v is x`` kernel
    #1's plain twin, with a separate ``v`` kernel #2's."""
    q, x, v = _features(block_case["n"], 7)
    cand, halo = block_case["cand"], block_case["halo"]
    shared = mask_kind != "packed_separate"
    jm = block_case["emask"] if mask_kind == "bool" else block_case["packed"]
    tm = (_t(jm) if mask_kind == "bool"
          else _t(jm.view(np.int32)))
    want = _jax_halo(jax_mesh, q, x, v, jnp.asarray(cand), jnp.asarray(jm),
                     halo, shared)
    tbuild.reset_launch_counts()
    tq, tx, tv, tc = _t(q), _t(x), _t(v), _t(cand, torch.long)
    if shared:
        got = mesh.run(lambda comm, q, x, c, e: tgp.block_halo_attention(
            comm, q, x, x, c, e, halo), row_sharded=(tq, tx, tc, tm))
    else:
        got = mesh.run(lambda comm, *a: tgp.block_halo_attention(
            comm, *a, halo), row_sharded=(tq, tx, tv, tc, tm))
    np.testing.assert_allclose(got.numpy(), want, **FN_TOL)
    assert not any(tbuild.launch_counts().values())   # CPU: plain versions


@pytest.mark.parametrize("halo", ["reach", 8])
@pytest.mark.parametrize("mask_kind", ["bool", "packed"])
def test_halo_kernel_args_point_at_the_global_candidates(block_case,
                                                         mask_kind, halo):
    """What the halo path hands kernels #1 and #2 on each rank: every slot
    whose mask survives reads the row of its global candidate from the
    exchanged table, and a slot outside the table (the sentinel, or past a
    halo below the reach, on either side) has every mask bit cleared."""
    n, B = block_case["n"], block_case["B"]
    halo = block_case["halo"] if halo == "reach" else halo
    cand = _t(block_case["cand"], torch.long)
    emask = (_t(block_case["emask"]) if mask_kind == "bool"
             else _t(block_case["packed"].view(np.int32)))
    rows = torch.arange(n, dtype=torch.float32)[:, None]   # row i holds i
    parts = [split_rows(t, D) for t in (rows, cand, emask)]

    def rank_args(comm):
        x, c, e = (p[comm.rank] for p in parts)
        return tgp.halo_kernel_args(comm, x, x, x, c, e, halo)

    for r, (qb, x_ext, v_ext, localc, m) in enumerate(run_local(D,
                                                                rank_args)):
        c = parts[1][r]
        assert qb.shape == (c.shape[0], B, 1) and v_ext is x_ext
        assert x_ext.shape[0] == n // D + 2 * halo
        live = (m != 0).any(dim=1)                          # [nb_loc, C]
        assert torch.equal(x_ext[localc][..., 0][live],
                           c[live].to(torch.float32))
        ok = (c >= r * (n // D) - halo) & (c < (r + 1) * (n // D) + halo)
        assert not (m != 0).any(dim=1)[~ok].any()
        keep = ok[:, None, :] if mask_kind == "bool" else torch.where(
            ok, -1, 0).to(torch.int32)[:, None, :]
        assert torch.equal(m, parts[2][r] & keep)


def test_block_halo_attention_halo_rules(jax_mesh, mesh, block_case):
    """halo > n_loc raises; halo == 0 skips the exchange (out-of-rank
    candidates are masked off) and equals the reference's reading."""
    n = block_case["n"]
    q, x, _ = _features(n, 8)
    cand, packed = block_case["cand"], block_case["packed"]
    args = (_t(q), _t(x), _t(cand, torch.long), _t(packed.view(np.int32)))

    def run(halo):
        return mesh.run(lambda comm, q, x, c, e: tgp.block_halo_attention(
            comm, q, x, x, c, e, halo), row_sharded=args)

    with pytest.raises(ValueError, match="exceeds the adjacent shard"):
        run(n // D + 8)
    want = _jax_halo(jax_mesh, q, x, None, jnp.asarray(cand),
                     jnp.asarray(packed), 0, True)
    np.testing.assert_allclose(run(0).numpy(), want, **FN_TOL)
    want = _jax_halo(jax_mesh, q, x, None, jnp.asarray(cand),
                     jnp.asarray(packed), n // D, True)
    np.testing.assert_allclose(run(n // D).numpy(), want, **FN_TOL)


@pytest.mark.parametrize("scale", ["unit", "reference"])
@pytest.mark.parametrize("packed", [False, True])
def test_partitioned_block_rgl_matches_jax_and_one_device(
        jax_mesh, mesh, block_case, packed, scale):
    """On the reference's own states (positions up to 30 m) layer-1 scores
    reach the hundreds, where float32 rounding of a score moves a softmax
    weight by ~1e-5: there the port is held to JAX at the reference's limit
    for this path (rtol 2e-4 / atol 2e-5, ``tests/test_parallel.py:99``).
    The same graph with the positions in a unit box holds at 1e-5 / 1e-6."""
    c = block_case
    states = c["states"].copy()
    if scale == "unit":
        states[:, :2] /= 30.0
    jm = c["packed"] if packed else c["emask"]
    fn = jax.jit(lambda p, s, cd, e: jgp.partitioned_block_rgl(
        p, JGCN(), s, cd, e, jax_mesh, halo=c["halo"]))
    want = np.asarray(fn(c["params"], jnp.asarray(states),
                         jnp.asarray(c["cand"]), jnp.asarray(jm)))
    model = _torch_rgl(c["params"], backend="block")
    tm = _t(jm.view(np.int32)) if packed else _t(jm)
    tstates, cand = _t(states), _t(c["cand"], torch.long)
    with torch.no_grad():
        got = tgp.partitioned_block_rgl(model, tstates, cand, tm, mesh,
                                        c["halo"])
        single = model(tstates, _t(c["cols"], torch.long), block_cand=cand,
                       block_emask=tm)
    np.testing.assert_allclose(got.numpy(), want,
                               **(FN_TOL if scale == "unit" else MODEL_TOL))
    np.testing.assert_allclose(got.numpy(), single.numpy(), **MODEL_TOL)


def test_partitioned_block_rgl_refuses_rows_that_do_not_split(block_case):
    c = block_case
    model = _torch_rgl(c["params"], backend="block")
    with pytest.raises(ValueError, match="do not split over D=3"):
        tgp.partitioned_block_rgl(
            model, _t(c["states"]), _t(c["cand"], torch.long),
            _t(c["emask"]), make_mesh(data=3, device="cpu"), c["halo"])
