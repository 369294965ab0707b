"""Port parity: the partitioned graph construction and mega-crowd rollout
(``parallel/partitioned_build.py``) on 4 ranks against the JAX package's on a
``make_mesh(data=4)`` mesh of the virtual CPU devices, at the shapes of the
JAX package's ``tests/test_partitioned_build.py`` (600 agents, n_cap 256,
B=64, C=256, K=8, K_orca=6, 8 steps, R=2), weights carried over by
``convert.py``.

One chunk's migration, sort and build must agree exactly (slab contents,
``eidx``, ``colvalid``, ``cand``, the mask bits, the counters and both
coverages); the rollouts agree per agent (matched by ``aid``) at atol 1e-4,
the reference's limit (ORCA's LP branches amplify float32 rounding), and the
port's rollout equals its own single-device loop at the same limit. Two
tests name the port's fixes of the reference (ADVICE r5 #1 and #4) and show
both readings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from relationalgraphlearning_tpu.configs.base import GCNConfig as JGCN
from relationalgraphlearning_tpu.envs.orca import ORCAParams as JORCA
from relationalgraphlearning_tpu.models.sparse_rgl import (
    SparseValueNet as JNet)
from relationalgraphlearning_tpu.ops.sparse import knn_graph as jknn
from relationalgraphlearning_tpu.parallel import partitioned_build as jpb
from relationalgraphlearning_tpu.parallel.mesh import make_mesh as jmesh
from relationalgraphlearning_tpu_torch.configs.base import GCNConfig as TGCN
from relationalgraphlearning_tpu_torch.convert import (
    sparse_value_net_from_flax)
from relationalgraphlearning_tpu_torch.envs.orca import ORCAParams as TORCA
from relationalgraphlearning_tpu_torch.models.sparse_rgl import (
    SparseValueNet as TNet)
from relationalgraphlearning_tpu_torch.ops.sparse import knn_graph
from relationalgraphlearning_tpu_torch.parallel import partitioned_build as tpb
from relationalgraphlearning_tpu_torch.parallel.mesh import (
    REP, ROW, make_mesh)

D = 4
K, K_ORCA, B, C = 8, 6, 64, 256
STEPS, R, DT = 8, 2, 0.25
ATOL = 1e-4                 # tests/test_partitioned_build.py:99-102
SPEC = dict(D=D, n_cap=256, x0=-24.0, band_w=12.0, y0=-24.0, cell=3.0,
            grid_w=64, B=B, C=C, K=K, K_orca=K_ORCA, mig_cap=32, dt=DT)
GRID = dict(SPEC, cell=6.0, grid_knn=True, grid_max_per_cell=64)
OUTS = ("shards", "eidx", "colvalid", "cand", "mbits", "band_cov",
        "win_cov", "overflow", "lost")


def _crowd(n=600, seed=0):
    k1, _ = jax.random.split(jax.random.PRNGKey(seed))
    pos = np.asarray(jax.random.uniform(k1, (n, 2), minval=-23.5,
                                        maxval=23.5))
    return (pos, np.zeros((n, 2), np.float32), -pos,
            np.full((n,), 0.3, np.float32), np.ones((n,), np.float32))


@pytest.fixture(scope="module")
def jax_mesh():
    return jmesh(data=D, model=1, devices=jax.devices()[:D])


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(data=D, device="cpu")


def _flax_params(pos, vel, rad, gcn=None, k=K):
    states = np.concatenate([pos, vel, rad[:, None]], -1)
    return JNet(gcn or JGCN(), backend="gather").init(
        jax.random.PRNGKey(1), jnp.asarray(states), jknn(jnp.asarray(pos), k))


def _torch_net(params, skip=False):
    net = TNet(TGCN(skip_connection=skip), backend="block")
    net.load_state_dict(sparse_value_net_from_flax(
        jax.tree.map(np.asarray, params)))
    return net.eval()


def _shards_np(sh):
    return {k: np.asarray(v) for k, v in zip(sh._fields, sh)}


def _jax_shards(arrays):
    return jpb.CrowdShards(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _torch_shards(arrays):
    return tpb.CrowdShards(**{k: torch.from_numpy(np.array(v))
                              for k, v in arrays.items()})


# --------------------------------------------------------- one chunk's build
def _jax_chunk(jax_mesh, spec, arrays):
    def body(sh):
        sh, mig = jpb._migrate(sh, spec, "data")
        sh = jpb._local_sort(sh, spec)
        (eidx, colvalid, cand, mbits, _, _, _, band_cov,
         win_cov) = jpb._build_graph(sh, spec, "data")
        return (sh, eidx, colvalid, cand, mbits, band_cov, win_cov,
                jax.lax.psum(mig["overflow"], "data"),
                jax.lax.psum(mig["lost"], "data"))

    rows = jpb.CrowdShards(*([P("data")] * 7))
    fn = shard_map(body, mesh=jax_mesh, in_specs=(rows,),
                   out_specs=(rows,) + (P("data"),) * 4 + (P(),) * 4,
                   check_vma=False)
    return dict(zip(OUTS, jax.jit(fn)(_jax_shards(arrays))))


def _torch_rank_chunk(comm, spec, sh):
    sh, mig = tpb._migrate(comm, sh, spec)
    sh = tpb._local_sort(sh, spec)
    (eidx, colvalid, cand, mbits, _, _, _, band_cov,
     win_cov) = tpb._build_graph(comm, sh, spec)
    return (sh, eidx, colvalid, cand, mbits, band_cov, win_cov,
            comm.psum(mig["overflow"]), comm.psum(mig["lost"]))


def _torch_chunk(mesh, spec, arrays):
    out = mesh.run(lambda comm, sh: _torch_rank_chunk(comm, spec, sh),
                   row_sharded=(_torch_shards(arrays),),
                   out_specs=(ROW,) * 5 + (REP,) * 4)
    return dict(zip(OUTS, out))


def _moved_shards(spec_kw, shift, seed=3):
    """The crowd placed in its bands, then moved by up to ``shift`` in x:
    agents near a band edge want to migrate."""
    pos, vel, goal, rad, vmax = _crowd()
    sh = _shards_np(jpb.init_crowd_shards(pos, vel, goal, rad, vmax,
                                          jpb.BandSpec(**spec_kw)))
    rng = np.random.RandomState(seed)
    dx = rng.uniform(-shift, shift, size=sh["pos"].shape[0])
    sh["pos"] = sh["pos"].copy()
    sh["pos"][:, 0] += np.where(sh["active"], dx, 0.0).astype(np.float32)
    return sh


def test_init_crowd_shards_matches_jax():
    pos, vel, goal, rad, vmax = _crowd()
    want = _shards_np(jpb.init_crowd_shards(pos, vel, goal, rad, vmax,
                                            jpb.BandSpec(**SPEC)))
    got = tpb.init_crowd_shards(pos, vel, goal, rad, vmax,
                                tpb.BandSpec(**SPEC), device="cpu")
    for k, v in want.items():
        np.testing.assert_array_equal(getattr(got, k).numpy(), v, err_msg=k)
    small = dict(SPEC, n_cap=128)
    with pytest.raises(ValueError, match="> n_cap=128") as jerr:
        jpb.init_crowd_shards(pos, vel, goal, rad, vmax,
                              jpb.BandSpec(**small))
    with pytest.raises(ValueError, match="> n_cap=128") as terr:
        tpb.init_crowd_shards(pos, vel, goal, rad, vmax,
                              tpb.BandSpec(**small), device="cpu")
    assert str(jerr.value) == str(terr.value)


@pytest.mark.parametrize("mig_cap", [32, 4])
@pytest.mark.parametrize("kw", [SPEC, GRID], ids=["dense", "grid_knn"])
def test_one_chunk_build_matches_jax(jax_mesh, mesh, kw, mig_cap):
    """Migration (with overflow at mig_cap=4), the local sort and the build
    of one chunk, per rank: every artifact bit for bit."""
    kw = dict(kw, mig_cap=mig_cap)
    arrays = _moved_shards(kw, shift=2.5)
    want = _jax_chunk(jax_mesh, jpb.BandSpec(**kw), arrays)
    got = _torch_chunk(mesh, tpb.BandSpec(**kw), arrays)
    for k, v in _shards_np(want["shards"]).items():
        np.testing.assert_array_equal(getattr(got["shards"], k).numpy(), v,
                                      err_msg=k)
    for k in ("eidx", "colvalid", "cand"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(
        got["mbits"].numpy(), np.asarray(want["mbits"]).view(np.int32))
    for k in ("band_cov", "win_cov", "overflow", "lost"):
        assert float(got[k]) == float(want[k]), k
    assert float(got["win_cov"]) == 1.0 and int(got["lost"]) == 0
    # the path ran: agents changed ranks; with 4 slots some had to stay
    home = np.arange(D * kw["n_cap"]) // kw["n_cap"]
    act = arrays["active"]
    before = dict(zip(arrays["aid"][act], home[act]))
    after_act = got["shards"].active.numpy()
    after = dict(zip(got["shards"].aid.numpy()[after_act], home[after_act]))
    assert sorted(after) == sorted(before)
    assert sum(before[a] != after[a] for a in before) > 0
    assert (int(got["overflow"]) > 0) == (mig_cap == 4)


# --------------------------------------------------------------- rollouts
def _aid_matched(sh):
    active = np.asarray(sh.active)
    aid = np.asarray(sh.aid)[active]
    order = np.argsort(aid)
    return (aid[order], np.asarray(sh.pos)[active][order],
            np.asarray(sh.vel)[active][order])


@pytest.mark.parametrize("kw", [SPEC, GRID], ids=["dense", "grid_knn"])
def test_partitioned_mega_rollout_matches_jax(jax_mesh, mesh, kw):
    pos, vel, goal, rad, vmax = _crowd()
    params = _flax_params(pos, vel, rad)
    jspec = jpb.BandSpec(**kw)
    run = jpb.partitioned_mega_rollout(
        jax_mesh, jspec, JNet(JGCN(), backend="block"), params, JORCA(),
        STEPS, R)
    with jax_mesh:
        jsh, jdiag = jax.jit(run)(jpb.init_crowd_shards(pos, vel, goal, rad,
                                                        vmax, jspec))
    tspec = tpb.BandSpec(**kw)
    net = _torch_net(params)
    tsh, tdiag = tpb.partitioned_mega_rollout(mesh, tspec, net, TORCA(),
                                              STEPS, R)(
        tpb.init_crowd_shards(pos, vel, goal, rad, vmax, tspec,
                              device="cpu"))
    for k in ("band_cov", "win_cov", "overflow", "lost"):
        assert float(tdiag[k]) == float(jdiag[k]), k
    assert float(tdiag["band_cov"]) == 1.0 and float(tdiag["win_cov"]) == 1.0
    assert int(tdiag["overflow"]) == 0 and int(tdiag["lost"]) == 0
    assert abs(float(tdiag["vmean"]) - float(jdiag["vmean"])) < 1e-5
    jaid, jpos, jvel = _aid_matched(jsh)
    taid, tpos, tvel = _aid_matched(tsh)
    np.testing.assert_array_equal(taid, np.arange(pos.shape[0]))
    np.testing.assert_array_equal(taid, jaid)
    np.testing.assert_allclose(tpos, jpos, atol=ATOL)
    np.testing.assert_allclose(tvel, jvel, atol=ATOL)

    # and the port's own one-device loop (dense kNN, kNN ORCA, the gather
    # value net), as the reference's test holds its rollout
    gnet = TNet(TGCN(), backend="gather")
    gnet.load_state_dict(net.state_dict())
    t = {k: torch.from_numpy(np.array(v)) for k, v in
         dict(pos=pos, vel=vel, goal=goal, rad=rad, vmax=vmax).items()}
    rpos, rvel, rvmean = tpb.single_device_rollout(
        gnet.eval(), t["pos"], t["vel"], t["goal"], t["rad"], t["vmax"],
        TORCA(), STEPS, R, K, K_ORCA, DT)
    np.testing.assert_allclose(tpos, rpos.numpy(), atol=ATOL)
    np.testing.assert_allclose(tvel, rvel.numpy(), atol=ATOL)
    assert abs(float(tdiag["vmean"]) - float(rvmean)) < ATOL


def test_migration_conserves_agents(jax_mesh, mesh):
    """Agents streaming across the band edges (the reference's test):
    none is lost, identity survives, the port places them as JAX does."""
    n = 96
    pos = np.stack([np.linspace(-11.0, 11.0, n), np.zeros(n)],
                   -1).astype(np.float32)
    vel = np.zeros((n, 2), np.float32)
    rad = np.full((n,), 0.1, np.float32)
    vmax = np.ones((n,), np.float32)
    kw = dict(D=D, n_cap=64, x0=-12.0, band_w=6.0, y0=-12.0, cell=1.5,
              grid_w=64, B=32, C=128, K=4, K_orca=4, mig_cap=24, dt=0.25)
    params = _flax_params(pos, vel, rad, k=4)
    jspec = jpb.BandSpec(**kw)
    run = jpb.partitioned_mega_rollout(
        jax_mesh, jspec, JNet(JGCN(), backend="block"), params, JORCA(),
        steps=16, rebuild_every=2)
    with jax_mesh:
        jsh, jdiag = jax.jit(run)(jpb.init_crowd_shards(pos, vel, -pos, rad,
                                                        vmax, jspec))
    tspec = tpb.BandSpec(**kw)
    tsh, tdiag = tpb.partitioned_mega_rollout(
        mesh, tspec, _torch_net(params), TORCA(), steps=16,
        rebuild_every=2)(tpb.init_crowd_shards(pos, vel, -pos, rad, vmax,
                                               tspec, device="cpu"))
    assert int(tdiag["overflow"]) == 0 and int(tdiag["lost"]) == 0
    active = tsh.active.numpy()
    aid = tsh.aid.numpy()[active]
    assert sorted(aid.tolist()) == list(range(n))
    np.testing.assert_array_equal(tsh.aid.numpy(), np.asarray(jsh.aid))
    np.testing.assert_allclose(tsh.pos.numpy(), np.asarray(jsh.pos),
                               atol=ATOL)
    # an agent sits at most one band from its rank (it may have crossed
    # in the last chunk), and some agents now live on another rank
    band = ((tsh.pos.numpy()[active][:, 0] - kw["x0"])
            // kw["band_w"]).astype(int)
    home = (np.arange(len(active)) // kw["n_cap"])[active]
    assert np.abs(band - home).max() <= 1
    init_band = np.clip(((pos[aid, 0] - kw["x0"]) // kw["band_w"])
                        .astype(int), 0, D - 1)
    assert (home != init_band).sum() > 0


# ------------------------------------------------ the port's two fixes
def test_band_coverage_counts_agents_short_of_k(jax_mesh, mesh):
    """ADVICE r5 #1, fixed in the port only. Three agents in band 0, bands
    1 and 2 empty, 100 agents in band 3: a band-0 agent has 2 neighbours in
    reach, while its true 8 nearest include band-3 agents two bands away.
    The reference reads its k-th radius as 0 and counts it covered
    (band_cov 1.0); the port counts it short (band_cov 100/103)."""
    rng = np.random.RandomState(11)
    pos = np.concatenate([
        np.stack([rng.uniform(-23.5, -22.0, 3), rng.uniform(-1, 1, 3)], -1),
        np.stack([rng.uniform(13.0, 23.5, 100), rng.uniform(-20, 20, 100)],
                 -1)]).astype(np.float32)
    n = pos.shape[0]
    kw = dict(D=D, n_cap=128, x0=-24.0, band_w=12.0, y0=-24.0, cell=3.0,
              grid_w=64, B=32, C=128, K=8, K_orca=4, mig_cap=16)
    arrays = _shards_np(jpb.init_crowd_shards(
        pos, np.zeros_like(pos), -pos, np.full(n, 0.3, np.float32),
        np.ones(n, np.float32), jpb.BandSpec(**kw)))
    want = _jax_chunk(jax_mesh, jpb.BandSpec(**kw), arrays)
    got = _torch_chunk(mesh, tpb.BandSpec(**kw), arrays)
    assert float(want["band_cov"]) == 1.0                  # the reference
    assert float(got["band_cov"]) == pytest.approx(100 / 103, abs=1e-7)
    # the same graph in both; rank 0's agents have 2 valid columns
    np.testing.assert_array_equal(got["eidx"].numpy(),
                                  np.asarray(want["eidx"]))
    short = got["colvalid"].numpy()[:3]
    assert (short.sum(1) == 2).all()
    # ...while their true 8 nearest (one device, all 103 agents) include
    # agents of band 3, out of the partitioned graph's reach
    true = knn_graph(torch.from_numpy(pos), 8).numpy()[:3]
    assert (pos[true][..., 0] > 0.0).any(axis=1).all()


def _rank_values(comm, spec, net, sh):
    sh = tpb._local_sort(sh, spec)
    eidx, colvalid, cand, mbits, *_ = tpb._build_graph(comm, sh, spec)
    states = torch.cat([sh.pos, sh.vel, sh.rad[:, None]], -1)
    with torch.no_grad():
        vals = tpb._value_net_fullshard(comm, net, states, cand, mbits)
    gid = (comm.rank - 1) * spec.n_cap + eidx
    own = comm.rank * spec.n_cap + torch.arange(spec.n_cap)
    cols = torch.where(colvalid, gid, own[:, None])
    return sh, states, cols, colvalid, cand, mbits, vals


def test_value_net_honours_skip_connection(jax_mesh, mesh):
    """ADVICE r5 #4, fixed in the port only: with ``skip_connection=True``
    the port's full-slab value net equals ``SparseValueNet`` with the skip,
    on the same graph; the reference's equals it without the skip."""
    pos, vel, goal, rad, vmax = _crowd()
    spec = tpb.BandSpec(**SPEC)
    params = _flax_params(pos, vel, rad)
    arrays = _shards_np(jpb.init_crowd_shards(pos, vel, goal, rad, vmax,
                                              jpb.BandSpec(**SPEC)))
    outs = {}
    for skip in (False, True):
        outs[skip] = mesh.run(
            lambda comm, sh, skip=skip: _rank_values(
                comm, spec, _torch_net(params, skip), sh),
            row_sharded=(_torch_shards(arrays),))
    sh, states, cols, colvalid, cand, mbits, _ = outs[True]
    active = sh.active.numpy()
    for skip in (False, True):
        one = TNet(TGCN(skip_connection=skip), backend="gather")
        one.load_state_dict(_torch_net(params).state_dict())
        with torch.no_grad():
            want = one.eval()(states, cols, colvalid).numpy()[active]
        np.testing.assert_allclose(outs[skip][-1].numpy()[active], want,
                                   rtol=1e-5, atol=1e-5)

    jnet = JNet(JGCN(skip_connection=True), backend="block")
    fn = shard_map(
        lambda st, c, m: jpb._value_net_fullshard(jnet, params, st, c, m,
                                                  "data"),
        mesh=jax_mesh, in_specs=(P("data"),) * 3, out_specs=P("data"),
        check_vma=False)
    ref = np.asarray(jax.jit(fn)(jnp.asarray(states.numpy()),
                                 jnp.asarray(cand.numpy()),
                                 jnp.asarray(mbits.numpy().view(np.uint32))))
    # the reference with skip_connection=True reads as the port without it
    np.testing.assert_allclose(ref[active], outs[False][-1].numpy()[active],
                               rtol=1e-5, atol=1e-5)
    assert np.abs(ref[active] - outs[True][-1].numpy()[active]).max() > 1e-2
