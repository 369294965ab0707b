"""Port parity: the mega-crowd rollout against the same loop composed from the
JAX package's functions (a transcription of ``bench_extra.mega_crowd``'s
``rebuild`` and chunk/body scans), on one seeded crowd with the same flax
weights carried over by ``convert.py``.

Positions and velocities are held at atol=1e-4: ORCA's LP branches amplify
float32 rounding from step to step. Per-step value means at atol=1e-4; the
graph artifacts of the last rebuild (permutation-carried agent order,
coverage) must agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relationalgraphlearning_tpu.configs.base import GCNConfig as JGCN
from relationalgraphlearning_tpu.envs.orca import (
    ORCAParams, centralized_orca_step_knn)
from relationalgraphlearning_tpu.models.sparse_rgl import (
    SparseValueNet as JNet)
from relationalgraphlearning_tpu.ops import block_graph as jbg
from relationalgraphlearning_tpu.ops.pallas_block import pack_emask
from relationalgraphlearning_tpu.ops.sparse import knn_graph_auto
from relationalgraphlearning_tpu_torch.configs.base import GCNConfig as TGCN
from relationalgraphlearning_tpu_torch.convert import (
    sparse_value_net_from_flax)
from relationalgraphlearning_tpu_torch.envs import mega_crowd as tmc
from relationalgraphlearning_tpu_torch.envs.mega_crowd import (
    mega_crowd_rollout)
from relationalgraphlearning_tpu_torch.envs.orca import (
    ORCAParams as TORCAParams, centralized_orca_step_knn as torca_knn)
from relationalgraphlearning_tpu_torch.models.sparse_rgl import (
    SparseValueNet as TNet)
from relationalgraphlearning_tpu_torch.ops import _build as tbuild
from relationalgraphlearning_tpu_torch.ops import fused_block

N, K, B, C = 512, 10, 64, 256
ATOL = 1e-4


def _jax_rollout(net, params, pos, steps, R, backend, packed):
    """bench_extra.py mega_crowd's rollout, unrolled as Python loops."""
    n = pos.shape[0]
    use_block = backend == "block"
    vel = jnp.zeros((n, 2))
    goals = -pos
    rad = jnp.full((n,), 0.3)
    vmax = jnp.ones((n,))
    act = jnp.ones((n,), bool)
    oparams = ORCAParams()

    @jax.jit
    def body(pos, vel, goals, rad, vmax, act, cols_gnn, cols_orca, cand, em):
        to = goals - pos
        d = jnp.linalg.norm(to, axis=-1, keepdims=True)
        pref = jnp.where(d > 1e-3, to / jnp.maximum(d, 1e-9), 0.0)
        new_v = centralized_orca_step_knn(pos, vel, rad, pref, vmax, act,
                                          oparams, K, cols=cols_orca)
        new_pos = pos + new_v * 0.25
        states = jnp.concatenate([new_pos, new_v, rad[:, None]], -1)
        vals = net.apply(params, states, cols_gnn,
                         block_cand=cand if use_block else None,
                         block_emask=em if use_block else None)
        return new_pos, new_v, jnp.mean(vals)

    values, covs = [], []
    for _ in range(steps // R):
        if use_block:
            perm = jbg.spatial_sort(pos)
            pos = pos[perm]
            vel, goals, rad, vmax, act = (
                a[perm] for a in (vel, goals, rad, vmax, act))
        cols_gnn = knn_graph_auto(pos, 16)
        cols_orca = knn_graph_auto(pos, K)
        cand = em = None
        cov = 1.0
        if use_block:
            cand, cov = jbg.block_window(cols_gnn, B, C)
            em = jbg.block_masks(cols_gnn, cand)
            if packed:
                em = pack_emask(em)
        covs.append(float(cov))
        for _ in range(R):
            pos, vel, v = body(pos, vel, goals, rad, vmax, act, cols_gnn,
                               cols_orca, cand, em)
            values.append(float(v))
    return np.asarray(pos), np.asarray(vel), np.asarray(values), min(covs)


@pytest.mark.parametrize("backend,packed,steps,R", [
    ("block", True, 4, 2),
    ("gather", False, 2, 1),
])
def test_rollout_matches_jax(backend, packed, steps, R):
    pos0 = np.random.RandomState(0).uniform(-44.7, 44.7, (N, 2)).astype(
        np.float32)
    states0 = jnp.zeros((N, 5))
    cols0 = knn_graph_auto(jnp.asarray(pos0), 16)
    params = JNet(JGCN()).init(jax.random.PRNGKey(1), states0, cols0)
    jnet = JNet(JGCN(), backend=backend)
    want_pos, want_vel, want_vals, want_cov = _jax_rollout(
        jnet, params, jnp.asarray(pos0), steps, R, backend, packed)

    tnet = TNet(TGCN(), backend=backend)
    tnet.load_state_dict(sparse_value_net_from_flax(
        jax.tree.map(np.asarray, params)))
    tbuild.reset_launch_counts()
    (pos, vel), vals, cov = mega_crowd_rollout(
        n=N, K=K, steps=steps, backend=backend, block_B=B, block_C=C,
        rebuild_every=R, packed=packed, pos=torch.from_numpy(pos0),
        net=tnet, device="cpu")

    assert float(cov) == want_cov == 1.0
    assert vals.shape == (steps,)
    np.testing.assert_allclose(pos.numpy(), want_pos, atol=ATOL, rtol=0)
    np.testing.assert_allclose(vel.numpy(), want_vel, atol=ATOL, rtol=0)
    np.testing.assert_allclose(vals.numpy(), want_vals, atol=ATOL, rtol=0)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert sum(tbuild.launch_counts().values()) == 0


def test_rollout_seeded_defaults_are_reproducible():
    """Without ``pos``/``net`` the crowd and the weights come from ``seed``
    through torch.Generators: two runs agree bit for bit."""
    kw = dict(n=256, K=6, steps=2, backend="block", block_B=64, block_C=256,
              rebuild_every=2, packed=True, device="cpu", seed=3)
    (p1, v1), vals1, c1 = mega_crowd_rollout(**kw)
    (p2, v2), vals2, c2 = mega_crowd_rollout(**kw)
    assert torch.equal(p1, p2) and torch.equal(v1, v2)
    assert torch.equal(vals1, vals2) and float(c1) == float(c2)
    assert torch.isfinite(vals1).all() and p1.shape == (256, 2)


def test_rollout_rejects_ragged_chunks():
    with pytest.raises(ValueError, match="multiple"):
        mega_crowd_rollout(n=64, steps=3, rebuild_every=2, device="cpu")


def _eager_loop(pos, K, steps, backend, block_B, block_C, R, packed, net):
    """The rollout as the port ran it before ``MegaCrowdRollout``: one
    Python loop over the chunks and their steps, each step's mean value
    stacked at the end."""
    n = pos.shape[0]
    goals, vel = -pos, torch.zeros((n, 2))
    rad, vmax = torch.full((n,), 0.3), torch.ones((n,))
    act = torch.ones((n,), dtype=torch.bool)
    values, covs = [], []
    with torch.no_grad():
        for _ in range(steps // R):
            pos, (vel, goals, rad, vmax, act), cols_gnn, cols_orca, cand, \
                em, cov = tmc.rebuild(pos, (vel, goals, rad, vmax, act), K,
                                      backend, block_B, block_C, packed)
            covs.append(cov)
            for _ in range(R):
                to = goals - pos
                d = torch.linalg.norm(to, dim=-1, keepdim=True)
                pref = torch.where(d > 1e-3, to / torch.clamp(d, min=1e-9),
                                   0.0)
                vel = torca_knn(pos, vel, rad, pref, vmax, act, TORCAParams(),
                                K, cols=cols_orca)
                pos = pos + vel * tmc.DT
                states = torch.cat([pos, vel, rad[:, None]], dim=-1)
                values.append(net(states, cols_gnn, block_cand=cand,
                                  block_emask=em).mean())
    return (pos, vel), torch.stack(values), torch.stack(covs).amin()


@pytest.mark.parametrize("backend,packed", [("block", True),
                                            ("pallas", False),
                                            ("gather", False)])
def test_runner_on_cpu_is_the_eager_loop(backend, packed):
    """``MegaCrowdRollout`` with ``graphed=None`` captures on the card only:
    on the CPU its chunks equal the former Python loop bit for bit, also
    when one runner rolls two crowds; ``graphed=True`` raises there."""
    kw = dict(K=6, backend=backend, block_B=64, block_C=256,
              rebuild_every=2, packed=packed)
    net = TNet(TGCN(), backend=backend,
               generator=torch.Generator().manual_seed(2)).eval()
    runner = tmc.MegaCrowdRollout(**kw, net=net, device="cpu")
    assert runner.graphed is False
    for seed in (0, 1):
        pos0 = tmc.initial_crowd(256, seed=seed, device="cpu")
        (p, v), vals, cov = runner(pos0, 4)
        (pw, vw), valw, covw = _eager_loop(pos0, 6, 4, backend, 64, 256, 2,
                                           packed, net)
        for got, want in ((p, pw), (v, vw), (vals, valw), (cov, covw)):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        (pm, vm), valm, _ = mega_crowd_rollout(n=256, steps=4, pos=pos0,
                                               net=net, device="cpu", **kw)
        torch.testing.assert_close(valm, valw, rtol=0, atol=0)
        torch.testing.assert_close(pm, pw, rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        tmc.MegaCrowdRollout(**kw, net=net, device="cpu", graphed=True)(
            tmc.initial_crowd(256, device="cpu"), 2)
