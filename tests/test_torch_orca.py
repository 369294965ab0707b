"""Port parity: batched ORCA against the JAX package and the sequential oracle.

The same seeded numpy crowds go through both. Tolerance atol=1e-5: float32 on
both sides; the port batches the line-pair 1-D LPs up front and reduces them
with exact min/max, so values differ only by the rounding of the shared
arithmetic. The oracle (float64) check keeps the JAX test's own bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relationalgraphlearning_tpu.envs import orca as jorca
from relationalgraphlearning_tpu_torch.envs import orca as torca

PARAMS_J = jorca.ORCAParams()
PARAMS_T = torca.ORCAParams()
ATOL = 1e-5


def _agents(rng, n, M, spread):
    """n agents each against M neighbours; `spread` small → many colliding
    pairs and infeasible LPs (linearProgram3)."""
    f32 = np.float32
    return dict(
        p_i=rng.uniform(-spread, spread, (n, 2)).astype(f32),
        v_i=rng.uniform(-1, 1, (n, 2)).astype(f32),
        r_i=np.full(n, 0.3, f32),
        pref=rng.uniform(-1, 1, (n, 2)).astype(f32),
        vmax=np.ones(n, f32),
        p_j=rng.uniform(-spread, spread, (n, M, 2)).astype(f32),
        v_j=rng.uniform(-1, 1, (n, M, 2)).astype(f32),
        r_j=np.full((n, M), 0.3, f32),
        valid=rng.rand(n, M) > 0.15)


_ORDER = ("p_i", "v_i", "r_i", "pref", "vmax", "p_j", "v_j", "r_j", "valid")


def _n_infeasible(a):
    """Agents whose 2-D LP fails, so that linearProgram3 decides them."""
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    pts, dirs, lv = torca.orca_lines(t["p_i"], t["v_i"], t["r_i"], t["p_j"],
                                     t["v_j"], t["r_j"], t["valid"], PARAMS_T)
    _, fail = torca._linear_program2(pts, dirs, lv, t["vmax"], t["pref"],
                                     False)
    return int((fail < pts.shape[-2]).sum())


@pytest.mark.parametrize("spread,seed", [(4.0, 0), (2.0, 2)])
def test_orca_velocity_matches_jax(spread, seed):
    a = _agents(np.random.RandomState(seed), 256, 10, spread)
    f = jax.jit(jax.vmap(lambda *xs: jorca.orca_velocity(*xs, PARAMS_J)))
    want = np.asarray(f(*(jnp.asarray(a[k]) for k in _ORDER)))
    got = torca.orca_velocity(*(torch.from_numpy(a[k]) for k in _ORDER),
                              PARAMS_T).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert _n_infeasible(a) > 10  # linearProgram3 is exercised


@pytest.mark.parametrize("spread,seed", [(1.0, 1), (1.5, 2), (2.5, 3)])
def test_orca_velocity_matches_jax_float64_pileups(spread, seed):
    """Pile-ups of overlapping agents: linearProgram3 projects nearly
    parallel lines, and float32 rounding grows there to ~1e-3 in EITHER
    implementation (both sit that far from a float64 run). In float64 the
    two agree to 1e-9, so the arithmetic is the same."""
    a = _agents(np.random.RandomState(seed), 256, 10, spread)
    a = {k: v.astype(np.float64) if v.dtype == np.float32 else v
         for k, v in a.items()}
    with jax.enable_x64(True):
        f = jax.jit(jax.vmap(lambda *xs: jorca.orca_velocity(*xs, PARAMS_J)))
        want = np.asarray(f(*(jnp.asarray(a[k]) for k in _ORDER)))
    assert want.dtype == np.float64
    got = torca.orca_velocity(*(torch.from_numpy(a[k]) for k in _ORDER),
                              PARAMS_T).numpy()
    np.testing.assert_allclose(got, want, atol=1e-9, rtol=0)
    assert _n_infeasible(a) > 50


def test_orca_velocity_matches_sequential_oracle():
    """The JAX test's fuzz (60 random agents against 1-8 neighbours), run
    batched through the port: at most one float32-vs-float64 boundary flip."""
    from orca_oracle import orca_np

    rng = np.random.RandomState(7)
    mismatches = 0
    for _ in range(60):
        m = rng.randint(1, 9)
        pi, vi = rng.uniform(-4, 4, 2), rng.uniform(-1, 1, 2)
        pref = rng.uniform(-1, 1, 2)
        pj, vj = rng.uniform(-4, 4, (m, 2)), rng.uniform(-1, 1, (m, 2))
        rj = np.full(m, 0.3)
        want = orca_np(pi, vi, 0.3, pref, 1.0, pj, vj, rj,
                       PARAMS_T.time_horizon, PARAMS_T.time_step)
        t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32)
        got = torca.orca_velocity(t(pi), t(vi), t(0.3), t(pref), t(1.0),
                                  t(pj), t(vj), t(rj),
                                  torch.ones(m, dtype=torch.bool), PARAMS_T)
        if not np.allclose(got.numpy(), want, atol=2e-3):
            mismatches += 1
    assert mismatches <= 1, f"{mismatches}/60 oracle mismatches"


def _crowd(n, seed, side):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-side, side, (n, 2)).astype(np.float32)
    vel = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    pref = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    rad = np.full(n, 0.3, np.float32)
    vmax = np.ones(n, np.float32)
    act = np.ones(n, bool)
    act[::13] = False  # inactive agents: zero velocity, invisible
    return pos, vel, rad, pref, vmax, act


@pytest.mark.parametrize("n,seed,side", [(64, 2, 3.0), (48, 3, 6.0)])
def test_centralized_orca_step_knn_matches_jax(n, seed, side):
    arrs = _crowd(n, seed, side)
    want = np.asarray(jax.jit(
        lambda *xs: jorca.centralized_orca_step_knn(*xs, PARAMS_J, 10))(
            *map(jnp.asarray, arrs)))
    got = torca.centralized_orca_step_knn(
        *map(torch.from_numpy, arrs), PARAMS_T, 10).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert (got[~arrs[-1]] == 0).all()


def test_centralized_orca_step_matches_jax():
    arrs = _crowd(24, 4, 3.0)
    want = np.asarray(jax.jit(
        lambda *xs: jorca.centralized_orca_step(*xs, PARAMS_J))(
            *map(jnp.asarray, arrs)))
    got = torca.centralized_orca_step(*map(torch.from_numpy, arrs),
                                      PARAMS_T).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_knn_matches_allpairs_small():
    """As tests/test_orca_knn.py: with max_neighbors >= n-1 the kNN variant
    is exactly all-pairs."""
    rng = np.random.RandomState(0)
    n = 6
    pos = torch.from_numpy(rng.uniform(-4, 4, (n, 2)).astype(np.float32))
    vel = torch.from_numpy(rng.uniform(-1, 1, (n, 2)).astype(np.float32))
    rad = torch.full((n,), 0.3)
    pref = torch.from_numpy(rng.uniform(-1, 1, (n, 2)).astype(np.float32))
    vmax = torch.ones(n)
    act = torch.ones(n, dtype=torch.bool)
    v_all = torca.centralized_orca_step(pos, vel, rad, pref, vmax, act,
                                        PARAMS_T)
    v_knn = torca.centralized_orca_step_knn(pos, vel, rad, pref, vmax, act,
                                            PARAMS_T, max_neighbors=n - 1)
    np.testing.assert_allclose(v_knn.numpy(), v_all.numpy(), atol=1e-5)


def test_centralized_orca_step_takes_env_dims():
    """[B, n, 2] crowds (the batched CrowdSim's ORCA step) against the
    reference's step vmapped over envs."""
    crowds = [_crowd(6, 4, 3.0 - 0.5 * b) for b in range(8)]
    arrs = [np.stack(parts) for parts in zip(*crowds)]
    want = np.asarray(jax.jit(jax.vmap(
        lambda *xs: jorca.centralized_orca_step(*xs, PARAMS_J)))(
            *map(jnp.asarray, arrs)))
    got = torca.centralized_orca_step(*map(torch.from_numpy, arrs),
                                      PARAMS_T).numpy()
    assert got.shape == (8, 6, 2)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
