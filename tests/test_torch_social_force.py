"""The port's social force step against the JAX package's, one crowd and a
batch of crowds (the batched CrowdSim's shape) at atol 1e-5 (float32, the
exponentials and sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from relationalgraphlearning_tpu.envs import social_force as jsf
from relationalgraphlearning_tpu_torch.envs import social_force as tsf

ATOL = 1e-5


def _crowds(B, n, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    active = rng.random((B, n)) > 0.2
    return (rng.uniform(-3, 3, (B, n, 2)).astype(f32),
            rng.uniform(-1, 1, (B, n, 2)).astype(f32),
            rng.uniform(0.3, 0.5, (B, n)).astype(f32),
            rng.uniform(-1, 1, (B, n, 2)).astype(f32),
            rng.uniform(0.5, 1.5, (B, n)).astype(f32), active)


def test_sfm_step_matches_jax():
    arrs = _crowds(16, 6, 0)
    step = jax.jit(jax.vmap(lambda *xs: jsf.centralized_sfm_step(
        *xs, jsf.SFMParams(), 0.25)))
    want = np.asarray(step(*map(jnp.asarray, arrs)))
    got = tsf.centralized_sfm_step(*map(torch.from_numpy, arrs),
                                   tsf.SFMParams(), 0.25).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert (got[~arrs[-1]] == 0).all()
    one = tsf.centralized_sfm_step(*(torch.from_numpy(a[3]) for a in arrs),
                                   tsf.SFMParams(), 0.25).numpy()
    np.testing.assert_allclose(one, got[3], rtol=0, atol=ATOL)
