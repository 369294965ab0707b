"""The port's native ORCA (``runtime/native_orca.py``): ``native/orca/
orca.cpp`` built with g++ into the port's build directory, bound by ctypes.

- Against the JAX package's ``orca_step_batch_native`` (the committed
  library of the same source) at the reference's atol 1e-6
  (``tests/test_native_orca.py:69``).
- Against the port's own solver (``envs/orca.py``) at the reference's
  tolerance for two independent float32 implementations (median |diff| <
  1e-3, max < 5e-2, ``tests/test_native_orca.py:35-37``).
- Inactive agents, the speed clamp and the safety space as the reference
  tests them; ``NativeORCA`` on tensors equals the host call.

Without a C++ compiler the tests skip, as the reference's do.
"""

import numpy as np
import pytest
import torch

from relationalgraphlearning_tpu.runtime import (
    native_orca_available as jax_native_available,
    orca_step_batch_native as jax_native)
from relationalgraphlearning_tpu_torch.envs.orca import (
    ORCAParams, centralized_orca_step)
from relationalgraphlearning_tpu_torch.runtime.native_orca import (
    NativeORCA, native_orca_available, orca_step_batch_native)

pytestmark = pytest.mark.skipif(
    not native_orca_available(), reason="native toolchain unavailable")


def _random_scene(B=4, n=6, seed=0):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-4, 4, (B, n, 2)).astype(np.float32)
    vel = rng.uniform(-1, 1, (B, n, 2)).astype(np.float32)
    rad = np.full((B, n), 0.3, np.float32)
    pref = rng.uniform(-1, 1, (B, n, 2)).astype(np.float32)
    vmax = np.ones((B, n), np.float32)
    act = np.ones((B, n), np.uint8)
    return pos, vel, rad, pref, vmax, act


@pytest.mark.parametrize("seed, safety", [(0, 0.0), (1, 0.1), (2, 0.0)])
def test_native_matches_the_jax_packages_binding(seed, safety):
    if not jax_native_available():
        pytest.skip("the JAX package's native library is unavailable")
    scene = _random_scene(B=8, n=6, seed=seed)
    scene[-1][:, -1] = seed % 2          # some inactive agents
    got = orca_step_batch_native(*scene, safety_space=safety)
    want = jax_native(*scene, safety_space=safety)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("seed", [0, 3])
def test_native_matches_the_ports_solver(seed):
    pos, vel, rad, pref, vmax, act = _random_scene(seed=seed)
    out_c = orca_step_batch_native(pos, vel, rad, pref, vmax, act)
    out_t = centralized_orca_step(
        *(torch.from_numpy(a) for a in (pos, vel, rad, pref, vmax)),
        torch.from_numpy(act.astype(bool)), ORCAParams()).numpy()
    diff = np.abs(out_c - out_t)
    assert np.median(diff) < 1e-3
    assert diff.max() < 5e-2, f"max diff {diff.max()}"


def test_native_safety_space_and_inactive():
    pos, vel, rad, pref, vmax, act = _random_scene(seed=1)
    act[:, -1] = 0
    out = orca_step_batch_native(pos, vel, rad, pref, vmax, act,
                                 safety_space=0.1)
    np.testing.assert_array_equal(out[:, -1], 0.0)
    assert np.all(np.isfinite(out))
    assert np.linalg.norm(out, axis=-1).max() <= 1.0 + 1e-4


def test_native_orca_on_tensors_equals_the_host_call():
    scene = _random_scene(B=2)
    solver = NativeORCA(safety_space=0.05)
    out = solver(*(torch.from_numpy(a) for a in scene[:5]),
                 torch.from_numpy(scene[5].astype(bool)))
    ref = orca_step_batch_native(*scene, safety_space=0.05)
    assert out.dtype == torch.float32 and out.shape == (2, 6, 2)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
