"""The port's numpy threefry2x32 and seeded scenarios against ``jax.random``
and the JAX package's ``generate_case``.

The bits are exact: PRNGKey, fold_in, split and the float32 uniform are
compared over 1,024 keys. All 500 test and 100 val cases of the default
configuration accept the same attempt for every human; positions agree to
atol 1e-6 (float32 cos/sin may differ in the last bit: 4.8e-7 at |x| = 4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from relationalgraphlearning_tpu.configs.base import EnvConfig as JEnvConfig
from relationalgraphlearning_tpu.configs.base import SimConfig as JSimConfig
from relationalgraphlearning_tpu.envs import scenarios as jsc
from relationalgraphlearning_tpu_torch.configs.base import EnvConfig, SimConfig
from relationalgraphlearning_tpu_torch.envs import scenarios as tsc

N_KEYS = 1024


def _keys():
    """1,024 keys: a spread of seeds, each folded with a spread of data."""
    rng = np.random.default_rng(0)
    seeds = rng.integers(0, 2**32, N_KEYS, dtype=np.uint64).astype(np.uint32)
    data = rng.integers(0, 2**32, N_KEYS, dtype=np.uint64).astype(np.uint32)
    return seeds, data


def test_prng_key_and_fold_in_bits():
    seeds, data = _keys()
    want = np.asarray(jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds)))
    np.testing.assert_array_equal(tsc.prng_key(seeds), want)
    want_f = np.asarray(jax.vmap(jax.random.fold_in)(
        jnp.asarray(want), jnp.asarray(data)))
    np.testing.assert_array_equal(tsc.fold_in(want, data), want_f)


@pytest.mark.parametrize("num", [2, 3, 4, 5, 12])
def test_split_bits(num):
    seeds, data = _keys()
    keys = tsc.fold_in(tsc.prng_key(seeds), data)
    want = np.asarray(jax.vmap(lambda k: jax.random.split(k, num))(
        jnp.asarray(keys)))
    np.testing.assert_array_equal(tsc.split(keys, num), want)


@pytest.mark.parametrize("minval,maxval", [(0.0, 1.0), (0.0, 2.0 * np.pi),
                                           (0.5, 1.5), (0.3, 0.5)])
def test_uniform_bits(minval, maxval):
    seeds, data = _keys()
    keys = tsc.fold_in(tsc.prng_key(seeds), data)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (), minval=minval, maxval=maxval))(jnp.asarray(keys)))
    got = tsc.uniform(keys, minval, maxval)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_case_key_bits():
    idx = np.arange(N_KEYS)
    want = np.asarray(jax.vmap(lambda i: jsc.case_key(0, 100_000, i))(
        jnp.asarray(idx)))
    np.testing.assert_array_equal(tsc.case_key(0, 100_000, idx), want)


def _reference(cfg_j, offset, n):
    gen = jax.jit(jax.vmap(lambda i: jsc.generate_case(
        jsc.case_key(0, offset, i), cfg_j)))
    robot, humans = gen(jnp.arange(n))
    return np.asarray(robot), np.asarray(humans)


@pytest.mark.parametrize("phase,offset,n", [("test", 100_000, 500),
                                            ("val", 0, 100)])
def test_circle_crossing_cases(phase, offset, n):
    robot_j, humans_j = _reference(JEnvConfig(), offset, n)
    robot, humans = tsc.generate_cases(tsc.case_key(0, offset, np.arange(n)),
                                       EnvConfig())
    assert robot.dtype == humans.dtype == np.float32
    np.testing.assert_array_equal(robot, robot_j)
    np.testing.assert_allclose(humans, humans_j, rtol=0, atol=1e-6)
    # the same attempt accepted: a different one would move a human by
    # metres, not by an ulp
    assert np.abs(humans - humans_j).max() < 1e-5


@pytest.mark.parametrize("randomize", [False, True])
def test_square_crossing_cases(randomize):
    sim = dict(scenario="square_crossing")
    cfg_j = JEnvConfig(sim=JSimConfig(**sim), randomize_attributes=randomize)
    cfg = EnvConfig(sim=SimConfig(**sim), randomize_attributes=randomize)
    robot_j, humans_j = _reference(cfg_j, 100_000, 200)
    robot, humans = tsc.generate_cases(tsc.case_key(0, 100_000,
                                                    np.arange(200)), cfg)
    np.testing.assert_array_equal(robot, robot_j)
    np.testing.assert_allclose(humans, humans_j, rtol=0, atol=1e-6)


def test_circle_crossing_randomized_attributes_and_crowd_size():
    kw = dict(randomize_attributes=True)
    cfg_j = JEnvConfig(sim=JSimConfig(human_num=10), **kw)
    cfg = EnvConfig(sim=SimConfig(human_num=10), **kw)
    _, humans_j = _reference(cfg_j, 0, 100)
    _, humans = tsc.generate_cases(tsc.case_key(0, 0, np.arange(100)), cfg)
    np.testing.assert_allclose(humans, humans_j, rtol=0, atol=1e-6)
