"""The port's replay buffer against the JAX package's, exactly: pushes of
numpy-made batches that fill and wrap the ring (``ptr``, ``size``,
``is_full`` and every slot), the gather of the slots the reference's
``sample`` draws, ``clear``; and the uniform indices over the filled
region that a sweep draws at once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relationalgraphlearning_tpu.training import replay_buffer as jrb
from relationalgraphlearning_tpu_torch.training import replay_buffer as rb

N = 5


def _batches(k, seed):
    rng = np.random.default_rng(seed)
    shapes = dict(robot=(k, 9), humans=(k, N, 5), value=(k,), reward=(k,),
                  next_robot=(k, 9), next_humans=(k, N, 5))
    data = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in shapes.items()}
    data["valid"] = (rng.random(k) < 0.8).astype(np.float32)
    data["terminal"] = (rng.random(k) < 0.2).astype(np.float32)
    return (jrb.Transition(**{n: jnp.asarray(a) for n, a in data.items()}),
            rb.Transition(**{n: torch.from_numpy(a) for n, a in data.items()}))


def _equal(tbuf, jbuf):
    assert (tbuf.ptr, tbuf.size) == (int(jbuf.ptr), int(jbuf.size))
    assert rb.is_full(tbuf) == bool(jrb.is_full(jbuf))
    for field, got, want in zip(rb.Transition._fields, tbuf.data,
                                jbuf.data):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=field)


@pytest.mark.parametrize("capacity,sizes", [
    (10, (7, 7)), (16, (5, 11, 3)), (8, (8, 8)), (12, (3, 3, 3, 3, 3)),
    (100, (64, 64))])
def test_push_fills_and_wraps_the_ring_as_jax_does(capacity, sizes):
    jbuf = jrb.create(capacity, N)
    tbuf = rb.create(capacity, N, device="cpu")
    assert tbuf.capacity == capacity
    assert sum(a[0].numel() for a in tbuf.data) == 72  # floats a slot
    _equal(tbuf, jbuf)
    for i, k in enumerate(sizes):
        jb, tb = _batches(k, i)
        jbuf = jrb.push(jbuf, jb)
        assert rb.push(tbuf, tb) is tbuf
        _equal(tbuf, jbuf)


def test_sample_gathers_the_slots_the_reference_draws():
    jbuf, tbuf = jrb.create(64, N), rb.create(64, N, device="cpu")
    jb, tb = _batches(40, 0)
    jbuf, _ = jrb.push(jbuf, jb), rb.push(tbuf, tb)
    key = jax.random.PRNGKey(3)
    want = jrb.sample(jbuf, key, 32)
    idx = jax.random.randint(key, (32,), 0, jnp.maximum(jbuf.size, 1))
    got = rb.sample(tbuf, torch.from_numpy(np.asarray(idx, np.int64)))
    for field, g, w in zip(rb.Transition._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=field)


def test_sample_indices_cover_the_filled_region_only():
    tbuf = rb.create(1000, N, device="cpu")
    rb.push(tbuf, _batches(37, 1)[1])
    gen = torch.Generator().manual_seed(0)
    idx = rb.sample_indices(tbuf, gen, (20, 100))
    assert idx.shape == (20, 100) and idx.dtype == torch.int64
    assert int(idx.min()) == 0 and int(idx.max()) == 36
    again = rb.sample_indices(tbuf, torch.Generator().manual_seed(0),
                              (20, 100))
    assert torch.equal(idx, again)
    empty = rb.create(10, N, device="cpu")
    assert int(rb.sample_indices(empty, gen, (4,)).max()) == 0


def test_clear_matches_jax():
    jbuf, tbuf = jrb.create(10, N), rb.create(10, N, device="cpu")
    jb, tb = _batches(13, 2)
    jbuf, _ = jrb.push(jbuf, jb), rb.push(tbuf, tb)
    assert rb.is_full(tbuf)
    jbuf = jrb.clear(jbuf)
    assert rb.clear(tbuf) is tbuf
    _equal(tbuf, jbuf)
    assert not rb.is_full(tbuf) and float(tbuf.data.valid.sum()) == 0
