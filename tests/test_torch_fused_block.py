"""Port parity: the fused block-attention kernels' plain versions against the
JAX package's Pallas kernels (interpret mode, as its own tests run them on
the CPU), and ``pack_emask`` bit for bit.

Tolerance rtol=atol=1e-5: float32 on both sides, sums in different orders.
Rows with no valid edge must give exactly 0 in both. The CUDA kernel itself
is held against the same plain versions on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relationalgraphlearning_tpu.ops import block_graph as jbg
from relationalgraphlearning_tpu.ops import pallas_block as jpb
from relationalgraphlearning_tpu.ops import sparse as jsp
from relationalgraphlearning_tpu_torch.ops import block_graph as tbg
from relationalgraphlearning_tpu_torch.ops import fused_block as tfb

TOL = dict(rtol=1e-5, atol=1e-5)


def _graph(n=1024, K=8, B=128, C=256, seed=0):
    pos = np.random.RandomState(seed).uniform(0, 30, (n, 2)).astype(
        np.float32)
    pos = pos[np.asarray(jbg.spatial_sort(jnp.asarray(pos)))]
    cols = jsp.knn_graph(jnp.asarray(pos), K)
    cand, cov = jbg.block_window(cols, B, C)
    emask = np.array(jbg.block_masks(cols, cand))
    emask[0, :5] = False      # rows with no valid edge
    emask[1, -1] = False
    return np.asarray(cand), emask, float(cov)


def _features(n, d, dv, seed, unit):
    rng = np.random.RandomState(seed)
    q, x = (rng.randn(n, d).astype(np.float32) for _ in range(2))
    if unit:  # |q·x| ≤ 1: the unshifted softmax's precondition
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    return q, x, rng.randn(n, dv).astype(np.float32)


def test_pack_emask_bit_exact():
    _, emask, _ = _graph(seed=1)
    want = np.asarray(jpb.pack_emask(jnp.asarray(emask))).view(np.int32)
    got = tfb.pack_emask(torch.from_numpy(emask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    back = tfb.unpack_emask(got, emask.shape[1])
    np.testing.assert_array_equal(back.numpy(), emask)
    assert (want < 0).any()  # bit 31 is exercised


def _run_both(shared, stable, epilogue, C=256, seed=0):
    n, d, dv, B = 1024, 32, 48, 128
    cand, emask, cov = _graph(B=B, C=C, seed=seed)
    q, x, v = _features(n, d, dv, seed + 1, unit=not stable)
    nb = cand.shape[0]
    bits = jpb.pack_emask(jnp.asarray(emask))
    candc = np.clip(cand, 0, n - 1)
    qb = q.reshape(nb, B, d)
    if shared:
        want = jpb.fused_block_attention_packed_shared(
            jnp.asarray(qb), jnp.asarray(x[candc]), bits, interpret=True,
            epilogue=epilogue, stable=stable)
    else:
        want = jpb.fused_block_attention_packed(
            jnp.asarray(qb), jnp.asarray(x[candc]), jnp.asarray(v[candc]),
            bits, interpret=True, epilogue=epilogue, stable=stable)
    tbits = tfb.pack_emask(torch.from_numpy(emask))
    tc = torch.from_numpy(np.array(cand)).long()
    if shared:
        got = tfb.fused_block_attention_packed_shared(
            torch.from_numpy(qb), torch.from_numpy(x), tc, tbits,
            epilogue=epilogue, stable=stable)
    else:
        got = tfb.fused_block_attention_packed(
            torch.from_numpy(qb), torch.from_numpy(x), torch.from_numpy(v),
            tc, tbits, epilogue=epilogue, stable=stable)
    return got.numpy(), np.asarray(want), cov


@pytest.mark.parametrize("epilogue", ["none", "l2norm", "relu"])
@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("shared", [True, False])
def test_plain_matches_pallas_kernel(shared, stable, epilogue):
    got, want, cov = _run_both(shared, stable, epilogue)
    assert cov == 1.0
    np.testing.assert_allclose(got, want, **TOL)
    assert (got[0, :5] == 0).all() and (want[0, :5] == 0).all()


@pytest.mark.parametrize("shared", [True, False])
def test_plain_matches_pallas_kernel_partial_coverage(shared):
    got, want, cov = _run_both(shared, True, "none", C=96, seed=4)
    assert cov < 1.0
    np.testing.assert_allclose(got, want, **TOL)


def test_block_attention_fused_matches_block_attention():
    """The dispatching wrapper on a bool mask (packed per call) and on a
    packed mask equals the plain block path at coverage 1."""
    n, B, C = 1024, 128, 256
    cand, emask, _ = _graph(B=B, C=C, seed=5)
    q, x, v = _features(n, 32, 48, 6, unit=False)
    tq, tx, tv = map(torch.from_numpy, (q, x, v))
    tc = torch.from_numpy(np.array(cand)).long()
    te = torch.from_numpy(emask)
    want = tbg.block_attention(tq, tx, tv, None, tc, emask=te)
    for em in (te, tfb.pack_emask(te)):
        torch.testing.assert_close(
            tfb.block_attention_fused(tq, tx, tv, tc, em), want, **TOL)
    want_shared = tbg.block_attention(tq, tx, tx, None, tc, emask=te)
    torch.testing.assert_close(
        tfb.block_attention_fused(tq, tx, tx, tc, te), want_shared, **TOL)


def test_kernel_checks_reject_cpu_tensors():
    qb = torch.zeros(1, 32, 32)
    with pytest.raises(ValueError, match="CUDA"):
        tfb._check(qb, torch.zeros(8, 32), torch.zeros(8, 32),
                   torch.zeros(1, 16, dtype=torch.int64),
                   torch.zeros(1, 1, 16, dtype=torch.int32), "none")
