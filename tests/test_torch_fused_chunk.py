"""Port parity: the chunked-fetch window construction and the attention's plain
version (kernels #4 and #7) against ``pallas_chunk.py``.

``chunk_window`` must equal the reference's bit for bit: ``starts`` and
``tail`` as integers, ``mbits`` as the uint32's bits held in int32, and the
coverage. The plain attention is held against the Pallas kernel in interpret
mode (g = 2) at atol=2e-5, the tolerance of ``tests/test_pallas_chunk.py``.
The reference kernel assumes g = 2 (ADVICE r5 #2); a g = 4 mask (the d = 32
form of ``tools/probe_chunk_d32.py``) is held against the reference's plain
``block_graph.block_attention`` on the same graph instead, and shown to be
misread when read with the wrong ``groups``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relationalgraphlearning_tpu.ops import block_graph as jbg
from relationalgraphlearning_tpu.ops import sparse as jsp
from relationalgraphlearning_tpu.ops.pallas_chunk import (
    chunk_block_attention as jcba, chunk_window as jcw)
from relationalgraphlearning_tpu_torch.ops import _build as tbuild
from relationalgraphlearning_tpu_torch.ops import fused_chunk as tfc

ATOL = 2e-5
N, K, B = 1024, 16, 128
_CACHE = {}


def _graph(seed=0):
    if seed not in _CACHE:
        pos = np.random.RandomState(seed).uniform(0, 35, (N, 2)).astype(
            np.float32)
        pos = pos[np.asarray(jbg.spatial_sort(jnp.asarray(pos)))]
        _CACHE[seed] = np.array(jsp.knn_graph(jnp.asarray(pos), K))
    return _CACHE[seed]


def _unit(n, d, seed):
    h = np.random.RandomState(seed).randn(n, d).astype(np.float32)
    return h / np.linalg.norm(h, axis=1, keepdims=True)


SIZINGS = {"chunk32": dict(nch=8, ct=288, thresh=32, chunk=32),
           "chunk128": dict(nch=2, ct=352, thresh=80, chunk=128),
           "tail too small": dict(nch=2, ct=64, thresh=80, chunk=128)}


@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("sizing", list(SIZINGS))
def test_chunk_window_bit_identical(sizing, groups):
    cols = _graph()
    kw = dict(SIZINGS[sizing], groups=groups)
    js, jt, jm, jc = jcw(jnp.asarray(cols), B, **kw)
    ts, tt, tm, tc = tfc.chunk_window(torch.from_numpy(cols).long(), B, **kw)
    assert ts.dtype == torch.int32 and tm.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm).view(np.int32))
    assert float(tc) == float(jc)
    assert (float(tc) < 1.0) == (sizing == "tail too small")


def _artifacts(sizing="chunk32", groups=2, seed=0):
    cols = _graph(seed)
    kw = dict(SIZINGS[sizing], groups=groups)
    jart = jcw(jnp.asarray(cols), B, **kw)
    tart = tfc.chunk_window(torch.from_numpy(cols).long(), B, **kw)
    return cols, jart, tart


@pytest.mark.parametrize("stable,epilogue", [
    (True, "none"), (False, "none"), (False, "l2norm"), (True, "relu")])
def test_plain_matches_pallas_kernel(stable, epilogue):
    cols, (js, jt, jm, _), (ts, tt, tm, _) = _artifacts()
    h = _unit(N, 64, 1)
    want = jcba(jnp.asarray(h), jnp.asarray(h), js, jt, jm, interpret=True,
                epilogue=epilogue, stable=stable)
    th = torch.from_numpy(h)
    got = tfc.chunk_block_attention(th, th, ts, tt, tm, epilogue=epilogue,
                                    stable=stable)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_plain_matches_pallas_kernel_partial_coverage():
    """ct too small: edges drop, and both sides drop the same ones."""
    cols, (js, jt, jm, jc), (ts, tt, tm, _) = _artifacts("tail too small")
    assert float(jc) < 1.0
    h = _unit(N, 64, 2)
    want = jcba(jnp.asarray(h), jnp.asarray(h), js, jt, jm, interpret=True)
    th = torch.from_numpy(h)
    got = tfc.chunk_block_attention(th, th, ts, tt, tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("sizing", ["chunk32", "chunk128"])
def test_groups4_equals_block_attention(sizing):
    """The d = 32 form: a g = 4 mask read with groups=4 is the exact block
    attention at coverage 1; read as g = 2 (the reference kernel's silent
    assumption) it is not."""
    cols, _, (ts, tt, tm, tc) = _artifacts(sizing, groups=4)
    assert float(tc) == 1.0
    h = _unit(N, 32, 3)
    cand, cov = jbg.block_window(jnp.asarray(cols), B, 448)
    assert float(cov) == 1.0
    want = np.asarray(jbg.block_attention(*(jnp.asarray(h),) * 3,
                                          jnp.asarray(cols), cand))
    th = torch.from_numpy(h)
    got = tfc.chunk_block_attention(th, th, ts, tt, tm, groups=4)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    misread = tfc.chunk_block_attention(th, th, ts, tt, tm, groups=2)
    assert np.abs(misread.numpy() - want).max() > 1e-2


def test_slot_ids_name_each_rows_knn_set():
    """At coverage 1 the set bits of each row name exactly its kNN set."""
    cols, _, (ts, tt, tm, tc) = _artifacts("chunk128", groups=4)
    from relationalgraphlearning_tpu_torch.ops.fused_block import (
        unpack_emask)
    ids = tfc.chunk_slot_ids(ts, tt, N, 128, 4)          # [nb, ntot]
    mask = unpack_emask(tm, B)                           # [nb, B, ntot]
    for b in (0, 3, 7):
        for r in (0, 31, 77, 127):
            got = set(ids[b][mask[b, r]].tolist())
            assert got == set(cols[b * B + r].tolist())


def test_cpu_tensors_launch_nothing():
    tbuild.reset_launch_counts()
    _, _, (ts, tt, tm, _) = _artifacts()
    th = torch.from_numpy(_unit(N, 64, 4))
    tfc.chunk_block_attention(th, th, ts, tt, tm)
    assert tbuild.launch_counts()["chunk_block_attention"] == 0
