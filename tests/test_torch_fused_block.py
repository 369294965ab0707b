"""Port parity: the fused block-attention kernels' plain versions (#1, #2, the
r3 kernel #5 and the aligned route) against the JAX package's Pallas kernels
(interpret mode, as its own tests run them on the CPU), and ``pack_emask``
bit for bit.

Tolerance rtol=atol=1e-5: float32 on both sides, sums in different orders.
Rows with no valid edge must give exactly 0 in both. The CUDA kernel itself
is held against the same plain versions on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relationalgraphlearning_tpu.ops import block_graph as jbg
from relationalgraphlearning_tpu.ops import pallas_block as jpb
from relationalgraphlearning_tpu.ops import sparse as jsp
from relationalgraphlearning_tpu_torch.ops import _build as tbuild
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


def test_r3_plain_matches_pallas_kernel():
    """Kernel #5: pre-gathered tables, a dense 0/1 f32 mask, the divide
    before the value product; rows with no edge give 0 in both."""
    n, d, dv, B = 1024, 32, 48, 128
    cand, emask, _ = _graph(B=B, C=256, seed=7)
    q, x, v = _features(n, d, dv, 8, unit=False)
    nb = cand.shape[0]
    candc = np.clip(cand, 0, n - 1)
    qb, xg, vg = q.reshape(nb, B, d), x[candc], v[candc]
    m = emask.astype(np.float32)
    want = jpb.fused_block_attention(*map(jnp.asarray, (qb, xg, vg, m)),
                                     interpret=True)
    got = tfb.fused_block_attention(*map(torch.from_numpy, (qb, xg, vg, m)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got[0, :5] == 0).all() and (np.asarray(want)[0, :5] == 0).all()
    # a bool mask is the same function
    torch.testing.assert_close(
        tfb.fused_block_attention(*map(torch.from_numpy, (qb, xg, vg)),
                                  torch.from_numpy(emask)), got)


def _r3_non_binary(C, seed):
    """Kernel #5's plain version and the reference's on a mask of the values
    {0, -0.0, 0.5, 1, 2} (slots with emask > 0 are edges), and the plain
    version on the bool mask of its edges; with the window's coverage."""
    n, d, dv, B = 1024, 32, 48, 128
    cand, emask, cov = _graph(B=B, C=C, seed=seed)
    q, x, v = _features(n, d, dv, seed + 1, unit=False)
    nb = cand.shape[0]
    candc = np.clip(cand, 0, n - 1)
    qb, xg, vg = q.reshape(nb, B, d), x[candc], v[candc]
    rng = np.random.RandomState(seed + 2)
    m = np.where(emask, rng.choice([0.5, 1.0, 2.0], emask.shape),
                 rng.choice([0.0, -0.0], emask.shape)).astype(np.float32)
    assert (np.signbit(m) & (m == 0)).any() and (m == 0.5).any()
    want = jpb.fused_block_attention(*map(jnp.asarray, (qb, xg, vg, m)),
                                     interpret=True)
    got = tfb.fused_block_attention(*map(torch.from_numpy, (qb, xg, vg, m)))
    as_bool = tfb.fused_block_attention(*map(torch.from_numpy, (qb, xg, vg)),
                                        torch.from_numpy(emask))
    return got, np.asarray(want), as_bool, cov


def test_r3_plain_matches_pallas_kernel_non_binary_mask():
    """Kernel #5 takes the slots with emask > 0 as edges: a mask of the
    values {0, -0.0, 0.5, 1, 2} gives the reference's function, and the
    same function as the bool mask of its edges."""
    got, want, as_bool, _ = _r3_non_binary(256, 11)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert (got[0, :5] == 0).all() and (want[0, :5] == 0).all()
    torch.testing.assert_close(as_bool, got, rtol=0, atol=0)


def test_r3_plain_matches_pallas_kernel_non_binary_mask_partial_coverage():
    """The same on a window that misses some of the graph's edges."""
    got, want, as_bool, cov = _r3_non_binary(96, 14)
    assert cov < 1.0
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    torch.testing.assert_close(as_bool, got, rtol=0, atol=0)


@pytest.mark.parametrize("shared", [True, False])
def test_aligned_route_matches_pallas_aligned(shared):
    """``block_attention_fused_aligned`` against
    ``block_attention_pallas_aligned`` on the same aligned window."""
    n, K, B, window, align = 1024, 8, 128, 512, 8
    pos = np.random.RandomState(9).uniform(0, 30, (n, 2)).astype(np.float32)
    pos = pos[np.asarray(jbg.spatial_sort(jnp.asarray(pos)))]
    cols = jsp.knn_graph(jnp.asarray(pos), K)
    starts, cand, cov = jbg.block_window_aligned(cols, B, window, align)
    assert float(cov) == 1.0
    bits = jpb.pack_emask(jbg.block_masks(cols, cand))
    q, x, v = _features(n, 32, 48, 10, unit=False)
    jv = jnp.asarray(x) if shared else jnp.asarray(v)
    jx = jnp.asarray(x)
    want = jpb.block_attention_pallas_aligned(
        jnp.asarray(q), jx, jx if shared else jv, starts, align, bits,
        interpret=True)
    tx = torch.from_numpy(x)
    tv = tx if shared else torch.from_numpy(v)
    tst = torch.from_numpy(np.array(starts)).long()
    tbits = torch.from_numpy(np.array(bits).view(np.int32))
    got = tfb.block_attention_fused_aligned(torch.from_numpy(q), tx, tv, tst,
                                            align, tbits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the expanded ids the kernel gathers through are the window's cand
    np.testing.assert_array_equal(tfb.aligned_cand(tst, align).numpy(),
                                  np.asarray(cand))


# ------------------------------------ the CTA layout of kernels #1/#2/#4/#7
def _cuda_cta_smem_bytes():
    """``cta_smem_bytes`` of ``csrc/block_attention.cuh`` as a Python
    function: its C++ (and that of ``list_stride``) read and evaluated, so
    that the test holds the wrappers' reckoning against the source the card
    builds."""
    src = (tbuild.CSRC / "block_attention.cuh").read_text()
    rows = int(re.search(r"constexpr int kRowsPerCta = (\d+);", src)[1])
    stride = re.search(r"int list_stride\(int C\) \{\s*return (.*?);",
                       src)[1]
    body = re.search(r"inline size_t cta_smem_bytes\(int C\) "
                     r"\{(.*?)\n\}", src, re.S)[1]
    nw = re.search(r"const size_t nw = (.*?);", body, re.S)[1]
    ret = re.search(r"return (.*?);", body, re.S)[1]
    sizes = {"int": 4, "uint32_t": 4, "uint16_t": 2}

    def py(expr):
        expr = re.sub(r"sizeof\((\w+)\)", lambda m: str(sizes[m[1]]), expr)
        return " ".join(expr.replace("(size_t)", "").replace("/", "//")
                        .split())

    def smem(C):
        env = dict(C=C, kRowsPerCta=rows,
                   list_stride=lambda c: eval(py(stride), {}, dict(C=c)))
        env["nw"] = eval(py(nw), {}, env)
        return eval(py(ret), {}, env)
    return rows, smem


def test_cta_smem_reckoning_matches_the_cuda_source():
    rows, smem = _cuda_cta_smem_bytes()
    assert rows == tfb.ROWS_PER_CTA
    for C in (1, 2, 3, 4, 31, 32, 33, 301, 544, 576, 1024, 2048, 8448):
        assert tfb.cta_smem_bytes(C) == smem(C), C


@pytest.mark.parametrize("C", [576, 544])
def test_main_path_windows_fit_several_ctas_an_sm(C):
    # slice 1's rollout (C=576) and the relation chain's block and chunk
    # routes (544 slots): at least 4 CTAs of 16 rows an SM by shared memory,
    # and the slice's 10,240 rows in one wave on an H100's 132 SMs
    per_sm = tbuild.MAX_SMEM_BYTES // (tfb.cta_smem_bytes(C) + 1024)
    assert per_sm >= 4
    assert per_sm * tfb.ROWS_PER_CTA * 132 >= 10240


def test_wide_windows_fit_and_wider_are_refused():
    # C=2048 at any d now fits a CTA; the staged layout took C*d floats of
    # rows and refused it at d=128 (4 * (2048*128 + 10*2048) B); 8,448
    # slots do not fit
    assert tfb.cta_smem_bytes(2048) <= tbuild.MAX_SMEM_BYTES
    assert 4 * (2048 * 128 + 10 * 2048) > tbuild.MAX_SMEM_BYTES
    assert tfb.cta_smem_bytes(8448) > tbuild.MAX_SMEM_BYTES


# ------------------------------------------------------------- bfloat16
# Two bfloat16 ulps of the output (2^-7 of it; 2^-7 near zero): both sides
# read the same bfloat16 features exactly, sum in float32 in other orders,
# and round e and the output to nearest even, so a rounding near a tie may
# land one ulp apart in e and again in the output.
BF16_TOL = dict(rtol=2**-7, atol=2**-7)


def _bf16_setup():
    """``tests/test_pallas_block.py::_setup(seed=11, C=384)``: the JAX test's
    graph and features, as numpy."""
    import jax
    n, K, B, C, dq, dv, seed = 1024, 8, 128, 384, 32, 48, 11
    pos = jax.random.uniform(jax.random.PRNGKey(seed), (n, 2)) * 30
    pos = pos[jbg.spatial_sort(pos)]
    cols = jsp.knn_graph(pos, K)
    cand, cov = jbg.block_window(cols, B, C)
    emask = jbg.block_masks(cols, cand)
    ks = jax.random.split(jax.random.PRNGKey(seed + 1), 3)
    q, x, v = (np.array(jax.random.normal(k, (n, w)))
               for k, w in zip(ks, (dq, dq, dv)))
    return q, x, v, np.array(cols), np.array(cand), np.array(emask), \
        float(cov)


@pytest.mark.parametrize("epilogue", ["none", "l2norm", "relu"])
@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("shared", [True, False])
def test_bf16_plain_matches_pallas_kernel(shared, stable, epilogue):
    q, x, v, cols, cand, emask, cov = _bf16_setup()
    assert cov == 1.0
    bf = jnp.bfloat16
    jv = jnp.asarray(x if shared else v).astype(bf)
    jx = jnp.asarray(x).astype(bf)
    want = jpb.block_attention_pallas(
        jnp.asarray(q).astype(bf), jx, jx if shared else jv,
        jnp.asarray(cand), jnp.asarray(emask), interpret=True,
        epilogue=epilogue, stable=stable)
    assert want.dtype == bf
    tq, tx, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, x, v))
    got = tfb.block_attention_fused(
        tq, tx, tx if shared else tv, torch.from_numpy(cand).long(),
        torch.from_numpy(emask), epilogue=epilogue, stable=stable)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)


@pytest.mark.parametrize("shared", [True, False])
def test_bf16_plain_matches_f32_block_path(shared):
    """As ``tests/test_pallas_block.py:65-76``: the bfloat16 kernel's math
    against the float32 block path within 0.05."""
    q, x, v, cols, cand, emask, _ = _bf16_setup()
    vv = x if shared else v
    want = jbg.block_attention(jnp.asarray(q), jnp.asarray(x),
                               jnp.asarray(vv), jnp.asarray(cols),
                               jnp.asarray(cand), emask=jnp.asarray(emask))
    tq, tx, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, x, vv))
    got = tfb.block_attention_fused(tq, tx, tx if shared else tv,
                                    torch.from_numpy(cand).long(),
                                    torch.from_numpy(emask))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=0.05, atol=0.05)


def test_bf16_plain_keeps_the_f32_path():
    """In float32 every added cast is the identity: the plain version gives
    the same bits as its float32 arithmetic spelled out."""
    n, B, C = 1024, 128, 256
    cand, emask, _ = _graph(B=B, C=C, seed=5)
    cand = np.array(cand)
    q, x, v = _features(n, 32, 48, 6, unit=False)
    qb = torch.from_numpy(q).reshape(-1, B, 32)
    xg = torch.from_numpy(x)[torch.from_numpy(cand).long().clamp(0, n - 1)]
    vg = torch.from_numpy(v)[torch.from_numpy(cand).long().clamp(0, n - 1)]
    bits = tfb.pack_emask(torch.from_numpy(emask))
    mask = tfb.unpack_emask(bits, B)
    s = torch.einsum("nbd,ncd->nbc", qb, xg).masked_fill(~mask, -1e30)
    e = torch.exp(s - s.amax(-1, keepdim=True)).masked_fill(~mask, 0.0)
    want = torch.einsum("nbc,ncd->nbd", e, vg) / torch.clamp(
        e.sum(-1, keepdim=True), min=1e-20)
    got = tfb.masked_softmax_agg_plain(qb, xg, vg, bits)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("mix", ["x", "v"])
def test_kernel_checks_reject_a_dtype_mix(mix):
    bf, f32 = torch.bfloat16, torch.float32
    t = {"qb": torch.zeros(1, 32, 32, dtype=bf),
         "x": torch.zeros(8, 32, dtype=bf), "v": torch.zeros(8, 32, dtype=bf)}
    t[mix] = t[mix].to(f32)
    with pytest.raises(TypeError, match="one feature type"):
        tfb._check(t["qb"], t["x"], t["v"],
                   torch.zeros(1, 16, dtype=torch.int64),
                   torch.zeros(1, 1, 16, dtype=torch.int32), "none")
    with pytest.raises(TypeError, match="kernel takes"):
        tfb._check(torch.zeros(1, 32, 32, dtype=torch.float16),
                   torch.zeros(8, 32, dtype=torch.float16),
                   torch.zeros(8, 32, dtype=torch.float16),
                   torch.zeros(1, 16, dtype=torch.int64),
                   torch.zeros(1, 1, 16, dtype=torch.int32), "none")
