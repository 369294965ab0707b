"""Port parity: kernel #6's plain version and the A/B harness against the
reference's ``tools/ab_kernel.py``.

The reference's ``make_kernel`` runs unchanged in Pallas interpret mode
(``pltpu.force_tpu_interpret_mode``). ``tools/`` is no package, so the file
is loaded by path; its import enables JAX's persistent compilation cache,
so the cache is pointed at a temporary directory first and the three config
values it sets are put back after. Its chain is nested in its ``main``, so
the JAX side of the chain tests is composed here: the gather ``h[clip(cand)]``
and the interpreted kernel, three iterations.

Tolerances: float32 at rtol=atol=1e-5 (one application; float32 sums in
another order) and atol=2e-5 over three chain iterations (the tolerance of
``tests/test_torch_relation_chain.py``); bfloat16 within one bfloat16 ulp of
the value (rtol=2^-7, atol=2^-9), on at most one element in a thousand:
both sides round with round-to-nearest-even, so only a float32 sum that
lands on the other side of a rounding boundary differs.
"""

import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from relationalgraphlearning_tpu.ops import block_graph as jbg
from relationalgraphlearning_tpu.ops import pallas_block as jpb
from relationalgraphlearning_tpu.ops import sparse as jsp
from relationalgraphlearning_tpu_torch.ops import _build as tbuild
from relationalgraphlearning_tpu_torch.ops import ab_block as tab
from relationalgraphlearning_tpu_torch.ops import fused_chunk as tfc
from relationalgraphlearning_tpu_torch.ops.fused_block import (
    unpack_emask as tfb_unpack)
from relationalgraphlearning_tpu_torch.tools import ab_kernel as tak

ROOT = Path(__file__).resolve().parents[1]
N, K = 1024, 16
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2**-7, atol=2**-9)
CHAIN_ATOL = 2e-5
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# the reference's variants, in its order (tools/ab_kernel.py:139-178)
REF_VARIANTS = ["base_f32", "divafter_f32", "divafter_intmask_f32",
                "divafter_bf16", "divafter_intmask_f32_NOGATHER",
                "divafter_intmask_f32_TAILSIM", "chunkfetch_f32"]
_CACHE_KEYS = ("jax_compilation_cache_dir",
               "jax_persistent_cache_min_compile_time_secs",
               "jax_persistent_cache_min_entry_size_bytes")
_GRAPH = {}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference tool, imported with its compile cache kept off the
    user's home and the JAX config of the worker left as it was."""
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    env = os.environ.get("RGL_TPU_COMPILE_CACHE")
    os.environ["RGL_TPU_COMPILE_CACHE"] = str(
        tmp_path_factory.mktemp("ab_kernel_cache"))
    try:
        spec = importlib.util.spec_from_file_location(
            "reference_ab_kernel", ROOT / "tools" / "ab_kernel.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        if env is None:
            del os.environ["RGL_TPU_COMPILE_CACHE"]
        else:
            os.environ["RGL_TPU_COMPILE_CACHE"] = env
    return mod


def _graph():
    if not _GRAPH:
        pos = np.random.RandomState(0).uniform(0, 35, (N, 2)).astype(
            np.float32)
        pos = pos[np.asarray(jbg.spatial_sort(jnp.asarray(pos)))]
        _GRAPH["cols"] = np.array(jsp.knn_graph(jnp.asarray(pos), K))
    return _GRAPH["cols"]


def _window(B, C, no_edge=True):
    """cand [nb, C] and the packed mask as the reference's uint32 and the
    port's int32; rows 0-4 of block 0 lose their edges (``no_edge``)."""
    jc = jnp.asarray(_graph())
    cand, cov = jbg.block_window(jc, B, C)
    bits = np.array(jpb.pack_emask(jbg.block_masks(jc, cand)))
    if no_edge:
        bits[0, 0, :] &= ~np.uint32(0x1F)
    return np.array(cand), float(cov), bits, torch.from_numpy(
        bits.view(np.int32).copy())


def _unit(n, d, seed):
    h = np.random.RandomState(seed).randn(n, d).astype(np.float32)
    return h / np.linalg.norm(h, axis=1, keepdims=True)


def _reference_call(ref, B, C, d, div_after, intmask, qb, xg, bits):
    with pltpu.force_tpu_interpret_mode():
        out = ref.make_kernel(B, C, d, div_after=div_after,
                              intmask=intmask)(qb, xg, jnp.asarray(bits))
    return np.asarray(out.astype(jnp.float32))


def _assert_matches(got, want, dtype):
    if dtype == "f32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        np.testing.assert_allclose(got, want, **BF16_TOL)
        assert (got != want).mean() <= 1e-3


@pytest.mark.parametrize("intmask", [False, True])
@pytest.mark.parametrize("div_after", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,C,d", [(256, 544, 64), (128, 320, 32)])
def test_plain_matches_reference_kernel(ref, B, C, d, dtype, div_after,
                                        intmask):
    cand, cov, jbits, tbits = _window(B, C)
    assert cov == 1.0
    jdt, tdt = DTYPES[dtype]
    q, h = _unit(N, d, 1), _unit(N, d, 2)
    candc = np.clip(cand, 0, N - 1)
    qb_j, h_j = jnp.asarray(q).astype(jdt), jnp.asarray(h).astype(jdt)
    want = _reference_call(ref, B, C, d, div_after, intmask,
                           qb_j.reshape(N // B, B, d), h_j[candc], jbits)
    qb_t, h_t = torch.from_numpy(q).to(tdt), torch.from_numpy(h).to(tdt)
    got = tab.ab_block_attention(qb_t.reshape(N // B, B, d),
                                 h_t[torch.from_numpy(candc)], tbits,
                                 div_after, intmask)
    assert got.dtype == tdt and got.shape == (N // B, B, d)
    got = got.float().numpy()
    _assert_matches(got, want, dtype)
    # rows with no edge are exactly 0 on both sides
    assert (got[0, :5] == 0).all() and (want[0, :5] == 0).all()
    assert not (got[0, 5:] == 0).all(axis=-1).any()


@pytest.mark.parametrize("dtype,div_after,intmask", [
    ("f32", False, False), ("bf16", True, True)])
@pytest.mark.parametrize("B", [128, 256])
def test_plain_matches_reference_kernel_partial_coverage(ref, B, dtype,
                                                         div_after, intmask):
    """A window of 256 slots drops edges: both sides drop the same."""
    cand, cov, jbits, tbits = _window(B, 256, no_edge=False)
    assert cov < 1.0
    jdt, tdt = DTYPES[dtype]
    h = _unit(N, 64, 3)
    candc = np.clip(cand, 0, N - 1)
    h_j = jnp.asarray(h).astype(jdt)
    want = _reference_call(ref, B, 256, 64, div_after, intmask,
                           h_j.reshape(N // B, B, 64), h_j[candc], jbits)
    h_t = torch.from_numpy(h).to(tdt)
    got = tab.ab_block_attention(h_t.reshape(N // B, B, 64),
                                 h_t[torch.from_numpy(candc)], tbits,
                                 div_after, intmask).float().numpy()
    _assert_matches(got, want, dtype)


# ------------------------------------------- the card's 3xTF32 numerics
def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32``: half an ulp added to the magnitude
    bits, then the low 13 bits cleared."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as kernel #6 takes it in float32: a = ah + al and b = bh + bl,
    each part rounded to TF32, and ah bh + ah bl + al bh summed in float32
    (al bl dropped)."""
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    al, bl = _tf32_rna(a - ah), _tf32_rna(b - bh)
    return al @ bh + ah @ bl + ah @ bh


@pytest.mark.parametrize("intmask", [False, True])
@pytest.mark.parametrize("div_after", [False, True])
def test_3xtf32_emulation_holds_the_card_tolerance(div_after, intmask):
    """Kernel #6's float32 products on the tensor cores, emulated in torch
    at the harness's B, C and d on unit rows, stay within the card test's
    rtol=atol=1e-5 of the exact plain version. This checks the design's
    numerics before the card; the card test holds the kernel itself."""
    B, C, d = 256, 544, 64
    cand, cov, _, tbits = _window(B, C)
    assert cov == 1.0
    q = torch.from_numpy(_unit(N, d, 5)).reshape(N // B, B, d)
    xg = torch.from_numpy(_unit(N, d, 6))[torch.from_numpy(
        np.clip(cand, 0, N - 1))]
    exact = tab.ab_block_attention_plain(q, xg, tbits, div_after, intmask)

    scores = _mm_3xtf32(q, xg.transpose(1, 2))
    assert float((scores - q @ xg.transpose(1, 2)).abs().max()) < 1e-6
    ex = torch.exp(scores)
    if intmask:
        shift = torch.arange(32, dtype=torch.int32)
        m32 = ((tbits[:, :, None, :] << (31 - shift)[None, None, :, None])
               >> 31).reshape(ex.shape)
        e = (ex.view(torch.int32) & m32).view(torch.float32)
    else:
        e = torch.where(tfb_unpack(tbits, B), ex, 0.0)
    den = torch.clamp(e.sum(-1, keepdim=True), min=1e-20)
    out = (_mm_3xtf32(e, xg) / den if div_after
           else _mm_3xtf32(e / den, xg))
    out = out / torch.clamp(out.norm(dim=-1, keepdim=True), min=1e-6)
    torch.testing.assert_close(out, exact, **F32_TOL)
    # and plain TF32, one product, would not hold it
    one = _tf32_rna(q) @ _tf32_rna(xg).transpose(1, 2)
    assert float((one - q @ xg.transpose(1, 2)).abs().max()) > 1e-5


# ----------------------------------------------------------- the chain
CB, CC, TAIL_FROM, ITERS = 256, 448, 264, 3   # TAIL_FROM: 320 of 544, scaled
CHAINS = {"base_f32": dict(dtype="f32"),
          "divafter_intmask_f32": dict(dtype="f32", div_after=True,
                                       intmask=True),
          "divafter_bf16": dict(dtype="bf16", div_after=True),
          "divafter_intmask_f32_NOGATHER": dict(
              dtype="f32", div_after=True, intmask=True, no_gather=True),
          "divafter_intmask_f32_TAILSIM": dict(
              dtype="f32", div_after=True, intmask=True,
              tail_from=TAIL_FROM)}


def _jax_chain(ref, h, cand, bits, d, div_after=False, intmask=False,
               no_gather=False, tail_from=None):
    """The reference's chain body (``ab_kernel.py:116-132``) as a loop."""
    nb = cand.shape[0]
    candc = jnp.clip(jnp.asarray(cand), 0, N - 1)
    xg0 = h[candc]
    kern = ref.make_kernel(CB, CC, d, div_after=div_after, intmask=intmask)
    for _ in range(ITERS):
        if no_gather:
            xg = xg0
        elif tail_from is not None:
            xg = jnp.concatenate([xg0[:, :tail_from],
                                  h[candc[:, tail_from:]]], 1)
        else:
            xg = h[candc]
        with pltpu.force_tpu_interpret_mode():
            out = kern(h.reshape(nb, CB, d), xg, jnp.asarray(bits))
        h = out.reshape(N, d).astype(h.dtype)
    return np.asarray(h.astype(jnp.float32))


@pytest.mark.parametrize("variant", list(CHAINS))
def test_chain_matches_reference_loop(ref, variant):
    kw = dict(CHAINS[variant])
    dtype = kw.pop("dtype")
    jdt, tdt = DTYPES[dtype]
    cand, cov, jbits, tbits = _window(CB, CC, no_edge=False)
    assert cov == 1.0
    h0 = _unit(N, 64, 4)
    want = _jax_chain(ref, jnp.asarray(h0).astype(jdt), cand, jbits, 64,
                      **kw)
    call = tak.make_kernel(CB, CC, 64, div_after=kw.get("div_after", False),
                           intmask=kw.get("intmask", False))
    f = tak.chain(call, tdt, no_gather=kw.get("no_gather", False),
                  tail_from=kw.get("tail_from"), inner=ITERS)
    got = f(torch.from_numpy(h0).to(tdt), torch.from_numpy(cand).long(),
            tbits)
    assert got.dtype == tdt and got.shape == (N, 64)
    got = got.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=CHAIN_ATOL, rtol=0)
    else:
        _assert_matches(got, want, dtype)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-2)


def test_variants_are_the_references_seven():
    cols = torch.from_numpy(_graph()).long()
    table, chunk = tak.variants(cols, B=CB, C=CC, inner=1)
    assert list(table) == REF_VARIANTS
    assert {name: dt for name, (_, dt) in table.items()} == {
        name: torch.bfloat16 if "bf16" in name else torch.float32
        for name in REF_VARIANTS}
    _, _, _, cov = tfc.chunk_window(cols, CB, nch=2, ct=288, thresh=80,
                                    chunk=128)
    assert chunk == dict(chunk_coverage=float(cov), nch=2, ct=288)


def test_run_on_cpu_gives_one_record_a_variant():
    tbuild.reset_launch_counts()
    finals = {}
    records = tak.run(rounds=1, reps=1, inner=2, device="cpu", n=N,
                      finals=finals)
    assert set(records[0]) == {"chunk_coverage", "nch", "ct"}
    assert [r["variant"] for r in records[1:]] == REF_VARIANTS
    for r in records[1:]:
        assert {"variant", "B", "C", "gedges_s", "gedges_s_best", "iqr_pct",
                "coverage"} <= set(r)
        assert (r["B"], r["C"]) == (256, 544)
        assert r["gedges_s_best"] >= r["gedges_s"] > 0
        # nothing launches on the CPU
        assert r["launches"] == {"ab_block_attention": 0,
                                 "chunk_block_attention": 0}
    assert set(finals["h"]) == set(REF_VARIANTS)
    assert all(torch.isfinite(h.float()).all() for h in finals["h"].values())
    cols, cand, cov, mbits, h0 = finals["graph"]
    assert cols.shape == (N, 16) and h0.shape == (N, 64)
    assert cand.shape == (N // 256, 544)
    assert all(r["coverage"] == float(cov) for r in records[1:])
    assert mbits.shape == (N // 256, 256 // 32, 544)
    assert tbuild.launch_counts()["ab_block_attention"] == 0
    # no graph on the CPU: the timed rounds are the eager ones
    for r in records[1:]:
        assert r["graphed"] is False
        assert r["graph_launches"] is None and r["replay_err"] is None
        assert r["gedges_s_eager"] == r["gedges_s"]


def test_run_with_no_rounds_gives_the_checked_runs_and_no_rates():
    finals = {}
    records = tak.run(rounds=0, inner=1, device="cpu", n=N, finals=finals)
    assert [r["variant"] for r in records[1:]] == REF_VARIANTS
    for r in records[1:]:
        assert not {"gedges_s", "gedges_s_best", "iqr_pct",
                    "gedges_s_eager"} & set(r)
        assert r["launches"] == {"ab_block_attention": 0,
                                 "chunk_block_attention": 0}
        assert r["coverage"] == float(finals["graph"][2])
    assert set(finals["h"]) == set(REF_VARIANTS)


def test_run_on_cpu_is_each_variants_eager_chain():
    """``graphed=None`` runs every variant eagerly on CPU tensors: each
    final h is its chain called directly, bit for bit; ``graphed=True``
    raises there."""
    finals = {}
    tak.run(rounds=1, reps=1, inner=2, device="cpu", n=N, finals=finals)
    cols, cand, _, mbits, h0 = finals["graph"]
    table, _ = tak.variants(cols, inner=2)
    for name, (f, dtype) in table.items():
        torch.testing.assert_close(finals["h"][name], f(h0.to(dtype), cand,
                                                        mbits),
                                   rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        tak.run(rounds=1, reps=1, inner=1, device="cpu", n=N, graphed=True)


def test_main_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; main would time it")
    assert tak.main(["--rounds", "1", "--reps", "1"]) == 1
