"""The CUDA kernels on the card (#1-#7): held against their plain PyTorch
versions, their wrappers' checks, and their launch counts on the rollout and
in the A/B harness's chain; the captured CUDA graphs of the chain, the
harness and both rollouts, each held to its eager run; and the MP-RGL
evaluation path (batched CrowdSim, planner, ``Explorer.run_cases``) on the
card against the CPU, the planner's shared prediction of the humans
against the per-action one at B=500, its captured step against its eager
run, and 32 test cases against the JAX package's per-case records; MP-RGL
training (the captured SGD step and collection step, each held to its
eager run bit for bit, and a ``debug`` train on the card); and the one-step
baselines (CADRL, SARL, SARL with occupancy maps, LSTM-RL, the model-free
RGL): their action values on the card against the CPU, their captured
rollouts (with the env-queried lookahead too) against eager ones, each
learned baseline's value-only training step and collection captured
against eager, the baselines the port trained from scratch replayed
against eager, and the unicycle breakdown's rollout graphed against eager;
the
device phases of ``utils/profiling.py`` read from captured graphs (inside
each replay's own time, no event node in a graph captured with tracing
off, the same outputs either way, a recapture counted once); and
the partitioned paths on 4 ranks run as threads on the card (kernel #1
through ``partitioned_block_rgl``, #2 through ``block_halo_attention`` with
a value table, the 600-agent partitioned rollout) against the same ranks on
the CPU.

These tests need an NVIDIA GPU with ``nvcc`` (sm_90a) and skip elsewhere.
This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda

Tolerance rtol=atol=1e-5: float32 in both, sums in different orders. Kernel
#6 in bfloat16: within one bfloat16 ulp of the value (rtol=2^-7, atol=2^-9),
since both sides round to bfloat16 with round-to-nearest-even from float32
sums taken in another order.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

from per_action_planner import per_action_expand
from relationalgraphlearning_tpu_torch import captured, checkpoints
from relationalgraphlearning_tpu_torch import relation_chain as trc
from relationalgraphlearning_tpu_torch import types as TT
from relationalgraphlearning_tpu_torch.configs.base import GCNConfig as TGCN
from relationalgraphlearning_tpu_torch.configs.base import load_config_module
from relationalgraphlearning_tpu_torch.envs.crowd_sim import CrowdSim
from relationalgraphlearning_tpu_torch.envs import mega_crowd as tmc
from relationalgraphlearning_tpu_torch.envs.orca import (
    ORCAParams as TORCAParams)
from relationalgraphlearning_tpu_torch.models.sparse_rgl import (
    SparseValueNet as TSparseValueNet)
from relationalgraphlearning_tpu_torch.envs.mega_crowd import (
    mega_crowd_rollout)
from relationalgraphlearning_tpu_torch.ops import _build as tbuild
from relationalgraphlearning_tpu_torch.ops import ab_block as tab
from relationalgraphlearning_tpu_torch.ops import block_graph as tbg
from relationalgraphlearning_tpu_torch.ops import fused_block as tfb
from relationalgraphlearning_tpu_torch.ops import fused_chunk as tfc
from relationalgraphlearning_tpu_torch.ops import fused_gather as tfg
from relationalgraphlearning_tpu_torch.ops import sparse as tsp
from relationalgraphlearning_tpu_torch.parallel import graph_partition as tgp
from relationalgraphlearning_tpu_torch.parallel import mesh as tmesh
from relationalgraphlearning_tpu_torch.parallel import partitioned_build as tpb
from relationalgraphlearning_tpu_torch.policies.model_predictive_rl import (
    ModelPredictiveRLPolicy)
from relationalgraphlearning_tpu_torch.tools import ab_kernel as tak
from relationalgraphlearning_tpu_torch.training import checkpoint as tckpt
from relationalgraphlearning_tpu_torch.training import replay_buffer as trb
from relationalgraphlearning_tpu_torch.training import train_loop as ttl
from relationalgraphlearning_tpu_torch.training.explorer import (
    EvalCarry, Explorer)
from relationalgraphlearning_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2**-7, atol=2**-9)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (sm_90a)")
    return torch.device("cuda")


def _problem(dev, n=1024, K=8, B=128, C=320, d=32, dv=48, unit=False,
             seed=0):
    g = torch.Generator().manual_seed(seed)
    pos = torch.rand(n, 2, generator=g) * 30.0
    pos = pos[tbg.spatial_sort(pos)]
    cols = tsp.knn_graph(pos, K)
    cand, cov = tbg.block_window(cols, B, C)
    emask = tbg.block_masks(cols, cand)
    emask[0, :5] = False  # rows with no edge
    q, x = torch.randn(n, d, generator=g), torch.randn(n, d, generator=g)
    if unit:  # |q·x| ≤ 1: the unshifted softmax's precondition
        q, x = q / q.norm(dim=1, keepdim=True), x / x.norm(dim=1, keepdim=True)
    v = torch.randn(n, dv, generator=g)
    bits = tfb.pack_emask(emask)
    return [t.to(dev) for t in (q.reshape(n // B, B, d), x, v, cand, bits)]


@pytest.mark.parametrize("epilogue", ["none", "l2norm", "relu"])
@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("shared", [True, False])
def test_cuda_kernel_matches_plain(dev, shared, stable, epilogue):
    qb, x, v, cand, bits = _problem(dev, unit=not stable)
    if shared:
        got = tfb.fused_block_attention_packed_shared(
            qb, x, cand, bits, epilogue, stable)
        want = tfb.fused_block_attention_packed_shared_plain(
            qb, x, cand, bits, epilogue, stable)
    else:
        got = tfb.fused_block_attention_packed(
            qb, x, v, cand, bits, epilogue, stable)
        want = tfb.fused_block_attention_packed_plain(
            qb, x, v, cand, bits, epilogue, stable)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)
    assert (got[0, :5] == 0).all()


def test_cuda_kernel_partial_coverage(dev):
    qb, x, v, cand, bits = _problem(dev, C=96, seed=1)
    got = tfb.fused_block_attention_packed(qb, x, v, cand, bits)
    want = tfb.fused_block_attention_packed_plain(qb, x, v, cand, bits)
    torch.testing.assert_close(got, want, **TOL)


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(dev):
    qb, x, v, cand, bits = _problem(dev)
    with pytest.raises(TypeError):
        tfb.fused_block_attention_packed_shared(qb.double(), x, cand, bits)
    with pytest.raises(ValueError, match="contiguous"):
        tfb.fused_block_attention_packed_shared(
            qb.transpose(1, 2).contiguous().transpose(1, 2), x, cand, bits)
    with pytest.raises(ValueError, match="CUDA"):
        tfb.fused_block_attention_packed_shared(qb, x.cpu(), cand, bits)
    with pytest.raises(ValueError, match="multiple of 32"):
        tfb.fused_block_attention_packed_shared(
            qb[:, :48].contiguous(), x, cand, bits[:, :1].contiguous())


# #1/#2 in bfloat16: two bfloat16 ulps of the output (rtol=atol=2^-7), as
# chip_smoke.py's phase 13 holds them: e and then the output are rounded to
# nearest even on both sides from float32 sums taken in other orders.
BF16_KERNEL_TOL = dict(rtol=2**-7, atol=2**-7)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("epilogue", ["none", "l2norm", "relu"])
@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("shared", [True, False])
def test_cuda_kernel_bf16_matches_plain(dev, shared, stable, epilogue, d):
    qb, x, v, cand, bits = _problem(dev, unit=not stable, d=d)
    bf = torch.bfloat16
    qb, x, v = qb.to(bf), x.to(bf), v.to(bf)
    if shared:
        args = (qb, x, cand, bits, epilogue, stable)
        got = tfb.fused_block_attention_packed_shared(*args)
        want = tfb.fused_block_attention_packed_shared_plain(*args)
    else:
        args = (qb, x, v, cand, bits, epilogue, stable)
        got = tfb.fused_block_attention_packed(*args)
        want = tfb.fused_block_attention_packed_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == bf
    torch.testing.assert_close(got, want, **BF16_KERNEL_TOL)
    assert (got[0, :5] == 0).all()


def test_cuda_kernel_bf16_rejects_a_mix(dev):
    qb, x, v, cand, bits = _problem(dev)
    with pytest.raises(TypeError, match="one feature type"):
        tfb.fused_block_attention_packed(qb.to(torch.bfloat16), x.to(
            torch.bfloat16), v, cand, bits)


def test_cuda_fma_chain_matches_plain(dev):
    from relationalgraphlearning_tpu_torch.ops import roofline
    x = torch.ones(1 << 16, device=dev)
    tbuild.reset_launch_counts()
    got = roofline.fma_chain(x, 128, 8)
    torch.cuda.synchronize()
    assert tbuild.launch_counts()["fma_chain"] == 1
    torch.testing.assert_close(got, roofline.fma_chain_plain(x, 128, 8),
                               rtol=0, atol=0)
    assert float(got[0]) == 1 + 1024 * 2.0**-23


def test_cuda_bf16_chain_graphed_equals_eager(dev):
    """The bfloat16 block route (#1, stable, l2norm) as one captured graph
    replays its eager run bit for bit, 100 launches of #1 in the graph."""
    cols = trc.crowd_graph(2048, 16, side=50.0, device=dev)
    h0 = trc.seed_features(2048, 64, device=dev, dtype=torch.bfloat16)
    prep = trc.prepare("block", cols, 256, 640, stable=True)
    eager = trc.run(prep, h0, 100)
    g = trc.runner(prep, h0, 100)
    assert g.launches["fused_block_attention_packed_shared"] == 100
    replay = g(h0)
    assert replay.dtype == torch.bfloat16
    torch.testing.assert_close(replay, eager, rtol=0, atol=0)


def _window_problem(dev, C, d, dv, nb=4, B=64, n=4096, unit=False, seed=11):
    """A random window of C distinct table rows a block and a mask of about
    5 % edges, with: block 0's last 40 slots the sentinel n (repeated, bits
    never set) and its rows 0-4 without an edge; block 1's rows 0-3 with
    every slot an edge (a full edge list). Scores are of order 1 (q scaled
    by 1/sqrt(d); unit rows for the unshifted softmax)."""
    g = torch.Generator().manual_seed(seed)
    cand = torch.stack([torch.randperm(n, generator=g)[:C].sort().values
                        for _ in range(nb)])
    cand[0, -40:] = n
    emask = torch.rand(nb, B, C, generator=g) < 0.05
    emask[0, :, -40:] = False
    emask[0, :5] = False
    emask[1, :4] = True
    q = torch.randn(nb, B, d, generator=g) / d ** 0.5
    x, v = torch.randn(n, d, generator=g), torch.randn(n, dv, generator=g)
    if unit:
        q, x = q / q.norm(dim=-1, keepdim=True), x / x.norm(dim=-1,
                                                             keepdim=True)
    return [t.to(dev) for t in (q, x, v, cand, tfb.pack_emask(emask))]


@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("C,d,dv", [(2048, 128, 128), (301, 32, 32),
                                    (301, 16, 8), (301, 100, 36),
                                    (301, 64, 48)])
def test_cuda_kernel_windows_and_widths(dev, shared, stable, C, d, dv):
    # C=2048 at d=128: wider than the staged layout admitted; C=301: neither
    # a multiple of a 32-slot mask word nor of 4; rows of 16, 100 (plain
    # loads) and 128 floats (two float4 a lane); dv != d for #2
    qb, x, v, cand, bits = _window_problem(dev, C, d, d if shared else dv,
                                           unit=not stable)
    for epilogue in ("none", "l2norm", "relu"):
        if shared:
            args = (qb, x, cand, bits, epilogue, stable)
            got = tfb.fused_block_attention_packed_shared(*args)
            want = tfb.fused_block_attention_packed_shared_plain(*args)
        else:
            args = (qb, x, v, cand, bits, epilogue, stable)
            got = tfb.fused_block_attention_packed(*args)
            want = tfb.fused_block_attention_packed_plain(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL)
        assert (got[0, :5] == 0).all()
        assert (got[1, :4] != 0).any(-1).all()


def test_cuda_kernel_row_lanes(dev):
    # the two row shapes the width chooses: 8 lanes a row at d=32 (#1 and
    # #7), 16 at d=64 (#1 and #4)
    for d, groups in ((32, 4), (64, 2)):
        qb, x, v, cand, bits = _window_problem(dev, 544, d, d)
        torch.testing.assert_close(
            tfb.fused_block_attention_packed_shared(qb, x, cand, bits),
            tfb.fused_block_attention_packed_shared_plain(qb, x, cand, bits),
            **TOL)
        h, starts, tail, mbits, _ = _chunk_problem(dev, groups=groups, d=d)
        torch.testing.assert_close(
            tfc.chunk_block_attention(h, h, starts, tail, mbits,
                                      groups=groups),
            tfc.chunk_block_attention_plain(h, h, starts, tail, mbits,
                                            groups=groups), **TOL)


def test_cuda_rollout_counts_two_launches_a_step(dev):
    # the eager run: a graph's launches count once, at its capture
    tbuild.reset_launch_counts()
    (pos, vel), vals, cov = mega_crowd_rollout(
        n=1024, K=10, steps=4, backend="block", packed=True, block_B=256,
        block_C=576, rebuild_every=2, device=dev, graphed=False)
    assert tbuild.launch_counts()["fused_block_attention_packed_shared"] == 8
    assert float(cov) == 1.0 and torch.isfinite(vals).all()
    (pc, vc), valc, _ = mega_crowd_rollout(
        n=1024, K=10, steps=4, backend="block", packed=True, block_B=256,
        block_C=576, rebuild_every=2, device="cpu")
    torch.testing.assert_close(pos.cpu(), pc, rtol=0, atol=1e-4)
    torch.testing.assert_close(vals.cpu(), valc, rtol=0, atol=1e-4)


# ------------------------------------------------ kernel #3, per-edge gather
def _gather_problem(dev, n=1024, K=16, d=64, dv=64, seed=2):
    g = torch.Generator().manual_seed(seed)
    cols = tsp.knn_graph(torch.rand(n, 2, generator=g) * 30.0, K)
    q, x = torch.randn(n, d, generator=g), torch.randn(n, d, generator=g)
    v = torch.randn(n, dv, generator=g)
    mask = torch.rand(n, K, generator=g) > 0.3
    mask[:4] = False          # fully masked rows: the uniform average
    return [t.to(dev) for t in (q, x, v, cols, mask)]


@pytest.mark.parametrize("dv", [64, 48])
@pytest.mark.parametrize("masked", [False, True])
def test_cuda_gather_kernel_matches_plain(dev, masked, dv):
    q, x, v, cols, mask = _gather_problem(dev, dv=dv)
    m = mask if masked else None
    got = tfg.fused_gather_attention(q, x, v, cols, m)
    want = tfg.fused_gather_attention_plain(q, x, v, cols, m)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)
    if masked:
        torch.testing.assert_close(got[:4], v[cols[:4]].mean(1), **TOL)


def test_cuda_gather_kernel_duplicates_and_wide_k(dev):
    q, x, v, cols, _ = _gather_problem(dev, K=40, d=32, dv=32)
    cols[:, 1] = cols[:, 0]   # a duplicate counts twice
    got = tfg.fused_gather_attention(q, x, v, cols)
    torch.testing.assert_close(
        got, tfg.fused_gather_attention_plain(q, x, v, cols), **TOL)


def test_cuda_gather_wrapper_rejects_what_the_kernel_does_not_take(dev):
    q, x, v, cols, mask = _gather_problem(dev)
    with pytest.raises(ValueError, match="outside"):
        bad = cols.clone()
        bad[3, 2] = x.shape[0]
        tfg.fused_gather_attention(q, x, v, bad)
    with pytest.raises(TypeError):
        tfg.fused_gather_attention(q, x, v, cols.int())
    with pytest.raises(TypeError):
        tfg.fused_gather_attention(q, x, v, cols, mask.float())
    with pytest.raises(ValueError, match="CUDA"):
        tfg.fused_gather_attention(q, x.cpu(), v, cols)
    with pytest.raises(ValueError, match="contiguous"):
        tfg.fused_gather_attention(q, x, v.t().contiguous().t(), cols)


# Kernel #3's shapes: K across the batches of 8 edges and the chunks of 32
# ids (1, 7, 16, 17, 33, 64); widths of every row shape (8 lanes up to 32
# floats, 16 up to 64, 32 up to 128) with and without 16-B rows.
GATHER_KS = (1, 7, 16, 17, 33, 64)
GATHER_WIDTHS = (1, 3, 4, 32, 36, 64, 100, 128)


def _gather_case(dev, K, d, dv, n=301, seed=20):
    """n = 301 rows: no multiple of a CTA's 16, 8 or 4 rows. Rows 0-3 are
    fully masked in the mask; row 4 repeats one neighbour K times."""
    g = torch.Generator().manual_seed(seed + K + d + dv)
    cols = tsp.knn_graph(torch.rand(n, 2, generator=g) * 30.0, K)
    cols[4] = cols[4, 0]
    if K > 1:
        cols[5:, 1] = cols[5:, 0]               # a duplicate neighbour
    q, x = torch.randn(n, d, generator=g), torch.randn(n, d, generator=g)
    v = torch.randn(n, dv, generator=g)
    mask = torch.rand(n, K, generator=g) > 0.3
    mask[:4] = False
    return [t.to(dev) for t in (q, x, v, cols, mask)]


def _gather_close(q, x, v, cols, mask):
    got = tfg.fused_gather_attention(q, x, v, cols, mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, tfg.fused_gather_attention_plain(q, x, v, cols, mask), **TOL)
    return got


@pytest.mark.parametrize("d", GATHER_WIDTHS)
@pytest.mark.parametrize("K", GATHER_KS)
def test_cuda_gather_kernel_keys_are_values(dev, K, d):
    # x is v: each neighbour row read once, for its score and its share
    q, x, _, cols, mask = _gather_case(dev, K, d, d)
    _gather_close(q, x, x, cols, None)
    got = _gather_close(q, x, x, cols, mask)
    # fully masked rows: the uniform average of v over their cols
    torch.testing.assert_close(got[:4], x[cols[:4]].mean(1), **TOL)


@pytest.mark.parametrize("K", (7, 17, 64))
@pytest.mark.parametrize("d,dv", [(1, 3), (3, 100), (4, 36), (32, 64),
                                  (36, 1), (64, 128), (100, 4), (128, 32)])
def test_cuda_gather_kernel_separate_values(dev, K, d, dv):
    # x != v, dv != d: the values load in batches beside the keys
    q, x, v, cols, mask = _gather_case(dev, K, d, dv)
    _gather_close(q, x, v, cols, None)
    got = _gather_close(q, x, v, cols, mask)
    torch.testing.assert_close(got[:4], v[cols[:4]].mean(1), **TOL)


@pytest.mark.parametrize("d", (32, 64, 128))
def test_cuda_gather_kernel_unaligned_rows(dev, d):
    # a storage offset of one float breaks the 16-B alignment of every row:
    # the kernel reads them with plain loads
    n, K = 301, 16
    q, x, v, cols, mask = _gather_case(dev, K, d, d)
    flat = torch.empty(3 * n * d + 1, device=dev)
    qo, xo, vo = (flat[1 + k * n * d:1 + (k + 1) * n * d].view(n, d)
                  for k in range(3))
    for dst, src in ((qo, q), (xo, x), (vo, v)):
        dst.copy_(src)
    assert xo.data_ptr() % 16 != 0 and xo.is_contiguous()
    for args in ((qo, xo, xo, cols, mask), (qo, xo, vo, cols, None)):
        _gather_close(*args)


def test_cuda_gather_kernel_large_scores_against_float64(dev):
    # scores of order 1e3-1e4, the layer-1 scale: integer features make
    # every score exact in float32 in any summation order, so the kernel's
    # online softmax (a running max rescaling acc and den) is held against
    # the plain version in float64
    n, K, d = 1024, 16, 32
    g = torch.Generator().manual_seed(21)
    cols = tsp.knn_graph(torch.rand(n, 2, generator=g) * 30.0, K)
    q = torch.randint(-30, 31, (n, d), generator=g).float()
    x = torch.randint(-30, 31, (n, d), generator=g).float()
    v = torch.randn(n, 48, generator=g)
    mask = torch.rand(n, K, generator=g) > 0.2
    mask[:4] = False
    s = (q[:, None] * x[cols]).sum(-1).abs()
    assert float(s.median()) > 1e3 and float(s.max()) > 5e3
    qd, xd, cd = q.to(dev), x.to(dev), cols.to(dev)
    for vv, vd in ((x, xd), (v, v.to(dev))):
        for m in (None, mask):
            want = tfg.fused_gather_attention_plain(
                q.double(), x.double(), vv.double(), cols, m)
            got = tfg.fused_gather_attention(
                qd, xd, vd, cd, None if m is None else m.to(dev))
            torch.testing.assert_close(got.double().cpu(), want, **TOL)


# ------------------------------------------- the captured CUDA graphs
def _replay_equals_eager(replayed, eager):
    # the same kernels in the same order: the same bits
    torch.testing.assert_close(replayed, eager, rtol=0, atol=0)


CHAIN_ROUTES = (("gather", 64, None),
                ("gather_kernel", 64, "fused_gather_attention"),
                ("block", 64, "fused_block_attention_packed_shared"),
                ("chunk", 64, "chunk_block_attention"),
                ("chunk_d32", 32, "chunk_block_attention"))


@pytest.mark.parametrize("route,d,kernel", CHAIN_ROUTES)
def test_cuda_chain_graph_replays_its_eager_run(dev, route, d, kernel):
    inner = 5
    cols = trc.crowd_graph(2048, 16, side=50.0, seed=3, device=dev)
    prep = trc.prepare(route, cols, 256, 544)
    h0 = trc.seed_features(2048, d, seed=4, device=dev)
    f = trc.runner(prep, h0, inner)
    want = {k: 0 for k in f.launches}
    if kernel:
        want[kernel] = inner
    assert f.launches == want
    eager = trc.run(prep, h0, inner)
    _replay_equals_eager(f(h0), eager)
    # new inputs go through the static buffers
    h1 = trc.seed_features(2048, d, seed=5, device=dev)
    _replay_equals_eager(f(h1).clone(), trc.run(prep, h1, inner))
    with pytest.raises(ValueError, match="captured on"):
        f(h1[:1024])


def test_cuda_harness_graphs_replay_their_eager_runs(dev):
    records = tak.run(rounds=1, reps=1, inner=4, device=dev, n=2048)
    for rec in records[1:]:
        kernel = ("chunk_block_attention" if rec["variant"] ==
                  "chunkfetch_f32" else "ab_block_attention")
        want = {"ab_block_attention": 0, "chunk_block_attention": 0,
                kernel: 4}
        assert rec["graphed"] is True
        assert rec["launches"] == rec["graph_launches"] == want
        assert rec["replay_err"] == 0.0
        assert rec["gedges_s"] > 0 and rec["gedges_s_eager"] > 0


@pytest.mark.parametrize("backend,packed,kernel", [
    ("block", True, "fused_block_attention_packed_shared"),
    ("pallas", False, "fused_gather_attention")])
def test_cuda_rollout_graph_refreshes_its_buffers(dev, monkeypatch, backend,
                                                  packed, kernel):
    """One runner, two crowds of two chunks each: the graph captured on the
    first chunk replays every later one, on other rebuilt graphs, and equals
    the eager runner; kernel #3's ids are proven on each rebuilt graph."""
    rebuilt, checked = [], []
    real_rebuild, real_check = tmc.rebuild, tfg.check_ids

    def rebuild(*args):
        out = real_rebuild(*args)
        rebuilt.append(out[2])
        return out

    def check_ids(cols, n):
        checked.append(cols)
        real_check(cols, n)

    monkeypatch.setattr(tmc, "rebuild", rebuild)
    monkeypatch.setattr(tfg, "check_ids", check_ids)
    kw = dict(K=10, backend=backend, block_B=256, block_C=576,
              rebuild_every=2, packed=packed)
    net = tmc.MegaCrowdRollout(**kw, device=dev).net
    graphed = tmc.MegaCrowdRollout(**kw, net=net, device=dev)
    eager = tmc.MegaCrowdRollout(**kw, net=net, device=dev, graphed=False)
    assert graphed.graphed and not eager.graphed
    chunks = []
    for seed in (0, 1):
        pos0 = tmc.initial_crowd(1024, seed=seed, device=dev)
        rebuilt.clear()
        (p, v), vals, cov = graphed(pos0, 4)
        chunks += rebuilt
        (pe, ve), vale, cove = eager(pos0, 4)
        for got, want in ((p, pe), (v, ve), (vals, vale)):
            _replay_equals_eager(got, want)
        assert float(cov) == float(cove) == 1.0
    # four chunks, the second crowd's on other graphs than the first's
    assert len(chunks) == 4 and not torch.equal(chunks[1], chunks[2])
    if backend == "pallas":
        assert all(any(c is cols for c in checked) for cols in chunks)
    assert graphed.graph.launches == {
        **{k: 0 for k in graphed.graph.launches}, kernel: 4,
        "orca_velocity": 2}                    # ORCA once a step


# ----------------------------------------- kernels #4/#7, chunked fetch
def _chunk_problem(dev, groups=2, d=64, ct=288, n=2048, B=256, seed=3):
    g = torch.Generator().manual_seed(seed)
    pos = torch.rand(n, 2, generator=g) * 50.0
    cols = tsp.knn_graph(pos[tbg.spatial_sort(pos)], 16)
    starts, tail, mbits, cov = tfc.chunk_window(cols, B, ct=ct,
                                                groups=groups)
    mbits[0, 0] &= ~0x1F      # rows 0-4 of block 0: no edge
    h = torch.randn(n, d, generator=g)
    h = h / h.norm(dim=1, keepdim=True)
    return [t.to(dev) for t in (h, starts, tail, mbits)] + [float(cov)]


@pytest.mark.parametrize("epilogue", ["none", "l2norm", "relu"])
@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("groups,d", [(2, 64), (4, 32)])
def test_cuda_chunk_kernel_matches_plain(dev, groups, d, stable, epilogue):
    h, starts, tail, mbits, cov = _chunk_problem(dev, groups, d)
    assert cov == 1.0
    got = tfc.chunk_block_attention(h, h, starts, tail, mbits, epilogue,
                                    stable, groups)
    want = tfc.chunk_block_attention_plain(h, h, starts, tail, mbits,
                                           epilogue, stable, groups)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)
    assert (got[:5] == 0).all()


def test_cuda_chunk_kernel_partial_coverage(dev):
    h, starts, tail, mbits, cov = _chunk_problem(dev, ct=64)
    assert cov < 1.0
    torch.testing.assert_close(
        tfc.chunk_block_attention(h, h, starts, tail, mbits),
        tfc.chunk_block_attention_plain(h, h, starts, tail, mbits), **TOL)


@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("groups,d,ct", [(2, 128, 1792), (4, 16, 288),
                                         (2, 100, 45)])
def test_cuda_chunk_kernel_windows_and_widths(dev, groups, d, ct, stable):
    # 256 + 1792 = 2048 slots at d=128, wider than the staged layout
    # admitted, its tail mostly the repeated sentinel; d=16 on 4 groups;
    # 301 slots (neither a multiple of 32 nor of 4) at d=100, plain loads.
    # Rows 5-7 of block 0 have every slot but the sentinels as an edge.
    h, starts, tail, mbits, _ = _chunk_problem(dev, groups, d, ct)
    nchunk = mbits.shape[-1] - ct
    real = torch.cat([torch.ones(nchunk, dtype=torch.bool, device=dev),
                      tail[0] < h.shape[0]])
    mbits[0, 0] |= torch.where(real, 0xE0, 0).to(torch.int32)
    for epilogue in ("none", "l2norm", "relu"):
        args = (h, h, starts, tail, mbits, epilogue, stable, groups)
        got = tfc.chunk_block_attention(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, tfc.chunk_block_attention_plain(
            *args), **TOL)
        assert (got[:5] == 0).all()


def test_cuda_chunk_wrapper_rejects_what_the_kernel_does_not_take(dev):
    h, starts, tail, mbits, _ = _chunk_problem(dev)
    with pytest.raises(TypeError):
        tfc.chunk_block_attention(h, h, starts.long(), tail, mbits)
    with pytest.raises(ValueError, match="shared memory"):
        # a window too wide for a CTA's 16 edge lists: 256 + 8192 slots
        # (the staged layout refused d=128 over 544 slots, which now runs)
        nb, n = starts.shape[0], h.shape[0]
        wide_tail = torch.full((nb, 8192), n, dtype=torch.int64, device=dev)
        wide_bits = torch.zeros(nb, mbits.shape[1], 256 + 8192,
                                dtype=torch.int32, device=dev)
        tfc.chunk_block_attention(h, h, starts, wide_tail, wide_bits)
    with pytest.raises(ValueError, match="groups"):
        tfc.chunk_block_attention(h, h, starts, tail, mbits, groups=3)


# ----------------------------------------------- kernel #5, the r3 form
def test_cuda_r3_kernel_matches_plain(dev):
    qb, x, v, cand, bits = _problem(dev, seed=4)
    n = x.shape[0]
    emask = tfb.unpack_emask(bits, qb.shape[1])
    candc = cand.clamp(0, n - 1)
    xg, vg = x[candc].contiguous(), v[candc].contiguous()
    got = tfb.fused_block_attention(qb, xg, vg, emask.float())
    want = tfb.fused_block_attention_plain(qb, xg, vg, emask.float())
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)
    assert (got[0, :5] == 0).all()


def _r3_problem(dev, C, nb=4, B=64, d=64, dv=48, seed=9):
    """Unit-normal features and a mask of the values {0, -0.0, 0.5, 1, 2}:
    the kernel takes slots with emask > 0 as edges, as the reference does."""
    g = torch.Generator().manual_seed(seed)
    qb = torch.randn(nb, B, d, generator=g)
    xg, vg = torch.randn(nb, C, d, generator=g), torch.randn(nb, C, dv,
                                                           generator=g)
    values = torch.tensor([0.0, -0.0, 0.5, 1.0, 2.0])
    pick = torch.randint(0, 5, (nb, B, C), generator=g)
    pick = torch.where(torch.rand(nb, B, C, generator=g) < 0.9, pick % 2,
                       pick)                  # about 6 % of slots are edges
    emask = values[pick]
    emask[0, :5] = torch.where(torch.arange(C) % 2 == 0, 0.0, -0.0)
    return [t.to(dev) for t in (qb, xg, vg, emask)]


@pytest.mark.parametrize("C", [301, 544, 1088])
def test_cuda_r3_kernel_non_binary_mask(dev, C):
    # C=301: neither a multiple of the 4 slots a lane reads at once nor of
    # a 32-slot mask word; C=1088: twice the chain's window
    qb, xg, vg, emask = _r3_problem(dev, C)
    got = tfb.fused_block_attention(qb, xg, vg, emask)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, tfb.fused_block_attention_plain(qb, xg, vg, emask), **TOL)
    assert (got[0, :5] == 0).all()
    # the same edges as a bool mask give the same function
    torch.testing.assert_close(
        tfb.fused_block_attention(qb, xg, vg, emask > 0), got, rtol=0, atol=0)


@pytest.mark.parametrize("d,dv", [(16, 8), (100, 36), (128, 128)])
def test_cuda_r3_kernel_other_widths(dev, d, dv):
    # one or two 16-B loads a lane and edge; rows of 100 and 36 floats are
    # read by plain loads
    qb, xg, vg, emask = _r3_problem(dev, 301, d=d, dv=dv)
    got = tfb.fused_block_attention(qb, xg, vg, emask)
    torch.testing.assert_close(
        got, tfb.fused_block_attention_plain(qb, xg, vg, emask), **TOL)
    assert (got[0, :5] == 0).all()


def test_cuda_r3_kernel_window_limit(dev):
    # the launch is the kernel's one check of shared memory: the widest
    # window that #1's former staged layout (which #5 also used before: C
    # rows of d floats, C mask words and ids, 8 warps' score rows) admits
    # at d=4 runs, and a window too wide for one warp's mask words and
    # scores is refused
    d = 4
    widest_staged = max(c for c in range(1, 1 << 15)
                        if 4 * (c * d + 2 * c + 8 * c)
                        <= tbuild.MAX_SMEM_BYTES)
    qb, xg, vg, emask = _r3_problem(dev, widest_staged, nb=1, B=32, d=d, dv=d)
    got = tfb.fused_block_attention(qb, xg, vg, emask)
    torch.testing.assert_close(
        got, tfb.fused_block_attention_plain(qb, xg, vg, emask), **TOL)
    qb, xg, vg, emask = _r3_problem(dev, 1 << 15, nb=1, B=32, d=d, dv=d)
    with pytest.raises(RuntimeError, match="launch failed"):
        tfb.fused_block_attention(qb, xg, vg, emask)
    # the refusal leaves no error behind for the next launch
    small = _r3_problem(dev, 301, nb=1, B=32, d=d, dv=d)
    torch.testing.assert_close(tfb.fused_block_attention(*small),
                               tfb.fused_block_attention_plain(*small), **TOL)


def test_cuda_aligned_route_matches_plain(dev):
    g = torch.Generator().manual_seed(5)
    pos = torch.rand(1024, 2, generator=g) * 30.0
    cols = tsp.knn_graph(pos[tbg.spatial_sort(pos)], 8)
    starts, cand, cov = tbg.block_window_aligned(cols, 128, 512, 8)
    bits = tfb.pack_emask(tbg.block_masks(cols, cand))
    q, x = torch.randn(1024, 32, generator=g), torch.randn(1024, 32,
                                                           generator=g)
    q, x, starts, bits = (t.to(dev) for t in (q, x, starts, bits))
    torch.testing.assert_close(
        tfb.block_attention_fused_aligned(q, x, x, starts, 8, bits),
        tfb.block_attention_fused_aligned_plain(q, x, x, starts, 8, bits),
        **TOL)


def test_cuda_pallas_rollout_counts_two_launches_a_step(dev):
    tbuild.reset_launch_counts()
    (pos, vel), vals, cov = mega_crowd_rollout(
        n=1024, K=10, steps=4, backend="pallas", rebuild_every=2,
        device=dev, graphed=False)
    assert tbuild.launch_counts()["fused_gather_attention"] == 8
    assert torch.isfinite(vals).all()
    (pc, vc), valc, _ = mega_crowd_rollout(
        n=1024, K=10, steps=4, backend="pallas", rebuild_every=2,
        device="cpu")
    torch.testing.assert_close(pos.cpu(), pc, rtol=0, atol=1e-4)
    torch.testing.assert_close(vals.cpu(), valc, rtol=0, atol=1e-4)


# ------------------------------------- kernel #6, the A/B harness's form
def _ab_problem(dev, dtype, C=544, n=2048, B=256, d=64, seed=7):
    g = torch.Generator().manual_seed(seed)
    pos = torch.rand(n, 2, generator=g) * 50.0
    cols = tsp.knn_graph(pos[tbg.spatial_sort(pos)], 16)
    cand, cov = tbg.block_window(cols, B, C)
    bits = tfb.pack_emask(tbg.block_masks(cols, cand))
    bits[0, 0] &= ~0x1F       # rows 0-4 of block 0: no edge
    q, x = torch.randn(n, d, generator=g), torch.randn(n, d, generator=g)
    q, x = q / q.norm(dim=1, keepdim=True), x / x.norm(dim=1, keepdim=True)
    qb, xg = q.reshape(n // B, B, d), x[cand.clamp(0, n - 1)]
    return [t.to(dev) for t in (qb.to(dtype), xg.to(dtype), bits)] + [
        float(cov)]


def _ab_close(got, want):
    assert got.dtype == want.dtype
    tol = TOL if got.dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("intmask", [False, True])
@pytest.mark.parametrize("div_after", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ab_kernel_matches_plain(dev, dtype, div_after, intmask):
    qb, xg, bits, cov = _ab_problem(dev, dtype)
    assert cov == 1.0
    got = tab.ab_block_attention(qb, xg, bits, div_after, intmask)
    want = tab.ab_block_attention_plain(qb, xg, bits, div_after, intmask)
    torch.cuda.synchronize()
    _ab_close(got, want)
    assert (got[0, :5] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ab_kernel_partial_coverage(dev, dtype):
    qb, xg, bits, cov = _ab_problem(dev, dtype, C=256)
    assert cov < 1.0
    _ab_close(tab.ab_block_attention(qb, xg, bits, True, True),
              tab.ab_block_attention_plain(qb, xg, bits, True, True))


@pytest.mark.parametrize("div_after", [False, True])
@pytest.mark.parametrize("C", [40, 1088])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ab_kernel_window_wider_or_narrower_than_a_tile(dev, dtype, C,
                                                            div_after):
    # the window streams through shared memory in tiles of 64 slots: one
    # ragged tile (C=40), and 17 tiles, wider than any window the card's
    # shared memory could hold whole in float32 at d=64 (C=1088)
    qb, xg, bits, _ = _ab_problem(dev, dtype, C=C)
    for intmask in (False, True):
        got = tab.ab_block_attention(qb, xg, bits, div_after, intmask)
        _ab_close(got, tab.ab_block_attention_plain(qb, xg, bits, div_after,
                                                    intmask))
        assert (got[0, :5] == 0).all()


@pytest.mark.parametrize("d", [40, 100, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ab_kernel_other_widths(dev, dtype, d):
    # rows padded to 64 or 128 features; at d=100 in bfloat16 a row is not
    # a whole number of 16-B chunks, so the window is staged by plain loads
    qb, xg, bits, _ = _ab_problem(dev, dtype, d=d)
    for div_after in (False, True):
        for intmask in (False, True):
            got = tab.ab_block_attention(qb, xg, bits, div_after, intmask)
            _ab_close(got, tab.ab_block_attention_plain(qb, xg, bits,
                                                        div_after, intmask))
            assert (got[0, :5] == 0).all()


def test_cuda_ab_wrapper_rejects_what_the_kernel_does_not_take(dev):
    qb, xg, bits, _ = _ab_problem(dev, torch.float32)
    with pytest.raises(TypeError):
        tab.ab_block_attention(qb, xg.bfloat16(), bits)
    with pytest.raises(TypeError):
        tab.ab_block_attention(qb.double(), xg.double(), bits)
    with pytest.raises(ValueError, match="1..128"):
        wide = torch.zeros(*qb.shape[:2], 160, device=dev)
        tab.ab_block_attention(wide, torch.zeros(*xg.shape[:2], 160,
                                                 device=dev), bits)
    with pytest.raises(ValueError, match="multiple of 32"):
        tab.ab_block_attention(qb[:, :48].contiguous(), xg,
                               bits[:, :1].contiguous())


def test_cuda_ab_harness_chain_counts_one_launch_an_iteration(dev):
    g = torch.Generator().manual_seed(8)
    pos = torch.rand(2048, 2, generator=g) * 50.0
    cols = tsp.knn_graph(pos[tbg.spatial_sort(pos)], 16).to(dev)
    cand, _ = tbg.block_window(cols, 256, 544)
    bits = tfb.pack_emask(tbg.block_masks(cols, cand))
    h = torch.randn(2048, 64, generator=g)
    h = (h / h.norm(dim=1, keepdim=True)).to(dev)
    tbuild.reset_launch_counts()
    f = tak.chain(tak.make_kernel(256, 544, 64, div_after=True), torch.float32,
                  inner=3)
    got = f(h, cand, bits)
    assert tbuild.launch_counts()["ab_block_attention"] == 3
    plain = tak.chain(lambda q, x, m: tab.ab_block_attention_plain(
        q, x, m, True), torch.float32, inner=3)(h, cand, bits)
    torch.testing.assert_close(got, plain, **TOL)


# ------------------------------------------------------- MP-RGL evaluation
ROOT = Path(__file__).resolve().parents[1]


def _mprl(device, model="mprl_td"):
    config = load_config_module(str(ROOT / "results" / model / "config.py"))
    env = CrowdSim(config.env, device=device)
    policy = ModelPredictiveRLPolicy(config.policy, config.env, device=device)
    policy.load_flax(checkpoints.load_flax_tree(model))
    return config, env, policy, Explorer(env, policy, config.policy.gamma)


def _top2_gap(values):
    top2 = values.sort(dim=-1).values[..., -2:]
    return top2[..., 1] - top2[..., 0]


@pytest.mark.parametrize("model", ["mprl_td", "mp_unicycle_anneal"])
def test_cuda_env_step_and_planner_match_the_cpu(dev, model):
    """The same states (10 steps into 64 test cases) on the card and on the
    CPU: one env step (robot and reward 1e-5, the humans' ORCA velocities
    1e-4, dmin 1e-4·Δt, done and outcome exact, as against the reference),
    the planner's action values (rtol 1e-5, atol 1e-5) and its choice
    where the top two differ by more than 1e-4."""
    config, env_c, pol_c, ex_c = _mprl("cpu", model)
    _, env_g, pol_g, _ = _mprl(dev, model)
    carry = ex_c.initial_carry(config.env.sim.test_seed_offset, range(64))
    with torch.no_grad():
        for _ in range(10):
            carry = EvalCarry(*ex_c.eval_step(*carry))
    states = carry.states
    action = pol_c.action_space[torch.arange(64) % 81]
    out_c = env_c.step(states, action)
    out_g = env_g.step(type(states)(*(t.to(dev) for t in states)),
                       action.to(dev))
    dt = config.env.time_step
    for name, atol in (("robot", 1e-5), ("humans", 1e-4)):
        torch.testing.assert_close(getattr(out_g.state, name).cpu(),
                                   getattr(out_c.state, name), rtol=0,
                                   atol=atol)
    torch.testing.assert_close(out_g.reward.cpu(), out_c.reward, rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(out_g.dmin.cpu(), out_c.dmin, rtol=0,
                               atol=1e-4 * dt)
    assert torch.equal(out_g.done.cpu(), out_c.done)
    assert torch.equal(out_g.outcome.cpu(), out_c.outcome)

    js_c = TT.JointState(states.robot, TT.observable(states.humans))
    js_g = TT.JointState(*(t.to(dev) for t in js_c))
    with torch.no_grad():
        acts_c, rew_c, nr_c, nh_c = pol_c._clip_actions(*js_c, pol_c.width)
        acts_g, rew_g, nr_g, nh_g = pol_g._clip_actions(*js_g, pol_g.width)
        ret_c = rew_c + pol_c._gamma_bar(js_c.robot)[..., None] \
            * pol_c.v_planning(nr_c, nh_c, pol_c.depth)
        ret_g = rew_g + pol_g._gamma_bar(js_g.robot)[..., None] \
            * pol_g.v_planning(nr_g, nh_g, pol_g.depth)
    assert torch.equal(acts_g.cpu(), acts_c)
    torch.testing.assert_close(ret_g.cpu(), ret_c, rtol=1e-5, atol=1e-5)
    clear = _top2_gap(ret_c) > 1e-4
    assert clear.sum() >= 8  # w=8's clipped returns lie close together
    got = pol_g.predict(js_g).cpu()
    assert torch.equal(got[clear], pol_c.predict(js_c)[clear])


def test_cuda_shared_prediction_matches_the_per_action_expansion(dev):
    """At the evaluation's batch, B=500 (its first 500 test cases), on the
    card: the humans the planner predicts once a node equal ``next_state``
    on every (node, action) row to 1e-6 relative (atol 1e-6), and over
    three steps the planner chooses the actions of the one that predicts
    per action, wherever both keep the same clipped root actions and the
    top two returns differ by more than 1e-4.

    A node whose float32 prediction, on either side, misses the float64
    one by more than that 1e-6 is excused from the equality, as a near
    tie is from the choice: the predictor's trained softmax scores (up to
    ~2·10³) make a few states' predictions sensitive to float32 rounding,
    so cuBLAS's tiles for 500 and for 40,500 rows round them apart (one
    node of 1,500 here, by 3.5e-5; its float32 error on the CPU is
    1.1e-5). At most 1 % of the nodes may be excused, and each still lies
    within 1e-4 of float64."""
    config, env, pol, _ = _mprl(dev)
    _, _, ref, ex = _mprl(dev)
    ref._expand = per_action_expand(ref)
    net64 = copy.deepcopy(pol.networks).double()
    states = ex.initial_carry(config.env.sim.test_seed_offset,
                              range(500)).states
    with torch.no_grad():
        for _ in range(3):
            js = TT.JointState(states.robot, TT.observable(states.humans))
            acts = pol._all_actions(js.robot)
            got, want = pol._expand(*js, acts), ref._expand(*js, acts)
            assert torch.equal(got[1], want[1])
            exact = net64.predict_humans(js.robot.double(),
                                         js.humans.double())[:, None]
            well = torch.ones(500, dtype=torch.bool, device=dev)
            for nh in (got[2], want[2]):
                well &= torch.isclose(nh.double(), exact, rtol=1e-6,
                                      atol=1e-6).flatten(1).all(1)
            torch.testing.assert_close(got[2][well], want[2][well],
                                       rtol=1e-6, atol=1e-6)
            assert int((~well).sum()) <= 5
            torch.testing.assert_close(
                got[2][~well].double(), exact.expand_as(got[2])[~well],
                rtol=0, atol=1e-4)
            clipped, returns = [], []
            for p in (pol, ref):
                a, rew, nr, nh = p._clip_actions(*js, p.width)
                clipped.append(a)
                returns.append(rew + p._gamma_bar(js.robot)[..., None]
                               * p.v_planning(nr, nh, p.depth))
            clear = (clipped[0] == clipped[1]).flatten(1).all(1) \
                & (_top2_gap(returns[1]) > 1e-4)
            assert int(clear.sum()) >= 250
            action = pol.predict(js)
            assert torch.equal(action[clear], ref.predict(js)[clear])
            states = env.step(states, action).state


def test_cuda_captured_decision_and_step_replays_eager(dev):
    """64 test cases for all 100 steps: the graphed rollout (one decision
    and one env step captured, replayed) equals the eager loop bit for bit,
    and the graph launches none of kernels #1-#7 and ORCA's kernel once
    (the env's step)."""
    config, _, _, ex = _mprl(dev)
    offset = config.env.sim.test_seed_offset
    with torch.no_grad():
        eager = ex.rollout(offset, range(64), graphed=False)
        graphed = ex.rollout(offset, range(64), graphed=True)
        again = ex.rollout(offset, range(64))  # graphed, the graph reused
    assert len(ex._graphs) == 1
    (graph,) = ex._graphs.values()
    assert graph.launches == {**{k: 0 for k in graph.launches},
                              "orca_velocity": 1}
    for name, a, b, c in zip(eager._fields, eager, graphed, again):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=name)
        torch.testing.assert_close(c, a, rtol=0, atol=0, msg=name)
    assert bool((eager.step > 0).all())


def test_cuda_run_cases_matches_the_per_case_reference(dev):
    """``run_cases`` on the card for the first 32 test cases against the JAX
    package's per-case records: at most one of 32 may differ in its outcome
    or, where both succeed, in its steps (a near-tie of one decision in
    float32; the 500-case bound of chip_smoke.py is 15 outcomes)."""
    config, _, _, ex = _mprl(dev)
    with torch.no_grad():
        final = ex.rollout(config.env.sim.test_seed_offset, range(32))
    ref = {k: v[:32] for k, v in
           checkpoints.load_test_reference("mprl_td").items()}
    outcome = final.case_outcome.cpu().numpy()
    both = (outcome == 1) & (ref["outcome"] == 1)
    other_steps = both & (final.step.cpu().numpy() != ref["steps"])
    assert ((outcome != ref["outcome"]) | other_steps).sum() <= 1
    stats = ex.stats(final)
    assert 0.9 <= float(stats.success_rate) <= 1.0


# --------------------------------------------------------- MP-RGL training
TRAIN_CONFIG = ROOT / "configs" / "icra_benchmark" / "mp_separate.py"


def _artifacts(dev, seed=0):
    config = load_config_module(str(TRAIN_CONFIG))
    art = ttl.build(config, "model_predictive_rl", seed, dev)
    art.policy.init_params(torch.Generator().manual_seed(seed))
    art.trainer.update_target()
    return config, art


def _states_equal(a, b, what):
    for part in ("params", "target_params"):
        for k in a[part]:
            torch.testing.assert_close(b[part][k], a[part][k], rtol=0,
                                       atol=0, msg=f"{what} {part}.{k}")
    for sa, sb in zip(a["optimizer_state"], b["optimizer_state"]):
        for k in sa:
            torch.testing.assert_close(sb[k], sa[k], rtol=0, atol=0,
                                       msg=f"{what} {k}")


@pytest.mark.parametrize("optimizer,use_td", [("sgd", False),
                                              ("adam", True)])
def test_cuda_captured_sgd_step_replays_eager(dev, optimizer, use_td):
    """From the same state and minibatch indices, 1 and then 5 captured SGD
    steps (the graph reused) equal as many eager ones bit for bit:
    parameters, target and optimizer state; the graph launches no kernel
    of #1-#7."""
    config, art = _artifacts(dev)
    trainer = art.trainer
    trainer.set_learning_rate(0.01, optimizer)
    buf = trb.create(4096, config.env.sim.human_num, device=dev)
    g = torch.Generator().manual_seed(0)
    n = 3000
    trb.push(buf, trb.Transition(
        torch.randn(n, 9, generator=g), torch.randn(n, 5, 5, generator=g),
        torch.randn(n, generator=g), torch.randn(n, generator=g),
        torch.randn(n, 9, generator=g), torch.randn(n, 5, 5, generator=g),
        (torch.rand(n, generator=g) < 0.8).float(),
        (torch.rand(n, generator=g) < 0.2).float()))
    gen = torch.Generator(device=dev).manual_seed(1)
    for steps in (1, 5):
        idx = trb.sample_indices(buf, gen, (steps, 100))
        before = trainer.state_dict()
        eager_aux = trainer.optimize(buf, idx, use_td, graphed=False)
        eager = trainer.state_dict()
        trainer.load_state(before)
        graphed_aux = trainer.optimize(buf, idx, use_td, graphed=True)
        _states_equal(eager, trainer.state_dict(), f"{steps} steps")
        assert [float(x) for x in graphed_aux] == [float(x)
                                                   for x in eager_aux]
    ((held, graph),) = trainer._graphs.values()
    assert held is buf and not any(graph.launches.values())


@pytest.mark.parametrize("policy,epsilon", [("orca", 0.0), ("mprl", 0.5)])
def test_cuda_captured_collection_replays_eager(dev, policy, epsilon):
    """64 captured collection steps at B=16 equal 64 eager ones bit for bit
    from the same carry and draws, with auto-resets on the way; the graph
    is reused and recaptured when the case table grows."""
    config, art = _artifacts(dev)
    expl = art.demonstrator_explorer if policy == "orca" else art.explorer
    offset = config.env.sim.train_seed_offset
    gen = torch.Generator(device=dev).manual_seed(2)
    carry = expl.init_carry(16, offset)
    for round_ in range(2):
        draws = art.explorer.draws(gen, 64, 16)
        eager = expl.collect(carry, 64, offset, epsilon, draws,
                             graphed=False)
        graphed = expl.collect(carry, 64, offset, epsilon, draws,
                               graphed=True)
        for part, a, b in zip(("carry", "trajectory"), eager, graphed):
            for name, x, y in zip(a._fields, a, b):
                torch.testing.assert_close(y, x, rtol=0, atol=0,
                                           msg=f"{part}.{name}")
        assert bool(eager[1].terminal.any()) or policy == "mprl"
        carry = eager[0]
        if round_ == 0:  # jump near the table's end: it grows
            table = expl.case_table(offset)
            cap = table.capacity
            carry = carry._replace(case_counter=carry.case_counter
                                   + cap - 16 * 2)
    assert expl.case_table(offset).capacity > cap
    assert len(expl._collect_graphs) == 1


def test_cuda_debug_train(dev, tmp_path):
    """``train_loop.train`` in its debug shrink on the card: the
    demonstrator gate passes, losses are finite, every parameter moved,
    the checkpoints and metrics are written and ``rl_model`` is the live
    state."""
    config, art = _artifacts(dev)
    init = {k: v.clone() for k, v in art.trainer.state_dict()[
        "params"].items()}
    result = ttl.train(config, "model_predictive_rl", str(tmp_path),
                       debug=True, seed=0, device=dev, art=art)
    assert result["demo_success"] >= 0.7 and result["episodes"] >= 40
    for k in ("il_value_loss", "il_sp_loss", "value_loss", "sp_loss"):
        assert np.isfinite(result[k]), k
    live = art.trainer.state_dict()
    assert all(not torch.equal(live["params"][k], v)
               for k, v in init.items())
    for name in ("il_model", "rl_model", "rl_model_best"):
        assert tckpt.exists(str(tmp_path / name)), name
    assert (tmp_path / "metrics.jsonl").is_file()
    _states_equal(live, tckpt.load(str(tmp_path / "rl_model"),
                                   map_location=dev), "rl_model")


# ------------------------------------------------------ one-step baselines
BASELINES = {"sarl": "sarl", "sarl_om": "sarl", "lstm_rl": "lstm_rl",
             "cadrl": "cadrl", "rgl": "rgl"}


def _baseline(device, model, query_env=False):
    """(config, env, policy, explorer) of ``results/<model>`` at 5 humans
    with the exported weights."""
    import dataclasses

    from relationalgraphlearning_tpu_torch.policies.factory import (
        make_policy)

    config = load_config_module(str(ROOT / "results" / model / "config.py"))
    config = dataclasses.replace(
        config, env=dataclasses.replace(config.env, sim=dataclasses.replace(
            config.env.sim, human_num=5)),
        policy=dataclasses.replace(config.policy, query_env=query_env))
    env = CrowdSim(config.env, device=device)
    policy = make_policy(BASELINES[model], config.policy, config.env,
                         device=device)
    policy.load_flax(checkpoints.load_flax_tree(model))
    return config, env, policy, Explorer(env, policy, config.policy.gamma)


@pytest.mark.parametrize("model", list(BASELINES))
def test_cuda_baseline_action_values_match_the_cpu(dev, model):
    """The same states (10 steps into 64 test cases) on the card and on the
    CPU: every action's one-step return (rtol 1e-5, atol 1e-5), with the
    humans at constant velocity and from the env's lookahead (atol 1e-4:
    ORCA sets the humans there), and the choice where the top two differ by
    more than 1e-4."""
    config, env_c, pol_c, ex_c = _baseline("cpu", model)
    _, env_g, pol_g, _ = _baseline(dev, model)
    carry = ex_c.initial_carry(config.env.sim.test_seed_offset, range(64))
    with torch.no_grad():
        for _ in range(10):
            carry = EvalCarry(*ex_c.eval_step(*carry))
    states = carry.states
    states_g = type(states)(*(t.to(dev) for t in states))
    js_c = TT.JointState(states.robot, TT.observable(states.humans))
    js_g = TT.JointState(*(t.to(dev) for t in js_c))
    ret_c, ret_g = pol_c.action_values(js_c), pol_g.action_values(js_g)
    torch.testing.assert_close(ret_g.cpu(), ret_c, rtol=1e-5, atol=1e-5)
    clear = _top2_gap(ret_c) > 1e-4
    assert clear.sum() >= 32
    assert torch.equal(pol_g.predict(js_g).cpu()[clear],
                       pol_c.predict(js_c)[clear])
    env_c_ret = pol_c.action_values_env(env_c, states)
    env_g_ret = pol_g.action_values_env(env_g, states_g)
    torch.testing.assert_close(env_g_ret.cpu(), env_c_ret, rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("model,query_env", [
    ("sarl", False), ("sarl_om", False), ("lstm_rl", False),
    ("cadrl", False), ("rgl", False), ("sarl", True)])
def test_cuda_baseline_captured_rollout_replays_eager(dev, model, query_env):
    """64 test cases for all 100 steps: the graphed rollout equals the
    eager loop bit for bit and its graph launches none of kernels #1-#7
    and ORCA's kernel once a step, twice with the env-queried lookahead;
    at most one of the 64 outcomes differs from the JAX package's
    per-case record (the 500-case bound of chip_smoke.py is 15)."""
    config, _, _, ex = _baseline(dev, model, query_env)
    offset = config.env.sim.test_seed_offset
    with torch.no_grad():
        eager = ex.rollout(offset, range(64), graphed=False)
        graphed = ex.rollout(offset, range(64), graphed=True)
    (graph,) = ex._graphs.values()
    assert graph.launches == {**{k: 0 for k in graph.launches},
                              "orca_velocity": 2 if query_env else 1}
    for name, a, b in zip(eager._fields, eager, graphed):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=name)
    if not query_env:  # the records are of the constant-velocity lookahead
        ref = checkpoints.load_test_reference(model)["outcome"][:64]
        assert (eager.case_outcome.cpu().numpy() != ref).sum() <= 1


def _sarl_artifacts(dev, seed=0, model="sarl"):
    config = load_config_module(str(ROOT / "results" / model / "config.py"))
    art = ttl.build(config, BASELINES[model], seed, dev)
    art.policy.init_params(torch.Generator().manual_seed(seed))
    art.trainer.update_target()
    return config, art


@pytest.mark.parametrize("model", list(BASELINES))
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_cuda_vnrl_captured_sgd_step_replays_eager(dev, optimizer, model):
    """Each learned baseline's value-only step (``VNRLTrainer``; CADRL at
    its one human): 1 and then 5 captured SGD steps equal as many eager
    ones bit for bit."""
    config, art = _sarl_artifacts(dev, model=model)
    trainer = art.trainer
    trainer.set_learning_rate(0.01, optimizer)
    h = config.env.sim.human_num
    buf = trb.create(4096, h, device=dev)
    g = torch.Generator().manual_seed(0)
    n = 3000
    trb.push(buf, trb.Transition(
        torch.randn(n, 9, generator=g), torch.randn(n, h, 5, generator=g),
        torch.randn(n, generator=g), torch.randn(n, generator=g),
        torch.randn(n, 9, generator=g), torch.randn(n, h, 5, generator=g),
        (torch.rand(n, generator=g) < 0.8).float(),
        (torch.rand(n, generator=g) < 0.2).float()))
    gen = torch.Generator(device=dev).manual_seed(1)
    for steps in (1, 5):
        idx = trb.sample_indices(buf, gen, (steps, 100))
        before = trainer.state_dict()
        trainer.optimize(buf, idx, graphed=False)
        eager = trainer.state_dict()
        trainer.load_state(before)
        trainer.optimize(buf, idx, graphed=True)
        _states_equal(eager, trainer.state_dict(), f"{steps} steps")


@pytest.mark.parametrize("model", list(BASELINES))
def test_cuda_sarl_captured_collection_replays_eager(dev, model):
    """64 captured collection steps of each learned baseline (CADRL at its
    one human) at ε = 0.5 and B=16 equal 64 eager ones bit for bit from the
    same carry and draws."""
    config, art = _sarl_artifacts(dev, model=model)
    offset = config.env.sim.train_seed_offset
    gen = torch.Generator(device=dev).manual_seed(2)
    carry = art.explorer.init_carry(16, offset)
    draws = art.explorer.draws(gen, 64, 16)
    eager = art.explorer.collect(carry, 64, offset, 0.5, draws,
                                 graphed=False)
    graphed = art.explorer.collect(carry, 64, offset, 0.5, draws,
                                   graphed=True)
    for part, a, b in zip(("carry", "trajectory"), eager, graphed):
        for name, x, y in zip(a._fields, a, b):
            torch.testing.assert_close(y, x, rtol=0, atol=0,
                                       msg=f"{part}.{name}")


PORT_RESULTS = ROOT / "relationalgraphlearning_tpu_torch" / "results"


@pytest.mark.parametrize("model", list(BASELINES))
def test_cuda_port_trained_baseline_replays_eager(dev, model):
    """The baselines the port trained from scratch (``results/<model>_s0``
    of the package, its torch ``rl_model_best``): 64 test cases at 5
    humans, the graphed rollout equal to the eager loop bit for bit."""
    from relationalgraphlearning_tpu_torch.cli import test as eval_cli

    model_dir = str(PORT_RESULTS / f"{model}_s0")
    config, _ = eval_cli.configure(model_dir, human_num=5)
    weights = eval_cli.weights_of(model_dir)
    assert weights == str(PORT_RESULTS / f"{model}_s0" / "rl_model_best")
    _, _, ex = eval_cli.build(config, BASELINES[model], weights, dev)
    offset = config.env.sim.test_seed_offset
    with torch.no_grad():
        eager = ex.rollout(offset, range(64), graphed=False)
        graphed = ex.rollout(offset, range(64), graphed=True)
    for name, a, b in zip(eager._fields, eager, graphed):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=name)


def test_cuda_diag_unicycle_rollout_replays_eager(dev):
    """The unicycle breakdown's rollout of ``results/mp_unicycle`` on 32
    test cases: graphed equal to eager bit for bit, at most one outcome
    off the JAX package's per-case record."""
    from relationalgraphlearning_tpu_torch.tools import diag_unicycle as diag

    config, explorer = diag.setup(str(ROOT / "results" / "mp_unicycle"), dev)
    graphed = diag.rollout(explorer, 32)
    eager = diag.rollout(explorer, 32, graphed=False)
    for k, v in eager.items():
        np.testing.assert_array_equal(graphed[k], v, err_msg=k)
    ref = checkpoints.load_test_reference("mp_unicycle")["outcome"][:32]
    assert (graphed["outcome"] != ref).sum() <= 1
    summary, rows = diag.diagnose(graphed, config, 32)
    assert summary["collision"] == len(rows)


# -------------------------------- the partitioned paths on D ranks (slice 10)
def _halo_problem(n=4096, K=8, B=64, C=224, seed=3):
    """The JAX package's block set-up (tests/test_parallel.py): 4096 agents
    sorted in a 30 m box, the graph's halo reach under the 1024 rows of
    each of 4 ranks. The net sees the positions in a unit box, so scores
    stay small enough for 1e-5 between two float32 summation orders."""
    g = torch.Generator().manual_seed(seed)
    pos = torch.rand(n, 2, generator=g) * 30.0
    pos = pos[tbg.spatial_sort(pos)]
    cols = tsp.knn_graph(pos, K)
    cand, cov = tbg.block_window(cols, B, C)
    assert float(cov) == 1.0
    mbits = tfb.pack_emask(tbg.block_masks(cols, cand))
    states = torch.cat([pos / 30.0, torch.zeros(n, 2),
                        torch.full((n, 1), 0.3)], -1)
    halo = -(-tgp.halo_reach(cand, B, n // 4) // 8) * 8
    return states, cand, mbits, halo


def test_cuda_partitioned_block_rgl_launches_kernel_1(dev):
    """4 ranks as threads on the card: kernel #1 twice a rank (two GCN
    layers), the result equal to the same ranks on the CPU (plain)."""
    states, cand, mbits, halo = _halo_problem()
    g = torch.Generator().manual_seed(1)
    net = TSparseValueNet(TGCN(), backend="block", generator=g).eval()
    model = net.graph_model
    with torch.no_grad():
        want = tgp.partitioned_block_rgl(
            model, states, cand, mbits, tmesh.make_mesh(data=4, device="cpu"),
            halo)
        tbuild.reset_launch_counts()
        got = tgp.partitioned_block_rgl(
            model.to(dev), states.to(dev), cand.to(dev), mbits.to(dev),
            tmesh.make_mesh(data=4, device=dev), halo)
        torch.cuda.synchronize()
    counts = tbuild.launch_counts()
    assert counts["fused_block_attention_packed_shared"] == 4 * 2
    assert counts["fused_block_attention_packed"] == 0
    torch.testing.assert_close(got.cpu(), want, **TOL)


def test_cuda_block_halo_attention_with_values_launches_kernel_2(dev):
    states, cand, mbits, halo = _halo_problem()
    g = torch.Generator().manual_seed(4)
    n = states.shape[0]
    q, x = torch.randn(n, 32, generator=g), torch.randn(n, 32, generator=g)
    q, x = q / q.norm(dim=1, keepdim=True), x / x.norm(dim=1, keepdim=True)
    v = torch.randn(n, 32, generator=g)

    def run(device):
        return tmesh.make_mesh(data=4, device=device).run(
            lambda comm, *a: tgp.block_halo_attention(comm, *a, halo),
            row_sharded=tuple(t.to(device) for t in (q, x, v, cand, mbits)))

    want = run("cpu")
    tbuild.reset_launch_counts()
    got = run(dev)
    torch.cuda.synchronize()
    counts = tbuild.launch_counts()
    assert counts["fused_block_attention_packed"] == 4
    assert counts["fused_block_attention_packed_shared"] == 0
    torch.testing.assert_close(got.cpu(), want, **TOL)


def test_cuda_partitioned_rollout_matches_the_cpu(dev):
    """The JAX package's 600-agent case (tests/test_partitioned_build.py):
    4 ranks on the card against the same on the CPU, per agent."""
    g = torch.Generator().manual_seed(0)
    n = 600
    pos = torch.rand(n, 2, generator=g) * 47.0 - 23.5
    kw = dict(D=4, n_cap=256, x0=-24.0, band_w=12.0, y0=-24.0, cell=3.0,
              grid_w=64, B=64, C=256, K=8, K_orca=6, mig_cap=32)
    spec = tpb.BandSpec(**kw)
    gnet = torch.Generator().manual_seed(1)
    net = TSparseValueNet(TGCN(), backend="block", generator=gnet).eval()
    args = (pos, torch.zeros(n, 2), -pos, torch.full((n,), 0.3),
            torch.ones(n))
    out = {}
    for device in ("cpu", dev):
        tbuild.reset_launch_counts()
        out[device] = tpb.partitioned_mega_rollout(
            tmesh.make_mesh(data=4, device=device), spec, net.to(device),
            TORCAParams(), 8, 2)(tpb.init_crowd_shards(*args, spec,
                                                       device=device))
    assert tbuild.launch_counts()["fused_block_attention_packed_shared"] == \
        4 * 2 * 8
    (csh, cdiag), (gsh, gdiag) = out["cpu"], out[dev]
    for k in ("band_cov", "win_cov", "overflow", "lost"):
        assert float(gdiag[k]) == float(cdiag[k]), k
    assert float(gdiag["win_cov"]) == 1.0 and int(gdiag["lost"]) == 0
    assert abs(float(gdiag["vmean"]) - float(cdiag["vmean"])) < 1e-4
    torch.testing.assert_close(gsh.aid.cpu(), csh.aid, rtol=0, atol=0)
    torch.testing.assert_close(gsh.pos.cpu(), csh.pos, rtol=0, atol=1e-4)
    torch.testing.assert_close(gsh.vel.cpu(), csh.vel, rtol=0, atol=1e-4)


# ------------------------------------------------ collectives in a capture
def _axes_collectives(comm, x):
    data, model = comm.axis("data"), comm.axis("model")
    y = x * (comm.rank + 1)
    return (data.psum(y), model.psum(y), data.all_gather(y),
            model.all_gather(y, dim=-1), data.ppermute(y, 1))


@pytest.mark.parametrize("data, model", [(4, 1), (2, 2), (4, 2)])
def test_cuda_mesh_capture_replays_collectives_bit_for_bit(dev, data,
                                                           model):
    """``Mesh.capture``: every rank's collectives recorded into one CUDA
    graph; a replay on new rows equals the eager run on them."""
    from relationalgraphlearning_tpu_torch.parallel import comm as tcomm
    mesh = tmesh.make_mesh(data, model, device=dev)
    g = torch.Generator().manual_seed(0)
    x0, x1 = (torch.randn(8 * data, 5, generator=g).to(dev)
              for _ in range(2))
    graph = mesh.capture(_axes_collectives, row_sharded=(x0,))
    for x in (x0, x1):
        got = graph(x)
        want = mesh.run(_axes_collectives, row_sharded=(x,))
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    one = tmesh.make_mesh(data, device=dev).capture(tcomm.collectives,
                                                    row_sharded=(x0,))
    got = one(x1)
    want = tmesh.make_mesh(data, device=dev).run(tcomm.collectives,
                                                 row_sharded=(x1,))
    from torch.utils._pytree import tree_leaves
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cuda_captured_halo_forward_holds_its_launches(dev):
    """The D=4 block-halo forward captured as one graph: kernel #1 twice a
    rank (two GCN layers) in the graph, the replay equal to the eager
    run."""
    states, cand, mbits, halo = _halo_problem()
    gnet = torch.Generator().manual_seed(1)
    model = TSparseValueNet(TGCN(), backend="block",
                            generator=gnet).graph_model.to(dev).eval()
    mesh = tmesh.make_mesh(data=4, device=dev)
    args = tuple(t.to(dev) for t in (states, cand, mbits))
    with torch.no_grad():
        want = mesh.run(tgp.block_rgl_rank, replicated=(model, halo),
                        row_sharded=args)
        graph = mesh.capture(tgp.block_rgl_rank, replicated=(model, halo),
                             row_sharded=args)
        got = graph(*args)
    assert graph.launches["fused_block_attention_packed_shared"] == 4 * 2
    assert sum(graph.launches.values()) == 4 * 2
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cuda_partitioned_rollout_graphed_equals_eager(dev):
    g = torch.Generator().manual_seed(0)
    n = 600
    pos = torch.rand(n, 2, generator=g) * 47.0 - 23.5
    spec = tpb.BandSpec(D=4, n_cap=256, x0=-24.0, band_w=12.0, y0=-24.0,
                        cell=3.0, grid_w=64, B=64, C=256, K=8, K_orca=6,
                        mig_cap=32)
    net = TSparseValueNet(TGCN(), backend="block",
                          generator=torch.Generator().manual_seed(1))
    net = net.to(dev).eval()
    shards = tpb.init_crowd_shards(pos, torch.zeros(n, 2), -pos,
                                   torch.full((n,), 0.3), torch.ones(n),
                                   spec, device=dev)
    mesh = tmesh.make_mesh(data=4, device=dev)
    eager = tpb.partitioned_mega_rollout(mesh, spec, net, TORCAParams(), 8,
                                         2)(shards)
    run = tpb.partitioned_mega_rollout(mesh, spec, net, TORCAParams(), 8, 2,
                                       graphed=True)
    for _ in range(2):                    # the capture, then a replay
        sh, diag = run(shards)
        for a, b in zip(sh, eager[0]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        for k in diag:
            assert float(diag[k]) == float(eager[1][k]), k
    assert run.graph.launches["fused_block_attention_packed_shared"] == \
        4 * 2 * 8


def _dp_config():
    from relationalgraphlearning_tpu_torch.configs.base import (
        Config, EnvConfig, MPRLConfig, PolicyConfig)
    return Config(env=EnvConfig(human_policy="linear"),
                  policy=PolicyConfig(mprl=MPRLConfig(
                      planning_depth=1, do_action_clip=False)))


@pytest.mark.parametrize("data, model", [(2, 1), (2, 2), (4, 2)])
def test_cuda_parallel_step_graphed_equals_eager(dev, data, model):
    """The dp/tp step of every rank as one CUDA graph against the eager
    ranks, from the same state and minibatches (3 Adam steps with TD
    targets): the gathered state bit for bit, every rank of an axis the
    same bits; and near the one-device step (value loss rel 1e-4)."""
    from relationalgraphlearning_tpu_torch.parallel import sharding
    config = _dp_config()
    base = ttl.build(config, "model_predictive_rl", 0, dev)
    base.policy.init_params(torch.Generator().manual_seed(0))
    base.trainer.update_target()
    state = base.trainer.state_dict()
    gen = torch.Generator(device=dev).manual_seed(0)
    carry = base.explorer.init_carry(8, 0)
    _, traj = base.explorer.collect(carry, 8, 0, 0.0, graphed=False)
    buffer = trb.create(256, 5, device=dev)
    base.explorer.update_memory(buffer, traj, None, True)
    idx = trb.sample_indices(buffer, gen, (3, 30))
    runs = {}
    for mode in ("eager", "graphed"):
        art = ttl.build(config, "model_predictive_rl", 0, dev)
        art.trainer.load_state(state)
        par = sharding.ParallelTrainer(art.trainer,
                                       tmesh.make_mesh(data, model, dev))
        aux = par.optimize(buffer, idx, use_td=True,
                           graphed=mode == "graphed")
        runs[mode] = (par, aux)
    (pe, ae), (pg, ag) = runs["eager"], runs["graphed"]
    assert torch.equal(torch.stack(ae), torch.stack(ag))
    se, sg = pe.state_dict(), pg.state_dict()
    for part in ("params", "target_params"):
        for k in se[part]:
            assert torch.equal(se[part][k], sg[part][k]), (part, k)
    for a, b in zip(se["optimizer_state"], sg["optimizer_state"]):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for r, rt in enumerate(pg.ranks):
        ref = pg.ranks[r % model]
        for p, q in zip(rt.params, ref.params):
            assert torch.equal(p, q), r
    base.trainer.load_state(state)
    one = base.trainer.optimize(buffer, idx, use_td=True, graphed=False)
    assert float(ag.value_loss) == pytest.approx(float(one.value_loss),
                                                 rel=1e-4)


def test_cuda_parallel_collect_equals_one_device(dev):
    from relationalgraphlearning_tpu_torch.parallel import sharding
    art = ttl.build(_dp_config(), "model_predictive_rl", 0, dev)
    art.policy.init_params(torch.Generator().manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    carry = art.explorer.init_carry(8, 0)
    draws = art.explorer.draws(gen, 6, 8)
    want = art.explorer.collect(carry, 6, 0, 0.5, draws, graphed=True)
    collect = sharding.make_parallel_collect(
        art.explorer, tmesh.make_mesh(4, device=dev), 6, 0)
    for _ in range(2):                    # the capture, then a replay
        got = collect(carry, 0.5, draws, graphed=True)
        for part_g, part_w in zip(got, want):
            for a, b in zip(part_g, part_w):
                torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cuda_parallel_train_step_on_a_batch_graphed_equals_eager(dev):
    """``make_parallel_train_step``'s step on a given batch (30 rows, which
    4 does not divide) at (4, 2): captured at its first call and replayed
    at its second, against the eager ranks from the same state."""
    from relationalgraphlearning_tpu_torch.parallel import sharding
    config = _dp_config()
    base = ttl.build(config, "model_predictive_rl", 0, dev)
    base.policy.init_params(torch.Generator().manual_seed(0))
    base.trainer.update_target()
    state = base.trainer.state_dict()
    g = torch.Generator().manual_seed(2)
    batches = [trb.Transition(
        robot=torch.randn(30, 9, generator=g),
        humans=torch.randn(30, 5, 5, generator=g),
        value=torch.randn(30, generator=g), reward=torch.zeros(30),
        next_robot=torch.randn(30, 9, generator=g),
        next_humans=torch.randn(30, 5, 5, generator=g),
        valid=(torch.rand(30, generator=g) < 0.8).float(),
        terminal=torch.zeros(30)) for _ in range(2)]
    batches = [trb.Transition(*(t.to(dev) for t in b)) for b in batches]
    steps = {}
    for mode in ("eager", "graphed"):
        art = ttl.build(config, "model_predictive_rl", 0, dev)
        art.trainer.load_state(state)
        steps[mode] = sharding.make_parallel_train_step(
            art.trainer, tmesh.make_mesh(4, 2, dev))
        steps[mode].auxes = [steps[mode](b, 1.0, graphed=mode == "graphed")
                             for b in batches]
    for a, b in zip(steps["eager"].auxes, steps["graphed"].auxes):
        assert torch.equal(torch.stack(a), torch.stack(b))
    for p, q in zip(steps["eager"].params, steps["graphed"].params):
        assert torch.equal(p, q)


# ----------------------------------------------- profiling's device phases
def _phased(x):
    with profiling.device_phase("t.a", x.device):
        y = torch.tanh(x @ x)
    with profiling.device_phase("t.b", x.device):
        y = y @ x
    return y


@pytest.fixture
def traced():
    """Tracing on and the registry empty for one test, off after."""
    profiling.reset()
    profiling.enable()
    yield
    profiling.disable()
    profiling.reset()


def test_cuda_phases_lie_inside_their_replay(dev, traced):
    """A graph captured with tracing on reads both phases of each of five
    replays (each read at the next replay or at the snapshot, none
    skipped, since each replay ends in a sync): positive times whose sum
    is at most the replay's own, bracketed by two events outside it
    (timestamps to 1 us)."""
    x = torch.randn(1024, 1024, device=dev) / 32
    g = captured.Graphed(_phased, x, name="t.graph")
    brackets = 0.0
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        g(x)
        ev[1].record()
        torch.cuda.synchronize()
        brackets += ev[0].elapsed_time(ev[1])
    snap = profiling.snapshot()
    gr = snap["graphs"]["t.graph"]
    assert (gr["replays"], gr["read"], gr["skipped"]) == (5, 5, 0)
    a, b = gr["phases"]["t.a"], gr["phases"]["t.b"]
    assert a["count"] == b["count"] == 5
    assert a["ms"] > 0 and b["ms"] > 0
    assert a["ms"] + b["ms"] <= brackets + 5 * 0.002
    assert snap["counters"]["captured.captures.t.graph"] == 1
    assert snap["counters"]["captured.capture_s.t.graph"] > 0


def test_cuda_untraced_capture_holds_no_event_node(dev, monkeypatch,
                                                    tmp_path):
    """Captured with tracing off, a graph holds no event node (its debug
    dump names none, where the traced one's does) and gives the traced
    graph's outputs bit for bit."""
    real = torch.cuda.CUDAGraph

    def debug_graph():  # kept after capture, so that it can be dumped
        g = real(keep_graph=True)
        g.enable_debug_mode()
        return g
    monkeypatch.setattr(torch.cuda, "CUDAGraph", debug_graph)
    x = torch.randn(512, 512, device=dev) / 32
    assert not profiling.enabled()
    plain = captured.Graphed(_phased, x, name="t.plain")
    profiling.enable()
    try:
        traced = captured.Graphed(_phased, x, name="t.traced")
    finally:
        profiling.disable()
        profiling.reset()
    assert plain.phases is None and len(traced.phases.phases) == 2
    assert torch.equal(plain(x).clone(), traced(x).clone())
    dumps = {}
    for name, g in (("plain", plain), ("traced", traced)):
        path = tmp_path / f"{name}.dot"
        g.graph.debug_dump(str(path))
        dumps[name] = path.read_text().lower()
    assert "event" in dumps["traced"]
    assert "event" not in dumps["plain"]


def test_cuda_recapture_counts_once(dev, traced):
    """The collection graph: captured at the first call, replayed at the
    second, captured once more when the case table grows; its phases are
    read."""
    config, art = _artifacts(dev)
    expl = art.demonstrator_explorer
    offset = config.env.sim.train_seed_offset
    carry = expl.init_carry(16, offset)
    name = "captured.captures.explorer.collect_step"
    expl.collect(carry, 8, offset, graphed=True)
    expl.collect(carry, 8, offset, graphed=True)
    assert profiling.snapshot()["counters"][name] == 1
    cap = expl.case_table(offset).capacity
    carry = carry._replace(case_counter=carry.case_counter + cap)
    expl.collect(carry, 8, offset, graphed=True)
    snap = profiling.snapshot()
    assert expl.case_table(offset).capacity > cap
    assert snap["counters"][name] == 2
    assert snap["counters"]["explorer.case_rows"] == \
        expl.case_table(offset).capacity
    phases = snap["graphs"]["explorer.collect_step"]["phases"]
    assert set(phases) == {"collect.plan", "collect.env", "collect.record"}
    assert all(p["ms"] > 0 for p in phases.values())


def test_cuda_traced_evaluation_equals_untraced(dev, traced):
    """The evaluation step graph captured with tracing on rolls 64 cases
    as the untraced graph does, bit for bit; the planner's phases nest
    inside ``step.plan``."""
    config, _, _, ex_on = _mprl(dev)
    offset = config.env.sim.test_seed_offset
    with torch.no_grad():
        on = ex_on.rollout(offset, range(64))
        profiling.disable()
        off = _mprl(dev)[3].rollout(offset, range(64))
        profiling.enable()
    for name, a, b in zip(off._fields, off, on):
        assert torch.equal(a, b), name
    g = profiling.snapshot()["graphs"]["explorer.eval_step"]
    ms = {k: v["ms"] / v["count"] for k, v in g["phases"].items()}
    assert set(ms) == {"step.plan", "plan.root_clip", "plan.v_planning",
                       "step.env", "step.book"}
    assert ms["plan.root_clip"] + ms["plan.v_planning"] <= ms["step.plan"]
    assert g["read"] >= 1 and g["replays"] == 100
