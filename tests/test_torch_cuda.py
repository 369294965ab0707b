"""The CUDA kernel on the card: held against its plain PyTorch versions, its
wrapper's checks, and its launch count on the rollout.

These tests need an NVIDIA GPU with ``nvcc`` (sm_90a) and skip elsewhere.
This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda

Tolerance rtol=atol=1e-5: float32 in both, sums in different orders.
"""

import pytest
import torch

from relationalgraphlearning_tpu_torch.envs.mega_crowd import (
    mega_crowd_rollout)
from relationalgraphlearning_tpu_torch.ops import block_graph as tbg
from relationalgraphlearning_tpu_torch.ops import fused_block as tfb
from relationalgraphlearning_tpu_torch.ops import sparse as tsp

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-5, atol=1e-5)


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


def test_cuda_rollout_counts_two_launches_a_step(dev):
    tfb.reset_launch_counts()
    (pos, vel), vals, cov = mega_crowd_rollout(
        n=1024, K=10, steps=4, backend="block", packed=True, block_B=256,
        block_C=576, rebuild_every=2, device=dev)
    assert tfb.launch_counts()["fused_block_attention_packed_shared"] == 8
    assert float(cov) == 1.0 and torch.isfinite(vals).all()
    (pc, vc), valc, _ = mega_crowd_rollout(
        n=1024, K=10, steps=4, backend="block", packed=True, block_B=256,
        block_C=576, rebuild_every=2, device="cpu")
    torch.testing.assert_close(pos.cpu(), pc, rtol=0, atol=1e-4)
    torch.testing.assert_close(vals.cpu(), valc, rtol=0, atol=1e-4)
