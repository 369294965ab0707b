"""The capture helper of the port (``captured.py``) off the card: what it
refuses and what it counts. The graphs themselves run only on a card
(``tests/test_torch_cuda.py``); the entry points that use them are held to
their eager loops on CPU tensors in the chain, harness and mega-crowd test
files.
"""

import pytest
import torch

from relationalgraphlearning_tpu_torch import captured
from relationalgraphlearning_tpu_torch.ops import (
    ab_block, fused_block, fused_chunk, fused_gather, orca)


def test_cpu_tensors_are_refused():
    with pytest.raises(ValueError, match="CUDA"):
        captured.Graphed(lambda h: h * 2, torch.ones(4))
    with pytest.raises(ValueError, match="CUDA"):
        captured.Graphed(lambda: None)


def test_launch_counts_cover_every_kernel_wrapper():
    fused_block.fused_block_attention_packed_shared.launches = 3
    fused_gather.fused_gather_attention.launches = 2
    ab_block.ab_block_attention.launches = 1
    orca.orca_velocity.launches = 4
    counts = captured.launch_counts()
    assert counts == {**fused_block.launch_counts(),
                      **fused_gather.launch_counts(),
                      **fused_chunk.launch_counts(),
                      **ab_block.launch_counts(),
                      **orca.launch_counts()}
    assert set(counts) == {"fused_block_attention_packed_shared",
                           "fused_block_attention_packed",
                           "fused_block_attention", "fused_gather_attention",
                           "chunk_block_attention", "ab_block_attention",
                           "orca_velocity"}
    assert counts["fused_gather_attention"] == 2
    assert counts["orca_velocity"] == 4
    captured.reset_launch_counts()
    assert set(captured.launch_counts().values()) == {0}
