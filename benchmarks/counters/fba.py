"""Kernel #1 (``csrc/fused_block_attention.cu``, values ≡ keys): the bytes
and operations one launch needs, and the least time they take on the card.

Inputs and output counted once each: the queries [n, d] and the node table
[n, d] in float32, the windows [nb, C] int64, the packed mask
[nb, B/32, C] int32, the output [n, d]. Operations: per edge d
multiply-adds for the score, d for the weighted sum, one exp and one add
for the denominator (2·d + 2·d + 2). The least time is the larger of bytes
over the HBM rate and operations over the float32 rate (PERF.md's kernel
table uses the same bound).
"""

from __future__ import annotations

from benchmarks.counters.peaks import F32_FLOPS, HBM_BYTES


def launch(n: int, d: int, B: int, C: int, edges: int) -> tuple[int, int]:
    """(bytes, operations) of one launch over n rows in blocks of B."""
    nb = n // B
    nbytes = 4 * n * d * 3 + 8 * nb * C + 4 * nb * (B // 32) * C
    return nbytes, edges * (2 * d + 2 * d + 2)


def least_seconds(n: int, d: int, B: int, C: int, edges: int) -> float:
    nbytes, ops = launch(n, d, B, C, edges)
    return max(nbytes / HBM_BYTES, ops / F32_FLOPS)
