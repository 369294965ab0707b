"""Graph ops: kNN graphs, the fixed-K chain, block windows, fused kernel.

The kernel modules of the system's paths are imported with the package, so
that ``_build``'s launch registry names each of their kernels from the first
import of any ``ops`` module on.
"""

from relationalgraphlearning_tpu_torch.ops import (  # noqa: F401
    ab_block, fused_block, fused_chunk, fused_gather, orca)
