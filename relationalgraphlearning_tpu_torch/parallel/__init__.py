"""The partitioned paths over D ranks: ``Mesh``, ``comm``, the node-
partitioned aggregation and the partitioned mega-crowd rollout."""

from relationalgraphlearning_tpu_torch.parallel.graph_partition import (
    block_halo_attention, halo_exchange, halo_reach, partitioned_block_rgl,
    partitioned_sparse_rgl)
from relationalgraphlearning_tpu_torch.parallel.mesh import Mesh, make_mesh
