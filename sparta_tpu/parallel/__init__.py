from .attention import sequence_sharded_attention
from .mesh import make_mesh, make_mesh_2d, sharding
from .spmm import (
    pad_block_rows,
    shard_bell_rowwise,
    spmm_colsplit_reduce_scatter,
    spmm_ring,
    dedup_spmm_rowsharded,
    shard_dedup_rowwise,
    spmm_rowsharded,
    split_bell_cols,
)

__all__ = [
    "make_mesh",
    "make_mesh_2d",
    "sequence_sharded_attention",
    "pad_block_rows",
    "shard_bell_rowwise",
    "sharding",
    "spmm_colsplit_reduce_scatter",
    "spmm_ring",
    "dedup_spmm_rowsharded",
    "shard_dedup_rowwise",
    "spmm_rowsharded",
    "split_bell_cols",
]
from .multihost import (  # noqa: E402
    initialize_multihost,
    partitioned_reorder,
    row_range_for_host,
)

__all__ += ["initialize_multihost", "partitioned_reorder", "row_range_for_host"]
