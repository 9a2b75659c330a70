from .mesh import data_mesh, shard_rows, replicate
from .neighbors import (
    sharded_edit_pairs_shifted,
    sharded_neighbor_pairs,
    sharded_neighbor_pairs_bucketed,
)
from .labelprop import (
    dedup_step,
    distributed_components,
    distributed_components_node_sharded,
)
from .pipeline import run_distributed, run_sharded

__all__ = [
    "data_mesh",
    "shard_rows",
    "replicate",
    "sharded_edit_pairs_shifted",
    "sharded_neighbor_pairs",
    "sharded_neighbor_pairs_bucketed",
    "distributed_components",
    "distributed_components_node_sharded",
    "dedup_step",
    "run_distributed",
    "run_sharded",
]
